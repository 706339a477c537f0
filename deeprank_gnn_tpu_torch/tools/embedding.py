"""3D -> 2D manifold embeddings for graph plots
(reference `tools/embedding.py:3-15`).

The port's own copy of ``deeprank_gnn_tpu/tools/embedding.py``
(``scikit-learn`` imported where it is used).
"""

from __future__ import annotations

import numpy as np


def manifold_embedding(pos, method: str = "tsne"):
    """Project [N, 3] positions to [N, 2] via tSNE / spectral / MDS."""
    from sklearn import manifold

    n_components = 2
    n_neighbors = min(30, max(2, len(pos) - 1))
    pos = np.asarray(pos, dtype=np.float64)

    if method == "tsne":
        tsne = manifold.TSNE(
            n_components=n_components,
            init="pca",
            random_state=0,
            perplexity=min(30.0, max(5.0, len(pos) / 4)),
        )
        return tsne.fit_transform(pos)
    if method == "spectral":
        se = manifold.SpectralEmbedding(
            n_components=n_components, n_neighbors=n_neighbors
        )
        return se.fit_transform(pos)
    if method == "mds":
        mds = manifold.MDS(n_components, max_iter=100, n_init=1, random_state=0)
        return mds.fit_transform(pos)
    raise ValueError(f"unknown embedding method {method!r}")
