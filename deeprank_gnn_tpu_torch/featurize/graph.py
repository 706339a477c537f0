"""Graph container with HDF5 round-trip, scoring and visualization.

Array-backed re-design of the reference's networkx-based `Graph`
(reference `Graph.py:13-236`): nodes/edges live in ordered lists +
feature dicts, so the HDF5 writer is O(N+E) instead of the reference's
O(N) `list.index` per edge (`Graph.py:96`, SURVEY hot-spot 6). The
on-disk schema is identical (groups `nodes`, `node_data/*`, `edges`,
`edge_index`, `edge_data/*`, `internal_*`, `score/*`), so files are
interchangeable with the reference's.

The port's own copy of ``deeprank_gnn_tpu/featurize/graph.py``. ``h5py``
is imported only where a file is read or written, and :meth:`Graph.to_sample`
converts a graph into the port's ``GraphSample`` without a file: exactly
the sample ``HDF5DataSet`` loads from the group :meth:`Graph.nx2h5`
writes, so featurized graphs reach the engine where ``h5py`` is absent.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeprank_gnn_tpu_torch.data.dataset import (
    ArrayGroup,
    GraphSample,
    default_edge_transform,
    sample_from_group,
)
from deeprank_gnn_tpu_torch.featurize.similarity import compute_all_scores

ResKey = Tuple[str, int, str]


class Graph:
    def __init__(self, device="cuda"):
        # where get_score's contact search runs
        self.device = device
        self.name: Optional[str] = None
        self.pdb: Optional[str] = None
        # ordered node keys and per-node feature dict
        self.nodes: List[ResKey] = []
        self.node_data: Dict[str, list] = {}
        # edges: list of (node_key_1, node_key_2); parallel feature lists
        self.edges: List[Tuple[ResKey, ResKey]] = []
        self.edge_data: Dict[str, list] = {}
        self.score: Dict[str, object] = {
            "irmsd": None,
            "lrmsd": None,
            "capri_class": None,
            "fnat": None,
            "dockQ": None,
            "bin_class": None,
        }
        self.clusters: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def get_score(self, ref: str) -> None:
        """Docking-quality targets vs a reference structure
        (reference `Graph.py:27-59`), the contacts found on ``self.device``."""
        self.score.update(compute_all_scores(self.pdb, ref, self.device))

    # ------------------------------------------------------------------
    def _split_edges(self):
        """Partition edges into interface / internal by their 'type'."""
        node_pos = {k: i for i, k in enumerate(self.nodes)}
        iface_idx, internal_idx = [], []
        for i, _ in enumerate(self.edges):
            etype = self.edge_data["type"][i]
            if isinstance(etype, bytes):
                etype = etype.decode("utf-8")
            (internal_idx if etype == "internal" else iface_idx).append(i)
        return node_pos, iface_idx, internal_idx

    def h5_arrays(self) -> Dict[str, np.ndarray]:
        """The datasets :meth:`nx2h5` writes, ``{path in the group: array}``
        (schema of reference `Graph.py:61-139`)."""
        out: Dict[str, np.ndarray] = {}
        out["nodes"] = np.array(
            [(k[0], str(k[1]), k[2]) for k in self.nodes], dtype="S"
        )
        for feat, vals in self.node_data.items():
            out[f"node_data/{feat}"] = np.asarray(vals)

        node_pos, iface_idx, internal_idx = self._split_edges()

        def edge_block(indices):
            e_list = [self.edges[i] for i in indices]
            arr = np.array(
                [
                    ((a[0], str(a[1]), a[2]), (b[0], str(b[1]), b[2]))
                    for a, b in e_list
                ],
                dtype="S",
            ) if e_list else np.zeros((0, 2, 3), dtype="S3")
            index = [[node_pos[a], node_pos[b]] for a, b in e_list]
            data = {
                feat: [self.edge_data[feat][i] for i in indices]
                for feat in self.edge_data
            }
            return arr, index, data

        e_arr, e_index, e_data = edge_block(iface_idx)
        i_arr, i_index, i_data = edge_block(internal_idx)
        out["edges"] = e_arr
        out["internal_edges"] = i_arr
        # empty edge lists must keep the (0, 2) shape — a (0,)-shaped
        # index would break every reader downstream
        out["edge_index"] = np.asarray(e_index, dtype=np.int64).reshape(-1, 2)
        out["internal_edge_index"] = np.asarray(i_index, dtype=np.int64).reshape(-1, 2)
        for feat in self.edge_data:
            out[f"edge_data/{feat}"] = np.asarray(e_data[feat])
            out[f"internal_edge_data/{feat}"] = np.asarray(i_data[feat])
        for k, v in self.score.items():
            if v is not None:
                out[f"score/{k}"] = np.asarray(v)
        return out

    def nx2h5(self, f5) -> None:
        """Write to an open ``h5py.File`` (schema of reference
        `Graph.py:61-139`)."""
        grp = f5.create_group(self.name)
        for sub in ("node_data", "edge_data", "internal_edge_data", "score"):
            grp.create_group(sub)
        for path, arr in self.h5_arrays().items():
            grp.create_dataset(path, data=arr)

    def to_sample(
        self,
        node_feature="all",
        edge_feature: Optional[Sequence[str]] = ("dist",),
        target: Optional[str] = None,
        clustering_method: str = "mcl",
        edge_feature_transform: Callable = default_edge_transform,
    ) -> GraphSample:
        """The port's ``GraphSample`` of this graph: exactly what
        ``HDF5DataSet(..., node_feature, edge_feature, target,
        clustering_method, edge_feature_transform).get`` loads from the
        group :meth:`nx2h5` writes (no clusters: that group has none;
        ``data.dataset.cluster_sample`` adds those ``PreCluster`` would
        store). Its mol is the graph's name."""
        grp = ArrayGroup(self.h5_arrays())
        if node_feature == "all":
            node_feature = grp["node_data"].keys()
        if edge_feature == "all":
            edge_feature = [
                k for k in grp["edge_data"].keys()
                if grp[f"edge_data/{k}"].dtype.kind in "fiub"
            ]
        sample = sample_from_group(
            grp, self.name, list(node_feature),
            None if edge_feature is None else list(edge_feature),
            target, clustering_method, edge_feature_transform,
        )
        if sample is None:
            raise ValueError(f"{self.name}: features {node_feature} / {edge_feature} missing")
        return sample

    # ------------------------------------------------------------------
    def h52nx(self, f5name: Optional[str], mol: Optional[str], molgrp=None):
        """Load from HDF5 (reference `Graph.py:141-236`)."""
        close = False
        if molgrp is None:
            import h5py

            f5 = h5py.File(f5name, "r")
            molgrp = f5[mol]
            self.name = mol
            self.pdb = mol + ".pdb"
            close = True
        else:
            self.name = molgrp.name
            self.pdb = self.name + ".pdb"

        raw_nodes = molgrp["nodes"][()].astype("U")
        self.nodes = [(n[0], int(n[1]), n[2]) for n in raw_nodes]
        self.node_data = {}
        for key in molgrp["node_data"]:
            vals = molgrp[f"node_data/{key}"][()]
            self.node_data[key] = list(vals)

        self.edges, self.edge_data = [], {}
        for block, data_key, typ in (
            ("edges", "edge_data", "interface"),
            ("internal_edges", "internal_edge_data", "internal"),
        ):
            raw = molgrp[block][()].astype("U")
            feats = {k: molgrp[f"{data_key}/{k}"][()] for k in molgrp[data_key]}
            for i, e in enumerate(raw):
                a = (e[0][0], int(e[0][1]), e[0][2])
                b = (e[1][0], int(e[1][1]), e[1][2])
                self.edges.append((a, b))
                for k, v in feats.items():
                    self.edge_data.setdefault(k, []).append(v[i])
            if "type" not in feats:
                self.edge_data.setdefault("type", []).extend(
                    [typ.encode()] * len(raw)
                )

        self.score = {k: molgrp[f"score/{k}"][()] for k in molgrp["score"]}
        self.clusters = {}
        if "clustering" in molgrp:
            for method in molgrp["clustering"]:
                self.clusters[method] = molgrp[
                    f"clustering/{method}/depth_0"
                ][()]
        if close:
            f5.close()

    # ------------------------------------------------------------------
    def to_networkx(self):
        """Optional networkx export for interop/visualization."""
        import networkx as nx

        g = nx.Graph()
        for i, n in enumerate(self.nodes):
            attrs = {k: v[i] for k, v in self.node_data.items()}
            g.add_node(n, **attrs)
        for i, (a, b) in enumerate(self.edges):
            attrs = {k: v[i] for k, v in self.edge_data.items()}
            g.add_edge(a, b, **attrs)
        return g

    def _edge_type(self, i: int) -> str:
        t = self.edge_data["type"][i]
        return t.decode("utf-8") if isinstance(t, bytes) else str(t)

    # ------------------------------------------------------------------
    # interactive figures (reference `Graph.py:238-477`, 16 plotly call
    # sites). The figure is built as a plain plotly-schema dict
    # (plotly figures ARE json); rendering needs no plotly package:
    # a self-contained HTML embeds the JSON and loads plotly.js from
    # its CDN. When the plotly package IS importable it renders the
    # same dict natively (offline.plot / iplot).

    _PLOTLY_HTML = (
        "<!DOCTYPE html><html><head><meta charset=\"utf-8\"/>"
        "<script src=\"https://cdn.plot.ly/plotly-2.27.0.min.js\">"
        "</script></head><body><div id=\"graph\"></div>"
        "<script>var FIG = {fig};\n"
        "Plotly.newPlot('graph', FIG.data, FIG.layout);</script>"
        "</body></html>"
    )

    def _node_hover(self):
        texts = []
        for i, n in enumerate(self.nodes):
            parts = [str(n)]
            for k in ("bsa", "charge", "ic"):
                if k in self.node_data:
                    v = np.asarray(self.node_data[k][i]).ravel()
                    if v.size == 1:
                        parts.append(f"{k}: {float(v[0]):.3g}")
            texts.append("<br>".join(parts))
        return texts

    def _edge_traces(self, pos):
        node_pos = {k: i for i, k in enumerate(self.nodes)}
        dim = pos.shape[1]
        traces = []
        for etype, color, width in (
            ("internal", "rgb(110,110,110)", 2),
            ("interface", "rgb(210,210,210)", 1),
        ):
            xs: list = [[] for _ in range(dim)]
            for i, (a, b) in enumerate(self.edges):
                if self._edge_type(i) != etype:
                    continue
                pa, pb = pos[node_pos[a]], pos[node_pos[b]]
                for d in range(dim):
                    xs[d] += [float(pa[d]), float(pb[d]), None]
            trace = {
                "type": "scatter3d" if dim == 3 else "scatter",
                "mode": "lines",
                "name": etype,
                "line": {"color": color, "width": width},
                "hoverinfo": "none",
                "x": xs[0],
                "y": xs[1],
            }
            if dim == 3:
                trace["z"] = xs[2]
            traces.append(trace)
        return traces

    def _plotly_fig(self, pos, cluster=None, title=None):
        """Plotly-schema figure dict: edge line traces + one
        hover-annotated marker trace per chain, colored by cluster
        (2D) or chain (3D) — the reference's figure structure
        (`Graph.py:262-384` / `:408-477`)."""
        dim = pos.shape[1]
        hover = self._node_hover()
        chains = np.array([n[0] for n in self.nodes])
        data = self._edge_traces(pos)
        for chain, line_color in (("A", "red"), ("B", "blue")):
            m = chains == chain
            idx = np.flatnonzero(m)
            marker = {
                "size": 6 if dim == 3 else 10,
                "line": {"color": line_color, "width": 2},
            }
            if cluster is not None:
                marker["color"] = [int(c) for c in np.asarray(cluster)[m]]
                marker["colorscale"] = "Plasma"
            else:
                marker["color"] = line_color
            trace = {
                "type": "scatter3d" if dim == 3 else "scatter",
                "mode": "markers",
                "name": f"chain {chain}",
                "marker": marker,
                "text": [hover[i] for i in idx],
                "hoverinfo": "text",
                "x": [float(pos[i, 0]) for i in idx],
                "y": [float(pos[i, 1]) for i in idx],
            }
            if dim == 3:
                trace["z"] = [float(pos[i, 2]) for i in idx]
            data.append(trace)
        return {
            "data": data,
            "layout": {
                "title": title or f"connection graph for {self.pdb}",
                "showlegend": True,
                "hovermode": "closest",
            },
        }

    def _render_plotly(self, fig: dict, path: str, iplot: bool):
        """Render a figure dict: native plotly when importable, else
        the self-contained HTML fallback (same interactivity in any
        browser)."""
        try:
            import plotly.graph_objects as go
            import plotly.offline as pyo

            f = go.Figure(fig)
            if iplot:
                try:
                    pyo.iplot(f, filename=path)
                except Exception:  # not a notebook environment
                    pyo.plot(f, filename=path, auto_open=False)
            else:
                pyo.plot(f, filename=path, auto_open=False)
            return path
        except ImportError:
            import json as _json

            html = self._PLOTLY_HTML.replace(
                "{fig}", _json.dumps(fig)
            )
            with open(path, "w") as fh:
                fh.write(html)
            return path

    def plotly_2d(
        self,
        out=None,
        offline: bool = False,
        iplot: bool = True,
        disable_plot: bool = False,
        method: str = "louvain",
    ):
        """2D interface-graph plot (reference `Graph.py:238-384`).

        Uses a manifold embedding of the 3D positions. Writes BOTH an
        interactive figure (`<out>_2d.html`, hover-annotated — via the
        plotly package when importable, else self-contained HTML with
        the figure JSON + plotly.js CDN) and a static matplotlib PNG.
        """
        from deeprank_gnn_tpu_torch.tools.embedding import manifold_embedding

        pos = np.array(self.node_data["pos"], dtype=np.float64)
        pos2d = manifold_embedding(pos)

        if method in self.clusters:
            cluster = np.asarray(self.clusters[method])
        else:
            from deeprank_gnn_tpu_torch.featurize.cluster import community_detection

            node_pos = {k: i for i, k in enumerate(self.nodes)}
            internal = [
                (node_pos[a], node_pos[b])
                for i, (a, b) in enumerate(self.edges)
                if self._edge_type(i) == "internal"
            ]
            ei = (
                np.array(internal, dtype=np.int64).T
                if internal
                else np.zeros((2, 0), dtype=np.int64)
            )
            cluster = community_detection(ei, len(self.nodes), method=method)

        if disable_plot:
            return pos2d, cluster
        base = out or self.name or "graph2d"
        fig = self._plotly_fig(np.asarray(pos2d), cluster)
        self._render_plotly(fig, f"{base}_2d.html", iplot and not offline)
        self._draw_2d(pos2d, cluster, out)
        return pos2d, cluster

    def _draw_2d(self, pos2d, cluster, out):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        node_pos = {k: i for i, k in enumerate(self.nodes)}
        fig, ax = plt.subplots(figsize=(8, 8))
        for i, (a, b) in enumerate(self.edges):
            style = (
                dict(color="0.4", lw=1.5)
                if self._edge_type(i) == "internal"
                else dict(color="0.8", lw=0.5)
            )
            pa, pb = pos2d[node_pos[a]], pos2d[node_pos[b]]
            ax.plot([pa[0], pb[0]], [pa[1], pb[1]], **style)
        chains = np.array([n[0] for n in self.nodes])
        for chain, color in (("A", "tab:red"), ("B", "tab:blue")):
            m = chains == chain
            ax.scatter(pos2d[m, 0], pos2d[m, 1], c=cluster[m], cmap="plasma",
                       edgecolors=color, s=60, linewidths=1.5)
        ax.set_title(f"connection graph for {self.pdb}")
        ax.axis("off")
        fig.savefig((out or self.name or "graph2d") + "_2d.png")
        plt.close(fig)

    def plotly_3d(
        self, out=None, offline=False, iplot=True, disable_plot=False
    ):
        """3D interface-graph plot (reference `Graph.py:386-477`):
        interactive rotatable figure (`<out>_3d.html`, see
        :meth:`plotly_2d` rendering notes) plus a static PNG."""
        pos = np.array(self.node_data["pos"], dtype=np.float64)
        if disable_plot:
            return pos
        base = out or self.name or "graph3d"
        fig = self._plotly_fig(pos)
        self._render_plotly(fig, f"{base}_3d.html", iplot and not offline)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        node_pos = {k: i for i, k in enumerate(self.nodes)}
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        for i, (a, b) in enumerate(self.edges):
            style = (
                dict(color="0.4", lw=1.5)
                if self._edge_type(i) == "internal"
                else dict(color="0.8", lw=0.5)
            )
            pa, pb = pos[node_pos[a]], pos[node_pos[b]]
            ax.plot([pa[0], pb[0]], [pa[1], pb[1]], [pa[2], pb[2]], **style)
        chains = np.array([n[0] for n in self.nodes])
        for chain, color in (("A", "tab:red"), ("B", "tab:blue")):
            m = chains == chain
            ax.scatter(pos[m, 0], pos[m, 1], pos[m, 2], c=color, s=40)
        ax.set_title(f"connection graph for {self.pdb}")
        fig.savefig((out or self.name or "graph3d") + "_3d.png")
        plt.close(fig)
        return pos
