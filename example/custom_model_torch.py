"""Build and train a custom GNN outside the NeuralNet engine, with the
PyTorch port.

The port's counterpart of ``custom_model.py`` (reference `example/model.py`):
the low-level API — dataset, loader, an ``nn.Module`` over the port's ops
and ``torch.optim.Adam`` — for users who want full control. Both
convolutions pass the batch's CSR row pointers (``edge_rowptr``,
``pe_rowptr``) to ``segment_sum``, so on the card their sums run as the
sorted segment sum kernel.

    python example/custom_model_torch.py          # on the card
"""

import numpy as np
import torch
from torch import nn

from deeprank_gnn_tpu_torch.data.batch import GraphLoader
from deeprank_gnn_tpu_torch.data.dataset import HDF5DataSet, PreCluster
from deeprank_gnn_tpu_torch.device import deterministic, resolve_device, set_fp32_numerics
from deeprank_gnn_tpu_torch.models.common import linear, linear_init, uniform_init
from deeprank_gnn_tpu_torch.ops import (
    community_pooling_x,
    gather,
    graph_mean_pool,
    max_pool_x,
    segment_sum,
)
from deeprank_gnn_tpu_torch.train.losses import mse_loss

H5 = "./1ATN_residue.hdf5"


class CustomNet(nn.Module):
    """A simple edge-weighted conv -> two-level pooled readout, with the
    parameters (and names) of ``custom_model.py``'s ``init_params``."""

    def __init__(self, num_features: int, generator=None):
        super().__init__()
        self.w1 = nn.Parameter(uniform_init((16, num_features), num_features, generator))
        self.w2 = nn.Parameter(uniform_init((32, 16), 16, generator))
        fc1_w, fc1_b = linear_init(32, 64, generator)
        fc2_w, fc2_b = linear_init(64, 1, generator)
        self.fc1_w, self.fc1_b = nn.Parameter(fc1_w), nn.Parameter(fc1_b)
        self.fc2_w, self.fc2_b = nn.Parameter(fc2_w), nn.Parameter(fc2_b)

    def forward(self, batch):
        row, col = batch.edge_index[0], batch.edge_index[1]
        n, c0, c1, g = (
            batch.num_nodes,
            batch.num_clusters0,
            batch.num_clusters1,
            batch.num_graphs,
        )
        h = batch.x @ self.w1.T
        msg = gather(h, col) * batch.edge_attr  # distance-weighted messages
        h = torch.relu(segment_sum(msg, row, n, row_ptr=batch.edge_rowptr))
        h = community_pooling_x(h, batch.assign0, c0)
        h2 = h @ self.w2.T
        pe_row, pe_col = batch.pe_index[0], batch.pe_index[1]
        msg2 = gather(h2, pe_col)
        h2 = torch.relu(segment_sum(msg2, pe_row, c0, row_ptr=batch.pe_rowptr))
        hq = max_pool_x(h2, batch.assign1, c1)
        out = graph_mean_pool(hq, batch.pool1_graph, g)
        out = torch.relu(linear(out, self.fc1_w, self.fc1_b))
        return linear(out, self.fc2_w, self.fc2_b)


def train(model: CustomNet, loader, epochs: int = 19, lr: float = 1e-2, device="cuda"):
    """``epochs`` epochs of Adam steps over ``loader``'s batches (any
    loader of sparse ``GraphBatch``es: an HDF5 file's or in-memory graphs'),
    under deterministic algorithms; prints each epoch's mean loss and
    returns every epoch's batch losses."""
    device = resolve_device(device)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    history = []
    with deterministic():
        for epoch in range(1, epochs + 1):
            losses = []
            for batch, _mols in loader:
                batch = batch.to(device)
                optimizer.zero_grad()
                pred = model(batch).reshape(-1)
                loss = mse_loss(pred, batch.y, batch.y_mask)
                loss.backward()
                optimizer.step()
                losses.append(float(loss.detach()))
            print(f"Epoch {epoch:02d}  loss {np.mean(losses):.4f}")
            history.append(losses)
    return history


def main(h5=H5, epochs=19, device="cuda", seed=0):
    """Train ``CustomNet`` (drawn from ``seed``) on ``h5``; returns the
    model and every epoch's batch losses."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_fp32_numerics()
    dataset = HDF5DataSet(
        database=h5,
        node_feature=["type", "polarity", "bsa"],
        edge_feature=["dist"],
        target="irmsd",
        tqdm=False,
    )
    # the low-level loader needs the two-level clusters; NeuralNet does
    # this automatically, here we pre-cluster explicitly (cached into the
    # HDF5 — a no-op on later runs)
    PreCluster(dataset, method="mcl")
    loader = GraphLoader(dataset, batch_size=4, shuffle=True)
    model = CustomNet(dataset.get(0).num_features, generator=torch.Generator().manual_seed(seed))
    return model, train(model, loader, epochs, device=device)


if __name__ == "__main__":
    main()
