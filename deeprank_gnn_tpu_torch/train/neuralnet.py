"""NeuralNet: the scoring engine (serving subset).

The port's counterpart of ``deeprank_gnn_tpu/train/neuralnet.py``, with
the reference engine's API (reference `NeuralNet.py:18-26`) for scoring
docking models with a pretrained network::

    nn = NeuralNet("graphs.hdf5", GINet, pretrained_model="model.pth.tar")
    nn.test()

- the configuration (features, target, task, classes, threshold, …) is
  restored from the checkpoint, of either flavour (`train/checkpoint.py`);
- clusters are computed into the file when it lacks them (quirk Q8,
  ``precluster_mode``);
- MSE / class-weighted cross-entropy give ``test_loss``; regression
  outputs may pass a sigmoid; class outputs are softmax probabilities;
- predictions, metrics and the epoch-data HDF5 export follow the
  reference (`NeuralNet.py:414-475, 827-872`).

The engine runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
kernels' plain versions) in fp32 with TF32 off, and the scoring pass runs
under ``torch.use_deterministic_algorithms(True)``. Training (``train()``
and the constructor without ``pretrained_model``) comes with slice 2 of
the port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from deeprank_gnn_tpu_torch.data.batch import GraphBatch, GraphLoader
from deeprank_gnn_tpu_torch.data.dataset import (
    GraphListDataSet,
    HDF5DataSet,
    PreCluster,
)
from deeprank_gnn_tpu_torch.data.prefetch import prefetch
from deeprank_gnn_tpu_torch.device import (
    deterministic,
    resolve_device,
    set_fp32_numerics,
)
from deeprank_gnn_tpu_torch.train import checkpoint as ckpt
from deeprank_gnn_tpu_torch.train.losses import cross_entropy_loss, mse_loss
from deeprank_gnn_tpu_torch.train.metrics import Metrics

_TRAINING = (
    "training is not ported yet; the port scores with a pretrained model "
    "(pass pretrained_model=...). See ROADMAP.md, queue 1, slice 2"
)


def _clusters_present(dataset: HDF5DataSet, method: str) -> bool:
    import h5py

    fname, mol = dataset.index_complexes[0]
    with h5py.File(fname, "r") as f:
        path = f"{mol}/clustering/{method}"
        return path in f and "depth_0" in f[path] and "depth_1" in f[path]


class NeuralNet:
    def __init__(
        self,
        database=None,
        Net=None,
        *,
        pretrained_model: Optional[str] = None,
        outdir: str = "./",
        precluster_mode: str = "auto",
        num_buckets: int = 1,
        device="cuda",
    ):
        """``database``: HDF5 file path(s), or a
        :class:`~deeprank_gnn_tpu_torch.data.dataset.GraphListDataSet` of
        graphs already in memory (which carry their clusters).

        ``pretrained_model``: the checkpoint to score with; the features,
        target, task, classes, threshold, batch size and clustering method
        come from it. Without it the constructor would prepare training,
        which is not ported yet, and raises ``NotImplementedError``.

        ``precluster_mode``: 'auto' computes clusters into the file only
        when the checkpoint's method is missing there (quirk Q8); 'force'
        always does; 'never' skips. ``num_buckets > 1`` batches graphs of
        similar size together (see ``GraphLoader``).

        ``device``: ``"cuda"`` (default) or ``"cpu"``. With no CUDA device
        and no ``device="cpu"`` the constructor raises."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_numerics()
        if pretrained_model is None:
            raise NotImplementedError(_TRAINING)
        self.Net = Net
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.precluster_mode = precluster_mode
        self.num_buckets = num_buckets
        self.load_params(pretrained_model)
        self.load_pretrained_model(database, Net)

    # ------------------------------------------------------------------
    # setup

    def _maybe_precluster(self, dataset) -> None:
        if isinstance(dataset, GraphListDataSet):
            return  # in-memory graphs carry their clusters (collate checks)
        if self.cluster_nodes is None or self.precluster_mode == "never":
            return
        if self.cluster_nodes not in ("mcl", "louvain"):
            raise ValueError(
                f"Invalid node clustering method {self.cluster_nodes!r} in the "
                "checkpoint; cluster_nodes must be 'mcl', 'louvain' or None."
            )
        if self.precluster_mode == "force" or not _clusters_present(
            dataset, self.cluster_nodes
        ):
            print("Loading clusters")
            PreCluster(dataset, method=self.cluster_nodes)

    def _make_dataset(self, database):
        if isinstance(database, GraphListDataSet):
            return database
        return HDF5DataSet(
            root="./",
            database=database,
            node_feature=self.node_feature,
            edge_feature=self.edge_feature,
            target=self.target,
            clustering_method=self.cluster_nodes or "mcl",
            tqdm=False,
        )

    def load_pretrained_model(self, database, Net) -> None:
        test_dataset = self._make_dataset(database)
        self._maybe_precluster(test_dataset)
        self.test_loader = GraphLoader(
            test_dataset, batch_size=self.batch_size, num_buckets=self.num_buckets,
        )
        self.valid_loader = None
        print("Test set loaded")
        self.build_model(test_dataset, Net)
        self.set_loss()

    def build_model(self, dataset, Net) -> None:
        """Instantiate the network on the engine's device and load the
        checkpoint's weights into it (reference `put_model_to_device`,
        `NeuralNet.py:195-237`)."""
        self.num_edge_features = len(self.edge_feature)
        first = dataset.get(0)
        num_features = first.num_features
        if self.task == "reg":
            output_shape = 1
        else:
            self.classes_to_idx = {c: i for i, c in enumerate(self.classes)}
            self.idx_to_classes = {i: c for i, c in enumerate(self.classes)}
            self.output_shape = output_shape = len(self.classes)
        # the draws are overwritten by the checkpoint; a private generator
        # leaves the global RNG alone
        self.model = Net(
            num_features, output_shape, self.num_edge_features,
            device=self.device, generator=torch.Generator(),
        )
        state_dict = ckpt.state_dict_from_checkpoint(
            type(self.model).__name__, self._pending_model_state
        )
        self.model.load_state_dict(state_dict)
        self.model.eval()

    def set_loss(self) -> None:
        """Select loss; compute inverse-frequency class weights if asked
        (reference `NeuralNet.py:239-263`)."""
        self.weights = None
        if self.task == "class":
            if self.class_weights is True:
                w = self.compute_class_weights(self.test_loader.dataset)
            elif self.class_weights not in (None, False):
                w = np.array(self.class_weights, dtype=np.float32)
            else:
                return
            self.weights = torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def compute_class_weights(self, ds) -> np.ndarray:
        """Normalized inverse-frequency class weights over a dataset
        (reference `NeuralNet.py:581-594`)."""
        targets_all = np.array(
            [
                t
                for t in (ds.get_target(i) for i in range(len(ds)))
                if t is not None
            ],
            dtype=np.float32,
        )
        counts = np.array(
            [(targets_all == float(c)).sum() for c in self.classes],
            dtype=np.float32,
        )
        print(f"class occurences: {counts}")
        w = 1.0 / np.maximum(counts, 1.0)
        w = w / w.sum()
        print(f"class weights: {w}")
        return w

    def _loss_and_pred(self, batch: GraphBatch):
        pred = self.model(batch)
        if self.task == "class":
            loss = cross_entropy_loss(pred, batch.y.long(), batch.y_mask, self.weights)
        else:
            p = pred.reshape(-1)
            if self.transform_sigmoid:
                p = torch.sigmoid(p)
            pred = p
            loss = mse_loss(p, batch.y, batch.y_mask)
        return loss, pred

    # ------------------------------------------------------------------
    # target/output mapping

    def _map_targets_host(self, batch: GraphBatch) -> GraphBatch:
        """classes_to_idx remap for class tasks (reference
        `format_output`, `NeuralNet.py:616-631`), on the host."""
        if self.task != "class":
            return batch
        mapped = np.array(
            [self.classes_to_idx.get(int(v), 0) for v in batch.y.numpy()],
            dtype=np.float32,
        )
        return dataclasses.replace(batch, y=torch.from_numpy(mapped))

    # ------------------------------------------------------------------
    # the scoring pass

    def _collect_batch(self, acc, pred, mols, y_host, mask_host) -> None:
        """Per-batch host bookkeeping: predictions, aligned (pred, target)
        pairs for metrics, raw outputs, molecule names."""
        out, out_m, raw_outputs, ys, data = acc
        g_real = len(mols)
        valid = mask_host[:g_real]
        if self.task == "class":
            probs = torch.softmax(torch.from_numpy(pred), dim=1).numpy()
            raw_outputs += probs[:g_real].tolist()
            labels = np.argmax(probs[:g_real], axis=1)
            batch_out = labels.tolist()
        else:
            raw_outputs += pred[:g_real].tolist()
            batch_out = pred[:g_real].tolist()
        out += batch_out
        # metrics need aligned (prediction, target) pairs: keep only
        # graphs that actually carry the target (y_mask)
        out_m += [o for o, v in zip(batch_out, valid) if v]
        ys += y_host[:g_real][valid].tolist()
        data["mol"] += mols

    def _finish_pass_data(self, data, out, raw_outputs, ys) -> None:
        if self.task == "class":
            data["targets"] += [self.idx_to_classes[int(x)] for x in ys]
            data["outputs"] += [self.idx_to_classes[int(x)] for x in out]
        else:
            data["targets"] += ys
            data["outputs"] += out
        data["raw_outputs"] += raw_outputs

    def _run_pass(self, loader: GraphLoader, training: bool = False):
        """One pass over ``loader``: host collation on a worker thread,
        asynchronous copies to the device, the forward pass under
        deterministic algorithms. Returns ``(out, out_m, ys, loss,
        data)``."""
        if training:
            raise NotImplementedError(_TRAINING)
        out, out_m, raw_outputs, ys = [], [], [], []
        data = {"outputs": [], "raw_outputs": [], "targets": [], "mol": []}
        running_loss = 0.0

        def _prepared():
            for batch, mols in loader:
                hb = self._map_targets_host(batch)
                yield hb, (mols, hb.y.numpy(), hb.y_mask.numpy())

        self.model.eval()
        with torch.inference_mode(), deterministic():
            for batch, (mols, y_host, mask_host) in prefetch(_prepared(), self.device):
                loss, pred = self._loss_and_pred(batch)
                running_loss += float(loss)
                self._collect_batch(
                    (out, out_m, raw_outputs, ys, data),
                    pred.cpu().numpy(), mols, y_host, mask_host,
                )
        self._finish_pass_data(data, out, raw_outputs, ys)
        return out, out_m, ys, running_loss, data

    def train(self, *args, **kwargs) -> None:
        raise NotImplementedError(_TRAINING)

    def test(
        self,
        database_test=None,
        threshold: float = 4,
        hdf5: str = "test_data.hdf5",
    ) -> None:
        """Score the test set (or ``database_test``), set ``test_out``,
        ``test_y``, ``test_acc`` and ``test_loss``, and export them to
        ``hdf5`` in ``outdir`` (reference `NeuralNet.py:357-412`)."""
        import h5py

        fname = self.update_name(hdf5, self.outdir)
        with h5py.File(fname, "w") as self.f5:
            if database_test is not None:
                test_dataset = self._make_dataset(database_test)
                self._maybe_precluster(test_dataset)
                self.test_loader = GraphLoader(
                    test_dataset, batch_size=self.batch_size,
                    num_buckets=self.num_buckets,
                )
                print("Test set loaded")
            self.data = {}
            _out, _out_m, _y, _test_loss, self.data["test"] = self._run_pass(
                self.test_loader, training=False
            )
            self.test_out = _out
            self._test_out_m = _out_m
            if len(_y) == 0:
                self.test_y = None
                self.test_acc = None
            else:
                self.test_y = _y
                self.test_acc = self.get_metrics("test", threshold).accuracy
            self.test_loss = _test_loss
            self._export_epoch_hdf5(0, self.data)

    def eval(self, loader: GraphLoader):
        """Evaluate a loader (reference `NeuralNet.py:414-475`)."""
        return self._run_pass(loader, training=False)

    # ------------------------------------------------------------------
    # metrics / persistence

    def get_metrics(self, data: str = "eval", threshold: float = 4.0, binary=True):
        if self.task == "class":
            threshold = self.classes_to_idx[threshold]
        if data == "eval":
            pred, y = getattr(self, "_valid_out_m", self.valid_out), self.valid_y
        elif data == "train":
            pred, y = getattr(self, "_train_out_m", self.train_out), self.train_y
        elif data == "test":
            pred, y = getattr(self, "_test_out_m", self.test_out), self.test_y
        else:
            raise ValueError(data)
        return Metrics(pred, y, self.target, threshold, binary)

    @staticmethod
    def update_name(hdf5: str, outdir: str) -> str:
        fname = os.path.join(outdir, hdf5)
        count = 0
        hdf5_name = hdf5.split(".")[0]
        while os.path.exists(fname):
            count += 1
            hdf5 = f"{hdf5_name}_{count:03d}.hdf5"
            fname = os.path.join(outdir, hdf5)
        return fname

    def load_params(self, filename: str) -> None:
        state = ckpt.load_state(filename)
        self.node_feature = state["node"]
        self.edge_feature = state["edge"]
        self.target = state["target"]
        self.batch_size = state["batch_size"]
        self.percent = state["percent"]
        self.lr = state["lr"]
        self.index = state["index"]
        self.class_weights = state["class_weight"]
        self.task = state["task"]
        self.classes = list(state["classes"])
        self.threshold = state["threshold"]
        self.shuffle = state["shuffle"]
        self.cluster_nodes = state["cluster_nodes"]
        self.transform_sigmoid = state["transform_sigmoid"]
        self.train_loss = list(state.get("train_loss", []))
        self.valid_loss = list(state.get("valid_loss", []))
        self.train_acc = list(state.get("train_acc", []))
        self.valid_acc = list(state.get("valid_acc", []))
        self._pending_model_state = state

    def _export_epoch_hdf5(self, epoch: int, data: dict) -> None:
        """Epoch data export (reference `NeuralNet.py:827-872`)."""
        import h5py

        grp = self.f5.create_group(f"epoch_{epoch:04d}")
        grp.attrs["task"] = self.task
        grp.attrs["target"] = self.target
        grp.attrs["batch_size"] = self.batch_size
        for pass_type, pass_data in data.items():
            try:
                sg = grp.create_group(pass_type)
                for data_name, data_value in pass_data.items():
                    if data_name == "mol":
                        string_dt = h5py.special_dtype(vlen=str)
                        sg.create_dataset(
                            data_name,
                            data=np.array(data_value, dtype=object),
                            dtype=string_dt,
                        )
                    else:
                        sg.create_dataset(data_name, data=data_value)
            except TypeError:
                raise ValueError("Error in export epoch to hdf5")
