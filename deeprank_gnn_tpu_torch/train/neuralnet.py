"""NeuralNet: the training, evaluation and scoring engine.

The port's counterpart of ``deeprank_gnn_tpu/train/neuralnet.py``, with the
reference engine's API (reference `NeuralNet.py:18-26`)::

    nn = NeuralNet("graphs.hdf5", GINet, target="fnat", percent=[0.8, 0.2])
    nn.train(nepoch=10, validate=True, save_model="best")

    nn = NeuralNet("graphs.hdf5", GINet, pretrained_model="model.pth.tar")
    nn.test()

- task inference from the target, threshold defaults, the train/valid split
  (``DivideDataSet``) or an independent eval set (reference
  `NeuralNet.py:64-85, 148-178`);
- MSE / class-weighted cross-entropy; regression outputs may pass a
  sigmoid; class outputs are softmax probabilities (`:239-263`);
- ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the counterpart of
  the JAX package's ``optax.flatten(optax.adam(...))``. Every parameter
  gets a gradient each step, the dead attention parameters of quirk Q1 a
  zero one, so Adam keeps moments for all of them as the reference does;
- best/last checkpoints with the reference's file names and format
  (`:326-355`, ``train/checkpoint.py``), epoch-data HDF5 export
  (`:827-872`); a pretrained load restores the configuration and the Adam
  moments of either checkpoint flavour, and the dropout generator's state
  of a port checkpoint saved on the same device type, and can resume
  training;
- clusters are computed into the file when it lacks them (quirk Q8,
  ``precluster_mode``).

``layout="sparse"`` (default) runs the conv aggregations as kernel K1,
``layout="dense"`` as kernel K3 (``models/ginet.py``); ``device_cache``
keeps the dense-collated dataset in device memory and, by default, takes
the models' operator path (``data/device_store.py``). The engine runs on
``device`` (default ``"cuda"``; ``"cpu"`` runs the kernels' plain versions)
in fp32 with TF32 off, every pass under
``torch.use_deterministic_algorithms(True)``, dropout drawing from a
generator on the engine's device seeded from ``seed``: the same seed gives
the same run. Options of the JAX engine that are not ported raise
``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from time import time
from typing import Optional, Sequence

import numpy as np
import torch

from deeprank_gnn_tpu_torch.data.batch import GraphLoader
from deeprank_gnn_tpu_torch.data.dataset import (
    DivideDataSet,
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

REG_TARGETS = ("irmsd", "lrmsd", "fnat", "dockQ")
CLASS_TARGETS = ("bin_class", "capri_classes")
# the checkpoint key of the dropout generator's state (the JAX package keeps
# its PRNG key under "rng" and ignores this one)
DROPOUT_KEY = "dropout_generator"


# the ROADMAP.md queue 1 item of the store's options that are not ported yet
_SCANNED = "scanned epochs, the executable cache and the fast mode"


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, queue 1 ({where})")


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported on first use (the
    card's machine has no matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


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
        node_feature: Sequence[str] = ("type", "polarity", "bsa"),
        edge_feature: Sequence[str] = ("dist",),
        target: Optional[str] = "irmsd",
        lr: float = 0.01,
        batch_size: int = 32,
        percent=(1.0, 0.0),
        database_eval=None,
        index=None,
        class_weights=None,
        task: Optional[str] = None,
        classes=(0, 1),
        threshold: Optional[float] = None,
        pretrained_model: Optional[str] = None,
        shuffle: bool = True,
        outdir: str = "./",
        cluster_nodes: Optional[str] = "mcl",
        transform_sigmoid: bool = False,
        precluster_mode: str = "auto",
        seed: int = 0,
        layout: str = "sparse",
        mesh=None,
        num_buckets: int = 1,
        executable_cache_dir: Optional[str] = None,
        device_cache: bool = False,
        scan_epochs=False,
        scan_unroll: int = 1,
        store_pack: str = "lossless",
        device_cache_bytes: Optional[int] = None,
        *,
        device="cuda",
    ):
        """The JAX engine's constructor (same arguments and defaults).

        ``database``: HDF5 file path(s), or a
        :class:`~deeprank_gnn_tpu_torch.data.dataset.GraphListDataSet` of
        graphs already in memory (which carry their clusters).

        Without ``pretrained_model`` the constructor prepares training: the
        dataset is split by ``percent`` (seeded by ``seed``), the model is
        drawn from ``seed``. With it, the configuration (features, target,
        task, classes, threshold, batch size, clustering method, …), the
        weights and the Adam moments come from the checkpoint, and the
        engine can ``test()`` or go on training (``train_loader`` is a
        shuffled loader over the same data).

        ``layout``: ``"sparse"`` (default) or ``"dense"``.
        ``precluster_mode``: 'auto' computes clusters into the file only
        when the method is missing there (quirk Q8); 'force' always does;
        'never' skips. ``num_buckets > 1`` batches graphs of similar size
        together in the sparse layout (see ``GraphLoader``).

        ``device_cache`` (dense layout): ``True`` keeps the dense-collated
        dataset in device memory and gathers every batch there,
        ``"chunked"`` rotates it through the device in chunks; with the
        cache on, batches carry the precomputed operators. A store whose
        estimate exceeds ``device_cache_bytes`` (default: the loader's
        2 GiB) streams instead, and says so. ``store_pack``: "lossless"
        (default) or "bf16" (raw fp32 payloads of the store in bfloat16).
        Every loader the engine builds gets these three.

        ``device``: ``"cuda"`` (default) or ``"cpu"``. With no CUDA device
        and no ``device="cpu"`` the constructor raises.

        ``mesh``, ``layout="halo"``, ``executable_cache_dir`` and
        ``scan_epochs`` (and ``scan_unroll``) are not ported yet and raise
        ``NotImplementedError``."""
        if layout not in ("sparse", "dense", "halo"):
            raise ValueError(f"unknown layout {layout!r}")
        if mesh is not None or layout == "halo":
            raise _unported("mesh and layout='halo'", "multi-device")
        if executable_cache_dir is not None:
            raise _unported("executable_cache_dir", _SCANNED)
        if scan_epochs or scan_unroll != 1:
            raise _unported("scan_epochs and scan_unroll", _SCANNED)
        if device_cache and layout != "dense":
            raise ValueError("device_cache requires layout='dense'")
        self.device_cache = device_cache
        self.store_pack = store_pack
        self.device_cache_bytes = device_cache_bytes
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_fp32_numerics()
        self.Net = Net
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.precluster_mode = precluster_mode
        self.seed = seed
        self.layout = layout
        self.num_buckets = num_buckets
        self._pending_model_state = None

        if pretrained_model is None:
            self.node_feature = list(node_feature)
            self.edge_feature = list(edge_feature)
            self.target = target
            self.lr = lr
            self.batch_size = batch_size
            self.percent = list(percent)
            self.index = index
            self.class_weights = class_weights
            self.task = task
            self.classes = list(classes)
            self.threshold = threshold
            self.shuffle = shuffle
            self.cluster_nodes = cluster_nodes
            self.transform_sigmoid = transform_sigmoid
            if self.task is None:
                if self.target in REG_TARGETS:
                    self.task = "reg"
                elif self.target in CLASS_TARGETS:
                    self.task = "class"
                else:
                    raise ValueError(
                        "User target detected -> The task argument is "
                        "required ('class' or 'reg')."
                    )
            if self.task == "class" and self.threshold is None:
                print(
                    "the threshold for accuracy computation is set to "
                    f"{self.classes[1]}"
                )
                self.threshold = self.classes[1]
            if self.task == "reg" and self.threshold is None:
                print("the threshold for accuracy computation is set to 0.3")
                self.threshold = 0.3
            self.load_model(database, Net, database_eval)
        else:
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
                f"Invalid node clustering method {self.cluster_nodes!r}; "
                "cluster_nodes must be 'mcl', 'louvain' or None."
            )
        if self.precluster_mode == "force" or not _clusters_present(
            dataset, self.cluster_nodes
        ):
            print("Loading clusters")
            PreCluster(dataset, method=self.cluster_nodes)

    def _make_dataset(self, database, index=None):
        if isinstance(database, GraphListDataSet):
            return database if index is None else database.subset(index)
        return HDF5DataSet(
            root="./",
            database=database,
            index=index,
            node_feature=self.node_feature,
            edge_feature=self.edge_feature,
            target=self.target,
            clustering_method=self.cluster_nodes or "mcl",
            tqdm=False,
        )

    def _loader(self, dataset, **kw) -> GraphLoader:
        """A loader of the engine's layout, batch size and store settings
        (JAX ``train/neuralnet.py:316-385``)."""
        if self.device_cache_bytes is not None:
            kw["device_cache_bytes"] = self.device_cache_bytes
        return GraphLoader(dataset, batch_size=self.batch_size, layout=self.layout,
                           device_cache=self.device_cache, store_pack=self.store_pack,
                           device=self.device, **kw)

    def load_model(self, database, Net, database_eval) -> None:
        """Datasets, loaders, model and loss for training (reference
        `NeuralNet.py:148-193`)."""
        dataset = self._make_dataset(database, self.index)
        self._maybe_precluster(dataset)
        train_dataset, valid_dataset = DivideDataSet(
            dataset, percent=self.percent, seed=self.seed
        )
        kw = dict(shuffle=self.shuffle, seed=self.seed, num_buckets=self.num_buckets)
        self.train_loader = self._loader(train_dataset, **kw)
        print("Training set loaded")
        self.valid_loader = None
        if self.percent[1] > 0.0:
            self.valid_loader = self._loader(valid_dataset, **kw)
            print("Evaluation set loaded")
        if database_eval is not None:
            eval_dataset = self._make_dataset(database_eval, self.index)
            self._maybe_precluster(eval_dataset)
            self.valid_loader = self._loader(eval_dataset, **kw)
            print("Independent validation set loaded !")
        self.build_model(dataset, Net)
        self.set_loss()
        self.train_acc = []
        self.train_loss = []
        self.valid_acc = []
        self.valid_loss = []

    def load_pretrained_model(self, database, Net) -> None:
        """Test loader, and a shuffled train loader over the same data so
        that a reloaded checkpoint can go on training (the reference can
        only test after a reload). The test loader has one bucket whatever
        ``num_buckets`` is, as in the JAX package, so graphs are scored in
        the dataset's order."""
        test_dataset = self._make_dataset(database)
        self._maybe_precluster(test_dataset)
        self.test_loader = self._loader(test_dataset)
        self.train_loader = self._loader(test_dataset, shuffle=True, seed=self.seed)
        self.valid_loader = None
        print("Test set loaded")
        self.build_model(test_dataset, Net)
        self.set_loss()

    def build_model(self, dataset, Net) -> None:
        """The network on the engine's device (reference
        `put_model_to_device`, `NeuralNet.py:195-237`), drawn from ``seed``
        or loaded from the pending checkpoint, its Adam optimizer (with the
        checkpoint's moments, when it has some that fit) and the dropout
        generator (seeded from ``seed``, or the checkpoint's saved state
        when it was saved on the same device type, as the JAX package
        carries on from its saved PRNG key)."""
        self.num_edge_features = len(self.edge_feature)
        num_features = dataset.get(0).num_features
        if self.task == "reg":
            output_shape = 1
        else:
            self.classes_to_idx = {c: i for i, c in enumerate(self.classes)}
            self.idx_to_classes = {i: c for i, c in enumerate(self.classes)}
            self.output_shape = output_shape = len(self.classes)
        # a private generator leaves the global RNG alone
        self.model = Net(
            num_features, output_shape, self.num_edge_features,
            device=self.device, generator=torch.Generator().manual_seed(self.seed),
        )
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8
        )
        self._dropout_generator = torch.Generator(device=self.device).manual_seed(self.seed)
        payload = self._pending_model_state
        if payload is None:
            return
        self.model.load_state_dict(
            ckpt.state_dict_from_checkpoint(type(self.model).__name__, payload)
        )
        moments = ckpt.adam_state_from_checkpoint(payload, list(self.model.parameters()))
        if moments is not None:
            state = self.optimizer.state_dict()
            state["state"] = moments
            self.optimizer.load_state_dict(state)
        elif payload.get("optimizer"):
            print(
                "optimizer state in checkpoint does not match the current "
                "optimizer; starting moments fresh"
            )
        saved = payload.get(DROPOUT_KEY)
        if saved is not None and saved["device"] == self.device.type:
            self._dropout_generator.set_state(
                torch.from_numpy(np.array(saved["state"], dtype=np.uint8)))
        else:
            why = ("the checkpoint holds no dropout generator state" if saved is None else
                   f"the checkpoint's dropout generator state is for {saved['device']}, "
                   f"not {self.device.type}")
            print(f"{why}; dropout seeded from seed {self.seed}")

    def set_loss(self) -> None:
        """Select loss; compute inverse-frequency class weights if asked
        (reference `NeuralNet.py:239-263`)."""
        self.weights = None
        if self.task == "class":
            if self.class_weights is True:
                w = self.compute_class_weights()
            elif self.class_weights not in (None, False):
                w = np.array(self.class_weights, dtype=np.float32)
            else:
                return
            self.weights = torch.as_tensor(w, dtype=torch.float32, device=self.device)

    def compute_class_weights(self) -> np.ndarray:
        """Normalized inverse-frequency class weights over the training
        set (reference `NeuralNet.py:581-594`)."""
        ds = self.train_loader.dataset
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

    def _loss_and_pred(self, batch, generator: Optional[torch.Generator] = None):
        pred = self.model(batch, generator)
        if self.task == "class":
            loss = cross_entropy_loss(pred, batch.y.long(), batch.y_mask, self.weights)
        else:
            p = pred.reshape(-1)
            if self.transform_sigmoid:
                p = torch.sigmoid(p)
            pred = p
            loss = mse_loss(p, batch.y, batch.y_mask)
        return loss, pred

    def _train_step(self, batch):
        """One Adam step on ``batch``; returns the loss and predictions
        before the update (as the JAX package's jitted step does)."""
        self.optimizer.zero_grad(set_to_none=False)
        loss, pred = self._loss_and_pred(batch, self._dropout_generator)
        loss.backward()
        for p in self.model.parameters():
            # Q1's dead parameters get no gradient from autograd; a zero
            # one keeps them in Adam's state, as in the reference
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach(), pred.detach()

    def _eval_step(self, batch):
        """Loss and predictions of ``batch`` in evaluation mode, without
        gradients (the JAX package's jitted ``eval_step``)."""
        self.model.eval()
        with torch.inference_mode(), deterministic():
            return self._loss_and_pred(batch.to(self.device))

    # ------------------------------------------------------------------
    # target/output mapping

    def _map_targets_host(self, batch):
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
    # passes

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
        asynchronous copies to the device, and per batch an Adam step
        (``training``) or a forward pass, under deterministic algorithms.
        Returns ``(out, out_m, ys, loss, data)``; ``loss`` sums the
        batches' losses."""
        out, out_m, raw_outputs, ys = [], [], [], []
        data = {"outputs": [], "raw_outputs": [], "targets": [], "mol": []}
        running_loss = 0.0

        def _prepared():
            for batch, mols in loader:
                hb = self._map_targets_host(batch)
                yield hb, (mols, hb.y.numpy(), hb.y_mask.numpy())

        self.model.train(training)
        grad_mode = contextlib.nullcontext() if training else torch.inference_mode()
        with grad_mode, deterministic():
            for batch, (mols, y_host, mask_host) in prefetch(_prepared(), self.device):
                if training:
                    loss, pred = self._train_step(batch)
                else:
                    loss, pred = self._loss_and_pred(batch)
                running_loss += float(loss)
                self._collect_batch(
                    (out, out_m, raw_outputs, ys, data),
                    pred.cpu().numpy(), mols, y_host, mask_host,
                )
        self.model.eval()
        self._finish_pass_data(data, out, raw_outputs, ys)
        return out, out_m, ys, running_loss, data

    def train(
        self,
        nepoch: int = 1,
        validate: bool = False,
        save_model: str = "last",
        hdf5: str = "train_data.hdf5",
        save_epoch: str = "intermediate",
        save_every: int = 5,
        profile: Optional[str] = None,
    ) -> None:
        """Train for ``nepoch`` epochs (reference `NeuralNet.py:265-355`
        semantics): per epoch a training pass, a validation pass when
        ``validate``, checkpoints (``save_model`` "last" or "best") and the
        epoch-data export to ``hdf5`` in ``outdir`` (every epoch with
        ``save_epoch="all"``, every ``save_every`` with "intermediate", and
        the last). ``profile``: a directory; the second epoch's training
        pass is recorded with ``torch.profiler`` (host activity, and the
        card's on a card) and written there as a Chrome trace that
        TensorBoard reads (JAX ``train/neuralnet.py:1078-1110``)."""
        import h5py

        fname = self.update_name(hdf5, self.outdir)
        with h5py.File(fname, "w") as self.f5:
            self.nepoch = nepoch
            self.data = {}
            for epoch in range(1, nepoch + 1):
                recorder = (self._profiler(profile) if profile is not None and epoch == 2
                            else contextlib.nullcontext())
                t0 = time()
                with recorder:
                    _out, _out_m, _y, _loss, self.data["train"] = self._run_pass(
                        self.train_loader, training=True
                    )
                t = time() - t0
                self.train_loss.append(_loss)
                self.train_out = _out
                self._train_out_m = _out_m
                self.train_y = _y
                _acc = self.get_metrics("train", self.threshold).accuracy
                self.train_acc.append(_acc)
                self.print_epoch_data("train", epoch, _loss, _acc, t)

                if validate:
                    t0 = time()
                    _out, _out_m, _y, _val_loss, self.data["eval"] = self._run_pass(
                        self.valid_loader, training=False
                    )
                    t = time() - t0
                    self.valid_loss.append(_val_loss)
                    self.valid_out = _out
                    self._valid_out_m = _out_m
                    self.valid_y = _y
                    _val_acc = self.get_metrics("eval", self.threshold).accuracy
                    self.valid_acc.append(_val_acc)
                    self.print_epoch_data("valid", epoch, _val_loss, _val_acc, t)
                    if save_model == "best" and min(self.valid_loss) == _val_loss:
                        self.save_model(filename=self._ckpt_name(nepoch, epoch))
                elif save_model == "best" and min(self.train_loss) == _loss:
                    print(
                        "WARNING: The training set is used both for "
                        "learning and model selection."
                    )
                    self.save_model(filename=self._ckpt_name(nepoch, epoch))

                if (save_epoch == "all") or (epoch == nepoch):
                    self._export_epoch_hdf5(epoch, self.data)
                elif save_epoch == "intermediate" and epoch % save_every == 0:
                    self._export_epoch_hdf5(epoch, self.data)

            if save_model == "last":
                self.save_model(filename=self._ckpt_name(nepoch))

    def _profiler(self, outdir: str):
        """A ``torch.profiler`` recording that writes its trace into
        ``outdir`` when it ends."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(outdir))

    def _ckpt_name(self, nepoch: int, epoch: Optional[int] = None) -> str:
        base = (
            f"t{self.task}_y{self.target}_b{self.batch_size}"
            f"_e{nepoch}_lr{self.lr}"
        )
        if epoch is not None:
            base += f"_{epoch}"
        return base + ".pth.tar"

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
                self.test_loader = self._loader(test_dataset)  # one bucket, as in JAX
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
    def print_epoch_data(stage, epoch, loss, acc, t):
        acc_str = "None" if acc is None else f"{acc:1.4e}"
        print(
            f"Epoch [{epoch:04d}] : {stage} loss {loss:e} | "
            f"accuracy {acc_str} | time {t:1.2e} sec."
        )

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

    def save_model(self, filename: str = "model.pth.tar") -> None:
        """Write a reference-format torch checkpoint (``model`` a state
        dict, ``optimizer`` the torch Adam state), with the JAX package's
        resume keys (loss and accuracy history) and the dropout generator's
        state and device type under ``DROPOUT_KEY`` (a uint8 numpy array,
        which both packages' loaders read), so that a reloaded engine on the
        same device type goes on with the same dropout stream. Lands in
        ``outdir`` unless ``filename`` has a directory. It holds no ``rng``
        entry: the JAX package would read one as its PRNG key."""
        if not os.path.dirname(filename):
            filename = os.path.join(self.outdir, filename)
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "net": type(self.model).__name__,
            "node": self.node_feature,
            "edge": self.edge_feature,
            "target": self.target,
            "task": self.task,
            "classes": self.classes,
            "class_weight": self.class_weights,
            "batch_size": self.batch_size,
            "percent": self.percent,
            "lr": self.lr,
            "index": self.index,
            "shuffle": self.shuffle,
            "threshold": self.threshold,
            "cluster_nodes": self.cluster_nodes,
            "transform_sigmoid": self.transform_sigmoid,
            "train_loss": list(getattr(self, "train_loss", [])),
            "valid_loss": list(getattr(self, "valid_loss", [])),
            "train_acc": list(getattr(self, "train_acc", [])),
            "valid_acc": list(getattr(self, "valid_acc", [])),
            DROPOUT_KEY: {
                "device": self._dropout_generator.device.type,
                "state": self._dropout_generator.get_state().numpy(),
            },
        }
        ckpt.save_state(filename, state)

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

    def plot_loss(self, name: str = "") -> None:
        """Train and valid loss per epoch into ``loss_epoch{name}.png`` in
        ``outdir`` (matplotlib, imported here, with the Agg backend)."""
        self._plot_curves(self.train_loss, self.valid_loss, "Loss/ epoch", "Total loss",
                          f"loss_epoch{name}.png")

    def plot_acc(self, name: str = "") -> None:
        """Train and valid accuracy per epoch into ``acc_epoch{name}.png``."""
        self._plot_curves(self.train_acc, self.valid_acc, "Accuracy/ epoch", "Accuracy",
                          f"acc_epoch{name}.png")

    def _plot_curves(self, train_vals, valid_vals, title, ylabel, fname):
        plt = _pyplot()
        # the x-axis follows the history's length (epochs restored from a
        # checkpoint included), not only the last train() call
        if len(valid_vals) > 1:
            plt.plot(range(1, len(valid_vals) + 1), valid_vals, c="red", label="valid")
        if len(train_vals) > 1:
            plt.plot(range(1, len(train_vals) + 1), train_vals, c="blue", label="train")
            plt.title(title)
            plt.xlabel("Number of epoch")
            plt.ylabel(ylabel)
            plt.legend()
            plt.savefig(os.path.join(self.outdir, fname))
            plt.close()

    def plot_hit_rate(self, data: str = "eval", threshold: float = 4,
                      mode: str = "percentage", name: str = "") -> None:
        """The hit rate of ``data`` ("eval", "train" or "test") into
        ``hitrate{name}.png``; prints instead when the task has none."""
        plt = _pyplot()
        try:
            hitrate = self.get_metrics(data, threshold).hitrate()
            X = range(1, len(hitrate) + 1)
            if mode == "percentage":
                hitrate = hitrate / max(hitrate.sum(), 1)
            plt.plot(X, hitrate, c="blue", label="train")
            plt.title("Hit rate")
            plt.xlabel("Number of models")
            plt.ylabel("Hit Rate")
            plt.legend()
            plt.savefig(os.path.join(self.outdir, f"hitrate{name}.png"))
            plt.close()
        except Exception:
            print(f"No hit rate plot could be generated for you {self.task} task")

    def plot_scatter(self) -> None:
        """Predictions against targets of the train (blue) and valid (red)
        loaders into ``scatter.png``. It iterates the loaders, so it draws
        from their shuffle streams as the JAX package does."""
        plt = _pyplot()
        pred, truth = {"train": [], "valid": []}, {"train": [], "valid": []}
        loaders = [("train", self.train_loader)]
        if self.valid_loader is not None:
            loaders.append(("valid", self.valid_loader))
        for split, loader in loaders:
            for batch, mols in loader:
                _, p = self._eval_step(batch)
                g = len(mols)
                truth[split] += batch.y.cpu().numpy()[:g].tolist()
                pred[split] += p.cpu().numpy().reshape(-1)[:g].tolist()
        plt.scatter(truth["train"], pred["train"], c="blue")
        plt.scatter(truth["valid"], pred["valid"], c="red")
        plt.savefig(os.path.join(self.outdir, "scatter.png"))
        plt.close()

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
