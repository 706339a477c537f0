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
the models' operator path (``data/device_store.py``); ``scan_epochs`` runs
each epoch over that store as replays of one captured step and reads the
results back once (``train/scan.py``); ``dense_fast`` gives GINet's dense
aggregations bf16 operands. ``mesh`` (``parallel/mesh.py``) trains and
serves over the ranks of a process group: graph-parallel in the sparse and
dense layouts (``parallel/step.py``), edge-parallel with the explicit halo
exchange under ``layout="halo"`` (``parallel/halo.py``). The engine runs on
``device`` (default ``"cuda"``; ``"cpu"`` runs the kernels' plain versions)
in fp32 with TF32 off, every pass under
``torch.use_deterministic_algorithms(True)``, dropout drawing from a
generator on the engine's device seeded from ``seed``: the same seed gives
the same run. Scanned epochs and the chunked store also run on a dense
mesh: each rank holds the whole store and steps over its columns of every
batch's slots, and the gradient all-reduce is the step's only collective.
On a card the step is captured with its all-reduce under NCCL, and split
around it (two graphs, the all-reduce issued by the host) under gloo,
whose collectives stage CUDA tensors through the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
from time import time
from typing import Optional, Sequence

import numpy as np
import torch

from deeprank_gnn_tpu_torch import trace
from deeprank_gnn_tpu_torch.data.batch import GraphLoader, RankBatch
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
from deeprank_gnn_tpu_torch.ops.lanes import ACCUMULATED
from deeprank_gnn_tpu_torch.train import checkpoint as ckpt
from deeprank_gnn_tpu_torch.train.aot import use_executable_cache
from deeprank_gnn_tpu_torch.train.losses import cross_entropy_loss, mse_loss
from deeprank_gnn_tpu_torch.train.metrics import Metrics
from deeprank_gnn_tpu_torch.train.scan import EpochSteps, gather_store_batch

REG_TARGETS = ("irmsd", "lrmsd", "fnat", "dockQ")
CLASS_TARGETS = ("bin_class", "capri_classes")
# the checkpoint key of the dropout generator's state (the JAX package keeps
# its PRNG key under "rng" and ignores this one)
DROPOUT_KEY = "dropout_generator"


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


def _epoch_loss(losses) -> float:
    """An epoch's loss from its batches' losses: their sum in batch order,
    in Python floats, as the per-batch loop adds them up (not ``sum()``,
    which compensates its rounding since Python 3.12)."""
    total = 0.0
    for loss in losses:
        total += float(loss)
    return total


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
        dense_fast: bool = False,
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

        ``scan_epochs`` (with ``device_cache``): ``True`` runs each epoch
        over the store as replays of one captured step and reads its
        results back once (``train/scan.py``); ``"full"`` (with
        ``device_cache=True``) runs a whole ``train()`` call so, validation
        and best-model selection included, and reads back once at its end.
        ``scan_unroll``: steps per captured graph. Without a store (empty
        dataset, over the byte budget) an epoch runs the per-batch loop.

        ``executable_cache_dir``: the directory the hand kernels are built
        in and found in (``train/aot.py``).

        ``dense_fast`` (dense layout, GINet): the paper-mode aggregations
        with bf16 operands and fp32 accumulation, the JAX package's
        ``DRGNN_DENSE_FAST``.

        ``device``: ``"cuda"`` (default) or ``"cpu"``. With no CUDA device
        and no ``device="cpu"`` the constructor raises.

        ``mesh``: a :class:`~deeprank_gnn_tpu_torch.parallel.mesh.Mesh`
        (``parallel.make_mesh()``) over the ranks of a process group
        (``parallel.distributed.initialize``); every rank constructs the
        engine with the same arguments (and its own ``outdir``), and the
        engine runs on the mesh's device for this rank. The sparse and
        dense layouts are graph-parallel over all ``dp * ep`` ranks: each
        rank runs its contiguous range of each batch's graphs, the loss and
        the gradients are summed over the ranks, every rank sees the whole
        batch's predictions, and the numbers are the single-device ones. In
        the dense layout a streaming rank loads only its slice of each batch
        (``GraphLoader(host_batch_slice=...)``) and its ``*_out`` cover its
        slice; with ``device_cache`` every rank holds the whole store on its
        device. ``layout="halo"`` is the explicit halo-exchange edge
        partition (``parallel/halo.py``; without ``mesh``, over every rank
        of the process group, or this process alone).

        ``scan_epochs`` on a mesh (JAX's scanned multi-chip epochs) needs
        ``layout="dense"`` and a ``batch_size`` divisible by the mesh's
        ranks, and ``device_cache="chunked"`` on a mesh needs
        ``scan_epochs``, as in JAX. Each rank holds the whole store (or
        uploads each chunk whole) and steps over its columns of every
        batch's slots (``parallel.mesh.dense_local_slice``): before a
        pass's first step one all-gather sums every batch's loss
        normalizer, the step's only collective is the gradient all-reduce,
        and after the last step one all-gather sums the loss numerators and
        one collects the predictions (the sums in rank order, as the looped
        step's, ``parallel.collectives.sum_values``), so every number is the
        looped mesh pass's. On a card the backend decides the capture:
        under NCCL a graph holds whole steps, the all-reduce included; under
        gloo, which stages CUDA tensors through the host, each training
        step is two replays around the host's all-reduce and
        ``scan_unroll`` does not join training steps. JAX's check that a
        store is single-process does not apply: one process is one rank
        here, and each rank holds its own store."""
        from deeprank_gnn_tpu_torch.parallel.mesh import Mesh, make_halo_mesh

        if layout not in ("sparse", "dense", "halo"):
            raise ValueError(f"unknown layout {layout!r}")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deeprank_gnn_tpu_torch.parallel.Mesh "
                            f"(parallel.make_mesh()), not {type(mesh).__name__}")
        if layout == "halo" and mesh is None:
            mesh = make_halo_mesh(device=device)
        self.mesh = mesh
        if device_cache and layout != "dense":
            raise ValueError("device_cache requires layout='dense'")
        # the JAX engine's checks of the store and scan options
        # (train/neuralnet.py:140-197)
        if device_cache == "chunked" and mesh is not None and not scan_epochs:
            raise ValueError(
                "device_cache='chunked' on a mesh requires "
                "scan_epochs=True (each chunk uploads replicated and "
                "runs as one scanned multi-chip dispatch)"
            )
        if scan_epochs not in (False, True, "full"):
            raise ValueError("scan_epochs must be False, True or 'full'")
        if scan_epochs and not device_cache:
            raise ValueError(
                "scan_epochs requires device_cache=True or 'chunked'"
            )
        if scan_epochs == "full" and device_cache is not True:
            raise ValueError(
                "scan_epochs='full' requires the in-HBM store "
                "(device_cache=True); the rotating 'chunked' store "
                "supports scan_epochs=True (one dispatch per chunk)"
            )
        if scan_epochs and mesh is not None:
            if layout != "dense":
                raise ValueError("scan_epochs on a mesh needs layout='dense'")
            if batch_size % mesh.size:
                raise ValueError(
                    f"scan_epochs on a mesh needs batch_size ({batch_size}) "
                    f"divisible by device count ({mesh.size})"
                )
        if int(scan_unroll) < 1:
            raise ValueError("scan_unroll must be >= 1")
        if dense_fast and layout != "dense":
            raise ValueError("dense_fast requires layout='dense'")
        self.scan_epochs = scan_epochs
        self.scan_unroll = int(scan_unroll)
        self.dense_fast = dense_fast
        self.executable_cache_dir = executable_cache_dir
        if executable_cache_dir is not None:
            use_executable_cache(executable_cache_dir)
        self.device_cache = device_cache
        self.store_pack = store_pack
        self.device_cache_bytes = device_cache_bytes
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's device is {mesh.device}, not {device}")
            self.device = mesh.device
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

    @property
    def _loader_layout(self) -> str:
        """The loader's collation: the halo layout partitions sparse
        batches (in :meth:`_shard`)."""
        return "sparse" if self.layout == "halo" else self.layout

    def _store_sharding(self):
        """On a mesh with the store on: this rank's device, where its whole
        store lives (JAX ``train/neuralnet.py:267-275``, which replicates
        the store over the mesh); None otherwise."""
        if not self.device_cache or self.mesh is None:
            return None
        return self.device

    def _host_slice(self):
        """Multi-process dense ingest: this rank's slice of every global
        batch (``parallel.mesh.dense_local_slice``; JAX
        ``train/neuralnet.py:277-290``). None single-rank, in the sparse and
        halo layouts (every rank collates the whole batch) and with the
        store (every rank holds it whole)."""
        if (self.mesh is not None and self.mesh.size > 1 and self.layout == "dense"
                and not self.device_cache):
            from deeprank_gnn_tpu_torch.parallel.mesh import dense_local_slice

            return dense_local_slice(self.batch_size, self.mesh)
        return None

    def _graph_share(self):
        """Sparse graph-parallel mesh: the graphs of every global batch that
        this rank collates (``parallel.mesh.graph_range``); None otherwise."""
        if self.mesh is None or self.layout != "sparse":
            return None
        from deeprank_gnn_tpu_torch.parallel.mesh import graph_range

        return graph_range(self.batch_size, self.mesh)

    def _loader(self, dataset, **kw) -> GraphLoader:
        """A loader of the engine's layout, batch size, store and ingest
        settings (JAX ``train/neuralnet.py:316-385``)."""
        if self.device_cache_bytes is not None:
            kw["device_cache_bytes"] = self.device_cache_bytes
        return GraphLoader(dataset, batch_size=self.batch_size, layout=self._loader_layout,
                           device_cache=self.device_cache, store_pack=self.store_pack,
                           host_batch_slice=self._host_slice(),
                           store_sharding=self._store_sharding(), device=self.device,
                           graph_share=self._graph_share(), **kw)

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
        if self.dense_fast:
            if not hasattr(self.model, "dense_fast"):
                raise ValueError(f"dense_fast: {type(self.model).__name__} has no fast mode "
                                 "(GINet's dense aggregations have)")
            self.model.dense_fast = True
        # on a card the step count and bias corrections stay on the device,
        # so that a scanned epoch can capture the update; the per-batch loop
        # takes the same optimizer, so both give the same numbers
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=self.device.type == "cuda",
        )
        self._dropout_generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._scan = EpochSteps(
            self._scan_step, unroll=self.scan_unroll,
            generator=self._dropout_generator if self.device.type == "cuda" else None)
        self._scan_targets = {}
        self._scan_mapped = {}
        self._chunk_buffers = {}
        self._mesh_steps = None
        # the columns of a batch's slots that a scanned step gathers: on a
        # mesh this rank's (``_build_mesh_steps``), else all of them
        self._scan_cols = slice(None)
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
        (reference `NeuralNet.py:239-263`). On a mesh, build the steps with
        them."""
        self.weights = None
        if self.task == "class" and self.class_weights not in (None, False):
            if self.class_weights is True:
                w = self.compute_class_weights()
            else:
                w = np.array(self.class_weights, dtype=np.float32)
            self.weights = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        self._build_mesh_steps()

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

    def _build_mesh_steps(self) -> None:
        """On a mesh, the steps of its layout (JAX ``_build_steps_sharded``
        and ``_build_steps_halo``, ``train/neuralnet.py:543-679``), with the
        loss's class weights; and the placement of a loader batch on this
        rank (:meth:`_shard`). A halo layout over a ``(dp, ep)`` mesh runs
        over the same ranks as a 1-D mesh."""
        if self.mesh is None:
            return
        from deeprank_gnn_tpu_torch.parallel import halo, mesh as M
        from deeprank_gnn_tpu_torch.parallel.collectives import stages_through_host
        from deeprank_gnn_tpu_torch.parallel.step import MeshSteps

        kw = dict(task=self.task, class_weights=self.weights,
                  transform_sigmoid=self.transform_sigmoid)
        self._pred_slice = self._host_slice()
        if self.layout == "halo":
            hmesh = self.mesh
            if hmesh.axis_names != ("ep",):
                hmesh = dataclasses.replace(hmesh, shape=(hmesh.size,), axis_names=("ep",))
            self._mesh_steps = MeshSteps(self.model, self.optimizer, hmesh, halo=True, **kw)
            self._shard = lambda b: halo.shard_halo_batch(
                halo.partition_batch(b, hmesh.size), hmesh)
            return
        self._mesh_steps = MeshSteps(self.model, self.optimizer, self.mesh, **kw)
        if self.scan_epochs:
            # this rank's columns of every batch's slots; the backend
            # decides whether a card captures the step's all-reduce
            self._scan_cols = M.dense_local_slice(self.batch_size, self.mesh)
            if stages_through_host(self.mesh.group, self.device):
                self._scan.split = (self._scan_gradients, self._mesh_steps.reduce_gradients,
                                    self._mesh_steps.apply_gradients)
        if self.layout == "sparse":
            # the loader collated this rank's graphs (``_graph_share``)
            self._shard = lambda b: b
        elif self._pred_slice is not None:
            # the loader loaded only this rank's slice; the predictions
            # come back global, and the pass keeps this slice's
            self._shard = lambda b: M.shard_dense_batch_from_local(b, self.mesh,
                                                                   self.batch_size)
        else:
            self._shard = lambda b: M.shard_dense_batch(b, self.mesh)

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

    def _scan_step(self, store, y_all, idx, training: bool, norm=None):
        """One step of a scanned epoch on the store's slots ``idx``: the
        gather, then an Adam step (``training``) or the forward pass. On a
        mesh ``idx`` are this rank's columns of the batch's slots and
        ``norm`` the batch's global loss normalizer: the step returns this
        rank's loss numerator and predictions, and its gradients are summed
        over the ranks before the update (``parallel/step.py``)."""
        if self.mesh is None:
            batch = gather_store_batch(store, y_all, idx)
            if training:
                return self._train_step(batch)
            return self._loss_and_pred(batch)
        if not training:
            return self._mesh_steps.scan_eval(self._scan_rank_batch(store, y_all, idx))
        out = self._scan_gradients(store, y_all, idx, training, norm)
        self._mesh_steps.reduce_gradients()
        self._mesh_steps.apply_gradients()
        return out

    def _scan_rank_batch(self, store, y_all, idx) -> RankBatch:
        """This rank's columns ``idx`` of a batch's slots, gathered, as its
        part of the global batch."""
        cols = self._scan_cols
        return RankBatch(gather_store_batch(store, y_all, idx), cols.start, cols.stop,
                         self.batch_size)

    def _scan_gradients(self, store, y_all, idx, training: bool, norm):
        """A mesh step's part before its all-reduce (``EpochSteps``'s
        ``split``)."""
        return self._mesh_steps.scan_gradients(self._scan_rank_batch(store, y_all, idx),
                                               self._dropout_generator, norm)

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
        `format_output`, `NeuralNet.py:616-631`), on the host; a mesh
        rank's batch has its own graphs' targets and the global batch's."""
        if self.task != "class":
            return batch

        def mapped(y):
            return torch.from_numpy(np.array(
                [self.classes_to_idx.get(int(v), 0) for v in y.numpy()], dtype=np.float32))

        if isinstance(batch, RankBatch):
            local = dataclasses.replace(batch.batch, y=mapped(batch.batch.y))
            return dataclasses.replace(batch, batch=local, y=mapped(batch.y))
        return dataclasses.replace(batch, y=mapped(batch.y))

    # ------------------------------------------------------------------
    # passes

    def _collect_batch(self, acc, pred, mols, y_host, mask_host) -> None:
        """Per-batch host bookkeeping of the looped passes: one batch's
        real graphs, the first ``len(mols)`` of ``pred``, ``y_host`` and
        ``mask_host``, through :meth:`_collect_batches`."""
        g = len(mols)
        self._collect_batches(acc, pred[None, :g], [mols], y_host[None, :g],
                              mask_host[None, :g])

    def _collect_batches(self, acc, preds, mols_per_batch, y_rows, mask_rows) -> None:
        """Host bookkeeping of batches ``preds [B, width(, classes)]`` with
        their targets and masks ``[B, width]``, batch ``b``'s real graphs the
        first ``len(mols_per_batch[b])`` of its row: predictions, aligned
        (pred, target) pairs for metrics, raw outputs, molecule names, in
        batch order, with one array operation each for all ``B``."""
        out, out_m, raw_outputs, ys, data = acc
        counts = np.fromiter(map(len, mols_per_batch), np.int64, len(mols_per_batch))
        real = np.arange(preds.shape[1]) < counts[:, None]
        pred = preds[real]
        if self.task == "class":
            probs = torch.softmax(torch.from_numpy(pred), dim=1).numpy()
            raw_outputs += probs.tolist()
            batch_out = np.argmax(probs, axis=1).tolist()
        else:
            batch_out = pred.tolist()
            raw_outputs += batch_out
        out += batch_out
        # metrics need aligned (prediction, target) pairs: keep only
        # graphs that actually carry the target (y_mask)
        valid = np.asarray(mask_rows, dtype=bool)[real]
        out_m += itertools.compress(batch_out, valid.tolist())
        ys += y_rows[real][valid].tolist()
        data["mol"] += itertools.chain.from_iterable(mols_per_batch)

    def _finish_pass_data(self, data, out, raw_outputs, ys) -> None:
        if self.task == "class":
            data["targets"] += [self.idx_to_classes[int(x)] for x in ys]
            data["outputs"] += [self.idx_to_classes[int(x)] for x in out]
        else:
            data["targets"] += ys
            data["outputs"] += out
        data["raw_outputs"] += raw_outputs

    def _mapped_store_targets(self, store) -> np.ndarray:
        """The store's targets, slot by slot, with the class remap applied
        (host numpy; the store keeps the file's targets), made once per
        store."""
        kept = self._scan_mapped.get(id(store))
        if kept is None or kept[0] is not store:
            mapped = np.asarray(store.y_host, dtype=np.float32)
            if self.task == "class":
                mapped = np.array([self.classes_to_idx.get(int(v), 0) for v in mapped],
                                  dtype=np.float32)
            kept = (store, mapped)
            self._scan_mapped[id(store)] = kept
        return kept[1]

    def _store_targets(self, store, mapped: np.ndarray) -> torch.Tensor:
        """``mapped`` on the device, uploaded once per store: the captured
        steps read it by address."""
        kept = self._scan_targets.get(id(store))
        if kept is None or kept[0] is not store:
            kept = (store, torch.from_numpy(mapped).to(self.device))
            self._scan_targets[id(store)] = kept
        return kept[1]

    def _slots_on_device(self, slots: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _scan_buffers(self, batches: int, width: Optional[int] = None):
        """The device buffers of ``batches`` batches' losses and
        predictions (``width`` graphs a batch, default ``batch_size``)."""
        width = width or self.batch_size
        per = (width,) if self.task != "class" else (width, len(self.classes))
        return (torch.empty(batches, device=self.device),
                torch.empty((batches,) + per, device=self.device))

    def _mesh_scan_begin(self, y_rows: np.ndarray, mask_rows: np.ndarray):
        """Before a scanned mesh pass over ``B`` batches whose slots'
        targets and masks are ``y_rows`` / ``mask_rows [B, batch_size]``
        (host): the buffers of this rank's losses and predictions, and the
        batches' global loss normalizers (one all-gather)."""
        cols = self._scan_cols
        y = torch.from_numpy(np.ascontiguousarray(y_rows[:, cols], dtype=np.float32))
        mask = torch.from_numpy(np.ascontiguousarray(mask_rows[:, cols], dtype=bool))
        norms = self._mesh_steps.scan_normalizers(
            y.to(self.device), mask.to(self.device),
            len(self.classes) if self.task == "class" else 1)
        return (*self._scan_buffers(len(y_rows), cols.stop - cols.start), norms)

    def _scan_into(self, store, y_all, slots_dev, training: bool, y_rows, mask_rows,
                   losses, preds) -> None:
        """One scanned pass over a resident ``store`` and its slot rows
        ``slots_dev`` (this rank's columns, on the device), the global
        losses and predictions into ``losses`` and ``preds``; on a mesh
        with the pass's collectives (:meth:`_mesh_scan_begin`, then
        ``MeshSteps.scan_finish``)."""
        if self.mesh is None:
            self._scan.run(store, y_all, slots_dev, training, losses, preds)
            return
        local_l, local_p, norms = self._mesh_scan_begin(y_rows, mask_rows)
        self._scan.run(store, y_all, slots_dev, training, local_l, local_p, norms)
        glob_l, glob_p = self._mesh_steps.scan_finish(local_l, norms, local_p, self.batch_size)
        losses.copy_(glob_l)
        preds.copy_(glob_p)

    def _scan_context(self, training: bool):
        self.model.train(training)
        stack = contextlib.ExitStack()
        if not training:
            stack.enter_context(torch.inference_mode())
        stack.enter_context(deterministic())
        return stack

    def _collect_scan_pass(self, store, mapped, slots, mols_per_batch, losses, preds):
        """The host's bookkeeping of a scanned pass from its read-back
        losses and predictions: the looped pass's per-batch lists, built for
        all batches at once (:meth:`_collect_batches`); the epoch's loss sums
        the batches' losses in order, as there."""
        out, out_m, raw_outputs, ys = [], [], [], []
        data = {"outputs": [], "raw_outputs": [], "targets": [], "mol": []}
        self._collect_batches((out, out_m, raw_outputs, ys, data), preds, mols_per_batch,
                              mapped[slots], store.y_mask_host[slots])
        self._finish_pass_data(data, out, raw_outputs, ys)
        return out, out_m, ys, _epoch_loss(losses), data

    def _run_pass_scan(self, loader: GraphLoader, training: bool):
        """One scanned epoch over the loader's store (``train/scan.py``):
        the host plans the slot matrix, the steps run as graph replays and
        the results are read back once. ``(result, steps)``, or None when
        the loader has no store (the caller runs the per-batch loop)."""
        if loader.device_cache == "chunked":
            return self._run_pass_scan_chunked(loader, training)
        with trace.span("pass.plan"):
            plan = loader.device_epoch_plan()
            if plan is None:
                return None
            slots, mols_per_batch = plan
            store = loader._store
            mapped = self._mapped_store_targets(store)
            y_all = self._store_targets(store, mapped)
            losses, preds = self._scan_buffers(len(slots))
            slots_dev = self._slots_on_device(slots[:, self._scan_cols])
            y_rows, mask_rows = mapped[slots], store.y_mask_host[slots]
        with self._scan_context(training):
            self._scan_into(store.store, y_all, slots_dev, training, y_rows, mask_rows, losses,
                            preds)
        self.model.eval()
        with trace.span("pass.readback"):
            losses, preds = losses.cpu().numpy(), preds.cpu().numpy()
        with trace.span("pass.collect"):
            res = self._collect_scan_pass(store, mapped, slots, mols_per_batch, losses, preds)
        return res, len(slots)

    def _chunk_sets(self, cs):
        """Two sets of fixed device buffers (a chunk's matrices and its
        targets) for the chunked store ``cs``, used in turn: a chunk's copy
        into one overlaps the steps over the other, and each set's captured
        graphs serve every chunk."""
        kept = self._chunk_buffers.get(id(cs))
        if kept is None or kept[0] is not cs:
            sets = []
            for _ in range(min(2, cs.num_chunks)):
                buf = cs.empty_chunk()
                sets.append({"store": buf, "y": torch.zeros(buf.num_slots, device=self.device),
                             "released": None})
            kept = (cs, sets)
            self._chunk_buffers[id(cs)] = kept
        return kept[1]

    def _run_pass_scan_chunked(self, loader: GraphLoader, training: bool):
        """One scanned epoch over the rotating chunk store: each chunk is
        copied into one of two sets of fixed buffers on the side stream
        while the steps over the other set run, and every chunk's steps are
        replays of that set's graphs. The results of the whole epoch are
        read back once. Batch order, dropout stream and numbers are those
        of the looped chunked epoch. ``(result, steps)``, or None when the
        loader has no chunk store."""
        with trace.span("pass.plan"):
            plan = loader.chunk_epoch_plan()
            if plan is None:
                return None
            cs = loader._chunk_store
            mapped = self._mapped_store_targets(cs)
            y_mask = np.asarray(cs.y_mask_host, dtype=bool)
            sets = self._chunk_sets(cs)
            counts = [len(slots) for _, slots, _ in plan]
            # each slot's row of the dataset (a chunk's pad slot: its last
            # graph's) and whether it holds a target
            grows = np.concatenate([np.minimum(cs.chunk_ranges[ci][0] + slots,
                                               cs.num_graphs - 1) for ci, slots, _ in plan])
            valids = np.concatenate([slots < cs.chunk_ranges[ci][1] for ci, slots, _ in plan])
            valids &= y_mask[grows]
            slots_all = np.concatenate([slots for _, slots, _ in plan])
            slots_dev = self._slots_on_device(slots_all[:, self._scan_cols])
            if self.mesh is None:
                losses, preds = self._scan_buffers(sum(counts))
                norms = None
            else:
                losses, preds, norms = self._mesh_scan_begin(mapped[grows], valids)
        cuda = self.device.type == "cuda"

        def upload(pos):
            ci = plan[pos][0]
            start, clen = cs.chunk_ranges[ci]
            y = torch.zeros(clen + 1, dtype=torch.float32)
            y[:clen] = torch.from_numpy(mapped[start: start + clen])
            if cuda:
                y = y.pin_memory()
            dst = sets[pos % len(sets)]
            return cs.upload_into(ci, dst["store"], [(y, dst["y"][: clen + 1])],
                                  after=dst["released"])

        with self._scan_context(training):
            ready = upload(0)
            off = 0
            for pos, (ci, slots, _mols) in enumerate(plan):
                nxt = upload(pos + 1) if pos + 1 < len(plan) else None
                cur = sets[pos % len(sets)]
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                n = counts[pos]
                self._scan.run(cur["store"], cur["y"], slots_dev[off: off + n], training,
                               losses[off: off + n], preds[off: off + n],
                               None if norms is None else norms[off: off + n])
                if cuda:
                    cur["released"] = torch.cuda.Event()
                    cur["released"].record(torch.cuda.current_stream(self.device))
                ready, off = nxt, off + n
        self.model.eval()
        if norms is not None:
            losses, preds = self._mesh_steps.scan_finish(losses, norms, preds, self.batch_size)
        with trace.span("pass.readback"):
            losses, preds = losses.cpu().numpy(), preds.cpu().numpy()
        with trace.span("pass.collect"):
            out, out_m, raw_outputs, ys = [], [], [], []
            data = {"outputs": [], "raw_outputs": [], "targets": [], "mol": []}
            acc = (out, out_m, raw_outputs, ys, data)
            off = 0
            for _ci, _slots, mols_per_batch in plan:
                for bi, mols in enumerate(mols_per_batch):
                    i = off + bi
                    self._collect_batch(acc, preds[i], mols, mapped[grows[i]], valids[i])
                off += len(mols_per_batch)
            self._finish_pass_data(data, out, raw_outputs, ys)
        return (out, out_m, ys, _epoch_loss(losses), data), sum(counts)

    def _full_scan_plans(self, loader: GraphLoader, nepoch: int):
        """``nepoch`` successive epoch plans, drawn as ``nepoch`` iterated
        epochs draw them: the stacked slot matrices ``[E, B, batch]`` and
        each epoch's molecules, or None without a store."""
        slots_list, mols_list = [], []
        for _ in range(nepoch):
            plan = loader.device_epoch_plan()
            if plan is None:
                return None
            s, m = plan
            if slots_list and s.shape != slots_list[0].shape:
                return None
            slots_list.append(s)
            mols_list.append(m)
        return np.stack(slots_list), mols_list

    def _train_full_scan(self, nepoch, validate, save_model, save_epoch, save_every) -> bool:
        """A whole ``train()`` call of scanned epochs (JAX
        ``make_train_scan``): every epoch's training pass, its validation
        pass and the best-model selection run on the device with the
        epochs' graphs, and the host reads the results back once, when the
        run ends; then it replays each epoch's bookkeeping (metrics, prints,
        epoch-data export). The best parameters so far are kept on the
        device, replaced where the epoch's selection loss (the validation
        losses' sum, else the training losses') is at most the best so far,
        which starts at the least of any earlier ``train()`` call's
        losses. ``save_model="best"`` writes one checkpoint, for the winning
        epoch. False when a loader has no store (the caller runs the
        per-epoch passes)."""
        tplan = self._full_scan_plans(self.train_loader, nepoch)
        if tplan is None:
            return False
        slots_te, mols_te = tplan
        tstore = self.train_loader._store
        mapped_t = self._mapped_store_targets(tstore)
        y_t = self._store_targets(tstore, mapped_t)
        track_best = save_model == "best"
        if validate:
            vplan = self._full_scan_plans(self.valid_loader, nepoch)
            if vplan is None:
                return False
            slots_ve, mols_ve = vplan
            vstore = self.valid_loader._store
            mapped_v = self._mapped_store_targets(vstore)
            y_v = self._store_targets(vstore, mapped_v)
        prior = self.valid_loss if validate else self.train_loss
        best_floor = float(min(prior)) if (track_best and prior) else np.inf
        t0 = time()
        params = list(self.model.parameters())
        cols = self._scan_cols
        tl, tp = self._scan_buffers(nepoch * slots_te.shape[1])
        tl, tp = tl.view(nepoch, -1), tp.view((nepoch, -1) + tp.shape[1:])
        st = self._slots_on_device(slots_te[:, :, cols])
        if validate:
            vl, vp = self._scan_buffers(nepoch * slots_ve.shape[1])
            vl, vp = vl.view(nepoch, -1), vp.view((nepoch, -1) + vp.shape[1:])
            sv = self._slots_on_device(slots_ve[:, :, cols])
        if track_best:
            best = [p.detach().clone() for p in params]
            best_loss = torch.tensor(best_floor, dtype=torch.float64, device=self.device)
            best_epoch = torch.tensor(-1, dtype=torch.int64, device=self.device)
        for e in range(nepoch):
            # on a mesh each pass ends with its losses summed over the
            # ranks, so the selection below sees the global ones
            with self._scan_context(True):
                self._scan_into(tstore.store, y_t, st[e], True, mapped_t[slots_te[e]],
                                tstore.y_mask_host[slots_te[e]], tl[e], tp[e])
            if validate:
                with self._scan_context(False):
                    self._scan_into(vstore.store, y_v, sv[e], False, mapped_v[slots_ve[e]],
                                    vstore.y_mask_host[slots_ve[e]], vl[e], vp[e])
            self.model.eval()
            if track_best:
                sel = (vl[e] if validate else tl[e]).to(torch.float64).sum()
                improved = sel <= best_loss
                with torch.no_grad():
                    for b, p in zip(best, params):
                        b.copy_(torch.where(improved, p, b))
                best_loss = torch.where(improved, sel, best_loss)
                best_epoch = torch.where(improved, torch.full_like(best_epoch, e), best_epoch)
        tl, tp = tl.cpu().numpy(), tp.cpu().numpy()
        if validate:
            vl, vp = vl.cpu().numpy(), vp.cpu().numpy()
        t_share = (time() - t0) / max(nepoch, 1)
        for e in range(nepoch):
            epoch = e + 1
            _out, _out_m, _y, _loss, self.data["train"] = self._collect_scan_pass(
                tstore, mapped_t, slots_te[e], mols_te[e], tl[e], tp[e])
            self.train_loss.append(_loss)
            self.train_out = _out
            self._train_out_m = _out_m
            self.train_y = _y
            _acc = self.get_metrics("train", self.threshold).accuracy
            self.train_acc.append(_acc)
            self.print_epoch_data("train", epoch, _loss, _acc, t_share)
            if validate:
                _out, _out_m, _y, _val_loss, self.data["eval"] = self._collect_scan_pass(
                    vstore, mapped_v, slots_ve[e], mols_ve[e], vl[e], vp[e])
                self.valid_loss.append(_val_loss)
                self.valid_out = _out
                self._valid_out_m = _out_m
                self.valid_y = _y
                _val_acc = self.get_metrics("eval", self.threshold).accuracy
                self.valid_acc.append(_val_acc)
                self.print_epoch_data("valid", epoch, _val_loss, _val_acc, t_share)
            elif track_best and min(self.train_loss) == _loss:
                print(
                    "WARNING: The training set is used both for "
                    "learning and model selection."
                )
            if (save_epoch == "all") or (epoch == nepoch):
                self._export_epoch_hdf5(epoch, self.data)
            elif save_epoch == "intermediate" and epoch % save_every == 0:
                self._export_epoch_hdf5(epoch, self.data)
        if track_best:
            be = int(best_epoch)
            if be >= 0:
                # the winner's parameters into the model for the save, in
                # place (the graphs read them by address), then back
                with torch.no_grad():
                    current = [p.detach().clone() for p in params]
                    for p, b in zip(params, best):
                        p.copy_(b)
                try:
                    self.save_model(filename=self._ckpt_name(nepoch, be + 1))
                finally:
                    with torch.no_grad():
                        for p, c in zip(params, current):
                            p.copy_(c)
        return True

    def _run_pass(self, loader: GraphLoader, training: bool = False):
        """One pass over ``loader``: host collation on a worker thread,
        asynchronous copies to the device, and per batch an Adam step
        (``training``) or a forward pass, under deterministic algorithms.
        With ``scan_epochs`` and a store, the scanned epoch instead.
        Returns ``(out, out_m, ys, loss, data)``; ``loss`` sums the
        batches' losses. Recorded as the span ``pass``, with its graphs,
        its steps and the elements its steps accumulated (``accumulated``:
        ``ops/lanes.py`` ``ACCUMULATED``, eager steps and replays alike;
        ``trace.py``)."""
        with trace.span("pass") as sp:
            before = ACCUMULATED["elements"]
            scanned = self._run_pass_scan(loader, training) if self.scan_epochs else None
            res, steps = scanned or self._run_pass_looped(loader, training)
            sp.add(graphs=len(res[4]["mol"]), steps=steps,
                   accumulated=ACCUMULATED["elements"] - before)
        return res

    def _run_pass_looped(self, loader: GraphLoader, training: bool):
        """The per-batch pass of :meth:`_run_pass`: ``(result, steps)``."""
        out, out_m, raw_outputs, ys = [], [], [], []
        data = {"outputs": [], "raw_outputs": [], "targets": [], "mol": []}
        running_loss, batches = 0.0, 0

        steps = self._mesh_steps

        def _prepared():
            # on a mesh the worker thread also places the batch on this
            # rank (the halo partition is host work)
            for batch, mols in loader:
                hb = self._map_targets_host(batch)
                meta = (mols, hb.y.numpy(), hb.y_mask.numpy())
                yield (hb if steps is None else self._shard(hb)), meta

        self.model.train(training)
        grad_mode = contextlib.nullcontext() if training else torch.inference_mode()
        with grad_mode, deterministic():
            for batch, (mols, y_host, mask_host) in prefetch(_prepared(), self.device):
                if steps is not None:
                    loss, pred = (steps.train(batch, self._dropout_generator) if training
                                  else steps.eval(batch))
                    if self._pred_slice is not None:
                        pred = pred[self._pred_slice]
                elif training:
                    loss, pred = self._train_step(batch)
                else:
                    loss, pred = self._loss_and_pred(batch)
                running_loss += float(loss)
                batches += 1
                self._collect_batch(
                    (out, out_m, raw_outputs, ys, data),
                    pred.cpu().numpy(), mols, y_host, mask_host,
                )
        self.model.eval()
        self._finish_pass_data(data, out, raw_outputs, ys)
        return (out, out_m, ys, running_loss, data), batches

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
        TensorBoard reads (JAX ``train/neuralnet.py:1078-1110``); the
        engine's spans (``pass``, ``pass.plan``, ``pass.issue``,
        ``pass.readback``, ``pass.collect``) are ranges in it, on the
        kernels' clock. In a running process ``trace.passes()`` gives the
        newest passes' spans (``trace.py``). With
        ``scan_epochs="full"`` and no ``profile`` the whole call runs as
        one scanned run (:meth:`_train_full_scan`)."""
        import h5py

        fname = self.update_name(hdf5, self.outdir)
        with h5py.File(fname, "w") as self.f5:
            self.nepoch = nepoch
            self.data = {}
            if (
                self.scan_epochs == "full"
                and profile is None
                and nepoch >= 1
                and (not validate or self.valid_loader is not None)
                and self._train_full_scan(nepoch, validate, save_model, save_epoch, save_every)
            ):
                if save_model == "last":
                    self.save_model(filename=self._ckpt_name(nepoch))
                return
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
                if self._mesh_steps is None:
                    _, p = self._eval_step(batch)
                else:
                    _, p = self._mesh_steps.eval(self._shard(batch).to(self.device))
                    if self._pred_slice is not None:
                        p = p[self._pred_slice]
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
