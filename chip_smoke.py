#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py [--seed N] [--graphs N] [--digests] [--atomic] [--k4]
    python3 chip_smoke.py --cards 4 [--atomic]

Run from the root of a checkout; it needs one CUDA device and ``nvcc``
(``$CUDA_HOME/bin`` or PATH), and nothing beyond torch, numpy and scipy.
With ``--cards 4`` it needs four and runs phases 1, 2, 11 and 16 only
(below; with ``--atomic`` too, phases 1, 2 and 16); with ``--atomic`` alone
phases 1, 2 and 15. Phases, each of which raises on
failure (phase 15 runs right after phase 3b, so that its profiled passes
come early in the process):

1. device: the card's name and power limit (``nvidia-smi``); fp32
   numerics with TF32 off; the cuBLAS workspace setting that
   deterministic mode needs;
2. build: every CUDA kernel of the port, from ``ops/csrc`` in this
   checkout, one ``nvcc`` per source, all started together, into a
   temporary directory set as the executable cache
   (``train/aot.py``, every engine's ``executable_cache_dir`` here); a
   second process pointed at it finds every library and runs no ``nvcc``;
3. kernels: each kernel against its plain PyTorch version, and two
   launches bitwise equal. K1 (sorted segment sum) on the card at rtol 1e-5
   and atol 1e-5 against the plain version run there (``index_add_`` with
   atomics; its edge cases use values whose sums are exact in fp32), and
   bitwise equal to the plain version run on the CPU (both sum each row in
   edge order), at the sparse serving path's shapes (F = 32 and 64), at
   the attention path's (F = 16 and 32), at ``coalesce_edges``' (the first
   batch's interface edges mapped through its level-0 clusters and sorted
   by key, F = 1), and at edge cases (empty rows, a
   run of thousands of edges, trailing padding, odd widths), with its
   launch plan (columns per load, lanes per row, rows per block), and its
   gradient against the plain version's. K3 (per-graph GIN aggregation) forward and backward
   bitwise equal to the plain version run on the CPU (both sum in edge
   order), on random values, at the dense path's first-batch shapes of
   both conv levels, and at edge cases: unsorted rows, duplicate edges,
   empty rows, sentinel and negative indices, F = 1, 17 and 100, more
   edges than one shared-memory tile, every valid edge of a graph on one
   row, a graph whose [S, F] slab does not fit in shared memory, and S of
   70,000, far beyond one block's rows; its launch plan (slab staged, rows
   per block, blocks resident per SM) is checked too. K3's fast variant
   (``exact=False``: fp32 ``xw`` rounded to bf16 in the kernel, fp32 sums
   and output) forward and backward bitwise equal to the fp32 plain version
   run on the CPU on the bf16-rounded values, at both conv levels' shapes
   and three edge cases; its launch plan against the exact kernel's (the
   fp32 slab plus its bf16 copy, no more blocks a graph); the kernels one
   call of the path launches, traced (no bf16 cast; a planted cast must be
   counted once); and timed as the path runs it beside the exact kernel on
   the same inputs and the cast it no longer launches. K2 (sorted
   scatter-gather, the attention softmax's denominator) forward and
   backward on the card at rtol 1e-5 and atol 1e-5, and bitwise equal to
   the plain version run on the CPU, forward and backward, at the attention
   path's two softmax shapes of the first batch (F = 1), at the JAX
   package's ``bench.py`` SpMM shapes, and at edge cases (empty rows, a
   run of 8,000 edges, longer than a shared-memory tile, leading and
   trailing padding, F = 1, 17 and 100, no row at all); its ``d2`` must be
   bitwise ``out[rows]`` and 0 at padding, its ``out`` bitwise K1's sums;
   its launch plan (path, rows and threads per block, tile edges) is
   checked. Each is
   timed at the main shapes with the L2 cache flushed before each call,
   beside its plain version, a PyTorch library yardstick and the least time
   the card could take, and also L2-resident and eagerly; and the device
   time of an almost empty launch of each (one row, no edges) is read
   under ``torch.profiler``, the floor of the in-pass times;
4. serve: a GINet at the paper's width (48 node features, the ``fold6``
   feature set, 1 edge feature, target ``fnat``, batch 128) with seeded
   random weights, written as a reference-format torch checkpoint, scores
   synthetic fixture-scale graphs (2,048 by default) through ``NeuralNet(...,
   pretrained_model=ckpt, device="cuda")`` in the sparse and the dense
   layout. The graphs are in memory (``GraphListDataSet``, which row-sorts
   their edges): the HDF5 front end is held against the JAX package by the
   CPU tests. The launch counters are cleared just before each pass and
   read just after: K1 must run twice per sparse batch, K3 twice per
   dense batch. Predictions must be finite and match the same port run
   with ``device="cpu"`` (the plain versions), and the two layouts each
   other, at rtol 2e-4 and atol 1e-5. A pass of each layout under
   ``torch.profiler`` shows where the time goes;
5. train, per layout: ``NeuralNet(graphs, GINet, ..., batch_size=128,
   percent=[0.8, 0.2], layout=...)`` with the epoch passes that ``train()``
   runs (``_run_pass`` for training, then for validation) and
   ``save_model``: ``train()`` itself also writes its epoch HDF5, and the
   card's machine has no ``h5py`` (the CPU tests run ``train()`` whole).
   With dropout off, the first 4 Adam steps' losses on the card match the
   port's ``device="cpu"`` run from the same weights at rtol 2e-4, atol
   1e-5. With dropout on, two card runs from one seed give bitwise-equal
   losses and parameters after 2 epochs. Per training batch K1 launches 2
   times (sparse) and K3 4 times (dense: 2 forward, 2 backward). Losses are
   finite. It prints graphs/s per epoch (the first one cold), a profile of
   one warm epoch, and the saved checkpoint reloads and trains on;
6. attention, the main path of the model zoo's slice:
   ``functools.partial(GINet, attention=True)``, sparse, at the paper's
   width on 2,048 graphs: served from a reference-format checkpoint as in
   4 (K1 4 and K2 4 launches per batch) and trained as in 5 (K1 4 and K2 8
   per training batch: K2's backward is K2 on the ``d2`` cotangent), with
   every check of both;
7. the other new paths on 768 graphs (4 or more training batches): the dense attention GINet (also
   against the sparse one; K4: 2 CSR builds and 4 forward calls per served
   batch, 4, 4 and 8 backward passes per training batch), the internal-tower GINet (sparse only, K1 4
   per batch), FoutNet and sGAT in both layouts (K1 2 per sparse batch;
   their dense aggregations are plain torch), each served against its CPU
   run (one of two passes profiled) and trained 4 Adam steps against the
   CPU and one epoch;
8. the device store (``device_cache``) on the 2,048 graphs at batch 128:
   every field of every batch of an unshuffled store epoch bitwise the
   streamed batch on the card, without and with the precomputed operators
   (with the store's build time, its bytes as ``estimate_store_bytes``
   gives them and as ``torch.cuda.memory_allocated`` grows, and one
   batch's gather time); paper-mode GINet trained on store batches without
   the operators, which feed K3 (4 launches per training batch; the first
   4 losses bitwise the streaming dense phase's); the operator path
   (``NeuralNet(..., layout="dense", device_cache=True)``) served and
   trained with every check of phases 4 and 5 and no hand kernel
   launched; the chunked store (4 chunks: serving bitwise the resident
   store's, a shuffled training epoch that sees every graph once, each
   chunk's copy time on its side stream beside the host's time between
   uploads); ``store_pack="bf16"`` serving within ``BF16_TOL`` of
   lossless; and FoutNet and sGAT on the operator path (768 graphs),
   against the CPU and their streaming dense runs;
9. scanned epochs (``scan_epochs=True``) on the 2,048 graphs' store, in
   the same process as the looped store path and from the same seed,
   dropout 0.4 on: the operator path and store batches without the
   operators (K3 inside the captured graph), three training and
   validation epochs each, every loss, prediction, parameter, Adam state
   and the dropout generator's state bitwise the looped run's; the graph
   replays per epoch (one warm-up step, then one replay per batch); K3's
   launches per epoch (the counts at capture times the replays) against
   the kernels a profiled scanned epoch traces; warm graphs/s, the host's
   ms per batch and the idle share beside the looped path's; the scanned
   engine's checkpoint (Adam ``step`` a CPU scalar) reloads and trains
   on; scanned serving bitwise the looped store serving, profiled; then
   on the operator path ``scan_epochs="full"`` (a whole ``train(nepoch=3,
   validate=True, save_model="best")`` call as one scanned run, its epoch
   HDF5 and metrics left out) and the chunked scan (4 batches a chunk),
   each bitwise its looped run, with replays, host ms per batch, warm
   graphs/s and idle share;
10. the fast mode (``dense_fast=True``) scanned on store batches without
   the operators: K3's fast variant inside the graph (52 launches an
   epoch, traced as the bf16 kernel), bitwise the looped fast epoch and
   within ``BF16_TOL`` of the exact path's loss; the fast operator path
   (``adj_conv`` with bf16 operands) scanned for one epoch;
11. multi-device (``parallel/``): this process first computes the
   single-card references on cuda:0 (served predictions and loss from a
   seeded checkpoint, the first 4 Adam steps with dropout off, in both
   layouts, and scanned store runs on the operator and K3 paths), then
   two worker processes started with ``torch.multiprocessing`` spawn form
   one gloo group over a ``file://`` store in the run's temporary
   directory, both on cuda:0 (NCCL refuses two ranks on one card; gloo
   stages the CUDA tensors through the host), and load the kernels from
   phase 2's cache (running ``nvcc`` fails them). On 512 of the graphs (4
   batches of 128) each rank runs paper-mode GINet on three paths: the halo
   layout (``layout="halo", mesh=make_halo_mesh()``; K1 3 launches per
   batch, served and trained), the dense graph-parallel mesh
   (``make_mesh(dp=2, ep=1)``; K3 2 per served batch, 4 per training batch,
   over 64 graphs) and the sparse one (``make_mesh()``, dp=1 x ep=2; K1 2
   per batch). Each is served against the single-card run at ``TOL``, with
   its collective bytes equal to the pass's plan, its first 4 Adam steps
   (dropout off) against the single-card run at ``TOL``, and with dropout
   on the engine's training pass (``_run_pass``) run twice from one seed,
   losses and parameters bitwise equal, both ranks' parameters bitwise
   equal after each epoch, its collective bytes equal to the plan; the
   launch counts, walls and the profiled epoch are that pass's. The same
   epoch taken a step at a time gives the pass's loss bitwise, with both
   ranks' parameters equal after every step. One halo training step's
   collective bytes equal its plan and lie below an all-gather of the node
   array. Each rank prints its graphs/s (gloo times, host staging
   included). Then this process alone forms an NCCL group of one and runs
   one halo and one dense-mesh training pass of one batch on NCCL's
   collectives. Scanned dense mesh epochs (``scan_epochs=True``, 3
   epochs and a scanned serving pass, dropout on): in the two gloo ranks on
   the operator path and on store batches without the operators (K3 inside
   the graphs), each training step two replays around the host's gradient
   all-reduce; in the NCCL group of one on the K3 path with
   ``scan_epochs=True``, ``"full"`` and the chunked store, the all-reduce
   captured inside the step's graph. Each is bitwise the looped mesh run
   (losses, predictions, parameters, Adam and generator state; the ranks'
   parameters equal), its K3 launches (captured times replays) equal the
   looped run's and the profiled trace, its replays and collective bytes
   per epoch equal the plan; the gloo runs also match the single-card
   scanned run at ``TOL``.
   With ``--cards 4`` (four cards or more; phase 2 builds the kernels
   once) it prints every card's name and power limit, ``nvidia-smi topo
   -m`` and NCCL's version, and runs this phase on 4,096 graphs at a global
   batch of 512 (128 graphs a rank and batch, the single card's batch):
   the references at batch 512 and the single card's warm graphs/s at
   batch 128 (served and trained in both layouts, scanned K3 epochs) on
   cuda:0, then four ranks in an NCCL group, rank r on cuda:r, nothing on
   gloo or the CPU: the three paths with every check above (two runs from
   one seed compared: a difference under NCCL is recorded, which values and
   by how much), each profiled pass with its NCCL kernels by name, and
   scanned mesh epochs (``True``, ``"full"``, chunked) on the operator and
   the K3 path, each bitwise its looped run with the all-reduce captured
   in the graphs. Its last lines are ``4 cards {...}`` (``cards_summary``)
   and the ``{"ok": true, ...}`` line with the card count;
12. featurize: 32 docking models of one synthetic complex written from the
   seed (``write_docking_models``: chains of 300 and 250 residues with
   their standard heavy atoms, ~4,700 atoms, 1ATN's scale; chain B moved
   in each model; a PSSM per chain) become residue graphs through
   ``ResidueGraph(..., device="cuda")``, each scored against the first
   model. Four of them also run on the CPU path: node and edge lists and
   ``pos`` bitwise, per-atom SASA, BSA, every feature and score within
   rtol 1e-9 and atol 1e-9. It prints models/s on the card and on the CPU,
   SASA and contact ms per model on both, the first model's cold time and
   a profiled model. The graphs are clustered (MCL), converted
   (``Graph.to_sample``, no HDF5: the card's machine has no ``h5py``) and
   served from phase 4's checkpoint (K1 2 launches a batch, against the
   CPU at ``TOL``); ``coalesce_edges`` on the card over the first batch's
   interface edges mapped through ``cluster0`` gives the collate's pooled
   edges bitwise, their summed attributes at ``KERNEL_TOL``, with one K1
   launch, bitwise the CPU run;
13. the low-level API: ``example/custom_model_torch.py``'s ``CustomNet``
   and ``train`` on 128 in-memory graphs at batch 4 for 3 epochs, K1 2
   launches a batch, within ``TOL`` of the same function on the CPU, two
   card runs from one seed bitwise equal;
14. digests: each training path (streamed in both layouts, the zoo, the
   fast mode, the store, scanned epochs, and on two gloo ranks the halo,
   the dense and sparse meshes and a scanned mesh epoch) trained one epoch
   of 512 graphs from the seed; sha256 of the epoch's outputs and loss and
   of the final parameters, printed as ``digest <path>: ...``. With
   ``--digests`` the script builds the kernels and runs only this phase:
   run it in a checkout of another commit (with this script copied in) and
   here, in one call, to hold two commits' training bitwise equal;
15. atomic scale: the port at the JAX package's own headline shapes,
   ``bench.py``'s atomic arms: 128 graphs of ``build_big_graphs`` (2,560
   nodes of 48 features, 15,000 edges doubled to 30,000, level-0 clusters
   of ~4 nodes; reproduced value for value from the seed by
   ``build_atomic_graphs``), batch 64, two batches, target ``irmsd``, every
   graph in training. Each graph's pooling plan is made once (timed) and
   found by every later loader (``plans_once``). Path "data": an
   unshuffled epoch of the sparse, dense and operator collation (host ms
   per batch), each batch moved to the card as the engine moves it bitwise
   the CPU batch, and ``community_pooling`` of one graph (2 K1 launches)
   bitwise the CPU run. "kernels": K1 (conv1 E 1.92 M into 163,840 rows at
   F 32, conv2 ~1.8 M pooled edges at F 64), K2 (the sparse attention
   softmax's two shapes of the first batch, F = 1: conv1 over the
   interface edges, conv2 over the pooled ones, where a warp's 32 rows span
   several shared-memory tiles), K3 (conv1 ``[64, ~5,200, 32]`` over
   ~30,100 edges a graph, without the slab in shared memory over 15 edge
   tiles, which the check requires; conv2 ``[64, 640, 64]``) and K3 fast at
   the first batch's shapes, forward and backward, bitwise their plain
   versions run on the CPU (K1 and K2 also within the rounding bound of a
   reordered fp32 sum of the plain version on the card), with their launch
   plans, flushed and L2-warm times, bounds, plain and library times; K3
   fast's calls trace no bf16 cast. "sparse" and "dense", paper-mode GINet:
   served (K1 2, K3 2 launches a batch; against the CPU run and each other
   at ``TOL``; a pass profiled) and trained (the first 4 Adam steps against
   the CPU, dropout off, at ``TOL``; one epoch with dropout on, K1 2 and K3
   4 launches a batch, run twice from one seed bitwise; a profiled epoch
   with its index accumulation's sites). The rest of the model zoo
   (``ATOMIC_ZOO``), each from its own seeded checkpoint, served (two
   passes and a profiled one) and trained (the first 4 steps, then two
   epochs run twice from one seed bitwise and a profiled one): the
   attention GINet sparse (K1 4 and K2 4 a served batch, K1 4 and K2 8 a
   trained one; held to the CPU run) and dense (no hand kernel; held to the
   sparse attention path's predictions and first 4 losses on the card), the
   internal tower (K1 4) and the attention with the internal tower (K1 4,
   K2 4 and 8), sparse, held to the CPU; FoutNet and sGAT sparse (K1 2,
   held to the CPU) and dense (held to their sparse paths on the card).
   Each dense zoo path fails if its peak allocated memory exceeds
   ``DENSE_ZOO_PEAK_BYTES`` (10 GB, below the 10.04 GB of the one-hot
   form's smallest tensor at conv1). "halo": ``bench.py``'s
   ``atomic_halo_step``, paper-mode GINet with ``layout="halo"`` on one
   rank in an NCCL group of one (K1 3 launches a batch), served and trained
   against the sparse path's card run at ``TOL``, two runs bitwise, with
   the host's ``partition_batch`` ms per batch and the served passes'
   collective bytes. "fast": phase 10's check on the atomic store (K3 fast
   4 launches a batch, no cast traced). "operators": the store's batches
   bitwise the data path's (the weighted operators that only FoutNet and
   sGAT read among the fields), its bytes against ``estimate_store_bytes``;
   served and trained against the CPU with no hand kernel; scanned epochs
   bitwise the looped ones, dropout on. "foutnet_store" and "sgat_store"
   (``STORE_ZOO``): FoutNet (``agg_x``, ``deg0``, ``adj1``) and sGAT
   (``wagg_x``, ``ea_rowsum0``, ``wadj1``, ``ea_rowsum1``) from the store's
   operators over the first batch of 64 graphs, served from their streamed
   dense paths' checkpoints (two passes and a profiled one) within ``TOL``
   of those paths' predictions, trained (the first 4 Adam steps against the
   CPU, one epoch), no hand kernel launched, each engine from its store
   (as every store engine's serve and train check asks), each peak under
   ``DENSE_ZOO_PEAK_BYTES``. "chunked": the chunked store in two
   chunks of one batch, serving bitwise the resident store's, then three
   scanned epochs bitwise the looped chunked ones (each epoch's rate).
   "bf16": ``store_pack="bf16"`` served within ``BF16_TOL`` of the lossless
   store, and a training epoch within rtol 5e-2 of the lossless one. "atomgraph": ``AtomGraph(...,
   device="cuda")`` on 32 of phase 12's docking models, 2 of them also on
   the CPU path (lists bitwise, features within ``FEATURE_TOL``),
   clustered, converted with ``bench.py``'s atomic features (51) and
   served sparse (K1 2 a batch) against the CPU. Each path logs its peak
   ``max_memory_allocated`` beside the card's name and power limit; the
   last lines' kernels carry an ``atomic`` entry each;
16. four cards at atomic scale (``--cards 4``, after phase 11): phase 11's
   four NCCL ranks and every check of theirs, on phase 15's graphs (a
   directory of its own). The meshes and the scanned mesh epochs run 512
   graphs at a global batch of 256, 64 graphs a rank and batch (phase 15's
   shapes); the halo runs the first 508 at a global batch of 254, whose
   shard boundaries fall inside graphs 63 and 190, so that every shard has
   remote edges (checked on every batch) and the exchange carries real
   rows. This process first computes the single-card references on cuda:0
   (the sparse and dense paths at 256, the sparse one at 254, scanned
   operator and K3 runs at 256; their peak allocated memory is logged)
   and the single card's graphs/s at 64 (served and trained in both
   layouts, scanned operator and K3 epochs). Each rank makes each graph's
   plan once (``plans_once``), logs each path's peak allocated memory, and
   times ``partition_batch`` on every halo batch beside its ``H`` (rows a
   peer) and each shard's local and remote edges; the halo step's bytes
   are checked against ``halo_step_bytes`` at C0 ~161,700. The spawn's
   limit, ``ATOMIC_MESH_TIMEOUT_S``, follows from the ranks' host work. The
   ``4 cards {...}`` line carries its numbers under ``atomic``;
17. K4, the dense attention conv (``--k4`` runs phases 1, 2 and 17 alone;
   the default run right after phase 3b): at the atomic cell's shapes (the
   first batch of 64 atomic graphs, conv1 ``[64, 5,200, 16]`` over unsorted
   rows, conv2 ``[64, 640, 32]`` over sorted pooled-edge rows, random
   values) the CSR builds bitwise their plain version on the CPU, two runs
   bitwise equal, each output within ``K4_TOL`` of the plain version run on
   the card (1e-6 of the largest element for out, alpha and dxw, 1e-5 for
   dp, dq and db) and bitwise it at the rows of fewer than 32 lanes, and
   both against the plain version in float64, the launch plan, L2-flushed
   and L2-warm times beside the plain version's and the byte bounds
   (``K4 {...}`` lines); then
   attention GINet on ``train_store``'s path, 128 atomic graphs at batch
   64 on the store without the operators in scanned epochs, dropout off:
   two epochs' losses within ``TOL`` of the CPU's, and each captured
   step's launches a replay, read from its ``graph_stats()``, 4 CSR
   builds, 4 forward calls and 8 backward passes (``K4 store {...}``). The
   ``kernels`` line's ``fused_attention_conv`` entry carries its numbers.

Phase 3b holds the padding rule (no accumulating op sees a run of padding
lanes, ``ops/lanes.py``): each repaired op at the first batches' shapes,
forward and gradient, and one training step of each path, bitwise their
old forms on the card (``padding: ...``). Every profiled pass reports
``index_accumulation_ms`` (every ``indexing_backward_kernel*`` item) and
its share of the device's busy time.

The last two lines are a JSON object of per-kernel numbers and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import functools
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # read before a cold call: 5x the 50 MB L2
SPIN_CYCLES = 1_000_000  # ~0.5 ms of device spin that hides the host's launch
TOL = dict(rtol=2e-4, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 store packing against lossless: the raw fp32 payloads (features and
# the stored aggregations) keep 8 significant bits
BF16_TOL = dict(rtol=5e-2, atol=5e-3)

FOLD6_FEATURES = ["type", "polarity", "bsa", "charge", "cons", "ic", "pssm"]
NODES_PER_GRAPH = 130
EDGES_PER_GRAPH = 250  # stored undirected; 500 directed after doubling
BATCH = 128
PARITY_STEPS = 4

# K3's fast variant: the same source, its own kernel entry
FAST_K3 = {
    "route": "cuda",
    "source": "deeprank_gnn_tpu_torch/ops/csrc/fused_gin_conv.cu",
    "replaces": "deeprank_gnn_tpu/ops/pallas/__init__.py:178",
}

KERNELS = {
    "sorted_segment_sum": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/sorted_segment_sum.cu",
        "replaces": "deeprank_gnn_tpu/ops/pallas/segment.py:409",
    },
    "fused_gin_conv": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/fused_gin_conv.cu",
        "replaces": "deeprank_gnn_tpu/ops/pallas/__init__.py:204",
    },
    "sorted_scatter_gather": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/sorted_scatter_gather.cu",
        "replaces": "deeprank_gnn_tpu/ops/pallas/segment.py:326",
    },
    "fused_attention_conv": {
        "route": "cuda",
        "source": "deeprank_gnn_tpu_torch/ops/csrc/fused_attention_conv.cu",
        "replaces": None,  # the JAX package leaves the attention conv to XLA
    },
}
# K4's launch counter names: the CSR build, the forward, the backward's passes
K4_CSR, K4, K4_BWD = "attention_csr", "fused_attention_conv", "fused_attention_conv_bwd"


def log(msg: str) -> None:
    print(msg, flush=True)


def build_graphs(seed: int, num_graphs: int):
    """Fixture-scale residue graphs made with numpy from ``seed``:
    doubled edges with the distance transform applied, in no particular
    order (``GraphListDataSet`` row-sorts them, as ``HDF5DataSet`` does
    on load), and stored two-level clusters."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample, default_edge_transform

    rng = np.random.default_rng(seed)
    n, e = NODES_PER_GRAPH, EDGES_PER_GRAPH
    graphs = []
    for gi in range(num_graphs):
        x = np.hstack([
            np.eye(20)[rng.integers(0, 20, n)],  # type, one-hot
            np.eye(4)[rng.integers(0, 4, n)],  # polarity, one-hot
            rng.random((n, 4)),  # bsa, charge, cons, ic
            rng.standard_normal((n, 20)),  # pssm
        ]).astype(np.float32)
        src = rng.integers(0, n, e)
        dst = (src + 1 + rng.integers(0, n - 1, e)) % n
        src[:n] = np.arange(n)
        ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
        dist = 2.0 + 6.5 * rng.random(e)
        ea = default_edge_transform(np.concatenate([dist, dist])[:, None])
        ei, ea = ei.astype(np.int32), ea.astype(np.float32)
        _, c0 = np.unique(rng.integers(0, 29, n), return_inverse=True)
        c1 = np.arange(int(c0.max()) + 1) // 3
        graphs.append(
            GraphSample(
                mol=f"model_{gi:05d}",
                x=x,
                pos=rng.standard_normal((n, 3)).astype(np.float32),
                edge_index=ei,
                edge_attr=ea,
                internal_edge_index=ei[:, :e],
                internal_edge_attr=ea[:e],
                cluster0=c0.astype(np.int32),
                cluster1=c1.astype(np.int32),
                y=float(rng.random()),
            )
        )
    return graphs


# the standard heavy atoms of each residue type, and its one-letter code
RESIDUE_ATOMS = {
    "ALA": ("A", "N CA C O CB"),
    "ARG": ("R", "N CA C O CB CG CD NE CZ NH1 NH2"),
    "ASN": ("N", "N CA C O CB CG OD1 ND2"),
    "ASP": ("D", "N CA C O CB CG OD1 OD2"),
    "CYS": ("C", "N CA C O CB SG"),
    "GLN": ("Q", "N CA C O CB CG CD OE1 NE2"),
    "GLU": ("E", "N CA C O CB CG CD OE1 OE2"),
    "GLY": ("G", "N CA C O"),
    "HIS": ("H", "N CA C O CB CG ND1 CD2 CE1 NE2"),
    "ILE": ("I", "N CA C O CB CG1 CG2 CD1"),
    "LEU": ("L", "N CA C O CB CG CD1 CD2"),
    "LYS": ("K", "N CA C O CB CG CD CE NZ"),
    "MET": ("M", "N CA C O CB CG SD CE"),
    "PHE": ("F", "N CA C O CB CG CD1 CD2 CE1 CE2 CZ"),
    "PRO": ("P", "N CA C O CB CG CD"),
    "SER": ("S", "N CA C O CB OG"),
    "THR": ("T", "N CA C O CB OG1 CG2"),
    "TRP": ("W", "N CA C O CB CG CD1 CD2 NE1 CE2 CE3 CZ2 CZ3 CH2"),
    "TYR": ("Y", "N CA C O CB CG CD1 CD2 CE1 CE2 CZ OH"),
    "VAL": ("V", "N CA C O CB CG1 CG2"),
}
CA_SPACING = 5.1  # Å between lattice sites: ~133 Å^3 a residue, a protein's density


def _unit(v):
    return v / np.linalg.norm(v)


def synthetic_chain(rng, n_res: int, center):
    """``n_res`` residues of random types, their CAs on a jittered cubic
    lattice filling a ball around ``center`` in serpentine order (so that
    consecutive residues are neighbours), the backbone along the path and
    each side chain a walk of 1.52 Å bonds pointing outwards. Returns
    ``[(resname, [(atom name, xyz)])]``."""
    radius = (3 * n_res / (4 * np.pi)) ** (1 / 3) * CA_SPACING
    while True:
        k = int(np.ceil(radius / CA_SPACING))
        ax = np.arange(-k, k + 1)
        sites = [(i, (j if i % 2 else -j), (m if (i + j) % 2 else -m))
                 for i in ax for j in ax for m in ax]
        sites = [s for s in sites if np.linalg.norm(s) * CA_SPACING <= radius]
        if len(sites) >= n_res:
            break
        radius += 0.5
    cas = np.asarray(sites[:n_res], dtype=np.float64) * CA_SPACING + np.asarray(center)
    cas += 0.4 * rng.standard_normal(cas.shape)
    names = list(RESIDUE_ATOMS)
    chain = []
    for r in range(n_res):
        resname = names[rng.integers(len(names))]
        ca = cas[r]
        forward = _unit(cas[min(r + 1, n_res - 1)] - cas[max(r - 1, 0)]
                        + 0.1 * rng.standard_normal(3))
        outward = _unit(ca - np.asarray(center) + rng.standard_normal(3))
        atoms = {"CA": ca, "N": ca - 1.46 * forward + 0.2 * rng.standard_normal(3),
                 "C": ca + 1.52 * forward + 0.2 * rng.standard_normal(3)}
        atoms["O"] = atoms["C"] + 1.23 * _unit(np.cross(forward, outward))
        prev = ca
        for name in RESIDUE_ATOMS[resname][1].split()[4:]:
            prev = prev + 1.52 * _unit(outward + 0.8 * rng.standard_normal(3))
            atoms[name] = prev
        chain.append((resname, [(n, atoms[n]) for n in RESIDUE_ATOMS[resname][1].split()]))
    return chain


def _pdb_lines(chains) -> list:
    """PDB ATOM records of ``{chain id: residues}`` (residue numbers from 1),
    coordinates rounded to the format's 3 decimals."""
    lines, serial = [], 1
    for cid, residues in chains.items():
        for resseq, (resname, atoms) in enumerate(residues, start=1):
            for name, xyz in atoms:
                pad = f" {name:<3s}" if len(name) < 4 else name
                lines.append(
                    f"ATOM  {serial:5d} {pad:<4s} {resname:>3s} {cid:1s}{resseq:4d}    "
                    f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00          "
                    f"{name[0]:>2s}\n")
                serial += 1
    return lines + ["END\n"]


def _pssm_lines(rng, residues) -> list:
    """A PSSM in the reference's text format (``tools/PSSM.py``): per
    residue its number and one-letter code twice, 20 scores and the
    information content."""
    lines = ["Last position-specific scoring matrix computed\n",
             "pdbresi pdbresn seqresi seqresn    A    R    N    D    C    Q    E    G    H"
             "    I    L    K    M    F    P    S    T    W    Y    V   IC\n"]
    for resseq, (resname, _) in enumerate(residues, start=1):
        code = RESIDUE_ATOMS[resname][0]
        scores = " ".join(f"{v:4d}" for v in rng.integers(-7, 10, 20))
        lines.append(f"{resseq:7d} {code} {resseq:7d} {code} {scores} {rng.random() * 2:.2f}\n")
    return lines


def _rotation(rng, max_deg: float):
    axis = _unit(rng.standard_normal(3))
    t = np.deg2rad(rng.uniform(0.0, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def write_docking_models(root: str, seed: int, n_models: int, res_a: int, res_b: int,
                         tie: bool = False, name: str = "1SYN") -> dict:
    """Docking models of one synthetic complex, made with numpy from
    ``seed``: chain A of ``res_a`` residues and chain B of ``res_b`` in two
    touching balls, as the PDB files ``<root>/pdb/<name>_<k>.pdb``, model 0
    the unperturbed pose (also ``<root>/ref/<name>.pdb``) and each other
    model chain B turned up to 12 degrees about its centre and moved ~1 Å;
    a PSSM per chain (``<root>/pssm/<name>.<chain>.pdb.pssm``). With
    ``tie``, chain A's outermost atom sits on exact binary coordinates and
    every model ends chain B with a glycine whose CA lies exactly 8.5 Å
    further along x and whose other atoms are farther from chain A: its
    one contact is a pair of atoms at exactly the residue graph's cutoff."""
    rng = np.random.default_rng(seed)
    r_a = (3 * res_a / (4 * np.pi)) ** (1 / 3) * CA_SPACING
    r_b = (3 * res_b / (4 * np.pi)) ** (1 / 3) * CA_SPACING
    chain_a = synthetic_chain(rng, res_a, (0.0, 0.0, 0.0))
    center_b = np.array([r_a + r_b - 2.0, 0.0, 0.0])
    chain_b = synthetic_chain(rng, res_b, center_b)
    if tie:
        # chain A's outermost atom: a strict maximum of x, on a 1/8 Å grid
        xs = [(xyz[0], ri, ai) for ri, (_, atoms) in enumerate(chain_a)
              for ai, (_, xyz) in enumerate(atoms)]
        top, ri, ai = max(xs)
        second = max(x for x, r, a in xs if (r, a) != (ri, ai))
        anchor = np.round(chain_a[ri][1][ai][1] * 8) / 8
        anchor[0] = np.ceil(max(top, second + 0.125) * 8) / 8
        chain_a[ri][1][ai] = (chain_a[ri][1][ai][0], anchor)
        ca = anchor + np.array([8.5, 0.0, 0.0])
        glycine = ("GLY", [("N", ca + (1.25, 1.0, 0.0)), ("CA", ca),
                           ("C", ca + (1.25, -1.0, 0.0)), ("O", ca + (2.5, -1.0, 0.0))])
    dirs = {sub: os.path.join(root, sub) for sub in ("pdb", "pssm", "ref")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    pdbs = []
    for k in range(n_models):
        turn = np.eye(3) if k == 0 else _rotation(rng, 12.0)
        shift = np.zeros(3) if k == 0 else rng.standard_normal(3)
        moved = [(rn, [(an, (xyz - center_b) @ turn.T + center_b + shift) for an, xyz in atoms])
                 for rn, atoms in chain_b]
        if tie:
            moved.append(glycine)
        lines = _pdb_lines({"A": chain_a, "B": moved})
        pdbs.append(os.path.join(dirs["pdb"], f"{name}_{k}.pdb"))
        with open(pdbs[-1], "w") as f:
            f.writelines(lines)
        if k == 0:
            with open(os.path.join(dirs["ref"], f"{name}.pdb"), "w") as f:
                f.writelines(lines)
            chain_b_final = moved
    pssm = {}
    for cid, residues in (("A", chain_a), ("B", chain_b_final)):
        pssm[cid] = os.path.join(dirs["pssm"], f"{name}.{cid}.pdb.pssm")
        with open(pssm[cid], "w") as f:
            f.writelines(_pssm_lines(rng, residues))
    return {**dirs, "pdbs": pdbs, "pssm_files": pssm,
            "ref_file": os.path.join(dirs["ref"], f"{name}.pdb")}


def write_checkpoint(path: str, seed: int, Net=None, task: str = "reg",
                     target: str = "fnat", batch_size: int = BATCH, node=FOLD6_FEATURES,
                     width: int = 48) -> None:
    """A reference-format torch checkpoint of a seeded random ``Net``
    (default GINet) of ``width`` node features named by ``node`` (default
    the paper's 48 of ``fold6``): a regressor of ``target``, or with
    ``task="class"`` a classifier of two classes; an engine built from it
    serves at ``batch_size``."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet

    outputs = 2 if task == "class" else 1
    model = (Net or GINet)(width, outputs, 1, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    torch.save(
        {
            "model": model.state_dict(),
            "optimizer": {},
            "net": type(model).__name__,
            "node": list(node),
            "edge": ["dist"],
            "target": target,
            "task": task,
            "classes": [0, 1],
            "class_weight": None,
            "batch_size": batch_size,
            "percent": [1.0, 0.0],
            "lr": 0.001,
            "index": None,
            "shuffle": True,
            "threshold": 0.3,
            "cluster_nodes": "mcl",
            "transform_sigmoid": False,
        },
        path,
    )


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one eager call, from CUDA events around ``iters``
    back-to-back calls: the host's launch cost included."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call with its inputs in HBM: before each
    call the card reads a buffer five times the L2 cache's size (a read,
    so the call finds no dirty lines to write back), then spins while the
    host queues the call between two CUDA events, so the events bracket
    the call's device work alone."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    pairs = []
    for _ in range(warmup + reps):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs[warmup:]]))


def l2_warm_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one call with its inputs L2-resident: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events, so the host's launch cost drops out and every call after
    the first reads what the one before left in the 50 MB L2 cache."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def errors(got, want) -> dict:
    err = (got - want).abs()
    if not err.numel():
        return {"max_abs_err": 0.0, "max_rel_err": 0.0}
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / want.abs().clamp_min(1e-30)).max())}


# ---------------------------------------------------------------------------
# K1: sorted segment sum


def reorder_bound(row_ptr, mag, extra_terms: int = 0):
    """The most two orders of an fp32 sum of ``n`` terms can differ by, per
    row of ``row_ptr``: ``2 (n - 1) 2^-24`` times the row's sum of the
    terms' magnitudes ``mag``; ``n`` is the longest row's edges plus
    ``extra_terms`` added to every row."""
    n = int(row_ptr.diff().max()) + extra_terms
    return 2 * max(n - 1, 0) * 2.0 ** -24 * mag


def k1_case(name, data, row_ptr, rows, timed: bool, reordered: bool = False):
    """Check the sorted segment sum kernel against its plain version on
    the card (``KERNEL_TOL``; with ``reordered``, within the rounding bound
    of an fp32 sum taken in another order, for runs long enough that the
    card's atomics exceed ``KERNEL_TOL``) and bitwise against the plain
    version run on the CPU (both sum in edge order); log its launch plan;
    time it when ``timed``. Returns a dict of numbers."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.segment import (
        launch_plan,
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    a = sorted_segment_sum(data, row_ptr)
    b = sorted_segment_sum(data, row_ptr)
    want = sorted_segment_sum_plain(data, row_ptr, rows)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"K1 {name}: two launches differ")
    if reordered:
        # the plain version's index_add_ adds with atomics in no fixed order
        mag = sorted_segment_sum_plain(data.abs(), row_ptr, rows)
        if ((a - want).abs() > reorder_bound(row_ptr, mag)).any():
            raise AssertionError(f"K1 {name}: beyond the reordering bound of the plain "
                                 f"version on the card: {errors(a, want)}")
    else:
        torch.testing.assert_close(a, want, **KERNEL_TOL, msg=f"K1 {name}")
    want_cpu = sorted_segment_sum_plain(data.cpu(), row_ptr.cpu())
    if not torch.equal(a.cpu(), want_cpu):
        raise AssertionError(f"K1 {name}: not bitwise the plain version on the cpu: "
                             f"{errors(a.cpu(), want_cpu)}")
    n, f = row_ptr.shape[0] - 1, data.shape[1]
    e_valid = int(row_ptr[-1])
    res = {"case": name, "E": int(data.shape[0]), "E_valid": e_valid, "N": n, "F": f,
           **errors(a, want), **launch_plan(data, row_ptr)}
    if timed:
        lengths = row_ptr.diff().to(torch.int64)
        valid = data[:e_valid]
        lib = torch.segment_reduce(valid, "sum", lengths=lengths, unsafe=True)
        res.update(
            ms=cold_ms(lambda: sorted_segment_sum(data, row_ptr)),
            plain_ms=cold_ms(lambda: sorted_segment_sum_plain(data, row_ptr)),
            library_ms=cold_ms(
                lambda: torch.segment_reduce(valid, "sum", lengths=lengths, unsafe=True)
            ),
            l2_warm_ms=l2_warm_ms(lambda: sorted_segment_sum(data, row_ptr)),
            call_ms=call_ms(lambda: sorted_segment_sum(data, row_ptr)),
            library_max_abs_err=float((lib - want).abs().max()),
            bound_ms=k1_bound_ms(e_valid, n, f),
        )
    return res


def k1_bound_ms(e_valid: int, n: int, f: int) -> float:
    """Least time of one sorted segment sum: its bytes (valid input rows,
    row pointers and output, each moved once) over the HBM rate, or its
    adds over the fp32 rate, whichever is longer."""
    moved = (e_valid * f + n * f + n + 1) * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S, e_valid * f / FP32_FLOPS)


def k1_backward_case(name, data, row_ptr, rows, gen) -> dict:
    """K1's gradient (``segment_sum(..., row_ptr=)`` through its autograd
    Function: the kernel forward, ``grad[rows]`` backward) against the
    gradient of the plain version (``index_add_``, whose backward is an
    ``index_select``), on the card."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum_plain
    from deeprank_gnn_tpu_torch.ops.segment import segment_sum

    n = row_ptr.shape[0] - 1
    cot = torch.randn((n, data.shape[1]), generator=gen, device=data.device)
    x = data.clone().requires_grad_(True)
    segment_sum(x, rows, n, row_ptr=row_ptr).backward(cot)
    xp = data.clone().requires_grad_(True)
    sorted_segment_sum_plain(xp, row_ptr, rows).backward(cot)
    torch.cuda.synchronize()
    if not torch.equal(x.grad, xp.grad):
        raise AssertionError(f"K1 backward {name}: differs from the plain gradient")
    if x.grad[int(row_ptr[-1]):].any():
        raise AssertionError(f"K1 backward {name}: padding edges got a gradient")
    return {"case": name + "-backward", **errors(x.grad, xp.grad)}


def k1_lanes(f: int, vec: int) -> int:
    """The lanes per row of F columns read ``vec`` at a time: the smallest
    power of two at or above ceil(F / vec), at most 32."""
    lanes = 1
    while lanes < -(-f // vec) and lanes < 32:
        lanes *= 2
    return lanes


def k1_plan_want(n: int, f: int) -> tuple:
    """The (columns per load, lanes per row, loads in flight) K1's plan must
    give for N rows of F columns, 16-byte aligned: float2 where F is even,
    F <= 64 and N x its lanes stays within 3/4 of the threads the card holds
    resident, else float4 where F % 4 == 0, else float2 where F is even,
    else single floats; 4 float4 loads in flight, else 8."""
    import torch

    props = torch.cuda.get_device_properties(0)
    resident = props.multi_processor_count * props.max_threads_per_multi_processor
    vec = 4 if f % 4 == 0 else 2 if f % 2 == 0 else 1
    if vec == 4 and f <= 64 and 4 * n * k1_lanes(f, 2) <= 3 * resident:
        vec = 2
    return vec, k1_lanes(f, vec), 4 if vec == 4 else 8


def pooled_ends(b):
    """A collated batch's interface edges mapped through its level-0
    clusters, ``[2, E]`` int32, padding lanes at ``C0``: the input of
    ``coalesce_edges`` whose output is the batch's pooled edges."""
    import torch

    ends = b.assign0[b.edge_index.clamp(max=b.num_nodes - 1).long()]
    return torch.where(b.edge_mask[None], ends, b.num_clusters0)


def k1_phase(first_batch, seed: int):
    """K1 at the sparse paper-mode path's two shapes, the attention path's
    two and ``coalesce_edges``' (from the first collated batch), and at edge
    cases, forward and backward; the launch plans."""
    import torch

    from deeprank_gnn_tpu_torch.ops.coalesce import coalesce_slots
    from deeprank_gnn_tpu_torch.ops.kernels.segment import rows_from_row_ptr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def rand(e, f):
        return torch.randn((e, f), generator=gen, device=dev)

    def exact(e, f):
        # multiples of 1/64 below 8 in magnitude: every partial sum of a
        # run of thousands is exact in fp32, so the long-run cases compare
        # which edges were summed, not the rounding of the order they
        # were summed in
        return torch.randint(-512, 512, (e, f), generator=gen, device=dev).float() / 64

    def from_rows(rows_np, n):
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
        ptr = torch.from_numpy(np.searchsorted(rows_np, np.arange(n + 1)).astype(np.int32)).to(dev)
        return ptr, rows

    b = first_batch.to(dev)
    main = [
        # paper-mode GINet's fused towers, and the attention GINet's towers
        ("conv1", rand(b.edge_index.shape[1], 32), b.edge_rowptr, b.edge_index[0]),
        ("conv2", rand(b.pe_index.shape[1], 64), b.pe_rowptr, b.pe_index[0]),
        ("attention-conv1", rand(b.edge_index.shape[1], 16), b.edge_rowptr, b.edge_index[0]),
        ("attention-conv2", rand(b.pe_index.shape[1], 32), b.pe_rowptr, b.pe_index[0]),
    ]
    # coalesce_edges' sum: the batch's interface edges mapped through its
    # level-0 clusters, sorted by key, their attributes summed into slots
    order, _, _, _, cptr = coalesce_slots(pooled_ends(b), b.edge_mask, b.num_clusters0)
    coalesce = ("coalesce", b.edge_attr[order].contiguous(), cptr,
                rows_from_row_ptr(cptr, b.edge_attr.shape[0]))
    log(f"K1 event floor: {cold_ms(lambda: None)} ms between two events with no call")
    results = [k1_case(name, d, p, r, timed=True) for name, d, p, r in main + [coalesce]]

    n = 4000
    rows = np.sort(rng.choice(np.arange(0, n, 3), 20000))  # 2 of 3 rows empty
    rows[:8000] = n // 2  # one run of 8,000 edges
    rows = np.concatenate([np.sort(rows), np.full(777, n)])  # trailing padding
    ptr, r = from_rows(rows, n)
    edge_cases = [(f"edges-F{f}", exact(len(rows), f), ptr, r) for f in (1, 17, 100)]
    ptr0, r0 = from_rows(np.full(300, 50), 50)  # every row empty, all padding
    edge_cases.append(("all-empty-F32", exact(300, 32), ptr0, r0))
    results += [k1_case(name, d, p, rr, timed=False) for name, d, p, rr in edge_cases]
    for res in results:
        # every tensor here is a fresh allocation, so 16-byte aligned
        got = (res["vec"], res["lanes_per_row"], res["loads_in_flight"])
        if got != k1_plan_want(res["N"], res["F"]) or \
                res["rows_per_block"] * res["lanes_per_row"] != 256:
            raise AssertionError(f"K1 {res['case']}: launch plan {res}")
    by_case = {r["case"]: r for r in results}
    # the widths this phase times take float2 where rows are few or F is
    # small, float4 on paper mode's conv1 (F 32, N ~16,640)
    if (by_case["attention-conv1"]["vec"], by_case["conv1"]["vec"]) != (2, 4):
        raise AssertionError(f"K1: launch plans {by_case['attention-conv1']}, {by_case['conv1']}")
    results += [k1_backward_case(name, d, p, rr, gen)
                for name, d, p, rr in main + edge_cases[:1]]
    for res in results:
        log("K1 " + json.dumps(res))
    return results


# ---------------------------------------------------------------------------
# K3: per-graph GIN aggregation


def k3_bound_ms(s: int, f: int, row, col) -> float:
    """Least time of one K3 call ``out = fused_gin_conv(xw [G,S,F], row,
    col)`` on these indices: its bytes over the HBM rate, or one add per
    valid edge and column over the fp32 rate, whichever is longer. The
    bytes are the fp32 ``xw`` rows that a valid edge reads (each distinct
    (graph, ``col``) pair once; run padding and sentinel slots are never
    read; the fast variant reads them as fp32 too),
    ``out`` written whole in fp32 (G*S*F) and ``row`` and ``col`` read once.
    For the backward pass ``col, row`` swapped: it reads the gradient rows
    that a valid ``row`` names."""
    import torch

    g, e = row.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, device=col.device)[:, None] * s
    sources = int(torch.unique((col.long() + goff)[valid]).numel())
    moved = 4 * (sources * f + g * s * f + 2 * g * e)
    return 1e3 * max(moved / HBM_BYTES_PER_S, int(valid.sum()) * f / FP32_FLOPS)


def k3_library_pair(xw, row, col):
    """The PyTorch yardstick for K3: no single call computes it, so two
    library calls on prepared flat indices, ``index_select`` of the source
    rows and ``index_add_`` into a zero-filled output (nondeterministic
    atomics; timed only, never used by the port)."""
    import torch

    g, s, f = xw.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, device=row.device)[:, None] * s
    src = torch.where(valid, col.long() + goff, g * s).reshape(-1)
    dst = torch.where(valid, row.long() + goff, g * s).reshape(-1)
    rows = torch.cat([xw.reshape(g * s, f), xw.new_zeros((1, f))])
    out = xw.new_zeros((g * s + 1, f))

    def run():
        out.zero_()
        out.index_add_(0, dst, rows.index_select(0, src))
        return out

    return run


def k3_case(name, xw, row, col, gen, timed: bool) -> dict:
    """K3 forward and backward (the gradient through its autograd Function)
    bitwise equal to the plain version run on the CPU on the same inputs
    (``plain(xw, row, col)``, and ``plain(cot, col, row)`` for the
    backward), which sums in edge order as the kernel does; two launches
    bitwise equal; the launch plan; timed when ``timed``."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import (
        fused_gin_conv,
        fused_gin_conv_forward,
        fused_gin_conv_plain,
        launch_plan,
    )

    g, s, f = xw.shape
    e = row.shape[1]
    cot = torch.randn(xw.shape, generator=gen, device=xw.device)
    x = xw.clone().requires_grad_(True)
    fwd = fused_gin_conv(x, row, col)
    fwd.backward(cot)
    again = fused_gin_conv_forward(xw, row, col)
    bwd_again = fused_gin_conv_forward(cot, col, row)
    torch.cuda.synchronize()
    if not (torch.equal(fwd, again) and torch.equal(x.grad, bwd_again)):
        raise AssertionError(f"K3 {name}: two launches differ")
    xc, rc, cc, gc = xw.cpu(), row.cpu(), col.cpu(), cot.cpu()
    want, want_grad = fused_gin_conv_plain(xc, rc, cc), fused_gin_conv_plain(gc, cc, rc)
    got, got_grad = fwd.detach().cpu(), x.grad.cpu()
    fe, be = errors(got, want), errors(got_grad, want_grad)
    if not (torch.equal(got, want) and torch.equal(got_grad, want_grad)):
        raise AssertionError(f"K3 {name}: not bitwise the plain version on the cpu: "
                             f"forward {fe}, backward {be}")
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    res = {"case": name, "G": g, "S": s, "F": f, "E": e, "E_valid": int(valid.sum()),
           **launch_plan(xw.device, s, f, e),
           "max_abs_err": max(fe["max_abs_err"], be["max_abs_err"]),
           "max_rel_err": max(fe["max_rel_err"], be["max_rel_err"])}
    if timed:
        lib_fwd, lib_bwd = k3_library_pair(xw, row, col), k3_library_pair(cot, col, row)
        res.update(
            ms_fwd=cold_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            ms_bwd=cold_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            plain_ms_fwd=cold_ms(lambda: fused_gin_conv_plain(xw, row, col)),
            plain_ms_bwd=cold_ms(lambda: fused_gin_conv_plain(cot, col, row)),
            library_ms_fwd=cold_ms(lib_fwd),
            library_ms_bwd=cold_ms(lib_bwd),
            l2_warm_ms_fwd=l2_warm_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            l2_warm_ms_bwd=l2_warm_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            call_ms_fwd=call_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            library_max_abs_err=float(
                (lib_fwd()[: g * s].reshape(g, s, f).cpu() - want).abs().max()),
            bound_ms_fwd=k3_bound_ms(s, f, row, col),
            bound_ms_bwd=k3_bound_ms(s, f, col, row),
        )
    return res


def bf16_cast_kernel(x) -> str:
    """The name of the kernel that casts ``x`` (fp32 on the card) to bf16,
    as ``torch.profiler`` traces ``x.to(torch.bfloat16)``: the one kernel
    that call launches. The name need not mention bf16, so the casts a path
    launches are counted by this name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x.to(torch.bfloat16)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation]
    if len(names) != 1:
        raise AssertionError(f"a cast to bf16 traced {names}, want one kernel")
    return names[0]


def k3_fast_path_kernels(xw, row, col, cot, cast_kernel: str) -> dict:
    """The kernels that one forward and backward of the fast path's call
    (``fused_gin_conv(..., exact=False)`` through autograd, as the model
    makes it) launch, traced: device operations, K3's fast and exact
    kernels, and casts to bf16 (``cast_kernel``, the name
    :func:`bf16_cast_kernel` traced). The control traces the same call after
    a planted ``xw.to(torch.bfloat16)``: it must count exactly one cast
    more, so that the path's count means what it says."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import fused_gin_conv

    def call(plant: bool):
        x = xw.detach().requires_grad_(True)
        if plant:
            xw.to(torch.bfloat16)
        torch.autograd.grad(fused_gin_conv(x, row, col, exact=False), x, cot)

    patterns = (K3_FAST_NAME, K3_EXACT_NAME, cast_kernel)
    res = {}
    for label, plant in (("path", False), ("control", True)):
        prof = profile_run(lambda: call(plant), patterns, attempts=3)
        res[label] = {"device_ops": prof["device_ops"],
                      **{name: prof[f"trace[{pat}]"]["count"]
                         for name, pat in (("fast", K3_FAST_NAME), ("exact", K3_EXACT_NAME),
                                           ("casts", cast_kernel))}}
    if res["control"]["casts"] != res["path"]["casts"] + 1:
        raise AssertionError(f"K3 fast: a planted cast is not counted once: {res}")
    if (res["path"]["fast"], res["path"]["exact"]) != (2, 0):
        raise AssertionError(f"K3 fast: one call's forward and backward traced {res['path']}")
    return res


def k3_fast_case(name, xw, row, col, gen, timed: bool, cast_kernel: str = "",
                 trace: bool = True) -> dict:
    """K3's fast variant as the path runs it (``exact=False`` on fp32
    ``xw``: the kernel rounds it to bf16 itself; fp32 sums and output),
    forward and backward through its autograd Function, bitwise equal to the
    fp32 plain version run on the CPU on the bf16-rounded values (both sum in
    edge order); two launches bitwise equal; its launch plan beside the
    exact kernel's. Timed when ``timed``: the path's call beside the exact
    kernel on the same inputs in this call; the cast that the path no longer
    launches, alone; the plain version and the library pair on the rounded
    fp32 values; the bound (fp32 ``xw``, as the path reads it); and with
    ``trace`` the kernels one call's forward and backward launch, traced,
    casts (by the name ``cast_kernel``) counted against a control
    (:func:`k3_fast_path_kernels`)."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.gin_conv import (
        fused_gin_conv,
        fused_gin_conv_forward,
        fused_gin_conv_plain,
        launch_plan,
    )

    g, s, f = xw.shape
    e = row.shape[1]
    cot = torch.randn(xw.shape, generator=gen, device=xw.device)
    x = xw.clone().requires_grad_(True)
    fwd = fused_gin_conv(x, row, col, exact=False)
    fwd.backward(cot)
    again = fused_gin_conv_forward(xw, row, col, False)
    bwd_again = fused_gin_conv_forward(cot, col, row, False)
    torch.cuda.synchronize()
    if not (torch.equal(fwd, again) and torch.equal(x.grad, bwd_again)):
        raise AssertionError(f"K3 fast {name}: two launches differ")
    xr, cr = xw.bfloat16().float(), cot.bfloat16().float()  # the rounded values, in fp32
    rc, cc = row.cpu(), col.cpu()
    want, want_grad = fused_gin_conv_plain(xr.cpu(), rc, cc), fused_gin_conv_plain(cr.cpu(), cc, rc)
    got, got_grad = fwd.detach().cpu(), x.grad.cpu()
    fe, be = errors(got, want), errors(got_grad, want_grad)
    if not (torch.equal(got, want) and torch.equal(got_grad, want_grad)):
        raise AssertionError(f"K3 fast {name}: not bitwise the plain version on the rounded "
                             f"values on the cpu: forward {fe}, backward {be}")
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    exact_plan = launch_plan(xw.device, s, f, e)
    res = {"case": name, "G": g, "S": s, "F": f, "E": e, "E_valid": int(valid.sum()),
           **launch_plan(xw.device, s, f, e, True),
           "exact_slab": exact_plan["slab"],
           "exact_rows_per_block": exact_plan["rows_per_block"],
           "exact_blocks_per_graph": exact_plan["blocks_per_graph"],
           "exact_smem_bytes": exact_plan["smem_bytes"],
           "max_abs_err": max(fe["max_abs_err"], be["max_abs_err"]),
           "max_rel_err": max(fe["max_rel_err"], be["max_rel_err"]),
           # how far the rounding moves the result from the exact kernel's
           "vs_exact_max_abs": float((fwd.detach() - fused_gin_conv_forward(xw, row, col))
                                     .abs().max())}
    if timed and trace:
        traced = k3_fast_path_kernels(xw, row, col, cot, cast_kernel)
        res.update(
            # one call's forward and backward, traced: bf16 casts, device
            # operations, and the control's count with a planted cast
            cast_kernel=cast_kernel,
            cast_launches_fwd_bwd=traced["path"]["casts"],
            device_ops_fwd_bwd=traced["path"]["device_ops"],
            control_casts=traced["control"]["casts"])
    if timed:
        lib_fwd, lib_bwd = k3_library_pair(xr, row, col), k3_library_pair(cr, col, row)
        res.update(
            ms_fwd=cold_ms(lambda: fused_gin_conv_forward(xw, row, col, False)),
            ms_bwd=cold_ms(lambda: fused_gin_conv_forward(cot, col, row, False)),
            exact_ms_fwd=cold_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            exact_ms_bwd=cold_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            cast_ms=cold_ms(lambda: xw.to(torch.bfloat16)),
            plain_ms_fwd=cold_ms(lambda: fused_gin_conv_plain(xr, row, col)),
            plain_ms_bwd=cold_ms(lambda: fused_gin_conv_plain(cr, col, row)),
            library_ms_fwd=cold_ms(lib_fwd),
            library_ms_bwd=cold_ms(lib_bwd),
            l2_warm_ms_fwd=l2_warm_ms(lambda: fused_gin_conv_forward(xw, row, col, False)),
            l2_warm_ms_bwd=l2_warm_ms(lambda: fused_gin_conv_forward(cot, col, row, False)),
            exact_l2_warm_ms_fwd=l2_warm_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            exact_l2_warm_ms_bwd=l2_warm_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            # the path reads fp32 xw: the exact kernel's bytes
            bound_ms_fwd=k3_bound_ms(s, f, row, col),
            bound_ms_bwd=k3_bound_ms(s, f, col, row),
        )
    return res


def k3_phase(first_dense_batch, seed: int):
    """K3 at the dense path's first-batch shapes of both conv levels and at
    edge cases, all with random values: summation order shows in the bits."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def indices(g, s, e, one_row=False):
        """Unsorted rows with a long run of duplicates on one row (with
        ``one_row``, every valid edge on one row), sentinel (== S) and
        negative indices, and rows without edges."""
        row = rng.integers(0, s, (g, e))
        col = rng.integers(0, s, (g, e))
        row[:, : e // 4] = s // 3  # duplicates of one row
        if one_row:
            row[:] = s // 3
        row[:, ::7] = s
        col[:, 3::11] = s
        row[:, 5::13] = -1
        row[row == s // 2] = s // 2 + 1  # slot s//2 receives nothing
        rng.shuffle(row, axis=1)
        return (torch.from_numpy(row.astype(np.int32)).to(dev),
                torch.from_numpy(col.astype(np.int32)).to(dev))

    b = first_dense_batch.to(dev)
    g, ng = b.x.shape[0], b.x.shape[1]
    c0g = b.pool0_mask.shape[1]
    main = [
        ("conv1", rand((g, ng, 32)), b.row, b.col),
        ("conv2", rand((g, c0g, 64)), b.pe_row, b.pe_col),
    ]
    results = [k3_case(name, x, r, c, gen, timed=True) for name, x, r, c in main]
    edge = []
    for f in (1, 17, 100):
        edge.append((f"edges-F{f}", rand((6, 50, f)), *indices(6, 50, 400)))
    edge.append(("tiles-F32", rand((4, 300, 32)), *indices(4, 300, 10000)))
    edge.append(("one-row-F32", rand((3, 300, 32)), *indices(3, 300, 5000, one_row=True)))
    edge.append(("no-slab-F64", rand((2, 4000, 64)), *indices(2, 4000, 9000)))
    edge.append(("wide-S-F8", rand((2, 70000, 8)), *indices(2, 70000, 9000)))
    results += [k3_case(name, x, r, c, gen, timed=False) for name, x, r, c in edge]
    for res in results:
        log("K3 " + json.dumps(res))
    # the fast variant on the same inputs
    cast_kernel = bf16_cast_kernel(main[0][1])
    log(f"K3 fast: a cast to bf16 traces as {cast_kernel!r}")
    fast = [k3_fast_case(name, x, r, c, gen, timed=True, cast_kernel=cast_kernel)
            for name, x, r, c in main]
    fast += [k3_fast_case(name, x, r, c, gen, timed=False) for name, x, r, c in edge
             if name in ("edges-F17", "tiles-F32", "no-slab-F64")]
    for res in fast:
        log("K3 fast " + json.dumps(res))
        # the slab staged where the exact kernel stages it, with its bf16
        # copy (16-byte units) and 9 counters for each row a block adds; no
        # more blocks a graph; 8 columns a lane where F allows
        copy = -(-res["S"] * res["F"] // 8) * 8 * 2
        added = 9 * 4 * (res["rows_per_block"] - res["exact_rows_per_block"])
        if res["slab"] != (res["case"] != "no-slab-F64") or res["slab"] != res["exact_slab"] or (
                res["slab"] and res["smem_bytes"] != res["exact_smem_bytes"] + copy + added) or (
                res["blocks_per_graph"] > res["exact_blocks_per_graph"]) or (
                res["cols_per_lane"] != (8 if res["F"] % 8 == 0 else 1)):
            raise AssertionError(f"K3 fast {res['case']}: launch plan {res}")
    by_case = {r["case"]: r for r in results}
    for name in ("conv1", "conv2"):
        # the main shapes: slab staged, rows split at most 128 to a block, at
        # least two blocks resident per SM
        r = by_case[name]
        if not (r["slab"] and r["rows_per_block"] <= 128 and r["blocks_per_sm"] >= 2):
            raise AssertionError(f"K3 {name}: launch plan {r}")
    if by_case["conv1"]["blocks_per_graph"] < 2:
        raise AssertionError("K3: conv1's rows should be split over several blocks")
    for name in ("no-slab-F64", "wide-S-F8"):
        if by_case[name]["slab"]:
            raise AssertionError(f"K3 {name}: the slab should not fit in shared memory")
    if by_case["wide-S-F8"]["blocks_per_graph"] != -(-70000 // 128):
        raise AssertionError(f"K3 wide-S-F8: launch plan {by_case['wide-S-F8']}")
    return results, fast


# ---------------------------------------------------------------------------
# K2: sorted scatter-gather


# ---------------------------------------------------------------------------
# K4: the dense attention conv


def k4_bound_ms(xw, row, col, what: str) -> float:
    """Least time of one K4 call at these shapes: bytes over the HBM rate
    (a few flops a lane and column). A lane is kept when its row and col lie
    in ``[0, S)``. ``"csr"``: ``key`` and ``other`` read, ``ptr`` and
    ``perm`` written. ``"fwd"``: the ``xw`` rows kept lanes read (each
    distinct (graph, col) once), ``p`` and ``q``, the kept lanes' ``b``,
    ``col`` and ``perm``, and ``ptr`` read once; ``out`` and ``alpha``
    written. ``"bwd"`` (both passes): the ``dout`` rows and ``xw`` rows kept
    lanes read, ``p``, ``q``, the kept lanes' ``b``, ``row``, ``col``,
    ``alpha`` and both CSRs read once; ``dxw``, ``dp``, ``dq`` and ``db``
    written."""
    import torch

    g, s, f = xw.shape
    e = row.shape[1]
    kept = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, device=row.device)[:, None] * s
    sources = int(torch.unique((col.long() + goff)[kept]).numel())
    targets = int(torch.unique((row.long() + goff)[kept]).numel())
    k, ptr = int(kept.sum()), g * (s + 1)
    if what == "csr":
        moved = 3 * g * e + ptr
    elif what == "fwd":
        moved = sources * f + 2 * g * s + 3 * k + ptr + g * s * f + g * e
    else:
        moved = (targets + sources) * f + 2 * g * s + 4 * k + 2 * (ptr + k) \
            + g * s * f + 2 * g * s + g * e
    return 1e3 * 4 * moved / HBM_BYTES_PER_S


# K4 against its plain version on the card: the largest error over the
# tensor's largest element, for out, alpha and dxw, and for dp, dq and db
# (``tests/test_torch_attention_conv.py::test_k4_cuda_matches_plain`` gives
# the reasons)
K4_TOL = dict(out=1e-6, alpha=1e-6, dxw=1e-6, dp=1e-5, dq=1e-5, db=1e-5)


def k4_case(name, xw, p, q, b, row, col, dout) -> dict:
    """K4 at one conv's shapes: the two CSRs bitwise their plain version on
    the CPU; the forward and the backward twice (bitwise equal) and against
    the plain version run on the card (bitwise flags, the largest error over
    the tensor's largest element within ``K4_TOL``, and ``out`` and
    ``alpha`` bitwise at the rows of fewer than 32 lanes, where both sides
    add in the same order) and against the plain version in float64 on the
    CPU beside the card's plain version; the launch plan; L2-flushed and
    L2-warm times of the CSR build, the forward and the backward, the plain
    version's flushed times and the bounds. Raises where a check fails."""
    import torch

    from deeprank_gnn_tpu_torch.device import deterministic
    from deeprank_gnn_tpu_torch.ops.kernels import attention_conv as A

    g, s, f = xw.shape
    e = row.shape[1]
    by_row, by_col = A.attention_csr(row, col, s), A.attention_csr(col, row, s)
    csr_ok = all(torch.equal(got.ptr.cpu(), want.ptr) and torch.equal(got.perm.cpu(), want.perm)
                 for got, want in ((by_row, A.attention_csr_plain(row.cpu(), col.cpu(), s)),
                                   (by_col, A.attention_csr_plain(col.cpu(), row.cpu(), s))))

    def kernel():
        out, alpha = A.fused_attention_conv_forward(xw, p, q, b, row, col, by_row)
        return (out, alpha, *A.fused_attention_conv_backward(dout, xw, p, q, b, row, col, alpha,
                                                             by_row, by_col))

    def plain():
        with deterministic():
            out, alpha = A.fused_attention_conv_plain(xw, p, q, b, row, col)
            return (out, alpha,
                    *A.fused_attention_conv_plain_bwd(dout, xw, p, q, b, row, col, alpha))

    got, again, card = kernel(), kernel(), plain()
    d = lambda t: t.double().cpu()  # noqa: E731
    t_out, t_alpha = A.fused_attention_conv_plain(d(xw), d(p), d(q), d(b), row.cpu(), col.cpu())
    truth = (t_out, t_alpha, *A.fused_attention_conv_plain_bwd(
        d(dout), d(xw), d(p), d(q), d(b), row.cpu(), col.cpu(), t_alpha))
    torch.cuda.synchronize()
    kept = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    res = {"case": name, "G": g, "S": s, "F": f, "E": e, "kept": int(kept.sum()),
           **A.launch_plan(xw.device, s, f), "csr_bitwise_cpu_plain": csr_ok,
           "runs_bitwise": all(torch.equal(a, c) for a, c in zip(got, again))}
    rel = lambda a, w: float((a - w).abs().max() / w.abs().max().clamp_min(1e-30))  # noqa: E731
    for key, k, c, t in zip(K4_TOL, got, card, truth):
        res[key] = {"bitwise_card_plain": torch.equal(k, c), "vs_card_plain": rel(k, c),
                    "kernel_vs_f64": rel(d(k), t), "card_plain_vs_f64": rel(d(c), t)}
    # the rows of fewer than 32 lanes, and their lanes and the dropped ones
    short = by_row.ptr[:, 1:] - by_row.ptr[:, :-1] < 32  # [G, S]
    short_lanes = torch.cat([short, torch.ones_like(short[:, :1])], dim=1).gather(
        1, torch.where(kept, row.long(), s))
    res["short_rows"] = int(short.sum())
    res["short_rows_bitwise"] = (torch.equal(got[0][short], card[0][short])
                                 and torch.equal(got[1][short_lanes], card[1][short_lanes]))
    over = {k: res[k]["vs_card_plain"] for k, tol in K4_TOL.items()
            if not res[k]["vs_card_plain"] <= tol}
    if over or not (csr_ok and res["runs_bitwise"] and res["short_rows_bitwise"]
                    and res["short_rows"]):
        raise AssertionError(f"K4 {name}: over K4_TOL {over}; {res}")
    alpha = got[1]
    fwd = lambda: A.fused_attention_conv_forward(xw, p, q, b, row, col, by_row)  # noqa: E731
    bwd = lambda: A.fused_attention_conv_backward(  # noqa: E731
        dout, xw, p, q, b, row, col, alpha, by_row, by_col)
    csr = lambda: A.attention_csr(row, col, s)  # noqa: E731
    with deterministic():
        plain_fwd = cold_ms(lambda: A.fused_attention_conv_plain(xw, p, q, b, row, col), reps=10)
        plain_bwd = cold_ms(lambda: A.fused_attention_conv_plain_bwd(
            dout, xw, p, q, b, row, col, alpha), reps=10)
    res.update(
        ms_csr=cold_ms(csr), ms_fwd=cold_ms(fwd), ms_bwd=cold_ms(bwd),
        l2_warm_ms_csr=l2_warm_ms(csr), l2_warm_ms_fwd=l2_warm_ms(fwd),
        l2_warm_ms_bwd=l2_warm_ms(bwd), plain_ms_fwd=plain_fwd, plain_ms_bwd=plain_bwd,
        bound_ms_csr=k4_bound_ms(xw, row, col, "csr"),
        bound_ms_fwd=k4_bound_ms(xw, row, col, "fwd"),
        bound_ms_bwd=k4_bound_ms(xw, row, col, "bwd"))
    return res


def k4_phase(seed: int, kdir: str) -> dict:
    """K4 at the atomic cell's shapes: on the first batch of 64 of
    ``ATOMIC_GRAPHS`` atomic graphs (``build_atomic_graphs``, the dense
    layout without the operators) with random values, conv1 ``[64, 5,200,
    16]`` over the batch's unsorted ``row``, ``col`` and conv2 ``[64, 640,
    32]`` over its sorted ``pe_row``, ``pe_col`` (``k4_case``); then
    attention GINet's scanned store epochs on all of them
    (``k4_store_check``)."""
    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    dataset = GraphListDataSet(build_atomic_graphs(seed, ATOMIC_GRAPHS))
    batch, _ = next(iter(GraphLoader(dataset, batch_size=ATOMIC_BATCH, layout="dense")))
    dev = torch.device("cuda")
    d = batch.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    rand = lambda *shape, scale=1.0: scale * torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    g, s, c0g = d.x.shape[0], d.x.shape[1], d.pool0_mask.shape[1]
    results = []
    for name, n, f, row, col in (("atomic-conv1", s, 16, d.row, d.col),
                                 ("atomic-conv2", c0g, 32, d.pe_row, d.pe_col)):
        res = k4_case(name, rand(g, n, f), rand(g, n, scale=0.3), rand(g, n, scale=0.3),
                      rand(g, row.shape[1], scale=0.05), row, col, rand(g, n, f))
        log("K4 " + json.dumps(res))
        results.append(res)
    return {"cases": results, "store": k4_store_check(dataset, seed, kdir)}


def k4_store_check(dataset, seed: int, kdir: str) -> dict:
    """Attention GINet on ``train_store``'s path at the atomic shapes: the
    device store without the operators and scanned epochs (a step warmed up
    and captured once, then replayed), ``ATOMIC_GRAPHS`` graphs
    (``dataset``) at batch ``ATOMIC_BATCH``, dropout off. Two training
    epochs (``run_pass``: the counts and replays zeroed just before each),
    their losses within
    ``TOL`` of a CPU engine's two epochs from the same seed; the second
    epoch all replays, and each graph's launches a replay (its own
    ``graph_stats()``) K4's 4 CSR builds, 4 forward calls and 8 backward
    passes a step, and no other hand kernel."""
    import functools

    from deeprank_gnn_tpu_torch.models import GINet

    net = functools.partial(GINet, attention=True)
    kw = dict(percent=(1.0, 0.0), batch=ATOMIC_BATCH, net=net, **ATOMIC_ENGINE)
    rate, GINet.dropout_rate = GINet.dropout_rate, 0.0
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_k4_") as tmp:
            card = scan_engine(dataset, seed, tmp, "k4_card", kdir, ops=False, scan_epochs=True,
                               **kw)
            epochs = [run_pass(card, True) for _ in range(2)]
            stats = card._scan.graph_stats()
            cpu = scan_engine(dataset, seed, tmp, "k4_cpu", kdir, ops=False, device="cpu", **kw)
            cpu_losses = [cpu._run_pass(cpu.train_loader, training=True)[3] for _ in range(2)]
    finally:
        GINet.dropout_rate = rate
    losses = [t["loss"] for t in epochs]
    per_replay = [{k: v for k, v in st["launches"].items() if v} for st in stats]
    want = [{K4_CSR: 4 * st["steps"], K4: 4 * st["steps"], K4_BWD: 8 * st["steps"]}
            for st in stats]
    res = {"graphs": len(dataset), "batches": epochs[-1]["batches"], "losses": losses,
           "cpu_losses": cpu_losses, "replays": [t["replays"] for t in epochs],
           "launches_per_replay": per_replay, "steps_per_graph": [st["steps"] for st in stats],
           "accumulated_per_replay": [st["accumulated"] for st in stats],
           "ran_per_epoch": [t["ran"] for t in epochs], "walls": [t["wall"] for t in epochs]}
    log("K4 store " + json.dumps(res))
    if not stats or per_replay != want or res["replays"][-1] != res["batches"]:
        raise AssertionError(f"K4 store: launches a replay {per_replay}, want {want}; replays "
                             f"{res['replays']} over {res['batches']} batches")
    np.testing.assert_allclose(losses, cpu_losses, **TOL)
    return res


def k2_bound_ms(e_valid: int, e: int, n: int, f: int) -> float:
    """Least time of one sorted scatter-gather: its bytes (valid input rows
    and row pointers read once, ``out [N,F]`` and ``d2 [E,F]`` written
    whole once) over the HBM rate, or its adds over the fp32 rate,
    whichever is longer."""
    moved = (e_valid * f + n + 1 + n * f + e * f) * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S, e_valid * f / FP32_FLOPS)


def k2_library(data, row_ptr, rows):
    """The PyTorch yardstick for K2: no one call computes it, so
    ``torch.segment_reduce`` over the valid rows, then ``index_select`` of
    the sums at the valid edges' rows (indices prepared beforehand; the
    padding of ``d2`` is not written). Timed only, never used by the
    port."""
    import torch

    lengths = row_ptr.diff().to(torch.int64)
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    valid, idx = data[lo:hi], rows[lo:hi].long()

    def run():
        out = torch.segment_reduce(valid, "sum", lengths=lengths, unsafe=True)
        return out, out.index_select(0, idx)

    return run




def k2_case(name, data, row_ptr, rows, gen, timed: bool, reordered: bool = False) -> dict:
    """K2 against its plain version on the card: ``out`` and ``d2`` within
    ``KERNEL_TOL`` (with ``reordered``, within the rounding bound of an fp32
    sum taken in another order, :func:`reorder_bound`, for runs long enough
    that the card's atomics exceed ``KERNEL_TOL``), ``d2`` bitwise
    ``out[rows]`` and 0 outside every run,
    ``out`` bitwise K1's sums, two launches bitwise equal, and the gradient
    through its autograd Function (with both cotangents, and with the
    ``out`` one absent as on the softmax path, where the backward is K2
    itself) against the gradient through the plain version; and all of
    them bitwise equal to the plain version run on the CPU on the same
    inputs (both sum each row in edge order). Its launch plan. Timed when
    ``timed``."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import (
        launch_plan,
        sorted_scatter_gather,
        sorted_scatter_gather_plain,
    )
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum
    from deeprank_gnn_tpu_torch.ops.segment import SortedScatterGather

    n, (e, f) = row_ptr.shape[0] - 1, data.shape
    out, d2 = sorted_scatter_gather(data, row_ptr)
    out_b, d2_b = sorted_scatter_gather(data, row_ptr)
    want_out, want_d2 = sorted_scatter_gather_plain(data, row_ptr, rows)
    k1 = sorted_segment_sum(data, row_ptr)
    torch.cuda.synchronize()
    if not (torch.equal(out, out_b) and torch.equal(d2, d2_b)):
        raise AssertionError(f"K2 {name}: two launches differ")
    valid = (rows >= 0) & (rows < n)
    safe = torch.where(valid, rows, 0).long()

    def close(got, want, mag, what, extra_terms=0):
        """``got`` against the plain version on the card: ``KERNEL_TOL``, or
        with ``reordered`` the reordering bound of the sums' magnitudes
        ``mag`` (per row; gathered onto the edges for an edge array)."""
        if not reordered:
            torch.testing.assert_close(got, want, **KERNEL_TOL, msg=f"K2 {name} {what}")
            return
        bound = reorder_bound(row_ptr, mag, extra_terms)
        if got.shape[0] != n:
            bound = torch.where(valid[:, None], bound[safe], 0.0)
        if ((got - want).abs() > bound).any():
            raise AssertionError(f"K2 {name} {what}: beyond the reordering bound of the "
                                 f"plain version on the card: {errors(got, want)}")

    mag = sorted_scatter_gather_plain(data.abs(), row_ptr, rows)[0]
    close(out, want_out, mag, "out")
    close(d2, want_d2, mag, "d2")
    if not (torch.equal(d2[valid], out[rows[valid].long()]) and not d2[~valid].any()):
        raise AssertionError(f"K2 {name}: d2 is not bitwise out[rows], 0 at padding")
    if not torch.equal(out, k1):
        raise AssertionError(f"K2 {name}: out differs from K1's sums")
    cpu_out, cpu_d2 = sorted_scatter_gather_plain(data.cpu(), row_ptr.cpu())
    if not (torch.equal(out.cpu(), cpu_out) and torch.equal(d2.cpu(), cpu_d2)):
        raise AssertionError(f"K2 {name}: not bitwise the plain version on the cpu: out "
                             f"{errors(out.cpu(), cpu_out)}, d2 {errors(d2.cpu(), cpu_d2)}")
    errs = [errors(out, want_out), errors(d2, want_d2)]
    cot_out = torch.randn((n, f), generator=gen, device=data.device)
    cot_d2 = torch.randn((e, f), generator=gen, device=data.device)
    if name not in ("conv1", "conv2", "bench"):
        cot_out, cot_d2 = torch.round(cot_out * 64) / 64, torch.round(cot_d2 * 64) / 64
    for use_out in (True, False):
        x = data.clone().requires_grad_(True)
        o, g = SortedScatterGather.apply(x, row_ptr)
        ((g * cot_d2).sum() + ((o * cot_out).sum() if use_out else 0)).backward()
        xp = data.clone().requires_grad_(True)
        o, g = sorted_scatter_gather_plain(xp, row_ptr, rows)
        ((g * cot_d2).sum() + ((o * cot_out).sum() if use_out else 0)).backward()
        torch.cuda.synchronize()
        # the gradient sums each row's d2 cotangents, plus its out one
        g_mag = sorted_scatter_gather_plain(cot_d2.abs(), row_ptr, rows)[0]
        close(x.grad, xp.grad, g_mag + (cot_out.abs() if use_out else 0), "backward",
              int(use_out))
        if x.grad[~valid].any():
            raise AssertionError(f"K2 {name}: padding edges got a gradient")
        xc = data.cpu().requires_grad_(True)
        o, g = sorted_scatter_gather_plain(xc, row_ptr.cpu())
        ((g * cot_d2.cpu()).sum() + ((o * cot_out.cpu()).sum() if use_out else 0)).backward()
        if not torch.equal(x.grad.cpu(), xc.grad):
            raise AssertionError(f"K2 {name} backward (out cotangent {use_out}): not bitwise "
                                 f"the plain version's on the cpu: {errors(x.grad.cpu(), xc.grad)}")
        errs.append(errors(x.grad, xp.grad))
    e_valid = int(valid.sum())
    res = {"case": name, "E": e, "E_valid": e_valid, "N": n, "F": f,
           "max_abs_err": max(r["max_abs_err"] for r in errs),
           "max_rel_err": max(r["max_rel_err"] for r in errs),
           "longest_run": int(row_ptr.diff().max()) if n else 0,
           **launch_plan(data.device, n, f)}
    if timed:
        lib = k2_library(data, row_ptr, rows)
        lib_out, lib_d2 = lib()
        res.update(
            ms=cold_ms(lambda: sorted_scatter_gather(data, row_ptr)),
            plain_ms=cold_ms(lambda: sorted_scatter_gather_plain(data, row_ptr)),
            library_ms=cold_ms(lib),
            l2_warm_ms=l2_warm_ms(lambda: sorted_scatter_gather(data, row_ptr)),
            call_ms=call_ms(lambda: sorted_scatter_gather(data, row_ptr)),
            library_max_abs_err=max(float((lib_out - want_out).abs().max()),
                                    float((lib_d2 - want_d2[valid]).abs().max())),
            bound_ms=k2_bound_ms(e_valid, e, n, f),
        )
    return res


def k2_phase(first_batch, seed: int):
    """K2 at the attention softmax's two shapes of the first served batch
    (F = 1, positive values as ``exp`` gives), at the JAX package's
    ``bench.py`` SpMM shapes, and at edge cases (exactly summable values)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 2)

    def exact(e, f):
        return torch.randint(-512, 512, (e, f), generator=gen, device=dev).float() / 64

    def from_rows(rows_np, n):
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
        ptr = np.searchsorted(rows_np, np.arange(n + 1)).astype(np.int32)
        return torch.from_numpy(ptr).to(dev), rows

    b = first_batch.to(dev)
    cases = [
        ("conv1", torch.rand((b.edge_index.shape[1], 1), generator=gen, device=dev) * 3,
         b.edge_rowptr, b.edge_index[0]),
        ("conv2", torch.rand((b.pe_index.shape[1], 1), generator=gen, device=dev) * 3,
         b.pe_rowptr, b.pe_index[0]),
    ]
    # bench.py's bench_spmm_kernel: N 81,920, E 983,040, F 16, no padding
    n_b, e_b = 81920, 983040
    ptr_b, rows_b = from_rows(np.sort(rng.integers(0, n_b, e_b)), n_b)
    cases.append(("bench", torch.randn((e_b, 16), generator=gen, device=dev), ptr_b, rows_b))
    results = [k2_case(name, d, p, r, gen, timed=True) for name, d, p, r in cases]

    n = 4000
    rows = np.sort(rng.choice(np.arange(0, n, 3), 20000))  # 2 of 3 rows empty
    rows[:8000] = n // 2 - 2  # one run of 8,000 edges
    # leading padding (edges before row_ptr[0]) and trailing padding
    rows = np.concatenate([np.full(300, -1), np.sort(rows), np.full(777, n)])
    ptr, r = from_rows(rows, n)
    edge = [(f"edges-F{f}", exact(len(rows), f), ptr, r) for f in (1, 17, 100)]
    ptr0, r0 = from_rows(np.full(300, 50), 50)  # every row empty, all padding
    edge.append(("all-empty-F32", exact(300, 32), ptr0, r0))
    results += [k2_case(name, d, p, rr, gen, timed=False) for name, d, p, rr in edge]
    for res in results:
        log("K2 " + json.dumps(res))
    if int(ptr[0]) != 300:
        raise AssertionError("K2: the edge cases should carry leading padding")
    for res in results:
        # F = 1: a block of one warp stages its 32 rows' edges in
        # shared-memory tiles; other widths take lane groups, 256 threads
        want = (("tiles", 32, 32) if res["F"] == 1
                else ("lanes", 256 // k1_lanes(res["F"], 1), 256))
        if (res["path"], res["rows_per_block"], res["threads"]) != want or \
                (res["tile_edges"] > 0) != (res["path"] == "tiles"):
            raise AssertionError(f"K2 {res['case']}: launch plan {res}")
    edges_f1 = next(r for r in results if r["case"] == "edges-F1")
    if edges_f1["longest_run"] <= edges_f1["tile_edges"]:
        raise AssertionError(f"K2 edges-F1: the long run should cross tiles: {edges_f1}")
    return results


def launch_floor(reps: int = 200) -> dict:
    """The device time of an almost empty launch of K1 and of K2 (one row,
    one padding edge, no valid edge: K1 one block, K2 one block and its
    zero-fill blocks), as ``torch.profiler`` reads each launch: the floor
    under the kernels' in-pass times, which the profiled passes read the
    same way. Milliseconds per launch, median and mean over ``reps``
    launches of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeprank_gnn_tpu_torch.ops.kernels.scatter_gather import sorted_scatter_gather
    from deeprank_gnn_tpu_torch.ops.kernels.segment import sorted_segment_sum

    data = torch.ones((1, 1), device="cuda")
    ptr = torch.zeros(2, dtype=torch.int32, device="cuda")
    for _ in range(10):
        sorted_segment_sum(data, ptr)
        sorted_scatter_gather(data, ptr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            sorted_segment_sum(data, ptr)
            sorted_scatter_gather(data, ptr)
        torch.cuda.synchronize()
    res = {}
    for name in ("sorted_segment_sum", "sorted_scatter_gather"):
        times = [e.device_time / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(times) != reps:
            raise AssertionError(f"launch floor: {len(times)} {name} launches traced, want {reps}")
        res[name] = {"median_ms": float(np.median(times)), "mean_ms": float(np.mean(times))}
    log("launch floor under torch.profiler " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the padding rule: no accumulating op sees a run of padding lanes
#
# The repaired ops' old plain forms, as they stood before the rule: a dump
# row that all padding lanes share, or autograd of ``index_select``. Under
# ``use_deterministic_algorithms`` each of them sums the batch's padding as
# one serial run on the card. ``tests/test_torch_padding.py`` imports them.


def old_dump_row(index, n):
    import torch

    return torch.where((index >= 0) & (index < n), index, n)


def old_gather(data, index, fill=None):
    import torch

    if fill is not None:
        table = torch.cat([data, data.new_full((1,) + tuple(data.shape[1:]), fill)])
        return table.index_select(0, old_dump_row(index, data.shape[0]))
    return data.index_select(0, torch.clamp(index, 0, data.shape[0] - 1))


def old_segment_sum(data, segment_ids, num_segments, *, row_ptr=None):
    from deeprank_gnn_tpu_torch.ops.segment import SortedSegmentSum

    if row_ptr is not None:
        return SortedSegmentSum.apply(data, row_ptr)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, old_dump_row(segment_ids, num_segments), data)
    return out[:num_segments]


def old_segment_count(segment_ids, num_segments, row_ptr=None):
    import torch

    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    out = ones.new_zeros(num_segments + 1)
    out.index_add_(0, old_dump_row(segment_ids, num_segments), ones)
    return out[:num_segments]


def old_segment_mean(data, segment_ids, num_segments, *, nan_empty=False, row_ptr=None):
    import torch

    total = old_segment_sum(data, segment_ids, num_segments, row_ptr=row_ptr)
    if row_ptr is None:
        count = old_segment_count(segment_ids, num_segments)
    else:
        count = (row_ptr[1:] - row_ptr[:-1]).to(data.dtype)
    count = count.reshape((num_segments,) + (1,) * (data.dim() - 1))
    return total / count if nan_empty else total / torch.clamp(count, min=1.0)


def old_segment_max(data, segment_ids, num_segments, *, row_ptr=None):
    import torch

    ids = old_dump_row(segment_ids, num_segments).to(torch.int64)
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), float("-inf"))
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    out = out[:num_segments]
    count = old_segment_count(segment_ids, num_segments).reshape(
        (num_segments,) + (1,) * (data.dim() - 1))
    return torch.where(count > 0, out, torch.zeros((), dtype=data.dtype, device=data.device))


def old_segment_softmax(logits, segment_ids, num_segments, *, row_ptr=None):
    import torch

    from deeprank_gnn_tpu_torch.ops.segment import SortedScatterGather

    seg_max = old_segment_max(logits, segment_ids, num_segments)
    ids = old_dump_row(segment_ids, num_segments)
    exp = torch.exp(logits - torch.cat([seg_max, seg_max.new_zeros(1)]).index_select(0, ids))
    if row_ptr is not None:
        _, denom = SortedScatterGather.apply(exp[:, None], row_ptr)
        one = torch.ones((), dtype=exp.dtype, device=exp.device)
        denom = torch.where(ids < num_segments, denom[:, 0], one)
    else:
        denom = old_segment_sum(exp, segment_ids, num_segments)
        denom = torch.cat([denom, denom.new_ones(1)]).index_select(0, ids)
    return exp / torch.clamp(denom, min=1e-16)


def old_gather_nodes(x, idx):
    import torch

    g, s, f = x.shape
    goff = torch.arange(g, dtype=idx.dtype, device=idx.device)[:, None] * s
    flat = (torch.clamp(idx, 0, s - 1) + goff).reshape(-1)
    return x.reshape(g * s, f).index_select(0, flat).reshape(g, idx.shape[1], f)


def old_dense_segment_softmax(logits, idx, size):
    import torch

    from deeprank_gnn_tpu_torch.ops.dense import edge_sum_to_slots

    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    valid = idx < size
    member = ((idx[..., None] == torch.arange(size, dtype=idx.dtype, device=idx.device))
              & valid[..., None])
    slot_max = torch.where(member, logits[..., None], float("-inf")).amax(dim=1)
    slot_max = torch.where(torch.isfinite(slot_max), slot_max, zero)
    safe = torch.clamp(idx, 0, size - 1).long()
    shifted = torch.where(valid, logits - torch.gather(slot_max, 1, safe), zero)
    expv = torch.where(valid, torch.exp(shifted), zero)
    denom = edge_sum_to_slots(expv[..., None], idx, size)[..., 0]
    denom = torch.where(denom > 0, denom, torch.ones((), dtype=denom.dtype, device=denom.device))
    return expv / torch.gather(denom, 1, safe)


def old_member_max_pool(h, mem_idx, assign=None):
    import torch

    g, s, f = h.shape
    c, m = mem_idx.shape[1], mem_idx.shape[2]
    rows = torch.cat([h.reshape(g * s, f), h.new_full((1, f), float("-inf"))])
    goff = torch.arange(g, dtype=mem_idx.dtype, device=mem_idx.device)
    valid = mem_idx < s
    flat = torch.where(valid, mem_idx + goff.reshape(g, 1, 1) * s, g * s)
    out = rows.index_select(0, flat.reshape(-1)).reshape(g, c, m, f).amax(dim=2)
    return torch.where((~valid.any(dim=2))[..., None],
                       torch.zeros((), dtype=h.dtype, device=h.device), out)


def old_k1_plain(data, row_ptr, rows=None):
    from deeprank_gnn_tpu_torch.ops.kernels.segment import rows_from_row_ptr

    n = row_ptr.shape[0] - 1
    if rows is None:
        rows = rows_from_row_ptr(row_ptr, data.shape[0])
    out = data.new_zeros((n + 1, data.shape[1]))
    out.index_add_(0, old_dump_row(rows, n), data)
    return out[:n]


def old_k3_plain(xw, row, col):
    import torch

    g, s, f = xw.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, dtype=row.dtype, device=row.device)[:, None] * s
    src = torch.where(valid, col + goff, g * s).reshape(-1)
    dst = torch.where(valid, row + goff, g * s).reshape(-1)
    rows = torch.cat([xw.reshape(g * s, f), xw.new_zeros((1, f))])
    out = xw.new_zeros((g * s + 1, f))
    out.index_add_(0, dst, rows.index_select(0, src))
    return out[: g * s].reshape(g, s, f)


# (module of deeprank_gnn_tpu_torch, name, old form): every place the paths
# look a repaired op up
OLD_FORMS = [
    ("ops.segment", "gather", old_gather),
    ("ops.segment", "segment_count", old_segment_count),
    ("ops.segment", "segment_max", old_segment_max),
    ("ops.segment", "segment_softmax", old_segment_softmax),
    ("ops.segment", "segment_sum", old_segment_sum),
    ("ops.dense", "gather_nodes", old_gather_nodes),
    ("ops.dense", "segment_max", old_segment_max),
    ("ops.dense", "member_max_pool", old_member_max_pool),
    ("ops.pooling", "member_max_pool", old_member_max_pool),
    ("ops.pooling", "segment_max", old_segment_max),
    ("ops.pooling", "segment_mean", old_segment_mean),
    ("ops.kernels.segment", "sorted_segment_sum_plain", old_k1_plain),
    ("ops.kernels.scatter_gather", "sorted_segment_sum_plain", old_k1_plain),
    ("ops.kernels.gin_conv", "fused_gin_conv_plain", old_k3_plain),
    ("models.ginet", "gather", old_gather),
    ("models.ginet", "segment_softmax", old_segment_softmax),
    ("models.ginet", "segment_sum", old_segment_sum),
    ("models.foutnet", "gather", old_gather),
    ("models.foutnet", "gather_nodes", old_gather_nodes),
    ("models.foutnet", "segment_mean", old_segment_mean),
    ("models.sgat", "gather", old_gather),
    ("models.sgat", "gather_nodes", old_gather_nodes),
    ("models.sgat", "segment_mean", old_segment_mean),
    ("models.sgat", "segment_sum", old_segment_sum),
]


@contextlib.contextmanager
def old_forms():
    """The block runs with the repaired ops' old forms in their place."""
    import importlib

    saved = []
    for module, name, old in OLD_FORMS:
        mod = importlib.import_module(f"deeprank_gnn_tpu_torch.{module}")
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, old)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# (path, net, constructor keywords, first batch): one training step each
PADDING_PATHS = [
    ("sparse-paper", "GINet", {}, "sparse"),
    ("sparse-attention", "GINet", {"attention": True}, "sparse"),
    ("internal-tower", "GINet", {"internal_tower": True}, "sparse"),
    ("foutnet-sparse", "FoutNet", {}, "sparse"),
    ("sgat-sparse", "sGAT", {}, "sparse"),
    ("dense-k3", "GINet", {}, "dense"),
    ("dense-fast-k3", "GINet", {"dense_fast": True}, "dense"),
    ("dense-attention", "GINet", {"attention": True}, "dense"),
    ("foutnet-dense", "FoutNet", {}, "dense"),
    ("sgat-dense", "sGAT", {}, "dense"),
    ("dense-store-operators", "GINet", {}, "store"),
    ("dense-fast-store-operators", "GINet", {"dense_fast": True}, "store"),
]


def training_step(batch, name: str, kw: dict, seed: int, device: str):
    """One training step's forward, MSE loss and backward of a seeded net
    ``name`` (dropout on, from a seeded generator) on ``batch``, under
    deterministic algorithms: the loss and every parameter's gradient."""
    import torch

    import deeprank_gnn_tpu_torch.models as models
    from deeprank_gnn_tpu_torch.device import deterministic
    from deeprank_gnn_tpu_torch.train.losses import mse_loss

    gen = torch.Generator().manual_seed(seed)
    net = getattr(models, name)(batch.x.shape[-1], 1, 1, device=device, generator=gen, **kw)
    net.train()
    drop = torch.Generator(device=device).manual_seed(seed + 1)
    with deterministic():
        pred = net(batch, generator=drop)
        loss = mse_loss(pred[:, 0], batch.y.to(device), batch.y_mask.to(device))
        loss.backward()
    return loss.detach(), {k: p.grad for k, p in net.named_parameters() if p.grad is not None}


def repaired_op_cases(sb, db, gen) -> list:
    """``(name, new, old, x, cotangent)`` of each repaired op at the paths'
    first batches' shapes (``sb`` sparse, ``db`` dense, on the card), with
    the cotangent the paths give a gather: 0 at its padding lanes."""
    import torch

    from deeprank_gnn_tpu_torch.ops import dense as D
    from deeprank_gnn_tpu_torch.ops import pooling as P
    from deeprank_gnn_tpu_torch.ops import segment as S

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    n, c0, c1, g = sb.num_nodes, sb.num_clusters0, sb.num_clusters1, sb.num_graphs
    row, col = sb.edge_index[0], sb.edge_index[1]
    emask = sb.edge_mask[:, None].float()
    prow = sb.pe_index[0]
    pmask = sb.pe_mask[:, None].float()
    dg, ds = db.x.shape[0], db.x.shape[1]
    c0g = db.pool0_mask.shape[1]
    dmask = db.edge_mask[..., None].float()
    logits = rand(sb.edge_index.shape[1])
    return [
        ("gather conv1", lambda t: S.gather(t, col), lambda t: old_gather(t, col),
         rand(n, 32), rand(col.shape[0], 32) * emask),
        ("gather conv2", lambda t: S.gather(t, sb.pe_index[1]),
         lambda t: old_gather(t, sb.pe_index[1]), rand(c0, 64),
         rand(prow.shape[0], 64) * pmask),
        ("member pool level 1", lambda t: P.community_pooling_x(t, sb.assign0, c0, sb.mem0_idx),
         lambda t: old_member_max_pool(t[None], sb.mem0_idx[None])[0], rand(n, 32), rand(c0, 32)),
        ("member pool level 2", lambda t: P.max_pool_x(t, sb.assign1, c1, sb.mem1_idx),
         lambda t: old_member_max_pool(t[None], sb.mem1_idx[None])[0], rand(c0, 64),
         rand(c1, 64)),
        ("graph mean", lambda t: P.graph_mean_pool(t, sb.pool1_graph, g),
         lambda t: old_segment_mean(t, sb.pool1_graph, g), rand(c1, 64), rand(g, 64)),
        ("segment max", lambda t: S.segment_max(t, sb.assign0, c0),
         lambda t: old_segment_max(t, sb.assign0, c0), rand(n, 32), rand(c0, 32)),
        ("segment softmax", lambda t: S.segment_softmax(t, row, n, row_ptr=sb.edge_rowptr),
         lambda t: old_segment_softmax(t, row, n, row_ptr=sb.edge_rowptr), logits,
         rand(logits.shape[0]) * emask[:, 0]),
        ("gather nodes", lambda t: D.gather_nodes(t, db.col),
         lambda t: old_gather_nodes(t, db.col), rand(dg, ds, 32),
         rand(dg, db.col.shape[1], 32) * dmask),
        ("slot max pool", lambda t: D.slot_max_pool(t, db.assign0, c0g),
         lambda t: old_segment_max(t.reshape(dg * ds, 32), torch.where(
             (db.assign0 >= 0) & (db.assign0 < c0g),
             db.assign0 + torch.arange(dg, device="cuda", dtype=db.assign0.dtype)[:, None] * c0g,
             dg * c0g).reshape(-1), dg * c0g).reshape(dg, c0g, 32),
         rand(dg, ds, 32), rand(dg, c0g, 32)),
        ("dense segment softmax", lambda t: D.dense_segment_softmax(t, db.row, ds),
         lambda t: old_dense_segment_softmax(t, db.row, ds), rand(dg, db.row.shape[1]),
         rand(dg, db.row.shape[1]) * dmask[..., 0]),
    ]


def padding_phase(dataset, seed: int) -> dict:
    """Each repaired op on the card at the paths' first batches, forward
    and gradient, bitwise its old form (and the counts bitwise); then one
    training step of each path with the new ops and with the old forms
    swapped in: loss and every gradient bitwise (``torch.equal``, which
    holds across the sign of a zero). On the card the dense attention conv
    runs as K4 and calls none of the repaired ops (only its plain version,
    on the CPU, does), so the ``dense-attention`` step holds only the rest
    of that path (its pools) to their old forms."""
    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.device import deterministic
    from deeprank_gnn_tpu_torch.ops.segment import segment_count

    t0 = time.perf_counter()
    batches = {
        "sparse": next(iter(GraphLoader(dataset, batch_size=BATCH)))[0],
        "dense": next(iter(GraphLoader(dataset, batch_size=BATCH, layout="dense")))[0],
        "store": next(iter(GraphLoader(dataset, batch_size=BATCH, layout="dense",
                                       precompute_ops=True)))[0],
    }
    batches = {k: b.to("cuda") for k, b in batches.items()}
    sb = batches["sparse"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    ops = []
    for name, new, old, x, cot in repaired_op_cases(sb, batches["dense"], gen):
        got, want = [], []
        for fn, into in ((new, got), (old, want)):
            t = x.clone().requires_grad_(True)
            with deterministic():  # as the engine runs them
                out = fn(t)
                out.backward(cot)
            into += [out.detach(), t.grad]
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"padding: {name} not bitwise its old form: forward "
                                 f"{errors(got[0], want[0])}, gradient {errors(got[1], want[1])}")
        ops.append(name)
    with deterministic():
        for ids, num in ((sb.assign0, sb.num_clusters0), (sb.pool1_graph, sb.num_graphs),
                         (sb.edge_index[0], sb.num_nodes)):
            if not torch.equal(segment_count(ids, num), old_segment_count(ids, num)):
                raise AssertionError("padding: segment_count differs from its old form")
        if not torch.equal(segment_count(sb.edge_index[0], sb.num_nodes, sb.edge_rowptr),
                           old_segment_count(sb.edge_index[0], sb.num_nodes)):
            raise AssertionError("padding: counts from the CSR pointers differ")
    steps = []
    for label, name, kw, layout in PADDING_PATHS:
        loss, grads = training_step(batches[layout], name, kw, seed, "cuda")
        with old_forms():
            old_loss, old_grads = training_step(batches[layout], name, kw, seed, "cuda")
        torch.cuda.synchronize()
        same = torch.equal(loss, old_loss) and grads.keys() == old_grads.keys() and all(
            torch.equal(grads[k], old_grads[k]) for k in grads)
        if not same:
            raise AssertionError(f"padding: the {label} step differs from the old forms' "
                                 f"(loss {float(loss)} vs {float(old_loss)})")
        steps.append(label)
    sizes = {"pooled_edge_padding": int((~sb.pe_mask).sum()),
             "edge_padding": int((~sb.edge_mask).sum()),
             "member_slot_padding": int((sb.mem0_idx >= sb.num_nodes).sum()
                                        + (sb.mem1_idx >= sb.num_clusters0).sum())}
    res = {"ops_bitwise": ops, "steps_bitwise": steps, "first_batch": sizes,
           "phase_s": time.perf_counter() - t0}
    log("padding: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the engine's passes


def serve(dataset, ckpt: str, device: str, outdir: str, passes: int, layout: str, Net,
          **engine_kw):
    """Score every graph ``passes`` times through the port's engine on
    ``device`` (``engine_kw``: the store options); returns the engine, the
    last pass's outputs and loss, and per-pass wall times and launch
    counts. A store is built in the first pass."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    nn = NeuralNet(dataset, Net, pretrained_model=ckpt, device=device, outdir=outdir,
                   layout=layout, **engine_kw)
    walls, launches = [], []
    for _ in range(passes):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out, _out_m, _ys, loss, _data = nn.eval(nn.test_loader)
        if device == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(dict(LAUNCHES))
    return nn, np.asarray(out, dtype=np.float64), loss, walls, launches


def per_pass(per_batch: dict, batches: int) -> dict:
    """The launch counts a pass of ``batches`` batches must show."""
    return {k: v * batches for k, v in per_batch.items() if v}


# the kernel names of deterministic index accumulation on the card
INDEX_ACCUMULATION = "indexing_backward_kernel"


def nccl_kernels(on_card) -> dict:
    """The NCCL kernels among the profiler's device events ``on_card``
    (every item whose name holds "nccl"), by name: count and device ms."""
    out: dict = {}
    for e in on_card:
        if "nccl" in e.name.lower():
            k = out.setdefault(e.name[:80], {"count": 0, "device_ms": 0.0})
            k["count"] += 1
            k["device_ms"] += e.device_time / 1e3
    return out


def profile_pass(run, loader, kernel_bounds) -> dict:
    """Where one warm pass spends its time: the host's collation alone
    (``loader`` iterated without the model), then ``run()`` under
    ``torch.profiler``: wall time, the device's busy time (every kernel and
    copy it ran; the profiler's annotation ranges, such as
    ``Optimizer.step``, span kernels already counted and are left out),
    its idle share, the kernels that took most, and each named kernel's
    device time per batch beside ``kernel_bounds[name]``, its bound per
    batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    batches = sum(1 for _ in loader)
    collate_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    annotations = [e for e in on_card if e.is_user_annotation]
    on_card = [e for e in on_card if not e.is_user_annotation]
    if not on_card:
        raise AssertionError("the profiler traced no device operation")
    busy_ms = sum(e.device_time for e in on_card) / 1e3
    by_name: dict = {}
    for e in on_card:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.device_time / 1e3
    # the deterministic index accumulation's serial runs (the backward of
    # index_select, index_add_, index_put_ with accumulate, scatter_add_):
    # every item, not only the top ones
    accum_ms = sum(e.device_time for e in on_card if INDEX_ACCUMULATION in e.name) / 1e3
    res = {
        "batches": batches,
        "host_collate_ms": collate_ms,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops": len(on_card),
        "index_accumulation_ms": accum_ms,
        "index_accumulation_share_of_busy": accum_ms / busy_ms,
        "annotation_ms_not_counted": sum(e.device_time for e in annotations) / 1e3,
        "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
        "nccl_kernels": nccl_kernels(on_card),
    }
    for name, bound in kernel_bounds.items():
        ms = sum(v for k, v in by_name.items() if name in k)
        res[f"{name}_device_ms"] = ms
        res[f"{name}_ms_per_batch"] = ms / batches
        res[f"{name}_share_of_busy"] = ms / busy_ms
        res[f"{name}_bound_ms_per_batch"] = bound
    return res


# the port's functions that issue an accumulating op on the card (module of
# deeprank_gnn_tpu_torch, name): every place the paths look one up
ACCUMULATING = [
    ("ops.lanes", "index_add_rows"),  # RowGather's backward: a gather's gradient
    ("ops.segment", "index_add_rows"),  # segment_sum, segment_count, segment_mean
    ("ops.dense", "index_add_rows"),  # the dense edge-to-slot sums and counts
    ("ops.segment", "segment_reduce_raw"),  # segment_max, segment_min
    ("parallel.halo", "segment_reduce_raw"),
]


@contextlib.contextmanager
def labelled_accumulation():
    """The block runs with each function of ``ACCUMULATING`` wrapped in a
    ``record_function`` range named ``site: <function> < <caller> < ...``
    (three callers), so that a trace ties each accumulation kernel to the
    code that asked for it."""
    import importlib

    from torch.profiler import record_function

    def labelled(fn, name):
        def run(*args, **kw):
            callers, frame = [], sys._getframe(1)
            while frame is not None and len(callers) < 3:
                callers.append(f"{os.path.basename(frame.f_code.co_filename)}:"
                               f"{frame.f_code.co_name}")
                frame = frame.f_back
            with record_function(" < ".join([f"site: {name}"] + callers)):
                return fn(*args, **kw)
        return run

    saved = []
    for module, name in ACCUMULATING:
        mod = importlib.import_module(f"deeprank_gnn_tpu_torch.{module}")
        if hasattr(mod, name):  # an older checkout's module may not look it up
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, labelled(getattr(mod, name), name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def accumulation_sites(run) -> dict:
    """``run()`` under ``torch.profiler`` with the accumulating functions
    labelled (:func:`labelled_accumulation`): the index accumulation's
    kernels (``INDEX_ACCUMULATION``) by the innermost label around the op
    that launched them (else the autograd node that ran it, else the op):
    count and device milliseconds. Its own pass, since the labels cost the
    host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with labelled_accumulation(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    sites: dict = {}
    for e in prof.events():
        hits = [k for k in e.kernels if INDEX_ACCUMULATION in k.name]
        if not hits:
            continue
        label, parent = e.name, e.cpu_parent
        while parent is not None:
            if parent.name.startswith(("site: ", "autograd::engine::evaluate_function: ")):
                label = parent.name
                break
            parent = parent.cpu_parent
        site = sites.setdefault(label, {"count": 0, "device_ms": 0.0})
        site["count"] += len(hits)
        site["device_ms"] += sum(k.duration for k in hits) / 1e3
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]["device_ms"]))


def sparse_bound_per_batch(loader) -> float:
    """K1's bound per batch of ``loader``, averaged over its batches
    (conv1 at 32 columns over the interface edges, conv2 at 64 over the
    pooled edges)."""
    bounds = [k1_bound_ms(int(b.edge_rowptr[-1]), b.num_nodes, 32)
              + k1_bound_ms(int(b.pe_rowptr[-1]), b.num_clusters0, 64) for b, _ in loader]
    return float(np.mean(bounds))


def tower_levels(b, internal: bool = False) -> tuple:
    """``(E_valid, E, N, F)`` of one unfused tower's two sums over the
    sparse batch ``b``: conv1 at 16 columns over the interface edges (the
    internal edges for the internal tower), conv2 at 32 over their pooled
    edges."""
    ptr, idx, pptr, pidx = ((b.iedge_rowptr, b.iedge_index, b.pie_rowptr, b.pie_index)
                            if internal else
                            (b.edge_rowptr, b.edge_index, b.pe_rowptr, b.pe_index))
    return ((int(ptr[-1]), idx.shape[1], b.num_nodes, 16),
            (int(pptr[-1]), pidx.shape[1], b.num_clusters0, 32))


def zoo_bounds_per_batch(loader, towers=(False, False), attention: bool = True,
                         training: bool = False) -> dict:
    """K1's (and with ``attention`` K2's) bounds per batch of ``loader`` on
    an unfused sparse zoo path, averaged over its batches: per tower
    (``towers``: internal or not, :func:`tower_levels`) K1 sums the
    messages and K2 the softmax denominators (F = 1); training adds K2's
    backward, one more K2 call at F = 1 each (the messages' gradient is a
    plain gather, K1's backward no kernel). GINet has two towers, FoutNet
    and sGAT one and no softmax."""
    k1, k2 = [], []
    for b, _ in loader:
        levels = [lv for internal in towers for lv in tower_levels(b, internal)]
        k1.append(sum(k1_bound_ms(ev, n, f) for ev, _e, n, f in levels))
        k2.append((2 if training else 1) * sum(k2_bound_ms(ev, e, n, 1)
                                               for ev, e, n, _f in levels))
    out = {"sorted_segment_sum": float(np.mean(k1))}
    if attention:
        out["sorted_scatter_gather"] = float(np.mean(k2))
    return out


def halo_bound_per_batch(loader) -> float:
    """K1's bound per batch of ``loader`` in the halo layout on one rank
    (``partition_batch(b, 1)``): the fused towers' local and remote sums
    at 32 columns and the pooled conv at 64."""
    from deeprank_gnn_tpu_torch.parallel.halo import partition_batch

    bounds = []
    for b, _ in loader:
        h = partition_batch(b, 1)
        bounds.append(k1_bound_ms(int(h.loc_rowptr[0][-1]), h.nl, 32)
                      + k1_bound_ms(int(h.rem_rowptr[0][-1]), h.nl, 32)
                      + k1_bound_ms(int(h.pe_rowptr[-1]), h.num_clusters0, 64))
    return float(np.mean(bounds))


def dense_bound(b, backward: bool) -> float:
    """K3's bound for the dense batch ``b``: conv1 at 32 columns, conv2 at
    64, forward, and backward too when ``backward``."""
    total = 0.0
    for s, f, row, col in ((b.x.shape[1], 32, b.row, b.col),
                           (b.pool0_mask.shape[1], 64, b.pe_row, b.pe_col)):
        total += k3_bound_ms(s, f, row, col)
        if backward:
            total += k3_bound_ms(s, f, col, row)
    return total


def dense_bound_per_batch(loader, backward: bool) -> float:
    """K3's bound per batch of ``loader`` (:func:`dense_bound`)."""
    return float(np.mean([dense_bound(b, backward) for b, _ in loader]))


def serve_check(label: str, Net, dataset, ckpt: str, tmp: str, layout: str, per_batch: dict,
                bounds=None, passes: int = 2, sites: bool = True, ref=None, tol=TOL,
                **engine_kw) -> dict:
    """Score ``dataset`` with ``Net`` from ``ckpt`` on the card (``passes``
    passes, launch counts cleared before each and read after: ``per_batch``
    launches per batch, nothing else; a store engine from its store) and
    once on the CPU: finite
    predictions that match the CPU's at ``TOL``; with ``ref`` (another
    path's card predictions of the same graphs) no CPU run, and the
    predictions match ``ref`` at ``tol`` instead. With ``bounds`` (a
    function of the test loader giving each kernel's bound per batch) one
    more pass runs under ``torch.profiler``, and with ``sites`` another with
    the index accumulation's sites labelled. ``engine_kw`` (the store
    options) go to both engines."""
    nn, pred, loss, walls, launches = serve(
        dataset, ckpt, "cuda", os.path.join(tmp, f"serve_{label}"), passes, layout, Net,
        **engine_kw)
    batches = len(nn.test_loader)
    where = None
    if bounds is not None:
        where = profile_pass(lambda: nn.eval(nn.test_loader), nn.test_loader,
                             bounds(nn.test_loader))
        if sites:
            where["index_accumulation_sites"] = accumulation_sites(
                lambda: nn.eval(nn.test_loader))
    log(f"serve {label}: {len(pred)} models in {batches} batches; pass walls (s) {walls} "
        f"-> models/s {[len(pred) / w for w in walls]}; loss {loss}; launches per pass "
        f"{launches}")
    if where is not None:
        log(f"serve {label} breakdown " + json.dumps(where))
    want = per_pass(per_batch, batches)
    for i, count in enumerate(launches):
        if count != want:
            raise AssertionError(f"serve {label} pass {i}: launched {count}, want {want}")
    if engine_kw.get("device_cache"):
        store_built(nn.test_loader, f"serve {label}")
    if pred.shape != (len(dataset),) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
    if ref is not None:
        diff = np.abs(pred - ref)
        log(f"serve {label}: against the reference path on the card max abs {diff.max()}; "
            f"prediction std {pred.std()}")
        np.testing.assert_allclose(pred, ref, **tol)
        return {"pred": pred, "launches": launches[0], "where": where, "walls": walls,
                "ref_max_abs": float(diff.max())}
    _, pred_cpu, loss_cpu, walls_cpu, launches_cpu = serve(
        dataset, ckpt, "cpu", os.path.join(tmp, f"serve_{label}_cpu"), 1, layout, Net,
        **engine_kw)
    log(f"serve {label}: cpu pass {walls_cpu[0]} s, launches {launches_cpu[0]}")
    if launches_cpu[0]:
        raise AssertionError(f"the cpu pass launched kernels: {launches_cpu[0]}")
    diff = np.abs(pred - pred_cpu)
    log(f"serve {label}: card vs cpu max abs {diff.max()}, max rel "
        f"{(diff / np.maximum(np.abs(pred_cpu), 1e-30)).max()}, loss {loss} vs {loss_cpu}; "
        f"prediction std {pred.std()}")
    np.testing.assert_allclose(pred, pred_cpu, **TOL)
    np.testing.assert_allclose(loss, loss_cpu, **TOL)
    return {"pred": pred, "launches": launches[0], "where": where, "walls": walls,
            "cpu_max_abs": float(diff.max())}


def serve_phase(dataset, tmp: str, seed: int):
    """Paper-mode GINet: score through both layouts on the card and on the
    CPU, profiled, and the layouts against each other."""
    from deeprank_gnn_tpu_torch.models import GINet

    ckpt = os.path.join(tmp, "ginet_fold6_fnat.pth.tar")
    write_checkpoint(ckpt, seed)
    out = {
        "sparse": serve_check("sparse", GINet, dataset, ckpt, tmp, "sparse",
                              {"sorted_segment_sum": 2},
                              lambda ld: {"sorted_segment_sum": sparse_bound_per_batch(ld)}),
        "dense": serve_check("dense", GINet, dataset, ckpt, tmp, "dense", {"fused_gin_conv": 2},
                             lambda ld: {"fused_gin_conv": dense_bound_per_batch(ld, False)}),
    }
    diff = np.abs(out["dense"]["pred"] - out["sparse"]["pred"])
    log(f"serve: dense vs sparse on the card, max abs {diff.max()}")
    np.testing.assert_allclose(out["dense"]["pred"], out["sparse"]["pred"], **TOL)
    return out


def first_steps(nn, steps: int):
    """The losses of the first ``steps`` Adam steps of ``nn``'s training
    loader, as ``_run_pass(training=True)`` takes them, over as many
    epochs as that takes."""
    from deeprank_gnn_tpu_torch.device import deterministic

    losses = []
    nn.model.train()
    with deterministic():
        while len(losses) < steps:  # epoch after epoch where one has fewer batches
            for batch, _mols in nn.train_loader:
                if len(losses) == steps:
                    break
                item = nn._map_targets_host(batch)
                if nn._mesh_steps is None:
                    loss, _pred = nn._train_step(item.to(nn.device))
                else:  # a mesh engine's step on this rank's part of the batch
                    loss, _pred = nn._mesh_steps.train(nn._shard(item).to(nn.device),
                                                       nn._dropout_generator)
                losses.append(float(loss))
    nn.model.eval()
    return losses


def train_phase(label: str, Net, dataset, layout: str, seed: int, tmp: str, per_batch: dict,
                bounds=None, epochs: int = 2, resume: bool = True, config=None,
                ref_losses="cpu", **engine_kw) -> dict:
    """Train ``Net`` at the paper's width, batch 128, percent [0.8, 0.2]
    (``config`` overrides these, the features and the target): the first 4
    Adam steps (dropout off) against the CPU's at ``TOL`` (with
    ``ref_losses`` another path's first 4 on the card, against those
    instead, and no CPU run); the epoch passes
    of ``train()`` with ``per_batch`` launches per training batch (counts
    cleared before each epoch and read after; a store engine from its
    store) and finite losses. With
    ``bounds`` (a function of the training loader giving each kernel's
    bound per batch) the whole check: ``epochs`` epochs, a second run from
    the same seed bitwise equal, a profiled warm epoch, and with ``resume``
    save, reload and resume. ``engine_kw`` (the store options) go to every
    engine."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    kw = dict(node_feature=FOLD6_FEATURES, edge_feature=["dist"], target="fnat",
              batch_size=BATCH, percent=[0.8, 0.2], layout=layout, seed=seed, **engine_kw)
    kw.update(config or {})
    full = bounds is not None

    def engine(device, name, **extra):
        return NeuralNet(dataset, Net, device=device,
                         outdir=os.path.join(tmp, f"{label}_{name}"), **kw, **extra)

    # parity with the CPU from the same weights, dropout off (FoutNet and
    # sGAT have none)
    rate = GINet.dropout_rate
    GINet.dropout_rate = 0.0
    try:
        card = first_steps(engine("cuda", "parity_cuda"), PARITY_STEPS)
        cpu = (first_steps(engine("cpu", "parity_cpu"), PARITY_STEPS) if ref_losses == "cpu"
               else list(ref_losses))
    finally:
        GINet.dropout_rate = rate
    diff = np.abs(np.asarray(card) - np.asarray(cpu))
    held = "cpu" if ref_losses == "cpu" else "reference path"
    log(f"train {label}: first {PARITY_STEPS} losses card {card} {held} {cpu}; max abs "
        f"{diff.max()}, max rel {(diff / np.abs(cpu)).max()}")
    np.testing.assert_allclose(card, cpu, **TOL)

    # the main path: the epoch passes of train(), dropout on
    def run_epochs(nn, count):
        walls, launches, losses, valid = [], [], [], []
        for _ in range(count):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            _o, _om, _y, loss, _d = nn._run_pass(nn.train_loader, training=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(dict(LAUNCHES))
            losses.append(loss)
            if nn.valid_loader is not None:
                valid.append(nn._run_pass(nn.valid_loader, training=False)[3])
        return walls, launches, losses, valid

    a = engine("cuda", "a")
    walls, launches, losses, valid = run_epochs(a, epochs if full else 1)
    batches = len(a.train_loader)
    graphs = len(a.train_loader.dataset)
    log(f"train {label}: {graphs} graphs in {batches} batches per epoch; epoch walls (s) {walls} "
        f"-> graphs/s {[graphs / w for w in walls]} (the first cold); losses {losses}, "
        f"valid {valid}; launches {launches}")
    want = per_pass(per_batch, batches)
    for i, count in enumerate(launches):
        if count != want:
            raise AssertionError(f"train {label} epoch {i}: launched {count}, want {want}")
    if engine_kw.get("device_cache"):
        store_built(a.train_loader, f"train {label}")
    if not np.isfinite(losses + valid).all():
        raise AssertionError(f"train {label}: losses {losses}, valid {valid}")
    res = {"walls": walls, "launches": launches[0], "where": None, "graphs": graphs,
           "parity_max_abs": float(diff.max()), "parity_losses": card, "losses": losses}
    if not full:
        return res

    # determinism: a second run from the same seed
    params = {k: v.clone() for k, v in a.model.state_dict().items()}
    b = engine("cuda", "b")
    _w, _l, losses_b, valid_b = run_epochs(b, epochs)
    same = all(torch.equal(v, b.model.state_dict()[k]) for k, v in params.items())
    log(f"train {label}: second run losses {losses_b} valid {valid_b}; parameters equal {same}")
    if losses_b != losses or valid_b != valid or not same:
        raise AssertionError(f"train {label}: two runs from one seed differ")

    # a profiled warm epoch
    res["where"] = profile_pass(lambda: a._run_pass(a.train_loader, training=True),
                                a.train_loader, bounds(a.train_loader))
    # on the second run's engine: the resume below counts this one's steps
    res["where"]["index_accumulation_sites"] = accumulation_sites(
        lambda: b._run_pass(b.train_loader, training=True))
    log(f"train {label} breakdown " + json.dumps(res["where"]))
    if not resume:
        return res

    # save, reload, resume
    path = os.path.join(tmp, f"{label}_a", "resume.pth.tar")
    a.save_model(path)
    r = NeuralNet(dataset, Net, pretrained_model=path, layout=layout, device="cuda",
                  outdir=os.path.join(tmp, f"{label}_r"), **engine_kw)
    if not all(torch.equal(v, r.model.state_dict()[k]) for k, v in a.model.state_dict().items()):
        raise AssertionError(f"train {label}: the reloaded weights differ")
    state = r.optimizer.state_dict()["state"]
    steps = {float(s["step"]) for s in state.values()}
    if len(state) != len(list(r.model.parameters())) or steps != {(epochs + 1.0) * batches}:
        raise AssertionError(f"train {label}: reloaded Adam steps {steps}")
    resumed = r._run_pass(r.train_loader, training=True)[3]
    log(f"train {label}: reloaded {path}, Adam step {steps}; resumed epoch loss {resumed}")
    if not np.isfinite(resumed):
        raise AssertionError(f"train {label}: resumed loss {resumed}")
    return res


def attention_phase(dataset, tmp: str, seed: int) -> dict:
    """``functools.partial(GINet, attention=True)``, sparse, at full width:
    served from a reference-format checkpoint (4 K1 and 4 K2 launches per
    batch) and trained (4 K1 and 8 K2 per batch: K2's backward is K2),
    both profiled, with every check of the training phase."""
    from deeprank_gnn_tpu_torch.models import GINet

    net = functools.partial(GINet, attention=True)
    ckpt = os.path.join(tmp, "ginet_attention_fold6_fnat.pth.tar")
    write_checkpoint(ckpt, seed, net)
    t0 = time.perf_counter()
    served = serve_check("attention", net, dataset, ckpt, tmp, "sparse",
                         {"sorted_segment_sum": 4, "sorted_scatter_gather": 4},
                         lambda ld: zoo_bounds_per_batch(ld))
    log(f"phase serve attention: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = train_phase("attention", net, dataset, "sparse", seed, tmp,
                          {"sorted_segment_sum": 4, "sorted_scatter_gather": 8},
                          lambda ld: zoo_bounds_per_batch(ld, training=True))
    log(f"phase train attention: {time.perf_counter() - t0:.1f} s")
    return {"serve": served, "train": trained}


def zoo_phase(dataset, tmp: str, seed: int) -> dict:
    """The other new paths at a smaller count: each served against its CPU
    run (two passes, then one profiled) and trained 4 Adam steps against
    the CPU and one epoch, with its launches per batch; the dense attention
    GINet also against the sparse one. The dense edge-to-slot paths run no
    hand kernel."""
    from deeprank_gnn_tpu_torch.models import FoutNet, GINet, sGAT

    attention = functools.partial(GINet, attention=True)
    paths = [
        ("attention_dense", attention, "dense", {K4_CSR: 2, K4: 4},
         {K4_CSR: 4, K4: 4, K4_BWD: 8}),
        ("attention_sparse_small", attention, "sparse",
         {"sorted_segment_sum": 4, "sorted_scatter_gather": 4},
         {"sorted_segment_sum": 4, "sorted_scatter_gather": 8}),
        ("internal_tower", functools.partial(GINet, internal_tower=True), "sparse",
         {"sorted_segment_sum": 4}, {"sorted_segment_sum": 4}),
        ("foutnet_sparse", FoutNet, "sparse", {"sorted_segment_sum": 2},
         {"sorted_segment_sum": 2}),
        ("foutnet_dense", FoutNet, "dense", {}, {}),
        ("sgat_sparse", sGAT, "sparse", {"sorted_segment_sum": 2}, {"sorted_segment_sum": 2}),
        ("sgat_dense", sGAT, "dense", {}, {}),
    ]
    out = {}
    for label, net, layout, serve_per_batch, train_per_batch in paths:
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, f"{label}.pth.tar")
        write_checkpoint(ckpt, seed, net)
        served = serve_check(label, net, dataset, ckpt, tmp, layout, serve_per_batch,
                             lambda ld: {})
        trained = train_phase(label, net, dataset, layout, seed, tmp, train_per_batch)
        out[label] = {"serve": served, "train": trained}
        log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    diff = np.abs(out["attention_dense"]["serve"]["pred"]
                  - out["attention_sparse_small"]["serve"]["pred"])
    log(f"serve attention: dense vs sparse on the card, max abs {diff.max()}")
    np.testing.assert_allclose(out["attention_dense"]["serve"]["pred"],
                               out["attention_sparse_small"]["serve"]["pred"], **TOL)
    return out


# ---------------------------------------------------------------------------
# the device store


def same_fields(label: str, want, got) -> int:
    """Every field of batch ``got`` (on the card) bitwise ``want`` (on the
    CPU): dtype, shape and values; a field None in both or in neither.
    Returns the fields compared (those not None)."""
    import dataclasses

    import torch

    fields = 0
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if (a is None) != (b is None):
            raise AssertionError(f"{label} field {f.name}: None in one only")
        if a is None:
            continue
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b.cpu()):
            raise AssertionError(f"{label} field {f.name} differs")
        fields += 1
    return fields


def store_batches_check(dataset, precompute_ops: bool, batch: int = BATCH,
                        streamed=None) -> dict:
    """One unshuffled epoch of ``GraphLoader(device_cache=True)`` on the card
    at batch ``batch`` against the streaming loader with the same
    ``precompute_ops`` (or the epoch ``streamed`` it gave: its ``(batch,
    molecules)`` pairs): the same molecules, and every field of every batch
    bitwise the streamed batch moved to the card (the same dtype and shape;
    a field is None in both or in neither). Also the store's build time and
    its bytes, as ``estimate_store_bytes`` gives them and as
    ``torch.cuda.memory_allocated`` grows."""
    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.device_store import estimate_store_bytes

    kw = dict(batch_size=batch, layout="dense", precompute_ops=precompute_ops)
    if streamed is None:
        streamed = list(GraphLoader(dataset, **kw))
    stored = GraphLoader(dataset, device_cache=True, device="cuda", **kw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if not stored._maybe_build_store():
        raise AssertionError("the device store was not built")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - before
    nf, ef = dataset.feature_dims()
    estimate = estimate_store_bytes(len(dataset), num_features=nf, num_edge_features=ef,
                                    precompute_ops=precompute_ops, **stored._dense_caps)
    pairs = list(zip(streamed, stored))
    if len(pairs) != len(streamed) or len(stored) != len(streamed):
        raise AssertionError("store and streaming epochs differ in length")
    fields = 0
    for bi, ((sb, smols), (cb, cmols)) in enumerate(pairs):
        if smols != cmols:
            raise AssertionError(f"store batch {bi}: molecules differ")
        if cb.x.device.type != "cuda":
            raise AssertionError(f"store batch {bi} is on {cb.x.device}")
        fields += same_fields(f"store batch {bi}", sb, cb)
    # one batch's gather and unpack, eager (the host's launches included),
    # and the packed bytes it reads
    store, slots = stored._store, np.arange(batch)
    gather_ms = call_ms(lambda: store.batch(slots, batch), iters=50, warmup=5)
    res = {"precompute_ops": precompute_ops, "batches": len(pairs),
           "fields_per_batch": fields // len(pairs), "build_s": build_s,
           "estimate_bytes": estimate, "packed_bytes": store.nbytes,
           "allocated_bytes": allocated, "gather_call_ms": gather_ms,
           "gather_bytes": batch * store.nbytes // (len(dataset) + 1)}
    log("store batches bitwise the streamed ones " + json.dumps(res))
    return res


def store_k3_check(dataset, seed: int, tmp: str, dense_parity: list) -> dict:
    """Paper-mode GINet trained on store batches without the operators
    (``precompute_ops=False``): they feed K3. The first 4 Adam steps
    (dropout off) must be bitwise the streaming dense phase's, since the
    batches and their order are the same; then one epoch with dropout on,
    K3 4 launches per training batch."""
    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    def engine(name):
        nn = NeuralNet(dataset, GINet, node_feature=FOLD6_FEATURES, edge_feature=["dist"],
                       target="fnat", batch_size=BATCH, percent=[0.8, 0.2], layout="dense",
                       seed=seed, device="cuda", outdir=os.path.join(tmp, f"store_k3_{name}"))
        nn.train_loader = GraphLoader(nn.train_loader.dataset, batch_size=BATCH, shuffle=True,
                                      seed=seed, layout="dense", device_cache=True,
                                      precompute_ops=False, device="cuda")
        return nn

    rate = GINet.dropout_rate
    GINet.dropout_rate = 0.0
    try:
        LAUNCHES.clear()
        losses = first_steps(engine("parity"), PARITY_STEPS)
        torch.cuda.synchronize()
        steps_launches = dict(LAUNCHES)
    finally:
        GINet.dropout_rate = rate
    log(f"store k3: first {PARITY_STEPS} losses {losses}, streaming dense {dense_parity}; "
        f"launches {steps_launches}")
    if losses != dense_parity:
        raise AssertionError("store k3: losses are not bitwise the streaming dense phase's")
    if steps_launches != {"fused_gin_conv": 4 * PARITY_STEPS}:
        raise AssertionError(f"store k3: launched {steps_launches} in {PARITY_STEPS} steps")
    nn = engine("epoch")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    loss = nn._run_pass(nn.train_loader, training=True)[3]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    batches = len(nn.train_loader)
    log(f"store k3: one epoch, {batches} batches in {wall} s (store build included), "
        f"loss {loss}, launches {launches}")
    if launches != {"fused_gin_conv": 4 * batches} or not np.isfinite(loss):
        raise AssertionError(f"store k3 epoch: launches {launches}, loss {loss}")
    return {"launches": launches, "walls": [wall], "where": None,
            "graphs": len(nn.train_loader.dataset)}


def chunk_budget(dataset, batches: int, batch: int = BATCH) -> int:
    """A ``device_cache_bytes`` whose chunks hold ``batches`` batches of
    ``batch`` graphs (the operator path's store, the larger one)."""
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.device_store import estimate_store_bytes

    nf, ef = dataset.feature_dims()
    caps = GraphLoader(dataset, batch_size=batch, layout="dense")._dense_caps
    per_slot = estimate_store_bytes(1, num_features=nf, num_edge_features=ef, **caps) // 2
    return 2 * per_slot * (batches * batch + 1)


def chunked_check(dataset, ckpt: str, tmp: str, seed: int, store_pred, chunk_batches: int = 4,
                  min_chunks: int = 3, batch: int = BATCH,
                  label: str = "chunked", profile: bool = False,
                  train_epoch: bool = True) -> dict:
    """``device_cache="chunked"`` with a budget of ``chunk_batches`` batches
    of ``batch`` graphs a chunk (at least ``min_chunks`` chunks): unshuffled
    serving bitwise that of ``device_cache=True``, no hand kernel, the
    copies of the chunks on their side stream beside the host's time per
    chunk; then, with ``train_epoch``, a shuffled training epoch that sees
    every graph once. With ``profile`` a third, warm serving pass runs
    under ``torch.profiler``."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    budget = chunk_budget(dataset, chunk_batches, batch)
    kw = dict(layout="dense", device="cuda", device_cache="chunked", device_cache_bytes=budget)
    nn = NeuralNet(dataset, GINet, pretrained_model=ckpt, outdir=os.path.join(tmp, label),
                   **kw)
    t0 = time.perf_counter()
    nn.test_loader._maybe_build_chunks()
    build_s = time.perf_counter() - t0
    cs = nn.test_loader._chunk_store
    if cs.num_chunks < min_chunks:
        raise AssertionError(f"{label}: {cs.num_chunks} chunks")
    uploads = []
    upload = cs.upload

    def timed_upload(ci):
        # events around the copy on its side stream: the copy's device time
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(cs.copy_stream())
        store = upload(ci)
        end.record(cs.copy_stream())
        uploads.append((time.perf_counter(), start, end))
        return store

    cs.upload = timed_upload
    walls, launches = [], []
    for _ in range(2):
        uploads.clear()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = nn.eval(nn.test_loader)[0]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(dict(LAUNCHES))
    pred = np.asarray(out, dtype=np.float64)
    copy_ms = [s.elapsed_time(e) for _, s, e in uploads]
    host_ms = [1e3 * (b[0] - a[0]) for a, b in zip(uploads, uploads[1:])]
    where = (profile_pass(lambda: nn.eval(nn.test_loader), nn.test_loader, {}) if profile
             else None)
    log(f"{label}: {cs.num_chunks} chunks of {cs.chunk_nbytes} bytes (budget {budget}), "
        f"built in {build_s} s; pass walls {walls}; launches {launches}; copy per chunk (ms, "
        f"side stream) {copy_ms}; host between chunk uploads (ms) {host_ms}")
    if any(launches) or not np.array_equal(pred, store_pred):
        raise AssertionError(f"{label} serving: launches {launches}, max abs "
                             f"{np.abs(pred - store_pred).max()} against device_cache=True")
    if train_epoch:
        t = NeuralNet(dataset, GINet, node_feature=FOLD6_FEATURES, edge_feature=["dist"],
                      target="fnat", batch_size=batch, percent=[0.8, 0.2], seed=seed,
                      outdir=os.path.join(tmp, f"{label}_train"), **kw)
        data = t._run_pass(t.train_loader, training=True)[4]
        want = sorted(t.train_loader.dataset.get(i).mol
                      for i in range(len(t.train_loader.dataset)))
        chunks = t.train_loader._chunk_store.num_chunks
        log(f"{label} training epoch: {len(data['mol'])} graphs in {chunks} chunks")
        if sorted(data["mol"]) != want:
            raise AssertionError(f"{label} training epoch: not every graph exactly once")
    return {"chunks": cs.num_chunks, "pred": pred, "walls": walls, "launches": launches[0],
            "where": where, "copy_ms": copy_ms, "host_ms_between_uploads": host_ms,
            "budget": budget, "chunk_nbytes": cs.chunk_nbytes, "build_s": build_s}


def store_phase(dataset, zoo, tmp: str, seed: int, dense_parity: list, served_dense,
                zoo_out) -> dict:
    """The device store (``device_cache``): store batches bitwise the
    streamed ones; K3 on store batches; the operator path (the default with
    the store) served and trained with every check of phases 4 and 5 and no
    hand kernel; the chunked store; bf16 packing; FoutNet and sGAT on the
    operator path."""
    from deeprank_gnn_tpu_torch.models import FoutNet, GINet, sGAT

    out = {"batches": [store_batches_check(dataset, False),
                       store_batches_check(dataset, True)]}
    t0 = time.perf_counter()
    out["train_k3"] = store_k3_check(dataset, seed, tmp, dense_parity)
    log(f"phase store k3: {time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(tmp, "ginet_fold6_fnat.pth.tar")
    t0 = time.perf_counter()
    out["serve"] = serve_check("store", GINet, dataset, ckpt, tmp, "dense", {}, lambda ld: {},
                               device_cache=True)
    diff = np.abs(out["serve"]["pred"] - served_dense["pred"])
    log(f"serve store: operator path vs K3 path on the card, max abs {diff.max()}")
    np.testing.assert_allclose(out["serve"]["pred"], served_dense["pred"], **TOL)
    out["train"] = train_phase("store", GINet, dataset, "dense", seed, tmp, {}, lambda ld: {},
                               device_cache=True)
    log(f"phase store operators: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["chunked"] = chunked_check(dataset, ckpt, tmp, seed, out["serve"]["pred"])
    _, pred, _loss, walls, launches = serve(dataset, ckpt, "cuda", os.path.join(tmp, "bf16"), 1,
                                            "dense", GINet, device_cache=True, store_pack="bf16")
    diff = np.abs(pred - out["serve"]["pred"])
    log(f"serve store bf16: max abs {diff.max()} against lossless, max rel "
        f"{(diff / np.maximum(np.abs(out['serve']['pred']), 1e-30)).max()}; launches {launches}")
    np.testing.assert_allclose(pred, out["serve"]["pred"], **BF16_TOL)
    log(f"phase store chunked and bf16: {time.perf_counter() - t0:.1f} s")
    for label, net in (("foutnet", FoutNet), ("sgat", sGAT)):
        t0 = time.perf_counter()
        name = f"{label}_store"
        ckpt = os.path.join(tmp, f"{name}.pth.tar")
        write_checkpoint(ckpt, seed, net)
        served = serve_check(name, net, zoo, ckpt, tmp, "dense", {}, lambda ld: {},
                             device_cache=True)
        diff = np.abs(served["pred"] - zoo_out[f"{label}_dense"]["serve"]["pred"])
        log(f"serve {name}: operator path vs streaming dense on the card, max abs {diff.max()}")
        np.testing.assert_allclose(served["pred"], zoo_out[f"{label}_dense"]["serve"]["pred"],
                                   **TOL)
        trained = train_phase(name, net, zoo, "dense", seed, tmp, {}, device_cache=True)
        out[name] = {"serve": served, "train": trained}
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# scanned epochs and the fast mode


def scan_engine(dataset, seed: int, tmp: str, name: str, kdir: str, ops: bool = True,
                percent=(0.8, 0.2), batch: int = BATCH, net=None, device: str = "cuda", **kw):
    """``net`` (default paper-mode GINet) on the device store of
    ``device`` at batch ``batch`` from ``seed``; ``ops=False`` gives it
    store loaders without the precomputed operators, whose batches feed K3
    (and the attention conv). ``kw``: ``scan_epochs``, ``dense_fast``,
    ``mesh``, ``device_cache`` (default True), ``device_cache_bytes``, and
    the features and target (default those of ``fold6`` and ``fnat``)."""
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    args = dict(node_feature=FOLD6_FEATURES, edge_feature=["dist"], target="fnat",
                device_cache=True)
    args.update(kw)
    nn = NeuralNet(dataset, net or GINet, batch_size=batch, percent=list(percent),
                   layout="dense", seed=seed, device=device, executable_cache_dir=kdir,
                   outdir=os.path.join(tmp, f"scan_{name}"), **args)
    if not ops:
        for attr in ("train_loader", "valid_loader"):
            ld = getattr(nn, attr)
            if ld is not None:
                setattr(nn, attr, nn._loader(ld.dataset, shuffle=True, seed=seed,
                                             precompute_ops=False))
    return nn


def run_pass(nn, training: bool, loader=None) -> dict:
    """One ``_run_pass`` of ``nn`` (scanned when it scans) with the launch
    and collective-byte counts cleared just before and read just after:
    its wall time, loss and outputs; the hand-kernel launches counted, and
    those that ran (counted outside a capture, plus each captured graph's
    launches times its replays in this pass: a wrapper counts where it
    launches, and a graph launches at capture), and the collective bytes
    that ran, counted alike; the graphs' replays and the host's seconds
    issuing the steps."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.parallel import collectives

    loader = loader or (nn.train_loader if training else nn.valid_loader)
    graphs_before = len(nn._scan.graph_stats())
    nn._scan.reset_replays()
    LAUNCHES.clear()
    collectives.reset_collective_bytes()
    t0 = time.perf_counter()
    out, _out_m, _ys, loss, _data = nn._run_pass(loader, training=training)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(LAUNCHES)
    stats = nn._scan.graph_stats()
    ran = ran_counts(counted, stats, graphs_before, "launches")
    nbytes = ran_counts(collectives.collective_bytes(), stats, graphs_before,
                        "collective_bytes")
    return {"wall": wall, "loss": loss, "out": out, "counted": counted, "ran": ran,
            "bytes": nbytes, "replays": sum(st["replays"] for st in stats),
            "issue_s": nn._scan.last_issue_s, "batches": len(loader),
            "graphs": len(loader.dataset)}


def store_built(ld, label: str) -> None:
    """Raise unless the loader ``ld`` of a store engine serves from its
    device store (resident or chunked): over its budget a store loader
    streams (a scanned engine then loops over streamed batches, and the
    operator path, with its operators collated per batch, gives the same
    predictions)."""
    if ld._store is None and ld._chunk_store is None:
        raise AssertionError(f"{label}: no device store was built (over its budget of "
                             f"{ld.device_cache_bytes} B?); the engine streamed")


def ran_counts(counted: dict, stats: list, graphs_before: int, key: str) -> dict:
    """What ran, from what the host ``counted`` (captures included) and the
    graph stats: the captures of the graphs made since ``graphs_before``
    taken out, every graph's ``key`` counts times its replays added."""
    ran = Counter(counted)
    for st in stats[graphs_before:]:
        ran.subtract(st[key])
    for st in stats:
        for k, v in st[key].items():
            ran[k] += v * st["replays"]
    return dict(+ran)


def profile_run(run, patterns=(), attempts: int = 1) -> dict:
    """``run()`` under ``torch.profiler``: wall time, the device's busy time
    and idle share (as ``profile_pass`` counts them), device operations,
    the index accumulation's device time, and per name pattern the kernels
    whose name holds it: count and device milliseconds. A trace without
    device events raises; with ``attempts`` > 1, for a ``run`` that has the
    same effect each time (one call on fixed inputs), it is first taken
    again, up to ``attempts`` traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        if on_card:
            break
        log(f"profile: trace {attempt} of {attempts} held no device operation")
    if not on_card:
        raise AssertionError("the profiler traced no device operation")
    busy_ms = sum(e.device_time for e in on_card) / 1e3
    accum_ms = sum(e.device_time for e in on_card if INDEX_ACCUMULATION in e.name) / 1e3
    res = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ops": len(on_card),
           "index_accumulation_ms": accum_ms, "nccl_kernels": nccl_kernels(on_card)}
    for pat in patterns:
        hits = [e for e in on_card if pat.lower() in e.name.lower()]
        res[f"trace[{pat}]"] = {"count": len(hits),
                                "device_ms": sum(e.device_time for e in hits) / 1e3}
    return res


def assert_same_training(label: str, a, b) -> None:
    """Two engines trained alike (a looped and a scanned one): bitwise the
    same parameters, Adam state and dropout generator state."""
    import torch

    for (name, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        if not torch.equal(x, y):
            raise AssertionError(f"scan {label}: parameter {name} differs from the looped run")
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for k in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(sa[k][key], sb[k][key]):
                raise AssertionError(f"scan {label}: Adam {key} of parameter {k} differs")
    if not torch.equal(a._dropout_generator.get_state(), b._dropout_generator.get_state()):
        raise AssertionError(f"scan {label}: the dropout generator's state differs")


K3_EXACT_NAME = "fused_gin_conv_kernel<"
K3_FAST_NAME = "fused_gin_conv_fast_kernel"


def scan_training_check(label: str, dataset, seed: int, tmp: str, kdir: str, ops: bool,
                        epochs: int = 3, **kw) -> dict:
    """A looped and a scanned engine from one seed, dropout 0.4 on, in this
    process: ``epochs`` training and validation passes each, the scanned
    ones bitwise the looped ones (losses, predictions, parameters, Adam
    state, the dropout generator's state); each pass's walls, the scanned
    graph replays and the hand-kernel launches that ran (``run_pass``);
    then a profiled warm scanned epoch (idle share, device busy time, the
    kernels traced by name) and a looped one."""
    looped = scan_engine(dataset, seed, tmp, f"{label}_looped", kdir, ops, **kw)
    scanned = scan_engine(dataset, seed, tmp, f"{label}_scanned", kdir, ops, scan_epochs=True,
                          **kw)
    runs = {"looped": [], "scanned": []}
    none = {"loss": None, "out": None}  # no validation set
    for name, nn in (("looped", looped), ("scanned", scanned)):
        for _ in range(epochs):
            runs[name].append((run_pass(nn, True),
                               none if nn.valid_loader is None else run_pass(nn, False)))
    for i, ((lt, lv), (st, sv)) in enumerate(zip(runs["looped"], runs["scanned"])):
        if (lt["loss"], lv["loss"], lv["out"]) != (st["loss"], sv["loss"], sv["out"]):
            raise AssertionError(f"scan {label} epoch {i}: losses {lt['loss']} {lv['loss']} "
                                 f"looped, {st['loss']} {sv['loss']} scanned")
        if lt["ran"] != st["ran"]:
            raise AssertionError(f"scan {label} epoch {i}: kernels ran {lt['ran']} looped, "
                                 f"{st['ran']} scanned")
    assert_same_training(label, looped, scanned)
    batches = runs["scanned"][0][0]["batches"]
    # the first scanned epoch: one warm-up step per set of store buffers
    # (two for the chunked store's chunks in turn), then a graph replay per
    # batch; later epochs replay every batch
    cs = scanned.train_loader._chunk_store
    warm = 1 if cs is None else min(2, cs.num_chunks)
    replays = [t["replays"] for t, _v in runs["scanned"]]
    if replays != [batches - warm] + [batches] * (epochs - 1):
        raise AssertionError(f"scan {label}: replays per epoch {replays}, {batches} batches")
    patterns = (K3_EXACT_NAME, K3_FAST_NAME)
    prof_scan = profile_run(lambda: scanned._run_pass(scanned.train_loader, training=True),
                            patterns)
    prof_loop = profile_run(lambda: looped._run_pass(looped.train_loader, training=True),
                            patterns)
    graphs = runs["scanned"][0][0]["graphs"]
    res = {
        "batches": batches, "graphs": graphs, "replays_per_epoch": replays,
        "losses": [t["loss"] for t, _v in runs["scanned"]],
        "valid_losses": [v["loss"] for _t, v in runs["scanned"]],
        "looped_walls": [t["wall"] for t, _v in runs["looped"]],
        "scanned_walls": [t["wall"] for t, _v in runs["scanned"]],
        "looped_graphs_per_s": [graphs / t["wall"] for t, _v in runs["looped"]],
        "scanned_graphs_per_s": [graphs / t["wall"] for t, _v in runs["scanned"]],
        "scanned_host_ms_per_batch": [1e3 * t["issue_s"] / batches
                                      for t, _v in runs["scanned"]],
        "looped_ms_per_batch": [1e3 * t["wall"] / batches for t, _v in runs["looped"]],
        "ran_per_epoch": [t["ran"] for t, _v in runs["scanned"]],
        "counted_per_epoch": [t["counted"] for t, _v in runs["scanned"]],
        "graph_stats": scanned._scan.graph_stats(),
        "scanned_profile": prof_scan, "looped_profile": prof_loop,
        "bitwise_with_dropout": True,
    }
    if cs is not None:
        res["chunks"] = cs.num_chunks
    log(f"scan {label}: " + json.dumps(res))
    return res, scanned


def skip_host_only_steps(nn) -> None:
    """Leave out the epoch bookkeeping of ``_train_full_scan`` that needs
    what the card's machine lacks: the epoch HDF5 export (``h5py``) and
    the metrics (scikit-learn). The CPU tests run both."""
    nn._export_epoch_hdf5 = lambda epoch, data: None
    nn.get_metrics = lambda *args, **kw: argparse.Namespace(accuracy=None)


def full_scan_check(dataset, seed: int, tmp: str, kdir: str, epochs: int = 3) -> dict:
    """``scan_epochs="full"`` on the operator path: a whole
    ``train(nepoch=3, validate=True, save_model="best")`` call as one
    scanned run (``_train_full_scan``; ``skip_host_only_steps``) bitwise the looped engine's three
    training and validation passes from the same seed, dropout on (losses,
    the last epoch's outputs, parameters, Adam state, the dropout
    generator's state), with one "best" checkpoint; then a warm call timed
    and a third profiled. Each call's replays, host ms per batch (the
    steps' issue time over every pass's batches) and graphs/s (training
    and validation graphs over the call's wall)."""
    import torch

    looped = scan_engine(dataset, seed, tmp, "full_looped", kdir)
    full = scan_engine(dataset, seed, tmp, "full_scanned", kdir, scan_epochs="full")
    lt = [(run_pass(looped, True), run_pass(looped, False)) for _ in range(epochs)]
    issue = []
    steps_run = full._scan.run

    def timed_run(*args, **kw):
        steps_run(*args, **kw)
        issue.append(full._scan.last_issue_s)

    full._scan.run = timed_run
    skip_host_only_steps(full)
    batches = (len(full.train_loader) + len(full.valid_loader)) * epochs
    graphs = (len(full.train_loader.dataset) + len(full.valid_loader.dataset)) * epochs

    def call():
        full.data = {}
        full._scan.reset_replays()
        issue.clear()
        t0 = time.perf_counter()
        if not full._train_full_scan(epochs, True, "best", "intermediate", 5):
            raise AssertionError("full scan: no store")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"wall": wall, "graphs_per_s": graphs / wall,
                "replays": sum(st["replays"] for st in full._scan.graph_stats()),
                "host_ms_per_batch": 1e3 * sum(issue) / batches}

    first = call()
    want = ([t["loss"] for t, _v in lt], [v["loss"] for _t, v in lt])
    if (full.train_loss, full.valid_loss) != want or full.valid_out != lt[-1][1]["out"]:
        raise AssertionError(f"full scan: losses {full.train_loss} {full.valid_loss}, looped "
                             f"{want}")
    assert_same_training("full", looped, full)
    ckpts = [f for f in os.listdir(full.outdir) if f.endswith(".pth.tar")]
    best = int(np.argmin(full.valid_loss)) + 1
    if ckpts != [full._ckpt_name(epochs, best)]:
        raise AssertionError(f"full scan: checkpoints {ckpts}, best epoch {best}")
    warm = call()
    prof = profile_run(call)
    res = {"epochs": epochs, "batches_per_call": batches, "graphs_per_call": graphs,
           "losses": want[0], "valid_losses": want[1], "best_epoch": best,
           "looped_graphs_per_s": [graphs / epochs / (t["wall"] + v["wall"]) for t, v in lt],
           "first": first, "warm": warm, "profile": prof, "bitwise_with_dropout": True}
    log("scan full: " + json.dumps(res))
    return res


def scan_phase(dataset, tmp: str, seed: int, kdir: str, store_pred) -> dict:
    """Scanned epochs (``scan_epochs=True``) on the device store, in this
    process beside the looped store path: the operator path (no hand
    kernel) and store batches without the operators (K3 inside the
    captured graph, 4 launches per batch), each with ``scan_training_check``
    (the profiled scanned epoch must trace K3's launches as the counts
    give them); the scanned engine's checkpoint (its Adam ``step`` a CPU
    scalar that counts the steps taken) reloads and trains on scanned; then
    scanned serving of the 2,048 graphs on the operator path, bitwise the
    looped store serving, three passes and a profiled one."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet

    out = {}
    t0 = time.perf_counter()
    out["operators"], scanned = scan_training_check("operators", dataset, seed, tmp, kdir, True)
    if any(out["operators"]["ran_per_epoch"]):
        raise AssertionError(f"scan operators: hand kernels ran {out['operators']}")
    path = os.path.join(tmp, "scan_operators_scanned", "scanned.pth.tar")
    scanned.save_model(path)
    steps = {float(s["step"]) for s in torch.load(path, weights_only=False)["optimizer"]
             ["state"].values()}
    want_steps = 4.0 * out["operators"]["batches"]  # 3 epochs and the profiled one
    types = {type(s["step"]).__name__ + str(getattr(s["step"], "device", ""))
             for s in torch.load(path, weights_only=False)["optimizer"]["state"].values()}
    r = scan_engine(dataset, seed, tmp, "operators_reloaded", kdir, scan_epochs=True,
                    pretrained_model=path)
    resumed = run_pass(r, True)
    log(f"scan operators: saved Adam steps {steps} ({types}), want {want_steps}; reloaded and "
        f"trained on scanned, loss {resumed['loss']}")
    if steps != {want_steps} or types != {"Tensorcpu"} or not np.isfinite(resumed["loss"]):
        raise AssertionError(f"scan operators: checkpoint steps {steps} {types}, "
                             f"resumed loss {resumed['loss']}")
    out["checkpoint_steps"] = sorted(steps)
    log(f"phase scan operators: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    out["k3"], _ = scan_training_check("k3", dataset, seed, tmp, kdir, False)
    k3 = out["k3"]
    want = {"fused_gin_conv": 4 * k3["batches"]}
    trace = k3["scanned_profile"][f"trace[{K3_EXACT_NAME}]"]["count"]
    log(f"scan k3: K3 launches ran per epoch {k3['ran_per_epoch']} (counted "
        f"{k3['counted_per_epoch']}: the first epoch's warm-up step and capture), traced in "
        f"the profiled scanned epoch {trace}; want {want}")
    if any(ran != want for ran in k3["ran_per_epoch"]) or trace != want["fused_gin_conv"]:
        raise AssertionError(f"scan k3: launches {k3['ran_per_epoch']}, traced {trace}, "
                             f"want {want}")
    log(f"phase scan k3: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "ginet_fold6_fnat.pth.tar")
    nn, pred, loss, walls, launches = serve(
        dataset, ckpt, "cuda", os.path.join(tmp, "scan_serve"), 3, "dense", GINet,
        device_cache=True, scan_epochs=True, executable_cache_dir=kdir)
    batches = len(nn.test_loader)
    issue_ms = 1e3 * nn._scan.last_issue_s / batches  # the last unprofiled pass
    prof = profile_run(lambda: nn.eval(nn.test_loader))
    if not np.array_equal(pred, store_pred) or any(launches):
        raise AssertionError(f"scan serve: max abs {np.abs(pred - store_pred).max()} against "
                             f"the looped store serving; launches {launches}")
    out["serve"] = {"pred": pred, "walls": walls, "launches": launches[0], "where": prof,
                    "models_per_s": [len(pred) / w for w in walls], "batches": batches,
                    "host_ms_per_batch": issue_ms, "graph_stats": nn._scan.graph_stats()}
    log("scan serve: " + json.dumps({k: v for k, v in out["serve"].items() if k != "pred"}))
    log(f"phase scan serve: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    out["full"] = full_scan_check(dataset, seed, tmp, kdir)
    log(f"phase scan full: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["chunked"], _ = scan_training_check(
        "chunked", dataset, seed, tmp, kdir, True, device_cache="chunked",
        device_cache_bytes=chunk_budget(dataset, 4))
    if out["chunked"]["chunks"] < 3 or any(out["chunked"]["ran_per_epoch"]):
        raise AssertionError(f"scan chunked: {out['chunked']['chunks']} chunks, launches "
                             f"{out['chunked']['ran_per_epoch']}")
    log(f"phase scan chunked: {time.perf_counter() - t0:.1f} s")
    return out


def fast_phase(dataset, tmp: str, seed: int, kdir: str, exact_k3_losses: list,
               cast_kernel: str, label: str = "fast", **engine_kw) -> dict:
    """The fast mode (``dense_fast=True``) scanned on store batches without
    the operators: a fresh engine's first epoch is the main path of K3's
    fast variant (its launches: the warm-up step's, and the capture's
    times the replays), held bitwise to the looped fast epoch and within
    ``BF16_TOL`` of the exact K3 path's loss; a profiled epoch traces the
    bf16 kernel once per launch and the fp32 one never, and counts the
    casts to bf16 (``cast_kernel``, as phase 3 traced one). Then the fast
    operator path (``adj_conv`` with bf16 operands in the graph) for one
    scanned epoch. ``engine_kw`` go to every engine (``scan_engine``), and
    ``label`` names them and the log lines."""
    out = {}
    looped = scan_engine(dataset, seed, tmp, f"{label}_looped", kdir, False, dense_fast=True,
                         **engine_kw)
    scanned = scan_engine(dataset, seed, tmp, f"{label}_scanned", kdir, False, dense_fast=True,
                          scan_epochs=True, **engine_kw)
    lt = run_pass(looped, True)
    st = run_pass(scanned, True)
    if st["loss"] != lt["loss"]:
        raise AssertionError(f"{label} k3: scanned {st['loss']} != looped {lt['loss']}")
    assert_same_training(label, looped, scanned)
    want = {"fused_gin_conv_bf16": 4 * st["batches"]}
    prof = profile_run(lambda: scanned._run_pass(scanned.train_loader, training=True),
                       (K3_EXACT_NAME, K3_FAST_NAME, cast_kernel))
    traced = (prof[f"trace[{K3_FAST_NAME}]"]["count"], prof[f"trace[{K3_EXACT_NAME}]"]["count"])
    log(f"{label} k3: looped loss {lt['loss']} ran {lt['ran']}; scanned loss {st['loss']} ran "
        f"{st['ran']} counted {st['counted']} replays {st['replays']}; exact K3 path's first "
        f"loss {exact_k3_losses[0]}; traced fast/exact K3 {traced}, bf16 casts "
        f"{prof[f'trace[{cast_kernel}]']}; profile {json.dumps(prof)}")
    if st["ran"] != want or lt["ran"] != want or traced != (want["fused_gin_conv_bf16"], 0):
        raise AssertionError(f"{label} k3: launches scanned {st['ran']} looped {lt['ran']}, "
                             f"traced {traced}, want {want}")
    np.testing.assert_allclose(st["loss"], exact_k3_losses[0], **BF16_TOL)
    out["k3"] = {"loss": st["loss"], "launches": st["ran"], "counted": st["counted"],
                 "replays": st["replays"], "wall": st["wall"], "graphs": st["graphs"],
                 "profile": prof, "casts": prof[f"trace[{cast_kernel}]"]["count"]}
    ops = scan_engine(dataset, seed, tmp, f"{label}_operators", kdir, True, dense_fast=True,
                      scan_epochs=True, **engine_kw)
    ot = run_pass(ops, True)
    log(f"{label} operators: scanned loss {ot['loss']}, ran {ot['ran']}, replays {ot['replays']}")
    if not np.isfinite(ot["loss"]) or ot["ran"]:
        raise AssertionError(f"{label} operators: loss {ot['loss']}, launches {ot['ran']}")
    out["operators"] = {"loss": ot["loss"], "wall": ot["wall"], "replays": ot["replays"]}
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 11. multi-device: two gloo ranks on the one card, then an NCCL group of
# one; with ``--cards 4``, four NCCL ranks, one a card

MESH_GRAPHS = 512  # 4 batches of 128
MESH_RANKS = 2
MESH_TIMEOUT_S = 600
# ``--cards 4``: 8 global batches of 512, so that each rank takes 128 graphs
# a batch, the single card's batch: its kernels run at the shapes measured
# on one card, and what differs is the collectives
CARDS = 4
CARDS_GRAPHS = 4096
CARDS_BATCH = 512
# per batch and rank: K1 runs 3 times per halo forward (the local and remote
# sums of the fused towers, the pooled conv; its gradient is plain torch)
# and 2 times per sparse graph-parallel forward; K3 2 times per dense
# forward and 2 more in the backward
MESH_PATHS = {
    "halo": ("sparse", {"sorted_segment_sum": 3}, {"sorted_segment_sum": 3}),
    "dense_mesh": ("dense", {"fused_gin_conv": 2}, {"fused_gin_conv": 4}),
    "sparse_mesh": ("sparse", {"sorted_segment_sum": 2}, {"sorted_segment_sum": 2}),
}
SCAN_VARIANTS = ("epochs", "full", "chunked")
# ``--cards 4`` at atomic scale (phase 16): phase 15's graphs, 512 at a
# global batch of 256, so that each rank takes 64 graphs a batch, phase 15's
# batch and kernel shapes; the halo at a global batch of 254 over 508 graphs
# (two batches), whose shard boundaries at nodes 162,560 and 487,680 fall
# inside graphs 63 and 190 (a global batch divisible by 4 puts every
# boundary between two graphs, and no edge would cross)
ATOMIC_MESH_GRAPHS = 512
ATOMIC_MESH_BATCH = 256
ATOMIC_HALO_GRAPHS = 508
ATOMIC_HALO_BATCH = 254
# a rank's work at atomic scale, the four ranks sharing the host's 8 cores:
# the graphs and their plans (~40 ms a graph: ~20 s), two operator stores of
# the 512 graphs for the scanned operator path (np.add.at, ~3 s a batch of
# 64: ~25 s each), the halo's ~15 passes of two batches of 254 that every
# rank collates and partitions whole (~1.5 s a batch: ~45 s), the meshes'
# ~15 passes each (~0.2 s a batch) and the scanned K3 runs: ~150 s of host
# work and ~300 s in all. The spawn's limit is three times that; a
# collective waits up to 300 s for a peer still building a store
ATOMIC_MESH_TIMEOUT_S = 900
ATOMIC_GROUP_TIMEOUT_S = 300
# the 512 graphs' padded operator store is ~3.65 GB, over the loader's
# default budget of 2 GiB (JAX's), under which the loader streams: the
# scanned store runs at atomic scale raise the budget as a user would
ATOMIC_STORE_BUDGET = dict(device_cache_bytes=8 * 1024**3)


def mesh_run(cards: bool, atomic: bool = False) -> dict:
    """What phase 11 (or with ``atomic`` phase 16) runs: ``ranks`` processes
    over ``graphs`` graphs at a global batch of ``batch``, in a gloo group
    whose ranks share cuda:0 (``nccl`` False), or in an NCCL group with rank
    ``r`` on cuda:r; the scanned mesh ``variants``; the spawn's and a
    collective's time limits. The halo runs over the first ``halo_graphs``
    at a global batch of ``halo_batch``, the engines take ``config``'s
    features and target, and the store engines ``store``'s budget: at
    residue scale the mesh's own graphs and batch and the engines'
    defaults."""
    if atomic:
        return {"ranks": CARDS, "graphs": ATOMIC_MESH_GRAPHS, "batch": ATOMIC_MESH_BATCH,
                "nccl": True, "atomic": True, "halo_graphs": ATOMIC_HALO_GRAPHS,
                "halo_batch": ATOMIC_HALO_BATCH, "config": ATOMIC_ENGINE,
                "store": ATOMIC_STORE_BUDGET, "variants": ("epochs",),
                "timeout_s": ATOMIC_MESH_TIMEOUT_S, "group_timeout_s": ATOMIC_GROUP_TIMEOUT_S}
    if cards:
        run = {"ranks": CARDS, "graphs": CARDS_GRAPHS, "batch": CARDS_BATCH, "nccl": True,
               "variants": SCAN_VARIANTS}
    else:
        run = {"ranks": MESH_RANKS, "graphs": MESH_GRAPHS, "batch": BATCH, "nccl": False,
               "variants": ("epochs",)}
    return dict(run, atomic=False, halo_graphs=run["graphs"], halo_batch=run["batch"],
                config={}, store={}, timeout_s=MESH_TIMEOUT_S, group_timeout_s=180)


def mesh_data(run: dict, seed: int) -> tuple:
    """The run's dataset and the halo's: its first ``halo_graphs``."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    build = build_atomic_graphs if run["atomic"] else build_graphs
    dataset = GraphListDataSet(build(seed, run["graphs"]))
    return dataset, dataset.subset(range(run["halo_graphs"]))


def _no_nvcc():
    raise AssertionError("a mesh worker ran nvcc: it must load the kernels from the cache")


@contextlib.contextmanager
def rank_session(rank: int, store: str, kdir: str, run: dict):
    """A spawned rank's work: a stack dump armed for a hang, fp32 numerics,
    the kernels from ``kdir`` (running ``nvcc`` fails it), the run's group
    over the ``file://`` ``store`` (NCCL with this rank on cuda:<rank>, or
    gloo on cuda:0: NCCL refuses two ranks on one card, and gloo stages
    CUDA tensors through the host), then the block, then the group left. A
    failure prints its traceback and ends the process at once (exit code 1,
    which ``spawn_ranks`` raises on): under NCCL a rank that raised would
    otherwise wait in the group's teardown on peers that wait on it, and
    its traceback would never print."""
    import datetime

    import torch

    from deeprank_gnn_tpu_torch.device import set_fp32_numerics
    from deeprank_gnn_tpu_torch.ops.kernels import build
    from deeprank_gnn_tpu_torch.parallel import distributed
    from deeprank_gnn_tpu_torch.train.aot import use_executable_cache

    # a rank still running near the spawn's limit prints every thread's
    # stack and exits: a hang (a collective no peer joins) names its place
    faulthandler.dump_traceback_later(run["timeout_s"] - 30, exit=True)
    set_fp32_numerics()
    build.nvcc = _no_nvcc
    use_executable_cache(kdir)
    timeout = datetime.timedelta(seconds=run["group_timeout_s"])
    if run["nccl"]:
        distributed.initialize(f"file://{store}", run["ranks"], rank, device=f"cuda:{rank}",
                               timeout=timeout)
    else:
        distributed.initialize(f"file://{store}", run["ranks"], rank, device="cuda:0",
                               backend="gloo", timeout=timeout)
    try:
        yield
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    faulthandler.dump_traceback_later(120, exit=True)  # the teardown, bounded
    distributed.shutdown()
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()


def _mesh_of(path: str):
    """The mesh of ``path`` over every rank of the group: the halo's 1-D
    mesh, the dense graph-parallel ``(D, 1)`` mesh, or the sparse one on
    JAX's default shape."""
    from deeprank_gnn_tpu_torch.parallel.distributed import process_count
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh, make_mesh

    if path == "halo":
        return make_halo_mesh()
    return make_mesh(dp=process_count(), ep=1) if path == "dense_mesh" else make_mesh()


def _ranks_equal(model) -> bool:
    """Whether every rank holds bitwise this rank's parameters (gathered
    straight through torch.distributed, outside the byte counter: on the
    card under NCCL, through the host under gloo)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    if dist.get_backend() == "gloo":
        flat = flat.cpu()
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(p, flat) for p in parts)


def mesh_epoch(nn, steps=None, check_ranks: bool = False):
    """Adam steps of a mesh engine over its training loader, one at a time
    outside the engine's pass (``steps``: stop after that many), with the
    ranks' parameters compared after every step (``check_ranks``): the
    parity check and the per-step rank check beside the engine's
    ``_run_pass``. Returns the losses and the wall time."""
    import torch

    from deeprank_gnn_tpu_torch.device import deterministic

    losses = []
    t0 = time.perf_counter()
    with deterministic():
        while True:  # epoch after epoch where one has fewer batches than ``steps``
            for batch, _mols in nn.train_loader:
                if len(losses) == steps:
                    break
                item = nn._shard(nn._map_targets_host(batch)).to(nn.device)
                loss, _pred = nn._mesh_steps.train(item, nn._dropout_generator)
                losses.append(float(loss))
                if check_ranks and not _ranks_equal(nn.model):
                    raise AssertionError(f"step {len(losses) - 1}: the ranks' parameters "
                                         f"differ")
            if steps is None or len(losses) == steps:
                break
    torch.cuda.synchronize()
    nn.model.eval()
    return losses, time.perf_counter() - t0


def _train_engine(dataset, layout: str, seed: int, outdir: str, mesh=None, batch: int = BATCH,
                  config=None):
    """Paper-mode GINet training every graph at batch ``batch`` (``config``:
    the features and target, by default those of ``fold6`` and ``fnat``)."""
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    kw = dict(node_feature=FOLD6_FEATURES, edge_feature=["dist"], target="fnat")
    kw.update(config or {})
    return NeuralNet(dataset, GINet, batch_size=batch, percent=[1.0, 0.0], seed=seed,
                     layout=layout, mesh=mesh, device="cuda", outdir=outdir, **kw)


@contextlib.contextmanager
def no_dropout():
    """Paper-mode GINet with dropout off inside the block."""
    from deeprank_gnn_tpu_torch.models import GINet

    rate = GINet.dropout_rate
    GINet.dropout_rate = 0.0
    try:
        yield
    finally:
        GINet.dropout_rate = rate


def halo_step_bytes(d: int, h: int, c0: int, n_params: int, training: bool) -> dict:
    """The collective bytes a rank issues in one halo step over ``d``
    ranks: ``d * h * 32 * 4`` per boundary exchange each way (both
    towers, 32 wide, in one exchange; ``h`` rows a peer), the pooled
    combine's all-gather of ``c0 * 33 * 4`` and its backward of ``d`` times
    that, one all-reduce of the gradients."""
    plan = {"all_to_all/forward": d * h * 32 * 4, "all_gather/forward": c0 * 33 * 4}
    if training:
        plan.update({"all_to_all/backward": d * h * 32 * 4,
                     "all_gather/backward": d * c0 * 33 * 4,
                     "all_reduce/gradients": n_params * 4})
    return plan


def mesh_plan(path: str, nn, loader, training: bool) -> tuple:
    """For ``loader``'s batches as the mesh engine ``nn`` places them on
    this rank: the hand kernel's bound per batch (K1 over the halo's local
    and remote sums, 32 columns, and its pooled conv, 64; or over a sparse
    range's two convs; K3 over a dense slice's two convs, and backward when
    ``training``), and the collective bytes of a pass over them (the halo's
    steps, :func:`halo_step_bytes`; per graph-parallel batch the loss
    terms, 8, this rank's predictions gathered, ``4 * ceil(G / D)``, and
    when training every gradient)."""
    import torch.distributed as dist

    d = dist.get_world_size()
    n_params = sum(p.numel() for p in nn.model.parameters())
    bounds, nbytes = [], Counter()
    for batch, _ in loader:
        item = nn._shard(nn._map_targets_host(batch))
        if path == "halo":
            bounds.append(k1_bound_ms(int(item.loc_rowptr[-1]), item.nl, 32)
                          + k1_bound_ms(int(item.rem_rowptr[-1]), item.nl, 32)
                          + k1_bound_ms(int(item.pe_rowptr[-1]), item.num_clusters0, 64))
            nbytes.update(halo_step_bytes(d, item.send_idx.shape[-1], item.num_clusters0,
                                          n_params, training))
            continue
        b = item.batch
        if path == "dense_mesh":
            bounds.append(dense_bound(b, training))
        else:
            bounds.append(k1_bound_ms(int(b.edge_rowptr[-1]), b.num_nodes, 32)
                          + k1_bound_ms(int(b.pe_rowptr[-1]), b.num_clusters0, 64))
        nbytes.update({"all_gather/loss": 8, "all_gather/outputs": -(-item.num_graphs // d) * 4})
        if training:
            nbytes["all_reduce/gradients"] += n_params * 4
    kernel = "fused_gin_conv" if path == "dense_mesh" else "sorted_segment_sum"
    return {kernel: float(np.mean(bounds))}, dict(nbytes)


def mesh_path(path: str, dataset, ckpt: str, tmp: str, seed: int, ref: dict, run: dict) -> dict:
    """One mesh path on this rank at the run's global batch: served from
    ``ckpt`` against the single-card run (``ref``), K1/K3 launches per
    batch and the collective bytes against the plan (``mesh_plan``), then
    trained: the first 4 Adam steps with dropout off against the single-card
    run, and with dropout on the engine's training pass twice from one seed,
    the ranks bitwise equal after each epoch, with its launches and
    collective bytes; the two runs bitwise equal (under NCCL a difference is
    recorded, which values and by how much), and once a step at a time, the
    ranks bitwise equal after every step; then a warm epoch and a profiled
    one."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.parallel import collectives
    from deeprank_gnn_tpu_torch.parallel.distributed import process_index
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    rank, batch, config = process_index(), run["batch"], run["config"]
    ref_layout, serve_per_batch, train_per_batch = MESH_PATHS[path]
    layout = "halo" if path == "halo" else ref_layout
    out = {}
    nn = NeuralNet(dataset, GINet, pretrained_model=ckpt, layout=layout, mesh=_mesh_of(path),
                   device="cuda", outdir=os.path.join(tmp, f"{path}_serve{rank}"))
    batches = len(nn.test_loader)
    walls = []
    for _ in range(2):
        LAUNCHES.clear()
        collectives.reset_collective_bytes()
        t0 = time.perf_counter()
        pred, _om, _ys, loss, data = nn.eval(nn.test_loader)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches, nbytes = dict(LAUNCHES), collectives.collective_bytes()
        if launches != per_pass(serve_per_batch, batches):
            raise AssertionError(f"{path} serve: rank {rank} launched {launches} in {batches} "
                                 f"batches, want {serve_per_batch} per batch")
    bounds, plan = mesh_plan(path, nn, nn.test_loader, False)
    if nbytes != plan:
        raise AssertionError(f"{path} serve: rank {rank} collective bytes {nbytes}, plan {plan}")
    want = np.array([ref["pred"][m] for m in data["mol"]])
    pred = np.asarray(pred, dtype=np.float64)
    if not np.isfinite(pred).all():
        raise AssertionError(f"{path} serve: predictions not finite")
    np.testing.assert_allclose(pred, want, **TOL)
    np.testing.assert_allclose(loss, ref["loss"], **TOL)
    out["serve"] = {"graphs": len(pred), "batches": batches, "walls": walls,
                    "graphs_per_s": [len(pred) / w for w in walls], "launches": launches,
                    "max_abs": float(np.abs(pred - want).max()), "collective_bytes": nbytes,
                    "where": profile_pass(lambda: nn.eval(nn.test_loader), nn.test_loader,
                                          bounds)}

    with no_dropout():
        parity, _ = mesh_epoch(_train_engine(dataset, layout, seed,
                                             os.path.join(tmp, f"{path}_p{rank}"),
                                             _mesh_of(path), batch, config), PARITY_STEPS)
    np.testing.assert_allclose(parity, ref["parity"], **TOL)

    # the main path: the engine's training pass, dropout on (counts and
    # byte counters cleared just before each epoch and read just after;
    # the ranks' parameters compared after it)
    def epoch(nn):
        LAUNCHES.clear()
        collectives.reset_collective_bytes()
        t0 = time.perf_counter()
        loss = nn._run_pass(nn.train_loader, training=True)[3]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, nbytes = dict(LAUNCHES), collectives.collective_bytes()
        if not _ranks_equal(nn.model):
            raise AssertionError(f"{path} train: the ranks' parameters differ after an epoch")
        return loss, wall, launches, nbytes

    def params(nn):
        return {k: v.clone() for k, v in nn.model.state_dict().items()}

    def same(pa, pb):
        return all(torch.equal(v, pb[k]) for k, v in pa.items())

    engines = [_train_engine(dataset, layout, seed, os.path.join(tmp, f"{path}_{name}{rank}"),
                             _mesh_of(path), batch, config) for name in ("a", "b")]
    (la, wa, launches, nbytes), (lb, _wb, _lcb, _nb) = [epoch(nn) for nn in engines]
    pa, pb = params(engines[0]), params(engines[1])
    repeat = {"bitwise": la == lb and same(pa, pb)}
    if not repeat["bitwise"]:
        repeat.update(losses=[la, lb], params_max_abs={
            k: float((v - pb[k]).abs().max()) for k, v in pa.items() if not torch.equal(v, pb[k])})
        if not run["nccl"]:
            raise AssertionError(f"{path} train: two runs from one seed differ: {repeat}")
    nn = engines[1]
    batches = len(nn.train_loader)
    if launches != per_pass(train_per_batch, batches) or not np.isfinite(la):
        raise AssertionError(f"{path} train: rank {rank} launched {launches} in {batches} "
                             f"batches, want {train_per_batch} per batch; loss {la}")
    # the same epoch a step at a time: the ranks' parameters equal after
    # every step, and losses and parameters bitwise the engine pass's
    c = _train_engine(dataset, layout, seed, os.path.join(tmp, f"{path}_c{rank}"),
                      _mesh_of(path), batch, config)
    steps, _ = mesh_epoch(c, check_ranks=True)
    if repeat["bitwise"] and (sum(steps) != la or not same(params(c), pa)):
        raise AssertionError(f"{path} train: step by step {steps}, engine pass {la}")
    # the bytes of the epoch against the plan (the halo's per batch depend
    # on the shuffled batches: its steps are held to the plan in
    # ``halo_bytes_check``, its gradients here); then run b's second epoch
    # (warm), and a third under the profiler
    bounds, plan = mesh_plan(path, nn, nn.train_loader, True)
    if path == "halo":
        plan = {k: v if k == "all_reduce/gradients" else nbytes.get(k) for k, v in plan.items()}
    if nbytes != plan:
        raise AssertionError(f"{path} train: rank {rank} collective bytes {nbytes}, plan {plan}")
    graphs = len(nn.train_loader.dataset)
    warm = epoch(nn)[1]
    where = profile_pass(lambda: nn._run_pass(nn.train_loader, training=True), nn.train_loader,
                         bounds)
    out["train"] = {"graphs": graphs, "batches": batches, "parity_losses": parity,
                    "parity_max_abs": float(np.abs(np.subtract(parity, ref["parity"])).max()),
                    "epoch_loss": la, "step_losses": steps, "walls": [wa, warm],
                    "graphs_per_s": [graphs / wa, graphs / warm], "launches": launches,
                    "collective_bytes": nbytes, "run_to_run": repeat, "where": where}
    return out


def halo_partitions(loader, d: int) -> dict:
    """Every batch of ``loader`` partitioned over ``d`` shards on this
    rank's host as a halo rank partitions it (``partition_batch``, timed):
    per batch the ms, ``H`` (the exchange's rows per peer) and each shard's
    valid local and remote edges (those whose source another shard owns)."""
    from deeprank_gnn_tpu_torch.parallel import halo

    out = {"partition_ms": [], "H": [], "local_edges": [], "remote_edges": []}
    for b, _ in loader:
        t0 = time.perf_counter()
        plan = halo.partition_batch(b, d)
        out["partition_ms"].append(1e3 * (time.perf_counter() - t0))
        out["H"].append(int(plan.send_idx.shape[-1]))
        out["local_edges"].append([int(p[-1]) for p in plan.loc_rowptr])
        out["remote_edges"].append([int(p[-1]) for p in plan.rem_rowptr])
    return out


def halo_bytes_check(dataset, seed: int, tmp: str, batch: int, config=None,
                     remote: bool = False) -> dict:
    """One halo training step's collective bytes over the group's ``D``
    ranks against its plan (:func:`halo_step_bytes`), the exchange below an
    all-gather of the ``[Nl, 32]`` node array (forward and backward) at the
    same batch; every training batch's partition on this host
    (:func:`halo_partitions`), and with ``remote`` every shard of every
    batch must have remote edges (at atomic scale, where the shard
    boundaries fall inside graphs)."""
    import torch.distributed as dist

    from deeprank_gnn_tpu_torch.parallel import collectives, halo

    nn = _train_engine(dataset, "halo", seed, os.path.join(tmp, f"bytes{dist.get_rank()}"),
                       _mesh_of("halo"), batch, config)
    first, _ = next(iter(nn.train_loader))
    d = dist.get_world_size()
    parts = halo_partitions(nn.train_loader, d)
    if remote and min(min(r) for r in parts["remote_edges"]) == 0:
        raise AssertionError(f"halo: a shard without remote edges: {parts}")
    plan = halo.partition_batch(nn._map_targets_host(first), d)
    h, nl, c0 = plan.send_idx.shape[-1], plan.nl, plan.num_clusters0
    n_params = sum(p.numel() for p in nn.model.parameters())
    item = halo.shard_halo_batch(plan, nn._mesh_steps.mesh).to(nn.device)
    collectives.reset_collective_bytes()
    nn._mesh_steps.train(item, nn._dropout_generator)
    counted = collectives.collective_bytes()
    want = halo_step_bytes(d, h, c0, n_params, True)
    node_gather = nl * 32 * 4 + d * nl * 32 * 4
    if counted != want or not counted["all_to_all/forward"] * 2 < node_gather:
        raise AssertionError(f"halo bytes: counted {counted}, plan {want}, node all-gather "
                             f"{node_gather}")
    return {"ranks": d, "counted": counted, "H": h, "Nl": nl, "C0": c0,
            "node_all_gather_bytes": node_gather, "partitions": parts}


def scan_bytes_plan(batches: int, ranks: int, params: int, training: bool,
                    batch: int = BATCH) -> dict:
    """The collective bytes a rank issues in a scanned mesh pass over
    ``batches`` batches of ``batch`` graphs (those of the looped pass):
    the normalizers and the numerators of the losses, 4 bytes a batch
    each; the predictions gathered, this rank's ``batch / ranks`` a batch;
    when training, every gradient once a step."""
    plan = {"all_gather/loss": 8 * batches, "all_gather/outputs": batches * batch // ranks * 4}
    if training:
        plan["all_reduce/gradients"] = batches * params * 4
    return plan


def same_training(label: str, looped, scanned, world: int) -> None:
    """A looped and a scanned mesh engine trained alike
    (``assert_same_training``), and the ranks' parameters equal."""
    assert_same_training(f"mesh {label}", looped, scanned)
    if world > 1 and not _ranks_equal(scanned.model):
        raise AssertionError(f"mesh scan {label}: the ranks' parameters differ")


def mesh_scan_check(label: str, dataset, seed: int, tmp: str, kdir: str, ops: bool,
                    variant: str = "epochs", epochs: int = 3, batch: int = BATCH,
                    **engine_kw) -> dict:
    """Scanned dense mesh epochs on this rank beside the looped mesh engine
    from one seed, dropout on, on the mesh of every rank of the group
    (``percent=[1.0, 0.0]``, global batch ``batch``; ``ops=False``: store
    batches without the operators, K3 inside the graphs). ``variant``:
    ``"epochs"`` (``scan_epochs=True``: ``epochs`` training passes and a
    scanned serving pass over the training store), ``"full"``
    (``_train_full_scan`` over ``epochs``, ``save_model="best"``) or
    ``"chunked"`` (the chunked store, a batch a chunk, ``scan_epochs=True``;
    its looped engine is built scanned and switched to the loop, since a
    mesh refuses the chunked store without scanned epochs). Losses,
    predictions, parameters, Adam state and the generator's state bitwise
    the looped run's, and the ranks' parameters equal; the hand-kernel
    launches and the collective bytes that ran (captures times replays,
    plus what the host issued) equal the looped run's and the plan
    (``scan_bytes_plan``); the replays per epoch equal the plan (one eager
    warm-up step per set of store buffers in the first epoch, then a replay
    per step, two under gloo); a profiled scanned epoch traces K3 as often
    as the counts say; whether the gradient all-reduce ran inside a
    captured graph. ``engine_kw`` (the features and target) go to both
    engines."""
    import torch
    import torch.distributed as dist

    from deeprank_gnn_tpu_torch.parallel.distributed import process_index

    rank, world = process_index(), dist.get_world_size()
    kw = dict(engine_kw)
    if variant == "chunked":
        kw.update(device_cache="chunked", device_cache_bytes=chunk_budget(dataset, 1, batch))
    scan = "full" if variant == "full" else True

    def engine(name, scanned):
        nn = scan_engine(dataset, seed, tmp, f"mesh_{label}_{name}{rank}", kdir, ops,
                         percent=(1.0, 0.0), batch=batch, mesh=_mesh_of("dense_mesh"),
                         scan_epochs=scan if scanned or variant == "chunked" else False, **kw)
        if not scanned:
            nn.scan_epochs = False
        return nn

    looped, scanned = engine("looped", False), engine("scanned", True)
    params = sum(p.numel() for p in scanned.model.parameters())
    lt = [run_pass(looped, True) for _ in range(epochs)]
    store_built(looped.train_loader, f"mesh scan {label} looped")
    batches = lt[0]["batches"]
    k3 = {} if ops else {"fused_gin_conv": 4 * batches}
    plan = scan_bytes_plan(batches, world, params, True, batch)
    if any(t["ran"] != k3 or t["bytes"] != plan for t in lt):
        raise AssertionError(f"mesh scan {label}: looped ran {[t['ran'] for t in lt]}, bytes "
                             f"{[t['bytes'] for t in lt]}; want {k3} {plan}")
    res = {"variant": variant, "ops": ops, "ranks": world, "batches": batches,
           "graphs": lt[0]["graphs"], "looped_walls": [t["wall"] for t in lt],
           "looped_bytes": [t["bytes"] for t in lt]}
    per_step = 1 if scanned._scan.split is None else 2

    def warm_steps():
        """The first epoch's eager steps: one per set of store buffers
        (two for the chunked store's chunks in turn), read once the
        scanned engine's store is built."""
        cs = scanned.train_loader._chunk_store
        return 1 if cs is None else min(2, cs.num_chunks)

    if variant == "full":
        from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
        from deeprank_gnn_tpu_torch.parallel import collectives

        skip_host_only_steps(scanned)

        def call():
            scanned.data = {}
            scanned._scan.reset_replays()
            LAUNCHES.clear()
            collectives.reset_collective_bytes()
            graphs_before = len(scanned._scan.graph_stats())
            t0 = time.perf_counter()
            scanned._train_full_scan(epochs, False, "best", "intermediate", 5)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = scanned._scan.graph_stats()
            return (wall, ran_counts(dict(LAUNCHES), stats, graphs_before, "launches"),
                    ran_counts(collectives.collective_bytes(), stats, graphs_before,
                               "collective_bytes"), sum(st["replays"] for st in stats))

        wall, ran, nbytes, replays = call()
        if scanned.train_loss != [t["loss"] for t in lt] or scanned.train_out != lt[-1]["out"]:
            raise AssertionError(f"mesh scan {label}: losses {scanned.train_loss}, looped "
                                 f"{[t['loss'] for t in lt]}")
        want_ran = {k: v * epochs for k, v in k3.items()}
        want_bytes = {k: v * epochs for k, v in plan.items()}
        if ran != want_ran or nbytes != want_bytes or replays != per_step * (
                epochs * batches - warm_steps()):
            raise AssertionError(f"mesh scan {label}: ran {ran} bytes {nbytes} replays "
                                 f"{replays}, want {want_ran} {want_bytes}")
        res.update(losses=list(scanned.train_loss), wall=wall, replays=replays, ran=ran,
                   bytes=nbytes)
        best = int(np.argmin(scanned.train_loss)) + 1
        ckpts = [f for f in os.listdir(scanned.outdir) if f.endswith(".pth.tar")]
        if ckpts != [scanned._ckpt_name(epochs, best)]:
            raise AssertionError(f"mesh scan {label}: checkpoints {ckpts}, best epoch {best}")
        same_training(label, looped, scanned, world)
        # a second call (warm: every graph captured) goes on training
        warm_wall, warm_ran, warm_bytes, warm_replays = call()
        if warm_ran != want_ran or warm_bytes != want_bytes or (
                warm_replays != per_step * epochs * batches):
            raise AssertionError(f"mesh scan {label}: warm call ran {warm_ran} {warm_bytes}, "
                                 f"{warm_replays} replays")
        res.update(graphs_per_s=[epochs * res["graphs"] / w for w in (wall, warm_wall)],
                   warm_replays=warm_replays,
                   host_ms_per_batch=1e3 * scanned._scan.last_issue_s / batches)
    else:
        lt.append(run_pass(looped, False, looped.train_loader))
        st = [run_pass(scanned, True) for _ in range(epochs)]
        st.append(run_pass(scanned, False, scanned.train_loader))
        for i, (a, b) in enumerate(zip(lt, st)):
            if (a["loss"], a["out"], a["ran"], a["bytes"]) != (b["loss"], b["out"], b["ran"],
                                                                b["bytes"]):
                raise AssertionError(f"mesh scan {label} pass {i}: looped {a['loss']} "
                                     f"{a['ran']} {a['bytes']}, scanned {b['loss']} {b['ran']} "
                                     f"{b['bytes']}")
        if any(t["ran"] != k3 or t["bytes"] != plan for t in st[:epochs]):
            raise AssertionError(f"mesh scan {label}: ran {[t['ran'] for t in st]}, bytes "
                                 f"{[t['bytes'] for t in st]}; want {k3} {plan}")
        if st[-1]["bytes"] != scan_bytes_plan(batches, world, params, False, batch):
            raise AssertionError(f"mesh scan {label}: serving bytes {st[-1]['bytes']}")
        replays, warm = [t["replays"] for t in st[:epochs]], warm_steps()
        if replays != [per_step * (batches - warm)] + [per_step * batches] * (epochs - 1):
            raise AssertionError(f"mesh scan {label}: replays per epoch {replays}, {batches} "
                                 f"batches, {warm} warm-up steps, {per_step} a step")
        same_training(label, looped, scanned, world)
        # one more scanned epoch, profiled (the engines part here)
        prof = profile_run(lambda: scanned._run_pass(scanned.train_loader, training=True),
                           (K3_EXACT_NAME,))
        traced = prof[f"trace[{K3_EXACT_NAME}]"]["count"]
        if traced != k3.get("fused_gin_conv", 0):
            raise AssertionError(f"mesh scan {label}: traced K3 {traced}, want {k3}")
        res.update(losses=[t["loss"] for t in st[:epochs]], serve_loss=st[-1]["loss"],
                   pred=st[-1]["out"], walls=[t["wall"] for t in st[:epochs]],
                   graphs_per_s=[t["graphs"] / t["wall"] for t in st[:epochs]],
                   looped_graphs_per_s=[t["graphs"] / t["wall"] for t in lt[:epochs]],
                   host_ms_per_batch=[1e3 * t["issue_s"] / batches for t in st[:epochs]],
                   replays_per_epoch=replays, ran_per_epoch=[t["ran"] for t in st[:epochs]],
                   bytes_per_epoch=[t["bytes"] for t in st[:epochs]], profile=prof,
                   trace_k3=traced)
    store_built(scanned.train_loader, f"mesh scan {label} scanned")
    cs = scanned.train_loader._chunk_store
    if cs is not None:
        res["chunks"] = cs.num_chunks
    stats = scanned._scan.graph_stats()
    res["graph_parts"] = sorted({(st["part"], st["training"]) for st in stats})
    res["all_reduce_captured"] = any(st["collective_bytes"].get("all_reduce/gradients")
                                     for st in stats)
    res["bytes_plan"] = plan
    res["bitwise_with_dropout"] = True
    return res


def mesh_refs(dataset, ckpt: str, tmp: str, seed: int, kdir: str, batch: int,
              layouts=("sparse", "dense"), scans: bool = True, config=None,
              store=None) -> dict:
    """The single-card references of the mesh paths, in this process on
    cuda:0 at the mesh's global batch ``batch`` (``ckpt`` holds it): per
    layout of ``layouts`` the predictions served from ``ckpt`` by molecule
    and their loss, and the first ``PARITY_STEPS`` losses with dropout off;
    with ``scans``, per store path (the operators, K3) a scanned run's three
    training losses and its scanned serving pass's predictions. ``config``:
    the training engines' features and target; ``store``: the store
    engines' budget."""
    from deeprank_gnn_tpu_torch.models import GINet

    mols = [g.mol for g in dataset.graphs]  # the test loader keeps the dataset's order
    refs = {}
    for layout in layouts:
        _nn, pred, loss, _w, _l = serve(dataset, ckpt, "cuda",
                                        os.path.join(tmp, f"mref_{layout}"), 1, layout, GINet)
        with no_dropout():
            parity = first_steps(_train_engine(dataset, layout, seed,
                                               os.path.join(tmp, f"mref_train_{layout}"),
                                               batch=batch, config=config), PARITY_STEPS)
        refs[layout] = {"pred": dict(zip(mols, pred.tolist())), "loss": loss, "parity": parity}
    for ops, label in ((True, "scan_operators"), (False, "scan_k3")) if scans else ():
        single = scan_engine(dataset, seed, tmp, f"single_{label}", kdir, ops,
                             percent=(1.0, 0.0), batch=batch, scan_epochs=True,
                             **(config or {}), **(store or {}))
        sp = [run_pass(single, True) for _ in range(3)]
        store_built(single.train_loader, f"mesh ref {label}")
        sp.append(run_pass(single, False, single.train_loader))
        refs[label] = {"losses": [p["loss"] for p in sp[:3]],
                       "pred": np.asarray(sp[-1]["out"], dtype=np.float64).tolist()}
    return refs


def mesh_worker(rank: int, store: str, kdir: str, tmp: str, seed: int, results: str,
                run: dict) -> None:
    """A spawned rank of phase 11 or 16 (``rank_session``): every mesh path
    against the single-card references that the parent wrote to
    ``run["refs"]`` (the halo on its own graphs, batch and checkpoint at
    atomic scale), each path's peak allocated memory on this rank's card,
    the halo step's bytes and every batch's partition (at atomic scale every
    shard must have remote edges), then the scanned mesh epochs (the run's
    ``variants`` on both store paths; under NCCL each with the all-reduce
    captured in the step's graph), the ``"epochs"`` runs against the single
    card's scanned runs at ``TOL``. At atomic scale the pooling plans are
    made once (``plans_once``). Writes its results to
    ``results/rank<r>.json``."""
    import torch

    t0 = time.perf_counter()
    atomic, config = run["atomic"], run["config"]
    with rank_session(rank, store, kdir, run), (plans_once() if atomic
                                                else contextlib.nullcontext()):
        dataset, halo_set = mesh_data(run, seed)
        with open(run["refs"]) as fh:
            refs = json.load(fh)
        out = {"start_s": time.perf_counter() - t0, "device": str(torch.cuda.current_device())}
        halo_run = dict(run, batch=run["halo_batch"])
        for path, (ref_layout, _s, _t) in MESH_PATHS.items():
            t1 = time.perf_counter()
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            if path == "halo":
                out[path] = mesh_path(path, halo_set, run["halo_ckpt"], tmp, seed, refs["halo"],
                                      halo_run)
            else:
                out[path] = mesh_path(path, dataset, run["ckpt"], tmp, seed, refs[ref_layout],
                                      run)
            out[path]["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
            out[path]["phase_s"] = time.perf_counter() - t1
        out["halo_bytes"] = halo_bytes_check(halo_set, seed, tmp, halo_run["batch"], config,
                                             remote=atomic)
        for ops, kind in ((True, "operators"), (False, "k3")):
            for variant in run["variants"]:
                t1 = time.perf_counter()
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                label = f"scan_{kind}" if variant == "epochs" else f"scan_{variant}_{kind}"
                res = mesh_scan_check(label, dataset, seed, tmp, kdir, ops, variant,
                                      batch=run["batch"], **config, **run["store"])
                if run["nccl"] and not res["all_reduce_captured"]:
                    raise AssertionError(f"nccl {label}: the all-reduce ran outside the "
                                         f"graphs: {res['graph_parts']}")
                if variant == "epochs":
                    single = refs[f"scan_{kind}"]
                    np.testing.assert_allclose(res["losses"], single["losses"], **TOL)
                    np.testing.assert_allclose(res["pred"], single["pred"], **TOL)
                    res["single_card_losses"] = single["losses"]
                    res["single_card_max_abs"] = float(np.abs(np.subtract(
                        res["pred"], single["pred"])).max())
                res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
                res["phase_s"] = time.perf_counter() - t1
                out[label] = res
        out["worker_s"] = time.perf_counter() - t0
        with open(os.path.join(results, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)


def nccl_group_check(tmp: str, seed: int, kdir: str) -> dict:
    """The parent alone as an NCCL group of one on the card: one halo and
    one dense-mesh training pass of one batch (the engine's ``_run_pass``)
    execute NCCL's collectives (the one-rank
    all-to-all, all-gather, reduce-scatter and all-reduce), each step's
    loss matching the single-process card run's first step. Then scanned
    mesh epochs on the K3 store path over ``MESH_GRAPHS`` graphs
    (``mesh_scan_check``: ``scan_epochs=True``, ``"full"`` and the chunked
    store), each bitwise its looped mesh run, with the gradient all-reduce
    captured inside the step's graph."""
    import torch

    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.parallel import collectives, distributed
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh, make_mesh

    distributed.initialize(f"file://{os.path.join(tmp, 'nccl_store')}", 1, 0, device="cuda:0")
    out = {}
    try:
        import torch.distributed as dist

        out["backend"] = dist.get_backend()
        dataset = GraphListDataSet(build_graphs(seed, BATCH))
        for label, layout, mesh in (("halo", "halo", make_halo_mesh()),
                                    ("dense_mesh", "dense", make_mesh())):
            with no_dropout():
                ref = first_steps(_train_engine(dataset, "dense" if layout == "dense" else "sparse",
                                                seed, os.path.join(tmp, f"nccl_ref_{label}")), 1)
                nn = _train_engine(dataset, layout, seed, os.path.join(tmp, f"nccl_{label}"),
                                   mesh)
                collectives.reset_collective_bytes()
                t0 = time.perf_counter()
                # the engine's training pass over one batch: one step
                loss = nn._run_pass(nn.train_loader, training=True)[3]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            np.testing.assert_allclose([loss], ref, **TOL)
            out[label] = {"loss": loss, "single_process_loss": ref[0], "wall_s": wall,
                          "collective_bytes": collectives.collective_bytes()}
        if not out["halo"]["collective_bytes"].get("all_to_all/backward"):
            raise AssertionError(f"nccl: the halo step issued no all-to-all: {out}")
        dataset = GraphListDataSet(build_graphs(seed, MESH_GRAPHS))
        for variant in SCAN_VARIANTS:
            t0 = time.perf_counter()
            res = mesh_scan_check(f"nccl_{variant}", dataset, seed, tmp, kdir, False, variant)
            res["phase_s"] = time.perf_counter() - t0
            if not res["all_reduce_captured"]:
                raise AssertionError(f"nccl scan {variant}: the all-reduce ran outside the "
                                     f"graphs: {res['graph_parts']}")
            out[f"scan_{variant}"] = res
    finally:
        distributed.shutdown()
    return out


def spawn_ranks(worker, name: str, tmp: str, kdir: str, seed: int, run: dict) -> list:
    """``run["ranks"]`` spawned processes of ``worker(rank, store, kdir, tmp,
    seed, results, run)``, each exit code checked (all killed after the
    run's ``timeout_s``): each rank's results, the JSON it wrote to
    ``results/rank<r>.json``."""
    import torch.multiprocessing as mp

    results = os.path.join(tmp, f"{name}_results")
    os.makedirs(results)
    t0 = time.perf_counter()
    ctx = mp.start_processes(worker, args=(os.path.join(tmp, f"{name}_store"), kdir, tmp, seed,
                                           results, run),
                             nprocs=run["ranks"], join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > run["timeout_s"]:
                raise AssertionError(f"{name} workers still running after {run['timeout_s']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in ctx.processes]
    if codes != [0] * run["ranks"]:
        raise AssertionError(f"{name} workers exited {codes}")
    ranks = []
    for r in range(run["ranks"]):
        with open(os.path.join(results, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    return ranks


def mesh_checkpoint(path: str, seed: int, run: dict, batch: int) -> str:
    """A seeded paper-mode GINet checkpoint that serves at ``batch``, with
    the run's features and target (``ATOMIC_CONFIG``'s at atomic scale)."""
    kw = {}
    if run["atomic"]:
        kw = dict(target=ATOMIC_CONFIG["target"], node=ATOMIC_CONFIG["node_feature"],
                  width=ATOMIC_WIDTH)
    write_checkpoint(path, seed, batch_size=batch, **kw)
    return path


def single_card_rates(dataset, tmp: str, seed: int, kdir: str, run: dict) -> dict:
    """The single card's warm graphs/s at a rank's batch (the global batch
    over the ranks: 128, or 64 at atomic scale), beside which the four
    cards' rates stand (``--cards 4``): serving from a seeded checkpoint
    and the engine's training pass in both layouts (a cold pass, then a
    warm one), and the scanned store epochs (three) on the K3 path, and at
    atomic scale on the operator path too."""
    from deeprank_gnn_tpu_torch.models import GINet

    batch, config = run["batch"] // run["ranks"], run["config"]
    ckpt = mesh_checkpoint(os.path.join(tmp, "rates_ginet.pth.tar"), seed, run, batch)
    out = {"batch": batch}
    for layout in ("sparse", "dense"):
        _nn, pred, _loss, walls, _l = serve(dataset, ckpt, "cuda",
                                            os.path.join(tmp, f"rate_serve_{layout}"), 2,
                                            layout, GINet)
        out[f"serve_{layout}"] = [len(pred) / w for w in walls]
        nn = _train_engine(dataset, layout, seed, os.path.join(tmp, f"rate_train_{layout}"),
                           batch=batch, config=config)
        out[f"train_{layout}"] = [p["graphs"] / p["wall"]
                                  for p in (run_pass(nn, True), run_pass(nn, True))]
    for ops, kind in ((True, "operators"), (False, "k3")):
        if ops and not run["atomic"]:
            continue
        nn = scan_engine(dataset, seed, tmp, f"rate_scan_{kind}", kdir, ops, percent=(1.0, 0.0),
                         batch=batch, scan_epochs=True, **config, **run["store"])
        out[f"scan_{kind}"] = [p["graphs"] / p["wall"]
                               for p in (run_pass(nn, True) for _ in range(3))]
        store_built(nn.train_loader, f"rate scan_{kind}")
    return out


def mesh_phase(tmp: str, kdir: str, seed: int, cards: bool = False, atomic: bool = False,
               smi: str = "") -> dict:
    """Phase 11 (or with ``atomic`` phase 16, four cards at atomic scale, in
    a directory of its own under ``tmp``): the single-card references
    (``mesh_refs``; at atomic scale also the sparse path at the halo's batch,
    and their peak allocated memory on cuda:0, logged with the card's name
    and power limit ``smi``), then the run's spawned ranks (``mesh_worker``),
    each exit code checked; by default two gloo ranks on the card and after
    them the NCCL group of one in this process, with ``cards`` four NCCL
    ranks, one a card, beside the single card's rates
    (``single_card_rates``)."""
    import torch

    t0 = time.perf_counter()
    run = mesh_run(cards, atomic)
    name = "atomic mesh" if atomic else "mesh"
    if atomic:
        tmp = os.path.join(tmp, "atomic_mesh")
        os.makedirs(tmp)
    with plans_once() if atomic else contextlib.nullcontext():
        dataset, halo_set = mesh_data(run, seed)
        run["ckpt"] = mesh_checkpoint(os.path.join(tmp, "mesh_ginet.pth.tar"), seed, run,
                                      run["batch"])
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        refs = mesh_refs(dataset, run["ckpt"], tmp, seed, kdir, run["batch"],
                         config=run["config"], store=run["store"])
        run["halo_ckpt"], refs["halo"] = run["ckpt"], refs[MESH_PATHS["halo"][0]]
        if atomic:  # the halo's own graphs, batch and checkpoint
            run["halo_ckpt"] = mesh_checkpoint(os.path.join(tmp, "halo_ginet.pth.tar"), seed,
                                               run, run["halo_batch"])
            refs["halo"] = mesh_refs(halo_set, run["halo_ckpt"], os.path.join(tmp, "halo"),
                                     seed, kdir, run["halo_batch"], layouts=("sparse",),
                                     scans=False, config=run["config"])["sparse"]
        refs_peak = torch.cuda.max_memory_allocated()
        log(f"{name} single-card references on cuda:0 ({smi}): peak allocated {refs_peak} B, "
            f"{time.perf_counter() - t0:.1f} s")
        run["refs"] = os.path.join(tmp, "mesh_refs.json")
        with open(run["refs"], "w") as fh:
            json.dump(refs, fh)
        rates = single_card_rates(dataset, tmp, seed, kdir, run) if cards else None
    del dataset, halo_set
    gc.collect()  # the references' engines are gone: cuda:0 goes to rank 0 whole
    torch.cuda.empty_cache()
    refs_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = spawn_ranks(mesh_worker, "mesh", tmp, kdir, seed, run)
    spawn_s = time.perf_counter() - t1
    how = (f"NCCL, {run['ranks']} ranks, one a card" if cards
           else "gloo, CUDA tensors staged through the host")
    for r, res in enumerate(ranks):
        for path in MESH_PATHS:
            s, t = res[path]["serve"], res[path]["train"]
            log(f"{name} {path} rank {r} ({how}): serve "
                f"{s['graphs']} graphs in {s['batches']} batches, graphs/s {s['graphs_per_s']} "
                f"(cold, warm), launches {s['launches']}, max abs vs single card "
                f"{s['max_abs']}, collective bytes {s['collective_bytes']}; train "
                f"{t['graphs']} graphs in {t['batches']} batches, graphs/s {t['graphs_per_s']} "
                f"(the engine's training pass: first epoch, warm epoch), epoch loss "
                f"{t['epoch_loss']} (step by step {t['step_losses']}), launches "
                f"{t['launches']}, first {PARITY_STEPS} "
                f"losses {t['parity_losses']} (max abs vs single card "
                f"{t['parity_max_abs']}), collective bytes {t['collective_bytes']}, run to "
                f"run {t['run_to_run']}; peak allocated {res[path]['peak_allocated_bytes']} B")
            log(f"{name} {path} rank {r} serve breakdown " + json.dumps(s["where"]))
            log(f"{name} {path} rank {r} train breakdown " + json.dumps(t["where"]))
        log(f"{name} halo bytes rank {r}: " + json.dumps(res["halo_bytes"]))
        log(f"{name} rank {r} on cuda:{res['device']}: start {res['start_s']:.1f} s, worker "
            f"{res['worker_s']:.1f} s")
    labels = [k for k in ranks[0] if k.startswith("scan_")]
    for r, res in enumerate(ranks):
        for label in labels:
            sc = res[label]
            parts = [tuple(p) for p in sc["graph_parts"]]
            if cards:
                ok = sc["all_reduce_captured"] and ("gradients", True) not in parts
            else:
                ok = (not sc["all_reduce_captured"] and ("gradients", True) in parts
                      and ("update", True) in parts)
            if not ok:
                raise AssertionError(f"{name} {label} rank {r} ({how}): graphs {parts}, "
                                     f"all-reduce captured {sc['all_reduce_captured']}")
            steps = ("the all-reduce captured inside the step's graph" if cards else
                     "each training step two graph replays around the host's all-reduce")
            log(f"{name} {label} rank {r} ({how}; {steps}): "
                + json.dumps({k: v for k, v in sc.items() if k not in ("pred", "profile")}))
            if "profile" in sc:
                log(f"{name} {label} rank {r} profiled scanned epoch "
                    + json.dumps(sc["profile"]))
    out = {"ranks": ranks, "run": run, "rates": rates, "refs_peak_allocated_bytes": refs_peak}
    if cards:
        log(f"single card at batch {rates['batch']}, graphs/s (cold, warm; scanned: three "
            f"epochs): " + json.dumps(rates))
    else:
        t1 = time.perf_counter()
        nccl = out["nccl"] = nccl_group_check(tmp, seed, kdir)
        for variant in SCAN_VARIANTS:
            sc = nccl[f"scan_{variant}"]
            log(f"mesh nccl scan {variant} (NCCL group of one, K3 store path; all-reduce "
                f"captured inside the step's graph: {sc['all_reduce_captured']}): "
                + json.dumps({k: v for k, v in sc.items() if k not in ("pred", "profile")}))
            if "profile" in sc:
                log(f"mesh nccl scan {variant} profiled scanned epoch "
                    + json.dumps(sc["profile"]))
        log("mesh nccl group of one: " + json.dumps(
            {k: v for k, v in nccl.items() if not k.startswith("scan_")}))
        log(f"phase mesh nccl group of one: {time.perf_counter() - t1:.1f} s")
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s (single card {refs_s:.1f} s, spawned "
        f"ranks {spawn_s:.1f} s)")
    return out


FEATURIZE_MODELS = 32
FEATURIZE_CPU_MODELS = 4  # the models also featurized on the CPU path
FEATURIZE_RESIDUES = (300, 250)  # chains A and B: ~4,700 heavy atoms, 1ATN's scale
FEATURE_TOL = dict(rtol=1e-9, atol=1e-9)


def featurize_model(pdb: str, pssm: dict, ref: str, device: str):
    """One docking model through ``ResidueGraph`` on ``device``, scored
    against ``ref``; the graph and its wall seconds."""
    import torch

    from deeprank_gnn_tpu_torch.featurize.residue_graph import ResidueGraph

    t0 = time.perf_counter()
    g = ResidueGraph(pdb=pdb, pssm=pssm, device=device)
    g.get_score(ref)
    if device == "cuda":
        torch.cuda.synchronize()
    return g, time.perf_counter() - t0


def geometry_ms(g, device: str):
    """A featurized model's geometry run again on ``device``: the SASA ms
    (per-atom SASA of the complex and of both unbound chains, the three
    its BSA takes), the contact ms (interface contacts and internal
    edges), and the three SASA arrays."""
    import torch

    from deeprank_gnn_tpu_torch.featurize.contacts import get_contact_residues, get_internal_edges
    from deeprank_gnn_tpu_torch.featurize.sasa import addatom_radii, atom_sasa

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    s = g.struct
    sync()
    t0 = time.perf_counter()
    sasa = [atom_sasa(s, device=device)]
    for chain in ("A", "B"):
        sub = s.select(s.chain == chain)
        sasa.append(atom_sasa(sub, radii=addatom_radii(sub), device=device))
    sync()
    t1 = time.perf_counter()
    get_contact_residues(s, device=device)
    get_internal_edges(s, g.nodes, device=device)
    sync()
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1), np.concatenate(sasa)


def same_graph(k: int, card, cpu, card_sasa, cpu_sasa) -> dict:
    """Model ``k`` featurized on the card against the CPU path: node and
    edge lists and ``pos`` bitwise; per-atom SASA (complex and unbound
    chains), BSA, every node and edge feature and the scores within
    ``FEATURE_TOL``."""
    if card.nodes != cpu.nodes or card.edges != cpu.edges:
        raise AssertionError(f"featurize model {k}: node or edge lists differ from the cpu's")
    if not np.array_equal(np.asarray(card.node_data["pos"]), np.asarray(cpu.node_data["pos"])):
        raise AssertionError(f"featurize model {k}: pos differs from the cpu's")
    err = {}
    for name in cpu.node_data:
        a = np.asarray(card.node_data[name], dtype=np.float64)
        b = np.asarray(cpu.node_data[name], dtype=np.float64)
        np.testing.assert_allclose(a, b, err_msg=f"model {k} {name}", **FEATURE_TOL)
        err[name] = float(np.abs(a - b).max()) if a.size else 0.0
    if card.edge_data["type"] != cpu.edge_data["type"]:
        raise AssertionError(f"featurize model {k}: edge types differ")
    np.testing.assert_allclose(card.edge_data["dist"], cpu.edge_data["dist"], **FEATURE_TOL)
    np.testing.assert_allclose(card_sasa, cpu_sasa, err_msg=f"model {k} atom sasa",
                               **FEATURE_TOL)
    for name in ("irmsd", "lrmsd", "fnat", "dockQ"):
        np.testing.assert_allclose(card.score[name], cpu.score[name], **FEATURE_TOL)
    err["atom_sasa"] = float(np.abs(card_sasa - cpu_sasa).max())
    err["dist"] = float(np.abs(np.subtract(card.edge_data["dist"], cpu.edge_data["dist"])).max())
    return err


def featurize_phase(tmp: str, seed: int, smi: str) -> dict:
    """Phase 12: docking models written from ``seed`` become residue graphs
    on the card (``ResidueGraph(..., device="cuda")``), 4 of them also on
    the CPU path and held to it; the graphs are clustered (MCL), converted
    (``Graph.to_sample``) and served from phase 4's checkpoint through the
    engine (K1 2 launches a batch, against the CPU at ``TOL``); and
    ``coalesce_edges`` on the card over the first batch's interface edges
    mapped through ``cluster0`` gives the collate's pooled edges bitwise (one
    K1 launch, bitwise the CPU run), their summed attributes at
    ``KERNEL_TOL``."""
    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet, cluster_sample
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops import coalesce_edges, segment_sum
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    t0 = time.perf_counter()
    cx = write_docking_models(os.path.join(tmp, "docking"), seed, FEATURIZE_MODELS,
                              *FEATURIZE_RESIDUES)
    write_s = time.perf_counter() - t0
    run = lambda k, dev: featurize_model(cx["pdbs"][k], cx["pssm_files"], cx["ref_file"], dev)
    card, card_s = zip(*(run(k, "cuda") for k in range(FEATURIZE_MODELS)))
    cpu, cpu_s = zip(*(run(k, "cpu") for k in range(FEATURIZE_CPU_MODELS)))
    geo_card = [geometry_ms(card[k], "cuda") for k in range(FEATURIZE_CPU_MODELS)]
    geo_cpu = [geometry_ms(cpu[k], "cpu") for k in range(FEATURIZE_CPU_MODELS)]
    errs = [same_graph(k, card[k], cpu[k], geo_card[k][2], geo_cpu[k][2])
            for k in range(FEATURIZE_CPU_MODELS)]
    where = profile_run(lambda: run(FEATURIZE_MODELS - 1, "cuda"))
    atoms = [g.struct.natoms for g in card]
    res = {
        "models": FEATURIZE_MODELS, "atoms": [min(atoms), max(atoms)],
        "nodes": [min(len(g.nodes) for g in card), max(len(g.nodes) for g in card)],
        "edges": [min(len(g.edges) for g in card), max(len(g.edges) for g in card)],
        "cold_first_model_s": card_s[0],
        "card_models_per_s": (FEATURIZE_MODELS - 1) / sum(card_s[1:]),
        "cpu_models_per_s": FEATURIZE_CPU_MODELS / sum(cpu_s),
        "card_model_s": [min(card_s[1:]), max(card_s[1:])],
        "cpu_model_s": [min(cpu_s), max(cpu_s)],
        "card_sasa_ms": [g[0] for g in geo_card], "card_contact_ms": [g[1] for g in geo_card],
        "cpu_sasa_ms": [g[0] for g in geo_cpu], "cpu_contact_ms": [g[1] for g in geo_cpu],
        "cpu_max_abs": {k: max(e[k] for e in errs) for k in errs[0]},
        "profiled_model": where, "write_pdb_s": write_s,
    }
    log(f"featurize ({smi}): {FEATURIZE_MODELS} models of {res['atoms']} atoms -> graphs of "
        f"{res['nodes']} nodes and {res['edges']} edges; card {res['card_models_per_s']:.2f} "
        f"models/s warm ({res['card_model_s']} s a model), cold first model "
        f"{card_s[0]:.3f} s; cpu path {res['cpu_models_per_s']:.2f} models/s "
        f"({res['cpu_model_s']} s a model)")
    log(f"featurize ({smi}): SASA ms per model card {res['card_sasa_ms']} cpu "
        f"{res['cpu_sasa_ms']}; contact ms per model card {res['card_contact_ms']} cpu "
        f"{res['cpu_contact_ms']}; card vs cpu max abs {res['cpu_max_abs']}")
    log("featurize profiled model " + json.dumps(where))

    samples = [cluster_sample(g.to_sample(FOLD6_FEATURES, ["dist"], target="fnat"), "mcl")
               for g in card]
    dataset = GraphListDataSet(samples)
    ckpt = os.path.join(tmp, "ginet_fold6_fnat.pth.tar")
    res["serve"] = serve_check("featurized", GINet, dataset, ckpt, tmp, "sparse",
                               {"sorted_segment_sum": 2},
                               lambda ld: {"sorted_segment_sum": sparse_bound_per_batch(ld)})

    b, _ = next(iter(GraphLoader(dataset, batch_size=BATCH)))
    b = b.to("cuda")
    ends = pooled_ends(b)
    LAUNCHES.clear()
    index, attr, mask = coalesce_edges(ends, b.edge_attr, b.edge_mask, b.num_clusters0)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches != {"sorted_segment_sum": 1}:
        raise AssertionError(f"coalesce_edges launched {launches}, want one K1")
    m = int(mask.sum())
    if m != int(b.pe_mask.sum()) or not torch.equal(index[:, :m], b.pe_index[:, b.pe_mask]):
        raise AssertionError("coalesce_edges: not the collate's pooled interface edges")
    want = segment_sum(b.edge_attr, b.edge_to_pe, b.edge_attr.shape[0])[b.pe_mask]
    torch.testing.assert_close(attr[:m], want, **KERNEL_TOL, msg="coalesce_edges attributes")
    on_cpu = coalesce_edges(ends.cpu(), b.edge_attr.cpu(), b.edge_mask.cpu(), b.num_clusters0)
    if not all(torch.equal(x.cpu(), y) for x, y in zip((index, attr, mask), on_cpu)):
        raise AssertionError("coalesce_edges on the card is not bitwise the cpu run")
    res["coalesce"] = {"E": int(ends.shape[1]), "E_valid": int(b.edge_mask.sum()),
                       "C0": b.num_clusters0, "pooled_edges": m, "launches": launches,
                       **errors(attr[:m], want)}
    log("featurize coalesce: " + json.dumps(res["coalesce"]))
    log(f"phase featurize: {time.perf_counter() - t0:.1f} s")
    return res


CUSTOM_GRAPHS = 128  # 32 batches of 4
CUSTOM_EPOCHS = 3


def custom_model_phase(seed: int) -> dict:
    """``example/custom_model_torch.py``'s ``CustomNet`` and ``train`` (the
    low-level API, batch 4) on ``CUSTOM_GRAPHS`` in-memory graphs for
    ``CUSTOM_EPOCHS`` epochs (the card's machine has no ``h5py`` for its
    ``main``): K1 2 launches a batch (the counts cleared just before the
    card run and read just after), the batch losses within ``TOL`` of the
    same function on the CPU from the same weights, and two card runs from
    one seed bitwise equal."""
    import runpy

    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    script = runpy.run_path(str(Path(__file__).resolve().parent / "example"
                                / "custom_model_torch.py"))
    dataset = GraphListDataSet(build_graphs(seed, CUSTOM_GRAPHS))

    def run(device):
        loader = GraphLoader(dataset, batch_size=4, shuffle=True, seed=seed)
        model = script["CustomNet"](dataset.get(0).num_features,
                                    generator=torch.Generator().manual_seed(seed))
        LAUNCHES.clear()
        t0 = time.perf_counter()
        history = script["train"](model, loader, CUSTOM_EPOCHS, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (history, dict(LAUNCHES), wall, len(loader),
                [p.detach().cpu() for p in model.parameters()])

    t0 = time.perf_counter()
    a, launches, wall_a, batches, params_a = run("cuda")
    b, _lb, wall_b, _, params_b = run("cuda")
    cpu, cpu_launches, wall_cpu, _, _ = run("cpu")
    want = {"sorted_segment_sum": 2 * batches * CUSTOM_EPOCHS}
    if launches != want or cpu_launches:
        raise AssertionError(f"custom model: launches {launches} (cpu {cpu_launches}), "
                             f"want {want}")
    if a != b or not all(torch.equal(x, y) for x, y in zip(params_a, params_b)):
        raise AssertionError("custom model: two card runs from one seed differ")
    if not np.isfinite(a).all():
        raise AssertionError(f"custom model: losses {a}")
    np.testing.assert_allclose(a, cpu, **TOL)
    graphs = CUSTOM_GRAPHS * CUSTOM_EPOCHS
    res = {"graphs": CUSTOM_GRAPHS, "epochs": CUSTOM_EPOCHS, "batches_per_epoch": batches,
           "launches": launches, "epoch_mean_losses": [float(np.mean(h)) for h in a],
           "cpu_max_abs": float(np.abs(np.subtract(a, cpu)).max()),
           "graphs_per_s": [graphs / wall_a, graphs / wall_b], "cpu_graphs_per_s":
               graphs / wall_cpu, "bitwise_run_to_run": True}
    log("custom model: " + json.dumps(res))
    log(f"phase custom model: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# 14. digests of every training path, to hold a commit's training bitwise
# to another's on the same card (``--digests`` runs only these)

DIGEST_GRAPHS = 512  # 4 training batches of 128


def training_digest(nn) -> dict:
    """One training epoch of ``nn`` (the engine's ``_run_pass``, dropout on,
    from its seed): sha256 of the float32 bytes of the epoch's outputs (each
    step's predictions, before its update) and loss, and of the final
    parameters in the module's order."""
    import torch

    out, _om, _ys, loss, _data = nn._run_pass(nn.train_loader, training=True)
    torch.cuda.synchronize()
    steps = np.asarray(out, dtype=np.float32).tobytes() + np.float32(loss).tobytes()
    params = b"".join(p.detach().float().cpu().numpy().tobytes()
                      for p in nn.model.parameters())
    return {"steps_sha256": hashlib.sha256(steps).hexdigest(),
            "params_sha256": hashlib.sha256(params).hexdigest(), "loss": float(loss)}


def digest_engines(dataset, seed: int, tmp: str, kdir: str) -> dict:
    """An engine factory for each single-process training path, one epoch
    of 4 batches from ``seed``: streamed (both layouts, the zoo, the fast
    mode), the device store (operators, K3) and scanned epochs."""
    from deeprank_gnn_tpu_torch.models import FoutNet, GINet, sGAT
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    def streamed(label, Net, layout, **kw):
        return lambda: NeuralNet(dataset, Net, node_feature=FOLD6_FEATURES,
                                 edge_feature=["dist"], target="fnat", batch_size=BATCH,
                                 percent=[1.0, 0.0], seed=seed, layout=layout, device="cuda",
                                 outdir=os.path.join(tmp, f"digest_{label}"), **kw)

    def store(label, ops, **kw):
        return lambda: scan_engine(dataset, seed, tmp, f"digest_{label}", kdir, ops,
                                   percent=(1.0, 0.0), **kw)

    attention = functools.partial(GINet, attention=True)
    return {
        "sparse": streamed("sparse", GINet, "sparse"),
        "dense": streamed("dense", GINet, "dense"),
        "dense_fast": streamed("dense_fast", GINet, "dense", dense_fast=True),
        "attention_sparse": streamed("attention_sparse", attention, "sparse"),
        "attention_dense": streamed("attention_dense", attention, "dense"),
        "internal_tower": streamed("internal_tower",
                                   functools.partial(GINet, internal_tower=True), "sparse"),
        "foutnet_sparse": streamed("foutnet_sparse", FoutNet, "sparse"),
        "foutnet_dense": streamed("foutnet_dense", FoutNet, "dense"),
        "sgat_sparse": streamed("sgat_sparse", sGAT, "sparse"),
        "sgat_dense": streamed("sgat_dense", sGAT, "dense"),
        "store_operators": store("store_operators", True),
        "store_k3": store("store_k3", False),
        "scan_operators": store("scan_operators", True, scan_epochs=True),
        "scan_k3": store("scan_k3", False, scan_epochs=True),
        "scan_fast_k3": store("scan_fast_k3", False, scan_epochs=True, dense_fast=True),
        "scan_fast_operators": store("scan_fast_operators", True, scan_epochs=True,
                                     dense_fast=True),
    }


def digest_worker(rank: int, store: str, kdir: str, tmp: str, seed: int, results: str,
                  run: dict) -> None:
    """A spawned rank of the digests (``rank_session``): the mesh paths'
    training epochs (the halo layout, the dense and sparse meshes, and the
    scanned K3 store epoch on the dense mesh) in a gloo group of
    ``MESH_RANKS`` on cuda:0."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    with rank_session(rank, store, kdir, run):
        dataset = GraphListDataSet(build_graphs(seed, DIGEST_GRAPHS))
        out = {}
        for path, (ref_layout, _s, _t) in MESH_PATHS.items():
            layout = "halo" if path == "halo" else ref_layout
            out[path] = training_digest(_train_engine(
                dataset, layout, seed, os.path.join(tmp, f"digest_{path}{rank}"),
                mesh=_mesh_of(path)))
        out["mesh_scan_k3"] = training_digest(scan_engine(
            dataset, seed, tmp, f"digest_mesh_scan_k3{rank}", kdir, False, percent=(1.0, 0.0),
            scan_epochs=True, mesh=_mesh_of("dense_mesh")))
        with open(os.path.join(results, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)


def digest_phase(tmp: str, kdir: str, seed: int) -> dict:
    """Phase 14: each training path's digest (``training_digest``) on
    ``DIGEST_GRAPHS`` graphs, single-process paths here and the mesh paths
    in two spawned gloo ranks, which must hold the same parameters and loss
    (each its own outputs: a mesh path's steps digest is every rank's)."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet

    t0 = time.perf_counter()
    dataset = GraphListDataSet(build_graphs(seed, DIGEST_GRAPHS))
    res = {label: training_digest(make())
           for label, make in digest_engines(dataset, seed, tmp, kdir).items()}
    ranks = spawn_ranks(digest_worker, "digest", tmp, kdir, seed, mesh_run(False))
    for label, d in ranks[0].items():
        # the ranks hold the same parameters and loss; each its own outputs
        if any(r[label]["params_sha256"] != d["params_sha256"] or r[label]["loss"] != d["loss"]
               for r in ranks[1:]):
            raise AssertionError(f"digests: the mesh ranks differ on {label}: {ranks}")
        res[label] = {**d, "steps_sha256": " ".join(r[label]["steps_sha256"] for r in ranks)}
    for label, d in res.items():
        log(f"digest {label}: steps {d['steps_sha256']} params {d['params_sha256']} "
            f"loss {d['loss']!r}")
    log(f"phase digests: {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# 15. atomic scale: the JAX package's headline shapes (bench.py's atomic arms)

ATOMIC_GRAPHS = 128  # two batches of 64, as bench.py's atomic_epoch_scan
ATOMIC_BATCH = 64
ATOMIC_NODES = 2560
ATOMIC_EDGES = 15000  # stored undirected; 30,000 directed a graph
ATOMIC_WIDTH = 48
# bench.py's feature names (write_bench_hdf5) and target; all graphs train
# (bench.py's epoch arm has no validation split)
ATOMIC_CONFIG = dict(node_feature=[f"f{i}" for i in range(ATOMIC_WIDTH)], target="irmsd",
                     batch_size=ATOMIC_BATCH, percent=[1.0, 0.0])
# the features and target alone, for engines at other batches (phase 16)
ATOMIC_ENGINE = dict(node_feature=ATOMIC_CONFIG["node_feature"], target=ATOMIC_CONFIG["target"])
ATOMGRAPH_MODELS = 32  # docking models featurized by AtomGraph on the card
ATOMGRAPH_CPU_MODELS = 2  # of them also on the CPU path
ATOMGRAPH_BATCH = 16
# bench.py's atomic_real_dense_op features (bench.py:490-491): 20 + 4 + 5 + 1 + 1 + 20
ATOMGRAPH_FEATURES = ["type", "polarity", "atomtype", "bsa", "charge", "pssm"]
ATOMGRAPH_WIDTH = 51


def build_atomic_graphs(seed: int, num_graphs: int, n: int = ATOMIC_NODES,
                        e_und: int = ATOMIC_EDGES):
    """The JAX package's atomic-scale synthetic graphs (``bench.py``'s
    ``build_big_graphs``) value for value, from the same ``RandomState``
    stream, as the port's ``GraphSample``: ``n`` nodes of 48 features,
    ``e_und`` random edges doubled and row-sorted (every node a source),
    uniform edge attributes, level-0 clusters drawn from ``n // 4`` labels
    (about 4 nodes each) and level 1 grouping 3 of them."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphSample

    rng = np.random.RandomState(seed)
    graphs = []
    for gi in range(num_graphs):
        src = rng.randint(0, n, e_und)
        dst = (src + 1 + rng.randint(0, n - 1, e_und)) % n
        src[:n] = np.arange(n)
        ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])]).astype(np.int32)
        ea = rng.rand(2 * e_und, 1).astype(np.float32)
        order = np.argsort(ei[0], kind="stable")
        ei, ea = ei[:, order], ea[order]
        _, c0 = np.unique(rng.randint(0, n // 4, n), return_inverse=True)
        c1 = (np.arange(int(c0.max()) + 1) // 3).astype(np.int32)
        graphs.append(GraphSample(
            mol=f"g{gi}",
            x=rng.randn(n, ATOMIC_WIDTH).astype(np.float32),
            pos=rng.randn(n, 3).astype(np.float32),
            edge_index=ei,
            edge_attr=ea,
            internal_edge_index=ei[:, :e_und],
            internal_edge_attr=ea[:e_und],
            cluster0=c0.astype(np.int32),
            cluster1=c1,
            y=float(rng.rand() * 10),
        ))
    return graphs


@contextlib.contextmanager
def plans_once():
    """The block runs with the loaders' per-graph pooling plan
    (``data.batch.make_graph_plan``) made once per sample: every loader and
    store built in the block finds the plan the first call made, so each of
    the many engines of the atomic phase pays its own collation and not the
    plans again (~30 ms a graph on the host at this scale; path 1 times
    them)."""
    from deeprank_gnn_tpu_torch.data import batch as batch_mod

    make = batch_mod.make_graph_plan
    memo: dict = {}

    def once(sample):
        if id(sample) not in memo:
            memo[id(sample)] = (sample, make(sample))  # the sample kept, so its id stays its own
        return memo[id(sample)][1]

    batch_mod.make_graph_plan = once
    try:
        yield memo
    finally:
        batch_mod.make_graph_plan = make


@contextlib.contextmanager
def peak_memory(label: str, smi: str, out: dict):
    """The block's peak of ``torch.cuda.max_memory_allocated`` (what was
    allocated when it began included, and given beside it), logged with the
    card's name and power limit and kept in ``out[label]``."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    out[label] = {"peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                  "allocated_before_bytes": before, "seconds": time.perf_counter() - t0}
    log(f"atomic {label} ({smi}): peak allocated {out[label]['peak_allocated_bytes']} B "
        f"(allocated before {before} B); {out[label]['seconds']:.1f} s")


def atomic_data_check(dataset) -> dict:
    """Path 1: every graph's pooling plan (host, timed); then one unshuffled
    epoch of the loader at batch 64 in each layout (sparse with its four CSR
    row-pointer families, dense run-padded, dense with the precomputed
    operators), each batch's host collation timed, and each batch moved to
    the card as the engine moves it (``prefetch``: pinned, asynchronous)
    bitwise the CPU batch; then ``community_pooling`` of one graph on the
    card (its pooled edges summed by K1, one launch for each edge family)
    against the CPU run: features, edges and their attributes bitwise,
    positions at ``KERNEL_TOL``. Returns the numbers and the CPU batches."""
    import types

    import torch

    from deeprank_gnn_tpu_torch.community_pooling import community_pooling
    from deeprank_gnn_tpu_torch.data import batch as batch_mod
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.prefetch import prefetch
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    t0 = time.perf_counter()
    for g in dataset.graphs:
        batch_mod.make_graph_plan(g)
    res = {"graphs": len(dataset),
           "plans_ms_per_graph": 1e3 * (time.perf_counter() - t0) / len(dataset)}
    batches = {}
    for name, kw in (("sparse", dict(layout="sparse")), ("dense", dict(layout="dense")),
                     ("operators", dict(layout="dense", precompute_ops=True))):
        walls, cpu = [], []
        t0 = time.perf_counter()
        for b, mols in GraphLoader(dataset, batch_size=ATOMIC_BATCH, **kw):
            walls.append(1e3 * (time.perf_counter() - t0))
            cpu.append((b, mols))
            t0 = time.perf_counter()
        on_card = list(prefetch(cpu, "cuda"))
        fields = [same_fields(f"atomic {name} batch {i}", want, got)
                  for i, ((want, _), (got, _m)) in enumerate(zip(cpu, on_card))]
        del on_card
        b = cpu[0][0]
        if name == "sparse":
            shape = {"N": b.num_nodes, "E": b.edge_index.shape[1],
                     "E_valid": int(b.edge_rowptr[-1]), "C0": b.num_clusters0,
                     "pooled_edges": int(b.pe_rowptr[-1]),
                     "internal_edges": int(b.iedge_rowptr[-1])}
        else:
            shape = {"G": b.x.shape[0], "S": b.x.shape[1], "E": b.row.shape[1],
                     "E_valid": int(b.edge_mask.sum()), "C0g": b.pool0_mask.shape[1],
                     "P": b.pe_row.shape[1], "pooled_edges": int(b.pe_mask.sum())}
        res[name] = {"batches": len(cpu), "host_collate_ms_per_batch": walls,
                     "fields_per_batch": fields, "first_batch": shape}
        batches[name] = cpu
        log(f"atomic data {name}: " + json.dumps(res[name]))

    g = dataset.graphs[0]

    def graph_on(dev):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        return types.SimpleNamespace(
            x=t(g.x), pos=t(g.pos), edge_index=t(g.edge_index.astype(np.int64)),
            edge_attr=t(g.edge_attr), internal_edge_index=t(g.internal_edge_index.astype(np.int64)),
            internal_edge_attr=t(g.internal_edge_attr)), t(g.cluster0)

    data, cluster = graph_on("cuda")
    LAUNCHES.clear()
    card = community_pooling(cluster, data)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    data, cluster = graph_on("cpu")
    cpu_pool = community_pooling(cluster, data)
    for f in ("x", "edge_index", "edge_attr", "internal_edge_index", "internal_edge_attr"):
        if not torch.equal(getattr(card, f).cpu(), getattr(cpu_pool, f)):
            raise AssertionError(f"atomic community_pooling: {f} differs from the cpu run")
    torch.testing.assert_close(card.pos.cpu(), cpu_pool.pos, **KERNEL_TOL)
    if launches != {"sorted_segment_sum": 2}:
        raise AssertionError(f"atomic community_pooling launched {launches}, want 2 K1")
    res["community_pooling"] = {"clusters": card.num_nodes,
                                "pooled_edges": card.edge_index.shape[1],
                                "pooled_internal_edges": card.internal_edge_index.shape[1],
                                "launches": launches}
    log(f"atomic data: plans {res['plans_ms_per_graph']:.2f} ms a graph; community_pooling "
        + json.dumps(res["community_pooling"]))
    return res, batches


def warp_span(row_ptr, rows_per_block: int = 32) -> int:
    """The most edges any block of ``rows_per_block`` consecutive rows
    spans (K2's tiled path at F = 1 stages one such span a block)."""
    import torch

    ptr = row_ptr.long().cpu()
    starts = torch.arange(0, ptr.shape[0] - 1, rows_per_block)
    ends = torch.clamp(starts + rows_per_block, max=ptr.shape[0] - 1)
    return int((ptr[ends] - ptr[starts]).max())


def atomic_kernels(sparse_batch, dense_batch, seed: int) -> dict:
    """K1, K2, K3 and K3 fast at the first atomic batch's shapes, forward
    and backward, each bitwise its plain version run on the CPU
    (``k1_case``, ``k2_case``, ``k3_case``, ``k3_fast_case``), with its
    launch plan, L2-flushed and L2-warm times, the plain version's and the
    library call's times and the bound. K2 runs at the sparse attention
    softmax's two shapes (the batch's row pointers over its interface and
    pooled edges, F = 1, positive values as ``exp`` gives them), where a
    warp's 32 rows span several of its shared-memory tiles at conv2. K3's
    conv1 must take the branch without the slab in shared
    memory over several edge tiles, in both variants. No call is traced
    here: a one-call trace after other traces in one process has come back
    without device events (PERF.md §7); path 4's traced epoch counts the
    fast path's casts."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    b, d = sparse_batch.to(dev), dense_batch.to(dev)
    k1 = []
    for name, f, ptr, rows in (("atomic-conv1", 32, b.edge_rowptr, b.edge_index[0]),
                               ("atomic-conv2", 64, b.pe_rowptr, b.pe_index[0])):
        data = rand(rows.shape[0], f)
        res = k1_case(name, data, ptr, rows, timed=True, reordered=True)
        if (res["vec"], res["lanes_per_row"], res["loads_in_flight"]) != \
                k1_plan_want(res["N"], res["F"]):
            raise AssertionError(f"K1 {name}: launch plan {res}")
        k1 += [res, k1_backward_case(name, data, ptr, rows, gen)]
    k2 = []
    for name, ptr, rows in (("atomic-conv1", b.edge_rowptr, b.edge_index[0]),
                            ("atomic-conv2", b.pe_rowptr, b.pe_index[0])):
        data = torch.rand((rows.shape[0], 1), generator=gen, device=dev) * 3
        res = k2_case(name, data, ptr, rows, gen, timed=True, reordered=True)
        res["longest_warp_span"] = warp_span(ptr, res["rows_per_block"])
        res["tiles_per_warp_span"] = -(-res["longest_warp_span"] // res["tile_edges"])
        if (res["path"], res["rows_per_block"]) != ("tiles", 32):
            raise AssertionError(f"K2 {name}: launch plan {res}")
        k2.append(res)
    g, s, c0g = d.x.shape[0], d.x.shape[1], d.pool0_mask.shape[1]
    main = [("atomic-conv1", rand(g, s, 32), d.row, d.col),
            ("atomic-conv2", rand(g, c0g, 64), d.pe_row, d.pe_col)]
    k3 = [k3_case(name, x, r, c, gen, timed=True) for name, x, r, c in main]
    fast = [k3_fast_case(name, x, r, c, gen, timed=True, trace=False) for name, x, r, c in main]
    for res in k1:
        log("K1 " + json.dumps(res))
    for res in k2:
        log("K2 " + json.dumps(res))
    for res in k3:
        log("K3 " + json.dumps(res))
    for res in fast:
        log("K3 fast " + json.dumps(res))
    for res in (k3[0], fast[0]):
        if res["slab"] or res["edge_tiles"] < 2:
            raise AssertionError(f"K3 {res['case']}: want the branch without the slab over "
                                 f"several edge tiles, plan {res}")
    return {"k1": k1, "k2": k2, "k3": k3, "k3_fast": fast}


def atomgraph_check(tmp: str, seed: int, smi: str) -> dict:
    """Path 6: ``write_docking_models``' seeded complex (~4,744 atoms a
    model) through ``AtomGraph(..., device="cuda")``, scored against the
    first model; ``ATOMGRAPH_CPU_MODELS`` of them also on the CPU path:
    node, edge and contact lists and ``pos`` bitwise, features, per-atom
    SASA, distances and scores within ``FEATURE_TOL`` (``same_graph``).
    The graphs are clustered (MCL), converted (``Graph.to_sample``) with
    bench.py's atomic features and served in the sparse layout from a
    seeded checkpoint (K1 2 launches a batch, against the CPU at ``TOL``)."""
    import torch

    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet, cluster_sample
    from deeprank_gnn_tpu_torch.featurize.atom_graph import AtomGraph
    from deeprank_gnn_tpu_torch.featurize.sasa import atom_sasa
    from deeprank_gnn_tpu_torch.models import GINet

    cx = write_docking_models(os.path.join(tmp, "atomic_docking"), seed, ATOMGRAPH_MODELS,
                              *FEATURIZE_RESIDUES)

    def run(k, dev):
        t0 = time.perf_counter()
        g = AtomGraph(pdb=cx["pdbs"][k], pssm=cx["pssm_files"], device=dev)
        g.get_score(cx["ref_file"])
        if dev == "cuda":
            torch.cuda.synchronize()
        return g, time.perf_counter() - t0

    card, card_s = zip(*(run(k, "cuda") for k in range(ATOMGRAPH_MODELS)))
    cpu, cpu_s = zip(*(run(k, "cpu") for k in range(ATOMGRAPH_CPU_MODELS)))
    errs = [same_graph(k, card[k], cpu[k], atom_sasa(card[k].struct, device="cuda"),
                       atom_sasa(cpu[k].struct, device="cpu"))
            for k in range(ATOMGRAPH_CPU_MODELS)]
    samples = [cluster_sample(g.to_sample(ATOMGRAPH_FEATURES, ["dist"], target="irmsd"), "mcl")
               for g in card]
    res = {
        "models": ATOMGRAPH_MODELS, "atoms": [min(g.struct.natoms for g in card),
                                              max(g.struct.natoms for g in card)],
        "nodes": [min(len(g.nodes) for g in card), max(len(g.nodes) for g in card)],
        "edges": [min(len(g.edges) for g in card), max(len(g.edges) for g in card)],
        "clusters0": [min(int(s.cluster0.max()) + 1 for s in samples),
                      max(int(s.cluster0.max()) + 1 for s in samples)],
        "features": int(samples[0].x.shape[1]),
        "cold_first_model_s": card_s[0],
        "card_models_per_s": (ATOMGRAPH_MODELS - 1) / sum(card_s[1:]),
        "cpu_models_per_s": ATOMGRAPH_CPU_MODELS / sum(cpu_s),
        "cpu_max_abs": {k: max(e[k] for e in errs) for k in errs[0]},
    }
    log(f"atomic featurize ({smi}): " + json.dumps(res))
    if res["features"] != ATOMGRAPH_WIDTH:
        raise AssertionError(f"atomic featurize: {res['features']} features, want "
                             f"{ATOMGRAPH_WIDTH}")
    ckpt = os.path.join(tmp, "ginet_atomgraph_irmsd.pth.tar")
    write_checkpoint(ckpt, seed, target="irmsd", batch_size=ATOMGRAPH_BATCH,
                     node=ATOMGRAPH_FEATURES, width=ATOMGRAPH_WIDTH)
    res["serve"] = serve_check("atomgraph", GINet, GraphListDataSet(samples), ckpt, tmp,
                               "sparse", {"sorted_segment_sum": 2},
                               lambda ld: {"sorted_segment_sum": sparse_bound_per_batch(ld)},
                               sites=False)
    return res


K1, K2 = "sorted_segment_sum", "sorted_scatter_gather"
# phase 15's rest of the model zoo: (label, net, its keywords, layout, launches
# per served batch, per training batch, how the path is held: "cpu" its
# served predictions and first 4 losses to the CPU run, else the sparse path
# whose card run a dense one must match; the towers and softmax of its
# bounds, ``zoo_bounds_per_batch``)
ATOMIC_ZOO = [
    ("attention_sparse", "GINet", {"attention": True}, "sparse", {K1: 4, K2: 4},
     {K1: 4, K2: 8}, "cpu", ((False, False), True)),
    ("attention_dense", "GINet", {"attention": True}, "dense", {K4_CSR: 2, K4: 4},
     {K4_CSR: 4, K4: 4, K4_BWD: 8}, "attention_sparse", None),
    ("internal_tower", "GINet", {"internal_tower": True}, "sparse", {K1: 4}, {K1: 4}, "cpu",
     ((False, True), False)),
    ("attention_internal", "GINet", {"attention": True, "internal_tower": True}, "sparse",
     {K1: 4, K2: 4}, {K1: 4, K2: 8}, "cpu", ((False, True), True)),
    ("foutnet_sparse", "FoutNet", {}, "sparse", {K1: 2}, {K1: 2}, "cpu",
     ((False,), False)),
    ("foutnet_dense", "FoutNet", {}, "dense", {}, {}, "foutnet_sparse", None),
    ("sgat_sparse", "sGAT", {}, "sparse", {K1: 2}, {K1: 2}, "cpu", ((False,), False)),
    ("sgat_dense", "sGAT", {}, "dense", {}, {}, "sgat_sparse", None),
]
# a dense zoo path's peak of allocated memory must stay below the smallest
# [G, E, size] tensor of the one-hot form at conv1 (the bool membership of
# the softmax: 64 x 30,080 x 5,216 bytes, 10.04 GB)
DENSE_ZOO_PEAK_BYTES = 10 * 10**9


def atomic_zoo_path(label: str, dataset, tmp: str, seed: int, out: dict) -> dict:
    """One path of ``ATOMIC_ZOO`` at the atomic batch: served from its own
    seeded checkpoint (two passes and a profiled one) and trained (the
    first 4 Adam steps, dropout off; two epochs with dropout on, run twice
    from one seed bitwise; a profiled epoch with its index accumulation's
    sites), the launches per batch as the table gives them. A sparse path
    is held to its CPU run, a dense one to its sparse path's card run in
    ``out`` at ``TOL``: the served predictions and the first 4 losses."""
    import deeprank_gnn_tpu_torch.models as models

    _, name, kw, layout, serve_launches, train_launches, held, towers = next(
        z for z in ATOMIC_ZOO if z[0] == label)
    net = functools.partial(getattr(models, name), **kw) if kw else getattr(models, name)
    ckpt = os.path.join(tmp, f"atomic_{label}.pth.tar")
    write_checkpoint(ckpt, seed, net, target="irmsd", batch_size=ATOMIC_BATCH,
                     node=ATOMIC_CONFIG["node_feature"], width=ATOMIC_WIDTH)
    ref = None if held == "cpu" else out[held]

    def bounds(training):
        if towers is None:
            return lambda ld: {}
        return lambda ld: zoo_bounds_per_batch(ld, towers[0], towers[1], training)

    served = serve_check(f"atomic_{label}", net, dataset, ckpt, tmp, layout, serve_launches,
                         bounds(False), sites=False,
                         ref=None if ref is None else ref["serve"]["pred"])
    trained = train_phase(f"atomic_{label}", net, dataset, layout, seed, tmp, train_launches,
                          bounds(True), resume=False, config=ATOMIC_CONFIG,
                          ref_losses="cpu" if ref is None else ref["train"]["parity_losses"])
    return {"serve": served, "train": trained, "held_to": held}


def halo_partition_ms(loader) -> list:
    """The host's ``partition_batch(b, 1)`` time per batch of ``loader``, ms
    (the halo engine's loader thread runs it for every batch)."""
    from deeprank_gnn_tpu_torch.parallel.halo import partition_batch

    walls = []
    for b, _ in loader:
        t0 = time.perf_counter()
        partition_batch(b, 1)
        walls.append(1e3 * (time.perf_counter() - t0))
    return walls


def atomic_halo_check(dataset, ckpt: str, tmp: str, seed: int, out: dict) -> dict:
    """``bench.py``'s ``atomic_halo_step`` arm: paper-mode GINet in the halo
    layout on one rank (``layout="halo", mesh=make_halo_mesh()``) in an
    NCCL group of one on the card, the whole halo machinery with its
    collectives. Served (K1 3 launches a batch) against the sparse path's
    card predictions at ``TOL``, trained (K1 3 a batch) with the first 4
    losses against the sparse path's and two runs from one seed bitwise;
    each pass profiled; the host's ``partition_batch`` time per batch."""
    import torch.distributed as dist

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.parallel import collectives, distributed
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh

    distributed.initialize(f"file://{os.path.join(tmp, 'atomic_nccl_store')}", 1, 0,
                           device="cuda:0")
    try:
        mesh = make_halo_mesh()
        bounds = lambda ld: {K1: halo_bound_per_batch(ld)}  # noqa: E731
        collectives.reset_collective_bytes()
        served = serve_check("atomic_halo", GINet, dataset, ckpt, tmp, "halo", {K1: 3}, bounds,
                             sites=False, ref=out["sparse"]["serve"]["pred"], mesh=mesh)
        res = {"backend": dist.get_backend(), "serve": served,
               "serve_collective_bytes": collectives.collective_bytes()}
        res["train"] = train_phase("atomic_halo", GINet, dataset, "halo", seed, tmp, {K1: 3},
                                   bounds, resume=False, config=ATOMIC_CONFIG,
                                   ref_losses=out["sparse"]["train"]["parity_losses"],
                                   mesh=mesh)
        res["partition_ms_per_batch"] = halo_partition_ms(
            GraphLoader(dataset, batch_size=ATOMIC_BATCH))
    finally:
        distributed.shutdown()
    if not res["serve_collective_bytes"].get("all_gather/forward"):
        raise AssertionError(f"atomic halo: no collective ran: {res['serve_collective_bytes']}")
    log(f"atomic halo: backend {res['backend']}; partition_batch ms per batch "
        f"{res['partition_ms_per_batch']}; collective bytes of the served passes "
        f"{res['serve_collective_bytes']}")
    return res


# FoutNet and sGAT from the store's operators at the atomic batch: (label,
# net, the streamed dense path of ``ATOMIC_ZOO`` whose checkpoint it serves
# and whose predictions it is held to)
STORE_ZOO = [("foutnet_store", "FoutNet", "foutnet_dense"),
             ("sgat_store", "sGAT", "sgat_dense")]


def atomic_store_zoo(label: str, dataset, tmp: str, seed: int, out: dict) -> dict:
    """One net of ``STORE_ZOO`` on the operator path
    (``NeuralNet(..., device_cache=True)``: FoutNet's ``agg_x``, ``deg0``,
    ``adj1``; sGAT's ``wagg_x``, ``ea_rowsum0``, ``wadj1``, ``ea_rowsum1``)
    over the first atomic batch of ``dataset`` (one batch: each store
    engine collates its own operators, as a user's does, ~3 s a batch on
    the host, and four engines run here), no hand kernel launched: served
    from the streamed dense path's checkpoint (two passes and a profiled
    one) within ``TOL`` of that path's card predictions of those graphs in
    ``out``, and trained (the first 4 Adam steps against the CPU run's at
    ``TOL``, then one epoch), each engine from its device store
    (``store_built``)."""
    import deeprank_gnn_tpu_torch.models as models

    _, name, held = next(z for z in STORE_ZOO if z[0] == label)
    net = getattr(models, name)
    ckpt = os.path.join(tmp, f"atomic_{held}.pth.tar")  # written by its ATOMIC_ZOO path
    first = dataset.subset(range(ATOMIC_BATCH))  # the test loader keeps the dataset's order
    served = serve_check(f"atomic_{label}", net, first, ckpt, tmp, "dense", {},
                         lambda ld: {}, sites=False,
                         ref=out[held]["serve"]["pred"][:ATOMIC_BATCH], device_cache=True)
    trained = train_phase(f"atomic_{label}", net, first, "dense", seed, tmp, {},
                          config=ATOMIC_CONFIG, device_cache=True)
    return {"serve": served, "train": trained, "held_to": held}


def atomic_bf16_check(dataset, ckpt: str, tmp: str, seed: int, out: dict) -> dict:
    """``store_pack="bf16"`` on the operator path at the atomic batch:
    served (two passes and a profiled one, no hand kernel) within
    ``BF16_TOL`` of the lossless store's predictions, and one training
    epoch (dropout on, the lossless path's seed) whose loss differs from
    the lossless epoch's and lies within rtol 5e-2 of it, the tolerance of
    ``tests/test_torch_store.py::test_bf16_pack_trains_close``."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    served = serve_check("atomic_bf16", GINet, dataset, ckpt, tmp, "dense", {}, lambda ld: {},
                         sites=False, ref=out["operators"]["serve"]["pred"], tol=BF16_TOL,
                         device_cache=True, store_pack="bf16")
    t = NeuralNet(dataset, GINet, layout="dense", device="cuda", seed=seed, device_cache=True,
                  store_pack="bf16", outdir=os.path.join(tmp, "atomic_bf16_train"),
                  edge_feature=["dist"], **ATOMIC_CONFIG)
    t0 = time.perf_counter()
    loss = t._run_pass(t.train_loader, training=True)[3]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lossless = out["operators"]["train"]["losses"][0]
    log(f"atomic bf16: training epoch loss {loss} against lossless {lossless}, {wall} s")
    if loss == lossless or not np.isfinite(loss):
        raise AssertionError(f"atomic bf16: epoch loss {loss}, lossless {lossless}")
    np.testing.assert_allclose(loss, lossless, rtol=5e-2)
    return {"serve": served, "train_loss": loss, "lossless_loss": lossless,
            "train_wall": wall, "graphs": len(t.train_loader.dataset)}


def atomic_phase(tmp: str, seed: int, kdir: str, smi: str, cast_kernel: str = "") -> dict:
    """Phase 15: the port at the JAX package's atomic-graph scale
    (``bench.py``'s headline arms: 128 graphs of 2,560 nodes and 30,000
    directed edges, batch 64, two batches) through its entry points, each
    path with its peak of allocated device memory: data, kernels,
    paper-mode GINet sparse and dense, the rest of the model zoo
    (``ATOMIC_ZOO``), the halo layout on one rank, the fast mode, the
    operator path from the store, FoutNet and sGAT on it (``STORE_ZOO``),
    the chunked store, bf16 packing and ``AtomGraph``. ``cast_kernel``: the
    name a cast to bf16 traces as (phase 3's), else traced here before any
    other trace."""
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.data.dense_batch import WEIGHTED_OPERATORS
    from deeprank_gnn_tpu_torch.models import GINet

    t_start = time.perf_counter()
    out, memory = {}, {}
    dataset = GraphListDataSet(build_atomic_graphs(seed, ATOMIC_GRAPHS))
    ckpt = os.path.join(tmp, "ginet_atomic_irmsd.pth.tar")
    write_checkpoint(ckpt, seed, target="irmsd", batch_size=ATOMIC_BATCH,
                     node=ATOMIC_CONFIG["node_feature"], width=ATOMIC_WIDTH)
    sparse_bounds = lambda ld: {K1: sparse_bound_per_batch(ld)}  # noqa: E731
    engine_kw = dict(batch=ATOMIC_BATCH, percent=ATOMIC_CONFIG["percent"], **ATOMIC_ENGINE)
    with plans_once():
        with peak_memory("data", smi, memory):
            out["data"], batches = atomic_data_check(dataset)
        with peak_memory("kernels", smi, memory):
            if not cast_kernel:
                cast_kernel = bf16_cast_kernel(batches["dense"][0][0].x.to("cuda"))
            out["kernels"] = atomic_kernels(batches["sparse"][0][0], batches["dense"][0][0],
                                            seed)
        with peak_memory("sparse", smi, memory):
            out["sparse"] = {
                "serve": serve_check("atomic_sparse", GINet, dataset, ckpt, tmp, "sparse",
                                     {K1: 2}, sparse_bounds, sites=False),
                "train": train_phase("atomic_sparse", GINet, dataset, "sparse", seed, tmp,
                                     {K1: 2}, sparse_bounds, epochs=1, resume=False,
                                     config=ATOMIC_CONFIG)}
        with peak_memory("dense", smi, memory):
            out["dense"] = {
                "serve": serve_check(
                    "atomic_dense", GINet, dataset, ckpt, tmp, "dense", {"fused_gin_conv": 2},
                    lambda ld: {"fused_gin_conv": dense_bound_per_batch(ld, False)},
                    sites=False),
                "train": train_phase(
                    "atomic_dense", GINet, dataset, "dense", seed, tmp, {"fused_gin_conv": 4},
                    lambda ld: {"fused_gin_conv": dense_bound_per_batch(ld, True)}, epochs=1,
                    resume=False, config=ATOMIC_CONFIG)}
            diff = np.abs(out["dense"]["serve"]["pred"] - out["sparse"]["serve"]["pred"])
            log(f"atomic serve: dense vs sparse on the card, max abs {diff.max()}")
            np.testing.assert_allclose(out["dense"]["serve"]["pred"],
                                       out["sparse"]["serve"]["pred"], **TOL)
        for label, _net, _kw, layout, *_ in ATOMIC_ZOO:
            with peak_memory(label, smi, memory):
                out[label] = atomic_zoo_path(label, dataset, tmp, seed, out)
            if layout == "dense" and memory[label]["peak_allocated_bytes"] > DENSE_ZOO_PEAK_BYTES:
                raise AssertionError(f"atomic {label}: peak allocated "
                                     f"{memory[label]['peak_allocated_bytes']} B, over "
                                     f"{DENSE_ZOO_PEAK_BYTES} B")
        with peak_memory("halo", smi, memory):
            out["halo"] = atomic_halo_check(dataset, ckpt, tmp, seed, out)
        with peak_memory("fast", smi, memory):
            out["fast"] = fast_phase(dataset, tmp, seed, kdir, out["dense"]["train"]["losses"],
                                     cast_kernel, label="atomic_fast", **engine_kw)
            if out["fast"]["k3"]["casts"]:
                raise AssertionError(f"atomic fast: {out['fast']['k3']['casts']} casts traced")
        with peak_memory("operators", smi, memory):
            # the store's batches bitwise path 1's, the weighted operators
            # (FoutNet's and sGAT's) among the fields, and its bytes
            store = store_batches_check(dataset, True, ATOMIC_BATCH, batches["operators"])
            store["weighted_operators"] = [
                f for f in WEIGHTED_OPERATORS if getattr(batches["operators"][0][0], f) is not None]
            del batches
            if store["packed_bytes"] > store["estimate_bytes"] or (
                    store["weighted_operators"] != list(WEIGHTED_OPERATORS)):
                raise AssertionError(f"atomic store: over its estimate, or without the weighted "
                                     f"operators: {store}")
            out["operators"] = {"store": store, "serve": serve_check(
                "atomic_operators", GINet, dataset, ckpt, tmp, "dense", {}, lambda ld: {},
                sites=False, device_cache=True)}
            np.testing.assert_allclose(out["operators"]["serve"]["pred"],
                                       out["dense"]["serve"]["pred"], **TOL)
            out["operators"]["train"] = train_phase(
                "atomic_operators", GINet, dataset, "dense", seed, tmp, {},
                config=ATOMIC_CONFIG, device_cache=True)
            scan = scan_training_check("atomic_operators", dataset, seed, tmp, kdir, True,
                                       epochs=2, **engine_kw)[0]
            out["operators"]["scan"] = scan
            if any(scan["ran_per_epoch"]):
                raise AssertionError(f"atomic scan: hand kernels ran {scan}")
        for label, *_ in STORE_ZOO:
            with peak_memory(label, smi, memory):
                out[label] = atomic_store_zoo(label, dataset, tmp, seed, out)
            if memory[label]["peak_allocated_bytes"] > DENSE_ZOO_PEAK_BYTES:
                raise AssertionError(f"atomic {label}: peak allocated "
                                     f"{memory[label]['peak_allocated_bytes']} B, over "
                                     f"{DENSE_ZOO_PEAK_BYTES} B")
        with peak_memory("chunked", smi, memory):
            # chunks of one batch: the store's two batches in two chunks
            res = chunked_check(dataset, ckpt, tmp, seed, out["operators"]["serve"]["pred"],
                                chunk_batches=1, min_chunks=2, batch=ATOMIC_BATCH,
                                label="atomic_chunked", profile=True, train_epoch=False)
            res["scan"] = scan_training_check(
                "atomic_chunked", dataset, seed, tmp, kdir, True, epochs=3,
                device_cache="chunked", device_cache_bytes=res["budget"], **engine_kw)[0]
            if res["scan"]["chunks"] < 2 or any(res["scan"]["ran_per_epoch"]):
                raise AssertionError(f"atomic scan chunked: {res['scan']['chunks']} "
                                     f"chunks, launches {res['scan']['ran_per_epoch']}")
            out["chunked"] = res
        with peak_memory("bf16", smi, memory):
            out["bf16"] = atomic_bf16_check(dataset, ckpt, tmp, seed, out)
        with peak_memory("atomgraph", smi, memory):
            out["atomgraph"] = atomgraph_check(tmp, seed, smi)
    out["memory"] = memory
    log(f"phase atomic: {time.perf_counter() - t_start:.1f} s")
    return out


ATOMIC_PASS_KEYS = ("device_idle_share", "device_busy_ms", "index_accumulation_ms",
                    "index_accumulation_share_of_busy", "host_collate_ms",
                    "sorted_segment_sum_ms_per_batch", "sorted_segment_sum_bound_ms_per_batch",
                    "sorted_scatter_gather_ms_per_batch",
                    "sorted_scatter_gather_bound_ms_per_batch",
                    "fused_gin_conv_ms_per_batch", "fused_gin_conv_bound_ms_per_batch",
                    "index_accumulation_sites")
# the paths of phase 15 that are served and trained by serve_check and train_phase
ATOMIC_SERVED = ("sparse", "dense", *[z[0] for z in ATOMIC_ZOO], "halo", "operators",
                 *[z[0] for z in STORE_ZOO])


def pass_summary(v: dict, count: int) -> dict:
    """A served or trained pass's numbers (``serve_check``, ``train_phase``,
    ``chunked_check``): graphs/s of each pass (the first cold), launches,
    the profiled pass's numbers and the check's largest difference."""
    out = {"graphs_per_s": [count / w for w in v["walls"]], "launches": v["launches"]}
    out.update({k: v[k] for k in ("cpu_max_abs", "ref_max_abs", "parity_max_abs") if k in v})
    if v["where"] is not None:
        out.update({k: v["where"][k] for k in ATOMIC_PASS_KEYS if k in v["where"]})
    return out


def scan_summary(scan: dict) -> dict:
    """A scanned training check's rates (the first epoch cold), host time,
    replays and idle shares (``scan_training_check``)."""
    out = {k: scan[k] for k in ("looped_graphs_per_s", "scanned_graphs_per_s",
                                "scanned_host_ms_per_batch", "replays_per_epoch")}
    out["device_idle_share"] = {"scanned": scan["scanned_profile"]["device_idle_share"],
                                "looped": scan["looped_profile"]["device_idle_share"]}
    return out


def atomic_summary(atomic: dict) -> dict:
    """Phase 15's numbers per path: graphs/s of each pass (the first cold),
    launches, the profiled pass's busy and idle shares, index accumulation
    and its sites, host collation and hand kernels against their bounds;
    the store's bytes, the scanned and looped epochs, the halo's partition
    time, the chunked store, bf16 packing, the fast mode, the featurizer,
    and peak memory."""
    out = {"memory": atomic["memory"], "data": atomic["data"]}
    for path in ATOMIC_SERVED:
        v = atomic[path]
        out[f"serve_{path}"] = pass_summary(v["serve"], len(v["serve"]["pred"]))
        out[f"train_{path}"] = pass_summary(v["train"], v["train"]["graphs"])
    out["halo"] = {k: atomic["halo"][k] for k in ("backend", "partition_ms_per_batch",
                                                  "serve_collective_bytes")}
    out["store"] = atomic["operators"]["store"]
    out["scan_operators"] = scan_summary(atomic["operators"]["scan"])
    c = atomic["chunked"]
    out["serve_chunked"] = pass_summary(c, len(c["pred"]))
    out["chunked"] = {k: c[k] for k in ("chunks", "chunk_nbytes", "budget", "build_s",
                                        "copy_ms", "host_ms_between_uploads")}
    out["scan_chunked"] = scan_summary(c["scan"])
    b = atomic["bf16"]
    out["serve_bf16"] = pass_summary(b["serve"], len(b["serve"]["pred"]))
    out["train_bf16"] = {"graphs_per_s": b["graphs"] / b["train_wall"],
                         "loss": b["train_loss"], "lossless_loss": b["lossless_loss"]}
    fast = atomic["fast"]["k3"]
    out["fast"] = {"loss": fast["loss"], "launches": fast["launches"], "casts": fast["casts"],
                   "graphs_per_s": fast["graphs"] / fast["wall"],
                   "device_idle_share": fast["profile"]["device_idle_share"]}
    feat = atomic["atomgraph"]
    out["atomgraph"] = {k: v for k, v in feat.items() if k != "serve"}
    out["atomgraph"]["serve"] = pass_summary(feat["serve"], len(feat["serve"]["pred"]))
    return out


def atomic_kernel_line(atomic: dict, name: str) -> dict:
    """A kernel's numbers at the atomic shapes for the last lines' JSON:
    launches on each atomic path, and the first batch's calls (forward and
    backward, L2 flushed) beside the plain version, the library call and
    the bound, with each shape's launch plan."""
    k = atomic["kernels"]
    sums = ("ms", "plain_ms", "library_ms", "bound_ms", "l2_warm_ms", "call_ms")
    if name in ("sorted_segment_sum", "sorted_scatter_gather"):
        k1 = name == "sorted_segment_sum"
        main = [r for r in k["k1" if k1 else "k2"] if "ms" in r]
        main_path = atomic["sparse" if k1 else "attention_sparse"]
        s_where, t_where = main_path["serve"]["where"], main_path["train"]["where"]
        plans = (("vec", "lanes_per_row", "rows_per_block", "blocks", "loads_in_flight",
                  "blocks_per_sm") if k1 else
                 ("path", "rows_per_block", "tile_edges", "blocks", "smem_bytes",
                  "blocks_per_sm", "threads", "longest_run", "longest_warp_span",
                  "tiles_per_warp_span"))
        line = {
            "max_abs_err": max(r["max_abs_err"] for r in k["k1" if k1 else "k2"]),
            # launches per pass or epoch of 2 batches on every atomic path
            "launches": {f"{kind}_{path}": atomic[path][kind]["launches"].get(name, 0)
                         for path in ATOMIC_SERVED for kind in ("serve", "train")},
            **{key: sum(r[key] for r in main) for key in sums},
            "served_ms_per_batch": s_where[f"{name}_ms_per_batch"],
            "served_bound_ms_per_batch": s_where[f"{name}_bound_ms_per_batch"],
            "train_ms_per_batch": t_where[f"{name}_ms_per_batch"],
            "train_bound_ms_per_batch": t_where[f"{name}_bound_ms_per_batch"],
            "shapes": [{key: r[key] for key in ("case", "E", "E_valid", "N", "F", *sums, *plans)}
                       for r in main],
        }
        if k1:
            line["launches"].update(
                atomgraph_serve=atomic["atomgraph"]["serve"]["launches"][name],
                community_pooling=atomic["data"]["community_pooling"]["launches"][name])
        return line
    plans = ("slab", "rows_per_block", "blocks_per_graph", "edge_tile", "edge_tiles",
             "smem_bytes", "blocks_per_sm")
    both = lambda r, key: r[f"{key}_fwd"] + r[f"{key}_bwd"]  # noqa: E731
    if name == "fused_gin_conv":
        rows = k["k3"]
        s_where = atomic["dense"]["serve"]["where"]
        t_where = atomic["dense"]["train"]["where"]
        line = {"serve_launches": atomic["dense"]["serve"]["launches"][name],
                "train_launches": atomic["dense"]["train"]["launches"][name],
                "served_ms_per_batch": s_where[f"{name}_ms_per_batch"],
                "served_bound_ms_per_batch": s_where[f"{name}_bound_ms_per_batch"],
                "train_ms_per_batch": t_where[f"{name}_ms_per_batch"],
                "train_bound_ms_per_batch": t_where[f"{name}_bound_ms_per_batch"]}
    else:
        rows = k["k3_fast"]
        line = {"launches": atomic["fast"]["k3"]["launches"][name],
                "scan_cast_launches": atomic["fast"]["k3"]["casts"],
                "exact_ms": sum(both(r, "exact_ms") for r in rows)}
    line["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    line.update({key: sum(both(r, key) for r in rows)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms", "l2_warm_ms")})
    line["shapes"] = [{key: r[key] for key in ("case", "G", "S", "F", "E", "E_valid", "ms_fwd",
                                                "ms_bwd", "plain_ms_fwd", "plain_ms_bwd",
                                                "library_ms_fwd", "library_ms_bwd",
                                                "bound_ms_fwd", "bound_ms_bwd", *plans)}
                      for r in rows]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", type=int, default=2048,
                    help="graphs of the paper-mode and attention GINet phases")
    ap.add_argument("--zoo-graphs", type=int, default=768,
                    help="graphs of the other new paths (at least 5 batches of 128 "
                         "give 4 training steps)")
    ap.add_argument("--digests", action="store_true",
                    help="build the kernels and print only each training path's digests "
                         "(phase 14), to compare a checkout with another on one card")
    ap.add_argument("--atomic", action="store_true",
                    help="build the kernels and run only the atomic-scale phase (15; with "
                         f"--cards {CARDS}: 16)")
    ap.add_argument("--k4", action="store_true",
                    help="build the kernels and run only K4's checks and timings at the "
                         "atomic shapes (phase 17)")
    ap.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                    help=f"{CARDS}: build the kernels and run only the mesh paths (phases 11 "
                         f"and 16), one NCCL rank a card on cuda:0-{CARDS - 1}, held against "
                         f"one card")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.cards:
        raise RuntimeError(f"--cards {args.cards} needs {args.cards} CUDA devices, this machine "
                           f"has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernels_") as kdir:
        return run(args, kdir)


def cards_summary(mesh: dict) -> dict:
    """The ``--cards`` run in numbers, per rank where they differ: each mesh
    path's warm graphs/s (each rank's share of the graphs over its wall,
    and every graph over the slowest rank's wall: the cards together),
    the warm pass's wall over the profiled one's, device busy time and idle
    share, NCCL kernel time (and by name on rank 0), the hand kernel's time
    per batch beside its bound, launches and collective bytes per batch,
    the two runs' agreement, each path's peak allocated memory; each scanned
    run's graphs/s, replays, idle share and NCCL time; the single card's
    rates and the references' peak; at atomic scale the halo's partitions
    (host ms per rank and batch, ``H``, each shard's remote edges) and its
    step's bytes."""
    ranks, run = mesh["ranks"], mesh["run"]
    out = {"ranks": run["ranks"], "graphs": run["graphs"], "global_batch": run["batch"],
           f"single_card_graphs_per_s_batch_{mesh['rates']['batch']}": mesh["rates"],
           "single_card_refs_peak_allocated_bytes": mesh["refs_peak_allocated_bytes"]}

    def nccl_ms(where):
        return sum(k["device_ms"] for k in where["nccl_kernels"].values())

    for path in MESH_PATHS:
        kernel = "fused_gin_conv" if path == "dense_mesh" else "sorted_segment_sum"
        out[f"{path}_peak_allocated_bytes"] = [r[path]["peak_allocated_bytes"] for r in ranks]
        for kind in ("serve", "train"):
            per = [r[path][kind] for r in ranks]
            wheres = [p["where"] for p in per]
            warm = [p["walls"][-1] for p in per]
            # a streaming dense rank serves its slice of each batch; every
            # other pass covers all the graphs on every rank
            graphs = (sum(p["graphs"] for p in per) if (path, kind) == ("dense_mesh", "serve")
                      else per[0]["graphs"])
            cell = out[f"{path}_{kind}"] = {
                "graphs_per_s_each_rank": [graphs / run["ranks"] / w for w in warm],
                "graphs_per_s_all_cards": graphs / max(warm),
                "warm_over_profiled_wall": [1e3 * w / wh["profiled_wall_ms"]
                                            for w, wh in zip(warm, wheres)],
                "device_busy_ms": [w["device_busy_ms"] for w in wheres],
                "device_idle_share": [w["device_idle_share"] for w in wheres],
                "nccl_ms": [nccl_ms(w) for w in wheres],
                "nccl_kernels_rank0": wheres[0]["nccl_kernels"],
                "kernel": kernel,
                "kernel_ms_per_batch": [w[f"{kernel}_ms_per_batch"] for w in wheres],
                "kernel_bound_ms_per_batch": [w[f"{kernel}_bound_ms_per_batch"] for w in wheres],
                "launches_per_batch": [{k: v / p["batches"] for k, v in p["launches"].items()}
                                       for p in per],
                "collective_bytes_per_batch": [
                    {k: v / p["batches"] for k, v in p["collective_bytes"].items()} for p in per],
            }
            if kind == "train":
                cell["run_to_run"] = [p["run_to_run"] for p in per]
    for label in (k for k in ranks[0] if k.startswith("scan_")):
        per = [r[label] for r in ranks]
        out[f"mesh_{label}"] = {
            "graphs_per_s": [p["graphs_per_s"] for p in per],
            "replays": [p.get("replays_per_epoch", p.get("replays")) for p in per],
            "all_reduce_captured": [p["all_reduce_captured"] for p in per],
            "device_idle_share": [p["profile"]["device_idle_share"] for p in per
                                  if "profile" in p],
            "nccl_ms": [nccl_ms(p["profile"]) for p in per if "profile" in p],
            "bytes_per_epoch_rank0": per[0].get("bytes_per_epoch", per[0].get("bytes")),
            "peak_allocated_bytes": [p["peak_allocated_bytes"] for p in per],
        }
    if run["atomic"]:
        halo = [r["halo_bytes"] for r in ranks]
        out["halo"] = {"graphs": run["halo_graphs"], "global_batch": run["halo_batch"],
                       "partition_ms_per_rank": [h["partitions"]["partition_ms"] for h in halo],
                       **{k: halo[0]["partitions"][k] for k in ("H", "local_edges",
                                                                "remote_edges")},
                       **{k: halo[0][k] for k in ("Nl", "C0", "counted",
                                                  "node_all_gather_bytes")}}
    return out


def cards_run(args, kdir: str, kind: str, smi: str, t_start: float) -> int:
    """``--cards 4``: the cards' links (``nvidia-smi topo -m`` or ``nvlink
    --status``, where the machine allows them, and the peer-access matrix) and NCCL's
    version, then phase 11 on four NCCL ranks, one a card, beside the single
    card on cuda:0 (``mesh_phase(cards=True)``; not with ``--atomic``), then
    phase 16, the same at atomic scale (``mesh_phase(cards=True,
    atomic=True)``); the last lines are their numbers (``cards_summary``,
    phase 16's under ``atomic``) and the ``{"ok": true, ...}`` line."""
    import torch

    # how the cards are linked, from what the machine lets a program read
    # (a sandbox may refuse the topology query: its exit code is printed)
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
        out = subprocess.run(cmd, capture_output=True, text=True)
        log(f"{' '.join(cmd)}: exit {out.returncode}")
        for line in (out.stdout + out.stderr).rstrip().splitlines():
            log(f"  {line}")
    n = torch.cuda.device_count()
    log("peer access (torch.cuda.can_device_access_peer, row to column): " + json.dumps(
        [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
         for i in range(n)]))
    log(f"NCCL {torch.cuda.nccl.version()}; NCCL variables set: "
        + json.dumps({k: v for k, v in os.environ.items() if k.startswith("NCCL_")}))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mesh = None if args.atomic else mesh_phase(tmp, kdir, args.seed, cards=True, smi=smi)
        atomic = mesh_phase(tmp, kdir, args.seed, cards=True, atomic=True, smi=smi)
    summary = {} if mesh is None else cards_summary(mesh)
    summary["atomic"] = cards_summary(atomic)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(f"{CARDS} cards " + json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# a second process that points the build at the same directory: it must
# find every library there and run no nvcc
SECOND_PROCESS = """
import json, sys
from deeprank_gnn_tpu_torch.ops.kernels import build
from deeprank_gnn_tpu_torch.train.aot import use_executable_cache
use_executable_cache(sys.argv[1])
found = {n: build.library_path(n).is_file() for n in sys.argv[2:]}
for n in sys.argv[2:]:
    build.load(n)
print(json.dumps(found))
"""


def run(args, kdir: str) -> int:
    """The phases, with the hand kernels built in ``kdir`` (the
    executable cache of every engine here)."""
    import torch

    import deeprank_gnn_tpu_torch

    here = Path(__file__).resolve().parent
    if Path(deeprank_gnn_tpu_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError(
            "deeprank_gnn_tpu_torch must come from this checkout "
            f"({here}), not {deeprank_gnn_tpu_torch.__file__}"
        )
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.device import set_fp32_numerics
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import build
    from deeprank_gnn_tpu_torch.train.aot import use_executable_cache

    t_start = time.perf_counter()
    # 1. device
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    for line in cards:
        log(line)
    smi = cards[0]
    set_fp32_numerics()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build, one nvcc per source, all at once, into the executable cache
    use_executable_cache(kdir)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        texts = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name, text in texts.items():
        build.load(name)
        log(f"build: {build.library_path(name).name} with {' '.join(build.NVCC_FLAGS)}")
        for line in text.strip().splitlines():
            log(f"  nvcc {name}: {line.strip()}")
    log(f"build: {len(KERNELS)} sources in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    second = subprocess.run([sys.executable, "-c", SECOND_PROCESS, kdir, *KERNELS],
                            capture_output=True, text=True, cwd=here, timeout=300)
    second_s = time.perf_counter() - t0
    if second.returncode != 0 or json.loads(second.stdout.strip().splitlines()[-1]) != {
            name: True for name in KERNELS}:
        raise AssertionError(f"executable cache: the second process {second.returncode} "
                             f"{second.stdout} {second.stderr}")
    log(f"executable cache: a second process with {kdir} found all {len(KERNELS)} libraries "
        f"and loaded them without nvcc, {second_s:.2f} s with its start")

    if args.digests:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            digest_phase(tmp, kdir, args.seed)
        return 0
    if args.cards == CARDS:
        return cards_run(args, kdir, kind, smi, t_start)
    if args.k4:
        k4_phase(args.seed, kdir)
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.atomic:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            atomic = atomic_phase(tmp, args.seed, kdir, smi)
        log("atomic " + json.dumps(atomic_summary(atomic)))
        log(f"total: {time.perf_counter() - t_start:.1f} s")
        return 0

    # 3. kernels, at the shapes of the paths' first batches
    graphs = build_graphs(args.seed, max(args.graphs, args.zoo_graphs))
    dataset = GraphListDataSet(graphs[: args.graphs])
    zoo = GraphListDataSet(graphs[: args.zoo_graphs])
    first_batch, _ = next(iter(GraphLoader(dataset, batch_size=BATCH)))
    first_dense, _ = next(iter(GraphLoader(dataset, batch_size=BATCH, layout="dense")))
    t0 = time.perf_counter()
    k1 = k1_phase(first_batch, args.seed)
    k3, k3_fast = k3_phase(first_dense, args.seed)
    k2 = k2_phase(first_batch, args.seed)
    floor = launch_floor()
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    # 3b. the padding rule: the repaired ops against their old forms
    padding = padding_phase(dataset, args.seed)
    # 17. K4 at the atomic shapes
    k4 = k4_phase(args.seed, kdir)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 15. atomic scale, early: its passes are profiled, and late in a
        # long process the profiler has returned traces without device events
        atomic = atomic_phase(tmp, args.seed, kdir, smi, k3_fast[0]["cast_kernel"])
        gc.collect()  # the phase's engines are gone: give their memory back
        torch.cuda.empty_cache()
        # 4. serve paper-mode GINet, both layouts
        t0 = time.perf_counter()
        served = serve_phase(dataset, tmp, args.seed)
        log(f"phase serve paper: {time.perf_counter() - t0:.1f} s")
        # 5. train paper-mode GINet, both layouts
        trained = {}
        for layout, per_batch, bounds in (
            ("sparse", {"sorted_segment_sum": 2},
             lambda ld: {"sorted_segment_sum": sparse_bound_per_batch(ld)}),
            ("dense", {"fused_gin_conv": 4},
             lambda ld: {"fused_gin_conv": dense_bound_per_batch(ld, True)}),
        ):
            t0 = time.perf_counter()
            trained[layout] = train_phase(layout, GINet, dataset, layout, args.seed, tmp,
                                          per_batch, bounds)
            log(f"phase train {layout}: {time.perf_counter() - t0:.1f} s")
        # 6. attention GINet, sparse, full width: serve and train
        att = attention_phase(dataset, tmp, args.seed)
        # 7. the other new paths
        zoo_out = zoo_phase(zoo, tmp, args.seed)
        # 8. the device store
        store = store_phase(dataset, zoo, tmp, args.seed, trained["dense"]["parity_losses"],
                            served["dense"], zoo_out)
        # 9. scanned epochs; 10. the fast mode
        scan = scan_phase(dataset, tmp, args.seed, kdir, store["serve"]["pred"])
        t0 = time.perf_counter()
        fast = fast_phase(dataset, tmp, args.seed, kdir, scan["k3"]["losses"],
                          k3_fast[0]["cast_kernel"])
        log(f"phase fast: {time.perf_counter() - t0:.1f} s")
        # 11. multi-device
        mesh = mesh_phase(tmp, kdir, args.seed)
        # 12. the featurizer, its graphs served, coalesce_edges on the card
        feat = featurize_phase(tmp, args.seed, smi)
        # 13. the low-level API: example/custom_model_torch.py on the card
        custom = custom_model_phase(args.seed)
        # 14. every training path's digest
        digests = digest_phase(tmp, kdir, args.seed)

    k1_main = [r for r in k1 if r["case"] in ("conv1", "conv2")]
    k1_att = [r for r in k1 if r["case"] in ("attention-conv1", "attention-conv2")]
    k1_plans = ("vec", "lanes_per_row", "rows_per_block", "blocks", "loads_in_flight",
                "blocks_per_sm")
    k2_plans = ("path", "rows_per_block", "tile_edges", "blocks", "smem_bytes", "blocks_per_sm",
                "threads")
    k3_main = [r for r in k3 if "ms_fwd" in r]
    k3_fast_main = [r for r in k3_fast if "ms_fwd" in r]
    k2_path = [r for r in k2 if r["case"] in ("conv1", "conv2")]
    k2_bench = next(r for r in k2 if r["case"] == "bench")
    s_where, d_where = served["sparse"]["where"], served["dense"]["where"]
    t_sparse, t_dense = trained["sparse"]["where"], trained["dense"]["where"]
    a_serve, a_train = att["serve"]["where"], att["train"]["where"]

    def mesh_launches(name: str) -> dict:
        """A kernel's launches on rank 0 of phase 11 (both ranks are checked
        against the same counts): each mesh path's serving pass and
        training epoch of 4 batches."""
        r0 = mesh["ranks"][0]
        return {f"{path}_{kind}": r0[path][kind]["launches"].get(name, 0)
                for path in MESH_PATHS for kind in ("serve", "train")}

    def scan_mesh_launches(name: str) -> dict:
        """A kernel's launches per training epoch of phase 11's scanned
        mesh epochs: rank 0 of the two gloo ranks (operator path, K3 path)
        and the NCCL group of one (K3 path; "full": its three epochs)."""
        out = {label: mesh["ranks"][0][label]["ran_per_epoch"][0].get(name, 0)
               for label in ("scan_operators", "scan_k3")}
        for variant in ("epochs", "chunked"):
            out[f"nccl_{variant}"] = mesh["nccl"][f"scan_{variant}"]["ran_per_epoch"][0].get(
                name, 0)
        out["nccl_full_three_epochs"] = mesh["nccl"]["scan_full"]["ran"].get(name, 0)
        return out

    line = {"kernels": [
        {
            "name": "sorted_segment_sum",
            # phase 15: the atomic-scale paths and the first atomic batch's calls
            "atomic": atomic_kernel_line(atomic, "sorted_segment_sum"),
            **KERNELS["sorted_segment_sum"],
            "mesh_launches_per_rank": mesh_launches("sorted_segment_sum"),
            "scan_mesh_launches": scan_mesh_launches("sorted_segment_sum"),
            # example/custom_model_torch.py's training: 2 a batch
            "custom_model_launches": custom["launches"]["sorted_segment_sum"],
            # the paper-mode sparse serving pass (slice 1's main path)
            "launches": served["sparse"]["launches"]["sorted_segment_sum"],
            "max_abs_err": max(r["max_abs_err"] for r in k1),
            # one call at each conv level's shape of the first served batch,
            # L2 flushed before each call
            "ms": sum(r["ms"] for r in k1_main),
            "plain_ms": sum(r["plain_ms"] for r in k1_main),
            "bound_ms": sum(r["bound_ms"] for r in k1_main),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in k1_main),
            # the profiled passes: device time per batch and its bound
            "served_ms_per_batch": s_where["sorted_segment_sum_ms_per_batch"],
            "served_bound_ms_per_batch": s_where["sorted_segment_sum_bound_ms_per_batch"],
            "train_launches": trained["sparse"]["launches"]["sorted_segment_sum"],
            "train_ms_per_batch": t_sparse["sorted_segment_sum_ms_per_batch"],
            "train_bound_ms_per_batch": t_sparse["sorted_segment_sum_bound_ms_per_batch"],
            # the attention path: 4 launches per served batch and per trained
            # one (K2's backward runs on K2)
            "attention_serve_launches": att["serve"]["launches"]["sorted_segment_sum"],
            "attention_served_ms_per_batch": a_serve["sorted_segment_sum_ms_per_batch"],
            "attention_served_bound_ms_per_batch":
                a_serve["sorted_segment_sum_bound_ms_per_batch"],
            "attention_train_launches": att["train"]["launches"]["sorted_segment_sum"],
            "attention_train_ms_per_batch": a_train["sorted_segment_sum_ms_per_batch"],
            "attention_train_bound_ms_per_batch":
                a_train["sorted_segment_sum_bound_ms_per_batch"],
            # the same two calls with their inputs L2-resident (graph replay)
            "l2_warm_ms": sum(r["l2_warm_ms"] for r in k1_main),
            # eager per-call time, the host's launch cost included
            "call_ms": sum(r["call_ms"] for r in k1_main),
            # one call at each attention conv's shape (F = 16 and 32), L2
            # flushed, L2-warm and eager, beside the plain version, the
            # library call and the bound
            **{f"attention_{k}": sum(r[k] for r in k1_att)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "l2_warm_ms", "call_ms")},
            # an almost empty launch under torch.profiler
            "launch_floor_ms": floor["sorted_segment_sum"]["median_ms"],
            "shapes": [{k: r[k] for k in ("case", "E", "E_valid", "N", "F", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "l2_warm_ms", "call_ms",
                                          *k1_plans)}
                       for r in k1_main + k1_att],
        },
        {
            "name": "fused_gin_conv",
            # phase 15: the atomic-scale paths and the first atomic batch's calls
            "atomic": atomic_kernel_line(atomic, "fused_gin_conv"),
            **KERNELS["fused_gin_conv"],
            "mesh_launches_per_rank": mesh_launches("fused_gin_conv"),
            "scan_mesh_launches": scan_mesh_launches("fused_gin_conv"),
            # the dense training epoch (slice 2's main path): 2 forward
            # and 2 backward launches per batch
            "launches": trained["dense"]["launches"]["fused_gin_conv"],
            "max_abs_err": max(r["max_abs_err"] for r in k3),
            # the 4 calls of one training batch at the first dense batch's
            # shapes (conv1 and conv2, forward and backward), L2 flushed
            # before each call
            "ms": sum(r["ms_fwd"] + r["ms_bwd"] for r in k3_main),
            "plain_ms": sum(r["plain_ms_fwd"] + r["plain_ms_bwd"] for r in k3_main),
            "bound_ms": sum(r["bound_ms_fwd"] + r["bound_ms_bwd"] for r in k3_main),
            "bound_by": "bytes",
            # no one PyTorch call computes K3: index_select + index_add_
            # on prepared flat indices, into a zero-filled output
            "library_ms": sum(r["library_ms_fwd"] + r["library_ms_bwd"] for r in k3_main),
            "library_call": "index_select + index_add_ (two calls, zero-filled output)",
            "train_ms_per_batch": t_dense["fused_gin_conv_ms_per_batch"],
            "train_bound_ms_per_batch": t_dense["fused_gin_conv_bound_ms_per_batch"],
            "serve_launches": served["dense"]["launches"]["fused_gin_conv"],
            # a training epoch on device-store batches without the operators
            # (the operator path itself runs no hand kernel)
            "store_train_launches": store["train_k3"]["launches"]["fused_gin_conv"],
            "served_ms_per_batch": d_where["fused_gin_conv_ms_per_batch"],
            "served_bound_ms_per_batch": d_where["fused_gin_conv_bound_ms_per_batch"],
            # scanned epochs on store batches without the operators: the
            # launches that ran per epoch inside the replayed graphs, and the
            # profiled scanned epoch's traced launches and device time
            "scan_train_launches": scan["k3"]["ran_per_epoch"][-1]["fused_gin_conv"],
            "scan_trace_launches":
                scan["k3"]["scanned_profile"][f"trace[{K3_EXACT_NAME}]"]["count"],
            "scan_train_ms_per_batch":
                scan["k3"]["scanned_profile"][f"trace[{K3_EXACT_NAME}]"]["device_ms"]
                / scan["k3"]["batches"],
            "shapes": [{k: r[k] for k in ("case", "G", "S", "F", "E", "E_valid", "ms_fwd",
                                          "ms_bwd", "plain_ms_fwd", "plain_ms_bwd",
                                          "library_ms_fwd", "library_ms_bwd", "bound_ms_fwd",
                                          "bound_ms_bwd", "l2_warm_ms_fwd", "l2_warm_ms_bwd",
                                          "call_ms_fwd", "rows_per_block", "blocks_per_graph",
                                          "smem_bytes", "blocks_per_sm")}
                       for r in k3_main],
        },
        {
            "name": "sorted_scatter_gather",
            # phase 15: the atomic attention paths and the first atomic
            # batch's softmax calls
            "atomic": atomic_kernel_line(atomic, "sorted_scatter_gather"),
            **KERNELS["sorted_scatter_gather"],
            "mesh_launches_per_rank": mesh_launches("sorted_scatter_gather"),
            "scan_mesh_launches": scan_mesh_launches("sorted_scatter_gather"),
            # the attention GINet's sparse serving pass (this slice's main
            # path): one launch per conv and tower, 4 per batch
            "launches": att["serve"]["launches"]["sorted_scatter_gather"],
            "max_abs_err": max(r["max_abs_err"] for r in k2),
            # one call at each softmax shape of the first served batch
            # (conv1 over the interface edges, conv2 over the pooled ones,
            # F = 1), L2 flushed before each call
            "ms": sum(r["ms"] for r in k2_path),
            "plain_ms": sum(r["plain_ms"] for r in k2_path),
            "bound_ms": sum(r["bound_ms"] for r in k2_path),
            "bound_by": "bytes",
            # no one PyTorch call computes K2: torch.segment_reduce, then
            # index_select of the sums at the valid edges' rows
            "library_ms": sum(r["library_ms"] for r in k2_path),
            "library_call": "torch.segment_reduce + index_select (two calls, prepared indices)",
            "served_ms_per_batch": a_serve["sorted_scatter_gather_ms_per_batch"],
            "served_bound_ms_per_batch": a_serve["sorted_scatter_gather_bound_ms_per_batch"],
            "train_launches": att["train"]["launches"]["sorted_scatter_gather"],
            "train_ms_per_batch": a_train["sorted_scatter_gather_ms_per_batch"],
            "train_bound_ms_per_batch": a_train["sorted_scatter_gather_bound_ms_per_batch"],
            "l2_warm_ms": sum(r["l2_warm_ms"] for r in k2_path),
            "call_ms": sum(r["call_ms"] for r in k2_path),
            # an almost empty launch under torch.profiler: the floor of the
            # in-pass times
            "launch_floor_ms": floor["sorted_scatter_gather"]["median_ms"],
            # bench.py's bench_spmm_kernel shapes (N 81,920, E 983,040, F 16)
            "bench_shapes": {k: k2_bench[k] for k in ("E", "N", "F", "ms", "plain_ms",
                                                       "library_ms", "bound_ms", "l2_warm_ms",
                                                       "call_ms")},
            "shapes": [{k: r[k] for k in ("case", "E", "E_valid", "N", "F", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "l2_warm_ms", "call_ms",
                                          *k2_plans)}
                       for r in k2_path],
        },
        {
            "name": "fused_gin_conv_bf16",
            # phase 15: the atomic-scale paths and the first atomic batch's calls
            "atomic": atomic_kernel_line(atomic, "fused_gin_conv_bf16"),
            **FAST_K3,
            "mesh_launches_per_rank": mesh_launches("fused_gin_conv_bf16"),
            "scan_mesh_launches": scan_mesh_launches("fused_gin_conv_bf16"),
            # the fast mode's scanned training epoch on store batches without
            # the operators, from a fresh engine: the warm-up step's 4
            # launches and the captured 4 times each replay
            "launches": fast["k3"]["launches"]["fused_gin_conv_bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in k3_fast),
            # the 4 calls of one training batch at the first dense batch's
            # shapes as the path makes them (fp32 in, no cast launch), L2
            # flushed before each call
            "ms": sum(r["ms_fwd"] + r["ms_bwd"] for r in k3_fast_main),
            "plain_ms": sum(r["plain_ms_fwd"] + r["plain_ms_bwd"] for r in k3_fast_main),
            # fp32 source rows as the path reads them, fp32 output and indices
            "bound_ms": sum(r["bound_ms_fwd"] + r["bound_ms_bwd"] for r in k3_fast_main),
            "bound_by": "bytes",
            # index_select + index_add_ on the bf16-rounded fp32 values
            "library_ms": sum(r["library_ms_fwd"] + r["library_ms_bwd"] for r in k3_fast_main),
            "library_call": "index_select + index_add_ on bf16-rounded fp32 (two calls)",
            # the exact K3 on the same inputs in this call
            "exact_ms": sum(r["exact_ms_fwd"] + r["exact_ms_bwd"] for r in k3_fast_main),
            # the cast to bf16 that the path no longer launches before each
            # call, alone, at each call's shape
            "cast_ms": sum(2 * r["cast_ms"] for r in k3_fast_main),
            # bf16 casts traced in one training batch's calls (each shape's
            # forward and backward through autograd), beside the control's
            # one planted cast per shape
            "cast_launches_per_batch": sum(r["cast_launches_fwd_bwd"] for r in k3_fast_main),
            "control_casts_per_batch": sum(r["control_casts"] for r in k3_fast_main),
            "device_ops_per_batch": sum(r["device_ops_fwd_bwd"] for r in k3_fast_main),
            "l2_warm_ms": sum(r["l2_warm_ms_fwd"] + r["l2_warm_ms_bwd"] for r in k3_fast_main),
            "exact_l2_warm_ms": sum(r["exact_l2_warm_ms_fwd"] + r["exact_l2_warm_ms_bwd"]
                                    for r in k3_fast_main),
            "trace_launches": fast["k3"]["profile"][f"trace[{K3_FAST_NAME}]"]["count"],
            "scan_train_ms_per_batch":
                fast["k3"]["profile"][f"trace[{K3_FAST_NAME}]"]["device_ms"]
                / (fast["k3"]["launches"]["fused_gin_conv_bf16"] / 4),
            # bf16 casts traced in that epoch, by the pattern phase 3's
            # control checks (the path launches none)
            "scan_cast_launches": fast["k3"]["casts"],
            "shapes": [{k: r[k] for k in ("case", "G", "S", "F", "E", "E_valid", "ms_fwd",
                                          "ms_bwd", "exact_ms_fwd", "exact_ms_bwd", "cast_ms",
                                          "cast_launches_fwd_bwd", "control_casts",
                                          "plain_ms_fwd", "plain_ms_bwd", "library_ms_fwd",
                                          "library_ms_bwd", "bound_ms_fwd", "bound_ms_bwd",
                                          "l2_warm_ms_fwd", "l2_warm_ms_bwd", "slab",
                                          "rows_per_block", "blocks_per_graph", "smem_bytes",
                                          "blocks_per_sm", "lanes_per_row", "cols_per_lane",
                                          "unroll", "exact_rows_per_block",
                                          "exact_blocks_per_graph", "exact_smem_bytes")}
                       for r in k3_fast_main],
        },
        {
            "name": "fused_attention_conv",
            **KERNELS["fused_attention_conv"],
            # phase 17: a captured training step of attention GINet on the
            # store (train_store's path), its launches a replay (CSR builds,
            # forward calls, backward passes), its epoch losses and the CPU's
            "launches": k4["store"]["launches_per_replay"],
            "store_losses": k4["store"]["losses"],
            "store_cpu_losses": k4["store"]["cpu_losses"],
            # phase 7: the dense attention path's first epoch on the card
            "zoo_serve_launches": zoo_out["attention_dense"]["serve"]["launches"],
            "zoo_train_launches": zoo_out["attention_dense"]["train"]["launches"],
            # phase 17's calls against the plain version on the card: the
            # largest error over the tensor's largest element, of the
            # forward's and of the backward's outputs
            "max_rel_err_fwd": max(r[k]["vs_card_plain"] for r in k4["cases"]
                                   for k in ("out", "alpha")),
            "max_rel_err_bwd": max(r[k]["vs_card_plain"] for r in k4["cases"]
                                   for k in ("dxw", "dp", "dq", "db")),
            # one CSR build, forward and backward at each conv's atomic
            # shape (conv1, conv2), L2 flushed before each call; the plain
            # version's forward and backward
            "ms": sum(r["ms_csr"] + r["ms_fwd"] + r["ms_bwd"] for r in k4["cases"]),
            "plain_ms": sum(r["plain_ms_fwd"] + r["plain_ms_bwd"] for r in k4["cases"]),
            "bound_ms": sum(r["bound_ms_csr"] + r["bound_ms_fwd"] + r["bound_ms_bwd"]
                            for r in k4["cases"]),
            "bound_by": "bytes",
            "l2_warm_ms": sum(r["l2_warm_ms_csr"] + r["l2_warm_ms_fwd"] + r["l2_warm_ms_bwd"]
                              for r in k4["cases"]),
            "shapes": [{k: r[k] for k in ("case", "G", "S", "F", "E", "kept", "ms_csr", "ms_fwd",
                                          "ms_bwd", "l2_warm_ms_csr", "l2_warm_ms_fwd",
                                          "l2_warm_ms_bwd", "plain_ms_fwd", "plain_ms_bwd",
                                          "bound_ms_csr", "bound_ms_fwd", "bound_ms_bwd",
                                          "short_rows", "lanes_per_row", "rows_per_block")}
                       for r in k4["cases"]],
        },
    ]}
    passes = {f"serve_{k}": v for k, v in served.items()}
    passes.update({f"train_{k}": v for k, v in trained.items()})
    passes.update(serve_attention=att["serve"], train_attention=att["train"])
    for label, v in zoo_out.items():
        passes.update({f"serve_{label}": v["serve"], f"train_{label}": v["train"]})
    passes.update(serve_store=store["serve"], train_store=store["train"],
                  train_store_k3=store["train_k3"], serve_store_chunked=store["chunked"])
    for label in ("foutnet_store", "sgat_store"):
        passes.update({f"serve_{label}": store[label]["serve"],
                       f"train_{label}": store[label]["train"]})
    summary = {}
    for label, v in passes.items():
        count = len(v["pred"]) if label.startswith("serve") else v["graphs"]
        summary[label] = {"graphs_per_s": [count / w for w in v["walls"]],
                          "launches": v["launches"]}
        if v["where"] is not None:
            summary[label].update({k: v["where"].get(k) for k in (
                "device_idle_share", "device_busy_ms", "index_accumulation_ms",
                "index_accumulation_share_of_busy")})
    summary["atomic"] = atomic_summary(atomic)
    summary["padding"] = padding
    summary["digests"] = digests
    summary["store_bytes"] = store["batches"]
    for label in ("operators", "k3"):
        v = scan[label]
        summary[f"scan_train_{label}"] = {
            k: v[k] for k in ("looped_graphs_per_s", "scanned_graphs_per_s",
                              "scanned_host_ms_per_batch", "looped_ms_per_batch",
                              "replays_per_epoch", "ran_per_epoch")}
        summary[f"scan_train_{label}"]["device_idle_share"] = {
            "scanned": v["scanned_profile"]["device_idle_share"],
            "looped": v["looped_profile"]["device_idle_share"]}
    summary["scan_train_chunked"] = {
        k: scan["chunked"][k] for k in ("looped_graphs_per_s", "scanned_graphs_per_s",
                                         "scanned_host_ms_per_batch", "looped_ms_per_batch",
                                         "replays_per_epoch", "chunks")}
    summary["scan_train_chunked"]["device_idle_share"] = {
        "scanned": scan["chunked"]["scanned_profile"]["device_idle_share"],
        "looped": scan["chunked"]["looped_profile"]["device_idle_share"]}
    summary["scan_full"] = {"first": scan["full"]["first"], "warm": scan["full"]["warm"],
                            "looped_graphs_per_s": scan["full"]["looped_graphs_per_s"],
                            "device_idle_share": scan["full"]["profile"]["device_idle_share"]}
    summary["scan_serve"] = {k: scan["serve"][k] for k in ("models_per_s", "host_ms_per_batch",
                                                          "batches")}
    summary["scan_serve"]["device_idle_share"] = scan["serve"]["where"]["device_idle_share"]
    summary["fast"] = {"k3_loss": fast["k3"]["loss"], "operators_loss": fast["operators"]["loss"],
                       "exact_k3_loss": scan["k3"]["losses"][0]}
    # per rank, under gloo with the CUDA tensors staged through the host:
    # not NCCL numbers
    summary["mesh_gloo_two_ranks_one_card"] = {
        path: {kind: {"graphs_per_s": [r[path][kind]["graphs_per_s"] for r in mesh["ranks"]],
                      "device_idle_share": [r[path][kind]["where"]["device_idle_share"]
                                            for r in mesh["ranks"]]}
               for kind in ("serve", "train")} for path in MESH_PATHS}
    summary["mesh_halo_bytes"] = mesh["ranks"][0]["halo_bytes"]
    scan_keys = ("graphs_per_s", "looped_graphs_per_s", "host_ms_per_batch", "replays_per_epoch",
                 "bytes_per_epoch", "all_reduce_captured", "wall", "replays")
    summary["mesh_scan_gloo_two_ranks_one_card"] = {
        label: [{k: r[label][k] for k in scan_keys if k in r[label]}
                | {"device_idle_share": r[label]["profile"]["device_idle_share"]}
                for r in mesh["ranks"]] for label in ("scan_operators", "scan_k3")}
    summary["mesh_scan_nccl_one_rank"] = {
        variant: {k: v for k, v in mesh["nccl"][f"scan_{variant}"].items()
                  if k in scan_keys or k == "profile"} for variant in ("epochs", "full",
                                                                      "chunked")}
    for v in summary["mesh_scan_nccl_one_rank"].values():
        if "profile" in v:
            v["device_idle_share"] = v.pop("profile")["device_idle_share"]
    summary["mesh_nccl_one_rank"] = {k: v for k, v in mesh["nccl"].items()
                                     if not k.startswith("scan_")}
    summary["custom_model"] = custom
    summary["featurize"] = {k: v for k, v in feat.items() if k != "serve"}
    summary["featurize"]["serve"] = {
        "graphs_per_s": [len(feat["serve"]["pred"]) / w for w in feat["serve"]["walls"]],
        "launches": feat["serve"]["launches"],
        "device_idle_share": feat["serve"]["where"]["device_idle_share"],
        "cpu_max_abs": feat["serve"]["cpu_max_abs"]}
    log("summary " + json.dumps(summary))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
