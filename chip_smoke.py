#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py [--seed N] [--graphs N]

Run from the root of a checkout; it needs one CUDA device and ``nvcc``
(``$CUDA_HOME/bin`` or PATH), and nothing beyond torch, numpy and scipy.
Phases, each of which raises on failure:

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
   (bf16 ``xw``, fp32 sums and output: ``exact=False``) forward and
   backward bitwise equal to the fp32 plain version run on the CPU on the
   bf16-rounded values, at both conv levels' shapes and three edge cases,
   its slab in shared memory smaller than the exact kernel's, and timed
   beside the exact kernel on the same inputs. K2 (sorted
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
   against the sparse one), the internal-tower GINet (sparse only, K1 4
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
   on; scanned serving bitwise the looped store serving, profiled;
10. the fast mode (``dense_fast=True``) scanned on store batches without
   the operators: K3's fast variant inside the graph (52 launches an
   epoch, traced as the bf16 kernel), bitwise the looped fast epoch and
   within ``BF16_TOL`` of the exact path's loss; the fast operator path
   (``adj_conv`` with bf16 operands) scanned for one epoch;
11. multi-device (``parallel/``): two worker processes started with
   ``torch.multiprocessing`` spawn form one gloo group over a ``file://``
   store in the run's temporary directory, both on cuda:0 (NCCL refuses
   two ranks on one card; gloo stages the CUDA tensors through the host),
   and load the kernels from phase 2's cache (running ``nvcc`` fails
   them). On 512 of the graphs (4 batches of 128) each rank runs
   paper-mode GINet on three paths: the halo layout
   (``layout="halo", mesh=make_halo_mesh()``; K1 3 launches per batch,
   served and trained), the dense graph-parallel mesh (``make_mesh(dp=2,
   ep=1)``; K3 2 per served batch, 4 per training batch, over 64 graphs)
   and the sparse one (``make_mesh()``, dp=1 x ep=2; K1 2 per batch). Each
   is served from phase 4's checkpoint against the single-process card run
   at ``TOL``, its first 4 Adam steps (dropout off) against the
   single-process card run at ``TOL``, and with dropout on the engine's
   training pass (``_run_pass``) run twice from one seed, losses and
   parameters bitwise equal, both ranks' parameters bitwise equal after
   each epoch; the launch counts, walls and the profiled epoch are that
   pass's. The same epoch taken a step at a time gives the pass's loss
   bitwise, with both ranks' parameters equal after every step. One halo
   training step's
   collective bytes equal its plan and lie below an all-gather of the node
   array. Each rank prints its graphs/s (gloo times, host staging
   included). Then this process alone forms an NCCL group of one and runs
   one halo and one dense-mesh training pass of one batch on NCCL's
   collectives;
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
   launch, bitwise the CPU run.

The last two lines are a JSON object of per-kernel numbers and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
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

# K3's fast variant: the same source, built for bf16 input
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
}


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


def write_checkpoint(path: str, seed: int, Net=None) -> None:
    """A reference-format torch checkpoint of a seeded random ``Net``
    (default GINet) at the paper's width."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet

    model = (Net or GINet)(48, 1, 1, device="cpu", generator=torch.Generator().manual_seed(seed))
    torch.save(
        {
            "model": model.state_dict(),
            "optimizer": {},
            "net": type(model).__name__,
            "node": FOLD6_FEATURES,
            "edge": ["dist"],
            "target": "fnat",
            "task": "reg",
            "classes": [0, 1],
            "class_weight": None,
            "batch_size": BATCH,
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


def k1_case(name, data, row_ptr, rows, timed: bool):
    """Check the sorted segment sum kernel against its plain version on
    the card (``KERNEL_TOL``) and bitwise against the plain version run on
    the CPU (both sum in edge order); log its launch plan; time it when
    ``timed``. Returns a dict of numbers."""
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


def k3_bound_ms(s: int, f: int, row, col, in_bytes: int = 4) -> float:
    """Least time of one K3 call ``out = fused_gin_conv(xw [G,S,F], row,
    col)`` on these indices: its bytes over the HBM rate, or one add per
    valid edge and column over the fp32 rate, whichever is longer. The
    bytes are the ``xw`` rows that a valid edge reads (each distinct
    (graph, ``col``) pair once, ``in_bytes`` an element: 4, or 2 for the
    fast variant's bf16; run padding and sentinel slots are never read),
    ``out`` written whole in fp32 (G*S*F) and ``row`` and ``col`` read once.
    For the backward pass ``col, row`` swapped: it reads the gradient rows
    that a valid ``row`` names."""
    import torch

    g, e = row.shape
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    goff = torch.arange(g, device=col.device)[:, None] * s
    sources = int(torch.unique((col.long() + goff)[valid]).numel())
    moved = in_bytes * sources * f + 4 * (g * s * f + 2 * g * e)
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


def k3_fast_case(name, xw, row, col, gen, timed: bool) -> dict:
    """K3's fast variant (``exact=False``: bf16 ``xw``, fp32 sums and
    output), forward and backward through its autograd Function, bitwise
    equal to the fp32 plain version run on the CPU on the bf16-rounded
    values (both sum in edge order); two launches bitwise equal; its launch
    plan beside the exact kernel's. Timed when ``timed``: beside the exact
    kernel on the same (unrounded) inputs in this call, the plain version
    and the library pair on the rounded fp32 values, and both bounds."""
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
    xb, cb = xw.bfloat16(), cot.bfloat16()
    again = fused_gin_conv_forward(xb, row, col)
    bwd_again = fused_gin_conv_forward(cb, col, row)
    torch.cuda.synchronize()
    if not (torch.equal(fwd, again) and torch.equal(x.grad, bwd_again)):
        raise AssertionError(f"K3 fast {name}: two launches differ")
    xr, cr = xb.float(), cb.float()  # the rounded values, in fp32
    rc, cc = row.cpu(), col.cpu()
    want, want_grad = fused_gin_conv_plain(xr.cpu(), rc, cc), fused_gin_conv_plain(cr.cpu(), cc, rc)
    got, got_grad = fwd.detach().cpu(), x.grad.cpu()
    fe, be = errors(got, want), errors(got_grad, want_grad)
    if not (torch.equal(got, want) and torch.equal(got_grad, want_grad)):
        raise AssertionError(f"K3 fast {name}: not bitwise the plain version on the rounded "
                             f"values on the cpu: forward {fe}, backward {be}")
    valid = (row >= 0) & (row < s) & (col >= 0) & (col < s)
    res = {"case": name, "G": g, "S": s, "F": f, "E": e, "E_valid": int(valid.sum()),
           **launch_plan(xw.device, s, f, e, bf16=True),
           "exact_smem_bytes": launch_plan(xw.device, s, f, e)["smem_bytes"],
           "max_abs_err": max(fe["max_abs_err"], be["max_abs_err"]),
           "max_rel_err": max(fe["max_rel_err"], be["max_rel_err"]),
           # how far the rounding moves the result from the exact kernel's
           "vs_exact_max_abs": float((fwd.detach() - fused_gin_conv_forward(xw, row, col))
                                     .abs().max())}
    if timed:
        lib_fwd, lib_bwd = k3_library_pair(xr, row, col), k3_library_pair(cr, col, row)
        res.update(
            ms_fwd=cold_ms(lambda: fused_gin_conv_forward(xb, row, col)),
            ms_bwd=cold_ms(lambda: fused_gin_conv_forward(cb, col, row)),
            exact_ms_fwd=cold_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            exact_ms_bwd=cold_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            plain_ms_fwd=cold_ms(lambda: fused_gin_conv_plain(xr, row, col)),
            plain_ms_bwd=cold_ms(lambda: fused_gin_conv_plain(cr, col, row)),
            library_ms_fwd=cold_ms(lib_fwd),
            library_ms_bwd=cold_ms(lib_bwd),
            l2_warm_ms_fwd=l2_warm_ms(lambda: fused_gin_conv_forward(xb, row, col)),
            l2_warm_ms_bwd=l2_warm_ms(lambda: fused_gin_conv_forward(cb, col, row)),
            exact_l2_warm_ms_fwd=l2_warm_ms(lambda: fused_gin_conv_forward(xw, row, col)),
            exact_l2_warm_ms_bwd=l2_warm_ms(lambda: fused_gin_conv_forward(cot, col, row)),
            bound_ms_fwd=k3_bound_ms(s, f, row, col, in_bytes=2),
            bound_ms_bwd=k3_bound_ms(s, f, col, row, in_bytes=2),
            exact_bound_ms_fwd=k3_bound_ms(s, f, row, col),
            exact_bound_ms_bwd=k3_bound_ms(s, f, col, row),
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
    fast = [k3_fast_case(name, x, r, c, gen, timed=True) for name, x, r, c in main]
    fast += [k3_fast_case(name, x, r, c, gen, timed=False) for name, x, r, c in edge
             if name in ("edges-F17", "tiles-F32", "no-slab-F64")]
    for res in fast:
        log("K3 fast " + json.dumps(res))
        if res["slab"] != (res["case"] != "no-slab-F64") or (
                res["slab"] and res["smem_bytes"] >= res["exact_smem_bytes"]):
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


def k2_case(name, data, row_ptr, rows, gen, timed: bool) -> dict:
    """K2 against its plain version on the card: ``out`` and ``d2`` within
    ``KERNEL_TOL``, ``d2`` bitwise ``out[rows]`` and 0 outside every run,
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
    torch.testing.assert_close(out, want_out, **KERNEL_TOL, msg=f"K2 {name} out")
    torch.testing.assert_close(d2, want_d2, **KERNEL_TOL, msg=f"K2 {name} d2")
    valid = (rows >= 0) & (rows < n)
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
        torch.testing.assert_close(x.grad, xp.grad, **KERNEL_TOL, msg=f"K2 {name} backward")
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
    busy_ms = sum(e.device_time for e in on_card) / 1e3
    by_name: dict = {}
    for e in on_card:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.device_time / 1e3
    res = {
        "batches": batches,
        "host_collate_ms": collate_ms,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops": len(on_card),
        "annotation_ms_not_counted": sum(e.device_time for e in annotations) / 1e3,
        "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
    }
    for name, bound in kernel_bounds.items():
        ms = sum(v for k, v in by_name.items() if name in k)
        res[f"{name}_device_ms"] = ms
        res[f"{name}_ms_per_batch"] = ms / batches
        res[f"{name}_share_of_busy"] = ms / busy_ms
        res[f"{name}_bound_ms_per_batch"] = bound
    return res


def sparse_bound_per_batch(loader) -> float:
    """K1's bound per batch of ``loader``, averaged over its batches
    (conv1 at 32 columns over the interface edges, conv2 at 64 over the
    pooled edges)."""
    bounds = [k1_bound_ms(int(b.edge_rowptr[-1]), b.num_nodes, 32)
              + k1_bound_ms(int(b.pe_rowptr[-1]), b.num_clusters0, 64) for b, _ in loader]
    return float(np.mean(bounds))


def attention_bounds_per_batch(loader, training: bool) -> dict:
    """K1's and K2's bounds per batch of ``loader`` on the attention path,
    averaged over its batches: per tower K1 sums the weighted messages
    (conv1 at 16 columns, conv2 at 32) and K2 the softmax denominators
    (F = 1); training adds K2's backward, one more K2 call at F = 1 each
    (the messages' gradient is a plain gather)."""
    k1, k2 = [], []
    for b, _ in loader:
        levels = ((int(b.edge_rowptr[-1]), b.edge_index.shape[1], b.num_nodes, 16),
                  (int(b.pe_rowptr[-1]), b.pe_index.shape[1], b.num_clusters0, 32))
        k1.append(2 * sum(k1_bound_ms(ev, n, f) for ev, _e, n, f in levels))
        k2.append((4 if training else 2) * sum(k2_bound_ms(ev, e, n, 1)
                                               for ev, e, n, _f in levels))
    return {"sorted_segment_sum": float(np.mean(k1)), "sorted_scatter_gather": float(np.mean(k2))}


def dense_bound_per_batch(loader, backward: bool) -> float:
    """K3's bound per batch of ``loader``: conv1 at 32 columns, conv2 at 64,
    forward, and backward too when ``backward``."""
    bounds = []
    for b, _ in loader:
        total = 0.0
        for s, f, row, col in ((b.x.shape[1], 32, b.row, b.col),
                               (b.pool0_mask.shape[1], 64, b.pe_row, b.pe_col)):
            total += k3_bound_ms(s, f, row, col)
            if backward:
                total += k3_bound_ms(s, f, col, row)
        bounds.append(total)
    return float(np.mean(bounds))


def serve_check(label: str, Net, dataset, ckpt: str, tmp: str, layout: str, per_batch: dict,
                bounds=None, passes: int = 2, **engine_kw) -> dict:
    """Score ``dataset`` with ``Net`` from ``ckpt`` on the card (``passes``
    passes, launch counts cleared before each and read after: ``per_batch``
    launches per batch, nothing else) and once on the CPU: finite
    predictions that match the CPU's at ``TOL``. With ``bounds`` (a function
    of the test loader giving each kernel's bound per batch) one more pass
    runs under ``torch.profiler``. ``engine_kw`` (the store options) go to
    both engines."""
    nn, pred, loss, walls, launches = serve(
        dataset, ckpt, "cuda", os.path.join(tmp, f"serve_{label}"), passes, layout, Net,
        **engine_kw)
    batches = len(nn.test_loader)
    where = None
    if bounds is not None:
        where = profile_pass(lambda: nn.eval(nn.test_loader), nn.test_loader,
                             bounds(nn.test_loader))
    _, pred_cpu, loss_cpu, walls_cpu, launches_cpu = serve(
        dataset, ckpt, "cpu", os.path.join(tmp, f"serve_{label}_cpu"), 1, layout, Net,
        **engine_kw)
    log(f"serve {label}: {len(pred)} models in {batches} batches; pass walls (s) {walls} "
        f"-> models/s {[len(pred) / w for w in walls]}; loss {loss}")
    log(f"serve {label}: launches per pass {launches}; cpu pass {walls_cpu[0]} s, "
        f"launches {launches_cpu[0]}")
    if where is not None:
        log(f"serve {label} breakdown " + json.dumps(where))
    want = per_pass(per_batch, batches)
    for i, count in enumerate(launches):
        if count != want:
            raise AssertionError(f"serve {label} pass {i}: launched {count}, want {want}")
    if launches_cpu[0]:
        raise AssertionError(f"the cpu pass launched kernels: {launches_cpu[0]}")
    if pred.shape != (len(dataset),) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions: shape {pred.shape}, finite {np.isfinite(pred).all()}")
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
    loader, as ``_run_pass(training=True)`` takes them."""
    from deeprank_gnn_tpu_torch.device import deterministic

    losses = []
    nn.model.train()
    with deterministic():
        for i, (batch, _mols) in enumerate(nn.train_loader):
            if i == steps:
                break
            loss, _pred = nn._train_step(nn._map_targets_host(batch).to(nn.device))
            losses.append(float(loss))
    nn.model.eval()
    return losses


def train_phase(label: str, Net, dataset, layout: str, seed: int, tmp: str, per_batch: dict,
                bounds=None, **engine_kw) -> dict:
    """Train ``Net`` at the paper's width, batch 128, percent [0.8, 0.2]:
    the first 4 Adam steps (dropout off) against the CPU's at ``TOL``; the
    epoch passes of ``train()`` with ``per_batch`` launches per training
    batch (counts cleared before each epoch and read after) and finite
    losses. With ``bounds`` (a function of the training loader giving each
    kernel's bound per batch) the whole check: two epochs, a second run
    from the same seed bitwise equal, a profiled warm epoch, and save,
    reload and resume. ``engine_kw`` (the store options) go to every
    engine."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    kw = dict(node_feature=FOLD6_FEATURES, edge_feature=["dist"], target="fnat",
              batch_size=BATCH, percent=[0.8, 0.2], layout=layout, seed=seed, **engine_kw)
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
        cpu = first_steps(engine("cpu", "parity_cpu"), PARITY_STEPS)
    finally:
        GINet.dropout_rate = rate
    diff = np.abs(np.asarray(card) - np.asarray(cpu))
    log(f"train {label}: first {PARITY_STEPS} losses card {card} cpu {cpu}; max abs {diff.max()}, "
        f"max rel {(diff / np.abs(cpu)).max()}")
    np.testing.assert_allclose(card, cpu, **TOL)

    # the main path: the epoch passes of train(), dropout on
    def epochs(nn, count):
        walls, launches, losses, valid = [], [], [], []
        for _ in range(count):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            _o, _om, _y, loss, _d = nn._run_pass(nn.train_loader, training=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(dict(LAUNCHES))
            losses.append(loss)
            valid.append(nn._run_pass(nn.valid_loader, training=False)[3])
        return walls, launches, losses, valid

    a = engine("cuda", "a")
    walls, launches, losses, valid = epochs(a, 2 if full else 1)
    batches = len(a.train_loader)
    graphs = len(a.train_loader.dataset)
    log(f"train {label}: {graphs} graphs in {batches} batches per epoch; epoch walls (s) {walls} "
        f"-> graphs/s {[graphs / w for w in walls]} (the first cold); losses {losses}, "
        f"valid {valid}; launches {launches}")
    want = per_pass(per_batch, batches)
    for i, count in enumerate(launches):
        if count != want:
            raise AssertionError(f"train {label} epoch {i}: launched {count}, want {want}")
    if not np.isfinite(losses + valid).all():
        raise AssertionError(f"train {label}: losses {losses}, valid {valid}")
    res = {"walls": walls, "launches": launches[0], "where": None, "graphs": graphs,
           "parity_max_abs": float(diff.max()), "parity_losses": card}
    if not full:
        return res

    # determinism: a second run from the same seed
    params = {k: v.clone() for k, v in a.model.state_dict().items()}
    b = engine("cuda", "b")
    _w, _l, losses_b, valid_b = epochs(b, 2)
    same = all(torch.equal(v, b.model.state_dict()[k]) for k, v in params.items())
    log(f"train {label}: second run losses {losses_b} valid {valid_b}; parameters equal {same}")
    if losses_b != losses or valid_b != valid or not same:
        raise AssertionError(f"train {label}: two runs from one seed differ")

    # a profiled warm epoch
    res["where"] = profile_pass(lambda: a._run_pass(a.train_loader, training=True),
                                a.train_loader, bounds(a.train_loader))
    log(f"train {label} breakdown " + json.dumps(res["where"]))

    # save, reload, resume
    path = os.path.join(tmp, f"{label}_a", "resume.pth.tar")
    a.save_model(path)
    r = NeuralNet(dataset, Net, pretrained_model=path, layout=layout, device="cuda",
                  outdir=os.path.join(tmp, f"{label}_r"), **engine_kw)
    if not all(torch.equal(v, r.model.state_dict()[k]) for k, v in a.model.state_dict().items()):
        raise AssertionError(f"train {label}: the reloaded weights differ")
    state = r.optimizer.state_dict()["state"]
    steps = {float(s["step"]) for s in state.values()}
    if len(state) != len(list(r.model.parameters())) or steps != {3.0 * batches}:
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
                         lambda ld: attention_bounds_per_batch(ld, False))
    log(f"phase serve attention: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = train_phase("attention", net, dataset, "sparse", seed, tmp,
                          {"sorted_segment_sum": 4, "sorted_scatter_gather": 8},
                          lambda ld: attention_bounds_per_batch(ld, True))
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
        ("attention_dense", attention, "dense", {}, {}),
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


def store_batches_check(dataset, precompute_ops: bool) -> dict:
    """One unshuffled epoch of ``GraphLoader(device_cache=True)`` on the card
    against the streaming loader with the same ``precompute_ops``: the same
    molecules, and every field of every batch bitwise the streamed batch
    moved to the card (the same dtype and shape; a field is None in both or
    in neither). Also the store's build time and its bytes, as
    ``estimate_store_bytes`` gives them and as ``torch.cuda.memory_allocated``
    grows."""
    import dataclasses

    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.device_store import estimate_store_bytes

    kw = dict(batch_size=BATCH, layout="dense", precompute_ops=precompute_ops)
    streamed = GraphLoader(dataset, **kw)
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
        want, got = sb.to("cuda"), cb.to("cuda")
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if (a is None) != (b is None):
                raise AssertionError(f"store batch {bi} field {f.name}: None in one only")
            if a is not None and (a.dtype != b.dtype or a.shape != b.shape
                                  or not torch.equal(a, b)):
                raise AssertionError(f"store batch {bi} field {f.name} differs")
            fields += a is not None
    # one batch's gather and unpack, eager (the host's launches included),
    # and the packed bytes it reads
    store, slots = stored._store, np.arange(BATCH)
    gather_ms = call_ms(lambda: store.batch(slots, BATCH), iters=50, warmup=5)
    res = {"precompute_ops": precompute_ops, "batches": len(pairs),
           "fields_per_batch": fields // len(pairs), "build_s": build_s,
           "estimate_bytes": estimate, "packed_bytes": store.nbytes,
           "allocated_bytes": allocated, "gather_call_ms": gather_ms,
           "gather_bytes": BATCH * store.nbytes // (len(dataset) + 1)}
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


def chunked_check(dataset, ckpt: str, tmp: str, seed: int, store_pred) -> dict:
    """``device_cache="chunked"`` with a budget of 4 batches a chunk (at
    least 3 chunks): unshuffled serving bitwise that of
    ``device_cache=True``, no hand kernel, the copies of the chunks on
    their side stream beside the host's time per chunk; then a shuffled
    training epoch that sees every graph once."""
    import torch

    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.data.device_store import estimate_store_bytes
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    nf, ef = dataset.feature_dims()
    caps = GraphLoader(dataset, batch_size=BATCH, layout="dense")._dense_caps
    per_slot = estimate_store_bytes(1, num_features=nf, num_edge_features=ef, **caps) // 2
    budget = 2 * per_slot * (4 * BATCH + 1)
    kw = dict(layout="dense", device="cuda", device_cache="chunked", device_cache_bytes=budget)
    nn = NeuralNet(dataset, GINet, pretrained_model=ckpt, outdir=os.path.join(tmp, "chunked"),
                   **kw)
    t0 = time.perf_counter()
    nn.test_loader._maybe_build_chunks()
    build_s = time.perf_counter() - t0
    cs = nn.test_loader._chunk_store
    if cs.num_chunks < 3:
        raise AssertionError(f"chunked: {cs.num_chunks} chunks")
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
    log(f"chunked: {cs.num_chunks} chunks of {cs.chunk_nbytes} bytes (budget {budget}), "
        f"built in {build_s} s; pass walls {walls}; launches {launches}; copy per chunk (ms, "
        f"side stream) {copy_ms}; host between chunk uploads (ms) {host_ms}")
    if any(launches) or not np.array_equal(pred, store_pred):
        raise AssertionError(f"chunked serving: launches {launches}, max abs "
                             f"{np.abs(pred - store_pred).max()} against device_cache=True")
    t = NeuralNet(dataset, GINet, node_feature=FOLD6_FEATURES, edge_feature=["dist"],
                  target="fnat", batch_size=BATCH, percent=[0.8, 0.2], seed=seed,
                  outdir=os.path.join(tmp, "chunked_train"), **kw)
    data = t._run_pass(t.train_loader, training=True)[4]
    want = sorted(t.train_loader.dataset.get(i).mol for i in range(len(t.train_loader.dataset)))
    chunks = t.train_loader._chunk_store.num_chunks
    log(f"chunked training epoch: {len(data['mol'])} graphs in {chunks} chunks")
    if sorted(data["mol"]) != want:
        raise AssertionError("chunked training epoch: not every graph exactly once")
    return {"chunks": cs.num_chunks, "pred": pred, "walls": walls, "launches": launches[0],
            "where": None, "copy_ms": copy_ms, "host_ms_between_uploads": host_ms}


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


def scan_engine(dataset, seed: int, tmp: str, name: str, kdir: str, ops: bool = True, **kw):
    """Paper-mode GINet on the device store at batch 128, percent [0.8,
    0.2], from ``seed``; ``ops=False`` gives it store loaders without the
    precomputed operators, whose batches feed K3. ``kw``: ``scan_epochs``,
    ``dense_fast``."""
    from deeprank_gnn_tpu_torch.data.batch import GraphLoader
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    nn = NeuralNet(dataset, GINet, node_feature=FOLD6_FEATURES, edge_feature=["dist"],
                   target="fnat", batch_size=BATCH, percent=[0.8, 0.2], layout="dense",
                   seed=seed, device="cuda", device_cache=True, executable_cache_dir=kdir,
                   outdir=os.path.join(tmp, f"scan_{name}"), **kw)
    if not ops:
        for attr in ("train_loader", "valid_loader"):
            ld = getattr(nn, attr)
            setattr(nn, attr, GraphLoader(ld.dataset, batch_size=BATCH, shuffle=True, seed=seed,
                                          layout="dense", device_cache=True,
                                          precompute_ops=False, device="cuda"))
    return nn


def run_pass(nn, training: bool, loader=None) -> dict:
    """One ``_run_pass`` of ``nn`` (scanned when it scans) with the launch
    counts cleared just before and read just after: its wall time, loss
    and outputs; the hand-kernel launches counted, and those that ran
    (counted outside a capture, plus each captured graph's launches times
    its replays in this pass: a wrapper counts where it launches, and a
    graph launches at capture); the graphs' replays and the host's
    seconds issuing the steps."""
    import torch

    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES

    loader = loader or (nn.train_loader if training else nn.valid_loader)
    graphs_before = len(nn._scan.graph_stats())
    nn._scan.reset_replays()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out, _out_m, _ys, loss, _data = nn._run_pass(loader, training=training)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(LAUNCHES)
    stats = nn._scan.graph_stats()
    ran = Counter(counted)
    for st in stats[graphs_before:]:
        ran.subtract(st["launches"])
    for st in stats:
        for k, v in st["launches"].items():
            ran[k] += v * st["replays"]
    return {"wall": wall, "loss": loss, "out": out, "counted": counted, "ran": dict(+ran),
            "replays": sum(st["replays"] for st in stats), "issue_s": nn._scan.last_issue_s,
            "batches": len(loader), "graphs": len(loader.dataset)}


def profile_run(run, patterns=()) -> dict:
    """``run()`` under ``torch.profiler``: wall time, the device's busy time
    and idle share (as ``profile_pass`` counts them), device operations,
    and per name pattern the kernels whose name holds it: count and device
    milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.device_time for e in on_card) / 1e3
    res = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ops": len(on_card)}
    for pat in patterns:
        hits = [e for e in on_card if pat in e.name]
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


K3_EXACT_NAME = "fused_gin_conv_kernel<float"
K3_FAST_NAME = "fused_gin_conv_kernel<__nv_bfloat16"


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
    for name, nn in (("looped", looped), ("scanned", scanned)):
        for _ in range(epochs):
            runs[name].append((run_pass(nn, True), run_pass(nn, False)))
    for i, ((lt, lv), (st, sv)) in enumerate(zip(runs["looped"], runs["scanned"])):
        if (lt["loss"], lv["loss"], lv["out"]) != (st["loss"], sv["loss"], sv["out"]):
            raise AssertionError(f"scan {label} epoch {i}: losses {lt['loss']} {lv['loss']} "
                                 f"looped, {st['loss']} {sv['loss']} scanned")
        if lt["ran"] != st["ran"]:
            raise AssertionError(f"scan {label} epoch {i}: kernels ran {lt['ran']} looped, "
                                 f"{st['ran']} scanned")
    assert_same_training(label, looped, scanned)
    batches = runs["scanned"][0][0]["batches"]
    # the first scanned epoch: one warm-up step, then a graph replay per
    # batch; later epochs replay every batch
    replays = [t["replays"] for t, _v in runs["scanned"]]
    if replays != [batches - 1] + [batches] * (epochs - 1):
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
    log(f"scan {label}: " + json.dumps(res))
    return res, scanned


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
    return out


def fast_phase(dataset, tmp: str, seed: int, kdir: str, exact_k3_losses: list) -> dict:
    """The fast mode (``dense_fast=True``) scanned on store batches without
    the operators: a fresh engine's first epoch is the main path of K3's
    fast variant (its launches: the warm-up step's, and the capture's
    times the replays), held bitwise to the looped fast epoch and within
    ``BF16_TOL`` of the exact K3 path's loss; a profiled epoch traces the
    bf16 kernel once per launch and the fp32 one never. Then the fast
    operator path (``adj_conv`` with bf16 operands in the graph) for one
    scanned epoch."""
    out = {}
    looped = scan_engine(dataset, seed, tmp, "fast_looped", kdir, False, dense_fast=True)
    scanned = scan_engine(dataset, seed, tmp, "fast_scanned", kdir, False, dense_fast=True,
                          scan_epochs=True)
    lt = run_pass(looped, True)
    st = run_pass(scanned, True)
    if st["loss"] != lt["loss"]:
        raise AssertionError(f"fast k3: scanned {st['loss']} != looped {lt['loss']}")
    assert_same_training("fast", looped, scanned)
    want = {"fused_gin_conv_bf16": 4 * st["batches"]}
    prof = profile_run(lambda: scanned._run_pass(scanned.train_loader, training=True),
                       (K3_EXACT_NAME, K3_FAST_NAME))
    traced = (prof[f"trace[{K3_FAST_NAME}]"]["count"], prof[f"trace[{K3_EXACT_NAME}]"]["count"])
    log(f"fast k3: looped loss {lt['loss']} ran {lt['ran']}; scanned loss {st['loss']} ran "
        f"{st['ran']} counted {st['counted']} replays {st['replays']}; exact K3 path's first "
        f"loss {exact_k3_losses[0]}; traced bf16/fp32 K3 {traced}; profile {json.dumps(prof)}")
    if st["ran"] != want or lt["ran"] != want or traced != (want["fused_gin_conv_bf16"], 0):
        raise AssertionError(f"fast k3: launches scanned {st['ran']} looped {lt['ran']}, "
                             f"traced {traced}, want {want}")
    np.testing.assert_allclose(st["loss"], exact_k3_losses[0], **BF16_TOL)
    out["k3"] = {"loss": st["loss"], "launches": st["ran"], "counted": st["counted"],
                 "replays": st["replays"], "wall": st["wall"], "graphs": st["graphs"],
                 "profile": prof}
    ops = scan_engine(dataset, seed, tmp, "fast_operators", kdir, True, dense_fast=True,
                      scan_epochs=True)
    ot = run_pass(ops, True)
    log(f"fast operators: scanned loss {ot['loss']}, ran {ot['ran']}, replays {ot['replays']}")
    if not np.isfinite(ot["loss"]) or ot["ran"]:
        raise AssertionError(f"fast operators: loss {ot['loss']}, launches {ot['ran']}")
    out["operators"] = {"loss": ot["loss"], "wall": ot["wall"], "replays": ot["replays"]}
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 11. multi-device: two gloo ranks on the one card, then an NCCL group of one

MESH_GRAPHS = 512  # 4 batches of 128
MESH_RANKS = 2
MESH_TIMEOUT_S = 600
# per batch and rank: K1 runs 3 times per halo forward (the local and remote
# sums of the fused towers, the pooled conv; its gradient is plain torch)
# and 2 times per sparse graph-parallel forward; K3 2 times per dense
# forward and 2 more in the backward
MESH_PATHS = {
    "halo": ("sparse", {"sorted_segment_sum": 3}, {"sorted_segment_sum": 3}),
    "dense_mesh": ("dense", {"fused_gin_conv": 2}, {"fused_gin_conv": 4}),
    "sparse_mesh": ("sparse", {"sorted_segment_sum": 2}, {"sorted_segment_sum": 2}),
}


def _no_nvcc():
    raise AssertionError("a mesh worker ran nvcc: it must load the kernels from the cache")


def _mesh_of(path: str):
    from deeprank_gnn_tpu_torch.parallel.mesh import make_halo_mesh, make_mesh

    if path == "halo":
        return make_halo_mesh()
    return make_mesh(dp=2, ep=1) if path == "dense_mesh" else make_mesh()


def _ranks_equal(model) -> bool:
    """Whether every rank holds bitwise this rank's parameters (gathered
    straight through torch.distributed, outside the byte counter)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
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
        for i, (batch, _mols) in enumerate(nn.train_loader):
            if i == steps:
                break
            item = nn._shard(nn._map_targets_host(batch)).to(nn.device)
            loss, _pred = nn._mesh_steps.train(item, nn._dropout_generator)
            losses.append(float(loss))
            if check_ranks and not _ranks_equal(nn.model):
                raise AssertionError(f"step {i}: the ranks' parameters differ")
    torch.cuda.synchronize()
    nn.model.eval()
    return losses, time.perf_counter() - t0


def _train_engine(dataset, layout: str, seed: int, outdir: str, mesh=None):
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    return NeuralNet(dataset, GINet, node_feature=FOLD6_FEATURES, edge_feature=["dist"],
                     target="fnat", batch_size=BATCH, percent=[1.0, 0.0], seed=seed,
                     layout=layout, mesh=mesh, device="cuda", outdir=outdir)


def mesh_bounds(path: str, nn, loader, training: bool) -> dict:
    """The hand kernel's bound per batch on this rank for ``loader``'s
    batches as the mesh engine ``nn`` places them: K1 over the halo's local
    and remote sums (32 columns) and its pooled conv (64), or over a sparse
    range's two convs; K3 over a dense slice's two convs (and backward when
    ``training``)."""
    if path == "dense_mesh":
        return {"fused_gin_conv": dense_bound_per_batch(loader, training)}
    bounds = []
    for batch, _ in loader:
        item = nn._shard(nn._map_targets_host(batch))
        if path == "halo":
            bounds.append(k1_bound_ms(int(item.loc_rowptr[-1]), item.nl, 32)
                          + k1_bound_ms(int(item.rem_rowptr[-1]), item.nl, 32)
                          + k1_bound_ms(int(item.pe_rowptr[-1]), item.num_clusters0, 64))
        else:
            b = item.batch
            bounds.append(k1_bound_ms(int(b.edge_rowptr[-1]), b.num_nodes, 32)
                          + k1_bound_ms(int(b.pe_rowptr[-1]), b.num_clusters0, 64))
    return {"sorted_segment_sum": float(np.mean(bounds))}


def mesh_path(path: str, dataset, ckpt: str, tmp: str, seed: int, ref: dict) -> dict:
    """One mesh path on this rank: served from ``ckpt`` against the
    single-process card run (``ref``), K1/K3 launches per batch, then
    trained: the first 4 Adam steps with dropout off against the
    single-process card run, and with dropout on the engine's training
    pass twice from one seed, bitwise equal, the ranks bitwise equal after
    each epoch, and once a step at a time, the ranks bitwise equal after
    every step."""
    import torch

    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import LAUNCHES
    from deeprank_gnn_tpu_torch.parallel import collectives
    from deeprank_gnn_tpu_torch.parallel.distributed import process_index
    from deeprank_gnn_tpu_torch.train.neuralnet import NeuralNet

    rank = process_index()
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
        launches = dict(LAUNCHES)
        if launches != per_pass(serve_per_batch, batches):
            raise AssertionError(f"{path} serve: rank {rank} launched {launches} in {batches} "
                                 f"batches, want {serve_per_batch} per batch")
    want = np.array([ref["pred"][m] for m in data["mol"]])
    pred = np.asarray(pred, dtype=np.float64)
    if not np.isfinite(pred).all():
        raise AssertionError(f"{path} serve: predictions not finite")
    np.testing.assert_allclose(pred, want, **TOL)
    np.testing.assert_allclose(loss, ref["loss"], **TOL)
    out["serve"] = {"graphs": len(pred), "batches": batches, "walls": walls,
                    "graphs_per_s": [len(pred) / w for w in walls], "launches": launches,
                    "max_abs": float(np.abs(pred - want).max()),
                    "collective_bytes": collectives.collective_bytes(),
                    "where": profile_pass(lambda: nn.eval(nn.test_loader), nn.test_loader,
                                          mesh_bounds(path, nn, nn.test_loader, False))}

    rate = GINet.dropout_rate
    GINet.dropout_rate = 0.0
    try:
        parity, _ = mesh_epoch(_train_engine(dataset, layout, seed,
                                             os.path.join(tmp, f"{path}_p{rank}"),
                                             _mesh_of(path)), PARITY_STEPS)
    finally:
        GINet.dropout_rate = rate
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
                             _mesh_of(path)) for name in ("a", "b")]
    (la, wa, launches, nbytes), (lb, _wb, _lcb, _nb) = [epoch(nn) for nn in engines]
    pa, pb = params(engines[0]), params(engines[1])
    if la != lb or not same(pa, pb):
        raise AssertionError(f"{path} train: two runs from one seed differ: {la} {lb}")
    nn = engines[1]
    batches = len(nn.train_loader)
    if launches != per_pass(train_per_batch, batches) or not np.isfinite(la):
        raise AssertionError(f"{path} train: rank {rank} launched {launches} in {batches} "
                             f"batches, want {train_per_batch} per batch; loss {la}")
    # the same epoch a step at a time: the ranks' parameters equal after
    # every step, and losses and parameters bitwise the engine pass's
    c = _train_engine(dataset, layout, seed, os.path.join(tmp, f"{path}_c{rank}"),
                      _mesh_of(path))
    steps, _ = mesh_epoch(c, check_ranks=True)
    if sum(steps) != la or not same(params(c), pa):
        raise AssertionError(f"{path} train: step by step {steps}, engine pass {la}")
    # run b's second epoch (warm), then a third under the profiler
    graphs = len(nn.train_loader.dataset)
    warm = epoch(nn)[1]
    where = profile_pass(lambda: nn._run_pass(nn.train_loader, training=True), nn.train_loader,
                         mesh_bounds(path, nn, nn.train_loader, True))
    out["train"] = {"graphs": graphs, "batches": batches, "parity_losses": parity,
                    "parity_max_abs": float(np.abs(np.subtract(parity, ref["parity"])).max()),
                    "epoch_loss": la, "step_losses": steps, "walls": [wa, warm],
                    "graphs_per_s": [graphs / wa, graphs / warm], "launches": launches,
                    "collective_bytes": nbytes, "where": where}
    return out


def halo_bytes_check(dataset, seed: int, tmp: str) -> dict:
    """One halo training step's collective bytes against its plan: ``D *
    H * 32 * 4`` per boundary exchange each way (both towers, 32 wide, in
    one exchange), the pooled combine's all-gather of ``C0 * 33 * 4`` and
    its backward of ``D`` times that, one all-reduce of the gradients; the
    exchange below an all-gather of the ``[Nl, 32]`` node array (forward
    and backward) at the same batch."""
    from deeprank_gnn_tpu_torch.parallel import collectives, halo

    nn = _train_engine(dataset, "halo", seed, os.path.join(tmp, "bytes"), _mesh_of("halo"))
    batch, _ = next(iter(nn.train_loader))
    plan = halo.partition_batch(nn._map_targets_host(batch), MESH_RANKS)
    d, h, nl, c0 = MESH_RANKS, plan.send_idx.shape[-1], plan.nl, plan.num_clusters0
    n_params = sum(p.numel() for p in nn.model.parameters())
    item = halo.shard_halo_batch(plan, nn._mesh_steps.mesh).to(nn.device)
    collectives.reset_collective_bytes()
    nn._mesh_steps.train(item, nn._dropout_generator)
    counted = collectives.collective_bytes()
    want = {"all_to_all/forward": d * h * 32 * 4, "all_to_all/backward": d * h * 32 * 4,
            "all_gather/forward": c0 * 33 * 4, "all_gather/backward": d * c0 * 33 * 4,
            "all_reduce/gradients": n_params * 4}
    node_gather = nl * 32 * 4 + d * nl * 32 * 4
    if counted != want or not counted["all_to_all/forward"] * 2 < node_gather:
        raise AssertionError(f"halo bytes: counted {counted}, plan {want}, node all-gather "
                             f"{node_gather}")
    return {"counted": counted, "H": h, "Nl": nl, "C0": c0, "node_all_gather_bytes": node_gather}


def mesh_worker(rank: int, store: str, kdir: str, tmp: str, seed: int, results: str) -> None:
    """A spawned rank of phase 11: joins the gloo group over ``store`` on
    cuda:0, loads the kernels from ``kdir`` (running ``nvcc`` fails it),
    computes the single-process card references, runs every mesh path and
    writes its results to ``results/rank<r>.json``."""
    import datetime

    import torch

    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.device import set_fp32_numerics
    from deeprank_gnn_tpu_torch.models import GINet
    from deeprank_gnn_tpu_torch.ops.kernels import build
    from deeprank_gnn_tpu_torch.parallel import distributed
    from deeprank_gnn_tpu_torch.train.aot import use_executable_cache

    set_fp32_numerics()
    build.nvcc = _no_nvcc
    use_executable_cache(kdir)
    t0 = time.perf_counter()
    distributed.initialize(f"file://{store}", MESH_RANKS, rank, device="cuda:0",
                           backend="gloo", timeout=datetime.timedelta(seconds=180))
    try:
        dataset = GraphListDataSet(build_graphs(seed, MESH_GRAPHS))
        ckpt = os.path.join(tmp, "ginet_fold6_fnat.pth.tar")
        out = {"start_s": time.perf_counter() - t0}
        refs = {}
        for ref_layout in ("sparse", "dense"):
            nn, pred, loss, _w, _l = serve(dataset, ckpt, "cuda",
                                           os.path.join(tmp, f"mref_{ref_layout}{rank}"), 1,
                                           ref_layout, GINet)
            rate = GINet.dropout_rate
            GINet.dropout_rate = 0.0
            try:
                parity = first_steps(_train_engine(dataset, ref_layout, seed, os.path.join(
                    tmp, f"mref_train_{ref_layout}{rank}")), PARITY_STEPS)
            finally:
                GINet.dropout_rate = rate
            # the test loader keeps the dataset's order
            mols = [g.mol for g in dataset.graphs]
            refs[ref_layout] = {"pred": dict(zip(mols, pred)), "loss": loss, "parity": parity}
        for path, (ref_layout, _s, _t) in MESH_PATHS.items():
            t1 = time.perf_counter()
            out[path] = mesh_path(path, dataset, ckpt, tmp, seed, refs[ref_layout])
            out[path]["phase_s"] = time.perf_counter() - t1
        out["halo_bytes"] = halo_bytes_check(dataset, seed, tmp)
        out["worker_s"] = time.perf_counter() - t0
        with open(os.path.join(results, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        distributed.shutdown()
        torch.cuda.synchronize()


def nccl_group_check(tmp: str, seed: int) -> dict:
    """The parent alone as an NCCL group of one on the card: one halo and
    one dense-mesh training pass of one batch (the engine's ``_run_pass``)
    execute NCCL's collectives (the one-rank
    all-to-all, all-gather, reduce-scatter and all-reduce), each step's
    loss matching the single-process card run's first step."""
    import torch

    from deeprank_gnn_tpu_torch.data.dataset import GraphListDataSet
    from deeprank_gnn_tpu_torch.models import GINet
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
            rate = GINet.dropout_rate
            GINet.dropout_rate = 0.0
            try:
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
            finally:
                GINet.dropout_rate = rate
            np.testing.assert_allclose([loss], ref, **TOL)
            out[label] = {"loss": loss, "single_process_loss": ref[0], "wall_s": wall,
                          "collective_bytes": collectives.collective_bytes()}
        if not out["halo"]["collective_bytes"].get("all_to_all/backward"):
            raise AssertionError(f"nccl: the halo step issued no all-to-all: {out}")
    finally:
        distributed.shutdown()
    return out


def mesh_phase(tmp: str, kdir: str, seed: int) -> dict:
    """Phase 11: two spawned gloo ranks on the card (``mesh_worker``), each
    exit code checked, then the NCCL group of one in this process."""
    import torch.multiprocessing as mp

    results = os.path.join(tmp, "mesh_results")
    os.makedirs(results)
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_worker, args=(os.path.join(tmp, "mesh_store"), kdir, tmp, seed,
                                                results),
                             nprocs=MESH_RANKS, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                raise AssertionError(f"mesh workers still running after {MESH_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in ctx.processes]
    if codes != [0] * MESH_RANKS:
        raise AssertionError(f"mesh workers exited {codes}")
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(results, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    spawn_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        for path in MESH_PATHS:
            s, t = res[path]["serve"], res[path]["train"]
            log(f"mesh {path} rank {r} (gloo, CUDA tensors staged through the host): serve "
                f"{s['graphs']} graphs in {s['batches']} batches, graphs/s {s['graphs_per_s']} "
                f"(cold, warm), launches {s['launches']}, max abs vs single process "
                f"{s['max_abs']}, collective bytes {s['collective_bytes']}; train "
                f"{t['graphs']} graphs in {t['batches']} batches, graphs/s {t['graphs_per_s']} "
                f"(the engine's training pass: first epoch, warm epoch), epoch loss "
                f"{t['epoch_loss']} (step by step {t['step_losses']}), launches "
                f"{t['launches']}, first {PARITY_STEPS} "
                f"losses {t['parity_losses']} (max abs vs single process "
                f"{t['parity_max_abs']}), collective bytes {t['collective_bytes']}")
            log(f"mesh {path} rank {r} serve breakdown " + json.dumps(s["where"]))
            log(f"mesh {path} rank {r} train breakdown " + json.dumps(t["where"]))
        log(f"mesh halo bytes rank {r}: " + json.dumps(res["halo_bytes"]))
        log(f"mesh rank {r}: start {res['start_s']:.1f} s, worker {res['worker_s']:.1f} s")
    t1 = time.perf_counter()
    nccl = nccl_group_check(tmp, seed)
    log("mesh nccl group of one: " + json.dumps(nccl))
    log(f"phase mesh: {time.perf_counter() - t0:.1f} s (spawned ranks {spawn_s:.1f} s, nccl "
        f"{time.perf_counter() - t1:.1f} s)")
    return {"ranks": ranks, "nccl": nccl}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", type=int, default=2048,
                    help="graphs of the paper-mode and attention GINet phases")
    ap.add_argument("--zoo-graphs", type=int, default=768,
                    help="graphs of the other new paths (at least 5 batches of 128 "
                         "give 4 training steps)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernels_") as kdir:
        return run(args, kdir)


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
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
        fast = fast_phase(dataset, tmp, args.seed, kdir, scan["k3"]["losses"])
        log(f"phase fast: {time.perf_counter() - t0:.1f} s")
        # 11. multi-device
        mesh = mesh_phase(tmp, kdir, args.seed)
        # 12. the featurizer, its graphs served, coalesce_edges on the card
        feat = featurize_phase(tmp, args.seed, smi)

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

    line = {"kernels": [
        {
            "name": "sorted_segment_sum",
            **KERNELS["sorted_segment_sum"],
            "mesh_launches_per_rank": mesh_launches("sorted_segment_sum"),
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
            **KERNELS["fused_gin_conv"],
            "mesh_launches_per_rank": mesh_launches("fused_gin_conv"),
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
            **KERNELS["sorted_scatter_gather"],
            "mesh_launches_per_rank": mesh_launches("sorted_scatter_gather"),
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
            **FAST_K3,
            "mesh_launches_per_rank": mesh_launches("fused_gin_conv_bf16"),
            # the fast mode's scanned training epoch on store batches without
            # the operators, from a fresh engine: the warm-up step's 4
            # launches and the captured 4 times each replay
            "launches": fast["k3"]["launches"]["fused_gin_conv_bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in k3_fast),
            # the 4 calls of one training batch at the first dense batch's
            # shapes, L2 flushed before each call
            "ms": sum(r["ms_fwd"] + r["ms_bwd"] for r in k3_fast_main),
            "plain_ms": sum(r["plain_ms_fwd"] + r["plain_ms_bwd"] for r in k3_fast_main),
            # bf16 source rows, fp32 output and indices
            "bound_ms": sum(r["bound_ms_fwd"] + r["bound_ms_bwd"] for r in k3_fast_main),
            "bound_by": "bytes",
            # index_select + index_add_ on the bf16-rounded fp32 values
            "library_ms": sum(r["library_ms_fwd"] + r["library_ms_bwd"] for r in k3_fast_main),
            "library_call": "index_select + index_add_ on bf16-rounded fp32 (two calls)",
            # the exact K3 on the same inputs in this call
            "exact_ms": sum(r["exact_ms_fwd"] + r["exact_ms_bwd"] for r in k3_fast_main),
            "exact_bound_ms": sum(r["exact_bound_ms_fwd"] + r["exact_bound_ms_bwd"]
                                  for r in k3_fast_main),
            "l2_warm_ms": sum(r["l2_warm_ms_fwd"] + r["l2_warm_ms_bwd"] for r in k3_fast_main),
            "exact_l2_warm_ms": sum(r["exact_l2_warm_ms_fwd"] + r["exact_l2_warm_ms_bwd"]
                                    for r in k3_fast_main),
            "trace_launches": fast["k3"]["profile"][f"trace[{K3_FAST_NAME}]"]["count"],
            "scan_train_ms_per_batch":
                fast["k3"]["profile"][f"trace[{K3_FAST_NAME}]"]["device_ms"]
                / (fast["k3"]["launches"]["fused_gin_conv_bf16"] / 4),
            "shapes": [{k: r[k] for k in ("case", "G", "S", "F", "E", "E_valid", "ms_fwd",
                                          "ms_bwd", "exact_ms_fwd", "exact_ms_bwd",
                                          "plain_ms_fwd", "plain_ms_bwd", "library_ms_fwd",
                                          "library_ms_bwd", "bound_ms_fwd", "bound_ms_bwd",
                                          "l2_warm_ms_fwd", "l2_warm_ms_bwd", "smem_bytes",
                                          "exact_smem_bytes", "blocks_per_sm")}
                       for r in k3_fast_main],
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
            summary[label]["device_idle_share"] = v["where"]["device_idle_share"]
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
    summary["mesh_nccl_one_rank"] = mesh["nccl"]
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
