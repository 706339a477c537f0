"""The featurizer's geometry as torch on an explicit device, in float64.

The port's counterpart of ``deeprank_gnn_tpu/native.py`` and
``native/fastpath.cpp``, which the JAX package runs on the host (C++
through ctypes, else ``cKDTree`` and numpy). The port neither builds nor
loads that library: every function here runs on ``device`` (``cuda``
unless the caller passes ``"cpu"``), takes host numpy arrays and returns
host numpy arrays, moving each result to the host once.

- Neighbour search is a chunked all-pairs pass: squared distances
  ``d² = dx*dx + dy*dy + dz*dz`` as three separate products and two adds
  in float64 (``fastpath.cpp:99-104, 116``; no ``torch.cdist``, whose
  matrix form rounds differently), then a mask. A chunk of rows is sized
  so that one ``[rows, cols]`` float64 intermediate stays within
  ``CHUNK_BYTES`` / 8 (32 MiB; a pass holds about eight), so no
  intermediate grows past a few hundred MB at 10,000 atoms.
- Reductions are deterministic and use no float atomics: ``amin`` over
  residue-pair keys (an order-free min), ``torch.unique`` (a sort), integer
  counts; everything runs under ``torch.use_deterministic_algorithms``.
- Bounds and operators are the JAX package's: ``<=`` for contacts
  (``fastpath.cpp:135``, as ``cKDTree``'s pair queries), ``<`` for SASA
  burial (``fastpath.cpp:117``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from deeprank_gnn_tpu_torch.device import deterministic, resolve_device

# budget of one pass's intermediates; rows per chunk follow from it
CHUNK_BYTES = 256 << 20
# live float64 intermediates of one [rows, cols] (or [rows, P, K]) pass
_LIVE = 8


def _f64(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=dev)


def _rows_per_chunk(cols: int) -> int:
    return max(1, CHUNK_BYTES // (_LIVE * 8 * max(cols, 1)))


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[m, n]`` squared distances of ``a [m, 3]`` and ``b [n, 3]``, summed
    x, y, z in that order as the C++ and numpy paths do."""
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    dz = a[:, None, 2] - b[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _pairs_within(a: torch.Tensor, b: torch.Tensor, cutoff: float):
    """Every ``(i, j)`` with ``d²(a[i], b[j]) <= cutoff²``, in ``(i, j)``
    order, and its ``d²``; on the tensors' device."""
    c2 = cutoff * cutoff
    rows, cols, d2s = [], [], []
    step = _rows_per_chunk(b.shape[0])
    for lo in range(0, a.shape[0], step):
        d2 = _sq_dist(a[lo : lo + step], b)
        i, j = (d2 <= c2).nonzero(as_tuple=True)
        rows.append(i + lo)
        cols.append(j)
        d2s.append(d2[i, j])
    return torch.cat(rows), torch.cat(cols), torch.cat(d2s)


def pairs_within(
    xyz_a: np.ndarray, xyz_b: np.ndarray, cutoff: float, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Atom pairs within ``cutoff`` (``<=``, as ``cKDTree``'s
    ``sparse_distance_matrix`` and ``query_ball_point``): ``(i, j, dist)``
    sorted by ``(i, j)``, ``dist = sqrt(d²)``."""
    dev = resolve_device(device)
    if len(xyz_a) == 0 or len(xyz_b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
    with deterministic():
        i, j, d2 = _pairs_within(_f64(xyz_a, dev), _f64(xyz_b, dev), cutoff)
        return i.cpu().numpy(), j.cpu().numpy(), torch.sqrt(d2).cpu().numpy()


def contact_pairs(
    xyz_a: np.ndarray,
    rid_a: np.ndarray,
    xyz_b: np.ndarray,
    rid_b: np.ndarray,
    cutoff: float,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Residue contact pairs: the minimum atom–atom distance per
    ``(rid_a, rid_b)`` pair with an atom pair within ``cutoff`` (``<=``).
    Returns ``(res_a, res_b, dist)`` sorted by ``(res_a, res_b)``, the
    JAX package's ``contact_pairs_native`` (``native.py:98``)."""
    dev = resolve_device(device)
    if len(xyz_a) == 0 or len(xyz_b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
    rid_a = np.asarray(rid_a, dtype=np.int64)
    rid_b = np.asarray(rid_b, dtype=np.int64)
    lo_a, lo_b = int(rid_a.min()), int(rid_b.min())
    span = int(rid_b.max()) - lo_b + 1
    with deterministic():
        i, j, d2 = _pairs_within(_f64(xyz_a, dev), _f64(xyz_b, dev), cutoff)
        ra = torch.as_tensor(rid_a - lo_a, device=dev)[i]
        rb = torch.as_tensor(rid_b - lo_b, device=dev)[j]
        keys, inv = torch.unique(ra * span + rb, sorted=True, return_inverse=True)
        best = torch.full(keys.shape, math.inf, dtype=torch.float64, device=dev)
        best.scatter_reduce_(0, inv, d2, reduce="amin", include_self=True)
        keys = keys.cpu().numpy()
        dist = torch.sqrt(best).cpu().numpy()
    return keys // span + lo_a, keys % span + lo_b, dist


def coalesce_pairs(
    src: np.ndarray, dst: np.ndarray, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique ``(src, dst)`` pairs in sorted order and the inverse map,
    int32 (the JAX package's ``coalesce_pairs_native``, ``native.py:135``)."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size == 0:
        empty = np.zeros(0, np.int32)
        return empty, empty.copy(), empty.copy()
    with deterministic():
        key = torch.as_tensor((src << 32) | (dst & 0xFFFFFFFF), device=dev)
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        uniq, inv = uniq.cpu().numpy(), inv.cpu().numpy()
    return ((uniq >> 32).astype(np.int32), (uniq & 0xFFFFFFFF).astype(np.int32),
            inv.astype(np.int32))


def _neighbour_table(xyz: torch.Tensor, radii: torch.Tensor):
    """``[N, K]`` indices of each atom's neighbours ``j != i`` with
    ``d² < (r_i + r_j)²`` (``fastpath.cpp:99-105``), padded with ``N``, and
    ``[N]`` their counts."""
    n = xyz.shape[0]
    rows, cols = [], []
    step = _rows_per_chunk(n)
    for lo in range(0, n, step):
        r = radii[lo : lo + step]
        rr = r[:, None] + radii[None, :]
        near = _sq_dist(xyz[lo : lo + step], xyz) < rr * rr
        own = torch.arange(lo, lo + r.shape[0], device=xyz.device)
        near[own - lo, own] = False
        i, j = near.nonzero(as_tuple=True)
        rows.append(i + lo)
        cols.append(j)
    rows, cols = torch.cat(rows), torch.cat(cols)
    counts = torch.bincount(rows, minlength=n)
    k = int(counts.max()) if rows.numel() else 0
    start = torch.cumsum(counts, 0) - counts
    table = torch.full((n, max(k, 1)), n, dtype=torch.int64, device=xyz.device)
    table[rows, torch.arange(rows.numel(), device=xyz.device) - start[rows]] = cols
    return table, counts


def buried_points(xyz: torch.Tensor, radii: torch.Tensor, sphere: torch.Tensor) -> torch.Tensor:
    """``[N, P]`` bool: point ``p`` of atom ``i``'s sphere,
    ``xyz[i] + radii[i] * sphere[p]``, lies strictly inside a neighbour's
    sphere (``d² < r_j²``). Atoms go in chunks, ordered by their number of
    neighbours so that each chunk pads its neighbour lists only to its own
    longest; one ``[atoms, P, K]`` intermediate stays within
    ``CHUNK_BYTES`` / 8."""
    n, p = xyz.shape[0], sphere.shape[0]
    table, counts = _neighbour_table(xyz, radii)
    order = torch.argsort(counts, stable=True)
    step = _rows_per_chunk(p * table.shape[1])
    bounds = list(range(0, n, step))
    widths = counts[order][[min(lo + step, n) - 1 for lo in bounds]].tolist()
    # the chunks run over the atoms in that order, then the rows go back
    xyz_s, r_s, table_s = xyz[order], radii[order, None], table[order]
    # the pad neighbour sits at the origin with r² = -1: it buries nothing
    pad = torch.zeros((1, 3), dtype=xyz.dtype, device=xyz.device)
    nxyz = torch.cat([xyz, pad])
    nr2 = torch.cat([radii * radii, radii.new_full((1,), -1.0)])
    out = torch.empty((n, p), dtype=torch.bool, device=xyz.device)
    for lo, k in zip(bounds, widths):
        hi = min(n, lo + step)
        nb = table_s[lo:hi, : max(k, 1)]
        d2 = None
        for c in range(3):
            pc = xyz_s[lo:hi, c, None] + r_s[lo:hi] * sphere[None, :, c]  # [C, P]
            dc = pc[:, :, None] - nxyz[nb, c][:, None, :]  # [C, P, K]
            d2 = dc * dc if d2 is None else d2 + dc * dc
        out[lo:hi] = (d2 < nr2[nb][:, None, :]).any(-1)
    buried = torch.empty_like(out)
    buried[order] = out
    return buried


def sasa(
    xyz: np.ndarray, radii: np.ndarray, sphere: np.ndarray, device="cuda"
) -> np.ndarray:
    """Shrake–Rupley SASA per atom, ``4π r² × accessible / P`` with the
    probe-inflated ``radii`` and the unit-sphere points ``sphere [P, 3]``
    (``fastpath.cpp`` ``sasa_compute``). The counts come to the host once;
    the area is taken there with the JAX package's numpy expression."""
    dev = resolve_device(device)
    radii = np.asarray(radii, dtype=np.float64)
    if len(radii) == 0:
        return np.zeros(0)
    with deterministic():
        buried = buried_points(_f64(xyz, dev), _f64(radii, dev), _f64(sphere, dev))
        accessible = (~buried).sum(1).cpu().numpy()
    return 4.0 * np.pi * radii ** 2 * accessible / len(sphere)


def surface_points(
    xyz: np.ndarray, radii: np.ndarray, sphere: np.ndarray, device="cuda"
) -> torch.Tensor:
    """The accessible sphere points, atom by atom and point by point in
    order, as a ``[M, 3]`` tensor on ``device``."""
    dev = resolve_device(device)
    with deterministic():
        xyz_t, r_t, s_t = _f64(xyz, dev), _f64(radii, dev), _f64(sphere, dev)
        keep = ~buried_points(xyz_t, r_t, s_t)
        pts = xyz_t[:, None, :] + r_t[:, None, None] * s_t[None, :, :]
        return pts[keep]


def nearest_distance(queries: np.ndarray, points: torch.Tensor) -> np.ndarray:
    """Distance from each query point to its nearest point of ``points``
    (a tensor on the device it runs on), as ``cKDTree.query`` gives it."""
    q = _f64(queries, points.device)
    out = []
    step = _rows_per_chunk(points.shape[0])
    with deterministic():
        for lo in range(0, q.shape[0], step):
            out.append(_sq_dist(q[lo : lo + step], points).amin(1))
        return torch.sqrt(torch.cat(out)).cpu().numpy()
