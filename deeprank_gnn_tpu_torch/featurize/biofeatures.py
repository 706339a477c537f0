"""Residue depth and half-sphere exposure — from-scratch replacements
for the reference's Biopython/msms wrappers (`tools/BioWrappers.py`).

- **Residue depth** (Chakravarty & Varadarajan 1999): mean distance of
  a residue's atoms to the solvent-accessible surface. The reference
  shells out to the `msms` binary via Biopython
  (`BioWrappers.py:32-70`); here the surface is sampled directly from
  the Shrake-Rupley accessible points, no external binary.
- **Half-sphere exposure** (Hamelryck 2005), CA-based: neighbors'
  CA atoms within 13 A are split by the plane normal to the
  pseudo-CB direction derived from CA(i-1), CA(i), CA(i+1)
  (`BioWrappers.py:72-94` wraps Biopython's HSExposureCA). Returns
  (hse_up, hse_down, angle) triples.

The port's own copy of ``deeprank_gnn_tpu/featurize/biofeatures.py``. The
neighbour queries the JAX package asks of ``cKDTree`` (surface burial,
nearest surface point, CA spheres) run on ``device`` through
:mod:`featurize.geometry` (``cuda`` unless the caller passes ``"cpu"``);
the per-residue vectors and angles stay host numpy, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from deeprank_gnn_tpu_torch.featurize import geometry
from deeprank_gnn_tpu_torch.featurize.pdb import Structure
from deeprank_gnn_tpu_torch.featurize.sasa import (
    PROBE_RADIUS,
    VDW_RADII,
    _fibonacci_sphere,
)

ResKey = Tuple[str, int, str]
# Biopython HSExposureCA default sphere radius (the reference wraps it
# with defaults, `BioWrappers.py:72-94`); 13.0 would overcount ~27%
HSE_RADIUS = 12.0


def get_bio_model(pdbfile):
    """Load a structure (reference `BioWrappers.get_bio_model`,
    `BioWrappers.py:18-29` — there it returns a Biopython model; here
    the parsed :class:`Structure` plays that role)."""
    from deeprank_gnn_tpu_torch.featurize.pdb import read_pdb

    return read_pdb(pdbfile)


def _surface_radii(struct: Structure) -> np.ndarray:
    return np.array(
        [VDW_RADII.get(e, 1.80) for e in struct.element], dtype=np.float64
    ) + PROBE_RADIUS


def surface_points(struct: Structure, n_points: int = 60, device="cuda") -> np.ndarray:
    """Sample the solvent-accessible surface: per-atom sphere points not
    buried in any neighbor sphere (found on ``device``)."""
    return geometry.surface_points(
        struct.xyz, _surface_radii(struct), _fibonacci_sphere(n_points), device
    ).cpu().numpy()


def get_depth_res(struct: Structure, device="cuda") -> Dict[Tuple[str, int], float]:
    """Mean residue-atom distance to the MOLECULAR surface, per
    (chain, resSeq). Sample points lie on the solvent-ACCESSIBLE
    surface (probe centers, vdW + 1.4 A); msms measures to the
    molecular (Connolly) surface the probe SPHERE traces, which sits
    one probe radius closer to the atoms — subtract it. The surface and
    each atom's nearest surface point are found on ``device``."""
    surf = geometry.surface_points(
        struct.xyz, _surface_radii(struct), _fibonacci_sphere(60), device
    )
    dist = geometry.nearest_distance(struct.xyz, surf)
    dist = np.maximum(dist - PROBE_RADIUS, 0.0)
    out: Dict[Tuple[str, int], float] = {}
    for key, idx in struct.residue_atoms().items():
        out[key] = float(dist[idx].mean())
    return out


def get_depth_contact_res(
    struct: Structure, nodes, device="cuda"
) -> Dict[ResKey, float]:
    """Depth restricted to the given contact residues
    (`BioWrappers.py:52-70`)."""
    depth = get_depth_res(struct, device)
    return {n: depth.get((n[0], n[1]), 0.0) for n in nodes}


def _gly_cb_dir(n_vec: np.ndarray, c_vec: np.ndarray) -> np.ndarray:
    """Virtual CB direction for glycine: the N position (relative to
    CA) rotated -120 degrees about the CA->C axis (Biopython
    `_get_gly_cb_vector` construction)."""
    axis = c_vec / (np.linalg.norm(c_vec) + 1e-12)
    theta = -np.pi * 120.0 / 180.0
    ct, st = np.cos(theta), np.sin(theta)
    v = n_vec
    rot = (
        v * ct
        + np.cross(axis, v) * st
        + axis * np.dot(axis, v) * (1.0 - ct)
    )
    return rot


def get_hse(
    struct: Structure, device="cuda"
) -> Dict[Tuple[str, int], Tuple[float, float, float]]:
    """CA-based half-sphere exposure per (chain, resSeq).

    Matches Biopython `HSExposureCA` semantics (the reference wraps it
    with defaults, `BioWrappers.py:72-94`): neighbors are CA atoms
    within 12 A (self excluded), split by the plane normal to the
    pseudo-CB bisector of the two CA-CA bonds; the third component is
    the ANGLE between that pseudo-CB and the residue's real CB
    direction (glycine: Biopython's virtual CB; 0.0 when
    unavailable). The CA spheres (``<=`` the radius, as ``cKDTree``'s
    ``query_ball_point``) are found on ``device`` in one pass."""
    out: Dict[Tuple[str, int], Tuple[float, float, float]] = {}
    ca_mask = struct.name == "CA"
    ca_xyz_all = struct.xyz[ca_mask]
    nb_i, nb_j, _ = geometry.pairs_within(ca_xyz_all, ca_xyz_all, HSE_RADIUS, device)
    if len(ca_xyz_all) == 0:
        return out
    # neighbours of CA k: nb_j[starts[k]:starts[k + 1]] (pairs come sorted)
    starts = np.searchsorted(nb_i, np.arange(len(ca_xyz_all) + 1))
    chains = struct.chain[ca_mask]
    resseqs = struct.resseq[ca_mask]

    # per-residue sidechain/backbone atoms for the pCB-vs-CB angle
    atom_of: Dict[Tuple[str, int, str], np.ndarray] = {}
    for want in ("CB", "N", "C"):
        m = struct.name == want
        for c, q, p in zip(struct.chain[m], struct.resseq[m], struct.xyz[m]):
            atom_of.setdefault((str(c), int(q), want), p)

    for chain in np.unique(chains):
        m = chains == chain
        order = np.argsort(resseqs[m], kind="stable")
        seqs = resseqs[m][order]
        coords = ca_xyz_all[m][order]
        rows = np.flatnonzero(m)[order]  # CA index of each sorted residue
        for i in range(len(seqs)):
            if i == 0 or i == len(seqs) - 1:
                continue
            ca_prev, ca, ca_next = coords[i - 1], coords[i], coords[i + 1]
            d1 = ca - ca_prev
            d2 = ca - ca_next
            n1 = np.linalg.norm(d1)
            n2 = np.linalg.norm(d2)
            if n1 < 1e-6 or n2 < 1e-6:
                continue
            # pseudo-CB: bisector of the two CA->CA bonds, away from
            # the backbone (Biopython `_get_cb`)
            cb_dir = d1 / n1 + d2 / n2
            norm = np.linalg.norm(cb_dir)
            if norm < 1e-6:
                continue
            cb_dir /= norm
            k = rows[i]
            up = down = 0
            for j in nb_j[starts[k] : starts[k + 1]]:
                vec = ca_xyz_all[j] - ca
                if np.linalg.norm(vec) < 1e-6:
                    continue
                if np.dot(vec, cb_dir) > 0:
                    up += 1
                else:
                    down += 1
            key = (str(chain), int(seqs[i]))
            real_cb = atom_of.get((key[0], key[1], "CB"))
            if real_cb is not None:
                v = real_cb - ca
            else:
                n_at = atom_of.get((key[0], key[1], "N"))
                c_at = atom_of.get((key[0], key[1], "C"))
                v = (
                    _gly_cb_dir(n_at - ca, c_at - ca)
                    if n_at is not None and c_at is not None
                    else None
                )
            if v is not None and np.linalg.norm(v) > 1e-6:
                angle = float(
                    np.arccos(
                        np.clip(
                            np.dot(v / np.linalg.norm(v), cb_dir), -1, 1
                        )
                    )
                )
            else:
                angle = 0.0
            out[key] = (float(up), float(down), angle)
    return out
