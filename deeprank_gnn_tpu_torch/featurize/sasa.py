"""Solvent-accessible surface area (SASA) — from-scratch Shrake-Rupley.

Replaces the freesasa C library the reference wraps for its buried-
surface-area node feature (`tools/BSA.py:6,55-117`): the BSA of a
contact residue is SASA(residue in its isolated chain) minus
SASA(residue in the complex) (`BSA.py:96-108`).

Implementation: Shrake & Rupley (1973) — sample each atom's solvent
sphere (vdW radius + 1.4 A probe) with a Fibonacci point set and count
points not buried inside any neighbor's sphere. Radii follow the ProtOr
united-atom set (Tsai, Taylor, Chothia & Gerstein, JMB 1999, Table 2)
classified by (residue, atom name), and hydrogens are excluded from the
calculation — both matching freesasa's default configuration.

The port's own copy of ``deeprank_gnn_tpu/featurize/sasa.py``: the radii
and the Fibonacci sphere are the JAX package's, bit for bit, on the host;
the burial test runs in :func:`featurize.geometry.sasa` on ``device``
(``cuda`` unless the caller passes ``"cpu"``), where the JAX package runs
its C++ kernel or its ``cKDTree`` loop.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from deeprank_gnn_tpu_torch.featurize import geometry
from deeprank_gnn_tpu_torch.featurize.pdb import Structure

# Element-level fallback radii (A) for hetero/unknown atoms.
VDW_RADII = {
    "C": 1.88,
    "N": 1.64,
    "O": 1.42,
    "S": 1.77,
    "P": 1.80,
    "SE": 1.90,
    "FE": 2.00,
    "ZN": 1.39,
    "MG": 1.73,
}
PROBE_RADIUS = 1.4
DEFAULT_N_POINTS = 500

# ProtOr atom classes that deviate from the element default. Trigonal
# carbons (no bonded H) are smaller than tetrahedral ones; aromatic CH
# sits in between; hydroxyl O is slightly larger than carbonyl O.
_C_TRIGONAL = {  # C3H0 -> 1.61 A
    ("ARG", "CZ"), ("ASN", "CG"), ("ASP", "CG"), ("GLN", "CD"),
    ("GLU", "CD"), ("HIS", "CG"), ("PHE", "CG"), ("TRP", "CG"),
    ("TRP", "CD2"), ("TRP", "CE2"), ("TYR", "CG"), ("TYR", "CZ"),
}
_C_AROMATIC_CH = {  # C3H1 -> 1.76 A
    ("HIS", "CD2"), ("HIS", "CE1"),
    ("PHE", "CD1"), ("PHE", "CD2"), ("PHE", "CE1"), ("PHE", "CE2"),
    ("PHE", "CZ"),
    ("TRP", "CD1"), ("TRP", "CE3"), ("TRP", "CZ2"), ("TRP", "CZ3"),
    ("TRP", "CH2"),
    ("TYR", "CD1"), ("TYR", "CD2"), ("TYR", "CE1"), ("TYR", "CE2"),
}
_O_HYDROXYL = {("SER", "OG"), ("THR", "OG1"), ("TYR", "OH")}  # O2H1 -> 1.46


def _protor_radius(resname: str, name: str, element: str) -> float:
    """ProtOr united-atom radius for one heavy atom."""
    if element == "C":
        if name == "C" or (resname, name) in _C_TRIGONAL:
            return 1.61  # backbone carbonyl C / side-chain trigonal C
        if (resname, name) in _C_AROMATIC_CH:
            return 1.76
        return 1.88  # tetrahedral (aliphatic) carbon
    if element == "N":
        return 1.64
    if element == "O":
        return 1.46 if (resname, name) in _O_HYDROXYL else 1.42
    if element == "S":
        return 1.77
    return VDW_RADII.get(element, 1.80)


def atom_radii(struct: Structure) -> np.ndarray:
    """Per-atom ProtOr radii [natoms]; hydrogens get 0 (excluded)."""
    out = np.zeros(struct.natoms, dtype=np.float64)
    for i, (rn, nm, el) in enumerate(
        zip(struct.resname, struct.name, struct.element)
    ):
        if el != "H":
            out[i] = _protor_radius(str(rn), str(nm), str(el))
    return out


# Radii freesasa resolves for atoms named by a SINGLE letter: the
# reference's BSA rebuilds each isolated chain via
# `freesasa.Structure.addAtom('{:>2}'.format(atomName[0]), ...)`
# (reference `tools/BSA.py:77-81`) — truncating every atom name to its
# first character. 'C'/'N'/'O' then classify as the ProtOr *backbone*
# entries, while 'S' and 'H' are unknown names whose radius freesasa
# guesses from the element (plain vdW). The complex, by contrast, is
# read from the PDB file with full names (`BSA.py:61`), so the
# reference's BSA = unbound - complex mixes two radius conventions —
# including hydrogens in the unbound term only. The fixture's bsa
# ground truth (and the paper models' training features) embed this
# behavior, so we reproduce it for parity (quantified in
# tests/test_featurize.py).
_FIRST_LETTER_RADII = {"C": 1.61, "N": 1.64, "O": 1.42, "S": 1.80, "H": 1.10}


def addatom_radii(struct: Structure) -> np.ndarray:
    """Radii for the reference's truncated-name addAtom path
    (`tools/BSA.py:77-81`): first letter of the atom name, hydrogens
    included at their guessed element radius."""
    return np.array(
        [_FIRST_LETTER_RADII.get(str(nm)[0], 1.80) for nm in struct.name],
        dtype=np.float64,
    )


def _fibonacci_sphere(n: int) -> np.ndarray:
    """n quasi-uniform points on the unit sphere."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))  # golden angle
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    theta = phi * i
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=1)


def atom_sasa(
    struct: Structure,
    n_points: int = DEFAULT_N_POINTS,
    radii: "np.ndarray | None" = None,
    device="cuda",
) -> np.ndarray:
    """Per-atom SASA [natoms] in A^2, computed on ``device``.

    With the default radii (``atom_radii``), hydrogens are excluded
    from the computation (zero area, and they bury nothing) —
    freesasa's default. Pass explicit ``radii`` to override the
    classification; atoms with radius 0 are excluded."""
    if radii is None:
        radii = atom_radii(struct)
    keep = radii > 0
    if not keep.all():
        out = np.zeros(struct.natoms, dtype=np.float64)
        out[keep] = atom_sasa(struct.select(keep), n_points, radii[keep], device)
        return out
    return geometry.sasa(
        struct.xyz, radii + PROBE_RADIUS, _fibonacci_sphere(n_points), device
    )


def residue_sasa(
    struct: Structure,
    n_points: int = DEFAULT_N_POINTS,
    radii: "np.ndarray | None" = None,
    device="cuda",
) -> Dict[Tuple[str, int], float]:
    """Per-residue SASA: sum of member atom SASAs."""
    per_atom = atom_sasa(struct, n_points, radii, device)
    out: Dict[Tuple[str, int], float] = {}
    for key, idx in struct.residue_atoms().items():
        out[key] = float(per_atom[idx].sum())
    return out


def buried_surface_area(
    struct: Structure,
    residues,
    n_points: int = DEFAULT_N_POINTS,
    complex_sasa: "Dict | None" = None,
    chain_sasa: "Dict | None" = None,
    device="cuda",
) -> Dict[Tuple[str, int, str], float]:
    """BSA per contact residue: SASA(unbound chain) - SASA(complex)
    (`tools/BSA.py:84-117` semantics).

    Args:
        struct: the full complex.
        residues: iterable of (chain, resSeq, resName) contact residues.
        complex_sasa / chain_sasa: optionally precomputed per-residue
            SASA maps (see :class:`featurize.bsa.BSA`) — SASA dominates
            featurization cost, so callers that already hold them
            shouldn't pay twice.
        device: where the SASA runs.
    """
    if complex_sasa is None:
        complex_sasa = residue_sasa(struct, n_points, device=device)
    if chain_sasa is None:
        chain_sasa = {}
    for chain in sorted(set(r[0] for r in residues)):
        if chain not in chain_sasa:
            # unbound chains use the truncated-name radius convention
            # (reference parity; see addatom_radii)
            sub = struct.select(struct.chain == chain)
            chain_sasa[chain] = residue_sasa(
                sub, n_points, addatom_radii(sub), device
            )
    out = {}
    for res in residues:
        key = (res[0], res[1])
        asa_unbound = chain_sasa[res[0]].get(key, 0.0)
        asa_complex = complex_sasa.get(key, 0.0)
        out[res] = asa_unbound - asa_complex
    return out
