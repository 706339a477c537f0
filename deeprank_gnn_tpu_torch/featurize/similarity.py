"""Docking-model quality scores: lrmsd, irmsd, fnat, DockQ.

Replaces pdb2sql's `StructureSimilarity` (used at reference
`Graph.py:27-59` to label every graph with its targets). Definitions
follow the CAPRI criteria / DockQ paper (Basu & Wallner 2016), which
pdb2sql implements:

- **lrmsd**: superpose the decoy onto the reference on the RECEPTOR
  backbone (receptor = chain with more atoms), then backbone RMSD of
  the ligand chain.
- **irmsd**: interface residues = reference residue pairs across the
  chains with any heavy-atom pair within 10 A; superpose on their
  backbone atoms, RMSD over the same set.
- **fnat**: fraction of reference residue-residue contacts (heavy
  atoms within 5 A) present in the decoy.
- **DockQ** = (fnat + 1/(1+(irmsd/1.5)^2) + 1/(1+(lrmsd/8.5)^2)) / 3.

Superposition via Kabsch SVD. Atom correspondence is by
(chain, resSeq, atom name); atoms missing from either structure are
dropped from the fit.

The port's own copy of ``deeprank_gnn_tpu/featurize/similarity.py``: the
3x3 SVDs stay on the host in numpy float64; the contact sets come from
:func:`featurize.geometry.contact_pairs` on ``device`` (``cuda`` unless
the caller passes ``"cpu"``), with ``cKDTree``'s bound, ``<=`` the cutoff.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from deeprank_gnn_tpu_torch.featurize import geometry
from deeprank_gnn_tpu_torch.featurize.pdb import Structure, read_pdb

BACKBONE = ("CA", "C", "N", "O")


def kabsch(p: np.ndarray, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal rotation R and translation t minimizing |R p + t - q|."""
    pc, qc = p.mean(axis=0), q.mean(axis=0)
    p0, q0 = p - pc, q - qc
    h = p0.T @ q0
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    diag = np.diag([1.0, 1.0, d])
    r = vt.T @ diag @ u.T
    t = qc - r @ pc
    return r, t


def _rmsd(p: np.ndarray, q: np.ndarray) -> float:
    return float(np.sqrt(((p - q) ** 2).sum(axis=1).mean()))


def superposed_rmsd(p: np.ndarray, q: np.ndarray) -> float:
    r, t = kabsch(p, q)
    return _rmsd(p @ r.T + t, q)


def _atom_map(struct: Structure, backbone_only: bool = True) -> Dict:
    out = {}
    for i in range(struct.natoms):
        if backbone_only and struct.name[i] not in BACKBONE:
            continue
        if struct.element[i] == "H":
            continue
        out[(str(struct.chain[i]), int(struct.resseq[i]), str(struct.name[i]))] = i
    return out


def _matched_coords(
    decoy: Structure, ref: Structure, keys
) -> Tuple[np.ndarray, np.ndarray]:
    dmap = _atom_map(decoy)
    rmap = _atom_map(ref)
    dsel, rsel = [], []
    for k in keys:
        if k in dmap and k in rmap:
            dsel.append(dmap[k])
            rsel.append(rmap[k])
    return decoy.xyz[dsel], ref.xyz[rsel]


def _residue_contacts(
    struct: Structure, cutoff: float, chain_a: str, chain_b: str, device="cuda"
):
    """Set of (resSeq_a, resSeq_b) with any heavy-atom pair within
    cutoff (``<=``, as ``cKDTree``'s pair query)."""
    heavy = struct.element != "H"
    ma = heavy & (struct.chain == chain_a)
    mb = heavy & (struct.chain == chain_b)
    ra, rb, _ = geometry.contact_pairs(
        struct.xyz[ma], struct.resseq[ma], struct.xyz[mb], struct.resseq[mb],
        cutoff, device,
    )
    return set(zip(ra.tolist(), rb.tolist()))


class StructureSimilarity:
    """API-compatible scorer (reference usage `Graph.py:35-53`)."""

    def __init__(self, decoy, ref, chain_a: str = "A", chain_b: str = "B",
                 device="cuda"):
        self.device = device
        self.decoy = decoy if isinstance(decoy, Structure) else read_pdb(decoy)
        self.ref = ref if isinstance(ref, Structure) else read_pdb(ref)
        self.chain_a = chain_a
        self.chain_b = chain_b
        na = (self.ref.chain == chain_a).sum()
        nb = (self.ref.chain == chain_b).sum()
        self.receptor = chain_a if na >= nb else chain_b
        self.ligand = chain_b if self.receptor == chain_a else chain_a

    # -- lrmsd ----------------------------------------------------------
    def compute_lrmsd_fast(self, method: str = "svd", lzone=None) -> float:
        rec_keys = [
            k for k in _atom_map(self.ref) if k[0] == self.receptor
        ]
        lig_keys = [k for k in _atom_map(self.ref) if k[0] == self.ligand]
        drec, rrec = _matched_coords(self.decoy, self.ref, rec_keys)
        dlig, rlig = _matched_coords(self.decoy, self.ref, lig_keys)
        if len(drec) < 3 or len(dlig) == 0:
            return float("nan")
        r, t = kabsch(drec, rrec)
        return _rmsd(dlig @ r.T + t, rlig)

    # -- irmsd ----------------------------------------------------------
    def compute_irmsd_fast(
        self, method: str = "svd", izone=None, cutoff: float = 10.0
    ) -> float:
        contacts = _residue_contacts(
            self.ref, cutoff, self.chain_a, self.chain_b, self.device
        )
        res_a = {a for a, _ in contacts}
        res_b = {b for _, b in contacts}
        keys = [
            k
            for k in _atom_map(self.ref)
            if (k[0] == self.chain_a and k[1] in res_a)
            or (k[0] == self.chain_b and k[1] in res_b)
        ]
        d, r = _matched_coords(self.decoy, self.ref, keys)
        if len(d) < 3:
            return float("nan")
        return superposed_rmsd(d, r)

    # -- fnat -----------------------------------------------------------
    def compute_fnat_fast(self, cutoff: float = 5.0) -> float:
        native = _residue_contacts(
            self.ref, cutoff, self.chain_a, self.chain_b, self.device
        )
        if not native:
            return float("nan")
        decoy = _residue_contacts(
            self.decoy, cutoff, self.chain_a, self.chain_b, self.device
        )
        return len(native & decoy) / len(native)

    # -- DockQ ----------------------------------------------------------
    @staticmethod
    def compute_DockQScore(
        fnat: float, lrmsd: float, irmsd: float, d1: float = 8.5, d2: float = 1.5
    ) -> float:
        def scale(rms, d):
            return 1.0 / (1.0 + (rms / d) ** 2)

        return (fnat + scale(lrmsd, d1) + scale(irmsd, d2)) / 3.0


def compute_all_scores(decoy, ref, device="cuda") -> Dict[str, float]:
    """All graph-level targets (reference `Graph.get_score`,
    `Graph.py:27-59`); the contact sets are found on ``device``."""
    sim = StructureSimilarity(decoy, ref, device=device)
    lrmsd = sim.compute_lrmsd_fast()
    irmsd = sim.compute_irmsd_fast()
    fnat = sim.compute_fnat_fast()
    dockq = sim.compute_DockQScore(fnat, lrmsd, irmsd)
    capri = 5
    for thr, val in zip([6.0, 4.0, 2.0, 1.0], [4, 3, 2, 1]):
        if irmsd < thr:
            capri = val
    return {
        "irmsd": irmsd,
        "lrmsd": lrmsd,
        "fnat": fnat,
        "dockQ": dockq,
        "bin_class": bool(irmsd < 4.0),
        "capri_class": capri,
    }
