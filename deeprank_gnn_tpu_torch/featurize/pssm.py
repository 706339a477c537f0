"""PSSM file parsing (reference `tools/PSSM.py`).

Format: whitespace table; data rows start with a digit. Columns 4:24
hold the 20 substitution scores, column 24 the information content
(`tools/PSSM.py:36-37`). Two alignment styles: 'res' uses pdb
numbering (cols 0/1), 'seq' uses sequence numbering (cols 2/3)
(`tools/PSSM.py:30-35`). Missing nodes zero-fill (`tools/PSSM.py:41-45`).

The port's own copy of ``deeprank_gnn_tpu/featurize/pssm.py`` (host
Python).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

RESMAP = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "E": "GLU", "Q": "GLN", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
    "B": "ASX", "U": "SEC", "Z": "GLX",
}

ResKey = Tuple[str, int, str]


def read_pssm_rows(fname: str) -> List[List[str]]:
    with open(fname, "r") as f:
        rows = []
        for line in f:
            parts = line.split()
            if parts and parts[0].isdigit():
                rows.append(parts)
    return rows


def pssm_aligned(
    pssm_files: Dict[str, str], style: str = "res"
) -> Tuple[Dict[ResKey, List[float]], Dict[ResKey, float]]:
    """Parse per-chain PSSM files keyed 'A'/'B' into
    (pssm[(chain, resi, resn)] -> 20 scores, ic[...] -> float)."""
    pssm: Dict[ResKey, List[float]] = {}
    ic: Dict[ResKey, float] = {}
    for chain in ("A", "B"):
        for row in read_pssm_rows(pssm_files[chain]):
            if style == "res":
                resi, resn = int(row[0]), RESMAP[row[1]]
            elif style == "seq":
                resi, resn = int(row[2]), RESMAP[row[3]]
            else:
                raise ValueError(f"unknown pssm style {style!r}")
            key = (chain, resi, resn)
            pssm[key] = [float(v) for v in row[4:24]]
            ic[key] = float(row[24])
    return pssm, ic


def get_pssm_data(node: ResKey, pssm: Dict[ResKey, List[float]]):
    return pssm[node] if node in pssm else [0.0] * 20


def get_ic_data(node: ResKey, ic: Dict[ResKey, float]) -> float:
    return ic[node] if node in ic else 0.0
