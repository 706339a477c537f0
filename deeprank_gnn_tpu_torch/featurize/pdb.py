"""Minimal vectorized PDB parser (replaces pdb2sql's SQLite layer).

The reference queries atoms through pdb2sql (`ResidueGraph.py:75`,
`Graph.py:35`) — a SQLite database built per structure. For an offline
featurizer that is pure overhead; here a PDB file parses directly into
column numpy arrays and every downstream query (per-residue slices,
chain splits, coordinate lookups) is an index operation.

The port's own copy of ``deeprank_gnn_tpu/featurize/pdb.py``: parsing
stays on the host; the geometry on these columns runs in
:mod:`deeprank_gnn_tpu_torch.featurize.geometry`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Structure:
    """Column-oriented atom table for one PDB model."""

    name: np.ndarray  # [n] <U4 atom names
    resname: np.ndarray  # [n] <U3
    resseq: np.ndarray  # [n] int32
    chain: np.ndarray  # [n] <U1
    xyz: np.ndarray  # [n, 3] float64
    element: np.ndarray  # [n] <U2
    altloc: np.ndarray  # [n] <U1
    occupancy: np.ndarray  # [n] float32
    temp: np.ndarray  # [n] float32

    @property
    def natoms(self) -> int:
        return self.name.shape[0]

    def select(self, mask: np.ndarray) -> "Structure":
        return Structure(
            name=self.name[mask],
            resname=self.resname[mask],
            resseq=self.resseq[mask],
            chain=self.chain[mask],
            xyz=self.xyz[mask],
            element=self.element[mask],
            altloc=self.altloc[mask],
            occupancy=self.occupancy[mask],
            temp=self.temp[mask],
        )

    def chain_mask(self, chain_id: str) -> np.ndarray:
        return self.chain == chain_id

    def residues(self) -> List[Tuple[str, int, str]]:
        """Unique residues in file order: (chain, resSeq, resName)."""
        seen = {}
        for c, s, r in zip(self.chain, self.resseq, self.resname):
            key = (str(c), int(s), str(r))
            if key not in seen:
                seen[key] = None
        return list(seen.keys())

    def residue_atoms(self) -> Dict[Tuple[str, int], np.ndarray]:
        """Map (chain, resSeq) -> atom index array, in file order."""
        out: Dict[Tuple[str, int], List[int]] = {}
        for i, (c, s) in enumerate(zip(self.chain, self.resseq)):
            out.setdefault((str(c), int(s)), []).append(i)
        return {k: np.array(v, dtype=np.int64) for k, v in out.items()}

    def backbone_mask(self) -> np.ndarray:
        return np.isin(self.name, ("CA", "C", "N", "O"))

    def heavy_mask(self) -> np.ndarray:
        return self.element != "H"


def _guess_element(name: str) -> str:
    """Element from the atom-name column when cols 77-78 are blank
    (HADDOCK models)."""
    stripped = name.strip()
    if not stripped:
        return ""
    # 4-char names starting with H (e.g. 'HG12', '1HB') are hydrogens
    if stripped[0].isdigit():
        stripped = stripped[1:]
    if stripped[:2] in ("FE", "ZN", "MG", "CA2", "NA", "CL", "MN", "CU"):
        # disambiguate CA (calcium) vs CA (C-alpha): inside a residue the
        # name 'CA' is carbon-alpha; standalone ions appear in HETATM
        pass
    return stripped[0]


def read_pdb(path_or_lines, model: int = 1) -> Structure:
    """Parse ATOM/HETATM records (fixed-column PDB format)."""
    if isinstance(path_or_lines, (list, tuple)):
        lines = path_or_lines
    else:
        with open(path_or_lines, "r") as f:
            lines = f.readlines()

    names, resnames, resseqs, chains = [], [], [], []
    xyzs, elements, altlocs, occs, temps = [], [], [], [], []
    current_model = 0
    in_target_model = True
    for line in lines:
        rec = line[:6]
        if rec.startswith("MODEL"):
            current_model += 1
            in_target_model = current_model == model
            continue
        if rec.startswith("ENDMDL"):
            in_target_model = current_model + 1 == model or current_model < model
            continue
        if not in_target_model:
            continue
        if not (rec == "ATOM  " or rec == "HETATM"):
            continue
        name = line[12:16].strip()
        altloc = line[16:17].strip()
        resname = line[17:20].strip()
        chain = line[21:22].strip()
        try:
            resseq = int(line[22:26])
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
        except ValueError:
            continue
        occ_s = line[54:60].strip()
        tmp_s = line[60:66].strip()
        elem = line[76:78].strip() if len(line) > 76 else ""
        if not elem:
            elem = _guess_element(line[12:16])
        names.append(name)
        altlocs.append(altloc)
        resnames.append(resname)
        chains.append(chain)
        resseqs.append(resseq)
        xyzs.append((x, y, z))
        occs.append(float(occ_s) if occ_s else 1.0)
        temps.append(float(tmp_s) if tmp_s else 0.0)
        elements.append(elem.upper())

    if not names:
        raise ValueError(f"no ATOM records parsed from {path_or_lines!r}")
    return Structure(
        name=np.array(names, dtype="<U4"),
        resname=np.array(resnames, dtype="<U3"),
        resseq=np.array(resseqs, dtype=np.int32),
        chain=np.array(chains, dtype="<U1"),
        xyz=np.array(xyzs, dtype=np.float64),
        element=np.array(elements, dtype="<U2"),
        altloc=np.array(altlocs, dtype="<U1"),
        occupancy=np.array(occs, dtype=np.float32),
        temp=np.array(temps, dtype=np.float32),
    )


def write_pdb(struct: Structure, path: str) -> None:
    """Write a Structure back to a minimal PDB file (for tests/tools)."""
    with open(path, "w") as f:
        for i in range(struct.natoms):
            name = struct.name[i]
            pad_name = f" {name:<3s}" if len(name) < 4 else name
            f.write(
                f"ATOM  {i + 1:5d} {pad_name:<4s}{'':1s}{struct.resname[i]:>3s} "
                f"{struct.chain[i]:1s}{struct.resseq[i]:4d}    "
                f"{struct.xyz[i, 0]:8.3f}{struct.xyz[i, 1]:8.3f}"
                f"{struct.xyz[i, 2]:8.3f}{struct.occupancy[i]:6.2f}"
                f"{struct.temp[i]:6.2f}          {struct.element[i]:>2s}\n"
            )
        f.write("END\n")
