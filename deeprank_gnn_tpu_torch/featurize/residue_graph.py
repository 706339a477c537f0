"""Residue interface graph featurizer (reference `ResidueGraph.py`).

PDB -> interface graph with the reference's exact feature set:

- nodes: chain-A contact residues (file order) + sorted chain-B contact
  residues, filtered to valid residue types present in the PSSM
  (`ResidueGraph.py:147-205`);
- interface edges (< 8.5 A, min atom distance) and per-chain internal
  edges (< 3 A) (`ResidueGraph.py:108-145, 272-316`);
- node features: chain{0,1}, pos (mean atom xyz), type (one-hot 20),
  charge, polarity (one-hot 4), bsa, pssm (20), cons, ic, and optional
  biopython-style depth/hse (`ResidueGraph.py:207-260`).

The port's own copy of ``deeprank_gnn_tpu/featurize/residue_graph.py``:
the node filter, node features and edge features are the JAX package's;
the contact search and the SASA run on ``device`` (``cuda`` unless the
caller passes ``"cpu"``), the per-residue dicts on the host.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeprank_gnn_tpu_torch.device import resolve_device
from deeprank_gnn_tpu_torch.featurize import pssm as pssm_mod
from deeprank_gnn_tpu_torch.featurize.contacts import (
    get_contact_residues,
    get_internal_edges,
    residue_centers,
)
from deeprank_gnn_tpu_torch.featurize.graph import Graph
from deeprank_gnn_tpu_torch.featurize.pdb import Structure, read_pdb
from deeprank_gnn_tpu_torch.featurize.sasa import buried_surface_area

RESIDUE_CHARGE = {
    "CYS": -0.64, "HIS": -0.29, "ASN": -1.22, "GLN": -1.22, "SER": -0.80,
    "THR": -0.80, "TYR": -0.80, "TRP": -0.79, "ALA": -0.37, "PHE": -0.37,
    "GLY": -0.37, "ILE": -0.37, "VAL": -0.37, "MET": -0.37, "PRO": 0.0,
    "LEU": -0.37, "GLU": -1.37, "ASP": -1.37, "LYS": -0.36, "ARG": -1.65,
}
RESIDUE_NAMES = {
    "CYS": 0, "HIS": 1, "ASN": 2, "GLN": 3, "SER": 4, "THR": 5, "TYR": 6,
    "TRP": 7, "ALA": 8, "PHE": 9, "GLY": 10, "ILE": 11, "VAL": 12,
    "MET": 13, "PRO": 14, "LEU": 15, "GLU": 16, "ASP": 17, "LYS": 18,
    "ARG": 19,
}
RESIDUE_POLARITY = {
    "CYS": "polar", "HIS": "polar", "ASN": "polar", "GLN": "polar",
    "SER": "polar", "THR": "polar", "TYR": "polar", "TRP": "polar",
    "ALA": "apolar", "PHE": "apolar", "GLY": "apolar", "ILE": "apolar",
    "VAL": "apolar", "MET": "apolar", "PRO": "apolar", "LEU": "apolar",
    "GLU": "neg_charged", "ASP": "neg_charged", "LYS": "neg_charged",
    "ARG": "pos_charged",
}
PSSM_POS = {
    "CYS": 4, "HIS": 8, "ASN": 2, "GLN": 5, "SER": 15, "THR": 16,
    "TYR": 18, "TRP": 17, "ALA": 0, "PHE": 13, "GLY": 7, "ILE": 9,
    "VAL": 19, "MET": 12, "PRO": 14, "LEU": 10, "GLU": 6, "ASP": 3,
    "LYS": 11, "ARG": 1,
}
POLARITY_ENCODING = {"apolar": 0, "polar": 1, "neg_charged": 2, "pos_charged": 3}
VALID_RES = (
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLU", "GLN", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "ASX", "SEC", "GLX",
)


def parse_inputs(pdb: str, pssm: Optional[Dict[str, str]], pssm_align: str = "res"):
    """``(structure, pssm, ic)`` of one model: the parsed PDB and, with
    ``pssm`` files, their tables (else None, None). Host only."""
    tables = (None, None) if pssm is None else pssm_mod.pssm_aligned(pssm, style=pssm_align)
    return (read_pdb(pdb), *tables)


def _onehot(idx: int, size: int) -> np.ndarray:
    v = np.zeros(size, dtype=np.float64)
    v[idx] = 1.0
    return v


class ResidueGraph(Graph):
    def __init__(
        self,
        pdb: Optional[str] = None,
        pssm: Optional[Dict[str, str]] = None,
        contact_distance: float = 8.5,
        internal_contact_distance: float = 3.0,
        pssm_align: str = "res",
        biopython: bool = False,
        device="cuda",
        parsed: Optional[Tuple[Structure, Optional[Dict], Optional[Dict]]] = None,
    ):
        """``parsed``: ``(structure, pssm, ic)`` already read from ``pdb``
        and ``pssm`` (``featurize.graphgen``'s workers parse, the geometry
        runs here); else they are read here."""
        super().__init__(resolve_device(device))
        self.type = "residue"
        self.pdb = pdb
        self.name = os.path.splitext(os.path.basename(pdb))[0]
        self.contact_distance = contact_distance
        self.internal_contact_distance = internal_contact_distance
        self.biopython = biopython
        self.struct, self.pssm, self.ic = parsed or parse_inputs(pdb, pssm, pssm_align)
        self._build_graph()
        self._build_node_features()

    # ------------------------------------------------------------------
    def _valid_nodes(self, pairs):
        """Node list: chain-A keys + sorted chain-B contacts, filtered
        (reference `_get_all_valid_nodes`, `ResidueGraph.py:147-205`)."""
        def ok(res):
            # RESIDUE_NAMES (not VALID_RES) gates eligibility: VALID_RES
            # also lists ASX/SEC/GLX, which have no feature encodings —
            # admitting them would KeyError in _build_node_features for
            # PSSM-less PDBs (with a PSSM they are filtered out anyway
            # because PSSM files only cover the 20 standard residues)
            if res[2] not in RESIDUE_NAMES:
                return False
            if self.pssm is not None and res not in self.pssm:
                return False
            return True

        keys_a = [k for k in pairs if ok(k)]
        nodes_b = sorted(
            {v for k in keys_a for v in pairs[k] if ok(v)}
        )
        return keys_a + nodes_b

    def _build_graph(self) -> None:
        pairs, distances = get_contact_residues(
            self.struct, cutoff=self.contact_distance, device=self.device
        )
        all_nodes = self._valid_nodes(pairs)
        node_set = set(all_nodes)

        self.nodes = list(all_nodes)
        self.edge_data = {"dist": [], "type": []}
        seen = set()
        for key, vals in pairs.items():
            if key not in node_set:
                print(f"WARNING: {key} is not a valid node")
                continue
            for v in vals:
                if v not in node_set:
                    print(f"WARNING: {v} is not a valid node")
                    continue
                ek = (key, v)
                if ek in seen:
                    continue
                seen.add(ek)
                self.edges.append(ek)
                self.edge_data["dist"].append(distances[(key, v)])
                self.edge_data["type"].append(b"interface")

        internal_edges, internal_dists = get_internal_edges(
            self.struct, self.nodes, self.internal_contact_distance, self.device
        )
        for e, d in zip(internal_edges, internal_dists):
            self.edges.append(e)
            self.edge_data["dist"].append(d)
            self.edge_data["type"].append(b"internal")

    # ------------------------------------------------------------------
    def _build_node_features(self) -> None:
        bsa = buried_surface_area(self.struct, self.nodes, device=self.device)
        centers = residue_centers(self.struct)

        if self.biopython:
            from deeprank_gnn_tpu_torch.featurize.biofeatures import (
                get_depth_contact_res,
                get_hse,
            )

            depth = get_depth_contact_res(self.struct, self.nodes, self.device)
            hse = get_hse(self.struct, self.device)
        feats: Dict[str, list] = {
            "chain": [], "pos": [], "type": [], "charge": [], "polarity": [],
            "bsa": [],
        }
        if self.pssm is not None:
            feats.update({"pssm": [], "cons": [], "ic": []})
        if self.biopython:
            feats.update({"depth": [], "hse": []})

        for node in self.nodes:
            chain_id, resseq, resname = node
            feats["chain"].append({"A": 0, "B": 1}[chain_id])
            feats["pos"].append(centers[(chain_id, resseq)])
            feats["type"].append(_onehot(RESIDUE_NAMES[resname], 20))
            feats["charge"].append(RESIDUE_CHARGE[resname])
            feats["polarity"].append(
                _onehot(POLARITY_ENCODING[RESIDUE_POLARITY[resname]], 4)
            )
            feats["bsa"].append([bsa[node]])
            if self.pssm is not None:
                data = pssm_mod.get_pssm_data(node, self.pssm)
                feats["pssm"].append(data)
                feats["cons"].append(data[PSSM_POS[resname]])
                feats["ic"].append(pssm_mod.get_ic_data(node, self.ic))
            if self.biopython:
                feats["depth"].append(depth.get(node, 0.0))
                feats["hse"].append(hse.get((chain_id, resseq), (0.0, 0.0, 0.0)))

        self.node_data = feats
