"""Atom-level interface graph featurizer (capability extension).

The reference framework is residue-only (`ResidueGraph.py`; its
`GraphGenMP.py:24` accepts a ``graph_type`` argument but implements
only ``'residue'``). This module extends the family with atomic
resolution: nodes are the interface's heavy atoms, edges are atom-atom
contacts. Everything downstream — the HDF5 schema (`featurize/graph.py`),
clustering/PreCluster, `HDF5DataSet`, the loaders, device store and all
three models — is feature-name driven and works on atomic graphs
unchanged, so the whole TPU training stack (padded dense batches,
precomputed operators, scanned epochs) applies at atomic resolution for
free.

Feature design keeps residue-graph NAME parity (``type``, ``polarity``,
``charge``, ``bsa``, ``pssm``, ``cons``, ``ic`` select exactly like on
residue graphs — atoms inherit their residue's values; ``bsa`` is the
true per-atom buried area) and adds ``atomtype``, a one-hot element
class (C, N, O, S, other), the genuinely atomic signal.

Geometry conventions:

- interface edges: chain-A heavy atom vs chain-B heavy atom closer
  than ``contact_distance`` (default 5.5 Å, the classic atomic contact
  cutoff — vs 8.5 Å for residue centers);
- internal edges: same-chain node pairs closer than
  ``internal_contact_distance`` (default 3 Å: covalent bonds plus
  H-bond-range contacts).

The port's own copy of ``deeprank_gnn_tpu/featurize/atom_graph.py``: the
atom pair searches (``<=`` the cutoff, as the JAX package's ``cKDTree``
pair queries) and the SASA run on ``device`` (``cuda`` unless the caller
passes ``"cpu"``) through :mod:`featurize.geometry`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from deeprank_gnn_tpu_torch.device import resolve_device
from deeprank_gnn_tpu_torch.featurize import geometry
from deeprank_gnn_tpu_torch.featurize import pssm as pssm_mod
from deeprank_gnn_tpu_torch.featurize.graph import Graph
from deeprank_gnn_tpu_torch.featurize.pdb import Structure
from deeprank_gnn_tpu_torch.featurize.residue_graph import (
    PSSM_POS,
    POLARITY_ENCODING,
    RESIDUE_CHARGE,
    RESIDUE_NAMES,
    RESIDUE_POLARITY,
    VALID_RES,
    _onehot,
    parse_inputs,
)
from deeprank_gnn_tpu_torch.featurize.sasa import atom_sasa

# element classes for the atomic one-hot (everything else -> "other")
ELEMENT_ENCODING = {"C": 0, "N": 1, "O": 2, "S": 3}
NUM_ELEMENT_CLASSES = 5


class AtomGraph(Graph):
    """Atomic interface graph with the residue feature names plus
    per-atom ``atomtype``/``bsa``. Node keys are
    ``(chain, resSeq, "RES:ATOM")`` — three components, so the HDF5
    writer/reader and every downstream consumer treat them exactly
    like residue keys."""

    def __init__(
        self,
        pdb: Optional[str] = None,
        pssm: Optional[Dict[str, str]] = None,
        contact_distance: float = 5.5,
        internal_contact_distance: float = 3.0,
        pssm_align: str = "res",
        biopython: bool = False,
        device="cuda",
        parsed: Optional[Tuple[Structure, Optional[Dict], Optional[Dict]]] = None,
    ):
        """``parsed``: as for ``ResidueGraph``."""
        super().__init__(resolve_device(device))
        self.type = "atomic"
        self.pdb = pdb
        self.name = os.path.splitext(os.path.basename(pdb))[0]
        self.contact_distance = contact_distance
        self.internal_contact_distance = internal_contact_distance
        self.biopython = biopython
        self.struct, self.pssm, self.ic = parsed or parse_inputs(pdb, pssm, pssm_align)
        self._build_graph()
        self._build_node_features()

    # ------------------------------------------------------------------
    def _eligible_atoms(self) -> np.ndarray:
        """Heavy atoms of valid residues, first altloc only; when a
        PSSM is given, only residues it covers (the residue-graph
        validity rule at atomic resolution)."""
        s = self.struct
        # restrict to residues with feature encodings: VALID_RES also
        # admits ASX/SEC/GLX, which RESIDUE_NAMES/RESIDUE_CHARGE lack —
        # without a PSSM filter those would KeyError in
        # _build_node_features and drop the whole model
        encodable = tuple(k for k in VALID_RES if k in RESIDUE_NAMES)
        keep = (s.element != "H") & np.isin(s.resname, encodable)
        keep &= np.isin(s.altloc, ("", "A"))
        if self.pssm is not None:
            res_ok = np.array(
                [
                    (str(c), int(q), str(r)) in self.pssm
                    for c, q, r in zip(s.chain, s.resseq, s.resname)
                ]
            )
            keep &= res_ok
        return np.flatnonzero(keep)

    @staticmethod
    def _key(s, i):
        return (
            str(s.chain[i]),
            int(s.resseq[i]),
            f"{s.resname[i]}:{s.name[i]}",
        )

    def _build_graph(self) -> None:
        s = self.struct
        idx = self._eligible_atoms()
        ia = idx[s.chain[idx] == "A"]
        ib = idx[s.chain[idx] == "B"]
        if len(ia) == 0 or len(ib) == 0:
            raise ValueError(f"{self.pdb}: need atoms on chains A and B")
        rows, cols, dists = geometry.pairs_within(
            s.xyz[ia], s.xyz[ib], self.contact_distance, self.device
        )
        # contact atoms in file order: chain A then chain B (the
        # residue-graph node-ordering convention at atomic resolution)
        used_a = ia[np.unique(rows)]
        used_b = ib[np.unique(cols)]
        self._atom_idx = np.concatenate([used_a, used_b])
        self.nodes = [self._key(s, i) for i in self._atom_idx]

        pos_a = {g: n for n, g in enumerate(used_a)}
        pos_b = {g: n for n, g in enumerate(used_b)}
        self.edge_data = {"dist": [], "type": []}
        # one edge per contacting atom pair, in (row, col) order
        for r, c, d in zip(rows.tolist(), cols.tolist(), dists.tolist()):
            self.edges.append(
                (self.nodes[pos_a[ia[r]]], self.nodes[len(used_a) + pos_b[ib[c]]])
            )
            self.edge_data["dist"].append(float(d))
            self.edge_data["type"].append(b"interface")

        # internal edges: same-chain contacts among the graph's nodes
        for side, used in (("A", used_a), ("B", used_b)):
            if len(used) < 2:
                continue
            xyz = s.xyz[used]
            close_r, close_c, close_d = geometry.pairs_within(
                xyz, xyz, self.internal_contact_distance, self.device
            )
            base = 0 if side == "A" else len(used_a)
            # each pair once (r < c), in (r, c) order
            for r, c, d in zip(close_r.tolist(), close_c.tolist(), close_d.tolist()):
                if r >= c:
                    continue
                self.edges.append(
                    (self.nodes[base + r], self.nodes[base + c])
                )
                self.edge_data["dist"].append(d)
                self.edge_data["type"].append(b"internal")

    # ------------------------------------------------------------------
    def _build_node_features(self) -> None:
        s = self.struct
        idx = self._atom_idx
        # per-atom BSA: SASA(unbound chain) - SASA(complex), the
        # atomic refinement of `tools/BSA.py:84-117`
        sasa_complex = atom_sasa(s, device=self.device)
        sasa_unbound = np.zeros_like(sasa_complex)
        for chain in ("A", "B"):
            mask = s.chain == chain
            sasa_unbound[mask] = atom_sasa(s.select(mask), device=self.device)
        bsa = sasa_unbound - sasa_complex

        feats: Dict[str, list] = {
            "chain": [], "pos": [], "type": [], "atomtype": [],
            "charge": [], "polarity": [], "bsa": [],
        }
        if self.pssm is not None:
            feats.update({"pssm": [], "cons": [], "ic": []})
        if self.biopython:
            from deeprank_gnn_tpu_torch.featurize.biofeatures import (
                get_depth_contact_res,
                get_hse,
            )

            res_nodes = sorted(
                {
                    (str(s.chain[i]), int(s.resseq[i]), str(s.resname[i]))
                    for i in idx
                }
            )
            depth = get_depth_contact_res(s, res_nodes, self.device)
            hse = get_hse(s, self.device)
            feats.update({"depth": [], "hse": []})

        for i in idx:
            chain_id = str(s.chain[i])
            resname = str(s.resname[i])
            res_key = (chain_id, int(s.resseq[i]), resname)
            feats["chain"].append({"A": 0, "B": 1}[chain_id])
            feats["pos"].append(s.xyz[i])
            feats["type"].append(_onehot(RESIDUE_NAMES[resname], 20))
            elem = ELEMENT_ENCODING.get(
                str(s.element[i]), NUM_ELEMENT_CLASSES - 1
            )
            feats["atomtype"].append(_onehot(elem, NUM_ELEMENT_CLASSES))
            feats["charge"].append(RESIDUE_CHARGE[resname])
            feats["polarity"].append(
                _onehot(POLARITY_ENCODING[RESIDUE_POLARITY[resname]], 4)
            )
            feats["bsa"].append([float(bsa[i])])
            if self.pssm is not None:
                data = pssm_mod.get_pssm_data(res_key, self.pssm)
                feats["pssm"].append(data)
                feats["cons"].append(data[PSSM_POS[resname]])
                feats["ic"].append(pssm_mod.get_ic_data(res_key, self.ic))
            if self.biopython:
                feats["depth"].append(depth.get(res_key, 0.0))
                feats["hse"].append(
                    hse.get((chain_id, int(s.resseq[i])), (0.0, 0.0, 0.0))
                )

        self.node_data = feats
