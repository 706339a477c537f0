"""Vectorized residue contact detection (replaces pdb2sql.interface +
the reference's O(N^2) python loops).

Semantics reproduced from the reference featurizer:

- interface contact pairs: chain-A residue vs chain-B residue with ANY
  atom-atom distance below `contact_distance` (8.5 A default)
  (`ResidueGraph.py:117-118` via pdb2sql `get_contact_residues`);
  the edge distance is the MIN atom-atom distance between the two
  residues (`ResidueGraph.py:364-381`).
- internal edges: within each chain, node pairs with any atom-atom
  distance below `internal_contact_distance` (3 A default), min
  distance attached (`ResidueGraph.py:289-316` — the reference loops
  over residue pairs).

The port's own copy of ``deeprank_gnn_tpu/featurize/contacts.py``. The
atom pair search and the per-residue-pair minimum run on ``device``
(:func:`featurize.geometry.contact_pairs`, ``cuda`` unless the caller
passes ``"cpu"``) with the JAX package's bound: ``<=`` the cutoff, as its
C++ kernel and its ``cKDTree`` fallback both test. The file-order and
``(i1, i2)`` ordering rules stay on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from deeprank_gnn_tpu_torch.featurize import geometry
from deeprank_gnn_tpu_torch.featurize.pdb import Structure

ResKey = Tuple[str, int, str]  # (chain, resSeq, resName)


def _atom_residue_ids(struct: Structure) -> Tuple[np.ndarray, List[ResKey]]:
    """Label each atom with a dense residue id; return id array + keys."""
    keys: List[ResKey] = []
    index: Dict[ResKey, int] = {}
    ids = np.empty(struct.natoms, dtype=np.int64)
    for i, (c, s, r) in enumerate(
        zip(struct.chain, struct.resseq, struct.resname)
    ):
        key = (str(c), int(s), str(r))
        if key not in index:
            index[key] = len(keys)
            keys.append(key)
        ids[i] = index[key]
    return ids, keys


def _pairwise_residue_contacts(
    xyz_a: np.ndarray,
    rid_a: np.ndarray,
    xyz_b: np.ndarray,
    rid_b: np.ndarray,
    cutoff: float,
    device="cuda",
) -> Dict[Tuple[int, int], float]:
    """Min atom-atom distance per (residue_a, residue_b) pair that has
    any atom pair within cutoff (``<=``), found on ``device``."""
    res_a, res_b, dist = geometry.contact_pairs(xyz_a, rid_a, xyz_b, rid_b, cutoff, device)
    return {
        (a, b): d for a, b, d in zip(res_a.tolist(), res_b.tolist(), dist.tolist())
    }


def get_contact_residues(
    struct: Structure,
    cutoff: float = 8.5,
    chain_a: str = "A",
    chain_b: str = "B",
    device="cuda",
) -> Tuple[Dict[ResKey, List[ResKey]], Dict[Tuple[ResKey, ResKey], float]]:
    """Interface contact pairs between two chains.

    Returns (pairs, distances): ``pairs`` maps each chain-A residue (in
    file order) to its chain-B contacts (in file order), matching the
    reference's pdb2sql `get_contact_residues(return_contact_pairs=True)`
    consumption at `ResidueGraph.py:117-135`; ``distances`` holds the
    min atom-atom distance per (A-res, B-res) pair.
    """
    rid, keys = _atom_residue_ids(struct)
    mask_a = struct.chain == chain_a
    mask_b = struct.chain == chain_b
    contacts = _pairwise_residue_contacts(
        struct.xyz[mask_a],
        rid[mask_a],
        struct.xyz[mask_b],
        rid[mask_b],
        cutoff,
        device,
    )
    pairs: Dict[ResKey, List[ResKey]] = {}
    distances: Dict[Tuple[ResKey, ResKey], float] = {}
    # preserve file order of residues on both sides
    ordered = sorted(contacts.items(), key=lambda kv: (kv[0][0], kv[0][1]))
    for (ia, ib), d in ordered:
        ka, kb = keys[ia], keys[ib]
        pairs.setdefault(ka, []).append(kb)
        distances[(ka, kb)] = d
    return pairs, distances


def get_internal_edges(
    struct: Structure,
    nodes: Sequence[ResKey],
    cutoff: float = 3.0,
    device="cuda",
) -> Tuple[List[Tuple[ResKey, ResKey]], List[float]]:
    """Within-chain residue pairs (among ``nodes``) with any atom-atom
    distance < cutoff; min distance attached. Order: chain A pairs then
    chain B pairs, each by (i1, i2) residue order in ``nodes`` — the
    reference's double-loop order (`ResidueGraph.py:272-316`)."""
    rid, keys = _atom_residue_ids(struct)
    node_set = {k: i for i, k in enumerate(nodes)}
    edges: List[Tuple[ResKey, ResKey]] = []
    dists: List[float] = []
    for chain in ("A", "B"):
        chain_nodes = [k for k in nodes if k[0] == chain]
        if not chain_nodes:
            continue
        key_to_rid = {k: i for i, k in enumerate(keys)}
        wanted_rids = [key_to_rid[k] for k in chain_nodes if k in key_to_rid]
        mask = np.isin(rid, wanted_rids)
        xyz = struct.xyz[mask]
        sub_rid = rid[mask]
        contacts = _pairwise_residue_contacts(
            xyz, sub_rid, xyz, sub_rid, cutoff, device
        )
        # node order within the chain (reference iterates i1 < i2 over
        # the node list)
        order = {node_set[k]: idx for idx, k in enumerate(chain_nodes)}
        chain_edges = {}
        for (ia, ib), d in contacts.items():
            ka, kb = keys[ia], keys[ib]
            if ka == kb:
                continue
            i1, i2 = order[node_set[ka]], order[node_set[kb]]
            if i1 > i2:
                i1, i2 = i2, i1
            key = (i1, i2)
            if key not in chain_edges or d < chain_edges[key]:
                chain_edges[key] = d
        for (i1, i2) in sorted(chain_edges):
            edges.append((chain_nodes[i1], chain_nodes[i2]))
            dists.append(chain_edges[(i1, i2)])
    return edges, dists


def residue_centers(struct: Structure) -> Dict[Tuple[str, int], np.ndarray]:
    """Mean atom position per (chain, resSeq) (`ResidueGraph.py:237-238`)."""
    atoms = struct.residue_atoms()
    return {k: struct.xyz[v].mean(axis=0) for k, v in atoms.items()}
