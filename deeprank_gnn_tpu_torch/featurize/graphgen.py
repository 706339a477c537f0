"""Batch PDB -> HDF5 graph generation driver (reference `GraphGenMP.py`).

The port's own copy of ``deeprank_gnn_tpu/featurize/graphgen.py``. The
geometry of every model runs in this process on ``device`` (``cuda``
unless the caller passes ``"cpu"``). With ``nproc > 1`` a forked pool of
workers parses the PDB and PSSM files on the host and this process
featurizes them as they come, in file order: the workers touch neither
torch nor the card (a forked child may not use the parent's CUDA
context, as torch's own ``DataLoader`` workers do not), so the JAX
package's fork, which keeps scripts without a ``__main__`` guard
working, stays safe. The HDF5 holds the JAX package's groups and
datasets for the same inputs.
"""

from __future__ import annotations

import glob
import multiprocessing as mp
import os
from functools import partial
from typing import Dict, List, Optional

from deeprank_gnn_tpu_torch.device import resolve_device
from deeprank_gnn_tpu_torch.featurize.residue_graph import ResidueGraph, parse_inputs

_GRAPH_CLASSES = {"residue": ResidueGraph}


def _graph_class(graph_type: str):
    if graph_type == "atomic":
        # lazy: atomic graphs are an extension beyond the residue-only
        # reference (`GraphGenMP.py:24` takes graph_type but only
        # implements 'residue')
        from deeprank_gnn_tpu_torch.featurize.atom_graph import AtomGraph

        return AtomGraph
    try:
        return _GRAPH_CLASSES[graph_type]
    except KeyError:
        raise ValueError(
            f"unknown graph_type {graph_type!r}; use 'residue' or 'atomic'"
        ) from None


def _parse_one(name: str, pssm: Dict[str, Optional[Dict[str, str]]]):
    """Worker: the parsed inputs of one model (host only), or the
    exception that parsing raised."""
    try:
        return parse_inputs(name, pssm[name])
    except Exception as e:
        return e


def _build_one(name, parsed, ref, biopython, graph_type, device):
    if isinstance(parsed, Exception):
        raise parsed
    g = _graph_class(graph_type)(pdb=name, biopython=biopython, device=device, parsed=parsed)
    if ref is not None:
        g.get_score(ref)
    # the graphs are kept without their parsed structure, as the JAX
    # package's come back from its pool
    g.struct = None
    return g


class GraphHDF5:
    def __init__(
        self,
        pdb_path: str,
        ref_path: Optional[str] = None,
        graph_type: str = "residue",
        pssm_path: Optional[str] = None,
        select: Optional[str] = None,
        outfile: str = "graph.hdf5",
        nproc: int = 1,
        use_tqdm: bool = True,
        tmpdir: str = "./",
        limit=None,
        biopython: bool = False,
        device="cuda",
    ):
        import h5py

        device = resolve_device(device)
        pdbs = [f for f in os.listdir(pdb_path) if f.endswith(".pdb")]
        if select is not None:
            pdbs = [f for f in pdbs if f.startswith(select)]
        pdbs = sorted(os.path.join(pdb_path, name) for name in pdbs)
        if limit is not None:
            pdbs = pdbs[limit[0] : limit[1]] if isinstance(limit, list) else pdbs[:limit]

        base_name = None
        pssm: Dict[str, Optional[Dict[str, str]]] = {}
        for p in pdbs:
            mol_name = os.path.splitext(os.path.basename(p))[0]
            base_name = mol_name.split("_")[0]
            pssm[p] = (
                self._get_pssm(pssm_path, mol_name, base_name)
                if pssm_path is not None
                else None
            )

        ref = (
            None
            if ref_path is None
            else self._find_ref(ref_path, base_name)
        )

        _graph_class(graph_type)  # validate before any work
        graphs: List[ResidueGraph] = []
        parse = partial(_parse_one, pssm=pssm)
        pool = mp.get_context("fork").Pool(nproc) if nproc > 1 else None
        try:
            parsed_models = pool.imap(parse, pdbs) if pool else map(parse, pdbs)
            for name, parsed in zip(pdbs, parsed_models):
                try:
                    graphs.append(
                        _build_one(name, parsed, ref, biopython, graph_type, device)
                    )
                except Exception as e:
                    print("Issue encountered while computing graph ", name)
                    print(e)
        finally:
            if pool is not None:
                pool.close()
                pool.join()

        with h5py.File(outfile, "w") as f5:
            for g in graphs:
                try:
                    g.nx2h5(f5)
                except Exception as e:
                    print("Issue encountered while storing graph ", g.pdb)
                    print(e)

        self.graphs = graphs

    @staticmethod
    def _find_ref(ref_path: str, base_name: Optional[str]) -> Optional[str]:
        if base_name is None:
            return None
        cand = os.path.join(ref_path, base_name + ".pdb")
        if os.path.isfile(cand):
            return cand
        # tolerate suffixed reference files (e.g. '<name>.pdb.save')
        matches = sorted(glob.glob(os.path.join(ref_path, base_name + ".pdb*")))
        return matches[0] if matches else None

    @staticmethod
    def _get_pssm(
        pssm_path: str, mol_name: str, base_name: str
    ) -> Dict[str, str]:
        """PSSM discovery with the reference's 3 naming fallbacks
        (`GraphGenMP.py:181-205`)."""
        for fmt in (
            "{base}.{chain}.pssm",
            "{base}.{chain}.pdb.pssm",
            "{mol}.{chain}.pdb.pssm",
        ):
            pa = os.path.join(
                pssm_path, fmt.format(base=base_name, mol=mol_name, chain="A")
            )
            pb = os.path.join(
                pssm_path, fmt.format(base=base_name, mol=mol_name, chain="B")
            )
            if os.path.isfile(pa) and os.path.isfile(pb):
                return {"A": pa, "B": pb}
        raise FileNotFoundError("PSSM file for " + mol_name + " not found")
