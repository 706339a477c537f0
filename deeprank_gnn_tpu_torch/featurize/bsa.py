"""BSA class API (reference `tools/BSA.py:12-117` surface).

Thin object wrapper over :func:`featurize.sasa.buried_surface_area`
for users of the reference's two-step `get_structure()` /
`get_contact_residue_sasa()` protocol. No freesasa dependency.

The port's own copy of ``deeprank_gnn_tpu/featurize/bsa.py``: the SASA and
the contact search run on ``device`` (``cuda`` unless the caller passes
``"cpu"``).
"""

from __future__ import annotations

from typing import Dict, Optional

from deeprank_gnn_tpu_torch.device import resolve_device
from deeprank_gnn_tpu_torch.featurize.contacts import get_contact_residues
from deeprank_gnn_tpu_torch.featurize.pdb import Structure, read_pdb
from deeprank_gnn_tpu_torch.featurize.sasa import (
    addatom_radii,
    buried_surface_area,
    residue_sasa,
)


class BSA:
    def __init__(self, pdb_data, sqldb=None, chainA: str = "A", chainB: str = "B",
                 device="cuda"):
        self.device = resolve_device(device)
        self.struct = (
            pdb_data if isinstance(pdb_data, Structure) else read_pdb(pdb_data)
        )
        self.chains_label = [chainA, chainB]
        self.complex_sasa: Optional[Dict] = None
        self.bsa_data: Dict = {}

    def get_structure(self) -> None:
        """Compute per-residue SASA of the complex and both isolated
        chains (reference `BSA.get_structure`, `BSA.py:55-82`). The
        chains use the reference's truncated-name radius convention
        (see `featurize.sasa.addatom_radii`)."""
        self.complex_sasa = residue_sasa(self.struct, device=self.device)
        self.chain_sasa = {}
        for label in self.chains_label:
            sub = self.struct.select(self.struct.chain == label)
            self.chain_sasa[label] = residue_sasa(
                sub, radii=addatom_radii(sub), device=self.device
            )

    def get_contact_residue_sasa(self, cutoff: float = 8.5) -> Dict:
        """BSA per contact residue: SASA(isolated chain) - SASA(complex)
        (reference `BSA.py:84-117`). Returns {(chain, resSeq, resName):
        [bsa]} like the reference's `bsa_data`."""
        pairs, _ = get_contact_residues(
            self.struct, cutoff=cutoff,
            chain_a=self.chains_label[0], chain_b=self.chains_label[1],
            device=self.device,
        )
        contacts = list(pairs.keys()) + sorted(
            {v for vals in pairs.values() for v in vals}
        )
        if self.complex_sasa is None:
            self.get_structure()
        bsa = buried_surface_area(
            self.struct,
            contacts,
            complex_sasa=self.complex_sasa,
            chain_sasa=dict(self.chain_sasa),
            device=self.device,
        )
        self.bsa_data = {res: [val] for res, val in bsa.items()}
        return self.bsa_data
