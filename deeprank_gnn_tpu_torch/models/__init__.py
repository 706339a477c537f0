"""Model zoo of the port (GINet so far; FoutNet and sGAT: ROADMAP.md)."""

from deeprank_gnn_tpu_torch.models.ginet import GINet

__all__ = ["GINet"]
