"""Model zoo of the port: GINet, FoutNet and sGAT."""

from deeprank_gnn_tpu_torch.models.foutnet import FoutNet
from deeprank_gnn_tpu_torch.models.ginet import GINet
from deeprank_gnn_tpu_torch.models.sgat import sGAT

MODELS = {"GINet": GINet, "FoutNet": FoutNet, "sGAT": sGAT}

__all__ = ["GINet", "FoutNet", "sGAT", "MODELS"]
