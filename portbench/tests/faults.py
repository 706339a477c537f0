"""Faults planted in the program for the output check's tests: each breaks
the timed path underneath the harness, which must then read ``correct``
false. A function here patches the program in the process that calls it."""

from __future__ import annotations


def state_unchanged():
    """Adam's update writes nothing: every step returns its state as it was."""
    import torch.optim.adam as adam

    adam.adam = lambda *args, **kwargs: None


def half_batch():
    """The loss is the mean over the first half of each batch's graphs."""
    import torch

    from deeprank_gnn_tpu_torch.train import neuralnet

    def first_half(mask):
        return mask & (torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2)

    full = neuralnet.mse_loss
    neuralnet.mse_loss = lambda pred, y, mask: full(pred, y, first_half(mask))


def answer_altered(net):
    """The first graph's score is moved where the model produces it, in the
    port's class ``net``."""
    forward = net.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return out + (torch_arange_like(out) == 0) * 0.05

    net.forward = altered


def half_scores(net):
    """Scoring has no loss to shorten: half of each batch's scores are lost
    (zero) where the port's class ``net`` produces them."""
    forward = net.forward

    def half(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return out * (torch_arange_like(out) < out.shape[0] // 2)

    net.forward = half


def torch_arange_like(out):
    import torch

    return torch.arange(out.shape[0], device=out.device).reshape(-1, *[1] * (out.dim() - 1))


# the faults each kind of cell can have: scoring has no state to leave
# unchanged
BY_MODE = {"train": ("state_unchanged", "half_batch", "answer_altered"),
           "score": ("half_batch", "answer_altered")}


def plant(fault: str, net, training: bool) -> None:
    """Plant ``fault`` of :data:`BY_MODE` in a training or a scoring run of
    the port's class ``net``."""
    if fault == "state_unchanged":
        state_unchanged()
    elif fault == "half_batch" and training:
        half_batch()
    elif fault == "half_batch":
        half_scores(net)
    else:
        answer_altered(net)
