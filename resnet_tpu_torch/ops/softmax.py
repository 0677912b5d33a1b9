"""Softmax, stable by default; ``stable=False`` is the reference's naive
exp(x)/sum (resnet.cu:569-580), kept for forward-dump fidelity."""

from __future__ import annotations

import torch


def softmax(x: torch.Tensor, *, dim: int = -1, stable: bool = True) -> torch.Tensor:
    if stable:
        x = x - torch.amax(x, dim=dim, keepdim=True).detach()
    ex = torch.exp(x)
    return ex / torch.sum(ex, dim=dim, keepdim=True)


def log_softmax(x: torch.Tensor, *, dim: int = -1) -> torch.Tensor:
    shifted = x - torch.amax(x, dim=dim, keepdim=True).detach()
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=dim, keepdim=True))
