"""Cross-entropy with the reference's gradient convention, and accuracies.

The port of resnet_tpu.ops.loss. ``reduction='sum'`` is the reference's
training loss (its backward starts from softmax - onehot summed over the
batch); 'mean' is the conventional choice and 'none' gives per-sample
values. The log-softmax runs in fp32. Label smoothing a gives
(1 - a) * nll + a * mean_k(-logp_k).
"""

from __future__ import annotations

import torch

from .softmax import log_softmax


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    reduction: str = "sum",
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    logp = log_softmax(logits.to(torch.float32))
    nll = -torch.gather(logp, 1, labels.to(torch.int64)[:, None])[:, 0]
    if label_smoothing:
        a32 = torch.tensor(label_smoothing, dtype=torch.float32)
        a, rest = a32.item(), (1 - a32).item()  # the fp32 values of a, 1 - a
        nll = rest * nll - a * torch.mean(logp, dim=-1)
    if reduction == "sum":
        return torch.sum(nll)
    if reduction == "mean":
        return torch.mean(nll)
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction!r}")


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  mean: bool = True) -> torch.Tensor:
    """mean=False returns the count of correct predictions (fp32), so a
    caller summing over microbatches divides by the full batch once."""
    hits = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    return torch.mean(hits) if mean else torch.sum(hits)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Share of rows whose label is among the k largest logits."""
    topk = torch.topk(logits, k, dim=-1).indices
    hit = torch.any(topk == labels[:, None], dim=-1)
    return torch.mean(hit.to(torch.float32))
