"""Cross-entropy loss (counterpart of pytorch_camvid_tpu/ops/loss.py; the
reference's ``nn.CrossEntropyLoss``, train.py:105).

Mean cross-entropy in f32 over NHWC logits, with optional per-class weights
and an ignore_index that may be one label or a tuple of labels (eval drops
both the pad sentinel 255 and a configured ignore class). The reduction is
torch's 'mean': ``sum_i w[y_i] * nll_i / sum_i w[y_i]`` over the pixels
that are not ignored. A label outside ``[0, C)`` that is not ignored
follows the JAX package's one-hot contraction (its one-hot row is all
zero): picked logit 0, so its nll is ``logsumexp``, with weight 1, or 0
under class weights.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

IgnoreIndex = Optional[Union[int, Sequence[int]]]


def _ignore_tuple(ignore_index: IgnoreIndex) -> tuple:
    if ignore_index is None:
        return ()
    if isinstance(ignore_index, (tuple, list, set, frozenset)):
        return tuple(sorted(set(int(i) for i in ignore_index)))
    return (int(ignore_index),)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       ignore_index: IgnoreIndex = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of w * nll, sum of w) over the pixels: the loss's numerator
    and denominator, which a data-parallel step sums over its ranks before
    it divides (the global batch's mean, JAX ``ops/loss.py:62``)."""
    logits = logits.float()
    ignore = _ignore_tuple(ignore_index)
    labels = labels.long()
    ignored = torch.zeros_like(labels, dtype=torch.bool)
    for ig in ignore:
        ignored |= labels == ig
    safe = labels.masked_fill(ignored, 0) if ignore else labels
    inside = (safe >= 0) & (safe < logits.shape[-1])
    idx = safe.masked_fill(~inside, 0).unsqueeze(-1)
    picked = logits.gather(-1, idx).squeeze(-1).masked_fill(~inside, 0.0)
    nll = torch.logsumexp(logits, dim=-1) - picked
    if class_weights is None:
        w = torch.ones_like(nll)
    else:
        w = class_weights.to(nll)[idx.squeeze(-1)].masked_fill(~inside, 0.0)
    if ignore:
        w = w.masked_fill(ignored, 0.0)
    return (nll * w).sum(), w.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       ignore_index: IgnoreIndex = None) -> torch.Tensor:
    """logits (N,H,W,C) float, labels (N,H,W) int -> scalar f32 mean CE."""
    num, den = cross_entropy_sums(logits, labels, class_weights,
                                  ignore_index)
    return num / den.clamp_min(1e-12)
