"""Losses of the port: the entropy that TransAttn needs and the losses of
the train step.

Ports of `ta3n_tpu/losses/losses.py:38-116`, with optional row masks in
place of the reference's dummy-row padding (`main.py:358-372,825-832`):
padded rows carry zero weight.  The discrepancy losses (DAN, JAN, CORAL)
come with ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["masked_mean", "entropy_from_logits", "weighted_cross_entropy",
           "cross_entropy_soft", "attentive_entropy", "dis_MCD"]


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Mean of ``x`` over rows where ``mask`` is 1 (mean of all if None)."""
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-row Shannon entropy of softmax(logits): sum(-p * log p, -1).

    Port of `ta3n_tpu/losses/losses.py::entropy_from_logits` (reference
    loss.py:8-12, models.py:351-357).
    """
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(-logp.exp() * logp, dim=-1)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Class-weighted CE with torch ``nn.CrossEntropyLoss(weight=w)``
    semantics, the weighted mean sum_i w[y_i]*nll_i / sum_i w[y_i]
    (reference main.py:204-206); rows with mask 0 carry no weight."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    if class_weights is not None:
        w = class_weights.to(nll.dtype)[labels.long()]
    else:
        w = torch.ones_like(nll)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return (w * nll).sum() / w.sum().clamp(min=1e-12)


def cross_entropy_soft(pred: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean self-entropy of softmax(pred), target-entropy minimisation
    (reference loss.py:8-12, used at main.py:542-545)."""
    return masked_mean(entropy_from_logits(pred), mask)


def attentive_entropy(pred: torch.Tensor, pred_domain: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Entropy of the class logits weighted by (1 + entropy of the domain
    prediction) (reference loss.py:15-25, used at main.py:558-562 with the
    video-level domain logits)."""
    weights = 1.0 + entropy_from_logits(pred_domain)
    return masked_mean(weights * entropy_from_logits(pred), mask)


def dis_MCD(out1: torch.Tensor, out2: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |softmax(out1) - softmax(out2)| over the real rows, the MCD
    discrepancy (reference loss.py:29-30)."""
    d = (torch.softmax(out1, dim=-1) - torch.softmax(out2, dim=-1)).abs()
    if mask is None:
        return d.mean()
    m = mask.to(d.dtype)[:, None]
    return (d * m).sum() / (m.sum() * d.shape[-1]).clamp(min=1.0)
