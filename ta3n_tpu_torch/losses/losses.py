"""Losses of the port.  So far only the entropy that TransAttn needs;
the rest of `ta3n_tpu/losses/losses.py` comes with the train step."""

from __future__ import annotations

import torch

__all__ = ["entropy_from_logits"]


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-row Shannon entropy of softmax(logits): sum(-p * log p, -1).

    Port of `ta3n_tpu/losses/losses.py::entropy_from_logits` (reference
    loss.py:8-12, models.py:351-357).
    """
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(-logp.exp() * logp, dim=-1)
