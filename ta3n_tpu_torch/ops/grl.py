"""Gradient reversal: identity on the forward pass, ``-beta * g`` on the
backward pass.

Port of `ta3n_tpu/ops/grl.py::grad_reverse` (reference GradReverse,
models.py:20-30).  ``beta`` is a tensor, so a schedule that changes it
every step changes no code path.
"""

from __future__ import annotations

import torch

__all__ = ["grad_reverse"]


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(beta)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (beta,) = ctx.saved_tensors
        # beta is a schedule scalar, not trained: no gradient for it
        return -beta.to(g.dtype) * g, None


def grad_reverse(x: torch.Tensor, beta) -> torch.Tensor:
    """Identity forward; the gradient is multiplied by ``-beta``."""
    return _GradReverse.apply(x, torch.as_tensor(beta, device=x.device))
