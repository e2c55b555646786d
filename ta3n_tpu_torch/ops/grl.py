"""Gradient reversal: identity on the forward pass, ``-beta * g`` on the
backward pass.

Port of `ta3n_tpu/ops/grl.py::grad_reverse` (reference GradReverse,
models.py:20-30).  ``beta`` is a tensor or a Python number, so a schedule
that changes it every step changes no code path; a number stays on the
host (no host-to-device copy, which would stall the step on the stream).
Under ``torch.func.vmap`` (the ensembles of `train/ensemble.py`) a batched
``beta`` gives each member its own strength.
"""

from __future__ import annotations

import torch

__all__ = ["grad_reverse"]


class _GradReverse(torch.autograd.Function):
    """In the ``setup_context`` form, with a generated vmap rule, so that
    ``torch.func`` transforms it (`train/ensemble.py`): under ``vmap`` a
    tensor ``beta`` may be batched, each member reversing by its own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x: torch.Tensor, beta) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        _, beta = inputs
        if isinstance(beta, torch.Tensor):
            ctx.save_for_backward(beta)
            ctx.beta = None
        else:
            ctx.beta = float(beta)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # beta is a schedule scalar, not trained: no gradient for it
        if ctx.beta is not None:
            return -ctx.beta * g, None
        (beta,) = ctx.saved_tensors
        return -beta.to(g.dtype) * g, None


def grad_reverse(x: torch.Tensor, beta) -> torch.Tensor:
    """Identity forward; the gradient is multiplied by ``-beta``."""
    if isinstance(beta, torch.Tensor):
        beta = beta.to(x.device)
    return _GradReverse.apply(x, beta)
