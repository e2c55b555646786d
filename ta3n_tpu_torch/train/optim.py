"""The optimizer of the port: clip, then weight decay, then Nesterov
momentum or Adam, as torch.optim does it natively.

The counterpart of `ta3n_tpu/train/optim.py:29-112`.  The JAX package
builds clip -> weight decay -> momentum (or ``optax.scale_by_adam()``) as
an optax chain and scales the update by a per-step lr; here the
reference's own calls are used (main.py:83, 578-583, 800-802):
``clip_grad_norm_`` on the raw gradients, then
``torch.optim.SGD(momentum, nesterov=True, weight_decay)`` or
``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay)``, whose
weight decay is added to the gradient before the moments as optax's
``add_decayed_weights`` is, with the step's lr written into its
``param_groups``.

Gradient reachability needs no mask here.  The train step clears the
gradients with ``zero_grad(set_to_none=True)``, so a parameter that
backprop does not reach in a step has ``grad=None``; clipping and the
optimizer skip it (no weight decay), which is what the JAX package
imitates with ``structural_participation`` (`optim.py:29`).  One
difference remains, and ``optimizer_step`` closes it: the JAX chain still
runs its transform on a zero gradient for such a parameter.  SGD's
momentum coasts on its buffer; Adam decays both moments, advances its one
count shared by every parameter and moves the parameter by its bias-
corrected moments.  That happens where steps of two kinds alternate
(``--pretrain_source``'s classification-only step before each train
step); where every step reaches the same parameters it never does.  So
that every parameter's Adam count is the shared one, ``make_optimizer``
gives every parameter its Adam state at step 0.  ``FlatOptimizer``, a TPU
dispatch workaround, is not ported (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

from ta3n_tpu_torch.config import TrainConfig

__all__ = ["make_optimizer", "optimizer_step"]

# optax.scale_by_adam's defaults, which the JAX chain uses
_ADAM_BETAS, _ADAM_EPS = (0.9, 0.999), 1e-8


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   train_cfg: TrainConfig) -> torch.optim.Optimizer:
    """Nesterov SGD with the configured momentum and weight decay, or Adam
    with optax's defaults and the configured weight decay."""
    if train_cfg.optimizer == "SGD":
        return torch.optim.SGD(params, lr=train_cfg.lr,
                               momentum=train_cfg.momentum, nesterov=True,
                               weight_decay=train_cfg.weight_decay)
    if train_cfg.optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=train_cfg.lr, betas=_ADAM_BETAS,
                               eps=_ADAM_EPS,
                               weight_decay=train_cfg.weight_decay)
        for group in opt.param_groups:
            for p in group["params"]:
                # the state torch.optim.Adam makes at a parameter's first
                # step, made now: every count starts together
                opt.state[p] = {
                    "step": torch.tensor(0.0, dtype=_step_dtype()),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}
        return opt
    raise ValueError(f"optimizer not supported: {train_cfg.optimizer}")


def _step_dtype() -> torch.dtype:
    """The dtype of torch.optim's step counts (float64 under a float64
    default dtype)."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def optimizer_step(optimizer: torch.optim.Optimizer, lr: float,
                   clip_gradient: Optional[float]) -> None:
    """Clip the global gradient norm to ``clip_gradient`` (None: no clip),
    then take one step at learning rate ``lr``.  A parameter without a
    gradient moves as on a zero gradient without weight decay, as in the
    JAX optax chain: under SGD one that has a momentum buffer coasts,
    buf = m * buf, then p -= lr * m * buf (Nesterov); under Adam every one
    does, m = b1 * m, v = b2 * v, its count advanced, then
    p -= lr * m_hat / (sqrt(v_hat) + eps)."""
    if clip_gradient is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for group in optimizer.param_groups for p in group["params"]],
            clip_gradient)
    adam = isinstance(optimizer, torch.optim.Adam)
    coasting = []
    for group in optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is not None:
                continue
            state = optimizer.state.get(p, {})
            if adam and state:
                coasting.append((p, state, group))
            elif state.get("momentum_buffer") is not None:
                coasting.append((p, state["momentum_buffer"],
                                 group["momentum"]))
    optimizer.step()
    with torch.no_grad():
        if adam:
            for p, state, group in coasting:
                _adam_coast(p, state, group, lr)
        else:
            for p, buf, m in coasting:
                buf.mul_(m)
                p.add_(buf, alpha=-lr * m)


def _adam_coast(p: torch.Tensor, state: dict, group: dict,
                lr: float) -> None:
    """One Adam step of ``p`` on a zero gradient, in torch.optim.Adam's
    arithmetic: the moments decay, the count advances, and p moves by the
    bias-corrected moments."""
    b1, b2 = group["betas"]
    state["step"] += 1
    step = float(state["step"])
    state["exp_avg"].mul_(b1)
    state["exp_avg_sq"].mul_(b2)
    denom = (state["exp_avg_sq"].sqrt()
             / math.sqrt(1 - b2 ** step)).add_(group["eps"])
    p.addcdiv_(state["exp_avg"], denom, value=-lr / (1 - b1 ** step))
