"""The optimizer of the port: clip, then weight decay, then Nesterov
momentum, as torch.optim does it natively.

The counterpart of `ta3n_tpu/train/optim.py:29-112`.  The JAX package
builds clip -> weight decay -> momentum as an optax chain and scales the
update by a per-step lr; here the reference's own calls are used
(main.py:83, 578-583, 800-802): ``clip_grad_norm_`` on the raw gradients,
then ``torch.optim.SGD(momentum, nesterov=True, weight_decay)`` with the
step's lr written into its ``param_groups``.

Gradient reachability needs no mask here.  The train step clears the
gradients with ``zero_grad(set_to_none=True)``, so a parameter that
backprop does not reach in a step has ``grad=None``; clipping and SGD
skip it (no weight decay), which is what the JAX package imitates with
``structural_participation`` (`optim.py:29`).  One difference remains,
and ``optimizer_step`` closes it: the JAX chain still runs the momentum
of such a parameter on a zero gradient, so a parameter that an earlier
step reached coasts on its momentum buffer.  That happens where steps of
two kinds alternate (``--pretrain_source``'s classification-only step
before each train step); where every step reaches the same parameters it
never does.  ``FlatOptimizer``, a TPU dispatch workaround, is not ported
(ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ta3n_tpu_torch.config import TrainConfig

__all__ = ["make_optimizer", "optimizer_step"]


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   train_cfg: TrainConfig) -> torch.optim.SGD:
    """Nesterov SGD with the configured momentum and weight decay."""
    if train_cfg.optimizer != "SGD":
        raise NotImplementedError(
            f"optimizer={train_cfg.optimizer!r} is not ported yet; the port "
            "runs SGD (ROADMAP.md queue 1, item 8: the optimizer and "
            "precision surface)")
    return torch.optim.SGD(params, lr=train_cfg.lr,
                           momentum=train_cfg.momentum, nesterov=True,
                           weight_decay=train_cfg.weight_decay)


def optimizer_step(optimizer: torch.optim.Optimizer, lr: float,
                   clip_gradient: Optional[float]) -> None:
    """Clip the global gradient norm to ``clip_gradient`` (None: no clip),
    then take one step at learning rate ``lr``.  A parameter without a
    gradient that has a momentum buffer moves on it as on a zero gradient
    without weight decay, as in the JAX optax chain: buf = m * buf, then
    p -= lr * m * buf (Nesterov)."""
    if clip_gradient is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for group in optimizer.param_groups for p in group["params"]],
            clip_gradient)
    coasting = []
    for group in optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            if p.grad is None and buf is not None:
                coasting.append((p, buf, group["momentum"]))
    optimizer.step()
    with torch.no_grad():
        for p, buf, m in coasting:
            buf.mul_(m)
            p.add_(buf, alpha=-lr * m)
