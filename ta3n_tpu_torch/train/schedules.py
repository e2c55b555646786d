"""Hyper-parameter schedules as pure functions of epoch / step: the port's
own copy of `ta3n_tpu/train/schedules.py`.

Parity with the reference's in-place schedule logic:
  * alpha ramp (main.py:231)
  * per-batch DANN beta (main.py:350-352)
  * step-decay / loss-plateau / DANN learning-rate rules
    (main.py:236-237,789-802)
All return plain floats, computed on the host and passed to the train step
as its per-step scalars.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["alpha_schedule", "dann_beta", "effective_beta", "dann_lr",
           "step_decay_lr", "loss_plateau_lr", "progress"]


def alpha_schedule(alpha_cfg: float, epoch: int, epochs: int) -> float:
    """alpha = 2/(1+exp(-epoch/epochs)) - 1 when the flag is negative
    (main.py:231)."""
    if alpha_cfg >= 0:
        return alpha_cfg
    return 2.0 / (1.0 + math.exp(-1.0 * epoch / epochs)) - 1.0


def progress(batch_idx: int, start_steps: int, total_steps: int) -> float:
    """p = (i + start_steps) / total_steps (main.py:350)."""
    return float(batch_idx + start_steps) / float(total_steps)


def dann_beta(p: float) -> float:
    """beta_dann = 2/(1+exp(-10p)) - 1 (main.py:351)."""
    return 2.0 / (1.0 + math.exp(-10.0 * p)) - 1.0


def effective_beta(beta_cfg: Sequence[float], p: float) -> list:
    """Replace negative configured betas with the DANN schedule
    (main.py:352)."""
    b = dann_beta(p)
    return [b if v < 0 else float(v) for v in beta_cfg]


def dann_lr(lr0: float, p: float) -> float:
    """lr = lr0 / (1 + 10p)^0.75 (main.py:800-802)."""
    return lr0 / (1.0 + 10.0 * p) ** 0.75


def step_decay_lr(lr0: float, decay: float, epoch: int,
                  lr_steps: Sequence[float]) -> float:
    """Divide by ``decay`` at every epoch listed in lr_steps
    (main.py:236-237,789-792)."""
    n = sum(1 for s in lr_steps if epoch >= s)
    return lr0 / (decay ** n)


def loss_plateau_lr(lr_prev: float, decay: float, loss_current: float,
                    loss_previous: float) -> float:
    """Divide by ``decay`` when the classification loss went up
    (main.py:234-235,794-798)."""
    if loss_current > loss_previous:
        return lr_prev / decay
    return lr_prev
