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
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.optim.adam import adam as _adam
from torch.optim.sgd import sgd as _sgd

from ta3n_tpu_torch.config import TrainConfig

__all__ = ["make_optimizer", "optimizer_step", "member_optimizer_state",
           "member_optimizer_step", "member_solo_optimizer"]

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
        _clip([p for group in optimizer.param_groups
               for p in group["params"]], clip_gradient)
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


def _clip(params, clip: float) -> None:
    """``clip_grad_norm_`` where some parameters may be a model rank's
    column slices (`parallel/tensor.py`): the squared norms of the
    slices' gradients are summed over their model group, so that every
    rank clips by the norm of the whole weights' gradients.  Without
    slices the norm is clip_grad_norm_'s own (sqrt(fl(x^2)) == |x|), and
    so is the result."""
    whole, sliced = [], {}
    for p in params:
        if p.grad is None:
            continue
        axis = getattr(p, "tp_axis", None)
        (whole if axis is None else sliced.setdefault(axis, [])).append(p)
    if not whole and not sliced:
        return
    sq = (torch.nn.utils.get_total_norm([p.grad for p in whole],
                                        2.0).square() if whole else 0)
    for axis, ps in sliced.items():
        part = torch.nn.utils.get_total_norm([p.grad for p in ps],
                                             2.0).square()
        dist.all_reduce(part, group=axis.group)
        sq = sq + part
    torch.nn.utils.clip_grads_with_norm_(
        whole + [p for ps in sliced.values() for p in ps], clip,
        torch.sqrt(sq))


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


# ---- the member-stacked optimizer of the ensembles (train/ensemble.py) ----
#
# Every member's parameters, gradients and optimizer state are stacked
# [N, ...] (members first).  Each member steps through torch.optim's own
# functional SGD or Adam and clip_grad_norm_'s arithmetic, on its slices
# of the stacked tensors (contiguous views, updated in place), at its own
# lr: on the CPU the single-tensor path, on the card the multi-tensor one,
# as the solo ``optimizer_step`` takes them, so member k's update is the
# solo step's (bitwise where the gradients are, as on the CPU), in a few
# multi-tensor kernels a member.  ``torch.func.grad`` gives a zero
# gradient, not None, to a parameter the loss does not reach; ``reached``
# names the parameters it does, and the others take no step, as the solo
# step skips them (every step of an ensemble reaches the same parameters,
# so none ever has a momentum buffer to coast on, and Adam's zero moments
# would move it by exactly 0).


def member_optimizer_state(params: Dict[str, torch.Tensor],
                           train_cfg: TrainConfig) -> dict:
    """The stacked optimizer state of fresh members: SGD's momentum
    buffers (made at the first step, as torch.optim makes them), or Adam's
    count and moments, every parameter's at 0 (``make_optimizer``)."""
    if train_cfg.optimizer == "SGD":
        return {"momentum_buffer": {}}
    if train_cfg.optimizer == "Adam":
        return {"step": 0,
                "exp_avg": {k: torch.zeros_like(p) for k, p in
                            params.items()},
                "exp_avg_sq": {k: torch.zeros_like(p) for k, p in
                               params.items()}}
    raise ValueError(f"optimizer not supported: {train_cfg.optimizer}")


def _clip_member(grads: list, clip: float) -> None:
    """``clip_grad_norm_``'s arithmetic on one member's gradients."""
    total = torch.nn.utils.get_total_norm(grads, 2.0)
    coef = torch.clamp(clip / (total + 1e-6), max=1.0)
    if grads[0].device.type == "cuda":
        torch._foreach_mul_(grads, coef)
    else:
        for g in grads:
            g.mul_(coef)


def member_optimizer_step(params: Dict[str, torch.Tensor],
                          grads: Dict[str, torch.Tensor], state: dict,
                          lrs: Sequence[float], train_cfg: TrainConfig,
                          reached: Dict[str, bool]) -> None:
    """One optimizer step of every member, in place: clip each member's
    global gradient norm to ``train_cfg.clip_gradient`` (over the reached
    parameters, as ``clip_grad_norm_`` over those with a gradient), then
    Nesterov SGD or Adam at member k's lr ``lrs[k]``."""
    names = [k for k in params if reached[k]]
    wd = train_cfg.weight_decay
    adam = train_cfg.optimizer == "Adam"
    if adam:
        state["step"] += 1
    first = {}  # the momentum buffers the first step makes, by member
    with torch.no_grad():
        for k, lr in enumerate(lrs):
            p_k = [params[n][k] for n in names]
            g_k = [grads[n][k] for n in names]
            if train_cfg.clip_gradient is not None:
                _clip_member(g_k, train_cfg.clip_gradient)
            if adam:
                b1, b2 = _ADAM_BETAS
                # the count before this step: adam() advances it
                steps = [torch.tensor(float(state["step"] - 1),
                                      dtype=_step_dtype()) for _ in names]
                _adam(
                    p_k, g_k, [state["exp_avg"][n][k] for n in names],
                    [state["exp_avg_sq"][n][k] for n in names], [], steps,
                    amsgrad=False, beta1=b1, beta2=b2, lr=float(lr),
                    weight_decay=wd, eps=_ADAM_EPS, maximize=False)
                continue
            bufs = state["momentum_buffer"]
            buf_k = [bufs[n][k] if n in bufs else None for n in names]
            _sgd(p_k, g_k, buf_k, weight_decay=wd,
                 momentum=train_cfg.momentum, lr=float(lr), dampening=0.0,
                 nesterov=True, maximize=False)
            for n, b in zip(names, buf_k):
                if n not in bufs and b is not None:
                    first.setdefault(n, []).append(b)
    if first:
        state["momentum_buffer"].update(
            {n: torch.stack(b) for n, b in first.items()})


def member_solo_optimizer(model: torch.nn.Module, state: dict, k: int,
                          train_cfg: TrainConfig) -> torch.optim.Optimizer:
    """A solo optimizer of ``model`` (member k's parameters, by the
    stacked state's names) holding member k's state: its momentum buffers,
    or its Adam count and moments."""
    opt = make_optimizer(model.parameters(), train_cfg)
    named = dict(model.named_parameters())
    if train_cfg.optimizer == "SGD":
        for name, buf in state["momentum_buffer"].items():
            opt.state[named[name]] = {"momentum_buffer": buf[k].clone()}
        return opt
    for name, p in named.items():
        opt.state[p] = {
            "step": torch.tensor(float(state["step"]), dtype=_step_dtype()),
            "exp_avg": state["exp_avg"][name][k].clone(),
            "exp_avg_sq": state["exp_avg_sq"][name][k].clone()}
    return opt
