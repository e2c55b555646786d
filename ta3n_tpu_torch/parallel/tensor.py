"""Tensor parallelism over the model axis of a (data x model) grid.

The counterpart of `ta3n_tpu/train/step.py::_tp_param_constrainer`, whose
``with_sharding_constraint`` column-shards the planned Dense kernels
``[in, out]`` over the mesh's ``model`` axis and lets GSPMD shard their
optimizer state alike.  Here each planned `models/layers.py::Linear`
(the plan is `train/step.py::tp_plan`) keeps only rows ``[m * o, (m + 1) *
o)`` of its torch weight ``[out, in]`` on model rank m, o = out / M, the
same numbers as the JAX kernel's column block, and becomes
column-parallel (``Linear.tp``).  The biases and every other parameter
stay whole on every rank.  A slice's momentum buffer or Adam moments are
made at its shape, so the optimizer state is sharded with it.

Checkpoints stay whole: ``whole_model`` and ``whole_optimizer_state``
gather the model group's slices (a collective: every rank of the group
calls them), and ``slice_state_dict`` and ``slice_optimizer_state`` cut a
whole state back to a rank's slices, so that a checkpoint loads into a
grid of any M, a 1-D grid or one card.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Mapping

import torch
from torch import nn

from ta3n_tpu_torch.parallel.mesh import Axis, gather_columns

__all__ = ["shard_linears", "sharded_linears", "slice_state_dict",
           "slice_optimizer_state", "whole_model", "whole_optimizer_state",
           "column_rows"]


def column_rows(out_features: int, axis: Axis) -> slice:
    """The rows of a planned weight [out, in] that model rank
    ``axis.rank`` holds."""
    o = out_features // axis.size
    return slice(axis.rank * o, (axis.rank + 1) * o)


def sharded_linears(model: nn.Module) -> Dict[str, nn.Module]:
    """The model's column-parallel Linears, by module name."""
    return {name: m for name, m in model.named_modules()
            if getattr(m, "tp", None) is not None}


@torch.no_grad()
def shard_linears(model: nn.Module, names: Iterable[str],
                  axis: Axis) -> None:
    """Make the Linears ``names`` of ``model`` column-parallel over
    ``axis``: each keeps its rank's rows of the weight (in place, so an
    optimizer over the parameters keeps them), marked with ``tp_axis``.
    A layer already sharded is left as it is."""
    for name in names:
        layer = model.get_submodule(name)
        if layer.tp is not None:
            continue
        if layer.out_features % axis.size:
            raise ValueError(f"{name}: {layer.out_features} outputs do not "
                             f"divide over {axis.size} model ranks")
        rows = column_rows(layer.out_features, axis)
        layer.weight.data = layer.weight.data[rows].clone()
        layer.weight.tp_axis = axis
        layer.tp = axis


def _whole_shape(p: torch.Tensor) -> tuple:
    return (p.shape[0] * p.tp_axis.size,) + tuple(p.shape[1:])


def slice_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Cut to its rank's rows each optimizer state tensor (momentum
    buffer, Adam moments) that a sharded parameter holds at the whole
    weight's shape (a fresh Adam's, or one loaded from a checkpoint)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            axis = getattr(p, "tp_axis", None)
            if axis is None:
                continue
            whole = _whole_shape(p)
            state = optimizer.state.get(p, {})
            for key, v in state.items():
                if torch.is_tensor(v) and tuple(v.shape) == whole:
                    state[key] = v[column_rows(whole[0], axis)].clone()


def slice_state_dict(state_dict: Mapping[str, torch.Tensor],
                     model: nn.Module) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` with each of ``model``'s sharded weights
    cut to this rank's rows: what ``model.load_state_dict`` takes."""
    out = dict(state_dict)
    for name, layer in sharded_linears(model).items():
        key = f"{name}.weight"
        if key in out:
            out[key] = out[key][column_rows(layer.out_features, layer.tp)]
    return out


def _gather_rows_of(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The model group's row blocks of ``t`` in rank order."""
    return gather_columns(t.detach().t(), axis).t().contiguous()


@torch.no_grad()
def whole_model(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every sharded weight gathered whole over
    its model group (a collective) and no longer column-parallel;
    ``model`` itself when nothing is sharded."""
    layers = sharded_linears(model)
    if not layers:
        return model
    whole = copy.deepcopy(model)
    for name, layer in layers.items():
        target = whole.get_submodule(name)
        target.weight = nn.Parameter(_gather_rows_of(layer.weight,
                                                     layer.tp))
        target.tp = None
    return whole


@torch.no_grad()
def whole_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with every sharded parameter's state
    tensors gathered whole over its model group (a collective): the state
    of the one-card optimizer."""
    state = optimizer.state_dict()
    index = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            axis = getattr(p, "tp_axis", None)
            entry = state["state"].get(index)
            if axis is not None and entry is not None:
                state["state"][index] = {
                    k: (_gather_rows_of(v, axis) if torch.is_tensor(v)
                        and tuple(v.shape) == tuple(p.shape) else v)
                    for k, v in entry.items()}
            index += 1
    return state
