"""Fused multi-scale TRN forward, inference variant.

The multi-scale TRN (reference TRNmodule.py:58-82) is, per scale k:
    out_k = sum_j relu( concat(relu(x[:, subset_kj, :])) @ W_k^T + b_k )
summed over min(3, C(S,k)) statically-selected subsets, for k = S..2
(`ops/relation.py`).  Weights are in torch ``nn.Linear`` layout
``[H, k*D]``: the JAX package keeps ``[k*D, H]``
(`ta3n_tpu/io_utils/torch_export.py:37`).

Two versions of one function:

  * ``trn_multiscale_plain``: plain PyTorch, the counterpart of the JAX
    package's ``trn_multiscale_reference``.  It runs on any device and is
    differentiable.
  * ``trn_multiscale_infer``: the wrapper of the hand-written CUDA kernel
    ``csrc/trn_fused_fwd.cu`` (the port of the Pallas kernel
    ``ta3n_tpu/ops/trn_fused.py::_fwd_kernel``, inference variant).  A
    CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
    version.  ``launches`` counts kernel launches.

The training variant (relu masks) and the fused backward are not ported
yet; see ROADMAP.md.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ta3n_tpu_torch.ops.relation import build_relation_plan

__all__ = ["trn_multiscale_plain", "trn_multiscale_infer", "launches"]

# kernel launches made by trn_multiscale_infer (plain-version calls are not
# counted); callers reset it to 0 to count the launches of one run
launches = 0

# limits of the kernel's by-value plan (csrc/trn_fused_fwd.cu)
_MAX_FRAMES = 16
_MAX_SUBSETS = 3


def trn_multiscale_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_frames: int,
                         subsample_num: int = 3) -> torch.Tensor:
    """Plain PyTorch multi-scale TRN.  x: [B, S, D]; weights[i]: [H, k_i*D];
    biases[i]: [H] -> [B, S-1, H]."""
    plan = build_relation_plan(num_frames, subsample_num)
    b, _, d = x.shape
    outs = []
    for w, bias, k, subsets, idx in zip(
            weights, biases, plan.scales, plan.subsets,
            _subset_index(num_frames, subsample_num, x.device)):
        g = x.index_select(1, idx).reshape(b, subsets.shape[0], k * d)
        z = torch.relu(g) @ w.T + bias
        outs.append(torch.relu(z).sum(dim=1))
    return torch.stack(outs, dim=1)


@functools.lru_cache(maxsize=None)
def _subset_index(num_frames: int, subsample_num: int,
                  device: torch.device) -> tuple:
    """Per scale, the plan's frame indices as a tensor on ``device``, made
    once: a host-to-device copy per call would stall the stream."""
    plan = build_relation_plan(num_frames, subsample_num)
    return tuple(torch.as_tensor(s.reshape(-1), device=device)
                 for s in plan.subsets)


@functools.lru_cache(maxsize=None)
def _plan_table(num_frames: int, subsample_num: int) -> np.ndarray:
    """The kernel's plan: for each scale, k, n_sub, then n_sub*k frame
    indices (int32)."""
    plan = build_relation_plan(num_frames, subsample_num)
    table = []
    for k, subsets in zip(plan.scales, plan.subsets):
        table += [k, subsets.shape[0], *subsets.reshape(-1).tolist()]
    table = np.asarray(table, dtype=np.int32)
    table.flags.writeable = False  # shared by every call
    return table


def _check_inputs(x, weights, biases, num_frames, subsample_num) -> None:
    """Raise on anything the kernel does not take."""
    if not 2 <= num_frames <= _MAX_FRAMES:
        raise ValueError(f"the TRN kernel takes 2..{_MAX_FRAMES} frames, "
                         f"got {num_frames}")
    plan = build_relation_plan(num_frames, subsample_num)
    if max(len(s) for s in plan.subsets) > _MAX_SUBSETS:
        raise ValueError(f"the TRN kernel takes at most {_MAX_SUBSETS} "
                         f"subsets per scale (subsample_num="
                         f"{subsample_num})")
    if x.dim() != 3 or x.shape[1] != num_frames:
        raise ValueError(f"x must be [B, {num_frames}, D], got "
                         f"{tuple(x.shape)}")
    n_scales = len(plan.scales)
    if len(weights) != n_scales or len(biases) != n_scales:
        raise ValueError(f"expected {n_scales} weights and biases, got "
                         f"{len(weights)} and {len(biases)}")
    d = x.shape[2]
    h = weights[0].shape[0]
    for t in (x, *weights, *biases):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, "
                             f"got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the TRN kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the TRN kernel takes contiguous tensors")
    for k, w, bias in zip(plan.scales, weights, biases):
        if tuple(w.shape) != (h, k * d) or tuple(bias.shape) != (h,):
            raise ValueError(
                f"scale k={k}: expected weight {(h, k * d)} and bias "
                f"{(h,)}, got {tuple(w.shape)} and {tuple(bias.shape)}")


def _launch(x, weights, biases, num_frames, subsample_num) -> torch.Tensor:
    global launches
    _check_inputs(x, weights, biases, num_frames, subsample_num)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError(
            "trn_multiscale_infer's CUDA kernel has no backward; call it "
            "under torch.no_grad() or torch.inference_mode()")
    from ta3n_tpu_torch.ops._build import load_library

    b, s, d = x.shape
    h = weights[0].shape[0]
    out = torch.empty((b, s - 1, h), dtype=x.dtype, device=x.device)
    if b == 0:  # a grid of 0 blocks is refused
        return out
    lib = load_library()
    table = _plan_table(num_frames, subsample_num)
    w_ptrs = (ctypes.c_void_p * len(weights))(
        *[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * len(biases))(
        *[bi.data_ptr() for bi in biases])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ta3n_trn_fused_fwd_f32(
            x.data_ptr(), ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
            out.data_ptr(), table.ctypes.data, b, s, d, h, stream)
    if err != 0:
        raise RuntimeError(f"trn_fused_fwd launch failed: CUDA error {err}")
    launches += 1
    return out


def trn_multiscale_infer(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_frames: int,
                         subsample_num: int = 3) -> torch.Tensor:
    """Inference-only fused forward: [B, S, D] -> [B, S-1, H].

    A CUDA ``x`` launches the hand-written kernel (float32, contiguous, on
    one device; anything else raises, and so does a call that would need
    a gradient).  A CPU ``x`` takes ``trn_multiscale_plain``.
    """
    if x.device.type == "cuda":
        return _launch(x, weights, biases, num_frames, subsample_num)
    if x.device.type == "cpu":
        return trn_multiscale_plain(x, weights, biases, num_frames,
                                    subsample_num)
    raise ValueError(f"trn_multiscale_infer: no kernel for device "
                     f"{x.device}")
