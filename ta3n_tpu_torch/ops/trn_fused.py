"""Fused multi-scale TRN: the inference forward, and the training forward
and backward as one autograd Function.

The multi-scale TRN (reference TRNmodule.py:58-82) is, per scale k:
    out_k = sum_j relu( concat(relu(x[:, subset_kj, :])) @ W_k^T + b_k )
summed over min(3, C(S,k)) statically-selected subsets, for k = S..2
(`ops/relation.py`).  Weights are in torch ``nn.Linear`` layout
``[H, k*D]``: the JAX package keeps ``[k*D, H]``
(`ta3n_tpu/io_utils/torch_export.py:37`).

Plain PyTorch versions, which run on any device (CPU tensors take them;
``chip_smoke.py`` holds the kernels against them on the card):

  * ``trn_multiscale_plain``: the forward, differentiable by autograd; the
    counterpart of the JAX package's ``trn_multiscale_reference``.
  * ``trn_multiscale_fwd_masks_plain``: the forward and the relu mask of
    every subset, the counterpart of ``_fused_forward(with_masks=True)``.
  * ``trn_multiscale_bwd_plain``: the backward from those masks, the
    counterpart of ``_fused_bwd_xla`` and of the Pallas ``_bwd_kernel``.

Wrappers of the hand-written CUDA kernels (``csrc/``).  A CUDA tensor
launches the kernel or raises, never falls back; a CPU tensor takes the
plain version.  Each kernel has a count of its launches:

  * ``trn_multiscale_infer`` (``launches``): the inference forward,
    ``csrc/trn_fused_fwd.cu``, the port of the Pallas ``_fwd_kernel``
    with ``with_masks=False``.
  * ``trn_multiscale_fwd_masks`` (``train_launches``): the training
    forward, the same source with the mask write, the port of
    ``_fwd_kernel`` with ``with_masks=True``.
  * ``trn_multiscale_bwd`` (``bwd_launches``): the backward,
    ``csrc/trn_fused_bwd.cu``, the port of ``_bwd_kernel``.

``trn_multiscale_fused`` joins the last two in one
``torch.autograd.Function``, as ``trn_multiscale_fused``'s custom VJP
joins them in the JAX package.  It saves x, the weights and the uint8
masks, never z.

The kernels take any number of frames S >= 2: they read the relation plan
as a table in device memory (``_plan_table``, the layout of
``csrc/trn_plan.cuh``), uploaded once per (S, subsample_num, device), and
the weights and biases through an array of device pointers (one weight
per (scale, position) unit, so that no load in the kernels waits on
another), uploaded once per set of pointers (the optimizer updates the
weights in place, so a training run uploads it once).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ta3n_tpu_torch.ops.relation import build_relation_plan

__all__ = ["trn_multiscale_plain", "trn_multiscale_fwd_masks_plain",
           "trn_multiscale_bwd_plain", "trn_multiscale_infer",
           "trn_multiscale_fwd_masks", "trn_multiscale_bwd",
           "trn_multiscale_fused", "launches", "train_launches",
           "bwd_launches"]

# kernel launches made by each wrapper (plain-version calls are not
# counted); callers reset them to 0 to count the launches of one run
launches = 0          # inference forward, csrc/trn_fused_fwd.cu
train_launches = 0    # training forward, csrc/trn_fused_fwd.cu
bwd_launches = 0      # backward, csrc/trn_fused_bwd.cu

# the kernels take at most 3 subsets per scale (csrc/trn_plan.cuh)
_MAX_SUBSETS = 3

# the forward kernel's tiles (csrc/trn_fused_fwd.cu): unit rows (subset,
# video) and H columns per block, D per chunk; and how many D slices share
# an output tile: as many as _FWD_TARGET_BLOCKS blocks hold, one per SM of
# the H100's 132 (one slice at B=64, 128 blocks, and at B=202, 440: on
# the H100 one slice beat two to eight at B=64 and was within 1% of the
# best at B=202, PERF.md)
_FWD_TILE_M, _FWD_TILE_H, _FWD_TILE_K = 64, 64, 32
_FWD_MAX_SPLITS, _FWD_TARGET_BLOCKS = 8, 132


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


def trn_multiscale_fwd_masks_plain(
        x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor], num_frames: int,
        subsample_num: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain training forward: ``(out [B, S-1, H], masks)``, where masks
    [B, n_sub*H] uint8 holds (z > 0) of every selected subset in the
    plan's order (scale by scale), the comparison that selects what
    ``out`` sums."""
    plan = build_relation_plan(num_frames, subsample_num)
    b, _, d = x.shape
    outs, masks = [], []
    for w, bias, k, subsets, idx in zip(
            weights, biases, plan.scales, plan.subsets,
            _subset_index(num_frames, subsample_num, x.device)):
        g = x.index_select(1, idx).reshape(b, subsets.shape[0], k * d)
        z = torch.relu(g) @ w.T + bias                 # [B, n_sub, H]
        on = z > 0
        outs.append(torch.where(on, z, 0.0).sum(dim=1))
        masks.append(on.reshape(b, -1))
    return torch.stack(outs, dim=1), torch.cat(masks, dim=1).to(torch.uint8)


def trn_multiscale_bwd_plain(
        x: torch.Tensor, weights: Sequence[torch.Tensor],
        masks: torch.Tensor, g: torch.Tensor, num_frames: int,
        subsample_num: int = 3) -> Tuple[torch.Tensor, tuple, tuple]:
    """Plain backward from the forward's masks: ``(dx [B, S, D], dWs, dbs)``
    with dWs[i] [H, k_i*D] (torch layout) and dbs[i] [H], for the upstream
    gradient g [B, S-1, H]."""
    plan = build_relation_plan(num_frames, subsample_num)
    b, _, d = x.shape
    h = weights[0].shape[0]
    xr = torch.relu(x)
    dx = torch.zeros_like(x)
    dws, dbs = [], []
    sub = 0
    for i, (w, k, subsets, idx) in enumerate(zip(
            weights, plan.scales, plan.subsets,
            _subset_index(num_frames, subsample_num, x.device))):
        n = subsets.shape[0]
        m = (masks[:, sub * h:(sub + n) * h].reshape(b, n, h).to(g.dtype)
             * g[:, i, None, :])                       # [B, n_sub, H]
        sub += n
        xs = xr.index_select(1, idx).reshape(b * n, k * d)
        dws.append(m.reshape(b * n, h).T @ xs)
        dbs.append(m.sum(dim=(0, 1)))
        dx.index_add_(1, idx, (m @ w).reshape(b, n * k, d))
    return dx * (x > 0), tuple(dws), tuple(dbs)


@functools.lru_cache(maxsize=None)
def _subset_index(num_frames: int, subsample_num: int,
                  device: torch.device) -> tuple:
    """Per scale, the plan's frame indices as a tensor on ``device``, made
    once: a host-to-device copy per call would stall the stream.  Made as
    normal tensors even when the first call runs under inference mode, so
    that autograd can save them later."""
    plan = build_relation_plan(num_frames, subsample_num)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(s.reshape(-1), device=device)
                     for s in plan.subsets)


@functools.lru_cache(maxsize=None)
def _plan_table(num_frames: int, subsample_num: int) -> np.ndarray:
    """The kernels' relation plan, int32, in the layout of
    ``csrc/trn_plan.cuh``: the header (n_scales, n_units, n_sub_total,
    n_slots); per scale {k, n_sub, sub0, slot0}; per unit (scale i,
    position p) {i, p, n_sub, slot}, {units before it with 1, 2, 3
    subsets, sub0}, {the frame of each subset at p (-1 past n_sub), k};
    per frame its first triple, then the count; and per frame its triples
    (unit << 2 | subset), in the order scale, subset, position."""
    plan = build_relation_plan(num_frames, subsample_num)
    scales, units, first_unit = [], [], []
    sub0 = slot0 = 0
    before = [0, 0, 0, 0]  # units so far with 1, 2, 3 subsets
    for i, (k, subsets) in enumerate(zip(plan.scales, plan.subsets)):
        n = len(subsets)
        scales.append([k, n, sub0, slot0])
        first_unit.append(len(units))
        for p in range(k):
            frames = [int(f) for f in subsets[:, p]] + [-1] * (3 - n)
            units.append([i, p, n, slot0 + p * n, *before[1:], sub0,
                          *frames, k])
            before[n] += 1
        sub0 += n
        slot0 += k * n
    trips = [[] for _ in range(num_frames)]
    for i, (k, subsets) in enumerate(zip(plan.scales, plan.subsets)):
        for j, sub in enumerate(subsets):
            for p, f in enumerate(sub):
                trips[f].append((first_unit[i] + p) << 2 | j)
    trip0 = np.cumsum([0] + [len(t) for t in trips])
    table = np.concatenate([
        [len(scales), len(units), sub0, slot0], np.ravel(scales),
        np.ravel(units), trip0, [c for t in trips for c in t]]
    ).astype(np.int32)
    table.flags.writeable = False  # shared by every call
    return table


@functools.lru_cache(maxsize=None)
def _plan_device(num_frames: int, subsample_num: int,
                 device: torch.device) -> torch.Tensor:
    """``_plan_table`` on ``device``, uploaded once."""
    return torch.as_tensor(_plan_table(num_frames, subsample_num).copy(),
                           device=device)


@functools.lru_cache(maxsize=64)
def _device_ptrs(ptrs: tuple, device: torch.device) -> torch.Tensor:
    """The int64 device pointers ``ptrs`` as an array on ``device``: a
    pinned upload ordered on the current stream, made once per set of
    pointers, so the host never waits for it."""
    host = torch.tensor(ptrs, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def _pointer_args(weights, biases, num_frames: int, subsample_num: int,
                  device: torch.device) -> tuple:
    """The kernels' array of pointers, each unit's weight (its scale's,
    once per position) then each bias, in two copies: on the device, and
    on the host (the C entry checks their alignment)."""
    scales = build_relation_plan(num_frames, subsample_num).scales
    ptrs = tuple(w.data_ptr() for w, k in zip(weights, scales)
                 for _ in range(k)) + tuple(b.data_ptr() for b in biases)
    return (_device_ptrs(ptrs, device).data_ptr(),
            (ctypes.c_void_p * len(ptrs))(*ptrs))


def _plan_args(num_frames: int, subsample_num: int,
               device: torch.device) -> tuple:
    """The plan table's C arguments: host copy, its length, device copy."""
    table = _plan_table(num_frames, subsample_num)
    return (table.ctypes.data, table.size,
            _plan_device(num_frames, subsample_num, device).data_ptr())


@functools.lru_cache(maxsize=None)
def _fwd_units(num_frames: int, subsample_num: int) -> tuple:
    """The forward kernel's work units in its block order: one per (scale
    i, position p), ``(i, p, n_sub_i)``, a GEMM over the n_sub_i*B rows
    (subset j, video) against W_i's D columns of position p.  The unit's
    partials land in the scratch slots slot0_i + p*n_sub_i + j, where
    slot0_i counts the slots of the scales before it."""
    plan = build_relation_plan(num_frames, subsample_num)
    return tuple((i, p, len(sub)) for i, (k, sub) in
                 enumerate(zip(plan.scales, plan.subsets)) for p in range(k))


def _fwd_splits(num_frames: int, subsample_num: int, b: int, d: int,
                h: int) -> int:
    """D slices per output tile of the forward kernel: as many as keep the
    grid within _FWD_TARGET_BLOCKS blocks, at least 1, at most
    _FWD_MAX_SPLITS and at most one per D chunk."""
    h_tiles = -(-h // _FWD_TILE_H)
    tiles = sum(-(-n * b // _FWD_TILE_M) * h_tiles
                for _, _, n in _fwd_units(num_frames, subsample_num))
    return max(1, min(_FWD_MAX_SPLITS, -(-d // _FWD_TILE_K),
                      _FWD_TARGET_BLOCKS // tiles))


def _check_inputs(x, weights, biases, num_frames, subsample_num) -> None:
    """Raise on anything the kernels do not take (``biases`` None: the
    backward, which takes none)."""
    if num_frames < 2:
        raise ValueError(f"the TRN kernel takes 2 or more frames, got "
                         f"{num_frames}")
    plan = build_relation_plan(num_frames, subsample_num)
    if max(len(s) for s in plan.subsets) > _MAX_SUBSETS:
        raise ValueError(f"the TRN kernel takes at most {_MAX_SUBSETS} "
                         f"subsets per scale (subsample_num="
                         f"{subsample_num})")
    if x.dim() != 3 or x.shape[1] != num_frames:
        raise ValueError(f"x must be [B, {num_frames}, D], got "
                         f"{tuple(x.shape)}")
    n_scales = len(plan.scales)
    biases = list(biases) if biases is not None else []
    if len(weights) != n_scales or len(biases) not in (0, n_scales):
        raise ValueError(f"expected {n_scales} weights and biases, got "
                         f"{len(weights)} and {len(biases)}")
    d = x.shape[2]
    h = weights[0].shape[0]
    for t in (x, *weights, *biases):
        _check_tensor(t, x.device, torch.float32)
    for i, (k, w) in enumerate(zip(plan.scales, weights)):
        if tuple(w.shape) != (h, k * d) or (
                biases and tuple(biases[i].shape) != (h,)):
            raise ValueError(
                f"scale k={k}: expected weight {(h, k * d)} and bias "
                f"{(h,)}, got {tuple(w.shape)} and "
                f"{tuple(biases[i].shape) if biases else None}")


def _check_tensor(t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"all tensors must be on {device}, got one on "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"the CUDA kernels take {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")


def _call(entry: str, x: torch.Tensor, *args) -> None:
    """Call a C entry with the current stream of x's device; raise on a
    refused launch."""
    from ta3n_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _launch_fwd(entry, x, weights, biases, num_frames, subsample_num,
                *outs) -> None:
    """The forward kernel and its epilogue into ``outs`` (out, and the
    masks in the training variant), with their scratch of partial z:
    [splits * n_slots, B, H] f32, n_slots = sum_k(k * n_sub_k): 32 slots
    at S=5 (6.6 MB at B=202, H=256), 922 at S=25 (190 MB)."""
    b, s, d = x.shape
    h = weights[0].shape[0]
    splits = _fwd_splits(num_frames, subsample_num, b, d, h)
    slots = sum(n for _, _, n in _fwd_units(num_frames, subsample_num))
    part = torch.empty((splits * slots, b, h), dtype=x.dtype,
                       device=x.device)
    _call(entry, x, x.data_ptr(),
          *_pointer_args(weights, biases, num_frames, subsample_num,
                         x.device),
          *(t.data_ptr() for t in outs), part.data_ptr(),
          *_plan_args(num_frames, subsample_num, x.device), b, s, d, h,
          splits)


def _launch(x, weights, biases, num_frames, subsample_num) -> torch.Tensor:
    """The inference forward kernel."""
    global launches
    _check_inputs(x, weights, biases, num_frames, subsample_num)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError(
            "trn_multiscale_infer's CUDA kernel has no backward; call it "
            "under torch.no_grad() or torch.inference_mode(), or train "
            "through trn_multiscale_fused")
    b, s, _ = x.shape
    h = weights[0].shape[0]
    out = torch.empty((b, s - 1, h), dtype=x.dtype, device=x.device)
    if b == 0:  # a grid of 0 blocks is refused
        return out
    _launch_fwd("ta3n_trn_fused_fwd_f32", x, weights, biases, num_frames,
                subsample_num, out)
    launches += 1
    return out


def _n_subsets(num_frames: int, subsample_num: int) -> int:
    return sum(len(sub) for sub in
               build_relation_plan(num_frames, subsample_num).subsets)


def _launch_train(x, weights, biases, num_frames, subsample_num
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward kernel: (out, uint8 masks)."""
    global train_launches
    _check_inputs(x, weights, biases, num_frames, subsample_num)
    b, s, _ = x.shape
    h = weights[0].shape[0]
    n_sub = _n_subsets(num_frames, subsample_num)
    out = torch.empty((b, s - 1, h), dtype=x.dtype, device=x.device)
    masks = torch.empty((b, n_sub * h), dtype=torch.uint8, device=x.device)
    if b == 0:  # a grid of 0 blocks is refused
        return out, masks
    _launch_fwd("ta3n_trn_fused_fwd_train_f32", x, weights, biases,
                num_frames, subsample_num, out, masks)
    train_launches += 1
    return out, masks


def _launch_bwd(x, weights, masks, g, num_frames, subsample_num
                ) -> Tuple[torch.Tensor, tuple, tuple]:
    """The backward kernel (one grid of dx and dW/db tiles): (dx, dWs,
    dbs)."""
    global bwd_launches
    _check_inputs(x, weights, None, num_frames, subsample_num)
    b, s, d = x.shape
    h = weights[0].shape[0]
    n_sub = _n_subsets(num_frames, subsample_num)
    _check_tensor(masks, x.device, torch.uint8)
    _check_tensor(g, x.device, torch.float32)
    if tuple(masks.shape) != (b, n_sub * h) or \
            tuple(g.shape) != (b, s - 1, h):
        raise ValueError(f"expected masks {(b, n_sub * h)} and g "
                         f"{(b, s - 1, h)}, got {tuple(masks.shape)} and "
                         f"{tuple(g.shape)}")
    dx = torch.empty_like(x)
    # every dW_i side by side in one buffer, every db_i in another
    dw = torch.empty((sum(w.numel() for w in weights),), dtype=x.dtype,
                     device=x.device)
    db = torch.empty((len(weights), h), dtype=x.dtype, device=x.device)
    _call("ta3n_trn_fused_bwd_f32", x, x.data_ptr(),
          *_pointer_args(weights, (), num_frames, subsample_num, x.device),
          masks.data_ptr(), g.data_ptr(),
          dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
          *_plan_args(num_frames, subsample_num, x.device), b, s, d, h)
    bwd_launches += 1
    return dx, _split_flat(dw, weights), tuple(db.unbind())


def _split_flat(flat: torch.Tensor, like) -> tuple:
    """Views of ``flat`` shaped as the tensors ``like``, side by side."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def _no_kernel(name: str, device: torch.device) -> ValueError:
    return ValueError(f"{name}: no kernel for device {device}")


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
    raise _no_kernel("trn_multiscale_infer", x.device)


def trn_multiscale_fwd_masks(x: torch.Tensor,
                             weights: Sequence[torch.Tensor],
                             biases: Sequence[torch.Tensor], num_frames: int,
                             subsample_num: int = 3
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: ``(out [B, S-1, H], uint8 masks [B, n_sub*H])``.

    A CUDA ``x`` launches the hand-written kernel (float32, contiguous, on
    one device; anything else raises).  A CPU ``x`` takes
    ``trn_multiscale_fwd_masks_plain``.  Not differentiable itself: train
    through ``trn_multiscale_fused``.
    """
    if x.device.type == "cuda":
        return _launch_train(x, weights, biases, num_frames, subsample_num)
    if x.device.type == "cpu":
        return trn_multiscale_fwd_masks_plain(x, weights, biases, num_frames,
                                              subsample_num)
    raise _no_kernel("trn_multiscale_fwd_masks", x.device)


def trn_multiscale_bwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       masks: torch.Tensor, g: torch.Tensor, num_frames: int,
                       subsample_num: int = 3
                       ) -> Tuple[torch.Tensor, tuple, tuple]:
    """Backward from the training forward's masks: ``(dx, dWs, dbs)`` for
    the upstream gradient g [B, S-1, H], dWs in the torch layout.

    A CUDA ``x`` launches the hand-written kernel (g may be
    non-contiguous; anything else it does not take raises).  A CPU ``x``
    takes ``trn_multiscale_bwd_plain``.
    """
    if x.device.type == "cuda":
        return _launch_bwd(x, weights, masks, g.contiguous(), num_frames,
                           subsample_num)
    if x.device.type == "cpu":
        return trn_multiscale_bwd_plain(x, weights, masks, g, num_frames,
                                        subsample_num)
    raise _no_kernel("trn_multiscale_bwd", x.device)


class _TRNFused(torch.autograd.Function):
    """The training forward (out and masks) and the backward from the
    masks."""

    @staticmethod
    def forward(ctx, x, num_frames, subsample_num, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        out, masks = trn_multiscale_fwd_masks(x, weights, biases, num_frames,
                                              subsample_num)
        ctx.save_for_backward(x, masks, *weights)
        ctx.plan = (num_frames, subsample_num)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, masks, *weights = ctx.saved_tensors
        dx, dws, dbs = trn_multiscale_bwd(x, weights, masks, g, *ctx.plan)
        return (dx, None, None, *dws, *dbs)


def trn_multiscale_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_frames: int,
                         subsample_num: int = 3) -> torch.Tensor:
    """Differentiable fused forward: [B, S, D] -> [B, S-1, H].

    Its forward is ``trn_multiscale_fwd_masks`` and its backward
    ``trn_multiscale_bwd``: on a CUDA ``x`` the two kernels, which raise
    on what they do not take and never fall back; on a CPU ``x`` their
    plain versions.
    """
    return _TRNFused.apply(x, num_frames, subsample_num, *weights, *biases)
