"""Fused multi-scale TRN: the inference forward, and the training forward
and backward as one autograd Function.

The multi-scale TRN (reference TRNmodule.py:58-82) is, per scale k:
    out_k = sum_j relu( concat(relu(x[:, subset_kj, :])) @ W_k^T + b_k )
summed over min(3, C(S,k)) statically-selected subsets, for k = S..2
(`ops/relation.py`).  Weights are in torch ``nn.Linear`` layout
``[H, k*D]``: the JAX package keeps ``[k*D, H]``
(`ta3n_tpu/io_utils/torch_export.py:37`).

Every function takes float32 or bfloat16 tensors, x, the weights and the
biases of one dtype (the plain versions any float dtype).  bfloat16
computes as the JAX package's Pallas
kernels do on bfloat16 operands: every product exact in float32, sums in
float32, the bias added in float32, the relu masks taken from the float32
z, and the outputs rounded to bfloat16 once (the backward's dx, dW and db
too, as `ta3n_tpu/ops/trn_fused.py:287, 310-312` round them).

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
plain version.  Each kernel has a count of its launches, float32 and
bfloat16 variants apart:

  * ``trn_multiscale_infer`` (``launches``, ``bf16_launches``): the
    inference forward, ``csrc/trn_fused_fwd.cu`` (float32) and
    ``csrc/trn_fused_fwd_bf16.cu`` (bfloat16, on ``wgmma``), the port of
    the Pallas ``_fwd_kernel`` with ``with_masks=False``.
  * ``trn_multiscale_fwd_masks`` (``train_launches``,
    ``bf16_train_launches``): the training forward, the same sources with
    the mask write, the port of ``_fwd_kernel`` with ``with_masks=True``.
  * ``trn_multiscale_bwd`` (``bwd_launches``, ``bf16_bwd_launches``): the
    backward, ``csrc/trn_fused_bwd.cu`` (float32) and
    ``csrc/trn_fused_bwd_bf16.cu`` (bfloat16, on ``wgmma``), the port of
    ``_bwd_kernel``.

``trn_multiscale_fused`` joins the last two in one
``torch.autograd.Function``, as ``trn_multiscale_fused``'s custom VJP
joins them in the JAX package.  It saves x, the weights and the uint8
masks, never z.

The member axis (the ensembles of `train/ensemble.py`, the counterpart of
``jax.vmap`` giving each ``pallas_call`` a grid axis over members):
``trn_multiscale_infer_members``, ``trn_multiscale_fwd_masks_members`` and
``trn_multiscale_bwd_members`` take N members' stacked inputs ([N, ...],
members first) and launch the kernels, float32 or bfloat16, once for all
of them, one grid row (``blockIdx.y``) a member, each member's blocks on
the grid of a one-member launch; a solo call is the same launch with one
member (one launch path a kernel, one count a dtype).  They check their
inputs on every device and take the plain versions member by member on
CPU tensors.  The Functions are in
the ``setup_context`` form and carry vmap rules, so that
``torch.func.vmap`` over stacked weights runs those wrappers: the
training forward (``_TRNFused``), its backward (``_TRNBackward``, which
the backward calls under a transform: batched tensors have no data
pointer) and the inference forward (``_TRNInfer``, taken only under a
transform).

The kernels take any number of frames S >= 2: they read the relation plan
as a table in device memory (``_plan_table``, the layout of
``csrc/trn_plan.cuh``), uploaded once per (S, subsample_num, device), and
the weights and biases through an array of device pointers (one weight
per (scale, position) unit, so that no load in the kernels waits on
another), uploaded once per set of pointers (the optimizer updates the
weights in place, so a training run uploads it once).  The bfloat16
kernels read the weights by TMA through a tensor map of each scale's
members' weights ([N, H, k*D], the member the outermost coordinate), made
once per weight and member count and passed by value at each launch, so
they take at most ``BF16_MAX_SCALES`` scales (S - 1) whatever N is.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ta3n_tpu_torch.ops.relation import build_relation_plan

__all__ = ["trn_multiscale_plain", "trn_multiscale_fwd_masks_plain",
           "trn_multiscale_bwd_plain", "trn_multiscale_infer",
           "trn_multiscale_fwd_masks", "trn_multiscale_bwd",
           "trn_multiscale_fused", "trn_multiscale_infer_members",
           "trn_multiscale_fwd_masks_members", "trn_multiscale_bwd_members",
           "bf16_fwd_grid", "bf16_bwd_grid", "BF16_MAX_SCALES",
           "f32_fwd_scratch", "F32BwdPlan", "f32_bwd_plan",
           "launches", "train_launches", "bwd_launches", "bf16_launches",
           "bf16_train_launches", "bf16_bwd_launches"]

# kernel launches made by each wrapper (plain-version calls are not
# counted); callers reset them to 0 to count the launches of one run
launches = 0          # inference forward, csrc/trn_fused_fwd.cu
train_launches = 0    # training forward, csrc/trn_fused_fwd.cu
bwd_launches = 0      # backward, csrc/trn_fused_bwd.cu
bf16_launches = 0        # the same three, bfloat16 variants:
bf16_train_launches = 0  # csrc/trn_fused_fwd_bf16.cu
bf16_bwd_launches = 0    # csrc/trn_fused_bwd_bf16.cu

# the kernels' element types, and the suffix of their C entries
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# the kernels take at most 3 subsets per scale (csrc/trn_plan.cuh)
_MAX_SUBSETS = 3

# the float32 kernels on wgmma (csrc/trn_fused_fwd.cu, trn_fused_bwd.cu,
# and K3's csrc/gather_gemm.cu): a block's output tile (128 x 128: two
# consumer warpgroups of 64 rows of the register operand, 128 rows of the
# shared one), its 32-deep K chunks, and the thread block clusters of
# 1..16 of its blocks (one an SM) that the H100 holds at once
# (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3:
# scripts/torch_port_tensor_core_probe.py k3-clusters), which bound a
# tile's K slices (one cluster); the most scales their weights' tensor
# maps take by value (csrc/wgmma_bf16.cuh, kMaxWeightMaps), past which,
# as for D not a multiple of 4 or a weight not 16-byte aligned, the
# kernels copy the weights into rows TMA can read
_F32_TILE, _F32_TILE_K = 128, 32
_F32_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)
_F32_MAP_SCALES = 32
# scratch offsets in float32 values (256 bytes)
_F32_ALIGN = 64
# the most D slices of a forward output tile the bfloat16 kernel takes
_FWD_MAX_SPLITS = 8

# the bfloat16 forward kernel's tiles (csrc/trn_fused_fwd_bf16.cu): 64
# videos of one subset by 128 H columns a block, D in chunks of 64; D
# slices are added while the grid stays within _BF16_FWD_TARGET_BLOCKS,
# one block an SM (two slices at B = 1 and 64, S=5: within 2% of one on
# the H100, and three or more slower, PERF.md)
_BF16_FWD_TILE_M, _BF16_FWD_TILE_H, _BF16_FWD_TILE_K = 64, 128, 64
_BF16_FWD_TARGET_BLOCKS = 132
# the bfloat16 backward kernel's tiles (csrc/trn_fused_bwd_bf16.cu): 64
# videos (dx) or 64 H rows (dW) by 128 D columns a block
_BF16_BWD_TILE_M, _BF16_BWD_TILE_N = 64, 128

# the most scales (S - 1) the bfloat16 kernels take: their weights' tensor
# maps are a kernel parameter of fixed size (csrc/wgmma_bf16.cuh,
# kMaxWeightMaps)
BF16_MAX_SCALES = 32


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type its products are summed in: bfloat16 as float32,
    any other type as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def trn_multiscale_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_frames: int,
                         subsample_num: int = 3) -> torch.Tensor:
    """Plain PyTorch multi-scale TRN.  x: [B, S, D]; weights[i]: [H, k_i*D];
    biases[i]: [H] -> [B, S-1, H] in x's dtype, computed in float32."""
    plan = build_relation_plan(num_frames, subsample_num)
    b, _, d = x.shape
    outs = []
    for w, bias, k, subsets, idx in zip(
            weights, biases, plan.scales, plan.subsets,
            _subset_index(num_frames, subsample_num, x.device)):
        g = _acc(x).index_select(1, idx).reshape(b, subsets.shape[0], k * d)
        z = torch.relu(g) @ _acc(w).T + _acc(bias)
        outs.append(torch.relu(z).sum(dim=1))
    return torch.stack(outs, dim=1).to(x.dtype)


def trn_multiscale_fwd_masks_plain(
        x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor], num_frames: int,
        subsample_num: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain training forward: ``(out [B, S-1, H], masks)``, where masks
    [B, n_sub*H] uint8 holds (z > 0) of every selected subset in the
    plan's order (scale by scale), the comparison that selects what
    ``out`` sums; z in float32, out in x's dtype."""
    plan = build_relation_plan(num_frames, subsample_num)
    b, _, d = x.shape
    outs, masks = [], []
    for w, bias, k, subsets, idx in zip(
            weights, biases, plan.scales, plan.subsets,
            _subset_index(num_frames, subsample_num, x.device)):
        g = _acc(x).index_select(1, idx).reshape(b, subsets.shape[0], k * d)
        z = torch.relu(g) @ _acc(w).T + _acc(bias)     # [B, n_sub, H]
        on = z > 0
        outs.append(torch.where(on, z, 0.0).sum(dim=1))
        masks.append(on.reshape(b, -1))
    return (torch.stack(outs, dim=1).to(x.dtype),
            torch.cat(masks, dim=1).to(torch.uint8))


def trn_multiscale_bwd_plain(
        x: torch.Tensor, weights: Sequence[torch.Tensor],
        masks: torch.Tensor, g: torch.Tensor, num_frames: int,
        subsample_num: int = 3) -> Tuple[torch.Tensor, tuple, tuple]:
    """Plain backward from the forward's masks: ``(dx [B, S, D], dWs, dbs)``
    with dWs[i] [H, k_i*D] (torch layout) and dbs[i] [H], for the upstream
    gradient g [B, S-1, H]; computed in float32, dx returned in x's dtype
    and dWs, dbs in the weights'."""
    plan = build_relation_plan(num_frames, subsample_num)
    b, _, d = x.shape
    h = weights[0].shape[0]
    xf = _acc(x)
    xr = torch.relu(xf)
    dx = torch.zeros_like(xf)
    dws, dbs = [], []
    sub = 0
    for i, (w, k, subsets, idx) in enumerate(zip(
            weights, plan.scales, plan.subsets,
            _subset_index(num_frames, subsample_num, x.device))):
        n = subsets.shape[0]
        m = (masks[:, sub * h:(sub + n) * h].reshape(b, n, h).to(xf.dtype)
             * _acc(g[:, i, None, :]))                 # [B, n_sub, H]
        sub += n
        xs = xr.index_select(1, idx).reshape(b * n, k * d)
        dws.append((m.reshape(b * n, h).T @ xs).to(w.dtype))
        dbs.append(m.sum(dim=(0, 1)).to(w.dtype))
        dx.index_add_(1, idx, (m @ _acc(w)).reshape(b, n * k, d))
    return (dx * (xf > 0)).to(x.dtype), tuple(dws), tuple(dbs)


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


def _f32_splits(tiles: int, chunks: int) -> int:
    """K slices of a float32 kernel's tiles, one cluster a tile: the most
    (up to 16, at most one per 32-deep chunk) whose clusters over
    ``tiles`` tiles the card holds at once (_F32_CLUSTERS; 1 where even
    single blocks take more than one wave)."""
    return max([s for s, held in enumerate(_F32_CLUSTERS, 1)
                if s <= chunks and tiles <= held], default=1)


def _f32_fwd_width(b: int) -> int:
    """Videos a tile of the float32 forward GEMM: 128, or at B <= 64 the
    power of two from 8 that holds B (its products m64nNk8)."""
    return next((n for n in (8, 16, 32, 64) if b <= n), _F32_TILE)


def _fwd_splits(num_frames: int, subsample_num: int, b: int, d: int,
                h: int) -> int:
    """D slices of the float32 forward GEMM's tiles (one a scratch slot,
    128 H columns and _f32_fwd_width(B) videos), chosen by one member's
    shape: _f32_splits over the D chunks."""
    slots = sum(n for _, _, n in _fwd_units(num_frames, subsample_num))
    tiles = slots * -(-h // _F32_TILE) * -(-b // _f32_fwd_width(b))
    return _f32_splits(tiles, -(-d // _F32_TILE_K))


def _f32_aligned(n: int) -> int:
    return -(-n // _F32_ALIGN) * _F32_ALIGN


def _f32_by_unit(weights, d: int) -> bool:
    """Whether the float32 kernels copy the weights into rows first
    (csrc/tf32_wgmma.cuh::trn_weights): D not a multiple of 4, a weight not
    16-byte aligned, or more scales than the kernels' maps."""
    return (d % 4 != 0 or len(weights) > _F32_MAP_SCALES
            or any(w.data_ptr() % 16 for w in weights))


def f32_fwd_scratch(num_frames: int, subsample_num: int, b: int, d: int,
                    h: int, members: int = 1, by_unit: bool = False) -> int:
    """Float32 values of the float32 forward's scratch: the slot partials
    [members, n_slots, B, H], relu(x)'s TF32 hi and lo planes [members *
    S, B, P] each (P = D up to 4s), then, ``by_unit``, every unit's
    weight slice in rows [members, H, n_units, P]."""
    units = _fwd_units(num_frames, subsample_num)
    slots = sum(n for _, _, n in units)
    pitch = -(-d // 4) * 4
    planes = 2 * members * num_frames * b * pitch
    return (_f32_aligned(members * slots * b * h) + planes
            + (members * h * len(units) * pitch if by_unit else 0))


class F32BwdPlan(NamedTuple):
    """A call of the float32 backward (csrc/trn_fused_bwd.cu)."""

    dx_tiles: int   # one member's GEMM grid: the dx tiles, then the dW
    dw_tiles: int   # tiles (x), members (y), K slices (z, a cluster)
    splits: int
    scratch: int    # float32 values: m's planes, relu(x)^T's, W's rows


def f32_bwd_plan(num_frames: int, subsample_num: int, b: int, d: int,
                 h: int, members: int = 1,
                 by_unit: bool = False) -> F32BwdPlan:
    """The float32 backward for B videos, D features and H outputs.  Its
    GEMM's tiles: dx, per frame 128 D columns x 128 videos over the
    frame's triples' H; dW, per (scale, position) unit 128 H rows x 128 D
    columns over the scale's subsets' videos.  Every tile's K is cut into
    the same slices, one cluster a tile, chosen by one member's dx tiles
    (_f32_splits over the shortest dx tile's chunks).  Scratch: m's TF32
    hi and lo planes [members * n_sub, B, H'] each, m^T [members * n_sub,
    H, B'], relu(x)^T's hi and lo planes [members * S, D, B'] each (H', B'
    the widths up to 4s), then, ``by_unit``, every unit's weight slice in
    rows [members, H, n_units, P]."""
    units = _fwd_units(num_frames, subsample_num)
    trips = collections.Counter(
        int(f) for sub in build_relation_plan(num_frames,
                                              subsample_num).subsets
        for f in sub.reshape(-1))
    tiles_d = -(-d // _F32_TILE)
    dx_tiles = -(-b // _F32_TILE) * tiles_d * num_frames
    dw_tiles = len(units) * -(-h // _F32_TILE) * tiles_d
    h_chunks = -(-h // _F32_TILE_K)
    splits = _f32_splits(dx_tiles, min(trips.values()) * h_chunks) \
        if b else 1
    n_sub = _n_subsets(num_frames, subsample_num)
    m_planes = 2 * members * n_sub * b * -(-h // 4) * 4
    m_t = members * n_sub * h * -(-b // 4) * 4
    x_planes = 2 * members * num_frames * d * -(-b // 4) * 4
    pitch = -(-d // 4) * 4
    scratch = (_f32_aligned(m_planes) + _f32_aligned(m_t)
               + _f32_aligned(x_planes)
               + (members * h * len(units) * pitch if by_unit else 0))
    return F32BwdPlan(dx_tiles, dw_tiles, splits, scratch)


def bf16_fwd_grid(num_frames: int, subsample_num: int, b: int, d: int,
                  h: int) -> Tuple[int, int, int]:
    """The bfloat16 forward kernel's grid for B videos, D features and H
    outputs: (row tiles of 64 videos, H tiles of 128, D slices).  Its
    blocks are one per scratch slot (a subset of a (scale, position) unit,
    ``_fwd_units``), row tile, H tile and D slice; D is split only where
    the tiles leave SMs of the H100 without a block: into as many slices as
    keep the grid within _BF16_FWD_TARGET_BLOCKS, at least 1, at most
    _FWD_MAX_SPLITS and at most one per 64-deep chunk."""
    row_tiles = -(-b // _BF16_FWD_TILE_M)
    h_tiles = -(-h // _BF16_FWD_TILE_H)
    slots = sum(n for _, _, n in _fwd_units(num_frames, subsample_num))
    room = _BF16_FWD_TARGET_BLOCKS // (slots * row_tiles * h_tiles)
    return row_tiles, h_tiles, max(1, min(_FWD_MAX_SPLITS,
                                          -(-d // _BF16_FWD_TILE_K), room))


def _check_inputs(x, weights, biases, num_frames, subsample_num) -> None:
    """Raise on anything the kernels do not take (``biases`` None: the
    backward, which takes none)."""
    if num_frames < 2:
        raise ValueError(f"the TRN kernel takes 2 or more frames, got "
                         f"{num_frames}")
    if x.dtype == torch.bfloat16 and num_frames - 1 > BF16_MAX_SCALES:
        raise ValueError(
            f"the bfloat16 TRN kernels take at most {BF16_MAX_SCALES} "
            f"scales (num_frames <= {BF16_MAX_SCALES + 1}: one tensor map "
            f"per scale in a kernel parameter), got num_frames={num_frames}")
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
    if x.dtype not in _SUFFIX:
        raise TypeError(f"the TRN kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in (x, *weights, *biases):
        _check_tensor(t, x.device, x.dtype)
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
        raise TypeError(f"this CUDA kernel takes {dtype} here, got "
                        f"{t.dtype}")
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
    """The forward kernels into ``outs`` (out, and the masks in the
    training variant), with their scratch: float32, ``f32_fwd_scratch``
    (the slot partials of z, relu(x)'s planes, the weights' rows where the
    kernel copies them); bfloat16, the partials [splits * n_slots, B, H]
    f32 a member.  Both take stacked inputs (x [N, B, S, D], each weight
    [N, H, k*D] and bias [N, H], members first) and their grid (float32:
    its D slices, ``_fwd_splits``; bfloat16: ``bf16_fwd_grid``) chosen by
    one member's shape, so each member's blocks do a one-member launch's
    work."""
    n, b, s, d = x.shape
    h = weights[0].shape[-2]
    if x.dtype == torch.bfloat16:
        grid = bf16_fwd_grid(num_frames, subsample_num, b, d, h)
        slots = sum(c for _, _, c in _fwd_units(num_frames, subsample_num))
        size = n * grid[-1] * slots * b * h
    else:
        grid = (_fwd_splits(num_frames, subsample_num, b, d, h),)
        size = f32_fwd_scratch(num_frames, subsample_num, b, d, h, n,
                               _f32_by_unit(weights, d))
    part = torch.empty((size,), dtype=torch.float32, device=x.device)
    _call(entry, x, x.data_ptr(),
          *_pointer_args(weights, biases, num_frames, subsample_num,
                         x.device),
          *(t.data_ptr() for t in outs), part.data_ptr(),
          *_plan_args(num_frames, subsample_num, x.device), b, s, d, h,
          *grid, n)


def _one(t: torch.Tensor) -> torch.Tensor:
    """An unstacked tensor as a stack of one member (a view)."""
    return t[None]


def _launch(x, weights, biases, num_frames, subsample_num) -> torch.Tensor:
    """The inference forward kernel: one member of ``_infer_kernel``."""
    _check_inputs(x, weights, biases, num_frames, subsample_num)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights, *biases)):
        raise RuntimeError(
            "trn_multiscale_infer's CUDA kernel has no backward; call it "
            "under torch.no_grad() or torch.inference_mode(), or train "
            "through trn_multiscale_fused")
    return _infer_kernel(_one(x), [_one(w) for w in weights],
                         [_one(b) for b in biases], num_frames,
                         subsample_num)[0]


def _infer_kernel(x, weights, biases, num_frames, subsample_num
                  ) -> torch.Tensor:
    """The inference forward on checked stacked inputs (x [N, B, S, D]):
    one launch for every member, [N, B, S-1, H]."""
    global launches, bf16_launches
    n, b = x.shape[:2]
    out = torch.empty((n, b, num_frames - 1, weights[0].shape[1]),
                      dtype=x.dtype, device=x.device)
    if b == 0:  # a grid of 0 blocks is refused
        return out
    _launch_fwd(f"ta3n_trn_fused_fwd_{_SUFFIX[x.dtype]}", x, weights,
                biases, num_frames, subsample_num, out)
    if x.dtype == torch.float32:
        launches += 1
    else:
        bf16_launches += 1
    return out


def _n_subsets(num_frames: int, subsample_num: int) -> int:
    return sum(len(sub) for sub in
               build_relation_plan(num_frames, subsample_num).subsets)


def _launch_train(x, weights, biases, num_frames, subsample_num
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward kernel: (out, uint8 masks), one member of
    ``_train_kernel``."""
    _check_inputs(x, weights, biases, num_frames, subsample_num)
    out, masks = _train_kernel(_one(x), [_one(w) for w in weights],
                               [_one(b) for b in biases], num_frames,
                               subsample_num)
    return out[0], masks[0]


def _train_kernel(x, weights, biases, num_frames, subsample_num
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward on checked stacked inputs (x [N, B, S, D]):
    out and masks with the members first, one launch for every member."""
    global train_launches, bf16_train_launches
    n, b, s = x.shape[:3]
    h = weights[0].shape[-2]
    n_sub = _n_subsets(num_frames, subsample_num)
    out = torch.empty((n, b, s - 1, h), dtype=x.dtype, device=x.device)
    masks = torch.empty((n, b, n_sub * h), dtype=torch.uint8,
                        device=x.device)
    if b == 0:  # a grid of 0 blocks is refused
        return out, masks
    _launch_fwd(f"ta3n_trn_fused_fwd_train_{_SUFFIX[x.dtype]}", x, weights,
                biases, num_frames, subsample_num, out, masks)
    if x.dtype == torch.float32:
        train_launches += 1
    else:
        bf16_train_launches += 1
    return out, masks


def _check_bwd(x, weights, masks, g, num_frames, subsample_num) -> None:
    """Raise on masks or g that do not fit x [..., B, S, D] and the
    weights [..., H, k*D] (the leading member axis, if any, included)."""
    lead, (b, s, _) = x.shape[:-3], x.shape[-3:]
    h = weights[0].shape[-2]
    n_sub = _n_subsets(num_frames, subsample_num)
    _check_tensor(masks, x.device, torch.uint8)
    _check_tensor(g, x.device, x.dtype)
    want_m, want_g = lead + (b, n_sub * h), lead + (b, s - 1, h)
    if tuple(masks.shape) != want_m or tuple(g.shape) != want_g:
        raise ValueError(f"expected masks {want_m} and g {want_g}, got "
                         f"{tuple(masks.shape)} and {tuple(g.shape)}")


def bf16_bwd_grid(num_frames: int, subsample_num: int, b: int, d: int,
                  h: int) -> Tuple[int, int]:
    """The bfloat16 backward kernel's grid of one member for B videos, D
    features and H outputs: (dx blocks, dW/db blocks).  A dx block is one
    tile of 64 videos by 128 D columns of one frame (frames slowest, then
    row tiles, then D tiles); a dW block one tile of 64 H rows by 128 D
    columns of one (scale, position) unit (units slowest, then H tiles,
    then D tiles), those at position 0 and the first D tile also summing
    db.  No dx blocks at B = 0: the dW blocks then write zeros."""
    tiles_d = -(-d // _BF16_BWD_TILE_N)
    dx_blocks = -(-b // _BF16_BWD_TILE_M) * tiles_d * num_frames
    units = len(_fwd_units(num_frames, subsample_num))
    return dx_blocks, tiles_d * -(-h // _BF16_BWD_TILE_M) * units


def _launch_bwd(x, weights, masks, g, num_frames, subsample_num
                ) -> Tuple[torch.Tensor, tuple, tuple]:
    """The backward kernel (one grid of dx and dW/db tiles): (dx, dWs,
    dbs), one member of ``_bwd_kernel``."""
    _check_inputs(x, weights, None, num_frames, subsample_num)
    _check_bwd(x, weights, masks, g, num_frames, subsample_num)
    dx, dws, dbs = _bwd_kernel(_one(x), [_one(w) for w in weights],
                               _one(masks), _one(g), num_frames,
                               subsample_num)
    return dx[0], tuple(t[0] for t in dws), tuple(t[0] for t in dbs)


def _bwd_kernel(x, weights, masks, g, num_frames, subsample_num):
    """Launch the backward kernel on checked stacked inputs (each input
    and output with its members first): (dx, dWs, dbs), one launch for
    every member; the bfloat16 kernel's grid is one member's
    (``bf16_bwd_grid``)."""
    global bwd_launches, bf16_bwd_launches
    n, b, s, d = x.shape
    h = weights[0].shape[-2]
    dx = torch.empty_like(x)
    # every dW_i side by side in one buffer, every db_i in another
    dw = torch.empty((n, sum(w.shape[-2] * w.shape[-1] for w in weights)),
                     dtype=x.dtype, device=x.device)
    db = torch.empty((n, len(weights), h), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(),
            *_pointer_args(weights, (), num_frames, subsample_num, x.device),
            masks.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            *_plan_args(num_frames, subsample_num, x.device), b, s, d, h)
    if x.dtype == torch.float32:
        plan = f32_bwd_plan(num_frames, subsample_num, b, d, h, n,
                            _f32_by_unit(weights, d))
        scratch = torch.empty((plan.scratch,), dtype=torch.float32,
                              device=x.device)
        _call("ta3n_trn_fused_bwd_f32", x, *args[:8], scratch.data_ptr(),
              *args[8:], plan.splits, n)
        bwd_launches += 1
    else:
        _call("ta3n_trn_fused_bwd_bf16", x, *args,
              *bf16_bwd_grid(num_frames, subsample_num, b, d, h), n)
        bf16_bwd_launches += 1
    return dx, _split_flat(dw, weights), tuple(db.unbind(-2))


def _split_flat(flat: torch.Tensor, like) -> tuple:
    """Views of ``flat`` [..., total] shaped as the tensors ``like`` [...,
    H, K] (the leading dims ``flat``'s), side by side in its last dim."""
    out, at = [], 0
    for t in like:
        size = t.shape[-2] * t.shape[-1]
        out.append(flat[..., at:at + size].view(*flat.shape[:-1],
                                                *t.shape[-2:]))
        at += size
    return tuple(out)


def _no_kernel(name: str, device: torch.device) -> ValueError:
    return ValueError(f"{name}: no kernel for device {device}")


def trn_multiscale_infer(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_frames: int,
                         subsample_num: int = 3) -> torch.Tensor:
    """Inference-only fused forward: [B, S, D] -> [B, S-1, H].

    A CUDA ``x`` launches the hand-written kernel (float32 or bfloat16,
    contiguous, on one device; anything else raises, and so does a call
    that would need a gradient).  A CPU ``x`` takes ``trn_multiscale_plain``.
    Under a ``torch.func`` transform it goes through a Function whose
    vmap rule runs ``trn_multiscale_infer_members``.
    """
    if torch._C._are_functorch_transforms_active():
        return _TRNInfer.apply(x, num_frames, subsample_num, *weights,
                               *biases)
    return _solo_infer(x, weights, biases, num_frames, subsample_num)


def _solo_infer(x, weights, biases, num_frames, subsample_num):
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

    A CUDA ``x`` launches the hand-written kernel (float32 or bfloat16,
    contiguous, on one device; anything else raises).  A CPU ``x`` takes
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


# the member axis: each argument [N, ...] with the members first, as
# ``torch.func.stack_module_state`` stacks parameters (`train/ensemble.py`)

def _check_members(x, weights, biases, num_frames, subsample_num) -> None:
    """Raise on stacked inputs that the member-batched kernels do not take
    (``biases`` None: the backward), on any device, so that the CPU
    refuses what the card refuses."""
    biases = list(biases) if biases is not None else []
    n = x.shape[0] if x.dim() == 4 else -1
    if n < 1 or any(t.dim() < 1 or t.shape[0] != n
                    for t in (*weights, *biases)):
        raise ValueError(
            "member-batched inputs carry N >= 1 members first: x [N, B, "
            "S, D], each weight [N, H, k*D] and bias [N, H]; got x "
            f"{tuple(x.shape)}")
    _check_inputs(x[0], [w[0] for w in weights],
                  [b[0] for b in biases] or None, num_frames, subsample_num)
    for t in (x, *weights, *biases):
        _check_tensor(t, x.device, x.dtype)


def _each_member(fn, *stacked):
    """``fn`` on each member's slice of the stacked tensor sequences
    ``stacked``, its outputs stacked back: the plain versions' member
    axis, member k computed exactly as a solo call on member k."""
    n = stacked[0].shape[0]
    outs = [fn(*(a[k] if isinstance(a, torch.Tensor) else [t[k] for t in a]
                 for a in stacked)) for k in range(n)]
    return _stack_outputs(outs)


def _stack_outputs(outs):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(_stack_outputs(list(o)) for o in zip(*outs))


def trn_multiscale_infer_members(x: torch.Tensor,
                                 weights: Sequence[torch.Tensor],
                                 biases: Sequence[torch.Tensor],
                                 num_frames: int, subsample_num: int = 3
                                 ) -> torch.Tensor:
    """``trn_multiscale_infer`` of N members in one call: x [N, B, S, D],
    weights[i] [N, H, k_i*D], biases[i] [N, H] -> [N, B, S-1, H].  A CUDA
    ``x`` launches the kernel of its dtype (float32 or bfloat16) once for
    every member (a member grid axis; member k's blocks do a one-member
    launch's work on member k's inputs, so its output is bitwise the solo
    call's).  Anything the kernels do not take raises, on any device.  A
    CPU ``x`` takes the plain version member by member."""
    _check_members(x, weights, biases, num_frames, subsample_num)
    if x.device.type == "cpu":
        return _each_member(
            lambda xk, wk, bk: trn_multiscale_plain(
                xk, wk, bk, num_frames, subsample_num), x, weights, biases)
    if x.device.type != "cuda":
        raise _no_kernel("trn_multiscale_infer_members", x.device)
    return _infer_kernel(x, weights, biases, num_frames, subsample_num)


def trn_multiscale_fwd_masks_members(
        x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor], num_frames: int,
        subsample_num: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """``trn_multiscale_fwd_masks`` of N members in one call: ``(out [N,
    B, S-1, H], masks [N, B, n_sub*H])`` from stacked inputs as for
    ``trn_multiscale_infer_members``: one launch of the training kernel
    of x's dtype on a CUDA ``x``, the plain version member by member on a
    CPU one."""
    _check_members(x, weights, biases, num_frames, subsample_num)
    if x.device.type == "cpu":
        return _each_member(
            lambda xk, wk, bk: trn_multiscale_fwd_masks_plain(
                xk, wk, bk, num_frames, subsample_num), x, weights, biases)
    if x.device.type != "cuda":
        raise _no_kernel("trn_multiscale_fwd_masks_members", x.device)
    return _train_kernel(x, weights, biases, num_frames, subsample_num)


def trn_multiscale_bwd_members(
        x: torch.Tensor, weights: Sequence[torch.Tensor],
        masks: torch.Tensor, g: torch.Tensor, num_frames: int,
        subsample_num: int = 3) -> Tuple[torch.Tensor, tuple, tuple]:
    """``trn_multiscale_bwd`` of N members in one call: ``(dx [N, B, S,
    D], dWs [N, H, k_i*D], dbs [N, H])`` from stacked x, weights, masks
    [N, B, n_sub*H] and g [N, B, S-1, H]: one launch of the backward
    kernel of x's dtype on a CUDA ``x`` (g may be non-contiguous), the
    plain version member by member on a CPU one."""
    _check_members(x, weights, None, num_frames, subsample_num)
    g = g.contiguous()
    _check_bwd(x, weights, masks, g, num_frames, subsample_num)
    if x.device.type == "cpu":
        return _each_member(
            lambda xk, wk, mk, gk: trn_multiscale_bwd_plain(
                xk, wk, mk, gk, num_frames, subsample_num),
            x, weights, masks, g)
    if x.device.type != "cuda":
        raise _no_kernel("trn_multiscale_bwd_members", x.device)
    return _bwd_kernel(x, weights, masks, g, num_frames, subsample_num)


def _stacked(n: int, in_dims, tensors) -> list:
    """Each tensor with its member axis (``in_dims``, None: unbatched,
    then the same for every member) first, contiguous: the kernels' member
    layout."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.contiguous())
    return out


class _TRNInfer(torch.autograd.Function):
    """The inference forward as a Function with a vmap rule, so that
    ``torch.func.vmap`` over stacked members (ensemble eval and serving)
    launches the kernel once for every member.  Not differentiable."""

    @staticmethod
    def forward(x, num_frames, subsample_num, *params):
        n = len(params) // 2
        return _solo_infer(x, params[:n], params[n:], num_frames,
                           subsample_num)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("trn_multiscale_infer has no backward; train "
                           "through trn_multiscale_fused")

    @staticmethod
    def vmap(info, in_dims, x, num_frames, subsample_num, *params):
        n = len(params) // 2
        x, *params = _stacked(info.batch_size, (in_dims[0], *in_dims[3:]),
                              (x, *params))
        return (trn_multiscale_infer_members(x, params[:n], params[n:],
                                             num_frames, subsample_num), 0)


class _TRNFused(torch.autograd.Function):
    """The training forward (out and masks) and the backward from the
    masks, in the ``setup_context`` form that ``torch.func`` takes.  Under
    ``vmap`` (stacked members) its vmap rule launches the member-batched
    training forward once, and the backward goes through
    ``_TRNBackward``, whose vmap rule launches the member-batched
    backward once."""

    @staticmethod
    def forward(x, num_frames, subsample_num, *params):
        n = len(params) // 2
        return trn_multiscale_fwd_masks(x, params[:n], params[n:],
                                        num_frames, subsample_num)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, num_frames, subsample_num, *params = inputs
        masks = output[1]
        ctx.mark_non_differentiable(masks)
        ctx.save_for_backward(x, masks, *params[:len(params) // 2])
        ctx.plan = (num_frames, subsample_num)

    @staticmethod
    def backward(ctx, g, _):
        x, masks, *weights = ctx.saved_tensors
        if torch._C._are_functorch_transforms_active():
            # batched tensors have no data pointer: the backward goes
            # through a Function of its own, whose vmap rule stacks them
            dx, *grads = _TRNBackward.apply(x, masks, g, *ctx.plan, *weights)
        else:
            if torch.is_grad_enabled():
                # create_graph: the kernel's gradients carry no graph, so
                # a second backward would take zeros for its terms
                raise RuntimeError(
                    "the fused TRN is differentiable once: its backward "
                    "cannot build a graph (create_graph=True)")
            dx, dws, dbs = trn_multiscale_bwd(x, weights, masks, g,
                                              *ctx.plan)
            grads = (*dws, *dbs)
        return (dx, None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, x, num_frames, subsample_num, *params):
        n = len(params) // 2
        x, *params = _stacked(info.batch_size, (in_dims[0], *in_dims[3:]),
                              (x, *params))
        return (trn_multiscale_fwd_masks_members(
            x, params[:n], params[n:], num_frames, subsample_num), (0, 0))


class _TRNBackward(torch.autograd.Function):
    """``trn_multiscale_bwd`` as a Function with a vmap rule: the backward
    of ``_TRNFused`` under ``torch.func`` transforms.  Not differentiable
    itself (the TRN is differentiable once, as the JAX custom VJP)."""

    @staticmethod
    def forward(x, masks, g, num_frames, subsample_num, *weights):
        dx, dws, dbs = trn_multiscale_bwd(x, weights, masks, g, num_frames,
                                          subsample_num)
        return (dx, *dws, *dbs)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the fused TRN's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, x, masks, g, num_frames, subsample_num,
             *weights):
        x, masks, g, *weights = _stacked(
            info.batch_size, (*in_dims[:3], *in_dims[5:]),
            (x, masks, g, *weights))
        dx, dws, dbs = trn_multiscale_bwd_members(x, weights, masks, g,
                                                  num_frames, subsample_num)
        return (dx, *dws, *dbs), (0,) * (1 + len(dws) + len(dbs))


def trn_multiscale_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_frames: int,
                         subsample_num: int = 3) -> torch.Tensor:
    """Differentiable fused forward: [B, S, D] -> [B, S-1, H].

    Its forward is ``trn_multiscale_fwd_masks`` and its backward
    ``trn_multiscale_bwd``: on a CUDA ``x`` the two kernels, which raise
    on what they do not take and never fall back; on a CPU ``x`` their
    plain versions.
    """
    return _TRNFused.apply(x, num_frames, subsample_num, *weights,
                           *biases)[0]
