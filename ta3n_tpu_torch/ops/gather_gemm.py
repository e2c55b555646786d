"""Fused row gather + first-FC GEMM (K3): the device-store steps' gather of
a batch's frame rows from the store on the card, fed straight into the
shared frame-level FC.

Port of `ta3n_tpu/ops/gather_gemm.py` (the Pallas ``gathered_gemm``), which
computes ``z = store[idx] @ W`` and returns the gathered rows ``x_res`` for
``dW = x_resᵀ dz``; the JAX device-store step computes the same function
as ``device_gather`` and the mask multiply (`ta3n_tpu/train/step.py:392-410,
759-766`) followed by the first Dense layer.  Here, with the gathered rows
each scaled by ``row_scale`` (the loader's video mask: padded videos point
at row 0 with scale 0, so their rows are exactly 0, as JAX's ``x * mask``):

  * ``gathered_gemm_plain``: the plain PyTorch version, which CPU stores
    take and ``chip_smoke.py`` holds the kernel against on the card.
  * ``gathered_gemm``: on a CUDA store, the hand-written kernel
    (``csrc/gather_gemm.cu`` at float32 compute, ``csrc/gather_gemm_bf16.cu``
    at bfloat16), counted in ``launches``; on a CPU store, the plain
    version.
  * ``gathered_linear``: the FC as a ``torch.autograd.Function`` over one
    or more (store, indices, row scale) parts written into one output
    buffer (source rows first), each part with its own weight and bias or
    all with one (the model's ``share_params``); its backward is
    ``dW = dzᵀ x_res`` and ``db = dz.sum(0)`` over the rows of each
    weight (the JAX package leaves dW to XLA too).  The stores and indices
    get no gradient.

Stores and compute dtypes.  A store is a float32 or bfloat16 tensor, or an
int8 store's pair ``(q, scale)`` (`data/quantized.py`: q int8, one float32
scale per store row), whose rows are dequantized as they are gathered:
``float(q) * scale``, then ``* row_scale``, two rounded multiplies in that
order, the JAX step's ``device_gather`` followed by ``x * mask``
(`ta3n_tpu/train/step.py:400-404, 764`), bit for bit.  The weight's dtype
is the compute dtype: float32, or bfloat16, where the scaled rows are
rounded to bfloat16 (the JAX model's entry cast, ``video_model.py:175``),
multiplied with float32 accumulation, and z is rounded to bfloat16; x_res
then holds the bfloat16 rows.  Each of the six (store, compute) pairs is a
variant of the kernel with its own count of launches (``launches`` is the
float32 store at float32 compute, ``variant_launches`` every variant); the
three at bfloat16 compute convert the gathered rows once and run one wgmma
GEMM over them, as ``bf16_plan`` plans; the three at float32 compute
split the gathered rows into TF32 hi and lo planes once and run one
3xTF32 wgmma GEMM over them, as ``f32_plan`` plans.

Shapes: a store is [R, D], or [R, S, D] for a Flow store whose S stream
rows interleave per frame (row r, stream s is gathered row r·S + s, the
order of ``device_gather``; an int8 store's scale is one per row r, for
all its streams); ``weight`` is in torch layout [H, k·D], where
k consecutive gathered rows form one FC input row, as the model's
``x.reshape(B*S, -1)`` groups them (k = 1 for RGB at new_length 1).  The
outputs are z [M, H] and x_res [M, k·D], M = N·S/k for N indices.

Members.  ``gathered_gemm_members`` runs N members' stacked weights [N,
H, k*D] over one store in one call of the kernel of their dtype (a
member grid axis, at either compute dtype; the rows of one index set are
gathered, scaled and converted or split once for every member), from one
index set for all members (x_res then written once) or one each; K is
sliced by one member's shape, so member k's z is bitwise its solo
launch's.  A solo call is that call with one member: one launch path, one
count a variant.
``gathered_linear``'s and ``gathered_gemm``'s Functions carry vmap rules
that call it under ``torch.func.vmap`` (`train/ensemble.py`); the
backward's ``dzᵀ x_res`` stays a batched ``torch.mm``.

Indices.  A kernel cannot raise on a bad index, so indices are checked on
the host, where the loader makes them, before they reach the card:
``row_index`` checks 0 <= idx < R and uploads them as a ``RowIndex``.  A
CUDA store takes only a ``RowIndex`` on its device; a CPU store also takes
an integer array, which it checks the same way.  Indices that the device
sampler makes on the card (`data/device_sampler.py`) never visit the host:
their ``RowIndex`` carries the bound that the sampler's records give,
known on the host when the sampler is built, and every gather checks
that bound against its store.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ta3n_tpu_torch.ops.trn_fused import (_F32_CLUSTERS, _acc, _call,
                                          _check_tensor, _no_kernel,
                                          _stacked)

__all__ = ["RowIndex", "row_index", "upload", "gathered_gemm_plain",
           "gathered_gemm", "gathered_gemm_members",
           "gathered_linear", "part_rows", "Bf16Plan", "bf16_plan",
           "F32Plan", "f32_plan", "launches", "variant_launches"]

# kernel launches made by gathered_gemm and gathered_linear (plain-version
# calls are not counted); callers reset them to count one run's launches:
# ``launches`` for the float32 store at float32 compute, and
# ``variant_launches["{store}_{compute}"]`` (e.g. "int8_bf16") for every
# variant, that one included
launches = 0
# the store and compute dtypes the kernel takes, and their codes in the C
# entry (csrc/gather_gemm.cu)
_STORE_KINDS = {torch.float32: ("f32", 0), torch.bfloat16: ("bf16", 1),
                torch.int8: ("int8", 2)}
_COMPUTE_KINDS = {torch.float32: ("f32", 0), torch.bfloat16: ("bf16", 1)}
variant_launches = {f"{s}_{c}": 0 for s, _ in _STORE_KINDS.values()
                    for c, _ in _COMPUTE_KINDS.values()}

# the most K slices of an output tile at bfloat16 compute
_MAX_SPLITS = 8
# the float32-compute kernels (csrc/gather_gemm.cu): stage A's threads a
# block, each one 16-byte piece (4 values) of a gathered row; stage B's
# output tile of one member a block (128 rows x 128 columns, two
# warpgroups of 64 columns), its 32-deep K chunks, and the thread block
# clusters of 1..16 of its blocks (one an SM) that the H100 holds at once
# (the float32 kernels' table, ops/trn_fused.py)
_F32_ROWS_THREADS = 256
_F32_TILE_M, _F32_TILE_N, _F32_TILE_K = 128, 128, 32
# the bfloat16-compute kernels (csrc/gather_gemm_bf16.cu): stage A's
# threads a block, each one 16-byte piece (8 values) of a gathered row;
# stage B's output tile of one member a block (128 rows x 128 columns,
# two warpgroups) and its 64-deep K chunks; its K slices (1, 2, 4 or 8)
# fill the H100's 132 SMs where one member's tiles do not
_BF16_ROWS_THREADS = 256
_BF16_TILE_M, _BF16_TILE_N, _BF16_TILE_K = 128, 128, 64
_SMS = 132


class RowIndex(NamedTuple):
    """Row indices into a store, checked on the host and uploaded."""

    rows: torch.Tensor  # [N] int32, contiguous
    end: int            # one past the largest index (0 when N == 0)


def row_index(idx, num_rows: int, device="cuda") -> RowIndex:
    """Check that every index lies in [0, num_rows) and upload them as
    int32 to ``device``.  ``idx``: an integer numpy array or CPU tensor of
    any shape (flattened in C order)."""
    a = np.asarray(idx).reshape(-1)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"row indices must be integers, got {a.dtype}")
    if num_rows > 2 ** 31:
        raise ValueError(f"int32 indices address at most 2**31 rows, the "
                         f"store has {num_rows}")
    end = int(a.max()) + 1 if a.size else 0
    if a.size and (a.min() < 0 or end > num_rows):
        raise IndexError(f"row indices must lie in [0, {num_rows}), got "
                         f"[{int(a.min())}, {end - 1}]")
    return RowIndex(upload(a, torch.int32, device), end)


def upload(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) as a new tensor of ``dtype`` on
    ``device``: to a CUDA device through a pinned buffer, as a
    ``non_blocking`` copy on the current stream (the host does not wait
    for it; the caching host allocator keeps the buffer until the copy is
    done), elsewhere a plain copy."""
    t = torch.as_tensor(np.asarray(a)).to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


def _split_store(store) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(rows, per-row scales or None) of a store tensor or (q, scale)
    pair."""
    if isinstance(store, (tuple, list)):
        q, scale = store
        if q.dtype != torch.int8 or scale.dtype != torch.float32 or \
                tuple(scale.shape) != (q.shape[0],):
            raise TypeError(f"an int8 store is (q int8 [R, ...], scale "
                            f"float32 [R]), got {q.dtype} {tuple(q.shape)} "
                            f"and {scale.dtype} {tuple(scale.shape)}")
        if scale.device != q.device:
            raise ValueError(f"store scales on {scale.device}, rows on "
                             f"{q.device}")
        return q, scale
    return store, None


def _variant(store, weight: torch.Tensor) -> str:
    """The kernel variant of a store (tensor or pair) and a weight, e.g.
    ``"int8_bf16"``: the store's dtype, then the compute dtype."""
    rows, _ = _split_store(store)
    if rows.dtype not in _STORE_KINDS or weight.dtype not in _COMPUTE_KINDS:
        raise TypeError(f"the gather kernel takes float32, bfloat16 or int8 "
                        f"stores and float32 or bfloat16 weights, got "
                        f"{rows.dtype} and {weight.dtype}")
    return f"{_STORE_KINDS[rows.dtype][0]}_{_COMPUTE_KINDS[weight.dtype][0]}"


def _rows_of(idx, store: torch.Tensor) -> torch.Tensor:
    """The int32 index tensor that may be read against ``store`` (its row
    tensor)."""
    if isinstance(idx, RowIndex):
        rows = idx.rows
        if rows.device != store.device:
            raise ValueError(f"indices on {rows.device} for a store on "
                             f"{store.device}")
        if rows.dtype != torch.int32 or rows.dim() != 1 or \
                not rows.is_contiguous():
            raise TypeError("a RowIndex holds a contiguous 1-d int32 tensor, "
                            f"got {rows.dtype} of shape {tuple(rows.shape)}")
        if idx.end > store.shape[0]:
            raise IndexError(f"indices checked for {idx.end} rows, the store "
                             f"has {store.shape[0]}")
        return rows
    if store.device.type == "cuda":
        raise TypeError("a CUDA store takes only indices checked on the host:"
                        " pass row_index(idx, store.shape[0], store.device)")
    return row_index(idx, store.shape[0], store.device).rows


def _geometry(store, n, weight, row_scale) -> Tuple[int, int, int, int]:
    """(streams, D, k, M) of a gather of n indices; raise on shapes that do
    not fit."""
    if store.dim() not in (2, 3):
        raise ValueError(f"a store is [R, D] or [R, S, D], got "
                         f"{tuple(store.shape)}")
    streams = store.shape[1] if store.dim() == 3 else 1
    d = store.shape[-1]
    if weight.dim() != 2 or weight.shape[1] % d:
        raise ValueError(f"weight must be [H, k*{d}], got "
                         f"{tuple(weight.shape)}")
    k = weight.shape[1] // d
    if n * streams % k:
        raise ValueError(f"{n * streams} gathered rows do not group into FC "
                         f"input rows of {k}")
    if row_scale is not None and tuple(row_scale.shape) != (n,):
        raise ValueError(f"row_scale must be [{n}], got "
                         f"{tuple(row_scale.shape)}")
    return streams, d, k, n * streams // k


def gathered_rows(store, idx, row_scale: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The plain gather: the rows [N, D] or [N, S, D] of a store at idx
    (an int8 store's dequantized, a bfloat16 store's as float32), each
    scaled by its row_scale, as the JAX step's ``device_gather`` and
    ``x * mask``.  idx: [N] integer tensor on the store's device, or a
    `RowIndex`.  The int8 eval steps (`train/step.py`), whose first FC is
    quantized, gather with it."""
    data, scale = _split_store(store)
    if isinstance(idx, RowIndex):
        idx = _rows_of(idx, data)
    rows = data.index_select(0, idx)                # [N, D] or [N, S, D]
    shape = (-1, *([1] * (rows.dim() - 1)))
    if scale is not None:
        rows = rows.to(scale.dtype) * scale.index_select(0, idx).reshape(
            shape)
    rows = _acc(rows)
    if row_scale is not None:
        rows = rows * row_scale.reshape(shape)
    return rows


def gathered_gemm_plain(store, idx: torch.Tensor, weight: torch.Tensor,
                        row_scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(z, x_res)`` with x_res the gathered rows
    (`gathered_rows`) viewed as [M, k*D] in the weight's dtype, and
    ``z = x_res @ weight.T`` (at bfloat16: float32 products of the
    bfloat16 values, rounded once).  idx: [N] integer tensor on the
    store's device."""
    x = gathered_rows(store, idx, row_scale).reshape(
        -1, weight.shape[1]).to(weight.dtype)
    return (_acc(x) @ _acc(weight).T).to(weight.dtype), x


def _prepare(store, idx, weight, row_scale):
    """The checked index tensor and the geometry of one gather."""
    data, _ = _split_store(store)
    rows = _rows_of(idx, data)
    return rows, _geometry(data, rows.shape[0], weight, row_scale)


def _gather_into(store, rows, geometry, weight, row_scale, z,
                 x_res) -> None:
    """One gather + GEMM written into z [M, H] and, unless None, x_res
    [M, k*D]: one member of ``_gather_members_into``."""
    _gather_members_into(store, rows, geometry, weight[None], row_scale,
                         z[None], x_res)


class Bf16Plan(NamedTuple):
    """A call of the bfloat16-compute kernels (csrc/gather_gemm_bf16.cu)."""

    rows_blocks: int  # stage A's blocks an index set, a 16-byte piece a thread
    index_sets: int   # 1 (shared indices) or the members
    row_tiles: int    # stage B's grid: row tiles x column tiles (x),
    col_tiles: int    # the members (y) and the K slices (z, a cluster)
    members: int
    splits: int
    pitch: int        # values a row of the A and W operands: k*D up to 8s
    scratch: int      # bfloat16 values of scratch: A's rows, then W's


def bf16_plan(m: int, h: int, d: int, k: int, members: int = 1,
              per_member: bool = False, rows_aligned: bool = True,
              weight_aligned: bool = True) -> Bf16Plan:
    """The bfloat16-compute call for M output rows, H columns and k
    gathered rows of D per FC input row, of ``members`` members with one
    index set each (``per_member``) or one for all.  Stage A converts
    every (gathered row, 16-byte piece) once an index set.  Stage B's
    tiles are one member's; its K slices, a power of two up to 8 and at
    most one per 64-deep chunk of k*D, are the most that keep one member's
    tiles times slices within the 132 SMs, so they never depend on N and
    member k's z is bitwise its solo call's (whether a cluster or one
    block runs a tile's slices, and how many blocks an SM holds, the
    launch decides by the card's count of SMs; the bits depend on
    neither).  Scratch holds A's rows
    unless x_res is given with 16-byte aligned rows (``rows_aligned``,
    and k*D a multiple of 8), and W's rows unless the weight's are
    (``weight_aligned``)."""
    kd = k * d
    pitch = -(-kd // 8) * 8
    sets = members if per_member else 1
    row_tiles, col_tiles = -(-m // _BF16_TILE_M), -(-h // _BF16_TILE_N)
    most = min(_MAX_SPLITS, -(-kd // _BF16_TILE_K),
               max(1, _SMS // (row_tiles * col_tiles)))
    splits = 1 << (most.bit_length() - 1)
    direct = kd % 8 == 0
    scratch = ((0 if direct and rows_aligned else sets * m * pitch)
               + (0 if direct and weight_aligned else members * h * pitch))
    pieces = m * k * -(-d // 8)
    return Bf16Plan(-(-pieces // _BF16_ROWS_THREADS), sets, row_tiles,
                    col_tiles, members, splits, pitch, scratch)


class F32Plan(NamedTuple):
    """A call of the float32-compute kernels (csrc/gather_gemm.cu)."""

    rows_blocks: int  # stage A's blocks an index set, a 16-byte piece a thread
    index_sets: int   # 1 (shared indices) or the members
    row_tiles: int    # stage B's grid: row tiles x column tiles (x),
    col_tiles: int    # the members (y) and the K slices (z, a cluster)
    members: int
    splits: int
    pitch: int        # values a row of the planes and W's rows: k*D up to 4s
    scratch: int      # float32 values of scratch: the planes, then W's rows


def f32_plan(m: int, h: int, d: int, k: int, members: int = 1,
             per_member: bool = False,
             weight_aligned: bool = True) -> F32Plan:
    """The float32-compute call for M output rows, H columns and k
    gathered rows of D per FC input row, of ``members`` members with one
    index set each (``per_member``) or one for all.  Stage A scales and
    splits every (gathered row, 16-byte piece) once an index set, into a
    TF32 hi and a lo plane of [sets, M, pitch] values.  Stage B's tiles
    are one member's; its K slices, one thread block cluster a tile, are
    the most (up to 16, at most one per 32-deep chunk of k*D) whose
    clusters over one member's tiles the card holds at once
    (_F32_CLUSTERS; 1 where even single blocks take more than one wave),
    so they never depend on N and member k's z is bitwise its solo
    call's.  Scratch holds the two planes, then W's rows at ``pitch``
    unless the weight's rows are 16-byte aligned (``weight_aligned``, and
    k*D a multiple of 4)."""
    kd = k * d
    pitch = -(-kd // 4) * 4
    sets = members if per_member else 1
    row_tiles, col_tiles = -(-m // _F32_TILE_M), -(-h // _F32_TILE_N)
    chunks = -(-kd // _F32_TILE_K)
    splits = max([s for s, held in enumerate(_F32_CLUSTERS, 1)
                  if s <= chunks and row_tiles * col_tiles <= held],
                 default=1)
    scratch = 2 * sets * m * pitch + (
        0 if kd % 4 == 0 and weight_aligned else members * h * pitch)
    pieces = m * k * -(-d // 4)
    return F32Plan(-(-pieces // _F32_ROWS_THREADS), sets, row_tiles,
                   col_tiles, members, splits, pitch, scratch)


def gathered_gemm(store, idx, weight: torch.Tensor,
                  row_scale: Optional[torch.Tensor] = None,
                  with_rows: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused gather + GEMM, no bias: ``(z [M, H], x_res [M, k*D])`` in the
    weight's dtype, x_res None unless ``with_rows``.

    A CUDA ``store`` (a float32 or bfloat16 tensor, or an int8 ``(q,
    scale)`` pair) launches the hand-written kernel's variant for its
    dtype and the weight's (float32 or bfloat16; contiguous, everything on
    its device, idx a ``RowIndex``; anything else raises, and nothing
    falls back).  A CPU ``store`` takes ``gathered_gemm_plain``.
    """
    if torch._C._are_functorch_transforms_active():
        # under vmap over stacked members (ensemble eval and serving): a
        # Function whose vmap rule launches the kernel once for all
        return _GatheredGemm.apply(store, idx, weight, row_scale, with_rows)
    return _solo_gemm(store, idx, weight, row_scale, with_rows)


def _solo_gemm(store, idx, weight, row_scale, with_rows):
    rows, geometry = _prepare(store, idx, weight, row_scale)
    m = geometry[3]
    kw = dict(dtype=weight.dtype, device=_split_store(store)[0].device)
    z = torch.empty((m, weight.shape[0]), **kw)
    x_res = torch.empty((m, weight.shape[1]), **kw) if with_rows else None
    _gather_into(store, rows, geometry, weight, row_scale, z, x_res)
    return z, x_res


# the member axis: stacked weights [N, H, k*D] (members first, as
# ``torch.func.stack_module_state`` stacks them, `train/ensemble.py`) over
# one store, with one index set for every member or one each

def _member_rows(rows: torch.Tensor, end: int, store: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Checked [N, n_idx] (per member) or [n_idx] (shared) int32 indices
    of a member-batched gather."""
    if rows.device != store.device:
        raise ValueError(f"indices on {rows.device} for a store on "
                         f"{store.device}")
    if rows.dtype != torch.int32 or rows.dim() not in (1, 2) or (
            rows.dim() == 2 and rows.shape[0] != n):
        raise TypeError(f"member indices are int32 [n_idx] or [{n}, n_idx],"
                        f" got {rows.dtype} of shape {tuple(rows.shape)}")
    if end > store.shape[0]:
        raise IndexError(f"indices checked for {end} rows, the store has "
                         f"{store.shape[0]}")
    return rows.contiguous()


def gathered_gemm_members(store, idx: RowIndex, weight: torch.Tensor,
                          row_scale: Optional[torch.Tensor] = None,
                          with_rows: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``gathered_gemm`` of N members in one call: weight [N, H, k*D]
    (stacked, members first) over one store; ``idx`` a ``RowIndex`` whose
    rows are [n_idx] (one index set for every member) or [N, n_idx] (one
    each), row_scale [n_idx] or [N, n_idx] likewise.  Returns z [N, M, H]
    and, with ``with_rows``, x_res: [M, k*D] for shared indices (the
    members gather the same rows), else [N, M, k*D].  A CUDA store launches
    the kernel of the weight's dtype (float32 or bfloat16 compute) once
    for every member (a member grid axis; K is sliced by one member's
    shape, so member k's z is bitwise the solo launch's); a CPU store
    takes the plain version member by member."""
    data, _ = _split_store(store)
    n = weight.shape[0]
    rows = _member_rows(idx.rows, idx.end, data, n)
    per_member = rows.dim() == 2 or (row_scale is not None
                                     and row_scale.dim() == 2)
    if per_member:
        rows = rows.expand(n, rows.shape[-1]).contiguous()
        if row_scale is not None:
            row_scale = row_scale.expand(n, rows.shape[-1]).contiguous()
    geometry = _geometry(data, rows.shape[-1], weight[0],
                         None if row_scale is None else row_scale[0]
                         if per_member else row_scale)
    m = geometry[3]
    kw = dict(dtype=weight.dtype, device=data.device)
    z = torch.empty((n, m, weight.shape[1]), **kw)
    x_res = (torch.empty(((n,) if per_member else ()) + (m, weight.shape[2]),
                         **kw) if with_rows else None)
    _gather_members_into(store, rows, geometry, weight, row_scale, z, x_res)
    return z, x_res


def _gather_members_into(store, rows, geometry, weight, row_scale, z,
                         x_res) -> None:
    """N members' gathers + GEMMs: weight [N, H, k*D] into z [N, M, H]
    and, unless None, x_res ([N, M, k*D] when rows are [N, n_idx], else
    [M, k*D], written once): the kernel on a CUDA store, one call for
    every member at either compute dtype, its K slices chosen by one
    member's shape, the plain version member by member on a CPU one."""
    global launches
    data, scale = _split_store(store)
    n = weight.shape[0]
    per_member = rows.dim() == 2
    if data.device.type == "cpu":
        for k in range(n):
            got_z, got_x = gathered_gemm_plain(
                store, rows[k] if per_member else rows, weight[k],
                row_scale[k] if per_member and row_scale is not None
                else row_scale)
            z[k].copy_(got_z)
            if x_res is not None and (per_member or k == 0):
                (x_res[k] if per_member else x_res).copy_(got_x)
        return
    if data.device.type != "cuda":
        raise _no_kernel("gathered_gemm", data.device)
    variant = _variant(store, weight[0])
    if (data.dtype == torch.int8) != (scale is not None):
        raise TypeError("an int8 store comes with its scales, as the pair "
                        "(q, scale); other stores without")
    _check_tensor(data, data.device, data.dtype)
    for t in (weight, z, x_res):
        if t is not None:
            _check_tensor(t, data.device, weight.dtype)
    for t in (scale, row_scale):
        if t is not None:
            _check_tensor(t, data.device, torch.float32)
    streams, d, k, m = geometry
    if m == 0:  # a grid of 0 blocks is refused
        return
    h = weight.shape[1]
    if weight.dtype == torch.bfloat16:
        plan = bf16_plan(m, h, d, k, n, per_member,
                         x_res is not None and x_res.data_ptr() % 16 == 0,
                         weight.data_ptr() % 16 == 0)
    else:
        plan = f32_plan(m, h, d, k, n, per_member,
                        weight.data_ptr() % 16 == 0)
    splits = plan.splits
    part = (torch.empty(plan.scratch, dtype=weight.dtype, device=z.device)
            if plan.scratch else None)
    _call("ta3n_gather_gemm_members", data, data.data_ptr(),
          None if scale is None else scale.data_ptr(), rows.data_ptr(),
          None if row_scale is None else row_scale.data_ptr(),
          weight.data_ptr(), z.data_ptr(),
          None if x_res is None else x_res.data_ptr(),
          None if part is None else part.data_ptr(), rows.shape[-1], streams,
          d, k, h, splits, _STORE_KINDS[data.dtype][1],
          _COMPUTE_KINDS[weight.dtype][1], n, int(per_member))
    variant_launches[variant] += 1
    if variant == "f32_f32":
        launches += 1


def _batched_part(part, dims):
    """A (store, RowIndex, row_scale) part as the member-batched gather
    takes it: the store unbatched, the indices and scales with their member
    axis first (or unbatched)."""
    store, idx, row_scale = part
    store_dims, idx_dims, scale_dim = dims
    if any(d is not None for d in (store_dims if isinstance(
            store_dims, (tuple, list)) else (store_dims,))):
        raise ValueError("the members share one store: a store cannot be "
                         "batched")
    rows = idx.rows if idx_dims.rows is None else idx.rows.movedim(
        idx_dims.rows, 0)
    if row_scale is not None and scale_dim is not None:
        row_scale = row_scale.movedim(scale_dim, 0)
    return store, RowIndex(rows, idx.end), row_scale


class _GatheredGemm(torch.autograd.Function):
    """``gathered_gemm`` as a Function with a vmap rule, for the
    inference paths under ``torch.func.vmap`` over stacked members.  Not
    differentiable (train through ``gathered_linear``)."""

    @staticmethod
    def forward(store, idx, weight, row_scale, with_rows):
        return _solo_gemm(store, idx, weight, row_scale, with_rows)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("gathered_gemm has no backward; train through "
                           "gathered_linear")

    @staticmethod
    def vmap(info, in_dims, store, idx, weight, row_scale, with_rows):
        store, idx, row_scale = _batched_part(
            (store, idx, row_scale), in_dims[:2] + (in_dims[3],))
        weight, = _stacked(info.batch_size, in_dims[2:3], (weight,))
        z, x_res = gathered_gemm_members(store, idx, weight, row_scale,
                                         with_rows)
        return (z, x_res), (0, None if x_res is None or x_res.dim() == 2
                            else 0)


class _GatheredLinear(torch.autograd.Function):
    """Forward: every part's gather + GEMM with its weight into one buffer,
    then its bias; backward: dW and db of each weight from the saved
    gathered rows of its parts.  ``part_weight[i]`` is the index of part
    i's weight; the parts of one weight are consecutive, so its rows are
    one range of the output.  In the ``setup_context`` form that
    ``torch.func`` takes; under ``vmap`` over stacked weights its vmap
    rule launches the member-batched gather once per part."""

    @staticmethod
    def forward(parts, part_weight, *weights_and_biases):
        n = len(weights_and_biases) // 2
        weights, biases = weights_and_biases[:n], weights_and_biases[n:]
        prepared = [_prepare(store, idx, weights[w], row_scale)
                    for (store, idx, row_scale), w in zip(parts, part_weight)]
        total = sum(geometry[3] for _, geometry in prepared)
        kw = dict(dtype=weights[0].dtype, device=weights[0].device)
        z = torch.empty((total, weights[0].shape[0]), **kw)
        x_res = torch.empty((total, weights[0].shape[1]), **kw)
        runs = _runs([g[3] for _, g in prepared], part_weight, n)
        start = 0
        for (store, _, row_scale), (rows, geometry), w in zip(
                parts, prepared, part_weight):
            end = start + geometry[3]
            _gather_into(store, rows, geometry, weights[w], row_scale,
                         z[start:end], x_res[start:end])
            start = end
        for (a, b), bias in zip(runs, biases):
            if bias is not None:
                z[a:b].add_(bias)  # in z's dtype, as flax Dense adds it
        return z, x_res

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        parts, part_weight, *weights_and_biases = inputs
        x_res = output[1]
        ctx.mark_non_differentiable(x_res)
        ctx.runs = _runs([part_rows(part, weights_and_biases[w])
                          for part, w in zip(parts, part_weight)],
                         part_weight, len(weights_and_biases) // 2)
        ctx.save_for_backward(x_res)

    @staticmethod
    def backward(ctx, dz, _):
        (x_res,) = ctx.saved_tensors
        runs, need = ctx.runs, ctx.needs_input_grad[2:]
        n = len(runs)
        dws = [torch.mm(dz[a:b].t(), x_res[a:b]) if need[i] else None
               for i, (a, b) in enumerate(runs)]
        dbs = [dz[a:b].sum(0) if need[n + i] else None
               for i, (a, b) in enumerate(runs)]
        return (None, None, *dws, *dbs)

    @staticmethod
    def vmap(info, in_dims, parts, part_weight, *weights_and_biases):
        m = info.batch_size
        n = len(weights_and_biases) // 2
        stacked = _stacked(m, in_dims[2:], weights_and_biases)
        weights, biases = stacked[:n], stacked[n:]
        parts = [_batched_part(part, dims)
                 for part, dims in zip(parts, in_dims[0])]
        per_member = any(idx.rows.dim() == 2 or (
            scale is not None and scale.dim() == 2)
            for _, idx, scale in parts)
        outs = [gathered_gemm_members(store, idx, weights[w], scale)
                for (store, idx, scale), w in zip(parts, part_weight)]
        z = torch.cat([o[0] for o in outs], dim=1)
        x_res = torch.cat([o[1].expand(m, *o[1].shape) if per_member and
                           o[1].dim() == 2 else o[1] for o in outs],
                          dim=-2)
        runs = _runs([o[0].shape[1] for o in outs], part_weight, n)
        for (a, b), bias in zip(runs, biases):
            z[:, a:b].add_(bias[:, None])
        return (z, x_res), (0, 0 if per_member else None)


def part_rows(part, weight: torch.Tensor) -> int:
    """The output rows M of a (store, idx, row_scale) part with
    ``weight``, from the shapes alone."""
    store, idx, _ = part
    data, _ = _split_store(store)
    if isinstance(idx, RowIndex):
        n_idx = idx.rows.shape[-1]
    else:
        n_idx = idx.numel() if isinstance(idx, torch.Tensor) \
            else np.asarray(idx).size
    return _geometry(data, n_idx, weight, None)[3]


def _runs(sizes, part_weight, n_weights: int) -> list:
    """The output rows [start, end) of each weight's parts (consecutive),
    from each part's output rows ``sizes``."""
    runs = [[None, 0] for _ in range(n_weights)]
    start = 0
    for size, w in zip(sizes, part_weight):
        end = start + size
        if runs[w][0] is None:
            runs[w][0] = start
        runs[w][1] = end
        start = end
    return [(a if a is not None else start, b) for a, b in runs]


def gathered_linear(parts: Sequence[tuple], weight, bias) -> torch.Tensor:
    """Differentiable ``gathered rows @ W.T + b`` over ``parts``, a sequence
    of (store, idx, row_scale or None), each written at its row offset
    into one [sum M, H] output (no concat), in the weights' dtype (float32
    or bfloat16, whose bias add rounds to bfloat16 as a bfloat16 flax
    ``Dense``; its backward's ``dzᵀ x_res`` is a bfloat16 ``torch.mm``,
    which the steps run with cuBLAS's reduced-precision reduction off).  ``weight`` and ``bias`` are
    one tensor for every part, or a sequence with one for each part:
    under share_params N the source store takes the source layer and the
    target store the target layer.  The parts of one weight must be
    consecutive.  One K3 launch per non-empty part on CUDA stores; the
    plain version on CPU stores.  Gradients flow to the weights and biases
    only: each gets ``dzᵀ x_res`` (and ``dz.sum(0)``) over its own parts'
    rows.  A bias of None adds nothing and gets no gradient."""
    parts = tuple(parts)
    if isinstance(weight, torch.Tensor):
        weight, bias = [weight] * len(parts), [bias] * len(parts)
    if not parts or not len(weight) == len(bias) == len(parts):
        raise ValueError(f"{len(parts)} parts need one weight and one bias "
                         f"each, got {len(weight)} and {len(bias)}")
    weights, biases, part_weight = [], [], []
    for w, b in zip(weight, bias):
        if not weights or w is not weights[-1]:
            if any(w is u for u in weights):
                raise ValueError("the parts of one weight must be "
                                 "consecutive")
            weights.append(w)
            biases.append(b)
        elif b is not biases[-1]:
            raise ValueError("parts that share a weight share its bias")
        part_weight.append(len(weights) - 1)
    return _GatheredLinear.apply(parts, tuple(part_weight), *weights,
                                 *biases)[0]
