"""The host side of the port's TRN kernels (K1, csrc/trn_fused_fwd.cu,
and in bfloat16 csrc/trn_fused_fwd_bf16.cu; K2, csrc/trn_fused_bwd.cu):
their work units, one per (scale, frame position), their choice of K
slices and, in bfloat16, of the whole grid.  The kernels themselves run
on the card (test_torch_port_cuda.py); here their block orders, the
clusters' row shares and the scratch layout, as their source notes and
``_fwd_units`` state them, are walked on the CPU."""

import collections

import numpy as np
import pytest
import torch

from ta3n_tpu_torch.ops import trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan

TILE, TK = trn_fused._F32_TILE, trn_fused._F32_TILE_K
BM, BH, BK = trn_fused._BF16_FWD_TILE_M, trn_fused._BF16_FWD_TILE_H, \
    trn_fused._BF16_FWD_TILE_K


def _blocks(s, b, d, h, splits):
    """The float32 GEMM's blocks in grid order, each (scale, position,
    subset, slot, videos, H tile, D slice, its D chunks, the videos whose
    cluster sum it writes), decoded as trn_fused_fwd_kernel does: video
    tile fastest, then H tile, then scratch slot (its unit the one whose
    slots slot .. slot + n_sub - 1 hold it), the D slice on the grid's z
    (a cluster), each slice summing rows [N z / splits, N (z + 1) /
    splits) of the tile."""
    width = trn_fused._f32_fwd_width(b)
    units, first = [], 0
    for i, p, n in trn_fused._fwd_units(s, 3):
        units.append((i, p, n, first))
        first += n
    chunks, h_tiles, b_tiles = -(-d // TK), -(-h // TILE), -(-b // width)
    for x in range(first * h_tiles * b_tiles):
        bt, ht, slot = x % b_tiles, x // b_tiles % h_tiles, \
            x // b_tiles // h_tiles
        (i, p, n, slot0), = [u for u in units if u[3] <= slot < u[3] + u[2]]
        for split in range(splits):
            rows = range(width * split // splits,
                         width * (split + 1) // splits)
            yield (i, p, slot - slot0, slot,
                   range(bt * width, min(bt * width + width, b)), ht, split,
                   range(chunks * split // splits,
                         chunks * (split + 1) // splits),
                   [bt * width + r for r in rows if bt * width + r < b])


def _slots(s):
    """slot0 of each scale: the scratch slots of the scales before it."""
    plan = build_relation_plan(s)
    first, out = 0, []
    for k, sub in zip(plan.scales, plan.subsets):
        out.append(first)
        first += k * len(sub)
    return out, first


@pytest.mark.parametrize("s", [2, 3, 5, 8])
def test_fwd_units_are_the_plan_positions(s):
    """One unit per (scale, position), scales in the plan's order and
    positions ascending, each with its scale's subset count: 14 at S=5,
    whose units hold 32 (subset, position) slots."""
    plan = build_relation_plan(s)
    units = trn_fused._fwd_units(s, 3)
    assert units == tuple((i, p, len(sub)) for i, (k, sub) in
                          enumerate(zip(plan.scales, plan.subsets))
                          for p in range(k))
    assert sum(n for _, _, n in units) == _slots(s)[1]
    if s == 5:
        assert len(units) == 14 and _slots(s)[1] == 32


@pytest.mark.parametrize("b,s,d,h,splits", [
    (1, 5, 512, 256, 4), (64, 5, 512, 256, 2), (65, 5, 100, 72, 3),
    (202, 5, 512, 256, 1), (13, 4, 37, 19, 8), (3, 2, 40, 33, 2),
    (22, 8, 64, 64, 1)])
def test_fwd_blocks_cover_every_partial_once(b, s, d, h, splits):
    """K1's GEMM: every (scale, subset, position, video, D chunk, H tile)
    is computed by exactly one block (a slice with no chunk, where the
    slices outnumber the chunks, adds zeros); each (slot, video, H tile)
    partial is written once, by the block of the cluster whose share of
    the tile's rows holds it, into the slot slot0 + p*n_sub + j; and the
    epilogue's fixed order (positions ascending) reads every slot
    once."""
    plan = build_relation_plan(s)
    chunks, h_tiles = -(-d // TK), -(-h // TILE)
    seen = collections.Counter()
    written = collections.Counter()
    slot0, n_slots = _slots(s)
    for i, p, j, slot, videos, ht, split, cs, mine in _blocks(s, b, d, h,
                                                             splits):
        n = len(plan.subsets[i])
        assert j < n and slot == slot0[i] + p * n + j
        assert plan.subsets[i][j][p] < s
        for video in videos:
            for c in cs:
                seen[(i, j, p, video, c, ht)] += 1
        for video in mine:
            written[(slot, video, ht)] += 1
    total = sum(len(sub) * k for k, sub in zip(plan.scales, plan.subsets))
    assert len(seen) == total * b * chunks * h_tiles
    assert set(seen.values()) == {1}
    assert set(written.values()) == {1}
    assert len(written) == n_slots * b * h_tiles

    # the epilogue: for (i, j), slots slot0 + p*n + j, positions ascending
    order = []
    for i, (k, sub) in enumerate(zip(plan.scales, plan.subsets)):
        for j in range(len(sub)):
            order += [slot0[i] + p * len(sub) + j for p in range(k)]
    assert sorted(order) == list(range(n_slots))


@pytest.mark.parametrize("s", [2, 3, 5, 8])
@pytest.mark.parametrize("b", [1, 64, 202, 640])
def test_fwd_splits_keep_the_grid_within_the_target(b, s):
    """D slices: 1..16, at most one per chunk, one cluster a tile, the
    tiles' clusters all resident at once on the H100 (_F32_CLUSTERS)
    unless even one slice a tile takes more than one wave; no larger count
    within the limits keeps them so.  The video tile is the narrowest of
    8, 16, 32, 64 that holds B, else 128.  At S=5 the 64 tiles of B = 1
    and 64 take 2 slices (128 blocks), the 128 of B = 202 one."""
    d, h = 512, 256
    splits = trn_fused._fwd_splits(s, 3, b, d, h)
    held = trn_fused._F32_CLUSTERS
    chunks = -(-d // TK)
    tiles = _slots(s)[1] * -(-h // TILE) * -(-b // trn_fused._f32_fwd_width(b))
    blocks = sum(1 for _ in _blocks(s, b, d, h, splits))
    assert blocks == tiles * splits
    assert 1 <= splits <= min(len(held), chunks)
    assert splits == 1 or tiles <= held[splits - 1]
    for more in range(splits + 1, min(len(held), chunks) + 1):
        assert tiles > held[more - 1]
    assert trn_fused._f32_fwd_width(b) == {1: 8, 64: 64}.get(b, TILE)
    if s == 5:
        want = {1: (2, 128), 64: (2, 128), 202: (1, 128), 640: (1, 320)}
        assert (splits, blocks) == want[b]


def _bf16_blocks(s, b, d, h, grid):
    """The bfloat16 kernel's blocks in grid order, decoded as
    trn_fused_fwd_bf16_kernel does (D slice fastest, then row tile, H tile,
    scratch slot), each (scale, position, subset, slot, videos, H tile, D
    slice, its D chunks); the slot's unit found as the kernel finds it, the
    one whose slots slot .. slot + n_sub - 1 hold it."""
    row_tiles, h_tiles, splits = grid
    units, first = [], 0
    for i, p, n in trn_fused._fwd_units(s, 3):
        units.append((i, p, n, first))
        first += n
    chunks = -(-d // BK)
    for blk in range(first * row_tiles * h_tiles * splits):
        rest, split = divmod(blk, splits)
        rest, rt = divmod(rest, row_tiles)
        slot, ht = divmod(rest, h_tiles)
        (i, p, n, slot0), = [u for u in units if u[3] <= slot < u[3] + u[2]]
        yield (i, p, slot - slot0, slot,
               range(rt * BM, min(rt * BM + BM, b)), ht, split,
               range(chunks * split // splits,
                     chunks * (split + 1) // splits))


@pytest.mark.parametrize("splits", ["chosen", "most"])
@pytest.mark.parametrize("b,s,d,h", [
    (1, 5, 512, 256), (64, 5, 512, 256), (65, 5, 100, 72),
    (202, 5, 512, 256), (13, 4, 37, 19), (3, 2, 40, 33), (22, 8, 64, 64),
    (202, 17, 512, 256), (129, 3, 64, 130)])
def test_bf16_fwd_grid_covers_every_partial_once(b, s, d, h, splits):
    """The bfloat16 forward's grid (bf16_fwd_grid, and with as many D
    slices as it takes): every (scale, subset, position, video, 64-deep D
    chunk, 128-wide H tile) computed by exactly one block; every scratch
    plane (D slice, slot) written once for each (video, H tile), slot
    slot0 + p*n_sub + j as the epilogue reads it; the row and H tiles
    exactly the ones the C entry accepts (ceil(B / 64), ceil(H / 128)),
    the D slices 1..min(8, chunks), each non-empty, and the grid within
    CUDA's 2**31 - 1 blocks."""
    plan = build_relation_plan(s)
    grid = trn_fused.bf16_fwd_grid(s, 3, b, d, h)
    chunks = -(-d // BK)
    if splits == "most":
        grid = grid[:2] + (min(trn_fused._FWD_MAX_SPLITS, chunks),)
    row_tiles, h_tiles, n_splits = grid
    assert row_tiles == -(-b // BM) and h_tiles == -(-h // BH)
    assert 1 <= n_splits <= min(trn_fused._FWD_MAX_SPLITS, chunks)
    slot0, n_slots = _slots(s)
    assert n_slots * row_tiles * h_tiles * n_splits <= 2 ** 31 - 1
    assert n_slots * row_tiles * h_tiles * n_splits == sum(
        1 for _ in _bf16_blocks(s, b, d, h, grid))
    seen = collections.Counter()
    written = collections.Counter()
    for i, p, j, slot, videos, ht, split, cs in _bf16_blocks(s, b, d, h,
                                                             grid):
        n = len(plan.subsets[i])
        assert j < n and slot == slot0[i] + p * n + j
        assert plan.subsets[i][j][p] < s and len(cs) > 0
        for video in videos:
            for c in cs:
                seen[(i, j, p, video, c, ht)] += 1
            written[(split * n_slots + slot, video, ht)] += 1
    total = sum(len(sub) * k for k, sub in zip(plan.scales, plan.subsets))
    assert len(seen) == total * b * chunks * h_tiles
    assert set(seen.values()) == {1}
    assert set(written.values()) == {1}
    assert len(written) == n_splits * n_slots * b * h_tiles


@pytest.mark.parametrize("s", [5, 17])
@pytest.mark.parametrize("b", [1, 64, 202])
def test_bf16_fwd_grid_fills_the_card_at_the_path_batches(b, s):
    """D slices only where the output tiles leave SMs without a block: at
    S=5 the 64 tiles of B = 1 and 64 take 2 slices (128 blocks), the 256
    of B = 202 one; at S=17 every batch has more tiles than SMs."""
    grid = trn_fused.bf16_fwd_grid(s, 3, b, 512, 256)
    blocks = _slots(s)[1] * grid[0] * grid[1] * grid[2]
    assert blocks <= trn_fused._BF16_FWD_TARGET_BLOCKS or grid[2] == 1
    want = {(1, 5): (1, 2, 2), (64, 5): (1, 2, 2), (202, 5): (4, 2, 1),
            (1, 17): (1, 2, 1), (64, 17): (1, 2, 1), (202, 17): (4, 2, 1)}
    assert grid == want[(b, s)]


def _check_slices(total, splits):
    """The K slices of one tile: chunks [total z / splits, total (z + 1) /
    splits) of slice z, which together take every chunk once, in order."""
    owner = []
    for z in range(splits):
        begin, end = total * z // splits, total * (z + 1) // splits
        assert begin <= end
        owner.extend([z] * (end - begin))
    assert owner == sorted(owner) and len(owner) == total


def _check_tiles(extent, width, tiles):
    """Tiles of ``width`` cover [0, extent) once, none starting past it."""
    covered = [v for t in range(tiles)
               for v in range(t * width, min(t * width + width, extent))]
    assert covered == list(range(extent)) and (tiles - 1) * width < extent


@pytest.mark.parametrize("b", [1, 64, 202])
@pytest.mark.parametrize("s", range(2, 26))
def test_f32_plans_cover_every_tile_and_chunk_once(s, b):
    """The float32 TRN kernels' plans at S = 2..25 and B = 1, 64, 202 (D =
    512, H = 256), and for N = 1, 4, 8 members.  K1: the GEMM's tiles
    (slot x H tile x video tile) cover every (slot, video, H column) once
    and each tile's D chunks are cut into its cluster's slices once; the
    cluster's row shares take the tile's rows once.  K2: the dx tiles
    (frame x video tile x D tile) and the dW tiles (unit x H tile x D
    tile) cover dx and every dW_i once; a dx tile's K is its frame's
    triples (the plan table's trip0) by 32-deep H chunks, a dW tile's the
    scale's subsets by 32-deep video chunks, each cut into the same
    slices once; the slices keep one member's dx clusters resident
    (_F32_CLUSTERS), never depend on N, and the scratch grows with N
    only by the members' planes."""
    d, h = 512, 256
    held = trn_fused._F32_CLUSTERS
    slots = _slots(s)[1]
    units = trn_fused._fwd_units(s, 3)
    # K1
    width = trn_fused._f32_fwd_width(b)
    splits = trn_fused._fwd_splits(s, 3, b, d, h)
    b_tiles, h_tiles = -(-b // width), -(-h // TILE)
    _check_tiles(b, width, b_tiles)
    _check_tiles(h, TILE, h_tiles)
    _check_slices(-(-d // TK), splits)
    _check_slices(width, splits)  # the cluster's rows
    tiles = slots * h_tiles * b_tiles
    assert splits == 1 or tiles <= held[splits - 1]
    assert tiles * splits <= 2 ** 31 - 1
    # K2
    table = trn_fused._plan_table(s, 3)
    n_scales, n_units = int(table[0]), int(table[1])
    trip0 = table[4 + 4 * n_scales + 12 * n_units:][:s + 1]
    plan = trn_fused.f32_bwd_plan(s, 3, b, d, h)
    d_tiles = -(-d // TILE)
    _check_tiles(d, TILE, d_tiles)
    _check_tiles(b, TILE, -(-b // TILE))
    assert plan.dx_tiles == s * -(-b // TILE) * d_tiles
    assert plan.dw_tiles == len(units) * h_tiles * d_tiles
    assert plan.splits == 1 or plan.dx_tiles <= held[plan.splits - 1]
    h_chunks, b_chunks = -(-h // TK), -(-b // TK)
    for f in range(s):
        trips = int(trip0[f + 1] - trip0[f])
        assert trips >= 1
        assert plan.splits <= trips * h_chunks  # no dx slice is empty
        _check_slices(trips * h_chunks, plan.splits)
    assert sum(int(trip0[f + 1] - trip0[f]) for f in range(s)) == slots
    for _, _, n in units:
        _check_slices(n * b_chunks, plan.splits)
    _check_slices(TILE, plan.splits)  # the clusters' rows, both families
    # members: the same slices; the scratch as the C entries lay it out
    # (256-byte aligned parts): K1's slot partials, then relu(x)'s hi and
    # lo planes; K2's m planes, m^T, then relu(x)^T's, each N members'
    # worth
    n_sub = int(table[2])
    up = lambda v, a: -(-v // a) * a
    for n in (1, 4, 8):
        member = trn_fused.f32_bwd_plan(s, 3, b, d, h, n)
        assert member._replace(scratch=0) == plan._replace(scratch=0)
        assert member.scratch == up(2 * n * n_sub * b * up(h, 4), 64) + \
            up(n * n_sub * h * up(b, 4), 64) + up(2 * n * s * d * up(b, 4), 64)
        assert trn_fused.f32_fwd_scratch(s, 3, b, d, h, n) == \
            up(n * slots * b * h, 64) + 2 * n * s * b * up(d, 4)


def _tf32(v):
    """v rounded to TF32 as tf32x3.cuh's to_tf32 (cvt.rna) rounds it."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _write(out, at, value):
    """The stage's store of ``value`` at flat indices ``at``: each index
    written once."""
    assert np.isnan(out[at]).all()
    out[at] = value


def _fwd_planes(x):
    """The hi and lo planes [2, N*S, B, P] that trn_fused_fwd_rows writes
    from x [N, B, S, D], indexed as its threads index them (thread p of
    member m: piece p % ceil(D/4) of x row p / ceil(D/4)); NaN where no
    thread writes."""
    n, b, s, d = x.shape
    pitch, pieces = -(-d // 4) * 4, -(-d // 4)
    plane = n * s * b * pitch
    out = np.full(2 * plane, np.nan, np.float32)
    p = np.arange(b * s * pieces)
    row, col = p // pieces, p % pieces * 4
    for m in range(n):
        rows = x[m].reshape(b * s, d)
        for e in range(4):
            v = np.where(col + e < d, rows[row, np.minimum(col + e, d - 1)],
                         0).astype(np.float32)
            hi = _tf32(np.maximum(v, 0))
            at = ((m * s + row % s) * b + row // s) * pitch + col + e
            _write(out, at, hi)
            _write(out, at + plane, _tf32(np.maximum(v, 0) - hi))
    return out.reshape(2, n * s, b, pitch)


def _bwd_planes(x, g, masks, s):
    """The planes that trn_fused_bwd_rows writes from x [N, B, S, D], g [N,
    B, S-1, H] and masks [N, B, n_sub*H], a 32 x 32 tile a block: m's [2,
    N*n_sub, B, H'] and m^T [N*n_sub, H, B'] from a tile (subset, videos,
    H columns), relu(x)^T's [2, N*S, D, B'] from a tile (frame, videos, D
    columns); thread (tx, ty) reads row b0 + ty + 8r at column c0 + tx
    (and writes it there to m's planes) and writes the transposed row c0
    + ty + 8r at video b0 + tx.  NaN where no thread writes (the pads past
    H and B, which no box reads)."""
    n, b, _, d = x.shape
    h = g.shape[-1]
    scales = trn_fused._plan_table(s, 3)[4:4 + 4 * (s - 1)].reshape(-1, 4)
    n_sub = int(scales[-1, 2] + scales[-1, 1])
    hp, bp = -(-h // 4) * 4, -(-b // 4) * 4
    m_plane, x_plane = n * n_sub * b * hp, n * s * d * bp
    m_out = np.full(2 * m_plane, np.nan, np.float32)
    mt_out = np.full(n * n_sub * h * bp, np.nan, np.float32)
    x_out = np.full(2 * x_plane, np.nan, np.float32)
    for m in range(n):
        for sb in range(n_sub):
            i = int(np.searchsorted(scales[:, 2], sb, side="right") - 1)
            for b0 in range(0, b, 32):
                for h0 in range(0, h, 32):
                    for ty in range(8):
                        for r in range(ty, 32, 8):
                            # the read: row b0 + r, columns h0 + tx
                            vb, hh = b0 + r, h0 + np.arange(32)
                            keep = (vb < b) & (hh < h)
                            if keep.any():
                                on = masks[m, vb, sb * h + hh[keep]] > 0
                                v = np.where(on, g[m, vb, i, hh[keep]],
                                             0).astype(np.float32)
                                hi = _tf32(v)
                                at = ((m * n_sub + sb) * b + vb) * hp + \
                                    hh[keep]
                                _write(m_out, at, hi)
                                _write(m_out, at + m_plane, _tf32(v - hi))
                            # the transposed write: row h0 + r, videos
                            hh, vv = h0 + r, b0 + np.arange(32)
                            keep = (hh < h) & (vv < b)
                            if keep.any():
                                on = masks[m, vv[keep], sb * h + hh] > 0
                                v = np.where(on, g[m, vv[keep], i, hh], 0)
                                at = ((m * n_sub + sb) * h + hh) * bp + \
                                    vv[keep]
                                _write(mt_out, at, v.astype(np.float32))
        for f in range(s):
            for b0 in range(0, b, 32):
                for d0 in range(0, d, 32):
                    for ty in range(8):
                        for r in range(ty, 32, 8):
                            dd, vv = d0 + r, b0 + np.arange(32)
                            keep = (dd < d) & (vv < b)
                            if not keep.any():
                                continue
                            v = np.maximum(x[m, vv[keep], f, dd], 0)
                            hi = _tf32(v)
                            at = ((m * s + f) * d + dd) * bp + vv[keep]
                            _write(x_out, at, hi)
                            _write(x_out, at + x_plane, _tf32(v - hi))
    return (m_out.reshape(2, n * n_sub, b, hp),
            mt_out.reshape(n * n_sub, h, bp),
            x_out.reshape(2, n * s, d, bp))


def _close_split(planes, want):
    """hi + lo is ``want`` to about 2^-22 of it, hi a TF32 value."""
    hi, lo = planes
    assert not np.isnan(hi).any() and not np.isnan(lo).any()
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_allclose(hi.astype(np.float64) + lo, want,
                               rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("n,b,s,d,h", [
    (1, 3, 5, 12, 8), (2, 5, 4, 7, 5), (1, 33, 3, 40, 33), (3, 2, 2, 4, 4)])
def test_f32_stage_a_planes_are_the_plain_operands(n, b, s, d, h):
    """What the float32 kernels' stage A writes, modelled in numpy as
    their threads index it, at ragged and member widths: every value of
    each plane written once (the pad columns of K1's rows included), hi a
    TF32 value and hi + lo the value the plain versions multiply: for
    K1's GEMM, layer m*S + f of relu(x)'s planes is the frame f rows of
    trn_multiscale_plain's relu(x[:, subset]) operand; for K2, layer m*n_sub
    + s' of m's planes is trn_multiscale_bwd_plain's m = masks * g of
    subset s' (and layer m*n_sub + s' of m^T that m exactly, transposed),
    and layer m*S + f of relu(x)^T's planes its relu(x) of frame f,
    transposed."""
    rng = np.random.default_rng(n * 100 + b)
    plan = build_relation_plan(s)
    n_sub = sum(len(sub) for sub in plan.subsets)
    x = rng.normal(size=(n, b, s, d)).astype(np.float32)
    g = rng.normal(size=(n, b, s - 1, h)).astype(np.float32)
    masks = (rng.random((n, b, n_sub * h)) > 0.4).astype(np.uint8)
    fwd = _fwd_planes(x)
    assert (fwd[:, :, :, d:] == 0).all()  # pads written as zeros
    m_planes, m_t, x_planes = _bwd_planes(x, g, masks, s)
    for m in range(n):
        xm = torch.from_numpy(x[m])
        relu = torch.relu(xm).numpy()
        for i, (k, subsets) in enumerate(zip(plan.scales, plan.subsets)):
            idx = torch.as_tensor(subsets.reshape(-1))
            operand = torch.relu(xm.index_select(1, idx)).reshape(
                b, len(subsets), k * d).numpy()
            for j, sub in enumerate(subsets):
                for p, f in enumerate(sub):
                    _close_split(fwd[:, m * s + f, :, :d],
                                 operand[:, j, p * d:(p + 1) * d])
        sub = 0
        for i, subsets in enumerate(plan.subsets):
            k = len(subsets)
            want = (torch.from_numpy(masks[m][:, sub * h:(sub + k) * h])
                    .reshape(b, k, h).float()
                    * torch.from_numpy(g[m][:, i, None, :])).numpy()
            for j in range(k):
                _close_split(m_planes[:, m * n_sub + sub + j, :, :h],
                             want[:, j])
                np.testing.assert_array_equal(
                    m_t[m * n_sub + sub + j, :, :b], want[:, j].T)
            sub += k
        for f in range(s):
            _close_split(x_planes[:, m * s + f, :, :b], relu[:, f, :].T)
