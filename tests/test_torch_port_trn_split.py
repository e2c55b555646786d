"""The host side of the port's TRN forward kernels (K1,
csrc/trn_fused_fwd.cu, and in bfloat16 csrc/trn_fused_fwd_bf16.cu): their
work units, one per (scale, frame position), and their choice of D slices
and, in bfloat16, of the whole grid.  The kernels themselves run on the
card (test_torch_port_cuda.py); here their block orders and scratch
layout, as their source notes and ``_fwd_units`` state them, are walked
on the CPU."""

import collections

import pytest

from ta3n_tpu_torch.ops import trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan

TM, TH, TK = trn_fused._FWD_TILE_M, trn_fused._FWD_TILE_H, \
    trn_fused._FWD_TILE_K
BM, BH, BK = trn_fused._BF16_FWD_TILE_M, trn_fused._BF16_FWD_TILE_H, \
    trn_fused._BF16_FWD_TILE_K


def _blocks(s, b, d, h, splits):
    """The kernel's blocks in grid order, each (scale, position, subset
    rows of the unit, H tile, D slice, its D chunks), decoded as
    trn_fused_fwd_kernel does: per unit, H tile, then row tile, then D
    slice."""
    chunks = -(-d // TK)
    for i, p, n in trn_fused._fwd_units(s, 3):
        for ht in range(-(-h // TH)):
            for mt in range(-(-n * b // TM)):
                rows = range(mt * TM, min((mt + 1) * TM, n * b))
                for split in range(splits):
                    yield (i, p, rows, ht, split,
                           range(chunks * split // splits,
                                 chunks * (split + 1) // splits))


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
    """Every (scale, subset, position, video, D chunk, H tile) is computed
    by exactly one block; each block's scratch rows are the slots
    slot0 + p*n_sub + j, one (split, slot) plane per partial; and the
    epilogue's fixed order (positions, then D slices) reads every plane
    once."""
    plan = build_relation_plan(s)
    chunks, h_tiles = -(-d // TK), -(-h // TH)
    seen = collections.Counter()
    written = collections.Counter()
    slot0, n_slots = _slots(s)
    for i, p, rows, ht, split, cs in _blocks(s, b, d, h, splits):
        n = len(plan.subsets[i])
        for r in rows:
            j, video = divmod(r, b)
            assert plan.subsets[i][j][p] < s
            for c in cs:
                seen[(i, j, p, video, c, ht)] += 1
        for r in rows:
            written[(split * n_slots + slot0[i] + p * n + r // b, r % b,
                     ht)] += 1
    total = sum(len(sub) * k for k, sub in zip(plan.scales, plan.subsets))
    assert len(seen) == total * b * chunks * h_tiles
    assert set(seen.values()) == {1}
    assert set(written.values()) == {1}
    assert len(written) == splits * n_slots * b * h_tiles

    # the epilogue: for (i, j), planes split * n_slots + slot0 + p*n + j,
    # positions ascending, D slices ascending within each
    order = []
    for i, (k, sub) in enumerate(zip(plan.scales, plan.subsets)):
        for j in range(len(sub)):
            order += [sp * n_slots + slot0[i] + p * len(sub) + j
                      for p in range(k) for sp in range(splits)]
    assert sorted(order) == list(range(splits * n_slots))


@pytest.mark.parametrize("s", [2, 3, 5, 8])
@pytest.mark.parametrize("b", [1, 64, 202, 640])
def test_fwd_splits_keep_the_grid_within_the_target(b, s):
    """D slices: 1..8, at most one per chunk, and the grid within
    _FWD_TARGET_BLOCKS unless one slice per tile already exceeds it."""
    d, h = 512, 256
    splits = trn_fused._fwd_splits(s, 3, b, d, h)
    blocks = sum(1 for _ in _blocks(s, b, d, h, splits))
    assert 1 <= splits <= min(trn_fused._FWD_MAX_SPLITS, -(-d // TK))
    assert splits == 1 or blocks <= trn_fused._FWD_TARGET_BLOCKS
    # one more slice would pass the target
    assert splits == trn_fused._FWD_MAX_SPLITS or \
        blocks // splits * (splits + 1) > trn_fused._FWD_TARGET_BLOCKS
    if s == 5:
        want = {1: (2, 112), 64: (1, 128), 202: (1, 440), 640: (1, 1280)}
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
