"""The host side of the port's TRN forward kernel (K1,
csrc/trn_fused_fwd.cu): its work units, one per (scale, frame position),
and its choice of D slices.  The kernel itself runs on the card
(test_torch_port_cuda.py); here its block order and scratch layout, as
its source note and ``_fwd_units`` state them, are walked on the CPU."""

import collections

import pytest

from ta3n_tpu_torch.ops import trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan

TM, TH, TK = trn_fused._FWD_TILE_M, trn_fused._FWD_TILE_H, \
    trn_fused._FWD_TILE_K


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
