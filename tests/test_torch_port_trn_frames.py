"""PyTorch port, the TRN beyond 16 frames: the relation plan (its subsets
unranked, never listed) against the JAX package's, the kernels' plan table
and the forward kernel's block search walked on the CPU at any S, and the
plain TRN versions (which CPU tensors take) at S = 17 and 20 against the
JAX package's XLA reference and its Pallas kernels in interpret mode.  The
CUDA kernels at S = 17 and 25 are tested on the card
(test_torch_port_cuda.py)."""

import itertools
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.ops import relation as jax_relation
from ta3n_tpu.ops.trn_fused import (_fused_backward_pallas, _fused_forward,
                                    trn_multiscale_reference)
from ta3n_tpu_torch.ops import relation, trn_fused

FWD_TOL = dict(rtol=1e-5, atol=1e-5)  # as test_torch_port_trn_train.py
BWD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s", range(2, 21))
def test_relation_plan_matches_jax(s):
    ours = relation.build_relation_plan(s)
    ref = jax_relation.build_relation_plan(s)
    assert ours.scales == ref.scales
    for a, b in zip(ours.subsets, ref.subsets, strict=True):
        np.testing.assert_array_equal(a, b)


def test_relation_plan_matches_brute_force_at_21():
    """The reference's rule by brute force (every combination walked in
    lexicographic order, the ones at ceil(i*N/n) kept)."""
    s = 21
    plan = relation.build_relation_plan(s)
    for scale_id, (k, got) in enumerate(zip(plan.scales, plan.subsets)):
        total = math.comb(s, k)
        n_sel = 1 if scale_id == 0 else min(3, total)
        want_at = {math.ceil(i * total / n_sel) for i in range(n_sel)}
        want = [c for i, c in enumerate(itertools.combinations(range(s), k))
                if i in want_at]
        assert got.tolist() == [list(c) for c in want]


def test_combination_at_is_lexicographic():
    for n in range(1, 9):
        for k in range(1, n + 1):
            assert [relation.combination_at(n, k, i)
                    for i in range(math.comb(n, k))] == \
                list(itertools.combinations(range(n), k))
    with pytest.raises(IndexError):
        relation.combination_at(5, 2, 10)


def test_plan_at_25_frames_is_instant():
    relation.build_relation_plan.cache_clear()
    t0 = time.perf_counter()
    plan = relation.build_relation_plan(25)
    assert time.perf_counter() - t0 < 1.0
    assert [len(sub) for sub in plan.subsets] == [1] + [3] * 23


@pytest.mark.parametrize("s", [17, 25])
def test_kernel_input_checks_take_many_frames(s):
    b, d, h = 2, 8, 4
    x = torch.zeros((b, s, d))
    w = [torch.zeros((h, k * d)) for k in relation.relation_scales(s)]
    bi = [torch.zeros(h) for _ in w]
    trn_fused._check_inputs(x, w, bi, s, 3)


@pytest.mark.parametrize("s", [2, 5, 17, 25])
def test_plan_table_sections(s):
    """The table of csrc/trn_plan.cuh at any S: its sizes, the units'
    running counts of 1-, 2- and 3-subset units, and every (unit, subset)
    of the plan read by exactly its frame's triples."""
    t = trn_fused._plan_table(s, 3)
    plan = relation.build_relation_plan(s)
    ns, nu = s - 1, sum(plan.scales)
    assert t[:4].tolist() == [ns, nu, sum(len(x) for x in plan.subsets),
                              sum(k * len(x) for k, x in
                                  zip(plan.scales, plan.subsets))]
    units = t[4 + 4 * ns:4 + 4 * ns + 12 * nu].reshape(nu, 12)
    trip0 = t[4 + 4 * ns + 12 * nu:][:s + 1]
    trips = t[4 + 4 * ns + 12 * nu + s + 1:]
    assert trip0[-1] == len(trips)
    counts = np.zeros(4, int)
    for u in units:
        assert u[4:7].tolist() == counts[1:].tolist()
        counts[u[2]] += 1
    pairs = [(code >> 2, code & 3) for code in trips]
    assert sorted(pairs) == [(z, j) for z, u in enumerate(units)
                             for j in range(u[2])]
    for f in range(s):
        for code in trips[trip0[f]:trip0[f + 1]]:
            assert units[code >> 2][8 + (code & 3)] == f


@pytest.mark.parametrize("s", [5, 17, 25])
@pytest.mark.parametrize("b", [1, 64, 202])
def test_fwd_block_search_walks_the_grid(b, s):
    """K1's block search (csrc/trn_fused_fwd.cu): a unit's first block
    from its running counts of 1-, 2- and 3-subset units, and its range of
    m_tiles(n_sub) * h_tiles * splits blocks.  Every block of the grid
    falls in exactly one unit, in the order unit, H tile, row tile, D
    slice (test_torch_port_trn_split.py), and the grid is the C entry's."""
    d, h = 512, 256
    splits = trn_fused._fwd_splits(s, 3, b, d, h)
    t = trn_fused._plan_table(s, 3)
    ns, nu = s - 1, t[1]
    units = t[4 + 4 * ns:4 + 4 * ns + 12 * nu].reshape(nu, 12)
    mt = np.array([0] + [-(-n * b // 64) for n in (1, 2, 3)])
    per_tile = -(-h // 64) * splits
    first = per_tile * (units[:, 4] * mt[1] + units[:, 5] * mt[2]
                        + units[:, 6] * mt[3])
    sizes = per_tile * mt[units[:, 2]]
    # the units' ranges tile the grid: each block is in exactly one
    assert first[0] == 0 and (first[1:] == first[:-1] + sizes[:-1]).all()
    grid = int(first[-1] + sizes[-1])
    want = [(z, ht, m, sp) for z, u in enumerate(units)
            for ht in range(-(-h // 64)) for m in range(mt[u[2]])
            for sp in range(splits)]
    assert grid == len(want)
    blk = np.arange(grid)
    z = np.searchsorted(first, blk, side="right") - 1
    rest = blk - first[z]
    split, rest = rest % splits, rest // splits
    m_tiles = mt[units[z, 2]]
    got = np.stack([z, rest // m_tiles, rest % m_tiles, split], axis=1)
    np.testing.assert_array_equal(got, np.asarray(want))


def _inputs(b, s, d, h, seed=0):
    """x of both signs, weights in the JAX layout [k*D, H] at torch's
    default scale, and an upstream gradient."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    weights, biases = [], []
    for k in jax_relation.build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append(rng.uniform(-bound, bound, (k * d, h))
                       .astype(np.float32))
        biases.append(rng.uniform(-bound, bound, (h,)).astype(np.float32))
    g = rng.normal(size=(b, s - 1, h)).astype(np.float32)
    tx = (torch.from_numpy(x),
          [torch.from_numpy(np.ascontiguousarray(w.T)) for w in weights],
          [torch.from_numpy(bi) for bi in biases])
    jx = (jnp.asarray(x), tuple(map(jnp.asarray, weights)),
          tuple(map(jnp.asarray, biases)))
    return tx, jx, g


@pytest.mark.parametrize("s", [17, 20])
def test_plain_forward_and_masks_match_jax(s):
    """Output against the XLA reference and the Pallas forward
    (interpret mode); the masks exactly those of the Pallas forward."""
    b, d, h = 5, 16, 8
    tx, jx, _ = _inputs(b, s, d, h)
    want = np.asarray(trn_multiscale_reference(*jx, s))
    want_out, want_masks = _fused_forward(*jx, s, 3, True)
    out, masks = trn_fused.trn_multiscale_fwd_masks_plain(*tx, s)
    np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD_TOL)
    np.testing.assert_allclose(
        trn_fused.trn_multiscale_infer(*tx, s).numpy(), want, **FWD_TOL)
    np.testing.assert_array_equal(masks.numpy().astype(np.float32),
                                  np.asarray(want_masks, np.float32))


@pytest.mark.parametrize("s", [17, 20])
def test_plain_backward_matches_jax(s):
    """dx, every dW (transposed to the JAX layout) and db against the
    Pallas backward in interpret mode, from the same masks."""
    b, d, h = 5, 16, 8
    tx, jx, g = _inputs(b, s, d, h, seed=1)
    jmasks = _fused_forward(*jx, s, 3, True)[1]
    want_dx, want_dw, want_db = _fused_backward_pallas(
        jx[0], jx[1], jmasks, jnp.asarray(g), s, 3, True)
    _, masks = trn_fused.trn_multiscale_fwd_masks_plain(*tx, s)
    dx, dws, dbs = trn_fused.trn_multiscale_bwd(
        tx[0], tx[1], masks, torch.from_numpy(g), s)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **BWD_TOL)
    assert len(dws) == len(dbs) == s - 1
    for ours, ref in zip(dws, want_dw):
        np.testing.assert_allclose(ours.numpy().T, np.asarray(ref),
                                   **BWD_TOL)
    for ours, ref in zip(dbs, want_db):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BWD_TOL)
