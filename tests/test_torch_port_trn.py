"""PyTorch port, ops: the relation plan, the fused multi-scale TRN forward
(its plain version, which CPU tensors take; the CUDA kernel is tested on
the card by test_torch_port_cuda.py), the GRL, the TransAttn entropy and
the init policy, each held against the JAX package.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.losses.losses import entropy_from_logits as jax_entropy
from ta3n_tpu.models.trn import \
    RelationModuleMultiScale as JaxRelationModuleMultiScale
from ta3n_tpu.ops import relation as jax_relation
from ta3n_tpu.ops.trn_fused import (trn_multiscale_infer as jax_infer,
                                    trn_multiscale_reference as jax_reference)
from ta3n_tpu_torch.losses.losses import entropy_from_logits
from ta3n_tpu_torch.models.layers import linear
from ta3n_tpu_torch.models.trn import RelationModuleMultiScale
from ta3n_tpu_torch.ops import relation, trn_fused
from ta3n_tpu_torch.ops.grl import grad_reverse

D, H = 16, 8
TOL = dict(rtol=1e-5, atol=1e-5)  # as tests/test_trn_fused.py: f32 sums


def _trn_inputs(b, s, d=D, h=H, seed=0):
    """x of both signs (exercises the relu on load); weights in the JAX
    layout [k*D, H] at torch's default scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    weights, biases = [], []
    for k in jax_relation.build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append(rng.uniform(-bound, bound, (k * d, h))
                       .astype(np.float32))
        biases.append(rng.uniform(-bound, bound, (h,)).astype(np.float32))
    return x, weights, biases


def _torch_layout(x, weights, biases):
    return (torch.from_numpy(x),
            [torch.from_numpy(np.ascontiguousarray(w.T)) for w in weights],
            [torch.from_numpy(b) for b in biases])


@pytest.mark.parametrize("s", range(2, 9))
def test_relation_plan_matches_jax(s):
    ours = relation.build_relation_plan(s)
    ref = jax_relation.build_relation_plan(s)
    assert ours.scales == ref.scales
    assert ours.num_relation_features == ref.num_relation_features
    assert len(ours.subsets) == len(ref.subsets)
    for a, b in zip(ours.subsets, ref.subsets):
        np.testing.assert_array_equal(a, b)
    assert relation.selected_relation_indices(s) == \
        jax_relation.selected_relation_indices(s)


@pytest.mark.parametrize("b", [6, 202])
@pytest.mark.parametrize("s", [3, 5])
def test_trn_infer_matches_jax(b, s):
    """CPU tensors take the plain version; it equals the Pallas kernel (in
    interpret mode) and the XLA reference of the JAX package."""
    x, weights, biases = _trn_inputs(b, s)
    jw, jb = tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray,
                                                         biases))
    want_kernel = np.asarray(jax_infer(jnp.asarray(x), jw, jb, s, 3, True))
    want_ref = np.asarray(jax_reference(jnp.asarray(x), jw, jb, s))
    trn_fused.launches = 0
    got = trn_fused.trn_multiscale_infer(*_torch_layout(x, weights, biases),
                                         s).numpy()
    assert trn_fused.launches == 0  # the CPU path launches nothing
    assert got.shape == (b, s - 1, H)
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


@pytest.mark.parametrize("infer", [True, False])
def test_relation_module_matches_jax(infer):
    """The module holds nn.Linear-layout weights that equal the JAX
    module's transposed kernels, and its forward agrees in both modes."""
    s, b = 5, 7
    x, weights, biases = _trn_inputs(b, s, seed=1)
    params = {"params": {}}
    for i, (w, bi) in enumerate(zip(weights, biases)):
        params["params"][f"w_scale_{i}"] = jnp.asarray(w)
        params["params"][f"b_scale_{i}"] = jnp.asarray(bi)
    want = JaxRelationModuleMultiScale(D, H, s, use_pallas="never").apply(
        params, jnp.asarray(x), infer=infer)
    mod = RelationModuleMultiScale(D, H, s)
    with torch.no_grad():
        for seq, w, bi in zip(mod.fc_fusion_scales, weights, biases):
            seq[1].weight.copy_(torch.from_numpy(w.T))
            seq[1].bias.copy_(torch.from_numpy(bi))
    got = mod(torch.from_numpy(x), infer=infer).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_plain_version_is_differentiable():
    """The plain version is the training path on CPU: autograd through it
    equals autograd through the JAX reference (sum of squares loss)."""
    import jax

    s, b = 4, 5
    x, weights, biases = _trn_inputs(b, s, seed=2)
    tx, tw, tb = _torch_layout(x, weights, biases)
    for t in (tx, *tw, *tb):
        t.requires_grad_(True)
    (trn_fused.trn_multiscale_plain(tx, tw, tb, s) ** 2).sum().backward()
    gx, gw, gb = jax.grad(
        lambda x, w, b: jnp.sum(jax_reference(x, w, b, s) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(x), tuple(map(jnp.asarray, weights)),
                           tuple(map(jnp.asarray, biases)))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for t, g in zip(tw, gw):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g).T,
                                   rtol=1e-4, atol=1e-5)
    for t, g in zip(tb, gb):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5)


def test_kernel_plan_table_layout():
    """The kernels' plan (csrc/trn_plan.cuh): the header, per scale k,
    n_sub, sub0, slot0; per (scale, position) unit its scale, position,
    subset count, slot, the units before it by subset count, sub0, its
    subsets' frames and k; per frame the triples that read it."""
    table = trn_fused._plan_table(5, 3).tolist()
    plan = relation.build_relation_plan(5, 3)
    assert table[:4] == [4, 14, 10, 32]
    scales = [table[4 + 4 * i:8 + 4 * i] for i in range(4)]
    assert scales == [[5, 1, 0, 0], [4, 3, 1, 5], [3, 3, 4, 17],
                      [2, 3, 7, 26]]
    units = [table[20 + 12 * z:32 + 12 * z] for z in range(14)]
    z = 0
    for i, (k, subsets) in enumerate(zip(plan.scales, plan.subsets)):
        n = len(subsets)
        for p in range(k):
            frames = subsets[:, p].tolist() + [-1] * (3 - n)
            assert units[z][:4] == [i, p, n, scales[i][3] + p * n]
            assert units[z][7:] == [scales[i][2], *frames, k]
            z += 1
    assert units[0] == [0, 0, 1, 0, 0, 0, 0, 0, 0, -1, -1, 5]
    assert [u[4:7] for u in units[4:7]] == [[4, 0, 0], [5, 0, 0], [5, 0, 1]]
    trip0 = table[188:194]
    trips = table[194:]
    assert trip0[0] == 0 and trip0[-1] == len(trips) == 32
    for f in range(5):
        for code in trips[trip0[f]:trip0[f + 1]]:
            unit, j = divmod(code, 4)
            assert units[unit][8 + j] == f


@pytest.mark.parametrize("case", ["dtype", "layout", "contiguous", "frames",
                                  "count", "subsets"])
def test_kernel_input_checks(case):
    """What the CUDA wrapper refuses, checked on CPU tensors."""
    s, b = 5, 3
    x, w, bi = _torch_layout(*_trn_inputs(b, s))
    kw = dict(num_frames=s, subsample_num=3)
    if case == "dtype":
        x, err = x.double(), TypeError
    elif case == "layout":  # JAX layout [k*D, H] instead of [H, k*D]
        w, err = [t.T.contiguous() for t in w], ValueError
    elif case == "contiguous":
        w, err = [t.T.contiguous().T for t in w], ValueError
    elif case == "frames":  # any S from 2 up runs; 1 has no relation
        x, kw["num_frames"], err = x[:, :1], 1, ValueError
    elif case == "count":
        w, err = w[:-1], ValueError
    else:
        kw["subsample_num"], err = 4, ValueError
    with pytest.raises(err):
        trn_fused._check_inputs(x, w, bi, **kw)
    trn_fused._check_inputs(*_torch_layout(*_trn_inputs(b, s)), s, 3)


def test_grad_reverse():
    """Identity forward; backward -beta * g with a tensor beta, as the JAX
    custom VJP."""
    import jax

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    g = rng.normal(size=(3, 4)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = grad_reverse(tx, torch.tensor(0.75))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    y.backward(torch.from_numpy(g))
    from ta3n_tpu.ops.grl import grad_reverse as jax_grad_reverse
    _, vjp = jax.vjp(lambda v: jax_grad_reverse(v, 0.75), jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), -0.75 * g, rtol=1e-6)


def test_entropy_from_logits_matches_jax():
    logits = np.random.default_rng(5).normal(
        scale=3.0, size=(6, 4, 2)).astype(np.float32)
    got = entropy_from_logits(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_entropy(logits)),
                               rtol=1e-5, atol=1e-6)


def test_init_policy_and_generator():
    """normal001: N(0, 0.001) weights and zero bias; torch_default:
    U(±1/sqrt(fan_in)) on both; the same seeded generator gives the same
    weights, and the global RNG is not touched."""
    state = torch.random.get_rng_state()
    a = linear(400, 300, "normal001", torch.Generator().manual_seed(7))
    b = linear(400, 300, "normal001", torch.Generator().manual_seed(7))
    assert torch.equal(a.weight, b.weight)
    assert abs(a.weight.std().item() - 1e-3) < 5e-5
    assert not a.bias.any()
    c = linear(400, 300, "torch_default", torch.Generator().manual_seed(7))
    bound = 1 / math.sqrt(400)
    for t in (c.weight, c.bias):
        assert t.abs().max().item() <= bound
        assert t.abs().max().item() > 0.9 * bound
    assert torch.equal(torch.random.get_rng_state(), state)
    with pytest.raises(ValueError):
        linear(4, 3, "xavier", None)
