"""PyTorch port, bfloat16 compute against the JAX package on the CPU.

The kernels' plain versions in bfloat16 against the Pallas kernels in
interpret mode, both in bfloat16 (the point is the kernel's arithmetic):
K1 (infer and train) and K2's dx, dW and db within one bfloat16 ulp of
the reference, |d| <= 2**-7 * |ref| + 1e-6 (a float32 sum on either side
of a rounding midpoint rounds to neighbours one ulp apart, and an ulp is
at most 2**-7 of the value; 2**-8 is half of one, the rounding itself),
masks equal except where |z| <= 1e-6; the plain K3 at bfloat16 compute
against ``gathered_gemm_reference`` on bfloat16 rows within the same
bound, x_res equal.

The slice as a whole (the point is the algorithm; the two frameworks
round bfloat16 at other places, XLA's CPU path keeping fused elementwise
chains in float32): every ``StreamOutput`` field of the flagship, avgpool
and the RNN has its JAX counterpart's dtype and lies within 3e-2 of its
largest value, and so do the losses of a first train step; the Trainer
at bfloat16 on the synthetic task of tests/test_bf16_training.py stays in
the band that test sets.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_port_train import DA, GAMMA, _redraw
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.ops import relation as jax_relation
from ta3n_tpu.ops.gather_gemm import gathered_gemm_reference, pack_store
from ta3n_tpu.ops.trn_fused import _fused_backward_pallas, _fused_forward
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.train import StepScalars, create_train_state
from ta3n_tpu_torch.train import make_train_step
from ta3n_tpu_torch.train.loop import Trainer

BF16 = ml_dtypes.bfloat16
SLICE_TOL = 3e-2
CASES = [(6, 5, 16, 8), (13, 4, 37, 19), (4, 3, 64, 16)]


def _ulp_ok(got, want):
    """|got - want| <= 2**-7 * |want| + 1e-6, elementwise, in float32."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return bool((np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)
                .all())


def _bf16_inputs(b, s, d, h, seed=0):
    """x of both signs, weights [k*D, H] (the JAX layout) and biases at
    torch's default scale, and an upstream gradient: bfloat16 values, as
    numpy float32 arrays."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return a.astype(BF16).astype(np.float32)

    x = bf(rng.normal(size=(b, s, d)))
    weights, biases = [], []
    for k in jax_relation.build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append(bf(rng.uniform(-bound, bound, (k * d, h))))
        biases.append(bf(rng.uniform(-bound, bound, (h,))))
    g = bf(rng.normal(size=(b, s - 1, h)))
    return x, weights, biases, g


def _jax(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
            for a in arrays]


def _zb(x, weights, biases, s):
    """Every subset's z [B, n_sub*H] in float64, in the masks' order."""
    plan = jax_relation.build_relation_plan(s)
    b = x.shape[0]
    zs = []
    for w, bias, k, subsets in zip(weights, biases, plan.scales,
                                   plan.subsets):
        g = np.maximum(x[:, subsets.reshape(-1)], 0).reshape(
            b, len(subsets), k * x.shape[2]).astype(np.float64)
        zs.append((g @ w + bias).reshape(b, -1))
    return np.concatenate(zs, axis=1)


@pytest.mark.parametrize("b,s,d,h", CASES)
def test_bf16_fwd_plain_matches_pallas(b, s, d, h):
    """K1 (infer and train) plain versions in bfloat16 against
    `_fused_forward` in interpret mode in bfloat16."""
    x, w, bi, _ = _bf16_inputs(b, s, d, h)
    want, want_masks = _fused_forward(_jax(x)[0], tuple(_jax(*w)),
                                      tuple(_jax(*bi)), s, 3, True)
    want_inf, _ = _fused_forward(_jax(x)[0], tuple(_jax(*w)),
                                 tuple(_jax(*bi)), s, 3, True,
                                 with_masks=False)
    tx, = _torch(x)
    tw, tb = _torch(*[a.T for a in w]), _torch(*bi)
    out, masks = trn_fused.trn_multiscale_fwd_masks_plain(tx, tw, tb, s)
    inf = trn_fused.trn_multiscale_plain(tx, tw, tb, s)
    assert out.dtype == inf.dtype == torch.bfloat16
    assert str(want.dtype) == "bfloat16"
    assert _ulp_ok(out.float(), want) and _ulp_ok(inf.float(), want_inf)
    differ = masks.numpy() != np.asarray(want_masks, np.float32)
    assert (np.abs(_zb(x, w, bi, s))[differ] <= 1e-6).all()


@pytest.mark.parametrize("b,s,d,h", CASES)
def test_bf16_bwd_plain_matches_pallas(b, s, d, h):
    """K2's plain version in bfloat16 against `_fused_backward_pallas` in
    interpret mode in bfloat16, from the same masks: dx, every dW
    (transposed to the JAX layout) and db, each in bfloat16."""
    x, w, bi, g = _bf16_inputs(b, s, d, h)
    _, masks = _fused_forward(_jax(x)[0], tuple(_jax(*w)), tuple(_jax(*bi)),
                              s, 3, True)
    dx_j, dws_j, dbs_j = _fused_backward_pallas(
        _jax(x)[0], tuple(_jax(*w)), masks, _jax(g)[0], s, 3, True)
    tx, tg = _torch(x, g)
    tw = _torch(*[a.T for a in w])
    tmasks = torch.from_numpy(np.asarray(masks, np.float32)
                              .astype(np.uint8))
    dx, dws, dbs = trn_fused.trn_multiscale_bwd_plain(tx, tw, tmasks, tg, s)
    assert dx.dtype == dws[0].dtype == dbs[0].dtype == torch.bfloat16
    assert str(dx_j.dtype) == str(dws_j[0].dtype) == "bfloat16"
    assert _ulp_ok(dx.float(), dx_j)
    for got, want in zip(dws, dws_j):
        assert _ulp_ok(got.float().T, want)
    for got, want in zip(dbs, dbs_j):
        assert _ulp_ok(got.float(), want)


@pytest.mark.parametrize("n", [37, 8, 1])
def test_bf16_gather_plain_matches_reference(n):
    """The plain K3 at bfloat16 compute from a bfloat16 store against the
    JAX oracle on the same bfloat16 rows: z within the ulp bound, x_res
    equal."""
    rng = np.random.default_rng(n)
    store = rng.normal(size=(64, 256)).astype(BF16)
    idx = rng.integers(0, 64, size=n).astype(np.int32)
    w = rng.normal(scale=0.05, size=(256, 32)).astype(BF16)
    want_z, want_x = gathered_gemm_reference(
        pack_store(jnp.asarray(store)), jnp.asarray(idx), jnp.asarray(w))
    tstore, tw = _torch(store.astype(np.float32), w.T.astype(np.float32))
    z, x_res = gather_gemm.gathered_gemm_plain(
        tstore, torch.from_numpy(idx.astype(np.int64)), tw)
    assert z.dtype == x_res.dtype == torch.bfloat16
    assert _ulp_ok(z.float(), want_z)
    np.testing.assert_array_equal(x_res.float().numpy(),
                                  np.asarray(want_x, np.float32)
                                  .reshape(n, 256))


MODEL = dict(num_class=4, baseline_type="video", frame_aggregation="trn-m",
             train_segments=5, val_segments=5, feature_dim=32, fc_dim=16,
             use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0,
             compute_dtype="bfloat16")
SLICE = {"flagship": {},
         "avgpool": dict(frame_aggregation="avgpool"),
         "rnn": dict(frame_aggregation="rnn", use_attn="none", n_ts=3)}


def _slice_params(cfg, seed=0):
    init = jax_create_train_state(JaxVideoModel(JaxModelConfig(**cfg)),
                                  jax.random.PRNGKey(0), 3, 2,
                                  JaxTrainConfig(batch_size=(3, 2, 4)))
    params = jax.tree_util.tree_map(np.asarray, init.params)
    return params if cfg["frame_aggregation"] == "rnn" else _redraw(
        params, np.random.default_rng(seed))


def _close(got, want, label):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= SLICE_TOL * max(np.abs(want).max(), 1e-6), label


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("name", list(SLICE))
def test_bf16_stream_outputs_match_jax(name, is_train):
    """Both streams of the bfloat16 model: every field's dtype that of its
    JAX counterpart (bfloat16, or float32 where the JAX model computes in
    float32: TransAttn weights, the RNN's video feature), every value
    within SLICE_TOL of the field's largest."""
    cfg = {**MODEL, **SLICE[name]}
    params = _slice_params(cfg)
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(3, 5, 32)).astype(np.float32)
    xt = rng.normal(size=(2, 5, 32)).astype(np.float32)
    beta = np.asarray([0.75, 0.75, 0.5], np.float32)
    ref = JaxVideoModel(JaxModelConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(xs), jnp.asarray(xt),
        jnp.asarray(beta), jnp.asarray(0.0), is_train, False)
    model = VideoModel(ModelConfig(**cfg))
    model.load_state_dict(state_dict_from_jax_params(params))
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.0, is_train, False)
    for a, b in zip(ours, ref):
        pairs = [("attn", a.attn, b.attn), ("out", a.out, b.out),
                 ("out_2", a.out_2, b.out_2),
                 *((f"pred_domain {i}", x, y)
                   for i, (x, y) in enumerate(zip(a.pred_domain,
                                                  b.pred_domain))),
                 *((f"feat {i}", x, y)
                   for i, (x, y) in enumerate(zip(a.feat, b.feat)))]
        assert len(a.feat) == len(b.feat)
        for label, x, y in pairs:
            assert str(x.dtype).replace("torch.", "") == str(y.dtype), label
            _close(x, y, label)


def test_bf16_first_step_losses_match_jax():
    """One train step of the bfloat16 flagship from the same converted
    weights, one padded video per stream: every loss within SLICE_TOL of
    the JAX step's, which are bfloat16 too; the parameters stay
    float32."""
    cfg = dict(MODEL)
    params = _slice_params(cfg)
    jmodel = JaxVideoModel(JaxModelConfig(**cfg))
    jtc = JaxTrainConfig(lr=0.03)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, {}, _build_tx(jtc).init(jparams),
                           jnp.asarray(0, jnp.int32))
    jstep = jax_make_train_step(jmodel, JaxDAConfig(**DA), jtc)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(6, 5, 32)).astype(np.float32)
    xt = rng.normal(size=(5, 5, 32)).astype(np.float32)
    ys = rng.integers(0, 4, 6).astype(np.int32)
    yt = rng.integers(0, 4, 5).astype(np.int32)
    ms, mt = np.ones(6, np.float32), np.ones(5, np.float32)
    ms[-1] = mt[-1] = 0.0
    beta = (0.75, 0.75, 0.5)
    _, want = jstep(jstate, xs, ys, ms, xt, yt, mt, JaxStepScalars(
        np.asarray(beta, np.float32), np.float32(0), np.float32(0),
        np.float32(GAMMA), np.float32(0.03)), jax.random.PRNGKey(0))
    state = create_train_state(ModelConfig(**cfg), TrainConfig(lr=0.03),
                               device="cpu")
    state.model.load_state_dict(state_dict_from_jax_params(params))
    step = make_train_step(state.model, DAConfig(**DA), TrainConfig(lr=0.03))
    state, got = step(state, xs, ys, ms, xt, yt, mt,
                      StepScalars(beta, 0.0, 0.0, GAMMA, 0.03), None)
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    for key in ("loss", "loss_c", "loss_a", "loss_e"):
        assert got[key].dtype == torch.float32
        want_k = float(want[key])
        assert abs(float(got[key]) - want_k) <= SLICE_TOL * abs(want_k), key
    for key in ("top1", "top5", "n"):
        assert float(got[key]) == float(want[key]), key


def _synthetic_run(compute_dtype, tmp_path):
    """tests/test_bf16_training.py's run, through the port's Trainer."""
    src, tgt, val = make_domain_pair(num_source=48, num_target=36,
                                     num_val=24, num_class=3,
                                     feature_dim=16, shift=0.5)
    cfg = ModelConfig(num_class=3, baseline_type="video",
                      frame_aggregation="trn-m", train_segments=3,
                      val_segments=3, fc_dim=16, feature_dim=16,
                      use_attn="TransAttn", dropout_i=0.1, dropout_v=0.1,
                      compute_dtype=compute_dtype)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad")
    tc = TrainConfig(lr=0.2, epochs=4, batch_size=(12, 9, 12),
                     beta=(0.3, 0.3, 0.3))
    ls = TSNLoader(src, batch_size=12, num_segments=3, mode="test", seed=1)
    lt = TSNLoader(tgt, batch_size=9, num_segments=3, mode="test", seed=2)
    lv = TSNLoader(val, batch_size=12, num_segments=3, mode="test",
                   shuffle=False)
    tr = Trainer(cfg, da, tc, ls, lt, lv,
                 path_exp=str(tmp_path) + f"/{compute_dtype}/",
                 eval_freq=4, print_freq=100, show_freq=100, device="cpu")
    return tr.fit()


def test_bf16_trainer_trains_comparably(tmp_path):
    """The band of tests/test_bf16_training.py: float32 above the 33%
    chance level by 5 points, bfloat16 within 20 points of float32."""
    acc32 = _synthetic_run("float32", tmp_path)
    acc16 = _synthetic_run("bfloat16", tmp_path)
    assert acc32 > 38.0
    assert acc16 > acc32 - 20.0


def test_param_dtype_is_ignored_as_in_jax():
    """ModelConfig(param_dtype="bfloat16") builds with float32
    parameters, as the JAX package's (which reads the field nowhere), and
    computes what the float32 model computes."""
    cfg = ModelConfig(**{**MODEL, "compute_dtype": "float32"})
    a = VideoModel(dataclasses.replace(cfg, param_dtype="bfloat16"),
                   torch.Generator().manual_seed(0))
    b = VideoModel(cfg, torch.Generator().manual_seed(0))
    assert {p.dtype for p in a.parameters()} == {torch.float32}
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
    for oa, ob in zip(a(x, x, (0.5,) * 3, 0.0, False),
                      b(x, x, (0.5,) * 3, 0.0, False)):
        assert torch.equal(oa.out, ob.out)
