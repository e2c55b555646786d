"""PyTorch port, int8 inference (``ModelConfig.quantize="int8"``) against
the JAX package on the CPU: the W8A8 codes and scales of ``int8_matmul``
and ``int8_batched_matmul`` equal JAX's element for element (both round
half to even, ``torch.round`` and ``jnp.round``, so a tie rounds the same
way) and their outputs within OP_RTOL; the int8 flagship-shaped model at
JAX's ``QCFG`` widths (tests/test_int8_infer.py: 256-d, 3 segments) on
converted weights within MODEL_TOL of JAX's; every train-step builder
refusing int8; K1 never called and the logits heads never quantized; the
int8 and float32 Predictors agreeing by JAX's rule (same argmax, max
|dp| < 0.05); the int8 ensemble Predictor the mean of its solo
Predictors with no vmap fallback, and JAX's ensemble; and the int8 eval
steps from a store equal to those from host features.

Tolerances: OP_RTOL 1e-6 (the float32 rescale (acc + zp*colsum)*sx*sw,
which XLA may fuse); MODEL_TOL |port - JAX| <= 1e-4 * max|JAX| per
output (float32 summation order upstream of each quantization; a code
that flips moves an output by one step of its grid).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.models.layers import _activation_scale as jax_scale
from ta3n_tpu.models.layers import int8_batched_matmul as jax_int8_bmm
from ta3n_tpu.models.layers import int8_matmul as jax_int8_mm
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel, layers
from ta3n_tpu_torch.models import trn as trn_module
from ta3n_tpu_torch.serve import Predictor
from ta3n_tpu_torch.train import ensemble, step

FIELDS = dict(num_class=6, baseline_type="video", frame_aggregation="trn-m",
              train_segments=3, val_segments=3, feature_dim=256, fc_dim=256,
              dropout_i=0.0, dropout_v=0.0, use_attn="TransAttn")
CFG = ModelConfig(**FIELDS)
QCFG = dataclasses.replace(CFG, quantize="int8")
OP_RTOL = 1e-6
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU ops, as in the
    heaviest port test files (tests/test_torch_port_ensemble.py); the
    previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """JAX's QCFG parameters: its init, every matrix x50 (trained-like
    logit separations), as tests/test_int8_infer.py draws them."""
    m = JaxVideoModel(JaxModelConfig(**FIELDS))
    x = jnp.zeros((4, 3, 256), jnp.float32)
    v = jax.jit(lambda key: m.init(key, x, x, jnp.zeros(3),
                                   jnp.asarray(0.0), False, False))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a * 50.0 if a.ndim >= 2 else a), v["params"])


def _x(seed=1, n=8):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (n, 3, 256)), np.float32)


def _port(cfg, params):
    model = VideoModel(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, {}))
    return model.eval()


def _jax_codes(x, kernel):
    """JAX int8_matmul's codes and scales (ta3n_tpu/models/layers.py:
    95-104), computed with its own ops, op by op: under jit XLA may turn
    the divisions by the constants 127 and 255 into products with their
    reciprocals, an ulp off, and the port keeps the divisions."""
    kf = jnp.asarray(kernel)
    sw = jnp.max(jnp.abs(kf), axis=0) / 127.0
    sw = jnp.where(sw > 0, sw, 1.0)
    w8 = jnp.clip(jnp.round(kf / sw), -127, 127).astype(jnp.int8)
    xf = jnp.asarray(x)
    hi = jnp.max(xf, axis=-1, keepdims=True)
    lo = jnp.min(xf, axis=-1, keepdims=True)
    sx = jax_scale(hi, lo)
    zp = jnp.round(lo / sx) + 128.0
    x8 = jnp.clip(jnp.round(xf / sx) - zp, -128, 127).astype(jnp.int8)
    return w8, sw, x8, sx, zp


def _op_inputs():
    """Rows post-relu, signed, constant (the degenerate-row rule), zero,
    and on JAX's exact grids (every code a tie-free integer), against a
    wide weight with a zero column."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 256)).astype(np.float32)
    x[:4] = np.maximum(x[:4], 0.0)
    x[4] = 0.3
    x[5] = -0.45
    x[6] = 0.0
    x[7] = (rng.integers(0, 256, 256) * 0.25).astype(np.float32)
    x[7, :2] = 0.0, 255 * 0.25
    x[8] = x[7] + 0.125          # every value half a step off the grid
    w = rng.normal(scale=0.05, size=(256, 136)).astype(np.float32)
    w[:, 3] = 0.0
    return x, w


def test_int8_codes_equal_jax():
    x, kernel = _op_inputs()
    w8, sw, colsum = layers.quantize_weight(torch.from_numpy(kernel.T))
    x8, sx, zp = layers.quantize_rows(torch.from_numpy(x))
    want = [np.asarray(a) for a in _jax_codes(x, kernel)]
    for name, got, ref in zip(("w8", "sw", "x8", "sx", "zp"),
                              (w8.T, sw, x8, sx, zp), want):
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    np.testing.assert_array_equal(colsum.numpy(),
                                  want[0].astype(np.int32).sum(0))
    out = layers.int8_matmul(torch.from_numpy(x), torch.from_numpy(kernel.T))
    ref = np.asarray(jax_int8_mm(jnp.asarray(x), jnp.asarray(kernel)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=OP_RTOL, atol=1e-6)
    # the constant rows reconstruct exactly (JAX's degenerate-row rule)
    eye = torch.eye(256)[:136]
    rows = layers.int8_matmul(torch.from_numpy(x[4:7]), eye)
    np.testing.assert_allclose(rows.numpy(), x[4:7, :136], rtol=2e-6,
                               atol=1e-7)


def test_int8_batched_matmul_equals_jax():
    """Per-(head, output) weight scales and per-(row, head) activation
    scales: each head's codes are JAX's, the outputs within OP_RTOL, and
    head r is int8_matmul of head r's rows and weight."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 3, 128)).astype(np.float32)
    x[2, 1] = 0.3
    w = rng.normal(size=(3, 128, 136)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).transpose(1, 2)
    got = layers.int8_batched_matmul(xt, wt)
    ref = np.asarray(jax_int8_bmm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=OP_RTOL, atol=1e-5)
    w8, _, _ = layers.quantize_weight(wt)
    for r in range(3):
        np.testing.assert_array_equal(w8[r].T.numpy(), np.asarray(
            _jax_codes(x[:, r], w[r])[0]))
        torch.testing.assert_close(got[:, r],
                                   layers.int8_matmul(xt[:, r], wt[r]),
                                   rtol=0, atol=0)


def test_int8_model_matches_jax(params):
    """Every output of both streams against JAX's QCFG model on the same
    weights, in eval mode."""
    x = _x()
    jm = JaxVideoModel(JaxModelConfig(**FIELDS, quantize="int8"))
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, x, jnp.zeros(3),
                                        jnp.asarray(0.0), False,
                                        False)[1])(params, x)
    model = _port(QCFG, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x)[:0], torch.from_numpy(x),
                    (0.0, 0.0, 0.0), 0.0, False, False)[1]
    pairs = [("attn", out.attn, ref.attn), ("out", out.out, ref.out),
             *((f"pred_domain {i}", a, b) for i, (a, b) in
               enumerate(zip(out.pred_domain, ref.pred_domain))),
             *((f"feat {i}", a, b) for i, (a, b) in
               enumerate(zip(out.feat, ref.feat)))]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= MODEL_TOL * np.abs(
            want).max(), name


def test_k1_never_runs_and_heads_stay_float(params, monkeypatch):
    """Under int8 the TRN takes no fused op (JAX turns Pallas off); the
    int8 products of one forward at 3 segments are the shared FC, the
    frame domain FC, the 2 TRN scales, the 2 relation heads' first layers
    and the video domain FC; no weight with 2 or num_class outputs is
    quantized."""
    def fused(*args, **kw):
        raise AssertionError("a fused TRN op ran under int8")

    monkeypatch.setattr(trn_module, "trn_multiscale_infer", fused)
    monkeypatch.setattr(trn_module, "trn_multiscale_fused", fused)
    seen = []
    real = layers.int8_matmul
    monkeypatch.setattr(layers, "int8_matmul", lambda x, w: (
        seen.append(tuple(w.shape)), real(x, w))[1])
    monkeypatch.setattr(trn_module, "int8_matmul", layers.int8_matmul)
    model = _port(QCFG, params)
    layers.int8_gemms = 0
    x = torch.from_numpy(_x())
    with torch.no_grad():
        model(x[:0], x, (0.0, 0.0, 0.0), 0.0, False, False)
    assert layers.int8_gemms == len(seen) == 7
    assert sorted(seen) == sorted([(256, 256)] * 5 + [(256, 768),
                                                      (256, 512)])
    assert all(o not in (2, CFG.num_class) for o, _ in seen)


def _builders():
    sampler = type("Sampler", (), {"steps_per_epoch": 1})()
    da, tc = DAConfig(), TrainConfig()
    return {
        "make_train_step": lambda m: step.make_train_step(m, da, tc),
        "make_grad_accum_step": lambda m: step.make_grad_accum_step(
            m, da, tc),
        "make_multi_train_step": lambda m: step.make_multi_train_step(
            m, da, tc),
        "make_sampled_multi_step": lambda m: step.make_sampled_multi_step(
            m, da, tc, sampler, sampler),
        "make_sampled_shard_multi_step":
            lambda m: step.make_sampled_shard_multi_step(
                m, da, tc, sampler, sampler, 1),
        "make_ensemble_step": lambda m: ensemble.make_ensemble_step(
            m, da, tc),
        "make_ensemble_multi_step":
            lambda m: ensemble.make_ensemble_multi_step(m, da, tc),
    }


@pytest.mark.parametrize("builder", sorted(_builders()))
def test_train_builders_refuse_int8(builder):
    """round() has zero gradient: every train-step builder refuses, as
    JAX's make_train_step (train/step.py:449-455)."""
    model = VideoModel(dataclasses.replace(QCFG, feature_dim=16, fc_dim=16))
    with pytest.raises(ValueError, match="inference-only"):
        _builders()[builder](model)


def test_int8_refuses_bf16_compute():
    with pytest.raises(ValueError, match="computes in float32"):
        VideoModel(dataclasses.replace(QCFG, compute_dtype="bfloat16"))


def test_int8_and_f32_predictors_agree_by_jax_rule(params):
    """JAX's rule (tests/test_int8_infer.py:147-152): the same argmax and
    max |dp| < 0.05, here through the port's Predictors (batch 4, the
    second chunk padded)."""
    x = _x(n=6)
    p32 = Predictor(CFG, _port(CFG, params), batch_size=4, top_k=3,
                    device="cpu")(x)[0]
    p8 = Predictor(QCFG, _port(QCFG, params), batch_size=4, top_k=3,
                   device="cpu")(x)[0]
    np.testing.assert_array_equal(p32.argmax(-1), p8.argmax(-1))
    assert np.abs(p32 - p8).max() < 0.05


def test_int8_ensemble_predictor(params):
    """Two members (the weights and the weights x1.1) in one vmapped
    pass: no vmap fallback (the int8 product's member rule), the mean of
    the two solo int8 Predictors.  (tests/test_torch_port_export.py holds
    a 2-member artifact to JAX's.)"""
    p2 = jax.tree_util.tree_map(lambda a: a * np.float32(1.1), params)
    x = _x(seed=3, n=4)
    ens = Predictor(QCFG, [_port(QCFG, p) for p in (params, p2)],
                    n_members=2, batch_size=4, top_k=3, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        probs, _, top_i = ens(x)
    assert not [w for w in caught if "performance drop" in str(w.message)]
    solos = [Predictor(QCFG, _port(QCFG, p), batch_size=4, top_k=3,
                       device="cpu")(x)[0] for p in (params, p2)]
    np.testing.assert_allclose(probs, np.mean(solos, axis=0), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(top_i[:, 0],
                                  np.mean(solos, axis=0).argmax(-1))


def test_int8_eval_steps_from_a_store(params):
    """From a store the int8 first FC takes the rows gathered plain: the
    infer and eval steps equal those from host features of the same
    videos, with a padded video."""
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(3, 256)).astype(np.float32) for _ in range(5)]
    store = FeatureStore.from_arrays(feats, [f"v{i}" for i in range(5)],
                                     [0, 1, 2, 3, 4])
    idx = np.arange(15).reshape(5, 3)
    idx[4] = 0
    mask = np.array([1, 1, 1, 1, 0], np.float32)
    x = np.stack(feats) * mask[:, None, None]
    model = _port(QCFG, params)
    dev = store.to_device("cpu")
    host = step.make_infer_step(model, 3)(x)
    gathered = step.make_infer_step(model, 3, gather_on_device=True)(
        dev, idx[None], mask[None])
    for a, b in zip(host, gathered):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)
    y = np.arange(5) % 6
    ev_host = step.make_eval_step(model)(x, y, mask)
    ev_store = step.make_eval_step(model, gather_on_device=True)(
        dev, idx, y, mask)
    for key in ("loss", "top1", "logits"):
        torch.testing.assert_close(ev_host[key], ev_store[key], rtol=0,
                                   atol=0)
