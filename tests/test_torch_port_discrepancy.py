"""PyTorch port, the discrepancy losses: DAN's RBF MMD (ver 1 and 2),
JAN, CORAL, the linear MMD and the adaptive loss weight against
`ta3n_tpu.losses` on the same numpy inputs, values and gradients
(torch.autograd against jax.grad), with and without row masks; the
degenerate masks of tests/test_losses.py:175-210 (finite losses and
gradients, all-padded slices exactly 0) and the float64 near-duplicate
check of tests/test_losses.py:213-235 on the port's function; then
`_discrepancy_loss` against the JAX one for DAN, JAN and CORAL at every
``place_dis``, with _DIS_CHUNK_ROWS shrunk to 4 on both sides so that
several sub-batches and an all-padded trailing one occur; and JAN with
the tsn baseline refused at build time, as by the JAX step (CPU,
float32).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu import losses as jax_losses
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train import step as jax_step
from ta3n_tpu_torch import losses
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.train import create_train_state, make_train_step
from ta3n_tpu_torch.train import step as port_step

# tests/test_torch_port_train.py's loss tolerance; gradients of the
# kernel sums add a little more rounding, ~1e-6 absolute at these sizes
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


def _rows(seed, n, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


def _masks(n, valid_s, valid_t):
    ms, mt = np.zeros(n, np.float32), np.zeros(n, np.float32)
    ms[:valid_s] = mt[:valid_t] = 1.0
    return ms, mt


# name -> (JAX function, port function, takes masks); each gets
# (source, target) or ([source, source2], [target, target2]) for JAN
CASES = {
    "mmd_rbf_v2": lambda L: (lambda s, t, ms=None, mt=None: L.mmd_rbf(
        s, t, 2.0, 5, None, 2, ms, mt)),
    "mmd_rbf_v1": lambda L: (lambda s, t, ms=None, mt=None: L.mmd_rbf(
        s, t, 2.0, 5, None, 1)),
    "mmd_rbf_fix_sigma": lambda L: (lambda s, t, ms=None, mt=None:
                                    L.mmd_rbf(s, t, 2.0, 3, 4.0, 2, ms, mt)),
    "jan": lambda L: (lambda s, t, ms=None, mt=None: L.JAN(
        [s, s[:, :5] * 2.0], [t, t[:, :5] * 2.0], (2.0, 2.0), (2, 5),
        (None, None), 2, ms, mt)),
    "coral": lambda L: (lambda s, t, ms=None, mt=None: L.CORAL(s, t, ms,
                                                               mt)),
    "mmd_linear": lambda L: (lambda s, t, ms=None, mt=None:
                             L.mmd_linear(s, t)),
    "adaptive_weight": lambda L: (lambda s, t, ms=None, mt=None:
                                  L.loss_adaptive_weight(
                                      (s * t).sum(), s - t)),
}
# the functions that take row masks, with and without; the others without
MASKED = ("mmd_rbf_v2", "mmd_rbf_fix_sigma", "jan", "coral")


@pytest.mark.parametrize("name,masked", [(n, False) for n in sorted(CASES)]
                         + [(n, True) for n in MASKED])
def test_losses_and_gradients_match_jax(name, masked):
    """Value and the gradients with respect to both inputs; masked: 7 of
    9 source and 5 of 9 target rows valid, the padded rows far out (they
    must take no part)."""
    s, t = _rows(0, 9, 12), _rows(1, 9, 12, 1.3) + 0.4
    ms, mt = _masks(9, 7, 5) if masked else (None, None)
    if masked:
        s[~ms.astype(bool)] = 50.0
        t[~mt.astype(bool)] = -50.0
    jfn, fn = CASES[name](jax_losses), CASES[name](losses)
    jm = () if ms is None else (jnp.asarray(ms), jnp.asarray(mt))
    pm = () if ms is None else (torch.from_numpy(ms), torch.from_numpy(mt))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: jfn(a, b, *jm), argnums=(0, 1)))(jnp.asarray(s),
                                                      jnp.asarray(t))
    ts, tt = (torch.from_numpy(a).requires_grad_() for a in (s, t))
    got = fn(ts, tt, *pm)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    for g, jg, label in ((ts.grad, jgrads[0], "d/dsource"),
                         (tt.grad, jgrads[1], "d/dtarget")):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=label,
                                   **GRAD_TOL)
    if masked:  # the padded rows get no gradient
        assert not ts.grad[~torch.from_numpy(ms).bool()].any()


def test_degenerate_masks_give_finite_losses_and_gradients():
    """tests/test_losses.py:175-210 on the port: at most one valid row
    gives a finite loss (the bandwidth floored to 1), all-padded slices
    exactly 0, identical valid rows a finite loss, finite gradients; the
    masks come in pairs."""
    s = torch.from_numpy(_rows(0, 4, 8))
    t = torch.from_numpy(_rows(1, 4, 8))
    one, zero = torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(4)
    assert torch.isfinite(losses.mmd_rbf(s, t, mask_source=one,
                                         mask_target=zero))
    assert losses.mmd_rbf(s, t, mask_source=zero,
                          mask_target=zero).item() == 0.0
    assert losses.JAN([s, s], [t, t], mask_source=zero,
                      mask_target=zero).item() == 0.0
    ones = torch.ones(4)
    same = torch.ones(4, 8)
    assert torch.isfinite(losses.mmd_rbf(same, same, mask_source=ones,
                                         mask_target=ones))
    sg = s.clone().requires_grad_()
    losses.mmd_rbf(sg, t, mask_source=one, mask_target=zero).backward()
    assert torch.isfinite(sg.grad).all()
    assert losses.CORAL(s, t, zero, zero).item() == 0.0
    with pytest.raises(ValueError, match="both or neither"):
        losses.gaussian_kernel(s, t, mask_source=one)
    with pytest.raises(ValueError, match="ver=2"):
        losses.mmd_rbf(s, t, ver=1, mask_source=ones, mask_target=ones)


def test_gaussian_kernel_near_duplicate_rows_float64():
    """tests/test_losses.py:213-235 on the port's function: rows of large
    norm a tiny distance apart, where the GEMM expansion |x|^2+|y|^2-2xy
    loses ~1e-3 relative accuracy in float32; the port's direct
    difference holds the float64 value to 1e-5."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(1, 64)).astype(np.float32) * 3.0
    s = (base + 1e-3 * rng.normal(size=(6, 64))).astype(np.float32)
    t = (base + 1e-3 * rng.normal(size=(6, 64))).astype(np.float32)
    tot = np.concatenate([s, t]).astype(np.float64)
    l2 = ((tot[:, None, :] - tot[None, :, :]) ** 2).sum(-1)
    bw = l2.sum() / (len(tot) ** 2 - len(tot)) / (2.0 ** (5 // 2))
    k = sum(np.exp(-l2 / (bw * 2.0 ** i)) for i in range(5))
    want = np.mean(k[:6, :6] + k[6:, 6:] - k[:6, 6:] - k[6:, :6])
    got = losses.mmd_rbf(torch.from_numpy(s), torch.from_numpy(t), ver=2)
    assert got.item() == pytest.approx(want, rel=1e-5)
    # the expansion, for the record, is off by far more here
    x = torch.from_numpy(np.concatenate([s, t]))
    sq = (x * x).sum(1)
    expanded = (sq[:, None] + sq[None, :] - 2 * x @ x.T).numpy()
    assert np.abs(expanded - l2).max() > 100 * np.abs(
        losses.losses._pairwise_sq_dist(x).numpy() - l2).max()


def test_rand_select_batch_draws_rows_without_replacement():
    x = torch.arange(30.0).reshape(10, 3)
    idx, rows = losses.rand_select_batch(torch.Generator().manual_seed(3),
                                         x, 4)
    assert len(set(idx.tolist())) == 4 and torch.equal(rows, x[idx])
    again = losses.rand_select_batch(torch.Generator().manual_seed(3), x, 4)
    assert torch.equal(again[0], idx)


# _discrepancy_loss: feature tuples of the video baseline (video logits,
# video feature, shared layers) and of the frame baseline (frame logits,
# shared layers); 11 source and 10 target videos, n_pair 10: sub-batches
# of 4 give rows 0-3, 4-7, 8-9, and the target's 7 valid rows leave the
# last one without a valid target row
B_S, B_T, N_PAIR, S, C, H, D = 11, 10, 10, 3, 4, 6, 5
PLACES = ["".join(p) for p in itertools.product("YN", repeat=3)]


def _feats(baseline, add_fc, seed):
    rng = np.random.default_rng(seed)
    out = []
    for b in (B_S, B_T):
        shapes = ([(b, C), (b, H)] if baseline == "video"
                  else [(b, S, C)]) + [(b, S, D)] * add_fc
        out.append([(rng.normal(size=sh) * 0.7).astype(np.float32)
                    for sh in shapes])
    return out


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(jax_step, "_DIS_CHUNK_ROWS", 4)
    monkeypatch.setattr(port_step, "_DIS_CHUNK_ROWS", 4)


@pytest.mark.parametrize("baseline,add_fc", [("video", 1), ("video", 2),
                                             ("frame", 1)])
@pytest.mark.parametrize("dis", ["DAN", "JAN", "CORAL"])
def test_discrepancy_loss_matches_jax(small_chunks, dis, baseline, add_fc):
    """Every place_dis of the layers (the last layer's flag repeated for
    a second shared layer): the loss and its gradient with respect to
    every feature, padded rows in both streams."""
    fs, ft = _feats(baseline, add_fc, seed=add_fc)
    ms, mt = np.ones(B_S, np.float32), np.zeros(B_T, np.float32)
    ms[-2:] = 0.0
    mt[:7] = 1.0
    places = PLACES if dis != "JAN" else ["YYN"]  # JAN ignores place_dis
    das = [dict(use_target="uSv", dis_DA=dis,
                place_dis=tuple(p) + (p[-1],) * (add_fc - 1))
           for p in places]

    @jax.jit
    def jax_losses_and_grads(fs, ft):  # one compile for every place_dis
        return [jax.value_and_grad(
            lambda fs, ft, da=da: jax_step._discrepancy_loss(
                fs, ft, JaxDAConfig(**da), add_fc, N_PAIR, jnp.asarray(ms),
                jnp.asarray(mt)), argnums=(0, 1))(fs, ft) for da in das]

    refs = jax_losses_and_grads([jnp.asarray(a) for a in fs],
                                [jnp.asarray(a) for a in ft])
    for da, (want, jgrads) in zip(das, refs):
        tfs = [torch.from_numpy(a).requires_grad_() for a in fs]
        tft = [torch.from_numpy(a).requires_grad_() for a in ft]
        got = port_step._discrepancy_loss(
            tfs, tft, DAConfig(**da), add_fc, N_PAIR, torch.from_numpy(ms),
            torch.from_numpy(mt))
        label = f"{dis} {baseline} add_fc={add_fc} {da['place_dis']}"
        np.testing.assert_allclose(got.item(), float(want), err_msg=label,
                                   **LOSS_TOL)
        if not got.requires_grad:
            assert float(want) == 0.0, label
            continue
        got.backward()
        for side, ts, jg in (("source", tfs, jgrads[0]),
                             ("target", tft, jgrads[1])):
            for i, (t, g) in enumerate(zip(ts, jg)):
                grad = np.zeros_like(t.detach().numpy()) if t.grad is None \
                    else t.grad.numpy()
                np.testing.assert_allclose(
                    grad, np.asarray(g), err_msg=f"{label} {side} feat[{i}]",
                    **GRAD_TOL)


def test_jan_with_tsn_is_refused_at_build_time():
    """tsn exposes only the shared layers, which JAN ignores: both steps
    refuse the configuration when they are built."""
    fields = dict(num_class=3, baseline_type="tsn",
                  frame_aggregation="avgpool", use_attn="none",
                  feature_dim=8, fc_dim=4, dropout_i=0.0, dropout_v=0.0)
    da = dict(use_target="uSv", dis_DA="JAN")
    with pytest.raises(ValueError, match="incompatible with baseline_type"):
        jax_make_train_step(JaxVideoModel(JaxModelConfig(**fields)),
                            JaxDAConfig(**da), JaxTrainConfig())
    state = create_train_state(ModelConfig(**fields), TrainConfig(),
                               device="cpu")
    with pytest.raises(ValueError, match="incompatible with baseline_type"):
        make_train_step(state.model, DAConfig(**da), TrainConfig())
    # without a target stream no discrepancy runs, and tsn is fine
    make_train_step(state.model, DAConfig(use_target="none", dis_DA="JAN"),
                    TrainConfig())
