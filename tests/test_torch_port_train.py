"""PyTorch port, the flagship train step: its losses, schedules and top-k
against the JAX package, and whole steps of `make_train_step` against the
JAX package's `make_train_step` from the same converted weights (CPU,
float32, dropout 0).

On the CPU the JAX step runs its TRN through the XLA path (the Pallas
kernels need a TPU), and tests/test_trn_fused.py holds that path against
the Pallas kernels in interpret mode; the port's step on CPU tensors runs
the plain versions of its TRN kernels, which test_torch_port_trn_train.py
holds against the Pallas kernels directly.
"""

import dataclasses

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
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train import schedules as jax_schedules
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import topk_correct as jax_topk_correct
from ta3n_tpu_torch import losses
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.ops import trn_fused
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_train_step)
from ta3n_tpu_torch.train import schedules
from ta3n_tpu_torch.train.step import topk_correct

# the flagship's branches at small widths
MODEL = dict(num_class=5, baseline_type="video", frame_aggregation="trn-m",
             train_segments=5, val_segments=5, feature_dim=24, fc_dim=16,
             use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
# the published DA recipe (BASELINE.md:25)
DA = dict(use_target="uSv", adv_DA="RevGrad",
          add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
B_S, B_T = 6, 5
N_STEPS = 4
LR0, GAMMA, BETA = 0.03, 0.003, (-1.0, -1.0, -1.0)  # DANN beta schedule
LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)  # tests/test_train_parity_torch.py


def _loss_inputs(seed=0, n=9, c=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=(n, c)).astype(np.float32)
    dom = rng.normal(scale=2.0, size=(n, 2)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, c).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    return logits, dom, labels, weights, mask


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(weighted, masked):
    logits, dom, labels, weights, mask = _loss_inputs()
    w = weights if weighted else None
    m = mask if masked else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    pairs = [
        (losses.weighted_cross_entropy(t(logits), t(labels).long(), t(w),
                                       t(m)),
         jax_losses.weighted_cross_entropy(logits, labels, w, m)),
        (losses.cross_entropy_soft(t(logits), t(m)),
         jax_losses.cross_entropy_soft(logits, m)),
        (losses.attentive_entropy(t(logits), t(dom), t(m)),
         jax_losses.attentive_entropy(logits, dom, m)),
        (losses.masked_mean(t(logits[:, 0]), t(m)),
         jax_losses.masked_mean(logits[:, 0], m)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


def test_loss_gradients_match_jax():
    """The weighted, masked CE and attentive entropy differentiate as the
    JAX losses do."""
    logits, dom, labels, weights, mask = _loss_inputs(seed=1)

    def jax_total(lg, dm):
        return (jax_losses.weighted_cross_entropy(lg, labels, weights, mask)
                + jax_losses.attentive_entropy(lg, dm, mask))

    want = jax.grad(jax_total, argnums=(0, 1))(logits, dom)
    tl = torch.from_numpy(logits).requires_grad_(True)
    td = torch.from_numpy(dom).requires_grad_(True)
    (losses.weighted_cross_entropy(tl, torch.from_numpy(labels).long(),
                                   torch.from_numpy(weights),
                                   torch.from_numpy(mask))
     + losses.attentive_entropy(tl, td, torch.from_numpy(mask))).backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_topk_correct_matches_jax(k):
    logits, _, labels, _, mask = _loss_inputs(seed=2, n=12, c=6)
    ours = topk_correct(torch.from_numpy(logits),
                        torch.from_numpy(labels).long(),
                        torch.from_numpy(mask), k)
    assert float(ours) == float(jax_topk_correct(logits, labels, mask, k))


@pytest.mark.parametrize("p", [0.0, 0.13, 0.5, 1.0])
def test_schedules_match_jax(p):
    assert schedules.dann_beta(p) == jax_schedules.dann_beta(p)
    assert schedules.dann_lr(0.03, p) == jax_schedules.dann_lr(0.03, p)
    beta = (-1.0, 0.75, -0.5)
    assert schedules.effective_beta(beta, p) == \
        jax_schedules.effective_beta(beta, p)
    assert schedules.progress(3, 7, 40) == jax_schedules.progress(3, 7, 40)
    for alpha in (-1.0, 0.3):
        assert schedules.alpha_schedule(alpha, 4, 10) == \
            jax_schedules.alpha_schedule(alpha, 4, 10)


def _redraw(tree, rng):
    """Every leaf at U(±1/sqrt(fan_in)), so that no output is near zero or
    uniform, and the steps move the parameters well above the tolerance
    (the normal(0.001) init would leave most heads near zero)."""
    out = {}
    for name, sub in tree.items():
        out[name] = {}
        for key, leaf in sub.items():
            fan_in = (sub[key.replace("b_", "w_")].shape[0]
                      if name == "TRN" else sub["kernel"].shape[0])
            bound = 1.0 / np.sqrt(fan_in)
            out[name][key] = rng.uniform(-bound, bound, leaf.shape) \
                .astype(np.float32)
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    d = MODEL["feature_dim"]
    xs = rng.normal(size=(B_S, 5, d)).astype(np.float32)
    xt = rng.normal(size=(B_T, 5, d)).astype(np.float32)
    ys = rng.integers(0, MODEL["num_class"], B_S).astype(np.int32)
    yt = rng.integers(0, MODEL["num_class"], B_T).astype(np.int32)
    # a padded last video in each stream (the loader's dummy rows)
    mask_s = np.ones(B_S, np.float32)
    mask_t = np.ones(B_T, np.float32)
    mask_s[-1] = mask_t[-1] = 0.0
    return xs, ys, mask_s, xt, yt, mask_t


def _scalars(i):
    """DANN beta and lr at step i of a 20-step run (main.py:350-352,
    800-802)."""
    p = schedules.progress(i, 0, 20)
    return (schedules.effective_beta(BETA, p), 0.0, 0.0, GAMMA,
            schedules.dann_lr(LR0, p))


def _port_state(jax_params, **da):
    cfg = ModelConfig(**MODEL)
    tc = TrainConfig(lr=LR0, batch_size=(B_S, B_T, B_S))
    state = create_train_state(cfg, tc, torch.Generator().manual_seed(0),
                               device="cpu")
    state.model.load_state_dict(state_dict_from_jax_params(jax_params))
    return state, make_train_step(state.model, DAConfig(**{**DA, **da}), tc)


@pytest.mark.parametrize("variant", ["flagship", "weighted_place_YNY"])
def test_train_steps_match_jax(variant):
    """N_STEPS steps on both sides from the same converted weights, under
    the DANN lr and beta schedules, with one padded video per stream.
    "weighted_place_YNY" adds class and domain weights and place_adv
    Y,N,Y, where attentive entropy falls back to the video-level logits."""
    da, cw, dw = {}, None, None
    if variant != "flagship":
        da = dict(place_adv=("Y", "N", "Y"))
        cw = np.linspace(0.5, 1.5, MODEL["num_class"]).astype(np.float32)
        dw = np.asarray([0.8, 1.25], np.float32)
    jcfg = JaxModelConfig(**MODEL)
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, B_S))
    jmodel = JaxVideoModel(jcfg)
    init = jax_create_train_state(jmodel, jax.random.PRNGKey(0), B_S, B_T,
                                  jtc)
    params = _redraw(jax.tree_util.tree_map(np.asarray, init.params),
                     np.random.default_rng(0))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, {}, tx.init(jparams),
                           jnp.asarray(0, jnp.int32))
    jstep = jax_make_train_step(
        jmodel, JaxDAConfig(**{**DA, **da}), jtc,
        None if cw is None else jnp.asarray(cw),
        None if dw is None else jnp.asarray(dw))
    state, step = _port_state(params, **da)
    if cw is not None:
        step = make_train_step(state.model, DAConfig(**{**DA, **da}),
                               TrainConfig(lr=LR0), cw, dw)

    for name in ("launches", "train_launches", "bwd_launches"):
        setattr(trn_fused, name, 0)
    for i in range(N_STEPS):
        batch = _batch(seed=10 + i)
        beta, mu, alpha, gamma, lr = _scalars(i)
        jstate, want = jstep(jstate, *batch, JaxStepScalars(
            np.asarray(beta, np.float32), np.float32(mu), np.float32(alpha),
            np.float32(gamma), np.float32(lr)), jax.random.PRNGKey(0))
        state, got = step(state, *batch,
                          StepScalars(beta, mu, alpha, gamma, lr), None)
        assert sorted(got) == sorted(want) == sorted(
            ["loss_c", "loss_a", "loss_e", "loss", "top1", "top5", "n"])
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=LOSS_RTOL, err_msg=key)
    assert state.step == N_STEPS
    # the CPU path runs the plain versions: no kernel launched
    assert (trn_fused.launches, trn_fused.train_launches,
            trn_fused.bwd_launches) == (0, 0, 0)

    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    start = state_dict_from_jax_params(params)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)
    # backprop never reaches the frame classifier in the video baseline:
    # both sides leave it exactly as it was (no weight decay either)
    for name in ("fc_classifier_source.weight", "fc_classifier_source.bias"):
        assert torch.equal(got[name], start[name])
        assert torch.equal(want[name], start[name])
    assert state.model.fc_classifier_source.weight.grad is None
    # and every other parameter moved
    moved = [n for n in want if not torch.equal(got[n], start[n])]
    assert len(moved) == len(want) - 2


def test_dropout_draws_from_the_step_generator():
    """With the published dropout 0.5 the masks come from the generator
    passed to the step: the same seed gives the same step, another seed
    another one, torch's global RNG is neither read nor advanced, and a
    step without a generator is refused."""
    cfg = ModelConfig(**{**MODEL, "dropout_i": 0.5, "dropout_v": 0.5})
    tc = TrainConfig(lr=LR0)
    batch = _batch(seed=3)
    scalars = StepScalars(*_scalars(0))

    def one_step(seed):
        state = create_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                   device="cpu")
        step = make_train_step(state.model, DAConfig(**DA), tc)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        _, metrics = step(state, *batch, scalars, gen)
        return float(metrics["loss"]), state.model.state_dict()

    rng_state = torch.random.get_rng_state()
    loss_a, params_a = one_step(1)
    loss_b, params_b = one_step(1)
    loss_c, _ = one_step(2)
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert loss_a == loss_b and loss_a != loss_c
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)
    with pytest.raises(ValueError, match="Generator"):
        one_step(None)


def test_unported_optimizer_and_quantized_training_raise():
    """An optimizer neither package has is refused by both, as is a train
    step of a model whose configuration asks for int8 inference.  (Adam
    runs: test_torch_port_optim.py.)"""
    from ta3n_tpu.train.optim import make_optimizer as jax_make_optimizer
    with pytest.raises(ValueError, match="optimizer not supported"):
        jax_make_optimizer("RMSprop")
    with pytest.raises(ValueError, match="optimizer not supported"):
        create_train_state(ModelConfig(**MODEL),
                           TrainConfig(optimizer="RMSprop"), device="cpu")
    state = create_train_state(ModelConfig(**MODEL), TrainConfig(),
                               device="cpu")

    class Quantized:  # a model whose configuration asks for int8
        cfg = dataclasses.replace(state.model.cfg, quantize="int8")

    with pytest.raises(ValueError, match="inference-only"):
        make_train_step(Quantized(), DAConfig(**DA), TrainConfig())
