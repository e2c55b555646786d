"""PyTorch port, the optimizer surface against the JAX package on the CPU,
at the float32 tolerances of test_torch_port_train.py: Adam over 4 train
steps against the JAX step's optax Adam; Adam in the Trainer over
``--pretrain_source``'s alternating classification-only and train steps,
where a parameter that one kind of step does not reach must still take
optax's zero-gradient step (``optimizer_step``'s coasting) and every
parameter shares one Adam count; and ``make_grad_accum_step`` with G = 2
against the JAX ``make_grad_accum_step`` and against one step on the big
batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import (B_S, B_T, DA, LOSS_RTOL, MODEL,
                                   PARAM_TOL, _batch, _redraw, _scalars)
from test_torch_port_trainer import _fit_and_compare, _trainers
from test_torch_port_trainer import workspace  # noqa: F401 (fixture)
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import make_grad_accum_step as jax_accum_step
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_train_step)
from ta3n_tpu_torch.train.step import make_grad_accum_step

ADAM_LR = 1e-3
# Adam divides each gradient by its own root mean square plus eps = 1e-8.
# Where a gradient and its weight-decay term cancel to near eps, the
# float32 difference of the two packages' gradients (summed in other
# orders) moves that element's update, and every later one that its
# moments carry, by a fraction of lr: up to 0.19 lr over the
# pretrain_source run below, in 1 or 2 of 65536 elements.  So parameters
# are compared with an absolute tolerance of lr / 2, and the moments,
# which have no such division, at float32 tolerance; a missing coast or
# a count out of step shows in the moments (decayed by 0.9 a step) and
# in the count.
ADAM_PARAM_TOL = dict(rtol=1e-3, atol=ADAM_LR / 2)
MOMENT_RTOL = 1e-3


def _jax_state(params, tc):
    jmodel = JaxVideoModel(JaxModelConfig(**MODEL))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jmodel, JaxTrainState(jparams, {}, _build_tx(tc).init(jparams),
                                 jnp.asarray(0, jnp.int32))


def _params(seed=0):
    jmodel = JaxVideoModel(JaxModelConfig(**MODEL))
    init = jax_create_train_state(jmodel, jax.random.PRNGKey(0), B_S, B_T,
                                  JaxTrainConfig())
    return _redraw(jax.tree_util.tree_map(np.asarray, init.params),
                   np.random.default_rng(seed))


def _port(params, tc):
    state = create_train_state(ModelConfig(**MODEL), tc, device="cpu")
    state.model.load_state_dict(state_dict_from_jax_params(params))
    return state


def _assert_params_close(state, jstate, tol=PARAM_TOL):
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def _jax_scalars(i, lr=None):
    beta, mu, alpha, gamma, lr_i = _scalars(i)
    return JaxStepScalars(np.asarray(beta, np.float32), np.float32(mu),
                          np.float32(alpha), np.float32(gamma),
                          np.float32(lr if lr is not None else lr_i))


def test_adam_steps_match_jax():
    """4 train steps with Adam (clip, weight decay, then optax's
    scale_by_adam: torch.optim.Adam after clip_grad_norm_) from the same
    converted weights, with one padded video per stream; the parameters
    that backprop never reaches keep their values and get no state
    movement on either side."""
    params = _params()
    jtc = JaxTrainConfig(optimizer="Adam", lr=ADAM_LR)
    jmodel, jstate = _jax_state(params, jtc)
    jstep = jax_make_train_step(jmodel, JaxDAConfig(**DA), jtc)
    tc = TrainConfig(optimizer="Adam", lr=ADAM_LR)
    state = _port(params, tc)
    assert isinstance(state.optimizer, torch.optim.Adam)
    step = make_train_step(state.model, DAConfig(**DA), tc)
    for i in range(4):
        batch = _batch(seed=20 + i)
        jstate, want = jstep(jstate, *batch, _jax_scalars(i, ADAM_LR),
                             jax.random.PRNGKey(0))
        beta, mu, alpha, gamma, _ = _scalars(i)
        state, got = step(state, *batch,
                          StepScalars(beta, mu, alpha, gamma, ADAM_LR), None)
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=LOSS_RTOL, err_msg=key)
    _assert_params_close(state, jstate, ADAM_PARAM_TOL)
    _assert_moments_close(state, jstate)
    start = state_dict_from_jax_params(params)
    assert torch.equal(state.model.fc_classifier_source.weight,
                       start["fc_classifier_source.weight"])
    counts = {float(s["step"]) for s in state.optimizer.state.values()}
    assert counts == {4.0}


def test_adam_with_pretrain_source_matches_jax_trainer(workspace):
    """One epoch of 3 batches with --pretrain_source and Adam: a
    classification-only step, then a train step, on every batch, against
    the JAX Trainer.  The domain heads are reached by the train steps
    only; between them they must move on their Adam moments as optax's
    chain moves them on a zero gradient, with the count shared by every
    parameter (without ``optimizer_step``'s coasting this fails)."""
    jt, pt = _trainers(workspace, False, da=dict(pretrain_source=True),
                       train=dict(optimizer="Adam", lr=ADAM_LR, epochs=1),
                       tag="_adam_pretrain")
    _fit_and_compare(jt, pt, 6, ADAM_PARAM_TOL)
    counts = {float(s["step"]) for s in pt.state.optimizer.state.values()}
    assert counts == {6.0}
    _assert_moments_close(pt.state, jt.state)


def _assert_moments_close(state, jstate):
    """Every parameter's Adam moments against optax's mu and nu, and its
    count against optax's one count."""
    adam = jstate.opt_state[-1]
    assert int(adam.count) == int(float(next(iter(
        state.optimizer.state.values()))["step"]))
    params = dict(state.model.named_parameters())
    for key, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, moment))
        for name, ref in want.items():
            got = state.optimizer.state[params[name]][key].numpy()
            scale = np.abs(ref.numpy()).max()
            np.testing.assert_allclose(got, ref.numpy(), rtol=MOMENT_RTOL,
                                       atol=MOMENT_RTOL * scale,
                                       err_msg=f"{name} {key}")


def _micro_batches(g, b, seed=0):
    rng = np.random.default_rng(seed)
    d = MODEL["feature_dim"]
    xs = rng.normal(size=(g, b, 5, d)).astype(np.float32)
    xt = rng.normal(size=(g, b, 5, d)).astype(np.float32)
    ys = rng.integers(0, MODEL["num_class"], (g, b)).astype(np.int32)
    yt = rng.integers(0, MODEL["num_class"], (g, b)).astype(np.int32)
    mask = np.ones((g, b), np.float32)
    mask[:, -1] = 0.0  # a padded video in every micro-batch
    return xs, ys, mask, xt, yt, mask


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_grad_accum_step_matches_jax(optimizer):
    """G = 2 micro-batch pairs, one update, against the JAX
    make_grad_accum_step: the [G] metrics and the parameters after two
    such updates."""
    params = _params(seed=1)
    lr = 0.03 if optimizer == "SGD" else ADAM_LR
    jtc = JaxTrainConfig(optimizer=optimizer, lr=lr)
    jmodel, jstate = _jax_state(params, jtc)
    jstep = jax_accum_step(jmodel, JaxDAConfig(**DA), jtc, accum_steps=2)
    tc = TrainConfig(optimizer=optimizer, lr=lr)
    state = _port(params, tc)
    step = make_grad_accum_step(state.model, DAConfig(**DA), tc,
                                accum_steps=2)
    for i in range(2):
        batch = _micro_batches(2, 4, seed=30 + i)
        jstate, want = jstep(jstate, *batch, _jax_scalars(i, lr),
                             jax.random.PRNGKey(0))
        beta, mu, alpha, gamma, _ = _scalars(i)
        state, got = step(state, *batch,
                          StepScalars(beta, mu, alpha, gamma, lr), None)
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].shape == (2,)
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]),
                                       rtol=LOSS_RTOL, err_msg=key)
    assert state.step == 2
    _assert_params_close(state, jstate,
                         ADAM_PARAM_TOL if optimizer == "Adam" else PARAM_TOL)


def test_grad_accum_matches_big_batch():
    """Without BN (so the statistics of a micro-batch are not the big
    batch's), G = 2 micro-batches of full videos give the update of one
    step on their concatenation, as tests/test_grad_accum.py holds for
    the JAX package."""
    params = _params(seed=2)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  place_adv=("Y", "Y", "Y"))
    tc = TrainConfig(lr=0.1)
    xs, ys, _, xt, yt, _ = _micro_batches(2, 6, seed=4)
    ones = np.ones((2, 6), np.float32)
    sc = StepScalars((0.5, 0.5, 0.5), 0.0, 0.0, 0.0, 0.1)
    accum = _port(params, tc)
    accum, m_a = make_grad_accum_step(accum.model, da, tc, accum_steps=2)(
        accum, xs, ys, ones, xt, yt, ones, sc, None)
    big = _port(params, tc)
    big, m_b = make_train_step(big.model, da, tc)(
        big, xs.reshape(12, 5, -1), ys.reshape(-1), ones.reshape(-1),
        xt.reshape(12, 5, -1), yt.reshape(-1), ones.reshape(-1), sc, None)
    for a, b in zip(accum.model.parameters(), big.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(m_a["loss"].mean()), float(m_b["loss"]),
                               rtol=2e-4)
