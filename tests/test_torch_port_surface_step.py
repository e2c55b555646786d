"""PyTorch port, the train step over the model surface beyond the
flagship: for each configuration of tests/test_torch_port_surface_model.py
(the comparison rows, trn, add_fc 3 and softmax outputs), 4 steps of the
port's host-feature step and 4 of its device-store step against the JAX
package's steps from the same converted weights, with a padded video in
every batch: every metric, every parameter after the steps (those that no
loss reaches left exactly where they were, as the JAX step leaves them),
the BN running stats, and AutoDIAL's alpha bitwise at weight decay 1e-4
(CPU, float32, dropout 0).  Also the MCD configuration error and the
padded videos' place in the BN statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_surface_model import (B_S, B_T, CONFIGS, jax_weights,
                                           model_fields)
from test_torch_port_train import LOSS_RTOL, PARAM_TOL
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data import TSNLoader as JaxTSNLoader
from ta3n_tpu.data.synthetic import make_domain_pair as jax_domain_pair
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_train_step)
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress

N_STEPS = 4
LR0, GAMMA, MU, BETA = 0.03, 0.01, 0.5, (-1.0, -1.0, -1.0)
WEIGHT_DECAY = 1e-4    # above 0: a decayed alpha would show
STEP_CONFIGS = sorted(n for n in CONFIGS if n != "frame_general")
PAIR = dict(num_source=12, num_target=9, num_class=5, feature_dim=24)


def _scalars(i):
    """DANN beta and lr at step i of a 20-step run, MCD's mu."""
    p = progress(i, 0, 20)
    beta, lr = effective_beta(BETA, p), dann_lr(LR0, p)
    return (JaxStepScalars(np.asarray(beta, np.float32), np.float32(MU),
                           np.float32(0), np.float32(GAMMA),
                           np.float32(lr)),
            StepScalars(beta, MU, 0.0, GAMMA, lr))


def _host_batches():
    """N_STEPS host-feature batches, the last video of each stream
    padded (the loader's zero rows and mask 0)."""
    out = []
    for i in range(N_STEPS):
        rng = np.random.default_rng(10 + i)
        xs = rng.normal(size=(B_S, 5, 24)).astype(np.float32)
        xt = rng.normal(size=(B_T, 5, 24)).astype(np.float32)
        ys = rng.integers(0, 5, B_S).astype(np.int32)
        yt = rng.integers(0, 5, B_T).astype(np.int32)
        ms, mt = np.ones(B_S, np.float32), np.ones(B_T, np.float32)
        ms[-1] = mt[-1] = 0.0
        xs[-1] = xt[-1] = 0.0
        out.append((xs, ys, ms, xt, yt, mt))
    return out


def _store_batches(make_pair, loader):
    """N_STEPS index batches from each package's loader over stores of 12
    source and 9 target videos: batches of 6 and 5, so each epoch's
    second batch is padded (1 source, 1 target video)."""
    src, tgt, _ = make_pair(**PAIR, num_val=2)
    ls = loader(src, batch_size=B_S, num_segments=5, seed=1)
    lt = loader(tgt, batch_size=B_T, num_segments=5, seed=2)
    out = []
    while len(out) < N_STEPS:
        out += list(zip(ls.index_epoch(), lt.index_epoch()))
    return (src, tgt), out[:N_STEPS]


def _run_both(name, gather_on_device):
    fields = model_fields(name)
    da = CONFIGS[name][1]
    jmodel, params, stats = jax_weights(fields, seed=1)
    jtc = JaxTrainConfig(lr=LR0, weight_decay=WEIGHT_DECAY,
                         batch_size=(B_S, B_T, B_S))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                           stats),
                           tx.init(jparams), jnp.asarray(0, jnp.int32))
    jstep = jax_make_train_step(jmodel, JaxDAConfig(**da), jtc,
                                gather_on_device=gather_on_device)
    tc = TrainConfig(lr=LR0, weight_decay=WEIGHT_DECAY)
    state = create_train_state(ModelConfig(**fields), tc, device="cpu")
    state.model.load_state_dict(state_dict_from_jax_params(params, stats))
    step = make_train_step(state.model, DAConfig(**da), tc,
                           gather_on_device=gather_on_device)
    if gather_on_device:
        jstores, jbatches = _store_batches(jax_domain_pair, JaxTSNLoader)
        jdev = [jnp.asarray(np.ascontiguousarray(s.features))
                for s in jstores]
        stores, batches = _store_batches(make_domain_pair, TSNLoader)
        dev = [s.to_device("cpu") for s in stores]
        assert batches[1][1].mask.tolist() == [1.0] * 4 + [0.0]
        jargs = [(jdev[0], *bs, jdev[1], *bt) for bs, bt in jbatches]
        args = [(dev[0], *bs, dev[1], *bt) for bs, bt in batches]
        for (bs, _), (jbs, _) in zip(batches, jbatches):
            np.testing.assert_array_equal(bs.abs_indices, jbs.abs_indices)
    else:
        jargs = args = _host_batches()
    for name_ in ("launches", "train_launches", "bwd_launches"):
        setattr(trn_fused, name_, 0)
    gather_gemm.launches = 0
    history = []
    for i in range(N_STEPS):
        jsc, sc = _scalars(i)
        jstate, want = jstep(jstate, *jargs[i], jsc, jax.random.PRNGKey(0))
        state, got = step(state, *args[i], sc, None)
        history.append((got, want))
    # the CPU path runs the plain versions: no kernel launched
    assert (trn_fused.launches, trn_fused.train_launches,
            trn_fused.bwd_launches, gather_gemm.launches) == (0, 0, 0, 0)
    assert state.step == N_STEPS
    return (state, history, state_dict_from_jax_params(params, stats),
            state_dict_from_jax_params(
                jax.tree_util.tree_map(np.asarray, jstate.params),
                jax.tree_util.tree_map(np.asarray, jstate.batch_stats)))


def _expected_metrics(da):
    keys = {"loss_c", "loss", "top1", "top5", "n"}
    use_tgt = da.get("use_target", "none") != "none"
    if da.get("adv_DA", "none") != "none" and use_tgt:
        keys.add("loss_a")
    if da.get("add_loss_DA", "none") != "none" and use_tgt:
        keys.add("loss_e")
    if da.get("ens_DA", "none") == "MCD" and use_tgt:
        keys.add("loss_s")
    return keys


@pytest.mark.parametrize("gather_on_device", [False, True],
                         ids=["host_features", "device_store"])
@pytest.mark.parametrize("name", STEP_CONFIGS)
def test_steps_match_jax(name, gather_on_device):
    state, history, start, want = _run_both(name, gather_on_device)
    da = CONFIGS[name][1]
    keys = _expected_metrics(da)
    if name == "ta2n":
        keys.discard("loss_e")  # attentive entropy needs attention
    for i, (got, ref) in enumerate(history):
        assert set(got) == set(ref) == keys, (i, sorted(got))
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    got = state.model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        if key.endswith("num_batches_tracked"):
            continue  # the JAX BN does not count its batches
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, **PARAM_TOL)
        # what the JAX step leaves exactly as it was (no loss reaches it,
        # so no weight decay either), the port's leaves so too
        assert torch.equal(got[key], start[key]) == \
            torch.equal(want[key], start[key]), key
    if "alpha" in want:  # AutoDIAL: exactly where the JAX step left it
        assert torch.equal(got["alpha"], want["alpha"])
        assert float(got["alpha"]) == 0.75
        assert state.model.alpha.grad is None
    unmoved = sorted(k for k in want if torch.equal(want[k], start[k])
                     and not k.endswith("num_batches_tracked"))
    # the frame classifier feeds only the frame baselines; the second
    # classifier trains only with a target stream
    assert {"fc_classifier_source.weight",
            "fc_classifier_source.bias"} <= set(unmoved)
    if "use_bn" in CONFIGS[name][0]:
        n_fwd = 2 if "ens_DA" in CONFIGS[name][0] else 1
        assert int(got["bn_shared_S.num_batches_tracked"]) == \
            N_STEPS * n_fwd


def test_mcd_needs_the_model_side_classifier():
    """DAConfig.ens_DA='MCD' on a model without the second classifier is
    refused, as by the JAX step; without a target stream MCD is off and
    the second classifier gets no gradient."""
    fields = model_fields("ta2n")
    state = create_train_state(ModelConfig(**fields), TrainConfig(),
                               device="cpu")
    with pytest.raises(ValueError, match="requires ModelConfig.ens_DA"):
        make_train_step(state.model,
                        DAConfig(**{**CONFIGS["mcd"][1]}), TrainConfig())
    state = create_train_state(ModelConfig(**model_fields("mcd")),
                               TrainConfig(), device="cpu")
    step = make_train_step(state.model,
                           DAConfig(use_target="none", ens_DA="MCD"),
                           TrainConfig())
    state, metrics = step(state, *_host_batches()[0],
                          _scalars(0)[1], None)
    assert "loss_s" not in metrics
    assert state.model.fc_classifier_video_source_2.weight.grad is None


def test_padded_videos_leave_the_bn_statistics_alone():
    """Under AdaBN a padded video counts in neither BN's statistics nor in
    n: a batch with padded videos whatever their features gives the step
    that the batch without them gives."""
    fields = model_fields("adabn")
    _, params, stats = jax_weights(fields, seed=2)
    xs, ys, ms, xt, yt, mt = _host_batches()[0]
    runs = []
    for padded in (False, True):
        state = create_train_state(ModelConfig(**fields), TrainConfig(
            lr=LR0), device="cpu")
        state.model.load_state_dict(state_dict_from_jax_params(params,
                                                               stats))
        step = make_train_step(state.model, DAConfig(**CONFIGS["adabn"][1]),
                               TrainConfig(lr=LR0))
        if padded:
            batch = (xs, ys, ms, xt, yt, mt)
            batch[0][-1] = batch[3][-1] = 7.0  # whatever the features
        else:
            batch = (xs[:-1], ys[:-1], ms[:-1], xt[:-1], yt[:-1], mt[:-1])
        _, metrics = step(state, *batch, _scalars(0)[1], None)
        runs.append((metrics, state.model.state_dict()))
    (m0, p0), (m1, p1) = runs
    for key in m0:
        np.testing.assert_allclose(float(m1[key]), float(m0[key]),
                                   rtol=1e-5, err_msg=key)
    for key in p0:
        np.testing.assert_allclose(p1[key].numpy(), p0[key].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
