"""PyTorch port, the train and eval steps over the surface that PR 8 adds:
for each configuration of tests/test_torch_port_aggregation.py (DAN, JAN
and CORAL, RNN and temconv aggregation, the frame and tsn baselines), 2
steps of the port's host-feature step and 2 of its device-store step
against the JAX package's step from the same converted weights, on the
same videos (the device-store step gathers them from stores; the two
host-feature steps get the same rows), with a padded video in each
stream: every metric (loss_d with the discrepancy losses) and every
parameter and BN statistic after the steps.  Then the eval step, the
multi-batch eval step and the infer step of the frame and tsn baselines
against the JAX eval steps and eval CLI arithmetic (CPU,
float32, dropout 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_aggregation import (B_S, B_T, CONFIGS, jax_weights,
                                         model_fields, port_model)
from test_torch_port_train import LOSS_RTOL, PARAM_TOL
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import make_eval_step as jax_make_eval_step
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import make_multi_eval_step as jax_multi_eval
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_eval_step, make_infer_step,
                                  make_multi_eval_step, make_train_step)
from ta3n_tpu_torch.train.step import device_gather

N_STEPS = 2
LR, ALPHA, GAMMA = 0.03, 0.5, 0.01
BETAS = ((0.75, 0.5, 0.25), (0.5, 0.75, 1.0))
PAIR = dict(num_source=12, num_target=9, num_class=5, feature_dim=24)


@pytest.fixture(scope="module")
def stores():
    """Stores of 12 source, 9 target and 7 val videos, uploaded to the
    CPU 'device'; N_STEPS index batches of 6 + 5 videos, the second with a
    padded video in each stream."""
    src, tgt, val = make_domain_pair(**PAIR, num_val=7)
    ls = TSNLoader(src, batch_size=B_S, num_segments=5, seed=1)
    lt = TSNLoader(tgt, batch_size=B_T, num_segments=5, seed=2)
    batches = list(zip(ls.index_epoch(), lt.index_epoch()))[:N_STEPS]
    assert batches[1][1].mask.tolist() == [1.0] * 4 + [0.0]
    return (src, tgt, val), [s.to_device("cpu") for s in (src, tgt, val)], \
        batches


def _features(store, b):
    """The rows a device-store step gathers, as a host-feature batch:
    (features, labels, mask), padded videos zero."""
    x = device_gather(store, torch.from_numpy(b.abs_indices)).numpy()
    return x * b.mask[:, None, None], b.labels, b.mask


def _run(name, dev, batches):
    fields = model_fields(name)
    da = CONFIGS[name][1]
    jmodel, params, stats = jax_weights(fields, seed=1)
    jtc = JaxTrainConfig(lr=LR, batch_size=(B_S, B_T, B_S))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                           stats),
                           tx.init(jparams), jnp.asarray(0, jnp.int32))
    jstep = jax_make_train_step(jmodel, JaxDAConfig(**da), jtc)
    tc = TrainConfig(lr=LR)
    runs = {}
    for gather in (False, True):
        state = create_train_state(ModelConfig(**fields), tc, device="cpu")
        state.model.load_state_dict(state_dict_from_jax_params(params,
                                                               stats))
        runs[gather] = [state, make_train_step(
            state.model, DAConfig(**da), tc, gather_on_device=gather), []]
    want = []
    for i, (bs, bt) in enumerate(batches):
        hs, ht = _features(dev[0], bs), _features(dev[1], bt)
        jsc = JaxStepScalars(np.asarray(BETAS[i], np.float32),
                             np.float32(0.5), np.float32(ALPHA),
                             np.float32(GAMMA), np.float32(LR))
        sc = StepScalars(BETAS[i], 0.5, ALPHA, GAMMA, LR)
        jstate, m = jstep(jstate, *hs, *ht, jsc, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in m.items()})
        for gather, run in runs.items():
            args = ((dev[0], bs.abs_indices, bs.labels, bs.mask, dev[1],
                     bt.abs_indices, bt.labels, bt.mask) if gather
                    else (*hs, *ht))
            run[0], got = run[1](run[0], *args, sc, None)
            run[2].append({k: float(v) for k, v in got.items()})
    want_params = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    return runs, want, want_params, state_dict_from_jax_params(params,
                                                               stats)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steps_match_jax(stores, name):
    _, dev, batches = stores
    runs, want, want_params, start = _run(name, dev, batches)
    da = CONFIGS[name][1]
    for gather, (state, _, history) in runs.items():
        label = f"{name} {'device store' if gather else 'host features'}"
        for i, (got, ref) in enumerate(zip(history, want)):
            assert set(got) == set(ref), (label, sorted(got), sorted(ref))
            for key in ref:
                np.testing.assert_allclose(got[key], ref[key],
                                           rtol=LOSS_RTOL,
                                           err_msg=f"{label} step {i} {key}")
        if "dis_DA" in da:
            assert history[-1]["loss_d"] > 0.0, label
        if CONFIGS[name][0].get("baseline_type") == "frame":
            # accuracy over frames: 5 per real video
            assert history[-1]["n"] == 5 * batches[-1][0].mask.sum(), label
        got = state.model.state_dict()
        assert sorted(got) == sorted(want_params), label
        for key, ref in want_params.items():
            if key.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[key].numpy(), ref.numpy(),
                                       err_msg=f"{label} {key}",
                                       **PARAM_TOL)
            assert torch.equal(got[key], start[key]) == \
                torch.equal(ref, start[key]), f"{label} {key}"


EVAL_CONFIGS = ("frame_ta3n", "tsn_tempooling")


@pytest.mark.parametrize("name", EVAL_CONFIGS)
def test_eval_and_infer_steps_match_jax(stores, name):
    """The val set in batches of 4 (the last padded): the host-feature
    and device-store eval steps against the JAX eval step (loss, counts,
    logits per frame for the frame baseline, feat), the multi-batch eval
    against the JAX one, and the infer step's probabilities against the
    JAX eval CLI's (frame logits averaged over the segments)."""
    (_, _, val), dev, _ = stores
    fields = model_fields(name)
    jmodel, params, stats = jax_weights(fields, seed=2)
    model = port_model(fields, params, stats)
    loader = TSNLoader(val, batch_size=4, num_segments=5, shuffle=False)
    batches = list(loader.index_epoch())
    jev = jax_make_eval_step(jmodel)
    ev, ev_store = make_eval_step(model), make_eval_step(
        model, gather_on_device=True)
    infer = make_infer_step(model, 3)
    for b in batches:
        x, y, m = _features(dev[2], b)
        want = jev(params, stats, jnp.asarray(x), jnp.asarray(y),
                   jnp.asarray(m))
        for got in (ev(x, y, m), ev_store(dev[2], b.abs_indices, y, m)):
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_allclose(
                    got[key].numpy(), np.asarray(want[key]),
                    err_msg=f"{name} {key}", rtol=1e-5, atol=1e-6)
        # the JAX eval CLI's frame average of the eval step's frame rows
        logits = np.asarray(want["logits"]).reshape(4, -1, 5).mean(axis=1)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        got = infer(x)
        np.testing.assert_allclose(got[0].numpy(), probs, rtol=1e-5,
                                   atol=1e-6)
        assert got[0].shape == (4, 5) and got[2].shape == (4, 3)
    stacked = [np.stack(a) for a in zip(*batches)]
    want = jax_multi_eval(jmodel)(params, stats, jnp.asarray(
        np.ascontiguousarray(val.features)), *map(jnp.asarray, stacked))
    got = make_multi_eval_step(model)(dev[2], *stacked)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=f"{name} {key}")
    per_video = 5 if name == "frame_ta3n" else 1
    assert float(got["n"]) == per_video * val.num_videos
    probs_all = make_infer_step(model, 3, gather_on_device=True)(
        dev[2], stacked[0], stacked[2])[0]
    for bi, b in enumerate(batches):
        np.testing.assert_allclose(
            probs_all[bi].numpy(), infer(_features(dev[2], b)[0])[0].numpy(),
            rtol=1e-6, atol=1e-7)
