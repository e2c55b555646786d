"""PyTorch port, the device-resident data path: the train step with
``gather_on_device=True`` and the validation steps, held against the JAX
package's from the same converted weights, on stores and index batches
made by each package's own loader from the same seed (CPU, float32,
dropout 0).  On the CPU the port's steps take the plain versions of their
kernels (K3, and K1/K2 of the TRN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import (BETA, DA, GAMMA, LOSS_RTOL, LR0,
                                   PARAM_TOL, _redraw)
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data import TSNLoader as JaxTSNLoader
from ta3n_tpu.data.synthetic import make_domain_pair as jax_domain_pair
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu.train import make_eval_step as jax_make_eval_step
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import make_multi_eval_step as jax_multi_eval
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_eval_step, make_multi_eval_step,
                                  make_train_step)
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress

MODEL = dict(num_class=5, baseline_type="video", frame_aggregation="trn-m",
             train_segments=5, val_segments=5, feature_dim=256, fc_dim=32,
             use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
B_S, B_T, B_V = 8, 6, 4
PAIR = dict(num_source=16, num_target=10, num_val=11, num_class=5,
            feature_dim=256)
EVAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _loaders(stores, cls):
    """Source, target and val loaders as the Trainer makes them ('test'
    sampling): 16 source videos in 2 batches of 8, 10 target videos in a
    batch of 6 and a padded one of 4, 11 val videos in batches of 4."""
    src, tgt, val = stores
    return (cls(src, batch_size=B_S, num_segments=5, seed=1),
            cls(tgt, batch_size=B_T, num_segments=5, seed=2),
            cls(val, batch_size=B_V, num_segments=5, shuffle=False))


def _weights():
    jmodel = JaxVideoModel(JaxModelConfig(**MODEL))
    init = jax_create_train_state(jmodel, jax.random.PRNGKey(0), B_S, B_T,
                                  JaxTrainConfig(lr=LR0))
    return jmodel, _redraw(jax.tree_util.tree_map(np.asarray, init.params),
                           np.random.default_rng(1))


def _port_model(params):
    state = create_train_state(ModelConfig(**MODEL), TrainConfig(lr=LR0),
                               device="cpu")
    state.model.load_state_dict(state_dict_from_jax_params(params))
    return state


def test_device_store_train_steps_match_jax():
    """4 steps (2 epochs of 2 batch pairs, the second target batch
    padded) under the DANN lr and beta schedules: metrics within the
    tolerance of test_torch_port_train.py at every step, parameters after
    the last one."""
    jmodel, params = _weights()
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, B_V))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, {}, tx.init(jparams),
                           jnp.asarray(0, jnp.int32))
    jstep = jax_make_train_step(jmodel, JaxDAConfig(**DA), jtc,
                                gather_on_device=True)
    jstores = jax_domain_pair(**PAIR)
    js, jt, _ = _loaders(jstores, JaxTSNLoader)
    jdev = [jnp.asarray(np.ascontiguousarray(s.features))
            for s in jstores[:2]]

    state = _port_model(params)
    step = make_train_step(state.model, DAConfig(**DA), TrainConfig(lr=LR0),
                           gather_on_device=True)
    stores = make_domain_pair(**PAIR)
    ps, pt, _ = _loaders(stores, TSNLoader)
    dev = [s.to_device("cpu") for s in stores[:2]]

    gather_gemm.launches = 0
    i = 0
    for _ in range(2):
        for (bs, bt), (js_b, jt_b) in zip(zip(ps.index_epoch(),
                                              pt.index_epoch()),
                                          zip(js.index_epoch(),
                                              jt.index_epoch())):
            np.testing.assert_array_equal(bs.abs_indices, js_b.abs_indices)
            p = progress(i, 0, 20)
            beta, lr = effective_beta(BETA, p), dann_lr(LR0, p)
            jstate, want = jstep(
                jstate, jdev[0], *js_b, jdev[1], *jt_b,
                JaxStepScalars(np.asarray(beta, np.float32), np.float32(0),
                               np.float32(0), np.float32(GAMMA),
                               np.float32(lr)), jax.random.PRNGKey(0))
            state, got = step(state, dev[0], *bs, dev[1], *bt,
                              StepScalars(beta, 0.0, 0.0, GAMMA, lr), None)
            assert sorted(got) == sorted(want)
            for key in got:
                np.testing.assert_allclose(float(got[key]), float(want[key]),
                                           rtol=LOSS_RTOL, err_msg=key)
            i += 1
    assert i == state.step == 4
    assert bt.mask.tolist() == [1.0] * 4 + [0.0] * 2  # the padded batch
    assert gather_gemm.launches == 0  # the CPU takes the plain version
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    start = state_dict_from_jax_params(params)
    assert not torch.equal(got["fc_feature_shared_source.weight"],
                           start["fc_feature_shared_source.weight"])
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_eval_steps_match_jax(weighted):
    """make_eval_step on host features and on the store, and
    make_multi_eval_step over the whole val epoch (the last batch padded),
    against the JAX steps: loss, logits and feat within f32 tolerance,
    top1, top5 and n equal."""
    cw = (np.linspace(0.5, 1.5, MODEL["num_class"]).astype(np.float32)
          if weighted else None)
    jmodel, params = _weights()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstores = jax_domain_pair(**PAIR)
    jval = _loaders(jstores, JaxTSNLoader)[2]
    jstore = jnp.asarray(np.ascontiguousarray(jstores[2].features))
    jcw = None if cw is None else jnp.asarray(cw)
    jev, jev_d = (jax_make_eval_step(jmodel, jcw, gather_on_device=g)
                  for g in (False, True))

    model = _port_model(params).model
    stores = make_domain_pair(**PAIR)
    val = _loaders(stores, TSNLoader)[2]
    store = stores[2].to_device("cpu")
    ev, ev_d = (make_eval_step(model, cw, gather_on_device=g)
                for g in (False, True))

    for (bh, bi), (jbh, jbi) in zip(zip(val.epoch(), val.index_epoch()),
                                    zip(jval.epoch(), jval.index_epoch())):
        want = jev(jparams, {}, *jbh)
        want_d = jev_d(jparams, {}, jstore, *jbi)
        for got in (ev(*bh), ev_d(store, *bi)):
            assert sorted(got) == sorted(want)
            for key in ("loss", "logits", "feat"):
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(want[key]),
                                           err_msg=key, **EVAL_TOL)
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(want_d[key]),
                                           err_msg=key, **EVAL_TOL)
            for key in ("top1", "top5", "n"):
                assert float(got[key]) == float(want[key]) == \
                    float(want_d[key])

    stacked = [np.stack(a) for a in zip(*val.index_epoch())]
    jstacked = [np.stack(a) for a in zip(*jval.index_epoch())]
    assert stacked[0].shape == (3, B_V, 5)
    want = jax_multi_eval(jmodel, jcw)(jparams, {}, jstore, *jstacked)
    got = make_multi_eval_step(model, cw)(store, *stacked)
    assert sorted(got) == sorted(want) == ["loss_sum", "n", "top1", "top5"]
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-5)
    for key in ("top1", "top5", "n"):
        assert float(got[key]) == float(want[key])
    assert float(got["n"]) == PAIR["num_val"]


def test_eval_then_train_in_one_process():
    """The eval steps run under inference mode; a train step after them
    on the same model and stores must still train: nothing cached under
    inference mode may be saved for backward.  The caches of the plain
    TRN are cleared first, so that the eval step is the one to fill
    them."""
    trn_fused._subset_index.cache_clear()
    state = _port_model(_weights()[1])
    stores = make_domain_pair(**PAIR)
    ls, lt, lv = _loaders(stores, TSNLoader)
    dev = [s.to_device("cpu") for s in stores]
    batch = next(iter(lv.index_epoch()))
    make_eval_step(state.model, gather_on_device=True)(dev[2], *batch)
    make_eval_step(state.model)(next(iter(lv.epoch())).features,
                                *batch[1:])
    make_multi_eval_step(state.model)(dev[2], *[a[None] for a in batch])
    sc = StepScalars((0.5, 0.5, 0.5), 0.0, 0.0, GAMMA, LR0)
    step = make_train_step(state.model, DAConfig(**DA), TrainConfig(lr=LR0),
                           gather_on_device=True)
    before = state.model.fc_feature_shared_source.weight.detach().clone()
    state, metrics = step(state, dev[0], *next(iter(ls.index_epoch())),
                          dev[1], *next(iter(lt.index_epoch())), sc, None)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, state.model.fc_feature_shared_source
                           .weight)
    host = make_train_step(state.model, DAConfig(**DA), TrainConfig(lr=LR0))
    state, metrics = host(state, *next(iter(ls.epoch())),
                          *next(iter(lt.epoch())), sc, None)
    assert np.isfinite(float(metrics["loss"]))


def test_empty_target_batch_and_bad_indices():
    """A source-only step (an empty target index batch) runs; an index
    outside the store is refused on the host before anything runs."""
    state = _port_model(_weights()[1])
    stores = make_domain_pair(**PAIR)
    dev = [s.to_device("cpu") for s in stores]
    bs = next(iter(_loaders(stores, TSNLoader)[0].index_epoch()))
    step = make_train_step(state.model, DAConfig(**DA), TrainConfig(lr=LR0),
                           gather_on_device=True)
    sc = StepScalars((0.5, 0.5, 0.5), 0.0, 0.0, GAMMA, LR0)
    empty = (np.zeros((0, 5), np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.float32))
    state, metrics = step(state, dev[0], *bs, dev[1], *empty, sc, None)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    bad = bs.abs_indices.copy()
    bad[0, 0] = dev[0].shape[0]
    with pytest.raises(IndexError):
        step(state, dev[0], bad, *bs[1:], dev[1], *empty, sc, None)
    assert state.step == 1
