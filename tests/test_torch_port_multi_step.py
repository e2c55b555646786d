"""PyTorch port, K optimizer steps per call (`ta3n_tpu_torch/train/step.py::
make_multi_train_step`) on the CPU, mirroring tests/test_multi_step.py.

The port's K = 3 call equals 3 single device-store steps of the port
bitwise (dropout 0.5, one generator advancing through both), and the JAX
package's ``make_multi_train_step`` at K = 3 on the same stacked index
batches and converted weights at dropout 0: the stacked metrics within
LOSS_RTOL = 2e-4 relative and the parameters after the call within
PARAM_TOL = rtol 1e-3, atol 2e-5 (the tolerances of
test_torch_port_device_step.py).  The stacked indices are checked once,
before any step runs: an out-of-range row anywhere in the stack raises
and leaves the model as it was.
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
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import \
    make_multi_train_step as jax_make_multi_train_step
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.ops import gather_gemm
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_multi_train_step, make_train_step)
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress

MODEL = dict(num_class=4, baseline_type="video", frame_aggregation="trn-m",
             train_segments=4, val_segments=4, feature_dim=32, fc_dim=16,
             use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
PAIR = dict(num_source=20, num_target=14, num_val=4, num_class=4,
            feature_dim=32)
B_S, B_T, K = 8, 6, 3


def _stacked(stores, cls):
    """K index-batch pairs (the third of each stream padded), stacked."""
    ls = cls(stores[0], batch_size=B_S, num_segments=4, seed=1)
    lt = cls(stores[1], batch_size=B_T, num_segments=4, seed=2)
    pairs = list(zip(ls.index_epoch(), lt.index_epoch()))[:K]
    assert len(pairs) == K
    return [np.stack(x) for x in zip(*(bs for bs, _ in pairs))], \
        [np.stack(x) for x in zip(*(bt for _, bt in pairs))]


def _schedule():
    """The DANN beta and lr of steps 0..K-1 of a 20-step run."""
    ps = [progress(i, 0, 20) for i in range(K)]
    return [effective_beta(BETA, p) for p in ps], \
        [LR0] + [dann_lr(LR0, p) for p in ps[:-1]]


def _port_state(params=None, dropout=0.0):
    cfg = ModelConfig(**{**MODEL, "dropout_i": dropout,
                         "dropout_v": dropout})
    state = create_train_state(cfg, TrainConfig(lr=LR0),
                               torch.Generator().manual_seed(0), "cpu")
    if params is not None:
        state.model.load_state_dict(state_dict_from_jax_params(params))
    return state


def test_multi_step_matches_single_steps_bitwise():
    """K = 3 steps in one call == 3 single device-store steps, bitwise:
    metrics, parameters, momentum and the generator's state after."""
    stores = make_domain_pair(**PAIR)
    dev = [s.to_device("cpu") for s in stores[:2]]
    (idx_s, ys, ms), (idx_t, yt, mt) = _stacked(stores, TSNLoader)
    betas, lrs = _schedule()
    runs = []
    for multi in (False, True):
        state = _port_state(dropout=0.5)
        gen = torch.Generator().manual_seed(3)
        if multi:
            step = make_multi_train_step(state.model, DAConfig(**DA),
                                         TrainConfig(lr=LR0))
            state, m = step(state, dev[0], idx_s, ys, ms, dev[1], idx_t, yt,
                            mt, StepScalars(betas, [0.0] * K, [0.0] * K,
                                            [GAMMA] * K, lrs), gen)
        else:
            step = make_train_step(state.model, DAConfig(**DA),
                                   TrainConfig(lr=LR0),
                                   gather_on_device=True)
            per = []
            for j in range(K):
                state, mj = step(state, dev[0], idx_s[j], ys[j], ms[j],
                                 dev[1], idx_t[j], yt[j], mt[j],
                                 StepScalars(betas[j], 0.0, 0.0, GAMMA,
                                             lrs[j]), gen)
                per.append(mj)
            m = {k: torch.stack([x[k] for x in per]) for k in per[0]}
        runs.append((state, m, gen.get_state()))
    (s1, m1, g1), (s2, m2, g2) = runs
    assert s1.step == s2.step == K
    assert sorted(m1) == sorted(m2)
    for key in m1:
        assert m2[key].shape == (K,) and torch.equal(m1[key], m2[key]), key
    for a, b in zip(s1.model.state_dict().values(),
                    s2.model.state_dict().values()):
        assert torch.equal(a, b)
    for p1, p2 in zip(s1.model.parameters(), s2.model.parameters()):
        b1 = s1.optimizer.state[p1].get("momentum_buffer")
        b2 = s2.optimizer.state[p2].get("momentum_buffer")
        assert (b1 is None) == (b2 is None)
        assert b1 is None or torch.equal(b1, b2)
    assert torch.equal(g1, g2)


def test_multi_step_matches_jax():
    """The port's K = 3 call against the JAX ``make_multi_train_step`` at
    K = 3, from the same converted weights on each package's stores and
    index batches (bitwise equal), dropout 0."""
    jmodel = JaxVideoModel(JaxModelConfig(**MODEL))
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, 4))
    init = jax_create_train_state(jmodel, jax.random.PRNGKey(0), B_S, B_T,
                                  jtc)
    params = _redraw(jax.tree_util.tree_map(np.asarray, init.params),
                     np.random.default_rng(2))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, {}, tx.init(jparams),
                           jnp.asarray(0, jnp.int32))
    jstores = jax_domain_pair(**PAIR)
    (jis, jys, jms), (jit, jyt, jmt) = _stacked(jstores, JaxTSNLoader)
    betas, lrs = _schedule()
    jsc = JaxStepScalars(np.asarray(betas, np.float32),
                         np.zeros(K, np.float32), np.zeros(K, np.float32),
                         np.full(K, GAMMA, np.float32),
                         np.asarray(lrs, np.float32))
    jstep = jax_make_multi_train_step(jmodel, JaxDAConfig(**DA), jtc)
    jstate, want = jstep(jstate, jnp.asarray(jstores[0].features), jis, jys,
                         jms, jnp.asarray(jstores[1].features), jit, jyt,
                         jmt, jsc, jax.random.PRNGKey(0))

    stores = make_domain_pair(**PAIR)
    (idx_s, ys, ms), (idx_t, yt, mt) = _stacked(stores, TSNLoader)
    np.testing.assert_array_equal(idx_s, jis)
    np.testing.assert_array_equal(idx_t, jit)
    # the third batch of each stream is padded
    assert ms[2].tolist() == [1.0] * 4 + [0.0] * 4
    assert mt[2].tolist() == [1.0] * 2 + [0.0] * 4
    state = _port_state(params)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    gather_gemm.launches = 0
    step = make_multi_train_step(state.model, DAConfig(**DA),
                                 TrainConfig(lr=LR0))
    state, got = step(state, stores[0].to_device("cpu"), idx_s, ys, ms,
                      stores[1].to_device("cpu"), idx_t, yt, mt,
                      StepScalars(betas, [0.0] * K, [0.0] * K, [GAMMA] * K,
                                  lrs), None)
    assert gather_gemm.launches == 0  # the CPU takes the plain version
    assert state.step == int(jstate.step) == K
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].shape == (K,)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    want_params = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    now = state.model.state_dict()
    assert not torch.equal(now["fc_feature_shared_source.weight"],
                           start["fc_feature_shared_source.weight"])
    for name in want_params:
        np.testing.assert_allclose(now[name].numpy(),
                                   want_params[name].numpy(), err_msg=name,
                                   **PARAM_TOL)


@pytest.mark.parametrize("where", ["source, last step", "target, 2nd step",
                                   "negative"])
def test_stacked_index_check_raises_before_any_step(where):
    stores = make_domain_pair(**PAIR)
    dev = [s.to_device("cpu") for s in stores[:2]]
    (idx_s, ys, ms), (idx_t, yt, mt) = _stacked(stores, TSNLoader)
    if where == "source, last step":
        idx_s[K - 1, B_S - 1, 3] = dev[0].shape[0]
    elif where == "target, 2nd step":
        idx_t[1, 0, 0] = dev[1].shape[0] + 5
    else:
        idx_s[0, 2, 1] = -1
    state = _port_state(dropout=0.5)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_multi_train_step(state.model, DAConfig(**DA),
                                 TrainConfig(lr=LR0))
    sc = StepScalars([(0.5, 0.5, 0.5)] * K, [0.0] * K, [0.0] * K,
                     [GAMMA] * K, [LR0] * K)
    with pytest.raises(IndexError, match="row indices"):
        step(state, dev[0], idx_s, ys, ms, dev[1], idx_t, yt, mt, sc, None)
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="one value of each field"):
        step(state, dev[0], idx_s, ys, ms, dev[1], idx_t, yt, mt,
             sc._replace(lr=[LR0] * (K - 1)), None)
