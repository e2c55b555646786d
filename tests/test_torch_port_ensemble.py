"""PyTorch port, ensembles (`ta3n_tpu_torch/train/ensemble.py`) on the
CPU, mirroring tests/test_ensemble.py.

Member k of a port ensemble is the port's solo run seeded k, bitwise on
the CPU (dropout 0.25, every member drawing from its own generator), from
host features and from a device store with per-member index batches, at
K steps per call as stepwise; with AdaBN too, and with an RNN (whose
recurrent net vmap runs member by member, its gradient summed in another
order: within PARAM_TOL).  The port ensemble against the JAX ensemble on
the same converted members at dropout 0: the losses within LOSS_RTOL =
2e-4 relative and the parameters within PARAM_TOL = rtol 1e-3, atol 2e-5
(the tolerances of test_torch_port_multi_step.py).  The member-batched
ops (the TRN's training forward and backward, its inference forward, the
gather + FC) under ``torch.func.vmap`` bitwise their solo calls member by
member, and against the JAX ops vmapped over the same members within the
tolerances of test_torch_port_trn_train.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_multi_step import _schedule
from test_torch_port_precision import SLICE_TOL
from test_torch_port_train import (DA, GAMMA, LOSS_RTOL, LR0, PARAM_TOL,
                                   _redraw)
from test_torch_port_trn_train import BWD_TOL, FWD_TOL, _inputs, _torch
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.ops.trn_fused import trn_multiscale_fused as jax_fused
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train.ensemble import \
    create_ensemble_state as jax_create_ensemble_state
from ta3n_tpu.train.ensemble import ensemble_keys
from ta3n_tpu.train.ensemble import make_ensemble_step as jax_ensemble_step
from ta3n_tpu.train.ensemble import stack_scalars as jax_stack_scalars
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu_torch.cli import test_models as cli_test_models
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore, TSNLoader, make_domain_pair
from ta3n_tpu_torch.data.quantized import quantize_rows
from ta3n_tpu_torch.io_utils.checkpoint import save_checkpoint
from ta3n_tpu_torch.io_utils.convert import (ensemble_from_jax_params,
                                             export_reference_state,
                                             state_dict_from_jax_params)
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.train import StepScalars, create_train_state
from ta3n_tpu_torch.train.ensemble import (create_ensemble_state,
                                           ensemble_generators,
                                           extract_member,
                                           make_ensemble_eval_step,
                                           make_ensemble_mesh,
                                           make_ensemble_multi_step,
                                           make_ensemble_step,
                                           stack_scalars)
from ta3n_tpu_torch.train.step import make_eval_step, make_train_step

SEG, FDIM = 3, 16
MODEL = dict(num_class=4, baseline_type="video", frame_aggregation="trn-m",
             train_segments=SEG, val_segments=SEG, feature_dim=FDIM,
             fc_dim=16, use_attn="TransAttn", dropout_i=0.25,
             dropout_v=0.25)
SEEDS = (0, 1, 2)
B_S, B_T = 8, 6
BETA = (0.75, 0.75, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU steps: a pool of
    every core gains them nothing and, with the other test workers'
    pools, oversubscribes the machine (the module ran ~2-4x slower beside
    two others).  The previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**fields):
    return ModelConfig(**{**MODEL, **fields})


def _tc(**fields):
    return TrainConfig(**{"lr": LR0, "batch_size": (B_S, B_T, 8),
                          **fields})


def _batches(n_steps=3, seed=0, members=None):
    """Host-feature batch pairs; with ``members`` each field stacked [N,
    ...] (one batch each)."""
    rng = np.random.default_rng(seed)

    def one(b):
        return (rng.normal(size=(b, SEG, FDIM)).astype(np.float32),
                rng.integers(0, 4, b), np.ones(b, np.float32))

    out = []
    for _ in range(n_steps):
        if members is None:
            out.append((*one(B_S), *one(B_T)))
        else:
            per = [(*one(B_S), *one(B_T)) for _ in range(members)]
            out.append(tuple(np.stack(f) for f in zip(*per)))
    return out


def _scalars(i, lrs):
    return [StepScalars(BETA, 0.0, 1.0, GAMMA, lr - 0.001 * i)
            for lr in lrs]


def _solo_runs(cfg, da, tc, seeds, feed, lrs, gather=False):
    """Each seed's solo run: ``feed(k)`` yields member k's step
    arguments (before the scalars)."""
    out = []
    for k, s in enumerate(seeds):
        st = create_train_state(cfg, tc, torch.Generator().manual_seed(s),
                                "cpu")
        step = make_train_step(st.model, da, tc, gather_on_device=gather)
        g = torch.Generator().manual_seed(s)
        metrics = []
        for i, args in enumerate(feed(k)):
            st, m = step(st, *args, _scalars(i, lrs)[k], g)
            metrics.append(m)
        out.append((st, metrics, g))
    return out


def _assert_member_is_solo(ens, k, solo, exact=True):
    named = {**dict(solo.model.named_parameters()),
             **dict(solo.model.named_buffers())}
    for name, t in named.items():
        got = ens.params.get(name, ens.buffers.get(name))[k]
        if exact:
            assert torch.equal(got, t.detach()), name
        else:
            np.testing.assert_allclose(got.numpy(), t.detach().numpy(),
                                       **PARAM_TOL, err_msg=name)


def test_members_are_solo_runs_bitwise():
    """3 members, 3 host-feature steps at dropout 0.25 and per-member lr:
    each member's parameters, BN statistics, momentum and metrics are its
    solo run's, bitwise; the step launches no kernel on the CPU."""
    cfg, da, tc = _cfg(), DAConfig(**DA), _tc()
    lrs = (0.03, 0.02, 0.01)
    batches = _batches()
    solo = _solo_runs(cfg, da, tc, SEEDS, lambda k: batches, lrs)
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    step = make_ensemble_step(ens.model, da, tc)
    gens = ensemble_generators(SEEDS, "cpu")
    trn_fused.train_launches = trn_fused.bwd_launches = 0
    for i, b in enumerate(batches):
        ens, m = step(ens, *b, stack_scalars(_scalars(i, lrs)), gens)
    assert (trn_fused.train_launches, trn_fused.bwd_launches) == (0, 0)
    assert ens.step == 3 and m["loss"].shape == (3,)
    for k, (st, metrics, g) in enumerate(solo):
        _assert_member_is_solo(ens, k, st)
        assert torch.equal(gens[k].get_state(), g.get_state())
        for key, v in metrics[-1].items():
            assert torch.equal(m[key][k], v), key
        opt = st.optimizer
        for name, p in st.model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            want = ens.opt["momentum_buffer"].get(name)
            assert (buf is None) == (want is None), name
            assert buf is None or torch.equal(want[k], buf), name


@pytest.mark.parametrize("mode", ["per_member_data", "shared_scalars"])
def test_host_feature_modes_are_solo_runs_bitwise(mode):
    """From host features: each member its own batches
    (``per_member_data``, every field [N, ...]), or one StepScalars of
    numbers for every member (``per_member_scalars=False``); either way
    member k is its solo run, bitwise."""
    cfg, da, tc = _cfg(), DAConfig(**DA), _tc()
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    gens = ensemble_generators(SEEDS, "cpu")
    if mode == "per_member_data":
        lrs = (0.03, 0.02, 0.01)
        batches = _batches(2, members=3)
        step = make_ensemble_step(ens.model, da, tc, per_member_data=True)
        for i, b in enumerate(batches):
            ens, _ = step(ens, *b, stack_scalars(_scalars(i, lrs)), gens)
        solo = _solo_runs(cfg, da, tc, SEEDS, lambda k: [
            tuple(f[k] for f in b) for b in batches], lrs)
    else:
        lrs = (0.03,) * 3
        batches = _batches(2)
        step = make_ensemble_step(ens.model, da, tc,
                                  per_member_scalars=False)
        for i, b in enumerate(batches):
            ens, _ = step(ens, *b, _scalars(i, lrs)[0], gens)
        solo = _solo_runs(cfg, da, tc, SEEDS, lambda k: batches, lrs)
    for k, (st, _, _) in enumerate(solo):
        _assert_member_is_solo(ens, k, st)


def _jax_members(jcfg, jtc, seeds):
    """A JAX ensemble whose members' parameters are redrawn at a
    trained-like scale (`_redraw`, member by member), with fresh optimizer
    state."""
    model = JaxVideoModel(jcfg)
    est = jax_create_ensemble_state(model, seeds, B_S, B_T, jtc)
    host = jax.tree_util.tree_map(np.asarray, est.params)
    members = [_redraw(jax.tree_util.tree_map(lambda l: l[k], host),
                       np.random.default_rng(10 + k))
               for k in range(len(seeds))]
    params = jax.tree_util.tree_map(lambda *ls: jnp.asarray(np.stack(ls)),
                                    *members)
    tx = _build_tx(jtc)
    return model, est._replace(params=params,
                               opt_state=jax.vmap(tx.init)(params))


def test_ensemble_matches_jax_ensemble():
    """The port ensemble and the JAX ensemble from the same converted
    members, 3 host-feature steps at dropout 0 with per-member lr: the
    losses and every member's parameters after."""
    fields = dict(MODEL, dropout_i=0.0, dropout_v=0.0)
    jcfg = JaxModelConfig(**fields)
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, 8))
    model, jstate = _jax_members(jcfg, jtc, SEEDS)
    lrs = (0.03, 0.02, 0.01)
    jstep = jax_ensemble_step(model, JaxDAConfig(**DA), jtc)
    keys = ensemble_keys(SEEDS)
    cfg, tc = ModelConfig(**fields), _tc()
    ens = ensemble_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), None, cfg, tc,
        "cpu")
    step = make_ensemble_step(ens.model, DAConfig(**DA), tc)
    gens = ensemble_generators(SEEDS, "cpu")
    # the DANN beta ramp of the multi-step comparison, per-member lr
    betas, _ = _schedule()
    for i, b in enumerate(_batches()):
        sc = [s._replace(beta=tuple(betas[i])) for s in _scalars(i, lrs)]
        jsc = jax_stack_scalars([JaxStepScalars(
            jnp.asarray(s.beta, jnp.float32), jnp.float32(s.mu),
            jnp.float32(s.alpha), jnp.float32(s.gamma), jnp.float32(s.lr))
            for s in sc])
        jstate, want = jstep(jstate, *b, jsc, keys)
        ens, got = step(ens, *b, stack_scalars(sc), gens)
        np.testing.assert_allclose(got["loss"].numpy(),
                                   np.asarray(want["loss"]), rtol=LOSS_RTOL)
    host = jax.tree_util.tree_map(np.asarray, jstate.params)
    for k in range(len(SEEDS)):
        want = state_dict_from_jax_params(
            jax.tree_util.tree_map(lambda l: l[k], host))
        for name, t in want.items():
            np.testing.assert_allclose(ens.params[name][k].numpy(),
                                       t.numpy(), **PARAM_TOL,
                                       err_msg=name)


# ---- bfloat16 compute ----

def _ramp_scalars(i, lrs):
    """Step i's per-member scalars on the DANN beta ramp (betas that are
    not bfloat16 values, so a member's GRL must scale its bfloat16
    gradient as the solo run's number does) and GAMMA (not one either)."""
    betas, _ = _schedule()
    return [s._replace(beta=tuple(betas[i])) for s in _scalars(i, lrs)]


@pytest.mark.parametrize("mode", ["host", "host_per_member", "store_f32",
                                  "store_int8_per_member"])
def test_bf16_members_are_solo_runs_bitwise(mode):
    """At compute_dtype="bfloat16", 3 members over 3 steps at dropout 0.25
    and per-member lr on the beta ramp: each member's parameters, BN
    statistics, momentum and metrics are its solo bfloat16 run's, bitwise,
    from host features (one stream, or one each) and from a device store
    (a float32 store with one stream, an int8 store with one each); the
    parameters stay float32."""
    cfg, da, tc = _cfg(compute_dtype="bfloat16"), DAConfig(**DA), _tc()
    lrs = (0.03, 0.02, 0.01)
    per_member = mode.endswith("per_member")
    if mode.startswith("host"):
        batches = _batches(3, members=3 if per_member else None)

        def feed(k):
            return ([tuple(f[k] for f in b) for b in batches] if per_member
                    else batches)
    else:
        stores = make_domain_pair(num_source=60, num_target=50, num_val=4,
                                  num_class=4, feature_dim=FDIM)
        dev = [s.to_device("cpu", "int8" if "int8" in mode else None)
               for s in stores[:2]]
        pairs = _store_feed(stores, dev)

        def feed(k):
            return [_pair_args(dev, *pairs[(i + k) % len(pairs)
                                           if per_member else i])
                    for i in range(3)]
    # the ensemble's step arguments: member k's feed(k), stacked [N, ...]
    # per member but for the stores
    calls = feed(0)
    if per_member:
        calls = [[a if j in (0, 4) and not mode.startswith("host")
                  else np.stack([feed(k)[i][j] for k in range(3)])
                  for j, a in enumerate(calls[i])] for i in range(3)]
    out = []
    for k, sd in enumerate(SEEDS):
        st = create_train_state(cfg, tc, torch.Generator().manual_seed(sd),
                                "cpu")
        step = make_train_step(st.model, da, tc,
                               gather_on_device=not mode.startswith("host"))
        g = torch.Generator().manual_seed(sd)
        for i, args in enumerate(feed(k)):
            st, m = step(st, *args, _ramp_scalars(i, lrs)[k], g)
        out.append((st, m, g))
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    step = make_ensemble_step(ens.model, da, tc,
                              gather_on_device=not mode.startswith("host"),
                              per_member_data=per_member)
    gens = ensemble_generators(SEEDS, "cpu")
    for i, args in enumerate(calls):
        ens, m = step(ens, *args, stack_scalars(_ramp_scalars(i, lrs)),
                      gens)
    assert {t.dtype for t in ens.params.values()} == {torch.float32}
    for k, (st, metrics, g) in enumerate(out):
        _assert_member_is_solo(ens, k, st)
        assert torch.equal(gens[k].get_state(), g.get_state())
        for key, v in metrics.items():
            assert torch.equal(m[key][k], v), key
        for name, p in st.model.named_parameters():
            buf = st.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                assert torch.equal(ens.opt["momentum_buffer"][name][k],
                                   buf), name


def test_bf16_eval_and_multi_step_are_member_runs():
    """At bfloat16 compute: K = 3 ensemble steps in one call over stacked
    index batches into an int8 store are 3 single ensemble steps,
    bitwise; and the ensemble eval step from the store gives each member
    its solo eval step's metrics, bitwise."""
    cfg, da, tc = _cfg(compute_dtype="bfloat16"), DAConfig(**DA), _tc()
    stores = make_domain_pair(num_source=60, num_target=50, num_val=12,
                              num_class=4, feature_dim=FDIM)
    dev = [s.to_device("cpu", "int8") for s in stores]
    pairs = _store_feed(stores, dev)[:3]
    lrs = (0.03, 0.02, 0.01)
    runs = []
    for multi in (False, True):
        ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
        gens = ensemble_generators(SEEDS, "cpu")
        if multi:
            step = make_ensemble_multi_step(ens.model, da, tc)
            per = [_pair_args(dev, *p) for p in pairs]
            stacked = [a if j in (0, 4) else np.stack([p[j] for p in per])
                       for j, a in enumerate(per[0])]
            sc = StepScalars(*(np.stack(f) for f in zip(
                *[stack_scalars(_ramp_scalars(i, lrs)) for i in range(3)])))
            ens, _ = step(ens, *stacked, sc, gens)
        else:
            step = make_ensemble_step(ens.model, da, tc,
                                      gather_on_device=True)
            for i, p in enumerate(pairs):
                ens, _ = step(ens, *_pair_args(dev, *p),
                              stack_scalars(_ramp_scalars(i, lrs)), gens)
        runs.append(ens)
    for name, t in runs[0].params.items():
        assert torch.equal(t, runs[1].params[name]), name
    lv = TSNLoader(stores[2], batch_size=12, num_segments=SEG, mode="test",
                   shuffle=False)
    b = next(iter(lv.index_epoch()))
    got = make_ensemble_eval_step(runs[1].model, gather_on_device=True)(
        runs[1], dev[2], b.abs_indices, b.labels, b.mask)
    for k in range(len(SEEDS)):
        member = extract_member(runs[1], k, tc).model
        want = make_eval_step(member, gather_on_device=True)(
            dev[2], b.abs_indices, b.labels, b.mask)
        for key in ("loss", "top1", "logits"):
            assert torch.equal(got[key][k], want[key]), key


def test_bf16_ensemble_matches_jax_ensemble():
    """The port's bfloat16 ensemble against the JAX ensemble at
    compute_dtype="bfloat16" from the same converted members, 3
    host-feature steps at dropout 0 with per-member lr on the beta ramp:
    every step's losses within SLICE_TOL of the largest, and every
    member's parameters after the first step within SLICE_TOL of the
    tensor's largest (test_torch_port_precision.py's bound for the
    bfloat16 slice: the two packages round to bfloat16 at other places)."""
    fields = dict(MODEL, dropout_i=0.0, dropout_v=0.0,
                  compute_dtype="bfloat16")
    jcfg = JaxModelConfig(**fields)
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, 8))
    model, jstate = _jax_members(jcfg, jtc, SEEDS)
    lrs = (0.03, 0.02, 0.01)
    jstep = jax_ensemble_step(model, JaxDAConfig(**DA), jtc)
    keys = ensemble_keys(SEEDS)
    cfg, tc = ModelConfig(**fields), _tc()
    ens = ensemble_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), None, cfg, tc,
        "cpu")
    step = make_ensemble_step(ens.model, DAConfig(**DA), tc)
    gens = ensemble_generators(SEEDS, "cpu")
    for i, b in enumerate(_batches()):
        sc = _ramp_scalars(i, lrs)
        jsc = jax_stack_scalars([JaxStepScalars(
            jnp.asarray(s.beta, jnp.float32), jnp.float32(s.mu),
            jnp.float32(s.alpha), jnp.float32(s.gamma), jnp.float32(s.lr))
            for s in sc])
        jstate, want = jstep(jstate, *b, jsc, keys)
        ens, got = step(ens, *b, stack_scalars(sc), gens)
        want_loss = np.asarray(want["loss"], np.float32)
        assert np.abs(got["loss"].numpy() - want_loss).max() <= \
            SLICE_TOL * np.abs(want_loss).max(), i
        if i > 0:
            continue
        host = jax.tree_util.tree_map(np.asarray, jstate.params)
        for k in range(len(SEEDS)):
            want_p = state_dict_from_jax_params(
                jax.tree_util.tree_map(lambda l: l[k], host))
            for name, t in want_p.items():
                err = (ens.params[name][k] - t).abs().max().item()
                assert err <= SLICE_TOL * max(t.abs().max().item(), 1e-6), \
                    name


def test_lr_zero_member_keeps_its_init():
    """Per-member scalars are a sweep axis: the lr = 0 member of three
    identical inits keeps its parameters bitwise, the others train and
    differ."""
    cfg, da, tc = _cfg(dropout_i=0.0, dropout_v=0.0), DAConfig(**DA), _tc()
    ens = create_ensemble_state(cfg, tc, (0, 0, 0), "cpu")
    init = {k: v.clone() for k, v in ens.params.items()}
    step = make_ensemble_step(ens.model, da, tc)
    sc = stack_scalars([StepScalars(BETA, 0.0, 1.0, GAMMA, lr)
                        for lr in (0.0, 0.1, 0.3)])
    ens, _ = step(ens, *_batches(1)[0], sc, ensemble_generators((0, 0, 0),
                                                                "cpu"))
    for name, t in ens.params.items():
        assert torch.equal(t[0], init[name][0]), name
    moved = [n for n, t in ens.params.items()
             if not torch.equal(t[1], init[n][1])]
    assert moved and any(not torch.equal(ens.params[n][1],
                                         ens.params[n][2]) for n in moved)


def _store_feed(stores, dev, n_steps=2):
    ls = TSNLoader(stores[0], batch_size=B_S, num_segments=SEG, seed=1)
    lt = TSNLoader(stores[1], batch_size=B_T, num_segments=SEG, seed=2)
    pairs = list(zip(ls.index_epoch(), lt.index_epoch()))
    assert len(pairs) >= n_steps + len(SEEDS)
    return pairs


def _pair_args(dev, bs, bt):
    return (dev[0], bs.abs_indices, bs.labels, bs.mask, dev[1],
            bt.abs_indices, bt.labels, bt.mask)


def test_per_member_data_from_a_device_store():
    """Each member gathers its own index batches from one shared store
    (per_member_data): member k is the solo device-store run on its
    batches, bitwise."""
    cfg, da, tc = _cfg(), DAConfig(**DA), _tc()
    stores = make_domain_pair(num_source=60, num_target=50, num_val=4,
                              num_class=4, feature_dim=FDIM)
    dev = [s.to_device("cpu") for s in stores[:2]]
    pairs = _store_feed(stores, dev)
    lrs = (0.03, 0.02, 0.01)

    def batch(k, i):
        return pairs[(i + k) % len(pairs)]

    solo = _solo_runs(cfg, da, tc, SEEDS, lambda k: [
        _pair_args(dev, *batch(k, i)) for i in range(2)], lrs, gather=True)
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    step = make_ensemble_step(ens.model, da, tc, gather_on_device=True,
                              per_member_data=True)
    gens = ensemble_generators(SEEDS, "cpu")
    gather_gemm.launches = 0
    for i in range(2):
        per = [_pair_args(dev, *batch(k, i)) for k in range(3)]
        args = [a if j in (0, 4) else np.stack([p[j] for p in per])
                for j, a in enumerate(per[0])]
        ens, _ = step(ens, *args, stack_scalars(_scalars(i, lrs)), gens)
    assert gather_gemm.launches == 0
    for k, (st, _, _) in enumerate(solo):
        _assert_member_is_solo(ens, k, st)


def test_multi_step_call_equals_stepwise():
    """K = 3 ensemble steps in one call over stacked index batches of the
    shared stream == 3 single ensemble steps, bitwise: parameters, buffers,
    momentum, metrics [K, N] and the generators."""
    cfg, da, tc = _cfg(), DAConfig(**DA), _tc()
    stores = make_domain_pair(num_source=60, num_target=50, num_val=4,
                              num_class=4, feature_dim=FDIM)
    dev = [s.to_device("cpu") for s in stores[:2]]
    pairs = _store_feed(stores, dev)[:3]
    lrs = (0.03, 0.02, 0.01)
    runs = []
    for multi in (False, True):
        ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
        gens = ensemble_generators(SEEDS, "cpu")
        if multi:
            step = make_ensemble_multi_step(ens.model, da, tc)
            per = [_pair_args(dev, *p) for p in pairs]
            stacked = [a if j in (0, 4) else np.stack([p[j] for p in per])
                       for j, a in enumerate(per[0])]
            sc = StepScalars(*(np.stack(f) for f in zip(
                *[stack_scalars(_scalars(i, lrs)) for i in range(3)])))
            ens, m = step(ens, *stacked, sc, gens)
        else:
            step = make_ensemble_step(ens.model, da, tc,
                                      gather_on_device=True)
            ms = []
            for i, p in enumerate(pairs):
                ens, mi = step(ens, *_pair_args(dev, *p),
                               stack_scalars(_scalars(i, lrs)), gens)
                ms.append(mi)
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((ens, m, [g.get_state() for g in gens]))
    (e1, m1, g1), (e2, m2, g2) = runs
    assert e1.step == e2.step == 3
    for key in m1:
        assert m2[key].shape == (3, 3) and torch.equal(m1[key], m2[key])
    for d1, d2 in ((e1.params, e2.params), (e1.buffers, e2.buffers),
                   (e1.opt["momentum_buffer"], e2.opt["momentum_buffer"])):
        assert sorted(d1) == sorted(d2)
        assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_extract_member_is_a_solo_state(tmp_path):
    """extract_member gives a solo TrainState whose further solo step
    equals the solo run's, and whose checkpoint the eval CLI loads and
    scores as the ensemble eval step scores the member."""
    cfg, da, tc = _cfg(), DAConfig(**DA), _tc()
    batches = _batches(3)
    lrs = (0.03, 0.02, 0.01)
    solo = _solo_runs(cfg, da, tc, SEEDS, lambda k: batches, lrs)
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    step = make_ensemble_step(ens.model, da, tc)
    gens = ensemble_generators(SEEDS, "cpu")
    for i, b in enumerate(batches[:2]):
        ens, _ = step(ens, *b, stack_scalars(_scalars(i, lrs)), gens)
    member = extract_member(ens, 1, tc)
    assert member.step == 2
    solo_step = make_train_step(member.model, da, tc)
    member, _ = solo_step(member, *batches[2], _scalars(2, lrs)[1], gens[1])
    for name, t in solo[1][0].model.state_dict().items():
        assert torch.equal(member.model.state_dict()[name], t), name

    # the Trainer's checkpoint payload, read back by the eval CLI
    stores = make_domain_pair(num_source=8, num_target=8, num_val=10,
                              num_class=4, feature_dim=FDIM)
    val = str(tmp_path / "val")
    stores[2].save(val)
    with open(os.path.join(val, "list.txt"), "w") as f:
        for r in stores[2].records():
            f.write(f"{r.path} {r.num_frames} {r.label}\n")
    (tmp_path / "class.txt").write_text("0 a\n1 b\n2 c\n3 d\n")
    ckpt = save_checkpoint(str(tmp_path / "m1"), {
        "epoch": 1, "arch": "resnet101",
        "state_dict": {f"module.{k}": v for k, v in
                       export_reference_state(member.model).items()},
        "optimizer": member.optimizer.state_dict(), "best_prec1": 0.0,
        "prec1": 0.0, "step": member.step})
    scores = str(tmp_path / "scores")
    cli_test_models.main([
        str(tmp_path / "class.txt"), "RGB", os.path.join(val, "list.txt"),
        ckpt, "--test_segments", str(SEG), "--fc_dim", "16",
        "--feature_dim", str(FDIM), "--baseline_type", "video",
        "--frame_aggregation", "trn-m", "--use_attn", "TransAttn",
        "--bS", "10", "--device", "cpu", "--save_scores", scores])
    got = np.load(scores + ".npz")["scores"]
    ens = ens._replace(step=3)
    for name, t in member.model.state_dict().items():
        src = ens.params if name in ens.params else ens.buffers
        src[name][1].copy_(t)
    lv = TSNLoader(FeatureStore.load(val), batch_size=10, num_segments=SEG,
                   mode="test", shuffle=False)
    b = next(iter(lv.index_epoch()))
    m = make_ensemble_eval_step(ens.model, gather_on_device=True)(
        ens, FeatureStore.load(val).to_device("cpu"), b.abs_indices,
        b.labels, b.mask)
    want = torch.softmax(m["logits"][1], dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name,fields,da_fields,exact", [
    ("adabn", dict(use_bn="AdaBN"), {}, True),
    ("rnn", dict(frame_aggregation="rnn", rnn_cell="LSTM", n_rnn=2,
                 n_directions=2, n_ts=2, use_attn="none"),
     dict(place_adv=("N", "Y", "Y")), False)])
def test_rnn_and_adabn_members_match_solo(name, fields, da_fields, exact):
    """AdaBN (BN statistics updated in place on the stacked buffers):
    bitwise.  A two-layer bidirectional LSTM, whose recurrent net (no
    batching rule in torch) runs under vmap as the plain recurrence
    (``models.rnn.recurrence``): within PARAM_TOL."""
    cfg, tc = _cfg(**fields), _tc()
    da = DAConfig(**{**DA, **da_fields})
    batches = _batches(2)
    lrs = (0.03, 0.02, 0.01)
    solo = _solo_runs(cfg, da, tc, SEEDS, lambda k: batches, lrs)
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    step = make_ensemble_step(ens.model, da, tc)
    gens = ensemble_generators(SEEDS, "cpu")
    for i, b in enumerate(batches):
        ens, _ = step(ens, *b, stack_scalars(_scalars(i, lrs)), gens)
    for k, (st, _, _) in enumerate(solo):
        _assert_member_is_solo(ens, k, st, exact=exact)


def test_unreached_parameter_moves_as_in_the_solo_run():
    """The video baseline never reads the frame classifier: torch.func
    gives it a zero gradient, the solo step none.  It keeps its init (no
    weight decay, no momentum buffer) as in the solo run, under SGD and
    under Adam."""
    for opt in ("SGD", "Adam"):
        cfg, da = _cfg(), DAConfig(**DA)
        tc = _tc(optimizer=opt, weight_decay=0.1)
        ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
        init = ens.params["fc_classifier_source.weight"].clone()
        step = make_ensemble_step(ens.model, da, tc)
        assert step.reached["fc_classifier_source.weight"] is False
        assert step.reached["fc_classifier_video_source.weight"] is True
        lrs = (0.03, 0.02, 0.01)
        batches = _batches(2)
        gens = ensemble_generators(SEEDS, "cpu")
        for i, b in enumerate(batches):
            ens, _ = step(ens, *b, stack_scalars(_scalars(i, lrs)), gens)
        assert torch.equal(ens.params["fc_classifier_source.weight"], init)
        solo = _solo_runs(cfg, da, tc, SEEDS[:1], lambda k: batches, lrs)
        _assert_member_is_solo(ens, 0, solo[0][0])
        if opt == "SGD":
            assert "fc_classifier_source.weight" not in \
                ens.opt["momentum_buffer"]


@pytest.mark.parametrize("case", [
    "mesh_step", "mesh_eval", "mesh_multi", "make_mesh", "bf16_state",
    "bf16_step", "generators", "scalar_shape"])
def test_error_paths(case):
    """``mesh=`` raises naming ROADMAP.md queue 1, item 9; a bfloat16
    ensemble's member-batched TRN call with a float32 weight raises
    TypeError (``bf16_state``: the kernels take one dtype) and one above
    BF16_MAX_SCALES scales raises naming the limit (``bf16_step``: the
    weight maps are a kernel parameter), on the CPU as on the card; the
    ensemble step refuses too few generators and per-member scalars of
    the wrong shape."""
    cfg, da, tc = _cfg(), DAConfig(**DA), _tc()
    ens = create_ensemble_state(cfg, tc, SEEDS, "cpu")
    err, match = NotImplementedError, "ROADMAP.md queue 1, item 9"
    if case == "mesh_step":
        call = lambda: make_ensemble_step(ens.model, da, tc, mesh=object())
    elif case == "mesh_eval":
        call = lambda: make_ensemble_eval_step(ens.model, mesh=object())
    elif case == "mesh_multi":
        call = lambda: make_ensemble_multi_step(ens.model, da, tc,
                                                mesh=object())
    elif case == "make_mesh":
        call = lambda: make_ensemble_mesh(2)
    elif case == "bf16_state":
        bf16 = create_ensemble_state(_cfg(compute_dtype="bfloat16"), tc,
                                     SEEDS, "cpu")
        bf = torch.bfloat16
        weights = [bf16.params[f"TRN.fc_fusion_scales.{i}.1.weight"]
                   for i in range(SEG - 1)]
        biases = [bf16.params[f"TRN.fc_fusion_scales.{i}.1.bias"].to(bf)
                  for i in range(SEG - 1)]
        x = torch.ones((3, 2, SEG, 16), dtype=bf)
        err, match = TypeError, "takes torch.bfloat16"
        call = lambda: trn_fused.trn_multiscale_fwd_masks_members(
            x, [weights[0].to(bf), weights[1]], biases, SEG)
    elif case == "bf16_step":
        s = trn_fused.BF16_MAX_SCALES + 2
        x = torch.ones((3, 2, s, 4), dtype=torch.bfloat16)
        err, match = ValueError, f"at most {trn_fused.BF16_MAX_SCALES} scales"
        call = lambda: trn_fused.trn_multiscale_infer_members(
            x, [torch.ones((3, 4, 4), dtype=torch.bfloat16)] * (s - 1),
            [torch.ones((3, 4), dtype=torch.bfloat16)] * (s - 1), s)
    else:
        step = make_ensemble_step(ens.model, da, tc)
        b = _batches(1)[0]
        sc = stack_scalars(_scalars(0, (0.1, 0.2, 0.3)))
        err, match = ValueError, "generators" if case == "generators" \
            else "per-member scalars"
        if case == "generators":
            call = lambda: step(ens, *b, sc, ensemble_generators((0,),
                                                                 "cpu"))
        else:
            call = lambda: step(ens, *b, sc._replace(lr=sc.lr[:2]),
                                ensemble_generators(SEEDS, "cpu"))
    with pytest.raises(err, match=match):
        call()


# ---- the member-batched ops under torch.func.vmap ----

@pytest.mark.parametrize("b,s,d,h", [(6, 5, 16, 8), (13, 4, 37, 19)])
def test_vmapped_trn_ops_equal_member_calls(b, s, d, h):
    """``vmap(grad)`` through the fused TRN over 3 members' stacked
    weights: the output and the gradients of x, weights and biases bitwise
    each member's solo autograd; the inference forward under vmap likewise;
    and both against the JAX op vmapped over the same members."""
    members = [_inputs(b, s, d, h, seed=k) for k in range(3)]
    tx = torch.stack([_torch(*m[:3])[0] for m in members])
    tw = [torch.stack([_torch(*m[:3])[1][i] for m in members])
          for i in range(s - 1)]
    tb = [torch.stack([_torch(*m[:3])[2][i] for m in members])
          for i in range(s - 1)]
    tg = torch.stack([torch.from_numpy(m[3]) for m in members])

    def loss(x, w, bi, g):
        return (trn_fused.trn_multiscale_fused(x, w, bi, s) * g).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
        tx, tw, tb, tg)
    with torch.no_grad():
        infer = torch.func.vmap(
            lambda x, w, bi: trn_fused.trn_multiscale_infer(x, w, bi, s))(
            tx, tw, tb)
    jfwd = jax.vmap(lambda x, w, bi: jax_fused(x, w, bi, s, 3, True))
    jgrad = jax.vmap(jax.grad(
        lambda x, w, bi, g: (jax_fused(x, w, bi, s, 3, True) * g).sum(),
        argnums=(0, 1, 2)))
    jx, jw, jb = (jnp.stack([jnp.asarray(m[0]) for m in members]),
                  tuple(jnp.stack([jnp.asarray(m[1][i]) for m in members])
                        for i in range(s - 1)),
                  tuple(jnp.stack([jnp.asarray(m[2][i]) for m in members])
                        for i in range(s - 1)))
    want_out = np.asarray(jfwd(jx, jw, jb))
    want_grads = jgrad(jx, jw, jb, jnp.stack([jnp.asarray(m[3])
                                              for m in members]))
    np.testing.assert_allclose(infer.numpy(), want_out, **FWD_TOL)
    for k in range(3):
        x = tx[k].clone().requires_grad_(True)
        w = [t[k].clone().requires_grad_(True) for t in tw]
        bi = [t[k].clone().requires_grad_(True) for t in tb]
        out = trn_fused.trn_multiscale_fused(x, w, bi, s)
        (out * tg[k]).sum().backward()
        assert torch.equal(infer[k], trn_fused.trn_multiscale_infer(
            tx[k], [t[k] for t in tw], [t[k] for t in tb], s))
        assert torch.equal(grads[0][k], x.grad)
        for i in range(s - 1):
            assert torch.equal(grads[1][i][k], w[i].grad)
            assert torch.equal(grads[2][i][k], bi[i].grad)
            np.testing.assert_allclose(grads[1][i][k].numpy(),
                                       np.asarray(want_grads[1][i][k]).T,
                                       **BWD_TOL)
        np.testing.assert_allclose(grads[0][k].numpy(),
                                   np.asarray(want_grads[0][k]), **BWD_TOL)


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
def test_vmapped_gathered_linear_equals_member_calls(per_member):
    """gathered_linear over 3 members' stacked weights under
    ``vmap(grad)``, from one index set or one each: z, dW and db bitwise
    each member's solo call; and gathered_gemm_members likewise."""
    rng = np.random.default_rng(0)
    store = torch.from_numpy(rng.normal(size=(50, FDIM)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 8, FDIM)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    idx = rng.integers(0, 50, (3 if per_member else 1, 12))
    scale = torch.from_numpy(rng.choice([0.0, 1.0], (3 if per_member else 1,
                                                     12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 12, 8)).astype(np.float32))
    checked = gather_gemm.row_index(idx, 50, "cpu")
    rows = gather_gemm.RowIndex(checked.rows.reshape(idx.shape),
                                checked.end)

    def loss(w, b, rows, scale, g):
        return (gather_gemm.gathered_linear([(store, rows, scale)], w, b)
                * g).sum()

    d_rows = gather_gemm.RowIndex(0 if per_member else None, None)
    gw, gb = torch.func.vmap(
        torch.func.grad(loss, argnums=(0, 1)),
        in_dims=(0, 0, d_rows, 0 if per_member else None, 0))(
        w, bias,
        rows if per_member else gather_gemm.RowIndex(rows.rows[0], rows.end),
        scale if per_member else scale[0], g)
    z, x_res = gather_gemm.gathered_gemm_members(
        store, rows if per_member else
        gather_gemm.RowIndex(rows.rows[0], rows.end), w,
        scale if per_member else scale[0])
    for k in range(3):
        j = k if per_member else 0
        wk = w[k].clone().requires_grad_(True)
        bk = bias[k].clone().requires_grad_(True)
        rk = gather_gemm.RowIndex(rows.rows[j], rows.end)
        (gather_gemm.gathered_linear([(store, rk, scale[j])], wk, bk)
         * g[k]).sum().backward()
        assert torch.equal(gw[k], wk.grad) and torch.equal(gb[k], bk.grad)
        sz, sx = gather_gemm.gathered_gemm(store, rk, w[k], scale[j])
        assert torch.equal(z[k], sz)
        assert torch.equal(x_res[k] if per_member else x_res, sx)


@pytest.mark.parametrize("b,s,d,h", [(6, 5, 16, 8), (13, 4, 37, 19)])
def test_vmapped_bf16_trn_ops_equal_member_calls(b, s, d, h):
    """The bfloat16 TRN ops over 3 members' stacked bfloat16 inputs:
    ``vmap(grad)`` through the fused TRN (its output and the gradients of
    x, weights and biases) and the inference forward under vmap, bitwise
    each member's solo call; the outputs and gradients stay bfloat16."""
    bf = torch.bfloat16
    members = [_torch(*_inputs(b, s, d, h, seed=k)[:3]) for k in range(3)]
    tx = torch.stack([m[0] for m in members]).to(bf)
    tw = [torch.stack([m[1][i] for m in members]).to(bf)
          for i in range(s - 1)]
    tb = [torch.stack([m[2][i] for m in members]).to(bf)
          for i in range(s - 1)]
    tg = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, b, s - 1, h)).astype(np.float32)).to(bf)

    def loss(x, w, bi, g):
        return (trn_fused.trn_multiscale_fused(x, w, bi, s).float()
                * g.float()).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
        tx, tw, tb, tg)
    with torch.no_grad():
        infer = torch.func.vmap(
            lambda x, w, bi: trn_fused.trn_multiscale_infer(x, w, bi, s))(
            tx, tw, tb)
    assert infer.dtype == grads[0].dtype == grads[1][0].dtype == bf
    for k in range(3):
        x = tx[k].clone().requires_grad_(True)
        w = [t[k].clone().requires_grad_(True) for t in tw]
        bi = [t[k].clone().requires_grad_(True) for t in tb]
        loss(x, w, bi, tg[k]).backward()
        assert torch.equal(infer[k], trn_fused.trn_multiscale_infer(
            tx[k], [t[k] for t in tw], [t[k] for t in tb], s))
        assert torch.equal(grads[0][k], x.grad)
        for i in range(s - 1):
            assert torch.equal(grads[1][i][k], w[i].grad)
            assert torch.equal(grads[2][i][k], bi[i].grad)


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("store_kind", ["f32", "bf16", "int8"])
def test_vmapped_bf16_gather_equals_member_calls(store_kind, per_member):
    """At bfloat16 compute (bfloat16 weights) from a float32, bfloat16 or
    int8 store, one index set or one each: gathered_linear under
    ``vmap(grad)`` (z, dW and db), gathered_gemm under vmap and
    gathered_gemm_members, bitwise each member's solo call."""
    rng = np.random.default_rng(1)
    rows_f32 = rng.normal(size=(50, FDIM)).astype(np.float32)
    if store_kind == "int8":
        q, qs = quantize_rows(rows_f32)
        store = (torch.from_numpy(q), torch.from_numpy(qs))
    else:
        store = torch.from_numpy(rows_f32).to(
            torch.bfloat16 if store_kind == "bf16" else torch.float32)
    bf = torch.bfloat16
    w = torch.from_numpy(rng.normal(size=(3, 8, FDIM)).astype(
        np.float32)).to(bf)
    bias = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32)).to(bf)
    n_sets = 3 if per_member else 1
    idx = rng.integers(0, 50, (n_sets, 12))
    scale = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], (n_sets, 12))
                             .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 12, 8)).astype(np.float32))
    checked = gather_gemm.row_index(idx, 50, "cpu")
    rows = gather_gemm.RowIndex(checked.rows.reshape(idx.shape),
                                checked.end)
    if not per_member:
        rows, scale = gather_gemm.RowIndex(rows.rows[0], rows.end), scale[0]
    dims = (gather_gemm.RowIndex(0 if per_member else None, None),
            0 if per_member else None)

    def loss(w, b, rows, scale, g):
        return (gather_gemm.gathered_linear([(store, rows, scale)], w, b)
                .float() * g).sum()

    gw, gb = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                             in_dims=(0, 0, *dims, 0))(w, bias, rows, scale,
                                                       g)
    with torch.no_grad():
        vz, vx = torch.func.vmap(
            lambda w, rows, scale: gather_gemm.gathered_gemm(
                store, rows, w, scale), in_dims=(0, *dims))(w, rows, scale)
    z, x_res = gather_gemm.gathered_gemm_members(store, rows, w, scale)
    assert z.dtype == x_res.dtype == gw.dtype == bf
    for k in range(3):
        rk = gather_gemm.RowIndex(rows.rows[k] if per_member else rows.rows,
                                  rows.end)
        sk = scale[k] if per_member else scale
        wk = w[k].clone().requires_grad_(True)
        bk = bias[k].clone().requires_grad_(True)
        loss(wk, bk, rk, sk, g[k]).backward()
        assert torch.equal(gw[k], wk.grad) and torch.equal(gb[k], bk.grad)
        sz, sx = gather_gemm.gathered_gemm(store, rk, w[k], sk)
        assert torch.equal(z[k], sz) and torch.equal(vz[k], sz)
        assert torch.equal(x_res[k] if per_member else x_res, sx)
        assert torch.equal(vx[k], sx)  # vmap expands a shared x_res


# ---- the Functions in the setup_context form, outside a transform ----

def test_fused_trn_refuses_a_second_backward():
    """The fused TRN is differentiable once: a backward that would build a
    graph (``create_graph=True``, for a second backward) raises, where the
    kernel's gradients would carry none; a plain backward still runs."""
    x, w, bi, g = _inputs(4, 5, 16, 8)
    tx, tw, tb = _torch(x, w, bi)
    tx.requires_grad_(True)
    for t in (*tw, *tb):
        t.requires_grad_(True)
    out = trn_fused.trn_multiscale_fused(tx, tw, tb, 5)
    loss = (out * torch.from_numpy(g)).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, [tx, *tw], create_graph=True)
    dx, = torch.autograd.grad(loss, [tx])
    assert torch.isfinite(dx).all()


def test_gathered_linear_second_backward_matches_autograd():
    """gathered_linear's backward (dzᵀ x_res and dz summed, torch ops on
    the saved rows) builds a graph under ``create_graph=True``: the
    gradient of a function of the first gradients equals plain autograd's
    through ``gathered_gemm_plain`` + bias in float64."""
    rng = np.random.default_rng(3)
    store = torch.from_numpy(rng.normal(size=(30, 6)))
    idx = rng.integers(0, 30, 10)
    scale = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], 10))
    w0 = torch.from_numpy(rng.normal(size=(4, 6)))
    b0 = torch.from_numpy(rng.normal(size=(4,)))
    rows = gather_gemm.row_index(idx, 30, "cpu")

    def second(linear):
        w = w0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        z = linear(w, b)
        gw, gb = torch.autograd.grad((z.tanh() ** 2).sum(), [w, b],
                                     create_graph=True)
        return torch.autograd.grad((gw ** 2).sum() + (gb ** 3).sum(),
                                   [w, b])

    got = second(lambda w, b: gather_gemm.gathered_linear(
        [(store, rows, scale)], w, b))
    want = second(lambda w, b: gather_gemm.gathered_gemm_plain(
        store, rows.rows.long(), w, scale)[0] + b)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("directions", [1, 2])
def test_recurrence_is_torch_rnn(cell, directions):
    """The plain recurrence that the ensembles run under vmap against
    torch's two-layer LSTM / GRU from a zero state, output and gradients
    of the input and every parameter within 1e-5 of their largest value
    (float32 sums in another order); and under vmap over 3 members'
    stacked parameters, member k the plain recurrence of member k within
    the same bound (batched products sum in another order)."""
    from ta3n_tpu_torch.models.rnn import recurrence
    gen = torch.Generator().manual_seed(0)
    rnn = getattr(torch.nn, cell)(12, 6, num_layers=2, batch_first=True,
                                  bidirectional=directions == 2)
    with torch.no_grad():
        for p in rnn.parameters():
            p.uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn((5, 3, 12), generator=gen)
    g = torch.randn((5, 3, 6 * directions), generator=gen)

    def run(fn):
        xd = x.clone().requires_grad_(True)
        rnn.zero_grad(set_to_none=True)
        out = fn(xd)
        (out * g).sum().backward()
        return [out.detach(), xd.grad, *(p.grad for p in rnn.parameters())]

    for got, want in zip(run(lambda t: recurrence(rnn, t)),
                         run(lambda t: rnn(t)[0])):
        assert (got - want).abs().max() <= 1e-5 * max(
            1.0, want.abs().max().item())
    wrapper = _Recurrence(rnn)
    stacked = {f"rnn.{name}": torch.stack([p.detach() * (1 + 0.1 * k)
                                           for k in range(3)])
               for name, p in rnn.named_parameters()}
    with torch.no_grad():
        batched = torch.func.vmap(lambda p: torch.func.functional_call(
            wrapper, p, (x,)))(stacked)
        for k in range(3):
            one = {n: t[k] for n, t in stacked.items()}
            want = torch.func.functional_call(wrapper, one, (x,))
            assert (batched[k] - want).abs().max() <= 1e-5 * max(
                1.0, want.abs().max().item())


class _Recurrence(torch.nn.Module):
    """``recurrence`` of the held net as a module's forward, for
    ``functional_call``."""

    def __init__(self, rnn):
        super().__init__()
        self.rnn = rnn

    def forward(self, x):
        from ta3n_tpu_torch.models.rnn import recurrence
        return recurrence(self.rnn, x)


def test_cudnn_f32_pins_tf32_off_under_a_transform():
    """Under ``torch.func.vmap`` (the ensembles' forwards, served or
    evaluated, where no step wraps the call) ``cudnn_f32`` still runs its
    module with cuDNN's TF32 off, and restores the flag after; outside a
    transform too.  The flag is read where the module runs, so a record
    of it there is what a cuDNN kernel would see."""
    from ta3n_tpu_torch.models.layers import cudnn_f32
    seen = []

    def fn(t):
        seen.append(torch.backends.cudnn.allow_tf32)
        return t * 2.0

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.ones((3, 4))
        with torch.no_grad():
            out = torch.func.vmap(lambda r: cudnn_f32(fn, r, ()))(x)
        assert torch.equal(out, 2.0 * x)
        cudnn_f32(fn, x.requires_grad_(True), ()).sum().backward()
        assert seen == [False, False, False]  # vmap, forward, backward
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
