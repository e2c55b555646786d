"""PyTorch port, tensor parallelism over a (data x model) grid
(`ta3n_tpu_torch/parallel/make_mesh_2d`, `parallel/tensor.py`): four
ranks, spawned processes in a gloo group as a 2 x 2 grid
(tests/test_torch_port_grid_worker.py), run the flagship's train step from
host features and from a device store (with the eval steps), K = 2
device-store steps a call from stacked index batches, and AdaBN, with the
tensor-parallel threshold lowered to 16 so that the small model's Linears
shard.  Each is held to the port's one-process step and to the JAX
package's step over ``make_mesh_2d(jax.devices()[:4], model_parallel=2)``
(tests/test_sharding.py:246-345) from the same numpy weights, at 1e-5;
the ranks of a model group hold bitwise equal replicated parameters and
their weight slices concatenate to the one-process weights.  The sharded
set is JAX's ``P(None, "model")`` leaves under the converter's names, at
the lowered threshold and, at the default one and the flagship's widths,
the first shared FC alone.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_parallel import (B_S, B_T, BASE, FLAGSHIP_DA, LR0,
                                      N_STEPS, _host_batch, _index_batch,
                                      _scalars)
from test_torch_port_surface_model import _redraw, _uniform
from test_torch_port_grid_worker import run_cases
import ta3n_tpu.train.step as jax_step_mod
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from ta3n_tpu.parallel import replicated_sharding
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu.train import make_eval_step as jax_make_eval_step
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import make_multi_train_step as jax_multi_step
from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.train import step as port_step_mod
from ta3n_tpu_torch.train.step import tp_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_port_grid_worker.py")
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD, M = 4, 2          # a 2 x 2 grid: ranks (0, 1) and (2, 3) a model group
TP_MIN = 16
K = 2
# name -> (model fields beyond BASE, kind); every case against JAX
CASES = {
    "flagship_host": ({}, "host"),
    "flagship_store": ({}, "store"),
    "stacked": ({}, "stacked"),
    "adabn": (dict(use_bn="AdaBN"), "host"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spawn(spec, tmp, world=WORLD):
    """``world`` worker ranks in a gloo group running ``spec``, and a
    function that waits for them and returns each rank's results."""
    spec_path = str(tmp / "spec.pt")
    torch.save(spec, spec_path)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, spec_path, str(tmp / f"rank{r}.pt"),
         str(r), str(world), str(tmp / "init")], env=env)
        for r in range(world)]

    def results():
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert codes == [0] * world
        return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return results


def jax_weights(fields, seed):
    """(JAX model, params, batch_stats) for the model fields, as
    test_torch_port_surface_model.jax_weights draws them, from the
    parameters' shapes alone (no init to compile)."""
    jmodel = JaxVideoModel(JaxModelConfig(**fields))
    shapes = jax.eval_shape(lambda k: jax_create_train_state(
        jmodel, k, 2, 2, JaxTrainConfig(batch_size=(2, 2, 2))),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = _redraw(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), shapes.params), rng)
    stats = {name: {"mean": _uniform(rng, s["mean"].shape, 0.5),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape)
                    .astype(np.float32)}
             for name, s in shapes.batch_stats.items()}
    return jmodel, params, stats


def _stacked_batches():
    steps = [_index_batch(40 + i, 60) for i in range(K)]
    return tuple(np.stack([s[j] for s in steps]) for j in range(6))


def _spec():
    rng = np.random.default_rng(0)
    store = rng.normal(size=(60, 24)).astype(np.float32)
    cases, weights = {}, {}
    for i, (name, (fields, kind)) in enumerate(CASES.items()):
        model = {**BASE, **fields}
        weights[name] = jmodel, params, stats = jax_weights(model, seed=i)
        case = dict(model=model, da=dict(FLAGSHIP_DA), kind=kind,
                    weights=state_dict_from_jax_params(params, stats),
                    scalars=[_scalars(j) for j in range(N_STEPS)],
                    train=dict(lr=LR0))
        if kind == "host":
            case["batches"] = [_host_batch(10 + j) for j in range(N_STEPS)]
        elif kind == "store":
            case["store"] = store
            case["batches"] = [_index_batch(10 + j, len(store))
                               for j in range(N_STEPS)]
            val = [_index_batch(20 + j, len(store)) for j in range(2)]
            case["val"] = tuple(np.stack([v[j] for v in val])
                                for j in (0, 1, 2))
        else:
            case.update(runner="stacked", store=store,
                        stacked=_stacked_batches(),
                        scalars=case["scalars"][:K])
        cases[name] = case
    return {"tp_min_size": TP_MIN, "grids": {("model", M): cases}}, weights


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases' spec, their one-process runs, every rank's results and
    the JAX mesh step's, the last two made while the ranks run."""
    tmp = tmp_path_factory.mktemp("grid")
    spec, weights = _spec()
    ranks = spawn(spec, tmp)
    cases = spec["grids"][("model", M)]
    one = run_cases({"cases": cases})
    threshold = jax_step_mod._TP_MIN_SIZE
    jax_step_mod._TP_MIN_SIZE = TP_MIN
    try:
        jax_runs = {name: _jax_run(case, weights[name])
                    for name, case in cases.items()}
    finally:
        jax_step_mod._TP_MIN_SIZE = threshold
    return cases, one, [r[("model", M)] for r in ranks()], jax_runs


def _sharded(case, monkeypatch) -> set:
    """The state_dict keys of the case's planned weights at the ranks'
    threshold."""
    monkeypatch.setattr(port_step_mod, "_TP_MIN_SIZE", TP_MIN)
    model = VideoModel(ModelConfig(**case["model"]))
    return {f"{n}.weight" for n in tp_plan(model, M)}


def _whole(ranks, name, sharded):
    """Model group (0, 1)'s parameters, each planned weight's slices
    concatenated in rank order."""
    p0, p1 = (ranks[r][name]["params"] for r in (0, 1))
    return {k: np.concatenate([p0[k], p1[k]]) if k in sharded else p0[k]
            for k in p0}


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]),
                                   err_msg=f"{what}: {key}", **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grid_matches_one_process(runs, name, monkeypatch):
    """Each case's parameters (the model groups' slices concatenated) and
    BN statistics after its steps and every step's metrics on the 2 x 2
    grid against one process; for the store case the eval step's and the
    K-batch eval's metrics too."""
    cases, one, ranks, _ = runs
    got, want = ranks[0][name], one[name]
    assert got["steps"] == want["steps"]
    _close(_whole(ranks, name, _sharded(cases[name], monkeypatch)),
           want["params"], "params")
    for g, w in zip(got["metrics"], want["metrics"]):
        _close(g, w, "metrics")
    for key in [k for k in want if k.startswith(("eval_", "multi_"))]:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grid_ranks_agree(runs, name, monkeypatch):
    """Within a model group the replicated parameters are bitwise equal
    and the planned weights are two different halves; across the data
    axis the ranks of one model index hold bitwise equal slices; every
    rank's metrics are equal."""
    cases, one, ranks, _ = runs
    sharded = _sharded(cases[name], monkeypatch)
    assert "fc_feature_shared_source.weight" in sharded
    p = [ranks[r][name]["params"] for r in range(WORLD)]
    for key in p[0]:
        if key in sharded:
            assert p[0][key].shape[0] * M == \
                one[name]["params"][key].shape[0], key
            assert not np.array_equal(p[0][key], p[1][key]), key
        else:
            np.testing.assert_array_equal(p[0][key], p[1][key], err_msg=key)
        np.testing.assert_array_equal(p[0][key], p[2][key], err_msg=key)
        np.testing.assert_array_equal(p[1][key], p[3][key], err_msg=key)
    for r in range(1, WORLD):
        for a, b in zip(ranks[0][name]["metrics"], ranks[r][name]["metrics"]):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _jax_scalars(sc):
    beta, mu, alpha, gamma, lr = sc
    return JaxStepScalars(np.asarray(beta, np.float32), np.float32(mu),
                          np.float32(alpha), np.float32(gamma),
                          np.float32(lr))


def _jax_run(case, weights):
    """The JAX step over a (2 data x 2 model) mesh of 4 CPU devices on the
    case's batches (the caller lowers its threshold as the ranks'):
    (params and batch_stats as the port's state_dict, every step's
    metrics, the eval metrics)."""
    mesh = jax_make_mesh_2d(jax.devices()[:WORLD], model_parallel=M)
    jmodel, params, stats = weights
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, B_S))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.device_put(JaxTrainState(
        jparams, jax.tree_util.tree_map(jnp.asarray, stats),
        tx.init(jparams), jnp.asarray(0, jnp.int32)),
        replicated_sharding(mesh))
    da = JaxDAConfig(**case["da"])
    key = jax.random.PRNGKey(0)
    metrics, extra = [], {}
    if case["kind"] == "stacked":
        step = jax_multi_step(jmodel, da, jtc, mesh=mesh)
        dev = jnp.asarray(case["store"])
        i_s, y_s, m_s, i_t, y_t, m_t = case["stacked"]
        sc = [_jax_scalars(s) for s in case["scalars"]]
        jstate, m = step(jstate, dev, i_s, y_s, m_s, dev, i_t, y_t, m_t,
                         JaxStepScalars(*(np.stack(f) for f in zip(*sc))),
                         key)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    else:
        store = case["kind"] == "store"
        step = jax_make_train_step(jmodel, da, jtc, gather_on_device=store,
                                   mesh=mesh)
        for i, batch in enumerate(case["batches"]):
            if store:
                dev = jnp.asarray(case["store"])
                xs, ys, ms, xt, yt, mt = batch
                batch = (dev, xs, ys, ms, dev, xt, yt, mt)
            jstate, m = step(jstate, *batch, _jax_scalars(case["scalars"][i]),
                             key)
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        if store:
            ev = jax_make_eval_step(jmodel, gather_on_device=True, mesh=mesh)
            idx, y, mask = case["val"]
            got = ev(jstate.params, jstate.batch_stats,
                     jnp.asarray(case["store"]), idx[0], y[0], mask[0])
            extra = {f"eval_{k}": np.asarray(got[k])
                     for k in ("loss", "top1", "n")}
    host = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                               jstate.batch_stats))
    return state_dict_from_jax_params(*host), metrics, extra


@pytest.mark.parametrize("name", list(CASES))
def test_grid_matches_jax_2d_mesh(runs, name, monkeypatch):
    """The port's 2 x 2 grid against the JAX package's (data x model)
    mesh step from the same weights on the same batches: parameters (the
    slices concatenated), BN statistics and metrics."""
    cases, _, ranks, jax_runs = runs
    want_params, want_metrics, want_eval = jax_runs[name]
    got = _whole(ranks, name, _sharded(cases[name], monkeypatch))
    want_params = {k: v.numpy() for k, v in want_params.items()
                   if not k.endswith("num_batches_tracked")}
    _close({k: got[k] for k in want_params}, want_params, "params")
    for g, w in zip(ranks[0][name]["metrics"], want_metrics):
        _close({k: g[k] for k in w}, w, "metrics")
    for key, v in want_eval.items():
        np.testing.assert_allclose(ranks[0][name][key], v, err_msg=key,
                                   **TOL)


def _jax_sharded(fields, min_size, monkeypatch):
    """The port names of the JAX leaves that ``_tp_param_constrainer``
    shards ``P(None, "model")`` over a 2 x 2 mesh, read from the compiled
    constraint's output shardings on abstract parameters: each such leaf
    marked with ones, the tree converted (`state_dict_from_jax_params`),
    the all-ones weights named."""
    from jax.sharding import PartitionSpec as P
    monkeypatch.setattr(jax_step_mod, "_TP_MIN_SIZE", min_size)
    jmodel = JaxVideoModel(JaxModelConfig(**fields))
    shapes = jax.eval_shape(lambda k: jax_create_train_state(
        jmodel, k, 2, 2, JaxTrainConfig(batch_size=(2, 2, 2))),
        jax.random.PRNGKey(0))
    mesh = jax_make_mesh_2d(jax.devices()[:WORLD], model_parallel=M)
    constrain = jax_step_mod._tp_param_constrainer(mesh)
    out = jax.jit(constrain).lower(shapes.params).compile().output_shardings
    leaves = jax.tree_util.tree_leaves(shapes.params)
    marks = [np.full(x.shape, float(s.spec == P(None, "model")), np.float32)
             for x, s in zip(leaves, jax.tree_util.tree_leaves(out))]
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes.params), marks)
    stats = jax.tree_util.tree_map(lambda x: np.ones(x.shape, np.float32),
                                   shapes.batch_stats)
    converted = state_dict_from_jax_params(params, stats)
    return sorted(k[:-len(".weight")] for k, v in converted.items()
                  if k.endswith(".weight") and v.dim() == 2
                  and bool((v == 1).all()))


@pytest.mark.parametrize("fields,min_size", [
    ({}, TP_MIN), (dict(use_bn="AdaBN"), TP_MIN),
    (dict(use_attn="general", use_attn_frame="general", share_params="N"),
     TP_MIN),
    (dict(feature_dim=2048, fc_dim=512, num_class=12), None),
], ids=["flagship", "adabn", "general_share_n", "flagship_width"])
def test_sharded_set_matches_jax(fields, min_size, monkeypatch):
    """tp_plan's Linears are the JAX rule's sharded kernels under the
    converter's names; at the default threshold and the flagship's widths
    (5 x 2048, fc 512, 12 classes) exactly the first shared FC."""
    fields = {**BASE, **fields}
    if min_size is not None:
        monkeypatch.setattr(port_step_mod, "_TP_MIN_SIZE", min_size)
    want = _jax_sharded(fields, min_size or jax_step_mod._TP_MIN_SIZE,
                        monkeypatch)
    model = VideoModel(ModelConfig(**fields))
    assert sorted(tp_plan(model, M)) == want
    if min_size is None:
        assert want == ["fc_feature_shared_source"]
