"""PyTorch port, the member axis over ranks and the 2-D grids' entry points
on the CPU.  Four ranks, spawned processes in a gloo group
(tests/test_torch_port_grid_worker.py), run a 4-member ensemble over a
(member 2 x data 2) grid (``make_ensemble_mesh(2)``) and over a 1-D
mesh of four member shards: two steps from shared host features (with
the eval step), two from per-member index batches into a store, and a
K = 2 call from stacked index batches.  Each rank's members are held to
the one-process ensemble's, and on the 2 x 2 grid every case to the JAX
package's ensemble step over ``make_ensemble_mesh(2, jax.devices()[:4])``
(tests/test_ensemble.py:302-360), at 1e-5.  ``run_sweep(mesh=)`` with 3
members padded to 4 against one process; the grids' divisibility
refusals against JAX's; ``cli.sweep --sweep_mesh 2 --num_devices 4``
and ``cli.train --num_devices 4 --model_parallel 2`` against one
process, the tensor-parallel checkpoint resumed by one process, and an
interrupt of one rank of that grid, which writes no emergency checkpoint.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_grid import jax_weights, spawn
from test_torch_port_grid_worker import run_cases
from test_torch_port_parallel import (B_S, B_T, BASE, FLAGSHIP_DA, LR0,
                                      _host_batch, _index_batch, _scalars,
                                      _train_argv, _workers)
from test_torch_port_sweep import FDIM, SEG, _sweep_argv
from test_torch_port_sweep import _workspace as sweep_workspace
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train.ensemble import \
    create_ensemble_state as jax_create_ensemble_state
from ta3n_tpu.train.ensemble import ensemble_keys
from ta3n_tpu.train.ensemble import make_ensemble_mesh as jax_ensemble_mesh
from ta3n_tpu.train.ensemble import \
    make_ensemble_multi_step as jax_ensemble_multi
from ta3n_tpu.train.ensemble import make_ensemble_step as jax_ensemble_step
from ta3n_tpu.train.ensemble import stack_scalars as jax_stack_scalars
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu_torch.cli import sweep as cli_sweep
from ta3n_tpu_torch.cli import train as cli_train
from ta3n_tpu_torch.data import make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD, SHARDS = 4, 2
SEEDS = [0, 1, 2, 3]
LRS = [0.03, 0.01, 0.02, 0.005]
GRIDS = {("member", SHARDS): 2, ("member_1d",): 1}   # grid -> data ranks
# name -> (kind, per-member data)
CASES = {"host": ("host", False), "store_per_member": ("store", True),
         "multi": ("multi", False)}
# the cases held to JAX's member x data step: all of them
JAX_CASES = tuple(CASES)
SWEEP = dict(model=dict(BASE, feature_dim=FDIM, train_segments=SEG,
                        val_segments=SEG, num_class=3),
             da=dict(FLAGSHIP_DA),
             train=dict(lr=LR0, epochs=1, batch_size=(6, 4, 6)),
             members=[(0, 0.03, 1.0), (1, 0.03, 1.0), (0, 0.01, 1.0)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _member_scalars(i):
    beta, mu, alpha, gamma, _ = _scalars(i)
    return (beta, mu, alpha, gamma)


def _members():
    """The members' JAX params stacked [N, ...] and as the port's
    stacked state_dict."""
    drawn = [jax_weights(BASE, seed=10 + k) for k in range(len(SEEDS))]
    params = jax.tree_util.tree_map(lambda *ls: np.stack(ls),
                                    *[d[1] for d in drawn])
    sds = [state_dict_from_jax_params(d[1]) for d in drawn]
    port = {name: np.stack([sd[name].numpy() for sd in sds])
            for name in sds[0]}
    return drawn[0][0], params, port


def _cases(port_params, store):
    cases = {}
    for name, (kind, per_member) in CASES.items():
        case = dict(runner="ensemble", kind=kind, model=dict(BASE),
                    da=dict(FLAGSHIP_DA), train=dict(lr=LR0),
                    seeds=SEEDS, lrs=LRS, params=port_params,
                    per_member_data=per_member, store=store,
                    scalars=[_member_scalars(i) for i in range(2)])
        if kind == "host":
            case["batches"] = [_host_batch(50 + i) for i in range(2)]
            case["val"] = _index_batch(60, len(store))[:3]
        elif kind == "store":
            case["batches"] = [tuple(np.stack(f) for f in zip(*(
                _index_batch(70 + 10 * i + k, len(store))
                for k in range(len(SEEDS))))) for i in range(2)]
        else:
            steps = [_index_batch(90 + i, len(store)) for i in range(2)]
            case["stacked"] = tuple(np.stack([s[j] for s in steps])
                                    for j in range(6))
        cases[name] = case
    return cases


def _sweep_case(root, out):
    return dict(SWEEP, runner="sweep", root=str(root), out=str(out))


@pytest.fixture(scope="module")
def grid(tmp_path_factory, clis):
    """Every rank's results over the grids, the one-process runs, the
    JAX ensemble steps (made while the ranks and the CLIs run) and the
    cases."""
    tmp = tmp_path_factory.mktemp("members")
    root = tmp / "stores"
    sweep_workspace(root, make_domain_pair)
    store = np.random.default_rng(1).normal(size=(60, 24)) \
        .astype(np.float32)
    jmodel, jparams, port_params = _members()
    cases = _cases(port_params, store)
    spec = {"grids": {g: cases for g in GRIDS}}
    spec["grids"][("member", SHARDS)] = dict(
        cases, sweep=_sweep_case(root, tmp / "sweep_grid"))
    spec["grids"][("errors",)] = {"errors": dict(
        runner="errors", bad=3, sweep=dict(
            _sweep_case(root, tmp / "sweep_bad"),
            train=dict(SWEEP["train"], batch_size=(6, 4, 5))))}
    ranks = spawn(spec, tmp)
    one = run_cases({"cases": dict(
        cases, sweep=_sweep_case(root, tmp / "sweep_one"))})
    want = {name: _jax_run(cases[name], jmodel, jparams)
            for name in JAX_CASES}
    clis["wait"]()
    return cases, one, ranks(), want, tmp


def _jax_run(case, jmodel, jparams):
    """The JAX ensemble step over make_ensemble_mesh(2) of 4 CPU devices:
    every member's parameters as the port's names and every step's
    metrics."""
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, B_S))
    est = jax_create_ensemble_state(jmodel, SEEDS, B_S, B_T, jtc)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = est._replace(params=params,
                         opt_state=jax.vmap(_build_tx(jtc).init)(params))
    mesh = jax_ensemble_mesh(SHARDS, jax.devices()[:WORLD])
    da = JaxDAConfig(**case["da"])
    per_member = case["per_member_data"]

    def scalars(i):
        beta, mu, alpha, gamma = case["scalars"][i]
        return jax_stack_scalars([JaxStepScalars(
            jnp.asarray(beta, jnp.float32), jnp.float32(mu),
            jnp.float32(alpha), jnp.float32(gamma), jnp.float32(lr))
            for lr in LRS])

    keys = ensemble_keys(SEEDS)
    dev = jnp.asarray(case["store"])
    metrics = []
    if case["kind"] == "multi":
        multi = jax_ensemble_multi(jmodel, da, jtc, mesh=mesh)
        sc = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls),
                                    scalars(0), scalars(1))
        i_s, y_s, m_s, i_t, y_t, m_t = case["stacked"]
        state, m = multi(state, dev, i_s, y_s, m_s, dev, i_t, y_t, m_t, sc,
                         keys)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    else:
        gather = case["kind"] == "store"
        step = jax_ensemble_step(jmodel, da, jtc, gather_on_device=gather,
                                 per_member_data=per_member, mesh=mesh)
        for i, (xs, ys, ms, xt, yt, mt) in enumerate(case["batches"]):
            args = ((dev, xs, ys, ms, dev, xt, yt, mt) if gather
                    else (xs, ys, ms, xt, yt, mt))
            state, m = step(state, *args, scalars(i), keys)
            metrics.append({k: np.asarray(v) for k, v in m.items()})
    host = jax.tree_util.tree_map(np.asarray, state.params)
    sds = [state_dict_from_jax_params(jax.tree_util.tree_map(
        lambda leaf: leaf[k], host)) for k in range(len(SEEDS))]
    return ({name: np.stack([sd[name].numpy() for sd in sds])
             for name in sds[0]}, metrics)


def _rows(grid, rank):
    """The members of the padded list that ``rank`` holds."""
    shards = WORLD // GRIDS[grid]
    per = len(SEEDS) // shards
    shard = rank // GRIDS[grid]
    return slice(shard * per, (shard + 1) * per)


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_allclose(got[key], want[key],
                                   err_msg=f"{what}: {key}", **TOL)


@pytest.mark.parametrize("grid_key", list(GRIDS), ids=["2x2", "1d"])
@pytest.mark.parametrize("name", list(CASES))
def test_member_grid_matches_one_process(grid, grid_key, name):
    """Every rank's members after the case's steps, their metrics and
    (host case) their eval metrics are the one-process ensemble's members
    ``rows``: over the 2 x 2 grid each shard's two ranks split the batch,
    over the 1-D mesh each rank holds one member and communicates
    nothing."""
    _, one, ranks, _, _ = grid
    want = one[name]
    for r in range(WORLD):
        got, rows = ranks[r][grid_key][name], _rows(grid_key, r)
        assert got["steps"] == want["steps"]
        _close(got["params"], {k: v[rows] for k, v in
                               want["params"].items()}, f"rank {r}")
        for g, w in zip(got["metrics"], want["metrics"]):
            _close(g, {k: v[..., rows] if v.ndim == 2 else v[rows]
                       for k, v in w.items()}, f"rank {r} metrics")
        for key in [k for k in want if k.startswith("eval_")]:
            np.testing.assert_allclose(got[key], want[key][rows],
                                       err_msg=key, **TOL)


@pytest.mark.parametrize("name", JAX_CASES)
def test_member_grid_matches_jax_member_data_mesh(grid, name):
    """The 2 x 2 grid's members against the JAX ensemble step over
    ``make_ensemble_mesh(2, jax.devices()[:4])`` from the same members on
    the same batches: parameters and losses."""
    _, _, ranks, want, _ = grid
    want_params, want_metrics = want[name]
    key = ("member", SHARDS)
    for r in range(WORLD):
        rows = _rows(key, r)
        got = ranks[r][key][name]
        _close(got["params"], {k: v[rows] for k, v in want_params.items()},
               f"rank {r}")
        for g, w in zip(got["metrics"], want_metrics):
            loss = w["loss"]
            np.testing.assert_allclose(
                g["loss"], loss[..., rows] if loss.ndim == 2 else loss[rows],
                **TOL)


def test_sweep_over_the_member_grid_matches_one_process(grid):
    """run_sweep(mesh=make_ensemble_mesh(2)) of 3 members, padded to 4
    (a copy of member 0, dropped): rank 0's rows and the directory that it
    writes are the one-process sweep's (top-1 equal, losses and every
    member's checkpoint within 1e-5); the other ranks' rows agree."""
    _, one, ranks, _, tmp = grid
    key = ("member", SHARDS)
    got, want = ranks[0][key]["sweep"], one["sweep"]
    assert len(got["results"]) == len(want["results"]) == 3
    for a, b in zip(got["results"], want["results"]):
        assert a["top1"] == b["top1"] and a["best_top1"] == b["best_top1"]
        assert a["final_loss"] == pytest.approx(b["final_loss"], abs=1e-4)
    assert got["ensemble_top1"] == want["ensemble_top1"]
    for r in range(1, WORLD):
        assert [x["top1"] for x in ranks[r][key]["sweep"]["results"]] == \
            [x["top1"] for x in got["results"]]
    for k in range(3):
        ckpts = [torch.load(str(tmp / d / f"member_{k:02d}" /
                                "checkpoint.pth.tar"), weights_only=False)
                 for d in ("sweep_grid", "sweep_one")]
        _close({n: v.numpy() for n, v in ckpts[0]["state_dict"].items()},
               {n: v.numpy() for n, v in ckpts[1]["state_dict"].items()},
               f"member {k}")
    assert not os.path.exists(tmp / "sweep_grid" / "member_03")
    assert sorted(os.listdir(tmp / "sweep_grid")) == \
        sorted(os.listdir(tmp / "sweep_one"))


def test_grid_refusals_match_jax(grid):
    """In a group of 4 ranks: model_parallel 3 and 3 member shards refuse
    with the JAX functions' messages over 4 devices, and run_sweep refuses
    a val batch of 5 over a data axis of 2 with JAX's message."""
    _, _, ranks, _, _ = grid
    got = ranks[0][("errors",)]["errors"]
    devices = jax.devices()[:WORLD]
    with pytest.raises(ValueError) as e:
        jax_make_mesh_2d(devices, model_parallel=3)
    assert got["model_parallel"] == str(e.value)
    with pytest.raises(ValueError) as e:
        jax_ensemble_mesh(3, devices)
    assert got["member_shards"] == str(e.value)
    assert got["sweep_batch"] == ("batch size 5 not divisible by the "
                                  "mesh's data axis (2)")


# ---- the entry points: cli.sweep --sweep_mesh and cli.train ----

def _cli(*runs):
    """Each (module, argv) run as a process, all started at once, and a
    function that waits for them: (exit code, stdout, stderr) of each."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for module, argv in runs]

    def wait():
        done = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                done.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return done

    return wait


def _ok(run):
    code, out, err = run
    assert code == 0, err[-3000:]
    return out


# the train CLI's widths: the first shared FC's 1024 x 512 weight reaches
# the default tensor-parallel threshold (2^19 elements), which a spawned
# rank cannot lower; nothing else does
WIDE = {"--feature_dim": "1024", "--fc_dim": "512"}


def _wide_workspace(root):
    stores = make_domain_pair(num_source=24, num_target=18, num_val=12,
                              num_class=3, feature_dim=1024, shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    (root / "class.txt").write_text("0 a\n1 b\n2 c\n")


def _wide_argv(root, exp, *extra):
    argv = _train_argv(root, exp, *extra)
    for flag, value in WIDE.items():
        argv[argv.index(flag) + 1] = value
    return argv


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The sweep and train CLIs over 4 gloo processes and in one, all
    started at once: the workspace roots, and after ``wait()`` (the grid
    fixture's, once its own work is done) each run's (code, stdout,
    stderr) by name."""
    tmp = tmp_path_factory.mktemp("grid_cli")
    sweep_root, train_root = tmp / "sweep", tmp / "train"
    for root in (sweep_root, train_root):
        root.mkdir()
    sweep_workspace(sweep_root, make_domain_pair)
    _wide_workspace(train_root)
    sweep = ["--device", "cpu", "-b", "6", "4", "6"]
    runs = {
        "sweep_one": ("ta3n_tpu_torch.cli.sweep", _sweep_argv(
            sweep_root, sweep_root / "one") + sweep),
        "sweep_grid": ("ta3n_tpu_torch.cli.sweep", _sweep_argv(
            sweep_root, sweep_root / "grid") + sweep
            + ["--sweep_mesh", "2", "--num_devices", "4"]),
        "train_one": ("ta3n_tpu_torch.cli.train", _wide_argv(
            train_root, "one", "--epochs", "2")),
        "train_grid": ("ta3n_tpu_torch.cli.train", _wide_argv(
            train_root, "grid", "--epochs", "2", "--model_parallel", "2",
            "--num_devices", "4")),
    }
    wait = _cli(*runs.values())
    out = {"roots": (sweep_root, train_root)}
    out["wait"] = lambda: out.setdefault("runs", dict(zip(runs, wait())))
    return out


def test_sweep_cli_member_grid_matches_one_process(grid, clis):
    """cli.sweep --sweep_mesh 2 --num_devices 4 --device cpu: 4 members
    over 2 shards of 2 gloo processes print the one process's rows (top-1
    equal, losses within 1e-4) and a summary naming the 4 devices, and
    write its directory; --sweep_mesh 2 on one process refuses with the
    divisibility message."""
    root, runs = clis["roots"][0], clis["wait"]()
    one = [json.loads(x) for x in _ok(runs["sweep_one"]).splitlines()
           if x.startswith("{")]
    grid = [json.loads(x) for x in _ok(runs["sweep_grid"]).splitlines()
            if x.startswith("{")]
    assert len(one) == len(grid) == 5
    for a, b in zip(grid[:4], one[:4]):
        assert a["top1"] == b["top1"] and (a["seed"], a["lr"]) == \
            (b["seed"], b["lr"])
        assert a["final_loss"] == pytest.approx(b["final_loss"], abs=1e-4)
    assert grid[4]["devices"] == 4 and one[4]["devices"] == 1
    assert grid[4]["ensemble_top1"] == one[4]["ensemble_top1"]
    assert sorted(os.listdir(root / "grid")) == sorted(os.listdir(root /
                                                                  "one"))
    with pytest.raises(SystemExit, match="not divisible"):
        cli_sweep.main(_sweep_argv(root, root / "bad")
                       + ["--device", "cpu", "--sweep_mesh", "2"])


def _results(out):
    return [x for x in out.splitlines() if x.startswith("Testing Results")]


def test_train_cli_model_grid_matches_one_process_and_resumes(grid, clis):
    """cli.train --num_devices 4 --model_parallel 2 --device cpu: a 2 x 2
    grid trains 2 epochs (device stores, K = 2 from the device sampler,
    dropout 0.5) to the one process's printed results, and rank 0's
    checkpoint, whole, equals the one process's; one process resumes from
    it and evaluates its weights to the same result."""
    root, runs = clis["roots"][1], clis["wait"]()
    one, on_grid = _ok(runs["train_one"]), _ok(runs["train_grid"])
    assert _results(on_grid) == _results(one) and len(_results(one)) == 2
    ckpts = [torch.load(str(root / exp / "RGB" / "checkpoint.pth.tar"),
                        map_location="cpu", weights_only=False)
             for exp in ("grid", "one")]
    assert ckpts[0]["step"] == ckpts[1]["step"]
    _close({k: v.numpy() for k, v in ckpts[0]["state_dict"].items()},
           {k: v.numpy() for k, v in ckpts[1]["state_dict"].items()},
           "checkpoint")
    momentum = [c["optimizer"]["state"] for c in ckpts]
    for i, entry in momentum[1].items():
        np.testing.assert_allclose(momentum[0][i]["momentum_buffer"],
                                   entry["momentum_buffer"], **TOL)
    resumed = cli_train.main(_wide_argv(
        root, "solo", "--epochs", "2", "--resume",
        str(root / "grid" / "RGB" / "checkpoint.pth.tar"), "--evaluate"))
    last = re.findall(r"Prec@1 ([0-9.]+)", _results(one)[-1])
    assert last and f"{resumed:.3f}" == last[0]


def test_train_cli_interrupt_on_one_rank_of_a_model_grid(tmp_path):
    """cli.train --num_devices 4 --model_parallel 2: a KeyboardInterrupt
    on rank 0 alone, as SIGINT or a second SIGTERM raises it, while its
    model group's peers are still in the step.  Rank 0 writes no
    emergency checkpoint (its weights would be gathered from peers that
    have not stopped), the run stops, and the last checkpoint is left
    whole.  SIGINT makes the interrupt certain: of two SIGTERMs, the ranks
    can agree on the first before the second comes (a stop that every
    rank saves at together), and two that come close are taken as one."""
    import signal
    import time

    _wide_workspace(tmp_path)
    ckpt = tmp_path / "sig" / "RGB" / "checkpoint.pth.tar"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    launcher = subprocess.Popen(
        [sys.executable, "-m", "ta3n_tpu_torch.cli.train", *_wide_argv(
            tmp_path, "sig", "--epochs", "100000", "--model_parallel", "2",
            "--num_devices", "4")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not ckpt.exists() and time.time() < deadline:
            time.sleep(0.2)
        assert ckpt.exists(), "no epoch finished"
        workers = _workers(launcher.pid)
        assert len(workers) == 4
        os.kill(workers[0], signal.SIGINT)
        out, _ = launcher.communicate(timeout=120)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    assert launcher.returncode != 0
    assert "no emergency checkpoint" in out, out[-3000:]
    assert "emergency checkpoint saved" not in out
    payload = torch.load(str(ckpt), map_location="cpu", weights_only=True)
    assert payload["epoch"] >= 1
    weight = payload["state_dict"]["module.fc_feature_shared_source.weight"]
    assert tuple(weight.shape) == (512, 1024)
    assert torch.isfinite(weight).all()
