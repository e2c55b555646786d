"""PyTorch port, data parallelism over a 1-D grid (`ta3n_tpu_torch/
parallel/`): the train and eval steps of two ranks, spawned processes in a
gloo group (tests/test_torch_port_parallel_worker.py), against the port's
one-rank steps on the same global batches and, for the flagship on host
features and on device stores and for AdaBN, against the JAX package's
steps over a 2-device mesh (``make_mesh(jax.devices()[:2])``) from the
same numpy weights (CPU, float32, dropout 0 where JAX is the reference).
Also the multi-host helpers case for case with the JAX ones, the train
CLI's ``--num_devices 2`` on the CPU against one process with a resume
and a SIGTERM, the Predictor over a grid of two CPU replicas and its
artifact, and the eval and serve CLIs' ``--data_parallel``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_surface_model import jax_weights
from test_torch_port_parallel_worker import run_cases
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.parallel import distributed as jax_distributed
from ta3n_tpu.parallel import mesh as jax_mesh
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu_torch.cli import serve as serve_cli
from ta3n_tpu_torch.cli import test_models as eval_cli
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import make_domain_pair
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.parallel import Mesh, make_mesh, make_mesh_2d
from ta3n_tpu_torch.parallel import distributed
from ta3n_tpu_torch.parallel import mesh as port_mesh
from ta3n_tpu_torch.serve import Predictor
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress
from ta3n_tpu_torch.train.step import (create_train_state, make_infer_step,
                                       make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests",
                      "test_torch_port_parallel_worker.py")
TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(num_class=5, baseline_type="video", frame_aggregation="trn-m",
            train_segments=5, val_segments=5, feature_dim=24, fc_dim=16,
            use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
FLAGSHIP_DA = dict(use_target="uSv", adv_DA="RevGrad",
                   add_loss_DA="attentive_entropy",
                   place_adv=("Y", "Y", "Y"))
AVGPOOL = dict(frame_aggregation="avgpool", use_attn="none")
B_S, B_T = 8, 6          # global batches: 4 + 3 videos a rank
N_STEPS = 3
LR0, GAMMA, BETA = 0.03, 0.003, (-1.0, -1.0, -1.0)
# name -> (model fields beyond BASE, DAConfig fields beyond the flagship's,
#          kind, extra case fields); JAX holds the first three
CASES = {
    "flagship_host": ({}, {}, "host", {}),
    "flagship_store": ({}, {}, "store", {}),
    "adabn": (dict(use_bn="AdaBN"), {}, "host", {}),
    "dan": ({}, dict(dis_DA="DAN", place_dis=("Y", "Y", "Y")), "host", {}),
    "jan": (AVGPOOL, dict(dis_DA="JAN"), "host", {}),
    "coral": ({}, dict(dis_DA="CORAL", place_dis=("Y", "Y", "Y")), "host",
              {}),
    "mcd": (dict(ens_DA="MCD"), dict(ens_DA="MCD"), "host", {}),
    "dropout": (dict(dropout_i=0.5, dropout_v=0.5), {}, "store",
                dict(dropout_seed=7)),
    "padded": ({}, {}, "host", {}),
    "accum": ({}, {}, "accum", {}),
    "multi": ({}, {}, "multi", dict(batch=(6, 4))),
    "sampled": ({}, {}, "sampled", dict(batch=(6, 4))),
}
JAX_CASES = ("flagship_host", "flagship_store", "adabn")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU steps (as the other
    step modules), restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scalars(i):
    p = progress(i, 0, 20)
    return (tuple(effective_beta(BETA, p)), 0.5, 0.1, GAMMA,
            dann_lr(LR0, p))


def _host_batch(seed, bs=B_S, bt=B_T):
    """A global batch whose last video of each stream is padded."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(bs, 5, 24)).astype(np.float32)
    xt = rng.normal(size=(bt, 5, 24)).astype(np.float32)
    ys = rng.integers(0, 5, bs).astype(np.int32)
    yt = rng.integers(0, 5, bt).astype(np.int32)
    ms, mt = np.ones(bs, np.float32), np.ones(bt, np.float32)
    ms[-1] = mt[-1] = 0.0
    xs[-1] = xt[-1] = 0.0
    return xs, ys, ms, xt, yt, mt


def _index_batch(seed, rows):
    rng = np.random.default_rng(seed)
    idx_s = rng.integers(0, rows, (B_S, 5)).astype(np.int32)
    idx_t = rng.integers(0, rows, (B_T, 5)).astype(np.int32)
    ys = rng.integers(0, 5, B_S).astype(np.int32)
    yt = rng.integers(0, 5, B_T).astype(np.int32)
    ms, mt = np.ones(B_S, np.float32), np.ones(B_T, np.float32)
    ms[-1] = mt[-1] = 0.0
    return idx_s, ys, ms, idx_t, yt, mt


def _padded(batch):
    """The target stream of a batch of B_T - 1 real videos padded to B_T
    with a masked zero video, as a loader pads to a multiple of 2."""
    xs, ys, ms, xt, yt, mt = batch
    return (xs, ys, ms, np.concatenate([xt, np.zeros_like(xt[:1])]),
            np.concatenate([yt, yt[:1]]), np.concatenate([mt, [0.0]])
            .astype(np.float32))


def _spec(store_dir):
    """Every case, as the workers and the one-rank run read it; and the
    one-rank spec, where "padded" runs its batches unpadded."""
    rng = np.random.default_rng(0)
    store = rng.normal(size=(60, 24)).astype(np.float32)
    spec, weights, drawn = {}, {}, {}
    for name, (fields, da, kind, extra) in CASES.items():
        model = {**BASE, **fields}
        # one draw a parameter layout (dropout rates change none): JAX's
        # where JAX is the reference, else the port's
        layout = tuple(sorted((k, v) for k, v in model.items()
                              if not k.startswith("dropout")))
        if layout not in drawn:
            drawn[layout] = (
                jax_weights(model, seed=len(drawn)) if name in JAX_CASES
                else (None, _port_weights(model, seed=len(drawn)), None))
        jmodel, params, stats = weights[name] = drawn[layout]
        case = dict(model=model, da={**FLAGSHIP_DA, **da}, kind=kind,
                    weights=(params if jmodel is None else
                             state_dict_from_jax_params(params, stats)),
                    scalars=[_scalars(i) for i in range(N_STEPS)],
                    train=dict(lr=LR0), **extra)
        if kind == "host":
            case["batches"] = [_host_batch(10 + i) for i in range(N_STEPS)]
        elif kind == "store":
            case["store"] = store
            case["batches"] = [_index_batch(10 + i, len(store))
                               for i in range(N_STEPS)]
            val = [_index_batch(20 + i, len(store)) for i in range(2)]
            case["val"] = tuple(np.stack([v[j] for v in val])
                                for j in (0, 1, 2))
        elif kind == "accum":
            micro = [[_host_batch(30 + 2 * i + g) for g in range(2)]
                     for i in range(N_STEPS)]
            case["batches"] = [tuple(np.stack([m[j] for m in pair])
                                     for j in range(6)) for pair in micro]
        else:
            case["store_dir"] = store_dir
            case["scalars"] = case["scalars"][:2]       # K = 2 a call
        spec[name] = case
    one = dict(spec)
    one["padded"] = dict(spec["padded"], batches=[
        _host_batch(10 + i, bt=B_T - 1) for i in range(N_STEPS)])
    spec["padded"] = dict(spec["padded"], batches=[
        _padded(b) for b in one["padded"]["batches"]])
    return spec, one, weights


def _port_weights(model, seed):
    """The port's state_dict for the model fields, every weight redrawn
    at U(±1/sqrt(fan_in)) (as _redraw does JAX's)."""
    state = create_train_state(ModelConfig(**model), TrainConfig(),
                               torch.Generator().manual_seed(seed),
                               device="cpu")
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in state.model.state_dict().items():
        if v.dtype.is_floating_point and "running" not in name:
            fan_in = v.shape[-1] if v.dim() > 1 else 16
            bound = 1.0 / np.sqrt(fan_in)
            v = torch.from_numpy(rng.uniform(-bound, bound, tuple(v.shape))
                                 .astype(np.float32))
        out[name] = v
    return out


def _spawn_ranks(spec, tmp, world=2):
    """``world`` worker processes in a gloo group running the spec, and
    a function that waits for them and returns each rank's results."""
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
        assert codes == [0] * world
        return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    store_dir = str(tmp / "store")
    make_domain_pair(num_source=14, num_target=10, num_val=2, num_class=5,
                     feature_dim=24)[0].save(store_dir)
    spec, one_spec, weights = _spec(store_dir)
    ranks = _spawn_ranks(spec, tmp)
    one = run_cases(one_spec)   # while the ranks run
    return spec, one, ranks(), weights


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]),
                                   err_msg=f"{what}: {key}", **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_rank(runs, name):
    """Each case's parameters and BN statistics after its steps, and every
    step's metrics (the global batch's), at 2 ranks against 1: the
    flagship on host features and device stores (with the eval steps), AdaBN,
    DAN, JAN and CORAL at every layer, MCD, dropout 0.5 (the masks drawn
    at the global shape), a target batch padded for 2 ranks against its
    unpadded one-rank run, gradient accumulation, and K = 2 steps a call
    from stacked index batches and from the device sampler."""
    _, one, ranks, _ = runs
    got, want = ranks[0][name], one[name]
    assert got["steps"] == want["steps"]
    _close(got["params"], want["params"], "params")
    for g, w in zip(got["metrics"], want["metrics"]):
        _close(g, w, "metrics")
    for key in [k for k in want if k.startswith(("eval_", "multi_"))]:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_bitwise_equal_parameters(runs, name):
    """The one flat gradient all-reduce and the same update on every rank
    leave the ranks' parameters and metrics bitwise equal."""
    _, _, (r0, r1), _ = runs
    for key in r0[name]["params"]:
        np.testing.assert_array_equal(r0[name]["params"][key],
                                      r1[name]["params"][key], err_msg=key)
    for a, b in zip(r0[name]["metrics"], r1[name]["metrics"]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _jax_run(spec, name, weights):
    """The JAX step over a 2-device mesh on the case's batches: (params
    and batch_stats as the port's state_dict, every step's metrics)."""
    case = spec[name]
    jmodel, params, stats = weights[name]
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, B_S))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                           stats),
                           tx.init(jparams), jnp.asarray(0, jnp.int32))
    store = case["kind"] == "store"
    jstep = jax_make_train_step(jmodel, JaxDAConfig(**case["da"]), jtc,
                                gather_on_device=store,
                                mesh=jax_mesh.make_mesh(jax.devices()[:2]))
    metrics = []
    for i, batch in enumerate(case["batches"]):
        beta, mu, alpha, gamma, lr = case["scalars"][i]
        if store:
            dev = jnp.asarray(case["store"])
            xs, ys, ms, xt, yt, mt = batch
            batch = (dev, xs, ys, ms, dev, xt, yt, mt)
        jstate, m = jstep(jstate, *batch, JaxStepScalars(
            np.asarray(beta, np.float32), np.float32(mu), np.float32(alpha),
            np.float32(gamma), np.float32(lr)), jax.random.PRNGKey(0))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    host = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                               jstate.batch_stats))
    return state_dict_from_jax_params(*host), metrics


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_match_jax_mesh_step(runs, name):
    """The port's 2-rank step against the JAX package's step over a
    2-device mesh, from the same numpy weights on the same global batches:
    the flagship on host features, on device stores (K3's path), and
    AdaBN, whose BN moments and running statistics are the global batch's
    on both sides (tests/test_sharding.py:208)."""
    spec, _, ranks, weights = runs
    want_params, want_metrics = _jax_run(spec, name, weights)
    got = ranks[0][name]
    # JAX's batch_stats count no batches: the port's counter apart
    want_params = {k: v for k, v in want_params.items()
                   if not k.endswith("num_batches_tracked")}
    _close({k: got["params"][k] for k in want_params},
           {k: v.numpy() for k, v in want_params.items()}, "params")
    for g, w in zip(got["metrics"], want_metrics):
        _close(g, w, "metrics")
    if name == "adabn":
        assert any("running_mean" in k for k in want_params)


def test_sampled_case_draws_padded_global_batches(runs):
    """The K = 2 call's batches are the samplers' global batches (6 + 4
    videos, 3 + 2 a rank): its metrics count every real video of both
    steps on every rank."""
    _, one, ranks, _ = runs
    n = ranks[0]["sampled"]["metrics"][0]["n"]
    assert n.shape == (2,) and float(n.sum()) > 0
    np.testing.assert_array_equal(n, one["sampled"]["metrics"][0]["n"])


# ---- (f) the multi-host helpers, case for case with the JAX ones ----

@pytest.mark.parametrize("world,rank,batch", [
    (1, 0, 128), (4, 2, 128), (2, 1, 202), (3, 0, 128), (8, 7, 64)])
def test_host_batch_slice_matches_jax(monkeypatch, world, rank, batch):
    monkeypatch.setattr(distributed, "process_count", lambda: world)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    if batch % world:
        with pytest.raises(ValueError, match="pad with masked rows"):
            jax_distributed.host_batch_slice(batch)
        with pytest.raises(ValueError, match="pad with masked rows"):
            distributed.host_batch_slice(batch)
        return
    assert distributed.host_batch_slice(batch) == \
        jax_distributed.host_batch_slice(batch)
    assert distributed.is_primary_host() == (rank == 0) == \
        jax_distributed.is_primary_host()


@pytest.mark.parametrize("batch,n", [(128, 4), (74, 4), (75, 2), (1, 8),
                                     (0, 3), (202, 1)])
def test_pad_to_multiple_matches_jax(batch, n):
    assert port_mesh.pad_to_multiple(batch, n) == \
        jax_mesh.pad_to_multiple(batch, n)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_lift_to_global_is_the_rank_rows_of_jax_global_array(world):
    """Each rank's rows of a batch every rank holds whole are the shard
    that the JAX function's global array puts on that rank's device."""
    a = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    sharding = jax_mesh.batch_sharding(jax_mesh.make_mesh(
        jax.devices()[:world]))
    shards = {s.device: np.asarray(s.data) for s in
              jax_mesh.lift_to_global(a, sharding).addressable_shards}
    for rank, dev in enumerate(jax.devices()[:world]):
        mesh = Mesh(["cpu"], rank=rank, group=object(), size=world)
        np.testing.assert_array_equal(port_mesh.lift_to_global(a, mesh),
                                      shards[dev])


def test_mesh_without_group_and_2d_grids():
    """Without a process group make_mesh is a single process's grid (here
    the CPU, named: without a card make_mesh() refuses rather than serve
    on the CPU), every step helper the identity; shard_train_step builds a
    step again over a mesh and refuses one without ``with_mesh``; the 2-D
    grids, one process a device, refuse to be made without a process
    group, and a mesh's model and member axes default to size 1."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    mesh = make_mesh(["cpu"])
    assert mesh.group is None and not port_mesh.active(mesh)
    x = torch.ones(3)
    assert port_mesh.lift_to_global(x, mesh) is x
    assert port_mesh.shard_sum(x, mesh) is x
    assert port_mesh.all_gather_rows([x], mesh)[0] is x
    model = VideoModel(SERVE_CFG, torch.Generator().manual_seed(0))
    step = make_train_step(model, DAConfig(**FLAGSHIP_DA), TrainConfig())
    assert callable(port_mesh.shard_train_step(step, mesh))
    with pytest.raises(ValueError, match="with_mesh"):
        port_mesh.shard_train_step(lambda *a: None, mesh)
    with pytest.raises(ValueError, match="initialise the process group"):
        make_mesh_2d(model_parallel=2)
    assert mesh.model.size == mesh.member.size == 1 and mesh.is_primary
    with pytest.raises(ValueError, match="no coordinator"):
        distributed.initialize_multihost()


# ---- (e) the train CLI over two CPU processes ----

def _workspace(root):
    stores = make_domain_pair(num_source=24, num_target=18, num_val=12,
                              num_class=3, feature_dim=32, shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    (root / "class.txt").write_text("0 a\n1 b\n2 c\n")


def _train_argv(root, exp, *extra):
    return [str(root / "class.txt"), "RGB", str(root / "src" / "list.txt"),
            str(root / "tgt" / "list.txt"), str(root / "val" / "list.txt"),
            "--exp_path", str(root / exp) + "/", "--baseline_type", "video",
            "--frame_aggregation", "trn-m", "--use_attn", "TransAttn",
            "--fc_dim", "32", "--feature_dim", "32", "--use_target", "uSv",
            "--adv_DA", "RevGrad", "--add_loss_DA", "attentive_entropy",
            "--gamma", "0.003", "--beta", "0.75", "0.75", "0.5", "--lr",
            "0.03", "--lr_adaptive", "none", "-b", "8", "6", "8",
            "--dropout_i", "0.5", "--dropout_v", "0.5", "-pf", "1",
            "--save_model", "--save_best_log", str(root / exp / "best.log"),
            "--device", "cpu", "--device_store", "--steps_per_call", "2",
            "--device_sampler", *extra]


def _cli(*argvs):
    """Each command line's train CLI run, all at once (their experiment
    directories differ): (exit code, stdout, stderr) of each."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ta3n_tpu_torch.cli.train", *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs]
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


def _ok(run):
    code, out, err = run
    assert code == 0, err[-3000:]
    return out


def _checkpoint(root, exp, name="checkpoint.pth.tar"):
    return torch.load(str(root / exp / "RGB" / name), map_location="cpu",
                      weights_only=False)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The workspace and the train CLI's runs that the tests below read,
    all started at once: (root, {name: (exit code, stdout, stderr)})."""
    root = tmp_path_factory.mktemp("cli")
    _workspace(root)
    argvs = {
        "one": ("--epochs", "2"),
        "two": ("--epochs", "2", "--num_devices", "2"),
        # epoch 1 of a 2-process run, resumed to epoch 2 below
        "part": ("--epochs", "1", "--num_devices", "2"),
        "bad": ("--epochs", "1", "--num_devices", "2", "--store_val",
                str(root / "missing")),
        "tb_one": ("--epochs", "2", "--tensorboard"),
        "tb_two": ("--epochs", "2", "--tensorboard", "--num_devices", "2"),
    }
    runs = _cli(*(_train_argv(root, name, *extra)
                  for name, extra in argvs.items()))
    return root, dict(zip(argvs, runs))


def test_train_cli_two_processes_match_one_and_resume(cli_runs):
    """``--num_devices 2 --device cpu``: two gloo processes train 2 epochs
    (K = 2 steps a call from the device sampler, dropout 0.5, its masks
    drawn at the global batch's shape; the last val batch padded) to the
    one-process run's parameters and printed results; rank 0 alone prints
    and writes
    the logs and the checkpoint; a 2-process ``--resume`` from the epoch-1
    checkpoint ends equal to the straight run (the sampler's batches are
    keyed by the saved step, the dropout stream by the saved generator
    state; the lr and the betas are constants, so that the first epoch of
    a 1-epoch run is that of a 2-epoch one).  A worker that fails (a store
    directory that does not exist) makes the launcher exit non-zero,
    naming the rank."""
    tmp_path, runs = cli_runs
    one, two, part, bad = (runs[k] for k in ("one", "two", "part", "bad"))
    assert bad[0] != 0 and "of 2 failed" in bad[2]
    one, two = _ok(one), _ok(two)
    _ok(part)
    results = [line for line in two.splitlines()
               if line.startswith("Testing Results")]
    assert results == [line for line in one.splitlines()
                       if line.startswith("Testing Results")]
    assert len(results) == 2 and two.count("start training") == 1
    with open(tmp_path / "two" / "RGB" / "val.log") as f:
        assert [line.strip() for line in f
                if line.startswith("Testing")] == results
    a, b = _checkpoint(tmp_path, "one"), _checkpoint(tmp_path, "two")
    assert a["epoch"] == b["epoch"] == 2 and a["step"] == b["step"]
    _close({k: v.numpy() for k, v in b["state_dict"].items()},
           {k: v.numpy() for k, v in a["state_dict"].items()}, "straight")

    ckpt = str(tmp_path / "part" / "RGB" / "checkpoint.pth.tar")
    _ok(*_cli(_train_argv(tmp_path, "part", "--epochs", "2",
                          "--num_devices", "2", "--resume", ckpt,
                          "--resume_hp")))
    c = _checkpoint(tmp_path, "part")
    assert c["epoch"] == 2
    _close({k: v.numpy() for k, v in c["state_dict"].items()},
           {k: v.numpy() for k, v in b["state_dict"].items()}, "resumed")

    # the eval CLI with --data_parallel (one CPU replica here: the grid's
    # split is test_infer_step_grid_matches_one_device's) on the best
    # checkpoint: the plain run's Pred@k line
    evaluate = [str(tmp_path / "class.txt"), "RGB",
                str(tmp_path / "val" / "list.txt"),
                str(tmp_path / "two" / "RGB" / "model_best.pth.tar"),
                "--test_segments", "5", "--fc_dim", "32", "--feature_dim",
                "32", "--baseline_type", "video", "--frame_aggregation",
                "trn-m", "--use_attn", "TransAttn", "--bS", "5", "--top", "1",
                "3", "--device", "cpu", "--device_store"]
    plain = eval_cli.main(evaluate)
    assert eval_cli.main(evaluate + ["--data_parallel"]) == plain


def test_train_cli_tensorboard_two_processes_match_one(cli_runs):
    """``--tensorboard`` over two processes: every rank takes the modes
    the writer's collection needs (one step a call, a per-batch
    validation), though rank 0 alone writes, so the ranks run the same
    collectives and end at the one-process run's results; the writer's
    files are those of one process."""
    tmp_path, runs = cli_runs
    one, two = runs["tb_one"], runs["tb_two"]
    one, two = _ok(one), _ok(two)
    results = [line for line in two.splitlines()
               if line.startswith("Testing Results")]
    assert len(results) == 2 and results == [
        line for line in one.splitlines()
        if line.startswith("Testing Results")]
    a, b = _checkpoint(tmp_path, "tb_one"), _checkpoint(tmp_path, "tb_two")
    assert a["step"] == b["step"]
    _close({k: v.numpy() for k, v in b["state_dict"].items()},
           {k: v.numpy() for k, v in a["state_dict"].items()}, "tensorboard")
    written = [sorted(os.listdir(tmp_path / exp / "RGB" / "tensorboard"))
               for exp in ("tb_one", "tb_two")]
    assert written[0] and len(written[0]) == len(written[1])


def _workers(pid):
    """The launcher's spawned workers (rank order is start order), by
    /proc."""
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        kids = [int(k) for k in f.read().split()]
    workers = []
    for kid in kids:
        with open(f"/proc/{kid}/cmdline", "rb") as f:
            if b"spawn_main" in f.read():
                workers.append(kid)
    return sorted(workers)


def test_train_cli_sigterm_on_one_rank_stops_all_with_checkpoint(tmp_path):
    """A SIGTERM to rank 1 alone: the ranks agree on it at the next flush
    and stop together, rank 0 writes the emergency checkpoint, and the
    launcher exits non-zero naming the rank."""
    import signal
    import time

    _workspace(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    ckpt = tmp_path / "sig" / "RGB" / "checkpoint.pth.tar"
    launcher = subprocess.Popen(
        [sys.executable, "-m", "ta3n_tpu_torch.cli.train",
         *_train_argv(tmp_path, "sig", "--epochs", "100000",
                      "--num_devices", "2")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not ckpt.exists() and time.time() < deadline:
            time.sleep(0.2)
        assert ckpt.exists(), "no epoch finished"
        workers = _workers(launcher.pid)
        assert len(workers) == 2
        os.kill(workers[1], signal.SIGTERM)
        out, _ = launcher.communicate(timeout=120)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    assert launcher.returncode != 0
    assert "emergency checkpoint saved" in out
    assert "rank 1 of 2 failed" in out or "rank 0 of 2 failed" in out
    assert _checkpoint(tmp_path, "sig")["epoch"] >= 1


# ---- (g) serving over a grid of two CPU replicas ----

SERVE_CFG = ModelConfig(**{**BASE, "num_class": 5})


@pytest.fixture(scope="module")
def served_model():
    return VideoModel(SERVE_CFG, torch.Generator().manual_seed(3))


@pytest.mark.parametrize("batch", [8, 7, 1])
def test_predictor_grid_matches_one_device(served_model, batch):
    """Predictor(mesh=) over two CPU replicas: the batch rounded up to a
    multiple of 2, each chunk split in two, the answers those of one
    device, for 21 videos (a padded last chunk) and for 1."""
    rng = np.random.default_rng(1)
    one = Predictor(SERVE_CFG, served_model, batch_size=batch, top_k=3,
                    device="cpu")
    grid = Predictor(SERVE_CFG, served_model, batch_size=batch, top_k=3,
                     device="cpu", mesh=Mesh(["cpu", "cpu"]))
    assert grid.batch_size == port_mesh.pad_to_multiple(batch, 2)
    for n in (21, 1):
        x = rng.normal(size=(n, 5, 24)).astype(np.float32)
        for a, b in zip(one(x), grid(x)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_predictor_grid_ensemble_and_artifact(served_model, tmp_path):
    """A 2-member ensemble over the grid answers as on one device; an
    artifact served over the grid answers as the live Predictor, and one
    whose batch does not divide by the devices is refused (the JAX
    Predictor's rule), as is one traced at a fixed batch."""
    x = np.random.default_rng(2).normal(size=(11, 5, 24)).astype(np.float32)
    members = [served_model, VideoModel(SERVE_CFG,
                                        torch.Generator().manual_seed(4))]
    one = Predictor(SERVE_CFG, members, batch_size=4, device="cpu",
                    n_members=2)
    grid = Predictor(SERVE_CFG, members, batch_size=4, device="cpu",
                     n_members=2, mesh=Mesh(["cpu", "cpu"]))
    for a, b in zip(one(x), grid(x)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    live = Predictor(SERVE_CFG, served_model, batch_size=6, device="cpu")
    path = live.export(str(tmp_path / "art"))
    art = Predictor.from_exported(path, mesh=Mesh(["cpu", "cpu"]),
                                  device="cpu")
    for a, b in zip(live(x), art(x)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible by the 4-device"):
        Predictor.from_exported(path, mesh=Mesh(["cpu"] * 4), device="cpu")
    # an int8 model's trace fixes the batch: its artifact serves on one
    # device only
    int8_cfg = ModelConfig(**{**BASE, "quantize": "int8"})
    fixed = Predictor(int8_cfg, VideoModel(int8_cfg, torch.Generator()
                                           .manual_seed(5)),
                      batch_size=4, device="cpu").export(
                          str(tmp_path / "int8"))
    with pytest.raises(ValueError, match="fixed batch"):
        Predictor.from_exported(fixed, mesh=Mesh(["cpu", "cpu"]),
                                device="cpu")


def test_serve_cli_data_parallel(served_model, tmp_path, monkeypatch):
    """cli.serve --data_parallel serves the checkpoint over the grid of
    make_mesh() (one CPU replica with --device cpu), answering as the
    plain Predictor."""
    from ta3n_tpu_torch.io_utils.convert import export_reference_state
    path = str(tmp_path / "model.pth.tar")
    torch.save({"epoch": 1, "prec1": 0.0, "state_dict": {
        f"module.{k}": v for k, v in
        export_reference_state(served_model).items()}}, path)
    (tmp_path / "class.txt").write_text(
        "".join(f"{i} c{i}\n" for i in range(5)))
    served = {}
    monkeypatch.setattr(serve_cli, "run_http_server",
                        lambda p, names, host, port: served.update(p=p))
    serve_cli.main([str(tmp_path / "class.txt"), path, "--feature_dim",
                    "24", "--fc_dim", "16", "--test_segments", "5",
                    "--device", "cpu", "--batch_size", "4",
                    "--data_parallel"])
    grid = served["p"]
    assert grid._shards is not None and len(grid._shards) == 1
    x = np.random.default_rng(4).normal(size=(9, 5, 24)).astype(np.float32)
    plain = Predictor(SERVE_CFG, served_model, batch_size=4, device="cpu")
    for a, b in zip(plain(x), grid(x)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gather_on_device", [False, True])
def test_infer_step_grid_matches_one_device(served_model, gather_on_device):
    """The eval CLI's infer step over two CPU replicas, from host features
    and from a store copy a device, against one device."""
    rng = np.random.default_rng(3)
    one = make_infer_step(served_model, 3, gather_on_device)
    grid = make_infer_step(served_model, 3, gather_on_device,
                           mesh=Mesh(["cpu", "cpu"]))
    if gather_on_device:
        store = torch.from_numpy(rng.normal(size=(40, 24))
                                 .astype(np.float32))
        idx = rng.integers(0, 40, (3, 8, 5)).astype(np.int32)
        mask = np.ones((3, 8), np.float32)
        mask[-1, -3:] = 0.0
        want, got = one(store, idx, mask), grid([store, store], idx, mask)
    else:
        x = rng.normal(size=(8, 5, 24)).astype(np.float32)
        want, got = one(x), grid(x)
    for a, b in zip(want, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
