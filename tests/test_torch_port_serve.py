"""PyTorch port, serving: the port's Predictor serves a reference-format
checkpoint written by the JAX package and answers as the JAX Predictor
does (CPU), over HTTP too; a sweep's member checkpoints as one deep
ensemble (``from_sweep``, the CLI with a sweep dir and ``--sweep_best``)
whose probabilities are the mean of the members' solo Predictors' and the
JAX ensemble Predictor's (``n_members``) on the same weights, within
PROB_TOL; the pipelined fetch equal to chunks fetched one by one; the
CLI's --export and --quantize, and its refusal of what is not ported."""

import dataclasses
import os
import shutil

import inspect
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_torch_port_precision import SLICE_TOL
from ta3n_tpu.config import ModelConfig, TrainConfig
from ta3n_tpu.io_utils.torch_export import save_torch_checkpoint
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.serve import Predictor as JaxPredictor
from ta3n_tpu.train import create_train_state
from ta3n_tpu_torch.cli import serve as cli_serve
from ta3n_tpu_torch.io_utils.convert import (load_reference_checkpoint,
                                             reference_state_dict)
from ta3n_tpu_torch.models import layers
from ta3n_tpu_torch.serve import Predictor, make_http_server

CFG = ModelConfig(num_class=4, baseline_type="video",
                  frame_aggregation="trn-m", train_segments=3,
                  val_segments=3, fc_dim=16, feature_dim=16,
                  use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """JAX params redrawn at a trained-like scale (kernels
    U(±1/sqrt(fan_in)), biases U(±0.25)), so that top-k is not decided by
    rounding, saved as a reference-format .pth.tar with the `module.`
    prefix and the dead keys."""
    state = create_train_state(JaxVideoModel(CFG), jax.random.PRNGKey(0),
                               4, 4, TrainConfig(batch_size=(4, 4, 4)))
    rng = np.random.default_rng(0)

    def redraw(leaf):
        bound = 1.0 / np.sqrt(leaf.shape[0]) if leaf.ndim == 2 else 0.25
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map(redraw, state.params)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pth.tar")
    save_torch_checkpoint(path, params)
    return path, params


@pytest.fixture(scope="module")
def predictor(checkpoint):
    return Predictor.from_checkpoint(checkpoint[0], CFG, device="cpu",
                                     batch_size=4, top_k=3)


def test_load_reference_checkpoint_onto_the_cpu(checkpoint):
    """The loader defaults to the card, as Predictor.from_checkpoint does;
    a CPU caller asks for the CPU and gets every weight of the file
    there."""
    default = inspect.signature(load_reference_checkpoint).parameters[
        "device"].default
    assert default == "cuda"
    model = load_reference_checkpoint(checkpoint[0], CFG, device="cpu")
    state = model.state_dict()
    want = reference_state_dict(checkpoint[0])
    assert sorted(state) == sorted(want)
    for name, value in want.items():
        assert state[name].device.type == "cpu"
        assert torch.equal(state[name], value), name


def test_predictor_matches_jax_predictor(checkpoint, predictor):
    """N=6 at batch 4: two chunks, the second padded."""
    x = np.random.default_rng(1).normal(size=(6, 3, 16)).astype(np.float32)
    ref = JaxPredictor(CFG, checkpoint[1], batch_size=4, top_k=3)
    want_p, want_tp, want_ti = ref(x)
    probs, tp, ti = predictor(x)
    assert probs.shape == (6, 4) and tp.shape == ti.shape == (6, 3)
    np.testing.assert_allclose(probs, want_p, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(tp, want_tp, rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(ti, want_ti)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=PROB_TOL)
    # padding does not change a row
    np.testing.assert_allclose(predictor(x[4:])[0], probs[4:], rtol=0,
                               atol=PROB_TOL)


@pytest.mark.parametrize("n", [1, 4, 5, 9, 13])
def test_pipelined_call_is_the_one_by_one_fetch(predictor, n):
    """Ragged requests at batch 4 (up to four chunks, the last padded):
    the pipelined call, which reads chunk i after dispatching chunk i+1,
    answers bitwise as the chunks fetched one call each."""
    x = np.random.default_rng(10 + n).normal(size=(n, 3, 16)).astype(
        np.float32)
    got = predictor(x)
    one_by_one = [predictor(x[lo:lo + 4]) for lo in range(0, n, 4)]
    for a, b in zip(got, zip(*one_by_one)):
        np.testing.assert_array_equal(a, np.concatenate(b))
    assert got[0].shape == (n, 4) and got[2].dtype == np.int64


def test_http_round_trip(predictor):
    server = make_http_server(predictor, ["a", "b", "c", "d"], "127.0.0.1",
                              0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok", "num_class": 4,
                                            "segments": 3}
        x = np.random.default_rng(2).normal(size=(5, 3, 16)).astype(
            np.float32)
        req = urllib.request.Request(
            f"{url}/predict", data=json.dumps({"features": x.tolist()})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        _, tp, ti = predictor(x)
        assert out["top_classes"] == ti.tolist()
        np.testing.assert_allclose(out["top_probs"], tp, rtol=0,
                                   atol=PROB_TOL)
        assert out["names"][0] == ["abcd"[j] for j in ti[0]]

        bad = urllib.request.Request(
            f"{url}/predict", data=json.dumps({"features": [1, 2]}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/nope", timeout=10)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_checkpoint_directory_raises_with_export_hint(tmp_path):
    with pytest.raises(ValueError, match="ta3n_tpu.cli.export_checkpoint"):
        Predictor.from_checkpoint(str(tmp_path), CFG, device="cpu")


def test_unported_serving_extras_raise(checkpoint, predictor, tmp_path):
    """Data-parallel serving (mesh=) raises, naming ROADMAP.md queue 1,
    item 9; AOT export is ported: the artifact answers as the Predictor
    (tests/test_torch_port_export.py holds it to JAX's); ensemble serving
    is ported: a sweep dir of two copies of one checkpoint serves that
    checkpoint's answers."""
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        Predictor(CFG, predictor.model, device="cpu", mesh=object())
    x = np.random.default_rng(5).normal(size=(5, 3, 16)).astype(np.float32)
    served = Predictor.from_exported(predictor.export(str(tmp_path / "a")),
                                     device="cpu")
    np.testing.assert_allclose(served(x)[0], predictor(x)[0], rtol=0,
                               atol=PROB_TOL)
    sweep = _sweep_dir(tmp_path, [checkpoint[0]] * 2)
    ens = Predictor.from_sweep(sweep, CFG, device="cpu", batch_size=4,
                               top_k=3)
    assert ens.n_members == 2
    np.testing.assert_allclose(ens(x)[0], predictor(x)[0], rtol=0,
                               atol=PROB_TOL)


def _sweep_dir(root, checkpoints, best=()):
    """A sweep's output layout: member_XX/checkpoint.pth.tar of each given
    checkpoint, and model_best.pth.tar for the members in ``best``."""
    for k, path in enumerate(checkpoints):
        d = os.path.join(str(root), "sweep", f"member_{k:02d}")
        os.makedirs(d, exist_ok=True)
        shutil.copyfile(path, os.path.join(d, "checkpoint.pth.tar"))
        if k in best:
            shutil.copyfile(path, os.path.join(d, "model_best.pth.tar"))
    return os.path.join(str(root), "sweep")


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Three members' JAX params, redrawn as ``checkpoint``'s, each saved
    as a reference-format .pth.tar."""
    root = tmp_path_factory.mktemp("members")
    state = create_train_state(JaxVideoModel(CFG), jax.random.PRNGKey(0),
                               4, 4, TrainConfig(batch_size=(4, 4, 4)))
    out = []
    for k in range(3):
        rng = np.random.default_rng(20 + k)
        params = jax.tree_util.tree_map(
            lambda leaf: rng.uniform(
                -(1.0 / np.sqrt(leaf.shape[0]) if leaf.ndim == 2 else 0.25),
                1.0 / np.sqrt(leaf.shape[0]) if leaf.ndim == 2 else 0.25,
                leaf.shape).astype(np.float32), state.params)
        path = str(root / f"m{k}.pth.tar")
        save_torch_checkpoint(path, params)
        out.append((path, params))
    return out


def test_from_sweep_is_the_member_mean_and_the_jax_ensemble(members,
                                                            tmp_path):
    """from_sweep over three members at batch 4 (two chunks, the second
    padded): the mean of the members' solo Predictors, and the JAX
    Predictor(n_members=3) on the stacked weights; model_best refused
    where a member has none; members= selects."""
    paths = [p for p, _ in members]
    sweep = _sweep_dir(tmp_path, paths, best=(0, 2))
    x = np.random.default_rng(6).normal(size=(6, 3, 16)).astype(np.float32)
    ens = Predictor.from_sweep(sweep, CFG, device="cpu", batch_size=4,
                               top_k=3)
    probs, tp, ti = ens(x)
    solo = [Predictor.from_checkpoint(p, CFG, device="cpu", batch_size=4,
                                      top_k=3)(x)[0] for p in paths]
    np.testing.assert_allclose(probs, np.mean(solo, axis=0), rtol=0,
                               atol=PROB_TOL)
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls),
                                     *[p for _, p in members])
    want_p, want_tp, want_ti = JaxPredictor(CFG, stacked, batch_size=4,
                                            top_k=3, n_members=3)(x)
    np.testing.assert_allclose(probs, want_p, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(tp, want_tp, rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(ti, want_ti)
    with pytest.raises(FileNotFoundError, match="member_01"):
        Predictor.from_sweep(sweep, CFG, which="model_best", device="cpu")
    best = Predictor.from_sweep(sweep, CFG, members=[0, 2],
                                which="model_best", device="cpu",
                                batch_size=4, top_k=3)
    np.testing.assert_allclose(best(x)[0], (solo[0] + solo[2]) / 2, rtol=0,
                               atol=PROB_TOL)
    with pytest.raises(ValueError, match="which="):
        Predictor.from_sweep(sweep, CFG, which="last", device="cpu")
    with pytest.raises(FileNotFoundError, match="no member_"):
        Predictor.from_sweep(str(tmp_path / "empty"), CFG, device="cpu")
    assert Predictor.is_sweep(sweep) and not Predictor.is_sweep(paths[0])


def test_bf16_from_sweep_is_the_member_mean_and_the_jax_ensemble(members,
                                                                 tmp_path):
    """from_sweep over the three members at compute_dtype="bfloat16"
    (batch 4, two chunks, the second padded): a float32 softmax averaged
    over the members, the mean of the members' solo bfloat16 Predictors
    within PROB_TOL, and within SLICE_TOL of the JAX
    Predictor(n_members=3) at bfloat16 (test_torch_port_precision.py's
    bound for the bfloat16 slice); the same top classes."""
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    paths = [p for p, _ in members]
    sweep = _sweep_dir(tmp_path, paths)
    x = np.random.default_rng(6).normal(size=(6, 3, 16)).astype(np.float32)
    probs, tp, ti = Predictor.from_sweep(sweep, cfg, device="cpu",
                                         batch_size=4, top_k=3)(x)
    assert probs.dtype == np.float32
    solo = [Predictor.from_checkpoint(p, cfg, device="cpu", batch_size=4,
                                      top_k=3)(x)[0] for p in paths]
    np.testing.assert_allclose(probs, np.mean(solo, axis=0), rtol=0,
                               atol=PROB_TOL)
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls),
                                     *[p for _, p in members])
    want_p, _, want_ti = JaxPredictor(cfg, stacked, batch_size=4, top_k=3,
                                      n_members=3)(x)
    want_p = np.asarray(want_p, np.float32)
    assert np.abs(probs - want_p).max() <= SLICE_TOL * np.abs(want_p).max()
    np.testing.assert_array_equal(ti[:, 0], np.asarray(want_ti)[:, 0])


def _class_file(tmp_path):
    path = tmp_path / "classes.txt"
    path.write_text("0 a\n1 b\n2 c\n3 d\n")
    return str(path)


_MODEL_FLAGS = ["--feature_dim", "16", "--fc_dim", "16",
                "--test_segments", "3"]


@pytest.mark.parametrize("flags", [["--export", "out"], ["--data_parallel"],
                                   ["--sweep_best"], ["--quantize", "int8"]])
def test_cli_refuses_unported_flags(tmp_path, checkpoint, flags,
                                    monkeypatch):
    """--data_parallel exits naming ROADMAP.md queue 1, item 9.  The
    others are ported: --export writes an artifact and exits without
    serving; --quantize int8 serves the int8 Predictor of the checkpoint
    (at these widths only the TRN's 256-wide bottleneck reaches the int8
    gate: the relation heads' first layers and the video domain FC);
    --sweep_best on a sweep dir serves the members' model_best
    as one ensemble, and on a solo checkpoint exits with the JAX CLI's
    message."""
    served = {}
    monkeypatch.setattr(cli_serve, "run_http_server",
                        lambda p, names, host, port: served.update(
                            predictor=p))
    argv = [_class_file(tmp_path), checkpoint[0], *_MODEL_FLAGS, "--device",
            "cpu", "--top_k", "3", "--batch_size", "4"]
    if flags == ["--data_parallel"]:
        with pytest.raises(SystemExit, match="queue 1, item 9"):
            cli_serve.main([*argv, *flags])
        return
    if flags[0] == "--export":
        out = str(tmp_path / flags[1])
        cli_serve.main([*argv, "--export", out])
        assert not served and Predictor.is_exported(out)
        return
    if flags[0] == "--quantize":
        cli_serve.main([*argv, *flags])
        assert served["predictor"].cfg.quantize == "int8"
        x = np.random.default_rng(9).normal(size=(5, 3, 16)).astype(
            np.float32)
        ref = Predictor.from_checkpoint(
            checkpoint[0], dataclasses.replace(CFG, quantize="int8"),
            device="cpu", batch_size=4, top_k=3)
        layers.int8_gemms = 0
        np.testing.assert_array_equal(served["predictor"](x)[0], ref(x)[0])
        # the 256-wide relation heads and video domain FC, at two chunks
        assert layers.int8_gemms == 2 * 2 * (2 + 1)
        return
    with pytest.raises(SystemExit, match="is not a sweep output dir"):
        cli_serve.main([_class_file(tmp_path), checkpoint[0], *_MODEL_FLAGS,
                        "--device", "cpu", *flags])
    sweep = _sweep_dir(tmp_path, [checkpoint[0]] * 2, best=(0, 1))
    cli_serve.main([_class_file(tmp_path), sweep, *_MODEL_FLAGS, "--device",
                    "cpu", "--top_k", "3", "--batch_size", "4", *flags])
    assert served["predictor"].n_members == 2


def test_cli_cuda_without_a_card_exits(tmp_path, checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_serve.main([_class_file(tmp_path), checkpoint[0],
                        *_MODEL_FLAGS])


def test_cli_builds_the_predictor(tmp_path, checkpoint, predictor,
                                  monkeypatch):
    served = {}
    monkeypatch.setattr(cli_serve, "run_http_server",
                        lambda p, names, host, port: served.update(
                            predictor=p, names=names, port=port))
    cli_serve.main([_class_file(tmp_path), checkpoint[0], *_MODEL_FLAGS,
                    "--device", "cpu", "--port", "0", "--top_k", "3",
                    "--batch_size", "4"])
    assert served["names"] == ["a", "b", "c", "d"] and served["port"] == 0
    x = np.random.default_rng(3).normal(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_array_equal(served["predictor"](x)[2], predictor(x)[2])


@pytest.mark.parametrize("aggregation", ["rnn", "temconv"])
def test_from_sweep_serves_rnn_and_temconv_members(aggregation, tmp_path):
    """Deep-ensemble serving of the aggregations whose nets are not the
    TRN: 3 members of a two-layer bidirectional LSTM (run under vmap as
    the plain recurrence) or of temconv, saved as the sweep saves them;
    from_sweep's probabilities are the mean of the members' solo
    Predictors within PROB_TOL."""
    from ta3n_tpu_torch.config import ModelConfig as PortModelConfig
    from ta3n_tpu_torch.io_utils.checkpoint import save_checkpoint
    from ta3n_tpu_torch.io_utils.convert import export_reference_state
    from ta3n_tpu_torch.models import VideoModel

    fields = (dict(frame_aggregation="rnn", rnn_cell="LSTM", n_rnn=2,
                   n_directions=2, n_ts=2) if aggregation == "rnn" else
              dict(frame_aggregation="temconv"))
    cfg = PortModelConfig(num_class=4, baseline_type="video",
                          train_segments=3, val_segments=3, fc_dim=16,
                          feature_dim=16, use_attn="none", dropout_i=0.0,
                          dropout_v=0.0, **fields)
    paths = []
    for k in range(3):
        gen = torch.Generator().manual_seed(30 + k)
        model = VideoModel(cfg, gen, "cpu")
        with torch.no_grad():
            for p in model.parameters():
                bound = (1.0 / np.sqrt(p[0].numel()) if p.dim() >= 2
                         else 0.25)
                p.uniform_(-bound, bound, generator=gen)
        paths.append(save_checkpoint(
            str(tmp_path / "sweep" / f"member_{k:02d}"),
            {"epoch": 1, "arch": "TBN",
             "state_dict": {f"module.{name}": v for name, v in
                            export_reference_state(model).items()}}))
    x = np.random.default_rng(8).normal(size=(6, 3, 16)).astype(np.float32)
    probs = Predictor.from_sweep(str(tmp_path / "sweep"), cfg, device="cpu",
                                 batch_size=4, top_k=3)(x)[0]
    solo = [Predictor.from_checkpoint(p, cfg, device="cpu", batch_size=4,
                                      top_k=3)(x)[0] for p in paths]
    np.testing.assert_allclose(probs, np.mean(solo, axis=0), rtol=0,
                               atol=PROB_TOL)
