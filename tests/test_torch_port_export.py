"""PyTorch port, AOT artifacts (``Predictor.export`` / ``from_exported``)
on the CPU: a float32 artifact of the flagship-shaped model at narrow
widths, an int8 one at JAX's ``QCFG`` widths (256-d) and a 2-member
ensemble's, each answering as the live port Predictor and as the JAX
package's artifact of the same weights (``jax.export``), within PROB_TOL,
with the same top class; meta.json with the JAX artifact's keys; a
loaded artifact refusing to export again and devices it was not exported
for; ``cli.serve --export`` then serving the artifact; and the three
artifacts loaded and run in a process where ``import ta3n_tpu_torch``
raises (no model code).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.io_utils.torch_export import save_torch_checkpoint
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.serve import Predictor as JaxPredictor
from ta3n_tpu_torch.cli import serve as cli_serve
from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.serve import Predictor

SMALL = dict(num_class=4, baseline_type="video", frame_aggregation="trn-m",
             train_segments=3, val_segments=3, fc_dim=16, feature_dim=16,
             use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
WIDE = dict(SMALL, num_class=6, fc_dim=256, feature_dim=256,
            quantize="int8")
BATCH, TOP_K = 4, 3
PROB_TOL = 1e-5   # tests/test_torch_port_serve.py
META_KEYS = {"model_cfg", "batch_size", "top_k", "platforms", "input_shape",
             "n_members"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU ops, as in the
    heaviest port test files (tests/test_torch_port_ensemble.py); the
    previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(fields, seed):
    """JAX parameters at a trained-like scale (matrices U(±1/sqrt(fan_in))
    x4, vectors U(±0.25)), so that the top class is not decided by
    rounding."""
    model = JaxVideoModel(JaxModelConfig(**fields))
    x = jnp.zeros((BATCH, 3, fields["feature_dim"]), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), x, x, jnp.zeros(3), jnp.asarray(0.0), False,
        False))["params"]
    rng = np.random.default_rng(seed)

    def redraw(leaf):
        bound = 4.0 / np.sqrt(leaf.shape[0]) if leaf.ndim == 2 else 0.25
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(redraw, shapes)


def _port(fields, params):
    model = VideoModel(ModelConfig(**fields))
    model.load_state_dict(state_dict_from_jax_params(params, {}))
    return model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """kind -> (live port Predictor, its artifact dir, the JAX artifact's
    answers on the kind's input x, x)."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for kind, fields, seeds in (("f32", SMALL, (0,)), ("int8", WIDE, (1,)),
                                ("members", SMALL, (2, 3))):
        params = [_jax_params(fields, s) for s in seeds]
        models = [_port(fields, p) for p in params]
        n = len(models) if len(models) > 1 else 0
        live = Predictor(ModelConfig(**fields),
                         models if n else models[0], batch_size=BATCH,
                         top_k=TOP_K, device="cpu", n_members=n)
        path = live.export(str(root / kind))
        tree = (jax.tree_util.tree_map(lambda *ls: np.stack(ls), *params)
                if n else params[0])
        jax_live = JaxPredictor(JaxModelConfig(**fields), tree,
                                batch_size=BATCH, top_k=TOP_K, n_members=n)
        jax_live.export(str(root / f"jax_{kind}"), platforms=("cpu",))
        x = np.random.default_rng(5).normal(
            size=(6, 3, fields["feature_dim"])).astype(np.float32)
        want = JaxPredictor.from_exported(str(root / f"jax_{kind}"))(x)
        out[kind] = (live, path, want, x)
    return out


@pytest.mark.parametrize("kind", ["f32", "int8", "members"])
def test_artifact_answers_as_live_and_jax(artifacts, kind):
    """Six videos at batch 4 (two calls of the program, the second
    padded): the artifact's answers, the live Predictor's and the JAX
    artifact's; meta.json carries JAX's keys, its model_cfg JAX's
    ModelConfig fields (quantize among them)."""
    live, path, (want_p, want_tp, want_ti), x = artifacts[kind]
    served = Predictor.from_exported(path, device="cpu")
    assert served.model is None and served.batch_size == BATCH
    probs, top_p, top_i = served(x)
    live_p, live_tp, live_ti = live(x)
    np.testing.assert_allclose(probs, live_p, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(top_p, live_tp, rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(top_i, live_ti)
    np.testing.assert_allclose(probs, want_p, rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(top_i[:, 0], np.asarray(want_ti)[:, 0])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(os.path.dirname(path), f"jax_{kind}",
                           "meta.json")) as f:
        jax_meta = json.load(f)
    assert set(meta) == set(jax_meta) == META_KEYS
    assert set(meta["model_cfg"]) == set(jax_meta["model_cfg"])
    assert meta["model_cfg"]["quantize"] == ("int8" if kind == "int8"
                                             else "none")
    assert meta["n_members"] == jax_meta["n_members"]
    assert meta["input_shape"] == jax_meta["input_shape"]
    assert served.cfg == live.cfg


def test_loaded_artifact_refusals(artifacts, tmp_path):
    """An artifact's Predictor refuses to export again (JAX serve.py:
    121-123) and a device it was not exported for; export refuses an
    unknown platform.  (mesh= is tests/test_torch_port_parallel.py's.)"""
    live, path, _, _ = artifacts["f32"]
    served = Predictor.from_exported(path, device="cpu")
    with pytest.raises(ValueError, match="re-export from the checkpoint"):
        served.export(str(tmp_path / "again"))
    cpu_only = live.export(str(tmp_path / "cpu_only"), platforms=["cpu"])
    with pytest.raises(ValueError, match="exported for"):
        Predictor.from_exported(cpu_only, device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        live.export(str(tmp_path / "tpu"), platforms=["tpu"])
    assert Predictor.is_exported(path) and not Predictor.is_exported(
        str(tmp_path))


def test_cli_export_then_serve(tmp_path, monkeypatch):
    """``cli.serve CLASS CKPT ... --export DIR`` writes the artifact and
    exits; ``cli.serve CLASS DIR`` serves it with the model flags of its
    meta.json (the CLI's own ignored), answering as the live Predictor."""
    params = _jax_params(SMALL, 7)
    ckpt = str(tmp_path / "model.pth.tar")
    save_torch_checkpoint(ckpt, params)
    classes = tmp_path / "classes.txt"
    classes.write_text("0 a\n1 b\n2 c\n3 d\n")
    served = {}
    monkeypatch.setattr(cli_serve, "run_http_server",
                        lambda p, names, host, port: served.update(
                            predictor=p, names=names))
    flags = ["--feature_dim", "16", "--fc_dim", "16", "--test_segments", "3",
             "--device", "cpu", "--batch_size", "4", "--top_k", "3"]
    art = str(tmp_path / "art")
    cli_serve.main([str(classes), ckpt, *flags, "--export", art,
                    "--export_platforms", "cpu"])
    assert "predictor" not in served and Predictor.is_exported(art)
    cli_serve.main([str(classes), art, "--device", "cpu", "--fc_dim", "99"])
    got = served["predictor"]
    assert got.model is None and served["names"] == ["a", "b", "c", "d"]
    x = np.random.default_rng(8).normal(size=(5, 3, 16)).astype(np.float32)
    live = Predictor(ModelConfig(**SMALL), _port(SMALL, params),
                     batch_size=4, top_k=3, device="cpu")
    np.testing.assert_allclose(got(x)[0], live(x)[0], rtol=0,
                               atol=PROB_TOL)


_NO_PACKAGE = """
import sys
import numpy as np
import torch
sys.modules["ta3n_tpu_torch"] = None
try:
    import ta3n_tpu_torch
except ImportError:
    pass
else:
    raise SystemExit("ta3n_tpu_torch imported")
for path, x, out in zip(sys.argv[1::3], sys.argv[2::3], sys.argv[3::3]):
    program = torch.export.load(path).module()
    with torch.no_grad():
        probs, top_p, top_i = program(torch.from_numpy(np.load(x)))
    np.savez(out, probs=probs.numpy(), top_i=top_i.numpy())
"""


def test_artifacts_load_without_the_package(artifacts, tmp_path):
    """Each artifact's program, loaded with torch.export.load in a process
    where importing ta3n_tpu_torch raises, answers a batch as its live
    Predictor does."""
    argv = []
    for kind, (live, path, _, x) in artifacts.items():
        np.save(tmp_path / f"{kind}_x.npy", x[:BATCH])
        argv += [os.path.join(path, "predict.pt2"),
                 str(tmp_path / f"{kind}_x.npy"),
                 str(tmp_path / f"{kind}_out.npz")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", _NO_PACKAGE, *argv], check=True,
                   cwd=str(tmp_path), env=env, timeout=300)
    for kind, (live, _, _, x) in artifacts.items():
        got = np.load(tmp_path / f"{kind}_out.npz")
        probs, _, top_i = live(x[:BATCH])
        np.testing.assert_allclose(got["probs"], probs, rtol=0,
                                   atol=PROB_TOL)
        np.testing.assert_array_equal(got["top_i"], top_i)
