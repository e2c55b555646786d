"""PyTorch port, the Trainer's extras on the CPU: the ``profile_dir``
window (a ``torch.profiler`` trace of steps 2-7 of the first epoch, or of
the second K-step call, and the JAX Trainer's warning when a K-step run
makes fewer than two calls), the tensorboard writer
(`io_utils/tensorboard.py`) held against the JAX package's call for call
through a recording ``tensorboardX``, and the train step's video-level
features against the JAX step's.  The Trainer's embeddings are
test_torch_port_trainer.py's."""

import json
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data.synthetic import make_domain_pair
from ta3n_tpu.io_utils.tensorboard import EmbeddingWriter as JaxWriter
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.io_utils.tensorboard import EmbeddingWriter
from ta3n_tpu_torch.train import StepScalars, make_train_step
from ta3n_tpu_torch.train.loop import Trainer, build_loaders
from test_torch_port_train import (B_S, B_T, DA as STEP_DA, LR0,
                                   MODEL as STEP_MODEL, _batch, _port_state,
                                   _redraw, _scalars)
from test_torch_port_trainer import (DA, MODEL, TRAIN, RecordingWriter,
                                     _args, fake_tensorboardx)

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Stores of 24 source, 18 target and 12 val videos with their lists:
    3 steps an epoch at batch 8 + 6."""
    root = tmp_path_factory.mktemp("train_extras")
    stores = make_domain_pair(num_source=24, num_target=18, num_val=12,
                              num_class=3, feature_dim=32, shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    return root


def _trainer(root, epochs=1, batch_size=TRAIN["batch_size"], **kw):
    cfg = (ModelConfig(**MODEL), DAConfig(**DA),
           TrainConfig(**{**TRAIN, "epochs": epochs,
                          "batch_size": batch_size}))
    return Trainer(*cfg, *build_loaders(_args(root), cfg[0], cfg[2])[:3],
                   path_exp=str(root / "exp") + "/", print_freq=10,
                   device="cpu", **kw)


def _trace_events(directory):
    """The events of the one Chrome trace written into ``directory``."""
    files = sorted(p for p in directory.iterdir()
                   if p.name.endswith(".pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


@pytest.mark.parametrize("kw,window", [
    (dict(), "steps 2-7"),
    (dict(device_store=True, steps_per_call=2), "second call"),
])
def test_profile_dir_writes_a_trace(workspace, tmp_path, kw, window,
                                    monkeypatch):
    """A CPU Trainer with profile_dir writes one trace: from step 2 to the
    end of the 3-step first epoch on the single-step path, of the second
    call (steps 2 and 3 of the first epoch) on the K-step path; the
    second epoch adds none, and no profiler is left running."""
    trainer = _trainer(workspace, epochs=2, profile_dir=str(tmp_path), **kw)
    calls = []
    step = trainer.multi_step or trainer.train_step
    monkeypatch.setattr(trainer, "multi_step" if trainer.multi_step
                        else "train_step",
                        lambda *a: calls.append(trainer._profiler is not None)
                        or step(*a))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.fit()
    assert not [w for w in caught if "--profile_dir" in str(w.message)]
    assert trainer._profiler is None
    # which calls ran inside the window
    assert calls == ([False, False, True, False, False, False]
                     if window == "steps 2-7" else [False, True, False, False])
    events = _trace_events(tmp_path)
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_profile_dir_warns_below_two_calls(workspace, tmp_path):
    """One K-step call in the whole run (K = 4 > 3 steps): the JAX
    Trainer's warning, and no trace."""
    trainer = _trainer(workspace, profile_dir=str(tmp_path),
                       device_store=True, steps_per_call=4)
    with pytest.warns(UserWarning, match="--profile_dir produced no trace: "
                      "the run dispatched only 1 chunk"):
        trainer.fit()
    assert list(tmp_path.iterdir()) == []


def test_profiler_stops_on_an_exception(workspace, tmp_path, monkeypatch):
    """A step that raises inside the window leaves no profiler running
    (the next one starts), and the trace of the window is written."""
    trainer = _trainer(workspace, profile_dir=str(tmp_path))
    step = trainer.train_step

    def failing(*a):
        if trainer._profiler is not None:
            raise RuntimeError("step failed")
        return step(*a)

    monkeypatch.setattr(trainer, "train_step", failing)
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.fit()
    assert trainer._profiler is None
    assert _trace_events(tmp_path)
    with torch.profiler.profile() as prof:  # no profiler left active
        torch.ones(2).sum()
    assert prof.key_averages()


def _writer_calls(writer_cls, rng):
    """The recorded calls of a writer of ``writer_cls`` fed the same
    batches, epoch, validation and best text."""
    writer = writer_cls("logdir")
    assert writer.active
    for _ in range(3):
        b_s, b_t = 8, 6
        writer.collect(rng.normal(size=(b_s, 4)).astype(np.float32),
                       rng.integers(0, 12, b_s),
                       rng.normal(size=(b_t, 4)).astype(np.float32),
                       rng.integers(0, 12, b_t),
                       (rng.random(b_s) > 0.25).astype(np.float32),
                       (rng.random(b_t) > 0.25).astype(np.float32))
    writer.write_epoch(9)
    writer.write_epoch(10)  # nothing collected: nothing written
    writer.write_val_embedding(rng.normal(size=(5, 4)).astype(np.float32),
                               rng.integers(0, 12, 5), 12)
    writer.write_best_text(61.25, 2)
    writer.close()
    return RecordingWriter.made[-1].calls


def test_writer_matches_jax_call_for_call(fake_tensorboardx):
    ours = _writer_calls(EmbeddingWriter, np.random.default_rng(3))
    ref = _writer_calls(JaxWriter, np.random.default_rng(3))
    assert [c[0] for c in ours] == ["add_embedding"] * 5 + ["add_text",
                                                             "close"]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b) and a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y)
            else:
                assert x == y


def test_writer_is_a_no_op_without_tensorboardx(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    for cls in (EmbeddingWriter, JaxWriter):
        writer = cls("logdir")
        assert not writer.active
        writer.collect(np.ones((2, 3)), np.zeros(2), np.ones((1, 3)),
                       np.zeros(1))
        writer.write_epoch(0)
        writer.write_best_text(1.0, 1)
        writer.close()


def _jax_step():
    """The JAX step with return_aux and its state at test_torch_port_train.py's
    redrawn weights (their shapes by ``jax.eval_shape``: no init
    compile), and those weights."""
    jcfg = JaxModelConfig(**STEP_MODEL)
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, B_S))
    jmodel = JaxVideoModel(jcfg)
    d = jcfg.input_feature_dim
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": key, "dropout": key},
                            jnp.zeros((B_S, 5, d)), jnp.zeros((B_T, 5, d)),
                            jnp.zeros(3), jnp.asarray(0.0), True,
                            False))["params"]
    params = _redraw(jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, np.float32), shapes),
        np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxTrainState(jparams, {}, _build_tx(jtc).init(jparams),
                          jnp.asarray(0, jnp.int32))
    return state, jax_make_train_step(jmodel, JaxDAConfig(**STEP_DA), jtc,
                                      return_aux=True), params


def test_step_features_match_jax():
    """return_aux: the step's feat_s and feat_t (and attention values)
    are the JAX step's aux at f32 tolerance, over two steps from the same
    converted weights (test_torch_port_train.py's flagship fixture)."""
    jstate, jstep, params = _jax_step()
    state, _ = _port_state(params)
    step = make_train_step(state.model, DAConfig(**STEP_DA),
                           TrainConfig(lr=LR0), return_aux=True)
    for i in range(2):
        batch = _batch(seed=10 + i)
        beta, mu, alpha, gamma, lr = _scalars(i)
        jstate, want = jstep(jstate, *batch, JaxStepScalars(
            np.asarray(beta, np.float32), np.float32(mu), np.float32(alpha),
            np.float32(gamma), np.float32(lr)), jax.random.PRNGKey(0))
        state, got = step(state, *batch,
                          StepScalars(beta, mu, alpha, gamma, lr), None)
        for key in ("feat_s", "feat_t", "attn_s", "attn_t"):
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=2e-4,
                                       atol=2e-5, err_msg=key)
    assert got["feat_s"].shape[0] == B_S and got["feat_t"].shape[0] == B_T
