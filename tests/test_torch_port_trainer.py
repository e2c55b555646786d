"""PyTorch port, the Trainer (`ta3n_tpu_torch.train.loop`) against the JAX
package's (`ta3n_tpu.train.loop`) on the CPU: the published recipe at small
widths, 2 epochs of 3 steps from the same converted initial weights at
dropout 0, from host features and from device stores: equal per-epoch
val Prec@1, per-step losses within 2e-4 relative, final parameters within
rtol 1e-3, atol 2e-5.  The chunked modes (K steps per call, streamed
stores, the device sampler) the same way over 2 epochs, their printed
meters too.  Then resume: the port's Trainer holds exactly what it saved,
and its checkpoint is read by `Predictor.from_checkpoint`.  With a
tensorboard_dir the Trainer writes the JAX Trainer's embeddings and text
through a recording ``tensorboardX`` (test_torch_port_train_extras.py
holds the writer against the JAX one and the profile_dir window)."""

import argparse
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data.synthetic import make_domain_pair
from ta3n_tpu.io_utils import LogFiles as JaxLogFiles
from ta3n_tpu.train.loop import Trainer as JaxTrainer
from ta3n_tpu.train.loop import build_loaders as jax_build_loaders
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.io_utils.logs import LogFiles
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.serve import Predictor
from ta3n_tpu_torch.train.loop import Trainer, build_loaders

MODEL = dict(num_class=3, baseline_type="video", frame_aggregation="trn-m",
             train_segments=5, val_segments=5, feature_dim=32, fc_dim=32,
             use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
# the published recipe (BASELINE.md:25): uSv, RevGrad at three levels,
# attentive entropy, beta 0.75 0.75 0.5, Nesterov SGD with DANN lr
DA = dict(use_target="uSv", adv_DA="RevGrad",
          add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
TRAIN = dict(lr=0.03, lr_adaptive="dann", batch_size=(8, 6, 8), epochs=2,
             beta=(0.75, 0.75, 0.5), gamma=0.003)
LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)


def _redraw(tree, rng):
    """Every leaf at U(±1/sqrt(fan_in)): outputs far from ties, and steps
    that move the parameters well above the tolerance."""
    out = {}
    for name, sub in tree.items():
        out[name] = {}
        for key, leaf in sub.items():
            fan_in = (sub[key.replace("b_", "w_")].shape[0]
                      if name == "TRN" else sub["kernel"].shape[0])
            bound = 1.0 / np.sqrt(fan_in)
            out[name][key] = rng.uniform(-bound, bound, leaf.shape) \
                .astype(np.float32)
    return out


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Stores of 24 source, 18 target and 12 val videos with their lists:
    3 steps an epoch at batch 8 + 6."""
    root = tmp_path_factory.mktemp("trainer")
    stores = make_domain_pair(num_source=24, num_target=18, num_val=12,
                              num_class=3, feature_dim=32, shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    return root


def _args(root):
    return argparse.Namespace(
        train_source_list=str(root / "src" / "list.txt"),
        train_target_list=str(root / "tgt" / "list.txt"),
        val_list=str(root / "val" / "list.txt"),
        store_source=None, store_target=None, store_val=None)


def _record(trainer, to_float):
    """Wrap the trainer's train step and validate: every step's losses and
    every epoch's val Prec@1."""
    steps, vals = [], []
    step, validate = trainer.train_step, trainer.validate

    def train_step(*a):
        state, m = step(*a)
        steps.append({k: to_float(m[k]) for k in
                      ("loss", "loss_c", "loss_a", "loss_e")})
        return state, m

    def val(epoch):
        vals.append(validate(epoch))
        return vals[-1]

    trainer.train_step, trainer.validate = train_step, val
    return steps, vals


def _loaders(build, args, cfg, shuffle):
    """The loaders of ``build`` (build_loaders of either package), the
    training ones unshuffled unless ``shuffle``."""
    loaders = build(args, cfg[0], cfg[2])[:3]
    for loader in loaders[:2]:
        loader.shuffle = loader.shuffle and shuffle
    return loaders


def _trainers(root, device_store, da=(), train=(), tag="", shuffle=True,
              **kw):
    """The JAX Trainer (one device, no mesh) and the port's on the CPU,
    the port's model holding the JAX one's (redrawn) initial weights.
    ``da`` and ``train`` override fields of DA and TRAIN; ``kw`` goes to
    both Trainers; ``tag`` names their experiment directories; without
    ``shuffle`` the training loaders keep the list's order."""
    da, train = {**DA, **dict(da)}, {**TRAIN, **dict(train)}
    name = f"{device_store}{tag}"
    jcfg = (JaxModelConfig(**MODEL), JaxDAConfig(**da),
            JaxTrainConfig(**train))
    jt = JaxTrainer(*jcfg, *_loaders(jax_build_loaders, _args(root), jcfg,
                                     shuffle),
                    path_exp=str(root / f"jax_{name}") + "/",
                    use_mesh=False, device_store=device_store,
                    log_files=JaxLogFiles(str(root / f"jax_{name}"),
                                          best_log=str(root / "jbest.log")),
                    print_freq=1, **kw)
    params = _redraw(jax.tree_util.tree_map(np.asarray, jt.state.params),
                     np.random.default_rng(0))
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    cfg = (ModelConfig(**MODEL), DAConfig(**da), TrainConfig(**train))
    pt = Trainer(*cfg, *_loaders(build_loaders, _args(root), cfg, shuffle),
                 path_exp=str(root / f"port_{name}") + "/",
                 device_store=device_store, print_freq=1, device="cpu",
                 log_files=LogFiles(str(root / f"port_{name}"),
                                    best_log=str(root / "pbest.log")), **kw)
    pt.state.model.load_state_dict(state_dict_from_jax_params(params))
    return jt, pt


@pytest.mark.parametrize("device_store", [False, True],
                         ids=["host", "device_store"])
def test_trainer_matches_jax(workspace, device_store):
    jt, pt = _trainers(workspace, device_store)
    j_steps, j_vals = _record(jt, lambda v: float(v))
    p_steps, p_vals = _record(pt, lambda v: v.item())
    trn_fused.launches = trn_fused.train_launches = gather_gemm.launches = 0
    j_best, p_best = jt.fit(), pt.fit()
    assert len(p_steps) == len(j_steps) == 6 and len(p_vals) == 2
    for i, (got, want) in enumerate(zip(p_steps, j_steps)):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert p_vals == j_vals and p_best == j_best
    assert pt.lr_current == pytest.approx(jt.lr_current, rel=1e-12)
    assert pt.state.step == int(jt.state.step) == 6
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = pt.state.model.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)
    # the CPU takes the plain versions: no kernel launched
    assert trn_fused.launches == trn_fused.train_launches == 0
    assert gather_gemm.launches == 0
    # the val lines the two write are the same
    for name in ("val_short.log",):
        assert (workspace / f"port_{device_store}" / name).read_text() == \
            (workspace / f"jax_{device_store}" / name).read_text()


def test_resume_restores_what_was_saved(workspace, tmp_path):
    """After fit() with save_model, a new Trainer resumed from
    checkpoint.pth.tar with resume_hp holds bitwise what the first one
    held: parameters, SGD momentum, lr_current, step and best_prec1; it
    starts at the next epoch.  Without resume_hp it keeps a fresh
    optimizer and the configured lr."""
    cfg = (ModelConfig(**MODEL), DAConfig(**DA), TrainConfig(**TRAIN))

    def trainer():
        return Trainer(*cfg, *build_loaders(_args(workspace), cfg[0],
                                            cfg[2])[:3],
                       path_exp=str(tmp_path) + "/", save_model=True,
                       save_attention=1, device_store=True, device="cpu",
                       seed=5)

    first = trainer()
    first.fit()
    ckpt = str(tmp_path / "checkpoint.pth.tar")
    for resume_hp in (True, False):
        again = trainer()
        assert again.resume(ckpt, resume_hp) == 3
        assert again.start_epoch == 3 and again.state.step == 6
        assert again.best_prec1 == first.best_prec1
        for a, b in zip(again.state.model.state_dict().values(),
                        first.state.model.state_dict().values()):
            assert torch.equal(a, b)
        if resume_hp:
            assert again.lr_current == first.lr_current
            mine, theirs = (t.state.optimizer.state_dict()["state"]
                            for t in (again, first))
            assert mine.keys() == theirs.keys() and len(mine) > 0
            for k in mine:
                assert torch.equal(mine[k]["momentum_buffer"],
                                   theirs[k]["momentum_buffer"])
        else:
            assert again.lr_current == TRAIN["lr"]
            assert again.state.optimizer.state_dict()["state"] == {}
    # the attention dumps: one mean row per epoch, of S-1 values
    rows = np.loadtxt(tmp_path / "attn_source_1.log")
    assert rows.shape == (2, 4)
    # the checkpoint serves as it is
    predictor = Predictor.from_checkpoint(
        str(tmp_path / "model_best.pth.tar"), cfg[0], device="cpu",
        batch_size=4)
    feats = np.random.default_rng(0).random((5, 5, 32), np.float32)
    probs, _, _ = predictor(feats)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def _fit_and_compare(jt, pt, updates, param_tol=PARAM_TOL):
    """Fit both Trainers; the port's per-step losses (of the steps the
    train step records), val Prec@1, best, lr, update count and final
    parameters against the JAX Trainer's, at the tolerances above (the
    parameters at ``param_tol``)."""
    j_steps, j_vals = _record(jt, lambda v: float(v))
    p_steps, p_vals = _record(pt, lambda v: v.item())
    j_best, p_best = jt.fit(), pt.fit()
    assert len(p_steps) == len(j_steps) and len(p_vals) == len(j_vals) > 0
    for i, (got, want) in enumerate(zip(p_steps, j_steps)):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert p_vals == j_vals and p_best == j_best
    assert pt.lr_current == pytest.approx(jt.lr_current, rel=1e-12)
    assert pt.state.step == int(jt.state.step) == updates
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = pt.state.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **param_tol)


@pytest.mark.parametrize("kw,device_store,updates", [
    (dict(accum_steps=2), False, 4),
    (dict(store_dtype="bfloat16"), True, 6),
], ids=["accum_steps", "store_dtype"])
def test_trainer_precision_options_match_jax(workspace, kw, device_store,
                                             updates):
    """--accum_steps 2 on host features (each epoch of 3 batch pairs: one
    update from 2 micro-batches, then a plain step on the tail) and a
    bfloat16 device store, against the JAX Trainer with the same option:
    as test_trainer_matches_jax."""
    jt, pt = _trainers(workspace, device_store,
                       tag="_" + "_".join(map(str, kw.values())), **kw)
    if "accum_steps" in kw:
        assert pt.accum_step is not None and jt.accum_step is not None
    _fit_and_compare(jt, pt, updates)


def _meters(path):
    """The numbers of every Train: line of a train.log but its times."""
    lines = [line for line in path.read_text().splitlines()
             if line.startswith("Train:")]
    cut = re.compile(r"Time \S+ \(\S+\)\tData \S+ \(\S+\)")
    return [[float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?",
                                          cut.sub("", line))]
            for line in lines]


@pytest.mark.parametrize("kw,shuffle,epochs", [
    (dict(steps_per_call=3), True, 2),
    (dict(store_budget_rows=80), True, 1),
    (dict(steps_per_call=3, device_sampler=True), False, 2),
], ids=["steps_per_call", "store_budget_rows", "device_sampler"])
def test_trainer_chunked_options_match_jax(workspace, kw, shuffle, epochs):
    """K = 3 steps per call, stores streamed in shards of 80 rows (at
    least 3 shards; one epoch of 6 steps, as many as the others take in
    2), and K = 3 with the device sampler (the training loaders
    unshuffled, where the port's order is the JAX one's), from device
    stores, against the JAX Trainer with the same options: as
    test_trainer_matches_jax, and each printed Train: line's numbers (lr,
    Prec@1, Prec@5, the losses) within LOSS_RTOL or 1e-4 of the JAX
    Trainer's."""
    jt, pt = _trainers(workspace, True, train=dict(epochs=epochs),
                       tag="_" + "_".join(kw), shuffle=shuffle, **kw)
    assert pt.steps_per_call == jt.steps_per_call == kw.get(
        "steps_per_call", 1)
    assert (pt.sampled_step is None) == (jt.sampled_step is None)
    updates = epochs * 3
    if "store_budget_rows" in kw:
        assert pt.streaming and jt.streaming
        assert pt._plan_s.num_shards >= 3
        updates = epochs * min(pt.source_loader.shard_epoch_len(pt._plan_s),
                               pt.target_loader.shard_epoch_len(pt._plan_t))
    _fit_and_compare(jt, pt, updates)
    name = "True_" + "_".join(kw)
    got = _meters(workspace / f"port_{name}" / "train.log")
    want = _meters(workspace / f"jax_{name}" / "train.log")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=1e-4)


@pytest.mark.parametrize("kw,item", [
    (dict(model_parallel=2), "item 9"),
    (dict(num_devices=2), "item 9"),
])
def test_trainer_unported_options_raise(workspace, kw, item):
    cfg = (ModelConfig(**MODEL), DAConfig(**DA), TrainConfig(**TRAIN))
    with pytest.raises(NotImplementedError, match=f"queue 1, {item}"):
        Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3],
                device="cpu", **kw)


class RecordingWriter:
    """A stand-in for tensorboardX's SummaryWriter: records every call."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.calls = []
        RecordingWriter.made.append(self)

    def add_embedding(self, mat, metadata=None, global_step=None, tag=None):
        self.calls.append(("add_embedding", mat.clone(), list(metadata),
                           global_step, tag))

    def add_text(self, tag, text, step):
        self.calls.append(("add_text", tag, text, step))

    def close(self):
        self.calls.append(("close",))


@pytest.fixture
def fake_tensorboardx(monkeypatch):
    """A recording ``tensorboardX`` in sys.modules; yields the writers
    made through it."""
    RecordingWriter.made = []
    module = types.ModuleType("tensorboardX")
    module.SummaryWriter = RecordingWriter
    monkeypatch.setitem(sys.modules, "tensorboardX", module)
    yield RecordingWriter.made


JAX_TAGS = ["train_source", "train_target", "train_DA", "train_DA_labels",
            "validation"]


def _port_trainer(root, batch_size, **kw):
    cfg = (ModelConfig(**MODEL), DAConfig(**DA),
           TrainConfig(**{**TRAIN, "batch_size": batch_size}))
    return Trainer(*cfg, *build_loaders(_args(root), cfg[0], cfg[2])[:3],
                   path_exp=str(root / "exp_tb") + "/", print_freq=10,
                   device="cpu", **kw)


@pytest.mark.parametrize("device_store", [False, True])
def test_trainer_tensorboard_embeddings(workspace, fake_tensorboardx,
                                        device_store):
    """The Trainer with a tensorboard_dir (dropout 0): the JAX tags, each
    epoch's embeddings one row per real video (source batches of 10 pad
    the third to 10 with 4 videos; val batches of 8 the second with 4),
    the validation per batch (no whole-epoch call), one step a call, and
    Prec@1 bitwise the run without tensorboard."""
    sizes = (10, 6, 8)
    plain = _port_trainer(workspace, sizes, device_store=device_store).fit()
    trainer = _port_trainer(workspace, sizes, device_store=device_store,
                            steps_per_call=2,
                            tensorboard_dir=str(workspace / "tb"))
    assert trainer.tb.active and trainer.steps_per_call == 1
    assert trainer.multi_eval_step is None
    assert trainer.fit() == plain
    (writer,) = fake_tensorboardx
    tags = [c[4] if c[0] == "add_embedding" else c[1] for c in writer.calls
            if c[0] != "close"]
    assert tags == (JAX_TAGS + ["Best_Accuracy"]) * 2
    assert writer.calls[-1] == ("close",)
    assert len(trainer.source_loader) == len(trainer.target_loader) == 3
    rows = {c[4]: c[1].shape for c in writer.calls[:5]}
    dim = rows["validation"][1]
    assert rows["train_source"] == (24, dim)
    assert rows["train_target"] == (18, dim)
    assert rows["train_DA"][0] == rows["train_source"][0] + \
        rows["train_target"][0]
    assert rows["validation"] == (len(trainer.val_loader.records), dim)
    assert writer.calls[4][3] == len(trainer.val_loader)  # epoch 1's step


def test_trainer_runs_on_the_card_by_default(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = (ModelConfig(**MODEL), DAConfig(**DA), TrainConfig(**TRAIN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3])
