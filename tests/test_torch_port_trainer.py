"""PyTorch port, the Trainer (`ta3n_tpu_torch.train.loop`) against the JAX
package's (`ta3n_tpu.train.loop`) on the CPU: the published recipe at small
widths, 2 epochs of 3 steps from the same converted initial weights at
dropout 0, from host features and from device stores: equal per-epoch
val Prec@1, per-step losses within 2e-4 relative, final parameters within
rtol 1e-3, atol 2e-5.  Then resume: the port's Trainer holds exactly what
it saved, and its checkpoint is read by `Predictor.from_checkpoint`."""

import argparse

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


def _trainers(root, device_store, jax_params=None):
    """The JAX Trainer (one device, no mesh) and the port's on the CPU,
    the port's model holding the JAX one's (redrawn) initial weights."""
    jcfg = (JaxModelConfig(**MODEL), JaxDAConfig(**DA),
            JaxTrainConfig(**TRAIN))
    jt = JaxTrainer(*jcfg, *jax_build_loaders(_args(root), jcfg[0],
                                              jcfg[2])[:3],
                    path_exp=str(root / f"jax_{device_store}") + "/",
                    use_mesh=False, device_store=device_store,
                    log_files=JaxLogFiles(str(root / f"jax_{device_store}"),
                                          best_log=str(root / "jbest.log")),
                    print_freq=1)
    params = _redraw(jax.tree_util.tree_map(np.asarray, jt.state.params),
                     np.random.default_rng(0))
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    cfg = (ModelConfig(**MODEL), DAConfig(**DA), TrainConfig(**TRAIN))
    pt = Trainer(*cfg, *build_loaders(_args(root), cfg[0], cfg[2])[:3],
                 path_exp=str(root / f"port_{device_store}") + "/",
                 device_store=device_store, print_freq=1, device="cpu",
                 log_files=LogFiles(str(root / f"port_{device_store}"),
                                    best_log=str(root / "pbest.log")))
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


@pytest.mark.parametrize("kw,item", [
    (dict(steps_per_call=2), "item 4"), (dict(accum_steps=2), "item 8"),
    (dict(store_dtype="bfloat16"), "item 8"),
    (dict(store_budget_rows=10), "item 9"),
    (dict(device_sampler=True), "item 9"), (dict(model_parallel=2), "item 9"),
    (dict(num_devices=2), "item 9"), (dict(tensorboard_dir="tb"), "item 5"),
    (dict(profile_dir="prof"), "item 5"),
])
def test_trainer_unported_options_raise(workspace, kw, item):
    cfg = (ModelConfig(**MODEL), DAConfig(**DA), TrainConfig(**TRAIN))
    with pytest.raises(NotImplementedError, match=f"queue 1, {item}"):
        Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3],
                device="cpu", **kw)


def test_trainer_pretrain_source_raises(workspace):
    cfg = (ModelConfig(**MODEL), DAConfig(**DA, pretrain_source=True),
           TrainConfig(**TRAIN))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3],
                device="cpu")


def test_trainer_runs_on_the_card_by_default(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = (ModelConfig(**MODEL), DAConfig(**DA), TrainConfig(**TRAIN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3])
