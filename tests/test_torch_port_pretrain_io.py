"""PyTorch port, the entry points and checkpoints over the surface that
PR 8 adds: the Trainer with ``pretrain_source`` (a classification-only
step before each train step, two updates a batch on one momentum buffer)
and JAN against the JAX Trainer, per-step losses, val Prec@1 and the
parameters after the epoch; the eval CLI with its default
``--baseline_type frame`` against the JAX eval CLI; the Predictor over
frame logits against the JAX Predictor; and the checkpoints of RNN and
temconv models: a JAX export (the reference's format, dead modules
included) strict-loads into the port, and the port's export is the JAX
export key for key and imports back into the JAX package (CPU, float32,
dropout 0).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_aggregation import AVGPOOL, BASE, jax_weights
from test_torch_port_surface_io import _record, _tree_equal
from test_torch_port_train import LOSS_RTOL, PARAM_TOL
from ta3n_tpu.cli import test_models as jax_cli
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data.synthetic import make_domain_pair
from ta3n_tpu.io_utils.torch_export import (export_state_dict,
                                            save_torch_checkpoint)
from ta3n_tpu.io_utils.torch_import import import_torch_state_dict
from ta3n_tpu.serve import Predictor as JaxPredictor
from ta3n_tpu.train.loop import Trainer as JaxTrainer
from ta3n_tpu.train.loop import build_loaders as jax_build_loaders
from ta3n_tpu_torch.cli import test_models as port_cli
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.io_utils.convert import (export_reference_state,
                                             load_reference_checkpoint,
                                             state_dict_from_jax_params)
from ta3n_tpu_torch.serve import Predictor
from ta3n_tpu_torch.train.loop import Trainer, build_loaders

# the eval CLI's defaults: the frame baseline over avgpool, no attention
FRAME_DEFAULT = {**BASE, "baseline_type": "frame", **AVGPOOL}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Stores of 24 source, 18 target and 12 val videos with their lists
    and class file: 3 steps an epoch at batch 8 + 6."""
    root = tmp_path_factory.mktemp("pretrain_io")
    stores = make_domain_pair(num_source=24, num_target=18, num_val=12,
                              num_class=5, feature_dim=BASE["feature_dim"],
                              shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    with open(root / "class.txt", "w") as f:
        for i in range(BASE["num_class"]):
            f.write(f"{i} class_{i}\n")
    return root


def _args(root):
    return argparse.Namespace(
        train_source_list=str(root / "src" / "list.txt"),
        train_target_list=str(root / "tgt" / "list.txt"),
        val_list=str(root / "val" / "list.txt"),
        store_source=None, store_target=None, store_val=None)


def test_pretrain_source_trainer_matches_jax(workspace):
    """An epoch of each Trainer from the same weights, from the device
    stores, with pretrain_source, JAN and RevGrad at the frame level:
    the train step's losses (loss_d among them) at every step, the val
    Prec@1, and every parameter after the epoch's six updates, those of
    the domain heads too, which the classification-only step leaves to
    coast on their momentum, as the JAX optimizer does."""
    fields = {**BASE, **AVGPOOL}
    da = dict(use_target="uSv", dis_DA="JAN", adv_DA="RevGrad",
              place_adv=("N", "N", "Y"), pretrain_source=True)
    train = dict(lr=0.03, lr_adaptive="dann", batch_size=(8, 6, 8),
                 epochs=1, beta=(0.75, 0.75, 0.5), alpha=0.5)
    jcfg = (JaxModelConfig(**fields), JaxDAConfig(**da),
            JaxTrainConfig(**train))
    jt = JaxTrainer(*jcfg, *jax_build_loaders(_args(workspace), jcfg[0],
                                              jcfg[2])[:3],
                    path_exp=str(workspace / "jax_pre") + "/",
                    use_mesh=False, device_store=True, print_freq=1)
    _, params, stats = jax_weights(fields)
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    cfg = (ModelConfig(**fields), DAConfig(**da), TrainConfig(**train))
    pt = Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3],
                 path_exp=str(workspace / "port_pre") + "/",
                 device_store=True, print_freq=1, device="cpu")
    pt.state.model.load_state_dict(state_dict_from_jax_params(params))
    j_steps, j_vals = _record(jt, float)
    p_steps, p_vals = _record(pt, lambda v: v.item())
    assert jt.fit() == pt.fit()
    assert len(p_steps) == len(j_steps) == 3 and p_vals == j_vals
    for i, (got, want) in enumerate(zip(p_steps, j_steps)):
        assert sorted(got) == sorted(want)
        assert "loss_d" in got
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert pt.state.step == 6   # two updates a batch
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.state.params))
    got = pt.state.model.state_dict()
    assert sorted(got) == sorted(want)
    start = state_dict_from_jax_params(params)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, **PARAM_TOL)
    # the frame-level domain head moved in the train steps only, and on
    # its momentum in the classification-only steps
    assert not torch.equal(got["fc_classifier_domain.weight"],
                           start["fc_classifier_domain.weight"])


def test_eval_cli_default_baseline_matches_jax(workspace):
    """Both eval CLIs with no --baseline_type (frame, the default) and no
    --frame_aggregation (avgpool) on the JAX export of a frame-baseline
    model: the same Pred@k line, from host features and from the store,
    and the saved scores."""
    _, params, stats = jax_weights(FRAME_DEFAULT)
    weights = str(workspace / "frame.pth.tar")
    save_torch_checkpoint(weights, params, stats)
    argv = [str(workspace / "class.txt"), "RGB",
            str(workspace / "val" / "list.txt"), weights,
            "--test_segments", "5", "--fc_dim", str(BASE["fc_dim"]),
            "--feature_dim", str(BASE["feature_dim"]), "--bS", "4",
            "--top", "1", "3"]
    want_line = jax_cli.main([*argv, "--save_scores",
                              str(workspace / "jax_scores")])
    for extra in ([], ["--device_store"]):
        line = port_cli.main([*argv, "--device", "cpu", "--save_scores",
                              str(workspace / "port_scores"), *extra])
        assert line == want_line
        got = np.load(workspace / "port_scores.npz")
        want = np.load(workspace / "jax_scores.npz")
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["labels"], want["labels"])


@pytest.mark.parametrize("fields", [
    FRAME_DEFAULT, {**FRAME_DEFAULT, "frame_aggregation": "trn-m",
                    "use_attn": "TransAttn"},
    {**BASE, "baseline_type": "tsn", **AVGPOOL}],
    ids=["frame-avgpool", "frame-trn-m", "tsn-avgpool"])
def test_predictor_matches_jax_predictor(fields, tmp_path):
    """A JAX export served by the port's Predictor against the JAX
    Predictor: 7 videos in padded chunks of 4, the frame logits averaged
    over the segments."""
    _, params, stats = jax_weights(fields)
    path = str(tmp_path / "model.pth.tar")
    save_torch_checkpoint(path, params, stats)
    feats = np.random.default_rng(8).normal(
        size=(7, 5, BASE["feature_dim"])).astype(np.float32)
    want = JaxPredictor(JaxModelConfig(**fields), params, stats,
                        batch_size=4, top_k=3)(feats)
    got = Predictor.from_checkpoint(path, ModelConfig(**fields),
                                    device="cpu", batch_size=4,
                                    top_k=3)(feats)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


CKPT_CONFIGS = {
    "rnn-lstm-bi-2": dict(frame_aggregation="rnn", rnn_cell="LSTM",
                          n_rnn=2, n_directions=2, n_ts=3, use_attn="none"),
    "rnn-gru": dict(frame_aggregation="rnn", rnn_cell="GRU", n_ts=2,
                    use_attn="none"),
    "temconv": dict(frame_aggregation="temconv", use_attn="none"),
    "temconv-adabn": dict(frame_aggregation="temconv", use_bn="AdaBN",
                          use_attn="none"),
    "frame-trn-m": dict(baseline_type="frame"),
}


@pytest.mark.parametrize("name", sorted(CKPT_CONFIGS))
def test_checkpoints_both_ways(name, tmp_path):
    """The JAX export (reference format: module. prefix, the dead
    modules, temconv's bn_1 pair dead without BN) strict-loads into the
    port with the same tensors; after a training forward the port's
    export is the JAX export of the same parameters and statistics, dead
    modules included, and imports back into the JAX package."""
    fields = {**BASE, **CKPT_CONFIGS[name]}
    _, params, stats = jax_weights(fields)
    path = str(tmp_path / "model.pth.tar")
    save_torch_checkpoint(path, params, stats)
    model = load_reference_checkpoint(path, ModelConfig(**fields), "cpu")
    want = state_dict_from_jax_params(params, stats)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    saved = torch.load(path, weights_only=True)["state_dict"]
    if fields["frame_aggregation"] == "temconv":
        assert "module.bn_1_S.weight" in saved   # dead without BN
        assert "module.tcl_5_2.conv2d.weight" in saved
    if fields["frame_aggregation"] == "rnn":
        assert "module.bn_before_rnn.running_var" in saved

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 5, BASE["feature_dim"])).astype(np.float32))
    model(x[:2], x[2:], (0.5, 0.5, 0.5), 0.0, True)
    ours = export_reference_state(model)
    live = {k: v.numpy() for k, v in model.state_dict().items()}
    stats = {bn: {"mean": live[f"{bn}.running_mean"],
                  "var": live[f"{bn}.running_var"]} for bn in stats}
    ref = export_state_dict(params, stats)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                          err_msg=k)
    got_params, got_stats = import_torch_state_dict(ours)
    _tree_equal(got_params, params, "params")
    _tree_equal(got_stats, stats, "batch_stats")
