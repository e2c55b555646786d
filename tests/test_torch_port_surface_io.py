"""PyTorch port, checkpoints and entry points over the model surface
beyond the flagship: the JAX package's reference-format export of every
configuration of tests/test_torch_port_surface_model.py strict-loads into
the port; the port's export (what its Trainer saves) is key for key and
value for value the JAX export, dead parameters included, and imports
back into the JAX package with equal parameters and BN statistics; the
general frame attention, which has no reference name, is refused by
both.  Then the Trainer against the JAX Trainer and the eval CLI against
the JAX eval CLI on the Trainer's model_best.pth.tar, for avgpool and
AdaBN, and the Predictor against the JAX Predictor on a JAX export (CPU,
float32, dropout 0).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_surface_model import (BASE, CONFIGS, jax_weights,
                                           model_fields, port_model)
from ta3n_tpu.cli import test_models as jax_cli
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data.synthetic import make_domain_pair
from ta3n_tpu.io_utils.torch_export import (export_state_dict,
                                            save_torch_checkpoint)
from ta3n_tpu.io_utils.torch_import import (import_torch_state_dict,
                                            load_torch_checkpoint)
from ta3n_tpu.train.loop import Trainer as JaxTrainer
from ta3n_tpu.train.loop import build_loaders as jax_build_loaders
from ta3n_tpu_torch.cli import test_models as port_cli
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.io_utils.convert import (export_reference_state,
                                             load_reference_checkpoint,
                                             state_dict_from_jax_params)
from ta3n_tpu_torch.train.loop import Trainer, build_loaders

EXPORTED = sorted(n for n in CONFIGS if n != "frame_general")
LOSS_RTOL = 2e-4                        # tests/test_torch_port_trainer.py
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)


def _tree_equal(got, want, label):
    assert sorted(got) == sorted(want), label
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_equal(got[k], v, f"{label}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=f"{label}/{k}")


@pytest.mark.parametrize("name", EXPORTED)
def test_jax_export_strict_loads_into_the_port(name, tmp_path):
    fields = model_fields(name)
    _, params, stats = jax_weights(fields)
    path = str(tmp_path / "model.pth.tar")
    save_torch_checkpoint(path, params, stats)
    model = load_reference_checkpoint(path, ModelConfig(**fields), "cpu")
    want = state_dict_from_jax_params(params, stats)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", EXPORTED)
def test_port_export_is_the_jax_export_and_imports_back(name):
    """After one training forward (so that the running stats moved), the
    port's export against the JAX export of the same parameters and
    stats, and through the JAX importer back to them."""
    fields = model_fields(name)
    _, params, stats = jax_weights(fields)
    model = port_model(fields, params, stats)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 5, BASE["feature_dim"])).astype(np.float32))
    model(x[:2], x[2:], (0.5, 0.5, 0.5), 0.0, True)
    ours = export_reference_state(model)
    live = {k: v.numpy() for k, v in model.state_dict().items()}
    if stats:
        stats = {bn: {"mean": live[f"{bn}.running_mean"],
                      "var": live[f"{bn}.running_var"]} for bn in stats}
        assert not np.allclose(stats["bn_shared_S"]["mean"],
                               jax_weights(fields)[2]["bn_shared_S"]["mean"])
    ref = export_state_dict(params, stats)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue  # the JAX BN does not count its batches
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    got_params, got_stats = import_torch_state_dict(ours)
    _tree_equal(got_params, params, "params")
    _tree_equal(got_stats, stats, "batch_stats")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Stores of 24 source, 18 target and 12 val videos with their lists
    and class file: 3 steps an epoch at batch 8 + 6, two val batches of 8
    (the second padded)."""
    root = tmp_path_factory.mktemp("surface_io")
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


def test_general_frame_attention_has_no_reference_name(workspace):
    """The reference has no general frame attention: the JAX export
    refuses it, so do the port's export and a Trainer that is to save,
    before it trains; without saving the Trainer takes it."""
    fields = model_fields("frame_general")
    _, params, stats = jax_weights(fields)
    with pytest.raises(KeyError, match="attn_layer_frame"):
        export_state_dict(params, stats)
    with pytest.raises(KeyError, match="attn_layer_frame"):
        export_reference_state(port_model(fields, params, stats))
    assert "attn_layer_frame.0.weight" in state_dict_from_jax_params(params)
    cfg = (ModelConfig(**fields), DAConfig(**CONFIGS["frame_general"][1]),
           TrainConfig(batch_size=(8, 6, 8)))
    loaders = build_loaders(_args(workspace), cfg[0], cfg[2])[:3]
    with pytest.raises(KeyError, match="attn_layer_frame"):
        Trainer(*cfg, *loaders, save_model=True, device="cpu")
    Trainer(*cfg, *loaders, device="cpu")


def _record(trainer, to_float):
    """Wrap the trainer's train step and validate: every step's losses and
    every epoch's val Prec@1."""
    steps, vals = [], []
    step, validate = trainer.train_step, trainer.validate

    def train_step(*a):
        state, m = step(*a)
        steps.append({k: to_float(v) for k, v in m.items()})
        return state, m

    def val(epoch):
        vals.append(validate(epoch))
        return vals[-1]

    trainer.train_step, trainer.validate = train_step, val
    return steps, vals


@pytest.mark.parametrize("name", ["tempooling_revgrad", "adabn", "mcd"])
def test_trainer_and_eval_cli_match_jax(workspace, name):
    """2 epochs of the JAX Trainer and the port's from the same weights
    (device stores, DANN lr, save_model): per-step losses (MCD's loss_s
    too), val Prec@1, final parameters and BN statistics.  Then the eval
    CLIs of both packages on the port's model_best.pth.tar: the same
    Pred@k line, its Pred@1 the port Trainer's best Prec@1 (MCD's second
    classifier in the checkpoint needs no eval flag)."""
    fields = model_fields(name)
    train = dict(lr=0.03, lr_adaptive="dann", batch_size=(8, 6, 8),
                 epochs=2, beta=(0.75, 0.75, 0.5), gamma=0.003, mu=0.5)
    jcfg = (JaxModelConfig(**fields), JaxDAConfig(**CONFIGS[name][1]),
            JaxTrainConfig(**train))
    jt = JaxTrainer(*jcfg, *jax_build_loaders(_args(workspace), jcfg[0],
                                              jcfg[2])[:3],
                    path_exp=str(workspace / f"jax_{name}") + "/",
                    use_mesh=False, device_store=True, print_freq=1)
    _, params, stats = jax_weights(fields)
    jt.state = jt.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    cfg = (ModelConfig(**fields), DAConfig(**CONFIGS[name][1]),
           TrainConfig(**train))
    exp = workspace / f"port_{name}"
    pt = Trainer(*cfg, *build_loaders(_args(workspace), cfg[0], cfg[2])[:3],
                 path_exp=str(exp) + "/", device_store=True, print_freq=1,
                 save_model=True, device="cpu")
    pt.state.model.load_state_dict(state_dict_from_jax_params(params, stats))
    j_steps, j_vals = _record(jt, float)
    p_steps, p_vals = _record(pt, lambda v: v.item())
    j_best, p_best = jt.fit(), pt.fit()
    assert len(p_steps) == len(j_steps) == 6 and len(p_vals) == 2
    for i, (got, want) in enumerate(zip(p_steps, j_steps)):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert p_vals == j_vals and p_best == j_best
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.batch_stats))
    got = pt.state.model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       err_msg=key, **PARAM_TOL)

    best = str(exp / "model_best.pth.tar")
    _, jstats, _ = load_torch_checkpoint(best)
    assert sorted(jstats) == sorted(stats)
    flags = ["--test_segments", "5", "--fc_dim", str(BASE["fc_dim"]),
             "--feature_dim", str(BASE["feature_dim"]), "--baseline_type",
             "video", "--frame_aggregation", fields["frame_aggregation"],
             "--use_attn", fields["use_attn"], "--use_bn",
             fields.get("use_bn", "none"), "--bS", "8", "--top", "1", "3"]
    argv = [str(workspace / "class.txt"), "RGB",
            str(workspace / "val" / "list.txt"), best, *flags]
    want_line = jax_cli.main(argv)
    for extra in ([], ["--device_store"]):
        line = port_cli.main([*argv, "--device", "cpu", *extra])
        assert line == want_line
        assert float(line.split()[1].rstrip("%")) == \
            pytest.approx(p_best, abs=0.006)


@pytest.mark.parametrize("name", ["tempooling_revgrad", "adabn", "share_n",
                                  "mcd"])
def test_predictor_matches_jax_predictor(name, tmp_path):
    """A JAX export served by the port's Predictor against the JAX
    Predictor on the same parameters and stats: the same probabilities
    and top-k for 7 videos in padded chunks of 4 (BN on its running
    stats, the target layers under share_params N, MCD's classifier
    loaded without a flag)."""
    from ta3n_tpu.serve import Predictor as JaxPredictor
    from ta3n_tpu_torch.serve import Predictor
    fields = model_fields(name)
    _, params, stats = jax_weights(fields)
    path = str(tmp_path / "model.pth.tar")
    save_torch_checkpoint(path, params, stats)
    feats = np.random.default_rng(8).normal(
        size=(7, 5, BASE["feature_dim"])).astype(np.float32)
    want = JaxPredictor(JaxModelConfig(**fields), params, stats,
                        batch_size=4, top_k=3)(feats)
    cfg = {k: v for k, v in fields.items() if k != "ens_DA"}
    got = Predictor.from_checkpoint(path, ModelConfig(**cfg), device="cpu",
                                    batch_size=4, top_k=3)(feats)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
