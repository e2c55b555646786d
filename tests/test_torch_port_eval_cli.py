"""PyTorch port, the eval CLI (`ta3n_tpu_torch.cli.test_models`) against the
JAX package's (`ta3n_tpu.cli.test_models`) on one synthetic store and one
`.pth.tar` exported from JAX parameters (`save_torch_checkpoint`), from
host features and with `--device_store`, on the CPU: the same `Pred@k`
line and per-class top-K file, scores and attention within 1e-5, also
with the store streamed in shards, and with --quantize int8.  Flags whose
path is not ported raise, naming their ROADMAP.md item."""

import jax
import numpy as np
import pytest
import torch

from ta3n_tpu.cli import test_models as jax_cli
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data.synthetic import make_synthetic_store
from ta3n_tpu.io_utils.torch_export import save_torch_checkpoint
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu_torch.cli import test_models as port_cli
from ta3n_tpu_torch.ops import gather_gemm, trn_fused

NUM_CLASS, D, FC, S = 4, 32, 32, 5
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_FLAGS = ["--test_segments", str(S), "--fc_dim", str(FC),
               "--feature_dim", str(D), "--baseline_type", "video",
               "--frame_aggregation", "trn-m", "--use_attn", "TransAttn",
               "--bS", "8", "--top", "1", "3"]


def _redraw(tree, rng):
    """Every leaf at U(±1/sqrt(fan_in)), so that the logits are far from
    uniform (the normal(0.001) init would tie them)."""
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
    """A val store of 21 videos (the last batch of 8 padded), its list and
    class files, and a .pth.tar of random JAX parameters."""
    root = tmp_path_factory.mktemp("eval_cli")
    store = make_synthetic_store(21, NUM_CLASS, D, seed=3, prefix="val")
    store.save(str(root / "val"))
    with open(root / "val" / "list.txt", "w") as f:
        # listed out of path order, so that --save_scores reorders
        for r in reversed(store.records()):
            f.write(f"{r.path} {r.num_frames} {r.label}\n")
    with open(root / "class.txt", "w") as f:
        for i in range(NUM_CLASS):
            f.write(f"{i} class_{i}\n")
    cfg = JaxModelConfig(num_class=NUM_CLASS, baseline_type="video",
                         frame_aggregation="trn-m", train_segments=S,
                         val_segments=S, feature_dim=D, fc_dim=FC,
                         use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
    init = jax_create_train_state(JaxVideoModel(cfg), jax.random.PRNGKey(0),
                                  8, 8, JaxTrainConfig())
    params = _redraw(jax.tree_util.tree_map(np.asarray, init.params),
                     np.random.default_rng(0))
    save_torch_checkpoint(str(root / "model.pth.tar"), params, epoch=7,
                          prec1=12.5)
    return root


def _run(main, root, tag, *extra):
    out = root / tag
    line = main([str(root / "class.txt"), "RGB",
                 str(root / "val" / "list.txt"), str(root / "model.pth.tar"),
                 *MODEL_FLAGS, "--save_scores", str(out) + "_scores",
                 "--save_confusion", str(out) + "_conf",
                 "--save_attention", str(out) + "_attn", *extra])
    scores = np.load(str(out) + "_scores.npz")
    return (line, scores["scores"], scores["labels"],
            np.loadtxt(str(out) + "_attn.txt"),
            (root / f"{tag}_conf-top[1, 3].txt").read_text())


@pytest.fixture(scope="module")
def jax_outputs(workspace):
    return _run(jax_cli.main, workspace, "jax")


@pytest.mark.parametrize("device_store", [False, True],
                         ids=["host", "device_store"])
def test_eval_cli_matches_jax(workspace, jax_outputs, device_store):
    trn_fused.launches = gather_gemm.launches = 0
    tag = "port_store" if device_store else "port_host"
    got = _run(port_cli.main, workspace, tag, "--device", "cpu",
               *(["--device_store"] if device_store else []))
    line, scores, labels, attn, per_class = got
    want_line, want_scores, want_labels, want_attn, want_per_class = \
        jax_outputs
    assert line == want_line and line.startswith("Pred@1 ")
    assert per_class == want_per_class
    np.testing.assert_array_equal(labels, want_labels)
    assert scores.shape == (21, NUM_CLASS)
    np.testing.assert_allclose(scores, want_scores, **TOL)
    np.testing.assert_allclose(scores.sum(1), 1.0, atol=1e-5)
    assert attn.shape == (21, S - 1)
    np.testing.assert_allclose(attn, want_attn, **TOL)
    # the CPU runs the kernels' plain versions: nothing launched
    assert trn_fused.launches == gather_gemm.launches == 0


def test_eval_cli_max_num(workspace):
    """--max_num stops at the batch that reaches it, which it keeps whole,
    as the JAX CLI does: 16 videos for a cap of 10 in batches of 8."""
    want = _run(jax_cli.main, workspace, "jax_max", "--max_num", "10")
    for device_store in ([], ["--device_store"]):
        got = _run(port_cli.main, workspace, "max", "--device", "cpu",
                   "--max_num", "10", *device_store)
        assert got[1].shape == (16, NUM_CLASS) and got[3].shape[0] == 16
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.mark.parametrize("store_dtype", ["bfloat16", "int8"])
def test_eval_cli_store_dtype_matches_jax(workspace, store_dtype):
    """``--device_store --store_dtype``: the store on the device in
    bfloat16, or quantized to int8 on the host, against the JAX eval CLI
    with the same flags: the same Pred@k line, per-class accuracies and
    labels, scores and attention within TOL."""
    flags = ("--device_store", "--store_dtype", store_dtype)
    want = _run(jax_cli.main, workspace, f"jax_{store_dtype}", *flags)
    got = _run(port_cli.main, workspace, f"port_{store_dtype}", "--device",
               "cpu", *flags)
    assert got[0] == want[0] and got[4] == want[4]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[3], want[3], **TOL)


@pytest.mark.parametrize("budget", ["40"])
def test_eval_cli_streamed_matches_jax(workspace, jax_outputs, budget):
    """``--device_store --store_budget_rows 40``: the store on the device
    in shards (at least 3), the next uploaded while one is evaluated.
    Against the JAX eval CLI with the same flags: the same Pred@k line
    and per-class accuracies; the scores, labels and attention, which
    the port puts back in the list's order, bitwise those of the port's
    resident --device_store run and within TOL of the JAX CLI's resident
    outputs."""
    from ta3n_tpu_torch.data import FeatureStore
    from ta3n_tpu_torch.data.streaming import ShardPlan
    store = FeatureStore.load(str(workspace / "val"))
    assert ShardPlan(store.offsets, int(budget)).num_shards >= 3
    flags = ("--device_store", "--store_budget_rows", budget)
    want = _run(jax_cli.main, workspace, "jax_streamed", *flags)
    got = _run(port_cli.main, workspace, "port_streamed", "--device",
               "cpu", *flags)
    resident = _run(port_cli.main, workspace, "port_resident", "--device",
                    "cpu", "--device_store")
    assert got[0] == want[0] == jax_outputs[0] and got[4] == want[4]
    for a, b in zip(got[1:4], resident[1:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], jax_outputs[2])
    np.testing.assert_allclose(got[1], jax_outputs[1], **TOL)
    np.testing.assert_allclose(got[3], jax_outputs[3], **TOL)


@pytest.mark.parametrize("flags,item", [
    (["--quantize", "int8"], None),
])
def test_eval_cli_unported_flags_raise(workspace, flags, item):
    """--quantize int8 is ported: the JAX CLI's --quantize int8 Pred@k line,
    scores and attention (at the workspace's widths the TRN's 256-wide
    bottleneck is quantized: the relation heads' first layers and the
    video domain FC)."""
    want = _run(jax_cli.main, workspace, "jax_int8", *flags)
    got = _run(port_cli.main, workspace, "port_int8", "--device", "cpu",
               *flags)
    assert got[0] == want[0] and got[4] == want[4]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[3], want[3], **TOL)


def test_eval_cli_needs_a_card_by_default(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main([str(workspace / "class.txt"), "RGB",
                       str(workspace / "val" / "list.txt"),
                       str(workspace / "model.pth.tar"), *MODEL_FLAGS])


def test_eval_cli_refuses_a_checkpoint_directory(workspace, tmp_path):
    with pytest.raises(ValueError, match="export_checkpoint"):
        port_cli.main([str(workspace / "class.txt"), "RGB",
                       str(workspace / "val" / "list.txt"), str(tmp_path),
                       *MODEL_FLAGS, "--device", "cpu"])
