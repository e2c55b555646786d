"""PyTorch port, the train CLI (`ta3n_tpu_torch.cli.train`) on the CPU:
the JAX CLI's command line with ``--device cpu`` trains, writes the log
files and reference-format checkpoints, resumes with ``--resume_hp``, and
evaluates; its ``model_best.pth.tar`` gives the port's and the JAX
package's eval CLIs the same ``Pred@k`` line, whose Pred@1 is the best
Prec@1 the training printed.  Flags whose path is not ported raise,
naming their ROADMAP.md item, and the default device is the card."""

import re

import pytest
import torch

from ta3n_tpu.cli import test_models as jax_eval_cli
from ta3n_tpu.data.synthetic import make_domain_pair
from ta3n_tpu_torch.cli import test_models as port_eval_cli
from ta3n_tpu_torch.cli.train import main

MODEL_FLAGS = ["--baseline_type", "video", "--frame_aggregation", "trn-m",
               "--use_attn", "TransAttn", "--fc_dim", "32",
               "--feature_dim", "32"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    stores = make_domain_pair(num_source=24, num_target=18, num_val=12,
                              num_class=3, feature_dim=32, shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    with open(root / "class.txt", "w") as f:
        f.write("0 a\n1 b\n2 c\n")
    return root


def _argv(root, exp, *extra):
    return [str(root / "class.txt"), "RGB", str(root / "src" / "list.txt"),
            str(root / "tgt" / "list.txt"), str(root / "val" / "list.txt"),
            "--exp_path", str(root / exp) + "/", *MODEL_FLAGS,
            "--use_target", "uSv", "--adv_DA", "RevGrad",
            "--add_loss_DA", "attentive_entropy", "--gamma", "0.003",
            "--beta", "0.75", "0.75", "0.5", "--lr", "0.03",
            "--lr_adaptive", "dann", "-b", "8", "6", "8",
            "--dropout_i", "0.5", "--dropout_v", "0.5", "-pf", "1",
            "--save_best_log", str(root / exp) + "/best.log",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(workspace):
    """2 epochs from the device stores with --save_model, then resumed
    with --resume_hp to epoch 3; the printed output of each."""
    import contextlib
    import io

    outs = []
    for extra in (["--epochs", "2"],
                  ["--epochs", "3", "--resume",
                   str(workspace / "exp" / "RGB" / "checkpoint.pth.tar"),
                   "--resume_hp"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            best = main(_argv(workspace, "exp", "--device_store",
                              "--save_model", "-sf", "1", *extra))
        outs.append((best, buf.getvalue()))
    return outs


def test_train_cli_trains_and_resumes(workspace, trained):
    exp = workspace / "exp" / "RGB"
    (best, first), (best_again, second) = trained
    for name in ("checkpoint.pth.tar", "model_best.pth.tar", "train.log",
                 "train_short.log", "val.log", "val_short.log"):
        assert (exp / name).is_file(), name
    assert "start training......" in first
    assert "total training time:" in first
    assert first.count("Testing Results: Prec@1") == 2
    # the resumed run: epoch 3 only, from the saved lr and step
    assert "=> loaded checkpoint" in second and "(epoch 2)" in second
    assert re.findall(r"Train: \[(\d+)\]", second) == ["3"] * 3
    payload = torch.load(exp / "checkpoint.pth.tar", weights_only=True)
    assert payload["epoch"] == 3 and payload["step"] == 9
    assert set(payload) >= {"epoch", "arch", "state_dict", "optimizer",
                            "best_prec1", "prec1", "lr_current", "step"}
    assert all(k.startswith("module.") for k in payload["state_dict"])
    lr_saved = float(re.findall(r"lr: ([0-9.]+)", first)[-1])
    assert float(re.findall(r"lr: ([0-9.]+)", second)[0]) < lr_saved
    log = (exp / "train.log").read_text()
    assert "========== start:" in log and "total time:" in log
    assert best_again >= best
    assert (workspace / "exp" / "best.log").read_text().count("\n") == 2


def test_best_checkpoint_evaluates_the_same_everywhere(workspace, trained):
    """The eval CLIs of both packages on model_best.pth.tar print the same
    Pred@k line, and its Pred@1 is the best Prec@1 of the training."""
    (best, _), (best_again, _) = trained
    argv = [str(workspace / "class.txt"), "RGB",
            str(workspace / "val" / "list.txt"),
            str(workspace / "exp" / "RGB" / "model_best.pth.tar"),
            *MODEL_FLAGS, "--test_segments", "5", "--bS", "8", "--top",
            "1", "3"]
    port = port_eval_cli.main(argv + ["--device", "cpu", "--device_store"])
    assert port == port_eval_cli.main(argv + ["--device", "cpu"])
    assert port == jax_eval_cli.main(argv)
    pred1 = float(re.match(r"Pred@1 ([0-9.]+)%", port).group(1))
    assert pred1 == pytest.approx(max(best, best_again), abs=0.006)


def test_train_cli_evaluate(workspace, trained):
    prec1 = main(_argv(workspace, "exp_eval", "--evaluate", "--resume",
                       str(workspace / "exp" / "RGB" / "model_best.pth.tar")))
    (best, _), (best_again, _) = trained
    assert prec1 == pytest.approx(max(best, best_again), abs=1e-9)


@pytest.mark.parametrize("flags,item", [
    (["--steps_per_call", "2"], "item 4"), (["--accum_steps", "2"], "item 8"),
    (["--store_dtype", "bfloat16"], "item 8"),
    (["--compute_dtype", "bfloat16"], "item 8"),
    (["--store_budget_rows", "10"], "item 9"),
    (["--device_sampler"], "item 9"), (["--model_parallel", "2"], "item 9"),
    (["--num_devices", "2"], "item 9"), (["--pretrain_source"], "item 6"),
    (["--tensorboard"], "item 5"), (["--profile_dir", "prof"], "item 5"),
    (["--dis_DA", "DAN"], "item 7"),
])
def test_train_cli_unported_flags_raise(workspace, flags, item):
    with pytest.raises(NotImplementedError, match=f"queue 1, {item}"):
        main(_argv(workspace, "exp_bad", "--epochs", "1", *flags))


def test_train_cli_accepts_the_jax_only_flags(workspace):
    """--prng_impl, --compilation_cache and -j run and change nothing."""
    argv = ["--epochs", "1", "--seed", "3"]
    plain = main(_argv(workspace, "exp_a", *argv))
    with_flags = main(_argv(workspace, "exp_b", *argv, "--prng_impl",
                            "threefry2x32", "--compilation_cache",
                            str(workspace / "cache"), "-j", "4"))
    assert plain == with_flags
    assert not (workspace / "cache").exists()


def test_train_cli_needs_a_card_by_default(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(workspace, "exp_card", "--epochs", "1")]
    argv = argv[:argv.index("--device")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)
