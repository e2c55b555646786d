"""PyTorch port, the train CLI (`ta3n_tpu_torch.cli.train`) on the CPU:
the JAX CLI's command line with ``--device cpu`` trains, writes the log
files and reference-format checkpoints, resumes with ``--resume_hp``, and
evaluates; its ``model_best.pth.tar`` gives the port's and the JAX
package's eval CLIs the same ``Pred@k`` line, whose Pred@1 is the best
Prec@1 the training printed.  The model and loss flags of every
configuration train, and so do the chunked modes: K steps per call,
streamed stores and the device sampler; --tensorboard and --profile_dir
write their embeddings and trace.  Flags whose path is not ported raise,
naming their ROADMAP.md item, and the default device is the card."""

import re
import sys
import types

import pytest
import torch

from ta3n_tpu.cli import test_models as jax_eval_cli
from ta3n_tpu.data.synthetic import make_domain_pair
from ta3n_tpu_torch.cli import test_models as port_eval_cli
from ta3n_tpu_torch.cli.train import main

MODEL_FLAGS = ["--baseline_type", "video", "--frame_aggregation", "trn-m",
               "--use_attn", "TransAttn", "--fc_dim", "32",
               "--feature_dim", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU steps: a pool of
    every core gains them nothing and, with the other test workers'
    pools, oversubscribes the machine (the module ran ~2-4x slower beside
    two others).  The previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _train_lines(main, argv):
    """Run a train CLI; its best Prec@1 and its printed Train: lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best = main(argv)
    return best, re.findall(r"Train: \[\d+\]\[\d+/\d+\]", buf.getvalue())


@pytest.mark.parametrize("flags,eval_flags", [
    (["--accum_steps", "2"], []),
    (["--device_store", "--store_dtype", "bfloat16"],
     ["--device_store", "--store_dtype", "bfloat16"]),
    (["--compute_dtype", "bfloat16", "--device_store", "--store_dtype",
      "int8", "--optimizer", "Adam", "--lr", "0.001"],
     ["--compute_dtype", "bfloat16", "--device_store", "--store_dtype",
      "int8"]),
], ids=["accum_steps", "store_dtype", "compute_dtype"])
def test_train_cli_precision_flags_run(workspace, flags, eval_flags):
    """The optimizer and precision flags through the port's train CLI for
    one epoch, as through the JAX train CLI with the same flags: the same
    Train: lines (--accum_steps 2: one line an update, the tail batch a
    plain step); model_best.pth.tar through the port's eval CLI, at the
    compute dtype and store dtype it trained with, gives the best Prec@1
    the training printed; and the JAX eval CLI and the port's in float32
    print the same Pred@k line on it."""
    from ta3n_tpu.cli.train import main as jax_main

    tag = "prec_" + flags[1]
    argv = _argv(workspace, tag, "--epochs", "1", "--save_model", *flags)
    best, lines = _train_lines(main, argv)
    jax_argv = [a for a in _argv(workspace, "jax_" + tag, "--epochs", "1",
                                 *flags) if a not in ("--device", "cpu")]
    _, jax_lines = _train_lines(jax_main, jax_argv)
    assert lines == jax_lines and lines
    evaluate = [str(workspace / "class.txt"), "RGB",
                str(workspace / "val" / "list.txt"),
                str(workspace / tag / "RGB" / "model_best.pth.tar"),
                *MODEL_FLAGS, "--test_segments", "5", "--bS", "8", "--top",
                "1", "3"]
    port = port_eval_cli.main(evaluate + ["--device", "cpu", *eval_flags])
    pred1 = float(re.match(r"Pred@1 ([0-9.]+)%", port).group(1))
    assert pred1 == pytest.approx(best, abs=0.006)
    assert port_eval_cli.main(evaluate + ["--device", "cpu"]) == \
        jax_eval_cli.main(evaluate)


@pytest.mark.parametrize("flags", [
    ["--steps_per_call", "2"], ["--store_budget_rows", "80"],
    ["--steps_per_call", "2", "--device_sampler"],
], ids=["steps_per_call", "store_budget_rows", "device_sampler"])
def test_train_cli_chunked_flags_run(workspace, flags):
    """--device_store with K = 2 steps per call, with stores streamed in
    shards of 80 rows, and with K = 2 and the device sampler, one epoch
    through the port's train CLI and the JAX train CLI: the same Train:
    lines; the port's eval CLI on model_best.pth.tar, from the store
    streamed the same way, gives the best Prec@1 the training printed,
    and the JAX eval CLI's Pred@k line."""
    from ta3n_tpu.cli.train import main as jax_main

    tag = "chunked_" + flags[0].strip("-") + str(len(flags))
    flags = ["--device_store", *flags]
    argv = _argv(workspace, tag, "--epochs", "1", "--save_model", *flags)
    best, lines = _train_lines(main, argv)
    jax_argv = [a for a in _argv(workspace, "jax_" + tag, "--epochs", "1",
                                 *flags) if a not in ("--device", "cpu")]
    _, jax_lines = _train_lines(jax_main, jax_argv)
    assert lines == jax_lines and lines
    evaluate = [str(workspace / "class.txt"), "RGB",
                str(workspace / "val" / "list.txt"),
                str(workspace / tag / "RGB" / "model_best.pth.tar"),
                *MODEL_FLAGS, "--test_segments", "5", "--bS", "8", "--top",
                "1", "3"]
    streamed = ["--device_store", "--store_budget_rows", "80"]
    port = port_eval_cli.main(evaluate + ["--device", "cpu", *streamed])
    pred1 = float(re.match(r"Pred@1 ([0-9.]+)%", port).group(1))
    assert pred1 == pytest.approx(best, abs=0.006)
    assert port == jax_eval_cli.main(evaluate)


@pytest.mark.parametrize("flags,item", [
    (["--model_parallel", "2"], "item 9"),
])
def test_train_cli_unported_flags_raise(workspace, flags, item):
    """The flags that raised until their ROADMAP item was ported: since
    item 9, --model_parallel on one process is ignored with the JAX CLI's
    warning and the run trains (tests/test_torch_port_grid_members.py
    runs it over four processes)."""
    with pytest.warns(UserWarning, match="--model_parallel 2 ignored"):
        best = main(_argv(workspace, "exp_bad", "--epochs", "1", *flags))
    assert best >= 0.0


@pytest.mark.parametrize("flag", ["--tensorboard", "--profile_dir"])
def test_train_cli_tensorboard_and_profile_dir_run(workspace, flag,
                                                   monkeypatch):
    """--tensorboard writes through tensorboardX under the experiment's
    RGB/tensorboard directory (a recording stand-in here) and --profile_dir a
    trace of steps 2-7 of the first epoch (3 steps here: steps 2 to its
    end); the best Prec@1 is the run's without either flag."""
    written = []

    class Writer:
        def __init__(self, logdir):
            written.append(logdir)

        def add_embedding(self, mat, metadata=None, global_step=None,
                          tag=None):
            written.append(tag)

        def add_text(self, tag, text, step):
            written.append(tag)

        def close(self):
            written.append("close")

    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=Writer))
    argv = ["--epochs", "1", "--dropout_i", "0", "--dropout_v", "0"]
    exp = "exp_" + flag.strip("-")
    extra = ([flag] if flag == "--tensorboard"
             else [flag, str(workspace / exp / "prof")])
    plain = main(_argv(workspace, exp + "_plain", *argv))
    assert main(_argv(workspace, exp, *argv, *extra)) == plain
    if flag == "--tensorboard":
        assert written == [str(workspace / exp / "RGB" / "tensorboard"),
                           "train_source", "train_target", "train_DA",
                           "train_DA_labels", "validation", "Best_Accuracy",
                           "close"]
    else:
        assert written == []
        traces = list((workspace / exp / "prof").iterdir())
        assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")


@pytest.mark.parametrize("flags,logged", [
    (["--pretrain_source", "--dis_DA", "DAN", "--place_dis", "Y", "Y",
      "Y"], "loss_d"),
    (["--dis_DA", "CORAL", "--alpha", "0.5"], "alpha 0.500"),
    (["--baseline_type", "frame", "--frame_aggregation", "temconv",
      "--use_bn", "AdaBN", "--use_attn", "none"], "loss_a"),
    (["--baseline_type", "tsn", "--frame_aggregation", "rnn",
      "--rnn_cell", "GRU", "--n_directions", "2", "--n_ts", "2",
      "--use_attn", "none", "--dis_DA", "JAN", "--device_store"], None),
])
def test_train_cli_runs_the_model_and_loss_flags(workspace, flags, logged):
    """The discrepancy losses, --pretrain_source, RNN and temconv
    aggregation and the frame and tsn baselines train through the CLI
    (JAN with tsn is refused, as in the JAX step); the train log carries
    the discrepancy's columns."""
    exp = "exp_" + "_".join(f.strip("-") for f in flags[:2])
    argv = _argv(workspace, exp, "--epochs", "1", *flags)
    if logged is None:
        with pytest.raises(ValueError, match="incompatible"):
            main(argv)
        return
    assert 0.0 <= main(argv) <= 100.0
    log = (workspace / exp / "RGB" / "train.log").read_text()
    assert logged in log


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
