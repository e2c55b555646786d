"""PyTorch port, the sweep runner (`ta3n_tpu_torch/train/sweep.py`) and
its CLI on the CPU, mirroring tests/test_sweep_runner.py: the manifest,
the emergency checkpoints on preemption and on an eval failure, eval_freq
best tracking, the frame baseline's skipped ensemble score, a resume
bitwise the uninterrupted sweep, and the refusal of member checkpoints of
mixed epochs.  The sweep CLI's JSON lines carry the JAX CLI's keys (the
JAX CLI run on the same workspace), and the eval CLI reproduces a member's
reported top-1 from its checkpoint."""

import contextlib
import io
import json
import os
import signal

import pytest
import torch

from ta3n_tpu.cli.sweep import main as jax_sweep_main
from ta3n_tpu.data.synthetic import make_domain_pair as jax_domain_pair
from ta3n_tpu_torch.cli import sweep as cli_sweep
from ta3n_tpu_torch.cli import test_models as cli_test_models
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.io_utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from ta3n_tpu_torch.train.sweep import _restack_members, run_sweep

SEG, FDIM = 3, 16
MEMBERS = [(0, 0.1, 0.0), (1, 0.05, 0.0)]


def _setup(baseline="video", epochs=4):
    src, tgt, val = make_domain_pair(num_source=16, num_target=16,
                                     num_val=8, num_class=3,
                                     feature_dim=FDIM, seed=0)
    cfg = ModelConfig(num_class=3, baseline_type=baseline,
                      frame_aggregation="avgpool", train_segments=SEG,
                      val_segments=SEG, fc_dim=16, feature_dim=FDIM,
                      dropout_i=0.0, dropout_v=0.0)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad")
    tc = TrainConfig(lr=0.1, epochs=epochs, batch_size=(8, 8, 8))
    ls = TSNLoader(src, batch_size=8, num_segments=SEG, mode="test",
                   seed=1)
    lt = TSNLoader(tgt, batch_size=8, num_segments=SEG, mode="test",
                   seed=2)
    lv = TSNLoader(val, batch_size=8, num_segments=SEG, mode="test",
                   shuffle=False)
    return cfg, da, tc, ls, lt, lv


class _KillingLoader:
    """A loader that SIGTERMs the process at its N-th epoch."""

    def __init__(self, inner, kill_on_call: int):
        self._inner = inner
        self._calls = 0
        self._kill_on = kill_on_call

    def index_epoch(self):
        self._calls += 1
        if self._calls == self._kill_on:
            os.kill(os.getpid(), signal.SIGTERM)
        return self._inner.index_epoch()

    def __len__(self):
        return len(self._inner)

    @property
    def store(self):
        return self._inner.store


def _ckpt(tmp_path, k, name="checkpoint.pth.tar"):
    return load_checkpoint(str(tmp_path / f"member_{k:02d}" / name))


def test_sweep_results_and_manifest(tmp_path):
    cfg, da, tc, ls, lt, lv = _setup()
    out = run_sweep(cfg, da, tc, ls, lt, lv, MEMBERS,
                    save_dir=str(tmp_path), device="cpu")
    assert len(out["results"]) == 2
    assert out["ensemble_top1"] is not None
    with open(tmp_path / "sweep.json") as f:
        assert json.load(f) == out["results"]
    for k, row in enumerate(out["results"]):
        assert "diverged" not in row and row["final_loss"] is not None
        payload = load_checkpoint(row["checkpoint"])
        assert int(payload["epoch"]) == tc.epochs
        assert int(payload["step"]) == tc.epochs * len(ls)
        assert payload["rng_state"].dtype == torch.uint8


def test_sweep_preemption_saves_emergency_checkpoints(tmp_path):
    cfg, da, tc, ls, lt, lv = _setup()
    killing = _KillingLoader(ls, kill_on_call=2)  # start of epoch 2
    with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
        run_sweep(cfg, da, tc, killing, lt, lv, MEMBERS,
                  save_dir=str(tmp_path), device="cpu")
    payload = _ckpt(tmp_path, 1)
    assert int(payload["epoch"]) == 1   # one epoch completed
    assert float(payload["prec1"]) == -1.0  # unvalidated emergency save


def test_sweep_eval_failure_still_saves_members(tmp_path):
    """A failure after training (during validation) keeps the trained
    sweep: the emergency checkpoints carry the full epoch count."""
    cfg, da, tc, ls, lt, lv = _setup()
    killing_val = _KillingLoader(lv, kill_on_call=1)
    with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
        run_sweep(cfg, da, tc, ls, lt, killing_val, MEMBERS[:1],
                  save_dir=str(tmp_path), device="cpu")
    payload = _ckpt(tmp_path, 0)
    assert int(payload["epoch"]) == tc.epochs
    assert float(payload["prec1"]) == -1.0


def test_sweep_eval_freq_tracks_best(tmp_path):
    """eval_freq > 0: each member's best_top1 and best_epoch across the
    periodic validations; model_best holds the best epoch, checkpoint the
    final state."""
    cfg, da, tc, ls, lt, lv = _setup()
    out = run_sweep(cfg, da, tc, ls, lt, lv, MEMBERS,
                    save_dir=str(tmp_path), eval_freq=1, device="cpu")
    for row in out["results"]:
        assert row["best_top1"] >= row["top1"] - 1e-9
        assert 1 <= row["best_epoch"] <= tc.epochs
        best = load_checkpoint(row["best_checkpoint"])
        assert int(best["epoch"]) == row["best_epoch"]
        assert abs(float(best["best_prec1"]) - row["best_top1"]) < 1e-6
        assert int(load_checkpoint(row["checkpoint"])["epoch"]) == tc.epochs


def test_sweep_frame_baseline_skips_ensemble_score():
    """The frame baseline's eval rows are frames: the deep-ensemble score
    is skipped (None), not mis-aligned."""
    cfg, da, tc, ls, lt, lv = _setup(baseline="frame", epochs=1)
    out = run_sweep(cfg, da, tc, ls, lt, lv, MEMBERS[:1], device="cpu")
    assert out["ensemble_top1"] is None
    assert out["results"][0]["top1"] >= 0.0


def test_sweep_resume_bitwise_matches_uninterrupted(tmp_path):
    """Preempt a sweep at epoch 3 and resume from its emergency member
    checkpoints: the final members, their best tracking and their
    generators equal the uninterrupted sweep's, bitwise; a resume under
    another configuration is refused."""

    def run(save_dir, kill=False, resume=False):
        cfg, da, tc, ls, lt, lv = _setup()
        if kill:
            ls = _KillingLoader(ls, kill_on_call=3)  # start of epoch 3
        return run_sweep(cfg, da, tc, ls, lt, lv, MEMBERS,
                         save_dir=save_dir, resume=resume, eval_freq=1,
                         device="cpu")

    out_a = run(str(tmp_path / "a"))
    with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
        run(str(tmp_path / "b"), kill=True)
    out_b = run(str(tmp_path / "b"), resume=True)
    assert [r["top1"] for r in out_a["results"]] == \
        [r["top1"] for r in out_b["results"]]
    assert [(r["best_top1"], r["best_epoch"]) for r in out_a["results"]] \
        == [(r["best_top1"], r["best_epoch"]) for r in out_b["results"]]
    with pytest.raises(ValueError, match="different sweep config"):
        cfg, da, tc, ls, lt, lv = _setup()
        run_sweep(cfg, da, tc, ls, lt, lv, [(5, 0.2, 0.0), (6, 0.3, 0.0)],
                  save_dir=str(tmp_path / "b"), resume=True, device="cpu")
    for k in range(2):
        a, b = _ckpt(tmp_path / "a", k), _ckpt(tmp_path / "b", k)
        assert int(a["epoch"]) == int(b["epoch"]) == 4
        assert torch.equal(a["rng_state"], b["rng_state"])
        for name, t in a["state_dict"].items():
            assert torch.equal(t, b["state_dict"][name]), name
        for i, st in a["optimizer"]["state"].items():
            assert torch.equal(st["momentum_buffer"],
                               b["optimizer"]["state"][i]["momentum_buffer"])


def test_restack_rejects_mixed_epochs(tmp_path):
    """Member checkpoints whose epochs disagree are not one sweep's save
    set."""
    cfg, _, tc, *_ = _setup()
    for k, ep in enumerate((1, 2)):
        save_checkpoint(str(tmp_path / f"member_{k:02d}"),
                        {"epoch": ep, "state_dict": {}, "step": ep})
    with pytest.raises(ValueError, match="disagree on epoch"):
        _restack_members(str(tmp_path), 2, 2, cfg, tc, "cpu")


def _workspace(root, make):
    stores = make(num_source=24, num_target=18, num_val=12, num_class=3,
                  feature_dim=FDIM, shift=0.8)
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(str(root / name))
        with open(root / name / "list.txt", "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    (root / "class.txt").write_text("0 a\n1 b\n2 c\n")


def _sweep_argv(root, out):
    return [str(root / "class.txt"), "RGB", str(root / "src" / "list.txt"),
            str(root / "tgt" / "list.txt"), str(root / "val" / "list.txt"),
            "--exp_path", str(root / "exp") + "/", "--baseline_type",
            "video", "--frame_aggregation", "avgpool", "--num_segments",
            str(SEG), "--val_segments", str(SEG), "--fc_dim", "16",
            "--feature_dim", str(FDIM), "--use_target", "uSv", "--adv_DA",
            "RevGrad", "--use_attn", "none", "--lr", "0.1", "--epochs", "1",
            "-b", "8", "6", "8", "--sweep_seeds", "0", "1", "--sweep_lrs",
            "0.1", "0.0", "--sweep_dir", str(out)]


def _json_lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def test_sweep_cli_lines_match_the_jax_cli(tmp_path):
    """cli.sweep on a workspace: a 2 seeds x 2 lrs grid, one JSON line per
    member and a summary line with the JAX CLI's keys, member checkpoints
    the eval CLI reproduces a member's top-1 from, and --sweep_mesh
    refused."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_root.mkdir()
    jax_root.mkdir()
    _workspace(port_root, make_domain_pair)
    _workspace(jax_root, jax_domain_pair)
    out_dir = port_root / "sweep"
    ours = _json_lines(cli_sweep.main, _sweep_argv(port_root, out_dir)
                       + ["--device", "cpu"])
    theirs = _json_lines(jax_sweep_main,
                         _sweep_argv(jax_root, jax_root / "sweep"))
    assert len(ours) == len(theirs) == 5
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert {(r["seed"], r["lr"]) for r in ours[:4]} == \
        {(0, 0.1), (0, 0.0), (1, 0.1), (1, 0.0)}
    assert os.path.isfile(out_dir / "member_00" / "checkpoint.pth.tar")
    line = cli_test_models.main([
        str(port_root / "class.txt"), "RGB",
        str(port_root / "val" / "list.txt"),
        str(out_dir / "member_00" / "checkpoint.pth.tar"),
        "--test_segments", str(SEG), "--fc_dim", "16", "--feature_dim",
        str(FDIM), "--baseline_type", "video", "--frame_aggregation",
        "avgpool", "--use_attn", "none", "--bS", "8", "--top", "1",
        "--device", "cpu"])
    assert f"Pred@1 {ours[0]['top1']:.2f}%" in line
    with pytest.raises(SystemExit, match="item 9"):
        cli_sweep.main(_sweep_argv(port_root, out_dir)
                       + ["--device", "cpu", "--sweep_mesh", "2"])
