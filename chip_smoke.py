"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ta3n_tpu_torch/csrc (one nvcc per
source, in parallel), checks in their SASS that the tensor-core kernels
(K1, K2, K3) hold mma (HMMA) and cp.async (LDGSTS) instructions, holds each
kernel against its plain PyTorch version at the flagship shapes and times
both (K1 (infer) at batch 1 and the serve and train batches, K2 also by
its dx and dW families, K3 at the train and eval shapes, each against the
bound of the arithmetic it runs), then drives the port's main paths at
the flagship widths (UCF->HMDB_full: trn-m over 5 segments, 2048-d features,
fc 512, TRN bottleneck 256, TransAttn, 12 classes, random weights from a
seed):
  * serving: the model served over HTTP at batch 64, and in process at
    batch 1 (a latency-first service), the answers checked against a
    plain-path forward of the same weights on the same card;
  * training: the published train step (uSv, RevGrad at three levels,
    attentive entropy, Nesterov SGD with DANN lr) at 128 source + 74
    target videos, 5 steps through the kernels checked against 5 steps of
    a copy whose TRN is the plain version, each step from the same
    parameters (rows moved by a relu mask flipped at a rounding tie let
    through, and named), then timed at the published dropout 0.5;
  * device-store training: synthetic feature stores of the published
    split sizes uploaded once, index batches from the loader, 5 steps
    whose gather + shared FC runs as the K3 kernel checked against 5
    steps of the host-feature step on the same batches, each step from
    the same parameters, then both timed at dropout 0.5;
  * device-store eval: one val epoch (6 batches of 64) through
    make_multi_eval_step against the host-feature eval step;
  * the TRN beyond 16 segments: K1 (infer) at B=64, K1 (train) and K2 at
    B=202, at S = 17 and 25, against their plain versions, and timed;
  * the eval CLI (`python -m ta3n_tpu_torch.cli.test_models`) on the
    synthetic val store and a seed model's `.pth.tar`, from host features
    and with --device_store, its scores held to a plain-path forward;
  * the Trainer through the train CLI (`python -m ta3n_tpu_torch.cli.train`)
    on synthetic stores of the published split sizes: 2 epochs from the
    device stores with --save_model, a --resume_hp run to epoch 3, one
    epoch from host features, and the eval CLI on its model_best.pth.tar,
    whose Pred@1 must be the best Prec@1 the Trainer printed.
Each path is run with the kernels' launch counts set to 0 just before it
and read just after.  Any failure exits non-zero; so does a machine
without a CUDA device.  The last line of the output is one JSON object:
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from torch import nn

from ta3n_tpu_torch.cli import test_models as cli_test_models
from ta3n_tpu_torch.cli import train as cli_train
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models.layers import torch_default_uniform_
from ta3n_tpu_torch.ops import _build, gather_gemm, relation, trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.serve import Predictor, make_http_server
from ta3n_tpu_torch.train import (StepScalars, TrainState, make_eval_step,
                                  make_multi_eval_step, make_train_step)
from ta3n_tpu_torch.train.loop import Trainer
from ta3n_tpu_torch.train.optim import make_optimizer
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress

FLAGSHIP = ModelConfig(
    num_class=12, baseline_type="video", frame_aggregation="trn-m",
    train_segments=5, val_segments=5, feature_dim=2048, fc_dim=512,
    use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
SERVE_BATCH = 64
REQUEST_SIZES = (1, 37, 130)   # 130 videos span three padded chunks
TRN_CASES = ((1, 5, 512, 256), (64, 5, 512, 256), (202, 5, 512, 256),
             (13, 4, 37, 19))  # (B, S, D, H); the last one ragged
TIMED_BATCHES = (1, 64, 202)  # single-video serving, serving, training
RTOL = 1e-4                    # |kernel - plain| <= RTOL * max(1, |plain|)
PROB_TOL = 1e-5
# the published training recipe (BASELINE.md:25)
DA = DAConfig(use_target="uSv", adv_DA="RevGrad",
              add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
TRAIN = TrainConfig(lr=0.03, lr_adaptive="dann", batch_size=(128, 74, 64),
                    beta=(0.75, 0.75, 0.5), gamma=0.003)
TRAIN_STEPS = 5                # parity steps, kernel TRN against plain TRN
TIMED_STEPS = 20
STEP_RTOL = 2e-4               # per-step losses (tests/test_train_parity_*)
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)
# the published UCF->HMDB_full split sizes: source train, target train, val
SPLITS = dict(num_source=1438, num_target=840, num_val=360)
K3_CASES = (640, 370, 320, 37, 1, 0)   # rows: train source/target, eval
K3_TIMED = ((640, True), (320, False))  # (rows, with x_res): train, eval
EVAL_RTOL = 1e-5               # the val epoch's summed loss
MANY_FRAMES = (17, 25)         # segments beyond the earlier cap of 16
CLI_BATCH = 128                # the eval CLI's --bS and the val batch
# the flagship's flags on the command line of the CLIs
MODEL_FLAGS = ["--baseline_type", "video", "--frame_aggregation", "trn-m",
               "--use_attn", "TransAttn", "--fc_dim", "512",
               "--feature_dim", "2048"]
# the published recipe on the train CLI's command line (BASELINE.md:25)
RECIPE_FLAGS = ["--num_segments", "5", "--use_target", "uSv",
                "--adv_DA", "RevGrad", "--place_adv", "Y", "Y", "Y",
                "--add_loss_DA", "attentive_entropy", "--gamma", "0.003",
                "--beta", "0.75", "0.75", "0.5", "--lr", "0.03",
                "--lr_adaptive", "dann", "-b", "128", "74", str(CLI_BATCH),
                "--dropout_i", "0.5", "--dropout_v", "0.5", "-pf", "4"]
# NVIDIA H100 SXM data sheet (700 W): dense TF32 tensor-core peak and HBM
# rate
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the rate of each kernel's arithmetic: all run three TF32 tensor-core
# products per f32 product (3xTF32)
PEAK_OPS = {"trn_fused_fwd": PEAK_TF32 / 3,
            "trn_fused_fwd_train": PEAK_TF32 / 3,
            "trn_fused_bwd": PEAK_TF32 / 3, "gather_gemm": PEAK_TF32 / 3}
# kernels on the tensor cores, fed by cp.async: their SASS must hold HMMA
# and LDGSTS instructions (K1's epilogue, trn_fused_fwd_epilogue, is a
# plain sum)
TENSOR_CORE_KERNELS = ("trn_fused_fwd_kernel", "gather_gemm_kernel",
                       "trn_fused_bwd_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def build_kernels() -> float:
    t0 = time.perf_counter()
    out = _build.compile_library(_build.library_path())
    seconds = time.perf_counter() - t0
    for line in out.splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()
    return seconds


def check_sass() -> None:
    """Count the tensor-core (HMMA) and asynchronous-copy (LDGSTS)
    instructions of each kernel in the built library's SASS; fail unless
    every kernel of TENSOR_CORE_KERNELS has both."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += " HMMA." in line
            counts[name][1] += " LDGSTS" in line
    for name, (hmma, ldgsts) in sorted(counts.items()):
        log(f"  sass: {hmma:4d} HMMA, {ldgsts:4d} LDGSTS  {name[:80]}")
    for kernel in TENSOR_CORE_KERNELS:
        found = [c for n, c in counts.items() if kernel in n]
        if not found or not all(h and g for h, g in found):
            raise AssertionError(f"{kernel}: no HMMA or no LDGSTS in its "
                                 "SASS")


def trn_inputs(b, s, d, h, gen, signed=False):
    """Non-negative x like the post-ReLU shared features (``signed``: of
    both signs, so that the backward's (x > 0) matters); weights and
    biases at torch's default Linear scale U(±1/sqrt(k*D))."""
    x = (torch.randn((b, s, d), generator=gen) if signed
         else torch.rand((b, s, d), generator=gen))
    weights, biases = [], []
    for k in build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append((torch.rand((h, k * d), generator=gen) * 2 - 1)
                       * bound)
        biases.append((torch.rand((h,), generator=gen) * 2 - 1) * bound)
    return (x.cuda(), [w.cuda() for w in weights],
            [bi.cuda() for bi in biases])


def device_ms(fn) -> float:
    """Device time of one call: the stream is kept busy while the host
    enqueues the call, so the events bracket device work only."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def call_ms(fn) -> float:
    """Time of one call as a caller sees it: host dispatch included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def host_ms(fn, n=20) -> float:
    """Host time to enqueue one call, the stream busy meanwhile."""
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / n


def check_trn_kernel(gen) -> float:
    worst = 0.0
    with torch.inference_mode():
        for b, s, d, h in TRN_CASES:
            x, w, bi = trn_inputs(b, s, d, h, gen)
            got = trn_fused.trn_multiscale_infer(x, w, bi, s)
            want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            torch.cuda.synchronize()
            if got.shape != (b, s - 1, h) or not torch.isfinite(got).all():
                raise AssertionError(f"kernel output bad at B={b}")
            err = (got - want).abs().max().item()
            tol = RTOL * max(1.0, want.abs().max().item())
            log(f"  B={b} S={s} D={d} H={h}: max|kernel-plain| = {err:.3e}"
                f" (tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain at "
                                     f"B={b}: {err} > {tol}")
            worst = max(worst, err)
    return worst


def time_trn(gen, runs=41, warmup=5):
    """Median times of kernel and plain at the flagship widths, taken in
    turns (plain, kernel, kernel, plain, ...)."""
    results = {}
    with torch.inference_mode():
        for b in TIMED_BATCHES:
            x, w, bi = trn_inputs(b, 5, 512, 256, gen)
            fns = {"kernel": lambda: trn_fused.trn_multiscale_infer(
                       x, w, bi, 5),
                   "plain": lambda: trn_fused.trn_multiscale_plain(
                       x, w, bi, 5)}
            for fn in fns.values():
                for _ in range(warmup):
                    fn()
            meters = {"device": device_ms, "call": call_ms, "host": host_ms}
            times = {(name, kind): [] for name in fns for kind in meters}
            for i in range(runs):
                order = ("plain", "kernel") if i % 2 == 0 else \
                    ("kernel", "plain")
                for name in order:
                    for kind, meter in meters.items():
                        times[(name, kind)].append(meter(fns[name]))
            med = {key: statistics.median(v) for key, v in times.items()}
            results[b] = med
            for name in fns:
                log(f"  B={b} {name}: " + ", ".join(
                    f"{kind} {med[(name, kind)]:.4f} ms" for kind in meters)
                    + f" (medians of {runs})")
    return results


def grid_inputs(b, s, d, h, rng):
    """x, weights, biases and an upstream gradient on dyadic grids small
    enough that every product and partial sum of the forward and the
    backward is exact in float32 at these widths: any summation order
    gives the same bits, so kernel and plain must agree exactly, masks
    included."""
    def grid(lo, hi, shape, step):
        return torch.from_numpy(
            (rng.integers(lo, hi + 1, shape) * step).astype(np.float32)
        ).cuda()

    x = grid(-8, 16, (b, s, d), 2.0 ** -4)
    weights = [grid(-16, 16, (h, k * d), 2.0 ** -8)
               for k in build_relation_plan(s).scales]
    biases = [grid(-64, 64, (h,), 2.0 ** -12) for _ in weights]
    return x, weights, biases, grid(-128, 128, (b, s - 1, h), 2.0 ** -8)


def preacts(x, weights, biases, s):
    """z of every subset, [B, n_sub*H], in the masks' layout."""
    plan = build_relation_plan(s)
    b, _, d = x.shape
    zs = []
    for w, bias, k, subsets in zip(weights, biases, plan.scales,
                                   plan.subsets):
        idx = torch.as_tensor(subsets.reshape(-1), device=x.device)
        g = x[:, idx].reshape(b, subsets.shape[0], k * d)
        zs.append((torch.relu(g) @ w.T + bias).reshape(b, -1))
    return torch.cat(zs, dim=1)


def check_train_kernels(gen):
    """K1 (train) against trn_multiscale_fwd_masks_plain and K2 against
    trn_multiscale_bwd_plain at every case: float inputs within the
    tolerance (K2 from the kernel's masks on both sides), exact inputs
    bit for bit, masks included, and K2 bitwise equal on a second call.
    Returns the largest error of each on the float inputs."""
    rng = np.random.default_rng(1)
    worst = {"fwd": 0.0, "bwd": 0.0}
    with torch.no_grad():
        for b, s, d, h in TRN_CASES:
            x, w, bi = trn_inputs(b, s, d, h, gen, signed=True)
            out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, s)
            torch.cuda.synchronize()
            if out.shape != (b, s - 1, h) or not torch.isfinite(out).all():
                raise AssertionError(f"K1 (train) output bad at B={b}")
            err = (out - want).abs().max().item()
            tol = RTOL * max(1.0, want.abs().max().item())
            differ = masks != want_masks
            z = preacts(x, w, bi, s)
            z_tol = RTOL * max(1.0, z.abs().max().item())
            ties = int(differ.sum())
            log(f"  K1 (train) B={b} S={s} D={d} H={h}: max|kernel-plain| "
                f"= {err:.3e} (tolerance {tol:.3e}); mask density "
                f"{masks.float().mean().item():.4f}; {ties} of "
                f"{masks.numel()} mask entries differ from plain")
            if not err <= tol:
                raise AssertionError(f"K1 (train) disagrees at B={b}")
            if ties and not (z[differ].abs() <= z_tol).all():
                raise AssertionError(f"K1 (train) masks differ at B={b} "
                                     "where z is not a rounding tie")
            worst["fwd"] = max(worst["fwd"], err)

            g = torch.randn((b, s - 1, h), generator=gen).cuda()
            got = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
            again = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
            ref = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
            torch.cuda.synchronize()
            errs = []
            for name, a_, again_, r in zip(
                    ["dx"] + [f"dW{i}" for i in range(s - 1)]
                    + [f"db{i}" for i in range(s - 1)],
                    (got[0], *got[1], *got[2]),
                    (again[0], *again[1], *again[2]),
                    (ref[0], *ref[1], *ref[2])):
                e = (a_ - r).abs().max().item()
                t = RTOL * max(1.0, r.abs().max().item())
                if a_.shape != r.shape or not e <= t:
                    raise AssertionError(f"K2 {name} disagrees at B={b}: "
                                         f"{e} > {t}")
                if not torch.equal(a_, again_):
                    raise AssertionError(f"K2 {name} not bitwise "
                                         f"repeatable at B={b}")
                errs.append(e)
            log(f"  K2 B={b} S={s} D={d} H={h}: max|kernel-plain| over dx, "
                f"{s - 1} dW, {s - 1} db = {max(errs):.3e}; a second call "
                "is bitwise equal")
            worst["bwd"] = max(worst["bwd"], max(errs))

            gx, gw, gb, gg = grid_inputs(b, s, d, h, rng)
            out, masks = trn_fused.trn_multiscale_fwd_masks(gx, gw, gb, s)
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                gx, gw, gb, s)
            got = trn_fused.trn_multiscale_bwd(gx, gw, masks, gg, s, 3)
            ref = trn_fused.trn_multiscale_bwd_plain(gx, gw, want_masks, gg,
                                                     s)
            torch.cuda.synchronize()
            exact = [torch.equal(masks, want_masks), torch.equal(out, want)]
            exact += [torch.equal(a_, r) for a_, r in
                      zip((got[0], *got[1], *got[2]),
                          (ref[0], *ref[1], *ref[2]))]
            if not all(exact):
                raise AssertionError(f"kernels differ from plain on exact "
                                     f"inputs at B={b}: {exact}")
            log(f"  exact inputs B={b}: K1 (train) masks and output, K2 dx, "
                "dW and db bitwise equal to plain")
    return worst


def time_pair(fns, runs=41, warmup=5):
    """Median device time of each function, taken in turns (a, b, b, a,
    ...)."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    names = list(fns)
    for i in range(runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            times[name].append(device_ms(fns[name]))
    return {name: statistics.median(v) for name, v in times.items()}


def time_train_kernels(gen, b=202):
    """Device times of K1 (train) and K2 against their plain versions at
    the train batch."""
    x, w, bi = trn_inputs(b, 5, 512, 256, gen, signed=True)
    g = torch.randn((b, 4, 256), generator=gen).cuda()
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
        fwd = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5),
            "plain": lambda: trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, 5)})
        bwd = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_bwd(x, w, masks, g, 5),
            "plain": lambda: trn_fused.trn_multiscale_bwd_plain(
                x, w, masks, g, 5)})
    for label, t in (("K1 (train)", fwd), ("K2", bwd)):
        log(f"  B={b} {label}: kernel {t['kernel']:.4f} ms, plain "
            f"{t['plain']:.4f} ms device (medians of 41, in turns)")
    return fwd, bwd


def trn_work(b, s=5, d=512, h=256):
    """FLOPs and the least bytes of the TRN kernels at these shapes: each
    input read once, each output written once."""
    plan = build_relation_plan(s)
    n_sub = sum(len(sub) for sub in plan.subsets)
    flops = 2 * b * h * d * sum(len(sub) * k
                                for k, sub in zip(plan.scales, plan.subsets))
    w_bytes = 4 * h * d * sum(plan.scales)
    b_bytes = 4 * h * len(plan.scales)
    x_bytes, out_bytes = 4 * b * s * d, 4 * b * (s - 1) * h
    mask_bytes = b * n_sub * h
    fwd_bytes = x_bytes + w_bytes + b_bytes + out_bytes
    return {
        "trn_fused_fwd": (flops, fwd_bytes),
        "trn_fused_fwd_train": (flops, fwd_bytes + mask_bytes),
        # x, g (the size of out), masks and W in; dx, dW and db out
        "trn_fused_bwd": (2 * flops, 2 * x_bytes + out_bytes + mask_bytes
                          + 2 * w_bytes + b_bytes),
    }


def bound(flops, nbytes, peak_ops):
    """The least time the card could take, in ms, and what sets it, for a
    kernel whose arithmetic runs at ``peak_ops`` FLOP/s."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class PlainTRN(nn.Module):
    """The TRN of a model, run through the plain PyTorch version."""

    def __init__(self, trn):
        super().__init__()
        self.trn = trn

    def forward(self, x, infer=False):
        seqs = self.trn.fc_fusion_scales
        return trn_fused.trn_multiscale_plain(
            x, [q[1].weight for q in seqs], [q[1].bias for q in seqs],
            self.trn.num_frames, self.trn.subsample_num)


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def serve_flagship(gen, workdir):
    """Serve the flagship over HTTP, a warm-up round of requests and then
    the served round, and in process at batch 1; return the kernel
    launches of the served round and of the batch-1 calls."""
    model = VideoModel(FLAGSHIP, generator=gen)
    # redraw every weight at torch's default scale so that the outputs
    # are far from uniform and top-k means something
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            torch_default_uniform_(mod, gen)
    path = os.path.join(workdir, "flagship.pth.tar")
    torch.save({"epoch": 0, "arch": "resnet101", "best_prec1": 0.0,
                "prec1": 0.0,
                "state_dict": {f"module.{k}": v
                               for k, v in model.state_dict().items()}},
               path)
    predictor = Predictor.from_checkpoint(path, FLAGSHIP, device="cuda",
                                          batch_size=SERVE_BATCH)
    plain_model = copy.deepcopy(predictor.model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    plain = Predictor(FLAGSHIP, plain_model, batch_size=SERVE_BATCH,
                      device="cuda")

    rng = np.random.default_rng(0)
    requests = [rng.random((n, FLAGSHIP.val_segments,
                            FLAGSHIP.input_feature_dim), np.float32)
                for n in REQUEST_SIZES]
    names = [f"class_{i}" for i in range(FLAGSHIP.num_class)]
    server = make_http_server(predictor, names, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bodies = [{"features": feats.tolist()} for feats in requests]
        for label in ("warm-up", "served"):
            reset_counts()
            answers = []
            for feats, body in zip(requests, bodies):
                t0 = time.perf_counter()
                answers.append(post(f"{url}/predict", body))
                log(f"  POST /predict ({label}), {feats.shape[0]} videos: "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        launches = counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"  TRN kernel launches while serving: {launches}")
    if launches["trn_fused_fwd_train"] or launches["trn_fused_bwd"] or \
            launches["gather_gemm"]:
        raise AssertionError("serving launched a kernel of another path")
    launches = launches["trn_fused_fwd"]
    if health != {"status": "ok", "num_class": 12, "segments": 5}:
        raise AssertionError(f"bad /healthz answer {health}")
    chunks = sum(-(-n // SERVE_BATCH) for n in REQUEST_SIZES)
    if launches != chunks:
        raise AssertionError(f"expected {chunks} TRN kernel launches "
                             f"while serving, counted {launches}")

    for feats, ans in zip(requests, answers):
        in_process = []
        for _ in range(5):
            t0 = time.perf_counter()
            probs, _, _ = predictor(feats)
            in_process.append((time.perf_counter() - t0) * 1e3)
        log(f"  Predictor call in process, {feats.shape[0]} videos: "
            f"{statistics.median(in_process):.2f} ms (median of 5)")
        ref_probs, ref_p, ref_i = plain(feats)
        if probs.shape != (feats.shape[0], 12) or \
                not np.isfinite(probs).all():
            raise AssertionError("bad probabilities")
        if not np.allclose(probs.sum(1), 1.0, atol=PROB_TOL):
            raise AssertionError("probabilities do not sum to 1")
        if not np.array_equal(np.asarray(ans["top_classes"]), ref_i):
            raise AssertionError("served top classes differ from the "
                                 "plain path")
        err = np.abs(np.asarray(ans["top_probs"]) - ref_p).max()
        log(f"  {feats.shape[0]} videos: top-5 classes equal the plain "
            f"path; max|top_p - plain| = {err:.3e}; mean top-1 "
            f"probability {ref_p[:, 0].mean():.3f}")
        if not err <= PROB_TOL:
            raise AssertionError(f"top probabilities differ: {err}")
    return launches + serve_single(predictor.model, plain, requests[0])


def serve_single(model, plain, feats, calls=5):
    """A latency-first service answers each video as it arrives: batch 1,
    no padding to 64, where K1 runs at B=1 and splits D
    (ops/trn_fused.py::_fwd_splits).  Time ``calls`` calls on one video
    and hold their answers to the plain path; return their K1 launches."""
    single = Predictor(FLAGSHIP, model, batch_size=1, device="cuda")
    single(feats)
    reset_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        probs, top_p, top_i = single(feats)
        times.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    _, ref_p, ref_i = plain(feats)
    err = np.abs(top_p - ref_p).max()
    log(f"  batch-1 Predictor, 1 video: {statistics.median(times):.2f} ms "
        f"in process (median of {calls}); K1 at B=1 in "
        f"{trn_fused._fwd_splits(5, 3, 1, 512, 256)} D slices; top-5 "
        f"classes equal the plain path: {np.array_equal(top_i, ref_i)}; "
        f"max|top_p - plain| = {err:.3e}; launches {launched}")
    if launched != {"trn_fused_fwd": calls, "trn_fused_fwd_train": 0,
                    "trn_fused_bwd": 0, "gather_gemm": 0}:
        raise AssertionError(f"expected {calls} K1 (infer) launches")
    if not np.array_equal(top_i, ref_i) or not err <= PROB_TOL or \
            not np.allclose(probs.sum(1), 1.0, atol=PROB_TOL):
        raise AssertionError("batch-1 answers differ from the plain path")
    return calls


def reset_counts():
    trn_fused.launches = trn_fused.train_launches = 0
    trn_fused.bwd_launches = 0
    gather_gemm.launches = 0


def counts():
    return {"trn_fused_fwd": trn_fused.launches,
            "trn_fused_fwd_train": trn_fused.train_launches,
            "trn_fused_bwd": trn_fused.bwd_launches,
            "gather_gemm": gather_gemm.launches}


def flagship_model(gen, dropout=0.0):
    """The flagship on the card, every weight redrawn at torch's default
    scale (as for serving), so that the losses and gradients are far from
    those of a near-zero network."""
    cfg = dataclasses.replace(FLAGSHIP, dropout_i=dropout, dropout_v=dropout)
    model = VideoModel(cfg, generator=gen)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            torch_default_uniform_(mod, gen)
    return model.cuda()


def train_batch(seed=0):
    """128 source and 74 target videos of random 5x2048 features (numpy,
    seeded), on the card."""
    rng = np.random.default_rng(seed)
    bs, bt = TRAIN.batch_size[:2]
    shape = (FLAGSHIP.train_segments, FLAGSHIP.input_feature_dim)
    batch = (rng.random((bs, *shape), np.float32),
             rng.integers(0, FLAGSHIP.num_class, bs), np.ones(bs, np.float32),
             rng.random((bt, *shape), np.float32),
             rng.integers(0, FLAGSHIP.num_class, bt), np.ones(bt, np.float32))
    return [torch.as_tensor(a).cuda() for a in batch]


def scalars(i, total, beta_cfg):
    """The step's schedule values at step i of ``total``: DANN lr, and
    beta from ``beta_cfg`` (negative entries follow the DANN schedule)."""
    p = progress(i, 0, total)
    return StepScalars(effective_beta(beta_cfg, p), 0.0, 0.0, TRAIN.gamma,
                       dann_lr(TRAIN.lr, p))


def same_start(dst, src):
    """Make dst's parameters, buffers and momentum buffers copies of
    src's, so that the next step on each starts from the same point."""
    with torch.no_grad():
        for a, b in zip((*dst.model.parameters(), *dst.model.buffers()),
                        (*src.model.parameters(), *src.model.buffers())):
            if a.shape != b.shape:
                raise AssertionError("the two models differ in layout")
            a.copy_(b)
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))


def named(model):
    """A model's state by the names of the kernel model (the plain-TRN
    copy holds its TRN under TRN.trn)."""
    return {k.replace("TRN.trn.", "TRN."): v
            for k, v in model.state_dict().items()}


def check_metrics(i, got, want, ref):
    """Hold one step's metrics to STEP_RTOL; the largest relative
    difference."""
    worst = 0.0
    for key in want:
        if not math.isfinite(got[key]) or not math.isclose(
                got[key], want[key], rel_tol=STEP_RTOL):
            raise AssertionError(f"step {i}: {key} {got[key]} differs from "
                                 f"{ref} {want[key]}")
        worst = max(worst, abs(got[key] - want[key])
                    / max(abs(want[key]), 1e-30))
    return worst


def record_trn(model):
    """Hook the model's TRN: at each forward, record its input x (the
    shared FC's output after its relu, so (x > 0) is that relu's mask), z
    of its subsets by the plain version, and the relu masks of its subsets
    as this side computed them: the kernel's, saved for its backward, or
    the plain TRN's.  Returns the record and the hook's handle."""
    rec = {}
    plain = isinstance(model.TRN, PlainTRN)
    trn = model.TRN.trn if plain else model.TRN

    def hook(_, args, out):
        x = args[0].detach()
        ws = [q[1].weight.detach() for q in trn.fc_fusion_scales]
        bs = [q[1].bias.detach() for q in trn.fc_fusion_scales]
        with torch.no_grad():
            z = preacts(x, ws, bs, trn.num_frames)
            masks = (trn_fused.trn_multiscale_fwd_masks_plain(
                x, ws, bs, trn.num_frames, trn.subsample_num)[1] if plain
                     else out.grad_fn.saved_tensors[1])
        rec.update(x=x.clone(), z=z, masks=masks.clone())

    return rec, model.TRN.register_forward_hook(hook)


def tie_rows(ours, ref):
    """The parameter rows that a relu mask flipped at a rounding tie may
    have moved in this step, ``{name: {row: why}}``, and the number of
    masks flipped (TRN, shared FC), from the two sides' records (record_trn; ``ref`` gives z).  A TRN mask of subset s (scale
    i) and unit u feeds row u of scale i's weight and bias; a shared-FC
    relu mask of unit u feeds row u of the shared FC's weight and bias: a
    flip moves one video's term in that row's gradient, which may carry
    the row past PARAM_TOL after the step (on the H100: one TRN mask
    flipped at |z| = 5.0e-8 moved 5 entries of one row of W_2 by up to
    3.1e-5).  Raise where a mask differs at a value that is not a tie,
    beyond RTOL of the largest."""
    rows = {}
    scale_of = [i for i, sub in enumerate(
        build_relation_plan(FLAGSHIP.train_segments).subsets) for _ in sub]
    h = ref["z"].shape[1] // len(scale_of)
    differ = ours["masks"] != ref["masks"]
    z = ref["z"].abs()
    if (differ & (z > RTOL * max(1.0, z.max().item()))).any():
        raise AssertionError("a TRN mask differs where z is not a rounding "
                             "tie")
    for b, col in differ.nonzero().tolist():
        i, u = scale_of[col // h], col % h
        for p in ("weight", "bias"):
            rows.setdefault(f"TRN.fc_fusion_scales.{i}.1.{p}", {})[u] = (
                f"TRN mask of video {b}, subset {col // h} flipped at "
                f"|z| = {z[b, col].item():.2e}")
    differ = (ours["x"] > 0) != (ref["x"] > 0)
    top = torch.maximum(ours["x"], ref["x"])
    if (differ & (top > RTOL * max(1.0, ref["x"].max().item()))).any():
        raise AssertionError("a shared-FC relu mask differs where its "
                             "input is not a rounding tie")
    for b, f, u in differ.nonzero().tolist():
        for p in ("weight", "bias"):
            rows.setdefault(f"fc_feature_shared_source.{p}", {})[u] = (
                f"shared-FC relu of video {b}, frame {f} flipped at "
                f"{top[b, f, u].item():.2e}")
    return rows, (int((ours["masks"] != ref["masks"]).sum()),
                  int(differ.sum()))


def check_params(i, ours, ref, label, ties):
    """Hold the parameters after step i to PARAM_TOL, all but the rows
    that ``ties`` (tie_rows) names, and log each of those let through.
    Returns the largest difference of the rows held and the number let
    through."""
    ours, ref = named(ours), named(ref)
    worst, let_through = 0.0, 0
    for name, want in ref.items():
        diff = (ours[name] - want).abs()
        tol = PARAM_TOL["rtol"] * want.abs() + PARAM_TOL["atol"]
        beyond = (diff > tol).reshape(want.shape[0] if want.dim() else 1,
                                      -1).any(dim=1)
        rows = beyond.nonzero()[:, 0].tolist()
        allowed = ties.get(name, {})
        stray = [r for r in rows if r not in allowed]
        if stray:
            raise AssertionError(
                f"{name} after step {i} differs from {label} beyond the "
                f"tolerance in {len(stray)} rows fed by no rounding tie "
                f"(first {stray[:5]}), max|d| {diff.max().item():.3e}")
        for r in rows:
            log(f"    {name} row {r} let through, max|d| "
                f"{diff[r].max().item():.3e}: {allowed[r]}")
            diff[r] = 0.0
        let_through += len(rows)
        worst = max(worst, diff.max().item())
    return worst, let_through


def drift(runs, models):
    """How far two free-running trajectories from one start came apart:
    the largest relative difference of a metric over the steps and of the
    parameters at the end."""
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
              for a, b in zip(*runs) for k in b)
    ours, ref = named(models[0]), named(models[1])
    return rel, max((ours[k] - v).abs().max().item() for k, v in ref.items())


def run_free(net, make_step, batches, steps):
    """``steps`` steps of a fresh optimizer over ``batches`` (the step's
    arguments before its scalars); the metrics of each."""
    state = TrainState(net, make_optimizer(net.parameters(), TRAIN), 0)
    step, out = make_step(net), []
    for sc, args in zip(steps, batches):
        state, m = step(state, *args, sc, None)
        out.append({k: float(v) for k, v in m.items()})
    return out


def train_flagship(gen):
    """TRAIN_STEPS flagship steps through the kernels against the same
    steps of a copy whose TRN is the plain version, dropout 0, DANN lr and
    beta.  Before each step the kernel side takes the plain side's
    parameters and momentum (copied), and that step's metrics and updated
    parameters are held to STEP_RTOL and PARAM_TOL, but for the rows fed
    by a relu mask that the two sides flipped at a rounding tie
    (tie_rows): the check does not fork on summation order.  The drift of
    the two sides run free from one start is printed.  Returns the kernel
    launches of the kernel copy's steps."""
    model = flagship_model(gen)
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    free = (copy.deepcopy(model), copy.deepcopy(plain_model))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch()
    steps = [scalars(i, TRAIN_STEPS, (-1.0, -1.0, -1.0))
             for i in range(TRAIN_STEPS)]
    ker = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    ref = TrainState(plain_model, make_optimizer(plain_model.parameters(),
                                                 TRAIN), 0)
    ker_step = make_train_step(model, DA, TRAIN)
    ref_step = make_train_step(plain_model, DA, TRAIN)
    (rec, hook), (ref_rec, ref_hook) = map(record_trn, (model, plain_model))
    launches = dict.fromkeys(counts(), 0)
    worst_rel = worst = 0.0
    ties, flips = 0, (0, 0)
    for i, sc in enumerate(steps):
        same_start(ker, ref)
        reset_counts()
        ker, got = ker_step(ker, *batch, sc, None)
        torch.cuda.synchronize()
        launches = {k: n + counts()[k] for k, n in launches.items()}
        ref, want = ref_step(ref, *batch, sc, None)
        got = {k: float(v) for k, v in got.items()}
        want = {k: float(v) for k, v in want.items()}
        log(f"  step {i}: lr {sc.lr:.5f} beta {sc.beta[0]:.4f}: " + ", ".join(
            f"{k} {got[k]:.6f}/{want[k]:.6f}" for k in
            ("loss_c", "loss_a", "loss_e", "loss")) + " (kernel/plain)")
        worst_rel = max(worst_rel, check_metrics(i, got, want,
                                                 "the plain TRN's"))
        allowed, flipped = tie_rows(rec, ref_rec)
        diff, rows = check_params(i, model, plain_model, "the plain TRN's",
                                  allowed)
        worst, ties = max(worst, diff), ties + rows
        flips = tuple(map(sum, zip(flips, flipped)))
    hook.remove()
    ref_hook.remove()
    log(f"  each step from the same parameters: metrics within "
        f"{worst_rel:.3e} relative (tolerance {STEP_RTOL}), updated "
        f"parameters within {worst:.3e} (tolerance rtol "
        f"{PARAM_TOL['rtol']}, atol {PARAM_TOL['atol']}; relu masks "
        f"flipped at rounding ties: {flips[0]} TRN, {flips[1]} shared FC; "
        f"{ties} rows let through)")
    ours = model.state_dict()
    for name in ("fc_classifier_source.weight", "fc_classifier_source.bias"):
        if not torch.equal(ours[name], start[name]):
            raise AssertionError(f"{name} moved")
    moved = sum(not torch.equal(ours[k], start[k]) for k in ours)
    if moved != len(ours) - 2:
        raise AssertionError(f"{moved} of {len(ours)} parameters moved")
    runs = [run_free(net, lambda n: make_train_step(n, DA, TRAIN),
                     [batch] * TRAIN_STEPS, steps) for net in free]
    rel, param = drift(runs, free)
    log(f"  {moved} of {len(ours)} parameter tensors moved (all but "
        f"fc_classifier_source); run free from one start over "
        f"{TRAIN_STEPS} steps, kernel and plain drift apart by {rel:.3e} "
        f"relative in a metric and {param:.3e} in a parameter")
    log(f"  kernel launches in the kernel copy's {TRAIN_STEPS} steps: "
        f"{launches}")
    want_launches = {"trn_fused_fwd": 0, "trn_fused_fwd_train": TRAIN_STEPS,
                     "trn_fused_bwd": TRAIN_STEPS, "gather_gemm": 0}
    if launches != want_launches:
        raise AssertionError(f"expected {want_launches} launches")
    return launches


def device_profile(run, n, step_ms, label):
    """Profile ``run(n)`` (n steps back to back): device time by kernel
    per step, and the device's idle share against ``step_ms``, the
    unprofiled time of a step run back to back."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    idle = 1 - busy_ms / step_ms
    log(f"  profile of {n} {label}: device busy {busy_ms:.4f} ms per step, "
        f"{sum(e.count for e in kernels) // n} kernels per step; against "
        f"{step_ms:.3f} ms per step back to back, the device is idle "
        f"{100 * idle:.1f}% of the time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/step "
            f"{e.count // n:4d}x  {e.key[:90]}")
    return busy_ms, idle


def time_train_step(gen, warmup=3):
    """The published step (dropout 0.5, beta 0.75/0.75/0.5, DANN lr) with
    the kernel TRN and with the plain TRN, TIMED_STEPS steps each, in
    turns (plain, kernel, kernel, plain): median ms of a step (synchronised
    after each) and videos/s over the steps run back to back."""
    model = flagship_model(gen, dropout=0.5)
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    batch = train_batch(seed=1)
    videos = sum(TRAIN.batch_size[:2])
    runs = {}
    for name, net in (("kernel", model), ("plain", plain_model)):
        runs[name] = [TrainState(net, make_optimizer(net.parameters(),
                                                     TRAIN), 0),
                      make_train_step(net, DA, TRAIN),
                      torch.Generator("cuda").manual_seed(0)]
    times = {name: {"step_ms": [], "rate": []} for name in runs}

    def run(name, n, sync_each):
        state, step, rng = runs[name]
        per_step = []
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            state, metrics = step(state, *batch,
                                  scalars(state.step, 100, TRAIN.beta), rng)
            if sync_each:
                torch.cuda.synchronize()
                per_step.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_all
        runs[name][0] = state
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} step loss is not finite")
        return per_step, n * videos / seconds

    for name in runs:
        run(name, warmup, True)
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for name in order:
            per_step, _ = run(name, TIMED_STEPS, True)
            _, rate = run(name, TIMED_STEPS, False)
            times[name]["step_ms"] += per_step
            times[name]["rate"].append(rate)
    result = {}
    for name, t in times.items():
        result[name] = (statistics.median(t["step_ms"]),
                        statistics.median(t["rate"]))
        log(f"  {name} TRN: {result[name][0]:.3f} ms per step (median of "
            f"{len(t['step_ms'])}, synchronised each step); "
            f"{result[name][1]:.0f} videos/s ({TIMED_STEPS} steps back to "
            f"back, median of {len(t['rate'])})")

    # where the kernel step's time goes: device time by kernel over a few
    # steps, against the unprofiled time of a step run back to back
    device_profile(lambda n: run("kernel", n, False), 5,
                   videos / result["kernel"][1] * 1e3, "kernel-TRN steps")
    return result


def gather_case(n, num_rows, rng):
    """n indices into a store of num_rows rows with duplicates, the last
    row and two masked rows (the loader points them at row 0, scale 0),
    checked and uploaded; and their scales on the card."""
    idx = rng.integers(0, num_rows, n)
    scale = np.ones(n, np.float32)
    if n >= 6:
        idx[:3] = [idx[2], idx[2], num_rows - 1]
        idx[3:5], scale[3:5] = 0, 0.0
    return (gather_gemm.row_index(idx, num_rows, "cuda"),
            torch.from_numpy(scale).cuda())


def check_gather_kernel(store):
    """K3 against gathered_gemm_plain on the source store at every row
    count of K3_CASES: z within the tolerance, x_res (the scaled gathered
    rows) bitwise equal, a second call bitwise equal; then on a store and
    a weight on dyadic grids, where every f32 sum is exact, z bit for bit.
    Returns the largest error on the float inputs."""
    rng = np.random.default_rng(2)
    h, d = FLAGSHIP.fc_dim, store.shape[1]
    w = (torch.from_numpy(rng.uniform(-1, 1, (h, d)).astype(np.float32))
         / math.sqrt(d)).cuda()
    grid_store = torch.from_numpy(
        (rng.integers(-8, 17, (4096, d)) * 2.0 ** -4).astype(np.float32)
    ).cuda()
    grid_w = torch.from_numpy(
        (rng.integers(-16, 17, (h, d)) * 2.0 ** -8).astype(np.float32)
    ).cuda()
    worst = 0.0
    for n in K3_CASES:
        rows, scale = gather_case(n, store.shape[0], rng)
        z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale)
        again, _ = gather_gemm.gathered_gemm(store, rows, w, scale)
        want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, w,
                                                       scale)
        grows, gscale = gather_case(n, grid_store.shape[0], rng)
        grid_z, _ = gather_gemm.gathered_gemm(grid_store, grows, grid_w,
                                              gscale)
        grid_want, _ = gather_gemm.gathered_gemm_plain(
            grid_store, grows.rows, grid_w, gscale)
        torch.cuda.synchronize()
        if z.shape != (n, h) or not torch.isfinite(z).all():
            raise AssertionError(f"K3 output bad at N={n}")
        err = (z - want).abs().max().item() if n else 0.0
        tol = RTOL * max(1.0, want.abs().max().item() if n else 0.0)
        exact = [torch.equal(x_res, want_x), torch.equal(z, again),
                 torch.equal(grid_z, grid_want)]
        log(f"  K3 N={n} D={d} H={h}: max|kernel-plain| = {err:.3e} "
            f"(tolerance {tol:.3e}); x_res equal to plain, second call "
            f"equal, exact inputs equal to plain: {exact}")
        if not err <= tol or not all(exact):
            raise AssertionError(f"K3 disagrees with plain at N={n}")
        worst = max(worst, err)
    return worst


def gather_work(rows, d, h, with_rows):
    """FLOPs and the least bytes of K3 for these index rows: each distinct
    store row read once, idx and scale read, W read once, z written and,
    with x_res, the gathered rows written."""
    n = rows.rows.shape[0]
    distinct = torch.unique(rows.rows).numel()
    nbytes = 4 * (distinct * d + 2 * n + h * d + n * h
                  + (n * d if with_rows else 0))
    return 2 * n * d * h, nbytes


def time_gather(store):
    """Device times of K3, its plain version and the index_select + mm
    pair at the train (with x_res) and eval (without) row counts, 41 runs
    each in turns; the work and bound of each case."""
    rng = np.random.default_rng(3)
    h, d = FLAGSHIP.fc_dim, store.shape[1]
    w = (torch.rand((h, d), generator=torch.Generator().manual_seed(3))
         * 2 - 1).cuda() / math.sqrt(d)
    results = {}
    with torch.no_grad():
        for n, with_rows in K3_TIMED:
            rows, scale = gather_case(n, store.shape[0], rng)
            t = time_pair({
                "kernel": lambda: gather_gemm.gathered_gemm(
                    store, rows, w, scale, with_rows),
                "plain": lambda: gather_gemm.gathered_gemm_plain(
                    store, rows.rows, w, scale),
                "library": lambda: torch.mm(
                    store.index_select(0, rows.rows), w.t())})
            work = gather_work(rows, d, h, with_rows)
            results[n] = (t, work)
            least, by = bound(*work, PEAK_OPS["gather_gemm"])
            log(f"  K3 N={n} {'with' if with_rows else 'without'} x_res: "
                f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
                f"index_select + mm {t['library']:.4f} ms device; bound "
                f"{least:.4f} ms by {by} (medians of 41, in turns)")
    return results


def bwd_parts(x, w, masks, g, parts):
    """K2's tiles of one family (parts 1: dx, 2: dW/db) or both (3),
    through the C entry that takes the choice; not counted as a launch of
    the backward.  Returns (dx, dWs, dbs), each written only by its own
    family."""
    b, s, d = x.shape
    h = w[0].shape[0]
    dx = torch.zeros_like(x)
    dw = torch.zeros((sum(t.numel() for t in w),), device=x.device)
    db = torch.zeros((len(w), h), device=x.device)
    trn_fused._call("ta3n_trn_fused_bwd_parts_f32", x, x.data_ptr(),
                    *trn_fused._pointer_args(w, (), s, 3, x.device),
                    masks.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                    *trn_fused._plan_args(s, 3, x.device), b, s, d, h, parts)
    return dx, trn_fused._split_flat(dw, w), tuple(db.unbind())


def split_bwd(gen, b=202, n=20):
    """K2's device time by the profiler at the train batch: the dx tiles
    alone, the dW/db tiles alone and both in one grid (the backward), n
    launches each; each family alone must give the backward's bits.
    Returns ms per launch of each."""
    from torch.profiler import ProfilerActivity, profile
    x, w, bi = trn_inputs(b, 5, 512, 256, gen, signed=True)
    g = torch.randn((b, 4, 256), generator=gen).cuda()
    result = {}
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
        full = bwd_parts(x, w, masks, g, 3)
        dx_only, dw_only = bwd_parts(x, w, masks, g, 1), \
            bwd_parts(x, w, masks, g, 2)
        torch.cuda.synchronize()
        if not (torch.equal(dx_only[0], full[0]) and all(
                torch.equal(a, r) for a, r in
                zip((*dw_only[1], *dw_only[2]), (*full[1], *full[2])))):
            raise AssertionError("K2's families alone differ from the "
                                 "backward")
        for name, parts in (("dx", 1), ("dW", 2), ("both", 3)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    bwd_parts(x, w, masks, g, parts)
                torch.cuda.synchronize()
            result[name] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if "trn_fused_bwd_kernel" in e.key) / 1e3 / n
    log(f"  K2 at B={b} by the profiler: dx tiles alone "
        f"{result['dx']:.4f} ms, dW/db tiles alone {result['dW']:.4f} ms, "
        f"both in one grid {result['both']:.4f} ms (means of {n}; the "
        f"families alone sum to {result['dx'] + result['dW']:.4f} ms)")
    return result


def store_loaders(stores, seed=1):
    """Source and target loaders as the Trainer makes them ('test'
    sampling, shuffled): 128 + 74 videos a step."""
    bs, bt = TRAIN.batch_size[:2]
    s = FLAGSHIP.train_segments
    return (TSNLoader(stores[0], batch_size=bs, num_segments=s, seed=seed),
            TSNLoader(stores[1], batch_size=bt, num_segments=s,
                      seed=seed + 1))


def endless(epochs):
    """The batches of epoch after epoch: ``epochs`` is a loader's bound
    epoch() or index_epoch()."""
    while True:
        yield from epochs()


def train_device_store(gen, stores, dev):
    """TRAIN_STEPS device-store steps (index batches, K3 twice per step)
    against as many host-feature steps on the same batches, where the host
    gathers the features; dropout 0, DANN lr and beta.  Before each step
    the device-store side takes the host-feature side's parameters and
    momentum (copied), and that step's metrics and updated parameters are
    held to STEP_RTOL and PARAM_TOL, but for the rows fed by a relu mask
    that the two sides flipped at a rounding tie (tie_rows); the drift of
    the two run free from one start is printed.  Returns the kernel
    launches of the device-store steps."""
    model = flagship_model(gen)
    host_model = copy.deepcopy(model)
    free = (copy.deepcopy(model), copy.deepcopy(host_model))
    steps = [scalars(i, TRAIN_STEPS, (-1.0, -1.0, -1.0))
             for i in range(TRAIN_STEPS)]

    def index_batches():
        idx_s, idx_t = store_loaders(stores)
        return ((dev[0], *bs, dev[1], *bt) for bs, bt in
                zip(endless(idx_s.index_epoch), endless(idx_t.index_epoch)))

    def feature_batches():
        feat_s, feat_t = store_loaders(stores)
        return ((*hs, *ht) for hs, ht in
                zip(endless(feat_s.epoch), endless(feat_t.epoch)))

    state = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    step = make_train_step(model, DA, TRAIN, gather_on_device=True)
    host_state = TrainState(host_model,
                            make_optimizer(host_model.parameters(), TRAIN), 0)
    host_step = make_train_step(host_model, DA, TRAIN)
    (rec, hook), (ref_rec, ref_hook) = map(record_trn, (model, host_model))
    launches = dict.fromkeys(counts(), 0)
    worst_rel = worst = 0.0
    ties, flips = 0, (0, 0)
    for i, (sc, args, host_args) in enumerate(zip(steps, index_batches(),
                                                 feature_batches())):
        same_start(state, host_state)
        # each device-store step is counted alone; the host-feature
        # reference step after it is not counted
        reset_counts()
        state, got = step(state, *args, sc, None)
        torch.cuda.synchronize()
        launched = counts()
        if launched != {"trn_fused_fwd": 0, "trn_fused_fwd_train": 1,
                        "trn_fused_bwd": 1, "gather_gemm": 2}:
            raise AssertionError(f"step {i} launched {launched}")
        launches = {k: launches[k] + launched[k] for k in launches}
        host_state, want = host_step(host_state, *host_args, sc, None)
        got = {k: float(v) for k, v in got.items()}
        want = {k: float(v) for k, v in want.items()}
        log(f"  step {i}: " + ", ".join(
            f"{k} {got[k]:.6f}/{want[k]:.6f}" for k in
            ("loss_c", "loss_a", "loss_e", "loss"))
            + " (device store/host features); launched " + str(launched))
        worst_rel = max(worst_rel, check_metrics(
            i, got, want, "the host-feature step's"))
        allowed, flipped = tie_rows(rec, ref_rec)
        diff, rows = check_params(i, model, host_model,
                                  "the host-feature step's", allowed)
        worst, ties = max(worst, diff), ties + rows
        flips = tuple(map(sum, zip(flips, flipped)))
    hook.remove()
    ref_hook.remove()
    runs = [run_free(free[0], lambda n: make_train_step(
                n, DA, TRAIN, gather_on_device=True), index_batches(), steps),
            run_free(free[1], lambda n: make_train_step(n, DA, TRAIN),
                     feature_batches(), steps)]
    rel, param = drift(runs, free)
    log(f"  each step from the same parameters: metrics within "
        f"{worst_rel:.3e} relative (tolerance {STEP_RTOL}), updated "
        f"parameters within {worst:.3e} (tolerance rtol "
        f"{PARAM_TOL['rtol']}, atol {PARAM_TOL['atol']}; relu masks "
        f"flipped at rounding ties: {flips[0]} TRN, {flips[1]} shared FC; "
        f"{ties} rows let through); run free from "
        f"one start over {TRAIN_STEPS} steps, they drift apart by {rel:.3e} "
        f"relative in a metric and {param:.3e} in a parameter; "
        f"device-store launches {launches}")
    return launches


def time_store_steps(gen, stores, dev, warmup=3):
    """The published step (dropout 0.5) fed from the stores on the card
    (index batches) and from host-gathered features, each from its own
    loaders, TIMED_STEPS steps back to back in turns (host, device,
    device, host): videos/s over the real (unmasked) videos, and the
    device's idle share of each under the profiler."""
    model = flagship_model(gen, dropout=0.5)
    host_model = copy.deepcopy(model)
    idx_s, idx_t = store_loaders(stores, seed=5)
    feat_s, feat_t = store_loaders(stores, seed=5)
    runs = {
        "device store": [
            TrainState(model, make_optimizer(model.parameters(), TRAIN), 0),
            make_train_step(model, DA, TRAIN, gather_on_device=True),
            zip(endless(idx_s.index_epoch), endless(idx_t.index_epoch)),
            lambda bs, bt: (dev[0], *bs, dev[1], *bt)],
        "host features": [
            TrainState(host_model, make_optimizer(host_model.parameters(),
                                                  TRAIN), 0),
            make_train_step(host_model, DA, TRAIN),
            zip(endless(feat_s.epoch), endless(feat_t.epoch)),
            lambda bs, bt: (*bs, *bt)]}
    rngs = {name: torch.Generator("cuda").manual_seed(0) for name in runs}

    def run(name, n):
        state, step, batches, args = runs[name]
        videos = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            bs, bt = next(batches)
            videos += float(bs.mask.sum() + bt.mask.sum())
            state, metrics = step(state, *args(bs, bt),
                                  scalars(state.step, 100, TRAIN.beta),
                                  rngs[name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[name][0] = state
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} step loss is not finite")
        return videos / seconds, seconds * 1e3 / n

    for name in runs:
        run(name, warmup)
    rates = {name: [] for name in runs}
    for order in (("host features", "device store"),
                  ("device store", "host features")):
        for name in order:
            rates[name].append(run(name, TIMED_STEPS))
    result = {}
    for name, r in rates.items():
        rate = statistics.median(x[0] for x in r)
        step_ms = statistics.median(x[1] for x in r)
        log(f"  {name}: {rate:.0f} videos/s, {step_ms:.3f} ms per step "
            f"({TIMED_STEPS} steps back to back with their loader, median "
            f"of {len(r)})")
        busy, idle = device_profile(lambda n: run(name, n), 5, step_ms,
                                    f"{name} steps")
        result[name] = (rate, step_ms, busy, idle)
    return result


def eval_device_store(gen, val, dev_val):
    """One val epoch (batches of 64, the last one padded) through
    make_multi_eval_step on the store on the card, against the summed
    host-feature eval steps with the same weights.  Returns the kernel
    launches of the multi-batch eval."""
    model = flagship_model(gen)
    loader = TSNLoader(val, batch_size=TRAIN.batch_size[2],
                       num_segments=FLAGSHIP.val_segments, shuffle=False)
    ev = make_eval_step(model)
    want = {"loss_sum": 0.0, "top1": 0.0, "top5": 0.0, "n": 0.0}
    for batch in loader.epoch():
        m = ev(*batch)
        for key, value in (("loss_sum", m["loss"] * m["n"]),
                           ("top1", m["top1"]), ("top5", m["top5"]),
                           ("n", m["n"])):
            want[key] += float(value)
    stacked = [np.stack(a) for a in zip(*loader.index_epoch())]
    reset_counts()
    t0 = time.perf_counter()
    got = {k: float(v) for k, v in
           make_multi_eval_step(model)(dev_val, *stacked).items()}
    seconds = time.perf_counter() - t0
    launches = counts()
    nb = len(loader)
    log(f"  {nb} batches of {TRAIN.batch_size[2]} ({int(got['n'])} videos)"
        f" in {seconds * 1e3:.2f} ms (one fetch): loss_sum "
        f"{got['loss_sum']:.6f}/{want['loss_sum']:.6f}, top1 "
        f"{got['top1']:.0f}/{want['top1']:.0f}, top5 {got['top5']:.0f}/"
        f"{want['top5']:.0f}, n {got['n']:.0f}/{want['n']:.0f} (device "
        f"store/host features); launches {launches}")
    if any(got[k] != want[k] for k in ("top1", "top5", "n")) or \
            got["n"] != len(val.paths) or not math.isclose(
                got["loss_sum"], want["loss_sum"], rel_tol=EVAL_RTOL):
        raise AssertionError("the device-store val epoch differs from the "
                             "host-feature eval")
    if launches != {"trn_fused_fwd": nb, "trn_fused_fwd_train": 0,
                    "trn_fused_bwd": 0, "gather_gemm": nb}:
        raise AssertionError(f"expected {nb} K1 (infer) and K3 launches")
    return launches


def trn_many_frames(gen):
    """K1 (infer) at B=64, K1 (train) and K2 at B=202, at the flagship
    widths and S = 17 and 25: each checked once against its plain version
    (K2 from the kernel's masks; the masks equal but at ties; on dyadic
    inputs bit for bit), then timed against it in turns.  Returns the
    launches of the checked calls and {S: {kernel: (ms, plain ms)}}."""
    relation.build_relation_plan.cache_clear()
    trn_fused._plan_table.cache_clear()
    t0 = time.perf_counter()
    trn_fused._plan_table(25, 3)
    log(f"  S=25 plan and kernel table built on the host in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms "
        f"({trn_fused._plan_table(25, 3).size} int32)")
    launches = dict.fromkeys(counts(), 0)
    rng = np.random.default_rng(4)
    results = {}
    for s in MANY_FRAMES:
        x, w, bi = trn_inputs(SERVE_BATCH, s, 512, 256, gen)
        with torch.inference_mode():
            reset_counts()
            got = trn_fused.trn_multiscale_infer(x, w, bi, s)
            torch.cuda.synchronize()
            launched = counts()
            want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            err = (got - want).abs().max().item()
            if not err <= RTOL * max(1.0, want.abs().max().item()):
                raise AssertionError(f"K1 (infer) disagrees at S={s}: {err}")
            infer_t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_infer(x, w, bi, s),
                "plain": lambda: trn_fused.trn_multiscale_plain(x, w, bi, s)})
        b = sum(TRAIN.batch_size[:2])
        x, w, bi = trn_inputs(b, s, 512, 256, gen, signed=True)
        g = torch.randn((b, s - 1, 256), generator=gen).cuda()
        with torch.no_grad():
            reset_counts()
            out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            dx, dws, dbs = trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
            torch.cuda.synchronize()
            launched = {k: launched[k] + n for k, n in counts().items()}
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, s)
            ref = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
            z = preacts(x, w, bi, s)
            fwd_err = (out - want).abs().max().item()
            differ = masks != want_masks
            bwd_err = max((a - r).abs().max().item() / max(
                1.0, r.abs().max().item()) for a, r in
                zip((dx, *dws, *dbs), (ref[0], *ref[1], *ref[2])))
            if not fwd_err <= RTOL * max(1.0, want.abs().max().item()) or \
                    not bwd_err <= RTOL or not (
                        z[differ].abs()
                        <= RTOL * max(1.0, z.abs().max().item())).all():
                raise AssertionError(f"K1 (train) or K2 disagrees at S={s}")
            gx, gw, gb, gg = grid_inputs(b, s, 512, 256, rng)
            gout, gmasks = trn_fused.trn_multiscale_fwd_masks(gx, gw, gb, s)
            gwant, gwant_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                gx, gw, gb, s)
            gbwd = trn_fused.trn_multiscale_bwd(gx, gw, gwant_masks, gg, s)
            gref = trn_fused.trn_multiscale_bwd_plain(gx, gw, gwant_masks,
                                                      gg, s)
            exact = [torch.equal(gout, gwant), torch.equal(gmasks, gwant_masks)]
            exact += [torch.equal(a, r) for a, r in zip(
                (gbwd[0], *gbwd[1], *gbwd[2]), (gref[0], *gref[1], *gref[2]))]
            if not all(exact):
                raise AssertionError(f"S={s}: kernels differ from plain on "
                                     "exact inputs")
            fwd_t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_fwd_masks(
                    x, w, bi, s),
                "plain": lambda: trn_fused.trn_multiscale_fwd_masks_plain(
                    x, w, bi, s)})
            bwd_t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_bwd(
                    x, w, masks, g, s),
                "plain": lambda: trn_fused.trn_multiscale_bwd_plain(
                    x, w, masks, g, s)})
        if launched != {"trn_fused_fwd": 1, "trn_fused_fwd_train": 1,
                        "trn_fused_bwd": 1, "gather_gemm": 0}:
            raise AssertionError(f"S={s} launched {launched}")
        launches = {k: launches[k] + n for k, n in launched.items()}
        slots = sum(n for _, _, n in trn_fused._fwd_units(s, 3))
        log(f"  S={s} ({slots} slots, K1 scratch "
            f"{slots * b * 256 * 4 / 1e6:.0f} MB at B={b}): max|kernel-plain|"
            f" K1 (infer) {err:.3e}, K1 (train) {fwd_err:.3e}, K2 "
            f"{bwd_err:.3e} relative; {int(differ.sum())} of {masks.numel()}"
            f" masks differ, at ties; exact inputs bitwise equal to plain")
        results[s] = {}
        for name, bb, t in (("trn_fused_fwd", SERVE_BATCH, infer_t),
                            ("trn_fused_fwd_train", b, fwd_t),
                            ("trn_fused_bwd", b, bwd_t)):
            least, by = bound(*trn_work(bb, s)[name], PEAK_OPS[name])
            results[s][name] = (t["kernel"], t["plain"], least)
            log(f"  S={s} {name} B={bb}: kernel {t['kernel']:.4f} ms, plain "
                f"{t['plain']:.4f} ms, bound {least:.4f} ms by {by} "
                "(device, medians of 41 in turns)")
    return launches, results


def write_workspace(root, stores):
    """The stores with their list files (as the JAX package writes them)
    and a class file of the flagship's 12 classes, under root."""
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(os.path.join(root, name))
        with open(os.path.join(root, name, "list.txt"), "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    with open(os.path.join(root, "class.txt"), "w") as f:
        for i in range(FLAGSHIP.num_class):
            f.write(f"{i} class_{i}\n")


def run_cli(main_fn, argv):
    """Run a CLI's main in process; its return value and its output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    return result, buf.getvalue()


def eval_cli_args(root, weights, *extra):
    return [os.path.join(root, "class.txt"), "RGB",
            os.path.join(root, "val", "list.txt"), weights, *MODEL_FLAGS,
            "--test_segments", "5", "--bS", str(CLI_BATCH), "--top", "1",
            "3", "5", *extra]


def eval_cli(gen, root, val):
    """The eval CLI on the val store and a seed model's .pth.tar, from
    host features and with --device_store (scores, confusion and
    attention saved): its scores against a plain-path forward of the same
    weights, the two Pred@k lines equal, and its launches (host: one K1
    (infer) per batch; store: one K1 (infer) and one K3 per batch)."""
    model = flagship_model(gen)
    weights = os.path.join(root, "seed.pth.tar")
    torch.save({"epoch": 0, "arch": "resnet101", "best_prec1": 0.0,
                "prec1": 0.0,
                "state_dict": {f"module.{k}": v.cpu() for k, v in
                               model.state_dict().items()}}, weights)
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    plain = Predictor(FLAGSHIP, plain_model, batch_size=CLI_BATCH,
                      device="cuda")
    loader = TSNLoader(val, batch_size=CLI_BATCH, num_segments=5,
                       shuffle=False)
    feats = np.concatenate([b.features[:int(b.mask.sum())]
                            for b in loader.epoch()])
    want = plain(feats)[0][np.argsort(np.array(val.paths), kind="stable")]
    nb = len(loader)
    lines, launches = {}, dict.fromkeys(counts(), 0)
    for label, extra, k3 in (("host features", [], 0),
                             ("device store", ["--device_store"], nb)):
        prefix = os.path.join(root, label.replace(" ", "_"))
        reset_counts()
        t0 = time.perf_counter()
        line, out = run_cli(cli_test_models.main, eval_cli_args(
            root, weights, "--save_scores", prefix + "_scores",
            "--save_confusion", prefix + "_conf", "--save_attention",
            prefix + "_attn", *extra))
        seconds = time.perf_counter() - t0
        launched = counts()
        scores = np.load(prefix + "_scores.npz")["scores"]
        attn = np.loadtxt(prefix + "_attn.txt")
        err = np.abs(scores - want).max()
        log(f"  {label}: {line.strip()}; {out.splitlines()[-2].strip()}; "
            f"{seconds:.2f} s in main; max|scores - plain| = {err:.3e}; "
            f"attention {attn.shape}; launches {launched}")
        if scores.shape != want.shape or not err <= PROB_TOL or \
                attn.shape != (len(val.paths), 4) or not os.path.isfile(
                    prefix + "_conf-top[1, 3, 5].txt"):
            raise AssertionError(f"eval CLI ({label}) output is wrong")
        if launched != {"trn_fused_fwd": nb, "trn_fused_fwd_train": 0,
                        "trn_fused_bwd": 0, "gather_gemm": k3}:
            raise AssertionError(f"eval CLI ({label}) launched {launched}")
        lines[label] = line
        launches = {k: launches[k] + n for k, n in launched.items()}
    if len(set(lines.values())) != 1:
        raise AssertionError(f"the eval CLI's Pred@k lines differ: {lines}")
    return launches


@contextlib.contextmanager
def trainer_records():
    """Record every epoch and validation the Trainer runs: its kernel
    launches (counted from 0 over the call), its time (synchronised), and
    for an epoch its lr at entry, its steps and its real videos."""
    records = []
    epoch_fn, validate_fn = Trainer.train_epoch, Trainer.validate

    def timed(fn, self, kind, epoch):
        lr = self.lr_current
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, epoch)
        torch.cuda.synchronize()
        rec = {"kind": kind, "epoch": epoch, "lr": lr, "out": out,
               "seconds": time.perf_counter() - t0, "launches": counts(),
               "store": self.device_store}
        if kind == "train":
            rec["steps"] = min(len(self.source_loader),
                               len(self.target_loader))
            rec["videos"] = (self.source_loader.num_videos
                             + self.target_loader.num_videos)
        else:
            rec["batches"] = len(self.val_loader)
        records.append(rec)
        return out

    Trainer.train_epoch = lambda self, e: timed(epoch_fn, self, "train", e)
    Trainer.validate = lambda self, e: timed(validate_fn, self, "val", e)
    try:
        yield records
    finally:
        Trainer.train_epoch, Trainer.validate = epoch_fn, validate_fn


def check_trainer_launches(rec):
    """One parametrised check for every epoch and validation: per train
    step 1 K1 (train), 1 K2 and, from the stores, 2 K3; per val batch
    1 K1 (infer) and, from the store, 1 K3."""
    if rec["kind"] == "train":
        n = rec["steps"]
        want = {"trn_fused_fwd": 0, "trn_fused_fwd_train": n,
                "trn_fused_bwd": n, "gather_gemm": 2 * n * rec["store"]}
    else:
        n = rec["batches"]
        want = {"trn_fused_fwd": n, "trn_fused_fwd_train": 0,
                "trn_fused_bwd": 0, "gather_gemm": n * rec["store"]}
    if rec["launches"] != want:
        raise AssertionError(f"{rec['kind']} epoch {rec['epoch']} launched "
                             f"{rec['launches']}, expected {want}")


def train_cli(root):
    """The Trainer through the train CLI on the stores under root: 2 epochs
    from the device stores with --save_model, then --resume_hp to epoch 3,
    then one epoch from host features; the launches of every epoch and
    validation checked; the resumed run's start (epoch 3, the saved lr,
    the log separator); the eval CLI on model_best.pth.tar against the
    best Prec@1 printed.  Returns the summed launches."""
    lists = [os.path.join(root, n, "list.txt") for n in ("src", "tgt", "val")]
    exp = os.path.join(root, "exp")
    ckpt = os.path.join(exp, "RGB", "checkpoint.pth.tar")

    def argv(exp_dir, *extra):
        return [os.path.join(root, "class.txt"), "RGB", *lists, *MODEL_FLAGS,
                *RECIPE_FLAGS, "--exp_path", exp_dir + "/",
                "--save_best_log", os.path.join(exp_dir, "best.log"), *extra]

    runs = (("device store, 2 epochs", argv(exp, "--device_store",
                                            "--save_model", "--epochs", "2")),
            ("device store, --resume_hp to epoch 3",
             argv(exp, "--device_store", "--save_model", "--epochs", "3",
                  "--resume", ckpt, "--resume_hp")),
            ("host features, 1 epoch", argv(os.path.join(root, "exp_host"),
                                            "--epochs", "1")))
    launches = dict.fromkeys(counts(), 0)
    best_seen = 0.0
    for i, (label, args) in enumerate(runs):
        if i == 1:
            saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        with trainer_records() as records:
            best, out = run_cli(cli_train.main, args)
        for rec in records:
            check_trainer_launches(rec)
            launches = {k: launches[k] + n
                        for k, n in rec["launches"].items()}
            if rec["kind"] == "train":
                log(f"  {label}: epoch {rec['epoch']} {rec['seconds']:.3f} s"
                    f", {rec['steps']} steps, {rec['videos']} videos, "
                    f"{rec['videos'] / rec['seconds']:.0f} videos/s (lr "
                    f"{rec['lr']:.5f} at entry; launches {rec['launches']})")
            else:
                log(f"  {label}: validation after epoch {rec['epoch']}: "
                    f"Prec@1 {rec['out']:.3f} in {rec['seconds'] * 1e3:.1f}"
                    f" ms ({rec['batches']} batches)")
                if i < 2:
                    best_seen = max(best_seen, rec["out"])
        log(f"  {label}: best {best:.3f}; "
            + out.strip().splitlines()[-1].strip())
        if i == 1:
            first = [r for r in records if r["kind"] == "train"][0]
            log_text = open(os.path.join(exp, "RGB", "train.log")).read()
            if first["epoch"] != 3 or first["lr"] != saved["lr_current"] or \
                    "========== start:" not in log_text or \
                    "=> loaded checkpoint" not in out:
                raise AssertionError(
                    f"the resumed run started at epoch {first['epoch']} with "
                    f"lr {first['lr']} (saved {saved['lr_current']})")
            log(f"  resumed at epoch 3 with the saved lr_current "
                f"{saved['lr_current']:.6f} and step {saved['step']}; "
                "train.log has the start separator")
    reset_counts()
    line, _ = run_cli(cli_test_models.main, eval_cli_args(
        root, os.path.join(exp, "RGB", "model_best.pth.tar"),
        "--device_store"))
    launched = counts()
    pred1 = float(line.split()[1].rstrip("%"))
    log(f"  eval CLI on model_best.pth.tar: {line.strip()} (best Prec@1 "
        f"printed {best_seen:.3f}); launches {launched}")
    if abs(pred1 - best_seen) > 0.006:
        raise AssertionError(f"Pred@1 {pred1} is not the best Prec@1 "
                             f"{best_seen}")
    return {k: launches[k] + launched[k] for k in launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    log("build: nvcc for sm_90a")
    log(f"  built {_build.library_path().name} in "
        f"{build_kernels():.1f} s")
    check_sass()

    gen = torch.Generator().manual_seed(0)
    log("K1 (infer) vs plain")
    max_err = {"trn_fused_fwd": check_trn_kernel(gen)}
    log("K1 (train) and K2 vs plain")
    worst = check_train_kernels(gen)
    max_err["trn_fused_fwd_train"] = worst["fwd"]
    max_err["trn_fused_bwd"] = worst["bwd"]

    log("feature stores of the published split sizes, uploaded once")
    t0 = time.perf_counter()
    stores = make_domain_pair(**SPLITS, num_class=FLAGSHIP.num_class,
                              feature_dim=FLAGSHIP.input_feature_dim)
    dev = [store.to_device() for store in stores]
    torch.cuda.synchronize()
    log("  " + ", ".join(
        f"{name} {store.num_videos} videos, {t.shape[0]} rows, "
        f"{t.numel() * 4 / 1e9:.3f} GB" for name, store, t in
        zip(("source", "target", "val"), stores, dev))
        + f" (made and uploaded in {time.perf_counter() - t0:.1f} s)")
    log("K3 vs plain")
    max_err["gather_gemm"] = check_gather_kernel(dev[0])

    log("kernel times")
    times = time_trn(gen)
    log("  K1's D slices (ops/trn_fused.py::_fwd_splits): " + ", ".join(
        f"B={b} {trn_fused._fwd_splits(5, 3, b, 512, 256)}"
        for b in TIMED_BATCHES))
    fwd_t, bwd_t = time_train_kernels(gen)
    bwd_split = split_bwd(gen)
    gather_t = time_gather(dev[0])
    t64 = times[SERVE_BATCH]
    k3_t, k3_work = gather_t[K3_TIMED[0][0]]
    k3_eval_t, k3_eval_work = gather_t[K3_TIMED[1][0]]
    ms = {"trn_fused_fwd": (t64[("kernel", "device")],
                            t64[("plain", "device")], None),
          "trn_fused_fwd_train": (fwd_t["kernel"], fwd_t["plain"], None),
          "trn_fused_bwd": (bwd_t["kernel"], bwd_t["plain"], None),
          "gather_gemm": (k3_t["kernel"], k3_t["plain"], k3_t["library"])}

    # each path's launches, counted from 0 over its own run, summed per
    # kernel over the paths that launch it
    launches = dict.fromkeys(counts(), 0)

    def add(path_launches):
        for name, n in path_launches.items():
            launches[name] += n

    log("flagship serving over HTTP")
    with tempfile.TemporaryDirectory() as workdir:
        add({"trn_fused_fwd": serve_flagship(gen, workdir)})

    log(f"flagship train step, {TRAIN.batch_size[0]} + "
        f"{TRAIN.batch_size[1]} videos: kernel TRN vs plain TRN")
    add(train_flagship(gen))
    log("flagship train step timing (dropout 0.5)")
    time_train_step(gen)

    log(f"device-store train step, {TRAIN.batch_size[0]} + "
        f"{TRAIN.batch_size[1]} videos: against the host-feature step")
    add(train_device_store(gen, stores, dev))
    log("device-store against host-feature train step timing (dropout 0.5)")
    time_store_steps(gen, stores, dev)

    log("device-store eval: one val epoch")
    add(eval_device_store(gen, stores[2], dev[2]))

    log(f"the TRN beyond 16 segments: S = {MANY_FRAMES}")
    many_launches, many = trn_many_frames(gen)
    add(many_launches)
    with tempfile.TemporaryDirectory() as root:
        write_workspace(root, stores)
        log(f"eval CLI: {len(stores[2].paths)} videos at --bS {CLI_BATCH}")
        add(eval_cli(gen, root, stores[2]))
        log("Trainer through the train CLI: the published recipe on "
            "stores of the published split sizes")
        add(train_cli(root))
        log(card_line())

    # the shapes each kernel runs at on its path: serving batch, train batch
    work = {**{k: v for k, v in trn_work(SERVE_BATCH).items()
               if k == "trn_fused_fwd"},
            **{k: v for k, v in trn_work(sum(TRAIN.batch_size[:2])).items()
               if k != "trn_fused_fwd"},
            "gather_gemm": k3_work}
    sources = {
        "trn_fused_fwd": ("ta3n_tpu_torch/csrc/trn_fused_fwd.cu",
                          "ta3n_tpu/ops/trn_fused.py:68"),
        "trn_fused_fwd_train": ("ta3n_tpu_torch/csrc/trn_fused_fwd.cu",
                                "ta3n_tpu/ops/trn_fused.py:68"),
        "trn_fused_bwd": ("ta3n_tpu_torch/csrc/trn_fused_bwd.cu",
                          "ta3n_tpu/ops/trn_fused.py:187"),
        "gather_gemm": ("ta3n_tpu_torch/csrc/gather_gemm.cu",
                        "ta3n_tpu/ops/gather_gemm.py:70"),
    }
    log(f"launches on the paths: {launches}")
    kernels = []
    for name, (source, replaces) in sources.items():
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on its path")
        bound_ms, bound_by = bound(*work[name], PEAK_OPS[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # the TRN kernels: no single PyTorch call computes a
            # multi-scale TRN over a subset plan, forward or backward.
            # K3: index_select + mm, two calls (no single call gathers
            # and multiplies)
            "library_ms": ms[name][2]})
    # K1 (infer) at batch 1 and at the train batch too; K2's two families
    # by the profiler, each alone and in one grid; K3 at the eval shape
    # (320 rows, no x_res) as well
    for b in TIMED_BATCHES:
        if b != SERVE_BATCH:
            kernels[0].update({
                f"b{b}_ms": times[b][("kernel", "device")],
                f"b{b}_plain_ms": times[b][("plain", "device")],
                f"b{b}_bound_ms": bound(*trn_work(b)["trn_fused_fwd"],
                                        PEAK_OPS["trn_fused_fwd"])[0]})
    kernels[2].update(dx_ms=bwd_split["dx"], dw_ms=bwd_split["dW"],
                      both_ms=bwd_split["both"])
    # K1 and K2 at S = 17 and 25 (K1 (infer) at B=64, the others at 202)
    for kernel in kernels[:3]:
        for s, t in many.items():
            kernel.update({f"s{s}_ms": t[kernel["name"]][0],
                           f"s{s}_plain_ms": t[kernel["name"]][1],
                           f"s{s}_bound_ms": t[kernel["name"]][2]})
    kernels[3].update(
        eval_ms=k3_eval_t["kernel"], eval_plain_ms=k3_eval_t["plain"],
        eval_library_ms=k3_eval_t["library"],
        eval_bound_ms=bound(*k3_eval_work, PEAK_OPS["gather_gemm"])[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
