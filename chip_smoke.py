"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from ta3n_tpu_torch/csrc, holds it against
its plain PyTorch version at the flagship serving shapes and times both,
then serves the flagship model (UCF->HMDB_full: trn-m over 5 segments,
2048-d features, fc 512, TRN bottleneck 256, TransAttn, 12 classes, random
weights from a seed) over HTTP and checks the answers against a plain-path
forward of the same weights on the same card.  Any failure exits non-zero;
so does a machine without a CUDA device.  The last line of the output is
one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
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

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models.layers import torch_default_uniform_
from ta3n_tpu_torch.ops import _build, trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.serve import Predictor, make_http_server

FLAGSHIP = ModelConfig(
    num_class=12, baseline_type="video", frame_aggregation="trn-m",
    train_segments=5, val_segments=5, feature_dim=2048, fc_dim=512,
    use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
SERVE_BATCH = 64
REQUEST_SIZES = (1, 37, 130)   # 130 videos span three padded chunks
TRN_CASES = ((1, 5, 512, 256), (64, 5, 512, 256), (202, 5, 512, 256),
             (13, 4, 37, 19))  # (B, S, D, H); the last one ragged
TIMED_BATCHES = (64, 202)
RTOL = 1e-4                    # |kernel - plain| <= RTOL * max(1, |plain|)
PROB_TOL = 1e-5


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
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()
    return seconds


def trn_inputs(b, s, d, h, gen):
    """Non-negative x like the post-ReLU shared features; weights and
    biases at torch's default Linear scale U(±1/sqrt(k*D))."""
    x = torch.rand((b, s, d), generator=gen)
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
    the served round; return the kernel launches of the served round."""
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
            trn_fused.launches = 0
            answers = []
            for feats, body in zip(requests, bodies):
                t0 = time.perf_counter()
                answers.append(post(f"{url}/predict", body))
                log(f"  POST /predict ({label}), {feats.shape[0]} videos: "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        launches = trn_fused.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"  TRN kernel launches while serving: {launches}")
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
    return launches


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

    gen = torch.Generator().manual_seed(0)
    log("TRN kernel vs plain")
    max_err = check_trn_kernel(gen)
    times = time_trn(gen)

    log("flagship serving over HTTP")
    with tempfile.TemporaryDirectory() as workdir:
        launches = serve_flagship(gen, workdir)

    t64 = times[SERVE_BATCH]
    print(json.dumps({"kernels": [{
        "name": "trn_fused_fwd", "route": "cuda",
        "source": "ta3n_tpu_torch/csrc/trn_fused_fwd.cu",
        "replaces": "ta3n_tpu/ops/trn_fused.py:68",
        "launches": launches, "max_abs_err": max_err,
        "ms": t64[("kernel", "device")],
        "plain_ms": t64[("plain", "device")]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
