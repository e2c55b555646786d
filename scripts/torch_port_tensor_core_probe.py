"""Probes of the port's tensor-core kernels on one CUDA card (an H100):
the numbers behind the design of K1 (csrc/trn_fused_fwd.cu), K2
(csrc/trn_fused_bwd.cu, and in bfloat16 csrc/trn_fused_bwd_bf16.cu) and
K3 (csrc/gather_gemm.cu, and at bfloat16 compute csrc/gather_gemm_bf16.cu),
and behind the tf32x3.cuh and wgmma_bf16.cuh helpers they share.

    PYTHONPATH=. python3 scripts/torch_port_tensor_core_probe.py \
        [PROBE ...] [--k3-slices N]
    PYTHONPATH=. python3 scripts/torch_port_tensor_core_probe.py \
        k1-earlier --earlier-k1 PATH
    PYTHONPATH=. python3 scripts/torch_port_tensor_core_probe.py \
        k3-bf16-earlier k1-bf16-earlier --earlier-csrc DIR

Probes (all but k1-earlier, k3-bf16-earlier and k1-bf16-earlier by
default):
  mma-rate        mma.sync m16n8k8 TF32 throughput: bare, and as one 3xTF32
                  step of the kernels (24 mma.sync over 16 fresh f32 values)
                  with the split done by integer rounding (tf32x3.cuh) or by
                  cvt.rna.tf32.f32
  k3-splits       K3 device time at the train (640 rows, x_res) and eval
                  (320 rows) shapes for 1..8 K slices, beside index_select
                  + mm; at bfloat16 compute from bfloat16 and int8 stores also at
                  the target batch's 370 rows, and K3's kernels and the
                  library pair's by the profiler at the chosen slices
  split-variants  the 3xTF32 split with a_lo left raw, rounded by integer
                  operations (the tree) and by cvt.rna: K3's error against
                  float64, and chip_smoke.py's five device-store steps
                  against the host-feature steps
  phases          clock64 cycles a chunk spends waiting for its copies,
                  issuing the next copies and computing, in K3, in K2's
                  dx and dW families and in K1
  k1-splits       K1 device time, (infer) at B=1, 64 and 202 and (train)
                  at B=202, for 1..8 D slices
  k1-variants     K1 with its tile width, ring and blocks an SM varied
                  (K1_VARIANTS) at one and two D slices, each checked
                  against the plain version and timed in turns; its GEMM
                  and epilogue kernels by the profiler
  wgmma-phases    clock64 cycles a chunk spends, in the wgmma rings of K3 at
                  bfloat16 compute (its rows landing, converting them,
                  issuing the products, waiting for the previous batch
                  and staging the next chunk) and of K2 in bfloat16 (its
                  boxes landing, converting, issuing the products, and
                  waiting for the previous batch), and of K1 in bfloat16
                  (the same phases as K2's)
  k1-bf16-profile K1's bfloat16 variants at S = 5 and 17: device time,
                  and its GEMM and epilogue kernels by the profiler
  k1-bf16-splits  the same at 1..8 D slices
  k1-bf16-variants K1 in bfloat16 with its source varied (K1_BF16_VARIANTS),
                  each checked against the plain version and timed in turns
  k3-bf16-earlier only when named, with --earlier-csrc DIR: K3 at
                  bfloat16 compute built from DIR, an earlier csrc/ (its
                  ta3n_gather_gemm, one member's entry; e.g. `git
                  archive 8024ae0 ta3n_tpu_torch/csrc | tar -x -C
                  build/earlier`, the first wgmma design, whose W tiles
                  came by cp.async), against the current one, both checked
                  against the plain version and timed in turns
  k1-bf16-earlier only when named, with --earlier-csrc DIR: K1 in
                  bfloat16 built from DIR, an earlier csrc/ whose bfloat16
                  K1 is the mma.sync design (e.g. `git archive feeb357
                  ta3n_tpu_torch/csrc | tar -x -C build/earlier`), against
                  the current one, both checked against the plain version
                  and timed in turns
  k1-earlier      only when named, with --earlier-k1 PATH: K1 against
                  the f32-FMA design it replaced, built from PATH, that
                  design's trn_fused_fwd.cu (its C entries take no scratch
                  and no slice count; e.g. `git show
                  a7f844d:ta3n_tpu_torch/csrc/trn_fused_fwd.cu`), both
                  checked against the plain version and timed in turns

--k3-slices N runs the split-variants probe with K3 at N K slices in
place of the wrapper's choice.  Variants are built from a patched copy of
csrc/ under
build/ta3n_tpu_torch/probe/ (gitignored); nothing in the tree changes.
Fails on a machine without a CUDA device.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ta3n_tpu_torch.data import make_domain_pair  # noqa: E402
from ta3n_tpu_torch.ops import _build, gather_gemm, trn_fused  # noqa: E402
from ta3n_tpu_torch.ops.relation import build_relation_plan  # noqa: E402

PROBE_DIR = _build.BUILD_DIR / "probe"

MMA_RATE_CU = r"""
#include <cstdio>
#include "ta3n_tpu_torch/csrc/tf32x3.cuh"

// kMode 0: three passes of mma.sync on fixed TF32 operands; 1: the
// kernels' 3xTF32 step on fresh values (integer split); 2: the same with
// cvt.rna.tf32.f32 doing the split
template <int kMode>
__global__ void __launch_bounds__(256) rate(float* out, int iters) {
  float acc[2][4][4] = {};
  float a[2][4], b[4][2];
  for (int i = 0; i < 2; ++i)
    for (int r = 0; r < 4; ++r) a[i][r] = 1e-3f * (threadIdx.x + i + r);
  for (int j = 0; j < 4; ++j)
    for (int r = 0; r < 2; ++r) b[j][r] = 1e-3f * (threadIdx.x + j - r);
  unsigned ah[2][4], bh[4][2];
  for (int i = 0; i < 2; ++i)
    for (int r = 0; r < 4; ++r) ah[i][r] = ta3n::to_tf32(a[i][r]);
  for (int j = 0; j < 4; ++j)
    for (int r = 0; r < 2; ++r) bh[j][r] = ta3n::to_tf32(b[j][r]);
  for (int it = 0; it < iters; ++it) {
    if (kMode == 0) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ta3n::mma_tf32(acc[i][j], ah[i], bh[j]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[i][r] += 1e-7f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) b[j][r] -= 1e-7f;
    if (kMode == 1) {
      ta3n::mma_3xtf32(acc, a, b);
      continue;
    }
    unsigned a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(a_hi[i][r]) : "f"(a[i][r]));
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(a_lo[i][r])
            : "f"(a[i][r] - __uint_as_float(a_hi[i][r])));
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(b_hi[j][r]) : "f"(b[j][r]));
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(b_lo[j][r])
            : "f"(b[j][r] - __uint_as_float(b_hi[j][r])));
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ta3n::mma_tf32(acc[i][j], a_lo[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ta3n::mma_tf32(acc[i][j], a_hi[i], b_lo[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ta3n::mma_tf32(acc[i][j], a_hi[i], b_hi[j]);
  }
  float s = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) s += acc[i][j][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kMode>
void run(float* out, int blocks, const char* name) {
  const int iters = 4096;
  rate<kMode><<<blocks, 256>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<kMode><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = double(blocks) * 8 * iters * 24 * 2.0 * 16 * 8 * 8;
  printf("  %-34s %3d blocks of 8 warps: %7.1f TFLOP/s of TF32 mma.sync "
         "(%5.1f TFLOP/s of f32 products in 3xTF32)\n",
         name, blocks, flop / ms / 1e9, flop / ms / 1e9 / 3);
}

int main() {
  float* out;
  cudaMalloc(&out, 528 * 256 * sizeof(float));
  for (int blocks : {132, 264, 528}) {
    run<0>(out, blocks, "bare mma.sync");
    run<1>(out, blocks, "3xTF32 step, integer split");
    run<2>(out, blocks, "3xTF32 step, cvt.rna split");
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("  %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
"""

SPLITS = {  # the body of split_tf32 in each variant
    "raw lo": """  hi = to_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));""",
    "integer (tree)": None,
    "cvt.rna": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(a - __uint_as_float(hi)));""",
}

PHASES = r"""  long long t_wait = 0, t_issue = 0, t_comp = 0;
  for (int c = 0; c < n; ++c) {
    const long long t0 = clock64();
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const long long t1 = clock64();
    const int next = c + kStages - 1;
    if (next < n) issue(next, next % kStages);
    cp_async_commit();
    const long long t2 = clock64();
    compute(c, c % kStages);
    const long long t3 = clock64();
    t_wait += t1 - t0;
    t_issue += t2 - t1;
    t_comp += t3 - t2;
  }
  if (threadIdx.x == 0) {
    atomicAdd(&phases[0], (unsigned long long)t_wait);
    atomicAdd(&phases[1], (unsigned long long)t_issue);
    atomicAdd(&phases[2], (unsigned long long)t_comp);
    atomicAdd(&phases[3], (unsigned long long)n);
  }"""

PIPELINE_LOOP = """  for (int c = 0; c < n; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < n) issue(next, next % kStages);
    cp_async_commit();
    compute(c, c % kStages);
  }"""


def log(msg: str) -> None:
    print(msg, flush=True)


def dev_ms(fn) -> float:
    return chip_smoke.device_ms(fn)


def variant_library(name: str, patch, extra_c: str = "", edits=None):
    """Build csrc/ with tf32x3.cuh patched by ``patch`` (text -> text),
    ``extra_c`` appended to each kernel source that includes it, STEM
    replaced by the source's name, and ``edits`` ({source name: [(old,
    new), ...]}) made in the sources; bind it as _build does.  Returns the
    library and ptxas's lines on registers and spills."""
    out = PROBE_DIR / re.sub(r"\W+", "_", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build._CSRC, out)
    header = out / "tf32x3.cuh"
    header.write_text(patch(header.read_text()))
    for source, pairs in (edits or {}).items():
        text = (out / source).read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{source} has changed: {old!r}")
            text = text.replace(old, new)
        (out / source).write_text(text)
    for src in _build.SOURCES:
        if '#include "tf32x3.cuh"' in src.read_text():
            with open(out / src.name, "a") as f:
                f.write(extra_c.replace("STEM", src.stem))
    nvcc = _build._nvcc()
    objs = [str(out / (src.stem + ".o")) for src in _build.SOURCES]
    ptxas = _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                              str(out / src.name)]
                             for src, obj in zip(_build.SOURCES, objs)])
    lib_path = out / "lib.so"
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                      str(lib_path), *objs]])
    lib = ctypes.CDLL(str(lib_path))
    for entry, argtypes in _build._ENTRIES.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, ptxas


def with_library(lib):
    """Make the port's wrappers call ``lib``."""
    _build.load_library = lambda: lib


def probe_mma_rate() -> None:
    log("mma-rate")
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, exe = PROBE_DIR / "mma_rate.cu", PROBE_DIR / "mma_rate"
    src.write_text(MMA_RATE_CU)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", f"-I{ROOT}", "-o", str(exe),
                    str(src)], check=True)
    run = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True)
    log(run.stdout.rstrip())


def store_and_weight(rows=35000, d=2048, h=512):
    gen = torch.Generator().manual_seed(3)
    store = torch.randn((rows, d), generator=gen).cuda()
    w = ((torch.rand((h, d), generator=gen) * 2 - 1) / d ** 0.5).cuda()
    return store, w


def probe_k3_splits() -> None:
    log("k3-splits (device time, median of 21 launches)")
    store, w = store_and_weight()
    rng = np.random.default_rng(0)
    chosen = gather_gemm._splits
    for n, with_rows in chip_smoke.K3_TIMED:
        rows = gather_gemm.row_index(rng.integers(0, store.shape[0], n),
                                     store.shape[0], "cuda")
        library = statistics.median(dev_ms(lambda: torch.mm(
            store.index_select(0, rows.rows), w.t())) for _ in range(21))
        line = []
        for splits in range(1, gather_gemm._MAX_SPLITS + 1):
            gather_gemm._splits = lambda m, h, c, s=splits: s
            fn = lambda: gather_gemm.gathered_gemm(store, rows, w, None,
                                                   with_rows)
            for _ in range(3):
                fn()
            line.append(f"{splits}: {statistics.median(dev_ms(fn) for _ in range(21)):.4f}")
        gather_gemm._splits = chosen
        log(f"  N={n} x_res={with_rows}: ms by K slices {', '.join(line)}; "
            f"index_select + mm {library:.4f}; the wrapper picks "
            f"{chosen(n, w.shape[0], 64)}")
    chosen = gather_gemm.bf16_grid
    w16 = w.to(torch.bfloat16)
    stores = {"bf16": store.to(torch.bfloat16), "int8": int8_store(store)}
    for n, with_rows in chip_smoke.K3_BF16_TIMED:
        rows = gather_gemm.row_index(rng.integers(0, store.shape[0], n),
                                     store.shape[0], "cuda")
        pair = lambda: torch.mm(stores["bf16"].index_select(0, rows.rows),
                                w16.t())
        library = statistics.median(dev_ms(pair) for _ in range(21))
        for kind, st in stores.items():
            fn = lambda: gather_gemm.gathered_gemm(st, rows, w16, None,
                                                   with_rows)
            line = []
            for splits in range(1, gather_gemm._MAX_SPLITS + 1):
                gather_gemm.bf16_grid = (
                    lambda m, h, d, k, dt, s=splits: (0, 0, s))
                for _ in range(3):
                    fn()
                ms = statistics.median(dev_ms(fn) for _ in range(21))
                line.append(f"{splits}: {ms:.4f}")
            gather_gemm.bf16_grid = chosen
            pick = chosen(n, w.shape[0], w.shape[1], 1, st[0].dtype
                          if isinstance(st, tuple) else st.dtype)[2]
            log(f"  bf16 compute, {kind} store, N={n} x_res={with_rows}: ms "
                f"by K slices {', '.join(line)}; index_select + mm in "
                f"bfloat16 {library:.4f}; the wrapper picks {pick}")
            log("    by the profiler: " + kernel_times(fn))
        log("    index_select + mm by the profiler: " + kernel_times(pair))


def int8_store(rows):
    """A float32 store on the card quantized per row, as the int8 pair
    ``(q, scale)`` on the card."""
    from ta3n_tpu_torch.data.quantized import quantize_rows
    q, scale = quantize_rows(rows.cpu().numpy())
    return torch.from_numpy(q).cuda(), torch.from_numpy(scale).cuda()


def kernel_times(fn, n=20) -> str:
    """Device time of each kernel a call of fn launches, by the profiler:
    microseconds a call, by name."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return ", ".join(
        f"{e.key[:48]} {e.self_device_time_total / n:.1f} us"
        for e in prof.key_averages()
        if e.device_type.name == "CUDA" and e.count)


def probe_split_variants() -> None:
    log("split-variants")
    torch.backends.cuda.matmul.allow_tf32 = False
    stores = make_domain_pair(**chip_smoke.SPLITS, num_class=12,
                              feature_dim=2048)
    dev = [s.to_device() for s in stores]
    store, w = store_and_weight()
    rows, scale = chip_smoke.gather_case(640, dev[0].shape[0],
                                         np.random.default_rng(3))
    def split_patch(body):
        def patch(text):
            if body is None:
                return text
            text, n = re.subn(
                r"(void split_tf32\(float a, unsigned& hi,\s*unsigned& lo\) "
                r"\{)(.*?)(\n\})",
                lambda m: m.group(1) + "\n" + body + m.group(3), text,
                flags=re.S)
            if n != 1:
                raise RuntimeError("tf32x3.cuh's split_tf32 has changed")
            return text
        return patch

    for name, body in SPLITS.items():
        patch = split_patch(body)
        with_library(variant_library(f"split {name}", patch)[0])
        z, x = gather_gemm.gathered_gemm(dev[0], rows, w, scale)
        err = z.double() - x.double() @ w.double().T
        log(f"  {name}: K3 at N=640 against float64: max {err.abs().max().item():.3e}, "
            f"mean {err.mean().item():.3e}, mean |e| {err.abs().mean().item():.3e}")
        try:
            chip_smoke.train_device_store(torch.Generator().manual_seed(0),
                                          stores, dev)
        except AssertionError as fault:
            log(f"  {name}: device-store steps FAILED: {fault}")


def probe_phases() -> None:
    log("phases (thread 0 of every block; cycles a chunk, summed over "
        "blocks and divided by block-chunks)")
    def patch(text):
        if PIPELINE_LOOP not in text:
            raise RuntimeError("tf32x3.cuh's pipeline loop has changed")
        return text.replace(
            "namespace ta3n {", "namespace ta3n {\n"
            "static __device__ unsigned long long phases[4];", 1).replace(
                PIPELINE_LOOP, PHASES)
    read = """
extern "C" void probe_phases_STEM(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    cudaMemcpyToSymbol(ta3n::phases, zero, sizeof(zero));
  } else {
    cudaMemcpyFromSymbol(out, ta3n::phases, sizeof(unsigned long long) * 4);
  }
}
"""
    lib = variant_library("phases", patch, read)[0]
    with_library(lib)
    counts = (ctypes.c_ulonglong * 4)()

    def measure(label, fn, source):
        read = getattr(lib, f"probe_phases_{source}")
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        read(counts, 1)
        fn()
        torch.cuda.synchronize()
        read(counts, 0)
        wait, issue, comp, n = list(counts)
        log(f"  {label}: wait + barrier {wait / n:.0f}, issue {issue / n:.0f}, "
            f"compute {comp / n:.0f} cycles a chunk ({n} block-chunks)")

    store, w = store_and_weight()
    rows = gather_gemm.row_index(
        np.random.default_rng(0).integers(0, store.shape[0], 640),
        store.shape[0], "cuda")
    measure("K3 N=640", lambda: gather_gemm.gathered_gemm(store, rows, w),
            "gather_gemm")
    with torch.no_grad():
        for b in (64, 202):
            x, wt, bi = chip_smoke.trn_inputs(
                b, 5, 512, 256, torch.Generator().manual_seed(0))
            measure(f"K1 (infer) B={b}", lambda: trn_fused.trn_multiscale_infer(
                x, wt, bi, 5), "trn_fused_fwd")
    x, wt, bi = chip_smoke.trn_inputs(202, 5, 512, 256,
                                      torch.Generator().manual_seed(0),
                                      signed=True)
    g = torch.randn((202, 4, 256), device="cuda")
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, wt, bi, 5)
        for parts, label in ((1, "dx"), (2, "dW/db"), (3, "both")):
            measure(f"K2 {label} tiles",
                    lambda parts=parts: chip_smoke.bwd_parts(
                        x, wt, masks, g, parts), "trn_fused_bwd")


WGMMA_LOOP = """    const int s = c % kStages;
    land(c, s);
    named_sync(kConsumers);
    convert(c, s);
    fence_proxy_async();
    named_sync(kConsumers);
    fence_operands(acc);
    wgmma_fence();
    mma(c, s);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's chunk c - 1 products are done
    fence_operands(acc);
    const int next = c + kStages - 1;
    if (next < n) {
      named_sync(kConsumers);  // and the other's: their stage is free
      issue(next, next % kStages);
    }"""

WGMMA_WS_LOOP = """    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    convert(c, s);
    fence_proxy_async();
    named_sync(kConsumers);
    fence_operands(acc);
    wgmma_fence();
    mma(c, s);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (c > 0 && tid % 128 == 0) mbar_arrive(&empty[(c - 1) % kStages]);"""

def wgmma_stamped(loop: str, marks) -> str:
    """``loop`` with clock64 read after each line that starts with one of
    ``marks`` (in order), the differences added to wphases[0..] by thread
    0 of each block at the end of each chunk."""
    lines, out, k = loop.split("\n"), [], 0
    out.append("    long long t_prev = clock64();")
    for line in lines:
        out.append(line)
        if k < len(marks) and line.strip().startswith(marks[k]):
            out.append(f"    {{ const long long t = clock64(); "
                       f"if (threadIdx.x == 0) atomicAdd(&wphases[{k}], "
                       f"(unsigned long long)(t - t_prev)); t_prev = t; }}")
            k += 1
    if k != len(marks):
        raise RuntimeError(f"the ring's loop has changed: {marks[k:]}")
    out.append("    if (threadIdx.x == 0) atomicAdd(&wphases[5], 1ull);")
    return "\n".join(out)


def probe_wgmma_phases() -> None:
    log("wgmma-phases (thread 0 of every block; cycles a chunk, summed "
        "over blocks and divided by block-chunks)")
    read = """
extern "C" void probe_wphases_STEM(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    cudaMemcpyToSymbol(ta3n::wphases, zero, sizeof(zero));
  } else {
    cudaMemcpyFromSymbol(out, ta3n::wphases, sizeof(unsigned long long) * 6);
  }
}
"""
    edits = {"wgmma_bf16.cuh": [
        ("namespace ta3n {", "namespace ta3n {\n"
         "static __device__ unsigned long long wphases[6];"),
        (WGMMA_LOOP, wgmma_stamped(WGMMA_LOOP, (
            "land(", "convert(", "mma(", "fence_operands(acc);",
            "issue("))),
        (WGMMA_WS_LOOP, wgmma_stamped(WGMMA_WS_LOOP, (
            "mbar_wait(", "convert(", "mma(", "fence_operands(acc);")))]}
    for name in ("gather_gemm_bf16.cu", "trn_fused_bwd_bf16.cu",
                 "trn_fused_fwd_bf16.cu"):
        stem = name.removesuffix(".cu")
        edits[name] = [('#include "wgmma_bf16.cuh"\n',
                        '#include "wgmma_bf16.cuh"\n' +
                        read.replace("STEM", stem))]
    lib = variant_library("wgmma phases", lambda text: text, edits=edits)[0]
    with_library(lib)
    counts = (ctypes.c_ulonglong * 6)()

    def measure(label, fn, stem, phases):
        read_fn = getattr(lib, f"probe_wphases_{stem}")
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        read_fn(counts, 1)
        fn()
        torch.cuda.synchronize()
        read_fn(counts, 0)
        n = counts[5]
        log(f"  {label}: " + ", ".join(
            f"{p} {counts[i] / n:.0f}" for i, p in enumerate(phases))
            + f" cycles a chunk ({n} block-chunks)")

    store, w = store_and_weight()
    w16 = w.to(torch.bfloat16)
    rows = gather_gemm.row_index(
        np.random.default_rng(0).integers(0, store.shape[0], 640),
        store.shape[0], "cuda")
    k3_phases = ("land", "convert", "products", "previous batch", "stage")
    for kind, st in (("bf16", store.to(torch.bfloat16)),
                     ("int8", int8_store(store))):
        measure(f"K3 bf16 compute, {kind} store, N=640 x_res",
                lambda: gather_gemm.gathered_gemm(st, rows, w16),
                "gather_gemm_bf16", k3_phases)
    x, wt, bi = chip_smoke.bf16_trn_inputs(202, 5,
                                           torch.Generator().manual_seed(0))
    g = torch.randn((202, 4, 256), device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, wt, bi, 5)
        measure("K2 bf16 B=202 S=5",
                lambda: trn_fused.trn_multiscale_bwd(x, wt, masks, g, 5),
                "trn_fused_bwd_bf16",
                ("land", "convert", "products", "previous batch"))
        for label, fn in (
                ("K1 (train) bf16 B=202 S=5",
                 lambda: trn_fused.trn_multiscale_fwd_masks(x, wt, bi, 5)),
                ("K1 (infer) bf16 B=202 S=5",
                 lambda: trn_fused.trn_multiscale_infer(x, wt, bi, 5))):
            measure(label, fn, "trn_fused_fwd_bf16",
                    ("land", "convert", "products", "previous batch"))


def earlier_library(csrc: Path) -> ctypes.CDLL:
    """Every .cu of ``csrc`` (an earlier csrc/) built as _build does into
    one library, unbound."""
    out_dir = PROBE_DIR / "earlier_csrc"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    sources = sorted(out_dir.glob("*.cu"))
    objs = [str(src.with_suffix(".o")) for src in sources]
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
                      str(src)] for src, obj in zip(sources, objs)])
    lib_path = out_dir / "lib.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(lib_path), *objs]])
    return ctypes.CDLL(str(lib_path))


class _OneMemberGather:
    """An earlier library whose K3 entry, ``ta3n_gather_gemm``, has no
    member arguments, called as the current wrappers call
    ``ta3n_gather_gemm_members`` with one member and shared indices."""

    def __init__(self, lib: ctypes.CDLL):
        entry = lib.ta3n_gather_gemm
        members = _build._ENTRIES["ta3n_gather_gemm_members"]
        entry.argtypes = members[:-3] + members[-1:]
        entry.restype = ctypes.c_int
        self._entry = entry

    def ta3n_gather_gemm_members(self, *args):
        *args, members, per_member, stream = args
        if (members, per_member) != (1, 0):
            raise ValueError("the earlier K3 entry takes one member")
        return self._entry(*args, stream)


def probe_k3_bf16_earlier(csrc: Path) -> None:
    log(f"k3-bf16-earlier (K3 at bfloat16 compute from {csrc}; device "
        "time, medians of 41 in turns)")
    earlier = _OneMemberGather(earlier_library(csrc))
    current = _build.load_library()
    store, w = store_and_weight()
    w16 = w.to(torch.bfloat16)
    stores = {"f32": store, "bf16": store.to(torch.bfloat16),
              "int8": int8_store(store)}
    rng = np.random.default_rng(0)

    def on(lib, fn):
        with_library(lib)
        return fn()

    for n, with_rows in chip_smoke.K3_BF16_TIMED:
        rows, scale = chip_smoke.gather_case(n, store.shape[0], rng)
        for kind, st in stores.items():
            fn = lambda: gather_gemm.gathered_gemm(st, rows, w16, scale,
                                                   with_rows)
            want = gather_gemm.gathered_gemm_plain(st, rows.rows, w16,
                                                   scale)[0]
            for label, lib in (("earlier", earlier), ("current", current)):
                ok, _ = chip_smoke.bf16_err(on(lib, fn)[0], want)
                if not ok:
                    raise AssertionError(f"{label} K3 {kind} N={n}")
            t = chip_smoke.time_pair({
                "earlier": lambda: on(earlier, fn),
                "current": lambda: on(current, fn)})
            log(f"  {kind} store N={n} x_res={with_rows}: earlier "
                f"{t['earlier']:.4f} ms, current {t['current']:.4f} ms "
                f"({t['earlier'] / t['current']:.2f}x)")
    with_library(current)


def k1_cases():
    """K1's timed cases: (label, B, fn(x, w, b) -> output)."""
    infer = lambda x, w, b: trn_fused.trn_multiscale_infer(x, w, b, 5)
    train = lambda x, w, b: trn_fused.trn_multiscale_fwd_masks(x, w, b, 5)
    return (("K1 (infer)", 1, infer), ("K1 (infer)", 64, infer),
            ("K1 (infer)", 202, infer),
            ("K1 (train)", 202, train))


def probe_k1_splits() -> None:
    log("k1-splits (device time, median of 21 launches)")
    chosen = trn_fused._fwd_splits
    with torch.no_grad():
        for label, b, fn in k1_cases():
            x, w, bi = chip_smoke.trn_inputs(
                b, 5, 512, 256, torch.Generator().manual_seed(0))
            line = []
            for splits in range(1, trn_fused._FWD_MAX_SPLITS + 1):
                trn_fused._fwd_splits = lambda *a, n=splits: n
                for _ in range(3):
                    fn(x, w, bi)
                line.append(f"{splits}: " + format(statistics.median(
                    dev_ms(lambda: fn(x, w, bi)) for _ in range(21)), ".4f"))
            trn_fused._fwd_splits = chosen
            log(f"  {label} B={b}: ms by D slices {', '.join(line)}; the "
                f"wrapper picks {chosen(5, 3, b, 512, 256)}")


# K1 (csrc/trn_fused_fwd.cu) variants: edits of the source
_K1_WIDE = [("constexpr int kTileH = 64;", "constexpr int kTileH = 128;"),
            ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")]
_K1_STAGES3 = [("constexpr int kStages = 4;", "constexpr int kStages = 3;")]
K1_VARIANTS = {
    "64x64 tiles, 4 stages, 3 blocks an SM (the tree)": [],
    "64x64, 3 stages, 4 blocks an SM": _K1_STAGES3 + [
        ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 4;")],
    "64x128, 3 stages, 2 blocks an SM": _K1_WIDE + _K1_STAGES3,
}


def ptxas_lines(out: str, kernel: str) -> str:
    """ptxas's registers and spills for the first entry naming kernel."""
    lines = out.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            found = [x.split(":", 1)[-1].strip() for x in lines[n + 1:n + 5]
                     if "registers" in x or "spill" in x]
            return "; ".join(found)
    return "not found"


def probe_k1_variants() -> None:
    """K1 built in each variant of K1_VARIANTS at one and two D slices,
    checked against the plain version and timed in turns; the GEMM and
    the epilogue kernels of each by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    log("k1-variants (device time, medians of 41 in turns)")
    libs = {}
    for name, edits in K1_VARIANTS.items():
        lib, ptxas = variant_library(f"k1 {name}", lambda text: text, "",
                                     {"trn_fused_fwd.cu": edits})
        log(f"  {name}: {ptxas_lines(ptxas, 'trn_fused_fwd_kernel')}")
        libs[name] = lib
    chosen, tree = trn_fused._fwd_splits, _build.load_library
    with torch.no_grad():
        for label, b, fn in k1_cases():
            x, w, bi = chip_smoke.trn_inputs(
                b, 5, 512, 256, torch.Generator().manual_seed(0))
            want = trn_fused.trn_multiscale_plain(x, w, bi, 5)
            fns = {}
            for (name, lib), splits in itertools.product(libs.items(),
                                                         (1, 2)):
                def run(lib=lib, splits=splits):
                    with_library(lib)
                    trn_fused._fwd_splits = lambda *a: splits
                    return fn(x, w, bi)
                got = run()
                got = got[0] if isinstance(got, tuple) else got
                err = (got - want).abs().max().item()
                tol = chip_smoke.RTOL * max(1.0, want.abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"{name} {label} B={b}: {err}")
                fns[(name, splits)] = run
            t = chip_smoke.time_pair(fns)
            for key, run in fns.items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        run()
                    torch.cuda.synchronize()
                gemm, epi = (sum(e.self_device_time_total
                                 for e in prof.key_averages() if part in e.key)
                             / 1e3 / 20 for part in ("trn_fused_fwd_kernel",
                                                     "trn_fused_fwd_epilogue"))
                log(f"  {label} B={b}, {key[0]}, {key[1]} D slice(s): "
                    f"{t[key]:.4f} ms (GEMM {gemm:.4f}, epilogue {epi:.4f} "
                    "by the profiler, means of 20)")
    trn_fused._fwd_splits, _build.load_library = chosen, tree


def k1_timeline(prof) -> str:
    """From a profile of K1 calls, the means over the calls of the GEMM's
    span and of the epilogue's tail past the GEMM's end (its blocks start
    early and wait for the GEMM: a programmatic dependent launch), in ms."""
    kernels = sorted((e for e in prof.events() if "trn_fused_fwd" in e.name
                      and e.time_range.end > e.time_range.start),
                     key=lambda e: e.time_range.start)
    gemms = [e for e in kernels if "epilogue" not in e.name]
    epis = [e for e in kernels if "epilogue" in e.name]
    if not gemms or len(gemms) != len(epis):
        return "timeline not read"
    span = statistics.mean(g.time_range.end - g.time_range.start
                           for g in gemms) / 1e3
    tail = statistics.mean(e.time_range.end - g.time_range.end
                           for g, e in zip(gemms, epis)) / 1e3
    return f"GEMM span {span:.4f}, epilogue tail past it {tail:.4f}"


def k1_bf16_profile(label, fn, runs=20):
    """Means over ``runs`` calls of K1's GEMM and epilogue kernels by the
    profiler (ms a call): (GEMM, epilogue, the timeline of k1_timeline)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that saw no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "trn_fused_fwd" in e.key]
        if events:
            break
    else:
        log(f"  {label}: the profiler saw no K1 kernel")
        return float("nan"), float("nan"), "not measured"
    gemm = sum(e.self_device_time_total for e in events
               if "epilogue" not in e.key) / 1e3 / runs
    epi = sum(e.self_device_time_total for e in events
              if "epilogue" in e.key) / 1e3 / runs
    return gemm, epi, k1_timeline(prof)


def probe_k1_bf16_profile() -> None:
    """K1's bfloat16 variants at S = 5 (infer at B = 1, 64, 202, train at
    B = 202) and S = 17 (infer at B = 64, train at 202): device time
    (median of 41) and its GEMM and epilogue kernels by the profiler."""
    log("k1-bf16-profile (device ms, median of 41; GEMM and epilogue by "
        "the profiler, means of 20)")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for s, label, b in ((5, "infer", 1), (5, "infer", 64),
                            (5, "infer", 202), (5, "train", 202),
                            (17, "infer", 64), (17, "train", 202)):
            x, w, bi = chip_smoke.bf16_trn_inputs(b, s, gen)
            if label == "infer":
                fn = lambda: trn_fused.trn_multiscale_infer(x, w, bi, s)
            else:
                fn = lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            ms = chip_smoke.time_pair({"kernel": fn})["kernel"]
            gemm, epi, timeline = k1_bf16_profile(label, fn)
            log(f"  K1 ({label}) bf16 S={s} B={b}: {ms:.4f} ms (GEMM "
                f"{gemm:.4f}, epilogue {epi:.4f}; {timeline})")


def k1_bf16_cases():
    """K1's bfloat16 cases: (variant, S, B)."""
    return (("infer", 5, 1), ("infer", 5, 64), ("infer", 5, 202),
            ("train", 5, 202), ("infer", 17, 64), ("train", 17, 202))


def k1_bf16_fn(variant, x, w, bi, s):
    if variant == "infer":
        return lambda: trn_fused.trn_multiscale_infer(x, w, bi, s)
    return lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)


def probe_k1_bf16_splits() -> None:
    """K1 in bfloat16 at 1..8 D slices (bf16_fwd_grid's row and H tiles):
    device time (median of 21) and its GEMM and epilogue by the profiler."""
    log("k1-bf16-splits (device ms, median of 21; GEMM + epilogue by the "
        "profiler)")
    chosen = trn_fused.bf16_fwd_grid
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for variant, s, b in k1_bf16_cases():
            x, w, bi = chip_smoke.bf16_trn_inputs(b, s, gen)
            fn = k1_bf16_fn(variant, x, w, bi, s)
            line = []
            for splits in range(1, trn_fused._FWD_MAX_SPLITS + 1):
                trn_fused.bf16_fwd_grid = \
                    lambda *a, n=splits: chosen(*a)[:2] + (n,)
                ms = statistics.median(dev_ms(fn) for _ in range(21))
                gemm, epi, _ = k1_bf16_profile(variant, fn)
                line.append(f"{splits}: {ms:.4f} ({gemm:.4f} + {epi:.4f})")
            trn_fused.bf16_fwd_grid = chosen
            log(f"  K1 ({variant}) bf16 S={s} B={b}: {'; '.join(line)}; "
                f"the wrapper picks {chosen(s, 3, b, 512, 256)[2]}")



# K1 in bfloat16 (csrc/trn_fused_fwd_bf16.cu) variants: edits of the
# source: the GEMM's trigger of its epilogue's launch at the start of each
# block in place of after its products, the epilogue launched without the
# programmatic dependence (once the GEMM has ended), and the tensor maps
# brought to the TMA unit's cache at the block's start
K1_BF16_VARIANTS = {
    "trigger after the products (the tree)": [],
    "trigger at the block's start": [
        ("""  // the epilogue may be launched now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
""", ""),
        ("""  const int tid = threadIdx.x;
  long long rest = blockIdx.x;""",
         """  const int tid = threadIdx.x;
  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
  long long rest = blockIdx.x;""")],
    "the epilogue launched after the GEMM": [
        ("  config.numAttrs = 1;\n", "  config.numAttrs = 0;\n")],
    "tensor maps prefetched": [
        ("""  const int tid = threadIdx.x;
  long long rest = blockIdx.x;""",
         """  const int tid = threadIdx.x;
  if (kVec && tid == ta3n::kConsumers)
    asm volatile("prefetch.tensormap [%0];" ::"l"(&maps.x) : "memory");
  long long rest = blockIdx.x;"""),
        ("""  const bf16* w_p = unit_w + static_cast<long long>(p) * d;
""", """  const bf16* w_p = unit_w + static_cast<long long>(p) * d;
  if (kVec && tid == ta3n::kConsumers)
    asm volatile("prefetch.tensormap [%0];" ::"l"(&maps.w.w[scale])
                 : "memory");
""")],
}


def probe_k1_bf16_variants() -> None:
    """K1 in bfloat16 built in each variant of K1_BF16_VARIANTS, checked
    against the plain version and timed in turns, with the GEMM's span
    and the epilogue's tail past it by the profiler."""
    log("k1-bf16-variants (device ms, medians of 41 in turns)")
    libs = {name: variant_library(f"k1 bf16 {name}", lambda text: text, "",
                                  {"trn_fused_fwd_bf16.cu": edits})[0]
            for name, edits in K1_BF16_VARIANTS.items()}
    tree = _build.load_library
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for variant, s, b in k1_bf16_cases():
            x, w, bi = chip_smoke.bf16_trn_inputs(b, s, gen)
            fn = k1_bf16_fn(variant, x, w, bi, s)
            want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            fns = {}
            for name, lib in libs.items():
                def run(lib=lib):
                    with_library(lib)
                    return fn()
                got = run()
                got = got[0] if isinstance(got, tuple) else got
                if not chip_smoke.bf16_err(got, want)[1]:
                    raise AssertionError(f"{name}: K1 ({variant}) bf16 "
                                         f"S={s} B={b}")
                fns[name] = run
            t = chip_smoke.time_pair(fns)
            for name, run in fns.items():
                log(f"  K1 ({variant}) bf16 S={s} B={b}, {name}: "
                    f"{t[name]:.4f} ms ({k1_bf16_profile(variant, run)[2]})")
    _build.load_library = tree


def probe_k1_bf16_earlier(csrc: Path) -> None:
    """K1 in bfloat16 built from an earlier csrc/ (the mma.sync design, whose
    C entries take the D slices of _fwd_splits in place of a grid) against
    the current kernel, both checked against the plain version and timed
    in turns."""
    log(f"k1-bf16-earlier (K1 in bfloat16 from {csrc}; device time, "
        "medians of 41 in turns)")
    earlier = earlier_library(csrc)
    P, I = ctypes.c_void_p, ctypes.c_int
    infer, train = (earlier.ta3n_trn_fused_fwd_bf16,
                    earlier.ta3n_trn_fused_fwd_train_bf16)
    infer.argtypes = [P] * 6 + [I, P] + [I] * 5 + [P]
    train.argtypes = [P] * 7 + [I, P] + [I] * 5 + [P]
    infer.restype = train.restype = ctypes.c_int

    def run_earlier(variant, x, w, bi, s):
        b, _, d = x.shape
        h = w[0].shape[0]
        splits = trn_fused._fwd_splits(s, 3, b, d, h)
        slots = sum(n for _, _, n in trn_fused._fwd_units(s, 3))
        out = torch.empty((b, s - 1, h), dtype=x.dtype, device=x.device)
        masks = torch.empty((b, trn_fused._n_subsets(s, 3) * h),
                            dtype=torch.uint8, device=x.device)
        part = torch.empty((splits * slots, b, h), device=x.device)
        outs = [out] if variant == "infer" else [out, masks]
        entry = infer if variant == "infer" else train
        err = entry(x.data_ptr(),
                    *trn_fused._pointer_args(w, bi, s, 3, x.device),
                    *(o.data_ptr() for o in outs), part.data_ptr(),
                    *trn_fused._plan_args(s, 3, x.device), b, s, d, h,
                    splits, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier K1 bf16 launch failed: {err}")
        return out

    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for variant, s, b in k1_bf16_cases():
            x, w, bi = chip_smoke.bf16_trn_inputs(b, s, gen)
            current = k1_bf16_fn(variant, x, w, bi, s)
            want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            for label, got in (("earlier", run_earlier(variant, x, w, bi,
                                                       s)),
                               ("current", current())):
                got = got[0] if isinstance(got, tuple) else got
                if not chip_smoke.bf16_err(got, want)[1]:
                    raise AssertionError(f"{label} K1 ({variant}) bf16 "
                                         f"S={s} B={b}")
            t = chip_smoke.time_pair({
                "earlier": lambda: run_earlier(variant, x, w, bi, s),
                "current": current})
            log(f"  K1 ({variant}) bf16 S={s} B={b}: earlier "
                f"{t['earlier']:.4f} ms, current {t['current']:.4f} ms "
                f"({t['earlier'] / t['current']:.2f}x)")


def probe_k1_earlier(path: Path) -> None:
    log(f"k1-earlier ({path.name} from {path.parent}; device time, "
        "medians of 41 in turns)")
    out_dir = PROBE_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "lib.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(lib_path), str(path)]])
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ta3n_trn_fused_fwd_f32.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.ta3n_trn_fused_fwd_train_f32.argtypes = [P] * 6 + [I] * 4 + [P]

    def by_value_table(s):
        """The earlier kernel's plan, passed by value: per scale k, n_sub,
        then the frame indices."""
        plan = build_relation_plan(s)
        return np.asarray([v for k, sub in zip(plan.scales, plan.subsets)
                           for v in (k, len(sub), *sub.reshape(-1))],
                          np.int32)

    def earlier(x, w, bi, masks=None):
        b, s, d = x.shape
        h = w[0].shape[0]
        out = torch.empty((b, s - 1, h), device=x.device)
        ptrs = [(ctypes.c_void_p * len(t))(*[v.data_ptr() for v in t])
                for t in (w, bi)]
        table = by_value_table(s)
        extra = [] if masks is None else [masks.data_ptr()]
        stream = torch.cuda.current_stream().cuda_stream
        entry = (lib.ta3n_trn_fused_fwd_f32 if masks is None
                 else lib.ta3n_trn_fused_fwd_train_f32)
        err = entry(x.data_ptr(), ctypes.addressof(ptrs[0]),
                    ctypes.addressof(ptrs[1]), out.data_ptr(), *extra,
                    table.ctypes.data, b, s, d, h,
                    stream)
        if err:
            raise RuntimeError(f"earlier K1 launch failed: {err}")
        return out

    with torch.no_grad():
        for label, b, fn in k1_cases():
            x, w, bi = chip_smoke.trn_inputs(
                b, 5, 512, 256, torch.Generator().manual_seed(0))
            masks = (torch.empty((b, 10 * 256), dtype=torch.uint8,
                                 device="cuda") if "train" in label else None)
            want = trn_fused.trn_multiscale_plain(x, w, bi, 5)
            for name, got in (("earlier", earlier(x, w, bi, masks)),
                              ("current", fn(x, w, bi))):
                got = got[0] if isinstance(got, tuple) else got
                err = (got - want).abs().max().item()
                tol = chip_smoke.RTOL * max(1.0, want.abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"{name} {label} B={b}: {err}")
            t = chip_smoke.time_pair({
                "earlier": lambda: earlier(x, w, bi, masks),
                "current": lambda: fn(x, w, bi)})
            log(f"  {label} B={b}: earlier {t['earlier']:.4f} ms, current "
                f"{t['current']:.4f} ms ({t['earlier'] / t['current']:.2f}x)")


PROBES = {"mma-rate": probe_mma_rate, "k3-splits": probe_k3_splits,
          "split-variants": probe_split_variants, "phases": probe_phases,
          "k1-splits": probe_k1_splits, "k1-variants": probe_k1_variants,
          "wgmma-phases": probe_wgmma_phases,
          "k1-bf16-profile": probe_k1_bf16_profile,
          "k1-bf16-splits": probe_k1_bf16_splits,
          "k1-bf16-variants": probe_k1_bf16_variants}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: these probes run on the card only",
              file=sys.stderr)
        return 1
    argv = list(argv)
    if "--k3-slices" in argv:
        at = argv.index("--k3-slices")
        slices = int(argv[at + 1])
        del argv[at:at + 2]
        gather_gemm._splits = lambda m, h, chunks: min(slices, chunks)
        log(f"K3 at {slices} K slices")
    if "--earlier-k1" in argv:
        at = argv.index("--earlier-k1")
        path = Path(argv[at + 1]).resolve()
        del argv[at:at + 2]
        PROBES["k1-earlier"] = lambda: probe_k1_earlier(path)
    if "--earlier-csrc" in argv:
        at = argv.index("--earlier-csrc")
        csrc = Path(argv[at + 1]).resolve()
        del argv[at:at + 2]
        PROBES["k3-bf16-earlier"] = lambda: probe_k3_bf16_earlier(csrc)
        PROBES["k1-bf16-earlier"] = lambda: probe_k1_bf16_earlier(csrc)
    names = argv or [n for n in PROBES if n not in (
        "k1-earlier", "k3-bf16-earlier", "k1-bf16-earlier")]
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        print(f"unknown probes {unknown}; choose from {list(PROBES)}",
              file=sys.stderr)
        return 2
    log(chip_smoke.card_line())
    chip_smoke.build_kernels()
    for name in names:
        PROBES[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
