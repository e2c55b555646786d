"""Probes of the port's tensor-core kernels on one CUDA card (an H100):
the numbers behind the design of K2 (csrc/trn_fused_bwd.cu) and K3
(csrc/gather_gemm.cu), and behind the tf32x3.cuh helpers they share.

    PYTHONPATH=. python3 scripts/torch_port_tensor_core_probe.py \
        [PROBE ...] [--k3-slices N]

Probes (all by default):
  mma-rate        mma.sync m16n8k8 TF32 throughput: bare, and as one 3xTF32
                  step of the kernels (24 mma.sync over 16 fresh f32 values)
                  with the split done by integer rounding (tf32x3.cuh) or by
                  cvt.rna.tf32.f32
  k3-splits       K3 device time at the train (640 rows, x_res) and eval
                  (320 rows) shapes for 1..8 K slices, beside index_select + mm
  split-variants  the 3xTF32 split with a_lo left raw, rounded by integer
                  operations (the tree) and by cvt.rna: K3's error against
                  float64, and chip_smoke.py's five device-store steps
                  against the host-feature steps
  phases          clock64 cycles a chunk spends waiting for its copies,
                  issuing the next copies and computing, in K3 and in K2's
                  dx and dW families

--k3-slices N runs the split-variants probe with K3 at N K slices in
place of the wrapper's choice.  Variants are built from a patched copy of
csrc/ under
build/ta3n_tpu_torch/probe/ (gitignored); nothing in the tree changes.
Fails on a machine without a CUDA device.
"""

from __future__ import annotations

import ctypes
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


def variant_library(name: str, patch, extra_c: str = ""):
    """Build csrc/ with tf32x3.cuh patched by ``patch`` (text -> text) and
    ``extra_c`` appended to each kernel source that includes it, STEM
    replaced by the source's name; bind it as _build does."""
    out = PROBE_DIR / re.sub(r"\W+", "_", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build._CSRC, out)
    header = out / "tf32x3.cuh"
    header.write_text(patch(header.read_text()))
    for src in _build.SOURCES:
        if '#include "tf32x3.cuh"' in src.read_text():
            with open(out / src.name, "a") as f:
                f.write(extra_c.replace("STEM", src.stem))
    nvcc = _build._nvcc()
    objs = [str(out / (src.stem + ".o")) for src in _build.SOURCES]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
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
    return lib


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
        with_library(variant_library(f"split {name}", patch))
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
    lib = variant_library("phases", patch, read)
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


PROBES = {"mma-rate": probe_mma_rate, "k3-splits": probe_k3_splits,
          "split-variants": probe_split_variants, "phases": probe_phases}


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
    names = argv or list(PROBES)
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
