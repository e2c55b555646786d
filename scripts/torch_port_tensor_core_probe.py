"""Probes of the port's tensor-core kernels on one CUDA card (an H100):
the numbers behind the design of K1 (csrc/trn_fused_fwd.cu), K2
(csrc/trn_fused_bwd.cu, and in bfloat16 csrc/trn_fused_bwd_bf16.cu) and
K3 (csrc/gather_gemm.cu at float32 compute, csrc/gather_gemm_bf16.cu at
bfloat16), and behind the tf32x3.cuh, tf32_wgmma.cuh and wgmma_bf16.cuh
helpers they share.

    PYTHONPATH=. python3 scripts/torch_port_tensor_core_probe.py \
        [PROBE ...] [--k3-slices N]
    PYTHONPATH=. python3 scripts/torch_port_tensor_core_probe.py \
        k1-earlier k2-earlier k3-bf16-earlier k3-f32-earlier \
        k1-bf16-earlier --earlier-csrc DIR

Probes (all but the *-earlier probes of --earlier-csrc by default):
  k3-clusters     the thread block clusters of 1..16 blocks of the float32
                  GEMMs (384 threads, one block an SM) the card holds at
                  once (the float32 plans' table)
  k3-splits       K3 device time by K slices: at float32 compute (1..8)
                  from the float32 store at the train (640 rows, x_res)
                  and eval (320 rows) shapes, with 4 and 8 members and on
                  the H = 128 column slice, beside index_select + mm; at
                  bfloat16 compute from bfloat16 and int8 stores, also at
                  the target batch's 370 rows and with 4 and 8 members,
                  beside index_select + matmul; K3's kernels (its two
                  stages) and the library pair's by the profiler at the
                  chosen slices
  split-variants  the 3xTF32 split with a_lo left raw, rounded by integer
                  operations (the tree) and by cvt.rna: K3's error against
                  float64, and chip_smoke.py's five device-store steps
                  against the host-feature steps
  k1-splits       K1 device time, (infer) at B=1, 64 and 202 and (train)
                  at B=202, for 1..8 D slices (clusters of its GEMM)
  wgmma-phases    clock64 cycles a chunk spends in the wgmma rings fed by a
                  producer warp (its boxes landing, converting, issuing
                  the products, and waiting for the previous batch): of
                  K3's GEMM at bfloat16 compute (stage B, nothing to
                  convert) at 1, 4 (also in one K slice) and 8 members,
                  of K2 in bfloat16 and of K1 in bfloat16
  k1-bf16-profile K1's bfloat16 variants at S = 5 and 17: device time,
                  and its GEMM and epilogue kernels by the profiler
  k1-bf16-splits  the same at 1..8 D slices
  k1-bf16-variants K1 in bfloat16 with its source varied (K1_BF16_VARIANTS),
                  each checked against the plain version and timed in turns
  k3-bf16-variants K3 at bfloat16 compute with its source varied
                  (K3_BF16_VARIANTS: a cluster a tile where the tree folds
                  the slices into one block, two blocks an SM where the
                  tree spreads them, stage B without the programmatic
                  dependent launch) at 1, 4 and 8 members, each checked
                  against the tree's z and the plain version and timed in
                  turns
  k3-f32-variants K3 at float32 compute with its source varied
                  (K3_F32_VARIANTS: W split into TF32 planes by a kernel
                  before stage A in place of the consumers' registers,
                  stage B without the programmatic dependent launch, a
                  ring of 3 stages, the consumer warpgroups taking turns
                  at the tensor cores, the K slices by bf16_plan's rule
                  (powers of two up to 8); and two diagnostics, one
                  product a k step fewer and W unsplit) at 1, 4 and 8
                  members, the eval shape
                  and the H = 256 and 128 column slices, each checked
                  against the tree's z (bitwise where the slices are the
                  same) and the plain version, and timed in turns
  k1-earlier      only when named, with --earlier-csrc DIR: K1 at float32
  k2-earlier      (k1-earlier) or K2 (k2-earlier) built from DIR, an
                  earlier csrc/ whose float32 TRN kernels are the mma.sync
                  design (e.g. `git archive f802a48 ta3n_tpu_torch/csrc |
                  tar -x -C build/earlier`: 64 x 64 tiles fed by cp.async,
                  K1's D slices as float32 partials, K2 one grid of dx and
                  dW tiles with no scratch), called with its own slices
                  and scratch, against the current kernels at every K1
                  and K2 row of PERF.md's table (S = 5, 17, 25; K1 (infer)
                  at B = 1, 64, 202; N = 1, 4, 8 members; K2's dx and dW
                  families alone), both checked against the plain version
                  and timed in turns, and the current ones' stages by the
                  profiler
  k3-f32-earlier  only when named, with --earlier-csrc DIR: K3 at float32
                  compute built from DIR, an earlier csrc/ whose K3 is the
                  mma.sync design (e.g. `git archive 33e2418
                  ta3n_tpu_torch/csrc | tar -x -C build/earlier`: a 64 x 64
                  tile a block fed by cp.async, its K slices summed through
                  float32 partials by a second kernel), called with its own
                  K slices and partials, against the current one from each
                  store at the train, target and eval shapes, at 4 and 8
                  members and on the column slices, both checked against
                  the plain version and timed in turns
  k3-bf16-earlier only when named, with --earlier-csrc DIR: K3 at
                  bfloat16 compute built from DIR, an earlier csrc/ whose
                  K3 is one kernel (e.g. `git archive 7575d3f
                  ta3n_tpu_torch/csrc | tar -x -C build/earlier`, a
                  64 x 128 tile a block converting its own rows, with
                  members; or 8024ae0, one member's entry, whose W tiles
                  came by cp.async), called with its own K slices and
                  float32 partials, against the current one at 1 member
                  (and 4 and 8 where it has members), both checked
                  against the plain version and timed in turns
  k1-bf16-earlier only when named, with --earlier-csrc DIR: K1 in
                  bfloat16 built from DIR, an earlier csrc/ whose bfloat16
                  K1 is the mma.sync design (e.g. `git archive feeb357
                  ta3n_tpu_torch/csrc | tar -x -C build/earlier`), against
                  the current one, both checked against the plain version
                  and timed in turns

--k3-slices N runs the split-variants probe with K3 at N K slices (1, 2,
4 or 8, at most one a 32-deep chunk) in place of the wrapper's choice.  Variants are built from a patched copy of
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

CLUSTERS_CU = r"""
#include <cstdio>
#include <cuda_runtime.h>

// a kernel shaped as K3's float32 GEMM (csrc/gather_gemm.cu): 384
// threads, one block an SM by its shared memory
__global__ void __launch_bounds__(384, 1) shaped(int* out) {
  extern __shared__ int smem[];
  if (out != nullptr) out[0] = smem[0];
}

int main() {
  const int smem = SMEM;
  cudaFuncSetAttribute(shaped, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(shaped,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int size = 1; size <= 16; ++size) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(1, 1, size);
    config.blockDim = dim3(384);
    config.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = size;
    config.attrs = &attr;
    config.numAttrs = 1;
    int clusters = -1;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, shaped, &config);
    printf("  clusters of %2d blocks: %3d resident at once (%3d blocks)%s\n",
           size, clusters, clusters * size,
           err == cudaSuccess ? "" : cudaGetErrorString(err));
  }
  return 0;
}
"""

SPLITS = {  # the body of split_tf32 in each variant
    "raw lo": """  hi = to_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));""",
    "integer (tree)": None,
    "cvt.rna": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(a - __uint_as_float(hi)));""",
}

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


def probe_k3_clusters() -> None:
    """How many thread block clusters of 1..16 blocks of K3's float32 GEMM
    (384 threads, its shared memory: one block an SM) the card holds at
    once (cudaOccupancyMaxActiveClusters): the table behind
    ops/gather_gemm.py::f32_plan's K slices."""
    text = (_build._CSRC / "gather_gemm.cu").read_text()
    stages = int(re.search(r"constexpr int kStages = (\d+);", text).group(1))
    smem = stages * 3 * 128 * 128 + 2 * stages * 8 + 1024
    log(f"k3-clusters (K3's float32 GEMM: 384 threads, {smem} bytes of "
        "shared memory)")
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, exe = PROBE_DIR / "clusters.cu", PROBE_DIR / "clusters"
    src.write_text(CLUSTERS_CU.replace("SMEM", str(smem)))
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe), str(src)],
                   check=True)
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
    chosen = gather_gemm.f32_plan
    cases = [(n, with_rows, 1, 512) for n, with_rows in chip_smoke.K3_TIMED]
    cases += [(640, True, members, 512) for members in (4, 8)]
    cases += [(370, True, 1, 128), (320, False, 1, 128)]
    for n, with_rows, members, h in cases:
        rows = gather_gemm.row_index(rng.integers(0, store.shape[0], n),
                                     store.shape[0], "cuda")
        ws = torch.stack([w[:h]] + [w[:h].roll(i, 0)
                                    for i in range(1, members)])
        pair = lambda: torch.matmul(store.index_select(0, rows.rows),
                                    ws.transpose(1, 2))
        library = statistics.median(dev_ms(pair) for _ in range(21))
        fn = lambda: gather_gemm.gathered_gemm_members(store, rows, ws, None,
                                                       with_rows)
        line = []
        for splits in range(1, 9):
            gather_gemm.f32_plan = (
                lambda *a, s=splits, **kw: chosen(*a, **kw)._replace(
                    splits=s))
            for _ in range(3):
                fn()
            ms = statistics.median(dev_ms(fn) for _ in range(21))
            line.append(f"{splits}: {ms:.4f}")
        gather_gemm.f32_plan = chosen
        pick = chosen(n, h, w.shape[1], 1, members).splits
        log(f"  f32 compute, f32 store, N={n} x_res={with_rows} "
            f"members={members} H={h}: ms by K slices {', '.join(line)}; "
            f"index_select + matmul {library:.4f}; the wrapper picks {pick}")
        log("    by the profiler: " + kernel_times(fn))
    chosen = gather_gemm.bf16_plan
    w16 = w.to(torch.bfloat16)
    stores = {"bf16": store.to(torch.bfloat16), "int8": int8_store(store)}
    cases = [(n, with_rows, 1) for n, with_rows in chip_smoke.K3_BF16_TIMED]
    cases += [(640, True, members) for members in (4, 8)]
    for n, with_rows, members in cases:
        rows = gather_gemm.row_index(rng.integers(0, store.shape[0], n),
                                     store.shape[0], "cuda")
        ws = torch.stack([w16] + [w16.roll(i, 0) for i in
                                  range(1, members)])
        pair = lambda: torch.matmul(stores["bf16"].index_select(
            0, rows.rows), ws.transpose(1, 2))
        library = statistics.median(dev_ms(pair) for _ in range(21))
        for kind, st in stores.items():
            fn = lambda: gather_gemm.gathered_gemm_members(st, rows, ws,
                                                           None, with_rows)
            line = []
            for splits in (1, 2, 4, 8):
                gather_gemm.bf16_plan = (
                    lambda *a, s=splits, **kw: chosen(*a, **kw)._replace(
                        splits=s))
                for _ in range(3):
                    fn()
                ms = statistics.median(dev_ms(fn) for _ in range(21))
                line.append(f"{splits}: {ms:.4f}")
            gather_gemm.bf16_plan = chosen
            pick = chosen(n, w.shape[0], w.shape[1], 1, members).splits
            log(f"  bf16 compute, {kind} store, N={n} x_res={with_rows} "
                f"members={members}: ms by K slices {', '.join(line)}; "
                f"index_select + matmul in bfloat16 {library:.4f}; the "
                f"wrapper picks {pick}")
            log("    by the profiler: " + kernel_times(fn))
        log("    index_select + matmul by the profiler: "
            + kernel_times(pair))


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
    if constexpr (kConvert) {
      convert(c, s);
      fence_proxy_async();
      named_sync(kConsumers);
    }
    fence_operands(acc);
    wgmma_fence();
    mma(c, s);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (c > first && tid % 128 == 0) release_stage<kStages>(empty, c - 1);"""

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
    ws_phases = ("land", "convert", "products", "previous batch")
    st = store.to(torch.bfloat16)
    chosen = gather_gemm.bf16_plan
    for members, splits in ((1, None), (4, None), (4, 1), (8, None)):
        ws = torch.stack([w16] * members)
        if splits is not None:
            gather_gemm.bf16_plan = (
                lambda *a, s=splits, **kw: chosen(*a, **kw)._replace(
                    splits=s))
        plan = gather_gemm.bf16_plan(640, 512, 2048, 1, members)
        measure(f"K3 bf16 compute (stage B), bf16 store, N=640 x_res, "
                f"{members} members, {plan.splits} K slices",
                lambda: gather_gemm.gathered_gemm_members(st, rows, ws),
                "gather_gemm_bf16", ws_phases)
        gather_gemm.bf16_plan = chosen
    x, wt, bi = chip_smoke.bf16_trn_inputs(202, 5,
                                           torch.Generator().manual_seed(0))
    g = torch.randn((202, 4, 256), device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, wt, bi, 5)
        measure("K2 bf16 B=202 S=5",
                lambda: trn_fused.trn_multiscale_bwd(x, wt, masks, g, 5),
                "trn_fused_bwd_bf16", ws_phases)
        for label, fn in (
                ("K1 (train) bf16 B=202 S=5",
                 lambda: trn_fused.trn_multiscale_fwd_masks(x, wt, bi, 5)),
                ("K1 (infer) bf16 B=202 S=5",
                 lambda: trn_fused.trn_multiscale_infer(x, wt, bi, 5))):
            measure(label, fn, "trn_fused_fwd_bf16", ws_phases)


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


def earlier_bf16_splits(m: int, h: int, d: int, k: int,
                        store_kind: int) -> int:
    """The K slices of the single-kernel design at bfloat16 compute (its
    ops/gather_gemm.py::bf16_grid): 64 x 128 tiles, as many slices as the
    blocks an SM holds by store (1 for float32, else 2) leave room for."""
    tiles = -(-m // 64) * -(-h // 128)
    room = 132 * (1 if store_kind == 0 else 2) // tiles
    return max(1, min(8, k * -(-d // 64), room))


def earlier_f32_splits(m: int, h: int, d: int, k: int) -> int:
    """The K slices of the mma.sync design at float32 compute (its
    ops/gather_gemm.py::_splits): 64 x 64 tiles, as many slices as keep
    the grid within 264 blocks (two an SM), at most one a 32-deep
    chunk."""
    tiles = -(-m // 64) * -(-h // 64)
    return max(1, min(8, k * -(-d // 32), 264 // tiles))


class _EarlierGather:
    """An earlier library called as the current wrappers call
    ``ta3n_gather_gemm_members``: with the earlier design's K slices and
    float32 partials [members, splits, m, h] in place of the current
    plan's, at bfloat16 compute where that design was one kernel, and at
    float32 compute where it was mma.sync.  An entry without members
    (``ta3n_gather_gemm``) takes one member and shared indices."""

    def __init__(self, lib: ctypes.CDLL):
        members = _build._ENTRIES["ta3n_gather_gemm_members"]
        self._members = hasattr(lib, "ta3n_gather_gemm_members")
        if self._members:
            entry = lib.ta3n_gather_gemm_members
            entry.argtypes = members
        else:
            entry = lib.ta3n_gather_gemm
            entry.argtypes = members[:-3] + members[-1:]
        entry.restype = ctypes.c_int
        self._entry = entry

    def ta3n_gather_gemm_members(self, *args):
        args = list(args)
        (n_idx, streams, d, k, h, splits, store_kind, compute_kind,
         members, per_member) = args[8:18]
        m = n_idx * streams // k
        splits = (earlier_f32_splits(m, h, d, k) if compute_kind == 0
                  else earlier_bf16_splits(m, h, d, k, store_kind))
        self._part = (torch.empty((members, splits, m, h),
                                  dtype=torch.float32, device="cuda")
                      if splits > 1 else None)
        args[7] = None if self._part is None else self._part.data_ptr()
        args[13] = splits
        if self._members:
            return self._entry(*args)
        if (members, per_member) != (1, 0):
            raise ValueError("the earlier K3 entry takes one member")
        return self._entry(*args[:16], args[-1])


def probe_k3_bf16_earlier(csrc: Path) -> None:
    log(f"k3-bf16-earlier (K3 at bfloat16 compute from {csrc}; device "
        "time, medians of 41 in turns)")
    earlier = _EarlierGather(earlier_library(csrc))
    current = _build.load_library()
    store, w = store_and_weight()
    w16 = w.to(torch.bfloat16)
    stores = {"f32": store, "bf16": store.to(torch.bfloat16),
              "int8": int8_store(store)}
    rng = np.random.default_rng(0)

    def on(lib, fn):
        with_library(lib)
        return fn()

    cases = [(n, with_rows, 1) for n, with_rows in chip_smoke.K3_BF16_TIMED]
    if earlier._members:
        cases += [(640, True, 4), (640, True, 8)]
    for n, with_rows, members in cases:
        rows, scale = chip_smoke.gather_case(n, store.shape[0], rng)
        ws = torch.stack([w16] + [w16.roll(i, 0) for i in
                                  range(1, members)])
        for kind, st in stores.items():
            fn = lambda: gather_gemm.gathered_gemm_members(st, rows, ws,
                                                           scale, with_rows)
            want = [gather_gemm.gathered_gemm_plain(st, rows.rows, ws[i],
                                                    scale)[0]
                    for i in range(members)]
            for label, lib in (("earlier", earlier), ("current", current)):
                got = on(lib, fn)[0]
                if not all(chip_smoke.bf16_err(got[i], want[i])[1]
                           for i in range(members)):
                    raise AssertionError(f"{label} K3 {kind} N={n}")
            t = chip_smoke.time_pair({
                "earlier": lambda: on(earlier, fn),
                "current": lambda: on(current, fn)})
            log(f"  {kind} store N={n} x_res={with_rows} members={members}: "
                f"earlier {t['earlier']:.4f} ms, current "
                f"{t['current']:.4f} ms ({t['earlier'] / t['current']:.2f}x)")
    with_library(current)


def probe_k3_f32_earlier(csrc: Path) -> None:
    """K3 at float32 compute built from an earlier csrc/ (the mma.sync
    design) against the current two-stage design: from each store at the
    train (640 rows, x_res), target (370, x_res) and eval (320, no x_res)
    shapes, from the float32 store at 4 and 8 members over one index set
    and on tensor parallelism's column slices (H = 256, 128), both checked
    against the plain version and timed in turns with index_select + mm
    beside them."""
    log(f"k3-f32-earlier (K3 at float32 compute from {csrc}; device time, "
        "medians of 41 in turns)")
    earlier = _EarlierGather(earlier_library(csrc))
    current = _build.load_library()
    store, w = store_and_weight()
    stores = {"f32": store, "bf16": store.to(torch.bfloat16),
              "int8": int8_store(store)}
    rng = np.random.default_rng(0)

    def on(lib, fn):
        with_library(lib)
        return fn()

    cases = [(kind, n, with_rows, 1, 512)
             for kind in stores for n, with_rows in chip_smoke.K3_BF16_TIMED]
    cases += [("f32", 640, True, members, 512) for members in (4, 8)]
    cases += [("f32", n, with_rows, 1, h) for h in (256, 128)
              for n, with_rows in chip_smoke.K3_BF16_TIMED]
    for kind, n, with_rows, members, h in cases:
        st = stores[kind]
        rows, scale = chip_smoke.gather_case(n, store.shape[0], rng)
        ws = torch.stack([w[:h]] + [w[:h].roll(i, 0)
                                    for i in range(1, members)])
        fn = lambda: gather_gemm.gathered_gemm_members(st, rows, ws, scale,
                                                       with_rows)
        want = [gather_gemm.gathered_gemm_plain(st, rows.rows, ws[i],
                                                scale)[0]
                for i in range(members)]
        for label, lib in (("earlier", earlier), ("current", current)):
            got = on(lib, fn)[0]
            for i in range(members):
                err = (got[i] - want[i]).abs().max().item()
                if not err <= chip_smoke.RTOL * max(
                        1.0, want[i].abs().max().item()):
                    raise AssertionError(f"{label} K3 f32 {kind} N={n}")
        library = (
            (lambda: torch.matmul(st[0].index_select(0, rows.rows).float()
                                  * st[1].index_select(0, rows.rows)[:, None],
                                  ws.transpose(1, 2)))
            if kind == "int8" else
            (lambda: torch.matmul(st.index_select(0, rows.rows).float(),
                                  ws.transpose(1, 2))))
        t = chip_smoke.time_pair({
            "earlier": lambda: on(earlier, fn),
            "current": lambda: on(current, fn), "library": library})
        log(f"  {kind} store N={n} x_res={with_rows} members={members} "
            f"H={h}: earlier {t['earlier']:.4f} ms, current "
            f"{t['current']:.4f} ms ({t['earlier'] / t['current']:.2f}x); "
            f"index_select + mm {t['library']:.4f} ms")
    with_library(current)


# K3 at float32 compute with W split into TF32 hi and lo planes before
# stage A (by the repitch kernel, for every weight), read by TMA beside
# the rows' planes, in place of the consumers' split in registers: four
# boxes a stage, so a ring of 3 stages (2 folded)
_K3_W_PLANES = [
    ("constexpr int kStageBytes = 3 * kBoxBytes;",
     "constexpr int kStageBytes = 4 * kBoxBytes;"),
    ("constexpr int kStages = 4;", "constexpr int kStages = 3;"),
    ("""        ta3n::split_tf32(*reinterpret_cast<const float*>(st + at(kk, r)),
                         w_hi[kk][r], w_lo[kk][r]);""",
     """        w_hi[kk][r] = *reinterpret_cast<const unsigned*>(st + at(kk, r)),
        w_lo[kk][r] = *reinterpret_cast<const unsigned*>(
            st + 3 * kBoxBytes + at(kk, r));"""),
    ("""        ta3n::tma_load_3d(smem + s * kStageBytes, &maps.w,
                          (c_begin + i) * kTileK, h0, member, &full[s]);""",
     """        ta3n::tma_load_3d(smem + s * kStageBytes, &maps.w,
                          (c_begin + i) * kTileK, h0, member, &full[s]);
        ta3n::tma_load_3d(smem + s * kStageBytes + 3 * kBoxBytes, &maps.w,
                          (c_begin + i) * kTileK, h0, gridDim.y + member,
                          &full[s]);"""),
    ("const bool w_direct = kd % 4 == 0 && aligned(w, 16);",
     "const bool w_direct = false;"),
    (": operand_map(w_rows, kd, h, members, pitch, &maps.w);",
     ": operand_map(w_rows, kd, h, 2 * members, pitch, &maps.w);"),
    ("    out[e / cols * pitch + e % cols] = w[e];",
     """  {
    unsigned hi, lo;
    ta3n::split_tf32(w[e], hi, lo);
    out[e / cols * pitch + e % cols] = __uint_as_float(hi);
    out[(rows + e / cols) * pitch + e % cols] = __uint_as_float(lo);
  }"""),
]

# the tree's plan, which the variants' plans start from
_F32_PLAN = gather_gemm.f32_plan


def _k3_w_planes_plan(m, h, d, k, members=1, per_member=False,
                      weight_aligned=True):
    """f32_plan's call with scratch for W's two planes as well."""
    plan = _F32_PLAN(m, h, d, k, members, per_member)
    return plan._replace(scratch=2 * plan.index_sets * m * plan.pitch
                         + 2 * members * h * plan.pitch)


def _k3_pow2_plan(m, h, d, k, members=1, per_member=False,
                  weight_aligned=True):
    """f32_plan's call with bf16_plan's rule for the K slices: a power of
    two up to 8, the most that keep one member's tiles times slices
    within the 132 SMs."""
    plan = _F32_PLAN(m, h, d, k, members, per_member, weight_aligned)
    most = min(8, -(-k * d // 32),
               max(1, 132 // (plan.row_tiles * plan.col_tiles)))
    return plan._replace(splits=1 << (most.bit_length() - 1))


# the two consumer warpgroups taking turns at the tensor cores (two named
# barriers: one's wait, sum and next split while the other's products
# run), with no branch on the warpgroup around the products
_K3_TURNS = [
    ("// Stage B.  Block (blockIdx.x",
     """__device__ __forceinline__ void turn(int id, bool wait) {
  if (wait)
    asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");
  else
    asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");
}

// Stage B.  Block (blockIdx.x"""),
    ("  for (int i = 0; i < n; ++i) {\n    const int s = i % kStages;\n"
     "    ta3n::mbar_wait(&full[s], (i / kStages) & 1);",
     "  if (wg == 1) turn(2, false);\n"
     "  for (int i = 0; i < n; ++i) {\n    const int s = i % kStages;\n"
     "    ta3n::mbar_wait(&full[s], (i / kStages) & 1);"),
    ("    ta3n::fence_operands(part);\n    ta3n::wgmma_fence();",
     "    asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(2 + wg) : \"memory\");\n"
     "    ta3n::fence_operands(part);\n    ta3n::wgmma_fence();"),
    ("    ta3n::wgmma_commit();\n    ta3n::wgmma_wait<0>();",
     "    ta3n::wgmma_commit();\n"
     "    asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(3 - wg) : \"memory\");\n"
     "    ta3n::wgmma_wait<0>();"),
    ("  // every slice's partial tile in its block's shared memory",
     "  if (wg == 0) turn(2, true);\n\n"
     "  // every slice's partial tile in its block's shared memory"),
]


# K3 at float32 compute in variants of csrc/gather_gemm.cu: name ->
# (source edits, the plan the wrapper takes in place of f32_plan or
# None).  "diagnostic:" variants compute another function (they only
# time what a part of the work costs) and are not checked; a variant
# with other K slices is held to the plain version only (its sums round
# elsewhere).
K3_F32_VARIANTS = {
    "the tree": ([], None),
    "W split into planes before stage A": (_K3_W_PLANES, _k3_w_planes_plan),
    "stage B launched after stage A": ([
        ("attrs[0].val.programmaticStreamSerializationAllowed = 1;",
         "attrs[0].val.programmaticStreamSerializationAllowed = 0;")], None),
    "a ring of 3 stages": ([
        ("constexpr int kStages = 4;", "constexpr int kStages = 3;")], None),
    "the warpgroups taking turns": (_K3_TURNS, None),
    "K slices a power of two up to 8 (bf16_plan's rule)": (
        [], _k3_pow2_plan),
    "diagnostic: two products a k step (no W_lo A_hi)": ([
        ("      wgmma_tf32(part, w_lo[kk], b_hi + step, kk > 0);\n"
         "      wgmma_tf32(part, w_hi[kk], b_lo + step, 1);",
         "      wgmma_tf32(part, w_hi[kk], b_lo + step, kk > 0);")], None),
    "diagnostic: W not split (its raw bits as hi and lo)": ([
        ("        ta3n::split_tf32(*reinterpret_cast<const float*>(st + "
         "at(kk, r)),\n                         w_hi[kk][r], "
         "w_lo[kk][r]);",
         "        w_hi[kk][r] = w_lo[kk][r] =\n"
         "            *reinterpret_cast<const unsigned*>(st + "
         "at(kk, r));")], None),
}


def probe_k3_f32_variants() -> None:
    """K3 at float32 compute built in each variant of K3_F32_VARIANTS,
    from the float32 store at 640 rows with x_res and 1, 4 and 8 members
    over one index set, at 320 rows without x_res, and on the column
    slices H = 256 and 128 at 370 rows with x_res and 320 without: z
    bitwise the tree's and within RTOL of the plain version (but for the
    diagnostic variants), timed in turns, each kernel by the
    profiler."""
    log("k3-f32-variants (device ms, medians of 41 in turns)")
    libs = {name: (variant_library(f"k3 f32 {name}", lambda text: text, "",
                                   {"gather_gemm.cu": edits}), plan)
            for name, (edits, plan) in K3_F32_VARIANTS.items()}
    for name, ((_, ptxas), _) in libs.items():
        log(f"  {name}: " + ptxas_lines(ptxas, "gather_gemm_kernel"))
    tree, chosen = _build.load_library, gather_gemm.f32_plan
    store, w = store_and_weight()
    rows = gather_gemm.row_index(
        np.random.default_rng(0).integers(0, store.shape[0], 640),
        store.shape[0], "cuda")
    part = {n: gather_gemm.row_index(rows.rows[:n].cpu(), store.shape[0],
                                     "cuda") for n in (320, 370)}
    for members, idx, with_rows, h in (
            (1, rows, True, 512), (1, part[320], False, 512),
            (4, rows, True, 512), (8, rows, True, 512),
            (1, part[370], True, 256), (1, part[320], False, 256),
            (1, part[370], True, 128), (1, part[320], False, 128)):
        ws = torch.stack([w[:h]] + [w[:h].roll(i, 0)
                                    for i in range(1, members)])
        fn = lambda: gather_gemm.gathered_gemm_members(store, idx, ws, None,
                                                       with_rows)
        want = [gather_gemm.gathered_gemm_plain(store, idx.rows, ws[i])[0]
                for i in range(members)]
        fns, first = {}, None
        for name, ((lib, _), plan) in libs.items():
            def run(lib=lib, plan=plan):
                with_library(lib)
                gather_gemm.f32_plan = plan or chosen
                try:
                    return fn()
                finally:
                    gather_gemm.f32_plan = chosen
            got = run()[0]
            first = got if first is None else first
            bitwise = plan in (None, _k3_w_planes_plan)
            if not name.startswith("diagnostic") and (
                    (bitwise and not torch.equal(got, first)) or not all(
                        (got[i] - want[i]).abs().max().item()
                        <= chip_smoke.RTOL
                        * max(1.0, want[i].abs().max().item())
                        for i in range(members))):
                raise AssertionError(f"{name}: K3 f32, {members} members, "
                                     f"H={h}")
            fns[name] = run
        t = chip_smoke.time_pair(fns)
        for name, run in fns.items():
            log(f"  {members} members, {idx.rows.shape[0]} rows, H={h}, "
                f"{name}: {t[name]:.4f} ms ({kernel_times(run)})")
    _build.load_library = tree


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


def ptxas_lines(out: str, kernel: str) -> str:
    """ptxas's registers and spills for the first entry naming kernel."""
    lines = out.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            found = [x.split(":", 1)[-1].strip() for x in lines[n + 1:n + 5]
                     if "registers" in x or "spill" in x]
            return "; ".join(found)
    return "not found"


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
  const int member = blockIdx.y;""",
         """  const int tid = threadIdx.x;
  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
  const int member = blockIdx.y;""")],
    "the epilogue launched after the GEMM": [
        ("  config.numAttrs = 1;\n", "  config.numAttrs = 0;\n")],
    "tensor maps prefetched": [
        ("""  const int tid = threadIdx.x;
  const int member = blockIdx.y;""",
         """  const int tid = threadIdx.x;
  if (kVec && tid == ta3n::kConsumers)
    asm volatile("prefetch.tensormap [%0];" ::"l"(&maps.x) : "memory");
  const int member = blockIdx.y;"""),
        ("""      static_cast<long long>(p) * d;
""", """      static_cast<long long>(p) * d;
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


K3_BF16_VARIANTS = {
    "the tree": [],
    "a cluster a tile at any N (no folded slices)": [
        ("const bool fold = splits > 1 && !spread;",
         "const bool fold = false;")],
    "never one block an SM": [
        (": spread ? kSmemSpread", ": false ? kSmemSpread")],
    "stage B launched after stage A": [
        ("attrs[0].val.programmaticStreamSerializationAllowed = 1;",
         "attrs[0].val.programmaticStreamSerializationAllowed = 0;")],
}


def probe_k3_bf16_variants() -> None:
    """K3 at bfloat16 compute built in each variant of K3_BF16_VARIANTS,
    from the bfloat16 store at 640 rows with x_res and 1, 4 and 8 members
    over one index set: z bitwise the tree's and within bf16_err of the
    plain version, timed in turns, each kernel by the profiler."""
    log("k3-bf16-variants (device ms, medians of 41 in turns)")
    libs = {name: variant_library(f"k3 bf16 {name}", lambda text: text, "",
                                  {"gather_gemm_bf16.cu": edits})[0]
            for name, edits in K3_BF16_VARIANTS.items()}
    tree = _build.load_library
    store, w = store_and_weight()
    st, w16 = store.to(torch.bfloat16), w.to(torch.bfloat16)
    rows = gather_gemm.row_index(
        np.random.default_rng(0).integers(0, store.shape[0], 640),
        store.shape[0], "cuda")
    rows320 = gather_gemm.row_index(rows.rows[:320].cpu(),
                                    store.shape[0], "cuda")
    for members, idx, with_rows in ((1, rows, True), (1, rows320, False),
                                    (4, rows, True), (8, rows, True)):
        ws = torch.stack([w16] + [w16.roll(i, 0) for i in
                                  range(1, members)])
        fn = lambda: gather_gemm.gathered_gemm_members(st, idx, ws, None,
                                                       with_rows)
        want = [gather_gemm.gathered_gemm_plain(st, idx.rows, ws[i])[0]
                for i in range(members)]
        fns, first = {}, None
        for name, lib in libs.items():
            def run(lib=lib):
                with_library(lib)
                return fn()
            got = run()[0]
            first = got if first is None else first
            if not torch.equal(got, first) or not all(
                    chip_smoke.bf16_err(got[i], want[i])[1]
                    for i in range(members)):
                raise AssertionError(f"{name}: K3 bf16, {members} members")
            fns[name] = run
        t = chip_smoke.time_pair(fns)
        for name, run in fns.items():
            log(f"  {members} members, {idx.rows.shape[0]} rows, "
                f"{name}: {t[name]:.4f} ms "
                f"({kernel_times(run)})")
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


def _earlier_fwd_splits(s: int, b: int, d: int, h: int) -> int:
    """The D slices of the mma.sync design of K1 (its _fwd_splits): 64 x 64
    tiles of (subset, video) rows by H, as many slices as keep the grid
    within 132 blocks, at most 8 and one per 32-deep chunk."""
    tiles = sum(-(-n * b // 64) * -(-h // 64)
                for _, _, n in trn_fused._fwd_units(s, 3))
    return max(1, min(8, -(-d // 32), 132 // tiles))


class _EarlierTrn:
    """The float32 TRN kernels of an earlier library (the mma.sync design)
    called on stacked inputs as that design's wrappers called them: K1
    with its own D slices and float32 partials [N * splits * n_slots, B,
    H], K2 with no scratch (and its dx / dW families alone through its
    parts entry)."""

    def __init__(self, lib: ctypes.CDLL):
        P, I = ctypes.c_void_p, ctypes.c_int
        fwd = [P] * 5 + [P, I, P] + [I] * 6 + [P]
        bwd = [P] * 8 + [P, I, P] + [I] * 5 + [P]
        for name, argtypes in (
                ("ta3n_trn_fused_fwd_f32", fwd),
                ("ta3n_trn_fused_fwd_train_f32", [P] + fwd),
                ("ta3n_trn_fused_bwd_f32", bwd),
                ("ta3n_trn_fused_bwd_parts_f32", bwd)):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        self.lib = lib

    def _call(self, name, *args):
        err = getattr(self.lib, name)(
            *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier {name} failed: CUDA error {err}")

    def fwd(self, x, w, bi, train):
        n, b, s, d = x.shape
        h = w[0].shape[-2]
        splits = _earlier_fwd_splits(s, b, d, h)
        slots = sum(c for _, _, c in trn_fused._fwd_units(s, 3))
        out = torch.empty((n, b, s - 1, h), device=x.device)
        masks = torch.empty((n, b, trn_fused._n_subsets(s, 3) * h),
                            dtype=torch.uint8, device=x.device)
        part = torch.empty((n * splits * slots, b, h), device=x.device)
        self._call("ta3n_trn_fused_fwd_train_f32" if train
                   else "ta3n_trn_fused_fwd_f32", x.data_ptr(),
                   *trn_fused._pointer_args(w, bi, s, 3, x.device),
                   out.data_ptr(), *([masks.data_ptr()] if train else []),
                   part.data_ptr(), *trn_fused._plan_args(s, 3, x.device),
                   b, s, d, h, splits, n)
        return out

    def bwd(self, x, w, masks, g, parts=3):
        n, b, s, d = x.shape
        h = w[0].shape[-2]
        dx = torch.zeros_like(x)
        dw = torch.zeros((n, sum(t[0].numel() for t in w)), device=x.device)
        db = torch.zeros((n, len(w), h), device=x.device)
        args = (x.data_ptr(), *trn_fused._pointer_args(w, (), s, 3, x.device),
                masks.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                db.data_ptr(), *trn_fused._plan_args(s, 3, x.device), b, s, d,
                h)
        if parts == 3:
            self._call("ta3n_trn_fused_bwd_f32", *args, n)
        else:
            self._call("ta3n_trn_fused_bwd_parts_f32", *args, parts)
        return dx, trn_fused._split_flat(dw, w), db


def _current_bwd_parts(x, w, masks, g, parts):
    """The current K2 on stacked inputs of one member, a family alone (as
    chip_smoke.bwd_parts) or the backward."""
    if parts == 3:
        return trn_fused.trn_multiscale_bwd_members(x, w, masks, g,
                                                    x.shape[2])
    dx, dws, dbs = chip_smoke.bwd_parts(x[0], [t[0] for t in w], masks[0],
                                        g[0], parts)
    return dx[None], tuple(t[None] for t in dws), torch.stack(dbs)[None]


def probe_trn_f32_earlier(csrc: Path, which: str) -> None:
    """K1 (``which`` "k1") or K2 ("k2") at float32 built from an earlier
    csrc/ (the mma.sync design) against the current kernels at every row
    of PERF.md's table: both held to the plain version (within RTOL),
    timed in turns, and the current ones' stages by the profiler."""
    log(f"{which}-earlier (K1 and K2 at f32 from {csrc} against the "
        f"current kernels; device ms, medians of 41 in turns; "
        f"{chip_smoke.card_line()})")
    earlier = _EarlierTrn(earlier_library(csrc))
    gen = torch.Generator().manual_seed(0)

    def stacked(n, b, s):
        sets = [chip_smoke.trn_inputs(b, s, 512, 256, gen, signed=True)
                for _ in range(n)]
        return (torch.stack([t[0] for t in sets]),
                [torch.stack([t[1][i] for t in sets]) for i in range(s - 1)],
                [torch.stack([t[2][i] for t in sets]) for i in range(s - 1)])

    def check(label, got, want):
        got = got if isinstance(got, (tuple, list)) else [got]
        want = want if isinstance(want, (tuple, list)) else [want]
        for a_, r in zip(got, want):
            err = (a_ - r).abs().max().item()
            if not err <= chip_smoke.RTOL * max(1.0, r.abs().max().item()):
                raise AssertionError(f"{label}: {err}")

    def flat(out):
        dx, dws, dbs = out
        return [dx, *dws, dbs if isinstance(dbs, torch.Tensor)
                else torch.stack(list(dbs), -2)]

    if which == "k1":
        cases = [("infer", n, b, s) for b, s in ((1, 5), (64, 5), (202, 5),
                                                 (64, 17), (64, 25))
                 for n in (1,)]
        cases += [("train", 1, 202, s) for s in (5, 17, 25)]
        cases += [("infer", n, 64, 5) for n in (4, 8)]
        cases += [("train", n, 202, 5) for n in (4, 8)]
    else:
        cases = [("bwd", 1, 202, s) for s in (5, 17, 25)]
        cases += [("bwd", n, 202, 5) for n in (4, 8)]
        cases += [("dx", 1, 202, 5), ("dW", 1, 202, 5)]
    with torch.no_grad():
        for kind, n, b, s in cases:
            x, w, bi = stacked(n, b, s)
            plain = [trn_fused.trn_multiscale_fwd_masks_plain(
                x[k], [t[k] for t in w], [t[k] for t in bi], s)
                for k in range(n)]
            if kind in ("infer", "train"):
                train = kind == "train"
                current = (
                    (lambda: trn_fused.trn_multiscale_fwd_masks_members(
                        x, w, bi, s)[0]) if train else
                    (lambda: trn_fused.trn_multiscale_infer_members(
                        x, w, bi, s)))
                old = lambda: earlier.fwd(x, w, bi, train)
                want = torch.stack([o for o, _ in plain])
                stages = chip_smoke.TRN_STAGES["trn_fused_fwd"]
            else:
                masks = torch.stack([m for _, m in plain])
                g = torch.randn((n, b, s - 1, 256), generator=gen).cuda()
                parts = {"bwd": 3, "dx": 1, "dW": 2}[kind]
                current = lambda: _current_bwd_parts(x, w, masks, g, parts)
                old = lambda: earlier.bwd(x, w, masks, g, parts)
                ref = [trn_fused.trn_multiscale_bwd_plain(
                    x[k], [t[k] for t in w], masks[k], g[k], s)
                    for k in range(n)]
                want = flat((torch.stack([r[0] for r in ref]),
                             [torch.stack([r[1][i] for r in ref])
                              for i in range(s - 1)],
                             torch.stack([torch.stack(list(r[2]))
                                          for r in ref])))
                keep = {"bwd": slice(None), "dx": slice(0, 1),
                        "dW": slice(1, None)}[kind]
                want = want[keep]
                stages = chip_smoke.TRN_STAGES["trn_fused_bwd"]
            label = f"{which} {kind} N={n} B={b} S={s}"
            for name, fn in (("earlier", old), ("current", current)):
                got = fn()
                got = flat(got)[keep] if kind in ("bwd", "dx", "dW") \
                    else got
                check(f"{name} {label}", got, want)
            t = chip_smoke.time_pair({"earlier": old, "current": current})
            log(f"  {label}: earlier {t['earlier']:.4f} ms, current "
                f"{t['current']:.4f} ms ({t['earlier'] / t['current']:.2f}x);"
                f" current by stage: "
                + chip_smoke.stage_text(chip_smoke.stage_ms(current,
                                                            stages)))


PROBES = {"k3-splits": probe_k3_splits,
          "k3-clusters": probe_k3_clusters,
          "split-variants": probe_split_variants,
          "k1-splits": probe_k1_splits,
          "wgmma-phases": probe_wgmma_phases,
          "k1-bf16-profile": probe_k1_bf16_profile,
          "k1-bf16-splits": probe_k1_bf16_splits,
          "k1-bf16-variants": probe_k1_bf16_variants,
          "k3-bf16-variants": probe_k3_bf16_variants,
          "k3-f32-variants": probe_k3_f32_variants}
EARLIER = ("k1-earlier", "k2-earlier", "k3-bf16-earlier", "k3-f32-earlier",
           "k1-bf16-earlier")


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
        chosen = gather_gemm.f32_plan
        gather_gemm.f32_plan = lambda *a, **kw: chosen(*a, **kw)._replace(
            splits=slices)
        log(f"K3 at {slices} K slices")
    if "--earlier-csrc" in argv:
        at = argv.index("--earlier-csrc")
        csrc = Path(argv[at + 1]).resolve()
        del argv[at:at + 2]
        PROBES["k1-earlier"] = lambda: probe_trn_f32_earlier(csrc, "k1")
        PROBES["k2-earlier"] = lambda: probe_trn_f32_earlier(csrc, "k2")
        PROBES["k3-bf16-earlier"] = lambda: probe_k3_bf16_earlier(csrc)
        PROBES["k3-f32-earlier"] = lambda: probe_k3_f32_earlier(csrc)
        PROBES["k1-bf16-earlier"] = lambda: probe_k1_bf16_earlier(csrc)
    names = argv or [n for n in PROBES if n not in EARLIER]
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
