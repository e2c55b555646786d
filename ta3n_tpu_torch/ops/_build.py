"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ sources under ``ta3n_tpu_torch/csrc/`` with a
plain C interface.  At first CUDA use they are compiled by ``nvcc`` for
Hopper (``sm_90a``), one compiler process per source, all started
together, then linked into one shared library and bound with ``ctypes``;
no PyTorch headers are compiled, so a build takes seconds.

The library lands in ``build/ta3n_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the sources and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.  It
is written under a temporary name and moved into place with
``os.replace``, so a concurrent or interrupted build never leaves a
half-written library behind.  ``hashed_name`` and ``build_shared`` hold
that policy for every library of the port (the host gather's too,
`data/native_gather.py`, built by the host C++ compiler).

Nothing here runs at import: a machine without ``nvcc`` imports the port
and uses the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "hashed_name", "build_shared", "library_path",
           "compile_library", "load_library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (_CSRC / "trn_fused_fwd.cu", _CSRC / "trn_fused_fwd_bf16.cu",
           _CSRC / "trn_fused_bwd.cu", _CSRC / "trn_fused_bwd_bf16.cu",
           _CSRC / "gather_gemm.cu", _CSRC / "gather_gemm_bf16.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ta3n_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream c_void_p)
_ENTRIES = {
    # x, ptrs (device), ptrs (host), out, part, plan table, its length,
    # plan (device), batch, frames, d, h, splits, members, stream
    "ta3n_trn_fused_fwd_f32": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                               _I, _I, _I, _P],
    # x, ptrs (device), ptrs (host), out, masks, part, plan table, its
    # length, plan (device), batch, frames, d, h, splits, members, stream
    "ta3n_trn_fused_fwd_train_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                                     _I, _I, _I, _I, _I, _P],
    # the bfloat16 variants of the two (trn_fused_fwd_bf16.cu): the same
    # arguments with the grid (row tiles, H tiles, D slices) for splits
    "ta3n_trn_fused_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _P],
    "ta3n_trn_fused_fwd_train_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w ptrs (device), w ptrs (host), masks, g, dx, dw, db, scratch,
    # plan table, its length, plan (device), batch, frames, d, h, K
    # slices, members, stream
    "ta3n_trn_fused_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _P, _I, _I, _I, _I, _I, _I, _P],
    # the same without members and with parts (1: dx tiles, 2: dW/db
    # tiles, 3: both), stream
    "ta3n_trn_fused_bwd_parts_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _P, _I, _I, _I, _I, _I, _I, _P],
    # the bfloat16 backward (trn_fused_bwd_bf16.cu): the same arguments
    # with its grid (dx blocks, dW/db blocks) before members
    "ta3n_trn_fused_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                _I, _I, _I, _I, _I, _I, _I, _P],
    # store, its int8 scales, idx, scale, w, z, x_res, part, n_idx,
    # streams, d, k_rows, h, splits, store kind, compute kind (1:
    # gather_gemm_bf16.cu's kernel), members (either compute kind),
    # per-member indices (0 or 1), stream
    "ta3n_gather_gemm_members": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            "ta3n_tpu_torch/csrc at first CUDA use")
    return found


def hashed_name(stem: str, key: str, sources) -> str:
    """``{stem}_{hash}.so``: the hash of ``key`` (the compiler and its
    flags) and of each source's name and bytes, so an edited source or a
    changed flag gets a build of its own."""
    digest = hashlib.sha256(key.encode())
    for src in sorted(sources, key=lambda p: p.name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return f"{stem}_{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the library for the current sources and flags lives: named by
    a hash of the flags and of every ``*.cu`` and ``*.cuh`` under
    ``csrc/``, so an edited header is rebuilt too."""
    return BUILD_DIR / hashed_name(
        "libta3n_tpu_torch", " ".join(NVCC_FLAGS),
        [*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")])


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise if any fails, else return
    their output in order."""
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
    except FileNotFoundError as e:
        raise RuntimeError(f"no compiler {cmds[0][0]!r}: {e}") from e
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_shared(path: Path, compiler, flags, sources) -> str:
    """Compile ``sources`` into the shared library ``path``: one
    ``compiler`` process per source, concurrently, then one link, in a
    temporary directory beside ``path``, moved into place with
    ``os.replace``.  Return the compiler's output; raise with it if a
    step fails."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        out = _run_all([[*compiler, *flags, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources, objs)])
        lib = os.path.join(tmp, path.name)
        out += _run_all([[*compiler, *flags, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
    return out


def compile_library(path: Path) -> str:
    """Compile SOURCES into ``path`` with nvcc.  Return the compiler's
    output (ptxas prints each kernel's registers, shared memory and
    spills)."""
    return build_shared(path, [_nvcc()], NVCC_FLAGS, SOURCES)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, compiled first if this source has no build."""
    path = library_path()
    if not path.is_file():
        compile_library(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
