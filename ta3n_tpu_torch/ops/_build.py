"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ sources under ``ta3n_tpu_torch/csrc/`` with a
plain C interface.  At first CUDA use they are compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library and bound with ``ctypes``; no
PyTorch headers are compiled, so a build takes seconds.

The library lands in ``build/ta3n_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the sources and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.  It
is written under a temporary name and moved into place with
``os.replace``, so a concurrent or interrupted build never leaves a
half-written library behind.

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

__all__ = ["SOURCES", "library_path", "compile_library", "load_library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (_CSRC / "trn_fused_fwd.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ta3n_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (every pointer and the stream c_void_p)
_ENTRIES = {
    # x, w ptrs, b ptrs, out, plan table, batch, frames, d, h, stream
    "ta3n_trn_fused_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libta3n_tpu_torch_{digest.hexdigest()[:16]}.so"


def compile_library(path: Path) -> str:
    """Compile SOURCES into ``path``; return the compiler's output (ptxas
    prints each kernel's registers, shared memory and spills)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


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
