"""ctypes binding for the native batch gather (``csrc/feature_gather.cc``):
the port's own copy of `ta3n_tpu/data/native_gather.py`.

The library does bounds-checked row ``memcpy``, on one thread unless
``num_threads`` says more, for any itemsize: the host path of
``FeatureStore.gather`` while its switch ``use_native_gather`` is on.  It
is built at first use with the host C++ compiler (``$CXX``, default
``g++``; no ``nvcc``) by `ops/_build.py`'s ``build_shared`` into
``build/ta3n_tpu_torch/``, named by a hash of the source, the compiler,
its flags and the host's machine type and C library, and moved into place
atomically, so concurrent builds never leave a half-written library
behind.

Unlike the JAX binding it never falls back to numpy: a failed build or
load raises with the compiler's message, an array the library cannot take
raises ``ValueError``, and an index outside its video raises
``IndexError``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import platform
import shlex
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from ta3n_tpu_torch.ops import _build

__all__ = ["load_native", "native_gather", "native_available",
           "build_native"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "feature_gather.cc"
BUILD_DIR = _build.BUILD_DIR
# no -march=native: the library may be built on one machine and run on
# another that shares the checkout
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread")

_ARGTYPES = [
    ctypes.c_char_p,                      # features
    ctypes.POINTER(ctypes.c_int64),       # offsets
    ctypes.POINTER(ctypes.c_int64),       # video_idx
    ctypes.POINTER(ctypes.c_int64),       # frame_idx
    ctypes.c_char_p,                      # out
    ctypes.c_int64, ctypes.c_int64,       # num_videos, total_rows
    ctypes.c_int64, ctypes.c_int64,       # batch, frames_per_video
    ctypes.c_int64, ctypes.c_int,         # row_bytes, num_threads
]


def _cxx() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


def _lib_path() -> Path:
    """The library for this source, compiler, flags and host (its machine
    type and C library: a checkout shared by two hosts keeps one build
    each)."""
    host = repr((platform.machine(), platform.libc_ver()))
    return BUILD_DIR / _build.hashed_name(
        "libta3n_gather", " ".join([*_cxx(), *CXX_FLAGS, host]), [SOURCE])


def build_native() -> bool:
    """Compile the library (always, replacing any earlier build); raise
    with the compiler's message if it fails."""
    if shutil.which(_cxx()[0]) is None:
        raise RuntimeError(f"native gather: no C++ compiler {_cxx()[0]!r} "
                           "(set $CXX)")
    try:
        _build.build_shared(_lib_path(), _cxx(), CXX_FLAGS, [SOURCE])
    except RuntimeError as e:
        raise RuntimeError(f"native gather: build failed ($CXX is "
                           f"{' '.join(_cxx())}): {e}") from e
    return True


@functools.cache
def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.gather_rows.restype = ctypes.c_int
    lib.gather_rows.argtypes = _ARGTYPES
    return lib


def load_native(build_if_missing: bool = False):
    """The library, compiled first if it is not built and
    ``build_if_missing``; None if it is not built and not to be."""
    path = _lib_path()
    if not path.is_file():
        if not build_if_missing:
            return None
        build_native()
    return _load(path)


def native_available() -> bool:
    """Whether the library for this source is built (nothing is
    compiled)."""
    return load_native() is not None


def native_gather(features: np.ndarray, offsets: np.ndarray,
                  video_idx: np.ndarray, frame_idx: np.ndarray,
                  num_threads: Optional[int] = None) -> np.ndarray:
    """``out[b, t] = features[offsets[video_idx[b]] + frame_idx[b, t]]``
    through the library, built at first use, on ``num_threads`` threads
    (default one: at the train batches, 128 and 74 x 5 rows of 2048
    floats, more were slower on the card's host; PERF.md §6): [B, T,
    *row] of the features' dtype.  ``features`` is a C-contiguous numpy
    array (a memmap too)."""
    if not isinstance(features, np.ndarray):
        raise ValueError(f"native gather: features must be a numpy array, "
                         f"not {type(features).__name__}")
    if not features.flags["C_CONTIGUOUS"]:
        raise ValueError("native gather: features must be C-contiguous")
    lib = load_native(build_if_missing=True)
    video_idx, frame_idx = np.asarray(video_idx), np.asarray(frame_idx)
    for idx in (video_idx, frame_idx):
        if idx.size and not np.issubdtype(idx.dtype, np.integer):
            raise IndexError(f"native gather: {idx.dtype} indices")
    if frame_idx.ndim != 2 or video_idx.shape != frame_idx.shape[:1]:
        raise ValueError(f"native gather: video_idx {video_idx.shape} for "
                         f"frame_idx {frame_idx.shape}")
    frame_idx = np.ascontiguousarray(frame_idx, dtype=np.int64)
    video_idx = np.ascontiguousarray(video_idx, dtype=np.int64)
    b, t = frame_idx.shape
    # the library trusts the offsets (they may come from a file): every
    # video's rows must lie inside the features
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or not len(offsets) or offsets[0] < 0 or \
            offsets[-1] > features.shape[0] or \
            np.any(offsets[1:] < offsets[:-1]):
        raise ValueError("native gather: offsets must rise from >= 0 to at "
                         f"most the {features.shape[0]} feature rows")
    row_shape = features.shape[1:]
    row_bytes = int(np.prod(row_shape)) * features.itemsize
    out = np.empty((b, t) + row_shape, dtype=features.dtype)
    rc = lib.gather_rows(
        features.ctypes.data_as(ctypes.c_char_p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        video_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        frame_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_char_p),
        len(offsets) - 1, features.shape[0], b, t, row_bytes,
        num_threads or 1)
    if rc != 0:
        raise IndexError("native gather: index out of range")
    return out
