"""Int8 row-quantized feature stores (``--store_dtype int8``): the port's
own copy of `ta3n_tpu/data/quantized.py`, which produces the same bytes.

Each frame-feature row is stored as int8 plus ONE float32 scale
(symmetric per-row quantization, scale = max|row| / 127): 4x fewer bytes
on the card than float32, 2x fewer than bfloat16.  On the card a
quantized store is the pair ``(q, scale)`` (``FeatureStore.to_device``);
the fused gather + FC kernel (`ops/gather_gemm.py`, K3) reads the int8
rows and their scales itself and dequantizes as it stages them, in the
order of ``dequantize_rows``.

Error bound: |x - dequant(quant(x))| <= scale/2 = max|row| / 254 per
row (round-to-nearest), i.e. ~0.4% of the row's dynamic range.
"""

from __future__ import annotations

import numpy as np

__all__ = ["QINT8_MAX", "quantize_rows", "dequantize_rows",
           "is_quantized"]

QINT8_MAX = 127.0


def quantize_rows(arr: np.ndarray):
    """Per-row symmetric int8 quantization.

    arr: [rows, D] or [rows, streams, D] float array.
    Returns (q int8 same-shape, scale float32 [rows]); all-zero rows
    (e.g. shard padding) get scale 1 so they dequantize to exact zeros.
    """
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    amax = np.abs(arr.reshape(arr.shape[0], -1)).max(axis=1)
    scale = np.where(amax > 0, amax / QINT8_MAX, 1.0).astype(np.float32)
    s = scale.reshape((-1,) + (1,) * (arr.ndim - 1))
    q = np.rint(arr / s).astype(np.int8)  # |arr/s| <= 127 by construction
    return q, scale


def dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host-side inverse of quantize_rows, in the op order of every
    dequantization in the port (cast, then multiply), so that host and
    device dequantized values agree bitwise."""
    s = np.asarray(scale, np.float32).reshape(
        (-1,) + (1,) * (q.ndim - 1))
    return q.astype(np.float32) * s


def is_quantized(store) -> bool:
    """True when a device-store argument is a (q, scale) pair."""
    return isinstance(store, (tuple, list))
