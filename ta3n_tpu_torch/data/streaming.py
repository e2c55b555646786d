"""Larger-than-memory feature stores: shards streamed to the card.  The
port of `ta3n_tpu/data/streaming.py`.

The packed store on the card (``FeatureStore.to_device``) caps a dataset
at device memory.  This module lifts the cap:

* ``ShardPlan``, copied from the JAX package, partitions a store's videos
  into contiguous row shards of at most ``budget_rows`` rows; every shard
  is padded to exactly ``budget_rows`` rows, so every shard has one shape.
* ``TSNLoader.shard_index_epoch(plan)`` (`data/loader.py`) yields
  ``(shard_id, IndexBatch)`` with shard-local row indices, shards in
  order, videos shuffled within their shard.
* ``ShardStream`` keeps the current shard on the card and uploads the next
  one while the current one is trained on: a worker thread fills a pinned
  host buffer and issues a ``non_blocking`` copy on a side CUDA stream,
  which the compute stream waits for (an event) before it first reads the
  shard, so neither the host's copies nor the transfer hold up the
  dispatch of the current shard's steps.

Peak device residency is 2 * budget_rows rows (the current and the
prefetched shard) of 4 bytes an element in float32, 2 in bfloat16 and
about 1 in int8 (`data/quantized.py`).

Equivalence contract (tests/test_torch_port_streaming.py): training on
the shard-local batches through ShardStream ends with bitwise the
parameters of the resident store on the same batches with global
indices.  A shard holds exactly the bytes of its rows in the resident
store (`feature_store.host_rows` converts per row), and the gather
kernel's grid depends on the batch's rows, never on the store's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ta3n_tpu_torch.data.feature_store import _dtype_name, host_rows

__all__ = ["ShardPlan", "ShardStream"]


class ShardPlan:
    """Greedy contiguous partition of a packed store's rows.

    offsets: [num_videos + 1] int64 row offsets (FeatureStore.offsets).
    budget_rows: max rows resident per shard; shards are padded to
    exactly this many rows so the jitted step compiles once.
    """

    def __init__(self, offsets: np.ndarray, budget_rows: int):
        offsets = np.asarray(offsets, dtype=np.int64)
        total = int(offsets[-1])
        self.budget_rows = int(min(budget_rows, total))
        n = offsets.shape[0] - 1
        video_lo, video_hi, row_lo, row_hi = [], [], [], []
        v = 0
        while v < n:
            start = int(offsets[v])
            hi = v
            while hi < n and int(offsets[hi + 1]) - start <= self.budget_rows:
                hi += 1
            if hi == v:
                raise ValueError(
                    f"video {v} alone has {int(offsets[v + 1]) - start} rows"
                    f" > budget_rows={self.budget_rows}; raise the budget")
            video_lo.append(v)
            video_hi.append(hi)
            row_lo.append(start)
            row_hi.append(int(offsets[hi]))
            v = hi
        self.video_lo = np.asarray(video_lo, dtype=np.int64)
        self.video_hi = np.asarray(video_hi, dtype=np.int64)
        self.row_lo = np.asarray(row_lo, dtype=np.int64)
        self.row_hi = np.asarray(row_hi, dtype=np.int64)
        # video index -> shard id
        counts = self.video_hi - self.video_lo
        self._vid2shard = np.repeat(
            np.arange(len(counts), dtype=np.int32), counts)

    @property
    def num_shards(self) -> int:
        return len(self.row_lo)

    def shard_of(self, video_idx: np.ndarray) -> np.ndarray:
        return self._vid2shard[np.asarray(video_idx)]

    def shard_array(self, features: np.ndarray, sid: int) -> np.ndarray:
        """Shard rows padded to [budget_rows, ...] (one host copy)."""
        lo, hi = int(self.row_lo[sid]), int(self.row_hi[sid])
        buf = np.zeros((self.budget_rows,) + features.shape[1:],
                       dtype=features.dtype)
        buf[:hi - lo] = features[lo:hi]
        return buf


class ShardStream:
    """Double-buffered host-to-card shard uploader.

    ``get(sid)`` returns shard ``sid`` on the card (uploading it unless it
    is the prefetched one) and starts the upload of the next shard, after
    the last one the first, for the next epoch.  Shards must be requested
    in that cyclic order for the prefetch to hit (the loader and the chunk
    plans walk them in order, an epoch at a time).

    ``sharding`` is the device the shards go to (the JAX class's placement
    argument; None: the card).  ``dtype`` is the store dtype on the card
    (None, "float32", "bfloat16" or "int8"), converted per shard as
    ``FeatureStore.to_device`` converts the whole store; ``scales`` are
    the per-row scales of a store quantized on disk, sharded alongside its
    rows (padding rows get scale 0 and dequantize to zeros).  A shard is
    a tensor [budget_rows, ...] or an int8 pair ``(q, scale)``.

    On the card a prefetch runs in a worker thread: the shard's rows
    converted on the host straight into pinned memory (one host copy for
    float32 and bfloat16 rows), and a ``non_blocking`` copy to the card on
    a side stream.  The compute stream
    waits for its event when ``get`` hands the shard out, and the shard's
    tensors are recorded on the compute stream, so their memory is not
    reused while kernels read them.  The pinned buffers are held until
    their shard is dropped.  A shard that was not prefetched is uploaded
    the same way by the caller.  On the CPU an upload is a plain copy, in
    the caller.  ``uploads`` counts the shards uploaded.
    """

    def __init__(self, features: np.ndarray, plan: ShardPlan,
                 sharding=None, dtype=None, prefetch: bool = True,
                 scales: Optional[np.ndarray] = None):
        self.features = features
        self.plan = plan
        self.device = torch.device("cuda" if sharding is None else sharding)
        self.dtype = dtype
        self.scales = scales
        self.prefetch = prefetch
        self.uploads = 0
        self._current: Optional[tuple] = None
        self._next: dict = {}
        self._stream = None
        self._worker = None

    def _host(self, sid: int, pin: bool) -> tuple:
        """The host tensors of shard ``sid``, padded to budget_rows, in
        pinned memory if ``pin``: the bytes that `feature_store.host_rows`
        gives for ``plan.shard_array`` of the rows (and of the scales), made
        without its intermediate copies where the rows need no
        quantizing."""
        lo, hi = int(self.plan.row_lo[sid]), int(self.plan.row_hi[sid])
        rows = np.asarray(self.features[lo:hi])
        shape = (self.plan.budget_rows,) + rows.shape[1:]
        if self.scales is not None or _dtype_name(self.dtype) == "int8":
            q, scale = host_rows(
                self.plan.shard_array(self.features, sid), self.dtype,
                None if self.scales is None
                else self.plan.shard_array(self.scales, sid))
            return tuple(t.pin_memory() if pin else t for t in (q, scale))
        bf16 = _dtype_name(self.dtype) == "bfloat16"
        out = torch.empty(shape, dtype=torch.bfloat16 if bf16
                          else torch.float32, pin_memory=pin)
        out[hi - lo:] = 0
        if bf16:  # rounded to nearest even, as host_rows rounds
            out[:hi - lo].copy_(torch.from_numpy(rows.astype(np.float32)))
        else:     # float16 rows upcast exactly
            out[:hi - lo].numpy()[...] = rows
        return (out,)

    def _put(self, sid: int) -> tuple:
        """(shard on the device, the copy's event or None, the pinned host
        tensors or None)."""
        cuda = self.device.type == "cuda"
        parts = self._host(sid, pin=cuda)
        if not cuda:  # a new tensor already: a plain copy
            dev = tuple(t.to(self.device) for t in parts)
            return (dev if len(dev) > 1 else dev[0]), None, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = tuple(t.to(self.device, non_blocking=True) for t in parts)
            done = torch.cuda.Event()
            done.record(self._stream)
        return (dev if len(dev) > 1 else dev[0]), done, parts

    def _prefetch(self, sid: int):
        """Start the upload of shard ``sid``: in the worker thread on the
        card, at once on the CPU."""
        self.uploads += 1
        if self.device.type != "cuda":
            return self._put(sid)
        if self._worker is None:
            self._worker = ThreadPoolExecutor(1, "shard-prefetch")
        return self._worker.submit(self._put, sid)

    def get(self, sid: int):
        if self._current is not None and self._current[0] == sid:
            return self._current[1]
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        buf = self._next.pop(sid, None)
        if buf is None:
            self.uploads += 1
            buf = self._put(sid)
        elif not isinstance(buf, tuple):  # a prefetch in the worker
            buf = buf.result()
        shard, done, _ = buf
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in (shard if isinstance(shard, tuple) else (shard,)):
                t.record_stream(compute)
        self._current = (sid, shard, buf)
        for stale in self._next.values():  # dropped: frees its buffers
            if not isinstance(stale, tuple):
                stale.cancel()  # unless the worker has started it
        self._next.clear()
        nxt = (sid + 1) % self.plan.num_shards
        if self.prefetch and nxt != sid:
            self._next[nxt] = self._prefetch(nxt)
        return shard
