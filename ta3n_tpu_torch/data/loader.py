"""Batch iteration over a FeatureStore with TSN segment sampling: the port's
own copy of `ta3n_tpu/data/loader.py`'s ``TSNLoader``, ``Batch`` and
``IndexBatch``.

A vectorised host pipeline (reference: torch DataLoader workers,
main.py:169-200): one numpy gather per batch, or only indices for the
device-store steps, with static batch shapes and validity masks instead of
dummy-row padding (main.py:358-372).  Given the same seed, it samples and
pads exactly as the JAX loader does, also the shard-local batches of a
streamed store (``shard_index_epoch``, `data/streaming.py`), whose methods
are the JAX loader's, line for line.  Index batches are a few KB, so the
port has no prefetch thread.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from ta3n_tpu_torch.data.feature_store import FeatureStore
from ta3n_tpu_torch.data.manifest import VideoRecord, repeat_to
from ta3n_tpu_torch.data.samplers import (expand_new_length,
                                          sample_indices_random,
                                          sample_indices_test,
                                          sample_indices_val)

__all__ = ["Batch", "IndexBatch", "TSNLoader"]

class Batch(NamedTuple):
    features: np.ndarray   # [B, T, D]
    labels: np.ndarray     # [B] int32
    mask: np.ndarray       # [B] float32, 0 for padded rows


class IndexBatch(NamedTuple):
    """Device-store batch: only indices cross the host boundary; the
    feature gather happens on the device inside the step."""
    abs_indices: np.ndarray  # [B, T] int32 rows into the packed store
    labels: np.ndarray       # [B] int32
    mask: np.ndarray         # [B] float32


class TSNLoader:
    """Epoch iterator with reference-parity sampling semantics.

    mode:
      'random' — training sampler (dataset.py:76-90)
      'val'    — centre-of-segment (dataset.py:92-101)
      'test'   — centre-of-segment with short-video duplication
                 (dataset.py:103-116).  NOTE the reference trains with
                 ``random_shift=False, test_mode=True`` (main.py:185-196),
                 i.e. 'test' sampling — keep that for parity runs.
    """

    def __init__(self, store: FeatureStore,
                 records: Optional[Sequence[VideoRecord]] = None,
                 num_dataload: Optional[int] = None,
                 batch_size: int = 32, num_segments: int = 5,
                 new_length: int = 1, mode: str = "test",
                 shuffle: bool = True, seed: int = 1,
                 dtype=np.float32, pad_to: Optional[int] = None):
        self.store = store
        base = list(records) if records is not None else store.records()
        if num_dataload is not None:
            base = repeat_to(base, num_dataload)
        self.records = base
        self.video_idx = np.array([store.index_of(r.path) for r in base],
                                  dtype=np.int64)
        self.num_frames = np.array([r.num_frames for r in base],
                                   dtype=np.int64)
        self.labels = np.array([r.label for r in base], dtype=np.int32)
        self.batch_size = batch_size
        # static emitted batch shape; > batch_size pads with masked rows
        self.pad_to = pad_to if pad_to is not None else batch_size
        self.num_segments = num_segments
        self.new_length = new_length
        self.mode = mode
        self.shuffle = shuffle
        self.dtype = dtype
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        """Batches per epoch: ceil(n / b) — torch DataLoader keeps the
        partial last batch (main.py:190)."""
        return -(-len(self.records) // self.batch_size)

    @property
    def num_videos(self) -> int:
        return len(self.records)

    @property
    def frames_per_video(self) -> int:
        return self.num_segments * self.new_length * self.store.num_streams

    def _sample(self, num_frames: np.ndarray) -> np.ndarray:
        if self.mode == "random":
            idx = sample_indices_random(num_frames, self.num_segments,
                                        self.new_length, self._rng)
        elif self.mode == "val":
            idx = sample_indices_val(num_frames, self.num_segments,
                                     self.new_length)
        elif self.mode == "test":
            idx = sample_indices_test(num_frames, self.num_segments,
                                      self.new_length)
        else:
            raise ValueError(f"unknown mode {self.mode}")
        return expand_new_length(idx, num_frames, self.new_length)

    def _batches(self) -> Iterator[tuple]:
        order = np.arange(len(self.records))
        if self.shuffle:
            order = self._rng.permutation(order)
        b = self.batch_size
        p = max(self.pad_to, b)
        for start in range(0, len(order), b):
            sel = order[start:start + b]
            n_real = sel.shape[0]
            if n_real < p:  # pad to the static batch shape, mask the rest
                sel = np.concatenate([sel, np.zeros(p - n_real,
                                                    dtype=sel.dtype)])
            vids = self.video_idx[sel]
            frames = self._sample(self.num_frames[sel])
            labels = self.labels[sel]
            mask = np.zeros(p, dtype=np.float32)
            mask[:n_real] = 1.0
            yield vids, frames, labels, mask, n_real

    def epoch(self) -> Iterator[Batch]:
        for vids, frames, labels, mask, n_real in self._batches():
            feats = self.store.gather(vids, frames, dtype=self.dtype)
            feats[n_real:] = 0.0
            yield Batch(feats, labels, mask)

    def index_epoch(self) -> Iterator[IndexBatch]:
        """Index-only batches for the device-resident store: the features
        live on the card (``FeatureStore.to_device``) and the step gathers
        rows there (``make_train_step(gather_on_device=True)``)."""
        for vids, frames, labels, mask, n_real in self._batches():
            abs_idx = (self.store.offsets[vids][:, None]
                       + frames).astype(np.int32)
            abs_idx[n_real:] = 0  # masked rows read row 0 harmlessly
            yield IndexBatch(abs_idx, labels, mask)

    # ---- larger-than-memory streaming (data/streaming.py) ----
    def _shard_groups(self, plan):
        """Record positions grouped by the shard their video lives in,
        shuffled within each shard (shard-local shuffle window)."""
        sid_of_record = plan.shard_of(self.video_idx)
        groups = []
        for sid in range(plan.num_shards):
            g = np.nonzero(sid_of_record == sid)[0]
            if self.shuffle:
                g = self._rng.permutation(g)
            groups.append(g)
        return groups

    def shard_epoch_len(self, plan) -> int:
        """Batches per streamed epoch: per-shard tails are padded, so
        this is >= len(self) by up to num_shards-1 batches."""
        sid_of_record = plan.shard_of(self.video_idx)
        counts = np.bincount(sid_of_record, minlength=plan.num_shards)
        b = self.batch_size
        return int(sum(-(-int(c) // b) for c in counts if c))

    def shard_index_epoch(self, plan) -> Iterator[tuple]:
        """(shard_id, IndexBatch) stream with shard-LOCAL row indices,
        shards in ascending order (ShardStream prefetch contract).
        Batches never span shards; shard tails are padded + masked."""
        b = self.batch_size
        p = max(self.pad_to, b)
        for sid, g in enumerate(self._shard_groups(plan)):
            row0 = int(plan.row_lo[sid])
            for start in range(0, len(g), b):
                sel = g[start:start + b]
                n_real = sel.shape[0]
                if n_real == 0:
                    continue
                if n_real < p:
                    sel = np.concatenate(
                        [sel, np.zeros(p - n_real, dtype=sel.dtype)])
                vids = self.video_idx[sel]
                frames = self._sample(self.num_frames[sel])
                labels = self.labels[sel]
                mask = np.zeros(p, dtype=np.float32)
                mask[:n_real] = 1.0
                abs_idx = (self.store.offsets[vids][:, None] + frames
                           - row0).astype(np.int32)
                abs_idx[n_real:] = 0  # masked rows read local row 0
                yield sid, IndexBatch(abs_idx, labels, mask)
