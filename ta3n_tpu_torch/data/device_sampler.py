"""The index pipeline on the device: epoch orders, TSN segment sampling
and the offset arithmetic as torch ops on the card, so that a K-step call
(`train/step.py::make_sampled_multi_step`) needs nothing from the host but
the schedule scalars.  The port of `ta3n_tpu/data/device_sampler.py`.

Deterministic modes ('val', 'test') give bitwise the host loader's
indices, by construction: each record's frame indices are made on the
host with the port's own samplers (`data/samplers.py`) when the sampler is
built, and a batch is a row gather of them (the float64 central formula
has no exact integer form for every (segments, num_frames) pair, e.g.
S = 7, nf = 12).  They are therefore bitwise the JAX ``DeviceSampler``'s
too.

'random' mode and shuffled epoch orders cannot reproduce the JAX
package's threefry streams (nor the host's numpy Generator).  They draw
from a counter-keyed integer hash of (seed, salt, epoch or step, position)
written in int64 torch ops, so that the CPU and the card give bitwise the
same indices.  Every product stays below 2**63: 32-bit values times odd
constants below 2**31, masked back to 32 bits.  An epoch order is a
stable ``argsort`` of hashed keys.  The distribution contract is the JAX
one: chunk-aligned random offsets, the sorted fallback for short videos,
every record once per epoch.  Runs are deterministic given the seed.

A sampler is built on the CPU; ``to(device)`` moves its tensors to the
store's device.  ``end`` is one past the largest row index it can make
(masked rows read row 0), known on the host, so that the indices it makes
need no check on the host (`ops/gather_gemm.py::RowIndex`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ta3n_tpu_torch.data.loader import TSNLoader
from ta3n_tpu_torch.data.samplers import (expand_new_length,
                                          sample_indices_test,
                                          sample_indices_val)

__all__ = ["DeviceSampler", "StreamingDeviceSampler",
           "plan_zip_shard_chunks"]

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit value times one stays below 2**63
_MUL1, _MUL2 = 0x7FEB352D, 0x2C1B3C6D
# the streams drawn from one seed
_SALT_EPOCH, _SALT_SHARD, _SALT_OFFSET, _SALT_SORTED = (
    0x1B873593, 0x68E31DA4, 0x5BD1E995, 0x3C6EF372)


def _mix(x):
    """A 32-bit integer finaliser (xorshift-multiply), on a Python int or
    an int64 tensor of values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def _key(seed: int, salt: int, *counters: int) -> int:
    """The host part of a hash: the seed, a stream's salt and counters
    (epoch, shard, step), each folded in 32 bits at a time."""
    h = _mix((seed ^ salt) & _M32)
    for c in counters:
        h = _mix(h ^ (c & _M32))
        h = _mix(h ^ ((c >> 32) & _M32))
    return h


def _hash(key: int, position: torch.Tensor) -> torch.Tensor:
    """32-bit hashes [0, 2**32) of int64 ``position`` values (below
    2**32) under a host key."""
    return _mix(_mix(position ^ key) ^ _SALT_OFFSET)


def plan_zip_shard_chunks(sampler_s, sampler_t, steps_per_call: int):
    """Host-side chunk plan for one streamed epoch with BOTH streams'
    shard progressions zipped (main.py:330 zip-shortest semantics):
    returns [(sid_s, j0_s, sid_t, j0_t, k)] with chunks breaking
    whenever EITHER stream switches shards and k <= steps_per_call."""
    def seq_of(sampler):
        return [(sid, j) for sid in range(sampler.num_shards)
                for j in range(sampler.shard_steps(sid))]

    a, b = seq_of(sampler_s), seq_of(sampler_t)
    n = min(len(a), len(b))
    chunks = []
    i = 0
    while i < n:
        sid_s, j0_s = a[i]
        sid_t, j0_t = b[i]
        k = 1
        while (k < steps_per_call and i + k < n
               and a[i + k][0] == sid_s and b[i + k][0] == sid_t):
            k += 1
        chunks.append((sid_s, j0_s, sid_t, j0_t, k))
        i += k
    return chunks


class DeviceSampler:
    """Index batches of one loader's records, made by torch ops on the
    sampler's device (the JAX class's traced batches)."""

    def __init__(self, loader: TSNLoader, seed: int = 0):
        store = loader.store
        # each record's row offset into the packed store (the list
        # repetition, dataset.py:69-74, is in loader.video_idx)
        offsets = np.asarray(store.offsets)[loader.video_idx].astype(
            np.int64)
        num_frames = np.asarray(loader.num_frames, np.int64)
        # the three per-record fields packed: one row gather per batch
        self._fields = torch.as_tensor(
            np.stack([offsets, num_frames, np.asarray(loader.labels,
                                                      np.int64)], axis=1))
        self.n = len(loader.records)
        self.batch_size = loader.batch_size
        self.pad_to = max(loader.pad_to, loader.batch_size)
        self.steps_per_epoch = len(loader)
        self.num_segments = loader.num_segments
        self.new_length = loader.new_length
        self.mode = loader.mode
        self.shuffle = loader.shuffle
        self.seed = int(seed)
        self._det_frames = None
        if self.mode in ("val", "test"):
            # the host sampler's frames, made once: bitwise parity
            sampler = (sample_indices_val if self.mode == "val"
                       else sample_indices_test)
            starts = sampler(num_frames, self.num_segments, self.new_length)
            frames = expand_new_length(starts, num_frames, self.new_length)
            self._det_frames = torch.as_tensor(
                np.asarray(frames, np.int64))                 # [N, T]
            last = (offsets[:, None] + frames).max(axis=1) if self.n else 0
        elif self.mode == "random":
            last = offsets + np.maximum(num_frames, 1) - 1
        else:
            raise ValueError(f"unsupported on-device sampling mode "
                             f"{self.mode}")
        # one past the largest row a batch can read (masked rows: row 0)
        self.end = int(max(np.max(last, initial=0), 0)) + 1
        self.device = torch.device("cpu")

    def to(self, device) -> "DeviceSampler":
        """Move the sampler's tensors to ``device`` (the store's)."""
        self.device = torch.device(device)
        for name, value in vars(self).items():
            if isinstance(value, torch.Tensor):
                setattr(self, name, value.to(self.device))
        return self

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int64, device=self.device)

    def epoch_order(self, epoch: int) -> torch.Tensor:
        """The records' visit order in one epoch ([n] int64): a stable
        argsort of hashed keys, or the loader's order without shuffle."""
        if not self.shuffle:
            return self._arange(self.n)
        keys = _hash(_key(self.seed, _SALT_EPOCH, epoch),
                     self._arange(self.n))
        return torch.argsort(keys, stable=True)

    # ---- batch construction, on the device ----
    def batch(self, step: int, order: torch.Tensor = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Global step ``step`` (a host int) -> (abs_idx [P, T] int32,
        labels [P] int64, mask [P] float32), P = pad_to; ``order``
        optionally the precomputed ``epoch_order(step // spe)``."""
        spe = self.steps_per_epoch
        i = step % spe
        if order is None:
            order = self.epoch_order(step // spe)
        slots = self._arange(self.pad_to)
        pos = i * self.batch_size + slots
        valid = (pos < self.n) & (slots < self.batch_size)
        sel = order[pos.clamp(0, max(self.n - 1, 0))]
        sel = torch.where(valid, sel, 0)
        return self._gather(sel, valid, step, 0)

    def _gather(self, sel, valid, step, row0):
        """(abs_idx, labels, mask) of the records ``sel``, the invalid
        ones masked and reading row 0; rows less ``row0``."""
        fields = self._fields[sel]
        offs, nf, labels = fields[:, 0], fields[:, 1], fields[:, 2]
        if self._det_frames is not None:
            frames = self._det_frames[sel]
        else:
            frames = self._expand_new_length(self._sample(nf, step), nf)
        abs_idx = offs[:, None] + frames - row0
        abs_idx = torch.where(valid[:, None], abs_idx, 0).to(torch.int32)
        return abs_idx.contiguous(), labels, valid.to(torch.float32)

    # ---- the random sampler: torch mirror of data/samplers.py ----
    def _sample(self, nf: torch.Tensor, step: int) -> torch.Tensor:
        """'random' mode (dataset.py:76-90): a random offset in each of S
        equal chunks, else S sorted random frames, else zeros."""
        s, l = self.num_segments, self.new_length
        b = nf.shape[0]
        avg = (nf - l + 1) // s
        seg = self._arange(s)
        cell = self._arange(b)[:, None] * s + seg[None, :]      # [B, S]
        case1 = seg[None, :] * avg[:, None] + _hash(
            _key(self.seed, _SALT_OFFSET, step), cell) % avg.clamp(
                min=1)[:, None]
        hi = (nf - l + 1).clamp(min=1)
        case2 = torch.sort(_hash(_key(self.seed, _SALT_SORTED, step), cell)
                           % hi[:, None], dim=1).values
        return torch.where((avg > 0)[:, None], case1,
                           torch.where((nf > s)[:, None], case2,
                                       torch.zeros_like(case1)))

    def _expand_new_length(self, starts: torch.Tensor,
                           nf: torch.Tensor) -> torch.Tensor:
        """[P, S] -> [P, S*new_length], clamped at the last frame
        (dataset.py:128-144)."""
        l = self.new_length
        if l == 1:
            return starts
        frames = starts[:, :, None] + self._arange(l)[None, None, :]
        frames = torch.minimum(frames, (nf - 1)[:, None, None])
        p, s, _ = frames.shape
        return frames.reshape(p, s * l)


class StreamingDeviceSampler(DeviceSampler):
    """Shard-local index batches on the device for the streamed stores
    (`data/streaming.py`), as ``TSNLoader.shard_index_epoch`` makes them:
    shard-local record groups in loader order, shard tails padded and
    masked, masked rows reading local row 0 with record 0's label; bitwise
    the host loader's in deterministic modes with shuffle off.  With
    shuffle on, the order within a shard is a stable argsort of hashed
    keys (the same window as the host's, another stream)."""

    def __init__(self, loader: TSNLoader, plan, seed: int = 0):
        super().__init__(loader, seed)
        sid_of_record = np.asarray(plan.shard_of(loader.video_idx))
        ns = plan.num_shards
        groups = [np.nonzero(sid_of_record == s)[0] for s in range(ns)]
        self.gmax = max(len(g) for g in groups)
        gp = np.zeros((ns, self.gmax), np.int64)
        counts = np.zeros(ns, np.int64)
        for s, g in enumerate(groups):
            gp[s, :len(g)] = g
            counts[s] = len(g)
        self.num_shards = ns
        self.groups = torch.as_tensor(gp)          # [NS, Gmax], valid first
        self.shard_counts_host = counts
        self.row_lo_host = np.asarray(plan.row_lo, np.int64)
        # shard-local rows: below the shards' padded size
        self.end = plan.budget_rows

    def shard_steps(self, sid: int) -> int:
        """Batches shard ``sid`` contributes per epoch (host int)."""
        return int(-(-int(self.shard_counts_host[sid]) // self.batch_size))

    def shard_order(self, sid: int, epoch: int) -> torch.Tensor:
        """The visit order of shard ``sid``'s slots in one epoch ([Gmax]
        int64 slot indices into groups[sid]; the empty slots last)."""
        if not self.shuffle:
            return self._arange(self.gmax)
        slots = self._arange(self.gmax)
        keys = _hash(_key(self.seed, _SALT_SHARD, epoch, sid), slots)
        keys = torch.where(slots < int(self.shard_counts_host[sid]), keys,
                           _M32 + 1)
        return torch.argsort(keys, stable=True)

    def shard_batch(self, sid: int, j: int, order: torch.Tensor,
                    step: int):
        """Shard-local batch j -> (abs_idx [P, T] int32 shard-local rows,
        labels [P], mask [P]); ``step`` keys the random-mode sampler."""
        count = int(self.shard_counts_host[sid])
        slots = self._arange(self.pad_to)
        pos = j * self.batch_size + slots
        valid = (pos < count) & (slots < self.batch_size)
        sel = self.groups[sid][order[pos.clamp(0, self.gmax - 1)]]
        sel = torch.where(valid, sel, 0)  # the host pads with record 0
        return self._gather(sel, valid, step, int(self.row_lo_host[sid]))
