"""Packed frame-feature store: the port's own copy of
`ta3n_tpu/data/feature_store.py::FeatureStore` (its on-disk format and host
gather), plus ``to_device``, which uploads the features once for the
device-store train and eval steps (`train/step.py`).

All frame features of a split live in ONE contiguous array plus an offsets
vector (reference: one ``.t7`` file per frame, dataset.py:53-66), so a
batch gather is one numpy fancy index, or one call of the native row
gather (`data/native_gather.py`) with the class switch
``use_native_gather`` on.

Layout on disk (directory), as the JAX package writes it:
    features.npy   [total_frames, D] (float32/float16) — memmap-able
    offsets.npy    [num_videos + 1] int64, frame row ranges per video
    meta.json      {"paths": [...], "labels": [...], "feature_dim": D,
                    "num_streams": 1|2}
Flow modality stores x/y stream features interleaved per frame:
    features.npy   [total_frames, 2, D]
Int8-quantized stores (``quantize()``, `data/quantized.py`) add
    scales.npy     [total_frames] float32, one scale per frame row
and ``"store_dtype": "int8"`` in meta.json; their host gathers dequantize.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np
import torch

from ta3n_tpu_torch.data.manifest import VideoRecord
from ta3n_tpu_torch.data.native_gather import native_gather
from ta3n_tpu_torch.data.quantized import quantize_rows

__all__ = ["FeatureStore"]


class FeatureStore:
    def __init__(self, features: np.ndarray, offsets: np.ndarray,
                 paths: Sequence[str], labels: Sequence[int],
                 scales: np.ndarray = None):
        if offsets.shape[0] != len(paths) + 1:
            raise ValueError(f"{offsets.shape[0]} offsets for "
                             f"{len(paths)} videos")
        self.features = features
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.paths = list(paths)
        self.labels = np.asarray(labels, dtype=np.int64)
        self.scales = scales  # [total_frames] f32 iff int8-quantized
        self._path_index = {p: i for i, p in enumerate(self.paths)}

    # ---- properties ----
    @property
    def num_videos(self) -> int:
        return len(self.paths)

    @property
    def feature_dim(self) -> int:
        return self.features.shape[-1]

    @property
    def num_streams(self) -> int:
        return self.features.shape[1] if self.features.ndim == 3 else 1

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    def quantize(self) -> "FeatureStore":
        """Int8-quantized copy (per-row symmetric, data/quantized.py):
        4x smaller rows; gathers dequantize transparently."""
        if self.quantized:
            return self
        q, s = quantize_rows(np.asarray(self.features))
        return FeatureStore(q, self.offsets, self.paths, self.labels,
                            scales=s)

    def num_frames(self, video_idx: np.ndarray) -> np.ndarray:
        video_idx = np.asarray(video_idx)
        return self.offsets[video_idx + 1] - self.offsets[video_idx]

    def records(self) -> List[VideoRecord]:
        nf = self.offsets[1:] - self.offsets[:-1]
        return [VideoRecord(p, int(n), int(l))
                for p, n, l in zip(self.paths, nf, self.labels)]

    def index_of(self, path: str) -> int:
        return self._path_index[path]

    # ---- gather ----
    # class switch, the JAX package's name: the native row gather
    # (`data/native_gather.py`, built by the host compiler at first use)
    # when on, numpy's fancy index, its plain version, when off.  Off by
    # default: on the card's host the library is slower at the train
    # batches (PERF.md §6)
    use_native_gather = False

    def gather(self, video_idx: np.ndarray, frame_idx: np.ndarray,
               dtype=np.float32) -> np.ndarray:
        """Gather [B, T(, streams), D] features on the host.

        video_idx: [B]; frame_idx: [B, T] 0-based within-video indices.
        Flow stores return [B, T*streams, D] with x/y interleaved per frame
        (parity with dataset.py:62-66 extending [x, y] per step).
        The rows come through numpy's fancy index, or through the native
        gather (bounds-checked: an index outside its video raises
        ``IndexError``) while ``use_native_gather`` is on.  A
        quantized store's rows are dequantized in the order of
        ``dequantize_rows`` (cast, then multiply), as the JAX package's.
        """
        video_idx = np.asarray(video_idx)
        frame_idx = np.asarray(frame_idx)
        abs_idx = self.offsets[video_idx][:, None] + frame_idx
        if self.use_native_gather:
            rows = native_gather(self.features, self.offsets, video_idx,
                                 frame_idx)
        else:
            rows = self.features[abs_idx]
        if self.quantized:
            s = np.asarray(self.scales[abs_idx], np.float32)
            rows = rows.astype(np.float32) * s.reshape(
                s.shape + (1,) * (rows.ndim - 2))
        out = np.asarray(rows, dtype=dtype)
        if out.ndim == 4:  # [B, T, streams, D] -> [B, T*streams, D]
            b, t, s, d = out.shape
            out = out.reshape(b, t * s, d)
        return out

    def to_device(self, device="cuda", dtype=None):
        """The features on ``device``, uploaded once, for the device-store
        steps: a contiguous tensor [total_frames, D] or [total_frames,
        streams, D], or an int8 store's pair ``(q, scale)`` (q int8 of that
        shape, scale float32 [total_frames]).

        ``dtype`` (a name or a torch dtype, the Trainer's ``store_dtype``):
        None or float32 gives float32 (a float16 store's rows upcast
        exactly, as the JAX model casts them); bfloat16 rounds to bfloat16
        on the host (round to nearest even, as numpy's ``astype``); int8
        quantizes per row on the host (``quantize_rows``).  A store that
        is quantized on disk uploads its own pair whatever ``dtype`` says,
        as the JAX Trainer does."""
        rows = host_rows(self.features, dtype, self.scales)
        if isinstance(rows, tuple):
            return tuple(t.to(device) for t in rows)
        return rows.to(device).contiguous()

    # ---- persistence ----
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "features.npy"), self.features)
        np.save(os.path.join(directory, "offsets.npy"), self.offsets)
        if self.quantized:
            np.save(os.path.join(directory, "scales.npy"), self.scales)
        meta = {
            "paths": self.paths,
            "labels": self.labels.tolist(),
            "feature_dim": int(self.feature_dim),
            "num_streams": int(self.num_streams),
        }
        if self.quantized:
            meta["store_dtype"] = "int8"
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, mmap: bool = True) -> "FeatureStore":
        features = np.load(os.path.join(directory, "features.npy"),
                           mmap_mode="r" if mmap else None)
        offsets = np.load(os.path.join(directory, "offsets.npy"))
        scales_path = os.path.join(directory, "scales.npy")
        scales = (np.load(scales_path) if os.path.exists(scales_path)
                  else None)
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        return cls(features, offsets, meta["paths"], meta["labels"],
                   scales=scales)

    # ---- construction ----
    @classmethod
    def from_arrays(cls, per_video_features: Sequence[np.ndarray],
                    paths: Sequence[str], labels: Sequence[int]
                    ) -> "FeatureStore":
        counts = [f.shape[0] for f in per_video_features]
        offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(counts)
        features = np.concatenate(per_video_features, axis=0)
        return cls(features, offsets, paths, labels)

    def subset(self, indices: Sequence[int]) -> "FeatureStore":
        feats = [self.features[self.offsets[i]:self.offsets[i + 1]]
                 for i in indices]
        sub = FeatureStore.from_arrays(
            feats, [self.paths[i] for i in indices],
            [int(self.labels[i]) for i in indices])
        if self.quantized:
            sub.scales = np.concatenate(
                [self.scales[self.offsets[i]:self.offsets[i + 1]]
                 for i in indices])
        return sub


def host_rows(features: np.ndarray, dtype=None, scales=None):
    """Feature rows as the CPU tensor(s) that go to the card: float32
    (float16 rows upcast exactly), bfloat16 (rounded to nearest even, as
    numpy's ``astype``), or an int8 ``(q, scale)`` pair, quantized here per
    row unless ``scales`` says the rows are quantized already, whatever
    ``dtype`` asks for (`FeatureStore.to_device`).  Every conversion is
    per row, so a slice of the rows converts to the slice of the
    converted rows: a streamed shard (`data/streaming.py`) holds exactly
    the bytes of the resident store."""
    name = _dtype_name(dtype)
    if scales is not None or name == "int8":
        q, scale = ((features, scales) if scales is not None
                    else quantize_rows(np.asarray(features)))
        return (torch.tensor(np.asarray(q), dtype=torch.int8),
                torch.tensor(np.asarray(scale), dtype=torch.float32))
    rows = torch.tensor(np.asarray(features), dtype=torch.float32)
    return rows.to(torch.bfloat16) if name == "bfloat16" else rows


def _dtype_name(dtype) -> str:
    """A store dtype as its name: None and float32 as "float32"; raise on
    what the device-store steps do not take."""
    if dtype in (None, "", "float32", torch.float32):
        return "float32"
    name = {torch.bfloat16: "bfloat16", torch.int8: "int8"}.get(dtype, dtype)
    if name not in ("bfloat16", "int8"):
        raise ValueError(f"store dtype {dtype!r}: the device-store steps take "
                         "float32, bfloat16 or int8 stores")
    return name
