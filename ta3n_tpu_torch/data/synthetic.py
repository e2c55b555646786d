"""Synthetic two-domain feature data for tests and the smoke test: the
port's own copy of `ta3n_tpu/data/synthetic.py`'s ``make_synthetic_store``
and ``make_domain_pair``.

Class-conditional Gaussian frame features with a controllable domain
shift; the same seed gives the same arrays as the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ta3n_tpu_torch.data.feature_store import FeatureStore

__all__ = ["make_synthetic_store", "make_domain_pair"]


def make_synthetic_store(num_videos: int, num_class: int, feature_dim: int,
                         min_frames: int = 8, max_frames: int = 40,
                         shift: float = 0.0, seed: int = 0,
                         prefix: str = "vid") -> FeatureStore:
    rng = np.random.default_rng(seed)
    # class centroids shared across domains; `shift` moves the whole domain
    centroids = np.random.default_rng(12345).normal(
        0.0, 1.0, size=(num_class, feature_dim))
    shift_vec = np.random.default_rng(54321).normal(
        0.0, 1.0, size=(feature_dim,)) * shift

    feats, paths, labels = [], [], []
    for i in range(num_videos):
        label = int(rng.integers(0, num_class))
        n = int(rng.integers(min_frames, max_frames + 1))
        base = centroids[label] + shift_vec
        f = base[None, :] + rng.normal(0.0, 1.0, size=(n, feature_dim))
        feats.append(f.astype(np.float32))
        paths.append(f"{prefix}_{i:05d}")
        labels.append(label)
    return FeatureStore.from_arrays(feats, paths, labels)


def make_domain_pair(num_source: int = 64, num_target: int = 48,
                     num_val: int = 32, num_class: int = 4,
                     feature_dim: int = 64, shift: float = 1.5,
                     seed: int = 0
                     ) -> Tuple[FeatureStore, FeatureStore, FeatureStore]:
    src = make_synthetic_store(num_source, num_class, feature_dim,
                               shift=0.0, seed=seed, prefix="src")
    tgt = make_synthetic_store(num_target, num_class, feature_dim,
                               shift=shift, seed=seed + 1, prefix="tgt")
    val = make_synthetic_store(num_val, num_class, feature_dim,
                               shift=shift, seed=seed + 2, prefix="val")
    return src, tgt, val
