"""Static temporal-relation index sets for the multi-scale TRN aggregator.

The multi-scale TRN enumerates k-frame subsets of the S segments for
k = S, S-1, ..., 2 and, per forward pass, sums a fixed, deterministic,
evenly-spaced selection of at most 3 subsets per scale (the largest scale
uses only the single full subset).  Behavioural parity with the reference
(`TRNmodule.py:27-86`), including its exact quirks:

  * scales are ``[S, S-1, ..., 2]`` (``TRNmodule.py:34``),
  * subsets per scale are ``itertools.combinations(range(S), k)`` in
    lexicographic order (``TRNmodule.py:84-86``),
  * the largest scale contributes only ``relations[0][0]`` — the single
    C(S,S)=1 full combination (``TRNmodule.py:60-64``),
  * every other scale sums ``min(3, C(S,k))`` subsets at indices
    ``ceil(i * N / n_sel)`` for i in range(n_sel) (``TRNmodule.py:66-79``).

Everything here is computed once at Python level (static under jit); the
selected indices are baked into gather constants so XLA sees fixed shapes.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from math import ceil
from typing import List, Tuple

import numpy as np

__all__ = [
    "relation_scales",
    "relation_set",
    "even_subsample_indices",
    "selected_relation_indices",
    "RelationPlan",
    "build_relation_plan",
]


def relation_scales(num_frames: int) -> List[int]:
    """Scales [S, S-1, ..., 2] (reference TRNmodule.py:34)."""
    return list(range(num_frames, 1, -1))


@lru_cache(maxsize=None)
def relation_set(num_frames: int, k: int) -> Tuple[Tuple[int, ...], ...]:
    """All k-frame index combinations, lexicographic (TRNmodule.py:84-86)."""
    return tuple(itertools.combinations(range(num_frames), k))


def even_subsample_indices(num_total: int, num_select: int) -> List[int]:
    """Deterministic even subsampling: ceil(i*N/n) (TRNmodule.py:71)."""
    return [int(ceil(i * num_total / num_select)) for i in range(num_select)]


def selected_relation_indices(num_frames: int, subsample_num: int = 3
                              ) -> List[List[Tuple[int, ...]]]:
    """Per-scale list of the frame-index subsets actually used in a forward.

    Element 0 (largest scale) holds exactly one subset; subsequent scales
    hold min(subsample_num, C(S,k)) subsets.
    """
    out: List[List[Tuple[int, ...]]] = []
    for scale_id, k in enumerate(relation_scales(num_frames)):
        rels = relation_set(num_frames, k)
        if scale_id == 0:
            out.append([rels[0]])
        else:
            n_sel = min(subsample_num, len(rels))
            idxs = even_subsample_indices(len(rels), n_sel)
            out.append([rels[i] for i in idxs])
    return out


class RelationPlan:
    """Precomputed gather plan for the fused multi-scale TRN.

    Attributes:
      num_frames: S.
      scales: [S, S-1, ..., 2].
      subsets: per scale, int32 array [n_sel_k, k] of frame indices.
    """

    def __init__(self, num_frames: int, subsample_num: int = 3):
        self.num_frames = int(num_frames)
        self.subsample_num = int(subsample_num)
        self.scales = relation_scales(num_frames)
        sel = selected_relation_indices(num_frames, subsample_num)
        self.subsets: List[np.ndarray] = [
            np.asarray(s, dtype=np.int32) for s in sel
        ]

    @property
    def num_relation_features(self) -> int:
        """Output relation axis length: one summed feature per scale = S-1."""
        return len(self.scales)


@lru_cache(maxsize=None)
def build_relation_plan(num_frames: int, subsample_num: int = 3) -> RelationPlan:
    return RelationPlan(num_frames, subsample_num)
