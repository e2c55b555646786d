"""Static temporal-relation index sets for the multi-scale TRN aggregator.

The multi-scale TRN enumerates k-frame subsets of the S segments for
k = S, S-1, ..., 2 and, per forward pass, sums a fixed, deterministic,
evenly-spaced selection of at most 3 subsets per scale (the largest scale
uses only the single full subset).  Behavioural parity with the reference
(`TRNmodule.py:27-86`), including its exact quirks:

  * scales are ``[S, S-1, ..., 2]`` (``TRNmodule.py:34``),
  * subsets per scale are ``itertools.combinations(range(S), k)`` in
    lexicographic order (``TRNmodule.py:84-86``); the selected ones are
    unranked from their index in that order, never listed, so a plan costs
    O(S^2) at any S (the listing grows as 2^S: about 0.3 s and 160 MB at
    S=20),
  * the largest scale contributes only ``relations[0][0]`` — the single
    C(S,S)=1 full combination (``TRNmodule.py:60-64``),
  * every other scale sums ``min(3, C(S,k))`` subsets at indices
    ``ceil(i * N / n_sel)`` for i in range(n_sel) (``TRNmodule.py:66-79``).

Everything here is computed once, on the host; the TRN's kernels read the
plan as a table on the device (`ops/trn_fused.py::_plan_table`).
"""

from __future__ import annotations

from functools import lru_cache
from math import ceil, comb
from typing import List, Tuple

import numpy as np

__all__ = [
    "relation_scales",
    "combination_at",
    "even_subsample_indices",
    "selected_relation_indices",
    "RelationPlan",
    "build_relation_plan",
]


def relation_scales(num_frames: int) -> List[int]:
    """Scales [S, S-1, ..., 2] (reference TRNmodule.py:34)."""
    return list(range(num_frames, 1, -1))


def combination_at(num_frames: int, k: int, index: int) -> Tuple[int, ...]:
    """The ``index``-th k-frame combination in lexicographic order, as
    ``list(itertools.combinations(range(num_frames), k))[index]``, without
    listing the others."""
    if not 0 <= index < comb(num_frames, k):
        raise IndexError(f"combination {index} of C({num_frames}, {k})")
    out, first = [], 0
    for slot in range(k, 0, -1):
        # skip the combinations whose next frame is `first`
        while comb(num_frames - first - 1, slot - 1) <= index:
            index -= comb(num_frames - first - 1, slot - 1)
            first += 1
        out.append(first)
        first += 1
    return tuple(out)


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
        total = comb(num_frames, k)
        n_sel = 1 if scale_id == 0 else min(subsample_num, total)
        out.append([combination_at(num_frames, k, i)
                    for i in even_subsample_indices(total, n_sel)])
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
