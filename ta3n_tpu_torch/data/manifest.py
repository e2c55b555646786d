"""Video records and class lists: the port's own copies of
`ta3n_tpu/data/manifest.py`'s ``VideoRecord``, ``repeat_to``,
``epoch_balance_counts`` and ``load_class_names``."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

__all__ = ["VideoRecord", "repeat_to", "epoch_balance_counts",
           "load_class_names"]


@dataclasses.dataclass(frozen=True)
class VideoRecord:
    path: str
    num_frames: int
    label: int


def repeat_to(records: Sequence[VideoRecord], num_dataload: int
              ) -> List[VideoRecord]:
    """Repeat the list so its length equals ``num_dataload``.

    Parity: dataset.py:69-74 — ``list * (n // len) + list[: n % len]``.
    """
    n = len(records)
    n_repeat = num_dataload // n
    n_left = num_dataload % n
    return list(records) * n_repeat + list(records)[:n_left]


def epoch_balance_counts(num_source: int, num_target: int,
                         batch_source: int, batch_target: int,
                         copy_list: Sequence[str]) -> tuple:
    """How many videos each stream loads per epoch so iteration counts match.

    Parity: main.py:144-153 — ``num_max_iter = max(ns/bs, nt/bt)``; a stream
    with copy_list[i]=='Y' is repeated to ``round(num_max_iter * b)``.
    """
    num_iter_source = num_source / batch_source
    num_iter_target = num_target / batch_target
    num_max_iter = max(num_iter_source, num_iter_target)
    n_src = round(num_max_iter * batch_source) if copy_list[0] == "Y" \
        else num_source
    n_tgt = round(num_max_iter * batch_target) if copy_list[1] == "Y" \
        else num_target
    return n_src, n_tgt


def load_class_names(class_file: str) -> List[str]:
    """Parse an ``id name`` class list (main.py:56-57)."""
    with open(class_file) as f:
        return [line.strip().split(" ", 1)[1] for line in f if line.strip()]
