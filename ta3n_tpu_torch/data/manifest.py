"""Class lists: the port's own copy of
`ta3n_tpu/data/manifest.py::load_class_names`."""

from __future__ import annotations

from typing import List

__all__ = ["load_class_names"]


def load_class_names(class_file: str) -> List[str]:
    """Parse an ``id name`` class list (main.py:56-57)."""
    with open(class_file) as f:
        return [line.strip().split(" ", 1)[1] for line in f if line.strip()]
