"""Checkpoint save and resume in the reference's own format.

The counterpart of `ta3n_tpu/io_utils/checkpoint.py`, whose orbax
directories the port cannot read, with the reference's files instead
(main.py:91-106,266-274,764-770): every eval epoch writes
``checkpoint.pth.tar`` and, on a new best, copies it to
``model_best.pth.tar``.  The payload is the reference's
{epoch, arch, state_dict, optimizer, best_prec1, prec1} (SURVEY §2.5),
``state_dict`` with the DataParallel ``module.`` prefix and only the live
parameters, plus ``lr_current`` and ``step``, which the JAX Trainer keeps
for resume (`ta3n_tpu/train/loop.py:458-469`).

So a checkpoint of the port's Trainer is read as it is by the port's eval
CLI and ``Predictor.from_checkpoint`` (`io_utils/convert.py`), and by the
JAX package's eval CLI (`ta3n_tpu/io_utils/torch_import.py`).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CKPT_NAME", "BEST_NAME"]

CKPT_NAME = "checkpoint.pth.tar"
BEST_NAME = "model_best.pth.tar"


def save_checkpoint(path_exp: str, payload: Dict[str, Any],
                    is_best: bool = False) -> str:
    """Write ``payload`` to ``path_exp/checkpoint.pth.tar`` (through a
    temporary file, so an interrupted save leaves the last one whole) and
    copy it to ``model_best.pth.tar`` when ``is_best``.  Returns the
    checkpoint's path."""
    os.makedirs(path_exp, exist_ok=True)
    path = os.path.join(path_exp, CKPT_NAME)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(path_exp, BEST_NAME))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a ``.pth.tar`` that save_checkpoint wrote, its
    tensors on the CPU."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port's checkpoints are .pth.tar "
            f"files ({CKPT_NAME}, {BEST_NAME})")
    return torch.load(path, map_location="cpu", weights_only=True)
