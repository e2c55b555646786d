"""The comparison that decides ``correct`` for a training cell.

The program's readings of its first steps (taken in set-up, through the
window's own call, on its own feed) are held to the plain reference's,
worked out from the same inputs.  Four gaps, each the worst over a
member's steps, leaves or rows:

* ``loss``: |L_program - L_reference| / |L_reference| of each step's
  loss;
* ``first_grad``: the gap between the norms of the first gradient as the
  optimizer takes it (SGD's momentum buffer after one step: clipped, with
  weight decay) on the two sides, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``change``: the same for the parameters' change after the steps;
* ``val_logits``: |z_program - z_reference| of the validation logits
  after the steps, over the member's largest |z_reference|, real rows.

Leaves whose reference gradient is under a thousandth of the median
leaf's (those the loss does not reach) are left out of the two norm
gaps, by that rule and not by name.

Each gap is read twice over the members: its worst member (moved by a
fault in one member, but swung by the rare relu that rounding flips
between the two sides, in one member of many), and its median member
(steady from seed to seed, and moved by whatever moves every member:
another precision, a state left unchanged, half the batch left out).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

GAPS = ("loss", "first_grad", "change", "val_logits")
_TINY = 1e-3


def leaf_norms(t: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Each leaf's norm per member {name: [M]} (float64)."""
    return {k: torch.linalg.vector_norm(v.reshape(v.shape[0], -1).double(),
                                        dim=1).cpu().numpy()
            for k, v in t.items()}


def _norm_gap(prog: dict, ref: dict, raw: dict, names: list) -> np.ndarray:
    """Per member, the worst leaf's norm gap (see the module docstring);
    a leaf missing on the program's side reads norm 0."""
    m = len(next(iter(raw.values())))
    r_raw = np.stack([raw.get(k, np.zeros(m)) for k in names], 1)
    r = np.stack([ref.get(k, np.zeros(m)) for k in names], 1)
    p = np.stack([prog.get(k, np.zeros(m)) for k in names], 1)
    worst = np.zeros(m)
    for j in range(m):
        counted = r_raw[j] >= _TINY * np.median(r_raw[j][r_raw[j] > 0])
        if not counted.any():
            continue
        denom = np.maximum(r[j, counted], np.median(r[j, counted]))
        worst[j] = np.max(np.abs(p[j, counted] - r[j, counted]) / denom)
    return worst


def gaps(prog: dict, ref: dict, names: list, val_mask: np.ndarray) -> dict:
    """The four gaps of each member of one block [M].  ``prog`` and ``ref``
    hold losses [K, M], first and change {name: [M]} norms, val_logits
    [M, rows, C]; ``ref`` also raw {name: [M]}, the first step's raw
    gradient norms."""
    lp, lr = np.asarray(prog["losses"], np.float64), \
        np.asarray(ref["losses"], np.float64)
    real = np.asarray(val_mask) > 0
    zp = np.asarray(prog["val_logits"], np.float64)[:, real]
    zr = np.asarray(ref["val_logits"], np.float64)[:, real]
    scale = np.abs(zr).reshape(zr.shape[0], -1).max(1)
    return {
        "loss": np.max(np.abs(lp - lr) / np.abs(lr), axis=0),
        "first_grad": _norm_gap(prog["first"], ref["first"], ref["raw"],
                                names),
        "change": _norm_gap(prog["change"], ref["change"], ref["raw"],
                            names),
        "val_logits": (np.abs(zp - zr).reshape(zr.shape[0], -1).max(1)
                       / np.maximum(scale, 1e-30)),
    }


def readings(per_member: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Each gap's worst member, and its median member (``<gap>_median``),
    from every member's gaps; a NaN anywhere reads NaN."""
    out = {}
    for n, v in per_member.items():
        out[n] = float(np.max(v))
        out[f"{n}_median"] = float(np.median(v))
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over every number the driver
    read and every number the cell's file names: each finite and at most
    its limit.  A limit of null marks a number reported and not judged; a
    number the file does not name is uncalibrated, and one the driver did
    not read is missing: either way the run is not correct."""
    checks, ok = {}, True
    for name in list(readings) + [n for n in limits if n not in readings]:
        value = float(readings.get(name, float("nan")))
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if name not in limits or not np.isfinite(value) or (
                limit is not None and value > limit):
            ok = False
    return ok, checks
