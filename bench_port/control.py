#!/usr/bin/env python3
"""Readings of a training cell's correctness check on many seeds, for
setting its limits: the program's first steps, the control (the plain
reference computed at TF32 in the program's place), and the program with
a fault planted underneath, each against the reference.

    python3 bench_port/control.py --workload ucf_hmdb_full.sweep \
        --seeds 11 12 13 --what program control frozen_state

prints one JSON line a seed and reading.  Set-up is long, so every
reading of a call runs in one process; no window is timed.  The faults:

* ``frozen_state``: the member optimizer's step does nothing, so the
  step returns its state unchanged;
* ``half_batch``: the second half of every batch's rows is masked out,
  so the losses are the means over the rest;
* ``altered_answer``: one validation logit is raised by 1 where the eval
  step produces it;

and three faults confined to some members, which leave the median member
as it was:

* ``one_member_frozen``: the member optimizer leaves member 0 (the
  smallest learning rate) and its momentum as they were;
* ``one_lr_column``: the members of the smallest learning rate step at
  twice it, the next column's;
* ``one_seed_dropout``: the members of the last sweep seed draw their
  dropout masks from the first seed's generator.

(The exchange between cards does not exist on one card.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAULTS = ("frozen_state", "half_batch", "altered_answer",
          "one_member_frozen", "one_lr_column", "one_seed_dropout")


def _frozen(orig):
    def step(*args, **kwargs):
        return None
    return step


def _half_batch(orig):
    import numpy as np
    import torch

    def upload(a, dtype, device):
        a = np.array(a)
        if dtype == torch.float32 and a.ndim == 2:
            a[:, a.shape[1] // 2:] = 0.0
        return orig(a, dtype, device)
    return upload


def _altered(orig):
    import torch

    def metrics(*args, **kwargs):
        out, *rest = orig(*args, **kwargs)
        bump = torch.zeros(out.shape, dtype=out.dtype, device=out.device)
        bump[0, 0] = 1.0
        return (out + bump, *rest)
    return metrics


def _one_member_frozen(orig):
    import torch

    def step(params, grads, state, lrs, train_cfg, reached):
        kept = {n: p[0].clone() for n, p in params.items()}
        bufs = {n: b[0].clone()
                for n, b in state.get("momentum_buffer", {}).items()}
        orig(params, grads, state, lrs, train_cfg, reached)
        with torch.no_grad():
            for n, p in params.items():
                p[0].copy_(kept[n])
            for n, b in state.get("momentum_buffer", {}).items():
                if n in bufs:
                    b[0].copy_(bufs[n])
                else:
                    b[0].zero_()
    return step


def _one_lr_column(orig):
    def step(params, grads, state, lrs, train_cfg, reached):
        low = min(lrs)
        return orig(params, grads, state,
                    [2.0 * lr if lr == low else lr for lr in lrs],
                    train_cfg, reached)
    return step


def _one_seed_dropout(orig):
    def generators(seeds, device="cuda"):
        seeds = list(seeds)
        return orig([seeds[0] if s == seeds[-1] else s for s in seeds],
                    device)
    return generators


# each fault: the name it replaces in train/ensemble.py, and its maker
_PLANTS = {
    "frozen_state": ("member_optimizer_step", _frozen),
    "half_batch": ("upload", _half_batch),
    "altered_answer": ("_eval_metrics", _altered),
    "one_member_frozen": ("member_optimizer_step", _one_member_frozen),
    "one_lr_column": ("member_optimizer_step", _one_lr_column),
    "one_seed_dropout": ("ensemble_generators", _one_seed_dropout),
}


@contextlib.contextmanager
def planted(fault: str):
    """The port with ``fault`` planted in its training or eval step."""
    from ta3n_tpu_torch.train import ensemble
    name, make = _PLANTS[fault]
    orig = getattr(ensemble, name)
    setattr(ensemble, name, make(orig))
    try:
        yield
    finally:
        setattr(ensemble, name, orig)


def reading(cell: dict, seed: int, what: str, device) -> dict:
    """One reading of the numbers (and each gap's 90th percentile over
    the members): ``what`` is "program", "control" or a fault's name."""
    import numpy as np
    import torch
    from bench_port import manifest
    driver = manifest.driver(cell["traffic"]["driver"])
    reference = manifest.reference(cell["model"]["reference"])
    k = int(cell["traffic"]["check_steps"])
    t0 = time.perf_counter()
    if what == "control":
        names = [s.name for s in reference.param_specs(
            cell["model"]["model"])]
        worst, _, every = driver.compare(cell, seed, None, names, k, device,
                                         control=reference.tf32_matmul)
    else:
        with (planted(what) if what in FAULTS else contextlib.nullcontext()):
            sw = driver.Sweep(cell, seed, device)
            prog = driver._first_steps(sw, k)
            names = [n for n, _ in sw.state.model.named_parameters()]
            del sw
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        worst, _, every = driver.compare(cell, seed, prog, names, k, device)
    return {"seed": seed, "what": what, "readings": worst,
            "p90": {n: float(np.quantile(v, 0.9)) for n, v in every.items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["program"])
    args = p.parse_args(argv)
    import torch
    from bench_port import manifest
    cell = manifest.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for what in args.what:
            print(json.dumps(reading(cell, seed, what,
                                     torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
