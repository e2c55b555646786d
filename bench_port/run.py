#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 bench_port/run.py --workload ucf_hmdb_full.sweep --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell's driver (its traffic file's ``driver``) builds its inputs
from the seed on the card, warms up, times ``--seconds`` seconds, and
checks what the timed path produced against the plain reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit,
which also end standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, or if JAX or the JAX package was loaded, the run
exits with another code than 0 and prints no result.

Every cache of the program is kept in ``build/bench_port/`` inside the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import types
from pathlib import Path


def _process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux: from
    /proc; elsewhere this line's time)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = Path(__file__).resolve().parent.parent
_CACHE = ROOT / "build" / "bench_port"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ta3n_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, flax's or the
    JAX package's, compared whole (``ta3n_tpu_torch`` is not
    ``ta3n_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def result_line(cell: dict, result: dict, trace: bool, correct: bool,
                checks: dict, device: dict) -> dict:
    """The result's JSON object (see the module docstring)."""
    from bench_port import manifest
    if trace:
        ctx = types.SimpleNamespace(cell=cell, result=result,
                                    trace=result["trace"])
        metrics = {}
        for m in cell["per_layer"]:
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": result["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device}
    if trace:
        t = result["trace"]
        line["device"] = {**device, "busy_s": t["busy_s"],
                          "window_s": t["window_s"]}
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench_port import check, manifest
    cell = manifest.resolve(args.workload)
    chips = int(cell["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} visible: no result")
        return 3
    device = torch.device("cuda", 0)
    driver = manifest.driver(cell["traffic"]["driver"])
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        device, STARTED, log)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the port must not load: {found}")
        return 4
    correct, checks = check.verdict(result["readings"], cell["limits"])
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": result["memory_peak_bytes"]}
    line = result_line(cell, result, bool(args.trace), correct, checks, dev)
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — a failed run prints no result
        traceback.print_exc()
        sys.exit(1)
