"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its
traffic mix; their files are ``configs/<config>.json`` (the entry's
``file``) and ``traffic/<traffic>.json``.  A file ``cells/<workload>.json``,
where it exists, holds what belongs to the cell alone: traffic settings
of its own, such as its member count, which add to or override the
traffic file's, and the limits of its correctness check.  Each per-layer metric is read by ``metrics/<name>.py``.  Adding a
cell, a configuration, a traffic mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """The Python file ``path`` as a module (names may hold dots)."""
    name = f"bench_port_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, by name: its entry, its configuration
    (entry and file), its traffic (with the cell's own overrides), its
    end-to-end and per-layer metrics."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    model = _read_json(root / config["file"])
    here = root / HERE.name
    traffic = _read_json(here / "traffic" / f"{cell['traffic']}.json")
    override_path = here / "cells" / f"{workload}.json"
    override = _read_json(override_path) if override_path.exists() else {}
    limits = override.pop("limits", {})
    traffic = {**traffic, **override}
    return {
        "workload": cell, "config": config, "model": model,
        "traffic": traffic, "limits": limits,
        "end_to_end": [m for m in manifest["end_to_end"]
                       if applies(m, workload)],
        "per_layer": [m for m in manifest["per_layer"]
                      if applies(m, workload)],
        "run_seconds": manifest["run_seconds"],
    }


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / HERE.name / "metrics" / f"{name}.py",
                       "metric")


def driver(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / HERE.name / "drivers" / f"{name}.py",
                       "driver")


def reference(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / HERE.name / "reference" / f"{name}.py",
                       "reference")
