"""The benchmark's manifest and files: names and units, every cell's
files found by name, files added without an edit, and what the harness
and the reference load."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import manifest

ROOT = manifest.ROOT
HERE = manifest.HERE
NAME = manifest.NAME
UNIT = manifest.UNIT
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _manifest():
    return manifest.load_manifest()


def test_top_level_keys_and_limits():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["paths"]) <= 16 and 1 <= len(m["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in m["command"]:
        assert LINE.match(word)


def test_names_units_and_entry_keys():
    m = _manifest()
    seen = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        assert metric["name"] not in seen
        seen.add(metric["name"])
    for metric in m["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "source", "layer", "moves"}
        assert metric["moves"] in e2e and LINE.match(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_every_cell_found_by_name():
    m = _manifest()
    for w in m["workloads"]:
        cell = manifest.resolve(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert (ROOT / cell["config"]["file"]).is_file()
        assert cell["config"]["file"].startswith("bench_port/")
        assert cell["model"]["reduced"] == cell["config"]["reduced"]
        assert hasattr(manifest.driver(cell["traffic"]["driver"]), "run")
        assert hasattr(manifest.reference(cell["model"]["reference"]),
                       "run_block")
        for metric in cell["per_layer"]:
            assert callable(manifest.metric_reader(metric["name"]).read)
        e2e = {x["name"] for x in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for metric in cell["per_layer"]:
            assert metric["moves"] in e2e


def test_files_added_need_no_edit(tmp_path):
    """A new configuration, traffic mix, cell and metric: files and
    manifest entries only."""
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = _manifest()
    here = tmp_path / HERE.name
    cfg = json.loads((HERE / "configs" / "ucf_hmdb_full.json").read_text())
    cfg["name"] = "ucf_hmdb_full_s8"
    (here / "configs" / "ucf_hmdb_full_s8.json").write_text(json.dumps(cfg))
    traffic = json.loads((HERE / "traffic" / "sweep.json").read_text())
    traffic["members"] = 16
    (here / "traffic" / "sweep16.json").write_text(json.dumps(traffic))
    (here / "cells" / "ucf_hmdb_full_s8.sweep16.json").write_text(
        json.dumps({"members": 24, "limits": {"loss": 1.0}}))
    (here / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    m["configs"].append({"name": "ucf_hmdb_full_s8", "source": "x",
                         "file": "bench_port/configs/ucf_hmdb_full_s8.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "ucf_hmdb_full_s8.sweep16",
                           "config": "ucf_hmdb_full_s8",
                           "traffic": "sweep16", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "new_metric", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernels", "moves": "setup_s",
                           "workloads": ["ucf_hmdb_full_s8.sweep16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    before = {p: p.read_bytes() for p in HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    cell = manifest.resolve("ucf_hmdb_full_s8.sweep16", tmp_path)
    assert cell["traffic"]["members"] == 24
    assert cell["limits"] == {"loss": 1.0}
    assert "new_metric" in [x["name"] for x in cell["per_layer"]]
    assert manifest.metric_reader("new_metric", tmp_path).read(None) == 42.0
    old = manifest.resolve("ucf_hmdb_full.sweep", tmp_path)
    assert "new_metric" not in [x["name"] for x in old["per_layer"]]
    for p in (here / "configs" / "ucf_hmdb_full.json",
              here / "traffic" / "sweep.json"):
        assert p.read_bytes() == (HERE / p.relative_to(here)).read_bytes()
    assert before == {p: p.read_bytes() for p in HERE.rglob("*")
                      if p.is_file() and "__pycache__" not in p.parts}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        assert not _imports(path) & {"ta3n_tpu_torch", "ta3n_tpu", "jax",
                                     "flax", "jaxlib"}, path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import manifest\n"
            "manifest.reference('ta3n')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ta3n_tpu_torch', 'ta3n_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_no_jax_in_what_a_run_loads():
    """A run of a small cell on the CPU, the port's modules and all,
    loads no module whose top-level name is jax, jaxlib, flax or
    ta3n_tpu (compared whole: ta3n_tpu_torch is the port)."""
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & {"ta3n_tpu", "jax", "flax", "jaxlib"}
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from bench_port import manifest\n"
        "from bench_port.tests.small import small_cell\n"
        "cell = small_cell('tempooling_revgrad', 8)\n"
        "for m in cell['per_layer']: manifest.metric_reader(m['name'])\n"
        "manifest.driver('sweep').run(cell, 5, 0.2, False, 'cpu', "
        "time.time(), print)\n"
        "sys.argv = ['run.py']\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', %r)\n"
        "r = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(r)\n"
        "print('FOUND', r.forbidden_modules())\n"
        % (str(ROOT), str(HERE / "run.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_forbidden_names_compared_whole():
    spec_code = (
        "import sys, types; sys.path.insert(0, %r)\n"
        "sys.modules['ta3n_tpu_torch_x'] = types.ModuleType('x')\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', %r)\n"
        "r = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(r)\n"
        "a = r.forbidden_modules()\n"
        "sys.modules['ta3n_tpu.models'] = types.ModuleType('y')\n"
        "print(a, r.forbidden_modules())\n"
        % (str(ROOT), str(HERE / "run.py")))
    out = subprocess.run([sys.executable, "-c", spec_code],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[] ['ta3n_tpu']"


def test_run_without_a_card_prints_no_result():
    """Decided inside the test: on a machine with a card this is the
    card's run, not this check."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "ucf_hmdb_full.sweep", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
