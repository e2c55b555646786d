"""PyTorch port, imports: the port and its smoke test stand without jax,
and the smoke test refuses to run anywhere but on a CUDA card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "ta3n_tpu_torch"
JAX_STACK = ("jax", "flax", "optax", "orbax")

_BLOCKED_IMPORT = f"""
import importlib, pkgutil, sys
for m in {JAX_STACK!r}:
    sys.modules[m] = None  # any import of them raises ImportError
import ta3n_tpu_torch, ta3n_tpu_torch.serve, ta3n_tpu_torch.cli.serve
for info in pkgutil.walk_packages(ta3n_tpu_torch.__path__, "ta3n_tpu_torch."):
    importlib.import_module(info.name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {JAX_STACK!r}
                and sys.modules[m] is not None)
print("loaded:", loaded)
"""


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "loaded: []" in proc.stdout


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", re.MULTILINE)
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_port_ships_its_kernel_sources():
    from ta3n_tpu_torch.ops import _build
    assert all(src.is_file() and src.parent == PORT / "csrc"
               for src in _build.SOURCES)


def test_chip_smoke_fails_without_a_card():
    """No CUDA device visible: non-zero exit and no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_program(tmp_path):
    """chip_smoke.py alone in a directory: non-zero exit, no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "No module named 'ta3n_tpu_torch'" in proc.stderr
    assert '"ok"' not in proc.stdout
