"""PyTorch port, imports: the port and its smoke test stand without jax
and without the JAX package, the port's own copies of the JAX package's
configuration do not drift from it, and the smoke test refuses to run
anywhere but on a CUDA card."""

import dataclasses
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "ta3n_tpu_torch"
JAX_STACK = ("jax", "flax", "optax", "orbax")
# and the JAX package itself (the top-level name exactly: ta3n_tpu_torch
# stays importable)
BLOCKED = (*JAX_STACK, "ta3n_tpu")

_BLOCKED_IMPORT = f"""
import importlib, pkgutil, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None  # any import of them raises ImportError
import ta3n_tpu_torch, ta3n_tpu_torch.serve, ta3n_tpu_torch.cli.serve
for info in pkgutil.walk_packages(ta3n_tpu_torch.__path__, "ta3n_tpu_torch."):
    importlib.import_module(info.name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
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


# the ensemble and sweep slice's modules, which the walk above must reach
_ENSEMBLE_MODULES = ("ta3n_tpu_torch.train.ensemble",
                     "ta3n_tpu_torch.train.sweep", "ta3n_tpu_torch.cli.sweep")


@pytest.mark.parametrize("module", _ENSEMBLE_MODULES)
def test_ensemble_modules_import_with_jax_blocked(module):
    """Each module of the ensembles and sweeps imports with the JAX stack
    and the JAX package blocked, and names its public entry points."""
    code = (f"import sys\nfor m in {BLOCKED!r}:\n    sys.modules[m] = None\n"
            f"import importlib\nmod = importlib.import_module({module!r})\n"
            "print(sorted(getattr(mod, '__all__', ['main'])))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = {"ta3n_tpu_torch.train.ensemble": "make_ensemble_step",
             "ta3n_tpu_torch.train.sweep": "run_sweep",
             "ta3n_tpu_torch.cli.sweep": "main"}[module]
    assert names in proc.stdout


# the modules of the last single-card slice: the tensorboard writer, the
# native gather's binding and the data-preparation entry points
_TOOL_MODULES = ("ta3n_tpu_torch.io_utils.tensorboard",
                 "ta3n_tpu_torch.data.native_gather",
                 "ta3n_tpu_torch.cli.convert_features",
                 "ta3n_tpu_torch.prep.dataset2split",
                 "ta3n_tpu_torch.prep.video_dataset2list",
                 "ta3n_tpu_torch.prep.list2da",
                 "ta3n_tpu_torch.prep.video_processing",
                 "ta3n_tpu_torch.__main__", "ta3n_tpu_torch.version")


@pytest.fixture(scope="module")
def tool_imports():
    """Each of _TOOL_MODULES imported in one process with the JAX stack
    and the JAX package blocked: module -> its public names, or the
    error."""
    code = (f"import importlib, json, sys\nfor m in {BLOCKED!r}:\n"
            "    sys.modules[m] = None\nout = {}\n"
            f"for module in {_TOOL_MODULES!r}:\n"
            "    try:\n"
            "        mod = importlib.import_module(module)\n"
            "        out[module] = sorted(getattr(mod, '__all__', vars(mod)))\n"
            "    except Exception as e:\n"
            "        out[module] = repr(e)\n"
            "print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", _TOOL_MODULES)
def test_tool_modules_import_with_jax_blocked(tool_imports, module):
    names = {"ta3n_tpu_torch.io_utils.tensorboard": "EmbeddingWriter",
             "ta3n_tpu_torch.data.native_gather": "native_gather",
             "ta3n_tpu_torch.__main__": "ENTRY_POINTS",
             "ta3n_tpu_torch.version": "__version__"}.get(module, "main")
    assert isinstance(tool_imports[module], list), tool_imports[module]
    assert names in tool_imports[module]


@pytest.mark.parametrize("port_module,jax_module", [
    ("ta3n_tpu_torch.data.native_gather", "ta3n_tpu.data.native_gather"),
    ("ta3n_tpu_torch.io_utils.tensorboard", "ta3n_tpu.io_utils.tensorboard"),
])
def test_copies_have_jax_names_and_signatures(port_module, jax_module):
    """The public names of the native gather's binding and of the
    tensorboard writer, and the parameters of their functions and
    methods, are the JAX modules' (the gather raises where the JAX one
    returns None, so return annotations differ; the writer takes tensors
    too, so its bodies differ)."""
    import importlib
    import inspect

    ours, ref = (importlib.import_module(m) for m in (port_module,
                                                      jax_module))

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert ours.__all__ == ref.__all__
    for name in ours.__all__:
        a, b = getattr(ours, name), getattr(ref, name)
        if not inspect.isclass(a):
            assert params(a) == params(b), name
            continue
        public = sorted(m for m in vars(b) if not m.startswith("_")
                        or m == "__init__")
        assert public == sorted(m for m in vars(a) if not m.startswith("_")
                                or m == "__init__")
        for m in public:
            if callable(vars(b)[m]):
                assert params(getattr(a, m)) == params(getattr(b, m)), m


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|ta3n_tpu\b(?!_torch))\b",
        re.MULTILINE)
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_source_pattern_tells_the_packages_apart():
    pattern = re.compile(r"^\s*(import|from)\s+ta3n_tpu\b(?!_torch)")
    assert pattern.match("from ta3n_tpu.config import ModelConfig")
    assert pattern.match("import ta3n_tpu")
    assert not pattern.match("from ta3n_tpu_torch.config import ModelConfig")


@pytest.mark.parametrize("name", ["ModelConfig", "DAConfig", "TrainConfig"])
def test_config_copies_match_jax_package(name):
    """The port's copies have the JAX package's fields, in order, with the
    same types and defaults, the same derived properties, and the same
    backbone table."""
    import ta3n_tpu.config as jax_config
    import ta3n_tpu_torch.config as port_config

    ours, ref = getattr(port_config, name), getattr(jax_config, name)

    def fields(cls):
        return [(f.name, f.type, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]

    assert fields(ours) == fields(ref)
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen
    props = sorted(k for k, v in vars(ref).items() if isinstance(v, property))
    assert props == sorted(k for k, v in vars(ours).items()
                           if isinstance(v, property))
    if name == "ModelConfig":
        assert port_config.BACKBONE_FEATURE_DIM == \
            jax_config.BACKBONE_FEATURE_DIM
        for kw in (dict(num_class=3), dict(num_class=3, fc_dim=4096),
                   dict(num_class=3, frame_aggregation="trn-m",
                        base_model="resnet18"),
                   dict(num_class=3, frame_aggregation="none",
                        modality="RGBDiff")):
            a, b = ours(**kw), ref(**kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            for prop in props:
                assert getattr(a, prop) == getattr(b, prop), prop
        for bad in (dict(quantize="fp8"), dict(add_fc=0),
                    dict(baseline_type="x"), dict(use_attn="DotProduct")):
            with pytest.raises(ValueError):
                ref(num_class=3, **bad)
            with pytest.raises(ValueError):
                ours(num_class=3, **bad)


@pytest.mark.parametrize("module", ["manifest", "samplers", "feature_store",
                                    "loader", "synthetic", "quantized",
                                    "streaming", "device_sampler"])
def test_data_copies_match_jax_package(module):
    """The port's copies of the JAX package's data modules: every public
    name they share has the same signature and defaults (functions and
    the methods of classes), the same fields (named tuples, dataclasses)
    or the same value (constants); test_torch_port_data.py,
    test_torch_port_quantized.py, test_torch_port_streaming.py and
    test_torch_port_device_sampler.py hold their behaviour.  The device
    sampler's methods take host ints and torch tensors where the JAX
    one's take traced arrays: their parameters and defaults are compared
    without the annotations."""
    import importlib
    import inspect

    ours = importlib.import_module(f"ta3n_tpu_torch.data.{module}")
    ref = importlib.import_module(f"ta3n_tpu.data.{module}")

    def signature(fn):
        sig = inspect.signature(fn)
        if module != "device_sampler":
            return sig
        return [(p.name, p.kind, p.default)
                for p in sig.parameters.values()]

    assert set(ours.__all__) <= set(ref.__all__) | {"IndexBatch"}
    for name in ours.__all__:
        a, b = getattr(ours, name), getattr(ref, name)
        if not callable(a):  # a constant (quantized.QINT8_MAX)
            assert a == b, name
            continue
        if not inspect.isclass(a):
            assert signature(a) == signature(b), name
            continue
        if dataclasses.is_dataclass(a):
            assert [(f.name, f.type) for f in dataclasses.fields(a)] == \
                [(f.name, f.type) for f in dataclasses.fields(b)]
        assert getattr(a, "_fields", None) == getattr(b, "_fields", None)
        shared = [m for m in vars(a) if m in vars(b)
                  and (m == "__init__" or not m.startswith("_"))
                  and callable(getattr(a, m))]
        for m in shared:
            assert signature(getattr(a, m)) == \
                signature(getattr(b, m)), f"{name}.{m}"


def test_manifest_copy_matches_jax_package(tmp_path):
    from ta3n_tpu.data.manifest import load_class_names as jax_load
    from ta3n_tpu_torch.data.manifest import load_class_names

    path = tmp_path / "class.txt"
    path.write_text("0 brush hair\n1 cartwheel\n\n2 catch\n")
    assert load_class_names(str(path)) == jax_load(str(path)) == \
        ["brush hair", "cartwheel", "catch"]


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


@pytest.mark.parametrize("port_module,jax_module,names", [
    ("ta3n_tpu_torch.io_utils.confusion", "ta3n_tpu.io_utils.confusion",
     ["confusion_matrix", "per_class_topk_accuracy",
      "plot_confusion_matrix"]),
    ("ta3n_tpu_torch.io_utils.logs", "ta3n_tpu.io_utils.logs",
     ["AverageMeter", "LogFiles"]),
    ("ta3n_tpu_torch.train.schedules", "ta3n_tpu.train.schedules",
     ["alpha_schedule", "progress", "dann_beta", "effective_beta",
      "dann_lr", "step_decay_lr", "loss_plateau_lr"]),
    ("ta3n_tpu_torch.data.manifest", "ta3n_tpu.data.manifest",
     ["parse_list_file"]),
    ("ta3n_tpu_torch.data.streaming", "ta3n_tpu.data.streaming",
     ["ShardPlan"]),
    ("ta3n_tpu_torch.data.device_sampler", "ta3n_tpu.data.device_sampler",
     ["plan_zip_shard_chunks"]),
    ("ta3n_tpu_torch.cli.opts", "ta3n_tpu.cli.opts", ["configs_from_args"]),
    ("ta3n_tpu_torch.cli.convert_features", "ta3n_tpu.cli.convert_features",
     ["load_t7", "convert", "main"]),
    ("ta3n_tpu_torch.prep.dataset2split", "ta3n_tpu.prep.dataset2split",
     ["split_class", "main"]),
    ("ta3n_tpu_torch.prep.video_dataset2list",
     "ta3n_tpu.prep.video_dataset2list",
     ["load_class_map", "count_frames", "build_list", "main"]),
    ("ta3n_tpu_torch.prep.list2da", "ta3n_tpu.prep.list2da",
     ["load_id_to_name", "class_from_filename", "convert", "main"]),
    ("ta3n_tpu_torch.prep.video_processing", "ta3n_tpu.prep.video_processing",
     ["count_frames", "overlay_text", "main"]),
])
def test_copied_code_matches_jax_package(port_module, jax_module, names):
    """The port's copies of JAX modules that import no jax: each copied
    function and class has the original's source, line for line."""
    import importlib
    import inspect

    ours, ref = (importlib.import_module(m) for m in (port_module,
                                                      jax_module))
    assert set(names) <= set(ours.__all__) | {"configs_from_args"}
    for name in names:
        assert inspect.getsource(getattr(ours, name)) == \
            inspect.getsource(getattr(ref, name)), name


def _actions(parser, skip=()):
    return [(a.option_strings, a.dest, a.default, a.type, a.choices,
             a.nargs, a.const, type(a).__name__) for a in parser._actions
            if a.dest not in skip]


def test_train_parser_matches_jax_package():
    """The train CLI's flags, defaults and order are the JAX parser's,
    plus --device; the three flags with no effect in the port say so."""
    from ta3n_tpu.cli.opts import build_parser as jax_parser
    from ta3n_tpu_torch.cli.opts import build_parser

    ours, ref = build_parser(), jax_parser()
    assert _actions(ours, skip=("device",)) == _actions(ref)
    assert ours._actions[-1].dest == "device"
    assert ours._actions[-1].default == "cuda"
    helps = {a.dest: a.help for a in ours._actions}
    for dest in ("prng_impl", "compilation_cache", "workers"):
        assert "no effect" in helps[dest], dest


def test_eval_parser_matches_jax_package():
    from ta3n_tpu.cli.test_models import build_parser as jax_parser
    from ta3n_tpu_torch.cli.test_models import build_parser

    ours = build_parser()
    assert _actions(ours, skip=("device", "compute_dtype")) == \
        _actions(jax_parser())
    assert ours._actions[-1].dest == "device"
    assert ours._actions[-1].default == "cuda"
    # the port's own --compute_dtype defaults to the JAX CLI's float32
    assert ours.parse_args(["c", "RGB", "l", "w"]).compute_dtype == "float32"


@pytest.mark.parametrize("argv", [
    [], ["--num_segments", "17", "--val_segments", "-1", "--fc_dim", "512",
         "--use_target", "uSv", "--dis_DA", "DAN", "--beta", "-1", "0.5",
         "--lr_steps", "3", "4", "--copy_list", "Y", "N"]])
def test_configs_from_args_match_jax_package(argv):
    from ta3n_tpu.cli.opts import build_parser as jax_parser
    from ta3n_tpu.cli.opts import configs_from_args as jax_configs
    from ta3n_tpu_torch.cli.opts import build_parser, configs_from_args

    head = ["class.txt", "RGB", "src.txt", "tgt.txt", "val.txt"]
    ours = configs_from_args(build_parser().parse_args(head + argv), 7)
    ref = jax_configs(jax_parser().parse_args(head + argv), 7)
    for a, b in zip(ours, ref, strict=True):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
