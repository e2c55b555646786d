"""PyTorch port, the data-preparation entry points on the CPU, against the
JAX package's tools on the same inputs: `cli/convert_features.py` packs a
`.t7`-per-frame tree (RGB and Flow, float32, float16 and int8) into the
same `.npy` files as the JAX converter; `prep/dataset2split.py`,
`prep/video_dataset2list.py`, `prep/list2da.py` and
`prep/video_processing.py` (through a recording ``cv2``) give the JAX
tools' output; ``python -m ta3n_tpu_torch`` lists the port's entry
points, each of which resolves, and ``__version__`` is the JAX
package's.  Every tool runs in process (``main(argv)``, ``runpy``)."""

import importlib
import importlib.util
import json
import os
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from ta3n_tpu.cli import convert_features as jax_convert
from ta3n_tpu.prep import dataset2split as jax_split
from ta3n_tpu.prep import list2da as jax_list2da
from ta3n_tpu.prep import video_dataset2list as jax_list
from ta3n_tpu.prep import video_processing as jax_video
from ta3n_tpu.version import __version__ as jax_version
from ta3n_tpu_torch.cli import convert_features
from ta3n_tpu_torch.prep import (dataset2split, list2da, video_dataset2list,
                                 video_processing)


@pytest.fixture(scope="module")
def t7_tree(tmp_path_factory):
    """3 videos of 2-4 frames, 6-d features, one ``.t7`` per frame (RGB)
    and one per frame and direction (Flow, ``flow_`` prefix), with their
    list files."""
    root = tmp_path_factory.mktemp("t7")
    rng = np.random.default_rng(0)
    lists = {"RGB": [], "Flow": []}
    for v, frames in enumerate((3, 2, 4)):
        vdir = root / f"video_{v}"
        vdir.mkdir()
        for i in range(1, frames + 1):
            torch.save(torch.from_numpy(rng.normal(size=6).astype(
                np.float32)), vdir / f"img_{i:05d}.t7")
            for axis in "xy":
                torch.save(torch.from_numpy(rng.normal(size=(1, 6)).astype(
                    np.float32)), vdir / f"flow_{axis}_{i:05d}.t7")
        for modality in lists:
            lists[modality].append(f"{vdir} {frames} {v % 2}\n")
    for modality, lines in lists.items():
        (root / f"{modality}.txt").write_text("".join(lines))
    return root


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
def test_convert_features_matches_jax(t7_tree, tmp_path, modality, dtype,
                                      capsys):
    argv = [str(t7_tree / f"{modality}.txt"), "--modality", modality,
            "--dtype", dtype] + (["--flow_prefix", "flow_"]
                                 if modality == "Flow" else [])
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    convert_features.main([argv[0], str(ours), *argv[1:]])
    jax_convert.main([argv[0], str(ref), *argv[1:]])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(ours), "") == out[1].replace(str(ref), "")
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names
    assert ("scales.npy" in names) == (dtype == "int8")
    for name in names:
        if name.endswith(".npy"):
            a, b = np.load(ours / name), np.load(ref / name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert json.loads((ours / name).read_text()) == \
                json.loads((ref / name).read_text())
    features = np.load(ours / "features.npy")
    assert features.shape == ((9, 2, 6) if modality == "Flow" else (9, 6))


def _class_tree(root):
    """3 classes of 4, 3 and 5 videos, each a directory of frame files,
    and a stray file at the top."""
    for c, n in (("brush_hair", 4), ("climb", 3), ("golf", 5)):
        for v in range(n):
            vdir = root / c / f"{c}_{v:02d}"
            vdir.mkdir(parents=True)
            for i in range(v + 2):
                (vdir / f"img_{i:05d}.t7").write_bytes(b"x")
    (root / "README").write_text("not a class\n")


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("split", ["ratio", "split_file"])
def test_dataset2split_matches_jax(tmp_path, split, capsys):
    data = tmp_path / "data"
    _class_tree(data)
    extra = ["--ratio", "0.6", "--seed", "3"]
    if split == "split_file":
        (tmp_path / "train.txt").write_text(
            "brush_hair/brush_hair_01.avi 1\nclimb_00\ngolf_03 2\n\n")
        extra += ["--split_file", str(tmp_path / "train.txt")]
    dataset2split.main([str(data), str(tmp_path / "ours"), *extra])
    jax_split.main([str(data), str(tmp_path / "ref"), *extra])
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "golf:" in out
    assert _listing(tmp_path / "ours") == _listing(tmp_path / "ref")
    assert _listing(tmp_path / "ours")


@pytest.mark.parametrize("extra", [
    [], ["--class_list", "classes"], ["--sample_ratio", "0.5"],
    ["--sample_per_class", "2", "--seed", "4"]])
def test_video_dataset2list_matches_jax(tmp_path, extra):
    data = tmp_path / "data"
    _class_tree(data)
    (tmp_path / "classes").write_text("7 golf\n2 brush_hair\n\n")
    extra = [str(tmp_path / e) if e == "classes" else e for e in extra]
    video_dataset2list.main([str(data), str(tmp_path / "ours.txt"), *extra])
    jax_list.main([str(data), str(tmp_path / "ref.txt"), *extra])
    ours = (tmp_path / "ours.txt").read_text()
    assert ours == (tmp_path / "ref.txt").read_text() and ours


@pytest.mark.parametrize("mode", ["class_list_full", "ucf101", "hmdb51"])
def test_list2da_matches_jax(tmp_path, mode):
    (tmp_path / "da.txt").write_text("0 climb\n1 golf\n2 brush_hair\n")
    (tmp_path / "full.txt").write_text("0 climb\n1 golf\n2 walk\n")
    if mode == "ucf101":
        lines = ["x/v_golf_g01_c01.avi 40 1", "x/v_walk_g02_c01.avi 30 2",
                 "x/v_climb_g03_c02.avi 12 0", "x/short.avi 5 0"]
    else:
        lines = [f"x/{v}.avi {n} {c}" for v, n, c in (
            ("Brushing_brush_hair_f_nm_np1_ba_goo_0", 40, 2),
            ("Rock_climb_u_cm_np1_fr_med_1", 30, 0),
            ("Golf_golf_f_cm_np1_fr_bad_2", 12, 1),
            ("Walking_walk_f_cm_np1_fr_med_3", 20, 2))]
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n\n")
    extra = ["--class_list_da", str(tmp_path / "da.txt"), "--feature_root",
             "RGB-Feature"]
    extra += (["--class_list_full", str(tmp_path / "full.txt")]
              if mode == "class_list_full" else ["--dataset", mode])
    list2da.main([str(tmp_path / "list.txt"), str(tmp_path / "ours.txt"),
                  *extra])
    jax_list2da.main([str(tmp_path / "list.txt"), str(tmp_path / "ref.txt"),
                      *extra])
    ours = (tmp_path / "ours.txt").read_text()
    assert ours == (tmp_path / "ref.txt").read_text() and ours


def _fake_cv2(log):
    """A recording ``cv2``: a 3-frame 4x2 video at 30 fps whose frame
    count property reads 0, so count_frames decodes."""
    cv2 = types.ModuleType("cv2")
    cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS = 7, 5
    cv2.CAP_PROP_FRAME_WIDTH, cv2.CAP_PROP_FRAME_HEIGHT = 3, 4
    cv2.FONT_HERSHEY_SIMPLEX = 0

    class VideoCapture:
        def __init__(self, path):
            log.append(("open", path))
            self.left = 3

        def get(self, prop):
            return {7: 0, 5: 30.0, 3: 4, 4: 2}[prop]

        def read(self):
            self.left -= 1
            return self.left >= 0, np.full((2, 4, 3), self.left, np.uint8)

        def release(self):
            log.append(("release",))

    class VideoWriter:
        def __init__(self, path, fourcc, fps, size):
            log.append(("writer", path, fourcc, fps, size))

        def write(self, frame):
            log.append(("write", int(frame[0, 0, 0])))

        def release(self):
            log.append(("writer_release",))

    cv2.VideoCapture, cv2.VideoWriter = VideoCapture, VideoWriter
    cv2.VideoWriter_fourcc = lambda *c: "".join(c)
    cv2.putText = lambda frame, text, *a: log.append(("text", text, *a))
    return cv2


@pytest.mark.parametrize("argv", [["count", "a.mp4", "b.mp4"],
                                  ["overlay", "a.mp4", "o.mp4", "--text",
                                   "golf"]])
def test_video_processing_matches_jax(monkeypatch, capsys, argv):
    logs = {}
    for name, tool in (("ours", video_processing), ("ref", jax_video)):
        logs[name] = []
        monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(logs[name]))
        tool.main(argv)
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    assert logs["ours"] == logs["ref"] and logs["ours"]
    assert ("a.mp4 3" in out) == (argv[0] == "count")


def test_entry_points_resolve_and_version(capsys):
    """``python -m ta3n_tpu_torch`` prints the port's own list, each
    module of which resolves and has a main(); the version is the JAX
    package's."""
    runpy.run_module("ta3n_tpu_torch", run_name="__main__")
    printed = capsys.readouterr().out
    from ta3n_tpu_torch.__main__ import ENTRY_POINTS
    modules = [m for m, _ in ENTRY_POINTS]
    assert "ta3n_tpu_torch.cli.sweep" in modules
    assert "ta3n_tpu_torch.prep.video2feature" in modules
    for module in modules:
        assert f"python -m {module}" in printed
        assert importlib.util.find_spec(module) is not None, module
        assert callable(importlib.import_module(module).main), module
    from ta3n_tpu_torch.version import __version__
    assert __version__ == jax_version
