"""PyTorch port, the feature extractor: the port's ResNet (resnet18's
basic blocks, resnet50's bottlenecks, at 64x64 input) and C3D (both
``activations``, on 16-frame 32x32 clips, fc6 sized for them) against the
JAX package's backbones on one seeded torchvision-format (reference C3D)
state_dict; ``clips_from_frames``; and the port's ``video2feature`` (its
per-video shards, resumed, then ``--finalize``) against the JAX tool's
store on the same frames, the decode monkeypatched (CPU, float32).

Tolerance: FEAT_TOL, |port - JAX| <= 1e-4 * max|JAX| per output, the
float32 summation-order differences of cuDNN-free CPU convolutions (XLA's
and oneDNN's) through up to 50 layers.
"""

import numpy as np
import pytest
import torch

import jax

from ta3n_tpu.models.backbones.c3d import C3DFeatures as JaxC3D
from ta3n_tpu.models.backbones.c3d import clips_from_frames as jax_clips
from ta3n_tpu.models.backbones.c3d import import_torch_c3d
from ta3n_tpu.models.backbones.resnet import RESNET_SPECS as JAX_SPECS
from ta3n_tpu.models.backbones.resnet import ResNetFeatures as JaxResNet
from ta3n_tpu.models.backbones.resnet import import_torch_resnet
from ta3n_tpu.prep import video2feature as jax_v2f
from ta3n_tpu_torch.data import FeatureStore
from ta3n_tpu_torch.models.backbones import (C3D_CLIP_SIZE, RESNET_SPECS,
                                             C3DFeatures, ResNetFeatures,
                                             clips_from_frames,
                                             resnet_feature_dim)
from ta3n_tpu_torch.prep import video2feature

FEAT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU ops, as in the
    heaviest port test files (tests/test_torch_port_ensemble.py); the
    previous count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=FEAT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def torchvision_state(arch, seed=0):
    """A torchvision-format state_dict of ``arch``, including the ``fc``
    classifier its files carry: He-normal convs, BN affine and running
    statistics near identity, so that activations stay O(1)."""
    kind, counts = JAX_SPECS[arch]
    rng = np.random.default_rng(seed)
    state = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def conv(name, cout, cin, k):
        state[f"{name}.weight"] = t(rng.normal(
            scale=(2.0 / (cin * k * k)) ** 0.5, size=(cout, cin, k, k)))

    def bn(name, c):
        state[f"{name}.weight"] = t(rng.uniform(0.5, 1.0, c))
        state[f"{name}.bias"] = t(rng.normal(scale=0.1, size=c))
        state[f"{name}.running_mean"] = t(rng.normal(scale=0.1, size=c))
        state[f"{name}.running_var"] = t(rng.uniform(0.5, 2.0, c))
        state[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin, width = 64, 64
    expansion = 1 if kind == "basic" else 4
    for li, n in enumerate(counts, 1):
        for b in range(n):
            src = f"layer{li}.{b}"
            if kind == "basic":
                convs = [(width, cin if b == 0 else width, 3),
                         (width, width, 3)]
            else:
                convs = [(width, cin if b == 0 else width * 4, 1),
                         (width, width, 3), (width * 4, width, 1)]
            for i, (co, ci, k) in enumerate(convs, 1):
                conv(f"{src}.conv{i}", co, ci, k)
                bn(f"{src}.bn{i}", co)
            if b == 0 and (li > 1 or cin != width * expansion):
                conv(f"{src}.downsample.0", width * expansion, cin, 1)
                bn(f"{src}.downsample.1", width * expansion)
        cin, width = width * expansion, width * 2
    state["fc.weight"] = t(rng.normal(size=(1000, cin)))
    state["fc.bias"] = t(np.zeros(1000))
    return state


def c3d_state(flat, seed=0):
    """A reference C3D state_dict whose fc6 takes ``flat`` inputs, with
    the extraction-irrelevant fc8."""
    rng = np.random.default_rng(seed)
    chans = [(3, 64, "conv1"), (64, 128, "conv2"), (128, 256, "conv3a"),
             (256, 256, "conv3b"), (256, 512, "conv4a"),
             (512, 512, "conv4b"), (512, 512, "conv5a"),
             (512, 512, "conv5b")]
    state = {}
    for cin, cout, name in chans:
        state[f"{name}.weight"] = torch.from_numpy(rng.normal(
            scale=(1.0 / (27 * cin)) ** 0.5,
            size=(cout, cin, 3, 3, 3)).astype(np.float32))
        state[f"{name}.bias"] = torch.from_numpy(
            rng.normal(scale=0.01, size=cout).astype(np.float32))
    for name, cout, cin in (("fc6", 4096, flat), ("fc7", 4096, 4096),
                            ("fc8", 487, 4096)):
        state[f"{name}.weight"] = torch.from_numpy(rng.normal(
            scale=cin ** -0.5, size=(cout, cin)).astype(np.float32))
        state[f"{name}.bias"] = torch.from_numpy(
            rng.normal(scale=0.01, size=cout).astype(np.float32))
    return state


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_jax(arch):
    """The port's ResNet strict-loads the torchvision state_dict (its fc
    left out, its BN batch counts taken) and gives the JAX backbone's
    features on the imported weights, NHWC there and NCHW here."""
    assert RESNET_SPECS == JAX_SPECS
    state = torchvision_state(arch)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    params, stats = import_torch_resnet(state, arch)
    want = jax.jit(lambda p, s, x: JaxResNet(arch=arch).apply(
        {"params": p, "batch_stats": s}, x))(params, stats, x)
    net = ResNetFeatures.from_state_dict(state, arch)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, resnet_feature_dim(arch))
    _close(got.numpy(), want)
    # running statistics in train mode too
    with torch.no_grad():
        torch.testing.assert_close(
            net.train()(torch.from_numpy(x).permute(0, 3, 1, 2)), got,
            rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key"):
        ResNetFeatures.from_state_dict(
            {k: v for k, v in state.items() if "layer4.0.bn2" not in k},
            arch)


@pytest.mark.parametrize("activations", ["none", "relu"])
def test_c3d_matches_jax(activations):
    """16-frame 32x32 clips (conv5b's pooled output flattens to 2048,
    channels first), against the JAX C3D on the imported weights."""
    state = c3d_state(flat=2048)
    x = np.random.default_rng(2).normal(
        scale=0.5, size=(1, C3D_CLIP_SIZE, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: JaxC3D(activations=activations).apply(
        {"params": p}, x))(import_torch_c3d(state), x)
    net = C3DFeatures.from_state_dict(state, activations)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (1, 4096)
    _close(got.numpy(), want)


def test_clips_from_frames():
    frames = np.arange(20)[:, None, None, None] * np.ones(
        (1, 4, 4, 3), np.float32)
    clips = clips_from_frames(frames)
    assert clips.shape == (5, 16, 4, 4, 3)
    np.testing.assert_array_equal(clips, jax_clips(frames))
    assert clips[4, 15, 0, 0, 0] == 19 * 255.0
    with pytest.raises(ValueError, match=">= 16 frames"):
        clips_from_frames(frames[:15])


def _frames(path):
    """A decoded 'video': 3 frames of 40x48, seeded by the file name."""
    seed = sum(map(ord, path.rsplit("/", 1)[-1]))
    return np.random.default_rng(seed).integers(
        0, 256, size=(3, 40, 48, 3), dtype=np.uint8)


def test_video2feature_matches_the_jax_tool(tmp_path, monkeypatch):
    """Two classes of two videos, resnet18 at --batch_size 2 (each video's
    second batch padded): the port's shards and finalized store against
    the JAX tool's, on the same decoded frames and weights; a second run
    skips the videos it has."""
    for cls in ("walk", "jump"):
        for v in ("a.mp4", "b.mp4"):
            (tmp_path / "RGB" / cls).mkdir(parents=True, exist_ok=True)
            (tmp_path / "RGB" / cls / v).write_bytes(b"")
    weights = str(tmp_path / "r18.pth")
    torch.save(torchvision_state("resnet18"), weights)
    monkeypatch.setattr(jax_v2f, "decode_video", _frames)
    monkeypatch.setattr(video2feature, "decode_video", _frames)
    common = ["--data_path", str(tmp_path), "--base_model", "resnet18",
              "--pretrain_weight", weights, "--batch_size", "2"]
    jax_v2f.main([*common, "--feature_in", "jax"])
    video2feature.main([*common, "--feature_in", "port", "--device", "cpu"])

    def never(path):
        raise AssertionError(f"{path} decoded again")

    monkeypatch.setattr(video2feature, "decode_video", never)
    video2feature.main([*common, "--feature_in", "port", "--device", "cpu"])
    jax_v2f.finalize(str(tmp_path / "jax_resnet18"))
    video2feature.main(["--finalize", str(tmp_path / "port_resnet18")])
    want = FeatureStore.load(str(tmp_path / "jax_resnet18"))
    got = FeatureStore.load(str(tmp_path / "port_resnet18"))
    assert got.paths == want.paths == ["jump/a", "jump/b", "walk/a",
                                       "walk/b"]
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.features.shape == (12, 512)
    _close(got.features, want.features)


def test_video2feature_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        video2feature.main(["--data_path", str(tmp_path),
                            "--pretrain_weight", "w.pth"])
