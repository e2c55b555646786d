"""PyTorch port, the native host gather (`data/native_gather.py`, built
from `csrc/feature_gather.cc` with the host C++ compiler) on the CPU:
``FeatureStore.gather`` through it is bitwise the numpy fancy index and
the JAX package's ``FeatureStore.gather`` for float32, float16 and int8
stores and two-stream (Flow) stores, memory-mapped too, and so are the
loader's batches; an index outside its video raises ``IndexError``, an
array the library cannot take and a failed build raise, never falling
back to numpy; two builds at once leave one whole library.  The switch
is off by default, and then a store gathers through the fancy index with
no compiler."""

import threading

import numpy as np
import pytest
import torch

from ta3n_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from ta3n_tpu_torch.data import FeatureStore, TSNLoader
from ta3n_tpu_torch.data import native_gather

DEFAULT_SWITCH = FeatureStore.use_native_gather


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """The library is off by default; these tests turn it on."""
    monkeypatch.setattr(FeatureStore, "use_native_gather", True)


def _arrays(streams, seed=0, videos=9, dim=24):
    rng = np.random.default_rng(seed)
    counts = rng.integers(3, 12, videos)
    rows = int(counts.sum())
    shape = (rows, streams, dim) if streams > 1 else (rows, dim)
    feats = rng.normal(size=shape).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return feats, offsets, [f"v{i}" for i in range(videos)], \
        list(rng.integers(0, 4, videos))


def _stores(dtype, streams):
    feats, offsets, paths, labels = _arrays(streams)
    if dtype == "float16":
        feats = feats.astype(np.float16)
    port = FeatureStore(feats, offsets, paths, labels)
    ref = JaxFeatureStore(feats, offsets, paths, labels)
    if dtype == "int8":
        port, ref = port.quantize(), ref.quantize()
    return port, ref


def _indices(store, rng, batch=7, frames=5):
    vids = rng.integers(0, store.num_videos, batch)
    frames = np.stack([rng.integers(0, n, frames)
                       for n in store.num_frames(vids)])
    return vids, frames


@pytest.mark.parametrize("dtype,streams", [
    ("float32", 1), ("float16", 1), ("int8", 1), ("float32", 2),
    ("int8", 2)])
def test_gather_is_bitwise_numpy_and_jax(dtype, streams, tmp_path,
                                         monkeypatch):
    port, ref = _stores(dtype, streams)
    saved = tmp_path / "store"
    port.save(str(saved))
    mapped = FeatureStore.load(str(saved))  # a read-only memmap
    assert isinstance(mapped.features, np.memmap)
    rng = np.random.default_rng(1)
    for _ in range(3):
        vids, frames = _indices(port, rng)
        for out_dtype in (np.float32, np.float16):
            got = port.gather(vids, frames, dtype=out_dtype)
            want = ref.gather(vids, frames, dtype=out_dtype)
            assert got.dtype == want.dtype == out_dtype
            assert got.shape == (len(vids), 5 * streams, port.feature_dim)
            assert np.array_equal(got, want)
            assert np.array_equal(mapped.gather(vids, frames, out_dtype),
                                  got)
            with monkeypatch.context() as m:
                m.setattr(FeatureStore, "use_native_gather", False)
                assert np.array_equal(port.gather(vids, frames, out_dtype),
                                      got)
    # the codes themselves, through the library
    rows = native_gather.native_gather(port.features, port.offsets, vids,
                                       frames)
    assert rows.dtype == port.features.dtype
    assert np.array_equal(rows, port.features[port.offsets[vids][:, None]
                                              + frames])


def test_gather_runs_the_library(monkeypatch):
    """The switch on: every gather calls the library; off, none does."""
    port, _ = _stores("float32", 1)
    calls = []
    real = native_gather.native_gather
    monkeypatch.setattr("ta3n_tpu_torch.data.feature_store.native_gather",
                        lambda *a: calls.append(1) or real(*a))
    vids, frames = _indices(port, np.random.default_rng(2))
    port.gather(vids, frames)
    monkeypatch.setattr(FeatureStore, "use_native_gather", False)
    port.gather(vids, frames)
    assert calls == [1]


def test_loader_batches_are_bitwise_numpy(monkeypatch):
    port, _ = _stores("int8", 2)

    def epoch():
        loader = TSNLoader(port, batch_size=4, num_segments=3, seed=5)
        return [(b.features, b.labels, b.mask) for b in loader.epoch()]

    native = epoch()
    monkeypatch.setattr(FeatureStore, "use_native_gather", False)
    for a, b in zip(native, epoch(), strict=True):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["past_video_end", "negative_frame",
                                  "video_out_of_range", "negative_video"])
def test_out_of_range_raises_index_error(case):
    """The library checks every index against its own video (the numpy
    index reads past a video's end into the next one)."""
    port, _ = _stores("float32", 1)
    vids = np.array([0, 1, 2])
    frames = np.zeros((3, 2), np.int64)
    if case == "past_video_end":
        frames[1, 1] = port.num_frames(vids)[1]
    elif case == "negative_frame":
        frames[2, 0] = -1
    elif case == "video_out_of_range":
        vids = np.array([0, port.num_videos, 2])
    else:
        vids = np.array([0, -1, 2])
    with pytest.raises(IndexError, match="out of range"):
        native_gather.native_gather(port.features, port.offsets, vids,
                                    frames)
    if case == "past_video_end":
        with pytest.raises(IndexError):
            port.gather(vids, frames)


@pytest.mark.parametrize("case", ["float_frames", "offsets_past_rows",
                                  "negative_offset", "falling_offsets",
                                  "frame_idx_1d"])
def test_bad_indices_and_offsets_raise(case):
    """Float indices raise as numpy's index does; offsets that would take
    the library outside the features (a corrupt offsets.npy) and index
    arrays of the wrong rank raise before any row is read."""
    port, _ = _stores("float32", 1)
    feats, offsets = port.features, port.offsets.copy()
    vids, frames = np.array([0, 1]), np.zeros((2, 3), np.int64)
    if case == "float_frames":
        frames = frames.astype(np.float32)
    elif case == "offsets_past_rows":
        offsets[-1] += 1
    elif case == "negative_offset":
        offsets[0] = -1
    elif case == "falling_offsets":
        offsets[2] = offsets[1] - 1
    else:
        frames = frames[0]
    error = IndexError if case == "float_frames" else ValueError
    with pytest.raises(error, match="native gather"):
        native_gather.native_gather(feats, offsets, vids, frames)


@pytest.mark.parametrize("features", ["strided", "tensor"])
def test_unsupported_features_raise(features):
    """An array the library cannot take raises; nothing falls back."""
    feats, offsets, paths, labels = _arrays(1)
    wide = np.repeat(feats, 2, axis=1)
    data = wide[:, ::2] if features == "strided" else torch.from_numpy(feats)
    store = FeatureStore(data, offsets, paths, labels)
    vids, frames = _indices(store, np.random.default_rng(3))
    with pytest.raises(ValueError, match="C-contiguous|numpy array"):
        store.gather(vids, frames)


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    """Two builds at once (as test workers may start them): one library
    under the hashed name, no temporary file left, and it gathers."""
    monkeypatch.setattr(native_gather, "BUILD_DIR", tmp_path)
    errors = []

    def build():
        try:
            native_gather.build_native()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert errors == []
    assert [p.name for p in tmp_path.iterdir()] == \
        [native_gather._lib_path().name]
    assert native_gather.native_available()
    port, _ = _stores("float16", 1)
    vids, frames = _indices(port, np.random.default_rng(4))
    assert np.array_equal(
        native_gather.native_gather(port.features, port.offsets, vids,
                                    frames),
        port.features[port.offsets[vids][:, None] + frames])


@pytest.mark.parametrize("cxx,message", [
    ("false", "build failed"),
    ("no-such-compiler-x", r"no C\+\+ compiler")])
def test_failed_build_raises(tmp_path, monkeypatch, cxx, message):
    """A compiler that fails or is missing raises from the gather with its
    message; nothing is left in the build directory."""
    monkeypatch.setattr(native_gather, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", cxx)
    assert not native_gather.native_available()
    port, _ = _stores("float32", 1)
    vids, frames = _indices(port, np.random.default_rng(5))
    with pytest.raises(RuntimeError, match=message):
        port.gather(vids, frames)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("features", ["array", "tensor"])
def test_default_is_the_fancy_index(features, tmp_path, monkeypatch):
    """The switch is off by default: a store, tensor-backed too, gathers
    through numpy's fancy index, and nothing is compiled (a missing
    compiler does not matter)."""
    assert DEFAULT_SWITCH is False
    monkeypatch.setattr(FeatureStore, "use_native_gather", DEFAULT_SWITCH)
    monkeypatch.setattr(native_gather, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-x")
    feats, offsets, paths, labels = _arrays(2)
    data = torch.from_numpy(feats) if features == "tensor" else feats
    store = FeatureStore(data, offsets, paths, labels)
    vids, frames = _indices(store, np.random.default_rng(6))
    got = store.gather(vids, frames)
    want = feats[offsets[vids][:, None] + frames]
    assert np.array_equal(got, want.reshape(got.shape))
    assert list(tmp_path.iterdir()) == []
