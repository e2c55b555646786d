"""PyTorch port, the data path: the port's own copies of the feature store,
the TSN samplers and loader, and the synthetic stores, held against the
JAX package's: the same seed and records give exactly the same batches,
and a store saved by either package loads in the other."""

import numpy as np
import pytest
import torch

from ta3n_tpu.data import TSNLoader as JaxTSNLoader
from ta3n_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from ta3n_tpu.data.synthetic import (make_domain_pair as jax_domain_pair,
                                     make_synthetic_store as jax_store)
from ta3n_tpu_torch.data import (FeatureStore, TSNLoader, make_domain_pair,
                                 make_synthetic_store)


def _stores(streams=None, seed=0):
    """The same features as a port store and a JAX store: the domain
    pair's source split, or a Flow store of [rows, streams, D]."""
    port = make_domain_pair(num_source=23, num_target=9, num_val=5,
                            num_class=4, feature_dim=12, seed=seed)[0]
    feats = port.features
    if streams is not None:
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(feats.shape[0], streams, 12)) \
            .astype(np.float32)
    return (FeatureStore(feats, port.offsets, port.paths, port.labels),
            JaxFeatureStore(feats, port.offsets, port.paths, port.labels))


@pytest.mark.parametrize("mode,new_length,streams,records", [
    ("random", 1, None, "all"), ("val", 1, None, "all"),
    ("test", 1, None, "all"), ("random", 3, None, "repeat"),
    ("test", 2, 2, "repeat"),
])
def test_loader_matches_jax(mode, new_length, streams, records):
    """Two epochs of epoch() and of index_epoch(), shuffled, with a padded
    last batch (and pad_to above the batch size), from the same seed:
    features, indices, labels and masks exactly equal."""
    port, ref = _stores(streams)
    kw = dict(batch_size=5, num_segments=4, new_length=new_length,
              mode=mode, seed=7, pad_to=6)
    if records == "repeat":
        kw["records"] = port.records()[3:]
        kw["num_dataload"] = 31
    a, b = TSNLoader(port, **kw), JaxTSNLoader(ref, **kw)
    assert len(a) == len(b) and a.frames_per_video == b.frames_per_video
    n = 0
    for _ in range(2):
        for got, want in zip(a.epoch(), b.epoch()):
            assert got.features.dtype == np.float32
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            n += 1
        for got, want in zip(a.index_epoch(), b.index_epoch()):
            assert got.abs_indices.dtype == np.int32
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            n += 1
    assert n == 4 * len(a)


def test_store_round_trips_between_packages(tmp_path):
    port, ref = _stores()
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))
    for loaded, other in ((JaxFeatureStore.load(str(tmp_path / "port")), port),
                          (FeatureStore.load(str(tmp_path / "jax")), ref)):
        np.testing.assert_array_equal(np.asarray(loaded.features),
                                      other.features)
        np.testing.assert_array_equal(loaded.offsets, other.offsets)
        assert [(r.path, r.num_frames, r.label) for r in loaded.records()] \
            == [(r.path, r.num_frames, r.label) for r in other.records()]
    sub = port.subset([4, 1])
    want = ref.subset([4, 1])
    np.testing.assert_array_equal(sub.features, want.features)
    assert sub.index_of(want.paths[1]) == 1


def test_to_device_uploads_float32_once():
    """float16 rows become float32 exactly; Flow stores keep their stream
    axis; a store quantized on disk uploads its own (q, scale) pair, as
    the JAX Trainer does, whatever dtype is asked for."""
    port, _ = _stores()
    half = FeatureStore(port.features.astype(np.float16), port.offsets,
                        port.paths, port.labels)
    got = half.to_device("cpu")
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), port.features.astype(np.float16).astype(np.float32))
    flow, _ = _stores(streams=2)
    assert flow.to_device("cpu").shape == flow.features.shape
    q = np.clip(port.features * 40, -127, 127).astype(np.int8)
    scales = np.linspace(0.5, 2.0, len(q)).astype(np.float32)
    quantized = FeatureStore(q, port.offsets, port.paths, port.labels,
                             scales=scales)
    for dtype in (None, "bfloat16", "int8"):
        got_q, got_s = quantized.to_device("cpu", dtype)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), q)
        np.testing.assert_array_equal(got_s.numpy(), scales)
    # a streamed epoch of the store: the JAX loader's, shard for shard
    from ta3n_tpu.data.streaming import ShardPlan as JaxShardPlan
    from ta3n_tpu_torch.data.streaming import ShardPlan
    plan, jplan = ShardPlan(port.offsets, 60), JaxShardPlan(port.offsets, 60)
    got = list(TSNLoader(port, batch_size=4, seed=5).shard_index_epoch(plan))
    want = list(JaxTSNLoader(_stores()[1], batch_size=4, seed=5)
                .shard_index_epoch(jplan))
    assert len(got) == len(want) > plan.num_shards > 1
    for (sid, b), (jsid, jb) in zip(got, want):
        assert sid == jsid
        for x, y in zip(b, jb):
            np.testing.assert_array_equal(x, y)


def test_synthetic_stores_match_jax():
    a = make_synthetic_store(7, 3, 16, shift=0.5, seed=4, prefix="x")
    b = jax_store(7, 3, 16, shift=0.5, seed=4, prefix="x")
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert a.paths == b.paths and list(a.labels) == list(b.labels)
    for x, y in zip(make_domain_pair(seed=3), jax_domain_pair(seed=3)):
        np.testing.assert_array_equal(x.features, y.features)
        assert x.paths == y.paths
