"""PyTorch port, larger-than-memory stores streamed to the device in shards
(`ta3n_tpu_torch/data/streaming.py`, ``TSNLoader.shard_index_epoch``) on
the CPU, mirroring tests/test_streaming_store.py.

The shard plan and the loader's shard-local epochs are held bitwise to
the JAX package's; training through ``ShardStream`` bitwise to the
resident store on the same batches with global indices (the streaming
contract); the float32, bfloat16 and int8 shards, and those of a store
quantized on disk, bitwise to the rows of the resident store on the
device; the streamed Trainer, single-step, K-step and sampled on the
device, and the streamed eval CLI, end to end.
"""

import numpy as np
import pytest
import torch

from ta3n_tpu.data import TSNLoader as JaxTSNLoader
from ta3n_tpu.data.streaming import ShardPlan as JaxShardPlan
from ta3n_tpu.data.synthetic import make_domain_pair as jax_domain_pair
from ta3n_tpu_torch.cli import test_models as port_eval_cli
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore, TSNLoader, make_domain_pair
from ta3n_tpu_torch.data.streaming import ShardPlan, ShardStream
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_multi_train_step, make_train_step)
from ta3n_tpu_torch.train.loop import Trainer

SEG, FDIM = 3, 16


def test_shard_plan_partition():
    # videos of 4 rows each; budget 10 -> 2 videos (8 rows) per shard
    offsets = np.arange(0, 41, 4, dtype=np.int64)
    plan = ShardPlan(offsets, budget_rows=10)
    assert plan.num_shards == 5
    np.testing.assert_array_equal(plan.video_lo, [0, 2, 4, 6, 8])
    np.testing.assert_array_equal(plan.row_lo, [0, 8, 16, 24, 32])
    np.testing.assert_array_equal(plan.shard_of(np.arange(10)),
                                  [0, 0, 1, 1, 2, 2, 3, 3, 4, 4])
    ref = JaxShardPlan(offsets, budget_rows=10)
    for name in ("video_lo", "video_hi", "row_lo", "row_hi"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(ref, name))


def test_shard_plan_rejects_oversized_video():
    offsets = np.array([0, 4, 30, 34], dtype=np.int64)  # video 1: 26 rows
    with pytest.raises(ValueError, match="budget_rows"):
        ShardPlan(offsets, budget_rows=10)


@pytest.mark.parametrize("streams", [None, 2], ids=["rgb", "flow"])
def test_shard_array_padded_to_budget(streams):
    offsets = np.array([0, 3, 7], dtype=np.int64)
    shape = (7, 2) if streams is None else (7, streams, 3)
    feats = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    plan = ShardPlan(offsets, budget_rows=4)
    assert plan.num_shards == 2
    a0, a1 = plan.shard_array(feats, 0), plan.shard_array(feats, 1)
    assert a0.shape == a1.shape == (4,) + shape[1:]
    np.testing.assert_array_equal(a0[:3], feats[:3])
    np.testing.assert_array_equal(a0[3], 0)
    np.testing.assert_array_equal(a1, feats[3:7])


@pytest.mark.parametrize("shuffle", [False, True])
def test_shard_index_epoch_matches_jax_loader(shuffle):
    """The same seed gives bitwise the JAX loader's (shard, batch) stream
    over two epochs, its length ``shard_epoch_len``, every record once
    an epoch, shard-local rows within the budget."""
    kw = dict(num_source=30, num_target=8, num_val=8, num_class=3,
              feature_dim=FDIM)
    src, jsrc = make_domain_pair(**kw)[0], jax_domain_pair(**kw)[0]
    loader = TSNLoader(src, batch_size=4, num_segments=SEG, shuffle=shuffle,
                       seed=3, pad_to=6)
    ref = JaxTSNLoader(jsrc, batch_size=4, num_segments=SEG,
                       shuffle=shuffle, seed=3, pad_to=6)
    plan, jplan = ShardPlan(src.offsets, 80), JaxShardPlan(jsrc.offsets, 80)
    assert plan.num_shards >= 3
    assert loader.shard_epoch_len(plan) == ref.shard_epoch_len(jplan)
    for _ in range(2):
        got = list(loader.shard_index_epoch(plan))
        want = list(ref.shard_index_epoch(jplan))
        assert len(got) == len(want) == loader.shard_epoch_len(plan)
        seen = []
        for (sid, b), (jsid, jb) in zip(got, want):
            assert sid == jsid
            for a, c in zip(b, jb):
                np.testing.assert_array_equal(a, c)
            real = b.mask > 0
            assert b.abs_indices[real].min() >= 0
            assert b.abs_indices[real].max() < plan.budget_rows
            glob = b.abs_indices[real][:, 0] + int(plan.row_lo[sid])
            vid = np.searchsorted(src.offsets, glob, side="right") - 1
            assert (plan.shard_of(vid) == sid).all()
            seen.extend(vid.tolist())
        assert sorted(seen) == list(range(30))


def _flagship(dropout=0.5):
    cfg = ModelConfig(num_class=3, baseline_type="video",
                      frame_aggregation="trn-m", use_attn="TransAttn",
                      train_segments=SEG, val_segments=SEG, fc_dim=16,
                      feature_dim=FDIM, dropout_i=dropout,
                      dropout_v=dropout)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy",
                  place_adv=("Y", "Y", "Y"))
    return cfg, da, TrainConfig(lr=0.1, batch_size=(8, 6, 8))


def _global(batch, plan, sid):
    """A shard-local batch's indices as global rows (masked rows: row
    0)."""
    idx = batch.abs_indices + np.int32(plan.row_lo[sid])
    idx[batch.mask == 0] = 0
    return idx


@pytest.mark.parametrize("store_dtype", [None, "bfloat16", "int8"])
def test_streaming_training_bitwise_equals_resident(store_dtype):
    """Two epochs of shard-local batches through ShardStream (single steps,
    then K = 3 steps per call within each shard pair) end with bitwise
    the parameters of the resident store on the same batches with global
    indices, in every store dtype, dropout on."""
    src, tgt, _ = make_domain_pair(num_source=30, num_target=24, num_val=8,
                                   num_class=3, feature_dim=FDIM)
    cfg, da, tc = _flagship()
    plans = [ShardPlan(s.offsets, budget_rows=100) for s in (src, tgt)]
    assert min(p.num_shards for p in plans) >= 2

    def epochs(store, plan, bs, seed):
        loader = TSNLoader(store, batch_size=bs, num_segments=SEG, seed=seed)
        return [x for _ in range(2) for x in loader.shard_index_epoch(plan)]

    pairs = list(zip(epochs(src, plans[0], 8, 1), epochs(tgt, plans[1], 6,
                                                        2)))
    sc = StepScalars((0.5, 0.5, 0.5), 0.0, 0.0, 0.01, 0.1)
    results = []
    for mode in ("streamed", "streamed K", "resident"):
        state = create_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                   "cpu")
        gen = torch.Generator().manual_seed(1)
        step = make_train_step(state.model, da, tc, gather_on_device=True)
        if mode == "resident":
            dev = [s.to_device("cpu", store_dtype) for s in (src, tgt)]
            for (sid_s, bs), (sid_t, bt) in pairs:
                state, _ = step(state, dev[0], _global(bs, plans[0], sid_s),
                                bs.labels, bs.mask, dev[1],
                                _global(bt, plans[1], sid_t), bt.labels,
                                bt.mask, sc, gen)
        else:
            streams = [ShardStream(s.features, p, "cpu", store_dtype)
                       for s, p in zip((src, tgt), plans)]
            if mode == "streamed":
                for (sid_s, bs), (sid_t, bt) in pairs:
                    state, _ = step(state, streams[0].get(sid_s),
                                    *bs, streams[1].get(sid_t), *bt, sc, gen)
            else:
                multi = make_multi_train_step(state.model, da, tc)
                i = 0
                while i < len(pairs):
                    key = (pairs[i][0][0], pairs[i][1][0])
                    chunk = [pairs[i]]
                    while (len(chunk) < 3 and i + len(chunk) < len(pairs)
                           and (pairs[i + len(chunk)][0][0],
                                pairs[i + len(chunk)][1][0]) == key):
                        chunk.append(pairs[i + len(chunk)])
                    bs, bt = ([b for _, b in side] for side in zip(*chunk))
                    k = len(chunk)
                    state, _ = multi(
                        state, streams[0].get(key[0]),
                        *(np.stack(x) for x in zip(*bs)),
                        streams[1].get(key[1]),
                        *(np.stack(x) for x in zip(*bt)),
                        StepScalars(*([f] * k for f in sc)), gen)
                    i += k
            assert streams[0].uploads >= plans[0].num_shards
        results.append(state.model.state_dict())
    assert results[0].keys() == results[2].keys()
    for name in results[2]:
        for got in results[:2]:
            assert torch.equal(got[name], results[2][name]), name


@pytest.mark.parametrize("kind", ["int8", "on_disk", "bfloat16", "float16"])
def test_shard_stream_matches_the_resident_store(kind):
    """Every shard holds bitwise the resident store's rows on the device
    (and scales, for int8); its padding rows read as zeros; a stale
    prefetch is dropped; requesting the current shard uploads nothing."""
    src = make_domain_pair(num_source=20, num_target=4, num_val=4,
                           num_class=3, feature_dim=FDIM)[0]
    dtype = {"int8": "int8", "bfloat16": "bfloat16"}.get(kind)
    if kind == "on_disk":
        src = src.quantize()
    elif kind == "float16":
        src = FeatureStore(src.features.astype(np.float16), src.offsets,
                           src.paths, src.labels)
    plan = ShardPlan(src.offsets, budget_rows=60)
    assert plan.num_shards >= 3
    stream = ShardStream(src.features, plan, "cpu", dtype,
                         scales=src.scales)
    resident = src.to_device("cpu", dtype)
    for sid in range(plan.num_shards):
        shard = stream.get(sid)
        assert stream.get(sid) is shard
        lo, hi = int(plan.row_lo[sid]), int(plan.row_hi[sid])
        if isinstance(resident, tuple):
            (q, s), (rq, rs) = shard, resident
            assert q.dtype == torch.int8 and q.shape[0] == 60
            assert torch.equal(q[:hi - lo], rq[lo:hi])
            assert torch.equal(s[:hi - lo], rs[lo:hi])
            padded = q[hi - lo:].float() * s[hi - lo:, None]
        else:
            assert shard.dtype == resident.dtype and shard.shape[0] == 60
            assert torch.equal(shard[:hi - lo], resident[lo:hi])
            padded = shard[hi - lo:]
        assert not padded.any()
    # the prefetches made on the way hit: one upload a shard, and the
    # last one prefetched the first, for the next epoch
    assert stream.uploads == plan.num_shards + 1
    assert list(stream._next) == [0]
    stream.get(0)  # the next epoch: 0 prefetched, 1 prefetched now
    stream.get(2)  # past the prefetched 1, which is dropped: 2 uploaded,
    assert list(stream._next) == [3]  # and 3 prefetched
    assert stream.uploads == plan.num_shards + 4


def _trainer(root, tag, budget, **kw):
    src, tgt, val = make_domain_pair(num_source=24, num_target=18,
                                     num_val=12, num_class=3,
                                     feature_dim=FDIM, shift=0.8)
    cfg, da, _ = _flagship(dropout=0.1)
    tc = TrainConfig(lr=0.05, epochs=2, batch_size=(8, 6, 8),
                     beta=(0.5, 0.5, 0.5))
    ls = TSNLoader(src, batch_size=8, num_segments=SEG, shuffle=False,
                   seed=1)
    lt = TSNLoader(tgt, batch_size=6, num_segments=SEG, shuffle=False,
                   seed=2)
    lv = TSNLoader(val, batch_size=8, num_segments=SEG, shuffle=False)
    return Trainer(cfg, da, tc, ls, lt, lv, path_exp=f"{root}/{tag}/",
                   device_store=True, store_budget_rows=budget, eval_freq=1,
                   print_freq=100, show_freq=100, device="cpu", **kw)


def test_trainer_streaming_device_sampler_bitwise_equals_host(tmp_path):
    """The streamed Trainer at K = 2: batches made shard-locally on the
    device train bitwise as the host loader's shard stream, in
    deterministic mode, dropout on; the single-step streamed Trainer and
    the K-step one agree too; val Prec@1 of the streamed validation
    equals the resident one's on the same weights."""
    runs = {name: _trainer(tmp_path, name, 80, **kw) for name, kw in (
        ("sampled", dict(steps_per_call=2, device_sampler=True)),
        ("host", dict(steps_per_call=2)), ("single", {}))}
    assert runs["sampled"].shard_sampled_step is not None
    assert runs["host"].multi_step is not None
    assert runs["host"].shard_sampled_step is None
    assert all(t.streaming for t in runs.values())
    assert runs["host"]._plan_s.num_shards >= 3
    best = {name: t.fit() for name, t in runs.items()}
    assert len(set(best.values())) == 1
    want = runs["host"].state.model.state_dict()
    for name in ("sampled", "single"):
        assert runs[name].state.step == runs["host"].state.step > 0
        for key, value in runs[name].state.model.state_dict().items():
            assert torch.equal(value, want[key]), (name, key)
    resident = _trainer(tmp_path, "resident", None)
    resident.state.model.load_state_dict(want)
    assert resident.validate(0) == runs["host"].validate(0)


def test_eval_cli_streamed_end_to_end(tmp_path):
    """The eval CLI with --device_store --store_budget_rows 40 (several
    shards, int8 rows quantized per shard) gives bitwise the outputs of
    the resident --device_store run, in the list's order."""
    store = make_domain_pair(num_source=21, num_target=4, num_val=4,
                             num_class=3, feature_dim=FDIM)[0]
    store.save(str(tmp_path / "val"))
    with open(tmp_path / "val" / "list.txt", "w") as f:
        for r in reversed(store.records()):
            f.write(f"{r.path} {r.num_frames} {r.label}\n")
    (tmp_path / "class.txt").write_text("0 a\n1 b\n2 c\n")
    trainer = _trainer(tmp_path, "ckpt", None, save_model=True)
    trainer.save(1, 0.0, True)
    outs = []
    for extra in ([], ["--store_budget_rows", "40"]):
        prefix = str(tmp_path / f"out{len(extra)}")
        line = port_eval_cli.main([
            str(tmp_path / "class.txt"), "RGB",
            str(tmp_path / "val" / "list.txt"),
            str(tmp_path / "ckpt" / "model_best.pth.tar"),
            "--test_segments", str(SEG), "--fc_dim", "16", "--feature_dim",
            str(FDIM), "--baseline_type", "video", "--frame_aggregation",
            "trn-m", "--use_attn", "TransAttn", "--bS", "4", "--top", "1",
            "2", "--device", "cpu", "--device_store", "--store_dtype", "int8",
            "--save_scores", prefix + "_scores", "--save_attention",
            prefix + "_attn", *extra])
        outs.append((line, np.load(prefix + "_scores.npz")["scores"],
                     np.loadtxt(prefix + "_attn.txt")))
    assert outs[0][0] == outs[1][0] and outs[0][0].startswith("Pred@1")
    assert outs[1][1].shape == (21, 3)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_array_equal(a, b)
