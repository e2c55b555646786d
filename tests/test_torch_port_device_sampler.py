"""PyTorch port, the index pipeline on the device
(`ta3n_tpu_torch/data/device_sampler.py`) on the CPU, mirroring
tests/test_device_sampler.py.

Deterministic modes ('val', 'test') are held bitwise to the port's host
loader and to the JAX package's ``DeviceSampler``; random mode and the
shuffled orders come from the port's own counter hash, so they are held
to the distribution contract (chunk-aligned offsets, every record once
per epoch) and to determinism.  The sampled K-step call is held bitwise
to the port's K-step call fed the same indices stacked on the host
(dropout on, one generator), the chunk plan to the JAX function, and a
resumed device-sampled Trainer bitwise to an uninterrupted run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.data import TSNLoader as JaxTSNLoader
from ta3n_tpu.data.device_sampler import DeviceSampler as JaxDeviceSampler
from ta3n_tpu.data.device_sampler import \
    StreamingDeviceSampler as JaxStreamingDeviceSampler
from ta3n_tpu.data.device_sampler import \
    plan_zip_shard_chunks as jax_plan_zip_shard_chunks
from ta3n_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from ta3n_tpu.data.streaming import ShardPlan as JaxShardPlan
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore, TSNLoader, make_domain_pair
from ta3n_tpu_torch.data.device_sampler import (DeviceSampler,
                                                StreamingDeviceSampler,
                                                plan_zip_shard_chunks)
from ta3n_tpu_torch.data.streaming import ShardPlan
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_multi_train_step,
                                  make_sampled_multi_step)
from ta3n_tpu_torch.train.loop import Trainer

SEG, FDIM = 3, 16


def _loader(store, bs, mode="test", shuffle=False, seed=1, pad_to=None,
            cls=TSNLoader, **kw):
    return cls(store, batch_size=bs, num_segments=SEG, mode=mode,
               shuffle=shuffle, seed=seed, pad_to=pad_to, **kw)


def _frames_store(lengths, dim=8, streams=None, seed=3, cls=FeatureStore):
    rng = np.random.default_rng(seed)
    shape = (dim,) if streams is None else (streams, dim)
    feats = [rng.normal(size=(n, *shape)).astype(np.float32)
             for n in lengths]
    return cls.from_arrays(feats, [f"v{v}" for v in range(len(lengths))],
                           [int(rng.integers(0, 3)) for _ in lengths])


def _jax_batch(sampler, step):
    return [np.asarray(a) for a in sampler.batch(jnp.asarray(step))]


@pytest.mark.parametrize("mode", ["test", "val"])
def test_deterministic_modes_match_host_and_jax_bitwise(mode):
    src, _, _ = make_domain_pair(num_source=23, num_target=8, num_val=8,
                                 num_class=3, feature_dim=FDIM)
    host = _loader(src, bs=6, mode=mode)
    dev = DeviceSampler(_loader(src, bs=6, mode=mode), seed=0)
    ref = JaxDeviceSampler(_loader(src, bs=6, mode=mode, cls=JaxTSNLoader),
                           seed=0)
    for step, hb in enumerate(host.index_epoch()):
        idx, lab, mask = dev.batch(step)
        assert idx.dtype == torch.int32 and idx.is_contiguous()
        for got, want in zip((idx, lab, mask), (hb.abs_indices, hb.labels,
                                                hb.mask)):
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{mode} step {step}")
        for got, want in zip((idx, lab, mask), _jax_batch(ref, step)):
            np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < dev.end <= src.offsets[-1]


@pytest.mark.parametrize("mode", ["test", "val"])
def test_deterministic_parity_seg7_float64_rounding_cases(mode):
    """At S = 7 the float64 central formula lands just below integer
    boundaries for some num_frames (nf = 12): the device sampler gives
    the host's frames, and the JAX sampler's."""
    lengths = list(range(8, 40)) + [12, 19, 26]
    store = _frames_store(lengths)
    jstore = _frames_store(lengths, cls=JaxFeatureStore)

    def loader(s, cls):
        return cls(s, batch_size=5, num_segments=7, mode=mode,
                   shuffle=False)

    host = loader(store, TSNLoader)
    dev = DeviceSampler(loader(store, TSNLoader), seed=0)
    ref = JaxDeviceSampler(loader(jstore, JaxTSNLoader), seed=0)
    for step, hb in enumerate(host.index_epoch()):
        idx = dev.batch(step)[0].numpy()
        np.testing.assert_array_equal(idx, hb.abs_indices,
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(idx, _jax_batch(ref, step)[0])


def test_pad_to_rows_masked_like_host():
    src, _, _ = make_domain_pair(num_source=10, num_target=8, num_val=8,
                                 num_class=3, feature_dim=FDIM)
    host = _loader(src, bs=4, pad_to=8)
    dev = DeviceSampler(_loader(src, bs=4, pad_to=8), seed=0)
    for step, hb in enumerate(host.index_epoch()):
        idx, lab, mask = dev.batch(step)
        assert idx.shape == (8, SEG)
        np.testing.assert_array_equal(idx.numpy(), hb.abs_indices)
        np.testing.assert_array_equal(lab.numpy(), hb.labels)
        np.testing.assert_array_equal(mask.numpy(), hb.mask)
        assert mask[4:].sum() == 0


def test_shuffled_epoch_covers_every_record_once():
    """A shuffled epoch visits every record once, epochs differ, and an
    epoch's order is a function of (seed, epoch) alone."""
    src, _, _ = make_domain_pair(num_source=23, num_target=8, num_val=8,
                                 num_class=3, feature_dim=FDIM)
    dev = DeviceSampler(_loader(src, bs=6, shuffle=True), seed=3)
    orders = [dev.epoch_order(e) for e in range(4)]
    for order in orders:
        assert sorted(order.tolist()) == list(range(23))
    assert len({tuple(o.tolist()) for o in orders}) == 4
    again = DeviceSampler(_loader(src, bs=6, shuffle=True), seed=3)
    assert torch.equal(again.epoch_order(2), orders[2])
    other = DeviceSampler(_loader(src, bs=6, shuffle=True), seed=4)
    assert not torch.equal(other.epoch_order(2), orders[2])
    seen = []
    for step in range(dev.steps_per_epoch, 2 * dev.steps_per_epoch):
        idx, _, mask = dev.batch(step)
        rows = idx[mask > 0, 0].tolist()
        seen.extend(int(np.searchsorted(src.offsets, r, side="right")) - 1
                    for r in rows)
    assert sorted(seen) == list(range(23))


def test_random_mode_bounds_and_alignment():
    """Random offsets lie in their video and in their segment's chunk;
    where a video is shorter than the segments they are sorted; steps
    draw anew; the sampler's bound covers every index."""
    lengths = [int(n) for n in
               np.random.default_rng(5).integers(1, 30, 40)] + [1, 2, 3]
    store = _frames_store(lengths)
    dev = DeviceSampler(_loader(store, bs=len(lengths), mode="random"),
                        seed=5)
    nf = np.asarray(lengths)
    offs = np.asarray(store.offsets[:-1])
    draws = []
    for step in range(3):
        idx, _, mask = dev.batch(step)
        local = idx.numpy() - offs[:, None]
        draws.append(local)
        assert idx.max() < dev.end == int(store.offsets[-1])
        avg = nf // SEG
        for v in range(len(lengths)):
            assert (local[v] >= 0).all() and (local[v] < max(nf[v], 1)).all()
            if avg[v] > 0:  # segment s in [s*avg, (s+1)*avg)
                np.testing.assert_array_equal(local[v] // avg[v],
                                              np.arange(SEG))
            elif nf[v] > SEG:
                assert (np.diff(local[v]) >= 0).all()
            else:
                assert (local[v] == 0).all()
    assert not np.array_equal(draws[0], draws[1])


def test_flow_new_length_matches_host():
    """A two-stream store at new_length 5: the device sampler's index
    batches are the host loader's, and the rows they gather are the host
    loader's features."""
    from ta3n_tpu_torch.train.step import device_gather
    lengths = [int(n) for n in np.random.default_rng(7).integers(6, 30, 9)]
    store = _frames_store(lengths, streams=2, seed=7)
    host = _loader(store, bs=4, new_length=5)
    dev = DeviceSampler(_loader(store, bs=4, new_length=5), seed=0)
    table = torch.from_numpy(store.features)
    for step, hb in enumerate(host.epoch()):
        idx, lab, mask = dev.batch(step)
        x = device_gather(table, idx.long()) * mask[:, None, None]
        np.testing.assert_array_equal(x.numpy(), hb.features)
        np.testing.assert_array_equal(lab.numpy(), hb.labels)


def _model_parts(dropout=0.5):
    cfg = ModelConfig(num_class=3, baseline_type="video",
                      frame_aggregation="trn-m", use_attn="TransAttn",
                      train_segments=SEG, val_segments=SEG, fc_dim=16,
                      feature_dim=FDIM, dropout_i=dropout,
                      dropout_v=dropout)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy",
                  place_adv=("Y", "Y", "Y"))
    return cfg, da, TrainConfig(lr=0.1, batch_size=(8, 6, 8))


def _scalars(k):
    return StepScalars([(0.5, 0.5, 0.5)] * k, [0.0] * k, [0.0] * k,
                       [0.01] * k, [0.1 - 0.01 * j for j in range(k)])


@pytest.mark.parametrize("mode", ["test", "random"])
def test_sampled_multi_step_matches_host_stacked(mode):
    """One sampled call of K = 4 steps, across an epoch boundary with
    shuffle on, equals the K-step call fed the sampler's own batches
    stacked on the host: bitwise, dropout on, from one generator seed."""
    src, tgt, _ = make_domain_pair(num_source=24, num_target=18, num_val=8,
                                   num_class=3, feature_dim=FDIM)
    cfg, da, tc = _model_parts()
    k = 4
    samp_s = DeviceSampler(_loader(src, bs=8, mode=mode, shuffle=True),
                           seed=0)
    samp_t = DeviceSampler(_loader(tgt, bs=6, mode=mode, shuffle=True),
                           seed=1)
    spe = min(samp_s.steps_per_epoch, samp_t.steps_per_epoch)
    assert spe < k
    samp_s.steps_per_epoch = samp_t.steps_per_epoch = spe
    stores = [torch.from_numpy(s.features) for s in (src, tgt)]

    def host_batches(sampler):
        b = [sampler.batch(i) for i in range(1, 1 + k)]
        return [torch.stack(x).numpy() for x in zip(*b)]

    states, metrics = [], []
    for sampled in (True, False):
        state = create_train_state(cfg, tc,
                                   torch.Generator().manual_seed(0), "cpu")
        state = state._replace(step=1)
        gen = torch.Generator().manual_seed(7)
        if sampled:
            step = make_sampled_multi_step(state.model, da, tc, samp_s,
                                           samp_t)
            state, m = step(state, stores[0], stores[1], _scalars(k), gen)
        else:
            step = make_multi_train_step(state.model, da, tc)
            state, m = step(state, stores[0], *host_batches(samp_s),
                            stores[1], *host_batches(samp_t), _scalars(k),
                            gen)
        states.append(state)
        metrics.append(m)
    assert states[0].step == states[1].step == 1 + k
    for key in metrics[1]:
        assert metrics[0][key].shape == (k,)
        assert torch.equal(metrics[0][key], metrics[1][key]), key
    for a, b in zip(states[0].model.state_dict().values(),
                    states[1].model.state_dict().values()):
        assert torch.equal(a, b)


def test_sampled_multi_step_needs_one_steps_per_epoch():
    src, tgt, _ = make_domain_pair(num_source=24, num_target=12, num_val=8,
                                   num_class=3, feature_dim=FDIM)
    cfg, da, tc = _model_parts()
    state = create_train_state(cfg, tc, device="cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        make_sampled_multi_step(state.model, da, tc,
                                DeviceSampler(_loader(src, bs=8)),
                                DeviceSampler(_loader(tgt, bs=6)))


@pytest.mark.parametrize("mode", ["test", "val"])
def test_streaming_sampler_matches_host_shard_stream_bitwise(mode):
    """Deterministic mode, shuffle off: the same (shard, batch) walk and
    bitwise the host loader's shard-local batches, and the JAX
    StreamingDeviceSampler's."""
    src, _, _ = make_domain_pair(num_source=23, num_target=8, num_val=8,
                                 num_class=3, feature_dim=FDIM)
    host = _loader(src, bs=6, mode=mode)
    plan = ShardPlan(host.store.offsets, budget_rows=40)
    assert plan.num_shards >= 3
    dev = StreamingDeviceSampler(_loader(src, bs=6, mode=mode), plan,
                                 seed=0)
    assert dev.end == 40
    ref = JaxStreamingDeviceSampler(
        _loader(src, bs=6, mode=mode, cls=JaxTSNLoader),
        JaxShardPlan(src.offsets, budget_rows=40), seed=0)
    walk = [(sid, j) for sid in range(dev.num_shards)
            for j in range(dev.shard_steps(sid))]
    host_stream = list(host.shard_index_epoch(plan))
    assert len(walk) == len(host_stream)
    for step, ((sid, j), (hsid, hb)) in enumerate(zip(walk, host_stream)):
        assert sid == hsid
        got = dev.shard_batch(sid, j, dev.shard_order(sid, 0), step)
        want = ref.shard_batch(jnp.asarray(sid), jnp.asarray(j),
                               ref.shard_order(jnp.asarray(sid),
                                               jnp.asarray(0)),
                               jnp.asarray(step))
        for g, h, w in zip(got, (hb.abs_indices, hb.labels, hb.mask), want):
            np.testing.assert_array_equal(g.numpy(), h,
                                          err_msg=f"shard {sid} batch {j}")
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_streaming_sampler_shuffle_covers_every_record_once():
    src, _, _ = make_domain_pair(num_source=23, num_target=8, num_val=8,
                                 num_class=3, feature_dim=FDIM)
    ld = _loader(src, bs=6, mode="random", shuffle=True)
    plan = ShardPlan(ld.store.offsets, budget_rows=40)
    dev = StreamingDeviceSampler(ld, plan, seed=0)
    seen = []
    for sid in range(dev.num_shards):
        count = int(dev.shard_counts_host[sid])
        order = dev.shard_order(sid, 1)
        assert sorted(order[:count].tolist()) == list(range(count))
        recs = dev.groups[sid][order[:count]].tolist()
        seen.extend(recs)
        # every index of the shard's batches is shard-local and in bounds
        for j in range(dev.shard_steps(sid)):
            idx, _, mask = dev.shard_batch(sid, j, order, 5)
            rows = idx[mask > 0]
            assert rows.min() >= 0 and rows.max() < plan.row_hi[sid] - \
                plan.row_lo[sid]
    assert sorted(seen) == list(range(23))
    big = int(np.argmax(dev.shard_counts_host))
    assert int(dev.shard_counts_host[big]) >= 2
    orders = {tuple(dev.shard_order(big, e).tolist()) for e in range(8)}
    assert len(orders) > 1


def test_zip_shard_chunk_plan_matches_jax():
    src, tgt, _ = make_domain_pair(num_source=23, num_target=17, num_val=8,
                                   num_class=3, feature_dim=FDIM)
    ls, lt = _loader(src, bs=6), _loader(tgt, bs=4)
    ds = StreamingDeviceSampler(ls, ShardPlan(src.offsets, 40), seed=0)
    dt = StreamingDeviceSampler(lt, ShardPlan(tgt.offsets, 40), seed=0)
    jls, jlt = (_loader(s, bs=b, cls=JaxTSNLoader)
                for s, b in ((src, 6), (tgt, 4)))
    jds = JaxStreamingDeviceSampler(jls, JaxShardPlan(src.offsets, 40))
    jdt = JaxStreamingDeviceSampler(jlt, JaxShardPlan(tgt.offsets, 40))
    for k in (1, 3, 5):
        chunks = plan_zip_shard_chunks(ds, dt, steps_per_call=k)
        assert chunks == jax_plan_zip_shard_chunks(jds, jdt, k)
        n_s = sum(ds.shard_steps(s) for s in range(ds.num_shards))
        n_t = sum(dt.shard_steps(s) for s in range(dt.num_shards))
        assert sum(c[4] for c in chunks) == min(n_s, n_t)
        for sid_s, j0_s, sid_t, j0_t, n in chunks:
            assert 1 <= n <= k
            assert j0_s + n <= ds.shard_steps(sid_s)
            assert j0_t + n <= dt.shard_steps(sid_t)


def test_resume_bitwise_matches_uninterrupted_run(tmp_path):
    """Checkpoint after epoch 2 and resume == one straight 4-epoch run,
    parameter-bitwise, in the device-sampled mode with dropout and random
    sampling: the step counter keys the epochs, orders and offsets, and
    the checkpoint holds the dropout generator's state."""
    src, tgt, val = make_domain_pair(num_source=24, num_target=18,
                                     num_val=12, num_class=3,
                                     feature_dim=FDIM, shift=0.8)
    cfg, da, _ = _model_parts(dropout=0.2)

    def trainer(exp):
        tc = TrainConfig(lr=0.05, epochs=4, batch_size=(8, 6, 8),
                         beta=(-1.0, -1.0, -1.0), lr_adaptive="dann")
        ls = TSNLoader(src, batch_size=8, num_segments=SEG, mode="random",
                       seed=1)
        lt = TSNLoader(tgt, batch_size=6, num_segments=SEG, mode="random",
                       seed=2)
        lv = TSNLoader(val, batch_size=8, num_segments=SEG, shuffle=False)
        return Trainer(cfg, da, tc, ls, lt, lv, path_exp=exp,
                       device_store=True, steps_per_call=2,
                       device_sampler=True, eval_freq=10, print_freq=100,
                       show_freq=100, save_model=True, seed=0, device="cpu")

    straight = trainer(str(tmp_path / "a") + "/")
    assert straight.sampled_step is not None
    straight.fit()

    first = trainer(str(tmp_path / "b") + "/")
    validate = first.validate

    def validate_then_interrupt(epoch):
        prec1 = validate(epoch)
        if epoch == 2:
            raise KeyboardInterrupt("preempted")
        return prec1

    first.eval_freq = 2
    first.validate = validate_then_interrupt
    with pytest.raises(KeyboardInterrupt):
        first.fit()  # emergency checkpoint at epoch 2
    resumed = trainer(str(tmp_path / "b") + "/")
    resumed.resume(str(tmp_path / "b" / "checkpoint.pth.tar"),
                   resume_hp=True)
    assert resumed.state.step == first.state.step == 6
    resumed.fit()
    assert straight.state.step == resumed.state.step == 12
    for a, b in zip(straight.state.model.state_dict().values(),
                    resumed.state.model.state_dict().values()):
        assert torch.equal(a, b)
