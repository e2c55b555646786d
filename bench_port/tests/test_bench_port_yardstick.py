"""The yardstick's counts against hand counts, and the trace reader on a
trace written by hand."""

import pytest

from bench_port import trace, yardstick


def test_trn_work_hand_counts():
    # K2 at B = 202, S = 5, D = 512, H = 256: subsets of 5 + 3x4 + 3x3 +
    # 3x2 = 32 frames, 2 products forward, 4 backward (PERF.md, 3.39 GFLOP)
    flops, nbytes = yardstick.trn_work(202)["trn_fused_bwd"]
    assert flops == 4 * 202 * 256 * 512 * 32 == 3_388_997_632
    x = 4 * 202 * 5 * 512
    out = 4 * 202 * 4 * 256
    masks = 202 * 10 * 256
    w = 4 * 256 * 512 * 14
    assert nbytes == 2 * x + out + masks + 2 * w + 4 * 256 * 4
    assert yardstick.trn_work(202)["trn_fused_fwd"][0] == flops // 2


def test_k3_work_hand_counts():
    flops, nbytes = yardstick.k3_work(640, 2048, 512, 8, True)
    assert flops == 2 * 640 * 2048 * 512 * 8
    assert nbytes == (4 * 640 * 2048 + 8 * 640 + 4 * 8 * 512 * 2048
                      + 4 * 8 * 640 * 512 + 4 * 640 * 2048)
    assert yardstick.k3_work(320, 2048, 512, 1, False)[1] == (
        4 * 320 * 2048 + 8 * 320 + 4 * 512 * 2048 + 4 * 320 * 512)


def test_bound():
    ms, what = yardstick.bound(165e9, 1e6, yardstick.PEAK_F32)
    assert what == "operations" and ms == pytest.approx(1.0)
    ms, what = yardstick.bound(1.0, 3.35e9, yardstick.PEAK_F32)
    assert what == "bytes" and ms == pytest.approx(1.0)


FLAGSHIP = dict(feature_dim=2048, fc_dim=512, num_class=12,
                train_segments=5, frame_aggregation="trn-m")


def test_step_flops_hand_count():
    b, r = 202, 1010
    first = 2 * r * 2048 * 512
    trn = 2 * b * 256 * 512 * 32
    heads = (2 * r * 512 * 512 + 2 * r * 512 * 2 + 2 * b * 256 * 12
             + 2 * b * 256 * 256 + 2 * b * 256 * 2
             + 4 * (2 * b * 256 * 256 + 2 * b * 256 * 2))
    assert yardstick.step_flops(FLAGSHIP, (128, 74, 128), "train") == \
        2 * first + 3 * (trn + heads)
    pool = dict(FLAGSHIP, frame_aggregation="avgpool")
    assert yardstick.step_flops(pool, (128, 74, 128), "eval") == (
        2 * 640 * 2048 * 512 + 2 * 640 * 512 * 512 + 2 * 640 * 512 * 2
        + 2 * 128 * 512 * 12 + 2 * 128 * 512 * 512 + 2 * 128 * 512 * 2)


@pytest.mark.parametrize("model", [FLAGSHIP,
                                   dict(FLAGSHIP,
                                        frame_aggregation="avgpool")])
def test_members_flops_are_n_solo(model):
    solo = yardstick.window_flops(model, (128, 74, 128), 36, 9, 1)
    for n in (8, 32, 128):
        assert yardstick.window_flops(model, (128, 74, 128), 36, 9, n) == \
            n * solo


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read_trace_by_hand():
    key = "m:f"
    events = [
        _ev("bench::window", "user_annotation", 0, 100),
        _ev("bench::train_call", "user_annotation", 0, 60),
        _ev("aten::mm", "cpu_op", 5, 20),
        _ev(f"bench_range::{key}", "user_annotation", 30, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 32, 1, corr=7),
        _ev("cudaLaunchKernel", "cuda_runtime", 35, 1, corr=8),
        _ev("cudaLaunchKernel", "cuda_runtime", 50, 1, corr=9),
        _ev("void k2_kernel<float>(int)", "kernel", 40, 10, tid=7, corr=7),
        _ev("k2_stage_a", "kernel", 45, 10, tid=7, corr=8),
        _ev("other", "kernel", 70, 10, tid=7, corr=9),
        _ev("bench::val", "user_annotation", 60, 40),
        _ev(f"bench_range::{key}", "gpu_user_annotation", 40, 15, tid=7),
        _ev("bench::window", "gpu_user_annotation", 40, 40, tid=7),
    ]
    t = trace.read_trace(events, [key])
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(25e-6)   # [40, 55) and [70, 80)
    assert t["kernels"] == 3
    assert t["range_times"][key] == [pytest.approx(20e-6)]
    assert dict(t["device_ops"])["k2_kernel"] == pytest.approx(10e-6)
    gaps = dict(t["idle_gaps"])
    # [0, 40): middle 20, inside aten::mm in the train call; [55, 70):
    # middle 62.5, the val phase; [80, 100): middle 90, val
    assert gaps["train_call:aten::mm"] == pytest.approx(40e-6)
    assert gaps["val:python"] == pytest.approx(35e-6)


def test_device_busy_by_hand():
    """The device's busy time is the union of its kernel, copy and set
    intervals, whatever the host did."""
    events = [
        _ev("cudaLaunchKernel", "cuda_runtime", 0, 1, corr=1),
        _ev("a", "kernel", 10, 10, tid=7),
        _ev("b", "kernel", 15, 10, tid=8),
        _ev("Memcpy HtoD", "gpu_memcpy", 40, 5, tid=7),
        _ev("Memset", "gpu_memset", 44, 2, tid=7),
        _ev("bench::window", "gpu_user_annotation", 0, 100, tid=7),
    ]
    # [10, 25) and [40, 46)
    assert trace.device_busy(events) == pytest.approx(21e-6)
