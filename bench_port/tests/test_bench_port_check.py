"""The correctness check at a size the CPU holds: a sound run of the port
is correct under each cell's limits, and the control (the reference at
TF32 in the program's place) and each fault that a one-card training
cell can have, planted underneath the timed path, are not: the faults of
every member and those confined to some members.  The card's
own run of the control is the last test, skipped without a card."""

import time

import numpy as np
import pytest
import torch

from bench_port import check, control, manifest
from bench_port.tests.small import small_cell

CELLS = ("ucf_hmdb_full", "tempooling_revgrad")
SEED = 2 ** 31 + 99


def _limits(config):
    return manifest.resolve(f"{config}.sweep")["limits"]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("config", CELLS)
def test_sound_run_is_correct(config):
    """The rest of a run, its look for a card skipped: set-up, a short
    window, the reference."""
    cell = small_cell(config)
    r = manifest.driver("sweep").run(cell, SEED, 0.2, False, "cpu",
                                     time.time(), print)
    correct, checks = check.verdict(r["readings"], _limits(config))
    assert correct, checks
    assert r["failed"] == 0 and r["attempted"] == r["steps"] * 8


def test_videos_counted_without_padding():
    """train_videos_per_s counts the real source videos of each batch,
    summed over the members: 37 a member an epoch, not 5 batches of 8."""
    cell = small_cell("ucf_hmdb_full")
    cell["model"]["data"]["num_source"] = 37
    r = manifest.driver("sweep").run(cell, SEED, 0.2, False, "cpu",
                                     time.time(), print)
    epochs = r["steps"] // 5
    assert r["steps"] == 5 * epochs
    assert r["end_to_end"]["train_videos_per_s"] * r["window_s"] == \
        pytest.approx(epochs * 37 * 8)


def test_every_seed_has_the_same_sizes():
    """Two seeds make stores of the same videos' labels and frame counts,
    in another order, and of other features."""
    from bench_port import inputs
    data = small_cell()["model"]["data"]
    a, b = (inputs.make_splits(s, data, 4, 16, "cpu") for s in (SEED, 7))
    for name in ("source", "target", "val"):
        fa, fb = np.diff(a[name].offsets), np.diff(b[name].offsets)
        assert sorted(zip(fa, a[name].labels)) == \
            sorted(zip(fb, b[name].labels))
        assert not np.array_equal(fa, fb)
        assert a[name].rows.shape == b[name].rows.shape
        assert not torch.equal(a[name].rows, b[name].rows)


def test_verdict_judges_what_the_driver_read():
    """Every reading needs its limit and every limit its reading, whatever
    the driver's numbers are named; a null limit reports without judging."""
    assert check.verdict({"a": 1.0, "b": 9.0}, {"a": 2.0, "b": None})[0]
    assert not check.verdict({"a": 3.0}, {"a": 2.0})[0]
    assert not check.verdict({"a": 1.0, "c": 0.0}, {"a": 2.0})[0]
    ok, checks = check.verdict({"a": 1.0}, {"a": 2.0, "d": 1.0})
    assert not ok and checks["d"]["limit"] == 1.0
    assert not check.verdict({"a": float("nan")}, {"a": None})[0]


@pytest.mark.parametrize("config", CELLS)
@pytest.mark.parametrize("what", ("control",) + control.FAULTS)
def test_control_and_faults_are_not_correct(config, what):
    cell = small_cell(config)
    r = control.reading(cell, SEED, what, "cpu")
    correct, checks = check.verdict(r["readings"], _limits(config))
    assert not correct, checks


@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_through_a_whole_run(fault):
    """The harness's own run, with a fault planted under the timed path,
    reads correct false."""
    cell = small_cell("ucf_hmdb_full")
    with control.planted(fault):
        r = manifest.driver("sweep").run(cell, SEED, 0.2, False, "cpu",
                                         time.time(), print)
    assert not check.verdict(r["readings"], _limits("ucf_hmdb_full"))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("config", CELLS)
def test_control_on_the_card(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell(config)
    dev = torch.device("cuda", 0)
    sound = control.reading(cell, SEED, "program", dev)
    assert check.verdict(sound["readings"], _limits(config))[0]
    ctl = control.reading(cell, SEED, "control", dev)
    assert not check.verdict(ctl["readings"], _limits(config))[0]
