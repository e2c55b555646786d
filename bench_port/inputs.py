"""The benchmark's inputs, made from ``--seed``: the feature stores and
the members' initial weights, both on the device in a few large calls,
and the seeds of the members' dropout generators.  Both sides, the port
and the plain reference, are handed the same inputs; neither makes them.

The stores follow `ta3n_tpu_torch/data/synthetic.py`'s recipe at the
published split sizes: each video's label and frame count (8-40) drawn
on the host, its frames class-conditional Gaussian features (a class
centroid, the domain's shift, unit noise), drawn on the device.  The
labels and frame counts are drawn once for every seed, and the seed
chooses their order: every seed makes stores of the same size, laid out
alike in device memory, and only the features and the weights differ.  The
weights follow the reference's init policy (`reference/ta3n.py`'s
``param_specs``): one normal draw for every normal(0, 0.001) leaf and one
uniform draw for every U(+-1/sqrt(fan_in)) leaf, of every seed of the
sweep at once; the members that share a seed share its weights.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

# stream tags: each input has its own generator
_TAGS = {"source": 1, "target": 2, "val": 3, "centroids": 4, "shift": 5,
         "weights": 6, "dropout": 7}


def seed_for(seed: int, *tags: int) -> int:
    """A 63-bit generator seed of the run seed and the tags."""
    a, b = np.random.SeedSequence([int(seed), *map(int, tags)]) \
        .generate_state(2, np.uint32)
    return ((int(a) << 32) | int(b)) & ((1 << 63) - 1)


class Split(NamedTuple):
    """One split's videos: offsets [V+1] and labels [V] (host, int64),
    and the frame rows [total_frames, D] float32 on the device."""

    offsets: np.ndarray
    labels: np.ndarray
    rows: torch.Tensor


def make_splits(seed: int, data: dict, num_class: int, feature_dim: int,
                device) -> dict:
    """{"source", "target", "val"}: `Split`s of the configured sizes; the
    target and val domains shifted by ``data["shift"]``."""
    g = torch.Generator(device).manual_seed(
        seed_for(seed, _TAGS["centroids"]))
    centroids = torch.randn(num_class, feature_dim, generator=g,
                            device=device)
    g.manual_seed(seed_for(seed, _TAGS["shift"]))
    shift = torch.randn(feature_dim, generator=g, device=device) \
        * float(data["shift"])
    out = {}
    for name, key in (("source", "num_source"), ("target", "num_target"),
                      ("val", "num_val")):
        n = int(data[key])
        sizes = np.random.default_rng([_TAGS[name]])
        labels = sizes.integers(0, num_class, n).astype(np.int64)
        frames = sizes.integers(int(data["min_frames"]),
                                int(data["max_frames"]) + 1, n)
        order = np.random.default_rng([int(seed), _TAGS[name]]).permutation(n)
        labels, frames = labels[order], frames[order]
        offsets = np.zeros(n + 1, np.int64)
        offsets[1:] = np.cumsum(frames)
        g.manual_seed(seed_for(seed, _TAGS[name]))
        rows = torch.randn(int(offsets[-1]), feature_dim, generator=g,
                           device=device)
        row_label = torch.as_tensor(np.repeat(labels, frames),
                                    device=device)
        rows += centroids.index_select(0, row_label)
        if name != "source":
            rows += shift
        out[name] = Split(offsets, labels, rows)
    return out


class Spec(NamedTuple):
    """One parameter: its name, shape and init ("normal001", "zero" or
    "uniform", the last with its bound)."""

    name: str
    shape: tuple
    init: str
    bound: float = 0.0


def make_weights(specs: Sequence[Spec], seed_index: Sequence[int],
                 seed: int, device) -> dict:
    """{name: [N, *shape] float32} for N members, member k taking the
    weights of sweep seed ``seed_index[k]``: one normal and one uniform
    draw over every seed, then each leaf cut out and given to its
    members."""
    n_seeds = max(seed_index) + 1
    g = torch.Generator(device).manual_seed(seed_for(seed, _TAGS["weights"]))
    sizes = {kind: sum(int(np.prod(s.shape)) for s in specs
                       if s.init == kind)
             for kind in ("normal001", "uniform")}
    draws = {"normal001": torch.randn(n_seeds, sizes["normal001"],
                                      generator=g, device=device),
             "uniform": torch.rand(n_seeds, sizes["uniform"],
                                   generator=g, device=device)}
    members = torch.as_tensor(list(seed_index), device=device)
    offset = {"normal001": 0, "uniform": 0}
    out = {}
    for s in specs:
        shape = (len(seed_index),) + tuple(s.shape)
        if s.init == "zero":
            out[s.name] = torch.zeros(shape, device=device)
            continue
        size = int(np.prod(s.shape))
        start = offset[s.init]
        offset[s.init] = start + size
        leaf = draws[s.init][:, start:start + size].index_select(0, members)
        if s.init == "normal001":
            leaf.mul_(0.001)
        else:
            leaf.mul_(2.0 * s.bound).sub_(s.bound)
        out[s.name] = leaf.reshape(shape)
    return out


def dropout_seeds(seed: int, seed_index: Sequence[int]) -> list:
    """Member k's dropout generator seed: its sweep seed's."""
    return [seed_for(seed, _TAGS["dropout"], i) for i in seed_index]
