"""The yardstick: the card's peaks, the work of the port's kernels and of
a whole step from their shapes, and a kernel's least time.

``trn_work``, ``bound`` and the peaks are frozen copies of
``chip_smoke.py``'s (``trn_work`` :835-857, ``bound`` :860-866, the peaks
:363-364 and :387), which the benchmark does not import; K3's work and the step's
are added here.  Every input byte is counted once and every output byte
once.
"""

from __future__ import annotations

import itertools
import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# float32 products run as three TF32 tensor-core products (3xTF32)
PEAK_F32 = PEAK_TF32 / 3
PEAK_BY_DTYPE = {"float32": PEAK_F32, "bfloat16": PEAK_BF16}


def relation_plan(s: int, subsample: int = 3) -> tuple:
    """(scales, subsets per scale) of the multi-scale TRN over S frames:
    scales S..2, the largest with its one full subset, the others
    min(3, C(S, k)) of the k-frame combinations."""
    scales = list(range(s, 1, -1))
    subsets = []
    for j, k in enumerate(scales):
        total = math.comb(s, k)
        n = 1 if j == 0 else min(subsample, total)
        combos = list(itertools.combinations(range(s), k))
        subsets.append([combos[math.ceil(i * total / n)] for i in range(n)])
    return scales, subsets


def trn_work(b, s=5, d=512, h=256, esize=4) -> dict:
    """FLOPs and the least bytes of the TRN kernels at these shapes, with
    x, the weights, the biases, g and the outputs of ``esize`` bytes: each
    input read once, each output written once."""
    scales, subsets = relation_plan(s)
    n_sub = sum(len(sub) for sub in subsets)
    flops = 2 * b * h * d * sum(len(sub) * k
                                for k, sub in zip(scales, subsets))
    w_bytes = esize * h * d * sum(scales)
    b_bytes = esize * h * len(scales)
    x_bytes, out_bytes = esize * b * s * d, esize * b * (s - 1) * h
    mask_bytes = b * n_sub * h
    fwd_bytes = x_bytes + w_bytes + b_bytes + out_bytes
    return {
        "trn_fused_fwd": (flops, fwd_bytes),
        "trn_fused_fwd_train": (flops, fwd_bytes + mask_bytes),
        # x, g (the size of out), masks and W in; dx, dW and db out
        "trn_fused_bwd": (2 * flops, 2 * x_bytes + out_bytes + mask_bytes
                          + 2 * w_bytes + b_bytes),
    }


def k3_work(m: int, d: int, h: int, members: int = 1,
            with_rows: bool = True, esize: int = 4) -> tuple:
    """(FLOPs, bytes) of K3 over ``members`` weights: M rows gathered from
    the store (read once, shared by the members) with their int32 indices
    and their scales, each member's weight [H, D] read, each member's z
    [M, H] written, and the gathered rows x_res [M, D] written when kept
    for the backward."""
    flops = 2 * m * d * h * members
    nbytes = (esize * m * d + 4 * m + 4 * m + esize * members * h * d
              + esize * members * m * h + (esize * m * d if with_rows else 0))
    return flops, nbytes


def bound(flops, nbytes, peak_ops) -> tuple:
    """The least time the card could take, in ms, and what sets it."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def step_flops(model: dict, batch, kind: str) -> int:
    """The matrix products' FLOPs of one member's train step (``kind``
    "train", at batch[0] + batch[1] videos: forward, and backward with
    the gradients of every weight and of every activation but the input
    features) or of one validation batch ("eval", batch[2] videos,
    forward).  Elementwise work is not counted; padded rows are, as the
    fixed batch shapes compute them."""
    d = int(model["feature_dim"])
    sh = min(int(model["fc_dim"]), d)
    c = int(model["num_class"])
    s = int(model["train_segments"])
    trn = model["frame_aggregation"] == "trn-m"
    agg = 256 if trn else sh
    b = batch[0] + batch[1] if kind == "train" else batch[2]
    r = b * s
    first = 2 * r * d * sh
    layers = (2 * r * sh * sh + 2 * r * sh * 2          # frame domain head
              + 2 * b * agg * c                          # video classifier
              + 2 * b * agg * agg + 2 * b * agg * 2)    # video domain head
    if trn:
        layers += trn_work(b, s, sh, 256)["trn_fused_fwd"][0]
        layers += (s - 1) * (2 * b * 256 * agg + 2 * b * agg * 2)
    if kind == "eval":
        return first + layers
    # backward: dW of the first FC; dx and dW of every other layer
    return 2 * first + 3 * layers


def window_flops(model: dict, batch, steps: int, val_batches: int,
                 members: int) -> int:
    """The matrix products' FLOPs of ``steps`` train steps and
    ``val_batches`` validation batches of ``members`` members: a member's
    work times the members, which share nothing but the inputs."""
    return members * (steps * step_flops(model, batch, "train")
                      + val_batches * step_flops(model, batch, "eval"))
