"""Plain reference of a TA3N sweep's first steps, in float32 PyTorch.

It follows the published model and recipe (Chen et al., ICCV 2019;
cmhungsteve/TA3N ``models.py``, ``TRNmodule.py``, ``main.py``,
``dataset.py``) from the benchmark's inputs alone: the stores' rows and
layout, the initial weights and the dropout generators' seeds.  It
imports nothing of the port and reads nothing the port made; it works
out again the loader's batches, the TRN's subsets, the dropout masks, the
forward, the losses, the gradients and the SGD steps.

Members are computed in blocks, each parameter stacked [members, ...],
every product a batched ``matmul``.  ``mm`` is the product that every
Linear and TRN scale goes through, forward and backward: ``matmul`` with
TF32 off for the reference, or the TF32 control (``tf32_matmul``).

Departures from the published code, each shared with the port by
design: padded videos (the last batch of an epoch) carry a zero row
weight instead of dummy rows; the TRN's subsets are the reference's
evenly spaced selection, fixed rather than drawn per forward.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from bench_port.inputs import Spec

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ---- parameters -------------------------------------------------------

def _dims(model: dict) -> tuple:
    """(D, shared, aggregated, relations) of a configuration."""
    d = int(model["feature_dim"])
    sh = min(int(model["fc_dim"]), d)
    trn = model["frame_aggregation"] == "trn-m"
    agg = 256 if trn else sh
    return d, sh, agg, (int(model["train_segments"]) - 1 if trn else 0)


def _supported(model: dict, da: dict) -> None:
    ok = (model["baseline_type"] == "video" and int(model["add_fc"]) == 1
          and model["share_params"] == "Y" and model["use_bn"] == "none"
          and model["use_attn_frame"] == "none"
          and model["frame_aggregation"] in ("trn-m", "avgpool")
          and model["use_attn"] in ("TransAttn", "none")
          and model.get("before_softmax", True)
          and da.get("dis_DA", "none") == "none"
          and da.get("ens_DA", "none") == "none"
          and da.get("pred_normalize", "N") == "N"
          and da["use_target"] == "uSv")
    if not ok:
        raise ValueError("the plain reference covers the video baseline "
                         "with trn-m or avgpool, TransAttn or none, uSv, "
                         "RevGrad and attentive entropy")


def param_specs(model: dict) -> List[Spec]:
    """Every parameter, by the reference's state_dict names, with the
    reference's init: normal(0, 0.001) and a zero bias for the Linears its
    init loop touches; torch's default U(+-1/sqrt(fan_in)), weight and
    bias, for the TRN's fusion layers and the relation domain heads."""
    d, sh, agg, rel = _dims(model)
    c = int(model["num_class"])
    specs = []

    def n001(name, i, o):
        specs.extend([Spec(f"{name}.weight", (o, i), "normal001"),
                      Spec(f"{name}.bias", (o,), "zero")])

    def default(name, i, o):
        b = 1.0 / math.sqrt(i)
        specs.extend([Spec(f"{name}.weight", (o, i), "uniform", b),
                      Spec(f"{name}.bias", (o,), "uniform", b)])

    n001("fc_feature_shared_source", d, sh)
    n001("fc_feature_domain", sh, sh)
    n001("fc_classifier_domain", sh, 2)
    n001("fc_classifier_source", sh, c)
    if rel:
        for i, k in enumerate(_scales(int(model["train_segments"]))):
            default(f"TRN.fc_fusion_scales.{i}.1", k * sh, 256)
        for i in range(rel):
            default(f"relation_domain_classifier_all.{i}.0", 256, agg)
            default(f"relation_domain_classifier_all.{i}.2", agg, 2)
    n001("fc_classifier_video_source", agg, c)
    n001("fc_feature_domain_video", agg, agg)
    n001("fc_classifier_domain_video", agg, 2)
    return specs


def _scales(s: int) -> list:
    return list(range(s, 1, -1))


def relation_subsets(s: int, subsample: int = 3) -> list:
    """TRNmodule.py:27-86: per scale k = S..2 the k-frame combinations in
    lexicographic order; the largest scale takes the one full subset,
    every other min(3, C(S, k)) at indices ceil(i * C / n)."""
    out = []
    for j, k in enumerate(_scales(s)):
        combos = list(itertools.combinations(range(s), k))
        n = 1 if j == 0 else min(subsample, len(combos))
        out.append([combos[int(math.ceil(i * len(combos) / n))]
                    for i in range(n)])
    return out


# ---- the loader's batches ---------------------------------------------

class Batch(NamedTuple):
    rows: np.ndarray     # [B, S] absolute frame rows
    labels: np.ndarray   # [B]
    mask: np.ndarray     # [B] 0/1


def _central(num_frames: np.ndarray, s: int) -> np.ndarray:
    """dataset.py:103-116 (test mode, new_length 1): the centre of each
    of S equal segments; a video shorter than S enumerates its frames and
    repeats the last."""
    tick = num_frames.astype(np.float64) / s
    centre = (tick[:, None] / 2.0 + tick[:, None]
              * np.arange(s)[None, :]).astype(np.int64)
    short = np.minimum(np.arange(s)[None, :], num_frames[:, None] - 1)
    return np.where((num_frames >= s)[:, None], centre, short)


def batches(offsets: np.ndarray, labels: np.ndarray, count: int,
            batch: int, segments: int, shuffle: bool, seed: int,
            epochs: int = 1) -> List[List[Batch]]:
    """main.py:144-200 and dataset.py: the list repeated to ``count``
    videos, a permutation an epoch from numpy's default generator seeded
    ``seed``, batches of ``batch`` with the partial last one padded by
    masked rows that point at row 0."""
    n = len(labels)
    base = np.concatenate([np.tile(np.arange(n), count // n),
                           np.arange(count % n)])
    rng = np.random.default_rng(seed)
    num_frames = np.diff(offsets)
    out = []
    for _ in range(epochs):
        order = rng.permutation(len(base)) if shuffle else \
            np.arange(len(base))
        epoch = []
        for start in range(0, len(order), batch):
            sel = order[start:start + batch]
            real = len(sel)
            sel = np.concatenate([sel, np.zeros(batch - real, sel.dtype)])
            vids = base[sel]
            rows = offsets[vids][:, None] + _central(num_frames[vids],
                                                     segments)
            rows[real:] = 0
            mask = (np.arange(batch) < real).astype(np.float32)
            epoch.append(Batch(rows, labels[vids], mask))
        out.append(epoch)
    return out


def epoch_counts(ns: int, nt: int, bs: int, bt: int, copy_list) -> tuple:
    """main.py:144-153: the streams repeated to the same iteration count
    where copy_list says Y."""
    it = max(ns / bs, nt / bt)
    return (round(it * bs) if copy_list[0] == "Y" else ns,
            round(it * bt) if copy_list[1] == "Y" else nt)


# ---- the model ----------------------------------------------------------

def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as the tensor cores read a float32 operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, forward and
    backward: the control, a float32 model computed at TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32(a), tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        da = torch.matmul(g, tf32(b).transpose(-1, -2))
        db = torch.matmul(tf32(a).transpose(-1, -2), g)
        return (_sum_to(da, a.shape), _sum_to(db, b.shape))


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    while t.dim() > len(shape):
        t = t.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and t.shape[i] != 1:
            t = t.sum(i, keepdim=True)
    return t


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32Matmul.apply(a, b)


class _Reverse(torch.autograd.Function):
    """Gradient reversal (models.py:20-30), each member by its beta."""

    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(beta)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (beta,) = ctx.saved_tensors
        return -beta.reshape((-1,) + (1,) * (g.dim() - 1)) * g, None


def _linear(p: dict, name: str, x: torch.Tensor, mm: Mm) -> torch.Tensor:
    """x [M, ..., in] @ W[M]ᵀ + b[M]: the members' own Linear."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    shape = x.shape
    y = mm(x.reshape(shape[0], -1, shape[-1]), w.transpose(1, 2))
    y = y + b[:, None, :]
    return y.reshape(shape[:-1] + (w.shape[1],))


def _entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(-1)


class Out(NamedTuple):
    logits: torch.Tensor          # [M, B, C]
    domain: tuple                 # relation, video, frame logits


def forward(p: dict, model: dict, x: torch.Tensor, mask: torch.Tensor,
            beta: torch.Tensor, keep: tuple, mm: Mm) -> Out:
    """models.py:545-722 for the video baseline: x [B, S, D] the videos'
    frame rows (source first), mask [B] their weights, beta [M, 3] the
    members' GRL strengths (relation, video, frame), ``keep`` the
    members' dropout keep masks (frame rows, video rows) or None in
    eval."""
    b, s, d = x.shape
    _, sh, _, rel = _dims(model)
    m = beta.shape[0]
    rows = (x * mask[:, None, None]).reshape(1, b * s, d).expand(m, -1, -1)
    f = torch.relu(_linear(p, "fc_feature_shared_source", rows, mm))
    if keep is not None and model["dropout_i"] > 0:
        f = f * keep[0] / (1.0 - model["dropout_i"])
    h = _Reverse.apply(f, beta[:, 2])
    h = torch.relu(_linear(p, "fc_feature_domain", h, mm))
    frame_dom = _linear(p, "fc_classifier_domain", h, mm).reshape(
        m, b, s, 2)
    seg = f.reshape(m, b, s, sh)
    if rel:
        scales = []
        for i, (k, subsets) in enumerate(zip(_scales(s),
                                             relation_subsets(s))):
            total = 0.0
            for sub in subsets:
                g = torch.relu(seg[:, :, list(sub), :].reshape(m, b, k * sh))
                total = total + torch.relu(
                    _linear(p, f"TRN.fc_fusion_scales.{i}.1", g, mm))
            scales.append(total)
        r = torch.stack(scales, dim=2)                     # [M, B, R, H]
        r_rev = _Reverse.apply(r, beta[:, 0])
        rel_dom = torch.stack([
            _linear(p, f"relation_domain_classifier_all.{i}.2", torch.relu(
                _linear(p, f"relation_domain_classifier_all.{i}.0",
                        r_rev[:, :, i], mm)), mm)
            for i in range(rel)], dim=2)                   # [M, B, R, 2]
        if model["use_attn"] == "TransAttn":
            r = (2.0 - _entropy(rel_dom))[..., None] * r
        video = r.sum(dim=2)
    else:
        if model["use_attn"] == "TransAttn":
            seg = (2.0 - _entropy(frame_dom))[..., None] * seg
        video = seg.mean(dim=2)
        rel_dom = None
    if keep is not None and model["dropout_v"] > 0:
        video = video * keep[1] / (1.0 - model["dropout_v"])
    logits = _linear(p, "fc_classifier_video_source", video, mm)
    hv = _Reverse.apply(video, beta[:, 1])
    hv = torch.relu(_linear(p, "fc_feature_domain_video", hv, mm))
    video_dom = _linear(p, "fc_classifier_domain_video", hv, mm)
    return Out(logits, (rel_dom if rel_dom is not None else video_dom,
                        video_dom, frame_dom))


def _ce(logits: torch.Tensor, labels: torch.Tensor,
        w: torch.Tensor) -> torch.Tensor:
    """The row-weighted mean cross entropy of each member [M]."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.reshape(1, -1, 1).expand(logits.shape[0], -1, 1)
    nll = -logp.gather(-1, idx)[..., 0]
    return (w * nll).sum(-1) / w.sum().clamp(min=1e-12)


def _rows(t: torch.Tensor, mask: torch.Tensor) -> tuple:
    """Domain logits [M, B(, L), 2] as rows, the mask repeated per row."""
    if t.dim() == 4:
        mask = mask.repeat_interleave(t.shape[2])
        t = t.reshape(t.shape[0], -1, 2)
    return t, mask


def loss(out: Out, bs: int, ys, ms, yt, mt, da: dict,
         gamma: torch.Tensor) -> torch.Tensor:
    """main.py:437-562: classification on the source videos, the domain
    cross entropy at each layer place_adv marks (source 0, target 1), and
    attentive entropy weighted by the video-level domain entropy."""
    o_s, o_t = out.logits[:, :bs], out.logits[:, bs:]
    total = _ce(o_s, ys, ms)
    selected = []
    if da["adv_DA"] == "RevGrad":
        for layer, flag in enumerate(da["place_adv"]):
            if flag != "Y":
                continue
            ps, ws = _rows(out.domain[layer][:, :bs], ms)
            pt, wt = _rows(out.domain[layer][:, bs:], mt)
            labels = torch.cat([torch.zeros(ps.shape[1], dtype=torch.long),
                                torch.ones(pt.shape[1], dtype=torch.long)]
                               ).to(ps.device)
            logits, w = torch.cat([ps, pt], 1), torch.cat([ws, wt])
            total = total + _ce(logits, labels, w)
            selected.append((logits, w))
    if da["add_loss_DA"] == "attentive_entropy":
        pred = out.logits
        w = torch.cat([ms, mt])
        if len(selected) > 1 and selected[1][0].shape[1] == pred.shape[1]:
            dom, dw = selected[1]
        else:
            dom, dw = out.domain[1], w
        ent = (1.0 + _entropy(dom)) * _entropy(pred)
        ww = w * dw
        total = total + gamma * ((ent * ww).sum(-1)
                                 / ww.sum().clamp(min=1.0))
    return total


# ---- the sweep's first steps ---------------------------------------------

def dropout_keep(generators: Sequence[torch.Generator], shape: tuple,
                 p: float, device) -> torch.Tensor:
    """Each member's keep mask of ``shape``, drawn from its own generator
    (Bernoulli(1 - p), float32), stacked [M, ...]."""
    return torch.stack([torch.empty(shape, device=device).bernoulli_(
        1.0 - p, generator=g) for g in generators])


def dann_lr(lr0: float, p: float) -> float:
    """main.py:800-802."""
    return lr0 / (1.0 + 10.0 * p) ** 0.75


class Steps(NamedTuple):
    """A member block's readings over the first steps: losses [K, M]; the
    first gradient as the optimizer takes it (clipped, with weight decay:
    SGD's first momentum buffer), the raw gradient of the first step, and
    the change after the K steps, each {name: [M, ...]}; the validation
    logits [M, rows, C]."""

    losses: torch.Tensor
    first: Dict[str, torch.Tensor]
    raw: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    val_logits: torch.Tensor


def run_block(p0: dict, cfg: dict, stores: dict, train: list, val: list,
              lrs: Sequence[Sequence[float]], generators, mm: Mm,
              device) -> Steps:
    """K SGD steps of a block of members from their weights ``p0``
    {name: [M, ...]} on the K (source, target) batches ``train``, then
    the validation forward over the ``val`` batches.  ``lrs[j]`` the
    members' learning rates at step j."""
    model, da, tc = cfg["model"], cfg["da"], cfg["train"]
    _supported(model, da)
    m = next(iter(p0.values())).shape[0]
    s = int(model["train_segments"])
    _, sh, agg, _ = _dims(model)
    beta = torch.tensor(tc["beta"], dtype=torch.float32,
                        device=device).expand(m, 3)
    gamma = torch.tensor(tc["gamma"], dtype=torch.float32, device=device)
    momentum, wd = float(tc["momentum"]), float(tc["weight_decay"])
    p = {k: v.clone() for k, v in p0.items()}
    buf, first, raw, losses = {}, None, None, []
    for j, (bs_, bt_) in enumerate(train):
        x = torch.cat([stores["source"][torch.as_tensor(bs_.rows)],
                       stores["target"][torch.as_tensor(bt_.rows)]])
        mask = torch.as_tensor(np.concatenate([bs_.mask, bt_.mask]),
                               device=device)
        b = x.shape[0]
        keep = (dropout_keep(generators, (b * s, sh), model["dropout_i"],
                             device),
                dropout_keep(generators, (b, agg), model["dropout_v"],
                             device))
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        out = forward(leaves, model, x, mask, beta, keep, mm)
        dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        total = loss(out, len(bs_.mask), dev(bs_.labels, torch.long),
                     dev(bs_.mask, torch.float32),
                     dev(bt_.labels, torch.long),
                     dev(bt_.mask, torch.float32), da, gamma)
        names = list(leaves)
        grads = torch.autograd.grad(total.sum(), [leaves[k] for k in names],
                                    allow_unused=True)
        losses.append(total.detach())
        with torch.no_grad():
            grads = {k: g for k, g in zip(names, grads) if g is not None}
            p = {k: v.detach() for k, v in leaves.items()}
            if raw is None:
                raw = {k: g.clone() for k, g in grads.items()}
            norm = torch.sqrt(sum((g.reshape(m, -1) ** 2).sum(1)
                                  for g in grads.values()))
            coef = torch.clamp(float(tc["clip_gradient"]) / (norm + 1e-6),
                               max=1.0)
            lr = torch.tensor(lrs[j], dtype=torch.float32, device=device)
            for k, g in grads.items():
                shape = (m,) + (1,) * (g.dim() - 1)
                d_p = g * coef.reshape(shape) + wd * p[k]
                buf[k] = d_p.clone() if k not in buf else \
                    buf[k] * momentum + d_p
                step = d_p + momentum * buf[k]
                p[k] = p[k] - lr.reshape(shape) * step
            if first is None:
                first = {k: v.clone() for k, v in buf.items()}
    with torch.no_grad():
        logits = []
        for bv in val:
            x = stores["val"][torch.as_tensor(bv.rows)]
            mask = torch.as_tensor(bv.mask, device=device)
            logits.append(forward(p, model, x, mask, beta, None,
                                  mm).logits)
        change = {k: p[k] - p0[k] for k in p}
    return Steps(torch.stack(losses), first, raw, change,
                 torch.cat(logits, dim=1))
