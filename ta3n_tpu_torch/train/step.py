"""The train step (one forward of both streams, the TA3N losses, backward
and one optimizer update) and the validation steps.

Port of `ta3n_tpu/train/step.py:175-389, 413-766, 1064-1168` (reference
main.py:348-628 loss assembly, backward and optimizer, and validate(),
main.py:669-761): the classification loss on the source stream (uSv) or
on both (Sv), per frame for the frame baseline; the discrepancy losses
DAN, JAN and CORAL at the layers that ``place_dis`` marks; RevGrad
adversarial losses at the layers that ``place_adv`` marks; target entropy
or attentive entropy with its layer-pick rule; the 'uncertainty' logit
scaling of ``pred_normalize``; MCD's second forward with its discrepancy;
and ``pretrain_source``'s classification-only step.

Padded videos are masked, not removed: ``mask_s`` and ``mask_t`` weight
every loss and keep the padded videos out of the BN statistics, as in the
JAX package (main.py:358-372,825-832).  The per-step schedule values
(beta, mu, alpha, gamma, lr) are arguments of the step.  The step makes
no host-device round trip of its own: metrics come back as 0-d tensors on
the model's device, and a number-valued beta never leaves the host.  A
multi-scale TRN runs through `ops/trn_fused.py::trn_multiscale_fused`: on
CUDA its training forward and backward kernels, once each per forward
(twice per MCD step).  BN running statistics live in the model's buffers
and are updated by every training forward, so twice per MCD step, as the
JAX step's second ``apply`` does.

Each step takes its videos either as feature arrays from the host or, with
``gather_on_device=True``, as index batches into feature stores that live
on the device (`FeatureStore.to_device`, `TSNLoader.index_epoch`): the
gather and the first shared FC then run as one fused op
(`ops/gather_gemm.py`, on CUDA the K3 kernel, one launch per store), and
only a few KB of indices cross per step.  Either way the first shared
FC's output is computed once per step: MCD's second forward reuses it.

Stores on the device are float32 or bfloat16 tensors, or int8 ``(q,
scale)`` pairs (`data/quantized.py`), which K3 dequantizes as it gathers.
Under ``compute_dtype="bfloat16"`` the first FC computes in bfloat16 (K3's
bfloat16 variants) and the model as `models/video_model.py` says; the
metrics come back as float32 whatever the compute dtype.  Every step runs
inside ``models.layers.bf16_f32_reduction``, so that cuBLAS sums bfloat16
products in float32, as XLA does.  ``make_grad_accum_step`` averages the
gradients of G micro-batch pairs into one update (``--accum_steps``).
int8 inference (``ModelConfig.quantize="int8"``) runs in the eval and
infer steps only: every train-step builder refuses it, as JAX's
``make_train_step`` does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.losses import (CORAL, JAN, attentive_entropy,
                                   cross_entropy_soft, dis_MCD, mmd_rbf,
                                   weighted_cross_entropy)
from ta3n_tpu_torch.models.layers import bf16_f32_reduction
from ta3n_tpu_torch.models.video_model import StreamOutput, VideoModel
from ta3n_tpu_torch.ops.gather_gemm import (RowIndex, gathered_gemm,
                                            gathered_linear, gathered_rows,
                                            row_index, upload)
from ta3n_tpu_torch.train.optim import make_optimizer, optimizer_step

__all__ = ["TrainState", "StepScalars", "create_train_state",
           "make_train_step", "make_grad_accum_step",
           "make_multi_train_step", "make_sampled_multi_step",
           "make_sampled_shard_multi_step", "make_eval_step",
           "make_multi_eval_step", "make_infer_step", "device_gather",
           "topk_correct", "video_logits"]


class TrainState(NamedTuple):
    """The model (its parameters updated in place by each step), its
    optimizer and the number of steps taken."""

    model: VideoModel
    optimizer: torch.optim.Optimizer
    step: int


class StepScalars(NamedTuple):
    """Per-step schedule values, computed on the host (`schedules.py`)."""

    beta: Any       # (3,) [relation, video, frame]: numbers or a tensor
    mu: float
    alpha: float
    gamma: float
    lr: float


def create_train_state(cfg: ModelConfig, train_cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> TrainState:
    """A `VideoModel` initialised from ``generator`` (a CPU generator) and
    moved to ``device``, with a fresh optimizer and step 0."""
    model = VideoModel(cfg, generator, device)
    return TrainState(model, make_optimizer(model.parameters(), train_cfg),
                      0)


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, k: int) -> torch.Tensor:
    """Masked top-k hit count (reference accuracy(), main.py:809-822)."""
    k = min(k, logits.shape[-1])
    top = torch.topk(logits, k, dim=-1).indices
    hit = (top == labels[:, None]).any(dim=-1).to(mask.dtype)
    return (hit * mask).sum()


def _flatten_out(out: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor):
    """The frame baseline's logits [B, S, C] as rows [B*S, C], with the
    labels and the video mask repeated per frame (main.py:380-385); other
    logits as they are."""
    if out.dim() == 3:
        s = out.shape[1]
        return (out.reshape(-1, out.shape[-1]), labels.repeat_interleave(s),
                mask.repeat_interleave(s))
    return out, labels, mask


def _rows(p: torch.Tensor, m: torch.Tensor):
    """Frame- and relation-level domain logits [B, L, 2] flattened to rows,
    with the video mask repeated per row."""
    if p.dim() == 3:
        m = m.repeat_interleave(p.shape[1])
        p = p.reshape(-1, p.shape[-1])
    return p, m


def _masked_var_log_scale(x: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """x / log(var(x)) over the real rows, the reference's 'uncertainty'
    pred_normalize (main.py:424-427, 531-532; `ta3n_tpu/train/step.py::
    _masked_var_log_scale`): torch's unbiased .var() over every element
    of the rows whose mask is 1."""
    w = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    n = (w.sum() * float(np.prod(x.shape[1:]))).clamp(min=2.0)
    mean = (x * w).sum() / n
    var = ((x - mean).square() * w).sum() / (n - 1.0)
    return x / torch.log(var)


def _domain_adversarial_loss(pred_domain_s, pred_domain_t, mask_s, mask_t,
                             place_adv: Sequence[str],
                             domain_weights: Optional[torch.Tensor],
                             pred_normalize: bool = False):
    """Sum of the 2-way domain CE over the layers marked 'Y' in place_adv
    (main.py:507-538): source label 0, target label 1, each layer's logits
    scaled by _masked_var_log_scale under pred_normalize.  Also returns
    the selected (logits, mask) pairs, scaled where the loss was, whose
    index 1 feeds attentive entropy (main.py:560)."""
    loss = 0.0
    selected = []
    for layer, flag in enumerate(place_adv):
        if flag != "Y":
            continue
        ps, ms = _rows(pred_domain_s[layer], mask_s)
        pt, mt = _rows(pred_domain_t[layer], mask_t)
        logits, m = torch.cat([ps, pt]), torch.cat([ms, mt])
        labels = torch.cat([
            torch.zeros(ps.shape[0], dtype=torch.long, device=ps.device),
            torch.ones(pt.shape[0], dtype=torch.long, device=pt.device)])
        if pred_normalize:
            logits = _masked_var_log_scale(logits, m)
        loss = loss + weighted_cross_entropy(logits, labels, domain_weights,
                                             m)
        selected.append((logits, m))
    return loss, selected


def _entropy_domain(selected, out_s, out_t, mask_s, mask_t, rows: int):
    """The domain logits that weight attentive entropy (main.py:560): the
    reference's pred_domain_all[1] (the video level under the published
    place_adv), else the video level, else the frame level, the first
    whose row count is the class logits' ``rows``.  The reference crashes
    for the other place_adv values; `ta3n_tpu/train/step.py:561-599`
    documents the divergence."""
    if len(selected) > 1 and selected[1][0].shape[0] == rows:
        return selected[1]
    for layer in (1, 2):
        ps, ms = _rows(out_s.pred_domain[layer], mask_s)
        pt, mt = _rows(out_t.pred_domain[layer], mask_t)
        if ps.shape[0] + pt.shape[0] == rows:
            break
    return torch.cat([ps, pt]), torch.cat([ms, mt])


# rows per sub-batch of DAN and CORAL: the reference's size_batch
# (main.py:488)
_DIS_CHUNK_ROWS = 256


def _discrepancy_loss(feat_s, feat_t, da: DAConfig, add_fc: int,
                      n_pair: int, mask_s: torch.Tensor,
                      mask_t: torch.Tensor) -> torch.Tensor:
    """DAN / JAN / CORAL at the layers of ``feat`` (the reversed
    feat_all) that ``da.place_dis`` marks (main.py:454-505;
    `ta3n_tpu/train/step.py::_discrepancy_loss`, with its documented
    divergences).

    The first ``n_pair`` videos of each stream pair up, each video's
    features flattened to one row (the shared layers' [B, S, d] too, where
    the reference crashes).  DAN and CORAL average over sub-batches of
    _DIS_CHUNK_ROWS rows, the last one smaller where the rows do not
    divide; a sub-batch counts only if it holds a valid source and a valid
    target row, so an all-padded trailing one adds nothing.  JAN takes
    every layer but the shared ones, in one batch (main.py:462-471).  The
    masks keep padded videos out of every bandwidth, kernel mean and
    covariance."""
    kernel_muls, kernel_nums = [2.0, 2.0], [2, 5]
    ms, mt = mask_s[:n_pair], mask_t[:n_pair]

    def flat(x):
        return x[:n_pair].reshape(n_pair, -1)

    if da.dis_DA == "JAN":
        fs = [flat(f) for f in feat_s[:-add_fc]]
        ft = [flat(f) for f in feat_t[:-add_fc]]
        if not fs:
            raise ValueError(
                "JAN requires frame- or video-level features; "
                "baseline_type 'tsn' provides none beyond the shared "
                "layers (the reference crashes on this config too)")
        return JAN(fs, ft, kernel_muls, kernel_nums, [None, None], 2, ms, mt)

    def chunked_mean(fn, fs, ft):
        size = min(_DIS_CHUNK_ROWS, fs.shape[0])
        losses, weights = [], []
        for i in range(0, fs.shape[0], size):
            cs, ct = ms[i:i + size], mt[i:i + size]
            losses.append(fn(fs[i:i + size], ft[i:i + size], cs, ct))
            weights.append(((cs.sum() > 0) & (ct.sum() > 0)).to(fs.dtype))
        w = torch.stack(weights)
        return (torch.stack(losses) * w).sum() / w.sum().clamp(min=1.0)

    if da.dis_DA not in ("DAN", "CORAL"):
        raise ValueError(f"unknown dis_DA {da.dis_DA}")
    muls = kernel_muls + [kernel_muls[-1]] * add_fc
    nums = kernel_nums + [kernel_nums[-1]] * add_fc
    loss = 0.0
    for layer in range(min(add_fc + 2, len(da.place_dis), len(feat_s))):
        if da.place_dis[layer] != "Y":
            continue
        fs, ft = flat(feat_s[layer]), flat(feat_t[layer])
        if da.dis_DA == "CORAL":
            loss = loss + chunked_mean(CORAL, fs, ft)
        else:
            loss = loss + chunked_mean(
                lambda a, b, wa, wb, layer=layer: mmd_rbf(
                    a, b, muls[layer], nums[layer], None, 2, wa, wb),
                fs, ft)
    return torch.as_tensor(loss, dtype=torch.float32, device=ms.device)


def _as(t, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=dtype)


def device_gather(store, abs_idx: torch.Tensor) -> torch.Tensor:
    """Row gather from a store on the device, as `ta3n_tpu/train/step.py::
    device_gather`: store [R, D] or [R, streams, D] (Flow), or an int8
    ``(q, scale)`` pair whose gathered rows are dequantized to float32 as
    ``q.float() * scale[idx]``; abs_idx [B, T] (a tensor on the store's
    device) -> [B, T(*streams), D], the streams interleaved per frame.  The
    device-store steps fuse this gather into the shared FC
    (`ops/gather_gemm.py`); this is its plain form."""
    if isinstance(store, (tuple, list)):
        q, scale = store
        x = q[abs_idx].to(scale.dtype) * scale[abs_idx].reshape(
            tuple(abs_idx.shape) + (1,) * (q.dim() - 1))
    else:
        x = store[abs_idx]
    if x.dim() == 4:  # interleave streams (dataset.py:62-66 semantics)
        b, t, s, d = x.shape
        x = x.reshape(b, t * s, d)
    return x


def _store_rows(store) -> torch.Tensor:
    """The row tensor of a store: the store, or an int8 pair's q."""
    return store[0] if isinstance(store, (tuple, list)) else store


def _store_part(store, idx, mask: torch.Tensor):
    """(store, checked indices, per-row scale) of one index batch [B, T]
    for `gathered_linear` / `gathered_gemm`: every row of a video is scaled
    by its mask, so the loader's padded videos, which point at row 0, give
    zero rows, as the JAX step's ``x * mask``."""
    idx = np.asarray(idx)
    if idx.ndim != 2:
        raise ValueError(f"index batches are [B, T], got {idx.shape}")
    rows = _store_rows(store)
    return (store, row_index(idx, rows.shape[0], rows.device),
            mask.repeat_interleave(idx.shape[1]))


def _scaled(s, t: torch.Tensor) -> torch.Tensor:
    """``s * t`` in t's dtype, as a Python number ``s`` gives it (the
    product in float32 for a bfloat16 t, then rounded), whether ``s`` is a
    number or a float32 tensor (an ensemble member's schedule scalar under
    ``vmap``, which would otherwise promote a bfloat16 loss to float32)."""
    return (s * t).to(t.dtype)


def _first_fc(net: VideoModel, domains=("target",)) -> list:
    """The (weight, bias) of each domain's first shared FC in the model's
    compute dtype (the gather kernel computes in the weight's dtype),
    cast once for a layer that the domains share (share_params Y)."""
    cast = {}
    for domain in domains:
        fc = net.shared_fc(domain)
        if fc not in cast:
            cast[fc] = (fc.weight.to(net.dtype), fc.bias.to(net.dtype))
    return [cast[net.shared_fc(domain)] for domain in domains]


def make_train_step(model: VideoModel, da: DAConfig, train_cfg: TrainConfig,
                    class_weights=None, domain_weights=None,
                    gather_on_device: bool = False, return_aux: bool = False,
                    pretrain_classification_only: bool = False):
    """Build the train step for ``model``'s configuration, on the model's
    device.

    Returned signature:
      step(state, xs, ys, mask_s, xt, yt, mask_t, scalars, generator)
        -> (new_state, metrics)
    xs [Bs, S, D] and xt [Bt, S, D] features, ys/yt labels, mask_s/mask_t
    per-video 0/1 weights (tensors or numpy arrays; moved to the model's
    device), ``scalars`` a `StepScalars`, ``generator`` a torch.Generator on
    the model's device for the dropout masks.  The step updates
    ``state.model`` in place and returns the state with ``step + 1`` and
    the metrics loss_c, loss_d, loss_a, loss_e, loss_s (where the
    configuration has them), loss, top1, top5 and n, as 0-d tensors; with
    ``return_aux`` also the attention values attn_s and attn_t
    (main.py:623-628) and the video-level features feat_s and feat_t
    (main.py:430-435).  The frame baseline's loss_c, top1, top5 and n are
    over frames.

    With ``pretrain_classification_only`` the step trains the
    classification loss alone (and reports loss_c, loss, top1, top5, n):
    ``--pretrain_source``'s extra step, which the Trainer runs before the
    train step on every batch (main.py:387-414).

    With ``gather_on_device=True`` the features stay on the device
    (`FeatureStore.to_device`) and only index batches cross from the host:
      step(state, store_s, idx_s, ys, mask_s, store_t, idx_t, yt, mask_t,
           scalars, generator)
    idx_s [Bs, T] and idx_t [Bt, T] are the loader's ``abs_indices``
    (numpy), checked against their store on the host before upload.  Both
    domains' first-FC pre-activations come from `gathered_linear`, one
    gather + GEMM per store into one buffer (on CUDA the K3 kernel, twice
    per step), each store with its domain's layer under share_params N,
    and the model runs on from them (`forward_shared`).  A store is a
    float32 or bfloat16 tensor or an int8 ``(q, scale)`` pair
    (``FeatureStore.to_device``).

    The returned step also carries ``loss_fn``, the forward(s) and losses
    of one micro-batch, which ``make_grad_accum_step`` builds on.
    """
    cfg = model.cfg
    if cfg.quantize != "none":
        # int8 quantization is inference-only: round() has zero gradient
        raise ValueError(
            f"ModelConfig.quantize={cfg.quantize!r} is inference-only "
            "(eval CLI / serve.Predictor); train with quantize='none'")
    use_tgt = da.use_target != "none"
    mcd = da.ens_DA == "MCD" and use_tgt
    if mcd and cfg.ens_DA != "MCD":
        # without the model's second classifier out_2 == out, and the MCD
        # discrepancy would train nothing (as the JAX step refuses)
        raise ValueError("DAConfig.ens_DA='MCD' requires "
                         "ModelConfig.ens_DA='MCD' (the second video "
                         "classifier lives in the model)")
    if da.dis_DA == "JAN" and use_tgt and cfg.baseline_type == "tsn":
        # tsn exposes only shared-layer features, which JAN ignores
        # (main.py:463-465): the reference crashes on an empty list
        raise ValueError(
            "dis_DA='JAN' is incompatible with baseline_type='tsn': JAN "
            "ignores shared-layer features and tsn provides no others "
            "(the reference crashes on this config, loss.py:86)")
    discrepancy = da.dis_DA != "none" and use_tgt
    adversarial = da.adv_DA != "none" and use_tgt
    target_entropy = da.add_loss_DA == "target_entropy" and use_tgt
    entropy = (da.add_loss_DA == "attentive_entropy"
               and cfg.use_attn != "none" and use_tgt)
    normalize = da.pred_normalize == "Y"
    device = next(model.parameters()).device
    if class_weights is not None:
        class_weights = _as(class_weights, device, torch.float32)
    if domain_weights is not None:
        domain_weights = _as(domain_weights, device, torch.float32)

    def loss_fn(net: VideoModel, pre, ys, mask_s, yt, mask_t, scalars,
                generator):
        """The forward(s) from the first shared FC's output ``pre`` and
        the losses (main.py:437-562; `ta3n_tpu/train/step.py::loss_fn`)."""
        bs, bt = len(mask_s), len(mask_t)
        fwd = (pre, bs, bt, scalars.beta, scalars.mu, True)
        out_s, out_t = net.forward_shared(*fwd, False, generator, mask_s,
                                          mask_t)
        metrics: Dict[str, torch.Tensor] = {}

        # (1) classification loss (main.py:424-451), per frame for the
        # frame baseline: pred_normalize scales both streams' logits once,
        # and the scaled ones feed Sv and the entropy losses below
        o_s, ys_r, ms_r = _flatten_out(out_s.out, ys, mask_s)
        o_t, yt_r, mt_r = _flatten_out(out_t.out, yt, mask_t)
        if normalize:
            o_s = _masked_var_log_scale(o_s, ms_r)
            o_t = _masked_var_log_scale(o_t, mt_r)
        if da.use_target == "Sv":
            o, lab, m = (torch.cat([o_s, o_t]), torch.cat([ys_r, yt_r]),
                         torch.cat([ms_r, mt_r]))
        else:
            o, lab, m = o_s, ys_r, ms_r
        loss = weighted_cross_entropy(o, lab, class_weights, m)
        if mcd:  # the second classifier's, unscaled
            o2, y2, m2 = _flatten_out(out_s.out_2, ys, mask_s)
            loss = loss + weighted_cross_entropy(o2, y2, class_weights, m2)
        metrics["loss_c"] = loss

        if pretrain_classification_only:
            return loss, finish(metrics, loss, o, lab, m, out_s, out_t)

        # (2) discrepancy loss (main.py:454-505)
        if discrepancy:
            loss_d = metrics["loss_d"] = _discrepancy_loss(
                out_s.feat, out_t.feat, da, cfg.add_fc, min(bs, bt), mask_s,
                mask_t)
            loss = loss + _scaled(scalars.alpha, loss_d)

        # (3) adversarial loss (main.py:507-538)
        selected = []
        if adversarial:
            loss_a, selected = _domain_adversarial_loss(
                out_s.pred_domain, out_t.pred_domain, mask_s, mask_t,
                da.place_adv, domain_weights, normalize)
            metrics["loss_a"] = loss_a
            loss = loss + loss_a

        # (4) target entropy (main.py:541-545) or attentive entropy
        # (main.py:558-562)
        if target_entropy:
            loss_e = metrics["loss_e"] = cross_entropy_soft(o_t, mt_r)
            loss = loss + _scaled(scalars.gamma, loss_e)
        elif entropy:
            pred_all = torch.cat([o_s, o_t])
            m_all = torch.cat([ms_r, mt_r])
            dom_logits, dom_m = _entropy_domain(
                selected, out_s, out_t, mask_s, mask_t, pred_all.shape[0])
            loss_e = attentive_entropy(pred_all, dom_logits, m_all * dom_m)
            metrics["loss_e"] = loss_e
            loss = loss + _scaled(scalars.gamma, loss_e)

        # (5) MCD: a second forward with GRL(mu) on the video feature and
        # its own dropout masks; the discrepancy of its two target-stream
        # classifiers, maximised (main.py:547-556, models.py:682-684)
        if mcd:
            _, out_t_rev = net.forward_shared(*fwd, True, generator, mask_s,
                                              mask_t)
            o1, _, m1 = _flatten_out(out_t_rev.out, yt, mask_t)
            o2 = _flatten_out(out_t_rev.out_2, yt, mask_t)[0]
            loss_s = metrics["loss_s"] = -dis_MCD(o1, o2, m1)
            loss = loss + loss_s

        return loss, finish(metrics, loss, o, lab, m, out_s, out_t)

    def finish(metrics, loss, o, lab, m, out_s, out_t):
        """The loss and accuracy metrics (main.py:564-571)."""
        metrics["loss"] = loss
        metrics["top1"] = topk_correct(o, lab, m, 1)
        metrics["top5"] = topk_correct(o, lab, m, 5)
        metrics["n"] = m.sum()
        if return_aux:
            # attention values and video-level features for the attention
            # logs (main.py:623-628) and the tensorboard embeddings
            # (main.py:428-435)
            metrics["attn_s"], metrics["attn_t"] = out_s.attn, out_t.attn
            fi = min(1, len(out_s.feat) - 1)
            metrics["feat_s"], metrics["feat_t"] = (out_s.feat[fi],
                                                    out_t.feat[fi])
        return metrics

    f32, i64 = torch.float32, torch.long

    def update(state: TrainState, pre_fn, ys, mask_s, yt, mask_t, scalars,
               generator):
        """The first FC's output ``pre_fn()``, the losses, backward and one
        update, with cuBLAS's bfloat16 reductions in float32."""
        with bf16_f32_reduction():
            pre = pre_fn()
            dev = pre.device
            loss, metrics = loss_fn(state.model, pre, _as(ys, dev, i64),
                                    mask_s, _as(yt, dev, i64), mask_t,
                                    scalars, generator)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer_step(state.optimizer, scalars.lr,
                           train_cfg.clip_gradient)
        return (TrainState(state.model, state.optimizer, state.step + 1),
                {k: v.detach().float() for k, v in metrics.items()})

    def step(state: TrainState, xs, ys, mask_s, xt, yt, mask_t,
             scalars: StepScalars, generator: Optional[torch.Generator]):
        dev = next(state.model.parameters()).device
        return update(
            state, lambda: state.model.shared_pre(_as(xs, dev, f32),
                                                  _as(xt, dev, f32)),
            ys, _as(mask_s, dev, f32), yt, _as(mask_t, dev, f32), scalars,
            generator)

    def parts_step(state: TrainState, part_s, ys, mask_s, part_t, yt,
                   mask_t, scalars: StepScalars,
                   generator: Optional[torch.Generator]):
        """The device-store step from store parts (`_store_part`) whose
        indices are on the device already, and the masks as float32
        tensors there."""
        net = state.model

        def pre():
            fcs = _first_fc(net, ("source", "target"))
            return gathered_linear([part_s, part_t], [w for w, _ in fcs],
                                   [b for _, b in fcs])

        return update(state, pre, ys, mask_s, yt, mask_t, scalars,
                      generator)

    def gather_step(state: TrainState, store_s, idx_s, ys, mask_s, store_t,
                    idx_t, yt, mask_t, scalars: StepScalars,
                    generator: Optional[torch.Generator]):
        dev = next(state.model.parameters()).device
        mask_s, mask_t = _as(mask_s, dev, f32), _as(mask_t, dev, f32)
        return parts_step(state, _store_part(store_s, idx_s, mask_s), ys,
                          mask_s, _store_part(store_t, idx_t, mask_t), yt,
                          mask_t, scalars, generator)

    built = gather_step if gather_on_device else step
    built.loss_fn = loss_fn
    built.parts_step = parts_step
    return built


def make_grad_accum_step(model: VideoModel, da: DAConfig,
                         train_cfg: TrainConfig, class_weights=None,
                         domain_weights=None, accum_steps: int = 2):
    """Gradient accumulation (`ta3n_tpu/train/step.py::
    make_grad_accum_step`): G = ``accum_steps`` micro-batch pairs of host
    features, each through the train step's forward and losses, their
    gradients averaged (each micro-batch's loss scaled by 1/G before its
    backward), then ONE clipped, weight-decayed update.  The BN running
    statistics are carried through the micro-batches (each forward updates
    them).  A parameter that no micro-batch reaches keeps ``grad=None`` and
    gets no weight decay, as the JAX step gates it by
    ``structural_participation``.

    Returned signature:
      step(state, xs [G, Bs, S, D], ys [G, Bs], mask_s [G, Bs],
           xt [G, Bt, S, D], yt [G, Bt], mask_t [G, Bt], scalars,
           generator) -> (new_state, metrics, each [G])
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = make_train_step(model, da, train_cfg, class_weights,
                              domain_weights).loss_fn
    f32, i64 = torch.float32, torch.long

    def accum_step(state: TrainState, xs, ys, mask_s, xt, yt, mask_t,
                   scalars: StepScalars,
                   generator: Optional[torch.Generator]):
        net = state.model
        dev = next(net.parameters()).device
        if len(xs) != accum_steps or len(xt) != accum_steps:
            raise ValueError(f"expected {accum_steps} micro-batches, got "
                             f"{len(xs)} and {len(xt)}")
        state.optimizer.zero_grad(set_to_none=True)
        per = []
        with bf16_f32_reduction():
            for g in range(accum_steps):
                ms, mt = _as(mask_s[g], dev, f32), _as(mask_t[g], dev, f32)
                pre = net.shared_pre(_as(xs[g], dev, f32),
                                     _as(xt[g], dev, f32))
                loss, metrics = loss_fn(net, pre, _as(ys[g], dev, i64), ms,
                                        _as(yt[g], dev, i64), mt, scalars,
                                        generator)
                (loss / accum_steps).backward()
                per.append(metrics)
            optimizer_step(state.optimizer, scalars.lr,
                           train_cfg.clip_gradient)
        return (TrainState(net, state.optimizer, state.step + 1),
                {k: torch.stack([m[k].detach().float() for m in per])
                 for k in per[0]})

    return accum_step


def _per_step(scalars: StepScalars) -> list:
    """The K steps' `StepScalars` of a `StepScalars` of K-long sequences
    (beta: K triples)."""
    k = len(scalars.lr)
    if any(len(f) != k for f in scalars):
        raise ValueError("the stacked StepScalars need one value of each "
                         f"field per step, got lengths "
                         f"{[len(f) for f in scalars]}")
    return [StepScalars(*(f[j] for f in scalars)) for j in range(k)]


def _stack(metrics: list) -> Dict[str, torch.Tensor]:
    """K steps' metrics, each key stacked [K] on the device."""
    return {key: torch.stack([m[key] for m in metrics])
            for key in metrics[0]}


def make_multi_train_step(model: VideoModel, da: DAConfig,
                          train_cfg: TrainConfig, class_weights=None,
                          domain_weights=None):
    """K optimizer steps per call over stacked index batches into stores on
    the device (`ta3n_tpu/train/step.py::make_multi_train_step`, its
    ``lax.scan`` a loop over the device-store step's body).

    Returned signature:
      multi_step(state, store_s, idx_s [K, Bs, T], ys [K, Bs],
                 mask_s [K, Bs], store_t, idx_t [K, Bt, T], yt, mask_t,
                 scalars, generator) -> (state, metrics each [K])
    ``scalars`` is a `StepScalars` of K-long sequences (beta K triples of
    numbers), ``generator`` as for the single step: it advances across the
    K steps exactly as across K single calls, so the K steps are bitwise
    those K single calls.  Each stacked index array is checked on the host
    once for the call (``row_index`` over the whole stack) and uploaded
    once, from pinned memory without waiting; labels and masks likewise.
    Step k reads a contiguous view of its rows.  Nothing in the call waits
    for the device; the metrics stay there, stacked [K]."""
    parts_step = make_train_step(model, da, train_cfg, class_weights,
                                 domain_weights,
                                 gather_on_device=True).parts_step

    def multi_step(state: TrainState, store_s, idx_s, ys, mask_s, store_t,
                   idx_t, yt, mask_t, scalars: StepScalars,
                   generator: Optional[torch.Generator]):
        per_step = _per_step(scalars)
        dev = next(state.model.parameters()).device
        streams = []
        for store, idx, y, mask in ((store_s, idx_s, ys, mask_s),
                                    (store_t, idx_t, yt, mask_t)):
            mask = upload(mask, torch.float32, dev)
            parts = _stacked_parts(store, idx, mask)
            if len(parts) != len(per_step):
                raise ValueError(f"{len(parts)} stacked index batches for "
                                 f"{len(per_step)} steps")
            streams.append((parts, upload(y, torch.long, dev), mask))
        (parts_s, ys, mask_s), (parts_t, yt, mask_t) = streams
        metrics = []
        for j, sc in enumerate(per_step):
            state, m = parts_step(state, parts_s[j], ys[j], mask_s[j],
                                  parts_t[j], yt[j], mask_t[j], sc,
                                  generator)
            metrics.append(m)
        return state, _stack(metrics)

    return multi_step


def _sampled_part(store, sampler, batch) -> tuple:
    """The store part, labels and mask of a batch that ``sampler`` made on
    the device: the indices' bound is the sampler's, known on the host."""
    idx, labels, mask = batch
    return ((store, RowIndex(idx.reshape(-1), sampler.end),
             mask.repeat_interleave(idx.shape[1])), labels, mask)


def make_sampled_multi_step(model: VideoModel, da: DAConfig,
                            train_cfg: TrainConfig, sampler_s, sampler_t,
                            class_weights=None, domain_weights=None):
    """K steps per call with the index batches made on the device by
    ``sampler_s`` and ``sampler_t`` (`data/device_sampler.py::
    DeviceSampler`), the counterpart of `ta3n_tpu/train/step.py::
    make_sampled_multi_step`: no index, label or mask crosses from the
    host; only the schedule scalars, which stay host numbers.

    Returned signature:
      step(state, store_s, store_t, scalars, generator)
        -> (state, metrics each [K])
    with K the length of ``scalars``' sequences.  Step i of the run (the
    host's ``state.step``) takes batch ``i % spe`` of epoch ``i // spe``
    of both samplers, whose ``steps_per_epoch`` must agree (the reference's
    zip-shortest epochs, main.py:330); the epoch orders of a call are made
    once for the call.  The indices are never read back: their bound is
    the samplers' ``end``, which every gather checks against its store."""
    if sampler_s.steps_per_epoch != sampler_t.steps_per_epoch:
        raise ValueError(
            "sampler_s and sampler_t must share steps_per_epoch (the "
            "zip-shortest epoch coupling, main.py:330): set both to "
            "min(len(source_loader), len(target_loader)) — otherwise "
            "target batches silently desync from their epoch "
            "permutation")
    parts_step = make_train_step(model, da, train_cfg, class_weights,
                                 domain_weights,
                                 gather_on_device=True).parts_step
    spe = sampler_s.steps_per_epoch

    def multi_step(state: TrainState, store_s, store_t,
                   scalars: StepScalars,
                   generator: Optional[torch.Generator]):
        per_step = _per_step(scalars)
        # the epoch orders of the call's epochs, once for the call
        e0 = state.step // spe
        n_epochs = -(-len(per_step) // spe) + 1
        orders = [(sampler_s.epoch_order(e), sampler_t.epoch_order(e))
                  for e in range(e0, e0 + n_epochs)]
        metrics = []
        for sc in per_step:
            order_s, order_t = orders[state.step // spe - e0]
            part_s, ys, ms = _sampled_part(
                store_s, sampler_s, sampler_s.batch(state.step, order_s))
            part_t, yt, mt = _sampled_part(
                store_t, sampler_t, sampler_t.batch(state.step, order_t))
            state, m = parts_step(state, part_s, ys, ms, part_t, yt, mt, sc,
                                  generator)
            metrics.append(m)
        return state, _stack(metrics)

    return multi_step


def make_sampled_shard_multi_step(model: VideoModel, da: DAConfig,
                                  train_cfg: TrainConfig, sampler_s,
                                  sampler_t, steps_per_epoch: int,
                                  class_weights=None, domain_weights=None):
    """The device-sampled K steps over streamed shards
    (`ta3n_tpu/train/step.py::make_sampled_shard_multi_step`): the batches
    are made shard-locally on the device by ``sampler_s`` and
    ``sampler_t`` (`data/device_sampler.py::StreamingDeviceSampler`)
    against the shards on the card (`data/streaming.py::ShardStream`).

    Returned signature:
      step(state, shard_s, shard_t, scalars, generator, sid_s, j0_s, sid_t,
           j0_t) -> (state, metrics each [K])
    Step j of the call takes batch ``j0 + j`` of shard ``sid`` of each
    stream; a call never spans a shard or an epoch (the chunk plan,
    ``plan_zip_shard_chunks``), so the shard orders are made once for the
    call, for the epoch ``state.step // steps_per_epoch``.  The indices'
    bound is the shards' ``budget_rows``."""
    parts_step = make_train_step(model, da, train_cfg, class_weights,
                                 domain_weights,
                                 gather_on_device=True).parts_step

    def shard_step(state: TrainState, shard_s, shard_t,
                   scalars: StepScalars,
                   generator: Optional[torch.Generator], sid_s: int,
                   j0_s: int, sid_t: int, j0_t: int):
        epoch = state.step // steps_per_epoch
        order_s = sampler_s.shard_order(sid_s, epoch)
        order_t = sampler_t.shard_order(sid_t, epoch)
        metrics = []
        for j, sc in enumerate(_per_step(scalars)):
            part_s, ys, ms = _sampled_part(shard_s, sampler_s,
                                           sampler_s.shard_batch(
                                               sid_s, j0_s + j, order_s,
                                               state.step))
            part_t, yt, mt = _sampled_part(shard_t, sampler_t,
                                           sampler_t.shard_batch(
                                               sid_t, j0_t + j, order_t,
                                               state.step))
            state, m = parts_step(state, part_s, ys, ms, part_t, yt, mt, sc,
                                  generator)
            metrics.append(m)
        return state, _stack(metrics)

    return shard_step


_EVAL_BETA = (0.0, 0.0, 0.0)


def video_logits(out: torch.Tensor) -> torch.Tensor:
    """A model output as video-level logits: the frame baseline's [B, S, C]
    averaged over the segments (the JAX eval CLI and Predictor,
    `ta3n_tpu/cli/test_models.py:165-166`, `ta3n_tpu/serve.py:91`)."""
    return out.mean(dim=1) if out.dim() == 3 else out


def _eval_metrics(out: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                  class_weights: Optional[torch.Tensor]):
    """(logits, loss, top1, top5, n) of one val batch (main.py:669-761);
    the frame baseline's over frames, its logits as rows [B*S, C]."""
    out, y, mask = _flatten_out(out, y, mask)
    loss = weighted_cross_entropy(out, y, class_weights, mask)
    return (out, loss, topk_correct(out, y, mask, 1),
            topk_correct(out, y, mask, 5), mask.sum())


def _eval_gathered(model: VideoModel, part, b: int) -> StreamOutput:
    """The eval forward of b videos from a store part (`_store_part`):
    the fused gather + FC without the gathered rows (no backward), then
    the model from the pre-activations.  The videos run as the target
    stream, so under share_params N they take the target layers, as in
    the JAX eval step, which reads the target side.  An int8 model's first
    FC is quantized: its rows are gathered plain and go through the
    model's quantized Linear, as in the JAX step, so K3 is not launched."""
    store, rows, scale = part
    if model.cfg.quantize == "int8":
        fc = model.shared_fc("target")
        pre = fc(gathered_rows(store, rows, scale).reshape(
            -1, fc.in_features))
    else:
        (weight, bias), = _first_fc(model)
        z, _ = gathered_gemm(store, rows, weight, scale, with_rows=False)
        pre = z.add_(bias)
    _, out = model.forward_shared(pre, 0, b, _EVAL_BETA, 0.0, False, False)
    return out


def make_eval_step(model: VideoModel, class_weights=None,
                   gather_on_device: bool = False):
    """The validation step (reference validate(), main.py:669-761), on the
    model's device, under ``torch.inference_mode()`` (the TRN runs its
    inference kernel, K1).

    Returned signature:
      ev(x, y, mask) -> metrics
    or, with ``gather_on_device=True``, ev(store, idx, y, mask): x is then
    gathered from ``store`` on the device by the index batch idx [B, T]
    (on CUDA the K3 kernel, without the gathered rows).  Metrics: loss,
    top1, top5 and n as 0-d tensors, the logits [B, C] (the frame
    baseline's per frame, [B*S, C], as its loss and counts) and feat, the
    video-level feature [B, H] (main.py:430; the tsn baseline's only
    feature, that of the shared layer).  The JAX step feeds the
    batch as both streams and reads the target side; in eval every row is
    independent (BN normalises with its running statistics), so the
    target side of x alone is the same function, and the port runs x
    once, as the target stream.
    """
    device = next(model.parameters()).device
    if class_weights is not None:
        class_weights = _as(class_weights, device, torch.float32)

    def metrics(out: StreamOutput, y, mask):
        logits, loss, top1, top5, n = _eval_metrics(out.out, y, mask,
                                                    class_weights)
        return {"loss": loss.float(), "top1": top1, "top5": top5, "n": n,
                "logits": logits,
                "feat": out.feat[min(1, len(out.feat) - 1)]}

    @torch.inference_mode()
    @bf16_f32_reduction()
    def ev(x, y, mask):
        x = _as(x, device, torch.float32)
        _, out = model(x[:0], x, _EVAL_BETA, 0.0, False, False)
        return metrics(out, _as(y, device, torch.long),
                       _as(mask, device, torch.float32))

    @torch.inference_mode()
    @bf16_f32_reduction()
    def ev_gather(store, idx, y, mask):
        mask = _as(mask, device, torch.float32)
        out = _eval_gathered(model, _store_part(store, idx, mask),
                             mask.shape[0])
        return metrics(out, _as(y, device, torch.long), mask)

    return ev_gather if gather_on_device else ev


def _stacked_parts(store, idx, mask: torch.Tensor) -> list:
    """The store part (`_store_part`) of each of the stacked index batches
    idx [Nb, B, T], whose masks are mask [Nb, B] on the store's device: the
    indices checked and uploaded once for all the batches."""
    idx = np.asarray(idx)
    if idx.ndim != 3:
        raise ValueError(f"stacked index batches are [Nb, B, T], got "
                         f"{idx.shape}")
    nb, b, t = idx.shape
    data = _store_rows(store)
    rows = row_index(idx, data.shape[0], data.device)
    scale = mask.repeat_interleave(t, dim=1)               # [Nb, B*T]
    return [(store, RowIndex(rows.rows[i * b * t:(i + 1) * b * t], rows.end),
             scale[i]) for i in range(nb)]


def make_multi_eval_step(model: VideoModel, class_weights=None):
    """A whole validation epoch from a store on the device
    (`ta3n_tpu/train/step.py::make_multi_eval_step`): the stacked index
    batches are checked and uploaded once, every batch runs as the
    device-store eval step does, and the metrics are summed on the device,
    so the caller fetches four numbers once, at the end.

    Returned signature:
      ev(store, idx [Nb, B, T], ys [Nb, B], mask [Nb, B])
        -> {"loss_sum", "top1", "top5", "n"} (0-d tensors)
    with loss_sum the sum over batches of loss * n, as AverageMeter
    accumulates it (main.py:669-761).
    """
    device = next(model.parameters()).device
    if class_weights is not None:
        class_weights = _as(class_weights, device, torch.float32)

    @torch.inference_mode()
    @bf16_f32_reduction()
    def multi_eval(store, idx, ys, mask):
        ys = _as(ys, device, torch.long)
        mask = _as(mask, device, torch.float32)
        sums = torch.zeros(4, device=device)
        for i, part in enumerate(_stacked_parts(store, idx, mask)):
            out = _eval_gathered(model, part, mask.shape[1])
            _, loss, top1, top5, n = _eval_metrics(out.out, ys[i], mask[i],
                                                   class_weights)
            sums += torch.stack([loss.float() * n, top1, top5, n])
        return dict(zip(("loss_sum", "top1", "top5", "n"), sums.unbind()))

    return multi_eval


def make_infer_step(model: VideoModel, top_k: int,
                    gather_on_device: bool = False):
    """Inference of the eval CLI, on the model's device, under
    ``torch.inference_mode()`` (the counterpart of the JAX CLI's ``_infer``
    and ``_infer_all``, `ta3n_tpu/cli/test_models.py:158-187`): softmax
    probabilities of the video-level logits (the frame baseline's frame
    logits averaged over the segments), their ``top_k`` (at most the
    class count) and the attention values.

    Returned signature:
      infer(x [B, S, D]) -> (probs [B, C], top_p [B, K], top_i [B, K],
                             attn [B, R])
    or, with ``gather_on_device=True``, a whole test set from a store on
    the device in one call, its outputs kept on the device and stacked for
    one fetch:
      infer(store, idx [Nb, B, T], mask [Nb, B]) -> the same, each
        [Nb, B, ...]
    Each batch then runs the fused gather + FC without the gathered rows
    (on CUDA the K3 kernel) and the model from its pre-activations (K1
    (infer)); padded videos (mask 0) read zero rows, as the JAX CLI's
    ``x * mask``.  The probabilities are the float32 softmax of the
    video-level logits in whatever dtype the model computes, so their
    ranking is the logits', and the attention values are float32.
    """
    device = next(model.parameters()).device
    k = min(top_k, model.cfg.num_class)

    def head(out: StreamOutput):
        probs = torch.softmax(video_logits(out.out).float(), dim=-1)
        top_p, top_i = torch.topk(probs, k, dim=-1)
        return probs, top_p, top_i, out.attn.float()

    @torch.inference_mode()
    @bf16_f32_reduction()
    def infer(x):
        x = _as(x, device, torch.float32)
        _, out = model(x[:0], x, _EVAL_BETA, 0.0, False, False)
        return head(out)

    @torch.inference_mode()
    @bf16_f32_reduction()
    def infer_all(store, idx, mask):
        mask = _as(mask, device, torch.float32)
        outs = [head(_eval_gathered(model, part, mask.shape[1]))
                for part in _stacked_parts(store, idx, mask)]
        return tuple(torch.stack(o) for o in zip(*outs))

    return infer_all if gather_on_device else infer
