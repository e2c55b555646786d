"""The flagship train step (one forward of both streams, the TA3N losses,
backward and one optimizer update) and the validation steps.

Port of `ta3n_tpu/train/step.py:175-289, 392-410, 413-766, 1064-1168`
(reference main.py:348-628 loss assembly, backward and optimizer, and
validate(), main.py:669-761) for the published UCF->HMDB_full
recipe: the uSv classification loss on the source stream, RevGrad
adversarial losses at the layers that ``place_adv`` marks, and attentive
entropy with its layer-pick rule.  Any other ``DAConfig`` value raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.

Padded videos are masked, not removed: ``mask_s`` and ``mask_t`` weight
every loss, as in the JAX package (main.py:358-372,825-832).  The per-step
schedule values (beta, mu, alpha, gamma, lr) are arguments of the step.
The step makes no host-device round trip of its own: metrics come back as
0-d tensors on the model's device, and a number-valued beta never leaves
the host.  The TRN runs through `ops/trn_fused.py::trn_multiscale_fused`:
on CUDA its training forward and backward kernels, once each per step.

Each step takes its videos either as feature arrays from the host or, with
``gather_on_device=True``, as index batches into feature stores that live
on the device (`FeatureStore.to_device`, `TSNLoader.index_epoch`): the
gather and the shared FC then run as one fused op (`ops/gather_gemm.py`,
on CUDA the K3 kernel), and only a few KB of indices cross per step.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.losses import attentive_entropy, weighted_cross_entropy
from ta3n_tpu_torch.models.video_model import StreamOutput, VideoModel
from ta3n_tpu_torch.ops.gather_gemm import (RowIndex, gathered_gemm,
                                            gathered_linear, row_index)
from ta3n_tpu_torch.train.optim import make_optimizer, optimizer_step

__all__ = ["TrainState", "StepScalars", "create_train_state",
           "make_train_step", "make_eval_step", "make_multi_eval_step",
           "make_infer_step", "device_gather", "topk_correct"]


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


# DAConfig field -> (the values the port runs, the ROADMAP.md queue-1 item
# porting the others)
_DA_PORTED = {
    "use_target": (("none", "uSv"), "6: Sv"),
    "dis_DA": (("none",), "7: the discrepancy losses DAN, JAN and CORAL"),
    "add_loss_DA": (("none", "attentive_entropy"), "6: target_entropy"),
    "ens_DA": (("none",), "6: MCD"),
    "pretrain_source": ((False,), "6: --pretrain_source"),
    "pred_normalize": (("N",), "6: pred_normalize"),
}


def _check_da(da: DAConfig) -> None:
    for field, (ported, item) in _DA_PORTED.items():
        got = getattr(da, field)
        if got not in ported:
            raise NotImplementedError(
                f"DAConfig.{field}={got!r} is not ported yet; the port runs "
                f"{' or '.join(map(repr, ported))} (ROADMAP.md queue 1, "
                f"item {item})")


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


def _rows(p: torch.Tensor, m: torch.Tensor):
    """Frame- and relation-level domain logits [B, L, 2] flattened to rows,
    with the video mask repeated per row."""
    if p.dim() == 3:
        m = m.repeat_interleave(p.shape[1])
        p = p.reshape(-1, p.shape[-1])
    return p, m


def _domain_adversarial_loss(pred_domain_s, pred_domain_t, mask_s, mask_t,
                             place_adv: Sequence[str],
                             domain_weights: Optional[torch.Tensor]):
    """Sum of the 2-way domain CE over the layers marked 'Y' in place_adv
    (main.py:507-538): source label 0, target label 1.  Also returns the
    selected (logits, mask) pairs, whose index 1 feeds attentive entropy
    (main.py:560)."""
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


def _as(t, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=dtype)


def device_gather(store, abs_idx: torch.Tensor) -> torch.Tensor:
    """Row gather from a store on the device, as `ta3n_tpu/train/step.py::
    device_gather`: store [R, D] or [R, streams, D] (Flow), abs_idx [B, T]
    (a tensor on the store's device) -> [B, T(*streams), D], the streams
    interleaved per frame.  The device-store steps fuse this gather into
    the shared FC (`ops/gather_gemm.py`); this is its plain form."""
    if isinstance(store, (tuple, list)):
        raise NotImplementedError(
            "int8 (q, scale) stores are not ported yet (ROADMAP.md queue 1, "
            "item 8)")
    x = store[abs_idx]
    if x.dim() == 4:  # interleave streams (dataset.py:62-66 semantics)
        b, t, s, d = x.shape
        x = x.reshape(b, t * s, d)
    return x


def _store_part(store: torch.Tensor, idx, mask: torch.Tensor):
    """(store, checked indices, per-row scale) of one index batch [B, T]
    for `gathered_linear` / `gathered_gemm`: every row of a video is scaled
    by its mask, so the loader's padded videos, which point at row 0, give
    zero rows, as the JAX step's ``x * mask``."""
    idx = np.asarray(idx)
    if idx.ndim != 2:
        raise ValueError(f"index batches are [B, T], got {idx.shape}")
    return (store, row_index(idx, store.shape[0], store.device),
            mask.repeat_interleave(idx.shape[1]))


def make_train_step(model: VideoModel, da: DAConfig, train_cfg: TrainConfig,
                    class_weights=None, domain_weights=None,
                    gather_on_device: bool = False, return_aux: bool = False):
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
    the metrics loss_c, loss_a, loss_e (where the configuration has them),
    loss, top1, top5 and n, as 0-d tensors; with ``return_aux`` also the
    attention values attn_s [Bs, R] and attn_t [Bt, R] (main.py:623-628).

    With ``gather_on_device=True`` the features stay on the device
    (`FeatureStore.to_device`) and only index batches cross from the host:
      step(state, store_s, idx_s, ys, mask_s, store_t, idx_t, yt, mask_t,
           scalars, generator)
    idx_s [Bs, T] and idx_t [Bt, T] are the loader's ``abs_indices``
    (numpy), checked against their store on the host before upload.  Both
    domains' shared-FC pre-activations come from `gathered_linear`, one
    gather + GEMM per store into one buffer (on CUDA the K3 kernel, twice
    per step), and the model runs on from them (`forward_shared`).
    """
    cfg = model.cfg
    if cfg.quantize != "none":
        # int8 quantization is inference-only: round() has zero gradient
        raise ValueError(
            f"ModelConfig.quantize={cfg.quantize!r} is inference-only "
            "(eval CLI / serve.Predictor); train with quantize='none'")
    _check_da(da)
    use_tgt = da.use_target != "none"
    adversarial = da.adv_DA != "none" and use_tgt
    entropy = (da.add_loss_DA == "attentive_entropy"
               and cfg.use_attn != "none" and use_tgt)
    device = next(model.parameters()).device
    if class_weights is not None:
        class_weights = _as(class_weights, device, torch.float32)
    if domain_weights is not None:
        domain_weights = _as(domain_weights, device, torch.float32)

    def loss_fn(out_s, out_t, ys, mask_s, mask_t, scalars):
        metrics: Dict[str, torch.Tensor] = {}

        # (1) classification loss on the source stream (uSv,
        # main.py:437-451)
        o, lab, m = out_s.out, ys, mask_s
        loss = metrics["loss_c"] = weighted_cross_entropy(
            o, lab, class_weights, m)

        # (2) adversarial loss (main.py:507-538)
        selected = []
        if adversarial:
            loss_a, selected = _domain_adversarial_loss(
                out_s.pred_domain, out_t.pred_domain, mask_s, mask_t,
                da.place_adv, domain_weights)
            metrics["loss_a"] = loss_a
            loss = loss + loss_a

        # (3) attentive entropy (main.py:558-562)
        if entropy:
            pred_all = torch.cat([out_s.out, out_t.out])
            m_all = torch.cat([mask_s, mask_t])
            dom_logits, dom_m = _entropy_domain(
                selected, out_s, out_t, mask_s, mask_t, pred_all.shape[0])
            loss_e = attentive_entropy(pred_all, dom_logits, m_all * dom_m)
            metrics["loss_e"] = loss_e
            loss = loss + scalars.gamma * loss_e

        metrics["loss"] = loss
        metrics["top1"] = topk_correct(o, lab, m, 1)
        metrics["top5"] = topk_correct(o, lab, m, 5)
        metrics["n"] = m.sum()
        if return_aux:
            metrics["attn_s"], metrics["attn_t"] = out_s.attn, out_t.attn
        return loss, metrics

    def update(state: TrainState, outs, ys, mask_s, mask_t, scalars):
        """The losses of the forward's outputs, backward and one update."""
        loss, metrics = loss_fn(*outs, ys, mask_s, mask_t, scalars)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer_step(state.optimizer, scalars.lr, train_cfg.clip_gradient)
        return (TrainState(state.model, state.optimizer, state.step + 1),
                {k: v.detach() for k, v in metrics.items()})

    f32, i64 = torch.float32, torch.long

    def step(state: TrainState, xs, ys, mask_s, xt, yt, mask_t,
             scalars: StepScalars, generator: Optional[torch.Generator]):
        dev = next(state.model.parameters()).device
        mask_s, mask_t = _as(mask_s, dev, f32), _as(mask_t, dev, f32)
        outs = state.model(_as(xs, dev, f32), _as(xt, dev, f32),
                           scalars.beta, scalars.mu, True, False,
                           generator=generator)
        return update(state, outs, _as(ys, dev, i64), mask_s, mask_t,
                      scalars)

    def gather_step(state: TrainState, store_s, idx_s, ys, mask_s, store_t,
                    idx_t, yt, mask_t, scalars: StepScalars,
                    generator: Optional[torch.Generator]):
        net = state.model
        dev = next(net.parameters()).device
        mask_s, mask_t = _as(mask_s, dev, f32), _as(mask_t, dev, f32)
        fc = net.fc_feature_shared_source
        pre = gathered_linear([_store_part(store_s, idx_s, mask_s),
                               _store_part(store_t, idx_t, mask_t)],
                              fc.weight, fc.bias)
        outs = net.forward_shared(pre, len(mask_s), len(mask_t),
                                  scalars.beta, scalars.mu, True, False,
                                  generator=generator)
        return update(state, outs, _as(ys, dev, i64), mask_s, mask_t,
                      scalars)

    return gather_step if gather_on_device else step


_EVAL_BETA = (0.0, 0.0, 0.0)


def _eval_metrics(out: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                  class_weights: Optional[torch.Tensor]):
    """(loss, top1, top5, n) of one val batch (main.py:669-761)."""
    loss = weighted_cross_entropy(out, y, class_weights, mask)
    return (loss, topk_correct(out, y, mask, 1), topk_correct(out, y, mask, 5),
            mask.sum())


def _eval_gathered(model: VideoModel, part, b: int) -> StreamOutput:
    """The eval forward of b videos from a store part (`_store_part`):
    the fused gather + FC without the gathered rows (no backward), then
    the model from the pre-activations."""
    fc = model.fc_feature_shared_source
    store, rows, scale = part
    z, _ = gathered_gemm(store, rows, fc.weight, scale, with_rows=False)
    _, out = model.forward_shared(z.add_(fc.bias), 0, b, _EVAL_BETA, 0.0,
                                  False, False)
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
    top1, top5 and n as 0-d tensors, the logits [B, C] and feat, the
    video-level feature [B, H] (main.py:430).  The JAX step feeds the
    batch as both streams and reads the target side; with no batch
    statistics in the model the target side of x alone is the same
    function, so the port runs x once, as the target stream.
    """
    device = next(model.parameters()).device
    if class_weights is not None:
        class_weights = _as(class_weights, device, torch.float32)

    def metrics(out: StreamOutput, y, mask):
        loss, top1, top5, n = _eval_metrics(out.out, y, mask, class_weights)
        return {"loss": loss, "top1": top1, "top5": top5, "n": n,
                "logits": out.out, "feat": out.feat[1]}

    @torch.inference_mode()
    def ev(x, y, mask):
        x = _as(x, device, torch.float32)
        _, out = model(x[:0], x, _EVAL_BETA, 0.0, False, False)
        return metrics(out, _as(y, device, torch.long),
                       _as(mask, device, torch.float32))

    @torch.inference_mode()
    def ev_gather(store, idx, y, mask):
        mask = _as(mask, device, torch.float32)
        out = _eval_gathered(model, _store_part(store, idx, mask),
                             mask.shape[0])
        return metrics(out, _as(y, device, torch.long), mask)

    return ev_gather if gather_on_device else ev


def _stacked_parts(store: torch.Tensor, idx, mask: torch.Tensor) -> list:
    """The store part (`_store_part`) of each of the stacked index batches
    idx [Nb, B, T], whose masks are mask [Nb, B] on the store's device: the
    indices checked and uploaded once for all the batches."""
    idx = np.asarray(idx)
    if idx.ndim != 3:
        raise ValueError(f"stacked index batches are [Nb, B, T], got "
                         f"{idx.shape}")
    nb, b, t = idx.shape
    rows = row_index(idx, store.shape[0], store.device)
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
    def multi_eval(store, idx, ys, mask):
        ys = _as(ys, device, torch.long)
        mask = _as(mask, device, torch.float32)
        sums = torch.zeros(4, device=device)
        for i, part in enumerate(_stacked_parts(store, idx, mask)):
            out = _eval_gathered(model, part, mask.shape[1])
            loss, top1, top5, n = _eval_metrics(out.out, ys[i], mask[i],
                                                class_weights)
            sums += torch.stack([loss * n, top1, top5, n])
        return dict(zip(("loss_sum", "top1", "top5", "n"), sums.unbind()))

    return multi_eval


def make_infer_step(model: VideoModel, top_k: int,
                    gather_on_device: bool = False):
    """Inference of the eval CLI, on the model's device, under
    ``torch.inference_mode()`` (the counterpart of the JAX CLI's ``_infer``
    and ``_infer_all``, `ta3n_tpu/cli/test_models.py:158-187`): softmax
    probabilities of the video-level logits, their ``top_k`` (at most the
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
    ``x * mask``.
    """
    device = next(model.parameters()).device
    k = min(top_k, model.cfg.num_class)

    def head(out: StreamOutput):
        probs = torch.softmax(out.out, dim=-1)
        top_p, top_i = torch.topk(probs, k, dim=-1)
        return probs, top_p, top_i, out.attn

    @torch.inference_mode()
    def infer(x):
        x = _as(x, device, torch.float32)
        _, out = model(x[:0], x, _EVAL_BETA, 0.0, False, False)
        return head(out)

    @torch.inference_mode()
    def infer_all(store, idx, mask):
        mask = _as(mask, device, torch.float32)
        outs = [head(_eval_gathered(model, part, mask.shape[1]))
                for part in _stacked_parts(store, idx, mask)]
        return tuple(torch.stack(o) for o in zip(*outs))

    return infer_all if gather_on_device else infer
