"""The TA3N video domain-adaptation model, flagship branches.

Port of `ta3n_tpu/models/video_model.py:130-391` (reference VideoModel,
models.py:58-722) for the published flagship configuration: one shared
FC layer, shared source/target parameters, no BN alignment, multi-scale
TRN aggregation with TransAttn, the video baseline, no MCD, float32.  Any
other configuration value raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it.

As in the JAX package the two streams run as one batch (source videos
first) and are split at the end; the outputs are two `StreamOutput`s with
``pred_domain`` in the reference's post-reversal order (relation, video,
frame).  Module attribute names are the reference ``state_dict`` keys, so
a reference-format checkpoint strict-loads (`io_utils/convert.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models.layers import linear, trans_attn_weights
from ta3n_tpu_torch.models.trn import RelationModuleMultiScale
from ta3n_tpu_torch.ops.grl import grad_reverse

__all__ = ["VideoModel", "StreamOutput"]

# field -> (the value the port runs, the ROADMAP.md queue-1 item porting
# the others)
_FLAGSHIP = {
    "baseline_type": ("video", "6: the frame and tsn baselines"),
    "frame_aggregation": ("trn-m", "6: avgpool, rnn, trn and temconv "
                                   "aggregation"),
    "add_fc": (1, "6: stacked shared FC layers"),
    "share_params": ("Y", "6: share_params=N"),
    "use_bn": ("none", "6: AdaBN and AutoDIAL"),
    "use_attn": ("TransAttn", "6: general attention and no attention"),
    "use_attn_frame": ("none", "6: frame-level attention"),
    "ens_DA": ("none", "6: MCD"),
    "before_softmax": (True, "6: softmax outputs"),
    "quantize": ("none", "10: int8 inference"),
    "compute_dtype": ("float32", "8: the bf16 compute path"),
    "param_dtype": ("float32", "8: the bf16 compute path"),
}


def _check_flagship(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration the port does not
    run yet."""
    for field, (want, item) in _FLAGSHIP.items():
        got = getattr(cfg, field)
        if got != want:
            raise NotImplementedError(
                f"{field}={got!r} is not ported yet; the port runs "
                f"{field}={want!r} (ROADMAP.md queue 1, item {item})")


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (torch's ``F.dropout`` arithmetic) whose mask is
    drawn from ``generator``, a generator on x's device, not from torch's
    global RNG."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on "
                         f"{x.device} (the train step passes one)")
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class StreamOutput(NamedTuple):
    """Per-domain forward outputs, as `ta3n_tpu.models.StreamOutput`."""

    attn: torch.Tensor                      # [B, R]
    out: torch.Tensor                       # logits [B, C]
    out_2: torch.Tensor                     # == out (no MCD)
    pred_domain: Tuple[torch.Tensor, ...]   # relation, video, frame
    feat: Tuple[torch.Tensor, ...]          # reversed feat_all


class VideoModel(nn.Module):
    """The flagship TA3N model, initialised on the CPU from ``generator``
    (a CPU generator; None draws from torch's global one) with the
    reference's init policy (`models/layers.py`), then moved to
    ``device``: the same seed gives the same weights on any device."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cpu"):
        super().__init__()
        _check_flagship(cfg)
        if cfg.train_segments != cfg.val_segments:
            # the TRN's parameters are sized by the segment count
            raise ValueError("trn-m needs train_segments == val_segments, "
                             f"got {cfg.train_segments} and "
                             f"{cfg.val_segments}")
        self.cfg = cfg
        d_in, d_sh = cfg.input_feature_dim, cfg.shared_dim
        d_rel, d_agg = cfg.num_bottleneck, cfg.aggregated_dim
        g = generator

        def n001(i, o):
            return linear(i, o, "normal001", g)

        # shared frame-level FC, frame domain head, frame classifier
        # (models.py:141-192)
        self.fc_feature_shared_source = n001(d_in, d_sh)
        self.fc_feature_domain = n001(d_sh, d_sh)
        self.fc_classifier_domain = n001(d_sh, 2)
        self.fc_classifier_source = n001(d_sh, cfg.num_class)
        self.TRN = RelationModuleMultiScale(d_sh, d_rel, cfg.train_segments,
                                            generator=g)
        # relation domain heads: torch default init, built outside the
        # reference's normal_(0.001) loop (models.py:286-294)
        self.relation_domain_classifier_all = nn.ModuleList(
            nn.Sequential(linear(d_rel, d_agg, "torch_default", g),
                          nn.ReLU(),
                          linear(d_agg, 2, "torch_default", g))
            for _ in range(cfg.train_segments - 1))
        self.fc_classifier_video_source = n001(d_agg, cfg.num_class)
        self.fc_feature_domain_video = n001(d_agg, d_agg)
        self.fc_classifier_domain_video = n001(d_agg, 2)
        self.to(device)

    def forward(self, input_source: torch.Tensor, input_target: torch.Tensor,
                beta, mu, is_train: bool = True, reverse: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[StreamOutput, StreamOutput]:
        """Dual-stream forward (reference forward, models.py:545-722).

        input_source [Bs, S, D], input_target [Bt, S, D] (either may be
        empty); beta: (3,) GRL strengths [relation, video, frame], a tensor
        or a sequence of numbers; mu: GRL strength of the MCD reverse step.
        ``generator`` (on the inputs' device) draws the two dropout masks;
        it is needed when ``is_train`` and a dropout rate is above 0.
        """
        cfg = self.cfg
        num_segments = cfg.train_segments if is_train else cfg.val_segments
        if input_source.shape[1] != num_segments:
            raise ValueError(f"expected {num_segments} segments, got "
                             f"{input_source.shape[1]}")
        bs, bt = input_source.shape[0], input_target.shape[0]
        x = torch.cat([input_source, input_target], dim=0)
        # shared frame-level FC (models.py:565-603)
        pre = self.fc_feature_shared_source(
            x.reshape((bs + bt) * num_segments, -1))
        return self.forward_shared(pre, bs, bt, beta, mu, is_train, reverse,
                                   generator)

    def forward_shared(self, pre: torch.Tensor, bs: int, bt: int, beta, mu,
                       is_train: bool = True, reverse: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[StreamOutput, StreamOutput]:
        """The forward from the shared FC's pre-activations on: ``pre``
        [(bs+bt)*S, fc] holds the frame rows of the bs source videos, then
        of the bt target videos.  The device-store steps compute ``pre``
        with the fused gather + FC (`ops/gather_gemm.py`), as the JAX
        model's ``combined_rows`` entry takes rows gathered on the device;
        ``forward`` computes it from feature arrays.  The other arguments
        are those of ``forward``."""
        cfg = self.cfg
        num_segments = cfg.train_segments if is_train else cfg.val_segments
        b_all = bs + bt
        if pre.shape[0] != b_all * num_segments:
            raise ValueError(f"expected {b_all * num_segments} frame rows "
                             f"for {b_all} videos, got {pre.shape[0]}")
        feat_all = []

        f = torch.relu(pre)
        f = _dropout(f, cfg.dropout_i, is_train, generator)
        feat_all.append(f.reshape(b_all, num_segments, -1))

        # frame-level adversarial branch (models.py:605-610)
        h = grad_reverse(f, beta[2])
        h = torch.relu(self.fc_feature_domain(h))
        pred_domain_frame = self.fc_classifier_domain(h)

        # the frame classifier (models.py:616-621) feeds only the frame and
        # tsn baselines: the video baseline never reads it

        # multi-scale TRN aggregation (models.py:623-651)
        rel = self.TRN(f.reshape(b_all, num_segments, -1),
                       infer=not is_train)
        rel_rev = grad_reverse(rel, beta[0])
        pred_domain_relation = torch.stack(
            [head(rel_rev[:, i])
             for i, head in enumerate(self.relation_domain_classifier_all)],
            dim=1)                                        # [B, R, 2]
        attn = trans_attn_weights(pred_domain_relation)   # [B, R]
        rel = (attn[..., None] + 1) * rel
        feat_video = rel.sum(dim=1)
        feat_all.append(feat_video)

        # video-level classifier (models.py:678-691)
        feat_video = _dropout(feat_video, cfg.dropout_v, is_train,
                              generator)
        if reverse:
            feat_video = grad_reverse(feat_video, mu)  # MCD step 2
        pred_video = self.fc_classifier_video_source(feat_video)
        feat_all.append(pred_video)

        # video-level adversarial branch (models.py:693-698)
        hv = grad_reverse(feat_video, beta[1])
        hv = torch.relu(self.fc_feature_domain_video(hv))
        pred_domain_video = self.fc_classifier_domain_video(hv)

        # split the fused batch back into the two streams
        pred_domain = (pred_domain_relation, pred_domain_video,
                       pred_domain_frame.reshape(b_all, num_segments, 2))
        pd_s, pd_t = zip(*((p[:bs], p[bs:]) for p in pred_domain))
        ft_s, ft_t = zip(*((t[:bs], t[bs:]) for t in reversed(feat_all)))
        out_s, out_t = pred_video[:bs], pred_video[bs:]
        return (StreamOutput(attn[:bs], out_s, out_s, pd_s, ft_s),
                StreamOutput(attn[bs:], out_t, out_t, pd_t, ft_t))
