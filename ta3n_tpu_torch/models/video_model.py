"""The TA3N video domain-adaptation model.

Port of `ta3n_tpu/models/video_model.py:130-391` (reference VideoModel,
models.py:58-722): the video, frame and tsn baselines; one to three
shared FC layers, shared or per-domain parameters (``share_params``),
AdaBN/AutoDIAL alignment after the first shared layer, frame-level
TransAttn or general attention; avgpool, RNN (`models/rnn.py`), temconv,
single-scale TRN or multi-scale TRN aggregation with TransAttn, general or
no relation attention; softmax outputs and MCD's second video classifier,
in float32 or bfloat16 (``compute_dtype``), and int8 inference
(``quantize="int8"``).

Under ``quantize="int8"`` the Linears that the JAX model builds with
``quantize=cfg.quantize`` (`ta3n_tpu/models/video_model.py:75, 79, 198,
211, 246-252, 274-282, 296, 342`) compute as JAX's ``QuantDense``
(`models/layers.py::Linear`): the shared FCs, the frame and video domain
FCs, general attention, the TRN (`models/trn.py`, without the fused op)
and the relation domain heads' first layers, head by head, which is
``int8_batched_matmul``'s arithmetic (per-(head, output) weight scales,
per-(row, head) activation scales).  The gate keeps every Linear with a
dim below 128 in float32: the 2-way domain logits and, at the published
class counts, the class logits.  Inference only (the train-step builders
refuse it), and at float32 compute, as the JAX CLIs that quantize run.

Under ``compute_dtype="bfloat16"`` the model casts where the JAX model
casts (`ta3n_tpu/models/video_model.py`), with explicit ``.to(dtype)``
and never ``torch.autocast``, which rounds at other places: the frame
rows enter in bfloat16 (:171-175); every Dense layer computes as a
bfloat16 ``nn.Dense`` (`models/layers.py::Linear`); TransAttn weights
are computed on float32 domain logits and cast back (:208, :234, :292);
the relation heads (:279-287), the video heads (:340-346) and the TRN
(`models/trn.py`) compute in bfloat16; general attention, the TCL and the
RNN compute in float32, as flax promotes their bfloat16 inputs to their
float32 parameters.  The parameters stay float32 whatever
``param_dtype`` says (the JAX package reads that field nowhere), so
every ``StreamOutput`` field has its JAX counterpart's dtype.

The frame baseline's output ``out`` is the frame classifier's logits
[B, S, C]; the tsn baseline's is their mean over the segments [B, C]; the
video baseline's is the video classifier's [B, C].  ``feat`` is the
reference's reversed ``feat_all``: the video baseline's
(video logits, video feature, shared layers last to first), the frame
baseline's (frame logits [B, S, C], shared layers), the tsn baseline's
(shared layers).

As in the JAX package the two streams run as one batch (source videos
first) and are split at the end; the outputs are two `StreamOutput`s with
``pred_domain`` in the reference's post-reversal order (relation, video,
frame).  Under ``share_params='N'`` a row of the batch takes the source
layer when it belongs to a source video and the target layer otherwise.
Module attribute names are the reference ``state_dict`` keys, so a
reference-format checkpoint strict-loads (`io_utils/convert.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models.layers import (TCL, GeneralAttn,
                                          MaskedBatchNorm, linear,
                                          trans_attn_weights)
from ta3n_tpu_torch.models.rnn import build_rnn, rnn_aggregate
from ta3n_tpu_torch.models.trn import (RelationModule,
                                       RelationModuleMultiScale)
from ta3n_tpu_torch.ops.grl import grad_reverse

__all__ = ["VideoModel", "StreamOutput", "MemberGenerators"]

# the compute dtypes whose kernels the port has (float16 has none)
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference builds at most three shared FC layers: its parameter names
# stop at fc_feature_shared_3_* (models.py:141-192)
_MAX_FC = 3


def _check_config(cfg: ModelConfig) -> None:
    """Raise ValueError for a configuration the port cannot build."""
    if cfg.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: the port "
                         f"computes in {' or '.join(_COMPUTE_DTYPES)}")
    if cfg.add_fc > _MAX_FC:
        raise ValueError(f"add_fc={cfg.add_fc}: the reference has at most "
                         f"{_MAX_FC} shared FC layers")
    if cfg.quantize == "int8" and cfg.compute_dtype != "float32":
        # the JAX CLIs that quantize (eval, serve) compute in float32 only
        raise ValueError(f"quantize='int8' computes in float32, got "
                         f"compute_dtype={cfg.compute_dtype!r}")


def _in(layer, dtype: torch.dtype, quantize: str = "none"):
    """``layer`` (a `Linear`) computing in ``dtype``, quantized as
    ``quantize`` says."""
    layer.compute_dtype = dtype
    layer.quantize = quantize
    return layer


class MemberGenerators(NamedTuple):
    """The dropout generators of N stacked members, for a forward under
    ``torch.func.vmap`` (`train/ensemble.py`): passed where a forward takes
    its generator, with ``member`` the batched member id (a 0-d tensor under
    the transform).  Each dropout site draws member k's mask from
    ``generators[k]``, in the order and shape of a solo forward, so member
    k's masks are bitwise those of the solo run seeded k."""

    generators: Sequence[torch.Generator]
    member: torch.Tensor

    def keep(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """Member-batched keep mask for x (x's shape per member)."""
        masks = torch.stack([
            torch.empty(x.shape, dtype=x.dtype, device=x.device)
            .bernoulli_(1.0 - p, generator=g) for g in self.generators])
        return masks.index_select(0, self.member.reshape(1))[0]


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator) -> torch.Tensor:
    """Inverted dropout (torch's ``F.dropout`` arithmetic) whose mask is
    drawn from ``generator``, a generator on x's device (or the members'
    `MemberGenerators`), not from torch's global RNG."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on "
                         f"{x.device} (the train step passes one)")
    if isinstance(generator, MemberGenerators):
        keep = generator.keep(x, p)
    else:
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class StreamOutput(NamedTuple):
    """Per-domain forward outputs, as `ta3n_tpu.models.StreamOutput`."""

    attn: torch.Tensor                      # [B, R] (TRN) or [B] (others)
    out: torch.Tensor                       # logits [B, C] ([B, S, C]: frame)
    out_2: torch.Tensor                     # MCD's second classifier (or out)
    pred_domain: Tuple[torch.Tensor, ...]   # relation, video, frame
    feat: Tuple[torch.Tensor, ...]          # reversed feat_all


class VideoModel(nn.Module):
    """The TA3N model, initialised on the CPU from ``generator`` (a CPU
    generator; None draws from torch's global one) with the reference's
    init policy (`models/layers.py`), then moved to ``device``: the same
    seed gives the same weights on any device."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cpu"):
        super().__init__()
        _check_config(cfg)
        trn = cfg.frame_aggregation in ("trn", "trn-m")
        if trn and cfg.train_segments != cfg.val_segments:
            # the TRN's parameters are sized by the segment count
            raise ValueError(f"{cfg.frame_aggregation} needs train_segments "
                             f"== val_segments, got {cfg.train_segments} "
                             f"and {cfg.val_segments}")
        self.cfg = cfg
        self.dtype = dt = _COMPUTE_DTYPES[cfg.compute_dtype]
        d_in, d_sh = cfg.input_feature_dim, cfg.shared_dim
        d_agg = cfg.aggregated_dim
        g = generator
        q = cfg.quantize
        domains = ("source",) if cfg.share_params == "Y" else ("source",
                                                               "target")

        def n001(i, o, quantize=q):
            """A Dense layer of the compute dtype (``dense(dtype=dtype,
            quantize=...)`` in the JAX model)."""
            return _in(linear(i, o, "normal001", g), dt, quantize)

        def dual(name, i, o):
            """The source layer and, under share_params N, the target
            layer (models.py:174-192, 296-305)."""
            for dom in domains:
                setattr(self, f"{name}_{dom}", n001(i, o))

        # shared frame-level FC stack, BN alignment, frame domain head,
        # frame classifier (models.py:141-199)
        for li in range(cfg.add_fc):
            suffix = "" if li == 0 else f"_{li + 1}"
            dual(f"fc_feature_shared{suffix}", d_in if li == 0 else d_sh,
                 d_sh)
        if cfg.use_bn != "none":
            self.bn_shared_S = MaskedBatchNorm(d_sh)
            self.bn_shared_T = MaskedBatchNorm(d_sh)
        self.fc_feature_domain = n001(d_sh, d_sh)
        self.fc_classifier_domain = n001(d_sh, 2, "none")
        dual("fc_classifier", d_sh, cfg.num_class)
        if cfg.use_attn_frame == "general":
            # no reference name: the reference reads use_attn here and
            # crashes when only use_attn_frame is set (models.py:369)
            self.attn_layer_frame = GeneralAttn(d_sh, g, q)
        if trn:
            d_rel = cfg.num_bottleneck
            if cfg.frame_aggregation == "trn":
                self.TRN = RelationModule(d_sh, d_rel, cfg.train_segments,
                                          generator=g, dtype=dt, quantize=q)
                num_relation = 1
            else:
                self.TRN = RelationModuleMultiScale(
                    d_sh, d_rel, cfg.train_segments, generator=g, dtype=dt,
                    quantize=q)
                num_relation = cfg.train_segments - 1
            # relation domain heads: torch default init, built outside the
            # reference's normal_(0.001) loop (models.py:286-294)
            self.relation_domain_classifier_all = nn.ModuleList(
                nn.Sequential(
                    _in(linear(d_rel, d_agg, "torch_default", g), dt, q),
                    nn.ReLU(),
                    _in(linear(d_agg, 2, "torch_default", g), dt))
                for _ in range(num_relation))
            if cfg.use_attn == "general":
                self.attn_layer = GeneralAttn(d_agg, g, q)
        if cfg.frame_aggregation == "rnn":
            self.rnn = build_rnn(cfg, g)
            # cuDNN's fast path wants the weights in one buffer: .to()
            # flattens them (RNNBase._apply), and so does every load
            self.register_load_state_dict_post_hook(
                lambda module, _: module.rnn.flatten_parameters())
        elif cfg.frame_aggregation == "temconv":
            # the first TCL and its BN pair (models.py:228-233); the rest
            # of the reference's temconv modules never run in its forward
            self.tcl_3_1 = TCL(3, g)
            if cfg.use_bn != "none":
                self.bn_1_S = MaskedBatchNorm(d_sh)
                self.bn_1_T = MaskedBatchNorm(d_sh)
        dual("fc_classifier_video", d_agg, cfg.num_class)
        if cfg.ens_DA == "MCD":
            for dom in domains:
                setattr(self, f"fc_classifier_video_{dom}_2",
                        n001(d_agg, cfg.num_class))
        self.fc_feature_domain_video = n001(d_agg, d_agg)
        self.fc_classifier_domain_video = n001(d_agg, 2, "none")
        if cfg.use_bn == "AutoDIAL":
            # the reference's learned mixing weight (models.py:314-316)
            self.alpha = nn.Parameter(torch.ones(()))
        self.to(device)

    def shared_fc(self, domain: str) -> nn.Linear:
        """The first shared FC layer of ``domain``, "source" or "target":
        under share_params Y both are fc_feature_shared_source."""
        if self.cfg.share_params == "Y":
            domain = "source"
        return getattr(self, f"fc_feature_shared_{domain}")

    def _dual(self, name: str, x: torch.Tensor, n_source_rows: int,
              suffix: str = "") -> torch.Tensor:
        """Layer ``name`` on x's rows: under share_params N the first
        n_source_rows rows take ``{name}_source{suffix}`` and the others
        ``{name}_target{suffix}`` (`ta3n_tpu/models/video_model.py::
        _dual_dense`), else every row takes ``{name}_source{suffix}``."""
        layer_s = getattr(self, f"{name}_source{suffix}")
        if self.cfg.share_params == "Y":
            return layer_s(x)
        layer_t = getattr(self, f"{name}_target{suffix}")
        return torch.cat([layer_s(x[:n_source_rows]),
                          layer_t(x[n_source_rows:])])

    def shared_pre(self, input_source: torch.Tensor,
                   input_target: torch.Tensor) -> torch.Tensor:
        """The first shared FC's pre-activations [(bs+bt)*S, fc] of the
        two streams' features [bs, S, D] and [bt, S, D], source rows
        first (models.py:565-603)."""
        s = input_source.shape[1]
        if input_target.shape[1] != s:
            raise ValueError(f"the streams have {s} and "
                             f"{input_target.shape[1]} segments")
        x = torch.cat([input_source, input_target], dim=0)
        return self._dual("fc_feature_shared",
                          x.reshape(-1, x.shape[-1]).to(self.dtype),
                          input_source.shape[0] * s)

    def forward(self, input_source: torch.Tensor, input_target: torch.Tensor,
                beta, mu, is_train: bool = True, reverse: bool = False,
                generator: Optional[torch.Generator] = None,
                mask_source: Optional[torch.Tensor] = None,
                mask_target: Optional[torch.Tensor] = None
                ) -> Tuple[StreamOutput, StreamOutput]:
        """Dual-stream forward (reference forward, models.py:545-722).

        input_source [Bs, S, D], input_target [Bt, S, D] (either may be
        empty); beta: (3,) GRL strengths [relation, video, frame], a tensor
        or a sequence of numbers; mu: GRL strength of the MCD reverse step,
        applied to the video feature when ``reverse``.  ``generator`` (on
        the inputs' device) draws the dropout masks; it is needed when
        ``is_train`` and a dropout rate is above 0.  mask_source [Bs] and
        mask_target [Bt], the loader's 0/1 video masks, keep padded videos
        out of the BN statistics (AdaBN/AutoDIAL; None: every video
        counts).
        """
        num_segments = (self.cfg.train_segments if is_train
                        else self.cfg.val_segments)
        if input_source.shape[1] != num_segments:
            raise ValueError(f"expected {num_segments} segments, got "
                             f"{input_source.shape[1]}")
        pre = self.shared_pre(input_source, input_target)
        return self.forward_shared(pre, input_source.shape[0],
                                   input_target.shape[0], beta, mu,
                                   is_train, reverse, generator,
                                   mask_source, mask_target)

    def _domain_align(self, x: torch.Tensor, bn_name: str, is_train: bool,
                      bs: int, bt: int, rows_per_video: int,
                      mask_s: Optional[torch.Tensor],
                      mask_t: Optional[torch.Tensor]) -> torch.Tensor:
        """AdaBN / AutoDIAL at the BN pair ``{bn_name}_S`` /
        ``{bn_name}_T``: each row normalised by BN_S or BN_T, each BN's
        statistics over the rows routed to it (`ta3n_tpu/models/
        video_model.py::_domain_align`, reference domainAlign,
        models.py:490-543, with the JAX package's two documented fixes).
        In training the first round(batch * max(alpha, 0.5)) videos of
        each domain go to their own BN and the rest to the other one, when
        both domains have such a rest; otherwise, and in eval, each domain
        to its own.  torch.round rounds half to even, as jnp.round.
        Padded videos count in neither BN's statistics.  alpha enters
        detached, so that it gets no gradient and SGD skips it (in the
        JAX step its gradient through round() is a structural zero)."""
        if self.cfg.use_bn == "AutoDIAL":
            alpha = self.alpha.detach()
        else:
            alpha = torch.ones((), device=x.device)
        alpha_c = alpha.clamp(min=0.5)
        n_s1 = torch.round(bs * alpha_c)
        n_t1 = torch.round(bt * alpha_c)
        own_s = torch.arange(bs, device=x.device) < n_s1
        own_t = torch.arange(bt, device=x.device) < n_t1
        if is_train:
            mixing = (bs - n_s1 > 0) & (bt - n_t1 > 0)
            own_s = own_s | ~mixing
            own_t = own_t | ~mixing
        else:
            own_s, own_t = torch.ones_like(own_s), torch.ones_like(own_t)
        to_s = torch.cat([own_s, ~own_t]).repeat_interleave(rows_per_video)
        w_s = to_s.to(x.dtype)
        w_t = 1.0 - w_s
        if mask_s is not None:
            valid = torch.cat([mask_s, mask_t]).to(x.dtype) \
                .repeat_interleave(rows_per_video)
            w_s, w_t = w_s * valid, w_t * valid
        bn_s = getattr(self, f"{bn_name}_S")
        bn_t = getattr(self, f"{bn_name}_T")
        y_s = bn_s(x, w_s, use_running_average=not is_train)
        y_t = bn_t(x, w_t, use_running_average=not is_train)
        return torch.where(w_s[:, None] > 0, y_s, y_t)

    def temconv_pre(self, feat_seg: torch.Tensor, is_train: bool, bs: int,
                    bt: int, mask_s: Optional[torch.Tensor],
                    mask_t: Optional[torch.Tensor]) -> torch.Tensor:
        """temconv's frame rows before their relu [B, S, D]: the first TCL
        over the segments, then, under AdaBN/AutoDIAL, the bn_1 pair's
        alignment with per-row statistic weights repeated per frame
        (models.py:654-663)."""
        b, s = feat_seg.shape[:2]
        x = self.tcl_3_1(feat_seg)
        if self.cfg.use_bn != "none":
            x = self._domain_align(x.reshape(b * s, -1), "bn_1", is_train,
                                   bs, bt, s, mask_s, mask_t)
        return x.reshape(b, s, -1)

    def forward_shared(self, pre: torch.Tensor, bs: int, bt: int, beta, mu,
                       is_train: bool = True, reverse: bool = False,
                       generator: Optional[torch.Generator] = None,
                       mask_source: Optional[torch.Tensor] = None,
                       mask_target: Optional[torch.Tensor] = None
                       ) -> Tuple[StreamOutput, StreamOutput]:
        """The forward from the first shared FC's pre-activations on:
        ``pre`` [(bs+bt)*S, fc] holds the frame rows of the bs source
        videos, then of the bt target videos.  The device-store steps
        compute ``pre`` with the fused gather + FC (`ops/gather_gemm.py`),
        as the JAX model's ``combined_rows`` entry takes rows gathered on
        the device; ``forward`` computes it from feature arrays
        (``shared_pre``).  The other arguments are those of ``forward``."""
        cfg = self.cfg
        num_segments = cfg.train_segments if is_train else cfg.val_segments
        b_all = bs + bt
        if pre.shape[0] != b_all * num_segments:
            raise ValueError(f"expected {b_all * num_segments} frame rows "
                             f"for {b_all} videos, got {pre.shape[0]}")
        n_src_rows = bs * num_segments
        feat_all = []

        # shared frame-level FC stack (models.py:565-603)
        f = pre
        for li in range(cfg.add_fc):
            if li > 0:
                f = self._dual(f"fc_feature_shared_{li + 1}", f, n_src_rows)
            elif cfg.use_bn != "none":
                f = self._domain_align(f, "bn_shared", is_train, bs, bt,
                                       num_segments, mask_source,
                                       mask_target)
            f = torch.relu(f)
            f = _dropout(f, cfg.dropout_i, is_train, generator)
            feat_all.append(f.reshape(b_all, num_segments, -1))

        # frame-level adversarial branch (models.py:605-610)
        h = grad_reverse(f, beta[2])
        h = torch.relu(self.fc_feature_domain(h))
        pred_domain_frame = self.fc_classifier_domain(h)
        pred_domain_frame_3d = pred_domain_frame.reshape(b_all, num_segments,
                                                         2)

        # frame-level attention (models.py:368-377, 612-614), keyed by
        # use_attn_frame as in the JAX package
        dt = self.dtype
        if cfg.use_attn_frame == "TransAttn":
            w = trans_attn_weights(pred_domain_frame.float())
            f = (w[:, None].to(dt) + 1) * f
        elif cfg.use_attn_frame == "general":
            w = self.attn_layer_frame(f.reshape(b_all, num_segments, -1))
            f = (w.reshape(-1, 1).to(dt) + 1) * f

        # the frame classifier (models.py:616-621) feeds only the frame and
        # tsn baselines: the video baseline never reads it
        video = cfg.baseline_type == "video"
        if not video:
            pred_frame = self._dual("fc_classifier", f, n_src_rows) \
                .reshape(b_all, num_segments, -1)
            if cfg.baseline_type == "frame":
                feat_all.append(pred_frame)

        # aggregation: frames -> video (models.py:623-672)
        feat_seg = f.reshape(b_all, num_segments, -1)
        if cfg.frame_aggregation in ("avgpool", "rnn", "temconv"):
            if cfg.frame_aggregation == "rnn":
                feat_video = rnn_aggregate(self.rnn, feat_seg, cfg.n_ts)
            elif cfg.frame_aggregation == "temconv":
                feat_video = torch.relu(self.temconv_pre(
                    feat_seg, is_train, bs, bt, mask_source,
                    mask_target)).mean(dim=1)
            else:
                if cfg.use_attn == "TransAttn":  # models.py:427-430
                    w = trans_attn_weights(pred_domain_frame_3d.float())
                    feat_seg = (w[..., None].to(dt) + 1) * feat_seg
                feat_video = feat_seg.mean(dim=1)
            attn = feat_video[:, 0]  # the reference's junk value
            pred_domain_relation = None
        else:
            rel = self.TRN(feat_seg, infer=not is_train)     # [B, R, H]
            rel_rev = grad_reverse(rel, beta[0])
            pred_domain_relation = torch.stack(
                [head(rel_rev[:, i])
                 for i, head in enumerate(self.relation_domain_classifier_all)],
                dim=1)                                        # [B, R, 2]
            if cfg.use_attn == "TransAttn":  # models.py:379-388, 643-648
                attn = trans_attn_weights(pred_domain_relation.float())
                rel = (attn[..., None].to(dt) + 1) * rel      # attn [B, R]
            elif cfg.use_attn == "general":
                w = self.attn_layer(rel)                      # [B, R, 1]
                rel = (w.to(dt) + 1) * rel
                attn = w[:, :, 0]
            else:
                attn = rel[:, :, 0]
            feat_video = rel.sum(dim=1)
        if video:
            feat_all.append(feat_video)

        # video-level classifier (models.py:678-691)
        feat_video = _dropout(feat_video, cfg.dropout_v, is_train,
                              generator)
        if reverse:
            feat_video = grad_reverse(feat_video, mu)  # MCD step 2
        if video:
            pred_video = self._dual("fc_classifier_video", feat_video, bs)
            feat_all.append(pred_video)

        # video-level adversarial branch (models.py:693-698)
        hv = grad_reverse(feat_video, beta[1])
        hv = torch.relu(self.fc_feature_domain_video(hv))
        pred_domain_video = self.fc_classifier_domain_video(hv)
        if pred_domain_relation is None:
            # no relations: the relation slot holds the video-level logits
            # (models.py:705-707)
            pred_domain_relation = pred_domain_video

        # outputs (models.py:437-454, 709-720): the frame logits keep
        # their segment axis, as in the JAX package
        def final(logits):
            return logits if cfg.before_softmax else torch.softmax(logits,
                                                                   dim=-1)

        if video:
            out = final(pred_video)
            out_2 = (final(self._dual("fc_classifier_video", feat_video,
                                      bs, suffix="_2"))
                     if cfg.ens_DA == "MCD" else out)
        else:
            # MCD's second output is the frame classifier's as well
            out = out_2 = final(pred_frame.mean(dim=1)
                                if cfg.baseline_type == "tsn"
                                else pred_frame)

        # split the fused batch back into the two streams
        pred_domain = (pred_domain_relation, pred_domain_video,
                       pred_domain_frame_3d)
        pd_s, pd_t = zip(*((p[:bs], p[bs:]) for p in pred_domain))
        ft_s, ft_t = zip(*((t[:bs], t[bs:]) for t in reversed(feat_all)))
        return (StreamOutput(attn[:bs], out[:bs], out_2[:bs], pd_s, ft_s),
                StreamOutput(attn[bs:], out[bs:], out_2[bs:], pd_t, ft_t))
