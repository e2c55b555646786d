"""Static configuration of the port: its own copy of the JAX package's
`ta3n_tpu/config.py` (``ModelConfig``, ``DAConfig``, ``TrainConfig`` and
the backbone feature-dimension table), with the same fields, defaults and
properties.  tests/test_torch_port_imports.py holds the two equal.

Mirrors the reference flag surface (`opts.py:1-119`) as typed dataclasses.
Schedules and per-step scalars (beta, lr, alpha, gamma, mu) are arguments
of the train step instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Feature dims of the frozen backbone used for offline extraction.  The
# reference probes a live torchvision model just to read `fc.in_features`
# (models.py:119-126, downloads pretrained weights as a side effect); we use
# a static table instead.
BACKBONE_FEATURE_DIM = {
    "resnet18": 512,
    "resnet34": 512,
    "resnet50": 2048,
    "resnet101": 2048,
    "resnet152": 2048,
    "alexnet": 4096,
    "vgg16": 4096,
    "c3d": 4096,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyper-parameters (reference VideoModel.__init__,
    models.py:58-117, driven by opts.py)."""

    num_class: int
    baseline_type: str = "frame"          # frame | video | tsn
    frame_aggregation: str = "avgpool"    # avgpool | rnn | temconv | trn | trn-m | none
    modality: str = "RGB"
    train_segments: int = 5
    val_segments: int = 5
    base_model: str = "resnet101"
    feature_dim: Optional[int] = None     # overrides BACKBONE_FEATURE_DIM
    new_length: Optional[int] = None      # 1 for RGB, 5 otherwise (models.py:96-99)
    before_softmax: bool = True
    dropout_i: float = 0.5
    dropout_v: float = 0.5
    use_bn: str = "none"                  # none | AdaBN | AutoDIAL
    ens_DA: str = "none"                  # none | MCD
    add_fc: int = 1
    fc_dim: int = 1024
    # RNN aggregation
    n_rnn: int = 1
    rnn_cell: str = "LSTM"                # LSTM | GRU
    n_directions: int = 1
    n_ts: int = 5
    # attention
    use_attn: str = "TransAttn"           # none | TransAttn | general
    n_attn: int = 1
    use_attn_frame: str = "none"
    share_params: str = "Y"               # Y | N
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"        # bfloat16 for the fast path
    # inference-only int8 quantization (W8A8 dynamic): large dense
    # GEMMs (both dims >= 128) run as int8 x int8 -> int32 dots with
    # per-output-channel weight scales and per-row activation scales;
    # small heads (num_class / 2-way domain logits) stay f32.  Training
    # rejects it (round() has zero gradient) — see train/step.py.
    quantize: str = "none"                # none | int8

    def __post_init__(self):
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}; "
                             "expected 'none' or 'int8'")
        if self.add_fc < 1:
            raise ValueError("add at least one fc layer")  # models.py:137-138
        if self.baseline_type not in ("frame", "video", "tsn"):
            raise ValueError(f"unknown baseline_type {self.baseline_type}")
        if self.frame_aggregation not in (
                "avgpool", "rnn", "temconv", "trn", "trn-m", "none"):
            raise ValueError(
                f"unknown frame_aggregation {self.frame_aggregation}")
        if self.frame_aggregation == "none":
            # 'none' is accepted by the reference CLI (opts.py:19-20,
            # "none if baseline_type is not video") but its forward still
            # unconditionally aggregates and crashes on it; we map it to
            # avgpool, which is what frame/tsn baselines effectively use.
            object.__setattr__(self, "frame_aggregation", "avgpool")
        if self.use_attn in ("DotProduct",):
            # Accepted-but-unimplemented in the reference (opts.py:50-51);
            # we reject it loudly instead of silently doing nothing.
            raise ValueError("use_attn DotProduct is not implemented "
                             "(unimplemented in the reference as well)")
        if self.use_attn_frame in ("DotProduct",):
            # same accepted-but-unimplemented flag value on the frame
            # level (reference opts.py:50-51 / models.py:369 fallthrough)
            raise ValueError("use_attn_frame DotProduct is not implemented "
                             "(unimplemented in the reference as well)")

    @property
    def input_feature_dim(self) -> int:
        if self.feature_dim is not None:
            return self.feature_dim
        try:
            return BACKBONE_FEATURE_DIM[self.base_model]
        except KeyError:
            raise ValueError(f"unknown base_model {self.base_model}; "
                             "pass feature_dim explicitly") from None

    @property
    def shared_dim(self) -> int:
        # models.py:129: min(fc_dim, feature_dim) when add_fc>0 and fc_dim>0
        if self.add_fc > 0 and self.fc_dim > 0:
            return min(self.fc_dim, self.input_feature_dim)
        return self.input_feature_dim

    @property
    def aggregated_dim(self) -> int:
        # models.py:246-253
        if self.frame_aggregation in ("trn", "trn-m"):
            return self.num_bottleneck
        return self.shared_dim

    @property
    def num_bottleneck(self) -> int:
        # models.py:218,223
        if self.frame_aggregation == "trn":
            return 512
        if self.frame_aggregation == "trn-m":
            return 256
        return 0

    @property
    def sample_new_length(self) -> int:
        if self.new_length is not None:
            return self.new_length
        # RGB -> 1; Flow/Diff -> 5; Diff variants need one extra frame for
        # the difference (dataset.py:48-49, models.py:96-99)
        if self.modality == "RGB":
            return 1
        if self.modality.startswith("RGBDiff"):
            return 6
        return 5


@dataclasses.dataclass(frozen=True)
class DAConfig:
    """Domain-adaptation loss configuration (opts.py:40-68)."""

    use_target: str = "none"              # none | Sv | uSv
    dis_DA: str = "none"                  # none | DAN | JAN | CORAL
    adv_DA: str = "none"                  # none | RevGrad
    add_loss_DA: str = "none"             # none | target_entropy | attentive_entropy
    ens_DA: str = "none"                  # none | MCD
    pretrain_source: bool = False
    place_dis: Tuple[str, ...] = ("Y", "Y", "N")
    place_adv: Tuple[str, ...] = ("Y", "Y", "Y")
    weighted_class_loss: str = "N"
    weighted_class_loss_DA: str = "N"
    pred_normalize: str = "N"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule configuration (opts.py:71-91)."""

    optimizer: str = "SGD"                # SGD | Adam
    lr: float = 0.0001
    lr_decay: float = 10.0
    lr_adaptive: str = "none"             # none | loss | dann
    lr_steps: Tuple[float, ...] = (60.0, 100.0)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_gradient: Optional[float] = 20.0
    # the JAX package's raveled-vector optimizer (optim.FlatOptimizer), a
    # TPU dispatch workaround with the same arithmetic; the port's
    # torch.optim.SGD ignores it (ROADMAP.md queue 1, item 11)
    fused_optimizer: bool = False
    epochs: int = 100
    batch_size: Tuple[int, int, int] = (32, 28, 64)   # [source, target, val]
    copy_list: Tuple[str, ...] = ("N", "Y")
    # loss weights; negative values select the schedule (opts.py:56-63)
    alpha: float = 1.0
    beta: Tuple[float, ...] = (1.0, 1.0, 1.0)
    gamma: float = 1.0
    mu: float = 0.0
