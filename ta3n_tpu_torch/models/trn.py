"""Multi-scale Temporal Relation Network aggregator.

Port of `ta3n_tpu/models/trn.py:80-161` (`RelationModuleMultiScale`,
reference TRNmodule.py:27-86).  The parameters keep the reference's
module layout, ``fc_fusion_scales.{i}`` = Sequential(ReLU, Linear, ReLU),
so a reference ``state_dict`` loads as it is; the forward runs the fused
op on each scale's Linear parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ta3n_tpu_torch.models.layers import linear
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.ops.trn_fused import (trn_multiscale_infer,
                                          trn_multiscale_plain)

__all__ = ["RelationModuleMultiScale"]


class RelationModuleMultiScale(nn.Module):
    """[B, S, D] -> [B, S-1, H]: one summed relation feature per scale
    k = S..2, over the deterministic subset selection of `ops/relation.py`.

    Init: torch's default Linear init (the reference's normal_(0.001) loop
    never touches the TRN fusion Linears, TRNmodule.py:50).
    """

    def __init__(self, img_feature_dim: int, num_bottleneck: int,
                 num_frames: int, subsample_num: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_frames = num_frames
        self.subsample_num = subsample_num
        plan = build_relation_plan(num_frames, subsample_num)
        self.fc_fusion_scales = nn.ModuleList(
            nn.Sequential(nn.ReLU(),
                          linear(k * img_feature_dim, num_bottleneck,
                                 "torch_default", generator),
                          nn.ReLU())
            for k in plan.scales)

    def forward(self, x: torch.Tensor, infer: bool = False) -> torch.Tensor:
        """``infer=True`` (eval and serve) takes the fused inference op,
        which on CUDA is the hand-written kernel; ``infer=False`` the
        plain, differentiable version, which on CUDA waits for the
        training kernels."""
        if x.shape[1] != self.num_frames:
            raise ValueError(f"expected {self.num_frames} segments, got "
                             f"{x.shape[1]}")
        weights = [seq[1].weight for seq in self.fc_fusion_scales]
        biases = [seq[1].bias for seq in self.fc_fusion_scales]
        if infer:
            return trn_multiscale_infer(x, weights, biases, self.num_frames,
                                        self.subsample_num)
        if x.device.type == "cuda":
            raise NotImplementedError(
                "the TRN training forward on CUDA is not ported yet (ROADMAP "
                "queue 1, item 3: the train step with the TRN training "
                "kernels)")
        return trn_multiscale_plain(x, weights, biases, self.num_frames,
                                    self.subsample_num)
