"""Temporal Relation Network aggregators, single- and multi-scale.

Ports of `ta3n_tpu/models/trn.py:47-161` (`RelationModule` and
`RelationModuleMultiScale`, reference TRNmodule.py:6-86).  The parameters
keep the reference's module layout, ``classifier`` and
``fc_fusion_scales.{i}``, each a Sequential(ReLU, Linear, ReLU), so a
reference ``state_dict`` loads as it is.  The multi-scale forward runs the
fused ops (`ops/trn_fused.py`) on each scale's Linear parameters; the
single-scale one is a plain Linear, as in the JAX package, which never
gives it the Pallas path.

``dtype`` is the model's compute dtype.  Under bfloat16 the multi-scale
module casts x, the weights and the biases to bfloat16 before the fused
ops, as the JAX module does before its Pallas kernels
(`ta3n_tpu/models/trn.py:138-143`): the products accumulate in float32,
the bias is added in float32, the output is bfloat16.  The single-scale
Linear computes as a bfloat16 ``nn.Dense`` (`models/layers.py::Linear`).

``quantize="int8"`` (inference only) is JAX's quantized TRN
(`ta3n_tpu/models/trn.py:104-107, 146-160`): the multi-scale module takes
no fused op, so K1 is never launched, but a gather and one GEMM a scale,
``int8_matmul`` on the relu of the gathered subsets where k*D and H reach
`QUANT_MIN_DIM`, else a float product with float32 accumulation; the
single-scale module's Linear is quantized by its own gate.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ta3n_tpu_torch.models.layers import QUANT_MIN_DIM, int8_matmul, linear
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.ops.trn_fused import (_acc, _subset_index,
                                          trn_multiscale_fused,
                                          trn_multiscale_infer)

__all__ = ["RelationModule", "RelationModuleMultiScale"]


class RelationModule(nn.Module):
    """[B, S, D] -> [B, 1, H]: relu -> Linear(S*D -> H) -> relu over the
    concatenated frames.  The reference returns [B, H], and its plain
    'trn' adversarial path crashes on it (models.py:639, 651); the JAX
    package returns one relation, [B, 1, H], so that the relation heads
    and the sum over relations run as for trn-m, and so does the port.

    Init: torch's default Linear init (outside the reference's
    normal_(0.001) loop, TRNmodule.py:16-21).
    """

    def __init__(self, img_feature_dim: int, num_bottleneck: int,
                 num_frames: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 quantize: str = "none"):
        super().__init__()
        self.num_frames = num_frames
        fc = linear(num_frames * img_feature_dim, num_bottleneck,
                    "torch_default", generator)
        fc.compute_dtype = dtype
        fc.quantize = quantize
        self.classifier = nn.Sequential(nn.ReLU(), fc, nn.ReLU())

    def forward(self, x: torch.Tensor, infer: bool = False) -> torch.Tensor:
        """``infer`` is accepted for the multi-scale module's signature;
        both modes compute the same function."""
        if x.shape[1] != self.num_frames:
            raise ValueError(f"expected {self.num_frames} segments, got "
                             f"{x.shape[1]}")
        return self.classifier(x.reshape(x.shape[0], -1))[:, None, :]


class RelationModuleMultiScale(nn.Module):
    """[B, S, D] -> [B, S-1, H]: one summed relation feature per scale
    k = S..2, over the deterministic subset selection of `ops/relation.py`.

    Init: torch's default Linear init (the reference's normal_(0.001) loop
    never touches the TRN fusion Linears, TRNmodule.py:50).
    """

    def __init__(self, img_feature_dim: int, num_bottleneck: int,
                 num_frames: int, subsample_num: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 quantize: str = "none"):
        super().__init__()
        self.num_frames = num_frames
        self.subsample_num = subsample_num
        self.dtype = dtype
        self.quantize = quantize
        plan = build_relation_plan(num_frames, subsample_num)
        self.fc_fusion_scales = nn.ModuleList(
            nn.Sequential(nn.ReLU(),
                          linear(k * img_feature_dim, num_bottleneck,
                                 "torch_default", generator),
                          nn.ReLU())
            for k in plan.scales)

    def forward(self, x: torch.Tensor, infer: bool = False) -> torch.Tensor:
        """``infer=True`` (eval and serve) takes the fused inference op;
        ``infer=False`` (training) the fused training op, whose backward
        uses the relu masks its forward saved.  On CUDA both are the
        hand-written kernels; on the CPU their plain versions.  Under
        ``quantize="int8"`` neither: `_quantized`."""
        if x.shape[1] != self.num_frames:
            raise ValueError(f"expected {self.num_frames} segments, got "
                             f"{x.shape[1]}")
        if self.quantize == "int8":
            return self._quantized(x)
        dt = self.dtype
        weights = [seq[1].weight.to(dt) for seq in self.fc_fusion_scales]
        biases = [seq[1].bias.to(dt) for seq in self.fc_fusion_scales]
        fused = trn_multiscale_infer if infer else trn_multiscale_fused
        return fused(x.to(dt), weights, biases, self.num_frames,
                     self.subsample_num)

    def _quantized(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 forward, one gather and GEMM a scale, as the JAX
        module's XLA path: relu(z + b) summed over the scale's subsets."""
        dt = self.dtype
        b, _, d = x.shape
        plan = build_relation_plan(self.num_frames, self.subsample_num)
        outs = []
        for seq, k, idx in zip(self.fc_fusion_scales, plan.scales,
                               _subset_index(self.num_frames,
                                             self.subsample_num, x.device)):
            fc = seq[1]
            g = torch.relu(x.index_select(1, idx).reshape(b, -1, k * d))
            if min(k * d, fc.out_features) >= QUANT_MIN_DIM:
                z = int8_matmul(g, fc.weight)
            else:
                z = _acc(g.to(dt)) @ _acc(fc.weight.to(dt)).T
            outs.append(torch.relu(z + fc.bias).sum(dim=1))
        return torch.stack(outs, dim=1).to(dt)
