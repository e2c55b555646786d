"""Building blocks of the port: the reference's init policy and the
TransAttn weights.

Init policy (`ta3n_tpu/models/layers.py:17-44`, PARITY §2.2, load-bearing):
the Linears that the reference's init loop touches get
``normal_(weight, 0, 0.001)`` and a zero bias; the TRN fusion Linears and
the relation-domain heads keep torch's default Linear init, weight and bias
U(±1/sqrt(fan_in)).  With normal(0.001) there the TRN output is ~1e-3 in
scale and training stalls.  Both draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ta3n_tpu_torch.losses.losses import entropy_from_logits

__all__ = ["linear", "normal_001_", "torch_default_uniform_",
           "trans_attn_weights"]


@torch.no_grad()
def normal_001_(layer: nn.Linear,
                generator: Optional[torch.Generator]) -> nn.Linear:
    """The reference's loop init: weight N(0, 0.001), bias 0."""
    layer.weight.normal_(0.0, 0.001, generator=generator)
    layer.bias.zero_()
    return layer


@torch.no_grad()
def torch_default_uniform_(layer: nn.Linear,
                           generator: Optional[torch.Generator]
                           ) -> nn.Linear:
    """torch's default Linear init: kaiming_uniform(a=sqrt(5)) on the
    weight and U(±1/sqrt(fan_in)) on the bias, both U(±sqrt(1/fan_in))."""
    bound = 1.0 / math.sqrt(layer.in_features)
    layer.weight.uniform_(-bound, bound, generator=generator)
    layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear(in_features: int, out_features: int, init: str,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """An ``nn.Linear`` on the CPU with the reference's init policy:
    ``init`` is "normal001" or "torch_default".  Built without torch's own
    init, so the global RNG is not touched."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
    if init == "normal001":
        return normal_001_(layer, generator)
    if init == "torch_default":
        return torch_default_uniform_(layer, generator)
    raise ValueError(f"unknown init {init!r}")


def trans_attn_weights(pred_domain: torch.Tensor) -> torch.Tensor:
    """TransAttn weights = 1 - entropy(softmax(domain logits)).

    Port of `ta3n_tpu/models/layers.py::trans_attn_weights` (reference
    get_trans_attn, models.py:351-357).  [..., 2] -> [...].
    """
    return 1.0 - entropy_from_logits(pred_domain)
