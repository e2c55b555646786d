"""Building blocks of the port: the reference's init policy, the Linear
that computes in the model's compute dtype, the TransAttn weights, general attention, the masked BatchNorm of AdaBN and
AutoDIAL, the temporal conv layer of temconv aggregation, and
``cudnn_f32``, which runs a cuDNN convolution or RNN in float32 forward
and backward whatever ``torch.backends.cudnn.allow_tf32`` says.

Init policy (`ta3n_tpu/models/layers.py:17-44`, PARITY §2.2, load-bearing):
the Linears that the reference's init loop touches get
``normal_(weight, 0, 0.001)`` and a zero bias; the TRN fusion Linears and
the relation-domain heads keep torch's default Linear init, weight and bias
U(±1/sqrt(fan_in)).  With normal(0.001) there the TRN output is ~1e-3 in
scale and training stalls.  Both draw from an explicit ``torch.Generator``.

Compute dtype (`ta3n_tpu/models/layers.py:165-186`): parameters are
float32 whatever ``ModelConfig.param_dtype`` says, as in the JAX package,
which reads that field nowhere.  A ``Linear`` whose ``compute_dtype`` is
bfloat16 computes as flax ``nn.Dense(dtype=bfloat16)``: input, weight and
bias cast to bfloat16, the product rounded to bfloat16, then the bias
added in bfloat16.  One with ``compute_dtype`` None computes in the
promoted type of its input and weight, as ``nn.Dense(dtype=None)``: a
bfloat16 input to such a layer (general attention's) is computed in
float32.  The BN statistics are float32 whatever the input's dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ta3n_tpu_torch.losses.losses import entropy_from_logits

__all__ = ["Linear", "linear", "normal_001_", "torch_default_uniform_",
           "trans_attn_weights", "GeneralAttn", "MaskedBatchNorm", "TCL",
           "cudnn_f32", "bf16_f32_reduction"]


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


class Linear(nn.Linear):
    """``nn.Linear`` (the same parameters and state_dict keys) that
    computes in ``compute_dtype``: None (the default) in the promoted type
    of its input and weight, which for a float32 input is ``nn.Linear``'s
    own arithmetic; bfloat16 as flax ``nn.Dense(dtype=bfloat16)``, the
    product and the bias add each rounded to bfloat16."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        if dt == self.weight.dtype:
            return F.linear(x.to(dt), self.weight, self.bias)
        return x.to(dt) @ self.weight.to(dt).T + self.bias.to(dt)


def linear(in_features: int, out_features: int, init: str,
           generator: Optional[torch.Generator]) -> Linear:
    """A `Linear` on the CPU with the reference's init policy: ``init`` is
    "normal001" or "torch_default".  Built without torch's own init, so
    the global RNG is not touched."""
    layer = nn.utils.skip_init(Linear, in_features, out_features)
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


class GeneralAttn(nn.Sequential):
    """'general' attention: Linear -> tanh -> Linear(1), softmax over
    axis 1.  Port of `ta3n_tpu/models/layers.py::GeneralAttn` (reference
    attn_layer, models.py:320-325, and get_general_attn, models.py:359-366):
    [B, T, D] -> weights [B, T, 1].  The reference builds it outside its
    normal_(0.001) loop, so both Linears keep torch's default init; as a
    Sequential(Linear, Tanh, Linear) it has the reference's parameter
    names, ``attn_layer.0`` and ``attn_layer.2``."""

    def __init__(self, dim: int, generator: Optional[torch.Generator]):
        super().__init__(linear(dim, dim, "torch_default", generator),
                         nn.Tanh(),
                         linear(dim, 1, "torch_default", generator))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return torch.softmax(super().forward(feat), dim=1)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d whose batch statistics take per-row weights.

    Port of `ta3n_tpu/models/layers.py::MaskedBatchNorm` (reference
    nn.BatchNorm1d, models.py:195-199): in training, normalise with the
    weighted batch mean and biased variance over the rows of weight > 0,
    and update the running stats with momentum 0.1 from the *unbiased*
    variance, ``var * n / max(n - 1, 1)`` with ``n = max(sum(w), 1)``;
    otherwise normalise with the running stats.  eps 1e-5.  The weights
    let AdaBN/AutoDIAL route rows between two BNs and leave padded videos
    out of both, without the reference's reordering of the batch
    (models.py:490-543).

    Which statistics it uses is the ``use_running_average`` argument of
    the forward, never ``self.training``: the steps pass it from their
    ``is_train``.  The statistics and the normalisation are computed in
    float32 and the output has the input's dtype, as in the JAX package
    (a bfloat16 input is normalised in float32 and rounded once).  Parameters and buffers carry torch's BN names
    (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so a reference state_dict loads as it is.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor,
                stats_weight: Optional[torch.Tensor] = None,
                use_running_average: bool = False) -> torch.Tensor:
        out_dtype = x.dtype
        x = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            if stats_weight is None:
                n = float(x.shape[0])
                mean = x.mean(dim=0)
                var = (x - mean).square().mean(dim=0)
                denom = max(n - 1.0, 1.0)
            else:
                w = stats_weight.to(x.dtype)[:, None]
                n = w.sum().clamp(min=1.0)
                mean = (w * x).sum(dim=0) / n
                var = (w * (x - mean).square()).sum(dim=0) / n
                denom = (n - 1.0).clamp(min=1.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / denom
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
                self.num_batches_tracked.add_(1)
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
                + self.bias).to(out_dtype)


@contextlib.contextmanager
def bf16_f32_reduction():
    """cuBLAS's bfloat16 matrix products with float32 reductions for the
    duration, as XLA's: ``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction`` is True by default, and then
    cuBLAS may sum a split-K product's partials in bfloat16.  The
    previous setting is restored.  The train, eval and infer steps
    (`train/step.py`) and the Predictor (`serve.py`) run inside it; it
    changes nothing for float32 products or on the CPU."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


@contextlib.contextmanager
def _no_cudnn_tf32():
    """cuDNN without TF32 for the duration; the previous setting
    restored.  ``torch.backends.cudnn.allow_tf32`` is True by default, and
    then cuDNN runs float32 convolutions and RNNs on TF32 tensor cores
    (10-bit mantissa)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _CudnnF32(torch.autograd.Function):
    """``fn(x)`` with cuDNN's TF32 off in the forward and in the backward:
    the backward recomputes ``fn(x)`` under the same setting and takes the
    gradients of x and of ``params``, the parameters that ``fn`` reads.
    cuDNN reads the flag when a kernel runs, so a context around the
    forward alone would leave the backward on TF32."""

    @staticmethod
    def forward(ctx, fn, x, *params):
        ctx.fn, ctx.params = fn, params
        ctx.save_for_backward(x)
        with _no_cudnn_tf32():
            return fn(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[1])
        inputs = [t for t, need in zip((x, *ctx.params),
                                       ctx.needs_input_grad[1:]) if need]
        with torch.enable_grad(), _no_cudnn_tf32():
            grads = iter(torch.autograd.grad(ctx.fn(x), inputs, grad,
                                             allow_unused=True))
        return (None, *(next(grads) if need else None
                        for need in ctx.needs_input_grad[1:]))


def cudnn_f32(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              params: Sequence[torch.Tensor]) -> torch.Tensor:
    """``fn(x)``, a call of a module whose parameters are ``params``, in
    float32 on cuDNN: TF32 off in its forward and in its backward (which
    recomputes the forward).  The TCL and the RNN aggregator run through
    it, so that their numbers do not depend on the process's global
    ``torch.backends.cudnn.allow_tf32``.  On the CPU the flag changes
    nothing."""
    return _CudnnF32.apply(fn, x, *params)


class TCL(nn.Module):
    """Temporal conv layer: a Conv2d(1, 1, (conv_size, 1)) over the
    segment axis, padding conv_size // 2, kaiming-normal weight.  Port of
    `ta3n_tpu/models/layers.py::TCL` (reference TCL, models.py:44-56):
    [B, S, D] -> [B, S, D].  The conv is ``conv2d``, the reference's
    parameter name (``tcl_3_1.conv2d.weight``), and runs through
    ``cudnn_f32``.  Its bias keeps torch's default init, U(±1/sqrt(fan_in))
    (the reference initialises only the weight).  A bfloat16 input is
    computed in float32, as the JAX TCL (an ``nn.Conv`` without a dtype)
    promotes it to its float32 kernel."""

    def __init__(self, conv_size: int, generator: Optional[torch.Generator]):
        super().__init__()
        with torch.device("meta"):  # no draw from the global RNG
            conv = nn.Conv2d(1, 1, (conv_size, 1),
                             padding=(conv_size // 2, 0))
        self.conv2d = conv.to_empty(device="cpu")
        with torch.no_grad():
            nn.init.kaiming_normal_(self.conv2d.weight, generator=generator)
            bound = 1.0 / math.sqrt(conv_size)
            self.conv2d.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv2d
        y = cudnn_f32(lambda t: F.conv2d(t, conv.weight, conv.bias,
                                         padding=conv.padding),
                      x.float()[:, None], (conv.weight, conv.bias))
        return y[:, 0]
