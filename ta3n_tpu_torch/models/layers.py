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
from ta3n_tpu_torch.parallel.mesh import active as mesh_active
from ta3n_tpu_torch.parallel.mesh import column_parallel, shard_sum

__all__ = ["Linear", "linear", "normal_001_", "torch_default_uniform_",
           "trans_attn_weights", "GeneralAttn", "MaskedBatchNorm", "TCL",
           "cudnn_f32", "no_cudnn_tf32", "bf16_f32_reduction",
           "QUANT_MIN_DIM", "quantize_weight", "quantize_rows", "int8_mm",
           "int8_matmul", "int8_batched_matmul"]

# int8 inference (ModelConfig.quantize="int8", `ta3n_tpu/models/layers.py:
# 47-161`): a Linear is quantized only when both its dims reach 128; the
# ones below are the logits heads (num_class and the 2-way domain
# outputs), which stay float32 for accuracy.
QUANT_MIN_DIM = 128
# int8 x int8 -> int32 products made by int8_mm (torch._int_mm), on any
# device; callers reset it to 0 to count the products of one run
int8_gemms = 0


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c, a true division on every device: a Python divisor would let
    CUDA multiply by its rounded reciprocal instead, an ulp off the CPU's
    and JAX's quotient, and flip codes at rounding ties."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _activation_scale(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Per-row scale of the asymmetric 256-level grid over [lo, hi].  A
    degenerate row (hi == lo) falls back to the symmetric |hi|/127 grid,
    which the zero-point correction reconstructs exactly; an all-zero row
    keeps scale 1.0."""
    rng = hi - lo
    return torch.where(rng > 0, _div(rng, 255.0),
                       torch.where(hi.abs() > 0, _div(hi.abs(), 127.0), 1.0))


def quantize_weight(weight: torch.Tensor):
    """(w8 [..., out, in] int8, sw [..., out], colsum [..., out]) of a
    weight in torch layout [..., out, in]: symmetric per-output-channel
    scales max|w|/127 (1.0 for an all-zero channel), codes
    clip(round(w / sw), -127, 127), and the codes' sums over the input
    axis for the zero-point correction.  The codes are JAX's
    ``int8_matmul`` codes of the transposed kernel, element for
    element."""
    wf = weight.float()
    sw = _div(wf.abs().amax(dim=-1), 127.0)
    sw = torch.where(sw > 0, sw, 1.0)
    w8 = torch.clamp(torch.round(wf / sw[..., None]), -127, 127).to(
        torch.int8)
    return w8, sw, w8.sum(dim=-1, dtype=torch.int32).float()


def quantize_rows(x: torch.Tensor):
    """(x8 int8, sx [..., 1], zp [..., 1]) of activations x [..., in]:
    asymmetric per-row quantization, scale (max - min)/255
    (`_activation_scale`), zero point round(min / sx) + 128, codes
    clip(round(x / sx) - zp, -128, 127), so that x ~= sx * (x8 + zp).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    hi = xf.amax(dim=-1, keepdim=True)
    lo = xf.amin(dim=-1, keepdim=True)
    sx = _activation_scale(hi, lo)
    zp = torch.round(lo / sx) + 128.0
    x8 = torch.clamp(torch.round(xf / sx) - zp, -128, 127).to(torch.int8)
    return x8, sx, zp


def _int_mm(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """x8 [M, K] @ w8 [N, K]ᵀ in int32 through ``torch._int_mm`` (on CUDA
    cuBLASLt's int8 tensor-core GEMM), w8 passed column-major.  On the
    card ``_int_mm`` takes M > 16 and K, N multiples of 8: other shapes
    are padded with zero rows and columns, which add nothing to a
    product, and the result is cut back to [M, N]."""
    global int8_gemms
    m, k = x8.shape
    n = w8.shape[0]
    pad_k = -k % 8
    if m <= 16 or pad_k:
        x8 = F.pad(x8, (0, pad_k, 0, max(17 - m, 0)))
    if pad_k or n % 8:
        w8 = F.pad(w8, (0, pad_k, 0, -n % 8))
    int8_gemms += 1
    return torch._int_mm(x8.contiguous(), w8.contiguous().T)[:m, :n]


class _Int8MM(torch.autograd.Function):
    """`_int_mm` with a vmap rule, so that ``torch.func.vmap`` over an
    ensemble's stacked weights (`serve.py`) needs no per-member fallback
    (``aten::_int_mm`` has no batching rule): one product over the
    members' stacked weights when the activations are shared, one over
    the stacked rows when the weight is, else one a member."""

    @staticmethod
    def forward(x8, w8):
        return _int_mm(x8, w8)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("int8 inference has no backward")

    @staticmethod
    def vmap(info, in_dims, x8, w8):
        dx, dw = in_dims
        if dx is None:                         # [M, K] @ [N_m, O, K]
            w8 = w8.movedim(dw, 0)
            acc = _int_mm(x8, w8.reshape(-1, w8.shape[-1]))
            return acc.reshape(acc.shape[0], w8.shape[0], -1), 1
        x8 = x8.movedim(dx, 0)
        if dw is None:                         # [N_m, M, K] @ [O, K]
            acc = _int_mm(x8.reshape(-1, x8.shape[-1]), w8)
            return acc.reshape(x8.shape[0], x8.shape[1], -1), 0
        w8 = w8.movedim(dw, 0)
        return torch.stack([_int_mm(a, b) for a, b in zip(x8, w8)]), 0


def int8_mm(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int8 x8 [M, K] times int8 w8 [N, K] (torch layout) transposed, as
    int32 [M, N]; under ``torch.func.vmap`` through `_Int8MM`'s rule."""
    if torch._C._are_functorch_transforms_active():
        return _Int8MM.apply(x8, w8)
    return _int_mm(x8, w8)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """W8A8 dynamically quantized ``x @ weight.T`` in float32, the port
    of `ta3n_tpu/models/layers.py::int8_matmul` (its kernel is
    ``weight.T``): weight codes and scales from `quantize_weight`, row
    codes from `quantize_rows`, an int8 x int8 -> int32 product
    (`int8_mm`), then ``(acc + zp * colsum) * sx * sw`` in that order.
    x: [..., in]; weight: [out, in] -> [..., out] float32."""
    w8, sw, colsum = quantize_weight(weight)
    x8, sx, zp = quantize_rows(x)
    acc = int8_mm(x8.reshape(-1, x8.shape[-1]), w8)
    acc = acc.reshape(*x8.shape[:-1], acc.shape[-1])
    return (acc.float() + zp * colsum) * sx * sw


def int8_batched_matmul(x: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """W8A8 quantized ``einsum('bri,roi->bro', x, weight)``, R stacked
    heads: the port of `ta3n_tpu/models/layers.py::int8_batched_matmul`
    (its w is ``weight.transpose(1, 2)``), with per-(head, output) weight
    scales and per-(row, head) activation scales, one int32 product a
    head.  x: [B, R, in]; weight: [R, out, in] -> [B, R, out] float32.
    Head r's columns are ``int8_matmul(x[:, r], weight[r])``'s."""
    w8, sw, colsum = quantize_weight(weight)               # [R, O, I]
    x8, sx, zp = quantize_rows(x)                          # [B, R, I]
    acc = torch.stack([int8_mm(x8[:, r], w8[r])
                       for r in range(w8.shape[0])], dim=1)
    return (acc.float() + zp * colsum) * sx * sw


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
    product and the bias add each rounded to bfloat16.

    ``quantize="int8"`` (inference only) makes it JAX's ``QuantDense``
    (`ta3n_tpu/models/layers.py:134-161`): when both dims reach
    `QUANT_MIN_DIM`, ``int8_matmul(x, weight) + bias`` in float32, then
    cast to ``compute_dtype`` if one is set; below that, the float
    arithmetic above.

    ``tp`` (`parallel/tensor.py`, a model axis of M ranks): the weight is
    this rank's slice of rows [out / M, in] (``out_features`` stays the
    whole layer's) and the layer is column-parallel
    (`parallel/mesh.py::column_parallel`): the same arithmetic on the
    slice, the slices' outputs gathered, then the whole bias added."""

    compute_dtype: Optional[torch.dtype] = None
    quantize: str = "none"
    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantize == "int8" and min(
                self.in_features, self.out_features) >= QUANT_MIN_DIM:
            y = self._product(x, lambda v: int8_matmul(v, self.weight))
            y = y + self.bias.float()
            return y if self.compute_dtype is None else y.to(
                self.compute_dtype)
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        if self.tp is not None:
            return self._product(
                x.to(dt), lambda v: v @ self.weight.to(dt).T) \
                + self.bias.to(dt)
        if dt == self.weight.dtype:
            return F.linear(x.to(dt), self.weight, self.bias)
        return x.to(dt) @ self.weight.to(dt).T + self.bias.to(dt)

    def _product(self, x: torch.Tensor, product) -> torch.Tensor:
        """``product(x)``, over the model axis when the layer is
        column-parallel."""
        if self.tp is None:
            return product(x)
        return column_parallel(x, product, self.tp)


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
    names, ``attn_layer.0`` and ``attn_layer.2``.  ``quantize`` is set on
    both Linears, as the JAX module passes it to both; the gate leaves the
    1-wide one in float32."""

    def __init__(self, dim: int, generator: Optional[torch.Generator],
                 quantize: str = "none"):
        super().__init__(linear(dim, dim, "torch_default", generator),
                         nn.Tanh(),
                         linear(dim, 1, "torch_default", generator))
        self[0].quantize = self[2].quantize = quantize

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

    Over a data mesh (``mesh``, `parallel/mesh.py`) x holds this rank's
    rows and the statistics are those of every rank's rows: the weight
    count and the weighted sums go through ``shard_sum``, so the moments,
    the running statistics and the gradient through them are the global
    batch's, as `tests/test_sharding.py:208` holds the JAX package's.
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
                use_running_average: bool = False,
                mesh=None) -> torch.Tensor:
        out_dtype = x.dtype
        x = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            if stats_weight is None and not mesh_active(mesh):
                n = float(x.shape[0])
                mean = x.mean(dim=0)
                var = (x - mean).square().mean(dim=0)
                denom = max(n - 1.0, 1.0)
            else:
                # weighted moments; over a mesh the global batch's (every
                # row of weight 1 without stats_weight)
                w = (torch.ones(x.shape[0], device=x.device)
                     if stats_weight is None else stats_weight.float())
                w = w[:, None]
                sums = shard_sum(
                    torch.cat([w.sum(dim=0), (w * x).sum(dim=0)]), mesh)
                n = sums[0].clamp(min=1.0)
                mean = sums[1:] / n
                var = shard_sum((w * (x - mean).square()).sum(dim=0),
                                mesh) / n
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
def no_cudnn_tf32():
    """cuDNN without TF32 for the duration; the previous setting
    restored.  ``torch.backends.cudnn.allow_tf32`` is True by default, and
    then cuDNN runs float32 convolutions and RNNs on TF32 tensor cores
    (10-bit mantissa).  ``cudnn_f32`` runs its forward inside it; the
    ensemble train step (`train/ensemble.py`) runs whole inside it, for
    the backward of a transform, which ``cudnn_f32`` cannot reach."""
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
    forward alone would leave the backward on TF32.  In the
    ``setup_context`` form that ``torch.func`` asks of a Function."""

    @staticmethod
    def forward(fn, x, *params):
        with no_cudnn_tf32():
            return fn(x)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        fn, x, *params = inputs
        ctx.fn, ctx.params = fn, params
        ctx.save_for_backward(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[1])
        inputs = [t for t, need in zip((x, *ctx.params),
                                       ctx.needs_input_grad[1:]) if need]
        with torch.enable_grad(), no_cudnn_tf32():
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
    nothing.  Under a ``torch.func`` transform (whose backward cannot call
    ``torch.autograd.grad``) it is ``fn(x)`` with TF32 off: every forward,
    the ensembles' vmapped ones too, runs in float32; a transform's
    backward runs where its caller puts it (the ensemble train step runs
    whole inside ``no_cudnn_tf32``)."""
    if torch._C._are_functorch_transforms_active():
        with no_cudnn_tf32():
            return fn(x)
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
