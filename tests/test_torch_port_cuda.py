"""PyTorch port on the card: the hand-written TRN kernel against its plain
version, and the flagship model's CUDA forward against its CPU forward.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models.layers import torch_default_uniform_
from ta3n_tpu_torch.ops import trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _trn_inputs(b, s, d, h, seed=0):
    """x of both signs (the kernel applies relu on load); weights and
    biases at torch's default Linear scale, in nn.Linear layout."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    weights, biases = [], []
    for k in build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append(torch.from_numpy(
            rng.uniform(-bound, bound, (h, k * d)).astype(np.float32)))
        biases.append(torch.from_numpy(
            rng.uniform(-bound, bound, (h,)).astype(np.float32)))
    return x.cuda(), [w.cuda() for w in weights], [b.cuda() for b in biases]


@pytest.mark.parametrize("b,s,d,h", [(1, 5, 512, 256), (64, 5, 512, 256),
                                     (202, 5, 512, 256), (13, 4, 24, 8),
                                     (5, 3, 37, 19), (3, 2, 40, 33)])
def test_kernel_matches_plain(b, s, d, h):
    """Within 1e-4 * max(1, max|plain|): f32 sums in another order.  One
    launch per call, and bitwise equal on a second call (no atomics)."""
    x, w, bi = _trn_inputs(b, s, d, h)
    trn_fused.launches = 0
    with torch.inference_mode():
        got = trn_fused.trn_multiscale_infer(x, w, bi, s)
        again = trn_fused.trn_multiscale_infer(x, w, bi, s)
        want = trn_fused.trn_multiscale_plain(x, w, bi, s)
    torch.cuda.synchronize()
    assert trn_fused.launches == 2
    assert got.shape == (b, s - 1, h)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, again)


def test_empty_batch_launches_nothing():
    x, w, bi = _trn_inputs(0, 5, 32, 16)
    trn_fused.launches = 0
    with torch.inference_mode():
        out = trn_fused.trn_multiscale_infer(x, w, bi, 5)
    assert out.shape == (0, 4, 16) and trn_fused.launches == 0


def test_kernel_refuses_what_it_cannot_take():
    x, w, bi = _trn_inputs(4, 5, 32, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        trn_fused.trn_multiscale_infer(x.requires_grad_(True), w, bi, 5)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="on cuda"):
            trn_fused.trn_multiscale_infer(x, [t.cpu() for t in w], bi, 5)
        with pytest.raises(TypeError):
            trn_fused.trn_multiscale_infer(x.half(), w, bi, 5)


def test_model_on_cuda_matches_cpu():
    """Eval forward of the flagship branches at small widths: CUDA (the
    kernel) against CPU (the plain version), within 1e-4 relative."""
    cfg = ModelConfig(num_class=6, baseline_type="video",
                      frame_aggregation="trn-m", train_segments=5,
                      val_segments=5, feature_dim=96, fc_dim=64,
                      use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
    gen = torch.Generator().manual_seed(0)
    model = VideoModel(cfg, gen)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            torch_default_uniform_(mod, gen)
    x = torch.rand((9, 5, 96), generator=gen)
    beta = torch.zeros(3)
    with torch.inference_mode():
        _, ref = model(x[:0], x, beta, 0.0, False)
    model.cuda()
    with torch.inference_mode():
        trn_fused.launches = 0
        _, got = model(x[:0].cuda(), x.cuda(), beta.cuda(), 0.0, False)
    assert trn_fused.launches == 1
    for a, b in [(got.out, ref.out), (got.attn, ref.attn),
                 *zip(got.pred_domain, ref.pred_domain)]:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(x[:0].cuda(), x.cuda(), beta.cuda(), 0.0, True)
