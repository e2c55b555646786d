"""PyTorch port on the card: the hand-written kernels (the TRN's inference
forward, training forward and backward, and the fused gather + first-FC
GEMM) against their plain versions, and the flagship model's CUDA forward,
backward, train steps (features from the host or from stores on the card)
and eval steps against the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import TSNLoader, make_domain_pair
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models.layers import torch_default_uniform_
from ta3n_tpu_torch.ops import _build, gather_gemm, trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_eval_step, make_multi_eval_step,
                                  make_train_step)

CASES = [(1, 5, 512, 256), (64, 5, 512, 256), (202, 5, 512, 256),
         (13, 4, 24, 8), (5, 3, 37, 19), (3, 2, 40, 33)]

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


def _grid_inputs(b, s, d, h, seed=0):
    """x, weights, biases and an upstream gradient on dyadic grids small
    enough that every product and partial sum of the forward and backward
    is exact in float32 at these widths (|sums| < 2**24 grid steps): any
    summation order then gives the same bits, and the masks agree even
    where z is 0."""
    rng = np.random.default_rng(seed)

    def grid(lo, hi, shape, step):
        return torch.from_numpy(
            (rng.integers(lo, hi + 1, shape) * step).astype(np.float32))

    x = grid(-8, 16, (b, s, d), 2.0 ** -4)
    weights = [grid(-16, 16, (h, k * d), 2.0 ** -8)
               for k in build_relation_plan(s).scales]
    biases = [grid(-64, 64, (h,), 2.0 ** -12) for _ in weights]
    g = grid(-128, 128, (b, s - 1, h), 2.0 ** -8)
    return (x.cuda(), [w.cuda() for w in weights],
            [bi.cuda() for bi in biases], g.cuda())


def _tol(want):
    return 1e-4 * max(1.0, want.abs().max().item())


def _reset_counts():
    trn_fused.launches = trn_fused.train_launches = 0
    trn_fused.bwd_launches = 0
    gather_gemm.launches = 0


def _counts():
    return (gather_gemm.launches, trn_fused.launches,
            trn_fused.train_launches, trn_fused.bwd_launches)


@pytest.mark.parametrize("b,s,d,h", CASES)
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


@pytest.mark.parametrize("b,s,d,h", CASES)
def test_train_kernel_matches_plain(b, s, d, h):
    """The training forward: output within 1e-4 * max(1, max|plain|),
    masks exactly those of the plain version on inputs where f32 sums are
    exact, bitwise equal on a second call, one launch per call."""
    x, w, bi = _trn_inputs(b, s, d, h)
    _reset_counts()
    with torch.no_grad():
        got, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        again, masks_again = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        want, _ = trn_fused.trn_multiscale_fwd_masks_plain(x, w, bi, s)
        gx, gw, gb, _ = _grid_inputs(b, s, d, h, seed=1)
        grid_out, grid_masks = trn_fused.trn_multiscale_fwd_masks(
            gx, gw, gb, s)
        grid_want, grid_want_masks = \
            trn_fused.trn_multiscale_fwd_masks_plain(gx, gw, gb, s)
    torch.cuda.synchronize()
    assert trn_fused.train_launches == 3 and trn_fused.launches == 0
    assert got.shape == (b, s - 1, h) and masks.dtype == torch.uint8
    assert (got - want).abs().max().item() <= _tol(want)
    assert torch.equal(got, again) and torch.equal(masks, masks_again)
    assert torch.equal(grid_masks, grid_want_masks)
    assert torch.equal(grid_out, grid_want)


def _preacts(x, weights, biases, s):
    """z of every subset, [B, n_sub*H], in the masks' layout."""
    plan = build_relation_plan(s)
    b, _, d = x.shape
    zs = []
    for w, bias, k, subsets in zip(weights, biases, plan.scales,
                                   plan.subsets):
        idx = torch.as_tensor(subsets.reshape(-1), device=x.device)
        g = x[:, idx].reshape(b, subsets.shape[0], k * d)
        zs.append((torch.relu(g) @ w.T + bias).reshape(b, -1))
    return torch.cat(zs, dim=1)


def _check_fwd(b, s, d, h, train):
    """K1, the inference (train=False) or the training variant: output
    within 1e-4 * max(1, max|plain|), masks equal to plain's except where
    |z| is within that tolerance of 0 (a rounding tie), a second call
    bitwise equal, exact inputs bit for bit (masks included); one launch
    per call."""
    x, w, bi = _trn_inputs(b, s, d, h)
    gx, gw, gb, _ = _grid_inputs(b, s, d, h, seed=1)
    _reset_counts()
    with torch.no_grad():
        if train:
            fwd = trn_fused.trn_multiscale_fwd_masks
            plain = trn_fused.trn_multiscale_fwd_masks_plain
        else:
            fwd = lambda *a: (trn_fused.trn_multiscale_infer(*a), None)
            plain = lambda *a: (trn_fused.trn_multiscale_plain(*a), None)
        (got, masks), (again, masks_again) = fwd(x, w, bi, s), \
            fwd(x, w, bi, s)
        want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
            x, w, bi, s)
        grid_got, grid_masks = fwd(gx, gw, gb, s)
        grid_want, grid_want_masks = plain(gx, gw, gb, s)
        z = _preacts(x, w, bi, s)
    torch.cuda.synchronize()
    assert (trn_fused.train_launches if train else trn_fused.launches) == 3
    assert got.shape == (b, s - 1, h)
    assert (got - want).abs().max().item() <= _tol(want)
    assert torch.equal(got, again) and torch.equal(grid_got, grid_want)
    if train:
        assert masks.dtype == torch.uint8 and masks.shape == want_masks.shape
        differ = masks != want_masks
        assert (z[differ].abs() <= _tol(z)).all()
        assert torch.equal(masks, masks_again)
        assert torch.equal(grid_masks, grid_want_masks)


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("b", [63, 64, 65, 129, 202])
def test_fwd_kernel_batch_edges(b, train):
    """K1 around its 64-row unit tiles, whose rows (subset, video) run
    over the subsets of a scale: B*n_sub rows end mid-tile at 63, 65 and
    129, exactly at 64 and 202*3 = 606 = 9*64 + 30."""
    _check_fwd(b, 5, 512, 256, train)


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("splits", ["one", "most"])
@pytest.mark.parametrize("b", [1, 64, 202])
def test_fwd_kernel_splits(b, splits, train, monkeypatch):
    """K1 with one D slice per output tile and with as many as it takes
    (8: 2 chunks a slice at D = 512): the checks of _check_fwd."""
    most = trn_fused._FWD_MAX_SPLITS
    monkeypatch.setattr(trn_fused, "_fwd_splits", lambda s, n, b_, d, h:
                        1 if splits == "one" else most)
    _check_fwd(b, 5, 512, 256, train)


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("d", [37, 100])
def test_fwd_kernel_ragged_d_chunk(d, train, monkeypatch):
    """K1 with D not a multiple of its 32-deep chunk, with 4-byte copies
    (D = 37) and 16-byte copies (D = 100), at 1 and at 3 D slices."""
    for splits in (1, 3):
        monkeypatch.setattr(trn_fused, "_fwd_splits",
                            lambda *a, n=splits: n)
        _check_fwd(70, 5, d, 40, train)


# beyond the 16 frames of the earlier by-value plan: the flagship widths
# at the serve and train batches, and ragged widths
MANY_FRAMES = [(b, s, 512, 256) for s in (17, 25) for b in (1, 64, 202)] + \
    [(13, 17, 37, 19), (5, 25, 24, 8)]


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("b,s,d,h", MANY_FRAMES)
def test_fwd_kernel_many_frames(b, s, d, h, train):
    """K1 at S = 17 and 25, its plan read from device memory: the checks
    of _check_fwd (tolerance, masks, second call, dyadic inputs bit for
    bit)."""
    _check_fwd(b, s, d, h, train)


@pytest.mark.parametrize("b,s,d,h", MANY_FRAMES)
def test_bwd_kernel_many_frames(b, s, d, h):
    """K2 at S = 17 and 25: the checks of test_bwd_kernel_matches_plain."""
    _check_bwd(b, s, d, h)


@pytest.mark.parametrize("b,s,d,h", CASES)
def test_bwd_kernel_matches_plain(b, s, d, h):
    """The backward from the kernel's masks: dx, every dW and db within
    1e-4 * max(1, max|plain|), bitwise equal on a second call (no
    atomics), exactly the plain values on exact-sum inputs; one launch per
    call."""
    _check_bwd(b, s, d, h)


@pytest.mark.parametrize("b", [15, 16, 17])
def test_bwd_kernel_batch_edges(b):
    """K2 around the 16-row boundary of an m16n8k8 fragment, in its
    16-byte copy variant (D % 4 == 0, H % 16 == 0): the checks of
    test_bwd_kernel_matches_plain."""
    _check_bwd(b, 5, 128, 64)


def _check_bwd(b, s, d, h):
    x, w, bi = _trn_inputs(b, s, d, h)
    g = torch.randn((b, s - 1, h), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    _reset_counts()
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        got = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
        again = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
        want = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
        gx, gw, gb, gg = _grid_inputs(b, s, d, h, seed=2)
        _, gmasks = trn_fused.trn_multiscale_fwd_masks_plain(gx, gw, gb, s)
        grid_got = trn_fused.trn_multiscale_bwd(gx, gw, gmasks, gg, s, 3)
        grid_want = trn_fused.trn_multiscale_bwd_plain(gx, gw, gmasks, gg,
                                                       s)
    torch.cuda.synchronize()
    assert trn_fused.bwd_launches == 3
    flat = [(got[0], again[0], want[0], grid_got[0], grid_want[0])]
    flat += list(zip(got[1] + got[2], again[1] + again[2],
                     want[1] + want[2], grid_got[1] + grid_got[2],
                     grid_want[1] + grid_want[2]))
    assert len(flat) == 1 + 2 * (s - 1)
    for ours, ours_again, ref, grid_ours, grid_ref in flat:
        assert ours.shape == ref.shape
        assert (ours - ref).abs().max().item() <= _tol(ref)
        assert torch.equal(ours, ours_again)
        assert torch.equal(grid_ours, grid_ref)


def test_empty_batch_launches_nothing():
    """B = 0: the forwards launch nothing; the backward runs its dW/db
    pass, which writes zeros."""
    x, w, bi = _trn_inputs(0, 5, 32, 16)
    _reset_counts()
    with torch.inference_mode():
        out = trn_fused.trn_multiscale_infer(x, w, bi, 5)
    assert out.shape == (0, 4, 16) and trn_fused.launches == 0
    with torch.no_grad():
        out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
        assert out.shape == (0, 4, 16) and masks.shape == (0, 160)
        dx, dws, dbs = trn_fused.trn_multiscale_bwd(
            x, w, masks, torch.zeros((0, 4, 16), device="cuda"), 5, 3)
    torch.cuda.synchronize()
    assert trn_fused.train_launches == 0 and trn_fused.bwd_launches == 1
    assert dx.shape == x.shape
    assert all(not t.any() for t in (*dws, *dbs))


def test_fused_op_autograd_on_cuda():
    """trn_multiscale_fused on CUDA tensors: one training-forward and one
    backward launch, the gradients of autograd through the plain version,
    and a non-contiguous upstream gradient taken as it comes."""
    b, s, d, h = 37, 5, 64, 32
    x, w, bi = _trn_inputs(b, s, d, h, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, *w, *bi)]
    refs = [t.clone().requires_grad_(True) for t in (x, *w, *bi)]
    n = len(w)
    _reset_counts()
    out = trn_fused.trn_multiscale_fused(leaves[0], leaves[1:1 + n],
                                         leaves[1 + n:], s)
    # a transposed upstream gradient: not contiguous
    r = torch.randn((h, s - 1, b), device="cuda").permute(2, 1, 0)
    out.backward(r)
    ref = trn_fused.trn_multiscale_plain(refs[0], refs[1:1 + n],
                                         refs[1 + n:], s)
    ref.backward(r)
    torch.cuda.synchronize()
    assert (trn_fused.train_launches, trn_fused.bwd_launches) == (1, 1)
    assert (out - ref).abs().max().item() <= _tol(ref)
    for a, b_ in zip(leaves, refs):
        assert (a.grad - b_.grad).abs().max().item() <= _tol(b_.grad)


def test_failed_launch_raises(monkeypatch):
    """A CUDA tensor whose kernel cannot launch raises, and is not counted;
    it never takes the plain version."""
    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue

    x, w, bi = _trn_inputs(4, 5, 32, 16)
    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    _reset_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        trn_fused.trn_multiscale_fused(x, w, bi, 5)
    with torch.no_grad(), pytest.raises(RuntimeError, match="launch failed"):
        trn_fused.trn_multiscale_bwd(
            x, w, torch.zeros((4, 160), dtype=torch.uint8, device="cuda"),
            torch.zeros((4, 4, 16), device="cuda"), 5, 3)
    assert (trn_fused.train_launches, trn_fused.bwd_launches) == (0, 0)


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
    """Eval forward, and training forward and backward, of the flagship
    branches at small widths: CUDA (the kernels) against CPU (the plain
    versions), within 1e-4 relative."""
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

    beta = (0.75, 0.75, 0.5)
    grads = []
    for device in ("cpu", "cuda"):
        model.to(device).zero_grad(set_to_none=True)
        _reset_counts()
        src, tgt = model(x[:4].to(device), x[4:].to(device), beta, 0.0, True)
        (src.out.sum() + tgt.pred_domain[0].sum()
         + tgt.pred_domain[1].sum()).backward()
        torch.cuda.synchronize()
        launched = (trn_fused.train_launches, trn_fused.bwd_launches)
        assert launched == ((1, 1) if device == "cuda" else (0, 0))
        # a copy: moving the model moves the data of its CPU grads too
        grads.append({n: p.grad.to("cpu", copy=True)
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1])
    for name, ref in grads[0].items():
        torch.testing.assert_close(grads[1][name], ref, rtol=1e-4,
                                   atol=1e-5, msg=lambda m: f"{name}: {m}")


def test_train_step_on_cuda_matches_cpu():
    """Three flagship train steps at small widths, dropout 0: on CUDA
    (one training-forward and one backward launch per step) against the
    same steps on the CPU."""
    cfg = ModelConfig(num_class=6, baseline_type="video",
                      frame_aggregation="trn-m", train_segments=5,
                      val_segments=5, feature_dim=96, fc_dim=64,
                      use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy")
    tc = TrainConfig(lr=0.03)
    rng = np.random.default_rng(0)
    batches = [(rng.random((8, 5, 96), np.float32),
                rng.integers(0, 6, 8), np.ones(8, np.float32),
                rng.random((7, 5, 96), np.float32),
                rng.integers(0, 6, 7), np.ones(7, np.float32))
               for _ in range(3)]
    results = []
    for device in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(0)
        state = create_train_state(cfg, tc, gen, device="cpu")
        for mod in state.model.modules():
            if isinstance(mod, torch.nn.Linear):
                torch_default_uniform_(mod, gen)
        state.model.to(device)  # the optimizer keeps the same Parameters
        step = make_train_step(state.model, da, tc)
        _reset_counts()
        losses = []
        for batch in batches:
            state, metrics = step(state, *batch,
                                  StepScalars((0.75, 0.75, 0.5), 0.0, 0.0,
                                              0.003, 0.03), None)
            losses.append(float(metrics["loss"]))
        launched = (trn_fused.train_launches, trn_fused.bwd_launches)
        assert launched == ((3, 3) if device == "cuda" else (0, 0))
        results.append((losses, {k: v.to("cpu", copy=True) for k, v in
                                 state.model.state_dict().items()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=2e-4)
    for name, ref in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], ref, rtol=1e-3,
                                   atol=2e-5, msg=lambda m: f"{name}: {m}")


def _gather_inputs(n, r=500, d=256, h=96, streams=None, k=1, seed=0,
                   grid=False):
    """A store of r rows, n indices with duplicates, the last row and two
    masked rows (row 0, scale 0), per-index scales and a weight [h, k*d].
    ``grid``: values on dyadic grids small enough that every f32 product
    and partial sum is exact, so any summation order gives the same
    bits."""
    rng = np.random.default_rng(seed)
    shape = (r, d) if streams is None else (r, streams, d)
    if grid:
        store = rng.integers(-8, 17, shape) * 2.0 ** -4
        w = rng.integers(-16, 17, (h, k * d)) * 2.0 ** -8
    else:
        store = rng.normal(size=shape)
        w = rng.uniform(-1, 1, (h, k * d)) / math.sqrt(k * d)
    idx = rng.integers(0, r, n)
    scale = rng.choice([1.0, 0.5, 2.0], n)
    if n >= 6:
        idx[:3] = [idx[2], idx[2], r - 1]
        idx[3:5], scale[3:5] = 0, 0.0
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    return f32(store), idx, f32(scale), f32(w)


@pytest.mark.parametrize("n,streams,k,d", [
    (640, None, 1, 256), (370, None, 1, 256), (37, None, 1, 256),
    (1, None, 1, 256), (30, 2, 2, 256), (21, 2, 1, 256), (18, None, 3, 256),
    (45, None, 1, 37), (20, 2, 2, 22)])
def test_gather_gemm_kernel_matches_plain(n, streams, k, d):
    """K3: z within 1e-4 * max(1, max|plain|), x_res (the scaled gathered
    rows) bitwise equal, masked rows exactly 0, a second call and the
    call without rows bitwise equal; exact inputs bit for bit.  Ragged N,
    Flow streams, k gathered rows per FC input row, and widths D that are
    not a multiple of 4 (the kernel's 4-byte copies)."""
    _check_gather(n, streams, k, d)


@pytest.mark.parametrize("splits", ["one", "most"])
@pytest.mark.parametrize("n", [63, 64, 65, 129])
def test_gather_gemm_row_tiles_and_splits(n, splits, monkeypatch):
    """K3 around the 64-row tile (one K slice, and as many as the kernel
    takes): the checks of test_gather_gemm_kernel_matches_plain."""
    most = gather_gemm._MAX_SPLITS
    monkeypatch.setattr(gather_gemm, "_splits", lambda m, h, chunks:
                        1 if splits == "one" else min(most, chunks))
    _check_gather(n, None, 1, 256)


@pytest.mark.parametrize("d", [100, 50])
def test_gather_gemm_ragged_k_chunk(d):
    """K3 with D not a multiple of its 32-deep K chunk, with 16-byte copies
    (D = 100) and with 4-byte copies (D = 50)."""
    _check_gather(70, None, 1, d)


def _check_gather(n, streams, k, d):
    store, idx, scale, w = _gather_inputs(n, d=d, streams=streams, k=k)
    r = store.shape[0]
    rows = gather_gemm.row_index(idx, r, "cuda")
    _reset_counts()
    z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale)
    again, _ = gather_gemm.gathered_gemm(store, rows, w, scale)
    bare, none = gather_gemm.gathered_gemm(store, rows, w, scale,
                                           with_rows=False)
    want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, w,
                                                   scale)
    gs, gi, gsc, gw = _gather_inputs(n, d=d, streams=streams, k=k, seed=1,
                                     grid=True)
    grows = gather_gemm.row_index(gi, r, "cuda")
    grid_z, _ = gather_gemm.gathered_gemm(gs, grows, gw, gsc)
    grid_want, _ = gather_gemm.gathered_gemm_plain(gs, grows.rows, gw, gsc)
    torch.cuda.synchronize()
    assert gather_gemm.launches == 4
    m = n * (streams or 1) // k
    assert z.shape == (m, w.shape[0]) and x_res.shape == (m, w.shape[1])
    assert none is None
    assert (z - want).abs().max().item() <= _tol(want)
    assert torch.equal(x_res, want_x)
    assert torch.equal(z, again) and torch.equal(z, bare)
    assert torch.equal(grid_z, grid_want)
    if n >= 6 and streams is None and k == 1:
        assert not z[3:5].any() and not x_res[3:5].any()


def _full_mantissa(rng, shape):
    """Values of both signs whose float32 mantissas use all 24 bits,
    (1 + j * 2**-23) * 2**e with j random in [0, 2**23): TF32 keeps 11 of
    them."""
    j = rng.integers(0, 2 ** 23, shape)
    e = rng.integers(-2, 1, shape)
    sign = rng.choice([-1.0, 1.0], shape)
    return (sign * (1.0 + j * 2.0 ** -23) * 2.0 ** e).astype(np.float32)


def _tf32(t):
    """t rounded to TF32 (10 explicit mantissa bits, to nearest, ties away
    from zero: cvt.rna.tf32.f32), as float64."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).double()


def _rel_err(got, want):
    """The largest |got - want| over the outputs, each relative to
    max(1, max|want|)."""
    return max((g.double() - w).abs().max().item()
               / max(1.0, w.abs().max().item()) for g, w in zip(got, want))


# 3xTF32 against the f32 plain version on full-mantissa inputs: the kernels
# may err at most _X3_FACTOR times as much as the plain f32 version, and
# that bound must stay 10 times below the error of 1xTF32 (rounded
# operands, exact sums) on the same inputs.  Measured on an NVIDIA H100
# 80GB HBM3 (700 W), relative to max(1, max|float64|): K3 3.2e-7 against
# plain f32 8.8e-7 and 1xTF32 2.7e-4; K2 6.1e-7 against 3.5e-7 and 2.9e-4
# (a kernel summing all of K in one tensor-core accumulator gave K2 1.5e-5)
_X3_FACTOR = 8.0


def _check_x3(kernel, plain, tf32):
    assert kernel <= _X3_FACTOR * plain, (kernel, plain, tf32)
    assert _X3_FACTOR * plain <= tf32 / 10, (kernel, plain, tf32)


def test_gather_gemm_full_mantissa_needs_3xtf32():
    """K3 at the train shape (640 rows, D = 2048, H = 512) on inputs with
    full 24-bit mantissas, against a float64 computation: within
    _X3_FACTOR times the error of the plain f32 version, which 1xTF32
    misses by far."""
    rng = np.random.default_rng(7)
    store = torch.from_numpy(_full_mantissa(rng, (1000, 2048))).cuda()
    w = torch.from_numpy(_full_mantissa(rng, (512, 2048)) / 64).cuda()
    idx = rng.integers(0, 1000, 640)
    rows = gather_gemm.row_index(idx, 1000, "cuda")
    z, _ = gather_gemm.gathered_gemm(store, rows, w)
    plain, _ = gather_gemm.gathered_gemm_plain(store, rows.rows, w)
    x = store.double()[torch.from_numpy(idx).cuda()]
    want = x @ w.double().T
    one = _tf32(store)[torch.from_numpy(idx).cuda()] @ _tf32(w).T
    errs = [_rel_err([t], [want]) for t in (z, plain, one)]
    print(f"K3 full mantissa: kernel {errs[0]:.3e}, plain f32 {errs[1]:.3e}, "
          f"1xTF32 {errs[2]:.3e}")
    _check_x3(*errs)


def test_bwd_full_mantissa_needs_3xtf32():
    """K2 at the train batch (202, 5, 512, 256) on inputs with full 24-bit
    mantissas, against the plain backward in float64: within _X3_FACTOR
    times the error of the plain f32 version, which 1xTF32 misses by
    far."""
    b, s, d, h = 202, 5, 512, 256
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_full_mantissa(rng, (b, s, d))).cuda()
    w = [torch.from_numpy(_full_mantissa(rng, (h, k * d)) / 64).cuda()
         for k in build_relation_plan(s).scales]
    g = torch.from_numpy(_full_mantissa(rng, (b, s - 1, h))).cuda()
    masks = torch.from_numpy(
        rng.integers(0, 2, (b, 10 * h)).astype(np.uint8)).cuda()
    got = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
    plain = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
    want = trn_fused.trn_multiscale_bwd_plain(
        x.double(), [t.double() for t in w], masks, g.double(), s)
    one = trn_fused.trn_multiscale_bwd_plain(
        _tf32(x), [_tf32(t) for t in w], masks, _tf32(g), s)
    flat = lambda r: (r[0], *r[1], *r[2])
    errs = [_rel_err(flat(r), flat(want)) for r in (got, plain, one)]
    print(f"K2 full mantissa: kernel {errs[0]:.3e}, plain f32 {errs[1]:.3e}, "
          f"1xTF32 {errs[2]:.3e}")
    _check_x3(*errs)


def test_fwd_full_mantissa_needs_3xtf32():
    """K1 (train) at the train batch (202, 5, 512, 256) on inputs with
    full 24-bit mantissas, against the plain forward in float64: the
    output within _X3_FACTOR times the error of the plain f32 version,
    which 1xTF32 misses by far; the masks differ from float64's only at
    rounding ties (|z| within 1e-4 * max(1, max|z|) of 0)."""
    b, s, d, h = 202, 5, 512, 256
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_full_mantissa(rng, (b, s, d))).cuda()
    w = [torch.from_numpy(_full_mantissa(rng, (h, k * d)) / 64).cuda()
         for k in build_relation_plan(s).scales]
    bi = [torch.from_numpy(_full_mantissa(rng, (h,)) / 64).cuda()
          for _ in w]
    with torch.no_grad():
        got, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        plain = trn_fused.trn_multiscale_plain(x, w, bi, s)
        xd, wd, bd = x.double(), [t.double() for t in w], \
            [t.double() for t in bi]
        want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
            xd, wd, bd, s)
        one = trn_fused.trn_multiscale_plain(_tf32(x), [_tf32(t) for t in w],
                                             bd, s)
        z = _preacts(xd, wd, bd, s)
    errs = [_rel_err([t], [want]) for t in (got, plain, one)]
    differ = masks != want_masks
    print(f"K1 full mantissa: kernel {errs[0]:.3e}, plain f32 {errs[1]:.3e}, "
          f"1xTF32 {errs[2]:.3e}; {int(differ.sum())} of {masks.numel()} "
          "masks differ from float64's")
    _check_x3(*errs)
    assert (z[differ].abs() <= _tol(z)).all()


def test_gather_gemm_empty_launches_nothing():
    store, _, _, w = _gather_inputs(0)
    _reset_counts()
    rows = gather_gemm.row_index(np.zeros(0, np.int64), 500, "cuda")
    z, x_res = gather_gemm.gathered_gemm(store, rows, w)
    out = gather_gemm.gathered_linear([(store, rows, None)], w,
                                      torch.zeros(96, device="cuda"))
    assert z.shape == (0, 96) and x_res.shape == (0, 256)
    assert out.shape == (0, 96) and gather_gemm.launches == 0


def test_gather_gemm_failed_launch_raises(monkeypatch):
    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue

    store, idx, scale, w = _gather_inputs(8)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    _reset_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        gather_gemm.gathered_gemm(store, rows, w, scale)
    with pytest.raises(RuntimeError, match="launch failed"):
        gather_gemm.gathered_linear([(store, rows, scale)], w,
                                    torch.zeros(96, device="cuda"))
    assert gather_gemm.launches == 0


def test_gather_gemm_refuses_what_it_cannot_take():
    """Indices not checked on the host (a numpy array, a CPU tensor, a
    bare CUDA tensor), int64 or CPU ones in a RowIndex, a float16 store,
    mixed devices and non-contiguous tensors: refused, none read."""
    store, idx, scale, w = _gather_inputs(8)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    _reset_counts()
    for unchecked in (idx, torch.from_numpy(idx), rows.rows):
        with pytest.raises(TypeError, match="checked on the host"):
            gather_gemm.gathered_gemm(store, unchecked, w)
    with pytest.raises(TypeError, match="int32"):
        gather_gemm.gathered_gemm(
            store, gather_gemm.RowIndex(rows.rows.long(), rows.end), w)
    with pytest.raises(ValueError, match="indices on cpu"):
        gather_gemm.gathered_gemm(store, gather_gemm.row_index(idx, 500,
                                                               "cpu"), w)
    with pytest.raises(TypeError):
        gather_gemm.gathered_gemm(store.half(), rows, w)
    with pytest.raises(ValueError, match="on cuda"):
        gather_gemm.gathered_gemm(store, rows, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        gather_gemm.gathered_gemm(store, rows, w.t().contiguous().t())
    with pytest.raises(IndexError):
        gather_gemm.gathered_gemm(store[:100], rows, w)
    assert gather_gemm.launches == 0


def test_gathered_linear_on_cuda_matches_cpu():
    """Two parts into one buffer: the output, dW and db on the card (two
    K3 launches) against the same on the CPU (the plain version)."""
    s_store, s_idx, s_scale, w = _gather_inputs(45, seed=2)
    t_store, t_idx, t_scale, _ = _gather_inputs(20, r=300, seed=3)
    bias = torch.randn(96)
    g = torch.randn((65, 96))
    results = []
    for device in ("cpu", "cuda"):
        weight = w.to(device).clone().requires_grad_(True)
        b = bias.to(device).clone().requires_grad_(True)
        parts = [(st.to(device), gather_gemm.row_index(i, st.shape[0],
                                                       device),
                  sc.to(device))
                 for st, i, sc in ((s_store, s_idx, s_scale),
                                   (t_store, t_idx, t_scale))]
        _reset_counts()
        out = gather_gemm.gathered_linear(parts, weight, b)
        out.backward(g.to(device))
        torch.cuda.synchronize()
        assert gather_gemm.launches == (2 if device == "cuda" else 0)
        results.append([t.detach().cpu() for t in (out, weight.grad,
                                                   b.grad)])
    for got, ref in zip(results[1], results[0]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


_SMALL = dict(num_class=6, baseline_type="video", frame_aggregation="trn-m",
              train_segments=5, val_segments=5, feature_dim=96, fc_dim=64,
              use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)


def _small_state(device):
    gen = torch.Generator().manual_seed(0)
    state = create_train_state(ModelConfig(**_SMALL), TrainConfig(lr=0.03),
                               gen, device="cpu")
    for mod in state.model.modules():
        if isinstance(mod, torch.nn.Linear):
            torch_default_uniform_(mod, gen)
    state.model.to(device)  # the optimizer keeps the same Parameters
    return state


def test_device_store_train_step_on_cuda_matches_cpu():
    """Three device-store steps at small widths, dropout 0, the target
    stream padded: on CUDA two K3, one K1 (train) and one K2 launch per
    step, against the same steps on the CPU."""
    stores = make_domain_pair(num_source=24, num_target=13, num_val=4,
                              num_class=6, feature_dim=96)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy")
    results = []
    for device in ("cpu", "cuda"):
        state = _small_state(device)
        step = make_train_step(state.model, da, TrainConfig(lr=0.03),
                               gather_on_device=True)
        dev = [s.to_device(device) for s in stores[:2]]
        ls = TSNLoader(stores[0], batch_size=8, num_segments=5, seed=1)
        lt = TSNLoader(stores[1], batch_size=5, num_segments=5, seed=2)
        _reset_counts()
        losses = []
        for bs, bt in zip(ls.index_epoch(), lt.index_epoch()):
            state, metrics = step(state, dev[0], *bs, dev[1], *bt,
                                  StepScalars((0.75, 0.75, 0.5), 0.0, 0.0,
                                              0.003, 0.03), None)
            losses.append(float(metrics["loss"]))
        assert len(losses) == 3
        assert _counts() == ((6, 0, 3, 3) if device == "cuda"
                             else (0, 0, 0, 0))
        results.append((losses, {k: v.to("cpu", copy=True) for k, v in
                                 state.model.state_dict().items()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=2e-4)
    for name, ref in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], ref, rtol=1e-3,
                                   atol=2e-5, msg=lambda m: f"{name}: {m}")


def test_eval_steps_on_cuda_match_cpu():
    """The eval step on host features and on the store, and the multi-
    batch eval over a val epoch with a padded last batch: on CUDA one K3
    (without rows) and one K1 (infer) launch per batch, the same metrics
    as on the CPU."""
    val = make_domain_pair(num_source=4, num_target=4, num_val=11,
                           num_class=6, feature_dim=96)[2]
    loader = TSNLoader(val, batch_size=4, num_segments=5, shuffle=False)
    batches = list(zip(loader.epoch(), loader.index_epoch()))
    stacked = [np.stack(a) for a in zip(*(bi for _, bi in batches))]
    results = []
    for device in ("cpu", "cuda"):
        model = _small_state(device).model
        store = val.to_device(device)
        ev, ev_d = (make_eval_step(model, gather_on_device=g)
                    for g in (False, True))
        _reset_counts()
        per_batch = [(ev(*bh), ev_d(store, *bi)) for bh, bi in batches]
        multi = make_multi_eval_step(model)(store, *stacked)
        torch.cuda.synchronize()
        assert _counts() == ((6, 9, 0, 0) if device == "cuda"
                             else (0, 0, 0, 0))
        results.append((per_batch, multi))
    for (got_h, got_d), (ref_h, _) in zip(results[1][0], results[0][0]):
        for got in (got_h, got_d):
            for key in ("loss", "logits", "feat"):
                torch.testing.assert_close(got[key].cpu(), ref_h[key],
                                           rtol=1e-4, atol=1e-5)
            for key in ("top1", "top5", "n"):
                assert float(got[key]) == float(ref_h[key])
    got, ref = results[1][1], results[0][1]
    assert math.isclose(float(got["loss_sum"]), float(ref["loss_sum"]),
                        rel_tol=1e-5)
    for key in ("top1", "top5", "n"):
        assert float(got[key]) == float(ref[key])
