"""PyTorch port on the card: the hand-written kernels (the TRN's inference
forward, training forward and backward, and the fused gather + first-FC
GEMM, also with a weight for each part) against their plain versions, and
the flagship model's CUDA forward, backward, train steps (features from
the host or from stores on the card) and eval steps, the device-store
steps of the comparison rows (AdaBN, MCD, DAN, JAN, CORAL, RNN, temconv,
the frame and tsn baselines), against the CPU; and the TCL and the RNN
in float32 on cuDNN with its TF32 flag at the default.  The bfloat16
variants of the TRN kernels and the six store x compute variants of the
gather kernel against their plain versions in the same dtype (the
backward and the gather at bfloat16 compute, on wgmma, also bit for bit
on exact inputs), the gather at float32 compute (3xTF32 on wgmma) at
every count of K slices, across waves of clusters and from unaligned
pointers, the refusals of what they do not take, and a bfloat16
train step with cuBLAS's bfloat16 reductions in float32.  The chunked
training modes: K device-store steps per call against K single steps,
the sampled and the shard-sampled calls at K = 1, at a call shorter than
K and on a one-shard plan against the K-step call on the same indices,
ShardStream's side-stream uploads read back exactly, the hash sampler
bitwise equal on the CPU and the card, and the Trainer in each chunked
mode on the card against the CPU.  The member axis of the ensembles: the
member-batched TRN kernels and gather + FC, float32 and bfloat16, bitwise
N solo launches and within the plain version's tolerance (bfloat16 also
where the members' strides are not 16-byte multiples), and a 3-member
ensemble's device-store steps (one index stream or one each), eval step
and Predictor (bfloat16: from_sweep) on the card against the CPU, with
their launches, at float32 and at bfloat16 compute.  Data parallelism:
two ranks in a gloo group on one card against one rank, NCCL at world
size 1 against no mesh, and each kernel launched on a second card by the
process that launched it on the first (which skips on one card).

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
from ta3n_tpu_torch.models.layers import TCL, torch_default_uniform_
from ta3n_tpu_torch.models.rnn import build_rnn, chunk_frames, rnn_aggregate
from ta3n_tpu_torch.ops import _build, gather_gemm, trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.train import (StepScalars, create_train_state,
                                  make_eval_step, make_multi_eval_step,
                                  make_multi_train_step,
                                  make_sampled_multi_step,
                                  make_sampled_shard_multi_step,
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
    """K1 around its video tiles (the narrowest of 8..64 that holds B, else
    128): B = 63 and 64 in one tile of 64, 65 and 129 ending past a tile
    of 128 by 1, 202 = 128 + 74."""
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
    """K1 with D not a multiple of its 32-deep chunk: D = 37 (x by 4-byte
    loads, the weights copied into rows TMA can take) and D = 100 (both
    read as they are), at 1 and at 3 D slices (3 > the 2 chunks of
    D = 37: a slice with no chunk adds zeros)."""
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
    """K2 around the 16-row boundary of a warp's rows of a wgmma fragment,
    at widths TMA reads as they are (D % 4 == 0, H % 4 == 0): the checks
    of test_bwd_kernel_matches_plain."""
    _check_bwd(b, 5, 128, 64)


@pytest.mark.parametrize("kernel", ["infer", "train", "bwd"])
@pytest.mark.parametrize("splits", range(1, 17))
def test_f32_trn_every_slice_count(kernel, splits, monkeypatch):
    """The float32 K1 (its GEMM's D slices) and K2 (its GEMM's K slices,
    the dx and the dW tiles alike) in clusters of every size 1..16 at the
    train batch: the checks of _check_fwd and of _check_bwd (tolerance,
    masks, a second call bitwise, exact inputs bit for bit)."""
    if kernel == "bwd":
        chosen = trn_fused.f32_bwd_plan
        monkeypatch.setattr(trn_fused, "f32_bwd_plan", lambda *a, **k:
                            chosen(*a, **k)._replace(splits=splits))
        _check_bwd(202, 5, 512, 256)
    else:
        monkeypatch.setattr(trn_fused, "_fwd_splits", lambda *a: splits)
        _check_fwd(202, 5, 512, 256, kernel == "train")


def _offset(t):
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary (a view one element into a larger buffer)."""
    k = 4 // t.element_size()
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


@pytest.mark.parametrize("b,s,d,h", [(202, 5, 512, 256), (70, 5, 100, 40),
                                     (13, 4, 37, 19)])
def test_f32_trn_misaligned_operands(b, s, d, h):
    """x, g and every weight 4 bytes off 16-byte alignment: K1 reads x by
    its 4-byte loads and the weights through the copy into rows TMA can
    take, K2 its g and masks by 4-byte loads; every output bitwise the
    aligned operands' (the same products in the same order) and within
    the tolerance of the plain version."""
    x, w, bi = _trn_inputs(b, s, d, h)
    g = torch.randn((b, s - 1, h), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    ox, ow, og = _offset(x), [_offset(t) for t in w], _offset(g)
    with torch.no_grad():
        out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        o_out, o_masks = trn_fused.trn_multiscale_fwd_masks(ox, ow, bi, s)
        infer = trn_fused.trn_multiscale_infer(x, w, bi, s)
        o_infer = trn_fused.trn_multiscale_infer(ox, ow, bi, s)
        grads = trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
        o_grads = trn_fused.trn_multiscale_bwd(ox, ow, _offset(masks), og,
                                               s)
        want = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
    torch.cuda.synchronize()
    assert torch.equal(out, o_out) and torch.equal(masks, o_masks)
    assert torch.equal(infer, o_infer)
    for ours, theirs, ref in zip((grads[0], *grads[1], *grads[2]),
                                 (o_grads[0], *o_grads[1], *o_grads[2]),
                                 (want[0], *want[1], *want[2])):
        assert torch.equal(ours, theirs)
        assert (ours - ref).abs().max().item() <= _tol(ref)


@pytest.mark.parametrize("b,s,d,h", [(70, 5, 22, 50), (129, 4, 37, 19),
                                     (5, 6, 100, 130), (33, 3, 6, 7)])
def test_f32_trn_ragged_widths(b, s, d, h):
    """Ragged B, H and D (D not a multiple of 4: the weights copied into
    rows TMA can take, x and the planes padded), K1 at video tiles of 8
    to 128: the checks of _check_fwd (both variants) and _check_bwd."""
    _check_fwd(b, s, d, h, False)
    _check_fwd(b, s, d, h, True)
    _check_bwd(b, s, d, h)


def test_f32_trn_second_call_new_weights():
    """A second call with new weights (new tensors at other addresses,
    then the first weights updated in place): each call of K1 and K2
    within the tolerance of the plain version on the weights it was
    given (the kernels' tensor maps are cached by address and shape, so
    no map outlives what it describes)."""
    b, s, d, h = 202, 5, 512, 256
    x, w, bi = _trn_inputs(b, s, d, h)
    _, w2, bi2 = _trn_inputs(b, s, d, h, seed=7)
    g = torch.randn((b, s - 1, h), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    with torch.no_grad():
        for weights, biases in ((w, bi), (w2, bi2), (w, bi)):
            out, masks = trn_fused.trn_multiscale_fwd_masks(x, weights,
                                                            biases, s)
            want = trn_fused.trn_multiscale_plain(x, weights, biases, s)
            assert (out - want).abs().max().item() <= _tol(want)
            got = trn_fused.trn_multiscale_bwd(x, weights, masks, g, s)
            ref = trn_fused.trn_multiscale_bwd_plain(x, weights, masks, g, s)
            for ours, r in zip((got[0], *got[1], *got[2]),
                               (ref[0], *ref[1], *ref[2])):
                assert (ours - r).abs().max().item() <= _tol(r)
            for t in w:  # the first weights change in place
                t.mul_(-0.5)
    torch.cuda.synchronize()


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
    """K3 around the 64-row tile and the 128-row tile of float32 compute
    (one K slice, and as many as the kernel takes: 8 over the 8 chunks of
    D = 256): the checks of test_gather_gemm_kernel_matches_plain."""
    chosen = gather_gemm.f32_plan
    monkeypatch.setattr(gather_gemm, "f32_plan", lambda *a, **kw: chosen(
        *a, **kw)._replace(splits=1 if splits == "one" else 8))
    _check_gather(n, None, 1, 256)


@pytest.mark.parametrize("d", [100, 50])
def test_gather_gemm_ragged_k_chunk(d):
    """K3 with D not a multiple of its 32-deep K chunk, with 16-byte copies
    (D = 100) and with 4-byte copies (D = 50)."""
    _check_gather(70, None, 1, d)


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8, 16])
def test_f32_gather_every_split_count(splits, monkeypatch):
    """K3 at float32 compute with its K slices forced to each cluster size
    the kernel takes (1..8, and 16 past the portable limit), at the train
    shape over 2 members: z within the float32 tolerance of the plain
    version, bitwise the solo launches at the same slices and, on dyadic
    grids (every product and float32 sum exact), bitwise the plain
    version; x_res bitwise."""
    chosen = gather_gemm.f32_plan
    monkeypatch.setattr(gather_gemm, "f32_plan", lambda *a, **kw: chosen(
        *a, **kw)._replace(splits=splits))
    for grid in (False, True):
        store, idx, scale, w = _gather_inputs(640, d=2048, h=512,
                                              grid=grid)
        w = torch.stack([w, w.flip(0)])
        rows = gather_gemm.row_index(idx, 500, "cuda")
        z, x_res = gather_gemm.gathered_gemm_members(store, rows, w, scale)
        for k in range(2):
            sz, sx = gather_gemm.gathered_gemm(store, rows, w[k], scale)
            pz, px = gather_gemm.gathered_gemm_plain(store, rows.rows, w[k],
                                                     scale)
            assert torch.equal(z[k], sz) and torch.equal(x_res, px)
            assert torch.equal(sx, px)
            if grid:
                assert torch.equal(z[k], pz)
            else:
                assert (z[k] - pz).abs().max().item() <= _tol(pz)
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("h,rows", [(512, 640), (128, 370)])
def test_f32_member_gather_clusters_bitwise_solo(h, rows, per_member):
    """K3 at float32 compute over 8 members, where one member's clusters
    fill the card (the train shape's 20 tiles in clusters of 5, the H =
    128 slice's 3 tiles in clusters of 16) so that 8 members take several
    waves of clusters: each member's z bitwise its solo launch (one
    member, one wave), x_res bitwise, z within the float32 tolerance of
    the plain version."""
    n = 8
    store, _, _, _ = _gather_inputs(8, d=2048, h=h)
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.uniform(-1, 1, (n, h, 2048)) / 45.0)
                         .astype(np.float32)).cuda()
    m = n if per_member else 1
    idx = rng.integers(0, store.shape[0], (m, rows))
    scale = torch.from_numpy(rng.choice([1.0, 0.0, 0.5], (m, rows))
                             .astype(np.float32)).cuda()
    checked = gather_gemm.row_index(idx, store.shape[0], "cuda")
    member_idx = (gather_gemm.RowIndex(checked.rows.reshape(n, rows),
                                       checked.end) if per_member
                  else checked)
    splits = gather_gemm.f32_plan(rows, h, 2048, 1, n, per_member).splits
    assert splits == (5 if h == 512 else 16)
    _reset_counts()
    z, x_res = gather_gemm.gathered_gemm_members(
        store, member_idx, w, scale if per_member else scale[0])
    assert gather_gemm.launches == 1
    for k in range(n):
        j = k if per_member else 0
        rows_k = gather_gemm.row_index(idx[j], store.shape[0], "cuda")
        sz, sx = gather_gemm.gathered_gemm(store, rows_k, w[k], scale[j])
        pz, px = gather_gemm.gathered_gemm_plain(store, rows_k.rows, w[k],
                                                 scale[j])
        assert torch.equal(z[k], sz)
        assert (z[k] - pz).abs().max().item() <= _tol(pz)
        got_x = x_res[k] if per_member else x_res
        assert torch.equal(got_x, sx) and torch.equal(got_x, px)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d,k", [(2048, 1), (50, 1), (37, 3)])
def test_f32_gather_unaligned_pointers(kind, d, k):
    """K3 at float32 compute with a weight and an x_res that start 4
    bytes past a 16-byte boundary (the weight's rows copied to aligned
    rows of scratch first, stage A's plain stores), at D = 2048 and at
    k*D not a multiple of 4 (D = 50; k = 3 rows of D = 37 a row, 111
    values, padded to 112 in the planes): z bitwise the aligned call's
    and within the float32 tolerance of the plain version, x_res bitwise
    the plain version's."""
    n = 60 * k
    store, idx, scale, w = _gather_inputs(n, d=d, h=96, k=k)
    store = _narrow_store(store, kind)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    m, kd = n // k, k * d
    w_buf = torch.empty(w.numel() + 1, device="cuda")
    w_off = w_buf[1:].view_as(w)
    w_off.copy_(w)
    x_buf = torch.empty(m * kd + 1, device="cuda")
    x_off = x_buf[1:].view(m, kd)
    z_off = torch.empty((m, 96), device="cuda")
    assert w_off.data_ptr() % 16 == 4 and x_off.data_ptr() % 16 == 4
    streams_d_k_m = (1, d, k, m)
    gather_gemm.variant_launches[f"{kind}_f32"] = 0
    gather_gemm._gather_into(store, rows.rows, streams_d_k_m, w_off, scale,
                             z_off, x_off)
    z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale)
    want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, w,
                                                   scale)
    torch.cuda.synchronize()
    assert gather_gemm.variant_launches[f"{kind}_f32"] == 2
    assert torch.equal(z_off, z)
    assert (z - want).abs().max().item() <= _tol(want)
    assert torch.equal(x_off, want_x) and torch.equal(x_res, want_x)


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


def test_gathered_linear_two_weights_on_cuda_matches_cpu():
    """share_params N: the source part with its weight and bias, the
    target part with its own, into one buffer; on the card two K3
    launches, each with its part's weight; the output and each weight's
    dW = dzᵀ x_res and db over its own rows against the CPU."""
    s_store, s_idx, s_scale, w_s = _gather_inputs(45, seed=4)
    t_store, t_idx, t_scale, w_t = _gather_inputs(20, r=300, seed=5)
    biases = (torch.randn(96), torch.randn(96))
    g = torch.randn((65, 96))
    results = []
    for device in ("cpu", "cuda"):
        weights = [w.to(device).clone().requires_grad_(True)
                   for w in (w_s, w_t)]
        bs = [b.to(device).clone().requires_grad_(True) for b in biases]
        parts = [(st.to(device), gather_gemm.row_index(i, st.shape[0],
                                                       device),
                  sc.to(device))
                 for st, i, sc in ((s_store, s_idx, s_scale),
                                   (t_store, t_idx, t_scale))]
        _reset_counts()
        out = gather_gemm.gathered_linear(parts, weights, bs)
        out.backward(g.to(device))
        torch.cuda.synchronize()
        assert gather_gemm.launches == (2 if device == "cuda" else 0)
        results.append([t.detach().cpu() for t in (
            out, *(w.grad for w in weights), *(b.grad for b in bs))])
    for got, ref in zip(results[1], results[0]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    # each part's rows through its own weight only
    x_t = t_store.cpu()[torch.from_numpy(t_idx).long()] * \
        t_scale.cpu()[:, None]
    torch.testing.assert_close(results[0][0][45:],
                               x_t @ w_t.cpu().T + biases[1],
                               rtol=1e-5, atol=1e-5)


_SMALL = dict(num_class=6, baseline_type="video", frame_aggregation="trn-m",
              train_segments=5, val_segments=5, feature_dim=96, fc_dim=64,
              use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)


def _small_state(device, **fields):
    gen = torch.Generator().manual_seed(0)
    state = create_train_state(ModelConfig(**{**_SMALL, **fields}),
                               TrainConfig(lr=0.03), gen, device="cpu")
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


@pytest.mark.parametrize("name,fields,da,per_step", [
    ("adabn", dict(use_bn="AdaBN"), {}, (2, 0, 1, 1)),
    ("mcd", dict(ens_DA="MCD"), dict(ens_DA="MCD"), (2, 0, 2, 2)),
])
def test_comparison_config_store_step_on_cuda_matches_cpu(name, fields, da,
                                                          per_step):
    """Three device-store steps of AdaBN and of MCD at small widths,
    dropout 0, the target stream padded: the kernels' launches per step
    (MCD runs the TRN forward and backward twice on one K3 output), the
    losses, parameters and BN running stats against the same steps on
    the CPU (the plain versions)."""
    stores = make_domain_pair(num_source=24, num_target=13, num_val=4,
                              num_class=6, feature_dim=96)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy", **da)
    results = []
    for device in ("cpu", "cuda"):
        state = _small_state(device, **fields)
        step = make_train_step(state.model, da, TrainConfig(lr=0.03),
                               gather_on_device=True)
        dev = [s.to_device(device) for s in stores[:2]]
        ls = TSNLoader(stores[0], batch_size=8, num_segments=5, seed=1)
        lt = TSNLoader(stores[1], batch_size=5, num_segments=5, seed=2)
        _reset_counts()
        losses = []
        for bs, bt in zip(ls.index_epoch(), lt.index_epoch()):
            state, metrics = step(state, dev[0], *bs, dev[1], *bt,
                                  StepScalars((0.75, 0.75, 0.5), 0.5, 0.0,
                                              0.003, 0.03), None)
            losses.append([float(metrics[k]) for k in sorted(metrics)])
        torch.cuda.synchronize()
        assert len(losses) == 3
        assert _counts() == (tuple(3 * n for n in per_step)
                             if device == "cuda" else (0, 0, 0, 0)), name
        results.append((losses, {k: v.to("cpu", copy=True) for k, v in
                                 state.model.state_dict().items()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=2e-4)
    for key, ref in results[0][1].items():
        torch.testing.assert_close(results[1][1][key], ref, rtol=1e-3,
                                   atol=2e-5, msg=lambda m: f"{key}: {m}")


_RECIPE = dict(use_target="uSv", adv_DA="RevGrad",
               add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
_AVGPOOL = dict(frame_aggregation="avgpool", use_attn="none")
_NYY = dict(use_target="uSv", adv_DA="RevGrad", place_adv=("N", "Y", "Y"))


@pytest.mark.parametrize("name,fields,da,per_step", [
    ("tempooling_dan", _AVGPOOL, dict(use_target="uSv", dis_DA="DAN",
                                      place_dis=("Y", "Y", "N")),
     (2, 0, 0, 0)),
    ("tempooling_jan", _AVGPOOL, dict(use_target="uSv", dis_DA="JAN"),
     (2, 0, 0, 0)),
    ("ta3n_dan_all", {}, dict(_RECIPE, dis_DA="DAN",
                              place_dis=("Y", "Y", "Y")), (2, 0, 1, 1)),
    ("ta3n_coral_all", {}, dict(_RECIPE, dis_DA="CORAL",
                                place_dis=("Y", "Y", "Y")), (2, 0, 1, 1)),
    ("rnn_bilstm", dict(frame_aggregation="rnn", rnn_cell="LSTM", n_rnn=2,
                        n_directions=2, n_ts=3, use_attn="none"), _NYY,
     (2, 0, 0, 0)),
    ("rnn_gru", dict(frame_aggregation="rnn", rnn_cell="GRU", n_ts=2,
                     use_attn="none"), _NYY, (2, 0, 0, 0)),
    ("temconv_adabn", dict(frame_aggregation="temconv", use_bn="AdaBN",
                           use_attn="none"), _NYY, (2, 0, 0, 0)),
    ("frame_ta3n", dict(baseline_type="frame"), _RECIPE, (2, 0, 1, 1)),
    ("tsn_tempooling", dict(baseline_type="tsn", **_AVGPOOL),
     dict(use_target="uSv", adv_DA="RevGrad", place_adv=("N", "N", "Y")),
     (2, 0, 0, 0)),
])
def test_new_rows_store_step_on_cuda_matches_cpu(name, fields, da,
                                                 per_step):
    """Three device-store steps of each row that the discrepancy losses,
    the RNN and temconv aggregations and the frame and tsn baselines add,
    at small widths, dropout 0, alpha 1, the target stream padded: the
    kernels' launches per step, the losses, parameters and BN running
    stats against the same steps on the CPU (the plain versions), with
    cuDNN's TF32 flag at its default."""
    stores = make_domain_pair(num_source=24, num_target=13, num_val=4,
                              num_class=6, feature_dim=96)
    results = []
    for device in ("cpu", "cuda"):
        state = _small_state(device, **fields)
        step = make_train_step(state.model, DAConfig(**da),
                               TrainConfig(lr=0.03), gather_on_device=True)
        dev = [s.to_device(device) for s in stores[:2]]
        ls = TSNLoader(stores[0], batch_size=8, num_segments=5, seed=1)
        lt = TSNLoader(stores[1], batch_size=5, num_segments=5, seed=2)
        _reset_counts()
        losses = []
        for bs, bt in zip(ls.index_epoch(), lt.index_epoch()):
            state, metrics = step(state, dev[0], *bs, dev[1], *bt,
                                  StepScalars((0.75, 0.75, 0.5), 0.5, 1.0,
                                              0.003, 0.03), None)
            losses.append([float(metrics[k]) for k in sorted(metrics)])
        torch.cuda.synchronize()
        assert _counts() == (tuple(3 * n for n in per_step)
                             if device == "cuda" else (0, 0, 0, 0)), name
        results.append((losses, {k: v.to("cpu", copy=True) for k, v in
                                 state.model.state_dict().items()}))
    assert torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=2e-4)
    for key, ref in results[0][1].items():
        torch.testing.assert_close(results[1][1][key], ref, rtol=1e-3,
                                   atol=2e-5, msg=lambda m: f"{key}: {m}")


def _rel(got, want):
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("module", ["lstm", "gru", "tcl"])
def test_tcl_and_rnn_are_f32_with_cudnn_tf32_at_its_default(module):
    """The flagship widths (202 videos, 5 frames, 512 units): the TCL and
    the bidirectional two-layer LSTM / GRU of the RNN aggregator on the
    card, with ``torch.backends.cudnn.allow_tf32`` left at its default
    (True), give the CPU float32 output and gradients of the input and of
    every parameter within 5e-5 of their largest value; the module called
    without the port's pin (cudnn_f32), under the same flag, is printed
    for the record.  The bound: a parameter gradient sums up to 517,120
    products (the TCL's) in another order on each side, which costs up to
    1.6e-5 in float32 on the H100, while TF32 shows from 1.6e-4 up (the
    unpinned RNN: 1.6e-4 to 1.1e-3)."""
    assert torch.backends.cudnn.allow_tf32
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(202, 5, 512)).astype(np.float32))
    if module == "tcl":
        layer = TCL(3, gen)
        pinned = layer

        def unpinned(t):
            return layer.conv2d(t[:, None])[:, 0]
    else:
        layer = build_rnn(ModelConfig(
            num_class=12, feature_dim=2048, fc_dim=512,
            frame_aggregation="rnn", n_rnn=2, n_directions=2, n_ts=3,
            rnn_cell=module.upper()), gen)

        def pinned(t):
            return rnn_aggregate(layer, t, 3)

        def unpinned(t):
            return layer(chunk_frames(t, 3))[0][:, -1]

    def run(fn, device, g=None):
        layer.to(device)
        xd = x.to(device, copy=True).requires_grad_()
        out = fn(xd)
        if g is None:
            g = torch.from_numpy(rng.normal(size=tuple(out.shape))
                                 .astype(np.float32))
        layer.zero_grad(set_to_none=True)
        (out * g.to(device)).sum().backward()
        return [t.detach().cpu() for t in (out, xd.grad,
                                           *(p.grad for p in
                                             layer.parameters()))], g

    want, g = run(pinned, "cpu")
    got, _ = run(pinned, "cuda", g)
    loose, _ = run(unpinned, "cuda", g)
    errs = [_rel(a, b) for a, b in zip(got, want)]
    print(f"{module}: pinned output and gradient errors "
          f"{['%.1e' % e for e in errs]}; unpinned "
          f"{['%.1e' % _rel(a, b) for a, b in zip(loose, want)]}")
    assert torch.backends.cudnn.allow_tf32
    assert max(errs) <= 5e-5, errs


# ---- bfloat16 and narrow-store variants ----

# One bfloat16 ulp of the element (at most 2**-7 of it: a float32 sum on
# either side of a rounding midpoint rounds to neighbours), plus float32
# summation-order differences at the tensor's scale, a tenth of the
# float32 checks' 1e-4 * max.
def _bf16_ok(got, want):
    got, want = got.float(), want.float()
    if want.numel() == 0:
        return got.shape == want.shape
    bound = 2.0 ** -7 * want.abs() + 1e-5 * max(1.0, want.abs().max().item())
    return bool(((got - want).abs() <= bound).all())


BF16_CASES = [(1, 5, 512, 256), (64, 5, 512, 256), (202, 5, 512, 256),
              (202, 17, 512, 256), (13, 4, 24, 8), (5, 3, 37, 19),
              (3, 2, 40, 33)]


def _bf16_trn_inputs(b, s, d, h, seed=0):
    x, w, bi = _trn_inputs(b, s, d, h, seed)
    bf = torch.bfloat16
    return x.to(bf), [t.to(bf) for t in w], [t.to(bf) for t in bi]


def _subset_z(x, w, bi, s):
    """z of every subset [B, n_sub*H] in float32 from the bfloat16 inputs,
    in the masks' order."""
    b = x.shape[0]
    zs = []
    for wi, bias, k, subsets in zip(w, bi, build_relation_plan(s).scales,
                                    build_relation_plan(s).subsets):
        idx = torch.as_tensor(subsets.reshape(-1), device=x.device)
        g = x.float().index_select(1, idx).reshape(b, len(subsets),
                                                   k * x.shape[2])
        zs.append((torch.relu(g) @ wi.float().T + bias.float())
                  .reshape(b, -1))
    return torch.cat(zs, dim=1)


@pytest.mark.parametrize("b,s,d,h", BF16_CASES + [(202, 25, 512, 256)])
def test_bf16_fwd_kernels_match_plain(b, s, d, h):
    """K1 (infer) and K1 (train) in bfloat16 against the plain version in
    bfloat16 (_bf16_ok); masks equal except where |z| is within float32
    summation order of 0; one launch of each bfloat16 variant per call,
    none of the float32 ones; bitwise equal on a second call; on bfloat16
    inputs on dyadic grids (every product and float32 sum exact) output
    and masks bitwise equal to the plain version's, which a wrong
    descriptor, swizzle or box would break."""
    x, w, bi = _bf16_trn_inputs(b, s, d, h)
    bf = torch.bfloat16
    gx, gw, gb, _ = _grid_inputs(b, s, d, h, seed=1)
    gx, gw, gb = gx.to(bf), [t.to(bf) for t in gw], [t.to(bf) for t in gb]
    trn_fused.bf16_launches = trn_fused.bf16_train_launches = 0
    _reset_counts()
    with torch.inference_mode():
        got = trn_fused.trn_multiscale_infer(x, w, bi, s)
        again = trn_fused.trn_multiscale_infer(x, w, bi, s)
        out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        want = trn_fused.trn_multiscale_plain(x, w, bi, s)
        want_out, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
            x, w, bi, s)
        z = _subset_z(x, w, bi, s)
        grid_got = trn_fused.trn_multiscale_infer(gx, gw, gb, s)
        grid_out, grid_masks = trn_fused.trn_multiscale_fwd_masks(gx, gw,
                                                                  gb, s)
        grid_want, grid_want_masks = \
            trn_fused.trn_multiscale_fwd_masks_plain(gx, gw, gb, s)
    torch.cuda.synchronize()
    assert (trn_fused.bf16_launches, trn_fused.bf16_train_launches) == (3, 2)
    assert _counts() == (0, 0, 0, 0)
    assert got.dtype == out.dtype == torch.bfloat16
    assert got.shape == (b, s - 1, h)
    assert _bf16_ok(got, want) and _bf16_ok(out, want_out)
    assert torch.equal(got, again) and torch.equal(got, out)
    differ = masks != want_masks
    assert (z[differ].abs() <= 1e-5 * z.abs().max()).all()
    assert torch.equal(grid_got, grid_want) and torch.equal(grid_out,
                                                            grid_want)
    assert torch.equal(grid_masks, grid_want_masks)


@pytest.mark.parametrize("b,d", [(63, 512), (65, 512), (128, 512),
                                 (129, 512), (129, 37), (70, 100)])
def test_bf16_fwd_kernel_batch_edges(b, d):
    """K1 in bfloat16 around its 64-video row tiles and with D off TMA's
    16-byte rule (37, 100: plain staging):
    infer and train within _bf16_ok of the plain version, masks equal
    except at ties, and bitwise equal on exact inputs."""
    s, h = 5, 72
    x, w, bi = _bf16_trn_inputs(b, s, d, h)
    bf = torch.bfloat16
    gx, gw, gb, _ = _grid_inputs(b, s, d, h, seed=2)
    gx, gw, gb = gx.to(bf), [t.to(bf) for t in gw], [t.to(bf) for t in gb]
    with torch.inference_mode():
        got = trn_fused.trn_multiscale_infer(x, w, bi, s)
        out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
            x, w, bi, s)
        z = _subset_z(x, w, bi, s)
        grid_out, grid_masks = trn_fused.trn_multiscale_fwd_masks(gx, gw,
                                                                  gb, s)
        grid_want, grid_want_masks = \
            trn_fused.trn_multiscale_fwd_masks_plain(gx, gw, gb, s)
    torch.cuda.synchronize()
    assert _bf16_ok(got, want) and torch.equal(got, out)
    differ = masks != want_masks
    assert (z[differ].abs() <= 1e-5 * z.abs().max()).all()
    assert torch.equal(grid_out, grid_want)
    assert torch.equal(grid_masks, grid_want_masks)


def test_bf16_fwd_kernel_takes_new_weights():
    """K1 in bfloat16 called with one set of weights, then with new weight
    tensors of the same shapes at other addresses (the first set still
    alive), then with the first again: each call right against the plain
    version, so no tensor map made for one weight serves another."""
    x, w1, b1 = _bf16_trn_inputs(202, 5, 512, 256, seed=0)
    _, w2, b2 = _bf16_trn_inputs(202, 5, 512, 256, seed=4)
    assert all(a.data_ptr() != c.data_ptr() for a, c in zip(w1, w2))
    with torch.inference_mode():
        for w, bi in ((w1, b1), (w2, b2), (w1, b1)):
            got = trn_fused.trn_multiscale_infer(x, w, bi, 5)
            out, _ = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
            want = trn_fused.trn_multiscale_plain(x, w, bi, 5)
            torch.cuda.synchronize()
            assert _bf16_ok(got, want) and torch.equal(got, out)


def test_bf16_kernels_refuse_more_scales_than_their_maps():
    """The bfloat16 TRN kernels take BF16_MAX_SCALES scales: one more
    raises, naming the limit, and launches nothing."""
    s = trn_fused.BF16_MAX_SCALES + 2
    x, w, bi = _bf16_trn_inputs(2, s, 16, 8)
    trn_fused.bf16_launches = trn_fused.bf16_train_launches = 0
    trn_fused.bf16_bwd_launches = 0
    limit = f"at most {trn_fused.BF16_MAX_SCALES} scales"
    with torch.inference_mode():
        with pytest.raises(ValueError, match=limit):
            trn_fused.trn_multiscale_infer(x, w, bi, s)
        with pytest.raises(ValueError, match=limit):
            trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
        masks = torch.zeros((2, trn_fused._n_subsets(s, 3) * 8),
                            dtype=torch.uint8, device="cuda")
        g = torch.zeros((2, s - 1, 8), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match=limit):
            trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
    assert (trn_fused.bf16_launches, trn_fused.bf16_train_launches,
            trn_fused.bf16_bwd_launches) == (0, 0, 0)


@pytest.mark.parametrize("b,s,d,h", BF16_CASES + [(202, 25, 512, 256)])
def test_bf16_bwd_kernel_matches_plain(b, s, d, h):
    """K2 in bfloat16 from the plain version's masks: dx, every dW and db
    in bfloat16 within _bf16_ok of the plain version, a second call
    bitwise equal; on bfloat16 inputs on dyadic grids (every product and
    float32 sum exact) bitwise equal to the plain version; one launch of
    the bfloat16 variant a call."""
    x, w, bi = _bf16_trn_inputs(b, s, d, h)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, s - 1, h)).astype(np.float32)).cuda().to(torch.bfloat16)
    _, masks = trn_fused.trn_multiscale_fwd_masks_plain(x, w, bi, s)
    bf = torch.bfloat16
    gx, gw, gb, gg = _grid_inputs(b, s, d, h, seed=1)
    gx, gw, gb, gg = (gx.to(bf), [t.to(bf) for t in gw],
                      [t.to(bf) for t in gb], gg.to(bf))
    _, grid_masks = trn_fused.trn_multiscale_fwd_masks_plain(gx, gw, gb, s)
    trn_fused.bf16_bwd_launches = 0
    got = trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
    again = trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
    grid_got = trn_fused.trn_multiscale_bwd(gx, gw, grid_masks, gg, s)
    want = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
    grid_want = trn_fused.trn_multiscale_bwd_plain(gx, gw, grid_masks, gg,
                                                   s)
    torch.cuda.synchronize()
    assert trn_fused.bf16_bwd_launches == 3
    flat = lambda r: (r[0], *r[1], *r[2])
    dx, dws = got[0], got[1]
    assert dx.dtype == torch.bfloat16 and dws[0].dtype == torch.bfloat16
    for a, c, a2 in zip(flat(got), flat(want), flat(again)):
        assert a.shape == c.shape and _bf16_ok(a, c)
        assert torch.equal(a, a2)
    for a, c in zip(flat(grid_got), flat(grid_want)):
        assert torch.equal(a, c)


def _narrow_store(store, kind):
    """A float32 store as the given store kind: itself, bfloat16, or an
    int8 (q, scale) pair quantized per row on the host."""
    if kind == "f32":
        return store
    if kind == "bf16":
        return store.to(torch.bfloat16)
    from ta3n_tpu_torch.data.quantized import quantize_rows
    q, sc = quantize_rows(store.cpu().numpy())
    return torch.from_numpy(q).cuda(), torch.from_numpy(sc).cuda()


@pytest.mark.parametrize("n,with_rows,h", [
    pytest.param(n, with_rows, h, id=f"{n}-{with_rows}" + (
        f"-h{h}" if h != 128 else ""))
    for n, with_rows, h in [
        (640, True, 128), (320, False, 128), (37, True, 128), (0, True, 128),
        (1, True, 128), (63, True, 128), (64, True, 128), (65, True, 128),
        (370, True, 128), (1010, True, 128), (640, True, 500)]])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_gather_gemm_variants_match_plain(kind, compute, n, with_rows, h):
    """Every store x compute variant of K3 against the plain version on the
    same store: z within the float32 check's tolerance at float32 compute
    and _bf16_ok at bfloat16 compute, x_res bitwise equal (an int8 store's
    rows dequantized as float(q) * scale, then * row_scale), a second call
    bitwise equal; at bfloat16 compute from a float32 or bfloat16 store on
    dyadic grids, with a weight on one (every product and float32 sum
    exact), z bitwise equal to plain; one launch of the variant per call,
    none at N = 0.  Row counts around
    the 64-row tile and the train and eval shapes, and H = 500 (not a
    multiple of the 128-column tile of the bfloat16 kernel)."""
    store, idx, scale, w = _gather_inputs(n, d=512, h=h)
    store = _narrow_store(store, kind)
    gstore, gidx, gscale, gw = _gather_inputs(n, d=512, h=h, seed=1,
                                              grid=True)
    gstore = _narrow_store(gstore, kind)
    if compute == "bf16":
        w, gw = w.to(torch.bfloat16), gw.to(torch.bfloat16)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    grows = gather_gemm.row_index(gidx, 500, "cuda")
    name = f"{kind}_{compute}"
    gather_gemm.variant_launches[name] = 0
    z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale,
                                         with_rows=with_rows)
    again, x_again = gather_gemm.gathered_gemm(store, rows, w, scale,
                                               with_rows=with_rows)
    grid_z, _ = gather_gemm.gathered_gemm(gstore, grows, gw, gscale,
                                          with_rows=with_rows)
    want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, w,
                                                   scale)
    grid_want, _ = gather_gemm.gathered_gemm_plain(gstore, grows.rows, gw,
                                                   gscale)
    torch.cuda.synchronize()
    assert gather_gemm.variant_launches[name] == (3 if n else 0)
    assert z.dtype == w.dtype and z.shape == (n, h)
    assert torch.equal(z, again)
    if compute == "f32":
        assert (z - want).abs().max().item() <= _tol(want) if n else True
    else:
        assert _bf16_ok(z, want)
        # an int8 store's dequantized rows are off the grid
        assert kind == "int8" or torch.equal(grid_z, grid_want)
    if with_rows:
        assert x_res.dtype == w.dtype and torch.equal(x_res, want_x)
        assert torch.equal(x_res, x_again)
    else:
        assert x_res is None and x_again is None


def test_bf16_kernels_refuse_other_layouts():
    """A bfloat16 CUDA tensor of a layout the kernels do not take raises:
    non-contiguous, mixed with float32 weights, an int8 store without its
    scales; nothing is launched."""
    x, w, bi = _bf16_trn_inputs(4, 5, 32, 16)
    trn_fused.bf16_launches = 0
    for name in ("int8_bf16", "bf16_bf16"):
        gather_gemm.variant_launches[name] = 0
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            trn_fused.trn_multiscale_infer(
                x.transpose(0, 1).contiguous().transpose(0, 1), w, bi, 5)
        with pytest.raises(TypeError):
            trn_fused.trn_multiscale_infer(x, [t.float() for t in w], bi, 5)
    store, idx, scale, wg = _gather_inputs(8)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    q = _narrow_store(store, "int8")
    with pytest.raises(TypeError):
        gather_gemm.gathered_gemm(q[0], rows, wg.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        gather_gemm.gathered_gemm(store.to(torch.bfloat16), rows,
                                  wg.t().contiguous().t().to(torch.bfloat16))
    assert trn_fused.bf16_launches == 0
    assert not any(gather_gemm.variant_launches[k] for k in
                   ("int8_bf16", "bf16_bf16"))


def test_f16_refused_by_every_kernel():
    """float16 has no kernel: each wrapper raises TypeError on it."""
    x, w, bi = _trn_inputs(4, 5, 32, 16)
    half = [t.half() for t in w], [t.half() for t in bi]
    with torch.inference_mode():
        with pytest.raises(TypeError):
            trn_fused.trn_multiscale_infer(x.half(), *half, 5)
        with pytest.raises(TypeError):
            trn_fused.trn_multiscale_fwd_masks(x.half(), *half, 5)
        with pytest.raises(TypeError):
            trn_fused.trn_multiscale_bwd(
                x.half(), half[0],
                torch.zeros((4, 160), dtype=torch.uint8, device="cuda"),
                torch.zeros((4, 4, 16), device="cuda").half(), 5)
    store, idx, scale, wg = _gather_inputs(8)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    for st, ww in ((store.half(), wg), (store, wg.half())):
        with pytest.raises(TypeError):
            gather_gemm.gathered_gemm(st, rows, ww)


def test_bf16_step_reduces_in_f32():
    """A bfloat16 device-store train step from an int8 store runs its
    bfloat16 kernels (two K3 int8 x bf16, one K1 (train) and one K2 in
    bfloat16) with cuBLAS's bfloat16 reduced-precision reduction off in
    its forward and backward, and restores the flag afterwards."""
    stores = make_domain_pair(num_source=16, num_target=10, num_val=4,
                              num_class=6, feature_dim=96)
    cfg = ModelConfig(num_class=6, baseline_type="video",
                      frame_aggregation="trn-m", train_segments=5,
                      val_segments=5, feature_dim=96, fc_dim=64,
                      use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0,
                      compute_dtype="bfloat16")
    state = create_train_state(cfg, TrainConfig(lr=0.03),
                               torch.Generator().manual_seed(0), "cuda")
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy")
    step = make_train_step(state.model, da, TrainConfig(lr=0.03),
                           gather_on_device=True)
    seen = []
    flag = lambda *_: seen.append(
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    fc = state.model.fc_feature_domain_video
    fc.register_forward_hook(flag)
    fc.register_full_backward_hook(flag)
    dev = [s.to_device("cuda", "int8") for s in stores[:2]]
    bs = next(TSNLoader(stores[0], batch_size=8, num_segments=5).index_epoch())
    bt = next(TSNLoader(stores[1], batch_size=5, num_segments=5).index_epoch())
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    for t in (gather_gemm.variant_launches,):
        t["int8_bf16"] = 0
    trn_fused.bf16_train_launches = trn_fused.bf16_bwd_launches = 0
    state, metrics = step(state, dev[0], *bs, dev[1], *bt,
                          StepScalars((0.75, 0.75, 0.5), 0.0, 0.0, 0.003,
                                      0.03), None)
    torch.cuda.synchronize()
    assert seen == [False, False]
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert gather_gemm.variant_launches["int8_bf16"] == 2
    assert (trn_fused.bf16_train_launches, trn_fused.bf16_bwd_launches) == \
        (1, 1)
    assert metrics["loss"].dtype == torch.float32
    assert math.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("n,streams,k,d", [(30, 2, 2, 256), (21, 2, 1, 256),
                                           (45, None, 1, 37),
                                           (20, 2, 2, 22), (70, None, 1, 100)])
@pytest.mark.parametrize("variant", ["bf16_f32", "int8_f32", "f32_bf16",
                                     "bf16_bf16", "int8_bf16"])
def test_gather_gemm_variants_flow_and_ragged_d(variant, n, streams, k, d):
    """The narrow variants on Flow stores (two streams a frame row, one
    int8 scale for both) and at widths D that take the plain-load and
    4-byte copies (D = 37, 22) or a ragged K chunk (D = 100): z and x_res
    as in test_gather_gemm_variants_match_plain."""
    kind, compute = variant.split("_")
    store, idx, scale, w = _gather_inputs(n, d=d, streams=streams, k=k)
    store = _narrow_store(store, kind)
    if compute == "bf16":
        w = w.to(torch.bfloat16)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale)
    want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, w,
                                                   scale)
    torch.cuda.synchronize()
    if compute == "f32":
        assert (z - want).abs().max().item() <= _tol(want)
    else:
        assert _bf16_ok(z, want)
    assert torch.equal(x_res, want_x)


# ---- the chunked training modes ----

_CHUNK_DA = DAConfig(use_target="uSv", adv_DA="RevGrad",
                     add_loss_DA="attentive_entropy")


def _chunk_scalars(k):
    return StepScalars([(0.75, 0.75, 0.5)] * k, [0.0] * k, [0.0] * k,
                       [0.003] * k, [0.03 - 0.001 * j for j in range(k)])


def _chunk_stores():
    return make_domain_pair(num_source=24, num_target=13, num_val=4,
                            num_class=6, feature_dim=96)


def _assert_same_states(a, b):
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("k", [1, 3])
def test_multi_step_on_cuda_matches_single_steps(k):
    """K device-store steps in one call on the card == K single steps on
    the card, bitwise (dropout 0.5, one CUDA generator each from the same
    seed): 2 K3, 1 K1 (train) and 1 K2 launches a step either way."""
    from ta3n_tpu_torch.data.device_sampler import DeviceSampler
    stores = _chunk_stores()
    dev = [st.to_device("cuda") for st in stores[:2]]
    batches = []
    for store, b in zip(stores[:2], (8, 5)):
        sampler = DeviceSampler(TSNLoader(store, batch_size=b,
                                          num_segments=5, seed=1))
        batches.append([torch.stack(x).numpy() for x in zip(
            *(sampler.batch(i) for i in range(k)))])
    runs = []
    for multi in (False, True):
        state = _small_state("cuda", dropout_i=0.5, dropout_v=0.5)
        gen = torch.Generator("cuda").manual_seed(4)
        _reset_counts()
        if multi:
            step = make_multi_train_step(state.model, _CHUNK_DA,
                                         TrainConfig(lr=0.03))
            state, m = step(state, dev[0], *batches[0], dev[1], *batches[1],
                            _chunk_scalars(k), gen)
        else:
            step = make_train_step(state.model, _CHUNK_DA,
                                   TrainConfig(lr=0.03),
                                   gather_on_device=True)
            per = []
            for j, sc in enumerate(
                    StepScalars(*(f[i] for f in _chunk_scalars(k)))
                    for i in range(k)):
                state, mj = step(state, dev[0], *(a[j] for a in batches[0]),
                                 dev[1], *(a[j] for a in batches[1]), sc,
                                 gen)
                per.append(mj)
            m = {key: torch.stack([x[key] for x in per]) for key in per[0]}
        assert _counts() == (2 * k, 0, k, k)
        runs.append((state, m))
    for key in runs[0][1]:
        assert torch.equal(runs[0][1][key], runs[1][1][key]), key
    _assert_same_states(runs[0][0], runs[1][0])


def test_hash_sampler_cpu_and_card_bitwise():
    """Random sampling and shuffled orders (the counter hash) make the
    same indices on the card as on the CPU: whole epochs across an epoch
    boundary, at new_length 2, and the shard-local sampler's orders and
    batches."""
    from ta3n_tpu_torch.data.device_sampler import (DeviceSampler,
                                                    StreamingDeviceSampler)
    from ta3n_tpu_torch.data.streaming import ShardPlan
    store = _chunk_stores()[0]
    for new_length in (1, 2):
        def loader():
            return TSNLoader(store, batch_size=7, num_segments=5,
                             new_length=new_length, mode="random",
                             shuffle=True, seed=1)
        cpu, card = (DeviceSampler(loader(), seed=9).to(d)
                     for d in ("cpu", "cuda"))
        for step in range(2 * cpu.steps_per_epoch + 1):
            for a, b in zip(cpu.batch(step), card.batch(step)):
                assert b.is_cuda and torch.equal(a, b.cpu()), step
        plan = ShardPlan(store.offsets, 120)
        assert plan.num_shards >= 3
        cpu, card = (StreamingDeviceSampler(loader(), plan, seed=9).to(d)
                     for d in ("cpu", "cuda"))
        for sid in range(plan.num_shards):
            for epoch in (0, 3):
                oc, og = cpu.shard_order(sid, epoch), card.shard_order(sid,
                                                                       epoch)
                assert torch.equal(oc, og.cpu())
                for j in range(cpu.shard_steps(sid)):
                    for a, b in zip(cpu.shard_batch(sid, j, oc, 11),
                                    card.shard_batch(sid, j, og, 11)):
                        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("ks", [(1,), (2, 1)], ids=["k1", "short_last"])
def test_sampled_step_on_cuda_matches_stacked(ks):
    """Sampled calls of ``ks`` steps on the card (random mode, shuffled,
    K = 1, and a call of 2 then a shorter last one of 1 ending an epoch
    of 3) == the K-step call fed the same sampler's batches stacked on
    the host, bitwise, with the K-step path's launches; the indices never
    come back to the host."""
    from ta3n_tpu_torch.data.device_sampler import DeviceSampler
    stores = _chunk_stores()
    dev = [st.to_device("cuda") for st in stores[:2]]
    samplers = [DeviceSampler(TSNLoader(st, batch_size=b, num_segments=5,
                                        mode="random", seed=1),
                              seed=s).to("cuda")
                for st, b, s in zip(stores[:2], (8, 5), (101, 202))]
    spe = min(sp.steps_per_epoch for sp in samplers)
    assert spe == 3
    for sp in samplers:
        sp.steps_per_epoch = spe
    runs = []
    for sampled in (True, False):
        state = _small_state("cuda", dropout_i=0.5, dropout_v=0.5)
        gen = torch.Generator("cuda").manual_seed(4)
        sampled_step = make_sampled_multi_step(
            state.model, _CHUNK_DA, TrainConfig(lr=0.03), *samplers)
        multi = make_multi_train_step(state.model, _CHUNK_DA,
                                      TrainConfig(lr=0.03))
        metrics = []
        _reset_counts()
        for k in ks:
            if sampled:
                state, m = sampled_step(state, dev[0], dev[1],
                                        _chunk_scalars(k), gen)
            else:
                stacked = [[torch.stack(x).cpu().numpy() for x in zip(
                    *(sp.batch(state.step + j) for j in range(k)))]
                    for sp in samplers]
                state, m = multi(state, dev[0], *stacked[0], dev[1],
                                 *stacked[1], _chunk_scalars(k), gen)
            metrics.append(m)
        assert _counts() == (2 * sum(ks), 0, sum(ks), sum(ks))
        runs.append((state, metrics))
    for m1, m2 in zip(runs[0][1], runs[1][1]):
        for key in m1:
            assert torch.equal(m1[key], m2[key]), key
    _assert_same_states(runs[0][0], runs[1][0])


def test_shard_sampled_step_one_shard_plan_on_cuda():
    """A one-shard plan (the budget holds the store): the shard-sampled
    call on the card, K = 2 then a shorter last call of 1, equals the
    K-step call on the resident store fed the same (shard-local = global)
    indices, bitwise."""
    from ta3n_tpu_torch.data.device_sampler import StreamingDeviceSampler
    from ta3n_tpu_torch.data.streaming import ShardPlan, ShardStream
    stores = _chunk_stores()
    plans = [ShardPlan(st.offsets, int(st.offsets[-1])) for st in stores[:2]]
    assert all(p.num_shards == 1 for p in plans)
    samplers = [StreamingDeviceSampler(
        TSNLoader(st, batch_size=b, num_segments=5, seed=1), p,
        seed=7).to("cuda")
        for st, b, p in zip(stores[:2], (8, 5), plans)]
    streams = [ShardStream(st.features, p, "cuda")
               for st, p in zip(stores[:2], plans)]
    dev = [st.to_device("cuda") for st in stores[:2]]
    runs = []
    for sampled in (True, False):
        state = _small_state("cuda")
        gen = torch.Generator("cuda").manual_seed(4)
        shard_step = make_sampled_shard_multi_step(
            state.model, _CHUNK_DA, TrainConfig(lr=0.03), *samplers, 3)
        multi = make_multi_train_step(state.model, _CHUNK_DA,
                                      TrainConfig(lr=0.03))
        _reset_counts()
        j0 = 0
        for k in (2, 1):
            if sampled:
                state, m = shard_step(state, streams[0].get(0),
                                      streams[1].get(0), _chunk_scalars(k),
                                      gen, 0, j0, 0, j0)
            else:
                stacked = [[torch.stack(x).cpu().numpy() for x in zip(
                    *(sp.shard_batch(0, j0 + j, sp.shard_order(0, 0),
                                     state.step + j) for j in range(k)))]
                    for sp in samplers]
                state, m = multi(state, dev[0], *stacked[0], dev[1],
                                 *stacked[1], _chunk_scalars(k), gen)
            j0 += k
        assert _counts() == (6, 0, 3, 3)
        runs.append(state)
    _assert_same_states(*runs)


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8", "on_disk"])
def test_shard_stream_side_stream_upload_reads_back_exactly(dtype):
    """Every shard uploaded on the side stream reads back on the compute
    stream as exactly the host's padded shard; a K3 launch right after
    ``get`` gathers from it as from the resident store's rows."""
    from ta3n_tpu_torch.data.feature_store import host_rows
    from ta3n_tpu_torch.data.streaming import ShardPlan, ShardStream
    store = _chunk_stores()[0]
    if dtype == "on_disk":
        store, dtype = store.quantize(), None
    plan = ShardPlan(store.offsets, 150)
    assert plan.num_shards >= 3
    stream = ShardStream(store.features, plan, "cuda", dtype,
                         scales=store.scales)
    weight = torch.randn((64, 96), generator=torch.Generator().manual_seed(
        1)).cuda() / 10
    for sid in list(range(plan.num_shards)) + [0]:
        shard = stream.get(sid)
        rows = torch.arange(0, 40, dtype=torch.int32, device="cuda")
        z, _ = gather_gemm.gathered_gemm(
            shard, gather_gemm.RowIndex(rows, 40), weight, with_rows=False)
        scales = (None if store.scales is None
                  else plan.shard_array(store.scales, sid))
        want = host_rows(plan.shard_array(store.features, sid), dtype,
                         scales)
        got = shard if isinstance(shard, tuple) else (shard,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w), sid
        plain, _ = gather_gemm.gathered_gemm_plain(
            tuple(w.cuda() for w in want) if len(want) > 1
            else want[0].cuda(), rows, weight)
        torch.testing.assert_close(z, plain, rtol=1e-4, atol=1e-4)
    assert stream.uploads == plan.num_shards + 2


@pytest.mark.parametrize("kw", [
    dict(steps_per_call=2), dict(steps_per_call=2, device_sampler=True),
    dict(steps_per_call=2, device_sampler=True, store_budget_rows=150),
    dict(store_budget_rows=150)],
    ids=["k2", "sampler", "streamed_sampler", "streamed"])
def test_trainer_chunked_modes_on_cuda_match_cpu(kw, tmp_path):
    """One epoch of the Trainer in each chunked mode at small widths,
    dropout 0, on the card against the CPU: the val Prec@1 equal and the
    parameters within rtol 1e-3, atol 2e-5; on the card 2 K3, 1 K1
    (train) and 1 K2 launches a step."""
    from ta3n_tpu_torch.train.loop import Trainer
    stores = _chunk_stores()
    results = []
    for device in ("cpu", "cuda"):
        loaders = [TSNLoader(st, batch_size=b, num_segments=5, seed=i + 1,
                             shuffle=i < 2)
                   for i, (st, b) in enumerate(zip(stores, (8, 5, 4)))]
        trainer = Trainer(ModelConfig(**_SMALL), _CHUNK_DA,
                          TrainConfig(lr=0.03, epochs=1,
                                      batch_size=(8, 5, 4)),
                          *loaders, path_exp=str(tmp_path / device) + "/",
                          device_store=True, print_freq=1, device=device,
                          **kw)
        trainer.state.model.load_state_dict(
            _small_state("cpu").model.state_dict())
        _reset_counts()
        trainer.train_epoch(1)
        steps = trainer.state.step
        assert steps >= 3
        assert _counts() == ((2 * steps, 0, steps, steps)
                             if device == "cuda" else (0, 0, 0, 0))
        results.append((trainer.validate(1), {
            k: v.to("cpu", copy=True)
            for k, v in trainer.state.model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    for name, ref in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], ref, rtol=1e-3,
                                   atol=2e-5, msg=lambda m: f"{name}: {m}")


# ---- the member axis (ensembles): each member-batched kernel is one
# launch for N members and, member by member, bitwise N solo launches on
# the members' inputs; and within _tol of the plain version ----

def _member_trn_inputs(n, b, s, d, h):
    """N members' x, weights and biases, stacked [N, ...]."""
    sets = [_trn_inputs(b, s, d, h, seed=10 + k) for k in range(n)]
    x = torch.stack([t[0] for t in sets])
    w = [torch.stack([t[1][i] for t in sets]) for i in range(s - 1)]
    bi = [torch.stack([t[2][i] for t in sets]) for i in range(s - 1)]
    return x, w, bi


# (N, B, S, D, H): the smoke's N and batches at the flagship widths, S 17,
# ragged widths, one member, and an empty batch; 8 members at the train
# batch (the float32 kernels' clusters in several waves) and 25 frames
# at ragged widths
MEMBER_CASES = [(1, 64, 5, 512, 256), (3, 1, 5, 512, 256),
                (4, 202, 5, 512, 256), (8, 64, 5, 512, 256),
                (3, 13, 17, 37, 19), (3, 0, 5, 32, 16),
                (8, 202, 5, 512, 256), (2, 70, 25, 22, 50)]


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("n,b,s,d,h", MEMBER_CASES)
def test_member_fwd_kernels_bitwise_solo(n, b, s, d, h, train):
    x, w, bi = _member_trn_inputs(n, b, s, d, h)
    with torch.no_grad():
        if train:
            _reset_counts()
            got, masks = trn_fused.trn_multiscale_fwd_masks_members(
                x, w, bi, s)
            assert trn_fused.train_launches == (1 if b else 0)
            solo = [trn_fused.trn_multiscale_fwd_masks(
                x[k], [t[k] for t in w], [t[k] for t in bi], s)
                for k in range(n)]
            assert torch.equal(masks, torch.stack([m for _, m in solo]))
            solo = [o for o, _ in solo]
        else:
            _reset_counts()
            got = trn_fused.trn_multiscale_infer_members(x, w, bi, s)
            assert trn_fused.launches == (1 if b else 0)
            solo = [trn_fused.trn_multiscale_infer(
                x[k], [t[k] for t in w], [t[k] for t in bi], s)
                for k in range(n)]
        plain = torch.stack([trn_fused.trn_multiscale_plain(
            x[k], [t[k] for t in w], [t[k] for t in bi], s)
            for k in range(n)])
    torch.cuda.synchronize()
    assert got.shape == (n, b, s - 1, h)
    assert torch.equal(got, torch.stack(solo))
    if b:
        assert (got - plain).abs().max().item() <= _tol(plain)


@pytest.mark.parametrize("n,b,s,d,h", MEMBER_CASES)
def test_member_bwd_kernel_bitwise_solo(n, b, s, d, h):
    x, w, bi = _member_trn_inputs(n, b, s, d, h)
    g = torch.randn((n, b, s - 1, h), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks_members(x, w, bi, s)
        _reset_counts()
        dx, dws, dbs = trn_fused.trn_multiscale_bwd_members(x, w, masks, g,
                                                            s)
        assert trn_fused.bwd_launches == 1
        for k in range(n):
            sx, sw, sb = trn_fused.trn_multiscale_bwd(
                x[k], [t[k] for t in w], masks[k], g[k], s)
            px, pw, pb = trn_fused.trn_multiscale_bwd_plain(
                x[k], [t[k] for t in w], masks[k], g[k], s)
            assert torch.equal(dx[k], sx)
            for got, want, plain in [*zip([t[k] for t in dws], sw, pw),
                                     *zip([t[k] for t in dbs], sb, pb)]:
                assert torch.equal(got, want)
                assert (got - plain).abs().max().item() <= _tol(plain)
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("n,rows,with_rows", [
    (1, 640, True), (3, 640, True), (4, 370, True), (8, 320, False),
    (3, 37, True), (3, 0, True)])
def test_member_gather_kernel_bitwise_solo(n, rows, with_rows, per_member):
    """K3 over N members: weights [N, H, K], one index set for all or one
    each, z bitwise the solo launches' (K sliced by one member's shape)
    and x_res written once for shared indices."""
    store, _, _, _ = _gather_inputs(8, d=2048, h=512)
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.uniform(-1, 1, (n, 512, 2048)) / 45.0)
                         .astype(np.float32)).cuda()
    m = n if per_member else 1
    idx = rng.integers(0, store.shape[0], (m, rows))
    scale = torch.from_numpy(rng.choice([1.0, 0.0, 0.5], (m, rows))
                             .astype(np.float32)).cuda()
    checked = gather_gemm.row_index(idx, store.shape[0], "cuda")
    if per_member:
        member_idx = gather_gemm.RowIndex(checked.rows.reshape(n, rows),
                                          checked.end)
        member_scale = scale
    else:
        member_idx = checked
        member_scale = scale[0]
    _reset_counts()
    z, x_res = gather_gemm.gathered_gemm_members(store, member_idx, w,
                                                 member_scale, with_rows)
    assert gather_gemm.launches == (1 if rows else 0)
    for k in range(n):
        j = k if per_member else 0
        rows_k = gather_gemm.row_index(idx[j], store.shape[0], "cuda")
        sz, sx = gather_gemm.gathered_gemm(store, rows_k, w[k], scale[j],
                                           with_rows)
        pz, px = gather_gemm.gathered_gemm_plain(store, rows_k.rows.long(),
                                                 w[k], scale[j])
        assert torch.equal(z[k], sz)
        if rows:
            assert (z[k] - pz).abs().max().item() <= _tol(pz)
        if with_rows:
            got_x = x_res[k] if per_member else x_res
            assert torch.equal(got_x, sx) and torch.equal(got_x, px)
    if not with_rows:
        assert x_res is None


def _ensemble_setup(n=3):
    from ta3n_tpu_torch.train.ensemble import (create_ensemble_state,
                                               ensemble_generators)
    cfg = ModelConfig(num_class=5, baseline_type="video",
                      frame_aggregation="trn-m", train_segments=5,
                      val_segments=5, feature_dim=64, fc_dim=32,
                      use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
    da = DAConfig(use_target="uSv", adv_DA="RevGrad",
                  add_loss_DA="attentive_entropy")
    tc = TrainConfig(lr=0.03, batch_size=(16, 12, 16))
    stores = make_domain_pair(num_source=40, num_target=30, num_val=16,
                              num_class=5, feature_dim=64, seed=2)
    return cfg, da, tc, stores, list(range(n)), create_ensemble_state, \
        ensemble_generators


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
def test_ensemble_store_step_on_cuda_matches_cpu(per_member):
    """Two device-store ensemble steps of 3 members on the card against
    the CPU ensemble (each member within the train steps' tolerance), from
    one index stream or one each, with K3 2x, K1 (train) 1x and K2 1x a
    step and no vmap fallback."""
    import warnings

    from ta3n_tpu_torch.train.ensemble import (make_ensemble_step,
                                               stack_scalars)
    cfg, da, tc, stores, seeds, create, gens = _ensemble_setup()
    ls = TSNLoader(stores[0], batch_size=16, num_segments=5, seed=1)
    lt = TSNLoader(stores[1], batch_size=12, num_segments=5, seed=2)
    pairs = list(zip(ls.index_epoch(), lt.index_epoch()))
    sc = stack_scalars([StepScalars((0.5, 0.5, 0.5), 0.0, 1.0, 0.01,
                                    0.03 * (k + 1)) for k in seeds])

    def args(i):
        """Step i's index batches: the stream's, or member k's i + k."""
        if not per_member:
            bs, bt = pairs[i]
            return (bs.abs_indices, bs.labels, bs.mask, bt.abs_indices,
                    bt.labels, bt.mask)
        per = [pairs[(i + k) % len(pairs)] for k in range(len(seeds))]
        return tuple(np.stack([getattr(p[j], f) for p in per])
                     for j in (0, 1) for f in ("abs_indices", "labels",
                                               "mask"))

    results = {}
    for dev in ("cpu", "cuda"):
        state = create(cfg, tc, seeds, dev)
        step = make_ensemble_step(state.model, da, tc, gather_on_device=True,
                                  per_member_data=per_member)
        s_dev = [st.to_device(dev) for st in stores[:2]]
        g = gens(seeds, dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(2):
                _reset_counts()
                a = args(i)
                state, m = step(state, s_dev[0], *a[:3], s_dev[1], *a[3:],
                                sc, g)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert _counts() == (2, 0, 1, 1)
        assert not [w for w in caught if "performance drop" in
                    str(w.message)]
        results[dev] = (state, m)
    (cpu, m_cpu), (card, m_card) = results["cpu"], results["cuda"]
    np.testing.assert_allclose(m_card["loss"].cpu().numpy(),
                               m_cpu["loss"].numpy(), rtol=2e-4)
    for name, t in cpu.params.items():
        np.testing.assert_allclose(card.params[name].cpu().numpy(),
                                   t.numpy(), rtol=1e-3, atol=2e-5,
                                   err_msg=name)


def test_ensemble_eval_and_predictor_on_cuda_match_cpu():
    """The ensemble eval step from a store (K3 1x, K1 (infer) 1x for all
    members) and the deep-ensemble Predictor on the card against the
    CPU."""
    from ta3n_tpu_torch.serve import Predictor
    from ta3n_tpu_torch.train.ensemble import (extract_member,
                                               make_ensemble_eval_step)
    cfg, _, tc, stores, seeds, create, _ = _ensemble_setup()
    lv = TSNLoader(stores[2], batch_size=16, num_segments=5, mode="test",
                   shuffle=False)
    b = next(iter(lv.index_epoch()))
    x = np.random.default_rng(4).normal(size=(7, 5, 64)).astype(np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        state = create(cfg, tc, seeds, dev)
        ev = make_ensemble_eval_step(state.model, gather_on_device=True)
        _reset_counts()
        m = ev(state, stores[2].to_device(dev), b.abs_indices, b.labels,
               b.mask)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _counts() == (1, 1, 0, 0)
        members = [extract_member(state, k, tc).model for k in seeds]
        pred = Predictor(cfg, members, batch_size=4, top_k=3, device=dev,
                         n_members=len(seeds))
        _reset_counts()
        probs = pred(x)[0]
        if dev == "cuda":
            assert trn_fused.launches == 2  # two chunks of 4
        got[dev] = (m["logits"].cpu().numpy(), probs)
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["cuda"][1], got["cpu"][1], atol=1e-5)


@pytest.mark.parametrize("aggregation", ["rnn", "temconv"])
def test_from_sweep_rnn_and_temconv_are_f32_at_cudnn_tf32_default(
        aggregation, tmp_path):
    """A deep ensemble of 3 RNN (two-layer bidirectional LSTM) or temconv
    members at the flagship widths (2048-d features, fc 512), served by
    ``from_sweep`` on the card with ``torch.backends.cudnn.allow_tf32``
    at its default (True): its probabilities are the mean of the members'
    solo Predictors within 1e-6.  The solo Predictors pin cuDNN to
    float32 (``cudnn_f32``), and so does the vmapped pass (temconv's
    convolution; the RNN, which has no batching rule in torch, runs as
    the plain recurrence under vmap).  At these shapes the TCL's
    convolution shows no TF32 difference on the H100, so the pin itself
    is held by ``test_cudnn_f32_pins_tf32_off_under_a_transform`` on the
    CPU.  Parameters are redrawn at a trained-like scale (kernels
    U(+-1/sqrt(fan_in)), vectors U(+-0.25))."""
    from ta3n_tpu_torch.io_utils.checkpoint import save_checkpoint
    from ta3n_tpu_torch.io_utils.convert import export_reference_state
    from ta3n_tpu_torch.serve import Predictor

    assert torch.backends.cudnn.allow_tf32
    fields = (dict(frame_aggregation="rnn", rnn_cell="LSTM", n_rnn=2,
                   n_directions=2, n_ts=3) if aggregation == "rnn" else
              dict(frame_aggregation="temconv"))
    cfg = ModelConfig(num_class=12, baseline_type="video", train_segments=5,
                      val_segments=5, feature_dim=2048, fc_dim=512,
                      use_attn="none", dropout_i=0.0, dropout_v=0.0,
                      **fields)
    sweep = tmp_path / "sweep"
    paths = []
    for k in range(3):
        gen = torch.Generator().manual_seed(k)
        model = VideoModel(cfg, gen, "cpu")
        with torch.no_grad():
            for p in model.parameters():
                bound = (1.0 / math.sqrt(p[0].numel()) if p.dim() >= 2
                         else 0.25)
                p.uniform_(-bound, bound, generator=gen)
        paths.append(save_checkpoint(str(sweep / f"member_{k:02d}"), {
            "epoch": 1, "arch": "TBN",
            "state_dict": {f"module.{name}": v for name, v in
                           export_reference_state(model).items()}}))
    x = np.random.default_rng(7).normal(size=(8, 5, 2048)).astype(
        np.float32)
    ens = Predictor.from_sweep(str(sweep), cfg, device="cuda", batch_size=8,
                               top_k=3)
    probs = ens(x)[0]
    solo = np.mean([Predictor.from_checkpoint(p, cfg, device="cuda",
                                              batch_size=8, top_k=3)(x)[0]
                    for p in paths], axis=0)
    err = float(np.abs(probs - solo).max())
    print(f"{aggregation}: from_sweep against the solo mean {err:.1e} "
          f"(largest probability {float(solo.max()):.3f})")
    assert torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(probs, solo, rtol=0, atol=1e-6)


# ---- the bfloat16 kernels' member axis: each member-batched bfloat16
# kernel is one launch for N members and, member by member, bitwise N solo
# bfloat16 launches; and within _bf16_ok of the plain version ----

def _reset_bf16_counts():
    trn_fused.bf16_launches = trn_fused.bf16_train_launches = 0
    trn_fused.bf16_bwd_launches = 0
    for variant in gather_gemm.variant_launches:
        gather_gemm.variant_launches[variant] = 0


def _bf16_member_inputs(n, b, s, d, h):
    bf = torch.bfloat16
    x, w, bi = _member_trn_inputs(n, b, s, d, h)
    return x.to(bf), [t.to(bf) for t in w], [t.to(bf) for t in bi]


# (N, B, S, D, H): N = 1, 3, 4, 8 at the serve, train and single-video
# batches of the flagship widths, S = 17, a ragged batch, an empty one
BF16_MEMBER_CASES = [(1, 64, 5, 512, 256), (3, 1, 5, 512, 256),
                     (4, 202, 5, 512, 256), (8, 64, 5, 512, 256),
                     (8, 202, 5, 512, 256), (3, 202, 17, 512, 256),
                     (3, 13, 5, 512, 256), (3, 0, 5, 512, 256)]


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("n,b,s,d,h", BF16_MEMBER_CASES)
def test_bf16_member_fwd_kernels_bitwise_solo(n, b, s, d, h, train):
    """K1 (infer, train) in bfloat16 over N members: one launch of the
    bfloat16 variant, out (and masks) bitwise the N solo launches, within
    _bf16_ok of the plain version."""
    x, w, bi = _bf16_member_inputs(n, b, s, d, h)
    with torch.no_grad():
        _reset_bf16_counts()
        if train:
            got, masks = trn_fused.trn_multiscale_fwd_masks_members(
                x, w, bi, s)
            assert trn_fused.bf16_train_launches == (1 if b else 0)
        else:
            got = trn_fused.trn_multiscale_infer_members(x, w, bi, s)
            assert trn_fused.bf16_launches == (1 if b else 0)
        for k in range(n):
            args = (x[k], [t[k] for t in w], [t[k] for t in bi], s)
            if train:
                so, sm = trn_fused.trn_multiscale_fwd_masks(*args)
                assert torch.equal(masks[k], sm)
            else:
                so = trn_fused.trn_multiscale_infer(*args)
            assert torch.equal(got[k], so)
            assert _bf16_ok(got[k], trn_fused.trn_multiscale_plain(*args))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (n, b, s - 1, h)


@pytest.mark.parametrize("n,b,s,d,h", BF16_MEMBER_CASES)
def test_bf16_member_bwd_kernel_bitwise_solo(n, b, s, d, h):
    """K2 in bfloat16 over N members on the grid bf16_bwd_grid chooses for
    one member: one launch, dx, every dW and db bitwise the N solo
    launches, within _bf16_ok of the plain version."""
    x, w, bi = _bf16_member_inputs(n, b, s, d, h)
    g = torch.randn((n, b, s - 1, h), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5)).to(
        torch.bfloat16)
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks_members(x, w, bi, s)
        _reset_bf16_counts()
        dx, dws, dbs = trn_fused.trn_multiscale_bwd_members(x, w, masks, g,
                                                            s)
        assert trn_fused.bf16_bwd_launches == 1
        for k in range(n):
            args = (x[k], [t[k] for t in w], masks[k], g[k], s)
            sx, sw, sb = trn_fused.trn_multiscale_bwd(*args)
            px, pw, pb = trn_fused.trn_multiscale_bwd_plain(*args)
            assert torch.equal(dx[k], sx) and _bf16_ok(dx[k], px)
            for got, want, plain in [*zip([t[k] for t in dws], sw, pw),
                                     *zip([t[k] for t in dbs], sb, pb)]:
                assert torch.equal(got, want) and _bf16_ok(got, plain)
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,rows", [(1, 640), (3, 640), (8, 370), (3, 37),
                                    (3, 0), (8, 640)])
def test_bf16_member_gather_kernel_bitwise_solo(n, rows, kind, per_member):
    """K3 at bfloat16 compute over N members from a float32, bfloat16 or
    int8 store, one index set for all or one each: one launch of the
    variant, z bitwise the N solo launches (K sliced by one member's
    shape), x_res bitwise the solo launches' and written once for shared
    indices, z within _bf16_ok of the plain version."""
    store, _, _, _ = _gather_inputs(8, d=2048, h=512)
    store = _narrow_store(store, kind)
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.uniform(-1, 1, (n, 512, 2048)) / 45.0)
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    m = n if per_member else 1
    r = (store[0] if kind == "int8" else store).shape[0]
    idx = rng.integers(0, r, (m, rows))
    scale = torch.from_numpy(rng.choice([1.0, 0.0, 0.5], (m, rows))
                             .astype(np.float32)).cuda()
    checked = gather_gemm.row_index(idx, r, "cuda")
    member_idx = (gather_gemm.RowIndex(checked.rows.reshape(n, rows),
                                       checked.end) if per_member
                  else checked)
    _reset_bf16_counts()
    z, x_res = gather_gemm.gathered_gemm_members(
        store, member_idx, w, scale if per_member else scale[0])
    assert gather_gemm.variant_launches[f"{kind}_bf16"] == (1 if rows
                                                            else 0)
    assert x_res.shape == ((n,) if per_member else ()) + (rows, 2048)
    for k in range(n):
        j = k if per_member else 0
        rows_k = gather_gemm.row_index(idx[j], r, "cuda")
        sz, sx = gather_gemm.gathered_gemm(store, rows_k, w[k], scale[j])
        pz, _ = gather_gemm.gathered_gemm_plain(store, rows_k.rows.long(),
                                                w[k], scale[j])
        assert torch.equal(z[k], sz) and _bf16_ok(z[k], pz)
        assert torch.equal(x_res[k] if per_member else x_res, sx)
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_bf16_member_gather_kernel_ragged_bitwise_solo(kind, per_member):
    """K3 at bfloat16 compute over 3 members at ragged widths, D = 37 and
    H = 19: rows TMA cannot take (stage A writes x_res as it is and A's
    rows padded to 40 values; W copied to rows of 40 first), column tiles
    padded within each member: one launch of the variant, z bitwise the
    solo launches and within _bf16_ok of the plain version, x_res bitwise
    the plain version's."""
    n, rows, d, h = 3, 45, 37, 19
    store, _, _, _ = _gather_inputs(8, d=d, h=h)
    store = _narrow_store(store, kind)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.uniform(-1, 1, (n, h, d)).astype(np.float32)
                         / 6.0).cuda().to(torch.bfloat16)
    m = n if per_member else 1
    r = (store[0] if kind == "int8" else store).shape[0]
    idx = rng.integers(0, r, (m, rows))
    scale = torch.from_numpy(rng.choice([1.0, 0.0, 0.5], (m, rows))
                             .astype(np.float32)).cuda()
    checked = gather_gemm.row_index(idx, r, "cuda")
    member_idx = (gather_gemm.RowIndex(checked.rows.reshape(n, rows),
                                       checked.end) if per_member
                  else checked)
    _reset_bf16_counts()
    z, x_res = gather_gemm.gathered_gemm_members(
        store, member_idx, w, scale if per_member else scale[0])
    assert gather_gemm.variant_launches[f"{kind}_bf16"] == 1
    for k in range(n):
        j = k if per_member else 0
        rows_k = gather_gemm.row_index(idx[j], r, "cuda")
        sz, sx = gather_gemm.gathered_gemm(store, rows_k, w[k], scale[j])
        pz, px = gather_gemm.gathered_gemm_plain(store, rows_k.rows, w[k],
                                                 scale[j])
        assert torch.equal(z[k], sz) and _bf16_ok(z[k], pz)
        got_x = x_res[k] if per_member else x_res
        assert torch.equal(got_x, sx) and torch.equal(got_x, px)
    torch.cuda.synchronize()


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_bf16_gather_every_split_count(splits, monkeypatch):
    """K3 at bfloat16 compute with its K slices forced to each cluster
    size the kernel takes, at the train shape over 2 members: z within
    _bf16_ok of the plain version, bitwise the solo launches at the same
    slices and, on dyadic grids (every product and float32 sum exact),
    bitwise the plain version; x_res bitwise."""
    chosen = gather_gemm.bf16_plan
    monkeypatch.setattr(gather_gemm, "bf16_plan", lambda *a, **kw: chosen(
        *a, **kw)._replace(splits=splits))
    for grid in (False, True):
        store, idx, scale, w = _gather_inputs(640, d=2048, h=512,
                                              grid=grid)
        w = torch.stack([w, w.flip(0)]).to(torch.bfloat16)
        rows = gather_gemm.row_index(idx, 500, "cuda")
        z, x_res = gather_gemm.gathered_gemm_members(store, rows, w, scale)
        for k in range(2):
            sz, sx = gather_gemm.gathered_gemm(store, rows, w[k], scale)
            pz, px = gather_gemm.gathered_gemm_plain(store, rows.rows, w[k],
                                                     scale)
            assert torch.equal(z[k], sz) and torch.equal(x_res, px)
            assert torch.equal(z[k], pz) if grid else _bf16_ok(z[k], pz)
    torch.cuda.synchronize()


def test_bf16_member_kernels_unaligned_member_stride():
    """D = 37 (and K3's D = 22): rows, and so every member's stride, that
    are not multiples of 16 bytes, which TMA cannot take: the kernels
    stage the members' tiles by plain loads, and every member is still
    bitwise its solo launch, one launch a call."""
    n, b, s, d, h = 3, 13, 5, 37, 19
    x, w, bi = _bf16_member_inputs(n, b, s, d, h)
    g = torch.randn((n, b, s - 1, h), device="cuda").to(torch.bfloat16)
    _reset_bf16_counts()
    with torch.no_grad():
        out = trn_fused.trn_multiscale_infer_members(x, w, bi, s)
        tout, masks = trn_fused.trn_multiscale_fwd_masks_members(x, w, bi, s)
        dx, dws, dbs = trn_fused.trn_multiscale_bwd_members(x, w, masks, g,
                                                            s)
        for k in range(n):
            args = (x[k], [t[k] for t in w], [t[k] for t in bi], s)
            assert torch.equal(out[k], trn_fused.trn_multiscale_infer(*args))
            so, sm = trn_fused.trn_multiscale_fwd_masks(*args)
            assert torch.equal(tout[k], so) and torch.equal(masks[k], sm)
            sx, sw, sb = trn_fused.trn_multiscale_bwd(
                x[k], [t[k] for t in w], masks[k], g[k], s)
            assert torch.equal(dx[k], sx)
            assert all(torch.equal(a[k], c) for a, c in zip(dws, sw))
            assert all(torch.equal(a[k], c) for a, c in zip(dbs, sb))
    store, idx, scale, _ = _gather_inputs(40, d=22, h=33)
    store = store.to(torch.bfloat16)
    wg = torch.randn((n, 33, 22), device="cuda").to(torch.bfloat16)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    z, x_res = gather_gemm.gathered_gemm_members(store, rows, wg, scale)
    for k in range(n):
        sz, sx = gather_gemm.gathered_gemm(store, rows, wg[k], scale)
        assert torch.equal(z[k], sz) and torch.equal(x_res, sx)
    torch.cuda.synchronize()
    assert (trn_fused.bf16_launches, trn_fused.bf16_train_launches,
            trn_fused.bf16_bwd_launches) == (1 + n, 1 + n, 1 + n)
    assert gather_gemm.variant_launches["bf16_bf16"] == 1 + n


def _bf16_ensemble_setup(n=3):
    import dataclasses
    cfg, da, tc, stores, seeds, create, gens = _ensemble_setup(n)
    return (dataclasses.replace(cfg, compute_dtype="bfloat16"), da, tc,
            stores, seeds, create, gens)


# bfloat16 steps against each other (a member and its solo step on the
# card, the card and the CPU): the losses (bfloat16 values, an ulp 2**-8
# of them) within BF16_LOSS_RTOL, and each tensor's update within
# BF16_UPDATE_RTOL of its largest (chip_smoke.py's rule for the bfloat16
# steps: the two sides round the same bfloat16 values an ulp apart here
# and there, summing in other orders)
BF16_LOSS_RTOL, BF16_UPDATE_RTOL = 2e-2, 5e-2


def _bf16_members(cfg, tc, seeds, dev):
    """An ensemble of the members seeded ``seeds`` with every Linear
    redrawn at torch's default scale (as chip_smoke.py's flagship_model
    draws them): away from the reference init's near-zero activations,
    where an ulp between the two sides flips relu masks at ties and moves
    whole rows of the gradient."""
    from ta3n_tpu_torch.train.ensemble import stack_members
    models = []
    for k in seeds:
        gen = torch.Generator().manual_seed(k)
        model = VideoModel(cfg, gen, "cpu")
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                torch_default_uniform_(mod, gen)
        models.append(model.to(dev))
    return stack_members(models, tc)


def _update_within(got, want, before):
    """Whether the update ``got - before`` is within BF16_UPDATE_RTOL of
    the largest of ``want - before``, elementwise."""
    got, want = (got - before).float(), (want - before).float()
    return bool(((got - want).abs() <= BF16_UPDATE_RTOL
                 * want.abs().max().item() + 1e-9).all())


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
def test_bf16_ensemble_store_step_on_cuda_matches_cpu(per_member):
    """Two bfloat16 device-store ensemble steps of 3 members (redrawn at
    torch's default scale, _bf16_members) from an int8 store on the card:
    the first step of each member against its solo bfloat16 step on the
    card and against the CPU ensemble's first step, all from the same
    start, each within BF16_LOSS_RTOL and BF16_UPDATE_RTOL (a second step
    would start from parameters an ulp apart); the second step's losses
    against the CPU's within BF16_LOSS_RTOL; from one index stream or one
    each; each step one launch of K1 (train) and K2 in bfloat16 and two of
    K3 int8 x bf16, none of the float32 kernels, and no vmap fallback."""
    import warnings

    from ta3n_tpu_torch.train.ensemble import (extract_member,
                                               make_ensemble_step,
                                               stack_scalars)
    cfg, da, tc, stores, seeds, _, gens = _bf16_ensemble_setup()
    ls = TSNLoader(stores[0], batch_size=16, num_segments=5, seed=1)
    lt = TSNLoader(stores[1], batch_size=12, num_segments=5, seed=2)
    pairs = list(zip(ls.index_epoch(), lt.index_epoch()))
    scalars = [StepScalars((0.3, 0.3, 0.3), 0.0, 1.0, 0.003, 0.03 * (k + 1))
               for k in seeds]
    sc = stack_scalars(scalars)

    def args(i, k=None):
        """Step i's index batches: the stream's, or member k's i + k (all
        members' stacked when k is None)."""
        if not per_member:
            per = [pairs[i]]
        elif k is not None:
            per = [pairs[(i + k) % len(pairs)]]
        else:
            per = [pairs[(i + m) % len(pairs)] for m in range(len(seeds))]
        out = tuple(np.stack([getattr(p[j], f) for p in per])
                    for j in (0, 1) for f in ("abs_indices", "labels",
                                              "mask"))
        return out if per_member and k is None else tuple(a[0] for a in out)

    results = {}
    start = {k: v.clone() for k, v in
             _bf16_members(cfg, tc, seeds, "cpu").params.items()}
    for dev in ("cpu", "cuda"):
        state = _bf16_members(cfg, tc, seeds, dev)
        step = make_ensemble_step(state.model, da, tc, gather_on_device=True,
                                  per_member_data=per_member)
        s_dev = [st.to_device(dev, "int8") for st in stores[:2]]
        g = gens(seeds, dev)
        solos = ([extract_member(state, k, tc) for k in seeds]
                 if dev == "cuda" else [])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(2):
                _reset_counts()
                _reset_bf16_counts()
                a = args(i)
                state, m = step(state, s_dev[0], *a[:3], s_dev[1], *a[3:],
                                sc, g)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert _counts() == (0, 0, 0, 0)
                    assert (trn_fused.bf16_train_launches,
                            trn_fused.bf16_bwd_launches,
                            gather_gemm.variant_launches["int8_bf16"]) == \
                        (1, 1, 2)
                if i == 0:
                    first = {n: t.detach().cpu().clone()
                             for n, t in state.params.items()}
                    first_loss = m["loss"].cpu()
                if dev == "cuda" and i == 0:
                    for k, solo in enumerate(solos):
                        before = {n: p.detach().clone() for n, p in
                                  solo.model.named_parameters()}
                        a_k = args(0, k)
                        solo, want = make_train_step(
                            solo.model, da, tc, gather_on_device=True)(
                            solo, s_dev[0], *a_k[:3], s_dev[1], *a_k[3:],
                            scalars[k], None)
                        assert abs(float(m["loss"][k]) - float(
                            want["loss"])) <= BF16_LOSS_RTOL * abs(
                            float(want["loss"]))
                        for n, p in solo.model.named_parameters():
                            assert _update_within(state.params[n][k], p,
                                                  before[n]), n
        assert not [w for w in caught if "performance drop" in
                    str(w.message)]
        assert {t.dtype for t in state.params.values()} == {torch.float32}
        results[dev] = (first, first_loss, m["loss"].cpu())
    (cpu, cpu_first, cpu_last), (card, card_first, card_last) = \
        results["cpu"], results["cuda"]
    for got, want in ((card_first, cpu_first), (card_last, cpu_last)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=BF16_LOSS_RTOL)
    for name, t in cpu.items():
        assert _update_within(card[name], t, start[name]), name


def test_bf16_ensemble_eval_and_from_sweep_on_cuda_match_cpu(tmp_path):
    """At bfloat16 compute: the ensemble eval step from an int8 store (K3
    int8 x bf16 once, K1 (infer) in bfloat16 once for all members) and
    from_sweep of the members' checkpoints (K1 (infer) in bfloat16 once a
    chunk) on the card against the CPU: logits within 2**-6 of the
    largest (bfloat16 values an ulp or two apart) and probabilities
    within 2**-6."""
    from ta3n_tpu_torch.io_utils.checkpoint import save_checkpoint
    from ta3n_tpu_torch.io_utils.convert import export_reference_state
    from ta3n_tpu_torch.serve import Predictor
    from ta3n_tpu_torch.train.ensemble import (extract_member,
                                               make_ensemble_eval_step)
    cfg, _, tc, stores, seeds, create, _ = _bf16_ensemble_setup()
    lv = TSNLoader(stores[2], batch_size=16, num_segments=5, mode="test",
                   shuffle=False)
    b = next(iter(lv.index_epoch()))
    x = np.random.default_rng(4).normal(size=(7, 5, 64)).astype(np.float32)
    state = create(cfg, tc, seeds, "cpu")
    sweep = tmp_path / "sweep"
    for k in seeds:
        save_checkpoint(str(sweep / f"member_{k:02d}"), {
            "epoch": 1, "arch": "TBN", "state_dict": {
                f"module.{name}": v for name, v in export_reference_state(
                    extract_member(state, k, tc).model).items()}})
    got = {}
    for dev in ("cpu", "cuda"):
        st = create(cfg, tc, seeds, dev)
        ev = make_ensemble_eval_step(st.model, gather_on_device=True)
        _reset_counts()
        _reset_bf16_counts()
        m = ev(st, stores[2].to_device(dev, "int8"), b.abs_indices,
               b.labels, b.mask)
        pred = Predictor.from_sweep(str(sweep), cfg, device=dev,
                                    batch_size=4, top_k=3)
        probs = pred(x)[0]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _counts() == (0, 0, 0, 0)
            # the eval step's one launch, then two chunks of 4
            assert trn_fused.bf16_launches == 3
            assert gather_gemm.variant_launches["int8_bf16"] == 1
        got[dev] = (m["logits"].float().cpu().numpy(), probs)
    logits_cpu = got["cpu"][0]
    assert np.abs(got["cuda"][0] - logits_cpu).max() <= \
        2.0 ** -6 * np.abs(logits_cpu).max()
    np.testing.assert_allclose(got["cuda"][1], got["cpu"][1], atol=2.0 ** -6)


# ---- int8 inference, AOT artifacts, the pipelined fetch, the extractor ----

def _int8_cfg(**over):
    """The flagship's branches at widths that reach the int8 gate."""
    return ModelConfig(**{**dict(
        num_class=6, baseline_type="video", frame_aggregation="trn-m",
        train_segments=5, val_segments=5, feature_dim=256, fc_dim=256,
        use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0,
        quantize="int8"), **over})


def _scaled_model(cfg, seed, device):
    """Seeded weights, every matrix x20 (separated logits)."""
    model = VideoModel(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.mul_(20.0)
    return model.to(device).eval()


@pytest.mark.parametrize("batch", [1, 64])
def test_int8_predictor_on_cuda_matches_cpu(batch):
    """The int8 Predictor at batch 1 (torch._int_mm's rows padded past 16)
    and 64 on the card against the CPU's: probabilities within 1e-4, the
    same top class, 11 int8 products a forward at 5 segments and no K1."""
    from ta3n_tpu_torch.models import layers
    from ta3n_tpu_torch.serve import Predictor
    cfg = _int8_cfg()
    x = np.random.default_rng(0).normal(size=(70, 5, 256)).astype(
        np.float32)[:batch + 3]
    cpu = Predictor(cfg, _scaled_model(cfg, 0, "cpu"), batch_size=batch,
                    device="cpu")(x)
    trn_fused.launches = layers.int8_gemms = 0
    got = Predictor(cfg, _scaled_model(cfg, 0, "cuda"), batch_size=batch,
                    device="cuda")(x)
    chunks = -(-x.shape[0] // batch)
    assert layers.int8_gemms == 11 * chunks and trn_fused.launches == 0
    np.testing.assert_allclose(got[0], cpu[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2][:, 0], cpu[2][:, 0])


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_exported_artifact_on_cuda(tmp_path, quantize):
    """An artifact traced on the CPU and loaded onto the card answers as
    the live Predictor on the card (within 1e-5), running no hand-written
    kernel."""
    from ta3n_tpu_torch.serve import Predictor
    cfg = _int8_cfg(quantize=quantize)
    live = Predictor(cfg, _scaled_model(cfg, 1, "cuda"), batch_size=8)
    served = Predictor.from_exported(live.export(str(tmp_path)))
    x = np.random.default_rng(1).normal(size=(13, 5, 256)).astype(
        np.float32)
    trn_fused.launches = 0
    got = served(x)
    assert trn_fused.launches == 0
    want = live(x)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2][:, 0], want[2][:, 0])


def test_pipelined_predictor_on_cuda_is_one_by_one():
    """Ten chunks through the pinned double buffers, bitwise the chunks
    fetched one call each, also for a ragged last chunk."""
    from ta3n_tpu_torch.serve import Predictor
    cfg = _int8_cfg(quantize="none")
    pred = Predictor(cfg, _scaled_model(cfg, 2, "cuda"), batch_size=16)
    x = np.random.default_rng(2).normal(size=(155, 5, 256)).astype(
        np.float32)
    got = pred(x)
    one = [pred(x[lo:lo + 16]) for lo in range(0, 155, 16)]
    for a, b in zip(got, zip(*one)):
        np.testing.assert_array_equal(a, np.concatenate(b))


@pytest.mark.parametrize("base_model", ["resnet18", "c3d"])
def test_extractor_on_cuda_matches_cpu(tmp_path, base_model):
    """make_extractor on the card (cuDNN with TF32 off) against the same
    extractor on the CPU: resnet18 on 224x224 frames, C3D on 16-frame
    112x112 clips, features within 1e-4 of their largest."""
    from ta3n_tpu_torch.models.backbones import (C3DFeatures,
                                                 ResNetFeatures)
    from ta3n_tpu_torch.prep.video2feature import (extract_batched,
                                                   make_extractor)
    gen = torch.Generator().manual_seed(3)
    if base_model == "c3d":
        net = C3DFeatures()
        shape = (3, 16, 112, 112, 3)
    else:
        net = ResNetFeatures("resnet18")
        shape = (5, 224, 224, 3)
    state = {}
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(t)
        elif name.endswith("running_var"):
            state[name] = torch.rand(t.shape, generator=gen) + 0.5
        else:
            fan_in = t[0].numel() if t.dim() > 1 else 1
            state[name] = torch.randn(t.shape, generator=gen) / math.sqrt(
                fan_in)
    path = str(tmp_path / "w.pth")
    torch.save(state, path)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got = extract_batched(x, make_extractor(base_model, path, 2,
                                            device="cuda"), 2)
    want = extract_batched(x, make_extractor(base_model, path, 2,
                                             device="cpu"), 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_int8_matmul_on_cuda_is_bitwise_the_cpu():
    """int8_matmul at the flagship's shapes and at narrow unaligned ones
    (torch._int_mm's rows, K and N padded) on the card, bitwise the CPU's:
    the scales are true divisions on both devices."""
    from ta3n_tpu_torch.models import layers
    gen = torch.Generator().manual_seed(4)
    for m, k, n in ((320, 2048, 512), (5, 2048, 512), (64, 2560, 256),
                    (1, 256, 256), (3, 20, 6), (17, 136, 130)):
        x = torch.relu(torch.randn(m, k, generator=gen))
        w = torch.randn(n, k, generator=gen) * 0.05
        got = layers.int8_matmul(x.cuda(), w.cuda()).cpu()
        assert torch.equal(got, layers.int8_matmul(x, w)), (m, k, n)


# ---- data parallelism (parallel/, the steps' mesh=) on the card ----

def _parallel_spec(device="cuda"):
    """The flagship's host-feature and device-store steps at small widths
    (batches of 8 + 6 videos, the last of each stream padded), its weights
    redrawn at U(±1/sqrt(fan_in)) from a seed, as
    tests/test_torch_port_parallel_worker.py reads them."""
    model = dict(num_class=5, baseline_type="video",
                 frame_aggregation="trn-m", train_segments=5,
                 val_segments=5, feature_dim=64, fc_dim=32,
                 use_attn="TransAttn", dropout_i=0.5, dropout_v=0.5)
    state = create_train_state(ModelConfig(**model), TrainConfig(),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(0)
    weights = {}
    for name, v in state.model.state_dict().items():
        if v.dtype.is_floating_point and "running" not in name:
            bound = 1.0 / math.sqrt(v.shape[-1] if v.dim() > 1 else 32)
            v = torch.from_numpy(rng.uniform(-bound, bound, tuple(v.shape))
                                 .astype(np.float32))
        weights[name] = v
    store = rng.normal(size=(80, 64)).astype(np.float32)

    def batch(seed, store_idx):
        r = np.random.default_rng(seed)
        ms, mt = np.ones(8, np.float32), np.ones(6, np.float32)
        ms[-1] = mt[-1] = 0.0
        xs = (r.integers(0, 80, (8, 5)).astype(np.int32) if store_idx
              else r.normal(size=(8, 5, 64)).astype(np.float32))
        xt = (r.integers(0, 80, (6, 5)).astype(np.int32) if store_idx
              else r.normal(size=(6, 5, 64)).astype(np.float32))
        return (xs, r.integers(0, 5, 8), ms, xt, r.integers(0, 5, 6), mt)

    da = dict(use_target="uSv", adv_DA="RevGrad",
              add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
    scalars = [((-0.5, -0.5, -0.5), 0.0, 0.0, 0.003, 0.01)] * 3
    common = dict(model=model, da=da, weights=weights, scalars=scalars,
                  train=dict(lr=0.01), dropout_seed=5, device=device)
    return {"host": dict(common, kind="host",
                         batches=[batch(i, False) for i in range(3)]),
            "store": dict(common, kind="store", store=store,
                          batches=[batch(i, True) for i in range(3)])}


def _parallel_close(got, want, what):
    """Parameters and metrics within the tolerance of kernels at two batch
    sizes (the kernels' sums in another order)."""
    for key in want["params"]:
        np.testing.assert_allclose(got["params"][key], want["params"][key],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}: {key}")
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{what}: {key}")


def test_two_rank_gloo_steps_on_the_card_match_one_rank(tmp_path):
    """Two processes on cuda:0 in a gloo group (CUDA tensors): 3 flagship
    steps at small widths with dropout 0.5, from host features and from a
    store, against the one-rank steps; every rank launched K1 (train), K2
    and K3 (the store case), and the ranks' parameters are bitwise
    equal."""
    import os
    import subprocess
    import sys

    from test_torch_port_parallel_worker import run_cases

    spec = _parallel_spec()
    path = str(tmp_path / "spec.pt")
    torch.save(spec, path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests",
                          "test_torch_port_parallel_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, path, str(tmp_path / f"r{r}.pt"), str(r),
         "2", str(tmp_path / "init")],
        env={**os.environ, "PYTHONPATH": root}) for r in range(2)]
    try:
        assert [p.wait(timeout=600) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(str(tmp_path / f"r{r}.pt"), weights_only=False)
             for r in range(2)]
    one = run_cases(spec)
    for name in spec:
        _parallel_close(ranks[0][name], one[name], name)
        for key in ranks[0][name]["params"]:
            assert np.array_equal(ranks[0][name]["params"][key],
                                  ranks[1][name]["params"][key]), key
        for rank in ranks:
            launched = rank[name]["launches"]
            assert launched["k1_train"] == launched["k2"] == 3
            assert launched["k3"] == (6 if name == "store" else 0)


def test_nccl_world_size_one_matches_no_mesh():
    """NCCL at world size 1: the steps through mesh= with a real process
    group (its gather and gradient all-reduce over one rank) equal the
    steps without a mesh."""
    import socket

    import torch.distributed as dist

    from test_torch_port_parallel_worker import run_cases
    from ta3n_tpu_torch.parallel import make_mesh
    from ta3n_tpu_torch.parallel.distributed import initialize_multihost

    spec = _parallel_spec()
    want = run_cases(spec)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.size == 1
        got = run_cases(spec, mesh)
    finally:
        dist.destroy_process_group()
    for name in spec:
        _parallel_close(got[name], want[name], name)


def test_kernels_launch_on_a_second_device():
    """One process launching each kernel on cuda:0 and then on cuda:1:
    every kernel opts in to its dynamic shared memory on each device
    (csrc/smem_optin.cuh), so K1 (infer, train) and K2 in float32 and
    bfloat16, and K3 at float32 and bfloat16 compute, run on the second
    card and agree with their plain versions there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card (one process launching on two "
                    "devices)")
    b, s, d, h = 202, 5, 512, 256
    for device in ("cuda:0", "cuda:1"):
        x, w, bi = (_move(t, device) for t in _trn_inputs(b, s, d, h))
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd, bd = x.to(dtype), [t.to(dtype) for t in w], \
                [t.to(dtype) for t in bi]
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            with torch.no_grad():
                got = trn_fused.trn_multiscale_infer(xd, wd, bd, s)
                want = trn_fused.trn_multiscale_plain(xd, wd, bd, s)
                out, masks = trn_fused.trn_multiscale_fwd_masks(xd, wd, bd,
                                                                s)
                g = torch.ones_like(out)
                dx, _, _ = trn_fused.trn_multiscale_bwd(xd, wd, masks, g, s)
                dx_want, _, _ = trn_fused.trn_multiscale_bwd_plain(
                    xd, wd, masks, g, s)
            for a, ref in ((got, want), (out, want), (dx, dx_want)):
                assert a.device == torch.device(device)
                assert (a.float() - ref.float()).abs().max().item() <= \
                    tol * max(1.0, ref.float().abs().max().item())
        store, idx, scale, gw = (_move(t, device) if torch.is_tensor(t)
                                 else t for t in _gather_inputs(640, d=2048))
        rows = gather_gemm.row_index(idx, store.shape[0], device)
        for weight, tol in ((gw, 1e-4), (gw.to(torch.bfloat16), 2e-2)):
            z, _ = gather_gemm.gathered_gemm(store, rows, weight, scale)
            ref, _ = gather_gemm.gathered_gemm_plain(store, rows.rows,
                                                     weight, scale)
            assert z.device == torch.device(device)
            assert (z.float() - ref.float()).abs().max().item() <= \
                tol * max(1.0, ref.float().abs().max().item())


def _move(t, device):
    return t.to(device) if torch.is_tensor(t) else [u.to(device) for u in t]


@pytest.mark.parametrize("n,with_rows", [(640, True), (370, True),
                                         (320, False)])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("h", [256, 128])
def test_gather_gemm_column_slice_matches_plain(h, compute, n, with_rows):
    """K3 on a model rank's column slice of the flagship's first FC (H =
    512 / M: 256 at M = 2, 128 at M = 4; D = 2048) from a float32 store,
    at float32 and bfloat16 compute, against its plain version: z within
    the float32 check's tolerance or _bf16_ok, x_res bitwise equal, one
    launch a call; and the slices of a whole weight, gathered in column
    order, are the whole weight's launch within the same bound."""
    store, idx, scale, w = _gather_inputs(n, d=2048, h=512)
    if compute == "bf16":
        w = w.to(torch.bfloat16)
    rows = gather_gemm.row_index(idx, 500, "cuda")
    m = 512 // h
    slices = [w[j * h:(j + 1) * h].contiguous() for j in range(m)]
    name = f"f32_{compute}"
    gather_gemm.variant_launches[name] = 0
    got = [gather_gemm.gathered_gemm(store, rows, s, scale,
                                     with_rows=with_rows) for s in slices]
    whole, _ = gather_gemm.gathered_gemm(store, rows, w, scale,
                                         with_rows=False)
    torch.cuda.synchronize()
    assert gather_gemm.variant_launches[name] == m + 1
    for s, (z, x_res) in zip(slices, got):
        want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, s,
                                                       scale)
        assert z.shape == (n, h) and z.dtype == w.dtype
        if compute == "f32":
            assert (z - want).abs().max().item() <= _tol(want)
        else:
            assert _bf16_ok(z, want)
        if with_rows:
            assert torch.equal(x_res, want_x)
    joined = torch.cat([z for z, _ in got], dim=1)
    if compute == "f32":
        assert (joined - whole).abs().max().item() <= _tol(whole)
    else:
        assert _bf16_ok(joined, whole.float())


def test_nccl_make_mesh_2d_one_by_one_equals_no_mesh():
    """NCCL at world size 1: the steps over ``make_mesh_2d(model_parallel=
    1)``, a 1 x 1 grid (the 1-D mesh), equal the steps without a mesh
    exactly: the gather and the all-reduce over one rank change no bit."""
    import socket

    import torch.distributed as dist

    from test_torch_port_parallel_worker import run_cases
    from ta3n_tpu_torch.parallel import make_mesh_2d
    from ta3n_tpu_torch.parallel.distributed import initialize_multihost

    spec = _parallel_spec()
    want = run_cases(spec)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh_2d(model_parallel=1)
        assert mesh.distributed and mesh.size == 1 and mesh.model.size == 1
        got = run_cases(spec, mesh)
    finally:
        dist.destroy_process_group()
    for name in spec:
        for key in want[name]["params"]:
            assert np.array_equal(got[name]["params"][key],
                                  want[name]["params"][key]), (name, key)
        for g, w in zip(got[name]["metrics"], want[name]["metrics"]):
            for key in w:
                assert np.array_equal(g[key], w[key]), (name, key)
