"""PyTorch port, the TRN training path: the plain training forward (with
its relu masks) and the plain backward, which CPU tensors take, and the
autograd Function that joins them, held against the JAX package's Pallas
kernels in interpret mode and its custom VJP.  The CUDA kernels that these
plain versions stand for are tested on the card by test_torch_port_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.ops import relation as jax_relation
from ta3n_tpu.ops.trn_fused import (_fused_backward_pallas, _fused_forward,
                                    trn_multiscale_fused as jax_fused)
from ta3n_tpu_torch.models.trn import RelationModuleMultiScale
from ta3n_tpu_torch.ops import trn_fused

# (B, S, D, H): the sizes of tests/test_trn_fused.py, and a ragged case
CASES = [(6, 5, 16, 8), (5, 5, 16, 8), (13, 4, 37, 19)]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_trn_fused.py:73-109


def _inputs(b, s, d, h, seed=0):
    """x of both signs (the relu on load matters), weights in the JAX
    layout [k*D, H] at torch's default scale, and an upstream gradient."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    weights, biases = [], []
    for k in jax_relation.build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append(rng.uniform(-bound, bound, (k * d, h))
                       .astype(np.float32))
        biases.append(rng.uniform(-bound, bound, (h,)).astype(np.float32))
    g = rng.normal(size=(b, s - 1, h)).astype(np.float32)
    return x, weights, biases, g


def _torch(x, weights, biases):
    """The same values in the port's layout: weights [H, k*D]."""
    return (torch.from_numpy(x),
            [torch.from_numpy(np.ascontiguousarray(w.T)) for w in weights],
            [torch.from_numpy(b) for b in biases])


def _jax(x, weights, biases):
    return (jnp.asarray(x), tuple(map(jnp.asarray, weights)),
            tuple(map(jnp.asarray, biases)))


@pytest.mark.parametrize("b,s,d,h", CASES)
def test_fwd_masks_plain_matches_pallas_forward(b, s, d, h):
    """Output within f32 tolerance of `_fused_forward(with_masks=True)` in
    interpret mode; the masks (bf16 there, uint8 here) exactly equal."""
    x, w, bi, _ = _inputs(b, s, d, h)
    want_out, want_masks = _fused_forward(*_jax(x, w, bi), s, 3, True)
    out, masks = trn_fused.trn_multiscale_fwd_masks_plain(*_torch(x, w, bi),
                                                          s)
    n_sub = sum(len(sub) for sub in jax_relation.build_relation_plan(s)
                .subsets)
    assert masks.dtype == torch.uint8 and masks.shape == (b, n_sub * h)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD_TOL)
    np.testing.assert_array_equal(masks.numpy().astype(np.float32),
                                  np.asarray(want_masks, np.float32))
    # the same output as the inference forward
    np.testing.assert_allclose(
        out.numpy(),
        trn_fused.trn_multiscale_plain(*_torch(x, w, bi), s).numpy(),
        **FWD_TOL)


@pytest.mark.parametrize("tile_batch", [None, 8])
@pytest.mark.parametrize("b,s,d,h", CASES)
def test_bwd_plain_matches_pallas_backward(b, s, d, h, tile_batch):
    """dx, every dW (transposed to the JAX layout) and db against
    `_fused_backward_pallas` in interpret mode, on one batch tile and, with
    tile_batch=8, on several (dW and db carried across grid steps)."""
    x, w, bi, g = _inputs(b, s, d, h, seed=1)
    jx, jw, jb = _jax(x, w, bi)
    jmasks = _fused_forward(jx, jw, jb, s, 3, True)[1]
    want_dx, want_dw, want_db = _fused_backward_pallas(
        jx, jw, jmasks, jnp.asarray(g), s, 3, True, tile_batch=tile_batch)
    tx, tw, tb = _torch(x, w, bi)
    _, masks = trn_fused.trn_multiscale_fwd_masks_plain(tx, tw, tb, s)
    dx, dws, dbs = trn_fused.trn_multiscale_bwd_plain(
        tx, tw, masks, torch.from_numpy(g), s)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **BWD_TOL)
    assert len(dws) == len(dbs) == s - 1
    for ours, ref, wt in zip(dws, want_dw, tw):
        assert ours.shape == wt.shape  # the torch layout [H, k*D]
        np.testing.assert_allclose(ours.numpy().T, np.asarray(ref),
                                   **BWD_TOL)
    for ours, ref in zip(dbs, want_db):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BWD_TOL)


@pytest.mark.parametrize("b,s,d,h", CASES)
def test_fused_gradients_match_jax_and_autograd(b, s, d, h):
    """`trn_multiscale_fused` on CPU tensors: its output and gradients
    against jax.grad of the JAX package's `trn_multiscale_fused` (the
    Pallas forward and backward in interpret mode), and against torch
    autograd through `trn_multiscale_plain`.  No kernel launches."""
    x, w, bi, g = _inputs(b, s, d, h, seed=2)

    def jax_loss(x, w, b):
        return jnp.sum(jax_fused(x, w, b, s, 3, True) * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*_jax(x, w, bi))

    def port_grads(fn):
        tx, tw, tb = _torch(x, w, bi)
        for t in (tx, *tw, *tb):
            t.requires_grad_(True)
        out = fn(tx, tw, tb, s)
        (out * torch.from_numpy(g)).sum().backward()
        return out, tx.grad, [t.grad for t in tw], [t.grad for t in tb]

    for name in ("launches", "train_launches", "bwd_launches"):
        setattr(trn_fused, name, 0)
    out, gx, gw, gb = port_grads(trn_fused.trn_multiscale_fused)
    assert (trn_fused.launches, trn_fused.train_launches,
            trn_fused.bwd_launches) == (0, 0, 0)
    _, ax, aw, ab = port_grads(trn_fused.trn_multiscale_plain)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax_fused(*_jax(x, w, bi), s, 3, True)), **FWD_TOL)
    for ours, ref, auto in [(gx, want[0], ax),
                            *zip(gw, want[1], aw), *zip(gb, want[2], ab)]:
        ref = np.asarray(ref)
        if ref.ndim == 2:  # a weight: JAX layout [k*D, H]
            ref = ref.T
        np.testing.assert_allclose(ours.numpy(), ref, **BWD_TOL)
        np.testing.assert_allclose(ours.numpy(), auto.numpy(), **BWD_TOL)


def test_fused_saves_masks_not_z():
    """The autograd Function keeps x, the uint8 masks and the weights for
    its backward, nothing of z's size in float."""
    x, w, bi, _ = _inputs(6, 5, 16, 8)
    tx, tw, tb = _torch(x, w, bi)
    for t in (tx, *tw, *tb):
        t.requires_grad_(True)
    out = trn_fused.trn_multiscale_fused(tx, tw, tb, 5)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 + len(tw)
    assert saved[0] is tx or torch.equal(saved[0], tx)
    assert saved[1].dtype == torch.uint8 and saved[1].shape == (6, 10 * 8)
    for a, b in zip(saved[2:], tw):
        assert torch.equal(a, b)


def test_relation_module_trains_through_fused_op():
    """RelationModuleMultiScale(infer=False) builds its graph on the fused
    Function, and its gradients equal autograd of the plain version."""
    s, d, h = 5, 16, 8
    x, w, bi, g = _inputs(7, s, d, h, seed=3)
    mod = RelationModuleMultiScale(d, h, s)
    with torch.no_grad():
        for seq, wt, bt in zip(mod.fc_fusion_scales, *_torch(x, w, bi)[1:]):
            seq[1].weight.copy_(wt)
            seq[1].bias.copy_(bt)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mod(tx, infer=False)
    assert type(out.grad_fn).__name__ == "_TRNFusedBackward"
    (out * torch.from_numpy(g)).sum().backward()
    weights = [seq[1].weight for seq in mod.fc_fusion_scales]
    biases = [seq[1].bias for seq in mod.fc_fusion_scales]
    ref_x = torch.from_numpy(x).requires_grad_(True)
    ref_w = [t.detach().clone().requires_grad_(True) for t in weights]
    ref_b = [t.detach().clone().requires_grad_(True) for t in biases]
    (trn_fused.trn_multiscale_plain(ref_x, ref_w, ref_b, s)
     * torch.from_numpy(g)).sum().backward()
    torch.testing.assert_close(tx.grad, ref_x.grad, rtol=1e-4, atol=1e-5)
    for t, ref in zip(weights + biases, ref_w + ref_b):
        torch.testing.assert_close(t.grad, ref.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["masks_dtype", "masks_shape", "g_shape",
                                  "g_dtype", "weight_layout"])
def test_backward_kernel_input_checks(case):
    """What the backward kernel's wrapper refuses, checked on CPU tensors
    before any build or launch."""
    s, h = 5, 8
    x, w, bi, g = _inputs(4, s, 16, h)
    tx, tw, _ = _torch(x, w, bi)
    tg = torch.from_numpy(g)
    masks = torch.zeros((4, 10 * h), dtype=torch.uint8)
    err = ValueError
    if case == "masks_dtype":
        masks, err = masks.float(), TypeError
    elif case == "masks_shape":
        masks = masks[:, :-1].contiguous()
    elif case == "g_shape":
        tg = tg[:, :-1].contiguous()
    elif case == "g_dtype":
        tg, err = tg.double(), TypeError
    else:  # the JAX layout [k*D, H]
        tw = [t.T.contiguous() for t in tw]
    with pytest.raises(err):
        trn_fused._launch_bwd(tx, tw, masks, tg, s, 3)


def test_plain_trains_after_an_inference_mode_first_call():
    """The plain version caches its index tensors per device; made first
    under inference mode, they must still serve a later training call."""
    x, w, bi, _ = _inputs(3, 5, 16, 8, seed=4)
    tx, tw, tb = _torch(x, w, bi)
    trn_fused._subset_index.cache_clear()
    with torch.inference_mode():
        trn_fused.trn_multiscale_plain(tx, tw, tb, 5)
    tx.requires_grad_(True)
    trn_fused.trn_multiscale_plain(tx, tw, tb, 5).sum().backward()
    assert tx.grad.shape == tx.shape


def test_kernel_wrappers_dispatch_by_device():
    """On CPU tensors the training-forward and backward wrappers are their
    plain versions and launch nothing; a device with no kernel raises."""
    x, w, bi, g = _inputs(4, 5, 16, 8, seed=5)
    tx, tw, tb = _torch(x, w, bi)
    tg = torch.from_numpy(g)
    for name in ("train_launches", "bwd_launches"):
        setattr(trn_fused, name, 0)
    out, masks = trn_fused.trn_multiscale_fwd_masks(tx, tw, tb, 5)
    want_out, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
        tx, tw, tb, 5)
    assert torch.equal(out, want_out) and torch.equal(masks, want_masks)
    got = trn_fused.trn_multiscale_bwd(tx, tw, masks, tg.transpose(0, 1)
                                       .contiguous().transpose(0, 1), 5)
    want = trn_fused.trn_multiscale_bwd_plain(tx, tw, masks, tg, 5)
    for a, b in zip((got[0], *got[1], *got[2]),
                    (want[0], *want[1], *want[2])):
        torch.testing.assert_close(a, b)
    assert (trn_fused.train_launches, trn_fused.bwd_launches) == (0, 0)
    meta = [t.to("meta") for t in (tx, *tw)]
    with pytest.raises(ValueError, match="no kernel"):
        trn_fused.trn_multiscale_fwd_masks(meta[0], meta[1:], tb, 5)
    with pytest.raises(ValueError, match="no kernel"):
        trn_fused.trn_multiscale_bwd(meta[0], meta[1:], masks, tg, 5)
