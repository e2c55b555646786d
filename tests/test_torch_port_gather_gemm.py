"""PyTorch port, the fused gather + first-FC GEMM (K3): the plain version,
which CPU stores take, held against the JAX package's XLA oracle
(`gathered_gemm_reference`), its Pallas kernel in interpret mode and its
``device_gather``; the autograd Function's gradients against autograd; and
the host-side index checks.  The CUDA kernel that the plain version stands
for is tested on the card by test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.ops.gather_gemm import (gathered_gemm as jax_gathered_gemm,
                                      gathered_gemm_reference, pack_store)
from ta3n_tpu.train.step import device_gather as jax_device_gather
from ta3n_tpu_torch.ops import gather_gemm
from ta3n_tpu_torch.train import device_gather

R, D, H = 64, 256, 32  # the sizes of tests/test_gather_gemm.py
Z_TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n, seed=0, streams=None):
    """A store of R rows, n indices with duplicates and the last row, and
    a weight in the JAX layout [D, H]."""
    rng = np.random.default_rng(seed)
    shape = (R, D) if streams is None else (R, streams, D)
    store = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, R, size=n).astype(np.int32)
    if n >= 4:
        idx[:2] = idx[2]          # duplicates
        idx[3] = R - 1
    k = 1 if streams is None else streams
    w = rng.normal(scale=0.05, size=(k * D, H)).astype(np.float32)
    return store, idx, w


def _port_w(w):
    """The port's torch layout [H, k*D]."""
    return torch.from_numpy(np.ascontiguousarray(w.T))


@pytest.mark.parametrize("n", [37, 8, 1])
def test_plain_matches_jax_reference_and_pallas(n):
    """Ragged N, duplicate indices: z within 1e-5 of the XLA oracle and of
    the Pallas kernel (interpret mode on the TPU's packed store); x_res
    equal to both."""
    store, idx, w = _data(n)
    store3 = pack_store(jnp.asarray(store))
    want_z, want_x = gathered_gemm_reference(store3, jnp.asarray(idx),
                                             jnp.asarray(w))
    pallas_z, pallas_x = jax_gathered_gemm(store3, jnp.asarray(idx),
                                           jnp.asarray(w), tile_rows=16,
                                           interpret=True)
    gather_gemm.launches = 0
    z, x_res = gather_gemm.gathered_gemm(torch.from_numpy(store), idx,
                                         _port_w(w))
    assert gather_gemm.launches == 0  # the CPU takes the plain version
    assert z.shape == (n, H) and x_res.shape == (n, D)
    for ref_z, ref_x in ((want_z, want_x), (pallas_z, pallas_x)):
        np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), **Z_TOL)
        np.testing.assert_array_equal(x_res.numpy(),
                                      np.asarray(ref_x).reshape(n, D))


@pytest.mark.parametrize("streams", [None, 2])
def test_scaled_rows_match_jax_device_gather(streams):
    """The device-store step's gather and mask multiply: rows of padded
    videos point at row 0 with scale 0 and come out exactly 0; a Flow
    store's streams interleave per frame, as JAX's device_gather orders
    them, and two gathered rows form one FC input row."""
    store, idx, w = _data(30, seed=1, streams=streams)
    b, t = 6, 5
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0
    abs_idx = idx.reshape(b, t)
    abs_idx[-2:] = 0
    x = jax_device_gather(jnp.asarray(store), jnp.asarray(abs_idx))
    x = np.asarray(x * jnp.asarray(mask)[:, None, None])
    k = 1 if streams is None else streams
    x = x.reshape(-1, k * D)
    scale = torch.from_numpy(np.repeat(mask, t))
    z, x_res = gather_gemm.gathered_gemm(torch.from_numpy(store), abs_idx,
                                         _port_w(w), scale)
    np.testing.assert_array_equal(x_res.numpy(), x)
    np.testing.assert_allclose(z.numpy(), x @ w, **Z_TOL)
    assert not x_res[-2 * t:].any() and not z[-2 * t:].any()
    # the port's device_gather, the plain form of the same gather
    got = device_gather(torch.from_numpy(store), torch.from_numpy(abs_idx))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_device_gather(jnp.asarray(store),
                                                  jnp.asarray(abs_idx))))


def test_without_rows_and_empty():
    store, idx, w = _data(9, seed=2)
    z, x_res = gather_gemm.gathered_gemm(torch.from_numpy(store), idx,
                                         _port_w(w), with_rows=False)
    assert x_res is None and z.shape == (9, H)
    z, x_res = gather_gemm.gathered_gemm(torch.from_numpy(store), idx[:0],
                                         _port_w(w))
    assert z.shape == (0, H) and x_res.shape == (0, D)


def test_gathered_linear_gradients_match_autograd():
    """Two parts (source and target stores) written into one buffer: the
    output, dW and db against autograd through store[idx] * scale @ W.T +
    b, concatenated; the stores get no gradient."""
    rng = np.random.default_rng(3)
    s_store, s_idx, w = _data(20, seed=3)
    t_store = rng.normal(size=(R // 2, D)).astype(np.float32)
    t_idx = rng.integers(0, R // 2, size=15)
    s_scale = (rng.random(20) > 0.2).astype(np.float32)
    t_scale = np.ones(15, np.float32)
    bias = rng.normal(size=H).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(35, H)).astype(np.float32))

    weight = _port_w(w).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    out = gather_gemm.gathered_linear(
        [(torch.from_numpy(s_store), s_idx, torch.from_numpy(s_scale)),
         (torch.from_numpy(t_store), t_idx, torch.from_numpy(t_scale))],
        weight, b)
    out.backward(g)

    ref_w = _port_w(w).requires_grad_(True)
    ref_b = torch.from_numpy(bias).requires_grad_(True)
    x = torch.cat([torch.from_numpy(s_store[s_idx] * s_scale[:, None]),
                   torch.from_numpy(t_store[t_idx] * t_scale[:, None])])
    ref = x @ ref_w.T + ref_b
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(weight.grad, ref_w.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, ref_b.grad, rtol=1e-5, atol=1e-6)


def test_indices_are_checked_on_the_host():
    store, idx, w = _data(8, seed=4)
    st = torch.from_numpy(store)
    for bad in (np.array([0, R]), np.array([-1, 3])):
        with pytest.raises(IndexError):
            gather_gemm.gathered_gemm(st, bad, _port_w(w))
        with pytest.raises(IndexError):
            gather_gemm.row_index(bad, R, "cpu")
    with pytest.raises(TypeError):
        gather_gemm.row_index(np.array([0.0, 1.0]), R, "cpu")
    # indices checked for a larger store are refused by a smaller one
    checked = gather_gemm.row_index(np.array([0, R - 1]), R, "cpu")
    assert checked.end == R and checked.rows.dtype == torch.int32
    with pytest.raises(IndexError):
        gather_gemm.gathered_gemm(st[:R // 2], checked, _port_w(w))
    with pytest.raises(TypeError):
        gather_gemm.gathered_gemm(
            st, gather_gemm.RowIndex(checked.rows.long(), checked.end),
            _port_w(w))
    with pytest.raises(ValueError, match="k\\*256"):
        gather_gemm.gathered_gemm(st, idx, torch.zeros(H, D + 1))
