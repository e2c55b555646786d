"""PyTorch port, narrow feature stores (``--store_dtype bfloat16|int8`` and
stores quantized on disk) against the JAX package on the CPU.

Exact, bit for bit: ``quantize_rows`` and ``dequantize_rows``, the host
gather and the loader's batches from a quantized store, a quantized
store's save and load both ways, the uploads of ``to_device``, the port's
``device_gather`` of an int8 pair, and the plain gather kernel's x_res
from an int8 store with a mask (the JAX step's ``device_gather`` then
``x * mask``).  At the float32 tolerances of
test_torch_port_device_step.py: 4 device-store train steps from a
bfloat16 and from an int8 store at float32 compute, and the eval and
infer steps from both, against the JAX steps from the same converted
weights.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_port_device_step import (B_S, B_T, EVAL_TOL, MODEL, PAIR,
                                         _loaders, _port_model, _weights)
from test_torch_port_train import (BETA, DA, GAMMA, LOSS_RTOL, LR0,
                                   PARAM_TOL)
from ta3n_tpu.config import DAConfig as JaxDAConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.data import TSNLoader as JaxTSNLoader
from ta3n_tpu.data import quantized as jax_quantized
from ta3n_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from ta3n_tpu.data.synthetic import make_domain_pair as jax_domain_pair
from ta3n_tpu.train import StepScalars as JaxStepScalars
from ta3n_tpu.train import TrainState as JaxTrainState
from ta3n_tpu.train import make_eval_step as jax_make_eval_step
from ta3n_tpu.train import make_train_step as jax_make_train_step
from ta3n_tpu.train.step import _build_tx
from ta3n_tpu.train.step import device_gather as jax_device_gather
from ta3n_tpu.train.step import make_multi_eval_step as jax_multi_eval
from ta3n_tpu_torch.config import DAConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore, TSNLoader, make_domain_pair
from ta3n_tpu_torch.data import quantized
from ta3n_tpu_torch.ops import gather_gemm
from ta3n_tpu_torch.train import (StepScalars, make_eval_step,
                                  make_multi_eval_step, make_train_step)
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress
from ta3n_tpu_torch.train.step import device_gather, make_infer_step


def _rows(seed=0, streams=None, rows=40, d=24):
    """Rows of mixed scales, one all-zero row (scale 1, exact zeros)."""
    rng = np.random.default_rng(seed)
    shape = (rows, d) if streams is None else (rows, streams, d)
    arr = rng.normal(size=shape) * rng.uniform(0.01, 30.0, (rows,) + (1,) * (
        len(shape) - 1))
    arr[3] = 0.0
    return arr.astype(np.float32)


@pytest.mark.parametrize("streams", [None, 2])
def test_quantize_rows_bytes_match_jax(streams):
    arr = _rows(streams=streams)
    q, s = quantized.quantize_rows(arr)
    jq, js = jax_quantized.quantize_rows(arr)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()
    assert s[3] == 1.0 and not q[3].any()
    deq = quantized.dequantize_rows(q, s)
    assert deq.tobytes() == jax_quantized.dequantize_rows(jq, js).tobytes()
    assert quantized.is_quantized((q, s)) and not quantized.is_quantized(q)


def _quantized_stores(streams=None):
    """The same features quantized by each package's FeatureStore."""
    port = make_domain_pair(num_source=23, num_target=9, num_val=5,
                            num_class=4, feature_dim=12, seed=2)[0]
    feats = port.features if streams is None else \
        _rows(seed=3, streams=streams, rows=len(port.features), d=12)
    args = (feats, port.offsets, port.paths, port.labels)
    return FeatureStore(*args).quantize(), JaxFeatureStore(*args).quantize()


@pytest.mark.parametrize("streams", [None, 2])
def test_quantized_host_gather_and_loader_match_jax(streams):
    """The host gather dequantizes as the JAX store does (cast, then
    multiply), and two shuffled epochs of the loader give the same
    features, bit for bit."""
    port, ref = _quantized_stores(streams)
    assert port.quantized and ref.quantized
    assert port.quantize() is port
    vids = np.array([0, 4, 4, 22])
    frames = np.array([[0, 1, 2], [2, 1, 0], [0, 0, 0], [1, 3, 2]])
    got, want = port.gather(vids, frames), ref.gather(vids, frames)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    lp = TSNLoader(port, batch_size=5, num_segments=3, mode="random",
                   seed=4)
    lj = JaxTSNLoader(ref, batch_size=5, num_segments=3, mode="random",
                      seed=4)
    for _ in range(2):
        for a, b in zip(lp.epoch(), lj.epoch(), strict=True):
            assert a.features.tobytes() == b.features.tobytes()
            np.testing.assert_array_equal(a.mask, b.mask)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_quantized_store_save_load_both_ways(tmp_path, writer):
    """A quantized store written by one package loads in the other with
    the same int8 rows, scales and meta.json's store_dtype, and gathers
    the same values."""
    port, ref = _quantized_stores()
    (port if writer == "port" else ref).save(str(tmp_path))
    assert (tmp_path / "scales.npy").is_file()
    import json
    assert json.loads((tmp_path / "meta.json").read_text())[
        "store_dtype"] == "int8"
    back_p = FeatureStore.load(str(tmp_path))
    back_j = JaxFeatureStore.load(str(tmp_path))
    for back in (back_p, back_j):
        assert back.quantized
        assert np.asarray(back.features).tobytes() == port.features.tobytes()
        assert np.asarray(back.scales).tobytes() == port.scales.tobytes()
    vids, frames = np.array([1, 7]), np.array([[0, 2], [1, 1]])
    assert back_p.gather(vids, frames).tobytes() == \
        back_j.gather(vids, frames).tobytes()
    sub = back_p.subset([2, 0])
    assert sub.quantized and sub.gather(np.array([1]), np.array([[0]])) \
        .tobytes() == back_j.gather(np.array([0]), np.array([[0]])).tobytes()


def test_to_device_dtypes_match_jax_uploads():
    """to_device: bfloat16 rounds as the JAX Trainer's astype(bfloat16)
    (round to nearest even); int8 quantizes per row as its quantize_rows;
    both bit for bit."""
    store = make_domain_pair(num_source=9, num_target=4, num_val=3,
                             feature_dim=16, seed=1)[0]
    bf = store.to_device("cpu", "bfloat16")
    assert bf.dtype == torch.bfloat16
    want = np.asarray(store.features).astype(ml_dtypes.bfloat16)
    assert bf.view(torch.int16).numpy().tobytes() == want.tobytes()
    q, s = store.to_device("cpu", torch.int8)
    jq, js = jax_quantized.quantize_rows(np.asarray(store.features))
    assert q.numpy().tobytes() == jq.tobytes()
    assert s.numpy().tobytes() == js.tobytes()
    assert store.to_device("cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        store.to_device("cpu", "float16")


@pytest.mark.parametrize("streams", [None, 2])
def test_int8_gathers_match_jax_bitwise(streams):
    """device_gather of an int8 pair, and the plain gather kernel's x_res
    from it with the loader's mask as row scale, against the JAX step's
    device_gather and x * mask: bit for bit."""
    arr = _rows(seed=5, streams=streams)
    q, s = quantized.quantize_rows(arr)
    idx = np.array([[0, 3, 39], [7, 7, 12]], np.int32)
    mask = np.array([1.0, 0.0], np.float32)
    pair = (torch.from_numpy(q), torch.from_numpy(s))
    got = device_gather(pair, torch.from_numpy(idx))
    want = jax_device_gather((jnp.asarray(q), jnp.asarray(s)),
                             jnp.asarray(idx))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    masked = np.asarray(want * jnp.asarray(mask)[:, None, None])
    d = arr.shape[-1]
    w = torch.zeros((4, d))
    _, x_res = gather_gemm.gathered_gemm_plain(
        pair, torch.from_numpy(idx.reshape(-1).astype(np.int64)), w,
        torch.from_numpy(mask).repeat_interleave(idx.shape[1]))
    assert x_res.numpy().tobytes() == masked.reshape(-1, d).tobytes()


def _jax_train(jmodel, params):
    jtc = JaxTrainConfig(lr=LR0, batch_size=(B_S, B_T, 4))
    tx = _build_tx(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return (JaxTrainState(jparams, {}, tx.init(jparams),
                          jnp.asarray(0, jnp.int32)),
            jax_make_train_step(jmodel, JaxDAConfig(**DA), jtc,
                                gather_on_device=True))


def _jax_store(store, dtype):
    """A store on the JAX device as the JAX Trainer uploads it."""
    arr = np.ascontiguousarray(store.features)
    if dtype == "int8":
        q, s = jax_quantized.quantize_rows(arr)
        return jnp.asarray(q), jnp.asarray(s)
    return jnp.asarray(arr.astype(ml_dtypes.bfloat16))


@pytest.mark.parametrize("store_dtype", ["bfloat16", "int8"])
def test_narrow_store_train_steps_match_jax(store_dtype):
    """4 device-store steps at float32 compute from a bfloat16 and from an
    int8 store, against the JAX step on the same narrow stores: metrics
    at every step and the final parameters at the float32 tolerances."""
    jmodel, params = _weights()
    jstate, jstep = _jax_train(jmodel, params)
    jstores = jax_domain_pair(**PAIR)
    js, jt, _ = _loaders(jstores, JaxTSNLoader)
    jdev = [_jax_store(s, store_dtype) for s in jstores[:2]]

    state = _port_model(params)
    step = make_train_step(state.model, DAConfig(**DA), TrainConfig(lr=LR0),
                           gather_on_device=True)
    stores = make_domain_pair(**PAIR)
    ps, pt, _ = _loaders(stores, TSNLoader)
    dev = [s.to_device("cpu", store_dtype) for s in stores[:2]]
    i = 0
    for _ in range(2):
        for (bs, bt), (js_b, jt_b) in zip(zip(ps.index_epoch(),
                                              pt.index_epoch()),
                                          zip(js.index_epoch(),
                                              jt.index_epoch())):
            p = progress(i, 0, 20)
            beta, lr = effective_beta(BETA, p), dann_lr(LR0, p)
            jstate, want = jstep(
                jstate, jdev[0], *js_b, jdev[1], *jt_b,
                JaxStepScalars(np.asarray(beta, np.float32), np.float32(0),
                               np.float32(0), np.float32(GAMMA),
                               np.float32(lr)), jax.random.PRNGKey(0))
            state, got = step(state, dev[0], *bs, dev[1], *bt,
                              StepScalars(beta, 0.0, 0.0, GAMMA, lr), None)
            for key in got:
                np.testing.assert_allclose(float(got[key]), float(want[key]),
                                           rtol=LOSS_RTOL, err_msg=key)
            i += 1
    assert i == state.step == 4
    from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("store_dtype", ["bfloat16", "int8"])
def test_narrow_store_eval_and_infer_steps_match_jax(store_dtype):
    """The device-store eval step, the whole-epoch eval step and the eval
    CLI's infer step from a bfloat16 and from an int8 store against the
    JAX eval steps on the same store (the infer step's probabilities
    against the softmax of the JAX eval step's logits): float32
    tolerance, top1, top5 and n equal."""
    jmodel, params = _weights()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jval = _loaders(jax_domain_pair(**PAIR), JaxTSNLoader)[2]
    jstore = _jax_store(jax_domain_pair(**PAIR)[2], store_dtype)
    jev = jax_make_eval_step(jmodel, None, gather_on_device=True)

    model = _port_model(params).model
    stores = make_domain_pair(**PAIR)
    val = _loaders(stores, TSNLoader)[2]
    store = stores[2].to_device("cpu", store_dtype)
    ev = make_eval_step(model, gather_on_device=True)
    batches = list(val.index_epoch())
    logits = []
    for b, jb in zip(batches, jval.index_epoch(), strict=True):
        want = jev(jparams, {}, jstore, *jb)
        got = ev(store, *b)
        for key in ("loss", "logits", "feat"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), err_msg=key,
                                       **EVAL_TOL)
        for key in ("top1", "top5", "n"):
            assert float(got[key]) == float(want[key])
        logits.append(np.asarray(want["logits"]))
    stacked = [np.stack(a) for a in zip(*batches)]
    want = jax_multi_eval(jmodel, None)(jparams, {}, jstore, *stacked)
    got = make_multi_eval_step(model)(store, *stacked)
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-5)
    for key in ("top1", "top5", "n"):
        assert float(got[key]) == float(want[key])
    probs, _, top_i, _ = make_infer_step(model, 3, gather_on_device=True)(
        store, stacked[0], stacked[2])
    want_p = jax.nn.softmax(jnp.asarray(np.stack(logits)), axis=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p),
                               **EVAL_TOL)
    assert probs.dtype == torch.float32 and top_i.shape[:2] == \
        stacked[0].shape[:2]
