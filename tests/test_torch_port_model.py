"""PyTorch port, model: the weight converter against the JAX package's
torch export, and the flagship VideoModel against the JAX VideoModel on
the same weights and inputs (CPU, float32, dropout 0).  The rest of the
model surface: tests/test_torch_port_surface_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.config import ModelConfig, TrainConfig
from ta3n_tpu.io_utils import torch_import
from ta3n_tpu.io_utils.torch_export import export_state_dict
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.train import create_train_state
from ta3n_tpu_torch.io_utils import convert
from ta3n_tpu_torch.io_utils.convert import (DEAD_PREFIXES,
                                             state_dict_from_jax_params)
from ta3n_tpu_torch.models import VideoModel

# the flagship's branches at small widths
CFG = ModelConfig(num_class=4, baseline_type="video",
                  frame_aggregation="trn-m", train_segments=5,
                  val_segments=5, feature_dim=32, fc_dim=16,
                  use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


def _redraw(tree, rng):
    """Every leaf at a trained-like scale, U(±1/sqrt(fan_in)), so that no
    output is near zero or near uniform (the normal(0.001) init would make
    most of them so)."""
    out = {}
    for name, sub in tree.items():
        if "kernel" in sub:
            bound = 1.0 / np.sqrt(sub["kernel"].shape[0])
            out[name] = {k: rng.uniform(-bound, bound, v.shape)
                         .astype(np.float32) for k, v in sub.items()}
        elif name == "TRN":
            out[name] = {}
            for i in range(len(sub) // 2):
                w = sub[f"w_scale_{i}"]
                bound = 1.0 / np.sqrt(w.shape[0])
                for key, shape in ((f"w_scale_{i}", w.shape),
                                   (f"b_scale_{i}", (w.shape[1],))):
                    out[name][key] = rng.uniform(-bound, bound, shape) \
                        .astype(np.float32)
        else:
            raise KeyError(name)
    return out


@pytest.fixture(scope="module")
def jax_params():
    state = create_train_state(JaxVideoModel(CFG), jax.random.PRNGKey(0),
                               3, 2, TrainConfig(batch_size=(3, 2, 4)))
    return _redraw(jax.tree_util.tree_map(np.asarray, state.params),
                   np.random.default_rng(0))


def test_converter_matches_torch_export(jax_params):
    """Key for key and value for value the JAX package's reference-format
    export, less the reference's dead parameters."""
    ours = state_dict_from_jax_params(jax_params)
    ref = {k: v for k, v in export_state_dict(jax_params).items()
           if not k.startswith(DEAD_PREFIXES)}
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # and the port's model takes it whole (strict)
    VideoModel(CFG).load_state_dict(ours, strict=True)


def test_dead_prefixes_match_jax_package():
    assert DEAD_PREFIXES == torch_import._DEAD_PREFIXES
    # and the BN pairs and Dense layers the converter maps
    assert convert._BN == tuple(torch_import._BN_DIRECT)
    assert convert._DENSE == tuple(torch_import._DENSE_DIRECT)


def test_converter_rejects_unknown_parameters(jax_params):
    """Collections that the port has no module for (the JAX model never
    holds the reference's dead temconv convs) and BN statistics without
    their BN are refused."""
    with pytest.raises(KeyError, match="tcl_5_1"):
        state_dict_from_jax_params({**jax_params, "tcl_5_1": {}})
    with pytest.raises(KeyError, match="conv_fusion"):
        state_dict_from_jax_params({**jax_params, "conv_fusion": {}})
    for bn in ("bn_shared_S", "bn_1_T"):
        with pytest.raises(KeyError, match=bn):
            state_dict_from_jax_params(jax_params,
                                       {bn: {"mean": np.zeros(2)}})


def _assert_stream_close(ours, ref, label):
    np.testing.assert_allclose(ours.out.detach().numpy(), np.asarray(ref.out),
                               err_msg=f"{label} out", **MODEL_TOL)
    np.testing.assert_allclose(ours.out_2.detach().numpy(),
                               np.asarray(ref.out_2),
                               err_msg=f"{label} out_2", **MODEL_TOL)
    np.testing.assert_allclose(ours.attn.detach().numpy(),
                               np.asarray(ref.attn),
                               err_msg=f"{label} attn", **MODEL_TOL)
    assert len(ours.pred_domain) == len(ref.pred_domain) == 3
    for name, a, b in zip(("relation", "video", "frame"), ours.pred_domain,
                          ref.pred_domain):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=f"{label} pred_domain {name}",
                                   **MODEL_TOL)
    assert len(ours.feat) == len(ref.feat)
    for i, (a, b) in enumerate(zip(ours.feat, ref.feat)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=f"{label} feat {i}", **MODEL_TOL)


@pytest.mark.parametrize("is_train", [False, True])
def test_model_matches_jax(jax_params, is_train):
    """Both streams, every output, on the same weights and inputs.  Eval
    runs the TRN through its inference op, train through the plain
    differentiable version (dropout is 0, so both are deterministic)."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(3, 5, 32)).astype(np.float32)
    xt = rng.normal(size=(2, 5, 32)).astype(np.float32)
    beta = np.asarray([0.75, 0.75, 0.5], np.float32)
    ref = JaxVideoModel(CFG).apply({"params": jax_params}, jnp.asarray(xs),
                                   jnp.asarray(xt), jnp.asarray(beta),
                                   jnp.asarray(0.0), is_train, False)
    model = VideoModel(CFG)
    model.load_state_dict(state_dict_from_jax_params(jax_params))
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.0, is_train, False)
    for label, a, b in zip(("source", "target"), ours, ref):
        _assert_stream_close(a, b, label)


def test_grl_reverses_domain_head_gradients(jax_params):
    """The domain heads sit behind the GRL: the gradient of the frame
    domain logits with respect to the shared FC equals -beta[2] times the
    plain gradient (checked by flipping beta's sign)."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 5, 32)).astype(np.float32))
    model = VideoModel(CFG)
    model.load_state_dict(state_dict_from_jax_params(jax_params))
    grads = []
    for b2 in (0.5, -0.5):
        model.zero_grad()
        _, out = model(x[:0], x, torch.tensor([0.0, 0.0, b2]), 0.0, True)
        out.pred_domain[2].sum().backward()
        grads.append(model.fc_feature_shared_source.weight.grad.clone())
    torch.testing.assert_close(grads[0], -grads[1])
    assert grads[0].abs().max() > 0


# bfloat16 against bfloat16: both round at their own places (the JAX CPU
# path fuses elementwise ops in float32), so every output within 3e-2 of
# its largest value
BF16_TOL = 3e-2


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("field", ["compute_dtype", "param_dtype"])
@pytest.mark.parametrize("is_train", [False, True])
def test_precision_config_matches_jax(jax_params, field, is_train):
    """compute_dtype bfloat16: both streams' every output has the dtype of
    its JAX counterpart and lies within BF16_TOL of its largest value.
    param_dtype bfloat16, which the JAX package reads nowhere: parameters
    float32 on both sides and the outputs those of the float32 model, at
    MODEL_TOL."""
    import dataclasses
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(3, 5, 32)).astype(np.float32)
    xt = rng.normal(size=(2, 5, 32)).astype(np.float32)
    beta = np.asarray([0.75, 0.75, 0.5], np.float32)
    cfg = dataclasses.replace(CFG, **{field: "bfloat16"})
    jmodel = JaxVideoModel(cfg)
    ref = jmodel.apply({"params": jax_params}, jnp.asarray(xs),
                       jnp.asarray(xt), jnp.asarray(beta), jnp.asarray(0.0),
                       is_train, False)
    model = VideoModel(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax_params))
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.0, is_train, False)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(xs),
                       jnp.asarray(xt), jnp.asarray(beta), jnp.asarray(0.0),
                       False)
    assert {str(v.dtype) for v in jax.tree_util.tree_leaves(init)} == \
        {"float32"}
    if field == "param_dtype":
        for label, a, b in zip(("source", "target"), ours, ref):
            _assert_stream_close(a, b, label)
        return
    for label, a, b in zip(("source", "target"), ours, ref):
        for name, x, y in [("attn", a.attn, b.attn), ("out", a.out, b.out),
                           ("out_2", a.out_2, b.out_2),
                           *((f"pred_domain {i}", x, y) for i, (x, y) in
                             enumerate(zip(a.pred_domain, b.pred_domain))),
                           *((f"feat {i}", x, y) for i, (x, y) in
                             enumerate(zip(a.feat, b.feat)))]:
            assert _dtype_name(x) == str(y.dtype), (label, name)
            want = np.asarray(y, np.float32)
            got = x.detach().float().numpy()
            assert np.abs(got - want).max() <= BF16_TOL * max(
                np.abs(want).max(), 1e-6), (label, name)


@pytest.mark.parametrize("field,value", [("quantize", "int8")])
def test_unported_config_raises(field, value):
    import dataclasses
    cfg = dataclasses.replace(CFG, **{field: value})
    with pytest.raises(NotImplementedError, match=f"{field}=.*ROADMAP"):
        VideoModel(cfg)
