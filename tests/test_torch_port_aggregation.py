"""PyTorch port, the model surface that PR 8 adds: RNN aggregation (LSTM
and GRU, one or two directions, one or two layers, n_ts chunks that
truncate or repeat the last frame), temconv aggregation with and without
AdaBN, and the frame and tsn baselines, each against the JAX VideoModel on
the same weights and inputs: every output of both streams (feat too), in
train and eval mode, and the gradients of every parameter of a loss over
them (torch.autograd against jax.grad); the TCL and the RNN's chunking
alone (CPU, float32, dropout 0).

The configurations (CONFIGS) are the rows that chip_smoke.py adds, at
narrow widths; tests/test_torch_port_da_steps.py and
tests/test_torch_port_pretrain_io.py take them and the helpers from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_surface_model import (B_S, B_T, BASE, FLAGSHIP_DA,
                                           MODEL_TOL, _redraw, _uniform,
                                           assert_streams_close)
from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.models.layers import TCL as JaxTCL
from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models.layers import TCL
from ta3n_tpu_torch.models.rnn import chunk_frames

GRAD_TOL = dict(rtol=1e-3, atol=2e-5)    # tests/test_torch_port_train.py
# a model's gradients: GRAD_TOL's rtol, and an atol of GRAD_ATOL times the
# largest |gradient| of the model.  The loss below sums every output, so
# gradients reach ~1e2-1e3, and an entry that is a sum of such terms
# cancelling to near zero (a bias before a BatchNorm, which removes its
# shift, is zero in exact arithmetic) carries float32 rounding of up to
# ~2e-6 of that scale on either side
GRAD_ATOL = 1e-5
AVGPOOL = dict(frame_aggregation="avgpool", use_attn="none")
REVGRAD_NYY = dict(use_target="uSv", adv_DA="RevGrad",
                   place_adv=("N", "Y", "Y"))
# name -> (model fields beyond BASE, DAConfig fields): chip_smoke.py's
# rows of this slice
CONFIGS = {
    "tempooling_dan": (AVGPOOL, dict(use_target="uSv", dis_DA="DAN",
                                     place_dis=("Y", "Y", "N"))),
    "tempooling_jan": (AVGPOOL, dict(use_target="uSv", dis_DA="JAN")),
    "ta3n_dan_all": ({}, {**FLAGSHIP_DA, "dis_DA": "DAN",
                          "place_dis": ("Y", "Y", "Y")}),
    "ta3n_coral_all": ({}, {**FLAGSHIP_DA, "dis_DA": "CORAL",
                            "place_dis": ("Y", "Y", "Y")}),
    "rnn_bilstm": (dict(frame_aggregation="rnn", rnn_cell="LSTM", n_rnn=2,
                        n_directions=2, n_ts=3, use_attn="none"),
                   REVGRAD_NYY),
    "rnn_gru": (dict(frame_aggregation="rnn", rnn_cell="GRU", n_ts=2,
                     use_attn="none"), REVGRAD_NYY),
    "temconv_adabn": (dict(frame_aggregation="temconv", use_bn="AdaBN",
                           use_attn="none"), REVGRAD_NYY),
    "frame_ta3n": (dict(baseline_type="frame"), FLAGSHIP_DA),
    "tsn_tempooling": (dict(baseline_type="tsn", **AVGPOOL),
                       dict(use_target="uSv", adv_DA="RevGrad",
                            place_adv=("N", "N", "Y"))),
}


def model_fields(name, **over):
    return {**BASE, **CONFIGS[name][0], **over} if name in CONFIGS \
        else {**BASE, **over}


def redraw(tree, rng):
    """`_redraw` of tests/test_torch_port_surface_model.py, and the RNN's
    weights and biases at torch's RNN scale, U(±1/sqrt(hidden))."""
    out = {k: v for k, v in tree.items() if k != "rnn"}
    out = _redraw(out, rng)
    if "rnn" in tree:
        hidden = tree["rnn"]["weight_hh_l0"].shape[0]
        out["rnn"] = {k: _uniform(rng, v.shape, 1.0 / np.sqrt(hidden))
                      for k, v in tree["rnn"].items()}
    return out


def jax_weights(fields, seed=0):
    """(JAX model, params, batch_stats) for the model fields, redrawn,
    running means in ±0.5 and variances in [0.5, 2]."""
    jmodel = JaxVideoModel(JaxModelConfig(**fields))
    init_params, init_stats = jax_init(jmodel)
    rng = np.random.default_rng(seed)
    params = redraw(init_params, rng)
    stats = {name: {"mean": _uniform(rng, s["mean"].shape, 0.5),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape)
                    .astype(np.float32)}
             for name, s in init_stats.items()}
    return jmodel, params, stats


def port_model(fields, params, stats):
    model = VideoModel(ModelConfig(**fields))
    model.load_state_dict(state_dict_from_jax_params(params, stats))
    return model


def jax_init(jmodel):
    """Zero arrays in the shapes of the JAX model's parameters and BN
    statistics (traced, not run: the values are redrawn anyway)."""
    cfg = jmodel.cfg
    shape = (cfg.train_segments, cfg.input_feature_dim)

    def init(key):
        return jmodel.init({"params": key, "dropout": key},
                           jnp.zeros((B_S, *shape)), jnp.zeros((B_T, *shape)),
                           jnp.zeros(3), jnp.asarray(0.0), True, False)

    variables = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(init, jax.random.PRNGKey(0)))
    return variables["params"], variables.get("batch_stats", {})


def batch(seed, segments=5, d=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B_S, segments, d)).astype(np.float32),
            rng.normal(size=(B_T, segments, d)).astype(np.float32))


# RNN: for each cell, one and two directions, one and two layers, and n_ts
# of each kind (5 segments: n_ts 2 gives round(2.5) = 2 frames a chunk,
# half to even, and drops the last frame; 3 gives round(1.67) = 2 and
# repeats it; 5 one frame a chunk)
RNN_CASES = [dict(rnn_cell=c, n_directions=d, n_rnn=n, n_ts=t)
             for c in ("LSTM", "GRU")
             for d, n, t in ((1, 1, 2), (2, 2, 3), (1, 2, 5), (2, 1, 2))]
AGG_CASES = {
    **{f"rnn-{c['rnn_cell']}-dir{c['n_directions']}-layers{c['n_rnn']}"
       f"-nts{c['n_ts']}": dict(frame_aggregation="rnn", use_attn="none",
                                **c) for c in RNN_CASES},
    "temconv": dict(frame_aggregation="temconv", use_attn="none"),
    "temconv-adabn": dict(frame_aggregation="temconv", use_attn="none",
                          use_bn="AdaBN"),
    "temconv-autodial-add_fc2": dict(frame_aggregation="temconv",
                                     use_attn="none", use_bn="AutoDIAL",
                                     add_fc=2),
    "frame-trn-m": dict(baseline_type="frame"),
    "frame-avgpool-mcd-softmax": dict(baseline_type="frame", ens_DA="MCD",
                                      before_softmax=False, **AVGPOOL),
    "tsn-avgpool": dict(baseline_type="tsn", **AVGPOOL),
    "tsn-trn-m-share_n": dict(baseline_type="tsn", share_params="N"),
}


def _loss_of(outs, lib):
    """A scalar that every output of both streams feeds, each term
    weighted differently."""
    total = 0.0
    for i, o in enumerate(outs):
        for j, t in enumerate((o.out, o.out_2, *o.pred_domain, *o.feat)):
            total = total + (i + 1) * (j + 1) * lib.sin(t).sum()
    return total


@pytest.mark.parametrize("name", sorted(AGG_CASES))
def test_forward_and_gradients_match_jax(name):
    """Both streams, every output, in eval and in train mode (a padded
    video in each stream, left out of the BN statistics); the gradient of
    every parameter of a loss over the train-mode outputs."""
    fields = {**BASE, **AGG_CASES[name]}
    jmodel, params, stats = jax_weights(fields)
    xs, xt = batch(1)
    mask_s, mask_t = np.ones(B_S, np.float32), np.ones(B_T, np.float32)
    mask_s[-1] = mask_t[-1] = 0.0
    beta = np.asarray([0.75, 0.5, 0.25], np.float32)
    model = port_model(fields, params, stats)
    masks = dict(mask_source=jnp.asarray(mask_s),
                 mask_target=jnp.asarray(mask_t)) if stats else {}

    def apply(p, is_train):
        variables = {"params": p, **({"batch_stats": stats} if stats
                                     else {})}
        outs = jmodel.apply(variables, jnp.asarray(xs), jnp.asarray(xt),
                            jnp.asarray(beta), jnp.asarray(0.3), is_train,
                            False, mutable=["batch_stats"] if stats and
                            is_train else False, **(masks if is_train
                                                    else {}))
        return outs[0] if stats and is_train else outs

    @jax.jit  # one compile for both modes and the gradients
    def reference(p):
        def jloss(p):
            outs = apply(p, True)
            return _loss_of(outs, jnp), outs
        return apply(p, False), jax.value_and_grad(jloss, has_aux=True)(p)

    ref_eval, ((_, ref), jgrads) = reference(
        jax.tree_util.tree_map(jnp.asarray, params))
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.3, False, False)
    assert_streams_close(ours, ref_eval, f"{name} eval")
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.3, True, False,
                 mask_source=torch.from_numpy(mask_s) if stats else None,
                 mask_target=torch.from_numpy(mask_t) if stats else None)
    assert_streams_close(ours, ref, f"{name} train")
    _loss_of(ours, torch).backward()
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jgrads))
    atol = GRAD_ATOL * max(v.abs().max().item() for v in want.values())
    for key, p in model.named_parameters():
        # a parameter that no output reaches has no gradient here and a
        # zero one in JAX
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), want[key].numpy(),
                                   rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=f"{name} d/d{key}")


@pytest.mark.parametrize("segments,n_ts,want", [
    (5, 2, [[0, 1], [2, 3]]),             # round(2.5) = 2: last dropped
    (7, 2, [[0, 1, 2, 3], [4, 5, 6, 6]]),  # round(3.5) = 4: last repeated
    (5, 3, [[0, 1], [2, 3], [4, 4]]),
    (4, 5, [[0], [1], [2], [3], [3]]),    # round(0.8) = 1
    (6, 4, [[0, 1], [2, 3], [4, 5], [5, 5]])])  # round(1.5) = 2
def test_chunk_frames_rounds_half_to_even(segments, n_ts, want):
    """The chunk of each kept frame, as the JAX aggregator builds it, and
    the gradient of a max shared between tied frames as jnp.max shares
    it (the repeated last frame ties with itself)."""
    x = torch.arange(segments, dtype=torch.float32)[None, :, None] \
        .repeat(1, 1, 2).requires_grad_()
    got = chunk_frames(x, n_ts)
    assert got[0, :, 0].tolist() == [float(max(c)) for c in want]
    y = jnp.asarray(x.detach().numpy())
    jgrad = jax.grad(lambda v: jnp.sum(jnp.stack(
        [jnp.max(v[0, jnp.asarray(c)], axis=0) for c in want]) * 1.0))(y)
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad) * 1.0,
                               atol=0)


def test_tcl_matches_jax():
    """The TCL alone: Conv2d(1, 1, (3, 1)) over the segment axis with the
    flax kernel carried across, output and gradients."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 6, 7)).astype(np.float32)
    jtcl = JaxTCL(3)
    params = redraw(jax.tree_util.tree_map(
        np.asarray, jtcl.init(jax.random.PRNGKey(0),
                              jnp.asarray(x[..., None]))["params"]), rng)

    def jf(p, v):
        return jtcl.apply({"params": p}, v[..., None])[..., 0]

    want = jf(params, jnp.asarray(x))
    tcl = TCL(3, torch.Generator().manual_seed(0))
    state = state_dict_from_jax_params({"tcl_3_1": params})
    tcl.load_state_dict({k[len("tcl_3_1."):]: v for k, v in state.items()})
    xt = torch.from_numpy(x).requires_grad_()
    got = tcl(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    jgx, jgp = jax.grad(lambda v, p: jnp.sum(jnp.sin(jf(p, v))),
                        argnums=(0, 1))(jnp.asarray(x), params)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               **GRAD_TOL)
    gstate = state_dict_from_jax_params({"tcl_3_1": jgp})
    np.testing.assert_allclose(tcl.conv2d.weight.grad.numpy(),
                               gstate["tcl_3_1.conv2d.weight"].numpy(),
                               **GRAD_TOL)
    np.testing.assert_allclose(tcl.conv2d.bias.grad.numpy(),
                               gstate["tcl_3_1.conv2d.bias"].numpy(),
                               **GRAD_TOL)


def test_new_modules_init_without_the_global_rng():
    """The RNN and the TCL draw their init from the model's generator: the
    same seed gives the same weights, and torch's global RNG is left
    where it was."""
    fields = {**BASE, **AGG_CASES["rnn-LSTM-dir2-layers2-nts3"]}
    state = torch.get_rng_state()
    a = VideoModel(ModelConfig(**fields), torch.Generator().manual_seed(4))
    b = VideoModel(ModelConfig(**fields), torch.Generator().manual_seed(4))
    assert torch.equal(state, torch.get_rng_state())
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert "rnn.weight_ih_l1_reverse" in a.state_dict()
    c = VideoModel(ModelConfig(**{**BASE, **AGG_CASES["temconv"]}),
                   torch.Generator().manual_seed(4))
    assert c.tcl_3_1.conv2d.weight.shape == (1, 1, 3, 1)
    assert torch.equal(state, torch.get_rng_state())
