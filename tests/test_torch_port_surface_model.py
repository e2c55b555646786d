"""PyTorch port, the model surface beyond the flagship: avgpool, the
single-scale TRN, no and general attention at both levels, AdaBN and
AutoDIAL, MCD's second classifier, share_params N, stacked shared FCs and
softmax outputs, each against the JAX VideoModel on the same weights and
inputs, every output of both streams, in train and eval mode; the masked
BatchNorm and general attention layers alone; BN running stats after a
forward; and AutoDIAL's routing at a half (CPU, float32, dropout 0).

The configurations (CONFIGS) are the comparison rows that chip_smoke.py
drives on the card, plus trn, add_fc 3, softmax outputs and general
frame attention; tests/test_torch_port_surface_step.py and
tests/test_torch_port_surface_io.py take them from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ta3n_tpu.config import ModelConfig as JaxModelConfig
from ta3n_tpu.config import TrainConfig as JaxTrainConfig
from ta3n_tpu.models import VideoModel as JaxVideoModel
from ta3n_tpu.models.layers import GeneralAttn as JaxGeneralAttn
from ta3n_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from ta3n_tpu.train import create_train_state as jax_create_train_state
from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.convert import state_dict_from_jax_params
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models.layers import GeneralAttn, MaskedBatchNorm

# small widths: 5 segments, 24-d features, fc 16
BASE = dict(num_class=5, baseline_type="video", frame_aggregation="trn-m",
            train_segments=5, val_segments=5, feature_dim=24, fc_dim=16,
            use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
# the published recipe (BASELINE.md:25)
FLAGSHIP_DA = dict(use_target="uSv", adv_DA="RevGrad",
                   add_loss_DA="attentive_entropy",
                   place_adv=("Y", "Y", "Y"))
# name -> (model fields beyond BASE, DAConfig fields)
CONFIGS = {
    "tempooling_source_only": (
        dict(frame_aggregation="avgpool", use_attn="none"),
        dict(use_target="none")),
    "tempooling_revgrad": (
        dict(frame_aggregation="avgpool", use_attn="none"),
        dict(use_target="uSv", adv_DA="RevGrad", place_adv=("N", "N", "Y"))),
    "ta2n": (dict(use_attn="none"), FLAGSHIP_DA),
    "trn_m_general": (dict(use_attn="general", use_attn_frame="TransAttn"),
                      FLAGSHIP_DA),
    "adabn": (dict(use_bn="AdaBN"), FLAGSHIP_DA),
    "autodial": (dict(use_bn="AutoDIAL"), FLAGSHIP_DA),
    "mcd": (dict(ens_DA="MCD"), {**FLAGSHIP_DA, "ens_DA": "MCD"}),
    "share_n": (dict(share_params="N", add_fc=2),
                dict(use_target="Sv", adv_DA="RevGrad",
                     add_loss_DA="target_entropy", pred_normalize="Y",
                     place_adv=("Y", "Y", "Y"))),
    "trn": (dict(frame_aggregation="trn"), FLAGSHIP_DA),
    "add_fc_3": (dict(add_fc=3), FLAGSHIP_DA),
    "softmax": (dict(before_softmax=False), FLAGSHIP_DA),
    "frame_general": (dict(use_attn_frame="general"), FLAGSHIP_DA),
}
B_S, B_T = 6, 5
# AutoDIAL's alpha in the weights: round(6 * 0.75) = round(4.5) = 4 source
# and round(5 * 0.75) = 4 target videos to their own BN, the rest mixed
ALPHA = 0.75
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_port_model.py


def model_fields(name, **over):
    return {**BASE, **CONFIGS[name][0], **over}


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _redraw(tree, rng):
    """Every weight at a trained-like scale, U(±1/sqrt(fan_in)), so that
    no output is near zero or uniform (the normal(0.001) init would make
    most of them so); BN scales in [0.5, 1.5] and biases in ±0.5;
    AutoDIAL's alpha at ALPHA."""
    out = {}
    for name, sub in tree.items():
        if name == "alpha":
            out[name] = np.full(sub.shape, ALPHA, np.float32)
        elif "kernel" in sub:
            bound = 1.0 / np.sqrt(sub["kernel"].shape[0])
            out[name] = {k: _uniform(rng, v.shape, bound)
                         for k, v in sub.items()}
        elif "scale" in sub:
            out[name] = {"scale": rng.uniform(0.5, 1.5, sub["scale"].shape)
                         .astype(np.float32),
                         "bias": _uniform(rng, sub["bias"].shape, 0.5)}
        elif name == "TRN" and "fc_fusion" not in sub:
            out[name] = {}
            for i in range(len(sub) // 2):
                w = sub[f"w_scale_{i}"]
                bound = 1.0 / np.sqrt(w.shape[0])
                out[name][f"w_scale_{i}"] = _uniform(rng, w.shape, bound)
                out[name][f"b_scale_{i}"] = _uniform(rng, (w.shape[1],),
                                                     bound)
        else:  # TRN.fc_fusion, attention MLPs
            out[name] = _redraw(sub, rng)
    return out


def jax_weights(fields, seed=0):
    """(JAX model, params, batch_stats) for the model fields: the JAX init
    redrawn by _redraw, running means in ±0.5 and variances in [0.5, 2]."""
    jmodel = JaxVideoModel(JaxModelConfig(**fields))
    init = jax_create_train_state(jmodel, jax.random.PRNGKey(0), B_S, B_T,
                                  JaxTrainConfig(batch_size=(B_S, B_T, B_S)))
    rng = np.random.default_rng(seed)
    params = _redraw(jax.tree_util.tree_map(np.asarray, init.params), rng)
    stats = {name: {"mean": _uniform(rng, s["mean"].shape, 0.5),
                    "var": rng.uniform(0.5, 2.0, s["var"].shape)
                    .astype(np.float32)}
             for name, s in init.batch_stats.items()}
    return jmodel, params, stats


def port_model(fields, params, stats):
    model = VideoModel(ModelConfig(**fields))
    model.load_state_dict(state_dict_from_jax_params(params, stats))
    return model


def batch(seed, segments=5, d=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B_S, segments, d)).astype(np.float32),
            rng.normal(size=(B_T, segments, d)).astype(np.float32))


def assert_streams_close(ours, ref, label, tol=MODEL_TOL):
    """Every output of the two streams: attn, out, out_2, pred_domain
    (relation, video, frame) and feat."""
    for side, a, b in zip(("source", "target"), ours, ref):
        for field in ("attn", "out", "out_2"):
            np.testing.assert_allclose(
                getattr(a, field).detach().numpy(),
                np.asarray(getattr(b, field)),
                err_msg=f"{label} {side} {field}", **tol)
        for group in ("pred_domain", "feat"):
            got, want = getattr(a, group), getattr(b, group)
            assert len(got) == len(want), (label, side, group)
            for i, (x, y) in enumerate(zip(got, want)):
                np.testing.assert_allclose(
                    x.detach().numpy(), np.asarray(y),
                    err_msg=f"{label} {side} {group}[{i}]", **tol)


def _jax_forward(jmodel, params, stats, xs, xt, beta, is_train, reverse,
                 mask_s=None, mask_t=None):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    kw = {}
    if mask_s is not None:
        kw = dict(mask_source=jnp.asarray(mask_s),
                  mask_target=jnp.asarray(mask_t))
    if stats and is_train:
        return jmodel.apply(variables, jnp.asarray(xs), jnp.asarray(xt),
                            jnp.asarray(beta), jnp.asarray(0.3), True,
                            reverse, mutable=["batch_stats"], **kw)
    return jmodel.apply(variables, jnp.asarray(xs), jnp.asarray(xt),
                        jnp.asarray(beta), jnp.asarray(0.3), is_train,
                        reverse, **kw), None


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, is_train):
    """Both streams, every output, on the same weights and inputs; in
    train mode with a padded video in each stream (the BN statistics
    leave it out) and, for the BN configurations, the running stats after
    the forward."""
    fields = model_fields(name)
    jmodel, params, stats = jax_weights(fields)
    xs, xt = batch(1)
    mask_s, mask_t = np.ones(B_S, np.float32), np.ones(B_T, np.float32)
    mask_s[-1] = mask_t[-1] = 0.0
    masks = (mask_s, mask_t) if is_train else (None, None)
    beta = np.asarray([0.75, 0.5, 0.25], np.float32)
    ref, mut = _jax_forward(jmodel, params, stats, xs, xt, beta, is_train,
                            False, *masks)
    model = port_model(fields, params, stats)
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.3, is_train, False,
                 mask_source=None if masks[0] is None else
                 torch.from_numpy(mask_s),
                 mask_target=None if masks[1] is None else
                 torch.from_numpy(mask_t))
    assert_streams_close(ours, ref, name)
    want_stats = mut["batch_stats"] if mut else stats
    got = model.state_dict()
    for bn, st in want_stats.items():
        for key, ours_key in (("mean", "running_mean"),
                              ("var", "running_var")):
            np.testing.assert_allclose(got[f"{bn}.{ours_key}"].numpy(),
                                       np.asarray(st[key]),
                                       err_msg=f"{bn}.{ours_key}",
                                       **MODEL_TOL)
    if mut and is_train:
        assert not np.allclose(np.asarray(want_stats["bn_shared_T"]["var"]),
                               stats["bn_shared_T"]["var"])


@pytest.mark.parametrize("name", ["mcd", "adabn"])
def test_reverse_forward_matches_jax(name):
    """The MCD step's second forward (GRL(mu) on the video feature) gives
    the same outputs."""
    fields = model_fields(name)
    jmodel, params, stats = jax_weights(fields)
    xs, xt = batch(2)
    beta = np.asarray([0.5, 0.5, 0.5], np.float32)
    ref, _ = _jax_forward(jmodel, params, stats, xs, xt, beta, True, True)
    model = port_model(fields, params, stats)
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.3, True, True)
    assert_streams_close(ours, ref, name)


def test_masked_batchnorm_matches_jax():
    """Per-row statistic weights with zeros (padded rows): the output and
    the running stats after one update, with n = sum(w) in the unbiased
    factor; in eval the running stats; without weights plain BN."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(11, 6)).astype(np.float32) * 3 + 1
    w = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 1], np.float32)
    jbn = JaxMaskedBatchNorm(6)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6)
                            .astype(np.float32),
                            "bias": _uniform(rng, (6,), 0.5)},
                 "batch_stats": {"mean": _uniform(rng, (6,), 0.5),
                                 "var": rng.uniform(0.5, 2, 6)
                                 .astype(np.float32)}}
    bn = MaskedBatchNorm(6)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    for weights in (w, None):
        want = jbn.apply(variables, jnp.asarray(x),
                         None if weights is None else jnp.asarray(weights),
                         use_running_average=True)
        got = bn(torch.from_numpy(x), None if weights is None else
                 torch.from_numpy(weights), use_running_average=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **MODEL_TOL)
        want, mut = jbn.apply(variables, jnp.asarray(x),
                              None if weights is None else
                              jnp.asarray(weights), mutable=["batch_stats"])
        got = bn(torch.from_numpy(x), None if weights is None else
                 torch.from_numpy(weights))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **MODEL_TOL)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(mut["batch_stats"]["mean"]),
                                   **MODEL_TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(mut["batch_stats"]["var"]),
                                   **MODEL_TOL)
        variables = {**variables, "batch_stats": jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"])}
    assert int(bn.num_batches_tracked) == 2
    # the padded rows take no part in the statistics: changing them
    # changes nothing of the real rows' output
    x2 = x.copy()
    x2[w == 0] = 100.0
    bn2 = MaskedBatchNorm(6)
    out1 = bn2(torch.from_numpy(x), torch.from_numpy(w))
    out2 = bn2(torch.from_numpy(x2), torch.from_numpy(w))
    torch.testing.assert_close(out1[w > 0], out2[w > 0])


def test_general_attention_matches_jax():
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(3, 4, 8)).astype(np.float32)
    jattn = JaxGeneralAttn(8)
    params = _redraw(jax.tree_util.tree_map(
        np.asarray, jattn.init(jax.random.PRNGKey(0),
                               jnp.asarray(feat))["params"]), rng)
    want = jattn.apply({"params": params}, jnp.asarray(feat))
    attn = GeneralAttn(8, torch.Generator().manual_seed(0))
    state = state_dict_from_jax_params({"attn_layer": params})
    assert sorted(state) == ["attn_layer.0.bias", "attn_layer.0.weight",
                             "attn_layer.2.bias", "attn_layer.2.weight"]
    attn.load_state_dict({k[len("attn_layer."):]: v
                          for k, v in state.items()})
    got = attn(torch.from_numpy(feat))
    assert got.shape == (3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    np.testing.assert_allclose(got.sum(1).detach().numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("bs,alpha,own", [(6, 0.75, 4), (10, 0.75, 8),
                                          (5, 0.7, 4), (3, 0.5, 2)])
def test_autodial_routing_rounds_half_to_even(bs, alpha, own):
    """round(batch * max(alpha, 0.5)) in float32, half to even as
    jnp.round: 4.5 -> 4, 7.5 -> 8, 3.5 -> 4, 1.5 -> 2; and a forward at
    such a half matches the JAX model."""
    a = torch.tensor(alpha, dtype=torch.float32)
    assert int(torch.round(bs * a.clamp(min=0.5))) == own == \
        int(jnp.round(bs * jnp.maximum(jnp.float32(alpha), 0.5)))
    fields = model_fields("autodial")
    jmodel, params, stats = jax_weights(fields)
    params = {**params, "alpha": np.full((1,), alpha, np.float32)}
    rng = np.random.default_rng(bs)
    xs = rng.normal(size=(bs, 5, 24)).astype(np.float32)
    xt = rng.normal(size=(B_T, 5, 24)).astype(np.float32)
    beta = np.asarray([0.5, 0.5, 0.5], np.float32)
    ref, mut = _jax_forward(jmodel, params, stats, xs, xt, beta, True,
                            False)
    model = port_model(fields, params, stats)
    ours = model(torch.from_numpy(xs), torch.from_numpy(xt),
                 torch.from_numpy(beta), 0.3, True, False)
    assert_streams_close(ours, ref, f"autodial bs={bs}")
    np.testing.assert_allclose(model.bn_shared_S.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn_shared_S"]
                                          ["var"]), **MODEL_TOL)


def test_share_params_n_takes_the_target_layers_for_target_rows():
    """Under share_params N a target video's output does not depend on
    the source layers, and a video fed as the target stream alone gives
    the same output as beside a source stream (eval)."""
    fields = model_fields("share_n")
    _, params, stats = jax_weights(fields)
    model = port_model(fields, params, stats)
    xs, xt = map(torch.from_numpy, batch(5))
    beta = (0.0, 0.0, 0.0)
    _, both = model(xs, xt, beta, 0.0, False)
    _, alone = model(xs[:0], xt, beta, 0.0, False)
    torch.testing.assert_close(both.out, alone.out)
    with torch.no_grad():
        model.fc_feature_shared_source.weight.mul_(2.0)
        model.fc_classifier_video_source.bias.add_(1.0)
    _, changed = model(xs[:0], xt, beta, 0.0, False)
    torch.testing.assert_close(changed.out, alone.out)


def test_more_than_three_shared_layers_are_refused():
    with pytest.raises(ValueError, match="at most 3"):
        VideoModel(ModelConfig(**{**BASE, "add_fc": 4}))
    with pytest.raises(ValueError, match="train_segments == val_segments"):
        VideoModel(ModelConfig(**{**BASE, "frame_aggregation": "trn",
                                  "val_segments": 4}))
    # avgpool runs other segment counts in eval, as the JAX model
    fields = {**model_fields("tempooling_revgrad"), "val_segments": 3}
    jmodel, params, stats = jax_weights(fields)
    x = np.random.default_rng(6).normal(size=(2, 3, 24)).astype(np.float32)
    ref, _ = _jax_forward(jmodel, params, stats, x[:0], x,
                          np.zeros(3, np.float32), False, False)
    model = port_model(fields, params, stats)
    ours = model(torch.from_numpy(x[:0]), torch.from_numpy(x), (0, 0, 0),
                 0.0, False)
    np.testing.assert_allclose(ours[1].out.detach().numpy(),
                               np.asarray(ref[1].out), **MODEL_TOL)
