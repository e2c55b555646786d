"""Weights for the port's `VideoModel`: from the JAX package's parameter
tree, from a reference-format ``.pth.tar``, and back to the reference's
layout.

The port's modules carry the reference ``state_dict`` names
(models.py:58-325), which are also what
`ta3n_tpu/io_utils/torch_export.py` writes.  Two ways in:

  * ``state_dict_from_jax_params`` maps the JAX parameter tree (numpy
    leaves) and its BN statistics onto those names, as
    `torch_export.export_state_dict` does (`torch_export.py:41-125`):
    Dense kernels ``[in, out]`` become Linear weights ``[out, in]``
    (`torch_export.py:37`), the RNN's ``[in, G*H]`` weights are
    transposed, the TCL's flax kernel ``[k, 1, in, out]`` becomes the
    Conv2d weight ``[out, in, k, 1]``.  Only live parameters come out.
  * ``load_reference_checkpoint`` reads a reference-format ``.pth.tar``
    (the original code's, or one written by
    ``python -m ta3n_tpu.cli.export_checkpoint``), strips the DataParallel
    ``module.`` prefix, drops the reference's dead parameters and
    strict-loads the rest (temconv's ``bn_1`` pair counts as dead without
    AdaBN/AutoDIAL, whose ``bn_shared`` pair the checkpoint then lacks).

One way out: ``export_reference_state`` gives a model's state in the
layout the export writes, dead parameters included, so the Trainer's
checkpoints strict-load into the reference and import into the JAX
package.  The JAX trainer's own checkpoints are orbax directories, which
the port cannot read: export them to ``.pth.tar`` first.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models.video_model import VideoModel

__all__ = ["state_dict_from_jax_params", "reference_state_dict",
           "load_reference_checkpoint", "export_reference_state",
           "live_state",
           "DEAD_PREFIXES"]

# reference parameters that exist but never take part in the forward pass
# (a copy of `ta3n_tpu/io_utils/torch_import.py::_DEAD_PREFIXES`, whose
# package imports orbax; tests hold the two equal)
DEAD_PREFIXES = (
    "fc_feature_source.", "fc_feature_target.",
    "fc_feature_video_source.", "fc_feature_video_source_2.",
    "fc_feature_video_target.", "fc_feature_video_target_2.",
    "bn_trn_S.", "bn_trn_T.",
    "tcl_3_2.", "tcl_5_1.", "tcl_5_2.", "conv_fusion.",
    "bn_2_S.", "bn_2_T.",
    "bn_before_rnn.", "bn_after_rnn.",
    "bn_source_S.", "bn_source_T.",
    "bn_source_video_S.", "bn_source_video_T.",
    "bn_source_video_2_S.", "bn_source_video_2_T.",
)

# plain Dense layers: JAX name == reference module name (a copy of
# `ta3n_tpu/io_utils/torch_import.py::_DENSE_DIRECT`)
_DENSE = (
    "fc_feature_shared_source", "fc_feature_shared_2_source",
    "fc_feature_shared_3_source", "fc_feature_shared_target",
    "fc_feature_shared_2_target", "fc_feature_shared_3_target",
    "fc_classifier_source", "fc_classifier_target",
    "fc_feature_domain", "fc_classifier_domain",
    "fc_feature_domain_video", "fc_classifier_domain_video",
    "fc_classifier_video_source", "fc_classifier_video_source_2",
    "fc_classifier_video_target", "fc_classifier_video_target_2",
)
# BN pairs of AdaBN/AutoDIAL: after the first shared FC and, in temconv,
# after the TCL (a copy of `torch_import.py::_BN_DIRECT`)
_BN = ("bn_shared_S", "bn_shared_T", "bn_1_S", "bn_1_T")
# general-attention MLPs: JAX name -> the port's module; attn_layer_frame
# has no reference name (`ta3n_tpu/io_utils/torch_export.py` raises on it)
_ATTN = ("attn_layer", "attn_layer_frame")

_EXPORT_HINT = ("python -m ta3n_tpu.cli.export_checkpoint DIR out.pth.tar")


def _tensor(a) -> torch.Tensor:
    """A contiguous float32 copy of an array."""
    return torch.tensor(np.asarray(a, np.float32))


def _linear(out: Dict[str, torch.Tensor], name: str, kernel, bias) -> None:
    out[f"{name}.weight"] = _tensor(np.asarray(kernel).T)
    out[f"{name}.bias"] = _tensor(bias)


def state_dict_from_jax_params(params: Mapping[str, Any],
                               batch_stats: Optional[Mapping] = None
                               ) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (and BN ``batch_stats``) -> the port's
    ``state_dict``, under the names that `ta3n_tpu/io_utils/
    torch_export.py` gives them (its export without the dead
    parameters), and ``attn_layer_frame.{0,2}``, which the export
    refuses.

    Raises KeyError for a parameter collection the port has no module
    for, and for statistics of a BN that ``params`` lacks.
    """
    batch_stats = dict(batch_stats or {})
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for name in _DENSE:
        if name in params:
            _linear(out, name, params[name]["kernel"], params[name]["bias"])
            consumed.add(name)
    for name in _BN:
        if name in params:
            stats = batch_stats.pop(name, {})
            out[f"{name}.weight"] = _tensor(params[name]["scale"])
            out[f"{name}.bias"] = _tensor(params[name]["bias"])
            out[f"{name}.running_mean"] = _tensor(
                stats.get("mean", np.zeros_like(params[name]["scale"])))
            out[f"{name}.running_var"] = _tensor(
                stats.get("var", np.ones_like(params[name]["scale"])))
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
            consumed.add(name)
    if batch_stats:
        raise KeyError(f"BN statistics without parameters: "
                       f"{sorted(batch_stats)}")
    if "alpha" in params:  # AutoDIAL (models.py:314-316)
        out["alpha"] = _tensor(params["alpha"]).reshape(())
        consumed.add("alpha")
    if "TRN" in params:
        trn = params["TRN"]
        n = 0
        while f"w_scale_{n}" in trn:  # multi-scale (TRNmodule.py:45-54)
            _linear(out, f"TRN.fc_fusion_scales.{n}.1", trn[f"w_scale_{n}"],
                    trn[f"b_scale_{n}"])
            n += 1
        known = {f"{p}_scale_{i}" for p in "wb" for i in range(n)}
        if "fc_fusion" in trn:  # single-scale (TRNmodule.py:16-21)
            _linear(out, "TRN.classifier.1", trn["fc_fusion"]["kernel"],
                    trn["fc_fusion"]["bias"])
            known.add("fc_fusion")
        extra = set(trn) - known
        if extra:
            raise KeyError(f"no port module for JAX TRN parameters {extra}")
        consumed.add("TRN")
    i = 0
    while f"relation_domain_fc1_{i}" in params:  # models.py:287-294
        for jax_name, slot in ((f"relation_domain_fc1_{i}", 0),
                               (f"relation_domain_fc2_{i}", 2)):
            _linear(out, f"relation_domain_classifier_all.{i}.{slot}",
                    params[jax_name]["kernel"], params[jax_name]["bias"])
            consumed.add(jax_name)
        i += 1
    for name in _ATTN:  # models.py:320-325
        if name in params:
            for jax_name, slot in (("attn_fc1", 0), ("attn_fc2", 2)):
                _linear(out, f"{name}.{slot}", params[name][jax_name]["kernel"],
                        params[name][jax_name]["bias"])
            consumed.add(name)
    if "tcl_3_1" in params:  # flax [k, 1, in, out] -> torch [out, in, k, 1]
        conv = params["tcl_3_1"]["Conv_0"]
        out["tcl_3_1.conv2d.weight"] = _tensor(
            np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        out["tcl_3_1.conv2d.bias"] = _tensor(conv["bias"])
        consumed.add("tcl_3_1")
    if "rnn" in params:  # torch's names; weights stored [in, G*H]
        for name, v in params["rnn"].items():
            out[f"rnn.{name}"] = _tensor(np.asarray(v).T
                                         if name.startswith("weight_")
                                         else v)
        consumed.add("rnn")
    extra = set(params) - consumed
    if extra:
        raise KeyError(f"no port module for JAX parameters {sorted(extra)}")
    return out


def export_reference_state(model: VideoModel) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` on the CPU in the reference's layout, as
    `ta3n_tpu/io_utils/torch_export.py::export_state_dict` writes it: the
    live parameters and BN statistics, plus the reference's dead modules
    (models.py:150-200, 214-243, 309-312), which its strict load needs,
    BNs at their init values, Linears and convs zeroed.  Raises KeyError, as the
    export does, for a module the reference has no name for
    (``attn_layer_frame``)."""
    out = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for key in out:
        if key.startswith("attn_layer_frame."):
            raise KeyError("no reference mapping for param collection "
                           "'attn_layer_frame' (the reference has no "
                           "general frame attention, models.py:369)")

    def dead_linear(name, like):
        out[f"{name}.weight"] = torch.zeros_like(like)
        out[f"{name}.bias"] = torch.zeros(like.shape[0])

    def dead_bn(name, dim):
        out.update({f"{name}.weight": torch.ones(dim),
                    f"{name}.bias": torch.zeros(dim),
                    f"{name}.running_mean": torch.zeros(dim),
                    f"{name}.running_var": torch.ones(dim),
                    f"{name}.num_batches_tracked": torch.tensor(0)})

    def dead_conv(name, c_out, c_in, k):
        out[f"{name}.weight"] = torch.zeros(c_out, c_in, k, 1)
        out[f"{name}.bias"] = torch.zeros(c_out)

    trn_bias = out.get("TRN.classifier.1.bias",
                       out.get("TRN.fc_fusion_scales.0.1.bias"))
    if trn_bias is not None:  # models.py:217-226
        for s in "ST":
            dead_bn(f"bn_trn_{s}", trn_bias.shape[0])
    if "rnn.weight_ih_l0" in out:  # BatchNorm2d(1) pair, models.py:214-215
        dead_bn("bn_before_rnn", 1)
        dead_bn("bn_after_rnn", 1)
    if "tcl_3_1.conv2d.weight" in out:  # models.py:228-243
        frame = out["fc_classifier_source.weight"].shape[1]
        dead_conv("tcl_5_1.conv2d", 1, 1, 5)
        dead_conv("tcl_3_2.conv2d", 1, 1, 3)
        dead_conv("tcl_5_2.conv2d", 2, 2, 5)
        dead_conv("conv_fusion.0", 1, 2, 1)
        for s in "ST":
            dead_bn(f"bn_2_{s}", frame)
            if f"bn_1_{s}.weight" not in out:  # live only under BN
                dead_bn(f"bn_1_{s}", frame)
    if "bn_shared_S.weight" in out:  # models.py:198-199, 309-312
        shared = out["bn_shared_S.weight"].shape[0]
        video = out["fc_classifier_video_source.weight"].shape[1]
        for s in "ST":
            dead_bn(f"bn_source_{s}", shared)
            dead_bn(f"bn_source_video_{s}", video)
            dead_bn(f"bn_source_video_2_{s}", video)
    domains = ("source", "target") if "fc_classifier_target.weight" in out \
        else ("source",)
    square = out["fc_feature_domain_video.weight"]
    square = torch.zeros(square.shape[0], square.shape[0])
    for dom in domains:  # models.py:150-192
        dead_linear(f"fc_feature_{dom}", out["fc_feature_domain.weight"])
        dead_linear(f"fc_feature_video_{dom}",
                    out["fc_feature_domain_video.weight"])
        dead_linear(f"fc_feature_video_{dom}_2", square)
    return out


def reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-format ``.pth.tar``: its ``state_dict`` without
    the ``module.`` prefix and without the dead parameters."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, and the port reads reference-format "
            f".pth.tar files only.  Export a JAX checkpoint directory with "
            f"`{_EXPORT_HINT}` and pass out.pth.tar")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return live_state(ckpt.get("state_dict", ckpt))


def live_state(state: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """A reference-format ``state_dict`` without the DataParallel
    ``module.`` prefix and without the dead parameters: what the port's
    model strict-loads."""
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    dead = DEAD_PREFIXES
    if "bn_shared_S.weight" not in state:
        # temconv builds its bn_1 pair whatever use_bn says, and runs it
        # only under AdaBN/AutoDIAL (models.py:232-233, 662-663), as
        # `ta3n_tpu/io_utils/torch_import.py` reads it
        dead += ("bn_1_S.", "bn_1_T.")
    return {k: v for k, v in state.items() if not k.startswith(dead)}


def load_reference_checkpoint(path: str, model_cfg: ModelConfig,
                              device="cuda") -> VideoModel:
    """A `VideoModel` for ``model_cfg`` holding the weights of the
    reference-format ``.pth.tar`` at ``path`` (strict load), on
    ``device``: the card by default, as the port's other entry points;
    CPU callers pass ``device="cpu"``.  A checkpoint that holds MCD's
    second video classifier loads into a model that has one, whatever
    ``model_cfg.ens_DA`` says: the eval CLIs have no flag for it, and
    the outputs that evaluation reads do not depend on it."""
    state = reference_state_dict(path)
    if "fc_classifier_video_source_2.weight" in state:
        model_cfg = dataclasses.replace(model_cfg, ens_DA="MCD")
    # its own generator: the init is overwritten, and the global RNG stays
    model = VideoModel(model_cfg, torch.Generator(), device)
    model.load_state_dict(state, strict=True)
    return model
