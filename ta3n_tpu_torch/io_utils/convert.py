"""Weights for the port's `VideoModel`: from the JAX package's parameter
tree, or from a reference-format ``.pth.tar``.

The port's modules carry the reference ``state_dict`` names
(models.py:58-325), which are also what
`ta3n_tpu/io_utils/torch_export.py` writes.  Two ways in:

  * ``state_dict_from_jax_params`` maps the JAX parameter tree (numpy
    leaves) onto those names, as `torch_export.export_state_dict` does for
    the flagship's layers (`torch_export.py:41-125`): Dense kernels
    ``[in, out]`` become Linear weights ``[out, in]``
    (`torch_export.py:37`).  Only live parameters come out.
  * ``load_reference_checkpoint`` reads a reference-format ``.pth.tar``
    (the original code's, or one written by
    ``python -m ta3n_tpu.cli.export_checkpoint``), strips the DataParallel
    ``module.`` prefix, drops the reference's dead parameters and
    strict-loads the rest.

The JAX trainer's own checkpoints are orbax directories, which the port
cannot read: export them to ``.pth.tar`` first.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models.video_model import VideoModel

__all__ = ["state_dict_from_jax_params", "reference_state_dict",
           "load_reference_checkpoint", "DEAD_PREFIXES"]

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

# the flagship's plain Dense layers: JAX name == reference module name
_DENSE = (
    "fc_feature_shared_source", "fc_classifier_source",
    "fc_feature_domain", "fc_classifier_domain",
    "fc_classifier_video_source",
    "fc_feature_domain_video", "fc_classifier_domain_video",
)

_EXPORT_HINT = ("python -m ta3n_tpu.cli.export_checkpoint DIR out.pth.tar")


def _linear(out: Dict[str, torch.Tensor], name: str, kernel, bias) -> None:
    out[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(kernel, np.float32).T))
    out[f"{name}.bias"] = torch.from_numpy(
        np.array(bias, np.float32, copy=True))


def state_dict_from_jax_params(params: Mapping[str, Any],
                               batch_stats: Optional[Mapping] = None
                               ) -> Dict[str, torch.Tensor]:
    """JAX flagship parameter tree -> the port's ``state_dict``.

    Raises KeyError for a parameter collection the port has no module for,
    and NotImplementedError for BN statistics (no BN in the flagship).
    """
    if batch_stats:
        raise NotImplementedError(
            "BN statistics are not ported yet (ROADMAP.md queue 1, item 6: "
            "AdaBN and AutoDIAL)")
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for name in _DENSE:
        if name in params:
            _linear(out, name, params[name]["kernel"], params[name]["bias"])
            consumed.add(name)
    if "TRN" in params:  # multi-scale (TRNmodule.py:45-54)
        trn = params["TRN"]
        n = 0
        while f"w_scale_{n}" in trn:
            _linear(out, f"TRN.fc_fusion_scales.{n}.1", trn[f"w_scale_{n}"],
                    trn[f"b_scale_{n}"])
            n += 1
        extra = set(trn) - {f"{p}_scale_{i}" for p in "wb" for i in range(n)}
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
    extra = set(params) - consumed
    if extra:
        raise KeyError(f"no port module for JAX parameters {sorted(extra)}")
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
    state = ckpt.get("state_dict", ckpt)
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    return {k: v for k, v in state.items()
            if not k.startswith(DEAD_PREFIXES)}


def load_reference_checkpoint(path: str, model_cfg: ModelConfig,
                              device="cuda") -> VideoModel:
    """A `VideoModel` for ``model_cfg`` holding the weights of the
    reference-format ``.pth.tar`` at ``path`` (strict load), on
    ``device``: the card by default, as the port's other entry points;
    CPU callers pass ``device="cpu"``."""
    state = reference_state_dict(path)
    # its own generator: the init is overwritten, and the global RNG stays
    model = VideoModel(model_cfg, torch.Generator(), device)
    model.load_state_dict(state, strict=True)
    return model
