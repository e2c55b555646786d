"""C3D feature extractor, NCDHW.

Port of `ta3n_tpu/models/backbones/c3d.py` (the reference's extraction
path, video2feature.py:62-78,119-143 over C3D_model.py): 16-frame sliding
clips at 112x112, inputs scaled x255, the conv stack, the channels-first
flatten to 8192, fc6, fc7.

QUIRK (kept by default, ``activations="none"``): the reference builds its
extractor as ``nn.Sequential(*list(model.children())[:-6])`` plus fc6 and
fc7, and the shared ``self.relu`` child is in neither slice, so the
published features come from a conv stack and fc layers with no
nonlinearities (video2feature.py:68-72).  ``activations="relu"`` is the
intended C3D.  Parameter names are the reference's (``conv1`` ...
``conv5b``, ``fc6``, ``fc7``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["C3DFeatures", "C3D_CLIP_SIZE", "clips_from_frames"]

C3D_CLIP_SIZE = 16

_CONVS = [("conv1", 3, 64), ("conv2", 64, 128), ("conv3a", 128, 256),
          ("conv3b", 256, 256), ("conv4a", 256, 512), ("conv4b", 512, 512),
          ("conv5a", 512, 512), ("conv5b", 512, 512)]
# the pool after each of these convs: (kernel = stride, padding)
_POOLS = {"conv1": ((1, 2, 2), 0), "conv2": (2, 0), "conv3b": (2, 0),
          "conv4b": (2, 0), "conv5b": (2, (0, 1, 1))}


class C3DFeatures(nn.Module):
    """[B, 3, 16, 112, 112] clips -> [B, 4096] fc7 features.  ``flat`` is
    fc6's input width, the flatten of conv5b's pooled output: 8192 at
    112x112 clips (a state_dict for smaller clips sets it).  Built
    without initialising its parameters: load a state_dict
    (`from_state_dict`) before use."""

    def __init__(self, activations: str = "none", device="cpu",
                 flat: int = 8192):
        super().__init__()
        if activations not in ("none", "relu"):
            raise ValueError(f"activations={activations!r}: 'none' or "
                             "'relu'")
        self.activations = activations
        with torch.device("meta"):
            for name, cin, cout in _CONVS:
                setattr(self, name, nn.Conv3d(cin, cout, 3, padding=1))
            self.fc6 = nn.Linear(flat, 4096)
            self.fc7 = nn.Linear(4096, 4096)
        self.to_empty(device=device)

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor],
                        activations: str = "none",
                        device="cpu") -> "C3DFeatures":
        """The extractor of a reference C3D state_dict, strictly loaded;
        fc8, the classifier, is left out (extraction never reads it)."""
        model = cls(activations, device, state["fc6.weight"].shape[1])
        model.load_state_dict({k: v for k, v in state.items()
                               if not k.startswith("fc8.")}, strict=True)
        return model.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = torch.relu if self.activations == "relu" else (lambda v: v)
        h = x
        for name, _, _ in _CONVS:
            h = act(getattr(self, name)(h))
            if name in _POOLS:
                k, pad = _POOLS[name]
                h = F.max_pool3d(h, k, k, pad)
        h = h.reshape(h.shape[0], -1)          # channels first, as torch
        return act(self.fc7(act(self.fc6(h))))


def clips_from_frames(frames: np.ndarray) -> np.ndarray:
    """[T, 112, 112, 3] frames -> [T-15, 16, 112, 112, 3] sliding clips,
    scaled x255 (video2feature.py:135-143)."""
    t = frames.shape[0]
    n = t - C3D_CLIP_SIZE + 1
    if n <= 0:
        raise ValueError(f"need >= {C3D_CLIP_SIZE} frames, got {t}")
    idx = np.arange(C3D_CLIP_SIZE)[None, :] + np.arange(n)[:, None]
    return frames[idx] * 255.0
