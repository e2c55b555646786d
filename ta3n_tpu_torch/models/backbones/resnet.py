"""ResNet v1 feature extractors (resnet18/34/50/101/152), NCHW.

Port of `ta3n_tpu/models/backbones/resnet.py` (the reference's
torchvision backbone with its final fc popped, video2feature.py:81-88:
the features are the global average of conv5's output).  The module
has torchvision's layout and parameter names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, ...), so the torchvision
state_dict that the JAX package imports (``import_torch_resnet``) loads
here as it is: it carries the weights between the two packages.

Inference only: every BN normalises with its running statistics, in
train mode too (extraction runs the backbone in eval mode,
video2feature.py:76,88).  The convolutions are cuDNN's, as the JAX
package leaves them to XLA; the extractor runs them with cuDNN's TF32
off (`prep/video2feature.py`).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["ResNetFeatures", "RESNET_SPECS", "resnet_feature_dim"]

# (block type, blocks per stage); torchvision's resnet definitions
RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def resnet_feature_dim(arch: str) -> int:
    block, _ = RESNET_SPECS[arch]
    return 512 if block == "basic" else 2048


class _FrozenBN(nn.BatchNorm2d):
    """BatchNorm2d (torchvision's names) on its running statistics
    always: (x - mean) * rsqrt(var + 1e-5) * weight + bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class _Block(nn.Module):
    """torchvision's BasicBlock (two 3x3 convs) or Bottleneck (1x1, 3x3
    with the stride, 1x1 to 4x the width), with a strided 1x1 conv + BN
    ``downsample`` where the shape changes."""

    def __init__(self, kind: str, cin: int, width: int, stride: int):
        super().__init__()
        out = width if kind == "basic" else width * 4
        if kind == "basic":
            shapes = [(cin, width, 3, stride), (width, width, 3, 1)]
        else:
            shapes = [(cin, width, 1, 1), (width, width, 3, stride),
                      (width, out, 1, 1)]
        self.n = len(shapes)
        for i, (ci, co, k, s) in enumerate(shapes, 1):
            setattr(self, f"conv{i}", _conv(ci, co, k, s))
            setattr(self, f"bn{i}", _FrozenBN(co))
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride),
                                         _FrozenBN(out))
                           if stride != 1 or cin != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(1, self.n + 1):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            if i < self.n:
                h = torch.relu(h)
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class ResNetFeatures(nn.Module):
    """[B, 3, H, W] (224x224 for extraction) -> [B, feature_dim] pooled
    features.  Built without initialising its parameters (no draw from
    torch's RNG): load a state_dict (`from_state_dict`) before use."""

    def __init__(self, arch: str = "resnet101", device="cpu"):
        super().__init__()
        kind, counts = RESNET_SPECS[arch]
        expansion = 1 if kind == "basic" else 4
        with torch.device("meta"):
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = _FrozenBN(64)
            cin, width = 64, 64
            for stage, n in enumerate(counts, 1):
                blocks = []
                for b in range(n):
                    stride = 2 if stage > 1 and b == 0 else 1
                    blocks.append(_Block(kind, cin, width, stride))
                    cin = width * expansion
                setattr(self, f"layer{stage}", nn.Sequential(*blocks))
                width *= 2
        self.to_empty(device=device)
        self.arch = arch

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor],
                        arch: str, device="cpu") -> "ResNetFeatures":
        """The extractor of a torchvision-format state_dict, strictly
        loaded; the classifier ``fc.*`` that torchvision's files carry is
        left out, as the reference pops it.  BN batch counts missing from
        the state_dict are set to 0."""
        model = cls(arch, device)
        state = {k: v for k, v in state.items() if not k.startswith("fc.")}
        for name, buf in model.named_buffers():
            if name.endswith("num_batches_tracked"):
                state.setdefault(name, torch.zeros_like(buf))
        model.load_state_dict(state, strict=True)
        return model.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return h.mean(dim=(2, 3))
