"""Frozen backbones of the feature extractor (`prep/video2feature.py`):
ResNet v1 (18/34/50/101/152) and C3D, loading torchvision-format and
reference-format state_dicts under their own names."""

from ta3n_tpu_torch.models.backbones.c3d import (C3D_CLIP_SIZE,
                                                 C3DFeatures,
                                                 clips_from_frames)
from ta3n_tpu_torch.models.backbones.resnet import (RESNET_SPECS,
                                                    ResNetFeatures,
                                                    resnet_feature_dim)

__all__ = ["ResNetFeatures", "RESNET_SPECS", "resnet_feature_dim",
           "C3DFeatures", "C3D_CLIP_SIZE", "clips_from_frames"]
