"""Offline feature extraction: videos or frame folders -> packed
FeatureStore, the backbone on the card.

Port of `ta3n_tpu/prep/video2feature.py` (the reference's
`dataset_preparation/video2feature.py`): the same flags, plus
``--device`` (default ``cuda``; without a CUDA device it exits rather
than extract on the CPU).  imageio/cv2 decode and the numpy preprocessing
run on the host, imported only when a video is decoded (the card's
machine may have neither: `extract_batched` and `finalize` need them not);
the backbone (`models/backbones`) runs on the device in float32 with
cuDNN's TF32 off.  Each video's features are written as a resumable
``.npy`` shard, ``<out_root>/shards/<class>/<video>.npy``, and
``--finalize`` packs the shards into one FeatureStore, the layout the JAX
tool writes.

Backbone weights come from ``--pretrain_weight``: a torchvision-format
ResNet state_dict or the reference's C3D state_dict (``.pth``, loaded
with ``weights_only=True``; this tool never downloads).

Usage:
    python -m ta3n_tpu_torch.prep.video2feature --data_path D/ \\
        --video_in RGB --base_model resnet101 --pretrain_weight r101.pth
    python -m ta3n_tpu_torch.prep.video2feature --finalize \\
        D/RGB-feature_resnet101
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List

import numpy as np
import torch

from ta3n_tpu_torch.models.layers import no_cudnn_tf32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_frames(frames: np.ndarray, size: int,
                      normalize: bool) -> np.ndarray:
    """Resize the shorter side to ``size`` (cv2, bilinear), center-crop,
    scale to [0, 1], optionally ImageNet-normalize (video2feature.py:
    93-105): [T, H, W, 3] uint8 -> [T, size, size, 3] float32."""
    import cv2
    out = np.empty((frames.shape[0], size, size, 3), np.float32)
    for i, im in enumerate(frames):
        h, w = im.shape[:2]
        scale = size / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        im = cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
        top, left = (nh - size) // 2, (nw - size) // 2
        out[i] = im[top:top + size, left:left + size].astype(np.float32) \
            / 255.0
    if normalize:
        out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return out


def decode_video(path: str) -> np.ndarray:
    """Every frame of a video, [T, H, W, 3] (video2feature.py:156-166)."""
    import imageio
    reader = imageio.get_reader(path)
    frames = []
    try:
        for im in reader:
            if np.sum(im.shape) != 0:
                if im.ndim == 2:
                    im = np.stack([im] * 3, axis=-1)
                frames.append(im[..., :3])
    except (RuntimeError, StopIteration):
        pass
    reader.close()
    return np.stack(frames) if frames else np.zeros((0, 1, 1, 3), np.uint8)


def read_frame_dir(path: str) -> np.ndarray:
    """The images of a frame folder in name order, [T, H, W, 3]."""
    import imageio
    frames = []
    for f in sorted(os.listdir(path)):
        im = imageio.imread(os.path.join(path, f))
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        frames.append(im[..., :3])
    return np.stack(frames) if frames else np.zeros((0, 1, 1, 3), np.uint8)


def make_extractor(base_model: str, pretrain_weight: str, batch_size: int,
                   c3d_activations: str = "none", device="cuda"
                   ) -> Callable[[np.ndarray], np.ndarray]:
    """The batched feature function of a backbone on ``device``: it takes
    the JAX tool's channels-last numpy batches, [N, 224, 224, 3] frames
    (ResNet) or [N, 16, 112, 112, 3] clips (C3D), permutes them to
    channels-first on the device, and returns float32 features
    [N, 2048 / 512 / 4096] as numpy.  ``batch_size`` is the JAX tool's
    argument (its batches are padded by `extract_batched`)."""
    from ta3n_tpu_torch.models.backbones import C3DFeatures, ResNetFeatures

    state = torch.load(pretrain_weight, map_location="cpu",
                       weights_only=True)
    if base_model == "c3d":
        net = C3DFeatures.from_state_dict(state, c3d_activations, device)
        channels_first = (0, 4, 1, 2, 3)
    else:
        net = ResNetFeatures.from_state_dict(state, base_model, device)
        channels_first = (0, 3, 1, 2)

    @torch.inference_mode()
    def run(batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(batch, np.float32)).to(device)
        with no_cudnn_tf32():
            return net(x.permute(channels_first)).cpu().numpy()
    return run


def extract_batched(inputs: np.ndarray, run, batch_size: int) -> np.ndarray:
    """``run`` over fixed batches of ``batch_size``, the last zero-padded
    (video2feature.py:182-203); the padding's rows are dropped."""
    n = inputs.shape[0]
    feats: List[np.ndarray] = []
    for t in range(0, n, batch_size):
        chunk = inputs[t:t + batch_size]
        if chunk.shape[0] < batch_size:
            pad = np.zeros((batch_size - chunk.shape[0],)
                           + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        feats.append(run(chunk))
    return np.concatenate(feats)[:n]


def finalize(shard_root: str) -> None:
    """Pack the per-video shards under ``shard_root/shards`` into one
    FeatureStore at ``shard_root``: classes and videos in name order, a
    video's path ``<class>/<video>``, its label its class's rank."""
    from ta3n_tpu_torch.data import FeatureStore
    shard_dir = os.path.join(shard_root, "shards")
    feats, paths, labels = [], [], []
    for cls_id, cls in enumerate(sorted(os.listdir(shard_dir))):
        cdir = os.path.join(shard_dir, cls)
        for v in sorted(os.listdir(cdir)):
            feats.append(np.load(os.path.join(cdir, v)))
            paths.append(f"{cls}/{os.path.splitext(v)[0]}")
            labels.append(cls_id)
    store = FeatureStore.from_arrays(feats, paths, labels)
    store.save(shard_root)
    print(f"packed {store.num_videos} videos / {store.offsets[-1]} frames "
          f"(dim {store.feature_dim}) -> {shard_root}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Dataset Preparation "
                                "(PyTorch port)")
    p.add_argument('--data_path', type=str, default='')
    p.add_argument('--video_in', type=str, default='RGB')
    p.add_argument('--feature_in', type=str, default='RGB-feature')
    p.add_argument('--input_type', type=str, default='video',
                   choices=['video', 'frames'])
    p.add_argument('--base_model', type=str, default='resnet101',
                   choices=['resnet18', 'resnet34', 'resnet50', 'resnet101',
                            'resnet152', 'c3d'])
    p.add_argument('--pretrain_weight', type=str, default='',
                   help='torch-format state_dict (.pth) for the backbone')
    p.add_argument('--batch_size', type=int, default=32)
    p.add_argument('--start_class', type=int, default=1)
    p.add_argument('--end_class', type=int, default=-1)
    p.add_argument('--class_file', type=str, default='none')
    p.add_argument('--c3d_activations', type=str, default='none',
                   choices=['none', 'relu'],
                   help="'none' replicates the reference extractor's "
                        "missing-ReLU quirk (video2feature.py:68-72)")
    p.add_argument('--finalize', type=str, default=None,
                   help='pack the shards under this output root and exit')
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device of the backbone (default cuda)')
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.finalize:
        finalize(args.finalize)
        return
    if not args.pretrain_weight:
        raise SystemExit(
            "--pretrain_weight is required: supply a torch-format "
            "state_dict for the backbone (this tool never downloads)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to extract on the "
                         "CPU)")

    from ta3n_tpu_torch.models.backbones import (C3D_CLIP_SIZE,
                                                 clips_from_frames)
    path_input = os.path.join(args.data_path, args.video_in)
    out_root = os.path.join(args.data_path,
                            f"{args.feature_in}_{args.base_model}")
    c3d = args.base_model == "c3d"
    size = 112 if c3d else 224
    run = make_extractor(args.base_model, args.pretrain_weight,
                         args.batch_size, args.c3d_activations, device)

    classes = sorted(os.listdir(path_input))
    if args.class_file != 'none':
        with open(args.class_file) as f:
            keep = {line.strip().split(' ', 1)[1] for line in f}
        classes = [c for c in classes if c in keep]
    lo = args.start_class - 1
    hi = len(classes) if args.end_class <= 0 else args.end_class
    for cls in classes[lo:hi]:
        cdir = os.path.join(path_input, cls)
        out_dir = os.path.join(out_root, "shards", cls)
        os.makedirs(out_dir, exist_ok=True)
        for video in sorted(os.listdir(cdir)):
            name = os.path.splitext(video)[0]
            out_file = os.path.join(out_dir, name + ".npy")
            if os.path.exists(out_file):  # resumable (video2feature.py:184)
                continue
            vpath = os.path.join(cdir, video)
            frames = (decode_video(vpath) if args.input_type == 'video'
                      else read_frame_dir(vpath))
            if frames.shape[0] == 0:
                print(f"!! no frames decoded: {vpath}")
                continue
            pre = preprocess_frames(frames, size, normalize=not c3d)
            if c3d:
                if pre.shape[0] < C3D_CLIP_SIZE:
                    print(f"!! too short for C3D: {vpath}")
                    continue
                inputs = clips_from_frames(pre)
            else:
                inputs = pre
            feats = extract_batched(inputs, run, args.batch_size)
            np.save(out_file, feats.astype(np.float32))
            print(f"{cls}/{name}: {feats.shape}")
    print(f"done; run --finalize {out_root} to pack the store")


if __name__ == "__main__":
    main()
