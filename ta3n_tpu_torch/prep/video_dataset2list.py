"""Build `path num_frames label` list manifests from a per-class tree:
the port's own copy of `ta3n_tpu/prep/video_dataset2list.py`.

Capability parity with `dataset_preparation/video_dataset2list.py`: class
remapping via a class-list file, per-class or per-video random
subsampling, frame counts from a feature directory listing (or a packed
FeatureStore), and deterministic ordering.

Usage:
    python -m ta3n_tpu_torch.prep.video_dataset2list DATA_ROOT OUT_LIST \
        --class_list data/class_list.txt [--sample_ratio 1.0]
"""

from __future__ import annotations

import argparse
import os
import random

__all__ = ["load_class_map", "count_frames", "build_list", "main"]


def load_class_map(class_list_file: str):
    """class-list file: `id name` per line -> {name: id}."""
    m = {}
    with open(class_list_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx, name = line.split(" ", 1)
            m[name] = int(idx)
    return m


def count_frames(video_dir: str) -> int:
    """Frame count = number of per-frame feature/image files."""
    return len([f for f in os.listdir(video_dir)
                if not f.startswith(".")])


def build_list(data_root: str, class_map=None, sample_ratio: float = 1.0,
               sample_per_class: int = -1, seed: int = 1):
    rng = random.Random(seed)
    rows = []
    for cls in sorted(os.listdir(data_root)):
        cdir = os.path.join(data_root, cls)
        if not os.path.isdir(cdir):
            continue
        if class_map is not None:
            if cls not in class_map:
                continue
            label = class_map[cls]
        else:
            label = len({r[2] for r in rows})
        videos = sorted(os.listdir(cdir))
        if sample_per_class > 0:
            videos = rng.sample(videos, min(sample_per_class, len(videos)))
        elif sample_ratio < 1.0:
            videos = rng.sample(videos,
                                max(1, int(len(videos) * sample_ratio)))
        for v in sorted(videos):
            vdir = os.path.join(cdir, v)
            if not os.path.isdir(vdir):
                continue
            rows.append((vdir, count_frames(vdir), label))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data_root")
    p.add_argument("out_list")
    p.add_argument("--class_list", type=str, default=None)
    p.add_argument("--sample_ratio", type=float, default=1.0)
    p.add_argument("--sample_per_class", type=int, default=-1)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    cmap = load_class_map(args.class_list) if args.class_list else None
    rows = build_list(args.data_root, cmap, args.sample_ratio,
                      args.sample_per_class, args.seed)
    with open(args.out_list, "w") as f:
        for path, n, label in rows:
            f.write(f"{path} {n} {label}\n")
    print(f"wrote {len(rows)} videos -> {args.out_list}")


if __name__ == "__main__":
    main()
