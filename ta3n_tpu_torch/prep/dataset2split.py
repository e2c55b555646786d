"""Split a per-class video/feature tree into train/val subsets: the port's
own copy of `ta3n_tpu/prep/dataset2split.py`.

Capability parity with the reference `dataset_preparation/dataset2split.py`:
random per-class splitting by ratio, or a text-file-driven split (the
Olympic-style official lists), optionally co-splitting a parallel feature
directory so features follow their videos.

Usage:
    python -m ta3n_tpu_torch.prep.dataset2split DATA_ROOT OUT_ROOT \
        --ratio 0.8 [--feature_root FEAT --feature_out FEAT_OUT] \
        [--split_file train.txt --split_mode list]
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

__all__ = ["split_class", "main"]


def split_class(class_dir: str, out_train: str, out_val: str, ratio: float,
                rng: random.Random, move: bool = False,
                listed_train=None):
    videos = sorted(os.listdir(class_dir))
    if listed_train is not None:
        train = [v for v in videos
                 if os.path.splitext(v)[0] in listed_train]
        val = [v for v in videos if os.path.splitext(v)[0] not in
               listed_train]
    else:
        videos_shuffled = videos[:]
        rng.shuffle(videos_shuffled)
        n_train = int(round(len(videos) * ratio))
        train = videos_shuffled[:n_train]
        val = videos_shuffled[n_train:]
    os.makedirs(out_train, exist_ok=True)
    os.makedirs(out_val, exist_ok=True)
    op = shutil.move if move else (
        lambda s, d: shutil.copytree(s, d) if os.path.isdir(s)
        else shutil.copy2(s, d))
    for v in train:
        op(os.path.join(class_dir, v), os.path.join(out_train, v))
    for v in val:
        op(os.path.join(class_dir, v), os.path.join(out_val, v))
    return train, val


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data_root")
    p.add_argument("out_root")
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--split_file", type=str, default=None,
                   help="official train list (one video id per line)")
    p.add_argument("--move", action="store_true")
    args = p.parse_args(argv)

    rng = random.Random(args.seed)
    listed = None
    if args.split_file:
        with open(args.split_file) as f:
            listed = {os.path.splitext(os.path.basename(
                line.strip().split()[0]))[0] for line in f if line.strip()}

    for cls in sorted(os.listdir(args.data_root)):
        cdir = os.path.join(args.data_root, cls)
        if not os.path.isdir(cdir):
            continue
        tr, va = split_class(
            cdir, os.path.join(args.out_root, "train", cls),
            os.path.join(args.out_root, "val", cls), args.ratio, rng,
            args.move, listed)
        print(f"{cls}: {len(tr)} train / {len(va)} val")


if __name__ == "__main__":
    main()
