"""Convert a reference-style `.t7`-per-frame feature layout into a packed
FeatureStore: the port's own copy of `ta3n_tpu/cli/convert_features.py`.

The reference stores one serialized tensor per frame
(`RGB-Feature/VIDEO/img_%05d.t7`, dataset_preparation/video2feature.py:
206-217) and loads them one `torch.load` at a time in the hot loop
(dataset.py:53-66).  This one-time converter packs a whole split into a
single contiguous array + offsets (see ta3n_tpu_torch/data/feature_store.py),
after which training never touches per-frame files again.

Usage:
    python -m ta3n_tpu_torch.cli.convert_features LIST_FILE OUT_DIR \
        [--modality RGB|Flow] [--flow_prefix flow_] [--dtype float32]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ta3n_tpu_torch.data import FeatureStore, parse_list_file

__all__ = ["load_t7", "convert", "main"]


def load_t7(path: str) -> np.ndarray:
    """Load one reference feature file (a torch-serialized tensor)."""
    import torch
    t = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(t.detach().numpy() if hasattr(t, "detach") else t
                      ).reshape(-1)


def convert(list_file: str, out_dir: str, modality: str = "RGB",
            image_tmpl: str = "img_{:05d}.t7", flow_prefix: str = "",
            dtype: str = "float32") -> FeatureStore:
    records = parse_list_file(list_file)
    feats, paths, labels = [], [], []
    for rec in records:
        per_frame = []
        for idx in range(1, rec.num_frames + 1):  # 1-based file naming
            if modality == "RGB" or modality.startswith("RGBDiff"):
                f = load_t7(os.path.join(rec.path, image_tmpl.format(idx)))
                per_frame.append(f)
            elif modality == "Flow":
                tmpl = flow_prefix + "{}_{:05d}.t7"
                x = load_t7(os.path.join(rec.path, tmpl.format("x", idx)))
                y = load_t7(os.path.join(rec.path, tmpl.format("y", idx)))
                per_frame.append(np.stack([x, y]))
            else:
                raise ValueError(f"unknown modality {modality}")
        feats.append(np.asarray(per_frame,
                                dtype="float32" if dtype == "int8"
                                else dtype))
        paths.append(rec.path)
        labels.append(rec.label)
    store = FeatureStore.from_arrays(feats, paths, labels)
    if dtype == "int8":
        # per-row symmetric quantization (data/quantized.py): 4x
        # smaller on disk/RAM/upload; gathers dequantize transparently
        store = store.quantize()
    store.save(out_dir)
    return store


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("list_file")
    p.add_argument("out_dir")
    p.add_argument("--modality", default="RGB")
    p.add_argument("--image_tmpl", default="img_{:05d}.t7")
    p.add_argument("--flow_prefix", default="")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float16", "int8"],
                   help="int8 writes a per-row-quantized store "
                        "(features.npy int8 + scales.npy): 4x smaller "
                        "on disk, in host RAM, and per host->HBM "
                        "upload; training/eval dequantize "
                        "transparently")
    args = p.parse_args(argv)
    store = convert(args.list_file, args.out_dir, args.modality,
                    args.image_tmpl, args.flow_prefix, args.dtype)
    print(f"packed {store.num_videos} videos, "
          f"{store.offsets[-1]} frames, dim {store.feature_dim} "
          f"-> {args.out_dir}")


if __name__ == "__main__":
    main()
