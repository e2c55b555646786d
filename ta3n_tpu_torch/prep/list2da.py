"""Filter official full-dataset split lists down to the DA class subset:
the port's own copy of `ta3n_tpu/prep/list2da.py`.

Parity with `dataset_preparation/list_ucf_hmdb_full2DA.py`: keep only
videos whose class is in the shared DA class list, remap labels to the
DA label space, and rewrite paths to the feature tree.

Two class-resolution modes:
  * ``--class_list_full``: map the line's numeric class id through a
    full-dataset id->name list (our original, dataset-agnostic design);
  * ``--dataset ucf101|hmdb51``: derive the class from the video
    FILENAME with the reference's own parsing
    (list_ucf_hmdb_full2DA.py:38-54 — ucf: token after 'v_'; hmdb:
    strip the 6-part suffix, take the last two '_'-tokens, try the
    second token alone then the joined pair), so the reference's
    official split files work without any extra input.  Oracle:
    tests/test_prep_tools.py runs the reference script itself and
    diffs the outputs; tests/test_torch_port_prep_tools.py holds this
    copy to it.

Divergence note (PARITY.md §2.8): the reference rebuilds the output
path from each line's own directory prefix; ours uses the single
--feature_root — identical for the standard one-tree layout.

Usage:
    python -m ta3n_tpu_torch.prep.list2da FULL_LIST OUT_LIST \
        --class_list_da data/classInd_hmdb_ucf.txt \
        [--class_list_full classInd_full.txt | --dataset ucf101] \
        --feature_root RGB-Feature/
"""

from __future__ import annotations

import argparse
import os

__all__ = ["load_id_to_name", "class_from_filename", "convert",
           "main"]


def load_id_to_name(class_file: str):
    out = {}
    with open(class_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx, name = line.split(" ", 1)
            out[int(idx)] = name
    return out


def class_from_filename(name_video: str, dataset: str, da_names):
    """The reference's filename-derived class
    (list_ucf_hmdb_full2DA.py:38-54).  Returns the matched DA class
    name or None.

    ucf101: 'v_Basketball_g01_c01' -> token after the first '_'.
    hmdb51: strip the 6-part annotation suffix, take the last two
    '_'-tokens; the reference tries the SECOND token alone first
    (one-word classes like 'climb'), then the joined pair
    ('brush_hair').  Names too short for its unguarded [1] index (an
    IndexError there) simply don't match here.
    """
    if dataset == "ucf101":
        parts = name_video.split("_")
        if len(parts) > 1 and parts[1] in da_names:
            return parts[1]
        return None
    if dataset == "hmdb51":
        short = name_video.rsplit("_", 6)[0]
        class_str = "_".join(short.rsplit("_", 2)[-2:])
        tokens = class_str.split("_")
        if len(tokens) > 1 and tokens[1] in da_names:
            return tokens[1]
        if class_str in da_names:
            return class_str
        return None
    raise ValueError(f"unknown dataset {dataset!r}; expected "
                     "'ucf101' or 'hmdb51'")


def convert(full_list: str, class_list_full: str, class_list_da: str,
            feature_root: str = "", dataset: str = None):
    if dataset is None and class_list_full is None:
        raise ValueError("pass --class_list_full (id-mapped mode) or "
                         "--dataset ucf101|hmdb51 (filename mode)")
    full_names = (load_id_to_name(class_list_full)
                  if class_list_full else {})
    da_map = {name: idx for idx, name in
              load_id_to_name(class_list_da).items()}
    rows = []
    with open(full_list) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            path, rest = parts[0], parts[1:]
            video = os.path.splitext(os.path.basename(path))[0]
            if dataset is not None:
                name = class_from_filename(video, dataset, da_map)
            else:
                name = full_names.get(int(rest[-1]))
            if name is None or name not in da_map:
                continue
            new_path = os.path.join(feature_root, video) if feature_root \
                else path
            n_frames = int(rest[0]) if len(rest) > 1 else 0
            rows.append((new_path, n_frames, da_map[name]))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("full_list")
    p.add_argument("out_list")
    p.add_argument("--class_list_full", default=None,
                   help="full-dataset id->name list (id-mapped mode)")
    p.add_argument("--dataset", default=None,
                   choices=["ucf101", "hmdb51"],
                   help="derive classes from filenames like the "
                        "reference tool (no class_list_full needed)")
    p.add_argument("--class_list_da", required=True)
    p.add_argument("--feature_root", default="")
    args = p.parse_args(argv)
    rows = convert(args.full_list, args.class_list_full, args.class_list_da,
                   args.feature_root, dataset=args.dataset)
    with open(args.out_list, "w") as f:
        for path, n, label in rows:
            f.write(f"{path} {n} {label}\n")
    print(f"kept {len(rows)} videos -> {args.out_list}")


if __name__ == "__main__":
    main()
