"""Video utilities: frame counting and label overlay: the port's own
copy of `ta3n_tpu/prep/video_processing.py`.

Capability parity with the reference `tools/video_processing.py`
(frame-count / overlay utility).  cv2-gated.

Usage:
    python -m ta3n_tpu_torch.prep.video_processing count VIDEO [VIDEO...]
    python -m ta3n_tpu_torch.prep.video_processing overlay VIDEO OUT \
        --text LABEL
"""

from __future__ import annotations

import argparse

__all__ = ["count_frames", "overlay_text", "main"]


def count_frames(path: str) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if n <= 0:  # fall back to decoding
        n = 0
        while True:
            ok, _ = cap.read()
            if not ok:
                break
            n += 1
    cap.release()
    return n


def overlay_text(path: str, out_path: str, text: str,
                 position=(30, 50), scale: float = 1.5,
                 color=(0, 255, 0)) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.putText(frame, text, position, cv2.FONT_HERSHEY_SIMPLEX,
                    scale, color, 2)
        writer.write(frame)
        n += 1
    writer.release()
    cap.release()
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("count")
    pc.add_argument("videos", nargs="+")
    po = sub.add_parser("overlay")
    po.add_argument("video")
    po.add_argument("out")
    po.add_argument("--text", required=True)
    args = p.parse_args(argv)
    if args.cmd == "count":
        for v in args.videos:
            print(v, count_frames(v))
    else:
        n = overlay_text(args.video, args.out, args.text)
        print(f"wrote {n} frames -> {args.out}")


if __name__ == "__main__":
    main()
