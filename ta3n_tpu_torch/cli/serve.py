"""Serving CLI of the port: expose a trained TA3N model over HTTP.

    python -m ta3n_tpu_torch.cli.serve CLASS_FILE model.pth.tar \
        --fc_dim 512 --frame_aggregation trn-m --test_segments 5 --port 8500

The positionals and model flags are those of `ta3n_tpu.cli.serve`, plus
``--device`` (default ``cuda``; without a CUDA device it exits with an
error rather than serve on the CPU).  WEIGHTS is a reference-format
``.pth.tar``; export a JAX checkpoint directory first with
``python -m ta3n_tpu.cli.export_checkpoint DIR out.pth.tar``.
"""

from __future__ import annotations

import argparse

import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.data.manifest import load_class_names
from ta3n_tpu_torch.serve import _LATER, Predictor, run_http_server


def build_parser():
    p = argparse.ArgumentParser(description="TA3N serving (PyTorch port)")
    p.add_argument("class_file")
    p.add_argument("weights", help="reference-format .pth.tar")
    p.add_argument("--arch", default="resnet101")
    p.add_argument("--feature_dim", type=int, default=None)
    p.add_argument("--test_segments", type=int, default=5)
    p.add_argument("--add_fc", type=int, default=1)
    p.add_argument("--fc_dim", type=int, default=512)
    p.add_argument("--baseline_type", default="video")
    p.add_argument("--frame_aggregation", default="trn-m")
    p.add_argument("--use_attn", default="TransAttn")
    p.add_argument("--use_attn_frame", default="none")
    p.add_argument("--use_bn", default="none")
    p.add_argument("--share_params", default="Y")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help=f"int8 {_LATER}")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--data_parallel", default=False, action="store_true",
                   help=_LATER)
    p.add_argument("--sweep_best", default=False, action="store_true",
                   help=_LATER)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--export", default=None, metavar="DIR", help=_LATER)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, on in (("--export", args.export is not None),
                     ("--data_parallel", args.data_parallel),
                     ("--sweep_best", args.sweep_best),
                     ("--quantize int8", args.quantize == "int8")):
        if on:
            raise SystemExit(f"{flag} {_LATER}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to serve on the CPU)")
    class_names = load_class_names(args.class_file)
    cfg = ModelConfig(
        num_class=len(class_names), baseline_type=args.baseline_type,
        frame_aggregation=args.frame_aggregation,
        train_segments=args.test_segments, val_segments=args.test_segments,
        base_model=args.arch, feature_dim=args.feature_dim,
        dropout_i=0.0, dropout_v=0.0, add_fc=args.add_fc,
        fc_dim=args.fc_dim, use_attn=args.use_attn,
        use_attn_frame=args.use_attn_frame, use_bn=args.use_bn,
        share_params=args.share_params, quantize=args.quantize)
    predictor = Predictor.from_checkpoint(
        args.weights, cfg, device=device, batch_size=args.batch_size,
        top_k=args.top_k)
    run_http_server(predictor, class_names, args.host, args.port)


if __name__ == "__main__":
    main()
