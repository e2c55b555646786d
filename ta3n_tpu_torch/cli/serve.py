"""Serving CLI of the port: expose a trained TA3N model over HTTP.

    python -m ta3n_tpu_torch.cli.serve CLASS_FILE model.pth.tar \
        --fc_dim 512 --frame_aggregation trn-m --test_segments 5 --port 8500

The positionals and model flags are those of `ta3n_tpu.cli.serve`, plus
``--device`` (default ``cuda``; without a CUDA device it exits with an
error rather than serve on the CPU).  WEIGHTS is a reference-format
``.pth.tar``; export a JAX checkpoint directory first with
``python -m ta3n_tpu.cli.export_checkpoint DIR out.pth.tar``.  WEIGHTS may
also be a sweep's output directory (``python -m ta3n_tpu_torch.cli.sweep
... --sweep_dir DIR``): every member is then served as one deep ensemble
(``Predictor.from_sweep``), each member's final checkpoint or, with
``--sweep_best``, its model_best.

``--quantize int8`` serves W8A8 int8 inference.  ``--export DIR`` writes
an AOT artifact (``Predictor.export``: predict.pt2 and meta.json, for
the devices ``--export_platforms`` lists) and exits; WEIGHTS may then be
DIR, served by ``Predictor.from_exported`` with the model flags of its
meta.json (the CLI's are ignored).  ``--data_parallel`` serves over
every visible card from this one process (``parallel.make_mesh()``: one
replica a card, each request batch split into one row block a card; with
``--device cpu``, one CPU replica), the batch size rounded up to a card
multiple.
"""

from __future__ import annotations

import argparse

import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.data.manifest import load_class_names
from ta3n_tpu_torch.parallel.mesh import Mesh, make_mesh
from ta3n_tpu_torch.serve import Predictor, run_http_server


def build_parser():
    p = argparse.ArgumentParser(description="TA3N serving (PyTorch port)")
    p.add_argument("class_file")
    p.add_argument("weights", help="reference-format .pth.tar, a sweep "
                   "output dir (served as a deep ensemble), or an --export "
                   "artifact dir")
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
                   help="int8: W8A8 dynamically quantized inference "
                        "(per-channel weight / per-row activation scales; "
                        "logits heads stay float32); recorded in --export "
                        "artifacts' meta.json")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--data_parallel", default=False, action="store_true",
                   help="split each request batch over every visible "
                        "card, one replica a card, from this process")
    p.add_argument("--sweep_best", default=False, action="store_true",
                   help="when WEIGHTS is a sweep dir: serve each member's "
                        "best-validation state (model_best, written by -ef "
                        "sweeps) instead of its final checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--export", default=None, metavar="DIR",
                   help="write an AOT artifact (predict.pt2 + meta.json) to "
                        "DIR and exit instead of serving; WEIGHTS may later "
                        "be DIR, served without model code or checkpoint")
    p.add_argument("--export_platforms", nargs="+", default=["cpu", "cuda"],
                   help="devices the exported artifact may be served on")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to serve on the CPU)")
    mesh = None
    if args.data_parallel:
        mesh = make_mesh() if device.type == "cuda" else Mesh([device])
        print(f"--data_parallel: {mesh.size} replica(s) on "
              f"{[str(d) for d in mesh.devices]}")
    class_names = load_class_names(args.class_file)
    if Predictor.is_exported(args.weights):
        # an artifact: the model flags come from its meta.json
        predictor = Predictor.from_exported(args.weights, mesh=mesh,
                                            device=device)
    else:
        predictor = _live_predictor(args, class_names, device, mesh)
    if args.export:
        out = predictor.export(args.export, args.export_platforms)
        print(f"exported {predictor.cfg.num_class}-class predictor (batch "
              f"{predictor.batch_size}, platforms {args.export_platforms}) "
              f"to {out}")
        return
    run_http_server(predictor, class_names, args.host, args.port)


def _live_predictor(args, class_names, device, mesh=None) -> Predictor:
    """The Predictor of a checkpoint or a sweep directory and the model
    flags."""
    cfg = ModelConfig(
        num_class=len(class_names), baseline_type=args.baseline_type,
        frame_aggregation=args.frame_aggregation,
        train_segments=args.test_segments, val_segments=args.test_segments,
        base_model=args.arch, feature_dim=args.feature_dim,
        dropout_i=0.0, dropout_v=0.0, add_fc=args.add_fc,
        fc_dim=args.fc_dim, use_attn=args.use_attn,
        use_attn_frame=args.use_attn_frame, use_bn=args.use_bn,
        share_params=args.share_params, quantize=args.quantize)
    if args.sweep_best and not Predictor.is_sweep(args.weights):
        raise SystemExit(
            f"--sweep_best: {args.weights} is not a sweep output dir (no "
            "member_XX checkpoints) — for a solo training run point WEIGHTS "
            "at its model_best.pth.tar directly")
    if Predictor.is_sweep(args.weights):
        # every member as one deep ensemble (member-averaged softmax, one
        # vmapped pass)
        which = "model_best" if args.sweep_best else "checkpoint"
        predictor = Predictor.from_sweep(
            args.weights, cfg, which=which, device=device,
            batch_size=args.batch_size, top_k=args.top_k, mesh=mesh)
        print(f"ensemble serving: {predictor.n_members} members ({which})")
        return predictor
    return Predictor.from_checkpoint(
        args.weights, cfg, device=device, batch_size=args.batch_size,
        top_k=args.top_k, mesh=mesh)


if __name__ == "__main__":
    main()
