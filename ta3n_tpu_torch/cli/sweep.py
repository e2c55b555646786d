"""Sweep entry point of the port: the train CLI's flags, training a (seed
x lr x alpha) grid as one ensemble (`train/sweep.py`).

    python -m ta3n_tpu_torch.cli.sweep CLASS_FILE MODALITY SRC_LIST \
        TGT_LIST VAL_LIST [train flags...] \
        --sweep_seeds 0 1 2 --sweep_lrs 0.03 0.01 --sweep_alphas 1.0 \
        --sweep_dir exp/sweep/

trains every combination together on one card (one shared data stream,
per-member schedule scalars; the feature stores uploaded once, as with
the train CLI's --device_store), prints one JSON line per member with its
final top-1 and a summary line, as `ta3n_tpu.cli.sweep` does, and writes
each member as a solo checkpoint that --resume, the eval CLI and
cli.serve read (exp/sweep/member_XX/checkpoint.pth.tar and a sweep.json
manifest; cli.serve serves the whole directory as an ensemble).
``--sweep_resume`` continues a preempted sweep from its member
checkpoints.  ``--device`` as in the train CLI (default cuda).

``--sweep_mesh M > 0`` runs the member axis over the ranks of a process
group (`train/sweep.py`): M member shards, each over W / M ranks that
split its batches.  The group is the train CLI's: ``--num_devices W``
starts W processes on this machine (one a card; gloo processes with
``--device cpu``), ``torchrun`` starts one a card on every machine, and a
caller that has initialised a group runs the CLI on each of its ranks.
Rank 0 prints the rows and writes the directory.
"""

from __future__ import annotations

import itertools
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ta3n_tpu_torch.cli.opts import build_parser, configs_from_args
from ta3n_tpu_torch.data import load_class_names


def _parser():
    parser = build_parser()
    parser.add_argument('--sweep_seeds', type=int, nargs='+', default=[0],
                        help='init/dropout seeds (sweep axis)')
    parser.add_argument('--sweep_lrs', type=float, nargs='+', default=None,
                        help='learning rates (sweep axis; default: --lr)')
    parser.add_argument('--sweep_alphas', type=float, nargs='+',
                        default=None,
                        help='discrepancy weights (sweep axis; default: '
                             '--alpha; the ramp value -1 is not sweepable)')
    parser.add_argument('--sweep_dir', type=str, default=None,
                        help='write member_XX/checkpoint.pth.tar + '
                             'sweep.json under this dir')
    parser.add_argument('--sweep_mesh', type=int, default=0,
                        help='0: one device; M>0: shard the member axis '
                             'M-way over the process group, each shard '
                             'splitting its batches over the remaining '
                             'ranks (--num_devices or torchrun)')
    parser.add_argument('--sweep_resume', default=False,
                        action='store_true',
                        help="continue a preempted sweep from --sweep_dir's "
                             'member checkpoints (loaders fast-forwarded: '
                             'deterministic setups reproduce the '
                             'uninterrupted trajectory exactly)')
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to train on the CPU)")
    if args.sweep_mesh <= 0:
        return _run(args, device)
    from ta3n_tpu_torch.cli import train as cli_train
    from ta3n_tpu_torch.parallel.distributed import (default_backend,
                                                     initialize_multihost)
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        # the caller's group, or torchrun's: run as this rank
        joined = not dist.is_initialized()
        if joined:
            initialize_multihost(backend=default_backend(device))
        try:
            world = dist.get_world_size()
            if args.num_devices not in (None, world):
                raise SystemExit(f"--num_devices {args.num_devices} in a "
                                 f"process group of {world} ranks")
            return _run(args, device)
        finally:
            if joined:
                dist.destroy_process_group()
    world = args.num_devices
    if world is None:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world % args.sweep_mesh:
        raise SystemExit(f"--sweep_mesh {args.sweep_mesh}: {world} devices "
                         f"not divisible by member_shards={args.sweep_mesh}")
    if world == 1:
        return _run(args, device)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"--num_devices {world}: "
                         f"{torch.cuda.device_count()} cards visible")
    return cli_train._launch(sys.argv[1:] if argv is None else list(argv),
                             world, device, run_argv)


def run_argv(argv):
    """The sweep of one rank from its command line (the launcher's
    entry)."""
    args = _parser().parse_args(argv)
    return _run(args, torch.device(args.device))


def _run(args, device):
    from ta3n_tpu_torch.train.loop import (build_loaders,
                                           class_weights_from_list)
    from ta3n_tpu_torch.train.sweep import run_sweep

    lrs = args.sweep_lrs if args.sweep_lrs is not None else [args.lr]
    alphas = (args.sweep_alphas if args.sweep_alphas is not None
              else [args.alpha])
    if any(a < 0 for a in alphas):
        raise SystemExit("--sweep_alphas entries must be >= 0 (the "
                         "epoch-ramp sentinel -1 is a solo-run feature)")
    members = list(itertools.product(args.sweep_seeds, lrs, alphas))

    num_class = len(load_class_names(args.class_file))
    model_cfg, da_cfg, train_cfg = configs_from_args(args, num_class)
    source_loader, target_loader, val_loader, n_src, n_tgt = build_loaders(
        args, model_cfg, train_cfg)
    class_weights = class_weights_from_list(
        args.train_source_list, num_class,
        args.weighted_class_loss == 'Y')
    domain_weights = (np.array([1.0 / n_src, 1.0 / n_tgt], np.float32)
                      if args.weighted_class_loss_DA == 'Y' else None)
    mesh = None
    if args.sweep_mesh > 0 and dist.is_initialized():
        from ta3n_tpu_torch.train.ensemble import make_ensemble_mesh
        mesh = make_ensemble_mesh(args.sweep_mesh)
    out = run_sweep(model_cfg, da_cfg, train_cfg, source_loader,
                    target_loader, val_loader, members,
                    dann_lr_decay=args.lr_adaptive == 'dann', mesh=mesh,
                    class_weights=class_weights,
                    domain_weights=domain_weights,
                    save_dir=args.sweep_dir, arch=args.arch,
                    eval_freq=args.eval_freq, resume=args.sweep_resume,
                    store_dtype=(args.store_dtype
                                 if args.store_dtype != 'float32'
                                 else None), device=device)
    if mesh is not None and not mesh.is_primary:
        return out
    for row in out["results"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({"members": len(members),
                      "epochs": train_cfg.epochs,
                      "train_wall_s": out["train_wall_s"],
                      "ensemble_top1": out["ensemble_top1"],
                      "devices": dist.get_world_size() if mesh is not None
                      else 1}), flush=True)
    return out


if __name__ == '__main__':
    main()
