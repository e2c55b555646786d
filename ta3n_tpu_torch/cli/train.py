"""Training entry point of the port: the reference `main.py` CLI, as
`ta3n_tpu.cli.train` runs it, on one card.

    python -m ta3n_tpu_torch.cli.train CLASS_FILE MODALITY SRC_LIST \
        TGT_LIST VAL_LIST [flags...]

The positionals and flags are the JAX CLI's (`cli/opts.py`), plus
``--device`` (default ``cuda``; without a CUDA device the CLI exits with an
error rather than train on the CPU: pass ``--device cpu``).  Feature stores
are the packed FeatureStore directories the JAX package writes, by default
the directory of each list file.  With ``--device_store``,
``--steps_per_call K`` runs K steps a call, ``--device_sampler`` makes the
index batches on the card and ``--store_budget_rows N`` streams the stores
in shards, as the Trainer says.  Checkpoints are reference-format
``checkpoint.pth.tar`` / ``model_best.pth.tar`` under
``EXP_PATH/MODALITY/``, which ``--resume`` reads back.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ta3n_tpu_torch.cli.opts import build_parser, configs_from_args
from ta3n_tpu_torch.data import load_class_names
from ta3n_tpu_torch.io_utils.logs import LogFiles
from ta3n_tpu_torch.train.loop import (Trainer, build_loaders,
                                       class_weights_from_list)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to train on the CPU)")

    print('Baseline:', args.baseline_type)
    print('Frame aggregation method:', args.frame_aggregation)
    print('target data usage:', args.use_target)
    if args.use_target == 'none':
        print('no Domain Adaptation')

    class_names = load_class_names(args.class_file)
    num_class = len(class_names)
    model_cfg, da_cfg, train_cfg = configs_from_args(args, num_class)

    path_exp = args.exp_path + args.modality + '/'
    os.makedirs(path_exp, exist_ok=True)

    source_loader, target_loader, val_loader, n_src, n_tgt = build_loaders(
        args, model_cfg, train_cfg)

    class_weights = class_weights_from_list(
        args.train_source_list, num_class,
        args.weighted_class_loss == 'Y')
    domain_weights = (np.array([1.0 / n_src, 1.0 / n_tgt], np.float32)
                      if args.weighted_class_loss_DA == 'Y' else None)

    logs = LogFiles(path_exp, resume=bool(args.resume),
                    best_log=args.save_best_log) if not args.evaluate \
        else None

    trainer = Trainer(model_cfg, da_cfg, train_cfg, source_loader,
                      target_loader, val_loader, path_exp=path_exp,
                      class_weights=class_weights,
                      domain_weights=domain_weights, log_files=logs,
                      print_freq=args.print_freq, show_freq=args.show_freq,
                      eval_freq=args.eval_freq, save_model=args.save_model,
                      save_attention=args.save_attention,
                      tensorboard_dir=(path_exp + 'tensorboard'
                                       if args.tensorboard else None),
                      profile_dir=args.profile_dir,
                      num_devices=args.num_devices,
                      device_store=args.device_store,
                      steps_per_call=args.steps_per_call,
                      store_budget_rows=args.store_budget_rows or None,
                      store_dtype=args.store_dtype,
                      device_sampler=args.device_sampler,
                      accum_steps=args.accum_steps,
                      model_parallel=args.model_parallel,
                      nan_guard=not args.no_nan_guard,
                      seed=args.seed, device=device)

    if args.resume:
        if os.path.isfile(args.resume):
            start = trainer.resume(args.resume, args.resume_hp)
            print(f"=> loaded checkpoint '{args.resume}' "
                  f"(epoch {start - 1})")
        else:
            print(f"=> no checkpoint found at '{args.resume}'")

    if args.evaluate:
        print('evaluation only......')
        prec1 = trainer.validate(0)
        print('%.3f' % prec1)
        return prec1

    print('start training......')
    start_train = time.time()
    best = trainer.fit()
    total = time.time() - start_train
    print('total training time:', total)
    if logs:
        logs.write_total_time(total)
        logs.close()
    return best


if __name__ == '__main__':
    main()
