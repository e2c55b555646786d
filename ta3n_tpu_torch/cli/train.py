"""Training entry point of the port: the reference `main.py` CLI, as
`ta3n_tpu.cli.train` runs it, on one card or several.

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

Several cards (data parallelism, `parallel/mesh.py`): ``--num_devices N``
above 1 starts N worker processes, one a card (``torch.multiprocessing``,
start method spawn), in an NCCL group on a free local port; the default,
None, takes every visible card, as the JAX CLI takes every device, and on
one card runs as before.  With ``--device cpu`` the default is one
process, and ``--num_devices N`` starts N processes in a gloo group.  Rank
0 prints and writes; the CLI exits non-zero when a worker fails, after
stopping the others.  Under ``torchrun`` (``WORLD_SIZE`` set), on one
machine or several, the process joins that group instead and trains as
its rank (the multi-host path): run the same command on every machine.
``--model_parallel M`` makes the group's ranks a (data x model) grid,
tensor parallelism (`train/loop.py`): ``--num_devices 4 --model_parallel
2`` is 2 data rows of 2 model ranks.  On one process it is ignored with
a warning, as in the JAX CLI.
"""

from __future__ import annotations

import os
import signal
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ta3n_tpu_torch.cli.opts import build_parser, configs_from_args
from ta3n_tpu_torch.data import load_class_names
from ta3n_tpu_torch.io_utils.logs import LogFiles
from ta3n_tpu_torch.parallel.distributed import (default_backend,
                                                 initialize_multihost)
from ta3n_tpu_torch.train.loop import (Trainer, build_loaders,
                                       class_weights_from_list)

# seconds the launcher gives the other workers to stop after one failed
_GRACE = 30.0


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to train on the CPU)")
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        # torchrun (one machine or several): join its group
        world = int(os.environ["WORLD_SIZE"])
        if args.num_devices not in (None, world):
            raise SystemExit(f"--num_devices {args.num_devices} under a "
                             f"torchrun group of {world} ranks")
        initialize_multihost(backend=default_backend(device))
        try:
            return _run(args, device)
        finally:
            dist.destroy_process_group()
    world = args.num_devices
    if world is None:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world > 1:
        if device.type == "cuda" and world > torch.cuda.device_count():
            raise SystemExit(f"--num_devices {world}: "
                             f"{torch.cuda.device_count()} cards visible")
        return _launch(sys.argv[1:] if argv is None else list(argv),
                       world, device, run_argv)
    return _run(args, device)


def run_argv(argv):
    """The run of one rank from its command line (``_launch``'s entry)."""
    args = build_parser().parse_args(argv)
    return _run(args, torch.device(args.device))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, address: str, argv, device_type: str,
            results, entry) -> None:
    """One rank of ``_launch``: its card (under NCCL), the group, the
    run ``entry(argv)``; rank 0 puts the run's result on ``results``."""
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_multihost(address, world, rank,
                         backend=default_backend(device_type))
    try:
        best = entry(argv)
        if rank == 0:
            results.put(best)
    finally:
        dist.destroy_process_group()


def _launch(argv, world: int, device: torch.device, entry):
    """``world`` worker processes of this command line, one a card (or,
    on the CPU, gloo processes), spawned, each running ``entry(argv)`` (a
    module-level function: the spawn pickles it by name); the result of
    rank 0.  A failed
    worker stops the others (SIGTERM, then SIGKILL after a grace period)
    and the CLI exits non-zero; a SIGTERM to the launcher goes on to every
    worker, which then stop together with rank 0's emergency
    checkpoint."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    address = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_worker,
                         args=(rank, world, address, argv, device.type,
                               results, entry), daemon=False)
             for rank in range(world)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    prev = signal.signal(signal.SIGTERM, forward)
    try:
        failed = None
        while failed is None and any(p.exitcode is None for p in procs):
            for rank, p in enumerate(procs):
                p.join(timeout=0.2)
                if p.exitcode not in (None, 0):
                    failed = (rank, p.exitcode)
                    break
        if failed is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            deadline = time.time() + _GRACE
            for p in procs:
                p.join(timeout=max(deadline - time.time(), 0.0))
                if p.is_alive():
                    p.kill()
                    p.join()
            raise SystemExit(f"rank {failed[0]} of {world} failed (exit "
                             f"code {failed[1]}); the other workers were "
                             "stopped")
    finally:
        signal.signal(signal.SIGTERM, prev)
    return results.get()


def _run(args, device: torch.device):
    """The training (or --evaluate) run of this process: the whole job,
    or this rank's part of it under a process group."""
    primary = not dist.is_initialized() or dist.get_rank() == 0
    say = print if primary else (lambda *a: None)
    say('Baseline:', args.baseline_type)
    say('Frame aggregation method:', args.frame_aggregation)
    say('target data usage:', args.use_target)
    if args.use_target == 'none':
        say('no Domain Adaptation')

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
                    best_log=args.save_best_log) if (
        not args.evaluate and primary) else None

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
            say(f"=> loaded checkpoint '{args.resume}' "
                f"(epoch {start - 1})")
        else:
            say(f"=> no checkpoint found at '{args.resume}'")

    if args.evaluate:
        say('evaluation only......')
        prec1 = trainer.validate(0)
        say('%.3f' % prec1)
        return prec1

    say('start training......')
    start_train = time.time()
    best = trainer.fit()
    total = time.time() - start_train
    say('total training time:', total)
    if logs:
        logs.write_total_time(total)
        logs.close()
    return best


if __name__ == '__main__':
    main()
