"""Training CLI flag surface of the port: its own copy of
`ta3n_tpu/cli/opts.py`'s ``build_parser`` and ``configs_from_args``.

Parity with the reference parser (opts.py:1-119): same positionals, same
flags, same defaults and order as the JAX parser, which
tests/test_torch_port_imports.py holds equal, plus ``--device``.  Three
JAX flags have no counterpart in the port and are accepted with no effect,
so that a JAX command line runs unchanged: ``--prng_impl``,
``--compilation_cache`` and ``-j/--workers``.
"""

from __future__ import annotations

import argparse

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig

__all__ = ["build_parser", "configs_from_args"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="TA3N: video domain adaptation (PyTorch port)")
    parser.add_argument('class_file', type=str)
    parser.add_argument('modality', type=str,
                        choices=['RGB', 'Flow', 'RGBDiff', 'RGBDiff2',
                                 'RGBDiffplus'])
    parser.add_argument('train_source_list', type=str)
    parser.add_argument('train_target_list', type=str)
    parser.add_argument('val_list', type=str)

    # ---- model (opts.py:9-38) ----
    parser.add_argument('--arch', type=str, default="resnet101")
    parser.add_argument('--pretrained', type=str, default="none")
    parser.add_argument('--num_segments', type=int, default=5)
    parser.add_argument('--val_segments', type=int, default=-1)
    parser.add_argument('--add_fc', default=1, type=int)
    parser.add_argument('--fc_dim', type=int, default=1024)
    parser.add_argument('--baseline_type', type=str, default='frame',
                        choices=['frame', 'video', 'tsn'])
    parser.add_argument('--frame_aggregation', type=str, default='avgpool',
                        choices=['avgpool', 'rnn', 'temconv', 'trn', 'trn-m',
                                 'none'])
    parser.add_argument('--optimizer', type=str, default='SGD',
                        choices=['SGD', 'Adam'])
    parser.add_argument('--dropout_i', '--doi', default=0.8, type=float)
    parser.add_argument('--dropout_v', '--dov', default=0.8, type=float)
    parser.add_argument('--loss_type', type=str, default="nll",
                        choices=['nll'])
    parser.add_argument('--weighted_class_loss', type=str, default='N',
                        choices=['Y', 'N'])
    parser.add_argument('--n_rnn', default=1, type=int)
    parser.add_argument('--rnn_cell', type=str, default='LSTM',
                        choices=['LSTM', 'GRU'])
    parser.add_argument('--n_directions', type=int, default=1,
                        choices=[1, 2])
    parser.add_argument('--n_ts', type=int, default=5)

    # ---- DA (opts.py:40-68) ----
    parser.add_argument('--share_params', type=str, default='Y',
                        choices=['Y', 'N'])
    parser.add_argument('--use_target', type=str, default='none',
                        choices=['none', 'Sv', 'uSv'])
    parser.add_argument('--dis_DA', type=str, default='none',
                        choices=['none', 'DAN', 'JAN', 'CORAL'])
    parser.add_argument('--adv_DA', type=str, default='none',
                        choices=['none', 'RevGrad'])
    parser.add_argument('--use_bn', type=str, default='none',
                        choices=['none', 'AdaBN', 'AutoDIAL'])
    parser.add_argument('--ens_DA', type=str, default='none',
                        choices=['none', 'MCD'])
    parser.add_argument('--use_attn_frame', type=str, default='none',
                        choices=['none', 'TransAttn', 'general'])
    parser.add_argument('--use_attn', type=str, default='none',
                        choices=['none', 'TransAttn', 'general'])
    parser.add_argument('--n_attn', type=int, default=1)
    parser.add_argument('--add_loss_DA', type=str, default='none',
                        choices=['none', 'target_entropy',
                                 'attentive_entropy'])
    parser.add_argument('--pred_normalize', type=str, default='N',
                        choices=['Y', 'N'])
    parser.add_argument('--alpha', default=1, type=float)
    parser.add_argument('--beta', default=[1, 1, 1], type=float, nargs="+")
    parser.add_argument('--gamma', default=1, type=float)
    parser.add_argument('--mu', default=0, type=float)
    parser.add_argument('--weighted_class_loss_DA', type=str, default='N',
                        choices=['Y', 'N'])
    parser.add_argument('--place_dis', default=['Y', 'Y', 'N'], type=str,
                        nargs="+")
    parser.add_argument('--place_adv', default=['Y', 'Y', 'Y'], type=str,
                        nargs="+")

    # ---- learning (opts.py:71-91) ----
    parser.add_argument('--pretrain_source', default=False,
                        action="store_true")
    parser.add_argument('--epochs', default=100, type=int)
    parser.add_argument('-b', '--batch_size', default=[32, 28, 64],
                        type=int, nargs="+")
    parser.add_argument('--lr', '--learning_rate', default=0.0001,
                        type=float)
    parser.add_argument('--lr_decay', default=10, type=float)
    parser.add_argument('--lr_adaptive', type=str, default='none',
                        choices=['none', 'loss', 'dann'])
    parser.add_argument('--lr_steps', default=[60, 100], type=float,
                        nargs="+")
    parser.add_argument('--momentum', default=0.9, type=float)
    parser.add_argument('--weight_decay', '--wd', default=1e-4, type=float)
    parser.add_argument('--clip_gradient', '--gd', default=20, type=float)
    parser.add_argument('--copy_list', default=['N', 'Y'], type=str,
                        nargs="+")

    # ---- monitor (opts.py:93-100) ----
    parser.add_argument('--print_freq', '-pf', default=10, type=int)
    parser.add_argument('--show_freq', '-sf', default=10, type=int)
    parser.add_argument('--eval_freq', '-ef', default=1, type=int)
    parser.add_argument('--verbose', default=False, action="store_true")

    # ---- runtime (opts.py:102-118) ----
    parser.add_argument('-j', '--workers', default=2, type=int,
                        help='accepted so that a JAX command line runs '
                             'unchanged; no effect (the port has no '
                             'prefetch thread)')
    parser.add_argument('--resume', default='', type=str)
    parser.add_argument('--resume_hp', default=False, action="store_true")
    parser.add_argument('-e', '--evaluate', dest='evaluate',
                        action='store_true')
    parser.add_argument('--exp_path', type=str, default="")
    parser.add_argument('--flow_prefix', default="", type=str)
    parser.add_argument('--save_model', default=False, action="store_true")
    parser.add_argument('--save_best_log', default="best.log", type=str)
    parser.add_argument('--save_attention', type=int, default=-1)
    parser.add_argument('--tensorboard', dest='tensorboard',
                        action='store_true')

    # ---- TPU-native additions (no reference equivalent) ----
    parser.add_argument('--store_source', type=str, default=None,
                        help='packed FeatureStore dir for source training '
                             'features (default: dirname of the list file)')
    parser.add_argument('--store_target', type=str, default=None)
    parser.add_argument('--store_val', type=str, default=None)
    parser.add_argument('--feature_dim', type=int, default=None,
                        help='override the backbone feature dim table')
    parser.add_argument('--compute_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--num_devices', type=int, default=None,
                        help='use only the first N devices of the mesh')
    parser.add_argument('--profile_dir', type=str, default=None,
                        help='write a torch.profiler trace (Chrome '
                             'trace JSON: Perfetto, TensorBoard) of steps '
                             '2-7 of the first epoch, or of the second '
                             'call with --steps_per_call > 1, into this '
                             'directory')
    parser.add_argument('--compilation_cache', type=str, default=None,
                        help='accepted so that a JAX command line runs '
                             'unchanged; no effect (the port compiles no '
                             'XLA programs)')
    parser.add_argument('--device_store', default=False,
                        action='store_true',
                        help='keep the packed feature stores on the card '
                             'and gather batches there (only indices '
                             'cross from the host)')
    parser.add_argument('--steps_per_call', type=int, default=1,
                        help='optimizer steps per call of the train '
                             'step: K index batches stacked and uploaded '
                             'once per call; device_store only (1 with '
                             '--save_attention or --pretrain_source)')
    parser.add_argument('--store_budget_rows', type=int, default=0,
                        help='larger-than-memory streaming: at most this '
                             'many feature-store rows per shard on the '
                             'card, the next shard uploaded on a side '
                             'stream meanwhile (device_store only; 0 = '
                             'fully resident). Peak device residency is 2 '
                             'shards (current + prefetched)')
    parser.add_argument('--device_sampler', default=False,
                        action='store_true',
                        help='make the index batches on the card (epoch '
                             'orders and TSN sampling as torch ops inside '
                             'the K-step call): no per-step host sampling '
                             'or index upload. Requires --device_store '
                             'and --steps_per_call > 1. With '
                             '--store_budget_rows, batches are made '
                             'shard-locally against the shard on the card '
                             '(bitwise the host loader\'s in '
                             'deterministic modes without shuffle); '
                             'random sampling and shuffled orders come '
                             'from a counter-keyed integer hash '
                             '(deterministic per seed, bitwise equal on '
                             'the CPU and the card, distribution-equal to '
                             'the host sampler)')
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='tensor parallelism degree: devices form a '
                             '(data x model) mesh; large dense kernels '
                             'are column-sharded over the model axis '
                             '(XLA inserts the collectives). 1 = pure '
                             'data parallelism')
    parser.add_argument('--accum_steps', type=int, default=1,
                        help='gradient accumulation: average gradients '
                             'over this many consecutive micro-batch '
                             'pairs before ONE optimizer update '
                             '(effective batch = accum_steps * -b; '
                             'capability absent in the reference). '
                             'Host-feed path only (ignored with '
                             '--device_store / --steps_per_call > 1)')
    parser.add_argument('--no_nan_guard', default=False,
                        action='store_true',
                        help='disable the divergence guard (by default a '
                             'non-finite training loss aborts with an '
                             'emergency checkpoint at the next metric '
                             'flush; the reference trains on through NaN)')
    parser.add_argument('--store_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16', 'int8'],
                        help='dtype of the HBM-resident feature store '
                             '(device_store only): bfloat16 halves HBM '
                             'residency and per-step gather bytes; int8 '
                             'quarters them (per-row symmetric '
                             'quantization, dequantized on device); '
                             'rows are cast to --compute_dtype after '
                             'the gather')
    parser.add_argument('--seed', type=int, default=1,
                        help='global seed (the reference hardcodes 1, '
                             'main.py:24-26)')
    parser.add_argument('--prng_impl', type=str, default='rbg',
                        choices=['rbg', 'threefry2x32'],
                        help='accepted so that a JAX command line runs '
                             'unchanged; no effect (dropout draws from a '
                             'torch.Generator seeded from --seed; '
                             'ROADMAP.md queue 1, item 11)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to train on (default cuda; '
                             'without a CUDA device the CLI exits rather '
                             'than train on the CPU: pass --device cpu)')
    return parser


def configs_from_args(args, num_class: int):
    val_segments = args.val_segments if args.val_segments > 0 \
        else args.num_segments
    model_cfg = ModelConfig(
        num_class=num_class,
        baseline_type=args.baseline_type,
        frame_aggregation=args.frame_aggregation,
        modality=args.modality,
        train_segments=args.num_segments,
        val_segments=val_segments,
        base_model=args.arch,
        feature_dim=args.feature_dim,
        dropout_i=args.dropout_i,
        dropout_v=args.dropout_v,
        use_bn=args.use_bn if args.use_target != 'none' else 'none',
        ens_DA=args.ens_DA if args.use_target != 'none' else 'none',
        add_fc=args.add_fc,
        fc_dim=args.fc_dim,
        n_rnn=args.n_rnn,
        rnn_cell=args.rnn_cell,
        n_directions=args.n_directions,
        n_ts=args.n_ts,
        use_attn=args.use_attn,
        n_attn=args.n_attn,
        use_attn_frame=args.use_attn_frame,
        share_params=args.share_params,
        compute_dtype=args.compute_dtype,
    )
    da_cfg = DAConfig(
        use_target=args.use_target,
        dis_DA=args.dis_DA,
        adv_DA=args.adv_DA,
        add_loss_DA=args.add_loss_DA,
        ens_DA=args.ens_DA,
        pretrain_source=args.pretrain_source,
        place_dis=tuple(args.place_dis),
        place_adv=tuple(args.place_adv),
        weighted_class_loss=args.weighted_class_loss,
        weighted_class_loss_DA=args.weighted_class_loss_DA,
        pred_normalize=args.pred_normalize,
    )
    train_cfg = TrainConfig(
        optimizer=args.optimizer,
        lr=args.lr,
        lr_decay=args.lr_decay,
        lr_adaptive=args.lr_adaptive,
        lr_steps=tuple(args.lr_steps),
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        clip_gradient=args.clip_gradient,
        epochs=args.epochs,
        batch_size=tuple(args.batch_size),
        copy_list=tuple(args.copy_list),
        alpha=args.alpha,
        beta=tuple(args.beta),
        gamma=args.gamma,
        mu=args.mu,
    )
    # reference validation (main.py:44-47)
    if (da_cfg.dis_DA != 'none' and da_cfg.use_target != 'none'
            and len(da_cfg.place_dis) != model_cfg.add_fc + 2):
        raise ValueError('len(place_dis) should be equal to add_fc + 2')
    return model_cfg, da_cfg, train_cfg
