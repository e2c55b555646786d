"""Standalone evaluation CLI of the port: the reference `test_models.py`,
as `ta3n_tpu.cli.test_models` runs it, on one card or, with
``--data_parallel``, on every visible card from this one process.

    python -m ta3n_tpu_torch.cli.test_models CLASS_FILE MODALITY \
        TEST_LIST WEIGHTS.pth.tar [flags...]

The positionals, flags and defaults are the JAX CLI's, plus ``--device``
(default ``cuda``; without a CUDA device the CLI exits with an error
rather than run on the CPU: pass ``--device cpu``) and ``--compute_dtype``
(default float32, the JAX CLI's only compute dtype; bfloat16 evaluates a
model as the train CLI's ``--compute_dtype bfloat16`` trained it).
``--quantize int8`` evaluates with W8A8 int8 inference, at float32
compute, from host features or a store on the card (whose rows are then
gathered plain, K3 not launched, for the quantized first FC).
WEIGHTS is a reference-format ``.pth.tar``: the original code's, one that the port's
Trainer wrote, or a JAX checkpoint exported with
``python -m ta3n_tpu.cli.export_checkpoint DIR out.pth.tar``.

The frame baseline, the default, is scored on its frame logits averaged
over the segments, as in the JAX CLI.

Outputs: the ``average ... sec/video`` and ``Pred@k`` lines, the confusion
PNG and per-class top-K txt (``--save_confusion``), the attention txt
(``--save_attention``) and the scores ``.npz`` sorted by video path
(``--save_scores``).  With ``--device_store`` the test store is uploaded
once, as float32, bfloat16 or int8 (``--store_dtype``; a store quantized
on disk uploads its own int8 rows), and the whole test set runs in one
call, gathered on the device, with one fetch.  With ``--store_budget_rows
N`` as well the store goes to the card in shards of at most N rows
(`data/streaming.py`), the next one uploaded while the current one is
evaluated; the batches of each shard run in one call with one fetch, and
the outputs are put back in the list's order, so that they are those of
the resident store.

``--data_parallel`` (`parallel/mesh.py`, the JAX CLI's single-controller
mesh): one model replica a card of ``parallel.make_mesh()`` (with
``--device cpu``, one CPU replica), ``--bS`` rounded up to a card
multiple with JAX's message (the mask covers the padding), every batch
split into one row block a card, and a store (or each streamed shard)
uploaded to every card.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.data import (FeatureStore, TSNLoader, load_class_names,
                                 parse_list_file)
from ta3n_tpu_torch.data.streaming import ShardPlan, ShardStream
from ta3n_tpu_torch.io_utils.confusion import (confusion_matrix,
                                               per_class_topk_accuracy,
                                               plot_confusion_matrix)
from ta3n_tpu_torch.io_utils.convert import load_reference_checkpoint
from ta3n_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple
from ta3n_tpu_torch.train.step import make_infer_step


def build_parser():
    parser = argparse.ArgumentParser(
        description="Standard video-level testing (PyTorch port)")
    parser.add_argument('class_file', type=str)
    parser.add_argument('modality', type=str,
                        choices=['RGB', 'Flow', 'RGBDiff', 'RGBDiff2',
                                 'RGBDiffplus'])
    parser.add_argument('test_list', type=str)
    parser.add_argument('weights', type=str)
    parser.add_argument('--arch', type=str, default="resnet101")
    parser.add_argument('--test_segments', type=int, default=5)
    parser.add_argument('--add_fc', default=1, type=int)
    parser.add_argument('--fc_dim', type=int, default=512)
    parser.add_argument('--baseline_type', type=str, default='frame',
                        choices=['frame', 'video', 'tsn'])
    parser.add_argument('--frame_aggregation', type=str, default='avgpool',
                        choices=['avgpool', 'rnn', 'temconv', 'trn', 'trn-m',
                                 'none'])
    parser.add_argument('--dropout_i', type=float, default=0)
    parser.add_argument('--dropout_v', type=float, default=0)
    parser.add_argument('--n_rnn', default=1, type=int)
    parser.add_argument('--rnn_cell', type=str, default='LSTM')
    parser.add_argument('--n_directions', type=int, default=1)
    parser.add_argument('--n_ts', type=int, default=5)
    parser.add_argument('--share_params', type=str, default='Y',
                        choices=['Y', 'N'])
    parser.add_argument('--use_bn', type=str, default='none',
                        choices=['none', 'AdaBN', 'AutoDIAL'])
    parser.add_argument('--use_attn_frame', type=str, default='none')
    parser.add_argument('--use_attn', type=str, default='none')
    parser.add_argument('--n_attn', type=int, default=1)
    parser.add_argument('--top', default=[1, 3, 5], nargs='+', type=int)
    parser.add_argument('--verbose', default=False, action="store_true")
    parser.add_argument('--save_confusion', type=str, default=None)
    parser.add_argument('--save_scores', type=str, default=None)
    parser.add_argument('--save_attention', type=str, default=None)
    parser.add_argument('--max_num', type=int, default=-1)
    parser.add_argument('--bS', default=2, type=int)
    parser.add_argument('--flow_prefix', type=str, default='')
    parser.add_argument('--store', type=str, default=None,
                        help='packed FeatureStore dir (default: dirname of '
                             'the test list)')
    parser.add_argument('--feature_dim', type=int, default=None)
    parser.add_argument('--device_store', default=False,
                        action='store_true',
                        help='keep the feature store on the card; gather on '
                             'the device (indices-only host traffic)')
    parser.add_argument('--store_budget_rows', type=int, default=0,
                        help='larger-than-memory streaming (with '
                             '--device_store): the store goes to the card '
                             'in shards of at most this many rows, two on '
                             'the card at a time; 0 = resident')
    parser.add_argument('--store_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16', 'int8'],
                        help='dtype of the store on the card (device_store '
                             'only): bfloat16 halves its bytes; int8 '
                             'quarters them (per-row symmetric '
                             'quantization, dequantized by the gather '
                             'kernel)')
    parser.add_argument('--compute_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='the model\'s compute dtype (the JAX CLI '
                             'evaluates in float32)')
    parser.add_argument('--quantize', type=str, default='none',
                        choices=['none', 'int8'],
                        help='int8: run the Linears whose dims reach 128 as '
                             'W8A8 dynamically quantized int8 products '
                             '(per-channel weight / per-row activation '
                             'scales); logits heads stay float32')
    parser.add_argument('--data_parallel', default=False,
                        action='store_true',
                        help='split every batch over every visible card, '
                             'one replica a card, from this process')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to evaluate on (default cuda)')
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    mesh = None
    if args.data_parallel:
        mesh = make_mesh() if device.type == "cuda" else Mesh([device])
        device = mesh.device
        padded = pad_to_multiple(args.bS, mesh.size)
        if padded != args.bS:
            print(f"--data_parallel: batch size {args.bS} -> {padded} "
                  f"({mesh.size}-device multiple; mask covers the "
                  f"padding)")
            args.bS = padded
    class_names = load_class_names(args.class_file)
    num_class = len(class_names)

    model_cfg = ModelConfig(
        num_class=num_class, baseline_type=args.baseline_type,
        frame_aggregation=args.frame_aggregation, modality=args.modality,
        train_segments=args.test_segments, val_segments=args.test_segments,
        base_model=args.arch, feature_dim=args.feature_dim,
        dropout_i=args.dropout_i, dropout_v=args.dropout_v,
        use_bn=args.use_bn, add_fc=args.add_fc, fc_dim=args.fc_dim,
        n_rnn=args.n_rnn, rnn_cell=args.rnn_cell,
        n_directions=args.n_directions, n_ts=args.n_ts,
        use_attn=args.use_attn, n_attn=args.n_attn,
        use_attn_frame=args.use_attn_frame, share_params=args.share_params,
        quantize=args.quantize, compute_dtype=args.compute_dtype)
    model = load_reference_checkpoint(args.weights, model_cfg, device).eval()
    meta = torch.load(args.weights, map_location="cpu", weights_only=True)
    print("model epoch {} prec@1: {}".format(meta.get("epoch"),
                                             meta.get("prec1")))

    records = parse_list_file(args.test_list)
    store_dir = args.store or os.path.dirname(
        os.path.abspath(args.test_list))
    store = FeatureStore.load(store_dir)
    loader = TSNLoader(store, records, batch_size=args.bS,
                       num_segments=args.test_segments,
                       new_length=model_cfg.sample_new_length, mode="test",
                       shuffle=False)
    # k clamped to the class count (e.g. --top 1 3 5 on 3 classes)
    max_top = min(max(args.top), num_class)
    infer = make_infer_step(model, max_top,
                            gather_on_device=args.device_store, mesh=mesh)
    # over a grid, the store (or each shard) on every card of it
    devices = mesh.devices if mesh is not None and mesh.size > 1 else None
    streaming = bool(args.device_store and args.store_budget_rows)
    if streaming:
        plan = ShardPlan(store.offsets, args.store_budget_rows)
        streams = [ShardStream(store.features, plan, d, args.store_dtype,
                               scales=store.scales)
                   for d in (devices or [device])]

        def shard(sid):
            got = [s.get(sid) for s in streams]
            return got if devices else got[0]
    elif args.device_store:
        store_dev = ([store.to_device(d, args.store_dtype) for d in devices]
                     if devices else store.to_device(device,
                                                     args.store_dtype))

    all_scores, all_labels, all_topk, all_attn = [], [], [], []
    positions = None  # the videos' places in the list, where not 0..n-1
    start = time.time()
    count = 0

    def accumulate(b, probs, top_i, attn):
        nonlocal count
        n_real = int(b.mask.sum())
        all_scores.append(probs[:n_real])
        all_topk.append(top_i[:n_real])
        all_labels.append(np.asarray(b.labels)[:n_real])
        all_attn.append(np.asarray(attn)[:n_real].reshape(n_real, -1))
        count += n_real
        return args.max_num > 0 and count >= args.max_num

    def fetch(outs):
        probs, _, top_i, attn = outs
        return (probs.cpu().numpy(), top_i.cpu().numpy(),
                attn.cpu().numpy())

    if streaming:
        # each shard's batches in one call and one fetch, in shard order
        # (as the JAX CLI runs them), then the videos back in list order
        order = np.concatenate(loader._shard_groups(plan))
        by_shard = {}
        for sid, b in loader.shard_index_epoch(plan):
            by_shard.setdefault(sid, []).append(b)
        for sid, bs in by_shard.items():
            probs_a, top_i_a, attn_a = fetch(infer(
                shard(sid), np.stack([b.abs_indices for b in bs]),
                np.stack([b.mask for b in bs])))
            for bi, b in enumerate(bs):
                if accumulate(b, probs_a[bi], top_i_a[bi], attn_a[bi]):
                    break
            if args.max_num > 0 and count >= args.max_num:
                break
        back = np.argsort(order[:count], kind="stable")
        for out in (all_scores, all_topk, all_labels, all_attn):
            out[:] = [np.concatenate(out)[back]]
        positions = order[:count][back]
    elif args.device_store:
        bs_all = list(loader.index_epoch())
        if args.max_num > 0:
            # run no batch past the --max_num cap
            need, total = 0, 0
            for b in bs_all:
                need += 1
                total += int(b.mask.sum())
                if total >= args.max_num:
                    break
            bs_all = bs_all[:need]
        probs_a, top_i_a, attn_a = fetch(infer(
            store_dev, np.stack([b.abs_indices for b in bs_all]),
            np.stack([b.mask for b in bs_all])))
        for bi, b in enumerate(bs_all):
            if accumulate(b, probs_a[bi], top_i_a[bi], attn_a[bi]):
                break
    else:
        for b in loader.epoch():
            if accumulate(b, *fetch(infer(b.features))):
                break

    scores = np.concatenate(all_scores)
    topk = np.concatenate(all_topk)
    labels = np.concatenate(all_labels)
    attn_values = np.concatenate(all_attn)
    elapsed = time.time() - start
    print('average %f sec/video' % (elapsed / max(count, 1)))

    # top-K accuracy (test_models.py:176-185)
    final_line = ''
    for j in args.top:
        hit = np.any(topk[:, :j] == labels[:, None], axis=1).mean()
        final_line += 'Pred@{:d} {:.02f}% '.format(j, hit * 100)
    print(final_line)

    if args.save_attention:
        np.savetxt(args.save_attention + '.txt', attn_values, fmt="%s")

    if args.save_confusion:
        cm = confusion_matrix(labels, topk[:, 0], num_class)
        plot_confusion_matrix(args.save_confusion + '.png', cm,
                              classes=class_names, normalize=True,
                              title='Normalized confusion matrix')
        cls_acc = per_class_topk_accuracy(labels, topk, num_class, args.top)
        with open(args.save_confusion + '-top' + str(args.top) + '.txt',
                  'w') as f:
            for i in range(num_class):
                f.write(' '.join(str(cls_acc[j][i])
                                 for j in range(len(args.top))) + ' \n')

    if args.save_scores is not None:
        # ordered by sorted video path (test_models.py:232-246), with the
        # scores themselves (the reference saves empty arrays)
        name_list = [r.path for r in records][:len(scores)]
        if positions is not None:
            name_list = [records[i].path for i in positions]
        order = np.argsort(np.array(name_list), kind="stable")
        np.savez(args.save_scores, scores=scores[order],
                 labels=labels[order])

    return final_line


if __name__ == '__main__':
    main()
