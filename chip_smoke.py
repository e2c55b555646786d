"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ta3n_tpu_torch/csrc (one nvcc per
source, in parallel), checks in their SASS that the tensor-core kernels
(K1, K2, K3) hold mma (HMMA) and cp.async (LDGSTS) instructions and their
bfloat16 variants on wgmma (K1 and K2 in bfloat16, K3 at bfloat16 compute)
HGMMA and no HMMA, and that no bfloat16 instance of K1's float32 kernel
is left, holds each kernel against its plain PyTorch version at the
flagship shapes and times both (K1 (infer) at batch 1 and the serve and
train batches, K2 also by its dx and dW families, K3 at the train and
eval shapes, each against the bound of the arithmetic it runs), then
drives the port's main paths at
the flagship widths (UCF->HMDB_full: trn-m over 5 segments, 2048-d features,
fc 512, TRN bottleneck 256, TransAttn, 12 classes, random weights from a
seed):
  * serving: the model served over HTTP at batch 64, and in process at
    batch 1 (a latency-first service), the answers checked against a
    plain-path forward of the same weights on the same card;
  * training: the published train step (uSv, RevGrad at three levels,
    attentive entropy, Nesterov SGD with DANN lr) at 128 source + 74
    target videos, 5 steps through the kernels checked against 5 steps of
    a copy whose TRN is the plain version, each step from the same
    parameters (rows moved by a relu mask flipped at a rounding tie let
    through, and named), then timed at the published dropout 0.5;
  * device-store training: synthetic feature stores of the published
    split sizes uploaded once, index batches from the loader, 5 steps
    whose gather + shared FC runs as the K3 kernel checked against 5
    steps of the host-feature step on the same batches, each step from
    the same parameters, then both timed at dropout 0.5;
  * device-store eval: one val epoch (6 batches of 64) through
    make_multi_eval_step against the host-feature eval step;
  * the TRN beyond 16 segments: K1 (infer) at B=64, K1 (train) and K2 at
    B=202, at S = 17 and 25, against their plain versions, and timed;
  * the eval CLI (`python -m ta3n_tpu_torch.cli.test_models`) on the
    synthetic val store and a seed model's `.pth.tar`, from host features
    and with --device_store, its scores held to a plain-path forward;
  * the Trainer through the train CLI (`python -m ta3n_tpu_torch.cli.train`)
    on synthetic stores of the published split sizes: 2 epochs from the
    device stores with --save_model, a --resume_hp run to epoch 3, one
    epoch from host features, and the eval CLI on its model_best.pth.tar,
    whose Pred@1 must be the best Prec@1 the Trainer printed;
  * the comparison configurations (COMPARISON: TemPooling source-only and
    with RevGrad, TA2N, general attention, AdaBN, AutoDIAL, MCD and
    share_params N with two shared FCs, Sv, target entropy and
    pred_normalize; TemPooling with DAN and with JAN, TA3N with DAN and
    with CORAL at all three layers, bidirectional two-layer LSTM and GRU
    aggregation, temconv with AdaBN, the frame baseline under the TA3N
    recipe and the tsn baseline over TemPooling) at the same widths and
    batch: 3 device-store steps of each against host-feature steps on the
    plain path, each step from the same parameters and with its launches
    checked, one val epoch from the store, the step timed and profiled
    (TA3N with DAN at all layers: also its peak memory); then AdaBN, MCD,
    TemPooling with JAN, the frame baseline and the flagship with
    --pretrain_source through the train CLI for one epoch and the eval CLI
    on its model_best.pth.tar (the frame baseline's with no
    --baseline_type flag, its default).
The bfloat16 compute path and the narrow stores (bf16 and int8): the
bfloat16 variants of K1 (infer) at B = 1, 64, 202, and of K1 (train) and
K2 at B = 202, at S = 5 and 17, and K3's five store x compute variants
beyond float32 x float32 at 640, 320, 37 and 0 rows, each against its
plain version in the same dtype and timed with it (K1 in bfloat16 also
at S = 17, K2 in bfloat16 at S = 17 and 25; at bfloat16 compute K3 also
at 370 rows and against index_select + mm in bfloat16, at float32
compute against index_select, the convert or dequantize and mm in
float32); the bfloat16 flagship
served by Predictors at batch 64 and 1 against their plain path; 5
bfloat16 device-store steps from an int8 and from a bfloat16 store
against the plain path from the same start (2 K3, 1 K1 (train), 1 K2 of
the bfloat16 variants a step), then timed and profiled; the train CLI
with --device_store --store_dtype int8 --compute_dtype bfloat16
--optimizer Adam for 2 epochs, the eval CLI on its best checkpoint
(Pred@1 the best Prec@1) and an --accum_steps 2 epoch from host features.
The chunked training modes at the flagship's widths: K = 4 steps per
call against 4 single steps from one start, the step timed at K = 1 and
K = 4 with its busy time, idle share and host-to-device copies; the
device sampler's val batches bitwise the host loader's, its random
batches bitwise equal on the card and the CPU, and a sampled K = 4 call
against the K-step call on the same indices; one epoch streamed in
shards (the source store in at least 3) bitwise against the resident
stores, with the shard uploads and their overlap with compute; the
train CLI for one epoch with --steps_per_call 4, with --device_sampler
as well, and streamed with --store_budget_rows and --device_sampler, its
launches per step and its Prec@1 against the resident single-step
Trainer's on the same weights; and the eval CLI streamed against the
resident run, bitwise.
Ensembles (N members in one step, train/ensemble.py): the member-batched
K1 (infer, train), K2 and K3 bitwise against N solo launches (B = 1, 64,
202; S = 5, 17; N = 1, 3, 8; K3 from one index set and one each) and
within RTOL of plain, timed at N = 1, 4, 8 against N solo launches; 5
device-store steps of a 4-member flagship ensemble (seeds 0-3, two lrs),
each member held to its solo step from the same start (the tie rule of
the other parity checks), with K3 2x, K1 (train) 1x and K2 1x a step and
no vmap fallback; the ensemble step timed against 4 solo steps in turns
with its profile; an ensemble val batch (K3 1x, K1 1x); a sweep's member
checkpoints served over HTTP by Predictor.from_sweep (the averaged
probabilities equal to the mean of the members' solo Predictors'); and
the sweep CLI for one epoch of 2 seeds x 2 lrs, then the eval CLI on a
member's checkpoint (its Pred@1 the member's reported top-1).  The same
phase in bfloat16: the bfloat16 member-batched K1 (infer, train) and K2
bitwise against N solo bfloat16 launches at the same (N, B, S) and
within one bfloat16 ulp of plain, K3 at bfloat16 compute from float32,
bfloat16 and int8 stores at N = 1, 3, 8, shared and per-member indices,
all timed at N = 1, 4, 8 (K3 also against index_select + matmul in
bfloat16 over the stacked weights); a 4-member bfloat16 flagship
ensemble from int8 stores, 5 steps, each member held to its solo
bfloat16 step by the bfloat16 steps' rule (check_updates), with no vmap
fallback, timed against 4 solo bfloat16 steps; a bfloat16 ensemble val
batch; from_sweep of bfloat16 members over HTTP; and cli.sweep
--compute_dtype bfloat16 --store_dtype int8 for one epoch, then the eval
CLI on member_00.
The serving extras and the feature extractor: int8_matmul at the
flagship's int8 shapes bitwise against the CPU; the int8 flagship served
over HTTP at batch 64 and in process at batch 1 against the same weights'
int8 path on the CPU, with its int8 products a forward and no K1, JAX's
rule against float32 logged; a 2-member int8 from_sweep with no vmap
fallback; the int8 eval CLI from host features and from the store; float32
and int8 artifacts exported by cli.serve --export, loaded by
Predictor.from_exported on the card and served over HTTP against the live
Predictor; 640 videos through the pipelined Predictor against the chunks
fetched one call each, bitwise, timed in turns; ResNet-101 and C3D (both
activations) extracting features on the card against the CPU, the shards
packed by video2feature --finalize, frames/s and clips/s.
The last single-card modules: FeatureStore.gather through the native
host gather (data/native_gather.py, built with g++) bitwise the numpy
fancy index (the store's default) over every video of the three stores
as float32, float16 and int8, and timed against it at 128 x 5 and 74 x 5
(median of 41 in turns, beside the fancy index's rows into a reused
output), with the host-feature train step in turns with each; the val
split written as .t7 files, converted by cli.convert_features at float32
and int8 (bitwise the rows and FeatureStore.quantize), and the eval CLI
on the converted store printing the original's line; the train CLI for
one epoch with --profile_dir, single-step and at --steps_per_call 4, each
trace holding its window's K1 (train), K2 and K3 and nothing more; the
train CLI with --tensorboard through a recording tensorboardX (the JAX
tags, one embedding row per real video, Prec@1 equal to the run
without); and every entry point of python -m ta3n_tpu_torch imported.
Each path is run with the kernels' launch counts set to 0 just before it
and read just after.  Any failure exits non-zero; so does a machine
without a CUDA device.  The last line of the output is one JSON object:
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch
from torch import nn

from ta3n_tpu_torch.cli import convert_features as cli_convert_features
from ta3n_tpu_torch.cli import serve as cli_serve
from ta3n_tpu_torch.cli import sweep as cli_sweep
from ta3n_tpu_torch.cli import test_models as cli_test_models
from ta3n_tpu_torch.cli import train as cli_train
from ta3n_tpu_torch.cli.opts import build_parser, configs_from_args
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore, TSNLoader, make_domain_pair
from ta3n_tpu_torch.data import native_gather
from ta3n_tpu_torch.data.device_sampler import (DeviceSampler,
                                                StreamingDeviceSampler)
from ta3n_tpu_torch.data.streaming import ShardPlan, ShardStream
from ta3n_tpu_torch.io_utils.checkpoint import save_checkpoint
from ta3n_tpu_torch.io_utils.convert import (export_reference_state,
                                             load_reference_checkpoint)
from ta3n_tpu_torch.models import VideoModel
from ta3n_tpu_torch.models import layers
from ta3n_tpu_torch.models.layers import torch_default_uniform_
from ta3n_tpu_torch.ops import _build, gather_gemm, relation, trn_fused
from ta3n_tpu_torch.ops.relation import build_relation_plan
from ta3n_tpu_torch.prep import video2feature
from ta3n_tpu_torch.serve import Predictor, make_http_server
from ta3n_tpu_torch.train import (StepScalars, TrainState, make_eval_step,
                                  make_multi_train_step,
                                  make_sampled_multi_step,
                                  make_multi_eval_step, make_train_step)
from ta3n_tpu_torch.train.ensemble import (ensemble_generators,
                                           extract_member,
                                           make_ensemble_eval_step,
                                           make_ensemble_step, stack_members,
                                           stack_scalars)
from ta3n_tpu_torch.train.loop import Trainer, build_loaders
from ta3n_tpu_torch.train.optim import make_optimizer
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress

FLAGSHIP = ModelConfig(
    num_class=12, baseline_type="video", frame_aggregation="trn-m",
    train_segments=5, val_segments=5, feature_dim=2048, fc_dim=512,
    use_attn="TransAttn", dropout_i=0.0, dropout_v=0.0)
SERVE_BATCH = 64
REQUEST_SIZES = (1, 37, 130)   # 130 videos span three padded chunks
TRN_CASES = ((1, 5, 512, 256), (64, 5, 512, 256), (202, 5, 512, 256),
             (13, 4, 37, 19))  # (B, S, D, H); the last one ragged
TIMED_BATCHES = (1, 64, 202)  # single-video serving, serving, training
RTOL = 1e-4                    # |kernel - plain| <= RTOL * max(1, |plain|)
PROB_TOL = 1e-5
# the published training recipe (BASELINE.md:25)
DA = DAConfig(use_target="uSv", adv_DA="RevGrad",
              add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
TRAIN = TrainConfig(lr=0.03, lr_adaptive="dann", batch_size=(128, 74, 64),
                    beta=(0.75, 0.75, 0.5), gamma=0.003)
TRAIN_STEPS = 5                # parity steps, kernel TRN against plain TRN
TIMED_STEPS = 20
STEP_RTOL = 2e-4               # per-step losses (tests/test_train_parity_*)
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)
# the published UCF->HMDB_full split sizes: source train, target train, val
SPLITS = dict(num_source=1438, num_target=840, num_val=360)
K3_CASES = (640, 370, 320, 37, 1, 0)   # rows: train source/target, eval
K3_TIMED = ((640, True), (320, False))  # (rows, with x_res): train, eval
# K3 at bfloat16 compute: the source and target train batches, and eval
K3_BF16_TIMED = ((640, True), (370, True), (320, False))
EVAL_RTOL = 1e-5               # the val epoch's summed loss
MANY_FRAMES = (17, 25)         # segments beyond the earlier cap of 16
CLI_BATCH = 128                # the eval CLI's --bS and the val batch
# the flagship's flags on the command line of the CLIs
MODEL_FLAGS = ["--baseline_type", "video", "--frame_aggregation", "trn-m",
               "--use_attn", "TransAttn", "--fc_dim", "512",
               "--feature_dim", "2048"]
# the published recipe on the train CLI's command line (BASELINE.md:25)
RECIPE_FLAGS = ["--num_segments", "5", "--use_target", "uSv",
                "--adv_DA", "RevGrad", "--place_adv", "Y", "Y", "Y",
                "--add_loss_DA", "attentive_entropy", "--gamma", "0.003",
                "--beta", "0.75", "0.75", "0.5", "--lr", "0.03",
                "--lr_adaptive", "dann", "-b", "128", "74", str(CLI_BATCH),
                "--dropout_i", "0.5", "--dropout_v", "0.5", "-pf", "4"]
# the comparison rows of the paper (BASELINE.md) and of the JAX package's
# baseline configurations (tests/test_baseline_configs.py), at the flagship
# widths: name -> (model fields beyond the flagship's, DAConfig fields,
# launches of one device-store step: K3, K1 (train), K2)
RECIPE = dict(use_target="uSv", adv_DA="RevGrad",
              add_loss_DA="attentive_entropy", place_adv=("Y", "Y", "Y"))
COMPARISON = {
    "tempooling_source_only": (
        dict(frame_aggregation="avgpool", use_attn="none"),
        dict(use_target="none"), (2, 0, 0)),
    "tempooling_revgrad": (
        dict(frame_aggregation="avgpool", use_attn="none"),
        dict(use_target="uSv", adv_DA="RevGrad", place_adv=("N", "N", "Y")),
        (2, 0, 0)),
    "ta2n": (dict(use_attn="none"), RECIPE, (2, 1, 1)),
    "trn_m_general": (dict(use_attn="general", use_attn_frame="TransAttn"),
                      RECIPE, (2, 1, 1)),
    "adabn": (dict(use_bn="AdaBN"), RECIPE, (2, 1, 1)),
    "autodial": (dict(use_bn="AutoDIAL"), RECIPE, (2, 1, 1)),
    "mcd": (dict(ens_DA="MCD"), {**RECIPE, "ens_DA": "MCD"}, (2, 2, 2)),
    "share_n": (dict(share_params="N", add_fc=2),
                dict(use_target="Sv", adv_DA="RevGrad",
                     add_loss_DA="target_entropy", pred_normalize="Y",
                     place_adv=("Y", "Y", "Y")), (2, 1, 1)),
    # the discrepancy losses (BENCH_NOTES.md "DAN stabilized"), DAN and
    # CORAL at every layer of the flagship: at 128 + 74 videos, 74 pairs
    # of 5 x 512 shared features, a 148 x 148 x 2560 difference
    "tempooling_dan": (dict(frame_aggregation="avgpool", use_attn="none"),
                       dict(use_target="uSv", dis_DA="DAN",
                            place_dis=("Y", "Y", "N")), (2, 0, 0)),
    "tempooling_jan": (dict(frame_aggregation="avgpool", use_attn="none"),
                       dict(use_target="uSv", dis_DA="JAN"), (2, 0, 0)),
    "ta3n_dan_all": (dict(), {**RECIPE, "dis_DA": "DAN",
                              "place_dis": ("Y", "Y", "Y")}, (2, 1, 1)),
    "ta3n_coral_all": (dict(), {**RECIPE, "dis_DA": "CORAL",
                                "place_dis": ("Y", "Y", "Y")}, (2, 1, 1)),
    # the aggregations of the paper's ablation: RNN (3 chunks of round(5/3)
    # = 2 frames, the last repeated; 2 chunks of round(2.5) = 2, the last
    # frame dropped) and temconv
    "rnn_bilstm": (dict(frame_aggregation="rnn", rnn_cell="LSTM", n_rnn=2,
                        n_directions=2, n_ts=3, use_attn="none"),
                   dict(use_target="uSv", adv_DA="RevGrad",
                        place_adv=("N", "Y", "Y")), (2, 0, 0)),
    "rnn_gru": (dict(frame_aggregation="rnn", rnn_cell="GRU", n_ts=2,
                     use_attn="none"),
                dict(use_target="uSv", adv_DA="RevGrad",
                     place_adv=("N", "Y", "Y")), (2, 0, 0)),
    "temconv_adabn": (dict(frame_aggregation="temconv", use_bn="AdaBN",
                           use_attn="none"),
                      dict(use_target="uSv", adv_DA="RevGrad",
                           place_adv=("N", "Y", "Y")), (2, 0, 0)),
    # the frame and tsn baselines
    "frame_ta3n": (dict(baseline_type="frame"), RECIPE, (2, 1, 1)),
    "tsn_tempooling": (dict(baseline_type="tsn", frame_aggregation="avgpool",
                            use_attn="none"),
                       dict(use_target="uSv", adv_DA="RevGrad",
                            place_adv=("N", "N", "Y")), (2, 0, 0)),
}
COMPARISON_STEPS = 3           # parity steps per configuration
COMPARISON_TIMED = 10          # timed steps per configuration
COMPARISON_MU = 0.5            # MCD's GRL strength in those steps
COMPARISON_ALPHA = 1.0         # the discrepancy weight (opts.py default)
# AutoDIAL's alpha in the seed model: round(128 * 0.75) = 96 source and
# round(74 * 0.75) = 56 (55.5, half to even) target videos to their own BN,
# the rest mixed (at its init value 1 nothing mixes)
AUTODIAL_ALPHA = 0.75
# the configurations taken through the train CLI and the eval CLI: their
# train flags beyond MODEL_FLAGS and RECIPE_FLAGS (the later of a repeated
# flag counts), their eval flags beyond MODEL_FLAGS (None: MODEL_FLAGS
# without --baseline_type, so that the eval CLI takes its default, frame),
# and the launches of one batch of their epochs: K3, K1 (train), K2, and
# K1 (infer) per val batch
AVGPOOL_FLAGS = ["--frame_aggregation", "avgpool", "--use_attn", "none"]
COMPARISON_CLI = {
    "adabn": (["--use_bn", "AdaBN"], ["--use_bn", "AdaBN"], (2, 1, 1, 1)),
    "mcd": (["--ens_DA", "MCD", "--mu", "0.5"], [], (2, 2, 2, 1)),
    "tempooling_jan": (AVGPOOL_FLAGS + ["--dis_DA", "JAN", "--adv_DA",
                                        "none", "--add_loss_DA", "none"],
                       AVGPOOL_FLAGS, (2, 0, 0, 0)),
    "frame_ta3n": (["--baseline_type", "frame"], None, (2, 1, 1, 1)),
    # the classification-only step before each train step: twice the
    # launches of a flagship batch
    "pretrain_source": (["--pretrain_source"], [], (4, 2, 2, 1)),
}
# NVIDIA H100 SXM data sheet (700 W): dense TF32 tensor-core peak and HBM
# rate
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the rate of each kernel's arithmetic: all run three TF32 tensor-core
# products per f32 product (3xTF32)
PEAK_OPS = {"trn_fused_fwd": PEAK_TF32 / 3,
            "trn_fused_fwd_train": PEAK_TF32 / 3,
            "trn_fused_bwd": PEAK_TF32 / 3, "gather_gemm": PEAK_TF32 / 3}
# kernels on the tensor cores through mma.sync, fed by cp.async: their
# SASS must hold HMMA and LDGSTS instructions (K1's epilogue,
# trn_fused_fwd_epilogue, is a plain sum)
TENSOR_CORE_KERNELS = ("trn_fused_fwd_kernel", "gather_gemm_kernel",
                       "trn_fused_bwd_kernel")
# the bfloat16 kernels on wgmma: HGMMA in their SASS and no HMMA; and the
# sources of the variants they run
WGMMA_KERNELS = ("gather_gemm_bf16_kernel", "trn_fused_bwd_bf16_kernel",
                 "trn_fused_fwd_bf16_kernel")
WGMMA_SOURCES = {
    "trn_fused_fwd_bf16": "ta3n_tpu_torch/csrc/trn_fused_fwd_bf16.cu",
    "trn_fused_fwd_train_bf16": "ta3n_tpu_torch/csrc/trn_fused_fwd_bf16.cu",
    "trn_fused_bwd_bf16": "ta3n_tpu_torch/csrc/trn_fused_bwd_bf16.cu",
    **{f"gather_gemm{s}_bf16": "ta3n_tpu_torch/csrc/gather_gemm_bf16.cu"
       for s in ("_f32", "_bf16", "_int8", "")}}
# the bfloat16 compute path and the narrow stores: the bfloat16 flagship,
# the dense bfloat16 tensor-core peak (H100 SXM data sheet, 700 W), and
# K3's variants beyond float32 x float32 ("{store}_{compute}")
BF16_FLAGSHIP = dataclasses.replace(FLAGSHIP, compute_dtype="bfloat16")
PEAK_BF16 = 989e12
K3_VARIANTS = ("bf16_f32", "int8_f32", "f32_bf16", "bf16_bf16", "int8_bf16")
# bfloat16 kernel against its plain version in bfloat16: one bfloat16 ulp
# of the element (at most 2**-7 of it: float32 sums on either side of a
# rounding midpoint round to neighbours) plus float32 summation-order
# differences at the tensor's scale, a tenth of RTOL
BF16_ULP, BF16_ABS = 2.0 ** -7, 1e-5
# a relu mask that the two sides flip at bfloat16 widths: the inputs of
# the TRN differ by an ulp where the two sides' shared FC rounded apart,
# which moves z by up to about 2**-8 of its terms, so a tie is |z| within
# 2**-6 of the largest
BF16_TIE_RTOL = 2.0 ** -6
# a bfloat16 step against the plain path from the same start: the losses
# are bfloat16 values (2**-8 apart) of bfloat16 activations; and each
# gradient is a sum over the batch of terms that carry bfloat16 roundings,
# which the two paths (K3 or cuBLAS, the TRN kernels or their plain
# versions) take an ulp apart here and there, so a row whose terms cancel
# can move by a percent of the tensor's largest update (3.4e-4 in a
# classifier row on the H100, where PARAM_TOL's atol is 2e-5): each
# tensor's update is held to BF16_UPDATE_RTOL of its largest
BF16_STEP_RTOL = 2e-2
BF16_UPDATE_RTOL = 5e-2
# probabilities (float32 softmax of bfloat16 logits) of the bfloat16
# Predictor against its plain path: logits an ulp or two apart
BF16_PROB_TOL = 2.0 ** -6
BF16_STEPS = 5
# K3 from a narrow store at float32 compute has a library counterpart of
# three calls: index_select, then this, then mm in float32
LIBRARY_CAST = {"bf16": "convert", "int8": "dequantize"}
# the chunked training modes: K steps per call, the timed steps of each
# run (in calls of K), and the shards the source store streams in (at
# least)
CHUNK_K = 4
CHUNK_TIMED = 20
CHUNK_SHARDS = 3
# ensembles: the members (seeds 0-3, two lrs) of the flagship ensemble,
# its parity steps and timed steps; the member-batched kernels against N
# solo launches at (N, B, S) for the TRN and (N, rows, per-member indices)
# for K3, and their times at N members
ENSEMBLE_SEEDS = (0, 1, 2, 3)
ENSEMBLE_LRS = (0.03, 0.01, 0.03, 0.01)
ENSEMBLE_STEPS = 5
ENSEMBLE_TIMED = 10
MEMBER_TRN_CASES = ((1, 64, 5), (3, 1, 5), (8, 64, 5), (3, 202, 5),
                    (8, 202, 5), (3, 202, 17))
MEMBER_K3_CASES = ((1, 640, False), (3, 640, False), (8, 640, False),
                   (4, 640, True), (8, 370, True), (3, 320, True))
# K3 at bfloat16 compute, from each store dtype: (N, per-member indices)
BF16_MEMBER_K3_CASES = ((1, False), (3, False), (8, False), (1, True),
                        (3, True), (8, True))
MEMBER_TIMED = (1, 4, 8)
# the member-batched kernels' entries of the kernels line: the kernel each
# extends (its source and TPU kernel) and its count, float32 and bfloat16
# (K3 at bfloat16 compute from any store as one, gather_gemm_bf16)
MEMBER_KERNELS = {"trn_fused_fwd_members": "trn_fused_fwd",
                  "trn_fused_fwd_train_members": "trn_fused_fwd_train",
                  "trn_fused_bwd_members": "trn_fused_bwd",
                  "gather_gemm_members": "gather_gemm",
                  "trn_fused_fwd_bf16_members": "trn_fused_fwd_bf16",
                  "trn_fused_fwd_train_bf16_members":
                      "trn_fused_fwd_train_bf16",
                  "trn_fused_bwd_bf16_members": "trn_fused_bwd_bf16",
                  "gather_gemm_bf16_members": "gather_gemm_bf16"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def build_kernels() -> float:
    t0 = time.perf_counter()
    out = _build.compile_library(_build.library_path())
    seconds = time.perf_counter() - t0
    for line in out.splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()
    return seconds


def check_sass() -> None:
    """Count the tensor-core (HMMA, and wgmma's HGMMA) and asynchronous-copy
    (LDGSTS) instructions of each kernel in the built library's SASS; fail
    unless every kernel of TENSOR_CORE_KERNELS has HMMA and LDGSTS, and
    every kernel of WGMMA_KERNELS HGMMA and no HMMA, and that K1's float32
    kernel has no bfloat16 instance left (trn_fused_fwd_bf16.cu took
    them)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0, 0]
        elif name is not None:
            counts[name][0] += " HMMA." in line
            counts[name][1] += " LDGSTS" in line
            counts[name][2] += " HGMMA." in line
    for name, (hmma, ldgsts, hgmma) in sorted(counts.items()):
        log(f"  sass: {hmma:4d} HMMA, {hgmma:4d} HGMMA, {ldgsts:4d} LDGSTS  "
            f"{name[:80]}")
    for kernel in TENSOR_CORE_KERNELS:
        # the mangled name holds the kernel's length-prefixed name
        found = [(n, c) for n, c in counts.items()
                 if f"{len(kernel)}{kernel}" in n]
        # an instance with 4-byte copies (template flag false, Lb0E) and
        # a bfloat16 operand stages that operand by plain loads: it needs
        # HMMA only
        if not found or not all(
                h and (g or ("Lb0E" in n and "nv_bfloat16" in n))
                for n, (h, g, _) in found):
            raise AssertionError(f"{kernel}: no HMMA or no LDGSTS in its "
                                 "SASS")
    for kernel in WGMMA_KERNELS:
        found = [c for n, c in counts.items()
                 if f"{len(kernel)}{kernel}" in n]
        if not found or not all(hg and not h for h, _, hg in found):
            raise AssertionError(f"{kernel}: no HGMMA, or HMMA, in its SASS")
    k1 = "trn_fused_fwd_kernel"
    if any(f"{len(k1)}{k1}" in n and "nv_bfloat16" in n for n in counts):
        raise AssertionError(f"{k1}: a bfloat16 instance is left")


def trn_inputs(b, s, d, h, gen, signed=False):
    """Non-negative x like the post-ReLU shared features (``signed``: of
    both signs, so that the backward's (x > 0) matters); weights and
    biases at torch's default Linear scale U(±1/sqrt(k*D))."""
    x = (torch.randn((b, s, d), generator=gen) if signed
         else torch.rand((b, s, d), generator=gen))
    weights, biases = [], []
    for k in build_relation_plan(s).scales:
        bound = 1.0 / math.sqrt(k * d)
        weights.append((torch.rand((h, k * d), generator=gen) * 2 - 1)
                       * bound)
        biases.append((torch.rand((h,), generator=gen) * 2 - 1) * bound)
    return (x.cuda(), [w.cuda() for w in weights],
            [bi.cuda() for bi in biases])


def device_ms(fn) -> float:
    """Device time of one call: the stream is kept busy while the host
    enqueues the call, so the events bracket device work only."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def call_ms(fn) -> float:
    """Time of one call as a caller sees it: host dispatch included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def host_ms(fn, n=20) -> float:
    """Host time to enqueue one call, the stream busy meanwhile."""
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / n


def check_trn_kernel(gen) -> float:
    worst = 0.0
    with torch.inference_mode():
        for b, s, d, h in TRN_CASES:
            x, w, bi = trn_inputs(b, s, d, h, gen)
            got = trn_fused.trn_multiscale_infer(x, w, bi, s)
            want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            torch.cuda.synchronize()
            if got.shape != (b, s - 1, h) or not torch.isfinite(got).all():
                raise AssertionError(f"kernel output bad at B={b}")
            err = (got - want).abs().max().item()
            tol = RTOL * max(1.0, want.abs().max().item())
            log(f"  B={b} S={s} D={d} H={h}: max|kernel-plain| = {err:.3e}"
                f" (tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain at "
                                     f"B={b}: {err} > {tol}")
            worst = max(worst, err)
    return worst


def time_trn(gen, runs=41, warmup=5):
    """Median times of kernel and plain at the flagship widths, taken in
    turns (plain, kernel, kernel, plain, ...)."""
    results = {}
    with torch.inference_mode():
        for b in TIMED_BATCHES:
            x, w, bi = trn_inputs(b, 5, 512, 256, gen)
            fns = {"kernel": lambda: trn_fused.trn_multiscale_infer(
                       x, w, bi, 5),
                   "plain": lambda: trn_fused.trn_multiscale_plain(
                       x, w, bi, 5)}
            for fn in fns.values():
                for _ in range(warmup):
                    fn()
            meters = {"device": device_ms, "call": call_ms, "host": host_ms}
            times = {(name, kind): [] for name in fns for kind in meters}
            for i in range(runs):
                order = ("plain", "kernel") if i % 2 == 0 else \
                    ("kernel", "plain")
                for name in order:
                    for kind, meter in meters.items():
                        times[(name, kind)].append(meter(fns[name]))
            med = {key: statistics.median(v) for key, v in times.items()}
            results[b] = med
            for name in fns:
                log(f"  B={b} {name}: " + ", ".join(
                    f"{kind} {med[(name, kind)]:.4f} ms" for kind in meters)
                    + f" (medians of {runs})")
    return results


def grid_inputs(b, s, d, h, rng):
    """x, weights, biases and an upstream gradient on dyadic grids small
    enough that every product and partial sum of the forward and the
    backward is exact in float32 at these widths: any summation order
    gives the same bits, so kernel and plain must agree exactly, masks
    included."""
    def grid(lo, hi, shape, step):
        return torch.from_numpy(
            (rng.integers(lo, hi + 1, shape) * step).astype(np.float32)
        ).cuda()

    x = grid(-8, 16, (b, s, d), 2.0 ** -4)
    weights = [grid(-16, 16, (h, k * d), 2.0 ** -8)
               for k in build_relation_plan(s).scales]
    biases = [grid(-64, 64, (h,), 2.0 ** -12) for _ in weights]
    return x, weights, biases, grid(-128, 128, (b, s - 1, h), 2.0 ** -8)


def preacts(x, weights, biases, s):
    """z of every subset, [B, n_sub*H], in the masks' layout; in float32
    from bfloat16 inputs (the kernels' z)."""
    plan = build_relation_plan(s)
    b, _, d = x.shape
    zs = []
    up = (lambda t: t.float()) if x.dtype == torch.bfloat16 else \
        (lambda t: t)
    for w, bias, k, subsets in zip(weights, biases, plan.scales,
                                   plan.subsets):
        idx = torch.as_tensor(subsets.reshape(-1), device=x.device)
        g = up(x)[:, idx].reshape(b, subsets.shape[0], k * d)
        zs.append((torch.relu(g) @ up(w).T + up(bias)).reshape(b, -1))
    return torch.cat(zs, dim=1)


def check_train_kernels(gen):
    """K1 (train) against trn_multiscale_fwd_masks_plain and K2 against
    trn_multiscale_bwd_plain at every case: float inputs within the
    tolerance (K2 from the kernel's masks on both sides), exact inputs
    bit for bit, masks included, and K2 bitwise equal on a second call.
    Returns the largest error of each on the float inputs."""
    rng = np.random.default_rng(1)
    worst = {"fwd": 0.0, "bwd": 0.0}
    with torch.no_grad():
        for b, s, d, h in TRN_CASES:
            x, w, bi = trn_inputs(b, s, d, h, gen, signed=True)
            out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, s)
            torch.cuda.synchronize()
            if out.shape != (b, s - 1, h) or not torch.isfinite(out).all():
                raise AssertionError(f"K1 (train) output bad at B={b}")
            err = (out - want).abs().max().item()
            tol = RTOL * max(1.0, want.abs().max().item())
            differ = masks != want_masks
            z = preacts(x, w, bi, s)
            z_tol = RTOL * max(1.0, z.abs().max().item())
            ties = int(differ.sum())
            log(f"  K1 (train) B={b} S={s} D={d} H={h}: max|kernel-plain| "
                f"= {err:.3e} (tolerance {tol:.3e}); mask density "
                f"{masks.float().mean().item():.4f}; {ties} of "
                f"{masks.numel()} mask entries differ from plain")
            if not err <= tol:
                raise AssertionError(f"K1 (train) disagrees at B={b}")
            if ties and not (z[differ].abs() <= z_tol).all():
                raise AssertionError(f"K1 (train) masks differ at B={b} "
                                     "where z is not a rounding tie")
            worst["fwd"] = max(worst["fwd"], err)

            g = torch.randn((b, s - 1, h), generator=gen).cuda()
            got = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
            again = trn_fused.trn_multiscale_bwd(x, w, masks, g, s, 3)
            ref = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
            torch.cuda.synchronize()
            errs = []
            for name, a_, again_, r in zip(
                    ["dx"] + [f"dW{i}" for i in range(s - 1)]
                    + [f"db{i}" for i in range(s - 1)],
                    (got[0], *got[1], *got[2]),
                    (again[0], *again[1], *again[2]),
                    (ref[0], *ref[1], *ref[2])):
                e = (a_ - r).abs().max().item()
                t = RTOL * max(1.0, r.abs().max().item())
                if a_.shape != r.shape or not e <= t:
                    raise AssertionError(f"K2 {name} disagrees at B={b}: "
                                         f"{e} > {t}")
                if not torch.equal(a_, again_):
                    raise AssertionError(f"K2 {name} not bitwise "
                                         f"repeatable at B={b}")
                errs.append(e)
            log(f"  K2 B={b} S={s} D={d} H={h}: max|kernel-plain| over dx, "
                f"{s - 1} dW, {s - 1} db = {max(errs):.3e}; a second call "
                "is bitwise equal")
            worst["bwd"] = max(worst["bwd"], max(errs))

            gx, gw, gb, gg = grid_inputs(b, s, d, h, rng)
            out, masks = trn_fused.trn_multiscale_fwd_masks(gx, gw, gb, s)
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                gx, gw, gb, s)
            got = trn_fused.trn_multiscale_bwd(gx, gw, masks, gg, s, 3)
            ref = trn_fused.trn_multiscale_bwd_plain(gx, gw, want_masks, gg,
                                                     s)
            torch.cuda.synchronize()
            exact = [torch.equal(masks, want_masks), torch.equal(out, want)]
            exact += [torch.equal(a_, r) for a_, r in
                      zip((got[0], *got[1], *got[2]),
                          (ref[0], *ref[1], *ref[2]))]
            if not all(exact):
                raise AssertionError(f"kernels differ from plain on exact "
                                     f"inputs at B={b}: {exact}")
            log(f"  exact inputs B={b}: K1 (train) masks and output, K2 dx, "
                "dW and db bitwise equal to plain")
    return worst


def time_pair(fns, runs=41, warmup=5):
    """Median device time of each function, taken in turns (a, b, b, a,
    ...)."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    names = list(fns)
    for i in range(runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            times[name].append(device_ms(fns[name]))
    return {name: statistics.median(v) for name, v in times.items()}


def time_train_kernels(gen, b=202):
    """Device times of K1 (train) and K2 against their plain versions at
    the train batch."""
    x, w, bi = trn_inputs(b, 5, 512, 256, gen, signed=True)
    g = torch.randn((b, 4, 256), generator=gen).cuda()
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
        fwd = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5),
            "plain": lambda: trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, 5)})
        bwd = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_bwd(x, w, masks, g, 5),
            "plain": lambda: trn_fused.trn_multiscale_bwd_plain(
                x, w, masks, g, 5)})
    for label, t in (("K1 (train)", fwd), ("K2", bwd)):
        log(f"  B={b} {label}: kernel {t['kernel']:.4f} ms, plain "
            f"{t['plain']:.4f} ms device (medians of 41, in turns)")
    return fwd, bwd


def trn_work(b, s=5, d=512, h=256, esize=4):
    """FLOPs and the least bytes of the TRN kernels at these shapes, with
    x, the weights, the biases, g and the outputs of ``esize`` bytes (4
    float32, 2 bfloat16): each input read once, each output written
    once."""
    plan = build_relation_plan(s)
    n_sub = sum(len(sub) for sub in plan.subsets)
    flops = 2 * b * h * d * sum(len(sub) * k
                                for k, sub in zip(plan.scales, plan.subsets))
    w_bytes = esize * h * d * sum(plan.scales)
    b_bytes = esize * h * len(plan.scales)
    x_bytes, out_bytes = esize * b * s * d, esize * b * (s - 1) * h
    mask_bytes = b * n_sub * h
    fwd_bytes = x_bytes + w_bytes + b_bytes + out_bytes
    return {
        "trn_fused_fwd": (flops, fwd_bytes),
        "trn_fused_fwd_train": (flops, fwd_bytes + mask_bytes),
        # x, g (the size of out), masks and W in; dx, dW and db out
        "trn_fused_bwd": (2 * flops, 2 * x_bytes + out_bytes + mask_bytes
                          + 2 * w_bytes + b_bytes),
    }


def bound(flops, nbytes, peak_ops):
    """The least time the card could take, in ms, and what sets it, for a
    kernel whose arithmetic runs at ``peak_ops`` FLOP/s."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class PlainTRN(nn.Module):
    """The TRN of a model, run through the plain PyTorch version."""

    def __init__(self, trn):
        super().__init__()
        self.trn = trn

    def forward(self, x, infer=False):
        seqs, dt = self.trn.fc_fusion_scales, self.trn.dtype
        return trn_fused.trn_multiscale_plain(
            x.to(dt), [q[1].weight.to(dt) for q in seqs],
            [q[1].bias.to(dt) for q in seqs], self.trn.num_frames,
            self.trn.subsample_num)


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def serve_flagship(gen, workdir):
    """Serve the flagship over HTTP, a warm-up round of requests and then
    the served round, and in process at batch 1; return the kernel
    launches of the served round and of the batch-1 calls."""
    model = VideoModel(FLAGSHIP, generator=gen)
    # redraw every weight at torch's default scale so that the outputs
    # are far from uniform and top-k means something
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            torch_default_uniform_(mod, gen)
    path = os.path.join(workdir, "flagship.pth.tar")
    torch.save({"epoch": 0, "arch": "resnet101", "best_prec1": 0.0,
                "prec1": 0.0,
                "state_dict": {f"module.{k}": v
                               for k, v in model.state_dict().items()}},
               path)
    predictor = Predictor.from_checkpoint(path, FLAGSHIP, device="cuda",
                                          batch_size=SERVE_BATCH)
    plain_model = copy.deepcopy(predictor.model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    plain = Predictor(FLAGSHIP, plain_model, batch_size=SERVE_BATCH,
                      device="cuda")

    rng = np.random.default_rng(0)
    requests = [rng.random((n, FLAGSHIP.val_segments,
                            FLAGSHIP.input_feature_dim), np.float32)
                for n in REQUEST_SIZES]
    names = [f"class_{i}" for i in range(FLAGSHIP.num_class)]
    server = make_http_server(predictor, names, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        bodies = [{"features": feats.tolist()} for feats in requests]
        for label in ("warm-up", "served"):
            reset_counts()
            answers = []
            for feats, body in zip(requests, bodies):
                t0 = time.perf_counter()
                answers.append(post(f"{url}/predict", body))
                log(f"  POST /predict ({label}), {feats.shape[0]} videos: "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        launches = counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"  TRN kernel launches while serving: {launches}")
    if launches["trn_fused_fwd_train"] or launches["trn_fused_bwd"] or \
            launches["gather_gemm"]:
        raise AssertionError("serving launched a kernel of another path")
    launches = launches["trn_fused_fwd"]
    if health != {"status": "ok", "num_class": 12, "segments": 5}:
        raise AssertionError(f"bad /healthz answer {health}")
    chunks = sum(-(-n // SERVE_BATCH) for n in REQUEST_SIZES)
    if launches != chunks:
        raise AssertionError(f"expected {chunks} TRN kernel launches "
                             f"while serving, counted {launches}")

    for feats, ans in zip(requests, answers):
        in_process = []
        for _ in range(5):
            t0 = time.perf_counter()
            probs, _, _ = predictor(feats)
            in_process.append((time.perf_counter() - t0) * 1e3)
        log(f"  Predictor call in process, {feats.shape[0]} videos: "
            f"{statistics.median(in_process):.2f} ms (median of 5)")
        ref_probs, ref_p, ref_i = plain(feats)
        if probs.shape != (feats.shape[0], 12) or \
                not np.isfinite(probs).all():
            raise AssertionError("bad probabilities")
        if not np.allclose(probs.sum(1), 1.0, atol=PROB_TOL):
            raise AssertionError("probabilities do not sum to 1")
        if not np.array_equal(np.asarray(ans["top_classes"]), ref_i):
            raise AssertionError("served top classes differ from the "
                                 "plain path")
        err = np.abs(np.asarray(ans["top_probs"]) - ref_p).max()
        log(f"  {feats.shape[0]} videos: top-5 classes equal the plain "
            f"path; max|top_p - plain| = {err:.3e}; mean top-1 "
            f"probability {ref_p[:, 0].mean():.3f}")
        if not err <= PROB_TOL:
            raise AssertionError(f"top probabilities differ: {err}")
    return launches + serve_single(predictor.model, plain, requests[0])


def serve_single(model, plain, feats, calls=5):
    """A latency-first service answers each video as it arrives: batch 1,
    no padding to 64, where K1 runs at B=1 and splits D
    (ops/trn_fused.py::_fwd_splits).  Time ``calls`` calls on one video
    and hold their answers to the plain path; return their K1 launches."""
    single = Predictor(FLAGSHIP, model, batch_size=1, device="cuda")
    single(feats)
    reset_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        probs, top_p, top_i = single(feats)
        times.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    _, ref_p, ref_i = plain(feats)
    err = np.abs(top_p - ref_p).max()
    log(f"  batch-1 Predictor, 1 video: {statistics.median(times):.2f} ms "
        f"in process (median of {calls}); K1 at B=1 in "
        f"{trn_fused._fwd_splits(5, 3, 1, 512, 256)} D slices; top-5 "
        f"classes equal the plain path: {np.array_equal(top_i, ref_i)}; "
        f"max|top_p - plain| = {err:.3e}; launches {launched}")
    if launched != {"trn_fused_fwd": calls, "trn_fused_fwd_train": 0,
                    "trn_fused_bwd": 0, "gather_gemm": 0}:
        raise AssertionError(f"expected {calls} K1 (infer) launches")
    if not np.array_equal(top_i, ref_i) or not err <= PROB_TOL or \
            not np.allclose(probs.sum(1), 1.0, atol=PROB_TOL):
        raise AssertionError("batch-1 answers differ from the plain path")
    return calls


def reset_counts():
    trn_fused.launches = trn_fused.train_launches = 0
    trn_fused.bwd_launches = 0
    gather_gemm.launches = 0
    trn_fused.bf16_launches = trn_fused.bf16_train_launches = 0
    trn_fused.bf16_bwd_launches = 0
    for variant in gather_gemm.variant_launches:
        gather_gemm.variant_launches[variant] = 0


def counts():
    return {"trn_fused_fwd": trn_fused.launches,
            "trn_fused_fwd_train": trn_fused.train_launches,
            "trn_fused_bwd": trn_fused.bwd_launches,
            "gather_gemm": gather_gemm.launches}


def bf16_counts():
    """The launches of the bfloat16 and narrow-store variants (the float32
    kernels' are counts())."""
    return {"trn_fused_fwd_bf16": trn_fused.bf16_launches,
            "trn_fused_fwd_train_bf16": trn_fused.bf16_train_launches,
            "trn_fused_bwd_bf16": trn_fused.bf16_bwd_launches,
            **{f"gather_gemm_{v}": gather_gemm.variant_launches[v]
               for v in K3_VARIANTS}}


def flagship_model(gen, dropout=0.0, **fields):
    """The flagship, or the flagship with other model ``fields``, on the
    card, every Linear redrawn at torch's default scale (as for serving),
    so that the losses and gradients are far from those of a near-zero
    network; AutoDIAL's alpha at AUTODIAL_ALPHA."""
    cfg = dataclasses.replace(FLAGSHIP, dropout_i=dropout, dropout_v=dropout,
                              **fields)
    model = VideoModel(cfg, generator=gen)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            torch_default_uniform_(mod, gen)
    if cfg.use_bn == "AutoDIAL":
        with torch.no_grad():
            model.alpha.fill_(AUTODIAL_ALPHA)
    return model.cuda()


def train_batch(seed=0):
    """128 source and 74 target videos of random 5x2048 features (numpy,
    seeded), on the card."""
    rng = np.random.default_rng(seed)
    bs, bt = TRAIN.batch_size[:2]
    shape = (FLAGSHIP.train_segments, FLAGSHIP.input_feature_dim)
    batch = (rng.random((bs, *shape), np.float32),
             rng.integers(0, FLAGSHIP.num_class, bs), np.ones(bs, np.float32),
             rng.random((bt, *shape), np.float32),
             rng.integers(0, FLAGSHIP.num_class, bt), np.ones(bt, np.float32))
    return [torch.as_tensor(a).cuda() for a in batch]


def scalars(i, total, beta_cfg):
    """The step's schedule values at step i of ``total``: DANN lr, and
    beta from ``beta_cfg`` (negative entries follow the DANN schedule)."""
    p = progress(i, 0, total)
    return StepScalars(effective_beta(beta_cfg, p), 0.0, 0.0, TRAIN.gamma,
                       dann_lr(TRAIN.lr, p))


def same_start(dst, src):
    """Make dst's parameters, buffers and momentum buffers copies of
    src's, so that the next step on each starts from the same point."""
    with torch.no_grad():
        for a, b in zip((*dst.model.parameters(), *dst.model.buffers()),
                        (*src.model.parameters(), *src.model.buffers())):
            if a.shape != b.shape:
                raise AssertionError("the two models differ in layout")
            a.copy_(b)
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))


def named(model):
    """A model's state by the names of the kernel model (the plain-TRN
    copy holds its TRN under TRN.trn)."""
    return {k.replace("TRN.trn.", "TRN."): v
            for k, v in model.state_dict().items()}


def check_metrics(i, got, want, ref, rtol=STEP_RTOL, abs_tol=0.0):
    """Hold one step's metrics to ``rtol`` (STEP_RTOL); the largest
    relative difference."""
    worst = 0.0
    for key in want:
        if not math.isfinite(got[key]) or not math.isclose(
                got[key], want[key], rel_tol=rtol, abs_tol=abs_tol):
            raise AssertionError(f"step {i}: {key} {got[key]} differs from "
                                 f"{ref} {want[key]}")
        worst = max(worst, abs(got[key] - want[key])
                    / max(abs(want[key]), 1e-30))
    return worst


def record_trn(model, calls=None):
    """Hook the model's TRN: at each forward, record its input x (the
    shared FC's output after its relu, so (x > 0) is that relu's mask), z
    of its subsets by the plain version, and the relu masks of its subsets
    as this side computed them: the kernel's, saved for its backward, or
    the plain TRN's.  The record holds the last forward's; ``calls``, a
    list, gets every forward's.  Returns the record and the hook's
    handle."""
    rec = {}
    plain = isinstance(model.TRN, PlainTRN)
    trn = model.TRN.trn if plain else model.TRN

    def hook(_, args, out):
        x = args[0].detach()
        ws = [q[1].weight.detach().to(trn.dtype)
              for q in trn.fc_fusion_scales]
        bs = [q[1].bias.detach().to(trn.dtype) for q in trn.fc_fusion_scales]
        with torch.no_grad():
            z = preacts(x, ws, bs, trn.num_frames)
            masks = (trn_fused.trn_multiscale_fwd_masks_plain(
                x, ws, bs, trn.num_frames, trn.subsample_num)[1] if plain
                     else out.grad_fn.saved_tensors[1])
        rec.update(x=x.clone(), z=z, masks=masks.clone())
        if calls is not None:
            calls.append(dict(rec))

    return rec, model.TRN.register_forward_hook(hook)


def trn_ties(ours, ref, rows, tie_rtol=RTOL):
    """Add to ``rows`` the TRN weight rows that a TRN relu mask flipped at
    a rounding tie may have moved (tie_rows); the number of masks
    flipped."""
    scale_of = [i for i, sub in enumerate(
        build_relation_plan(ref["x"].shape[1]).subsets) for _ in sub]
    h = ref["z"].shape[1] // len(scale_of)
    differ = ours["masks"] != ref["masks"]
    z = ref["z"].abs()
    if (differ & (z > tie_rtol * max(1.0, z.max().item()))).any():
        raise AssertionError("a TRN mask differs where z is not a rounding "
                             "tie")
    for b, col in differ.nonzero().tolist():
        i, u = scale_of[col // h], col % h
        for p in ("weight", "bias"):
            rows.setdefault(f"TRN.fc_fusion_scales.{i}.1.{p}", {})[u] = (
                f"TRN mask of video {b}, subset {col // h} flipped at "
                f"|z| = {z[b, col].item():.2e}")
    return int(differ.sum())


def relu_ties(ours, ref, names, rows, what="shared-FC relu",
              tie_rtol=RTOL):
    """Add to ``rows`` the rows u of the parameters ``names(b)`` (for
    video b) that a relu mask of unit u flipped at a rounding tie may have
    moved (a name given as (name, row) names that row whatever u);
    ``ours`` and ``ref`` are the relu's outputs, or its inputs, [B, S, F]
    on the two sides.  Raise where a mask differs at a value that is not
    a tie.  The number of masks flipped."""
    differ = (ours > 0) != (ref > 0)
    top = torch.maximum(ours, ref)
    if (differ & (top.float() > tie_rtol * max(1.0, ref.max().item()))
            ).any():
        raise AssertionError(f"a {what} mask differs where its input is "
                             "not a rounding tie")
    for b, f, u in differ.nonzero().tolist():
        for name in names(b):
            name, row = name if isinstance(name, tuple) else (name, u)
            rows.setdefault(name, {})[row] = (
                f"{what} of video {b}, frame {f} unit {u} flipped at "
                f"{top[b, f, u].item():.2e}")
    return int(differ.sum())


def tie_rows(ours, ref, tie_rtol=RTOL):
    """The parameter rows that a relu mask flipped at a rounding tie may
    have moved in this step, ``{name: {row: why}}``, and the number of
    masks flipped (TRN, shared FC), from the two sides' records (record_trn; ``ref`` gives z).  A TRN mask of subset s (scale
    i) and unit u feeds row u of scale i's weight and bias; a shared-FC
    relu mask of unit u feeds row u of the shared FC's weight and bias: a
    flip moves one video's term in that row's gradient, which may carry
    the row past PARAM_TOL after the step (on the H100: one TRN mask
    flipped at |z| = 5.0e-8 moved 5 entries of one row of W_2 by up to
    3.1e-5).  Raise where a mask differs at a value that is not a tie,
    beyond ``tie_rtol`` of the largest (RTOL; BF16_TIE_RTOL at bfloat16
    compute)."""
    rows = {}
    shared = ("fc_feature_shared_source.weight",
              "fc_feature_shared_source.bias")
    flipped = (trn_ties(ours, ref, rows, tie_rtol),
               relu_ties(ours["x"], ref["x"], lambda b: shared, rows,
                         tie_rtol=tie_rtol))
    return rows, flipped


def check_params(i, ours, ref, label, ties, tol=PARAM_TOL):
    """Hold the parameters after step i to ``tol`` (PARAM_TOL), all but
    the rows that ``ties`` (tie_rows) names, and log each of those let
    through.  Returns the largest difference of the rows held and the
    number let through."""
    ours, ref = named(ours), named(ref)
    worst, let_through = 0.0, 0
    for name, want in ref.items():
        diff = (ours[name] - want).abs()
        bound_at = tol["rtol"] * want.abs() + tol["atol"]
        beyond = (diff > bound_at).reshape(want.shape[0] if want.dim() else 1,
                                      -1).any(dim=1)
        rows = beyond.nonzero()[:, 0].tolist()
        allowed = ties.get(name, {})
        stray = [r for r in rows if r not in allowed]
        if stray:
            raise AssertionError(
                f"{name} after step {i} differs from {label} beyond the "
                f"tolerance in {len(stray)} rows fed by no rounding tie "
                f"(first {stray[:5]}), max|d| {diff.max().item():.3e}")
        for r in rows:
            log(f"    {name} row {r} let through, max|d| "
                f"{diff[r].max().item():.3e}: {allowed[r]}")
            diff[r] = 0.0
        let_through += len(rows)
        worst = max(worst, diff.max().item())
    return worst, let_through


def drift(runs, models):
    """How far two free-running trajectories from one start came apart:
    the largest relative difference of a metric over the steps and of the
    parameters at the end."""
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
              for a, b in zip(*runs) for k in b)
    ours, ref = named(models[0]), named(models[1])
    return rel, max((ours[k] - v).abs().max().item() for k, v in ref.items())


def run_free(net, make_step, batches, steps):
    """``steps`` steps of a fresh optimizer over ``batches`` (the step's
    arguments before its scalars); the metrics of each."""
    state = TrainState(net, make_optimizer(net.parameters(), TRAIN), 0)
    step, out = make_step(net), []
    for sc, args in zip(steps, batches):
        state, m = step(state, *args, sc, None)
        out.append({k: float(v) for k, v in m.items()})
    return out


def train_flagship(gen):
    """TRAIN_STEPS flagship steps through the kernels against the same
    steps of a copy whose TRN is the plain version, dropout 0, DANN lr and
    beta.  Before each step the kernel side takes the plain side's
    parameters and momentum (copied), and that step's metrics and updated
    parameters are held to STEP_RTOL and PARAM_TOL, but for the rows fed
    by a relu mask that the two sides flipped at a rounding tie
    (tie_rows): the check does not fork on summation order.  The drift of
    the two sides run free from one start is printed.  Returns the kernel
    launches of the kernel copy's steps."""
    model = flagship_model(gen)
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    free = (copy.deepcopy(model), copy.deepcopy(plain_model))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch()
    steps = [scalars(i, TRAIN_STEPS, (-1.0, -1.0, -1.0))
             for i in range(TRAIN_STEPS)]
    ker = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    ref = TrainState(plain_model, make_optimizer(plain_model.parameters(),
                                                 TRAIN), 0)
    ker_step = make_train_step(model, DA, TRAIN)
    ref_step = make_train_step(plain_model, DA, TRAIN)
    (rec, hook), (ref_rec, ref_hook) = map(record_trn, (model, plain_model))
    launches = dict.fromkeys(counts(), 0)
    worst_rel = worst = 0.0
    ties, flips = 0, (0, 0)
    for i, sc in enumerate(steps):
        same_start(ker, ref)
        reset_counts()
        ker, got = ker_step(ker, *batch, sc, None)
        torch.cuda.synchronize()
        launches = {k: n + counts()[k] for k, n in launches.items()}
        ref, want = ref_step(ref, *batch, sc, None)
        got = {k: float(v) for k, v in got.items()}
        want = {k: float(v) for k, v in want.items()}
        log(f"  step {i}: lr {sc.lr:.5f} beta {sc.beta[0]:.4f}: " + ", ".join(
            f"{k} {got[k]:.6f}/{want[k]:.6f}" for k in
            ("loss_c", "loss_a", "loss_e", "loss")) + " (kernel/plain)")
        worst_rel = max(worst_rel, check_metrics(i, got, want,
                                                 "the plain TRN's"))
        allowed, flipped = tie_rows(rec, ref_rec)
        diff, rows = check_params(i, model, plain_model, "the plain TRN's",
                                  allowed)
        worst, ties = max(worst, diff), ties + rows
        flips = tuple(map(sum, zip(flips, flipped)))
    hook.remove()
    ref_hook.remove()
    log(f"  each step from the same parameters: metrics within "
        f"{worst_rel:.3e} relative (tolerance {STEP_RTOL}), updated "
        f"parameters within {worst:.3e} (tolerance rtol "
        f"{PARAM_TOL['rtol']}, atol {PARAM_TOL['atol']}; relu masks "
        f"flipped at rounding ties: {flips[0]} TRN, {flips[1]} shared FC; "
        f"{ties} rows let through)")
    ours = model.state_dict()
    for name in ("fc_classifier_source.weight", "fc_classifier_source.bias"):
        if not torch.equal(ours[name], start[name]):
            raise AssertionError(f"{name} moved")
    moved = sum(not torch.equal(ours[k], start[k]) for k in ours)
    if moved != len(ours) - 2:
        raise AssertionError(f"{moved} of {len(ours)} parameters moved")
    runs = [run_free(net, lambda n: make_train_step(n, DA, TRAIN),
                     [batch] * TRAIN_STEPS, steps) for net in free]
    rel, param = drift(runs, free)
    log(f"  {moved} of {len(ours)} parameter tensors moved (all but "
        f"fc_classifier_source); run free from one start over "
        f"{TRAIN_STEPS} steps, kernel and plain drift apart by {rel:.3e} "
        f"relative in a metric and {param:.3e} in a parameter")
    log(f"  kernel launches in the kernel copy's {TRAIN_STEPS} steps: "
        f"{launches}")
    want_launches = {"trn_fused_fwd": 0, "trn_fused_fwd_train": TRAIN_STEPS,
                     "trn_fused_bwd": TRAIN_STEPS, "gather_gemm": 0}
    if launches != want_launches:
        raise AssertionError(f"expected {want_launches} launches")
    return launches


def device_profile(run, n, step_ms, label, top=8, copies=False):
    """Profile ``run(n)`` (n steps back to back): device time per step of
    the ``top`` kernels that take most, and the device's idle share
    against ``step_ms``, the unprofiled time of a step run back to back;
    with ``copies`` also the host-to-device copies per step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    idle = 1 - busy_ms / step_ms
    h2d = sum(e.count for e in kernels if "HtoD" in e.key) / n
    log(f"  profile of {n} {label}: device busy {busy_ms:.4f} ms per step, "
        f"{sum(e.count for e in kernels) // n} kernels per step; against "
        f"{step_ms:.3f} ms per step back to back, the device is idle "
        f"{100 * idle:.1f}% of the time"
        + (f"; {h2d:.2f} host-to-device copies per step" if copies else ""))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/step "
            f"{e.count // n:4d}x  {e.key[:90]}")
    return (busy_ms, idle, h2d) if copies else (busy_ms, idle)


def time_train_step(gen, warmup=3):
    """The published step (dropout 0.5, beta 0.75/0.75/0.5, DANN lr) with
    the kernel TRN and with the plain TRN, TIMED_STEPS steps each, in
    turns (plain, kernel, kernel, plain): median ms of a step (synchronised
    after each) and videos/s over the steps run back to back."""
    model = flagship_model(gen, dropout=0.5)
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    batch = train_batch(seed=1)
    videos = sum(TRAIN.batch_size[:2])
    runs = {}
    for name, net in (("kernel", model), ("plain", plain_model)):
        runs[name] = [TrainState(net, make_optimizer(net.parameters(),
                                                     TRAIN), 0),
                      make_train_step(net, DA, TRAIN),
                      torch.Generator("cuda").manual_seed(0)]
    times = {name: {"step_ms": [], "rate": []} for name in runs}

    def run(name, n, sync_each):
        state, step, rng = runs[name]
        per_step = []
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            state, metrics = step(state, *batch,
                                  scalars(state.step, 100, TRAIN.beta), rng)
            if sync_each:
                torch.cuda.synchronize()
                per_step.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_all
        runs[name][0] = state
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} step loss is not finite")
        return per_step, n * videos / seconds

    for name in runs:
        run(name, warmup, True)
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for name in order:
            per_step, _ = run(name, TIMED_STEPS, True)
            _, rate = run(name, TIMED_STEPS, False)
            times[name]["step_ms"] += per_step
            times[name]["rate"].append(rate)
    result = {}
    for name, t in times.items():
        result[name] = (statistics.median(t["step_ms"]),
                        statistics.median(t["rate"]))
        log(f"  {name} TRN: {result[name][0]:.3f} ms per step (median of "
            f"{len(t['step_ms'])}, synchronised each step); "
            f"{result[name][1]:.0f} videos/s ({TIMED_STEPS} steps back to "
            f"back, median of {len(t['rate'])})")

    # where the kernel step's time goes: device time by kernel over a few
    # steps, against the unprofiled time of a step run back to back
    device_profile(lambda n: run("kernel", n, False), 5,
                   videos / result["kernel"][1] * 1e3, "kernel-TRN steps")
    return result


def gather_case(n, num_rows, rng):
    """n indices into a store of num_rows rows with duplicates, the last
    row and two masked rows (the loader points them at row 0, scale 0),
    checked and uploaded; and their scales on the card."""
    idx = rng.integers(0, num_rows, n)
    scale = np.ones(n, np.float32)
    if n >= 6:
        idx[:3] = [idx[2], idx[2], num_rows - 1]
        idx[3:5], scale[3:5] = 0, 0.0
    return (gather_gemm.row_index(idx, num_rows, "cuda"),
            torch.from_numpy(scale).cuda())


def check_gather_kernel(store):
    """K3 against gathered_gemm_plain on the source store at every row
    count of K3_CASES: z within the tolerance, x_res (the scaled gathered
    rows) bitwise equal, a second call bitwise equal; then on a store and
    a weight on dyadic grids, where every f32 sum is exact, z bit for bit.
    Returns the largest error on the float inputs."""
    rng = np.random.default_rng(2)
    h, d = FLAGSHIP.fc_dim, store.shape[1]
    w = (torch.from_numpy(rng.uniform(-1, 1, (h, d)).astype(np.float32))
         / math.sqrt(d)).cuda()
    grid_store = torch.from_numpy(
        (rng.integers(-8, 17, (4096, d)) * 2.0 ** -4).astype(np.float32)
    ).cuda()
    grid_w = torch.from_numpy(
        (rng.integers(-16, 17, (h, d)) * 2.0 ** -8).astype(np.float32)
    ).cuda()
    worst = 0.0
    for n in K3_CASES:
        rows, scale = gather_case(n, store.shape[0], rng)
        z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale)
        again, _ = gather_gemm.gathered_gemm(store, rows, w, scale)
        want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows, w,
                                                       scale)
        grows, gscale = gather_case(n, grid_store.shape[0], rng)
        grid_z, _ = gather_gemm.gathered_gemm(grid_store, grows, grid_w,
                                              gscale)
        grid_want, _ = gather_gemm.gathered_gemm_plain(
            grid_store, grows.rows, grid_w, gscale)
        torch.cuda.synchronize()
        if z.shape != (n, h) or not torch.isfinite(z).all():
            raise AssertionError(f"K3 output bad at N={n}")
        err = (z - want).abs().max().item() if n else 0.0
        tol = RTOL * max(1.0, want.abs().max().item() if n else 0.0)
        exact = [torch.equal(x_res, want_x), torch.equal(z, again),
                 torch.equal(grid_z, grid_want)]
        log(f"  K3 N={n} D={d} H={h}: max|kernel-plain| = {err:.3e} "
            f"(tolerance {tol:.3e}); x_res equal to plain, second call "
            f"equal, exact inputs equal to plain: {exact}")
        if not err <= tol or not all(exact):
            raise AssertionError(f"K3 disagrees with plain at N={n}")
        worst = max(worst, err)
    return worst


def gather_work(rows, d, h, with_rows, store_size=4, compute_size=4):
    """FLOPs and the least bytes of K3 for these index rows: each distinct
    store row read once (``store_size`` bytes a value; an int8 row also
    its 4-byte scale), idx and scale read, W read once, z written and,
    with x_res, the gathered rows written (``compute_size`` bytes a
    value)."""
    n = rows.rows.shape[0]
    distinct = torch.unique(rows.rows).numel()
    nbytes = (distinct * (store_size * d + 4 * (store_size == 1)) + 8 * n
              + compute_size * (h * d + n * h + (n * d if with_rows else 0)))
    return 2 * n * d * h, nbytes


def time_gather(store):
    """Device times of K3, its plain version and the index_select + mm
    pair at the train (with x_res) and eval (without) row counts, 41 runs
    each in turns; the work and bound of each case."""
    rng = np.random.default_rng(3)
    h, d = FLAGSHIP.fc_dim, store.shape[1]
    w = (torch.rand((h, d), generator=torch.Generator().manual_seed(3))
         * 2 - 1).cuda() / math.sqrt(d)
    results = {}
    with torch.no_grad():
        for n, with_rows in K3_TIMED:
            rows, scale = gather_case(n, store.shape[0], rng)
            t = time_pair({
                "kernel": lambda: gather_gemm.gathered_gemm(
                    store, rows, w, scale, with_rows),
                "plain": lambda: gather_gemm.gathered_gemm_plain(
                    store, rows.rows, w, scale),
                "library": lambda: torch.mm(
                    store.index_select(0, rows.rows), w.t())})
            work = gather_work(rows, d, h, with_rows)
            results[n] = (t, work)
            least, by = bound(*work, PEAK_OPS["gather_gemm"])
            log(f"  K3 N={n} {'with' if with_rows else 'without'} x_res: "
                f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
                f"index_select + mm {t['library']:.4f} ms device; bound "
                f"{least:.4f} ms by {by} (medians of 41, in turns)")
    return results


def bwd_parts(x, w, masks, g, parts):
    """K2's tiles of one family (parts 1: dx, 2: dW/db) or both (3),
    through the C entry that takes the choice; not counted as a launch of
    the backward.  Returns (dx, dWs, dbs), each written only by its own
    family."""
    b, s, d = x.shape
    h = w[0].shape[0]
    dx = torch.zeros_like(x)
    dw = torch.zeros((sum(t.numel() for t in w),), device=x.device)
    db = torch.zeros((len(w), h), device=x.device)
    trn_fused._call("ta3n_trn_fused_bwd_parts_f32", x, x.data_ptr(),
                    *trn_fused._pointer_args(w, (), s, 3, x.device),
                    masks.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                    *trn_fused._plan_args(s, 3, x.device), b, s, d, h, parts)
    return dx, trn_fused._split_flat(dw, w), tuple(db.unbind())


def split_bwd(gen, b=202, n=20):
    """K2's device time by the profiler at the train batch: the dx tiles
    alone, the dW/db tiles alone and both in one grid (the backward), n
    launches each; each family alone must give the backward's bits.
    Returns ms per launch of each."""
    from torch.profiler import ProfilerActivity, profile
    x, w, bi = trn_inputs(b, 5, 512, 256, gen, signed=True)
    g = torch.randn((b, 4, 256), generator=gen).cuda()
    result = {}
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
        full = bwd_parts(x, w, masks, g, 3)
        dx_only, dw_only = bwd_parts(x, w, masks, g, 1), \
            bwd_parts(x, w, masks, g, 2)
        torch.cuda.synchronize()
        if not (torch.equal(dx_only[0], full[0]) and all(
                torch.equal(a, r) for a, r in
                zip((*dw_only[1], *dw_only[2]), (*full[1], *full[2])))):
            raise AssertionError("K2's families alone differ from the "
                                 "backward")
        for name, parts in (("dx", 1), ("dW", 2), ("both", 3)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    bwd_parts(x, w, masks, g, parts)
                torch.cuda.synchronize()
            result[name] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if "trn_fused_bwd_kernel" in e.key) / 1e3 / n
    log(f"  K2 at B={b} by the profiler: dx tiles alone "
        f"{result['dx']:.4f} ms, dW/db tiles alone {result['dW']:.4f} ms, "
        f"both in one grid {result['both']:.4f} ms (means of {n}; the "
        f"families alone sum to {result['dx'] + result['dW']:.4f} ms)")
    return result


def store_loaders(stores, seed=1):
    """Source and target loaders as the Trainer makes them ('test'
    sampling, shuffled): 128 + 74 videos a step."""
    bs, bt = TRAIN.batch_size[:2]
    s = FLAGSHIP.train_segments
    return (TSNLoader(stores[0], batch_size=bs, num_segments=s, seed=seed),
            TSNLoader(stores[1], batch_size=bt, num_segments=s,
                      seed=seed + 1))


def endless(epochs):
    """The batches of epoch after epoch: ``epochs`` is a loader's bound
    epoch() or index_epoch()."""
    while True:
        yield from epochs()


def train_device_store(gen, stores, dev):
    """TRAIN_STEPS device-store steps (index batches, K3 twice per step)
    against as many host-feature steps on the same batches, where the host
    gathers the features; dropout 0, DANN lr and beta.  Before each step
    the device-store side takes the host-feature side's parameters and
    momentum (copied), and that step's metrics and updated parameters are
    held to STEP_RTOL and PARAM_TOL, but for the rows fed by a relu mask
    that the two sides flipped at a rounding tie (tie_rows); the drift of
    the two run free from one start is printed.  Returns the kernel
    launches of the device-store steps."""
    model = flagship_model(gen)
    host_model = copy.deepcopy(model)
    free = (copy.deepcopy(model), copy.deepcopy(host_model))
    steps = [scalars(i, TRAIN_STEPS, (-1.0, -1.0, -1.0))
             for i in range(TRAIN_STEPS)]

    def index_batches():
        idx_s, idx_t = store_loaders(stores)
        return ((dev[0], *bs, dev[1], *bt) for bs, bt in
                zip(endless(idx_s.index_epoch), endless(idx_t.index_epoch)))

    def feature_batches():
        feat_s, feat_t = store_loaders(stores)
        return ((*hs, *ht) for hs, ht in
                zip(endless(feat_s.epoch), endless(feat_t.epoch)))

    state = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    step = make_train_step(model, DA, TRAIN, gather_on_device=True)
    host_state = TrainState(host_model,
                            make_optimizer(host_model.parameters(), TRAIN), 0)
    host_step = make_train_step(host_model, DA, TRAIN)
    (rec, hook), (ref_rec, ref_hook) = map(record_trn, (model, host_model))
    launches = dict.fromkeys(counts(), 0)
    worst_rel = worst = 0.0
    ties, flips = 0, (0, 0)
    for i, (sc, args, host_args) in enumerate(zip(steps, index_batches(),
                                                 feature_batches())):
        same_start(state, host_state)
        # each device-store step is counted alone; the host-feature
        # reference step after it is not counted
        reset_counts()
        state, got = step(state, *args, sc, None)
        torch.cuda.synchronize()
        launched = counts()
        if launched != {"trn_fused_fwd": 0, "trn_fused_fwd_train": 1,
                        "trn_fused_bwd": 1, "gather_gemm": 2}:
            raise AssertionError(f"step {i} launched {launched}")
        launches = {k: launches[k] + launched[k] for k in launches}
        host_state, want = host_step(host_state, *host_args, sc, None)
        got = {k: float(v) for k, v in got.items()}
        want = {k: float(v) for k, v in want.items()}
        log(f"  step {i}: " + ", ".join(
            f"{k} {got[k]:.6f}/{want[k]:.6f}" for k in
            ("loss_c", "loss_a", "loss_e", "loss"))
            + " (device store/host features); launched " + str(launched))
        worst_rel = max(worst_rel, check_metrics(
            i, got, want, "the host-feature step's"))
        allowed, flipped = tie_rows(rec, ref_rec)
        diff, rows = check_params(i, model, host_model,
                                  "the host-feature step's", allowed)
        worst, ties = max(worst, diff), ties + rows
        flips = tuple(map(sum, zip(flips, flipped)))
    hook.remove()
    ref_hook.remove()
    runs = [run_free(free[0], lambda n: make_train_step(
                n, DA, TRAIN, gather_on_device=True), index_batches(), steps),
            run_free(free[1], lambda n: make_train_step(n, DA, TRAIN),
                     feature_batches(), steps)]
    rel, param = drift(runs, free)
    log(f"  each step from the same parameters: metrics within "
        f"{worst_rel:.3e} relative (tolerance {STEP_RTOL}), updated "
        f"parameters within {worst:.3e} (tolerance rtol "
        f"{PARAM_TOL['rtol']}, atol {PARAM_TOL['atol']}; relu masks "
        f"flipped at rounding ties: {flips[0]} TRN, {flips[1]} shared FC; "
        f"{ties} rows let through); run free from "
        f"one start over {TRAIN_STEPS} steps, they drift apart by {rel:.3e} "
        f"relative in a metric and {param:.3e} in a parameter; "
        f"device-store launches {launches}")
    return launches


def time_store_steps(gen, stores, dev, warmup=3):
    """The published step (dropout 0.5) fed from the stores on the card
    (index batches) and from host-gathered features, each from its own
    loaders, TIMED_STEPS steps back to back in turns (host, device,
    device, host): videos/s over the real (unmasked) videos, and the
    device's idle share of each under the profiler."""
    model = flagship_model(gen, dropout=0.5)
    host_model = copy.deepcopy(model)
    idx_s, idx_t = store_loaders(stores, seed=5)
    feat_s, feat_t = store_loaders(stores, seed=5)
    runs = {
        "device store": [
            TrainState(model, make_optimizer(model.parameters(), TRAIN), 0),
            make_train_step(model, DA, TRAIN, gather_on_device=True),
            zip(endless(idx_s.index_epoch), endless(idx_t.index_epoch)),
            lambda bs, bt: (dev[0], *bs, dev[1], *bt)],
        "host features": [
            TrainState(host_model, make_optimizer(host_model.parameters(),
                                                  TRAIN), 0),
            make_train_step(host_model, DA, TRAIN),
            zip(endless(feat_s.epoch), endless(feat_t.epoch)),
            lambda bs, bt: (*bs, *bt)]}
    rngs = {name: torch.Generator("cuda").manual_seed(0) for name in runs}

    def run(name, n):
        state, step, batches, args = runs[name]
        videos = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            bs, bt = next(batches)
            videos += float(bs.mask.sum() + bt.mask.sum())
            state, metrics = step(state, *args(bs, bt),
                                  scalars(state.step, 100, TRAIN.beta),
                                  rngs[name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[name][0] = state
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} step loss is not finite")
        return videos / seconds, seconds * 1e3 / n

    for name in runs:
        run(name, warmup)
    rates = {name: [] for name in runs}
    for order in (("host features", "device store"),
                  ("device store", "host features")):
        for name in order:
            rates[name].append(run(name, TIMED_STEPS))
    result = {}
    for name, r in rates.items():
        rate = statistics.median(x[0] for x in r)
        step_ms = statistics.median(x[1] for x in r)
        log(f"  {name}: {rate:.0f} videos/s, {step_ms:.3f} ms per step "
            f"({TIMED_STEPS} steps back to back with their loader, median "
            f"of {len(r)})")
        busy, idle = device_profile(lambda n: run(name, n), 5, step_ms,
                                    f"{name} steps")
        result[name] = (rate, step_ms, busy, idle)
    return result


def eval_device_store(gen, val, dev_val, model=None):
    """One val epoch (batches of 64, the last one padded) through
    make_multi_eval_step on the store on the card, against the summed
    host-feature eval steps with the same weights: of ``model``, else of
    a flagship seed model.  Returns the kernel launches of the
    multi-batch eval."""
    model = model or flagship_model(gen)
    k1 = model.cfg.frame_aggregation == "trn-m"
    # the frame baseline's loss and counts are over frames
    per_video = (model.cfg.val_segments
                 if model.cfg.baseline_type == "frame" else 1)
    loader = TSNLoader(val, batch_size=TRAIN.batch_size[2],
                       num_segments=FLAGSHIP.val_segments, shuffle=False)
    ev = make_eval_step(model)
    want = {"loss_sum": 0.0, "top1": 0.0, "top5": 0.0, "n": 0.0}
    for batch in loader.epoch():
        m = ev(*batch)
        for key, value in (("loss_sum", m["loss"] * m["n"]),
                           ("top1", m["top1"]), ("top5", m["top5"]),
                           ("n", m["n"])):
            want[key] += float(value)
    stacked = [np.stack(a) for a in zip(*loader.index_epoch())]
    reset_counts()
    t0 = time.perf_counter()
    got = {k: float(v) for k, v in
           make_multi_eval_step(model)(dev_val, *stacked).items()}
    seconds = time.perf_counter() - t0
    launches = counts()
    nb = len(loader)
    log(f"  {nb} batches of {TRAIN.batch_size[2]} ({int(got['n'])} videos)"
        f" in {seconds * 1e3:.2f} ms (one fetch): loss_sum "
        f"{got['loss_sum']:.6f}/{want['loss_sum']:.6f}, top1 "
        f"{got['top1']:.0f}/{want['top1']:.0f}, top5 {got['top5']:.0f}/"
        f"{want['top5']:.0f}, n {got['n']:.0f}/{want['n']:.0f} (device "
        f"store/host features); launches {launches}")
    if any(got[k] != want[k] for k in ("top1", "top5", "n")) or \
            got["n"] != len(val.paths) * per_video or not math.isclose(
                got["loss_sum"], want["loss_sum"], rel_tol=EVAL_RTOL):
        raise AssertionError("the device-store val epoch differs from the "
                             "host-feature eval")
    if launches != {"trn_fused_fwd": nb * k1, "trn_fused_fwd_train": 0,
                    "trn_fused_bwd": 0, "gather_gemm": nb}:
        raise AssertionError(f"expected {nb} K3 launches and {nb * k1} K1 "
                             "(infer)")
    return launches


def trn_many_frames(gen):
    """K1 (infer) at B=64, K1 (train) and K2 at B=202, at the flagship
    widths and S = 17 and 25: each checked once against its plain version
    (K2 from the kernel's masks; the masks equal but at ties; on dyadic
    inputs bit for bit), then timed against it in turns.  Returns the
    launches of the checked calls and {S: {kernel: (ms, plain ms)}}."""
    relation.build_relation_plan.cache_clear()
    trn_fused._plan_table.cache_clear()
    t0 = time.perf_counter()
    trn_fused._plan_table(25, 3)
    log(f"  S=25 plan and kernel table built on the host in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms "
        f"({trn_fused._plan_table(25, 3).size} int32)")
    launches = dict.fromkeys(counts(), 0)
    rng = np.random.default_rng(4)
    results = {}
    for s in MANY_FRAMES:
        x, w, bi = trn_inputs(SERVE_BATCH, s, 512, 256, gen)
        with torch.inference_mode():
            reset_counts()
            got = trn_fused.trn_multiscale_infer(x, w, bi, s)
            torch.cuda.synchronize()
            launched = counts()
            want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            err = (got - want).abs().max().item()
            if not err <= RTOL * max(1.0, want.abs().max().item()):
                raise AssertionError(f"K1 (infer) disagrees at S={s}: {err}")
            infer_t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_infer(x, w, bi, s),
                "plain": lambda: trn_fused.trn_multiscale_plain(x, w, bi, s)})
        b = sum(TRAIN.batch_size[:2])
        x, w, bi = trn_inputs(b, s, 512, 256, gen, signed=True)
        g = torch.randn((b, s - 1, 256), generator=gen).cuda()
        with torch.no_grad():
            reset_counts()
            out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            dx, dws, dbs = trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
            torch.cuda.synchronize()
            launched = {k: launched[k] + n for k, n in counts().items()}
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, s)
            ref = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g, s)
            z = preacts(x, w, bi, s)
            fwd_err = (out - want).abs().max().item()
            differ = masks != want_masks
            bwd_err = max((a - r).abs().max().item() / max(
                1.0, r.abs().max().item()) for a, r in
                zip((dx, *dws, *dbs), (ref[0], *ref[1], *ref[2])))
            if not fwd_err <= RTOL * max(1.0, want.abs().max().item()) or \
                    not bwd_err <= RTOL or not (
                        z[differ].abs()
                        <= RTOL * max(1.0, z.abs().max().item())).all():
                raise AssertionError(f"K1 (train) or K2 disagrees at S={s}")
            gx, gw, gb, gg = grid_inputs(b, s, 512, 256, rng)
            gout, gmasks = trn_fused.trn_multiscale_fwd_masks(gx, gw, gb, s)
            gwant, gwant_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                gx, gw, gb, s)
            gbwd = trn_fused.trn_multiscale_bwd(gx, gw, gwant_masks, gg, s)
            gref = trn_fused.trn_multiscale_bwd_plain(gx, gw, gwant_masks,
                                                      gg, s)
            exact = [torch.equal(gout, gwant), torch.equal(gmasks, gwant_masks)]
            exact += [torch.equal(a, r) for a, r in zip(
                (gbwd[0], *gbwd[1], *gbwd[2]), (gref[0], *gref[1], *gref[2]))]
            if not all(exact):
                raise AssertionError(f"S={s}: kernels differ from plain on "
                                     "exact inputs")
            fwd_t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_fwd_masks(
                    x, w, bi, s),
                "plain": lambda: trn_fused.trn_multiscale_fwd_masks_plain(
                    x, w, bi, s)})
            bwd_t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_bwd(
                    x, w, masks, g, s),
                "plain": lambda: trn_fused.trn_multiscale_bwd_plain(
                    x, w, masks, g, s)})
        if launched != {"trn_fused_fwd": 1, "trn_fused_fwd_train": 1,
                        "trn_fused_bwd": 1, "gather_gemm": 0}:
            raise AssertionError(f"S={s} launched {launched}")
        launches = {k: launches[k] + n for k, n in launched.items()}
        slots = sum(n for _, _, n in trn_fused._fwd_units(s, 3))
        log(f"  S={s} ({slots} slots, K1 scratch "
            f"{slots * b * 256 * 4 / 1e6:.0f} MB at B={b}): max|kernel-plain|"
            f" K1 (infer) {err:.3e}, K1 (train) {fwd_err:.3e}, K2 "
            f"{bwd_err:.3e} relative; {int(differ.sum())} of {masks.numel()}"
            f" masks differ, at ties; exact inputs bitwise equal to plain")
        results[s] = {}
        for name, bb, t in (("trn_fused_fwd", SERVE_BATCH, infer_t),
                            ("trn_fused_fwd_train", b, fwd_t),
                            ("trn_fused_bwd", b, bwd_t)):
            least, by = bound(*trn_work(bb, s)[name], PEAK_OPS[name])
            results[s][name] = (t["kernel"], t["plain"], least)
            log(f"  S={s} {name} B={bb}: kernel {t['kernel']:.4f} ms, plain "
                f"{t['plain']:.4f} ms, bound {least:.4f} ms by {by} "
                "(device, medians of 41 in turns)")
    return launches, results


def write_workspace(root, stores):
    """The stores with their list files (as the JAX package writes them)
    and a class file of the flagship's 12 classes, under root."""
    for name, store in zip(("src", "tgt", "val"), stores):
        store.save(os.path.join(root, name))
        with open(os.path.join(root, name, "list.txt"), "w") as f:
            for r in store.records():
                f.write(f"{r.path} {r.num_frames} {r.label}\n")
    with open(os.path.join(root, "class.txt"), "w") as f:
        for i in range(FLAGSHIP.num_class):
            f.write(f"{i} class_{i}\n")


def run_cli(main_fn, argv):
    """Run a CLI's main in process; its return value and its output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    return result, buf.getvalue()


def eval_cli_args(root, weights, *extra, model_flags=MODEL_FLAGS):
    return [os.path.join(root, "class.txt"), "RGB",
            os.path.join(root, "val", "list.txt"), weights, *model_flags,
            "--test_segments", "5", "--bS", str(CLI_BATCH), "--top", "1",
            "3", "5", *extra]


def eval_cli(gen, root, val):
    """The eval CLI on the val store and a seed model's .pth.tar, from
    host features and with --device_store (scores, confusion and
    attention saved): its scores against a plain-path forward of the same
    weights, the two Pred@k lines equal, and its launches (host: one K1
    (infer) per batch; store: one K1 (infer) and one K3 per batch)."""
    model = flagship_model(gen)
    weights = os.path.join(root, "seed.pth.tar")
    torch.save({"epoch": 0, "arch": "resnet101", "best_prec1": 0.0,
                "prec1": 0.0,
                "state_dict": {f"module.{k}": v.cpu() for k, v in
                               model.state_dict().items()}}, weights)
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    plain = Predictor(FLAGSHIP, plain_model, batch_size=CLI_BATCH,
                      device="cuda")
    loader = TSNLoader(val, batch_size=CLI_BATCH, num_segments=5,
                       shuffle=False)
    feats = np.concatenate([b.features[:int(b.mask.sum())]
                            for b in loader.epoch()])
    want = plain(feats)[0][np.argsort(np.array(val.paths), kind="stable")]
    nb = len(loader)
    lines, launches = {}, dict.fromkeys(counts(), 0)
    for label, extra, k3 in (("host features", [], 0),
                             ("device store", ["--device_store"], nb)):
        prefix = os.path.join(root, label.replace(" ", "_"))
        reset_counts()
        t0 = time.perf_counter()
        line, out = run_cli(cli_test_models.main, eval_cli_args(
            root, weights, "--save_scores", prefix + "_scores",
            "--save_confusion", prefix + "_conf", "--save_attention",
            prefix + "_attn", *extra))
        seconds = time.perf_counter() - t0
        launched = counts()
        scores = np.load(prefix + "_scores.npz")["scores"]
        attn = np.loadtxt(prefix + "_attn.txt")
        err = np.abs(scores - want).max()
        log(f"  {label}: {line.strip()}; {out.splitlines()[-2].strip()}; "
            f"{seconds:.2f} s in main; max|scores - plain| = {err:.3e}; "
            f"attention {attn.shape}; launches {launched}")
        if scores.shape != want.shape or not err <= PROB_TOL or \
                attn.shape != (len(val.paths), 4) or not os.path.isfile(
                    prefix + "_conf-top[1, 3, 5].txt"):
            raise AssertionError(f"eval CLI ({label}) output is wrong")
        if launched != {"trn_fused_fwd": nb, "trn_fused_fwd_train": 0,
                        "trn_fused_bwd": 0, "gather_gemm": k3}:
            raise AssertionError(f"eval CLI ({label}) launched {launched}")
        lines[label] = line
        launches = {k: launches[k] + n for k, n in launched.items()}
    if len(set(lines.values())) != 1:
        raise AssertionError(f"the eval CLI's Pred@k lines differ: {lines}")
    return launches


@contextlib.contextmanager
def trainer_records():
    """Record every epoch and validation the Trainer runs: its kernel
    launches (counted from 0 over the call), its time (synchronised), and
    for an epoch its lr at entry, its steps and its real videos."""
    records = []
    epoch_fn, validate_fn = Trainer.train_epoch, Trainer.validate

    def timed(fn, self, kind, epoch):
        lr = self.lr_current
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, epoch)
        torch.cuda.synchronize()
        rec = {"kind": kind, "epoch": epoch, "lr": lr, "out": out,
               "seconds": time.perf_counter() - t0, "launches": counts(),
               "bf16_launches": bf16_counts(), "store": self.device_store}
        if kind == "train":
            rec["steps"] = (min(
                self.source_loader.shard_epoch_len(self._plan_s),
                self.target_loader.shard_epoch_len(self._plan_t))
                if self.streaming else min(len(self.source_loader),
                                           len(self.target_loader)))
            rec["videos"] = (self.source_loader.num_videos
                             + self.target_loader.num_videos)
        else:
            rec["batches"] = (self.val_loader.shard_epoch_len(self._plan_v)
                              if self.streaming else len(self.val_loader))
        records.append(rec)
        return out

    Trainer.train_epoch = lambda self, e: timed(epoch_fn, self, "train", e)
    Trainer.validate = lambda self, e: timed(validate_fn, self, "val", e)
    try:
        yield records
    finally:
        Trainer.train_epoch, Trainer.validate = epoch_fn, validate_fn


def check_trainer_launches(rec, per_batch=(2, 1, 1, 1)):
    """One parametrised check for every epoch and validation, from the
    launches of one batch ``per_batch`` (K3 from the stores, K1 (train),
    K2, K1 (infer) per val batch): per train batch those (the flagship: 2
    K3, 1 K1 (train), 1 K2; MCD two TRN forwards, --pretrain_source two
    steps), per val batch its K1 (infer) and, from the store, 1 K3."""
    k3, k1_train, k2, k1 = per_batch
    if rec["kind"] == "train":
        n = rec["steps"]
        want = {"trn_fused_fwd": 0, "trn_fused_fwd_train": n * k1_train,
                "trn_fused_bwd": n * k2,
                "gather_gemm": k3 * n * rec["store"]}
    else:
        n = rec["batches"]
        want = {"trn_fused_fwd": n * k1, "trn_fused_fwd_train": 0,
                "trn_fused_bwd": 0, "gather_gemm": n * rec["store"]}
    if rec["launches"] != want:
        raise AssertionError(f"{rec['kind']} epoch {rec['epoch']} launched "
                             f"{rec['launches']}, expected {want}")


def train_cli(root):
    """The Trainer through the train CLI on the stores under root: 2 epochs
    from the device stores with --save_model, then --resume_hp to epoch 3,
    then one epoch from host features; the launches of every epoch and
    validation checked; the resumed run's start (epoch 3, the saved lr,
    the log separator); the eval CLI on model_best.pth.tar against the
    best Prec@1 printed.  Returns the summed launches."""
    lists = [os.path.join(root, n, "list.txt") for n in ("src", "tgt", "val")]
    exp = os.path.join(root, "exp")
    ckpt = os.path.join(exp, "RGB", "checkpoint.pth.tar")

    def argv(exp_dir, *extra):
        return [os.path.join(root, "class.txt"), "RGB", *lists, *MODEL_FLAGS,
                *RECIPE_FLAGS, "--exp_path", exp_dir + "/",
                "--save_best_log", os.path.join(exp_dir, "best.log"), *extra]

    runs = (("device store, 2 epochs", argv(exp, "--device_store",
                                            "--save_model", "--epochs", "2")),
            ("device store, --resume_hp to epoch 3",
             argv(exp, "--device_store", "--save_model", "--epochs", "3",
                  "--resume", ckpt, "--resume_hp")),
            ("host features, 1 epoch", argv(os.path.join(root, "exp_host"),
                                            "--epochs", "1")))
    launches = dict.fromkeys(counts(), 0)
    best_seen = 0.0
    for i, (label, args) in enumerate(runs):
        if i == 1:
            saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        with trainer_records() as records:
            best, out = run_cli(cli_train.main, args)
        for rec in records:
            check_trainer_launches(rec)
            launches = {k: launches[k] + n
                        for k, n in rec["launches"].items()}
            if rec["kind"] == "train":
                log(f"  {label}: epoch {rec['epoch']} {rec['seconds']:.3f} s"
                    f", {rec['steps']} steps, {rec['videos']} videos, "
                    f"{rec['videos'] / rec['seconds']:.0f} videos/s (lr "
                    f"{rec['lr']:.5f} at entry; launches {rec['launches']})")
            else:
                log(f"  {label}: validation after epoch {rec['epoch']}: "
                    f"Prec@1 {rec['out']:.3f} in {rec['seconds'] * 1e3:.1f}"
                    f" ms ({rec['batches']} batches)")
                if i < 2:
                    best_seen = max(best_seen, rec["out"])
        log(f"  {label}: best {best:.3f}; "
            + out.strip().splitlines()[-1].strip())
        if i == 1:
            first = [r for r in records if r["kind"] == "train"][0]
            log_text = open(os.path.join(exp, "RGB", "train.log")).read()
            if first["epoch"] != 3 or first["lr"] != saved["lr_current"] or \
                    "========== start:" not in log_text or \
                    "=> loaded checkpoint" not in out:
                raise AssertionError(
                    f"the resumed run started at epoch {first['epoch']} with "
                    f"lr {first['lr']} (saved {saved['lr_current']})")
            log(f"  resumed at epoch 3 with the saved lr_current "
                f"{saved['lr_current']:.6f} and step {saved['step']}; "
                "train.log has the start separator")
    reset_counts()
    line, _ = run_cli(cli_test_models.main, eval_cli_args(
        root, os.path.join(exp, "RGB", "model_best.pth.tar"),
        "--device_store"))
    launched = counts()
    pred1 = float(line.split()[1].rstrip("%"))
    log(f"  eval CLI on model_best.pth.tar: {line.strip()} (best Prec@1 "
        f"printed {best_seen:.3f}); launches {launched}")
    if abs(pred1 - best_seen) > 0.006:
        raise AssertionError(f"Pred@1 {pred1} is not the best Prec@1 "
                             f"{best_seen}")
    return {k: launches[k] + launched[k] for k in launches}


def record_forwards(model):
    """Record every forward_shared call of ``model``: the outputs of its
    shared FC layers' relus [B, S, F] (StreamOutput.feat, both streams),
    with a multi-scale TRN the record_trn record of each, and with temconv
    the input of its relu [B, S, F] (temconv_pre).  Returns (calls,
    trn_calls, undo, temconv_calls)."""
    calls, trn_calls, temconv_calls = [], [], []
    inner, inner_temconv = model.forward_shared, model.temconv_pre
    layers = model.cfg.add_fc

    def forward_shared(*args, **kw):
        outs = inner(*args, **kw)
        calls.append([torch.cat([o.feat[-1 - l] for o in outs]).detach()
                      for l in range(layers)])
        return outs

    def temconv_pre(*args, **kw):
        out = inner_temconv(*args, **kw)
        temconv_calls.append(out.detach().clone())
        return out

    model.forward_shared = forward_shared
    model.temconv_pre = temconv_pre
    handle = (record_trn(model, trn_calls)[1]
              if model.cfg.frame_aggregation == "trn-m" else None)

    def undo():
        del model.forward_shared, model.temconv_pre
        if handle is not None:
            handle.remove()

    return calls, trn_calls, undo, temconv_calls


def comparison_ties(cfg, bs, ours, ref):
    """tie_rows for every forward of a step (two under MCD) of a
    comparison configuration: the TRN masks (trn_ties), the relu of each
    shared FC layer l, whose flip at unit u for video b may move row u of
    layer l's weight and bias of b's domain (both domains' under BN, whose
    statistics mix them) and, after the first layer with BN, entry u of
    both BNs' weight and bias; and temconv's relu."""
    rows, flips = {}, [0, 0]
    for o, r in zip(ours[1], ref[1]):
        flips[0] += trn_ties(o, r, rows)
    bn = cfg.use_bn != "none"
    for o_call, r_call in zip(ours[0], ref[0]):
        for layer, (o, r) in enumerate(zip(o_call, r_call)):
            suffix = "" if layer == 0 else f"_{layer + 1}"

            def names(b, suffix=suffix, layer=layer):
                if cfg.share_params == "Y":
                    doms = ("source",)
                elif bn:
                    doms = ("source", "target")
                else:
                    doms = ("source",) if b < bs else ("target",)
                out = [f"fc_feature_shared{suffix}_{d}.{p}" for d in doms
                       for p in ("weight", "bias")]
                if layer == 0 and bn:
                    out += [f"bn_shared_{t}.{p}" for t in "ST"
                            for p in ("weight", "bias")]
                return out

            flips[1] += relu_ties(o, r, names, rows,
                                  f"layer-{layer + 1} relu")
    # temconv's relu: z[b, f, u] is the TCL's (one 3-tap conv over the
    # frames, every unit) of units u of frames f-1..f+1, then under BN
    # entry u of the bn_1 pair; a flip moves the whole conv and row u of
    # the bn_1 pair and of the last shared layer (and of the shared BN)
    for o, r in zip(ours[3], ref[3]):
        last = "" if cfg.add_fc == 1 else f"_{cfg.add_fc}"

        def temconv_names(b, last=last):
            doms = ("source",) if cfg.share_params == "Y" else (
                "source", "target")
            out = [(f"tcl_3_1.conv2d.{p}", 0) for p in ("weight", "bias")]
            out += [f"fc_feature_shared{last}_{d}.{p}" for d in doms
                    for p in ("weight", "bias")]
            if bn:
                out += [f"bn_{n}_{t}.{p}" for n in ("1", "shared")
                        for t in "ST" for p in ("weight", "bias")]
            return out

        flips[1] += relu_ties(o, r, temconv_names, rows, "temconv relu")
    return rows, flips


def comparison_config(gen, name, stores, dev):
    """One comparison configuration at the flagship widths:
    COMPARISON_STEPS device-store steps (K3, and K1 (train) and K2 where
    the configuration has a multi-scale TRN) against as many host-feature
    steps of a copy on the plain path (its TRN the plain version), on the
    same batches, each step from the same parameters, BN statistics and
    momentum (same_start); the launches of each step against the table;
    metrics and updated parameters held as in train_device_store.  Then
    one val epoch from the store against the host-feature eval, and the
    device-store step timed and profiled at dropout 0.  Returns the
    launches and (ms per step, device busy ms per step, idle share)."""
    fields, da_fields, per_step = COMPARISON[name]
    da = DAConfig(**da_fields)
    model = flagship_model(gen, **fields)
    cfg = model.cfg
    plain = copy.deepcopy(model)
    if cfg.frame_aggregation == "trn-m":
        plain.TRN = PlainTRN(plain.TRN)
    elif cfg.frame_aggregation == "rnn":
        # a deep copy gives each RNN weight its own storage: back into one
        # buffer for cuDNN, as the model keeps them
        plain.rnn.flatten_parameters()
    steps = [scalars(i, COMPARISON_STEPS, (-1.0, -1.0, -1.0))._replace(
        mu=COMPARISON_MU, alpha=COMPARISON_ALPHA)
        for i in range(COMPARISON_STEPS)]
    ker = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    ref = TrainState(plain, make_optimizer(plain.parameters(), TRAIN), 0)
    ker_step = make_train_step(model, da, TRAIN, gather_on_device=True)
    ref_step = make_train_step(plain, da, TRAIN)
    rec, ref_rec = record_forwards(model), record_forwards(plain)
    idx_s, idx_t = store_loaders(stores, seed=7)
    feat_s, feat_t = store_loaders(stores, seed=7)
    index = zip(endless(idx_s.index_epoch), endless(idx_t.index_epoch))
    feats = zip(endless(feat_s.epoch), endless(feat_t.epoch))
    want_launches = {"trn_fused_fwd": 0, "trn_fused_fwd_train": per_step[1],
                     "trn_fused_bwd": per_step[2],
                     "gather_gemm": per_step[0]}
    launches = dict.fromkeys(counts(), 0)
    worst_rel = worst = 0.0
    ties, flips = 0, (0, 0)
    for i, sc in enumerate(steps):
        (bs, bt), (hs, ht) = next(index), next(feats)
        same_start(ker, ref)
        for r in (rec, ref_rec):
            r[0].clear()
            r[1].clear()
            r[3].clear()
        reset_counts()
        ker, got = ker_step(ker, dev[0], *bs, dev[1], *bt, sc, None)
        torch.cuda.synchronize()
        launched = counts()
        if launched != want_launches:
            raise AssertionError(f"{name} step {i} launched {launched}, "
                                 f"expected {want_launches}")
        launches = {k: launches[k] + launched[k] for k in launches}
        ref, want = ref_step(ref, *hs, *ht, sc, None)
        got = {k: float(v) for k, v in got.items()}
        want = {k: float(v) for k, v in want.items()}
        worst_rel = max(worst_rel, check_metrics(
            i, got, want, f"{name}'s plain path"))
        allowed, flipped = comparison_ties(cfg, len(bs.mask), rec, ref_rec)
        diff, rows = check_params(i, model, plain,
                                  f"{name}'s plain path", allowed)
        worst, ties = max(worst, diff), ties + rows
        flips = tuple(map(sum, zip(flips, flipped)))
    for r in (rec, ref_rec):
        r[2]()
    losses = ", ".join(f"{k} {got[k]:.5f}" for k in sorted(got)
                       if k.startswith("loss"))
    log(f"  {name}: {COMPARISON_STEPS} steps, last {losses}; metrics within "
        f"{worst_rel:.3e} relative, parameters within {worst:.3e} "
        f"(masks flipped at ties: {flips[0]} TRN, {flips[1]} FC relu; "
        f"{ties} rows let through); launches per step {want_launches}")
    if cfg.use_bn == "AutoDIAL" and \
            float(model.alpha.detach()) != AUTODIAL_ALPHA:
        raise AssertionError(f"AutoDIAL's alpha moved to "
                             f"{float(model.alpha)}")
    launches_val = eval_device_store(gen, stores[2], dev[2], model)
    launches = {k: launches[k] + launches_val[k] for k in launches}

    def run(n):
        nonlocal ker
        for _ in range(n):
            bs, bt = next(index)
            ker, metrics = ker_step(ker, dev[0], *bs, dev[1], *bt, steps[-1],
                                    None)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name}: a step's loss is not finite")

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(COMPARISON_TIMED)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / COMPARISON_TIMED
    log(f"  {name}: {step_ms:.3f} ms per device-store step "
        f"({COMPARISON_TIMED} back to back, dropout 0)")
    busy, idle = device_profile(run, 5, step_ms, f"{name} steps",
                                top=12 if da.dis_DA != "none" else 8)
    if da.dis_DA != "none":
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"  {name}: peak memory over a step "
            f"{peak / 2 ** 20:.1f} MiB, {(peak - base) / 2 ** 20:.1f} MiB "
            f"above the {base / 2 ** 20:.1f} MiB held between steps "
            f"(stores, model, optimizer); {card_line()}")
    return launches, (step_ms, busy, idle)


def comparison_cli(root, name):
    """The Trainer through the train CLI for one epoch from the device
    stores with --save_model, its launches checked per epoch and
    validation, then the eval CLI on its model_best.pth.tar (reference
    format, with the BN running stats or the second classifier).  Its
    Pred@1 must be the best Prec@1 the Trainer printed; for the frame
    baseline, whose Prec@1 counts frames and whose Pred@1 scores the
    frame logits averaged over the segments, the Pred@1 of a plain-path
    Predictor on the same checkpoint and val videos.  Returns the summed
    launches."""
    lists = [os.path.join(root, n, "list.txt") for n in ("src", "tgt", "val")]
    exp = os.path.join(root, f"exp_{name}")
    train_flags, eval_flags, per_batch = COMPARISON_CLI[name]
    with trainer_records() as records:
        best, out = run_cli(cli_train.main, [
            os.path.join(root, "class.txt"), "RGB", *lists, *MODEL_FLAGS,
            *RECIPE_FLAGS, *train_flags, "--exp_path", exp + "/",
            "--save_best_log", os.path.join(exp, "best.log"),
            "--device_store", "--save_model", "--epochs", "1"])
    launches = dict.fromkeys(counts(), 0)
    for rec in records:
        check_trainer_launches(rec, per_batch)
        launches = {k: launches[k] + n for k, n in rec["launches"].items()}
    train = [r for r in records if r["kind"] == "train"][0]
    log(f"  {name} train CLI: epoch 1 {train['seconds']:.3f} s, "
        f"{train['steps']} steps, {train['videos']} videos; best "
        f"{best:.3f}; launches {launches}")
    weights = os.path.join(exp, "RGB", "model_best.pth.tar")
    if eval_flags is None:  # no --baseline_type: the CLI's default, frame
        model_flags, eval_flags = MODEL_FLAGS[2:], []
    else:
        model_flags = MODEL_FLAGS
    reset_counts()
    line, _ = run_cli(cli_test_models.main, eval_cli_args(
        root, weights, "--device_store", *eval_flags,
        model_flags=model_flags))
    launched = counts()
    pred1 = float(line.split()[1].rstrip("%"))
    want, what = best, "best Prec@1 printed"
    if "--baseline_type" not in model_flags:
        want, what = video_accuracy(root, weights), (
            "plain-path Pred@1 of the averaged frame logits")
    log(f"  {name} eval CLI on model_best.pth.tar: {line.strip()} ({what} "
        f"{want:.3f}, best Prec@1 printed {best:.3f}); launches {launched}")
    if abs(pred1 - want) > 0.006:
        raise AssertionError(f"{name}: Pred@1 {pred1} is not the {what} "
                             f"{want}")
    return {k: launches[k] + launched[k] for k in launches}


def video_accuracy(root, weights):
    """Top-1 accuracy in percent over the val videos of a frame-baseline
    flagship checkpoint served by a Predictor whose TRN is the plain
    version: the frame logits averaged over the segments."""
    cfg = dataclasses.replace(FLAGSHIP, baseline_type="frame")
    model = load_reference_checkpoint(weights, cfg, "cuda")
    model.TRN = PlainTRN(model.TRN)
    val = FeatureStore.load(os.path.join(root, "val"))
    loader = TSNLoader(val, batch_size=CLI_BATCH, num_segments=5,
                       shuffle=False)
    predictor = Predictor(cfg, model, batch_size=CLI_BATCH, top_k=1,
                          device="cuda")
    hits = total = 0
    for b in loader.epoch():
        n = int(b.mask.sum())
        top = predictor(b.features[:n])[2][:, 0]
        hits += int((top == b.labels[:n]).sum())
        total += n
    return 100.0 * hits / total


def comparison_phase(gen, stores, dev, root):
    """The comparison configurations (COMPARISON) at the flagship widths,
    then COMPARISON_CLI through the CLIs.  Returns the summed launches."""
    launches = dict.fromkeys(counts(), 0)
    times = {}
    for name in COMPARISON:
        got, times[name] = comparison_config(gen, name, stores, dev)
        launches = {k: launches[k] + got[k] for k in launches}
    for name in COMPARISON_CLI:
        got = comparison_cli(root, name)
        launches = {k: launches[k] + got[k] for k in launches}
    log("  device-store step by configuration (ms per step back to back, "
        "device busy ms per step, idle share): " + "; ".join(
            f"{n} {t[0]:.3f} / {t[1]:.4f} / {100 * t[2]:.1f}%"
            for n, t in times.items()))
    return launches


# ---- the bfloat16 compute path and the narrow stores ----

def bf16_err(got, want):
    """The largest |got - want| over the elements and whether every one
    lies within BF16_ULP * |want| + BF16_ABS * max(1, max|want|)."""
    if want.numel() == 0:
        return 0.0, got.shape == want.shape
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound_at = (BF16_ULP * want.abs()
                + BF16_ABS * max(1.0, want.abs().max().item()))
    return diff.max().item(), bool((diff <= bound_at).all())


def bf16_trn_inputs(b, s, gen, signed=True):
    """trn_inputs at the flagship widths, as bfloat16."""
    x, w, bi = trn_inputs(b, s, 512, 256, gen, signed=signed)
    bf = torch.bfloat16
    return x.to(bf), [t.to(bf) for t in w], [t.to(bf) for t in bi]


def check_bf16_trn(gen):
    """K1 (infer) in bfloat16 at B = 1, 64, 202 and S = 5, 17, K1 (train)
    and K2 in bfloat16 at B = 202 and S = 5, 17, against their plain
    versions in bfloat16 (bf16_err; the masks equal but where |z| is
    within RTOL of the largest; K2 from the kernel's masks).  Returns the
    largest error of each."""
    worst = dict.fromkeys(("trn_fused_fwd_bf16", "trn_fused_fwd_train_bf16",
                           "trn_fused_bwd_bf16"), 0.0)
    for s in (5, 17):
        for b in (1, 64, 202):
            x, w, bi = bf16_trn_inputs(b, s, gen, signed=False)
            with torch.inference_mode():
                got = trn_fused.trn_multiscale_infer(x, w, bi, s)
                want = trn_fused.trn_multiscale_plain(x, w, bi, s)
            torch.cuda.synchronize()
            err, ok = bf16_err(got, want)
            log(f"  K1 (infer) bf16 B={b} S={s}: max|kernel-plain| "
                f"{err:.3e}")
            if got.dtype != torch.bfloat16 or not ok:
                raise AssertionError(f"K1 (infer) bf16 disagrees at B={b} "
                                     f"S={s}")
            worst["trn_fused_fwd_bf16"] = max(worst["trn_fused_fwd_bf16"],
                                              err)
        x, w, bi = bf16_trn_inputs(202, s, gen)
        g = torch.randn((202, s - 1, 256), generator=gen).cuda() \
            .to(torch.bfloat16)
        with torch.no_grad():
            out, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            want, want_masks = trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, s)
            z = preacts(x, w, bi, s).abs()
            grads = trn_fused.trn_multiscale_bwd(x, w, masks, g, s)
            want_grads = trn_fused.trn_multiscale_bwd_plain(x, w, masks, g,
                                                            s)
        torch.cuda.synchronize()
        differ = masks != want_masks
        fwd_err, fwd_ok = bf16_err(out, want)
        flat = lambda r: (r[0], *r[1], *r[2])
        bwd = [bf16_err(a, c) for a, c in zip(flat(grads),
                                              flat(want_grads))]
        bwd_err = max(e for e, _ in bwd)
        log(f"  K1 (train) bf16 B=202 S={s}: max|kernel-plain| "
            f"{fwd_err:.3e}, {int(differ.sum())} of {masks.numel()} masks "
            f"differ (at |z| <= {z[differ].max().item() if differ.any() else 0:.2e}); "
            f"K2 bf16: max|kernel-plain| over dx, dW, db {bwd_err:.3e}")
        if not fwd_ok or not all(ok for _, ok in bwd) or (
                differ & (z > RTOL * z.max())).any():
            raise AssertionError(f"K1 (train) or K2 bf16 disagrees at S={s}")
        worst["trn_fused_fwd_train_bf16"] = max(
            worst["trn_fused_fwd_train_bf16"], fwd_err)
        worst["trn_fused_bwd_bf16"] = max(worst["trn_fused_bwd_bf16"],
                                          bwd_err)
    return worst


def narrow_stores(store, source):
    """The source store in every store dtype on the card: float32 (as
    uploaded), bfloat16 and int8 (``FeatureStore.to_device``)."""
    return {"f32": store, "bf16": source.to_device("cuda", "bfloat16"),
            "int8": source.to_device("cuda", "int8")}


def check_gather_variants(stores):
    """K3's five variants beyond float32 x float32 against the plain
    version on the same store: at N = 640 with x_res, 320 without, 37
    (ragged) and 0; z within RTOL * max(1, max|plain|) at float32 compute
    and bf16_err at bfloat16 compute, x_res bitwise equal (an int8 store's
    rows dequantized as float(q) * scale, then * row scale).  Returns the
    largest error of each variant."""
    rng = np.random.default_rng(6)
    h, d = FLAGSHIP.fc_dim, stores["f32"].shape[1]
    w32 = (torch.from_numpy(rng.uniform(-1, 1, (h, d)).astype(np.float32))
           / math.sqrt(d)).cuda()
    weights = {"f32": w32, "bf16": w32.to(torch.bfloat16)}
    worst = {}
    for variant in K3_VARIANTS:
        kind, compute = variant.split("_")
        store, w = stores[kind], weights[compute]
        errs = []
        for n, with_rows in ((640, True), (320, False), (37, True),
                             (0, True)):
            rows, scale = gather_case(n, store_rows(store), rng)
            reset_counts()
            z, x_res = gather_gemm.gathered_gemm(store, rows, w, scale,
                                                 with_rows)
            launched = gather_gemm.variant_launches[variant]
            want, want_x = gather_gemm.gathered_gemm_plain(store, rows.rows,
                                                           w, scale)
            torch.cuda.synchronize()
            if compute == "f32":
                err = (z - want).abs().max().item() if n else 0.0
                ok = err <= RTOL * max(1.0, want.abs().max().item()
                                       if n else 0.0)
            else:
                err, ok = bf16_err(z, want)
            exact = (x_res is None) != with_rows and (
                x_res is None or torch.equal(x_res, want_x))
            if not ok or not exact or z.dtype != w.dtype or \
                    launched != (1 if n else 0):
                raise AssertionError(f"K3 {variant} disagrees with plain "
                                     f"at N={n}")
            errs.append(err)
        log(f"  K3 {variant} (store_compute): N = 640, 320, 37, 0: "
            f"max|kernel-plain| " + ", ".join(f"{e:.3e}" for e in errs)
            + "; x_res bitwise equal to plain")
        worst[variant] = max(errs)
    return worst


def store_rows(store):
    """The rows of a store tensor or of an int8 pair."""
    return (store[0] if isinstance(store, tuple) else store).shape[0]


def time_bf16_kernels(gen, stores):
    """Device times of every bfloat16 and narrow-store variant and of its
    plain version, medians of 41 in turns, at the shapes of their paths:
    K1 (infer) at B = 1, 64, 202 and S = 5, 17, K1 (train) at the train
    batch and S = 5, 17, K2 at the train batch and S = 5, 17, 25, K3 at the
    train shape (640 rows with x_res) and the eval shape (320 rows
    without), at bfloat16 compute also at the target batch's 370 rows with
    x_res and against index_select + mm in bfloat16, at float32 compute
    from a narrow store against index_select, the convert (bfloat16) or
    ``float() * scale`` (int8) and mm in float32.  Returns {name: (ms,
    plain_ms, library_ms, work)}, the K1 (infer) times by batch at S=5,
    K3's at the eval shape and the others by their shape's key (K3 "n370",
    K1 and K2 "s17", K1 (infer) "s17_b1", "s17_b202", K2 "s25")."""
    out, k1 = {}, {}
    with torch.inference_mode():
        for b in TIMED_BATCHES:
            x, w, bi = bf16_trn_inputs(b, 5, gen, signed=False)
            k1[b] = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_infer(x, w, bi,
                                                                 5),
                "plain": lambda: trn_fused.trn_multiscale_plain(x, w, bi,
                                                                5)})
    t = k1[SERVE_BATCH]
    out["trn_fused_fwd_bf16"] = (t["kernel"], t["plain"], None,
                                 trn_work(SERVE_BATCH, esize=2)[
                                     "trn_fused_fwd"])
    b = sum(TRAIN.batch_size[:2])
    x, w, bi = bf16_trn_inputs(b, 5, gen)
    g = torch.randn((b, 4, 256), generator=gen).cuda().to(torch.bfloat16)
    with torch.no_grad():
        _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5)
        fwd = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi, 5),
            "plain": lambda: trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, 5)})
        bwd = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_bwd(x, w, masks, g, 5),
            "plain": lambda: trn_fused.trn_multiscale_bwd_plain(
                x, w, masks, g, 5)})
    work = trn_work(b, esize=2)
    out["trn_fused_fwd_train_bf16"] = (fwd["kernel"], fwd["plain"], None,
                                       work["trn_fused_fwd_train"])
    out["trn_fused_bwd_bf16"] = (bwd["kernel"], bwd["plain"], None,
                                 work["trn_fused_bwd"])
    for name in ("trn_fused_fwd_train_bf16", "trn_fused_bwd_bf16"):
        log(f"  B={b} {name}: kernel {out[name][0]:.4f} ms, plain "
            f"{out[name][1]:.4f} ms device (medians of 41, in turns)")
    more = {"trn_fused_bwd_bf16": {}, "trn_fused_fwd_bf16": {},
            "trn_fused_fwd_train_bf16": {}}
    # K1 in bfloat16 at S=17: infer at B = 1, 64 ("s17"), 202, train at b
    s = MANY_FRAMES[0]
    for bb in TIMED_BATCHES:
        x, w, bi = bf16_trn_inputs(bb, s, gen, signed=False)
        with torch.inference_mode():
            tt = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_infer(x, w, bi,
                                                                 s),
                "plain": lambda: trn_fused.trn_multiscale_plain(x, w, bi,
                                                                s)})
        key = f"s{s}" if bb == SERVE_BATCH else f"s{s}_b{bb}"
        more["trn_fused_fwd_bf16"][key] = (
            tt["kernel"], tt["plain"], None,
            trn_work(bb, s=s, esize=2)["trn_fused_fwd"])
        log(f"  B={bb} S={s} trn_fused_fwd_bf16: kernel "
            f"{tt['kernel']:.4f} ms, plain {tt['plain']:.4f} ms device "
            "(medians of 41, in turns)")
    x, w, bi = bf16_trn_inputs(b, s, gen)
    with torch.no_grad():
        tt = time_pair({
            "kernel": lambda: trn_fused.trn_multiscale_fwd_masks(x, w, bi,
                                                                 s),
            "plain": lambda: trn_fused.trn_multiscale_fwd_masks_plain(
                x, w, bi, s)})
    more["trn_fused_fwd_train_bf16"][f"s{s}"] = (
        tt["kernel"], tt["plain"], None,
        trn_work(b, s=s, esize=2)["trn_fused_fwd_train"])
    log(f"  B={b} S={s} trn_fused_fwd_train_bf16: kernel {tt['kernel']:.4f} "
        f"ms, plain {tt['plain']:.4f} ms device (medians of 41, in turns)")
    for s in MANY_FRAMES:
        x, w, bi = bf16_trn_inputs(b, s, gen)
        g = torch.randn((b, s - 1, 256), generator=gen).cuda().to(
            torch.bfloat16)
        with torch.no_grad():
            _, masks = trn_fused.trn_multiscale_fwd_masks(x, w, bi, s)
            tt = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_bwd(x, w, masks,
                                                               g, s),
                "plain": lambda: trn_fused.trn_multiscale_bwd_plain(
                    x, w, masks, g, s)})
        more["trn_fused_bwd_bf16"][f"s{s}"] = (
            tt["kernel"], tt["plain"], None,
            trn_work(b, s=s, esize=2)["trn_fused_bwd"])
        log(f"  B={b} S={s} trn_fused_bwd_bf16: kernel {tt['kernel']:.4f} "
            f"ms, plain {tt['plain']:.4f} ms device (medians of 41, in "
            "turns)")
    for bb, tt in k1.items():
        log(f"  B={bb} trn_fused_fwd_bf16: kernel {tt['kernel']:.4f} ms, "
            f"plain {tt['plain']:.4f} ms device (medians of 41, in turns)")
    rng = np.random.default_rng(7)
    h, d = FLAGSHIP.fc_dim, stores["f32"].shape[1]
    w32 = (torch.rand((h, d), generator=torch.Generator().manual_seed(7))
           * 2 - 1).cuda() / math.sqrt(d)
    weights = {"f32": w32, "bf16": w32.to(torch.bfloat16)}
    sizes = {"f32": 4, "bf16": 2, "int8": 1}
    eval_times = {}
    with torch.no_grad():
        for variant in K3_VARIANTS:
            kind, compute = variant.split("_")
            store, wc = stores[kind], weights[compute]
            for n, with_rows in (K3_BF16_TIMED if compute == "bf16"
                                 else K3_TIMED):
                rows, scale = gather_case(n, store_rows(store), rng)
                fns = {"kernel": lambda: gather_gemm.gathered_gemm(
                           store, rows, wc, scale, with_rows),
                       "plain": lambda: gather_gemm.gathered_gemm_plain(
                           store, rows.rows, wc, scale)}
                if compute == "bf16":
                    rows_bf = stores["bf16"]
                    fns["library"] = lambda: torch.mm(
                        rows_bf.index_select(0, rows.rows), wc.t())
                elif kind == "bf16":  # gather, convert, mm in float32
                    fns["library"] = lambda: torch.mm(
                        store.index_select(0, rows.rows).float(), wc.t())
                else:  # gather, dequantize, mm in float32
                    fns["library"] = lambda: torch.mm(
                        store[0].index_select(0, rows.rows).float()
                        * store[1].index_select(0, rows.rows)[:, None],
                        wc.t())
                tt = time_pair(fns)
                work = gather_work(rows, d, h, with_rows, sizes[kind],
                                   sizes[compute])
                least, by = bound(*work, PEAK_BF16 if compute == "bf16"
                                  else PEAK_TF32 / 3)
                log(f"  K3 {variant} N={n} "
                    f"{'with' if with_rows else 'without'} x_res: kernel "
                    f"{tt['kernel']:.4f} ms, plain {tt['plain']:.4f} ms"
                    + (f", index_select + mm in bfloat16 "
                       f"{tt['library']:.4f} ms" if compute == "bf16" else
                       f", index_select, {LIBRARY_CAST[kind]} and mm in "
                       f"float32 {tt['library']:.4f} ms")
                    + f" device; bound {least:.4f} ms by {by}")
                entry = (tt["kernel"], tt["plain"], tt.get("library"), work)
                if not with_rows:
                    eval_times[f"gather_gemm_{variant}"] = entry
                elif n == K3_TIMED[0][0]:
                    out[f"gather_gemm_{variant}"] = entry
                else:
                    more.setdefault(f"gather_gemm_{variant}", {})[
                        f"n{n}"] = entry
    return out, k1, eval_times, more


def train_bf16_store(gen, stores):
    """The bfloat16 flagship, BF16_STEPS device-store steps from an int8
    store and from a bfloat16 store (2 K3 of the store's bfloat16
    variant, 1 K1 (train) and 1 K2 in bfloat16 each, nothing else),
    against as many steps of the plain path on the same batches: host
    features (the int8 store's dequantized by the host gather, as K3
    dequantizes them; the float32 ones for the bfloat16 store, rounded
    as the model's entry cast rounds them) through a copy whose TRN is
    the plain version.  Each step from the same parameters; the metrics
    held to BF16_STEP_RTOL, the updated parameters to BF16_PARAM_TOL but
    for the rows fed by a relu mask flipped at a bfloat16 tie
    (BF16_TIE_RTOL).  Returns the launches of the device-store steps."""
    launches = dict.fromkeys(bf16_counts(), 0)
    for store_dtype in ("int8", "bfloat16"):
        model = flagship_model(gen, compute_dtype="bfloat16")
        plain_model = copy.deepcopy(model)
        plain_model.TRN = PlainTRN(plain_model.TRN)
        host = [st.quantize() if store_dtype == "int8" else st
                for st in stores[:2]]
        dev = [st.to_device("cuda", store_dtype) for st in stores[:2]]
        steps = [scalars(i, BF16_STEPS, (-1.0, -1.0, -1.0))
                 for i in range(BF16_STEPS)]
        idx_s, idx_t = store_loaders(host)
        feat_s, feat_t = store_loaders(host)
        index = zip(endless(idx_s.index_epoch), endless(idx_t.index_epoch))
        feats = zip(endless(feat_s.epoch), endless(feat_t.epoch))
        state = TrainState(model, make_optimizer(model.parameters(), TRAIN),
                           0)
        step = make_train_step(model, DA, TRAIN, gather_on_device=True)
        ref = TrainState(plain_model,
                         make_optimizer(plain_model.parameters(), TRAIN), 0)
        ref_step = make_train_step(plain_model, DA, TRAIN)
        (rec, hook), (ref_rec, ref_hook) = map(record_trn,
                                               (model, plain_model))
        variant = f"gather_gemm_{'int8' if store_dtype == 'int8' else 'bf16'}_bf16"
        want_launched = {**dict.fromkeys(bf16_counts(), 0), variant: 2,
                         "trn_fused_fwd_train_bf16": 1,
                         "trn_fused_bwd_bf16": 1}
        worst_rel = worst = 0.0
        ties, flips = 0, (0, 0)
        for i, sc, (bs, bt), (hs, ht) in zip(range(BF16_STEPS), steps,
                                             index, feats):
            same_start(state, ref)
            before = {k: v.clone() for k, v in named(plain_model).items()}
            reset_counts()
            state, got = step(state, dev[0], *bs, dev[1], *bt, sc, None)
            torch.cuda.synchronize()
            launched = bf16_counts()
            if launched != want_launched or any(counts().values()):
                raise AssertionError(f"bf16 step {i} launched {launched}, "
                                     f"{counts()}")
            launches = {k: launches[k] + launched[k] for k in launches}
            ref, want = ref_step(ref, *hs, *ht, sc, None)
            got = {k: float(v) for k, v in got.items()}
            want = {k: float(v) for k, v in want.items()}
            for key in want:
                if not math.isfinite(got[key]) or not math.isclose(
                        got[key], want[key], rel_tol=BF16_STEP_RTOL,
                        abs_tol=1e-6):
                    raise AssertionError(f"bf16 step {i} ({store_dtype} "
                                         f"store): {key} {got[key]} differs "
                                         f"from the plain path's "
                                         f"{want[key]}")
                worst_rel = max(worst_rel, abs(got[key] - want[key])
                                / max(abs(want[key]), 1e-30))
            allowed, flipped = tie_rows(rec, ref_rec, BF16_TIE_RTOL)
            diff, rows = check_updates(i, model, plain_model, before,
                                       allowed)
            worst, ties = max(worst, diff), ties + rows
            flips = tuple(map(sum, zip(flips, flipped)))
            log(f"  {store_dtype} store, step {i}: " + ", ".join(
                f"{k} {got[k]:.5f}/{want[k]:.5f}" for k in
                ("loss_c", "loss_a", "loss_e", "loss"))
                + " (device store/plain path)")
        hook.remove()
        ref_hook.remove()
        log(f"  {store_dtype} store: each step from the same parameters: "
            f"metrics within {worst_rel:.3e} relative (tolerance "
            f"{BF16_STEP_RTOL}), each tensor's update within {worst:.3e} of "
            f"its largest (tolerance {BF16_UPDATE_RTOL}; masks flipped at "
            f"bfloat16 ties: {flips[0]} TRN, {flips[1]} shared FC; {ties} "
            f"rows let through); launches per step "
            f"{ {k: v for k, v in want_launched.items() if v} }")
        profile_bf16_step(model, step, dev, store_loaders(host, seed=5),
                          store_dtype)
    return launches


def check_updates(i, ours, ref, before, ties):
    """Hold the update of step i of every parameter tensor (the tensor
    after the step less ``before``, the same start of both sides) to
    BF16_UPDATE_RTOL of the reference update's largest value, all but the
    rows that ``ties`` (tie_rows) names, which are logged.  Returns the
    largest such ratio of the rows held and the number let through."""
    ours, ref = named(ours), named(ref)
    worst, let_through = 0.0, 0
    for name, want in ref.items():
        if not want.is_floating_point():
            continue
        step_ref = (want - before[name]).float()
        diff = ((ours[name] - before[name]).float() - step_ref).abs()
        scale = step_ref.abs().max().item()
        beyond = (diff > BF16_UPDATE_RTOL * scale + 1e-9).reshape(
            want.shape[0] if want.dim() else 1, -1).any(dim=1)
        rows = beyond.nonzero()[:, 0].tolist()
        allowed = ties.get(name, {})
        stray = [r for r in rows if r not in allowed]
        if stray:
            raise AssertionError(
                f"{name}: the update of step {i} differs from the plain "
                f"path's beyond {BF16_UPDATE_RTOL} of its largest "
                f"({scale:.3e}) in {len(stray)} rows fed by no tie (first "
                f"{stray[:5]}), max|d| {diff.max().item():.3e}")
        for r in rows:
            log(f"    {name} row {r} let through, max|d| "
                f"{diff[r].max().item():.3e}: {allowed[r]}")
            diff[r] = 0.0
        let_through += len(rows)
        worst = max(worst, diff.max().item() / max(scale, 1e-30))
    return worst, let_through


def profile_bf16_step(model, step, dev, loaders, label, n=5):
    """The bfloat16 device-store step back to back (dropout 0 model, its
    own loaders): ms per step and, under the profiler, device busy ms per
    step and the idle share."""
    state = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    batches = zip(endless(loaders[0].index_epoch),
                  endless(loaders[1].index_epoch))

    def run(k):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            bs, bt = next(batches)
            state, m = step(state, dev[0], *bs, dev[1], *bt,
                            scalars(state.step, 100, TRAIN.beta), None)
        torch.cuda.synchronize()
        if not math.isfinite(float(m["loss"])):
            raise AssertionError("bf16 step loss is not finite")
        return (time.perf_counter() - t0) * 1e3 / k

    run(3)
    step_ms = statistics.median(run(TIMED_STEPS) for _ in range(2))
    log(f"  bf16 step from the {label} store: {step_ms:.3f} ms per step "
        f"({TIMED_STEPS} back to back, median of 2)")
    device_profile(run, n, step_ms, f"bf16 {label}-store steps")


def serve_bf16(gen):
    """A Predictor on the bfloat16 flagship at batch 64 (130 videos, three
    padded chunks) and at batch 1 (5 calls), against Predictors of a copy
    whose TRN is the plain version: float32 probabilities within
    BF16_PROB_TOL, top-1 equal where the plain path's top two are further
    apart than that.  Returns the launches of the kernel Predictors."""
    model = flagship_model(gen, compute_dtype="bfloat16")
    plain_model = copy.deepcopy(model)
    plain_model.TRN = PlainTRN(plain_model.TRN)
    feats = np.random.default_rng(8).random(
        (130, BF16_FLAGSHIP.val_segments, BF16_FLAGSHIP.input_feature_dim),
        np.float32)
    launches = dict.fromkeys(bf16_counts(), 0)
    for batch, data in ((SERVE_BATCH, feats), (1, feats[:5])):
        pred = Predictor(BF16_FLAGSHIP, model, batch_size=batch,
                         device="cuda")
        plain = Predictor(BF16_FLAGSHIP, plain_model, batch_size=batch,
                          device="cuda")
        reset_counts()
        probs, _, top_i = pred(data)
        torch.cuda.synchronize()
        launched = bf16_counts()
        want, want_p, want_i = plain(data)
        chunks = -(-len(data) // batch)
        err = np.abs(probs - want).max()
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_PROB_TOL
        log(f"  bf16 Predictor at batch {batch}: {len(data)} videos, "
            f"max|probs - plain| {err:.3e} (tolerance {BF16_PROB_TOL:.3e}),"
            f" top-1 equal on {int((top_i[:, 0] == want_i[:, 0]).sum())} "
            f"of {len(data)}; probs {probs.dtype}; launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        if probs.dtype != np.float32 or not err <= BF16_PROB_TOL or \
                (top_i[clear, 0] != want_i[clear, 0]).any() or \
                launched["trn_fused_fwd_bf16"] != chunks or \
                any(counts().values()):
            raise AssertionError(f"the bf16 Predictor at batch {batch} "
                                 "disagrees with its plain path")
        launches = {k: launches[k] + launched[k] for k in launches}
    return launches


def train_cli_bf16(root):
    """The train CLI with --device_store --store_dtype int8
    --compute_dtype bfloat16 --optimizer Adam for 2 epochs on the stores
    of the published split sizes (each train batch 2 K3 int8 x bf16, 1 K1
    (train) and 1 K2 in bfloat16; each val batch 1 K3 and 1 K1 (infer)),
    then the eval CLI with --device_store --store_dtype int8
    --compute_dtype bfloat16 on its model_best.pth.tar, whose Pred@1 must
    be the best Prec@1 printed; then one host-feature epoch with
    --accum_steps 2 (float32: K1 (train) and K2 per micro-batch), which
    must run the accumulation epoch.  Returns the launches (bfloat16
    variants, float32 kernels)."""
    lists = [os.path.join(root, n, "list.txt") for n in ("src", "tgt", "val")]
    exp = os.path.join(root, "exp_bf16")

    def argv(exp_dir, *extra):
        return [os.path.join(root, "class.txt"), "RGB", *lists, *MODEL_FLAGS,
                *RECIPE_FLAGS, "--exp_path", exp_dir + "/",
                "--save_best_log", os.path.join(exp_dir, "best.log"), *extra]

    narrow = ["--device_store", "--store_dtype", "int8", "--compute_dtype",
              "bfloat16"]
    launches = dict.fromkeys(bf16_counts(), 0)
    launches32 = dict.fromkeys(counts(), 0)
    best_seen = 0.0
    with trainer_records() as records:
        best, out = run_cli(cli_train.main, argv(
            exp, *narrow, "--optimizer", "Adam", "--lr", "0.001",
            "--save_model", "--epochs", "2"))
    for rec in records:
        if rec["kind"] == "train":
            n = rec["steps"]
            want = {"gather_gemm_int8_bf16": 2 * n,
                    "trn_fused_fwd_train_bf16": n, "trn_fused_bwd_bf16": n}
            log(f"  bf16, int8 store, Adam: epoch {rec['epoch']} "
                f"{rec['seconds']:.3f} s, {n} steps, "
                f"{rec['videos'] / rec['seconds']:.0f} videos/s")
        else:
            n = rec["batches"]
            want = {"gather_gemm_int8_bf16": n, "trn_fused_fwd_bf16": n}
            best_seen = max(best_seen, rec["out"])
            log(f"  bf16, int8 store: validation after epoch {rec['epoch']}"
                f": Prec@1 {rec['out']:.3f} in {rec['seconds'] * 1e3:.1f} ms")
        want = {**dict.fromkeys(bf16_counts(), 0), **want}
        if rec["bf16_launches"] != want or any(rec["launches"].values()):
            raise AssertionError(f"{rec['kind']} epoch {rec['epoch']} "
                                 f"launched {rec['bf16_launches']}, "
                                 f"{rec['launches']}; expected {want}")
        launches = {k: launches[k] + rec["bf16_launches"][k]
                    for k in launches}
    log(f"  bf16, int8 store, Adam: best {best:.3f}; "
        + out.strip().splitlines()[-1].strip())
    reset_counts()
    line, _ = run_cli(cli_test_models.main, eval_cli_args(
        root, os.path.join(exp, "RGB", "model_best.pth.tar"), *narrow))
    launched = bf16_counts()
    pred1 = float(line.split()[1].rstrip("%"))
    log(f"  eval CLI --store_dtype int8 --compute_dtype bfloat16 on "
        f"model_best.pth.tar: {line.strip()} (best Prec@1 printed "
        f"{best_seen:.3f}); launches "
        f"{ {k: v for k, v in launched.items() if v} }")
    if abs(pred1 - best_seen) > 0.006 or not launched[
            "gather_gemm_int8_bf16"] or any(counts().values()):
        raise AssertionError(f"Pred@1 {pred1} is not the best Prec@1 "
                             f"{best_seen}, or the eval ran other kernels")
    launches = {k: launches[k] + launched[k] for k in launches}
    accum_epochs = []
    inner = Trainer._train_epoch_accum

    def counted(self, epoch, *args):
        accum_epochs.append(epoch)
        return inner(self, epoch, *args)

    Trainer._train_epoch_accum = counted
    try:
        with trainer_records() as records:
            best, out = run_cli(cli_train.main, argv(
                os.path.join(root, "exp_accum"), "--accum_steps", "2",
                "--epochs", "1"))
    finally:
        Trainer._train_epoch_accum = inner
    for rec in records:
        check_trainer_launches(rec)
        launches32 = {k: launches32[k] + rec["launches"][k]
                      for k in launches32}
        if rec["kind"] == "train":
            log(f"  host features, --accum_steps 2: epoch {rec['epoch']} "
                f"{rec['seconds']:.3f} s, {rec['steps']} micro-batches, "
                f"launches {rec['launches']}")
    if accum_epochs != [1]:
        raise AssertionError("--accum_steps 2 did not run the accumulation "
                             "epoch")
    log(f"  host features, --accum_steps 2: best {best:.3f}; "
        + out.strip().splitlines()[-1].strip())
    return launches, launches32


def eval_cli_narrow(root, weights):
    """The eval CLI on the bfloat16 run's model_best.pth.tar from narrow
    stores and in mixed dtypes, each device-store run against a
    host-feature run on the same values: float32 compute from a store
    quantized on disk (its own int8 rows: K3 int8 x f32) against the host
    gather of that store (it dequantizes in the same order), float32
    compute from a store uploaded as bfloat16 (K3 bf16 x f32) against
    host features rounded to bfloat16, both with scores within PROB_TOL
    and the same Pred@k line; bfloat16 compute from the float32 store (K3
    f32 x bf16) against host features (cuBLAS's bfloat16 GEMM), scores
    within BF16_PROB_TOL.  Returns the launches (bfloat16 variants,
    float32 kernels)."""
    val = FeatureStore.load(os.path.join(root, "val"))
    val.quantize().save(os.path.join(root, "val_q"))
    rounded = torch.from_numpy(np.array(val.features, np.float32)).to(
        torch.bfloat16).float().numpy()
    FeatureStore(rounded, val.offsets, val.paths, val.labels).save(
        os.path.join(root, "val_b"))
    nb = -(-len(val.paths) // CLI_BATCH)
    bf16 = ["--compute_dtype", "bfloat16"]
    cases = (
        ("int8_f32", ["--store", os.path.join(root, "val_q")],
         ["--store", os.path.join(root, "val_q")], ["--device_store"],
         PROB_TOL),
        ("bf16_f32", ["--store", os.path.join(root, "val_b")],
         ["--store", os.path.join(root, "val")],
         ["--device_store", "--store_dtype", "bfloat16"], PROB_TOL),
        ("f32_bf16", bf16, bf16, ["--device_store"], BF16_PROB_TOL))
    launches = dict.fromkeys(bf16_counts(), 0)
    launches32 = dict.fromkeys(counts(), 0)
    for variant, host_flags, dev_flags, store_flags, tol in cases:
        runs = {}
        for label, extra in (("host", host_flags),
                             ("store", dev_flags + store_flags)):
            prefix = os.path.join(root, f"narrow_{variant}_{label}")
            reset_counts()
            line, _ = run_cli(cli_test_models.main, eval_cli_args(
                root, weights, "--save_scores", prefix, *extra))
            runs[label] = (line, np.load(prefix + ".npz")["scores"],
                           bf16_counts(), counts())
        (h_line, h_scores, _, _), (line, scores, got16, got32) = \
            runs["host"], runs["store"]
        err = np.abs(scores - h_scores).max()
        log(f"  eval CLI {variant}: {line.strip()} (host features: "
            f"{h_line.strip()}); max|scores - host| {err:.3e}; launches "
            f"{ {k: v for k, v in {**got16, **got32}.items() if v} }")
        k1 = "trn_fused_fwd_bf16" if variant.endswith("bf16") else \
            "trn_fused_fwd"
        if got16[f"gather_gemm_{variant}"] != nb or \
                {**got16, **got32}[k1] != nb or not err <= tol or (
                    tol == PROB_TOL and line != h_line):
            raise AssertionError(f"the eval CLI's {variant} store run "
                                 "disagrees with host features or ran "
                                 "other kernels")
        launches = {k: launches[k] + got16[k] for k in launches}
        launches32 = {k: launches32[k] + got32[k] for k in launches32}
    return launches, launches32


def stacked_pairs(pairs):
    """Index-batch pairs stacked [k, ...]: (source arrays, target
    arrays)."""
    return ([np.stack(x) for x in zip(*(bs for bs, _ in pairs))],
            [np.stack(x) for x in zip(*(bt for _, bt in pairs))])


def chunk_scalars(i0, k, total, beta_cfg):
    """The schedule values of steps [i0, i0 + k) of ``total`` for one
    K-step call: a StepScalars of k-long lists."""
    return StepScalars(*(list(f) for f in zip(
        *(scalars(i, total, beta_cfg) for i in range(i0, i0 + k)))))


def per_call(steps):
    """The launches of ``steps`` flagship device-store steps: 2 K3, 1 K1
    (train) and 1 K2 each."""
    return {"trn_fused_fwd": 0, "trn_fused_fwd_train": steps,
            "trn_fused_bwd": steps, "gather_gemm": 2 * steps}


def check_same(label, got_state, want_state, got_metrics, want_metrics):
    """The metrics of each step within STEP_RTOL and the parameters after
    within PARAM_TOL (no rows let through), of a chunked run against its
    reference from the same start; whether they are bitwise equal."""
    worst = max(check_metrics(j, g, w, label) for j, (g, w) in
                enumerate(zip(got_metrics, want_metrics)))
    diff, _ = check_params(len(got_metrics) - 1, got_state.model,
                           want_state.model, label, {})
    bitwise = all(torch.equal(a, b) for a, b in zip(
        got_state.model.state_dict().values(),
        want_state.model.state_dict().values()))
    return worst, diff, bitwise


def unstack(m, k):
    """A K-step call's metrics [k] as k dicts of numbers."""
    host = {key: v.tolist() for key, v in m.items()}
    return [{key: v[j] for key, v in host.items()} for j in range(k)]


def multi_step_phase(gen, stores, dev):
    """Phase 1, K steps per call: make_multi_train_step at K = CHUNK_K
    from the stores against CHUNK_K calls of the device-store step from
    the same start (dropout 0), launches checked (2 K3, 1 K1 (train), 1
    K2 a step); then the published step (dropout 0.5) timed at K = 1 and
    K = CHUNK_K, in turns, with the device's busy time, idle share and
    host-to-device copies per step by the profiler.  Returns the launches
    of the K-step call."""
    k = CHUNK_K
    model = flagship_model(gen)
    ref_model = copy.deepcopy(model)
    idx_s, idx_t = store_loaders(stores)
    pairs = list(zip(idx_s.index_epoch(), idx_t.index_epoch()))[:k]
    stacked_s, stacked_t = stacked_pairs(pairs)
    sc = chunk_scalars(0, k, 100, (-1.0, -1.0, -1.0))
    state = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    multi = make_multi_train_step(model, DA, TRAIN)
    reset_counts()
    state, got = multi(state, dev[0], *stacked_s, dev[1], *stacked_t, sc,
                       None)
    torch.cuda.synchronize()
    launches = counts()
    if launches != per_call(k):
        raise AssertionError(f"the K-step call launched {launches}")
    ref = TrainState(ref_model, make_optimizer(ref_model.parameters(),
                                               TRAIN), 0)
    single = make_train_step(ref_model, DA, TRAIN, gather_on_device=True)
    want = []
    for j, (bs, bt) in enumerate(pairs):
        ref, m = single(ref, dev[0], *bs, dev[1], *bt,
                        StepScalars(*(f[j] for f in sc)), None)
        want.append({key: float(v) for key, v in m.items()})
    worst, diff, bitwise = check_same(f"{k} single steps'", state, ref,
                                      unstack(got, k), want)
    log(f"  K = {k} in one call against {k} single steps from one start: "
        f"metrics within {worst:.3e} relative (tolerance {STEP_RTOL}), "
        f"parameters within {diff:.3e} (PARAM_TOL), bitwise equal: "
        f"{bitwise}; launches {launches}")

    # the published step timed at K = 1 (the single device-store step, as
    # the Trainer runs it) and K = CHUNK_K
    timed_model = flagship_model(gen, dropout=0.5)
    runs = {}
    for kk in (1, k):
        net = copy.deepcopy(timed_model)
        loaders = store_loaders(stores, seed=5)
        runs[kk] = [TrainState(net, make_optimizer(net.parameters(), TRAIN),
                               0),
                    make_train_step(net, DA, TRAIN, gather_on_device=True)
                    if kk == 1 else make_multi_train_step(net, DA, TRAIN),
                    zip(endless(loaders[0].index_epoch),
                        endless(loaders[1].index_epoch)),
                    torch.Generator("cuda").manual_seed(0)]

    def run(kk, n):
        state, step, batches, rng = runs[kk]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n // kk):
            if kk == 1:
                bs, bt = next(batches)
                state, m = step(state, dev[0], *bs, dev[1], *bt,
                                scalars(state.step, 1000, TRAIN.beta), rng)
                continue
            s_, t_ = stacked_pairs([next(batches) for _ in range(kk)])
            state, m = step(state, dev[0], *s_, dev[1], *t_,
                            chunk_scalars(state.step, kk, 1000, TRAIN.beta),
                            rng)
        torch.cuda.synchronize()
        runs[kk][0] = state
        if not torch.isfinite(m["loss"]).all():
            raise AssertionError("a chunked step's loss is not finite")
        return (time.perf_counter() - t0) * 1e3 / n

    for kk in runs:
        run(kk, 2 * kk)
    times = {kk: [] for kk in runs}
    for order in ((1, k), (k, 1), (1, k), (k, 1)):
        for kk in order:
            times[kk].append(run(kk, CHUNK_TIMED))
    for kk, t in times.items():
        step_ms = statistics.median(t)
        log(f"  K = {kk}: {step_ms:.3f} ms per step ({CHUNK_TIMED} steps "
            f"in calls of {kk}, median of {len(t)}; {card_line()})")
        device_profile(lambda n: run(kk, n), 2 * k, step_ms,
                       f"steps at K = {kk}", top=4, copies=True)
    return launches


def sampler_phase(gen, stores, dev):
    """Phase 2, the device sampler: val mode without shuffle bitwise the
    host loader's index_epoch(); random mode with shuffle on the card
    bitwise the same sampler on the CPU over an epoch and a step; one
    make_sampled_multi_step call at K = CHUNK_K against
    make_multi_train_step fed the same indices stacked on the host.
    Returns the launches of the sampled call."""
    val = TSNLoader(stores[2], batch_size=TRAIN.batch_size[2],
                    num_segments=FLAGSHIP.val_segments, mode="val",
                    shuffle=False)
    card = DeviceSampler(val, seed=1).to("cuda")
    for step, hb in enumerate(val.index_epoch()):
        for got, want in zip(card.batch(step), hb):
            if not np.array_equal(got.cpu().numpy(), want):
                raise AssertionError(f"val batch {step} differs from the "
                                     "host loader's")
    log(f"  val mode: {len(val)} batches bitwise the host loader's")

    def random_loader(store, b, seed):
        return TSNLoader(store, batch_size=b,
                         num_segments=FLAGSHIP.train_segments,
                         mode="random", shuffle=True, seed=seed)

    cpu = DeviceSampler(random_loader(stores[0], TRAIN.batch_size[0], 1),
                        seed=101)
    card = DeviceSampler(random_loader(stores[0], TRAIN.batch_size[0], 1),
                         seed=101).to("cuda")
    for step in range(cpu.steps_per_epoch + 1):
        for a, b in zip(cpu.batch(step), card.batch(step)):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"random batch {step}: card and CPU "
                                     "differ")
    log(f"  random mode, shuffled: {cpu.steps_per_epoch + 1} batches on the"
        " card bitwise the CPU's")

    k = CHUNK_K
    samplers = [DeviceSampler(random_loader(st, b, i + 1),
                              seed=101 * (i + 1)).to("cuda")
                for i, (st, b) in enumerate(zip(stores[:2],
                                                TRAIN.batch_size[:2]))]
    spe = min(sp.steps_per_epoch for sp in samplers)
    for sp in samplers:
        sp.steps_per_epoch = spe
    model = flagship_model(gen)
    ref_model = copy.deepcopy(model)
    sc = chunk_scalars(0, k, 100, (-1.0, -1.0, -1.0))
    state = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    step = make_sampled_multi_step(model, DA, TRAIN, *samplers)
    reset_counts()
    t0 = time.perf_counter()
    state, got = step(state, dev[0], dev[1], sc, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    if launches != per_call(k):
        raise AssertionError(f"the sampled call launched {launches}")
    stacked = [[torch.stack(x).cpu().numpy() for x in zip(
        *(sp.batch(j) for j in range(k)))] for sp in samplers]
    ref = TrainState(ref_model, make_optimizer(ref_model.parameters(),
                                               TRAIN), 0)
    ref, want = make_multi_train_step(ref_model, DA, TRAIN)(
        ref, dev[0], *stacked[0], dev[1], *stacked[1], sc, None)
    worst, diff, bitwise = check_same(
        "the K-step call on host-stacked indices'", state, ref,
        unstack(got, k), unstack(want, k))
    log(f"  one sampled call of K = {k} ({seconds * 1e3:.1f} ms, "
        f"{card_line()}) against the K-step call on the same indices "
        f"stacked on the host: metrics within {worst:.3e}, parameters "
        f"within {diff:.3e}, bitwise equal: {bitwise}; launches {launches}")
    return launches


def copy_overlap(prof, min_us=50.0):
    """The host-to-device copies of at least ``min_us`` in a profile: their
    device times, and how much of them ran while a kernel ran (ms); None
    where the profile holds no device intervals."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [(e.time_range.start, e.time_range.end) for e in events
              if "HtoD" in e.name and e.time_range.elapsed_us() >= min_us]
    if not events:
        return None
    merged = []
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events if not e.name.startswith("Mem")):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    over = sum(max(0, min(b, d) - max(a, c)) for a, b in copies
               for c, d in merged)
    return [(b - a) / 1e3 for a, b in copies], over / 1e3


def budget_rows(store, shards=CHUNK_SHARDS):
    """A shard budget that splits ``store`` into at least ``shards``
    shards."""
    rows = int(store.offsets[-1]) // shards
    if ShardPlan(store.offsets, rows).num_shards < shards:
        raise AssertionError(f"{rows} rows make fewer than {shards} shards")
    return rows


def streaming_phase(gen, stores, dev):
    """Phase 3, shard streaming: one epoch of shard-local batches in
    K-step calls (a call never spans a shard pair) through ShardStream,
    the source store in at least CHUNK_SHARDS shards, against the
    resident stores on the same batches with global indices, from one
    start at dropout 0.5 with one generator seed: bitwise equal
    parameters (K3's grid depends on the batch's rows, not on the store's
    row count).  The shard uploads and their overlap with compute by the
    profiler.  Returns the launches of the streamed run."""
    from torch.profiler import ProfilerActivity, profile
    n = budget_rows(stores[0])
    plans = [ShardPlan(st.offsets, n) for st in stores[:2]]
    loaders = store_loaders(stores)
    pairs = list(zip(loaders[0].shard_index_epoch(plans[0]),
                     loaders[1].shard_index_epoch(plans[1])))
    chunks, i = [], 0
    while i < len(pairs):
        key = (pairs[i][0][0], pairs[i][1][0])
        j = i + 1
        while j < len(pairs) and j - i < CHUNK_K and (
                pairs[j][0][0], pairs[j][1][0]) == key:
            j += 1
        chunks.append((key, [(bs, bt) for (_, bs), (_, bt) in pairs[i:j]]))
        i = j
    total = len(pairs)
    model = flagship_model(gen, dropout=0.5)
    results = []
    # streamed, resident, then streamed again under the profiler
    for run, streamed in enumerate((True, False, True)):
        net = copy.deepcopy(model)
        state = TrainState(net, make_optimizer(net.parameters(), TRAIN), 0)
        multi = make_multi_train_step(net, DA, TRAIN)
        rng = torch.Generator("cuda").manual_seed(3)
        streams = [ShardStream(st.features, p, "cuda")
                   for st, p in zip(stores[:2], plans)]
        metrics = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if run == 2
              else contextlib.nullcontext()) as prof:
            for (sid_s, sid_t), chunk in chunks:
                sc = chunk_scalars(state.step, len(chunk), total,
                                   TRAIN.beta)
                if streamed:
                    s_, t_ = stacked_pairs(chunk)
                    state, m = multi(state, streams[0].get(sid_s), *s_,
                                     streams[1].get(sid_t), *t_, sc, rng)
                else:
                    glob = [(bs._replace(abs_indices=np.where(
                        bs.mask[:, None] > 0, bs.abs_indices + np.int32(
                            plans[0].row_lo[sid_s]), 0).astype(np.int32)),
                             bt._replace(abs_indices=np.where(
                                 bt.mask[:, None] > 0, bt.abs_indices
                                 + np.int32(plans[1].row_lo[sid_t]),
                                 0).astype(np.int32)))
                            for bs, bt in chunk]
                    s_, t_ = stacked_pairs(glob)
                    state, m = multi(state, dev[0], *s_, dev[1], *t_, sc,
                                     rng)
                metrics.extend(unstack(m, len(chunk)))
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
        if launched != per_call(total):
            raise AssertionError(f"the streamed epoch launched {launched}")
        results.append((state, metrics, launched))
        label = ["streamed", "resident", "streamed, profiled"][run]
        log(f"  {label}: {total} steps in {len(chunks)} calls, "
            f"{seconds:.3f} s ({card_line()}); launches {launched}")
        if run == 2:
            overlap = copy_overlap(prof)
            log(f"  shards: source {plans[0].num_shards}, target "
                f"{plans[1].num_shards} of {n} rows, uploads "
                f"{streams[0].uploads} + {streams[1].uploads}; "
                + ("copies of >= 50 us: not measured (no device intervals "
                   "in the profile)" if overlap is None else
                   f"copies of >= 50 us: {len(overlap[0])}, ms on the "
                   f"device {[round(t, 4) for t in overlap[0]]}, "
                   f"{overlap[1]:.3f} ms of them while a kernel ran"))
    for got in (results[0], results[2]):
        worst, diff, bitwise = check_same("the resident stores'", got[0],
                                          results[1][0], got[1],
                                          results[1][1])
        if not bitwise:
            raise AssertionError("streamed training is not bitwise the "
                                 "resident stores'")
    log(f"  streamed against resident over one epoch: bitwise equal "
        f"parameters (metrics within {worst:.3e})")
    return results[0][2]


def resident_prec1(argv, ckpt):
    """The val Prec@1 of the resident single-step Trainer (--device_store
    alone) of the train CLI line ``argv`` on the weights of ``ckpt``."""
    args = build_parser().parse_args(argv)
    model_cfg, da_cfg, train_cfg = configs_from_args(args,
                                                     FLAGSHIP.num_class)
    trainer = Trainer(model_cfg, da_cfg, train_cfg,
                      *build_loaders(args, model_cfg, train_cfg)[:3],
                      device_store=True)
    trainer.resume(ckpt)
    with contextlib.redirect_stdout(io.StringIO()):
        return trainer.validate(1)


def chunked_cli(root):
    """Phase 4, the train CLI for one epoch from the stores in each
    chunked mode: --steps_per_call CHUNK_K; with --device_sampler; and
    with --store_budget_rows N (the source store in at least
    CHUNK_SHARDS shards) and --device_sampler.  Every epoch's and
    validation's launches checked per batch (check_trainer_launches), the
    epoch's seconds and videos/s logged, and the validation's Prec@1
    equal to that of the resident single-step Trainer on the same
    weights.  Returns the summed launches and the last run's checkpoint."""
    lists = [os.path.join(root, n, "list.txt") for n in ("src", "tgt", "val")]
    n = budget_rows(FeatureStore.load(os.path.join(root, "src")))
    base = ["--device_store", "--steps_per_call", str(CHUNK_K)]
    runs = (("K steps per call", base),
            ("device sampler", base + ["--device_sampler"]),
            ("streamed, device sampler",
             base + ["--store_budget_rows", str(n), "--device_sampler"]))
    launches = dict.fromkeys(counts(), 0)
    for i, (label, flags) in enumerate(runs):
        exp = os.path.join(root, f"exp_chunked{i}")
        argv = [os.path.join(root, "class.txt"), "RGB", *lists, *MODEL_FLAGS,
                *RECIPE_FLAGS, "--exp_path", exp + "/", "--save_best_log",
                os.path.join(exp, "best.log"), "--epochs", "1",
                "--save_model", *flags]
        with trainer_records() as records:
            best, out = run_cli(cli_train.main, argv)
        prec1 = None
        for rec in records:
            check_trainer_launches(rec)
            launches = {k: launches[k] + v
                        for k, v in rec["launches"].items()}
            if rec["kind"] == "train":
                log(f"  {label}: epoch {rec['seconds']:.3f} s, "
                    f"{rec['steps']} steps, {rec['videos']} videos, "
                    f"{rec['videos'] / rec['seconds']:.0f} videos/s "
                    f"({card_line()}); launches {rec['launches']}")
            else:
                prec1 = rec["out"]
                log(f"  {label}: validation Prec@1 {prec1:.3f} in "
                    f"{rec['seconds'] * 1e3:.1f} ms ({rec['batches']} "
                    f"batches)")
        ckpt = os.path.join(exp, "RGB", "checkpoint.pth.tar")
        want = resident_prec1(argv[:argv.index("--steps_per_call")], ckpt)
        if prec1 != want:
            raise AssertionError(f"{label}: validation Prec@1 {prec1}, the "
                                 f"resident single-step Trainer's {want}")
        log(f"  {label}: Prec@1 equal to the resident single-step "
            f"Trainer's on the same weights ({want:.3f})")
    return launches, ckpt


def streamed_eval_cli(root, weights):
    """Phase 5, the eval CLI with --device_store --store_budget_rows N
    (the val store in at least CHUNK_SHARDS shards) against the resident
    --device_store run: the same Pred@k line, bitwise the same scores and
    attention; one K3 and one K1 (infer) per streamed batch.  Returns the
    streamed run's launches."""
    val = FeatureStore.load(os.path.join(root, "val"))
    n = budget_rows(val)
    plan = ShardPlan(val.offsets, n)
    nb = TSNLoader(val, batch_size=CLI_BATCH, num_segments=5,
                   shuffle=False).shard_epoch_len(plan)
    outs = {}
    for label, extra in (("resident", []),
                         ("streamed", ["--store_budget_rows", str(n)])):
        prefix = os.path.join(root, f"eval_{label}")
        reset_counts()
        t0 = time.perf_counter()
        line, _ = run_cli(cli_test_models.main, eval_cli_args(
            root, weights, "--device_store", "--save_scores",
            prefix + "_scores", "--save_attention", prefix + "_attn",
            *extra))
        seconds = time.perf_counter() - t0
        launched = counts()
        outs[label] = (line, np.load(prefix + "_scores.npz")["scores"],
                       np.loadtxt(prefix + "_attn.txt"), launched)
        log(f"  {label}: {line.strip()} in {seconds:.2f} s "
            f"({card_line()}); launches {launched}")
    line, scores, attn, launched = outs["streamed"]
    want = outs["resident"]
    if line != want[0] or not np.array_equal(scores, want[1]) or \
            not np.array_equal(attn, want[2]):
        raise AssertionError("the streamed eval CLI's outputs differ from "
                             "the resident run's")
    if launched != {"trn_fused_fwd": nb, "trn_fused_fwd_train": 0,
                    "trn_fused_bwd": 0, "gather_gemm": nb}:
        raise AssertionError(f"the streamed eval CLI launched {launched}, "
                             f"expected {nb} K1 and {nb} K3")
    log(f"  streamed ({plan.num_shards} shards of {n} rows, {nb} batches): "
        "scores and attention bitwise the resident run's")
    return launched


# ---- ensembles: N members in one step (train/ensemble.py) ----

def member_stacks(sets):
    """Stack N (x, weights, biases) sets of trn_inputs, members first."""
    x = torch.stack([t[0] for t in sets])
    w = [torch.stack([t[1][i] for t in sets]) for i in range(len(sets[0][1]))]
    bi = [torch.stack([t[2][i] for t in sets])
          for i in range(len(sets[0][2]))]
    return x, w, bi


def member_trn(n, b, s, gen, dtype=torch.float32):
    """N members' TRN inputs at the flagship widths (x of both signs), in
    ``dtype``."""
    x, w, bi = member_stacks([trn_inputs(b, s, 512, 256, gen, signed=True)
                              for _ in range(n)])
    return x.to(dtype), [t.to(dtype) for t in w], [t.to(dtype) for t in bi]


def solo(t, k):
    return [w[k] for w in t]


def member_counts(bf16=False):
    """The launches of the member-batched kernels of one dtype by their
    base names: the float32 kernels' counts(), or the bfloat16 ones' (K3
    at bfloat16 compute from any store as one, gather_gemm_bf16)."""
    if not bf16:
        return counts()
    c = bf16_counts()
    return {"trn_fused_fwd_bf16": c["trn_fused_fwd_bf16"],
            "trn_fused_fwd_train_bf16": c["trn_fused_fwd_train_bf16"],
            "trn_fused_bwd_bf16": c["trn_fused_bwd_bf16"],
            "gather_gemm_bf16": sum(c[f"gather_gemm_{s}_bf16"]
                                    for s in ("f32", "bf16", "int8"))}


def check_launched(what, want, bf16=False):
    """Raise unless the member-batched kernels of the path's dtype launched
    as ``want`` says (by base name, 0 where missing) and those of the other
    dtype not at all; return the path's counts."""
    got = member_counts(bf16)
    if got != {k: want.get(k, 0) for k in got} or any(
            member_counts(not bf16).values()):
        raise AssertionError(f"{what} launched {got}, "
                             f"{member_counts(not bf16)}")
    return got


def kernel_err(got, want, bf16=False):
    """The largest |kernel - plain| and whether it is within the kernel's
    tolerance: RTOL * max(1, max|plain|) in float32, bf16_err in
    bfloat16."""
    if not bf16:
        err = (got - want).abs().max().item() if want.numel() else 0.0
        return err, err <= RTOL * max(1.0, want.abs().max().item()
                                      if want.numel() else 0.0)
    return bf16_err(got, want)


def check_member_trn(gen, bf16=False):
    """The member-batched K1 (infer, train) and K2 of one dtype against N
    solo launches on the members' inputs, bitwise, and against the plain
    version (kernel_err), at MEMBER_TRN_CASES; each call one launch.  The
    worst errors against plain."""
    sfx = "_bf16" if bf16 else ""
    dt = torch.bfloat16 if bf16 else torch.float32
    worst = dict.fromkeys((f"trn_fused_fwd{sfx}_members",
                           f"trn_fused_fwd_train{sfx}_members",
                           f"trn_fused_bwd{sfx}_members"), 0.0)
    with torch.no_grad():
        for n, b, s in MEMBER_TRN_CASES:
            x, w, bi = member_trn(n, b, s, gen, dt)
            g = torch.randn((n, b, s - 1, 256), generator=gen).cuda().to(dt)
            reset_counts()
            out = trn_fused.trn_multiscale_infer_members(x, w, bi, s)
            tout, masks = trn_fused.trn_multiscale_fwd_masks_members(
                x, w, bi, s)
            dx, dws, dbs = trn_fused.trn_multiscale_bwd_members(
                x, w, masks, g, s)
            torch.cuda.synchronize()
            check_launched("member TRN", {f"trn_fused_fwd{sfx}": 1,
                                          f"trn_fused_fwd_train{sfx}": 1,
                                          f"trn_fused_bwd{sfx}": 1}, bf16)
            same, errs = [], [0.0, 0.0, 0.0]
            for k in range(n):
                so = trn_fused.trn_multiscale_infer(x[k], solo(w, k),
                                                    solo(bi, k), s)
                st, sm = trn_fused.trn_multiscale_fwd_masks(
                    x[k], solo(w, k), solo(bi, k), s)
                sdx, sdw, sdb = trn_fused.trn_multiscale_bwd(
                    x[k], solo(w, k), masks[k], g[k], s)
                same.append(all([
                    torch.equal(out[k], so), torch.equal(tout[k], st),
                    torch.equal(masks[k], sm), torch.equal(dx[k], sdx),
                    *(torch.equal(a[k], c) for a, c in zip(dws, sdw)),
                    *(torch.equal(a[k], c) for a, c in zip(dbs, sdb))]))
                plain = trn_fused.trn_multiscale_plain(x[k], solo(w, k),
                                                       solo(bi, k), s)
                pdx, pdw, pdb = trn_fused.trn_multiscale_bwd_plain(
                    x[k], solo(w, k), masks[k], g[k], s)
                for j, (got, want) in enumerate((
                        (out[k], plain), (tout[k], plain), (dx[k], pdx),
                        *((a[k], c) for a, c in zip(dws, pdw)),
                        *((a[k], c) for a, c in zip(dbs, pdb)))):
                    err, ok = kernel_err(got, want, bf16)
                    if not ok:
                        raise AssertionError(
                            f"member TRN output {j} differs from plain at "
                            f"N={n} B={b} S={s}: {err}")
                    errs[min(j, 2)] = max(errs[min(j, 2)], err)
            log(f"  N={n} B={b} S={s}: K1 (infer), K1 (train) with its "
                f"masks and K2's dx, dW, db bitwise equal to {n} solo "
                f"launches: {all(same)}; max|kernel-plain| {errs[0]:.2e}, "
                f"{errs[1]:.2e}, {errs[2]:.2e}; one launch each")
            if not all(same):
                raise AssertionError(f"member TRN kernels differ from solo "
                                     f"launches at N={n} B={b} S={s}")
            for key, e in zip(worst, errs):
                worst[key] = max(worst[key], e)
    return worst


def member_gather_case(n, rows, store, per_member, rng,
                       dtype=torch.float32):
    """N members' weights [N, 512, 2048] in ``dtype``, their indices (one
    set for all or one each) and scales."""
    h, d = FLAGSHIP.fc_dim, (store[0] if isinstance(store, tuple)
                             else store).shape[1]
    w = (torch.from_numpy(rng.uniform(-1, 1, (n, h, d)).astype(np.float32))
         / math.sqrt(d)).cuda().to(dtype)
    sets = [gather_case(rows, store_rows(store), rng)
            for _ in range(n if per_member else 1)]
    if per_member:
        idx = gather_gemm.RowIndex(torch.stack([r.rows for r, _ in sets]),
                                   max(r.end for r, _ in sets))
        scale = torch.stack([sc for _, sc in sets])
    else:
        idx, scale = sets[0]
    return w, idx, scale, sets


def check_member_gather(stores, bf16=False):
    """K3 over N members, shared and per-member indices: z bitwise N solo
    launches and within kernel_err of plain, x_res bitwise; one launch a
    call.  At float32 compute from the float32 store at
    MEMBER_K3_CASES; at bfloat16 compute from each store dtype at
    BF16_MEMBER_K3_CASES and the train rows.  The worst error against
    plain."""
    rng = np.random.default_rng(7)
    compute = "bf16" if bf16 else "f32"
    cases = ([(kind, n, 640, pm) for kind in ("f32", "bf16", "int8")
              for n, pm in BF16_MEMBER_K3_CASES] if bf16 else
             [("f32", n, rows, pm) for n, rows, pm in MEMBER_K3_CASES])
    worst = 0.0
    for kind, n, rows, per_member in cases:
        store = stores[kind]
        w, idx, scale, sets = member_gather_case(
            n, rows, store, per_member, rng,
            torch.bfloat16 if bf16 else torch.float32)
        reset_counts()
        z, x_res = gather_gemm.gathered_gemm_members(store, idx, w, scale)
        torch.cuda.synchronize()
        if gather_gemm.variant_launches[f"{kind}_{compute}"] != 1 or sum(
                gather_gemm.variant_launches.values()) != 1:
            raise AssertionError(f"member K3 launched "
                                 f"{gather_gemm.variant_launches}")
        same, err = [], 0.0
        for k in range(n):
            rk, sk = sets[k if per_member else 0]
            sz, sx = gather_gemm.gathered_gemm(store, rk, w[k], sk)
            pz, _ = gather_gemm.gathered_gemm_plain(store, rk.rows, w[k], sk)
            got_x = x_res[k] if per_member else x_res
            same.append(torch.equal(z[k], sz) and torch.equal(got_x, sx))
            e, ok = kernel_err(z[k], pz, bf16)
            if not ok:
                raise AssertionError(f"member K3 differs from plain at "
                                     f"N={n} rows={rows} ({kind} store): "
                                     f"{e}")
            err = max(err, e)
        log(f"  K3 {kind}_{compute} N={n} rows={rows} "
            f"{'per-member' if per_member else 'shared'} indices: z and "
            f"x_res bitwise equal to {n} solo launches: {all(same)}; "
            f"max|kernel-plain| {err:.2e}; one launch")
        if not all(same):
            raise AssertionError(f"member K3 differs from solo launches at "
                                 f"N={n} rows={rows} ({kind} store)")
        worst = max(worst, err)
    return worst


def time_members(gen, store, bf16=False):
    """Device times of each member-batched kernel of one dtype at N = 1, 4
    and 8 against N solo launches and the plain version member by member,
    in turns (K1 (infer) at B=64, K1 (train) and K2 at B=202, K3 at the
    train shape, 640 rows with x_res, from one index set of ``store``: the
    float32 store at float32 compute, the bfloat16 one at bfloat16); and,
    for K3, index_select + matmul over the stacked weights (in the compute
    dtype).  {name: {N: (times, work)}}."""
    sfx = "_bf16" if bf16 else ""
    dt = torch.bfloat16 if bf16 else torch.float32
    esize = 2 if bf16 else 4
    out = {f"{k}{sfx}_members": {} for k in (
        "trn_fused_fwd", "trn_fused_fwd_train", "trn_fused_bwd",
        "gather_gemm")}
    names = list(out)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for n in MEMBER_TIMED:
            x, w, bi = member_trn(n, SERVE_BATCH, 5, gen, dt)
            t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_infer_members(
                    x, w, bi, 5),
                "solo": lambda: [trn_fused.trn_multiscale_infer(
                    x[k], solo(w, k), solo(bi, k), 5) for k in range(n)],
                "plain": lambda: [trn_fused.trn_multiscale_plain(
                    x[k], solo(w, k), solo(bi, k), 5) for k in range(n)]},
                runs=21)
            flops, nbytes = trn_work(SERVE_BATCH,
                                     esize=esize)["trn_fused_fwd"]
            out[names[0]][n] = (t, (n * flops, n * nbytes))
            b = sum(TRAIN.batch_size[:2])
            x, w, bi = member_trn(n, b, 5, gen, dt)
            g = torch.randn((n, b, 4, 256), generator=gen).cuda().to(dt)
            _, masks = trn_fused.trn_multiscale_fwd_masks_members(x, w, bi,
                                                                  5)
            work = trn_work(b, esize=esize)
            t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_fwd_masks_members(
                    x, w, bi, 5),
                "solo": lambda: [trn_fused.trn_multiscale_fwd_masks(
                    x[k], solo(w, k), solo(bi, k), 5) for k in range(n)],
                "plain": lambda: [trn_fused.trn_multiscale_fwd_masks_plain(
                    x[k], solo(w, k), solo(bi, k), 5) for k in range(n)]},
                runs=21)
            f, nb = work["trn_fused_fwd_train"]
            out[names[1]][n] = (t, (n * f, n * nb))
            t = time_pair({
                "kernel": lambda: trn_fused.trn_multiscale_bwd_members(
                    x, w, masks, g, 5),
                "solo": lambda: [trn_fused.trn_multiscale_bwd(
                    x[k], solo(w, k), masks[k], g[k], 5) for k in range(n)],
                "plain": lambda: [trn_fused.trn_multiscale_bwd_plain(
                    x[k], solo(w, k), masks[k], g[k], 5) for k in range(n)]},
                runs=21)
            f, nb = work["trn_fused_bwd"]
            out[names[2]][n] = (t, (n * f, n * nb))
            rows = K3_TIMED[0][0]
            w, idx, scale, sets = member_gather_case(n, rows, store, False,
                                                     rng, dt)
            t = time_pair({
                "kernel": lambda: gather_gemm.gathered_gemm_members(
                    store, idx, w, scale),
                "solo": lambda: [gather_gemm.gathered_gemm(
                    store, idx, w[k], scale) for k in range(n)],
                "plain": lambda: [gather_gemm.gathered_gemm_plain(
                    store, idx.rows, w[k], scale) for k in range(n)],
                "library": lambda: torch.matmul(
                    store.index_select(0, idx.rows), w.transpose(1, 2))},
                runs=21)
            d, h = store.shape[1], FLAGSHIP.fc_dim
            f, nb = gather_work(idx, d, h, True, store_size=esize,
                                compute_size=esize)
            # N weights and N outputs; the rows and x_res once
            nb += (n - 1) * esize * (h * d + rows * h)
            out[names[3]][n] = (t, (n * f, nb))
    for name, by_n in out.items():
        for n, (t, work) in by_n.items():
            least, by = bound(*work, PEAK_BF16 if bf16 else PEAK_TF32 / 3)
            log(f"  {name} N={n}: kernel {t['kernel']:.4f} ms, {n} solo "
                f"launches {t['solo']:.4f} ms, plain {t['plain']:.4f} ms"
                + (f", index_select + matmul {t['library']:.4f} ms"
                   if "library" in t else "")
                + f" device; bound {least:.4f} ms by {by} (medians of 21, "
                "in turns)")
    return out


def ensemble_models(seeds, dropout=0.0, **fields):
    """The members: flagship models (or with other model ``fields``)
    redrawn at torch's default scale, each from its seed."""
    return [flagship_model(torch.Generator().manual_seed(s), dropout,
                           **fields) for s in seeds]


def member_scalars(i, total, lrs):
    """Step i's per-member scalars: DANN lr of each member's base lr, the
    DANN beta ramp."""
    p = progress(i, 0, total)
    return stack_scalars([StepScalars(effective_beta((-1.0, -1.0, -1.0), p),
                                      0.0, 0.0, TRAIN.gamma,
                                      dann_lr(lr, p)) for lr in lrs])


def record_member_trn():
    """Record the member-batched TRN training forward's inputs and masks
    (the ensemble side's TRN record, member by member, for tie_rows)."""
    rec, original = {}, trn_fused.trn_multiscale_fwd_masks_members

    def recording(x, weights, biases, s, sub=3):
        out = original(x, weights, biases, s, sub)
        rec.update(x=x.detach().clone(), masks=out[1].clone(),
                   weights=[w.detach().clone() for w in weights],
                   biases=[b.detach().clone() for b in biases])
        return out

    return rec, recording, original


def dtype_fields(bf16):
    return {"compute_dtype": "bfloat16"} if bf16 else {}


def train_ensemble(stores, dev, bf16=False):
    """ENSEMBLE_STEPS device-store steps of ENSEMBLE_SEEDS members (two
    lrs), dropout 0, from the stores ``dev`` (float32; at bfloat16
    compute int8): each step launches K3 2x, K1 (train) 1x and K2 1x of
    the compute dtype with no vmap fallback, and each member's updated
    parameters are held to its solo step from the same start
    (extract_member) on the same batch: in float32 at STEP_RTOL and
    PARAM_TOL, in bfloat16 by the bfloat16 steps' rule (BF16_STEP_RTOL,
    check_updates), but for rows fed by a relu mask flipped at a rounding
    tie (tie_rows, the ensemble side's TRN record taken from the
    member-batched kernel's inputs).  Returns the launches and the count
    of vmap fallbacks."""
    import warnings

    n = len(ENSEMBLE_SEEDS)
    ens = stack_members(ensemble_models(ENSEMBLE_SEEDS, **dtype_fields(bf16)),
                        TRAIN)
    step = make_ensemble_step(ens.model, DA, TRAIN, gather_on_device=True)
    gens = ensemble_generators(ENSEMBLE_SEEDS, "cuda")
    ls, lt = store_loaders(stores)
    batches = zip(endless(ls.index_epoch), endless(lt.index_epoch))
    rec, recording, original = record_member_trn()
    sfx = "_bf16" if bf16 else ""
    per_step = {f"trn_fused_fwd_train{sfx}": 1, f"trn_fused_bwd{sfx}": 1,
                f"gather_gemm{sfx}": 2}
    launches = dict.fromkeys(member_counts(bf16), 0)
    fallbacks, worst_rel, worst, ties = 0, 0.0, 0.0, 0
    tie_rtol = BF16_TIE_RTOL if bf16 else RTOL
    for i in range(ENSEMBLE_STEPS):
        bs, bt = next(batches)
        sc = member_scalars(i, ENSEMBLE_STEPS, ENSEMBLE_LRS)
        solos = [extract_member(ens, k, TRAIN) for k in range(n)]
        trn_fused.trn_multiscale_fwd_masks_members = recording
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                reset_counts()
                ens, got = step(ens, dev[0], *bs, dev[1], *bt, sc, gens)
                torch.cuda.synchronize()
                launched = check_launched(f"ensemble step {i}", per_step,
                                          bf16)
        finally:
            trn_fused.trn_multiscale_fwd_masks_members = original
        fallbacks += sum("performance drop" in str(w.message)
                         for w in caught)
        launches = {k: launches[k] + launched[k] for k in launches}
        for k, st in enumerate(solos):
            before = {key: v.clone() for key, v in named(st.model).items()}
            ref_rec, hook = record_trn(st.model)
            solo_step = make_train_step(st.model, DA, TRAIN,
                                        gather_on_device=True)
            st, want = solo_step(st, dev[0], *bs, dev[1], *bt,
                                 StepScalars(*(f[k] for f in sc)), None)
            hook.remove()
            ours = {"x": rec["x"][k], "masks": rec["masks"][k]}
            ours["z"] = preacts(ours["x"], solo(rec["weights"], k),
                                solo(rec["biases"], k), 5)
            allowed, _ = tie_rows(ours, ref_rec, tie_rtol)
            member = extract_member(ens, k, TRAIN).model
            worst_rel = max(worst_rel, check_metrics(
                i, {key: float(v[k]) for key, v in got.items()},
                {key: float(v) for key, v in want.items()},
                f"member {k}'s solo step",
                *((BF16_STEP_RTOL, 1e-6) if bf16 else ())))
            if bf16:
                diff, let = check_updates(i, member, st.model, before,
                                          allowed)
            else:
                diff, let = check_params(i, member, st.model,
                                         f"member {k}'s solo step", allowed)
            worst, ties = max(worst, diff), ties + let
        log(f"  step {i}: losses {[round(float(v), 5) for v in got['loss']]}"
            f", launched {launched}, vmap fallbacks so far {fallbacks}")
    held = (f"each tensor's update within {worst:.3e} of its largest "
            f"(tolerance {BF16_UPDATE_RTOL}" if bf16 else
            f"parameters within {worst:.3e} (rtol {PARAM_TOL['rtol']}, "
            f"atol {PARAM_TOL['atol']}")
    log(f"  {n} members x {ENSEMBLE_STEPS} steps, each member against its "
        f"solo step from the same start: metrics within {worst_rel:.3e} "
        f"relative (tolerance {BF16_STEP_RTOL if bf16 else STEP_RTOL}), "
        f"{held}; {ties} rows let through); vmap fallbacks {fallbacks}; "
        f"launches {launches}")
    if fallbacks:
        raise AssertionError(f"{fallbacks} vmap fallbacks in the flagship "
                             "ensemble step")
    return launches, fallbacks


def time_ensemble_step(stores, dev, bf16=False):
    """ms per ensemble step of ENSEMBLE_SEEDS members against as many solo
    steps (one after another, one model each), dropout 0.5, in turns; the
    device's busy time and idle share of each under the profiler."""
    n = len(ENSEMBLE_SEEDS)
    models = ensemble_models(ENSEMBLE_SEEDS, dropout=0.5,
                             **dtype_fields(bf16))
    ens = stack_members(models, TRAIN)
    estep = make_ensemble_step(ens.model, DA, TRAIN, gather_on_device=True)
    gens = ensemble_generators(ENSEMBLE_SEEDS, "cuda")
    solos = [TrainState(m, make_optimizer(m.parameters(), TRAIN), 0)
             for m in models]
    sstep = [make_train_step(m, DA, TRAIN, gather_on_device=True)
             for m in models]
    sgens = ensemble_generators(ENSEMBLE_SEEDS, "cuda")
    ls, lt = store_loaders(stores, seed=5)
    batches = zip(endless(ls.index_epoch), endless(lt.index_epoch))
    state = {"ens": ens, "solo": solos}
    sc = member_scalars(0, 100, ENSEMBLE_LRS)

    def run(name, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            bs, bt = next(batches)
            if name == "ensemble":
                state["ens"], m = estep(state["ens"], dev[0], *bs, dev[1],
                                        *bt, sc, gens)
            else:
                for k in range(n):
                    state["solo"][k], m = sstep[k](
                        state["solo"][k], dev[0], *bs, dev[1], *bt,
                        StepScalars(*(f[k] for f in sc)), sgens[k])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    for name in ("ensemble", "solo"):
        run(name, 3)
    times = {"ensemble": [], "solo": []}
    for order in (("solo", "ensemble"), ("ensemble", "solo"),
                  ("solo", "ensemble")):
        for name in order:
            times[name].append(run(name, ENSEMBLE_TIMED))
    result = {}
    kind = "bfloat16 " if bf16 else ""
    for name, t in times.items():
        ms = statistics.median(t)
        label = (f"{kind}ensemble steps of {n} members" if name == "ensemble"
                 else f"rounds of {n} solo {kind}steps")
        log(f"  {label}: {ms:.3f} ms each ({ENSEMBLE_TIMED} back to back, "
            f"median of {len(t)}, in turns)")
        busy, idle = device_profile(lambda s: run(name, s), 3, ms, label)
        result[name] = (ms, busy, idle)
    return result


def eval_ensemble(stores, val_dev, bf16=False):
    """One val batch of CLI_BATCH videos through the ensemble eval step
    from the store ``val_dev``: K3 1x and K1 (infer) 1x for all members,
    each member's logits within kernel_err of its solo eval step's."""
    n = len(ENSEMBLE_SEEDS)
    ens = stack_members(ensemble_models(ENSEMBLE_SEEDS, **dtype_fields(bf16)),
                        TRAIN)
    ev = make_ensemble_eval_step(ens.model, gather_on_device=True)
    lv = TSNLoader(stores[2], batch_size=CLI_BATCH,
                   num_segments=FLAGSHIP.val_segments, mode="test",
                   shuffle=False)
    b = next(iter(lv.index_epoch()))
    sfx = "_bf16" if bf16 else ""
    reset_counts()
    m = ev(ens, val_dev, b.abs_indices, b.labels, b.mask)
    torch.cuda.synchronize()
    launched = check_launched("ensemble val batch",
                              {f"trn_fused_fwd{sfx}": 1,
                               f"gather_gemm{sfx}": 1}, bf16)
    worst = 0.0
    for k in range(n):
        member = extract_member(ens, k, TRAIN).model
        want = make_eval_step(member, gather_on_device=True)(
            val_dev, b.abs_indices, b.labels, b.mask)["logits"]
        err, ok = kernel_err(m["logits"][k], want, bf16)
        if not ok:
            raise AssertionError(f"member {k}'s ensemble eval logits differ "
                                 f"from its solo eval: {err}")
        worst = max(worst, err)
    log(f"  one val batch of {CLI_BATCH} videos, {n} members: launched "
        f"{launched}; each member's logits within {worst:.2e} of its solo "
        "eval step")
    return launched


def serve_ensemble(workdir, bf16=False):
    """A sweep directory of the members' checkpoints served over HTTP by
    Predictor.from_sweep: K1 (infer) once a chunk for every member, and
    the averaged probabilities equal to the mean of the members' solo
    Predictors' within PROB_TOL (in bfloat16 BF16_PROB_TOL: the logits an
    ulp or two apart where the members' products sum in other orders)."""
    cfg = BF16_FLAGSHIP if bf16 else FLAGSHIP
    tol = BF16_PROB_TOL if bf16 else PROB_TOL
    sweep = os.path.join(workdir, "sweep")
    for k, model in enumerate(ensemble_models(ENSEMBLE_SEEDS,
                                              **dtype_fields(bf16))):
        save_checkpoint(os.path.join(sweep, f"member_{k:02d}"), {
            "epoch": 1, "arch": "resnet101", "best_prec1": 0.0,
            "prec1": 0.0, "state_dict": {
                f"module.{key}": v for key, v in
                export_reference_state(model).items()}})
    predictor = Predictor.from_sweep(sweep, cfg, device="cuda",
                                     batch_size=SERVE_BATCH)
    solos = [Predictor.from_checkpoint(
        os.path.join(sweep, f"member_{k:02d}", "checkpoint.pth.tar"),
        cfg, device="cuda", batch_size=SERVE_BATCH)
        for k in range(len(ENSEMBLE_SEEDS))]
    rng = np.random.default_rng(1)
    requests = [rng.random((n, 5, FLAGSHIP.input_feature_dim), np.float32)
                for n in REQUEST_SIZES]
    server = make_http_server(predictor, [f"class_{i}" for i in range(12)],
                              "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for label in ("warm-up", "served"):
            reset_counts()
            answers = []
            for feats in requests:
                t0 = time.perf_counter()
                answers.append(post(f"{url}/predict",
                                    {"features": feats.tolist()}))
                log(f"  POST /predict ({label}), {feats.shape[0]} videos, "
                    f"{predictor.n_members} members: "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        chunks = sum(-(-n // SERVE_BATCH) for n in REQUEST_SIZES)
        launches = check_launched(
            "ensemble serving",
            {"trn_fused_fwd_bf16" if bf16 else "trn_fused_fwd": chunks},
            bf16)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for feats, ans in zip(requests, answers):
        probs, top_p, top_i = predictor(feats)
        mean = np.mean([p(feats)[0] for p in solos], axis=0)
        err = np.abs(probs - mean).max()
        top = np.sort(mean, axis=1)[:, ::-1][:, :5]
        log(f"  {feats.shape[0]} videos: |averaged - mean of solo "
            f"Predictors| = {err:.2e}; served top-5 probabilities within "
            f"{np.abs(np.asarray(ans['top_probs']) - top).max():.2e}")
        if not err <= tol or not np.allclose(
                np.asarray(ans["top_probs"]), top, atol=tol):
            raise AssertionError("ensemble probabilities differ from the "
                                 "mean of the members' solo Predictors")
    return launches


def sweep_cli(root, bf16=False):
    """cli.sweep on the stores of the published split sizes: 1 epoch, 2
    seeds x 2 lrs, one JSON line per member and a summary (at bfloat16
    compute from int8 stores: --compute_dtype bfloat16 --store_dtype
    int8); then the eval CLI, with the same dtypes, on member 0's
    checkpoint, whose Pred@1 must be the member's reported top-1."""
    dtypes = (["--compute_dtype", "bfloat16", "--store_dtype", "int8"]
              if bf16 else [])
    out_dir = os.path.join(root, "sweep_cli_bf16" if bf16 else "sweep_cli")
    argv = [os.path.join(root, "class.txt"), "RGB",
            os.path.join(root, "src", "list.txt"),
            os.path.join(root, "tgt", "list.txt"),
            os.path.join(root, "val", "list.txt"),
            "--exp_path", os.path.join(root, "sweep_exp") + "/",
            *MODEL_FLAGS, *RECIPE_FLAGS, "--epochs", "1", "--sweep_seeds",
            "0", "1", "--sweep_lrs", "0.03", "0.01", "--sweep_dir", out_dir,
            *dtypes]
    reset_counts()
    t0 = time.perf_counter()
    result, text = run_cli(cli_sweep.main, argv)
    seconds = time.perf_counter() - t0
    launched = check_launched("the sweep CLI", member_counts(bf16), bf16)
    lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    for line in lines:
        log(f"  {json.dumps(line)}")
    rows = result["results"]
    if len(rows) != 4 or len(lines) != 5 or any(
            r["final_loss"] is None for r in rows):
        raise AssertionError("the sweep CLI did not train 4 members")
    log(f"  cli.sweep {' '.join(dtypes)}: 4 members, 1 epoch, "
        f"{seconds:.1f} s with the build of its steps and its validation; "
        f"launches {launched}")
    _, text = run_cli(cli_test_models.main, eval_cli_args(
        root, os.path.join(out_dir, "member_00", "checkpoint.pth.tar"),
        "--device_store", *dtypes))
    want = f"Pred@1 {rows[0]['top1']:.2f}%"
    log(f"  eval CLI on member_00: {text.strip().splitlines()[-1][:100]}")
    if want not in text:
        raise AssertionError(f"the eval CLI does not reproduce member 0's "
                             f"top-1 ({want})")
    return launched


def ensemble_phase(gen, stores, dev, root, bf16=False):
    """The ensemble slice at one compute dtype: the member-batched kernels
    against N solo launches, then each path with the counts set to 0 just
    before it and read just after (at bfloat16 compute from int8 stores,
    as the bfloat16 steps' users run them).  Returns (launches of the
    member-batched kernels on the paths, their worst errors against plain,
    their times, the ensemble step's times)."""
    kind = "bfloat16" if bf16 else "float32"
    log(f"member-batched K1 (infer, train) and K2 in {kind} against N solo "
        "launches")
    errs = check_member_trn(gen, bf16)
    log(f"member-batched K3 at {kind} compute against N solo launches")
    k3_stores = (narrow_stores(dev[0], stores[0]) if bf16
                 else {"f32": dev[0]})
    errs[f"gather_gemm{'_bf16' if bf16 else ''}_members"] = \
        check_member_gather(k3_stores, bf16)
    log(f"member-batched {kind} kernel times at N = {MEMBER_TIMED} "
        f"({card_line()})")
    times = time_members(gen, k3_stores["bf16" if bf16 else "f32"], bf16)
    del k3_stores
    path_dev = ([st.to_device("cuda", "int8") for st in stores] if bf16
                else dev)
    log(f"{kind} ensemble of {len(ENSEMBLE_SEEDS)} members (seeds "
        f"{ENSEMBLE_SEEDS}, lrs {ENSEMBLE_LRS}), {TRAIN.batch_size[0]} + "
        f"{TRAIN.batch_size[1]} videos from the {'int8 ' if bf16 else ''}"
        "stores: against each member's solo step")
    launches = dict.fromkeys(member_counts(bf16), 0)

    def add(got):
        for key, v in got.items():
            launches[key] += v

    steps, _ = train_ensemble(stores, path_dev, bf16)
    add(steps)
    log(f"{kind} ensemble step timing ({card_line()})")
    step_t = time_ensemble_step(stores, path_dev, bf16)
    log(f"{kind} ensemble eval: one val batch")
    add(eval_ensemble(stores, path_dev[2], bf16))
    log(f"{kind} deep-ensemble serving over HTTP (Predictor.from_sweep)")
    with tempfile.TemporaryDirectory() as workdir:
        add(serve_ensemble(workdir, bf16))
    log(f"the sweep CLI for one epoch at {kind} compute, then the eval CLI "
        "on a member")
    add(sweep_cli(root, bf16))
    log(f"member-batched {kind} launches on the ensemble paths: {launches}")
    return launches, errs, times, step_t


# ---- serving extras and the feature extractor (int8, AOT, pipelining) ----

INT8_FLAGSHIP = dataclasses.replace(FLAGSHIP, quantize="int8")
INT8_CPU_TOL = 1e-5      # int8 on the card against int8 on the CPU (probs)
INT8_RULE = 0.05         # JAX's rule against float32: same argmax, |dp| <
INT8_RULE_VIDEOS = 8     # JAX's sample: standard-normal features
# (M, K, N) of the flagship's int8 products at batch 64 and 1: the shared
# FC, the frame domain FC, the TRN scales k = 5..2, the relation heads'
# first layers and the video domain FC
INT8_SHAPES = ((320, 2048, 512), (5, 2048, 512), (320, 512, 512),
               (64, 2560, 256), (192, 2048, 256), (192, 1536, 256),
               (192, 1024, 256), (1, 1024, 256), (64, 256, 256),
               (1, 256, 256))
INT8_MIN_GEMMS = 8       # int8 products a flagship forward at least makes
EXPORT_TOL = 1e-5        # an artifact's probabilities against the live path
PIPELINE_VIDEOS = 640    # one request of 10 chunks of SERVE_BATCH
PIPELINE_ROUNDS = 5      # timed in turns: pipelined, one by one, ...
EXTRACT_TOL = 1e-4       # card features within this share of their largest
EXTRACT_FRAMES = 40      # per "video", preprocessed 224x224 frames
EXTRACT_BATCH = 32       # --batch_size
C3D_FRAMES = 20          # 112x112 frames a "video": 5 clips of 16
CPU_FRAMES = 8           # frames (clips: 2) of each video checked on the CPU


def int8_weights(cfg, seed):
    """A model of ``cfg`` on the CPU, every Linear drawn from a seed at
    torch's default scale, as the float32 serving phase draws them
    (`serve_flagship`): logits far from uniform, not saturated."""
    gen = torch.Generator().manual_seed(seed)
    model = VideoModel(cfg, generator=gen)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            torch_default_uniform_(mod, gen)
    return model


def save_weights(model, path):
    """A model's reference-format .pth.tar."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 0, "arch": "resnet101", "best_prec1": 0.0,
                "prec1": 0.0,
                "state_dict": {f"module.{k}": v.cpu() for k, v in
                               export_reference_state(model).items()}},
               path)
    return path


@contextlib.contextmanager
def http_server(predictor):
    """A predictor served over HTTP on a free port; yields its URL."""
    server = make_http_server(predictor, [f"class_{i}" for i in range(12)],
                              "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def serve_requests(predictor, requests, label):
    """Warm-up and served rounds of POST /predict; the served answers, the
    kernel launches and int8 products of the served round."""
    with http_server(predictor) as url:
        for rnd in ("warm-up", "served"):
            reset_counts()
            layers.int8_gemms = 0
            answers = []
            for feats in requests:
                t0 = time.perf_counter()
                answers.append(post(f"{url}/predict",
                                    {"features": feats.tolist()}))
                log(f"  POST /predict ({label}, {rnd}), {feats.shape[0]} "
                    f"videos: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return answers, counts(), layers.int8_gemms


def predictor_ms(pred, x_np):
    """(device ms of one forward on an uploaded batch, call ms of one
    Predictor call on the host batch, upload and fetch included), medians
    of 11 after 3 warm-up calls."""
    x = torch.from_numpy(x_np).cuda()
    for _ in range(3):
        pred(x_np)
    dev = statistics.median(device_ms(lambda: pred._forward(x))
                            for _ in range(11))
    call = statistics.median(call_ms(lambda: pred(x_np)) for _ in range(11))
    return dev, call


def check_int8_ops():
    """``int8_matmul`` at the flagship's shapes (INT8_SHAPES; torch._int_mm
    padded past 16 rows at batch 1) on the card against the CPU, on the
    same post-relu rows and weights: bitwise equal (the codes and the
    int32 products are exact, the rescale elementwise)."""
    gen = torch.Generator().manual_seed(9)
    for m, k, n in INT8_SHAPES:
        x = torch.relu(torch.randn(m, k, generator=gen))
        w = torch.randn(n, k, generator=gen) * 0.05
        got = layers.int8_matmul(x.cuda(), w.cuda()).cpu()
        if not torch.equal(got, layers.int8_matmul(x, w)):
            raise AssertionError(f"int8_matmul at {(m, k, n)} differs from "
                                 "the CPU")
    log(f"  int8_matmul at {len(INT8_SHAPES)} flagship shapes (M, K, N) "
        f"{list(INT8_SHAPES)}: bitwise equal to the CPU")


def int8_phase(workdir, root):
    """int8 inference at the flagship's widths: its products bitwise the
    CPU's at every flagship shape; the int8 Predictor served over HTTP at
    batch 64 and in process at batch 1, held to the same weights' int8
    plain path on the CPU, with its int8 products a forward and no K1;
    against the float32 Predictor, JAX's rule (tests/test_int8_infer.py:
    147-152) measured on the served videos and on JAX's sample, logged
    (it holds or fails by the videos near a tie); a 2-member int8 from_sweep
    with no vmap fallback; the int8 eval CLI on the val store from host
    features and from the store.  Returns the weights and the times."""
    check_int8_ops()
    weights = save_weights(int8_weights(INT8_FLAGSHIP, 7),
                           os.path.join(workdir, "int8", "model.pth.tar"))
    rng = np.random.default_rng(3)
    sample = rng.normal(size=(INT8_RULE_VIDEOS, 5,
                              FLAGSHIP.input_feature_dim)).astype(np.float32)
    requests = [rng.random((n, 5, FLAGSHIP.input_feature_dim), np.float32)
                for n in REQUEST_SIZES]
    times = {}
    for batch in (SERVE_BATCH, 1):
        q = Predictor.from_checkpoint(weights, INT8_FLAGSHIP,
                                      batch_size=batch)
        if batch == SERVE_BATCH:
            answers, launched, gemms = serve_requests(q, requests, "int8")
            chunks = sum(-(-n // batch) for n in REQUEST_SIZES)
            feats = requests
        else:
            feats = [requests[0]]
            q(feats[0])
            reset_counts()
            layers.int8_gemms = 0
            answers = [q(feats[0]) for _ in range(5)][-1:]
            launched, gemms, chunks = counts(), layers.int8_gemms, 5
        per_forward = gemms / chunks
        log(f"  int8 at batch {batch}: launches {launched}, {gemms} int8 "
            f"products in {chunks} forwards ({per_forward:g} a forward)")
        if any(launched.values()):
            raise AssertionError(f"int8 serving launched {launched}")
        if per_forward < INT8_MIN_GEMMS or per_forward != int(per_forward):
            raise AssertionError(f"{per_forward} int8 products a forward")
        cpu = Predictor.from_checkpoint(weights, INT8_FLAGSHIP, device="cpu",
                                        batch_size=batch)
        f32 = Predictor.from_checkpoint(weights, FLAGSHIP, batch_size=batch)
        for x, ans in zip([*feats, sample], [*answers, None]):
            got = q(x)
            want = cpu(x)
            ref = f32(x)
            err = np.abs(got[0] - want[0]).max()
            dps = np.abs(got[0] - ref[0]).max(1)
            dp = dps.max()
            agree = (got[0].argmax(1) == ref[0].argmax(1)).mean()
            label = f"{x.shape[0]} videos" if ans is not None else \
                "JAX's sample"
            log(f"  int8 batch {batch}, {label}: |card - CPU| = {err:.2e}; "
                f"against float32: argmax agreement {agree:.3f}, max |dp| "
                f"= {dp:.2e}, median {np.median(dps):.2e}; mean top-1 "
                f"probability {got[1][:, 0].mean():.3f}")
            if not err <= INT8_CPU_TOL or not np.array_equal(
                    got[2][:, 0], want[2][:, 0]):
                raise AssertionError("int8 on the card differs from the CPU")
            log(f"    JAX's rule (the same argmax, max |dp| < {INT8_RULE})"
                f": {agree == 1.0 and dp < INT8_RULE}")
            if ans is None:
                continue
            served = (np.asarray(ans["top_classes"]) if isinstance(ans, dict)
                      else ans[2])
            if not np.array_equal(served[:, 0], got[2][:, 0]):
                raise AssertionError("served int8 top class differs")
        x = requests[-1][:batch]
        times[batch] = {"int8": predictor_ms(q, x),
                        "f32": predictor_ms(f32, x)}
        log(f"  batch {batch} ({card_line()}): int8 device "
            f"{times[batch]['int8'][0]:.3f} ms, call "
            f"{times[batch]['int8'][1]:.3f} ms; float32 device "
            f"{times[batch]['f32'][0]:.3f} ms, call "
            f"{times[batch]['f32'][1]:.3f} ms")

    sweep = os.path.join(workdir, "int8_sweep")
    for k in range(2):
        save_weights(int8_weights(INT8_FLAGSHIP, 20 + k),
                     os.path.join(sweep, f"member_{k:02d}",
                                  "checkpoint.pth.tar"))
    ens = Predictor.from_sweep(sweep, INT8_FLAGSHIP, batch_size=SERVE_BATCH)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_counts()
        probs = ens(requests[-1])[0]
    fallbacks = sum("performance drop" in str(w.message) for w in caught)
    solos = np.mean([Predictor.from_checkpoint(
        os.path.join(sweep, f"member_{k:02d}", "checkpoint.pth.tar"),
        INT8_FLAGSHIP, batch_size=SERVE_BATCH)(requests[-1])[0]
        for k in range(2)], axis=0)
    err = np.abs(probs - solos).max()
    log(f"  2-member int8 from_sweep: |averaged - mean of solos| = "
        f"{err:.2e}; vmap fallbacks {fallbacks}; launches {counts()}")
    if fallbacks or not err <= PROB_TOL or any(counts().values()):
        raise AssertionError("the int8 ensemble is wrong")

    lines = {}
    for label, extra in (("host features", []),
                         ("device store", ["--device_store"])):
        prefix = os.path.join(root, "int8_" + label.replace(" ", "_"))
        reset_counts()
        line, _ = run_cli(cli_test_models.main, eval_cli_args(
            root, weights, "--quantize", "int8", "--save_scores",
            prefix + "_scores", *extra))
        lines[label] = (line, np.load(prefix + "_scores.npz")["scores"])
        log(f"  int8 eval CLI ({label}): {line.strip()}; launches "
            f"{counts()}")
        if any(counts().values()):
            raise AssertionError("the int8 eval CLI launched a kernel")
    (l1, s1), (l2, s2) = lines.values()
    if l1 != l2 or not np.abs(s1 - s2).max() <= PROB_TOL:
        raise AssertionError("int8 eval CLI from the store differs")
    return weights, times


def export_phase(workdir, root, weights):
    """The flagship exported through cli.serve --export from a .pth.tar,
    float32 and int8, loaded by Predictor.from_exported on the card and
    served over HTTP: answers within EXPORT_TOL of the live Predictor's,
    no K1; exported and live timed.  Returns (K1 launches of the live
    paths, times)."""
    rng = np.random.default_rng(4)
    requests = [rng.random((n, 5, FLAGSHIP.input_feature_dim), np.float32)
                for n in REQUEST_SIZES]
    classes = os.path.join(root, "class.txt")
    k1, times = 0, {}
    for label, cfg, extra in (("float32", FLAGSHIP, []),
                              ("int8", INT8_FLAGSHIP,
                               ["--quantize", "int8"])):
        out = os.path.join(workdir, f"export_{label}")
        t0 = time.perf_counter()
        _, text = run_cli(cli_serve.main, [classes, weights, "--export", out,
                                           *extra])
        log(f"  {text.strip()} in {time.perf_counter() - t0:.1f} s")
        served = Predictor.from_exported(out)
        live = Predictor.from_checkpoint(weights, cfg,
                                         batch_size=SERVE_BATCH)
        answers, launched, _ = serve_requests(served, requests,
                                              f"{label} artifact")
        if any(launched.values()):
            raise AssertionError(f"the artifact launched {launched}")
        for x, ans in zip(requests, answers):
            reset_counts()
            want = live(x)
            k1 += counts()["trn_fused_fwd"]
            got = served(x)
            err = np.abs(got[0] - want[0]).max()
            log(f"  {label} artifact, {x.shape[0]} videos: |artifact - "
                f"live| = {err:.2e}")
            if not err <= EXPORT_TOL or not np.array_equal(
                    np.asarray(ans["top_classes"])[:, 0], want[2][:, 0]):
                raise AssertionError(f"the {label} artifact differs")
        x = requests[-1][:SERVE_BATCH]
        reset_counts()
        times[label] = {"exported": predictor_ms(served, x)[1],
                        "live": predictor_ms(live, x)[1]}
        k1 += counts()["trn_fused_fwd"]
        log(f"  {label} at batch {SERVE_BATCH} ({card_line()}): exported "
            f"{times[label]['exported']:.3f} ms a call, live "
            f"{times[label]['live']:.3f} ms")
    return k1, times


def pipelined_phase():
    """A request of PIPELINE_VIDEOS videos (10 chunks of SERVE_BATCH)
    through the pipelined Predictor against the same chunks fetched one
    call each: bitwise equal, and timed in turns.  Returns (K1 launches,
    times)."""
    pred = Predictor(FLAGSHIP, flagship_model(torch.Generator().manual_seed(
        5)), batch_size=SERVE_BATCH)
    x = np.random.default_rng(5).random(
        (PIPELINE_VIDEOS, 5, FLAGSHIP.input_feature_dim), np.float32)

    def one_by_one():
        return [np.concatenate(o) for o in zip(*(
            pred(x[lo:lo + SERVE_BATCH])
            for lo in range(0, PIPELINE_VIDEOS, SERVE_BATCH)))]

    reset_counts()
    got, want = pred(x), one_by_one()
    launched = counts()["trn_fused_fwd"]
    equal = all(np.array_equal(a, b) for a, b in zip(got, want))
    chunks = PIPELINE_VIDEOS // SERVE_BATCH
    log(f"  pipelined against one by one, {PIPELINE_VIDEOS} videos: "
        f"bitwise equal {equal}; K1 launches {launched} (2 x {chunks})")
    if not equal or launched != 2 * chunks:
        raise AssertionError("the pipelined fetch differs")
    runs = {"pipelined": [], "one by one": []}
    for i in range(2 * PIPELINE_ROUNDS):
        order = (("pipelined", lambda: pred(x)),
                 ("one by one", one_by_one))
        for name, fn in order if i % 2 == 0 else order[::-1]:
            runs[name].append(call_ms(fn))
    launched = counts()["trn_fused_fwd"]
    times = {k: statistics.median(v) for k, v in runs.items()}
    log(f"  {PIPELINE_VIDEOS} videos ({card_line()}): pipelined "
        f"{times['pipelined']:.2f} ms, one by one "
        f"{times['one by one']:.2f} ms (medians of "
        f"{2 * PIPELINE_ROUNDS} in turns)")
    return launched, times


def backbone_state(net, seed):
    """A seeded state_dict in the backbone's (torchvision's or the
    reference's) format: He-normal weights, biases near 0, BN statistics
    near identity."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in net.state_dict().items():   # t on "meta": shapes only
        shape = t.shape
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros(shape, dtype=t.dtype)
        elif name.endswith("running_var"):
            state[name] = torch.rand(shape, generator=gen) + 0.5
        elif name.endswith(("running_mean", "bias")):
            state[name] = torch.randn(shape, generator=gen) * 0.1
        elif name.startswith("bn") or ".bn" in name or "downsample.1" in name:
            state[name] = torch.rand(shape, generator=gen) * 0.5 + 0.5
        else:
            state[name] = torch.randn(shape, generator=gen) * math.sqrt(
                2.0 / math.prod(shape[1:]))
    return state


def extract_phase(workdir):
    """Feature extraction on the card: a seeded torchvision-format
    resnet101 state_dict saved to disk, make_extractor + extract_batched
    on 2 "videos" of EXTRACT_FRAMES preprocessed 224x224 frames at
    --batch_size EXTRACT_BATCH, the shards written and packed by
    ``video2feature --finalize``; C3D with both activations on
    C3D_FRAMES-frame 112x112 videos; features within EXTRACT_TOL of the
    same extractor on the CPU (its first frames or clips); frames/s and
    clips/s, float32 with cuDNN's TF32 off.  Returns the rates."""
    from ta3n_tpu_torch.models.backbones import (C3DFeatures,
                                                 ResNetFeatures,
                                                 clips_from_frames)
    rng = np.random.default_rng(6)
    rates = {}
    cases = [("resnet101", "none", ResNetFeatures("resnet101", "meta"),
              (EXTRACT_FRAMES, 224, 224, 3), 2048)]
    cases += [("c3d", act, C3DFeatures(act, "meta"),
               (C3D_FRAMES, 112, 112, 3), 4096) for act in ("none", "relu")]
    for base, act, net, shape, dim in cases:
        path = os.path.join(workdir, f"{base}.pth")
        torch.save(backbone_state(net, 7), path)
        root = os.path.join(workdir, f"{base}_{act}-features")
        run = video2feature.make_extractor(base, path, EXTRACT_BATCH, act)
        cpu = video2feature.make_extractor(base, path, EXTRACT_BATCH, act,
                                           device="cpu")
        feats = []
        for v in range(2):
            frames = rng.normal(size=shape).astype(np.float32)
            inputs = clips_from_frames(frames) if base == "c3d" else frames
            got = video2feature.extract_batched(inputs, run, EXTRACT_BATCH)
            n_cpu = 2 if base == "c3d" else CPU_FRAMES
            want = cpu(inputs[:n_cpu])
            err = np.abs(got[:n_cpu] - want).max() / np.abs(want).max()
            log(f"  {base} ({act}) video {v}: {got.shape}; card against "
                f"CPU on {n_cpu}: {err:.2e} of the largest")
            if got.shape != (inputs.shape[0], dim) or not err <= EXTRACT_TOL:
                raise AssertionError(f"{base} features differ from the CPU")
            os.makedirs(os.path.join(root, "shards", "class_0"),
                        exist_ok=True)
            np.save(os.path.join(root, "shards", "class_0", f"v{v}.npy"),
                    got)
            feats.append(got)
        _, text = run_cli(video2feature.main, ["--finalize", root])
        store = FeatureStore.load(root)
        log(f"  {text.strip()}")
        if store.paths != ["class_0/v0", "class_0/v1"] or not \
                np.array_equal(np.asarray(store.features),
                               np.concatenate(feats)):
            raise AssertionError("the finalized store differs")
        batch = np.ascontiguousarray(np.concatenate(
            [inputs] * (-(-EXTRACT_BATCH // inputs.shape[0])))[
                :EXTRACT_BATCH if base != "c3d" else 8])
        run(batch)
        ms = statistics.median(call_ms(lambda: run(batch)) for _ in range(5))
        rate = batch.shape[0] * 1e3 / ms
        unit = "clips" if base == "c3d" else "frames"
        rates[f"{base}_{act}"] = rate
        log(f"  {base} ({act}): {rate:.1f} {unit}/s at batch "
            f"{batch.shape[0]}, float32, cuDNN TF32 off ({card_line()})")
    return rates


# the last single-card modules (after every other phase): the native host
# gather at the train batches (source, target), timed as a median of
# GATHER_RUNS in turns with numpy's fancy index; NATIVE_STEPS host-feature
# steps a turn with each; the tags the JAX Trainer writes to tensorboard
GATHER_BATCHES = (128, 74)
GATHER_RUNS = 41
NATIVE_STEPS = 20
TB_TAGS = ("train_source", "train_target", "train_DA", "train_DA_labels",
           "validation", "Best_Accuracy")
# a recording tensorboardX, written into a scratch directory on sys.path
STUB_TENSORBOARDX = """CALLS = []


class SummaryWriter:
    def __init__(self, logdir):
        CALLS.append(("init", logdir))

    def add_embedding(self, mat, metadata=None, global_step=None, tag=None):
        CALLS.append(("embedding", tag, tuple(mat.shape), len(metadata),
                      global_step))

    def add_text(self, tag, text, step):
        CALLS.append(("text", tag, text, step))

    def close(self):
        CALLS.append(("close",))
"""


@contextlib.contextmanager
def native_gather_on(on):
    """FeatureStore's class switch set to ``on`` for the block."""
    prev = FeatureStore.use_native_gather
    FeatureStore.use_native_gather = on
    try:
        yield
    finally:
        FeatureStore.use_native_gather = prev


def gather_batch(store, b, rng):
    """b random videos of ``store`` and 5 frame indices of each."""
    vids = rng.integers(0, store.num_videos, b)
    return vids, np.stack([rng.integers(0, n, FLAGSHIP.train_segments)
                           for n in store.num_frames(vids)])


def check_native_gather(stores):
    """(a) FeatureStore.gather through the native library bitwise the
    numpy fancy index over every video of the three published-size
    stores, as float32, float16 and int8 stores, in batches of 128 with
    random frames.  Returns the int8 val store (for the conversion)."""
    rng = np.random.default_rng(11)
    int8_val = None
    for name, store in zip(("source", "target", "val"), stores):
        variants = {"float32": store,
                    "float16": FeatureStore(store.features.astype(np.float16),
                                            store.offsets, store.paths,
                                            store.labels),
                    "int8": store.quantize()}
        for kind, variant in variants.items():
            for start in range(0, variant.num_videos, 128):
                vids = np.arange(start, min(start + 128, variant.num_videos))
                frames = np.stack([rng.integers(0, n, FLAGSHIP.train_segments)
                                   for n in variant.num_frames(vids)])
                with native_gather_on(True):
                    got = variant.gather(vids, frames)
                with native_gather_on(False):
                    want = variant.gather(vids, frames)
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    raise AssertionError(f"native gather of the {kind} {name}"
                                         f" store differs at videos {start}+")
            log(f"  {name} ({variant.num_videos} videos), {kind}: every "
                "video's batch bitwise the fancy index")
        int8_val = variants["int8"]
    return int8_val


def time_native_gather(gen, stores):
    """(a, timing) The gather per batch, native against the fancy index,
    at 128 x 5 (source) and 74 x 5 (target) from float32 stores and at
    128 x 5 from the int8 source store, GATHER_RUNS in turns, beside the
    fancy index's rows taken into one reused output (what a fresh
    output's first touch costs); then the
    host-feature train step (128 + 74, dropout 0.5) with each, in turns
    (numpy, native, native, numpy), NATIVE_STEPS steps a turn.  Returns
    the medians (ms)."""
    rng = np.random.default_rng(12)
    cases = {f"{b}x5 float32": (stores[i], b)
             for i, b in enumerate(GATHER_BATCHES)}
    cases["128x5 int8"] = (stores[0].quantize(), GATHER_BATCHES[0])
    result = {}
    for label, (store, b) in cases.items():
        # FeatureStore.gather with the switch on and off; the library
        # alone on 8 threads (its rows only) beside its default of one;
        # the fancy index's rows into a reused output
        reused = np.empty((b, FLAGSHIP.train_segments)
                          + store.features.shape[1:], store.features.dtype)
        runs = {"native_ms": lambda v, f: store.gather(v, f),
                "numpy_ms": lambda v, f: store.gather(v, f),
                "native_8threads_rows_ms": lambda v, f: native_gather
                .native_gather(store.features, store.offsets, v, f, 8),
                # (mode "clip": with "raise" numpy takes into a buffer
                # of its own first)
                "numpy_rows_into_reused_ms": lambda v, f: np.take(
                    store.features, store.offsets[v][:, None] + f, axis=0,
                    out=reused, mode="clip")}
        times = {name: [] for name in runs}
        for r in range(GATHER_RUNS + 2):
            vids, frames = gather_batch(store, b, rng)
            names = list(runs) if r % 2 else list(runs)[::-1]
            for name in names:
                with native_gather_on(name != "numpy_ms"):
                    t0 = time.perf_counter()
                    runs[name](vids, frames)
                    if r >= 2:  # two warm-up turns
                        times[name].append((time.perf_counter() - t0) * 1e3)
        result[label] = {name: statistics.median(t)
                         for name, t in times.items()}
        log(f"  gather {label}: native {result[label]['native_ms']:.4f} ms, "
            f"fancy index {result[label]['numpy_ms']:.4f} ms, the library's "
            f"rows on 8 threads "
            f"{result[label]['native_8threads_rows_ms']:.4f} ms, the fancy "
            f"index's rows into a reused output "
            f"{result[label]['numpy_rows_into_reused_ms']:.4f} ms (median of "
            f"{GATHER_RUNS} in turns)")
    model = flagship_model(gen, dropout=0.5)
    state = TrainState(model, make_optimizer(model.parameters(), TRAIN), 0)
    step = make_train_step(model, DA, TRAIN)
    feat_s, feat_t = store_loaders(stores, seed=7)
    batches = zip(endless(feat_s.epoch), endless(feat_t.epoch))
    rng_dev = torch.Generator("cuda").manual_seed(0)

    def run(on, n):
        nonlocal state
        with native_gather_on(on):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                bs, bt = next(batches)
                state, metrics = step(state, *bs, *bt,
                                      scalars(state.step, 100, TRAIN.beta),
                                      rng_dev)
            torch.cuda.synchronize()
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError("host-feature step loss is not finite")
        return (time.perf_counter() - t0) * 1e3 / n

    run(True, 3)
    steps = {True: [], False: []}
    for on in (False, True, True, False):
        steps[on].append(run(on, NATIVE_STEPS))
    result["host-feature step"] = {
        "native_ms": statistics.median(steps[True]),
        "numpy_ms": statistics.median(steps[False])}
    log(f"  host-feature step (128 + 74 videos, its loader): native "
        f"{result['host-feature step']['native_ms']:.3f} ms, fancy index "
        f"{result['host-feature step']['numpy_ms']:.3f} ms per step "
        f"(median of 2 turns of {NATIVE_STEPS})")
    return result


def write_t7_tree(workdir, store):
    """``store`` as the original's layout, one .t7 per frame
    (``<video>/img_%05d.t7``), and its list file; returns the list's
    path."""
    lines = []
    for v, (path, label) in enumerate(zip(store.paths, store.labels)):
        vdir = os.path.join(workdir, f"video_{v:04d}")
        os.makedirs(vdir)
        rows = store.features[store.offsets[v]:store.offsets[v + 1]]
        for i, row in enumerate(rows, 1):
            torch.save(torch.from_numpy(np.array(row)),
                       os.path.join(vdir, f"img_{i:05d}.t7"))
        lines.append(f"{vdir} {len(rows)} {label}\n")
    list_file = os.path.join(workdir, "list.txt")
    with open(list_file, "w") as f:
        f.writelines(lines)
    return list_file


def conversion_check(root, workdir, val, int8_val):
    """(b) The val split written as .t7 files, converted by
    cli.convert_features at float32 and int8: the stores bitwise the
    source rows and FeatureStore.quantize's codes and scales; the eval
    CLI on the converted float32 store prints the original store's Pred@k
    line.  Returns the eval CLIs' launches."""
    t0 = time.perf_counter()
    list_file = write_t7_tree(os.path.join(workdir, "t7"), val)
    n_files = int(val.offsets[-1])
    log(f"  wrote {n_files} .t7 files of {val.num_videos} videos in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for dtype in ("float32", "int8"):
        out[dtype] = os.path.join(workdir, f"store_{dtype}")
        t0 = time.perf_counter()
        _, printed = run_cli(cli_convert_features.main,
                             [list_file, out[dtype], "--dtype", dtype])
        seconds = time.perf_counter() - t0
        got = FeatureStore.load(out[dtype])
        want = val if dtype == "float32" else int8_val
        same = (np.array_equal(got.offsets, want.offsets)
                and got.features.dtype == want.features.dtype
                and np.array_equal(got.features, want.features)
                and list(got.labels) == list(want.labels))
        if dtype == "int8":
            same = same and np.array_equal(got.scales, want.scales)
        log(f"  {printed.strip()} in {seconds:.1f} s; bitwise the "
            f"{'source rows' if dtype == 'float32' else 'quantized rows'}: "
            f"{same}")
        if not same:
            raise AssertionError(f"the converted {dtype} store differs")
    weights = os.path.join(root, "exp", "RGB", "model_best.pth.tar")
    nb = -(-val.num_videos // CLI_BATCH)
    lines, launches = {}, dict.fromkeys(counts(), 0)
    for label, argv in (
            ("original store", eval_cli_args(root, weights)),
            ("converted store", [
                os.path.join(root, "class.txt"), "RGB", list_file, weights,
                *MODEL_FLAGS, "--test_segments", "5", "--bS", str(CLI_BATCH),
                "--top", "1", "3", "5", "--store", out["float32"]])):
        reset_counts()
        lines[label], _ = run_cli(cli_test_models.main, argv)
        launched = counts()
        if launched != {"trn_fused_fwd": nb, "trn_fused_fwd_train": 0,
                        "trn_fused_bwd": 0, "gather_gemm": 0}:
            raise AssertionError(f"eval CLI ({label}) launched {launched}")
        launches = {k: launches[k] + n for k, n in launched.items()}
        log(f"  eval CLI on the {label}: {lines[label].strip()}")
    if lines["original store"] != lines["converted store"]:
        raise AssertionError(f"the eval CLI's lines differ: {lines}")
    return launches


def profile_dir_check(root, workdir):
    """(c) The train CLI for one epoch from the stores with --profile_dir,
    single-step (a window of steps 2-7) and with --steps_per_call 4 (the
    second call, 4 steps): one Chrome trace each, holding device events
    of K1 (train), K2 and K3, and no more than the window's launches (per
    step 1, 1 and 2: a wider window would hold more; CUPTI may drop the
    first kernels after the trace starts, so fewer are logged, not
    failed); the trace's top device kernels logged.  Returns the runs'
    launches."""
    launches = dict.fromkeys(counts(), 0)
    for label, extra, steps in (("single-step", [], 6),
                                ("--steps_per_call 4",
                                 ["--steps_per_call", "4"], 4)):
        prof_dir = os.path.join(workdir, "prof_" + str(steps))
        exp = os.path.join(workdir, "exp_prof_" + str(steps))
        argv = [os.path.join(root, "class.txt"), "RGB",
                *[os.path.join(root, n, "list.txt")
                  for n in ("src", "tgt", "val")], *MODEL_FLAGS,
                *RECIPE_FLAGS, "--exp_path", exp + "/", "--save_best_log",
                os.path.join(exp, "best.log"), "--epochs", "1",
                "--device_store", "--profile_dir", prof_dir, *extra]
        with trainer_records() as records:
            run_cli(cli_train.main, argv)
        for rec in records:
            check_trainer_launches(rec)
            launches = {k: launches[k] + n
                        for k, n in rec["launches"].items()}
        traces = [f for f in os.listdir(prof_dir)
                  if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"{label}: traces {traces}")
        with open(os.path.join(prof_dir, traces[0])) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel"]
        by_kernel = {}
        for e in events:
            total, n = by_kernel.get(e["name"], (0.0, 0))
            by_kernel[e["name"]] = (total + e.get("dur", 0.0), n + 1)
        found = {k: sum(n for name, (_, n) in by_kernel.items() if k in name)
                 for k in ("trn_fused_fwd_kernel", "trn_fused_bwd_kernel",
                           "gather_gemm_kernel")}
        want = {"trn_fused_fwd_kernel": steps, "trn_fused_bwd_kernel": steps,
                "gather_gemm_kernel": 2 * steps}
        size = os.path.getsize(os.path.join(prof_dir, traces[0]))
        log(f"  {label}: {traces[0]} ({size / 1e6:.1f} MB), {len(events)} "
            f"device kernels in the window; K1 (train), K2, K3: {found} "
            f"(the window launched {want}; all in the trace: "
            f"{found == want})")
        for name, (total, n) in sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1][0])[:6]:
            log(f"    {total / 1e3:8.4f} ms {n:4d}x  {name[:90]}")
        if any(not 1 <= found[k] <= want[k] for k in want):
            raise AssertionError(f"{label}: the trace holds {found}")
    return launches


def tensorboard_check(root, workdir):
    """(d) The train CLI for one epoch from the stores with --tensorboard
    through a recording tensorboardX, and without it, dropout 0: the JAX
    Trainer's tags in order, the embeddings [n, feature] with n the
    epoch's real videos (val: 360), and the same best Prec@1.  Returns
    the runs' launches."""
    stub = os.path.join(workdir, "stub")
    os.makedirs(os.path.join(stub, "tensorboardX"))
    with open(os.path.join(stub, "tensorboardX", "__init__.py"), "w") as f:
        f.write(STUB_TENSORBOARDX)
    saved = sys.modules.pop("tensorboardX", None)
    sys.path.insert(0, stub)
    launches = dict.fromkeys(counts(), 0)
    best = {}
    try:
        for label, extra in (("plain", []), ("--tensorboard",
                                             ["--tensorboard"])):
            exp = os.path.join(workdir, "exp_tb_" + label.strip("-"))
            argv = [os.path.join(root, "class.txt"), "RGB",
                    *[os.path.join(root, n, "list.txt")
                      for n in ("src", "tgt", "val")], *MODEL_FLAGS,
                    *RECIPE_FLAGS, "--exp_path", exp + "/",
                    "--save_best_log", os.path.join(exp, "best.log"),
                    "--epochs", "1", "--device_store", "--dropout_i", "0",
                    "--dropout_v", "0", *extra]
            with trainer_records() as records:
                best[label], _ = run_cli(cli_train.main, argv)
            for rec in records:
                check_trainer_launches(rec)
                launches = {k: launches[k] + n
                            for k, n in rec["launches"].items()}
        import tensorboardX
        calls = tensorboardX.CALLS
    finally:
        sys.path.remove(stub)
        sys.modules.pop("tensorboardX", None)
        if saved is not None:
            sys.modules["tensorboardX"] = saved
    # the real videos of the epoch's zip-shortest steps, in each stream
    steps = [r["steps"] for r in records if r["kind"] == "train"][0]
    n_src, n_tgt, n_val = (
        len(open(os.path.join(root, n, "list.txt")).readlines())
        for n in ("src", "tgt", "val"))
    want = {"train_source": min(n_src, steps * TRAIN.batch_size[0]),
            "train_target": min(n_tgt, steps * TRAIN.batch_size[1]),
            "validation": n_val}
    want["train_DA"] = want["train_source"] + want["train_target"]
    tags = [c[1] for c in calls if c[0] in ("embedding", "text")]
    rows = {c[1]: c[2] for c in calls if c[0] == "embedding"}
    log(f"  tensorboardX calls: {[c[:3] for c in calls]}")
    dims = {shape[1] for shape in rows.values() if len(shape) == 2}
    if tags != list(TB_TAGS) or len(dims) != 1 or \
            any(len(shape) != 2 for shape in rows.values()) or \
            any(rows[tag][0] != n for tag, n in want.items()) or \
            calls[-1] != ("close",):
        raise AssertionError(f"tensorboard wrote {calls}, want rows {want}")
    log(f"  tags {tags}, rows {want}; best Prec@1 "
        f"{best['--tensorboard']:.3f} with --tensorboard, "
        f"{best['plain']:.3f} without: equal "
        f"{best['--tensorboard'] == best['plain']}")
    if best["--tensorboard"] != best["plain"]:
        raise AssertionError(f"Prec@1 differs: {best}")
    return launches


def entry_points_check():
    """(e) Every module `python -m ta3n_tpu_torch` lists imports here
    (a machine without jax) and has a main()."""
    from ta3n_tpu_torch.__main__ import ENTRY_POINTS
    for module, _ in ENTRY_POINTS:
        if not callable(importlib.import_module(module).main):
            raise AssertionError(f"{module} has no main()")
    log(f"  {len(ENTRY_POINTS)} entry points import: "
        + ", ".join(m for m, _ in ENTRY_POINTS))


def train_extras_phase(gen, stores, root):
    """The last single-card modules: (a) the native host gather against
    the fancy index, bitwise and timed, with the host-feature step; (b)
    .t7 conversion and the eval CLI on the converted store; (c)
    --profile_dir traces; (d) --tensorboard; (e) the entry points.
    Returns the launches of their CLI runs."""
    log(f"  the native gather's library: "
        f"{native_gather._lib_path().name}")
    int8_val = check_native_gather(stores)
    times = time_native_gather(gen, stores)
    log(f"native gather against numpy's fancy index (ms; {card_line()}): "
        f"{json.dumps(times)}")
    launches = dict.fromkeys(counts(), 0)
    with tempfile.TemporaryDirectory() as workdir:
        for what, check in (
                (".t7 conversion at float32 and int8, and the eval CLI on "
                 "the converted store", lambda: conversion_check(
                     root, workdir, stores[2], int8_val)),
                ("--profile_dir: one epoch single-step and with "
                 "--steps_per_call 4", lambda: profile_dir_check(root,
                                                                 workdir)),
                ("--tensorboard through a recording tensorboardX",
                 lambda: tensorboard_check(root, workdir))):
            log(what)
            got = check()
            launches = {k: launches[k] + got[k] for k in launches}
    log("entry points of python -m ta3n_tpu_torch")
    entry_points_check()
    return launches


def serving_extras(root) -> dict:
    """The int8, export, pipelined and extraction phases, in a scratch
    directory of their own; their times, and the K1 launches of their
    float32 live paths (``k1``)."""
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        log(f"int8 inference: the int8 flagship served over HTTP at batch "
            f"{SERVE_BATCH} and in process at batch 1, a 2-member int8 "
            "from_sweep and the int8 eval CLI")
        weights, int8_t = int8_phase(workdir, root)
        log(f"AOT artifacts: cli.serve --export, float32 and int8, served "
            f"from Predictor.from_exported on the card")
        k1, export_t = export_phase(workdir, root, weights)
        log(f"the pipelined Predictor: {PIPELINE_VIDEOS} videos against "
            "the chunks fetched one by one")
        k1_pipe, pipe_t = pipelined_phase()
        log("feature extraction: resnet101 and C3D (both activations) on "
            "the card, shards and --finalize")
        rates = extract_phase(workdir)
        log(f"serving extras and extraction: {time.perf_counter() - t0:.1f}"
            " s")
    times = {"int8": int8_t, "export": export_t, "pipelined": pipe_t,
             "extract": rates}
    log("serving extras' times (ms; extraction frames/s or clips/s; "
        f"{card_line()}): {json.dumps(times)}")
    return {"k1": k1 + k1_pipe, **times}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's TF32 flag stays at its default (True), as the CLIs' users
    # run it: the TCL and the RNN pin float32 themselves (cudnn_f32)
    kind = torch.cuda.get_device_name(0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    log("build: nvcc for sm_90a")
    log(f"  built {_build.library_path().name} in "
        f"{build_kernels():.1f} s")
    check_sass()

    gen = torch.Generator().manual_seed(0)
    log("K1 (infer) vs plain")
    max_err = {"trn_fused_fwd": check_trn_kernel(gen)}
    log("K1 (train) and K2 vs plain")
    worst = check_train_kernels(gen)
    max_err["trn_fused_fwd_train"] = worst["fwd"]
    max_err["trn_fused_bwd"] = worst["bwd"]

    log("feature stores of the published split sizes, uploaded once")
    t0 = time.perf_counter()
    stores = make_domain_pair(**SPLITS, num_class=FLAGSHIP.num_class,
                              feature_dim=FLAGSHIP.input_feature_dim)
    dev = [store.to_device() for store in stores]
    torch.cuda.synchronize()
    log("  " + ", ".join(
        f"{name} {store.num_videos} videos, {t.shape[0]} rows, "
        f"{t.numel() * 4 / 1e9:.3f} GB" for name, store, t in
        zip(("source", "target", "val"), stores, dev))
        + f" (made and uploaded in {time.perf_counter() - t0:.1f} s)")
    log("K3 vs plain")
    max_err["gather_gemm"] = check_gather_kernel(dev[0])
    log("K1 (infer), K1 (train) and K2 in bfloat16 vs plain in bfloat16")
    max_err.update(check_bf16_trn(gen))
    log("K3's store x compute variants vs plain (source store as float32, "
        "bfloat16 and int8)")
    variants = narrow_stores(dev[0], stores[0])
    max_err.update({f"gather_gemm_{k}": v for k, v in
                    check_gather_variants(variants).items()})

    log("kernel times")
    times = time_trn(gen)
    log("  K1's D slices (ops/trn_fused.py::_fwd_splits): " + ", ".join(
        f"B={b} {trn_fused._fwd_splits(5, 3, b, 512, 256)}"
        for b in TIMED_BATCHES))
    fwd_t, bwd_t = time_train_kernels(gen)
    bwd_split = split_bwd(gen)
    gather_t = time_gather(dev[0])
    t64 = times[SERVE_BATCH]
    k3_t, k3_work = gather_t[K3_TIMED[0][0]]
    k3_eval_t, k3_eval_work = gather_t[K3_TIMED[1][0]]
    ms = {"trn_fused_fwd": (t64[("kernel", "device")],
                            t64[("plain", "device")], None),
          "trn_fused_fwd_train": (fwd_t["kernel"], fwd_t["plain"], None),
          "trn_fused_bwd": (bwd_t["kernel"], bwd_t["plain"], None),
          "gather_gemm": (k3_t["kernel"], k3_t["plain"], k3_t["library"])}

    log("bfloat16 and narrow-store kernel times")
    bf16_ms, bf16_k1, bf16_eval, bf16_more = time_bf16_kernels(gen,
                                                               variants)
    del variants

    # each path's launches, counted from 0 over its own run, summed per
    # kernel over the paths that launch it (the bfloat16 and narrow-store
    # variants apart)
    launches = dict.fromkeys(counts(), 0)
    launches16 = dict.fromkeys(bf16_counts(), 0)

    def add(path_launches):
        for name, n in path_launches.items():
            launches[name] += n

    def add16(path_launches):
        for name, n in path_launches.items():
            launches16[name] += n

    log("flagship serving over HTTP")
    with tempfile.TemporaryDirectory() as workdir:
        add({"trn_fused_fwd": serve_flagship(gen, workdir)})
    log("bfloat16 flagship served by a Predictor at batch 64 and 1")
    add16(serve_bf16(gen))

    log(f"flagship train step, {TRAIN.batch_size[0]} + "
        f"{TRAIN.batch_size[1]} videos: kernel TRN vs plain TRN")
    add(train_flagship(gen))
    log("flagship train step timing (dropout 0.5)")
    time_train_step(gen)

    log(f"device-store train step, {TRAIN.batch_size[0]} + "
        f"{TRAIN.batch_size[1]} videos: against the host-feature step")
    add(train_device_store(gen, stores, dev))
    log("device-store against host-feature train step timing (dropout 0.5)")
    time_store_steps(gen, stores, dev)

    log("device-store eval: one val epoch")
    add(eval_device_store(gen, stores[2], dev[2]))
    log(f"bfloat16 flagship, device-store train steps from an int8 and a "
        f"bfloat16 store, {TRAIN.batch_size[0]} + {TRAIN.batch_size[1]} "
        "videos: against the plain path")
    add16(train_bf16_store(gen, stores))

    log(f"the TRN beyond 16 segments: S = {MANY_FRAMES}")
    many_launches, many = trn_many_frames(gen)
    add(many_launches)
    t_chunked = time.perf_counter()
    log(f"K = {CHUNK_K} steps per call, {TRAIN.batch_size[0]} + "
        f"{TRAIN.batch_size[1]} videos: against {CHUNK_K} single steps, "
        f"and timed at K = 1 and {CHUNK_K} ({card_line()})")
    add(multi_step_phase(gen, stores, dev))
    log("the device sampler: val batches, random batches on the card and "
        f"the CPU, a sampled call of K = {CHUNK_K}")
    add(sampler_phase(gen, stores, dev))
    log(f"shard streaming: one epoch in shards, K = {CHUNK_K}, against the "
        "resident stores")
    add(streaming_phase(gen, stores, dev))
    t_chunked = time.perf_counter() - t_chunked
    with tempfile.TemporaryDirectory() as root:
        write_workspace(root, stores)
        log(f"eval CLI: {len(stores[2].paths)} videos at --bS {CLI_BATCH}")
        add(eval_cli(gen, root, stores[2]))
        extras = serving_extras(root)
        add({"trn_fused_fwd": extras.pop("k1")})
        log("Trainer through the train CLI: the published recipe on "
            "stores of the published split sizes")
        add(train_cli(root))
        t0 = time.perf_counter()
        log("the chunked modes through the train CLI: one epoch each")
        got, ckpt = chunked_cli(root)
        add(got)
        log("the eval CLI from a streamed store against the resident one")
        add(streamed_eval_cli(root, ckpt))
        t_chunked += time.perf_counter() - t0
        log(f"the chunked modes: {t_chunked:.1f} s in all ({card_line()})")
        log("comparison configurations: " + ", ".join(COMPARISON) + " at "
            f"{TRAIN.batch_size[0]} + {TRAIN.batch_size[1]} videos; "
            + " and ".join(COMPARISON_CLI) + " through the CLIs")
        t0 = time.perf_counter()
        add(comparison_phase(gen, stores, dev, root))
        log(f"comparison configurations: {time.perf_counter() - t0:.1f} s")
        log("the bfloat16 flagship through the train CLI from int8 stores "
            "with Adam, the eval CLI on its best checkpoint, and an "
            "--accum_steps 2 epoch from host features")
        t0 = time.perf_counter()
        got16, got32 = train_cli_bf16(root)
        add16(got16)
        add(got32)
        log("the eval CLI from narrow stores and in mixed dtypes")
        got16, got32 = eval_cli_narrow(root, os.path.join(
            root, "exp_bf16", "RGB", "model_best.pth.tar"))
        add16(got16)
        add(got32)
        log(f"bfloat16 and accumulation CLIs: {time.perf_counter() - t0:.1f}"
            " s")
        t0 = time.perf_counter()
        log("ensembles: member-batched kernels, the flagship ensemble's "
            "steps, eval, serving and the sweep CLI")
        member_launches, member_errs, member_t, ens_t = ensemble_phase(
            gen, stores, dev, root)
        log(f"ensembles: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log("bfloat16 ensembles: the bfloat16 member-batched kernels, the "
            "bfloat16 flagship ensemble's steps from int8 stores, eval, "
            "serving and the sweep CLI")
        got = ensemble_phase(gen, stores, dev, root, bf16=True)
        for mine, theirs in zip((member_launches, member_errs, member_t),
                                got):
            mine.update(theirs)
        ens16_t = got[3]
        log(f"bfloat16 ensembles: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log("the last single-card modules: the native host gather, .t7 "
            "conversion, --profile_dir, --tensorboard and the entry points")
        add(train_extras_phase(gen, stores, root))
        log(f"the last single-card modules: {time.perf_counter() - t0:.1f} s")
        log(card_line())

    # the shapes each kernel runs at on its path: serving batch, train batch
    work = {**{k: v for k, v in trn_work(SERVE_BATCH).items()
               if k == "trn_fused_fwd"},
            **{k: v for k, v in trn_work(sum(TRAIN.batch_size[:2])).items()
               if k != "trn_fused_fwd"},
            "gather_gemm": k3_work}
    sources = {
        "trn_fused_fwd": ("ta3n_tpu_torch/csrc/trn_fused_fwd.cu",
                          "ta3n_tpu/ops/trn_fused.py:68"),
        "trn_fused_fwd_train": ("ta3n_tpu_torch/csrc/trn_fused_fwd.cu",
                                "ta3n_tpu/ops/trn_fused.py:68"),
        "trn_fused_bwd": ("ta3n_tpu_torch/csrc/trn_fused_bwd.cu",
                          "ta3n_tpu/ops/trn_fused.py:187"),
        "gather_gemm": ("ta3n_tpu_torch/csrc/gather_gemm.cu",
                        "ta3n_tpu/ops/gather_gemm.py:70"),
    }
    log(f"launches on the paths: {launches}")
    kernels = []
    for name, (source, replaces) in sources.items():
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on its path")
        bound_ms, bound_by = bound(*work[name], PEAK_OPS[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # the TRN kernels: no single PyTorch call computes a
            # multi-scale TRN over a subset plan, forward or backward.
            # K3: index_select + mm, two calls (no single call gathers
            # and multiplies)
            "library_ms": ms[name][2]})
    # K1 (infer) at batch 1 and at the train batch too; K2's two families
    # by the profiler, each alone and in one grid; K3 at the eval shape
    # (320 rows, no x_res) as well
    for b in TIMED_BATCHES:
        if b != SERVE_BATCH:
            kernels[0].update({
                f"b{b}_ms": times[b][("kernel", "device")],
                f"b{b}_plain_ms": times[b][("plain", "device")],
                f"b{b}_bound_ms": bound(*trn_work(b)["trn_fused_fwd"],
                                        PEAK_OPS["trn_fused_fwd"])[0]})
    kernels[2].update(dx_ms=bwd_split["dx"], dw_ms=bwd_split["dW"],
                      both_ms=bwd_split["both"])
    # K1 and K2 at S = 17 and 25 (K1 (infer) at B=64, the others at 202)
    for kernel in kernels[:3]:
        for s, t in many.items():
            kernel.update({f"s{s}_ms": t[kernel["name"]][0],
                           f"s{s}_plain_ms": t[kernel["name"]][1],
                           f"s{s}_bound_ms": t[kernel["name"]][2]})
    kernels[3].update(
        eval_ms=k3_eval_t["kernel"], eval_plain_ms=k3_eval_t["plain"],
        eval_library_ms=k3_eval_t["library"],
        eval_bound_ms=bound(*k3_eval_work, PEAK_OPS["gather_gemm"])[0])
    # the bfloat16 and narrow-store variants: the bfloat16 ones bound by
    # the dense bfloat16 rate, K3 from a narrow store at float32 compute by
    # 3xTF32's
    log(f"launches of the bfloat16 and narrow-store variants on the paths: "
        f"{launches16}")
    for name, (ms_k, ms_p, ms_lib, work_k) in bf16_ms.items():
        if launches16[name] < 1:
            raise AssertionError(f"{name} was not launched on its path")
        peak = (PEAK_BF16 if name.startswith("trn") or name.endswith("bf16")
                else PEAK_TF32 / 3)
        bound_ms, bound_by = bound(*work_k, peak)
        # at bfloat16 compute K2 and K3 are the wgmma kernels' own sources
        source, replaces = (sources["gather_gemm"] if name.startswith(
            "gather") else sources[name.removesuffix("_bf16")])
        if name in WGMMA_SOURCES:
            source = WGMMA_SOURCES[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches16[name],
                 "max_abs_err": max_err[name], "ms": ms_k,
                 "plain_ms": ms_p, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": ms_lib}
        if name in bf16_eval:
            ev_k, ev_p, ev_lib, ev_work = bf16_eval[name]
            entry.update(eval_ms=ev_k, eval_plain_ms=ev_p,
                         eval_library_ms=ev_lib,
                         eval_bound_ms=bound(*ev_work, peak)[0])
        for key, (k_ms, p_ms, lib_ms, k_work) in bf16_more.get(
                name, {}).items():
            entry.update({f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
                          f"{key}_bound_ms": bound(*k_work, peak)[0]})
            if lib_ms is not None:
                entry[f"{key}_library_ms"] = lib_ms
        if name == "trn_fused_fwd_bf16":
            for b in TIMED_BATCHES:
                if b != SERVE_BATCH:
                    entry.update({
                        f"b{b}_ms": bf16_k1[b]["kernel"],
                        f"b{b}_plain_ms": bf16_k1[b]["plain"],
                        f"b{b}_bound_ms": bound(*trn_work(b, esize=2)[
                            "trn_fused_fwd"], peak)[0]})
        kernels.append(entry)
    # the member-batched kernels (the member grid axis of the float32 and
    # the bfloat16 kernels): their launches on the ensemble paths, times at
    # N = 4 members with N = 1 and 8 beside, each against N solo launches
    for name, base in MEMBER_KERNELS.items():
        n_launch = member_launches[base]
        if n_launch < 1:
            raise AssertionError(f"{name} was not launched on its path")
        by_n = member_t[name]
        t4, work4 = by_n[4]
        peak = PEAK_BF16 if base.endswith("bf16") else PEAK_OPS[base]
        bound_ms, bound_by = bound(*work4, peak)
        source, replaces = sources[base.removesuffix("_bf16")]
        entry = {"name": name, "route": "cuda",
                 "source": WGMMA_SOURCES.get(base, source),
                 "replaces": replaces, "launches": n_launch,
                 "max_abs_err": member_errs[name], "ms": t4["kernel"],
                 "plain_ms": t4["plain"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": t4.get("library"),
                 "members": 4, "solo_ms": t4["solo"]}
        for n in MEMBER_TIMED:
            if n != 4:
                t, work = by_n[n]
                entry.update({f"n{n}_ms": t["kernel"],
                              f"n{n}_solo_ms": t["solo"],
                              f"n{n}_plain_ms": t["plain"],
                              f"n{n}_bound_ms": bound(*work, peak)[0]})
                if "library" in t:
                    entry[f"n{n}_library_ms"] = t["library"]
        kernels.append(entry)
    log(f"ensemble step of {len(ENSEMBLE_SEEDS)} members: "
        f"{ens_t['ensemble'][0]:.3f} ms (busy {ens_t['ensemble'][1]:.3f}, "
        f"idle {100 * ens_t['ensemble'][2]:.1f}%); {len(ENSEMBLE_SEEDS)} "
        f"solo steps: {ens_t['solo'][0]:.3f} ms (busy "
        f"{ens_t['solo'][1]:.3f}, idle {100 * ens_t['solo'][2]:.1f}%); in "
        f"bfloat16 from int8 stores {ens16_t['ensemble'][0]:.3f} ms (busy "
        f"{ens16_t['ensemble'][1]:.3f}, idle "
        f"{100 * ens16_t['ensemble'][2]:.1f}%) against "
        f"{ens16_t['solo'][0]:.3f} ms (busy {ens16_t['solo'][1]:.3f}, idle "
        f"{100 * ens16_t['solo'][2]:.1f}%)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
