"""The training driver: epoch loop, validation, checkpointing, logging.

Port of `ta3n_tpu/train/loop.py` (reference main.py:33-306 ``main()``,
``train()`` and ``validate()``) for one card: one optimizer step per call
of the train step (`train/step.py`), fed from the host loaders or, with
``device_store``, by index batches into feature stores uploaded once
(``FeatureStore.to_device``, ``TSNLoader.index_epoch``) as float32,
bfloat16 or int8 (``store_dtype``).  With ``pretrain_source`` a
classification-only step runs on every batch before the train step
(main.py:387-414).  With ``accum_steps`` G > 1 every G host-feature
batch pairs make one update with averaged gradients
(``_train_epoch_accum``), under the JAX Trainer's conditions.

The JAX Trainer's chunked modes, under its conditions and with its
warnings: ``steps_per_call`` K > 1 runs K device-store steps per call
(``make_multi_train_step``, ``_train_epoch_multi``); ``store_budget_rows``
streams each store to the card in shards of at most that many rows
(`data/streaming.py`), the epoch's batches shard-local; ``device_sampler``
with K > 1 makes the index batches on the device (`data/device_sampler.py`,
``make_sampled_multi_step``, ``make_sampled_shard_multi_step``).  All of
them take their schedule values from ``_chunk_scalars``.

Per-step Python work is schedule arithmetic and meter updates; metrics
stay on the device until the print-frequency flush, which fetches them in
one copy.  ``tensorboard_dir`` writes the JAX Trainer's embeddings and
best-accuracy text (`io_utils/tensorboard.py`; per-step video-level
features, so one step per call and a per-batch validation), and
``profile_dir`` a ``torch.profiler`` trace of the JAX Trainer's window:
steps 2–7 of the first epoch, or the second K-step call of the run.

Over several cards (``num_devices``, ``use_mesh``, as the JAX Trainer's):
the process belongs to a ``torch.distributed`` group of one process a
card (`parallel/distributed.py`; the train CLI starts it), the loaders'
batches are padded to a multiple of the ranks with masked videos, and
every step takes the global batch and computes its own rows of it
(`parallel/mesh.py`), so every rank holds the same parameters and the
same metrics.  Rank 0 alone prints and writes the logs, checkpoints, the
``--tensorboard`` files and the ``--profile_dir`` trace; every rank
restores the same checkpoint on resume.  A SIGTERM on any rank stops
every rank at the next metric flush (the ranks agree on it there), with
rank 0's emergency checkpoint; a rank whose peer has left fails at the
process group's timeout rather than wait forever.

``model_parallel`` M > 1 (tensor parallelism, as the JAX Trainer's): the
group's W ranks form a (W / M data x M model) grid (`parallel/mesh.py::
make_mesh_2d`), the loaders are padded to a multiple of the data axis,
and the planned Linears are column-sharded over the model axis
(`train/step.py::tp_plan`, `parallel/tensor.py`).  Checkpoints stay
whole: every rank of rank 0's model group gathers its weight slices and
their optimizer state, and rank 0 writes them; a resume cuts them to the
rank's slices, so a checkpoint moves between grids of any M, the 1-D
grid and one card.  Without a group of at least two ranks M is ignored
with a warning, as the JAX Trainer does.
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import (FeatureStore, TSNLoader,
                                 epoch_balance_counts, parse_list_file)
from ta3n_tpu_torch.data.device_sampler import (DeviceSampler,
                                                StreamingDeviceSampler,
                                                plan_zip_shard_chunks)
from ta3n_tpu_torch.data.streaming import ShardPlan, ShardStream
from ta3n_tpu_torch.io_utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from ta3n_tpu_torch.io_utils.convert import (export_reference_state,
                                             live_state)
from ta3n_tpu_torch.io_utils.logs import AverageMeter, LogFiles
from ta3n_tpu_torch.io_utils.tensorboard import EmbeddingWriter
from ta3n_tpu_torch.parallel.mesh import make_mesh_2d, pad_to_multiple
from ta3n_tpu_torch.parallel.tensor import (slice_optimizer_state,
                                            slice_state_dict,
                                            whole_model,
                                            whole_optimizer_state)
from ta3n_tpu_torch.train.schedules import (alpha_schedule, dann_lr,
                                            effective_beta, loss_plateau_lr,
                                            progress, step_decay_lr)
from ta3n_tpu_torch.train.step import (StepScalars, TrainState,
                                       create_train_state, make_eval_step,
                                       make_grad_accum_step,
                                       make_multi_eval_step,
                                       make_multi_train_step,
                                       make_sampled_multi_step,
                                       make_sampled_shard_multi_step,
                                       make_train_step)

__all__ = ["Trainer", "TrainingDivergedError", "build_loaders",
           "class_weights_from_list"]

_METRICS = ("loss", "loss_c", "loss_d", "loss_a", "loss_e", "loss_s",
            "top1", "top5", "n")


class TrainingDivergedError(RuntimeError):
    """Raised by the Trainer's nan_guard when a training loss is
    non-finite at the metric flush (a host sync the loop makes anyway);
    fit() writes an emergency checkpoint before the exception propagates.
    The reference trains on through NaN (main.py:569)."""


class _AgreedStop(KeyboardInterrupt):
    """The stop that every rank raises at once, at the metric flush where
    the ranks agree that one was asked to stop (``Trainer._agree_stop``)."""


@contextlib.contextmanager
def _sigterm_as_interrupt(stop: Optional[threading.Event] = None):
    """Deliver SIGTERM as KeyboardInterrupt for the duration of fit(), so
    that a scheduler's kill (or ``timeout``) goes through fit()'s
    emergency checkpoint.  Installed only in the main thread and only when
    SIGTERM has its default disposition; the previous one is restored.
    Over several ranks (``stop`` given) the first SIGTERM sets ``stop``
    instead, which the ranks agree on at their next metric flush; a second
    one raises at once."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.getsignal(signal.SIGTERM)
    if prev is not signal.SIG_DFL:
        yield
        return

    def _raise(signum, frame):
        if stop is not None and not stop.is_set():
            stop.set()
            return
        raise KeyboardInterrupt("SIGTERM (preemption)")

    signal.signal(signal.SIGTERM, _raise)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def class_weights_from_list(list_file: str, num_class: int,
                            enabled: bool) -> Optional[np.ndarray]:
    """Inverse-frequency class weights (main.py:155-164), always with
    ``num_class`` entries; a class absent from the list gets 1.0 (the
    reference misaligns the later weights instead)."""
    if not enabled:
        return None
    with open(list_file) as f:
        labels = [int(line.strip().split(' ')[2]) for line in f
                  if line.strip()]
    counts = np.bincount(np.asarray(labels, np.int64),
                         minlength=num_class).astype(np.float64)
    freq = counts / counts.sum()
    weights = np.ones(num_class, np.float64)
    present = counts > 0
    weights[present] = 1.0 / freq[present]
    return weights.astype(np.float32)


def build_loaders(args, model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Source/target/val loaders with the reference's epoch-balance
    repetition (main.py:144-153,169-200)."""
    def store_for(list_file, flag):
        d = flag if flag else os.path.dirname(os.path.abspath(list_file))
        return FeatureStore.load(d)

    src_records = parse_list_file(args.train_source_list)
    tgt_records = parse_list_file(args.train_target_list)
    val_records = parse_list_file(args.val_list)

    n_src, n_tgt = epoch_balance_counts(
        len(src_records), len(tgt_records), train_cfg.batch_size[0],
        train_cfg.batch_size[1], train_cfg.copy_list)

    new_length = model_cfg.sample_new_length
    src_store = store_for(args.train_source_list, args.store_source)
    tgt_store = store_for(args.train_target_list, args.store_target)
    val_store = store_for(args.val_list, args.store_val)

    # NOTE the reference trains with test-mode (central) segment sampling
    # (main.py:185-196: random_shift=False, test_mode=True).
    source_loader = TSNLoader(src_store, src_records, num_dataload=n_src,
                              batch_size=train_cfg.batch_size[0],
                              num_segments=model_cfg.train_segments,
                              new_length=new_length, mode="test",
                              shuffle=True, seed=1)
    target_loader = TSNLoader(tgt_store, tgt_records, num_dataload=n_tgt,
                              batch_size=train_cfg.batch_size[1],
                              num_segments=model_cfg.train_segments,
                              new_length=new_length, mode="test",
                              shuffle=True, seed=2)
    val_loader = TSNLoader(val_store, val_records,
                           batch_size=train_cfg.batch_size[2],
                           num_segments=model_cfg.val_segments,
                           new_length=new_length, mode="test",
                           shuffle=False, seed=3)
    return source_loader, target_loader, val_loader, n_src, n_tgt


class Trainer:
    """The epoch loop of `ta3n_tpu.train.loop.Trainer`, with its arguments,
    on ``device`` (the card by default; CPU callers pass ``"cpu"``).

    The model's initial weights come from a CPU generator seeded from
    ``seed``, the dropout masks from a generator on ``device`` seeded from
    ``seed`` (those of ``pretrain_source``'s step from one seeded from
    ``seed + 7919``, as the JAX Trainer's key); the device samplers on
    ``seed + 101`` and ``seed + 202``, as the JAX Trainer's.  Checkpoints
    hold the step counter and the generators' states, so a resumed run
    continues the same index and dropout streams; over several ranks every
    rank seeds them alike.  ``num_devices`` and ``use_mesh`` are the JAX
    Trainer's: with ``use_mesh`` and a process group of more than one rank
    (`parallel/distributed.py`) the Trainer trains over every rank of it;
    ``num_devices`` must then be None or the group's size, and above 1
    it needs the group (the train CLI starts one process a card).
    ``model_parallel`` above 1 makes the group a (data x model) grid (see
    the module docstring).  Without the JAX Trainer's ``prefetch_depth``:
    no prefetch thread."""

    def __init__(self, model_cfg: ModelConfig, da_cfg: DAConfig,
                 train_cfg: TrainConfig, source_loader: TSNLoader,
                 target_loader: TSNLoader, val_loader: TSNLoader,
                 path_exp: str = "exp/", class_weights=None,
                 domain_weights=None,
                 log_files: Optional[LogFiles] = None,
                 print_freq: int = 10, show_freq: int = 10,
                 eval_freq: int = 1, save_model: bool = False,
                 save_attention: int = -1, seed: int = 1,
                 tensorboard_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 num_devices: Optional[int] = None,
                 device_store: bool = False,
                 steps_per_call: int = 1,
                 store_budget_rows: Optional[int] = None,
                 store_dtype: Optional[str] = None,
                 device_sampler: bool = False,
                 accum_steps: int = 1,
                 model_parallel: int = 1,
                 nan_guard: bool = True,
                 use_mesh: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; the Trainer "
                               "runs on the card by default (pass "
                               "device='cpu' for the CPU)")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = self._make_mesh(num_devices, use_mesh, model_parallel)
        self.primary = self.mesh is None or self.mesh.is_primary
        if self.mesh is not None:
            # batch divisibility by the ranks via masked padding (the
            # static analogue of main.py:366-372), as the JAX Trainer
            for loader in (source_loader, target_loader, val_loader):
                loader.pad_to = pad_to_multiple(loader.batch_size,
                                                self.mesh.size)
            if not self.primary:
                log_files, profile_dir = None, None
        self._stop = threading.Event() if self.mesh is not None else None
        self.model_cfg, self.da_cfg, self.train_cfg = (model_cfg, da_cfg,
                                                       train_cfg)
        self.source_loader = source_loader
        self.target_loader = target_loader
        self.val_loader = val_loader
        self.path_exp = path_exp
        self.print_freq, self.show_freq = print_freq, show_freq
        self.eval_freq = eval_freq
        self.save_model = save_model
        self.save_attention = save_attention
        self.logs = log_files
        self.profile_dir = profile_dir
        self._profiler = None
        self._profile_chunks_seen = 0
        self._profile_done = False
        self.nan_guard = nan_guard
        # a no-op writer without tensorboardX, as the JAX Trainer's, and on
        # every rank but rank 0
        self.tb = EmbeddingWriter(tensorboard_dir if self.primary else None)
        # whether rank 0 collects for the writer: every rank then takes the
        # modes the collection needs (one step a call, a per-batch
        # validation, no accumulation), so that all run the same steps and
        # collectives
        tb_on = self.tb.active
        if self.mesh is not None:
            flag = torch.tensor([float(tb_on)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            tb_on = flag.item() > 0
        # per-step attention values or video-level features to fetch
        self._need_aux = save_attention >= 0 or tb_on
        self.device_store = device_store
        if store_dtype not in (None, "", "float32", "bfloat16", "int8"):
            raise ValueError(f"store_dtype={store_dtype!r}: the device "
                             "stores are float32, bfloat16 or int8")
        # the dtype of the stores on the device (device_store only): None
        # keeps float32; a store quantized on disk uploads its own pair
        self.store_dtype = store_dtype or None

        self.state = create_train_state(
            model_cfg, train_cfg, torch.Generator().manual_seed(seed),
            self.device)
        if save_model:
            # a model the reference format cannot hold fails here, not at
            # the first save
            export_reference_state(self.state.model)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.pretrain_generator = None
        model = self.state.model
        # K optimizer steps per call: device stores only, and 1 where the
        # steps' attention values or features are collected or with
        # pretrain_source (the JAX Trainer's rule)
        self.steps_per_call = steps_per_call if (
            device_store and not self._need_aux
            and not da_cfg.pretrain_source) else 1
        mesh = self.mesh
        self.train_step = make_train_step(
            model, da_cfg, train_cfg, class_weights, domain_weights,
            gather_on_device=device_store, return_aux=self._need_aux,
            mesh=mesh)
        # the step has cut the planned weights to this rank's slices (a
        # model grid): so is, once, Adam's state made with the optimizer
        slice_optimizer_state(self.state.optimizer)
        # --pretrain_source: a classification-only step before each train
        # step on the same batch (main.py:387-414): two updates a batch,
        # one momentum buffer and lr
        self.pretrain_step = None
        if da_cfg.pretrain_source:
            self.pretrain_step = make_train_step(
                model, da_cfg, train_cfg, class_weights, domain_weights,
                gather_on_device=device_store,
                pretrain_classification_only=True, mesh=mesh)
            self.pretrain_generator = torch.Generator(
                self.device).manual_seed(seed + 7919)
        self.eval_step = make_eval_step(model, class_weights,
                                        gather_on_device=device_store,
                                        mesh=mesh)
        self.multi_step = None
        if self.steps_per_call > 1:
            self.multi_step = make_multi_train_step(
                model, da_cfg, train_cfg, class_weights, domain_weights,
                mesh=mesh)
        self.streaming = bool(device_store and store_budget_rows)
        if self.streaming:
            # larger-than-memory stores: shards of at most budget rows
            # streamed through a double buffer (data/streaming.py); the
            # same gather steps run against the shard on the card
            def plan_stream(loader):
                plan = ShardPlan(loader.store.offsets, store_budget_rows)
                return plan, ShardStream(loader.store.features, plan,
                                         self.device, self.store_dtype,
                                         scales=loader.store.scales)

            self._plan_s, self._stream_s = plan_stream(source_loader)
            self._plan_t, self._stream_t = plan_stream(target_loader)
            self._plan_v, self._stream_v = plan_stream(val_loader)
        elif device_store:
            # stores uploaded once; each step then sends index batches
            uploaded = {}

            def put(store):
                if id(store) not in uploaded:
                    uploaded[id(store)] = store.to_device(self.device,
                                                          self.store_dtype)
                return uploaded[id(store)]

            self._dev_store_s = put(source_loader.store)
            self._dev_store_t = put(target_loader.store)
            self._dev_store_v = put(val_loader.store)

        # the index pipeline on the device (data/device_sampler.py): the
        # K-step call makes its own batches; with K > 1 from device stores
        # only, as in the JAX Trainer
        self.sampled_step = None
        self.shard_sampled_step = None
        if device_sampler and not (device_store and self.steps_per_call > 1):
            unmet = []
            if not device_store:
                unmet.append("--device_store")
            if self.steps_per_call <= 1:
                unmet.append("--steps_per_call > 1")
            warnings.warn(
                "--device_sampler ignored; requires " + ", ".join(unmet)
                + " — falling back to host-side sampling", stacklevel=2)
        elif device_sampler and self.streaming:
            # shard-local batches made on the device against the shard
            # on the card
            self._ssampler_s = StreamingDeviceSampler(
                source_loader, self._plan_s, seed=seed + 101).to(self.device)
            self._ssampler_t = StreamingDeviceSampler(
                target_loader, self._plan_t, seed=seed + 202).to(self.device)
            # zip-shortest steps per epoch: the epoch of a step on the
            # device
            self._stream_spe = min(
                sum(s.shard_steps(i) for i in range(s.num_shards))
                for s in (self._ssampler_s, self._ssampler_t))
            self.shard_sampled_step = make_sampled_shard_multi_step(
                model, da_cfg, train_cfg, self._ssampler_s, self._ssampler_t,
                self._stream_spe, class_weights, domain_weights, mesh=mesh)
        elif device_sampler:
            self._sampler_s = DeviceSampler(source_loader,
                                            seed=seed + 101).to(self.device)
            self._sampler_t = DeviceSampler(target_loader,
                                            seed=seed + 202).to(self.device)
            # zip-shortest epochs (main.py:330): both samplers advance on
            # one steps-per-epoch; each epoch drops the longer one's tail
            spe = min(len(source_loader), len(target_loader))
            self._sampler_s.steps_per_epoch = spe
            self._sampler_t.steps_per_epoch = spe
            self.sampled_step = make_sampled_multi_step(
                model, da_cfg, train_cfg, self._sampler_s, self._sampler_t,
                class_weights, domain_weights, mesh=mesh)

        # a whole validation in one call and one fetch: resident store and
        # a deterministic val epoch, whose stacked indices are cached
        # (tensorboard needs the features of every batch)
        self.multi_eval_step = (
            make_multi_eval_step(model, class_weights, mesh=mesh)
            if device_store and not self.streaming and not tb_on
            and not val_loader.shuffle else None)
        self._val_stack = None

        # gradient accumulation (--accum_steps): G host-fed micro-batch
        # pairs -> averaged gradients -> ONE optimizer update, under the
        # JAX Trainer's conditions and with its warning otherwise
        self.accum_step = None
        self.accum_steps = 1
        if accum_steps > 1:
            unmet = []
            if device_store:
                unmet.append("--device_store")
            if self.steps_per_call > 1:
                unmet.append("--steps_per_call > 1")
            if da_cfg.pretrain_source:
                unmet.append("--pretrain_source")
            if self._need_aux:
                unmet.append("attention/tensorboard collection")
            if unmet:
                warnings.warn(
                    "--accum_steps ignored with " + ", ".join(unmet)
                    + " — falling back to per-batch updates", stacklevel=2)
            else:
                self.accum_steps = accum_steps
                self.accum_step = make_grad_accum_step(
                    model, da_cfg, train_cfg, class_weights, domain_weights,
                    accum_steps=accum_steps, mesh=mesh)

        self.lr_current = train_cfg.lr
        self.best_prec1 = 0.0
        self.start_epoch = 1
        self.loss_c_current = 999.0
        self.loss_c_previous = 999.0
        self.attn_epoch_source = []
        self.attn_epoch_target = []
        self._last_epoch_done = 0

    def _make_mesh(self, num_devices: Optional[int], use_mesh: bool,
                   model_parallel: int = 1):
        """The data mesh, or with ``model_parallel`` > 1 the (data x
        model) grid, of the process group this process belongs to; or
        None: one device (no group, a group of one, or ``use_mesh``
        off)."""
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        if num_devices is not None and num_devices > 1 and world == 1:
            raise ValueError(
                f"num_devices={num_devices}: training on several cards "
                "runs one process a card in a torch.distributed group; "
                "start it with the train CLI's --num_devices or torchrun "
                "(parallel/distributed.py::initialize_multihost)")
        if num_devices is not None and world > 1 and num_devices != world:
            raise ValueError(f"num_devices={num_devices} in a process "
                             f"group of {world} ranks")
        if model_parallel > 1 and not (use_mesh and world > 1):
            warnings.warn(
                f"--model_parallel {model_parallel} ignored: requires a "
                f"process group of several ranks (use_mesh={use_mesh}, "
                f"{world} rank(s)) — training proceeds without tensor "
                "parallelism", stacklevel=3)
        if not (use_mesh and world > 1):
            return None
        return make_mesh_2d([self.device], model_parallel)

    def _print(self, *args) -> None:
        """print, on rank 0 only."""
        if self.primary:
            print(*args)

    def _agree_stop(self) -> None:
        """Over several ranks: whether any rank has been asked to stop
        (SIGTERM), agreed on by every rank at once; then every rank raises
        `_AgreedStop` (a KeyboardInterrupt) together, and rank 0 writes
        the emergency checkpoint (on a model grid with every rank's
        slices)."""
        if self._stop is None:
            return
        flag = torch.tensor([float(self._stop.is_set())], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() > 0:
            raise _AgreedStop("SIGTERM (preemption) on a rank")

    # ---- checkpoint (main.py:91-106,266-274) ----
    def resume(self, path: str, resume_hp: bool = False) -> int:
        """Restore the model, epoch and best accuracy from a checkpoint
        ``.pth.tar``; with ``resume_hp`` also the optimizer (its momentum
        buffers) and the current lr.  Returns the epoch to start at."""
        payload = load_checkpoint(path)
        # a whole checkpoint, cut to this rank's slices on a model grid
        self.state.model.load_state_dict(slice_state_dict(
            live_state(payload["state_dict"]), self.state.model),
            strict=True)
        if resume_hp:
            self.state.optimizer.load_state_dict(payload["optimizer"])
            slice_optimizer_state(self.state.optimizer)
            # the reference's --resume_hp also restores the optimizer's
            # current lr (main.py:102-104); the DANN rule decays it after
            # every step (main.py:619-621), so it is saved as lr_current
            if "lr_current" in payload:
                self.lr_current = float(payload["lr_current"])
        self.start_epoch = int(payload["epoch"]) + 1
        self.best_prec1 = float(payload["best_prec1"])
        # the step counter keys the device samplers' epochs and orders,
        # and the generators' states continue the dropout streams, so a
        # resumed run continues the streams of an uninterrupted one
        step = int(payload.get("step", 0))
        if step == 0 and self.start_epoch > 1:
            spe = min(len(self.source_loader), len(self.target_loader))
            step = (self.start_epoch - 1) * spe
        self.state = self.state._replace(step=step)
        for key, gen in (("rng_state", self.generator),
                         ("pretrain_rng_state", self.pretrain_generator)):
            if gen is not None and key in payload:
                gen.set_state(payload[key])
        return self.start_epoch

    @property
    def _sharded(self) -> bool:
        """Whether the ranks hold weight slices (a model grid)."""
        return self.mesh is not None and self.mesh.model.size > 1

    def _ckpt_payload(self, epoch: int, prec1: float) -> dict:
        """The checkpoint's payload, whole: on a model grid the weight
        slices and their optimizer state are gathered over the model
        group (a collective of every rank)."""
        return {
            "epoch": epoch,
            "arch": self.model_cfg.base_model,
            "state_dict": {f"module.{k}": v for k, v in
                           export_reference_state(
                               whole_model(self.state.model)).items()},
            "optimizer": whole_optimizer_state(self.state.optimizer),
            "best_prec1": self.best_prec1,
            "prec1": prec1,
            "lr_current": float(self.lr_current),
            "step": int(self.state.step),
            "rng_state": self.generator.get_state(),
            **({"pretrain_rng_state": self.pretrain_generator.get_state()}
               if self.pretrain_generator is not None else {}),
        }

    def save(self, epoch: int, prec1: float, is_best: bool):
        """Write the checkpoint (rank 0 only: every rank holds the same
        state, or on a model grid its slices, which every rank gathers
        for rank 0)."""
        if self.primary or self._sharded:
            payload = self._ckpt_payload(epoch, prec1)
            if self.primary:
                save_checkpoint(self.path_exp, payload, is_best)

    # ---- the profiler window (--profile_dir) ----
    def _start_profile(self):
        """Start a ``torch.profiler`` trace, of the host and, on the card,
        of the device; `_stop_profile` writes it into ``profile_dir`` as
        a Chrome trace (Perfetto, TensorBoard's profiler plugin)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                self.profile_dir))
        self._profiler.start()

    def _stop_profile(self):
        """Wait for the device's work in the window, then stop the trace
        and write it."""
        profiler, self._profiler = self._profiler, None
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            profiler.stop()

    def _maybe_profile_chunk(self) -> bool:
        """The window of the K-step paths: start a trace before the SECOND
        call dispatched in this run, whatever epoch it falls in (the first
        call warms up), as the JAX Trainer does; True if it started."""
        if not self.profile_dir or self._profile_done:
            return False
        self._profile_chunks_seen += 1
        if self._profile_chunks_seen == 2:
            self._profile_done = True
            self._start_profile()
            return True
        return False

    # ---- one epoch (main.py:309-667) ----
    def train_epoch(self, epoch: int) -> float:
        """One epoch; a profiler window still open at its end (an epoch
        shorter than the window, or an exception) is stopped here."""
        try:
            return self._train_epoch(epoch)
        finally:
            if self._profiler is not None:
                self._stop_profile()

    def _train_epoch(self, epoch: int) -> float:
        tc = self.train_cfg
        meters = {k: AverageMeter() for k in
                  ("batch_time", "data_time", "loss", "loss_c", "loss_d",
                   "loss_a", "loss_e", "loss_s", "top1", "top5")}
        if self.streaming:
            # the schedules' denominator: the source stream's streamed
            # length (main.py:347 uses len(source_loader)), in every
            # streamed mode
            len_loader = self.source_loader.shard_epoch_len(self._plan_s)
        else:
            len_loader = len(self.source_loader)
        start_steps = epoch * len_loader
        total_steps = tc.epochs * len_loader
        alpha = alpha_schedule(tc.alpha, epoch, tc.epochs)
        end = time.time()

        last_line = ""
        pending = []  # metrics still on the device: fetched at print
        attn_src_epoch, attn_tgt_epoch = [], []

        def flush(keep_last: int = 0):
            """Move the pending metrics into the meters, all but the newest
            ``keep_last`` entries (still running on the device), as the
            JAX Trainer does (printed values lag up to keep_last steps or
            chunks; the meters' averages are exact).  An entry is one
            step's metrics or a K-step call's, ``("stacked", m, k)`` with
            each of m's values [k]; all the entries taken come to the host
            in one copy."""
            self._agree_stop()
            if meters["loss"].count == 0:
                keep_last = 0  # first print of the epoch: real values
            if len(pending) <= keep_last:
                return
            take = pending[:len(pending) - keep_last]
            del pending[:len(pending) - keep_last]
            first = take[0][1] if isinstance(take[0], tuple) else take[0]
            keys = [k for k in _METRICS if k in first]
            host = torch.cat([
                torch.stack([m[1][k] for k in keys], dim=1)
                if isinstance(m, tuple) else torch.stack(
                    [m[k] for k in keys])[None] for m in take]).cpu().tolist()
            for row in host:
                m = dict(zip(keys, row))
                n = m["n"]
                if self.nan_guard and not math.isfinite(m["loss"]):
                    raise TrainingDivergedError(
                        f"non-finite training loss {m['loss']} at epoch "
                        f"{epoch} (nan_guard=False disables)")
                # weighted by batch size like the reference (main.py:569)
                meters["loss"].update(m["loss"], n)
                meters["loss_c"].update(m["loss_c"], n)
                for key in ("loss_d", "loss_a", "loss_e", "loss_s"):
                    if key in m:
                        meters[key].update(m[key], n)
                meters["top1"].update(100.0 * m["top1"] / max(n, 1), n)
                meters["top5"].update(100.0 * m["top5"] / max(n, 1), n)

        chunked = (epoch, meters, flush, pending, alpha, start_steps,
                   total_steps)
        if self.shard_sampled_step is not None:
            # streamed and sampled on the device: the host walks the
            # chunk plan and rotates the shards
            return self._train_epoch_sampled_stream(*chunked)
        if self.sampled_step is not None:
            # sampled on the device: no host iterators at all
            return self._train_epoch_sampled(*chunked)
        if self.streaming:
            epochs = (self.source_loader.shard_index_epoch(self._plan_s),
                      self.target_loader.shard_index_epoch(self._plan_t))
        elif self.device_store:
            epochs = (self.source_loader.index_epoch(),
                      self.target_loader.index_epoch())
        else:
            epochs = (self.source_loader.epoch(), self.target_loader.epoch())
        if self.multi_step is not None:
            return self._train_epoch_multi(*chunked, zip(*epochs),
                                           len_loader)
        if self.accum_step is not None:
            return self._train_epoch_accum(epoch, meters, zip(*epochs), flush,
                                           pending, alpha, start_steps,
                                           total_steps, len_loader)
        for i, (bs, bt) in enumerate(zip(*epochs)):
            p = progress(i, start_steps, total_steps)
            beta = effective_beta(tc.beta, p)
            meters["data_time"].update(time.time() - end)
            if self.profile_dir and epoch == self.start_epoch and i == 2:
                self._start_profile()  # steps 2-7 of the first epoch
            scalars = StepScalars(beta, tc.mu, alpha, tc.gamma,
                                  self.lr_current)
            if self.streaming:
                (sid_s, bs), (sid_t, bt) = bs, bt
                args = (self._stream_s.get(sid_s), bs.abs_indices, bs.labels,
                        bs.mask, self._stream_t.get(sid_t), bt.abs_indices,
                        bt.labels, bt.mask)
            elif self.device_store:
                args = (self._dev_store_s, bs.abs_indices, bs.labels,
                        bs.mask, self._dev_store_t, bt.abs_indices,
                        bt.labels, bt.mask)
            else:
                args = (bs.features, bs.labels, bs.mask,
                        bt.features, bt.labels, bt.mask)
            if self.pretrain_step is not None:
                self.state, _ = self.pretrain_step(
                    self.state, *args, scalars, self.pretrain_generator)
            self.state, m = self.train_step(self.state, *args, scalars,
                                            self.generator)
            if self._profiler is not None and i == 7:
                self._stop_profile()
            if self._need_aux:
                aux = {k: m.pop(k) for k in ("attn_s", "attn_t", "feat_s",
                                             "feat_t")}
                if self.save_attention >= 0:
                    # attention rows of the selected class
                    # (main.py:623-628); a value per video without
                    # relations (avgpool, rnn, temconv)
                    a_s = aux["attn_s"].cpu().numpy().reshape(
                        len(bs.mask), -1)
                    a_t = aux["attn_t"].cpu().numpy().reshape(
                        len(bt.mask), -1)
                    sel_s = (bs.labels == self.save_attention) & (bs.mask > 0)
                    sel_t = (bt.labels == self.save_attention) & (bt.mask > 0)
                    attn_src_epoch.append(a_s[sel_s])
                    attn_tgt_epoch.append(a_t[sel_t])
                self.tb.collect(aux["feat_s"], bs.labels, aux["feat_t"],
                                bt.labels, bs.mask, bt.mask)
            pending.append(m)

            meters["batch_time"].update(time.time() - end)
            end = time.time()

            if i % self.print_freq == 0:
                flush(keep_last=2)
                last_line = self._format_train_line(
                    epoch, i, len_loader, meters, alpha, beta, tc)
                if i % self.show_freq == 0:
                    self._print(last_line)
                if self.logs:
                    self.logs.write("train.log", last_line)

            # DANN per-step lr for the NEXT step (main.py:619-621)
            if tc.lr_adaptive == "dann":
                self.lr_current = dann_lr(tc.lr, p)

        flush()
        if self.save_attention >= 0:
            # per-epoch mean attention vector (main.py:242-244,667)
            for buf, store in ((attn_src_epoch, self.attn_epoch_source),
                               (attn_tgt_epoch, self.attn_epoch_target)):
                rows = np.concatenate(buf) if buf else np.zeros((0, 1))
                store.append(rows.mean(axis=0) if len(rows) else
                             np.zeros(rows.shape[1]))
        self.tb.write_epoch(epoch * len_loader)
        if self.logs and last_line:
            self.logs.write("train_short.log", last_line)
        return meters["loss_c"].avg

    def _chunk_scalars(self, i, k, alpha, start_steps, total_steps):
        """The schedule values of steps [i, i + k) for one K-step call, a
        `StepScalars` of k-long lists (host numbers), and the betas; the
        DANN lr decays after each step (main.py:619-621).  Every K-step
        path takes its schedules from here, as in the JAX Trainer."""
        tc = self.train_cfg
        betas, lrs = [], []
        for j in range(k):
            p = progress(i + j, start_steps, total_steps)
            betas.append(effective_beta(tc.beta, p))
            lrs.append(self.lr_current)
            if tc.lr_adaptive == "dann":
                self.lr_current = dann_lr(tc.lr, p)
        return StepScalars(betas, [tc.mu] * k, [alpha] * k, [tc.gamma] * k,
                           lrs), betas

    def _run_chunks(self, epoch, meters, flush, pending, alpha, start_steps,
                    total_steps, len_loader, chunks):
        """The K-step epoch loop: ``chunks`` yields (k, call), where
        ``call(scalars)`` runs k steps and returns (state, metrics each
        [k]); their metrics wait on the device until the print
        frequency's flush, which prints a line (the JAX Trainer's
        cadence)."""
        tc = self.train_cfg
        big_k = self.steps_per_call
        end = time.time()
        last_line = ""
        i = 0
        for k, call in chunks:
            sc, betas = self._chunk_scalars(i, k, alpha, start_steps,
                                            total_steps)
            profiling = self._maybe_profile_chunk()
            self.state, m = call(sc)
            if profiling:
                self._stop_profile()
            pending.append(("stacked", m, k))
            meters["batch_time"].update((time.time() - end) / k, k)
            end = time.time()
            i += k
            if (i - k) // big_k % max(self.print_freq // big_k, 1) == 0:
                flush(keep_last=2)
                last_line = self._format_train_line(
                    epoch, i - 1, len_loader, meters, alpha, betas[-1], tc)
                if self.logs:
                    self.logs.write("train.log", last_line)
                self._print(last_line)
        flush()
        if self.logs and last_line:
            self.logs.write("train_short.log", last_line)
        return meters["loss_c"].avg

    def _train_epoch_multi(self, epoch, meters, flush, pending, alpha,
                           start_steps, total_steps, pairs, len_loader):
        """K steps per call from the device stores
        (``make_multi_train_step``): K index batches stacked on the host
        with their schedule values.  Streamed, a call never spans a shard
        switch of either stream (one shard each per call)."""
        big_k = self.steps_per_call

        def call(chunk, key):
            """(k, the K-step call on ``chunk``), on the shards ``key``
            when streamed."""
            store_s, store_t = (
                (self._stream_s.get(key[0]), self._stream_t.get(key[1]))
                if self.streaming else (self._dev_store_s, self._dev_store_t))
            bs_list, bt_list = zip(*chunk)
            return len(chunk), lambda sc: self.multi_step(
                self.state, store_s,
                np.stack([b.abs_indices for b in bs_list]),
                np.stack([b.labels for b in bs_list]),
                np.stack([b.mask for b in bs_list]), store_t,
                np.stack([b.abs_indices for b in bt_list]),
                np.stack([b.labels for b in bt_list]),
                np.stack([b.mask for b in bt_list]), sc, self.generator)

        def chunks():
            chunk, key = [], None
            for bs, bt in pairs:
                if self.streaming:
                    (sid_s, bs), (sid_t, bt) = bs, bt
                    if chunk and (sid_s, sid_t) != key:
                        yield call(chunk, key)
                        chunk = []
                    key = (sid_s, sid_t)
                chunk.append((bs, bt))
                if len(chunk) == big_k:
                    yield call(chunk, key)
                    chunk = []
            if chunk:
                yield call(chunk, key)

        return self._run_chunks(epoch, meters, flush, pending, alpha,
                                start_steps, total_steps, len_loader,
                                chunks())

    def _train_epoch_sampled(self, epoch, meters, flush, pending, alpha,
                             start_steps, total_steps):
        """Sampled on the device (``make_sampled_multi_step``): each call
        makes its own index batches from the step counter; the host sends
        the schedule values alone."""
        spe = self._sampler_s.steps_per_epoch
        big_k = self.steps_per_call

        def chunks():
            for i in range(0, spe, big_k):
                yield min(big_k, spe - i), lambda sc: self.sampled_step(
                    self.state, self._dev_store_s, self._dev_store_t, sc,
                    self.generator)

        return self._run_chunks(epoch, meters, flush, pending, alpha,
                                start_steps, total_steps, spe, chunks())

    def _train_epoch_sampled_stream(self, epoch, meters, flush, pending,
                                    alpha, start_steps, total_steps):
        """Streamed and sampled on the device
        (``make_sampled_shard_multi_step``): per call the host hands over
        the shards on the card (``ShardStream``, double-buffered), the
        shard ids and offsets and the schedule values; the call makes
        every batch shard-locally on the device."""
        plan = plan_zip_shard_chunks(self._ssampler_s, self._ssampler_t,
                                     self.steps_per_call)

        def chunks():
            for sid_s, j0_s, sid_t, j0_t, k in plan:
                yield k, lambda sc: self.shard_sampled_step(
                    self.state, self._stream_s.get(sid_s),
                    self._stream_t.get(sid_t), sc, self.generator, sid_s,
                    j0_s, sid_t, j0_t)

        return self._run_chunks(epoch, meters, flush, pending, alpha,
                                start_steps, total_steps, self._stream_spe,
                                chunks())

    def _train_epoch_accum(self, epoch, meters, pairs, flush, pending,
                           alpha, start_steps, total_steps, len_loader):
        """Gradient-accumulation epoch (`ta3n_tpu/train/loop.py::
        _train_epoch_accum`): every G consecutive micro-batch pairs become
        ONE optimizer update with averaged gradients
        (``make_grad_accum_step``).  Schedule scalars (beta, lr) are
        evaluated once per update at the chunk's first micro-step index; a
        tail of fewer than G pairs falls back to plain per-batch updates
        so that no data is dropped."""
        tc = self.train_cfg
        g_steps = self.accum_steps
        end = time.time()
        last_line = ""
        i = 0

        def scalars_at(step_i):
            p = progress(step_i, start_steps, total_steps)
            beta = effective_beta(tc.beta, p)
            return (StepScalars(beta, tc.mu, alpha, tc.gamma,
                                self.lr_current), p, beta)

        def run_chunk(chunk):
            nonlocal last_line, end, i
            k = len(chunk)
            if k == g_steps:
                # one update: scalars at the chunk's first micro-step index,
                # the lr decays once
                scalars, p, beta = scalars_at(i)
                bs_list, bt_list = zip(*chunk)
                self.state, m = self.accum_step(
                    self.state,
                    np.stack([b.features for b in bs_list]),
                    np.stack([b.labels for b in bs_list]),
                    np.stack([b.mask for b in bs_list]),
                    np.stack([b.features for b in bt_list]),
                    np.stack([b.labels for b in bt_list]),
                    np.stack([b.mask for b in bt_list]),
                    scalars, self.generator)
                pending.extend({key: v[j] for key, v in m.items()}
                               for j in range(k))
                if tc.lr_adaptive == "dann":  # per-update lr decay
                    self.lr_current = dann_lr(tc.lr, p)
            else:  # tail: plain per-batch updates, per-step schedules
                for j, (bs, bt) in enumerate(chunk):
                    scalars, p, beta = scalars_at(i + j)
                    self.state, m = self.train_step(
                        self.state, bs.features, bs.labels, bs.mask,
                        bt.features, bt.labels, bt.mask, scalars,
                        self.generator)
                    pending.append(m)
                    if tc.lr_adaptive == "dann":
                        self.lr_current = dann_lr(tc.lr, p)
            meters["batch_time"].update((time.time() - end) / k, k)
            end = time.time()
            i += k
            if (i - k) // g_steps % max(self.print_freq // g_steps, 1) == 0:
                flush(keep_last=2 * g_steps)
                last_line = self._format_train_line(
                    epoch, i - 1, len_loader, meters, alpha, beta, tc)
                if self.logs:
                    self.logs.write("train.log", last_line)
                self._print(last_line)

        chunk = []
        for pair in pairs:
            chunk.append(pair)
            if len(chunk) == g_steps:
                run_chunk(chunk)
                chunk = []
        if chunk:
            run_chunk(chunk)
        flush()
        if self.logs and last_line:
            self.logs.write("train_short.log", last_line)
        return meters["loss_c"].avg

    def _format_train_line(self, epoch, i, total, meters, alpha, beta, tc):
        line = (f"Train: [{epoch}][{i}/{total}], lr: {self.lr_current:.5f}\t"
                f"Time {meters['batch_time'].val:.3f} "
                f"({meters['batch_time'].avg:.3f})\t"
                f"Data {meters['data_time'].val:.3f} "
                f"({meters['data_time'].avg:.3f})\t"
                f"Prec@1 {meters['top1'].val:.3f} "
                f"({meters['top1'].avg:.3f})\t"
                f"Prec@5 {meters['top5'].val:.3f} "
                f"({meters['top5'].avg:.3f})\t"
                f"Loss {meters['loss'].val:.4f} "
                f"({meters['loss'].avg:.4f})   "
                f"loss_c {meters['loss_c'].avg:.4f}\t")
        da = self.da_cfg
        if da.dis_DA != 'none' and da.use_target != 'none':
            line += f"alpha {alpha:.3f}  loss_d {meters['loss_d'].avg:.4f}\t"
        if da.adv_DA != 'none' and da.use_target != 'none':
            line += (f"beta {beta[0]:.3f}, {beta[1]:.3f}, {beta[2]:.3f}  "
                     f"loss_a {meters['loss_a'].avg:.4f}\t")
        if da.add_loss_DA != 'none' and da.use_target != 'none':
            line += (f"gamma {tc.gamma:.6f}  "
                     f"loss_e {meters['loss_e'].avg:.4f}\t")
        if da.ens_DA != 'none' and da.use_target != 'none':
            line += f"mu {tc.mu:.6f}  loss_s {meters['loss_s'].avg:.4f}\t"
        return line

    # ---- validation (main.py:669-761) ----
    def validate(self, epoch: int) -> float:
        if self.multi_eval_step is not None:
            # the deterministic val epoch's stacked index batches, built
            # once; each validation is then one call and one fetch
            if self._val_stack is None:
                bs = list(self.val_loader.index_epoch())
                self._val_stack = (
                    np.stack([b.abs_indices for b in bs]),
                    np.stack([b.labels for b in bs]),
                    np.stack([b.mask for b in bs]))
            r = self.multi_eval_step(self._dev_store_v, *self._val_stack)
            loss_sum, top1, top5, n = torch.stack(
                [r["loss_sum"], r["top1"], r["top5"], r["n"]]).cpu().tolist()
            n = max(n, 1.0)
            top1, top5, loss = 100.0 * top1 / n, 100.0 * top5 / n, \
                loss_sum / n
        else:
            meters = {k: AverageMeter() for k in ("loss", "top1", "top5")}
            feat_val, label_val = [], []
            if self.streaming:
                batches = self.val_loader.shard_index_epoch(self._plan_v)
            elif self.device_store:
                batches = self.val_loader.index_epoch()
            else:
                batches = self.val_loader.epoch()
            for b in batches:
                if self.streaming:
                    sid, b = b
                    r = self.eval_step(self._stream_v.get(sid),
                                       b.abs_indices, b.labels, b.mask)
                elif self.device_store:
                    r = self.eval_step(self._dev_store_v, b.abs_indices,
                                       b.labels, b.mask)
                else:
                    r = self.eval_step(b.features, b.labels, b.mask)
                loss, t1, t5, n = torch.stack(
                    [r["loss"], r["top1"], r["top5"], r["n"]]).cpu().tolist()
                meters["loss"].update(loss, n)
                meters["top1"].update(100.0 * t1 / max(n, 1), n)
                meters["top5"].update(100.0 * t5 / max(n, 1), n)
                if self.tb.active:
                    sel = np.asarray(b.mask) > 0
                    feat_val.append(r["feat"].float().cpu().numpy()[sel])
                    label_val.append(np.asarray(b.labels)[sel])
            top1, top5, loss = (meters["top1"].avg, meters["top5"].avg,
                                meters["loss"].avg)
            if feat_val:
                self.tb.write_val_embedding(np.concatenate(feat_val),
                                            np.concatenate(label_val),
                                            epoch * len(self.val_loader))
        line = (f"Testing Results: Prec@1 {top1:.3f} Prec@5 {top5:.3f} "
                f"Loss {loss:.5f}")
        self._print(line)
        if self.logs:
            self.logs.write("val.log", line)
        return top1

    # ---- full run (main.py:228-306) ----
    def fit(self):
        """The epoch loop.  An interrupt, SIGTERM (see
        ``_sigterm_as_interrupt``) or a crash after a finished epoch saves
        a resumable checkpoint before re-raising (the reference has no
        such recovery, SURVEY §5.3)."""
        try:
            with _sigterm_as_interrupt(self._stop):
                return self._fit()
        except BaseException as exc:
            if self._sharded and not isinstance(exc, _AgreedStop):
                # the slices are gathered over every model group, and the
                # other ranks have not stopped with this one: a rank that
                # failed, or an interrupt of this rank alone (SIGINT, a
                # second SIGTERM), whose peers are still in the step
                self._print("no emergency checkpoint: a model grid's "
                            "weights are gathered from every rank")
            elif self.save_model and self._last_epoch_done >= 1:
                self.save(self._last_epoch_done, self.best_prec1, False)
                self._print(f"emergency checkpoint saved at epoch "
                            f"{self._last_epoch_done} -> {self.path_exp}")
            raise

    def _fit(self):
        tc = self.train_cfg
        for epoch in range(self.start_epoch, tc.epochs + 1):
            # epoch-level lr rules (main.py:234-237)
            if tc.lr_adaptive == "loss":
                self.lr_current = loss_plateau_lr(
                    self.lr_current, tc.lr_decay, self.loss_c_current,
                    self.loss_c_previous)
            elif tc.lr_adaptive == "none":
                # cumulative, so a resumed run past a step epoch re-derives
                # the decayed lr
                self.lr_current = step_decay_lr(tc.lr, tc.lr_decay, epoch,
                                                tc.lr_steps)

            loss_c = self.train_epoch(epoch)
            self._last_epoch_done = epoch
            self.loss_c_previous = self.loss_c_current
            self.loss_c_current = loss_c

            if epoch % self.eval_freq == 0 or epoch == tc.epochs:
                prec1 = self.validate(epoch)
                is_best = prec1 > self.best_prec1
                line_update = (' ==> updating the best accuracy'
                               if is_best else '')
                self._print(f"Best score {self.best_prec1} vs current "
                            f"score {prec1}{line_update}")
                if self.logs:
                    self.logs.write("val_short.log", "%.3f" % prec1)
                self.best_prec1 = max(prec1, self.best_prec1)
                self.tb.write_best_text(self.best_prec1, epoch)
                if self.save_model:
                    self.save(epoch, prec1, is_best)
        if (self.profile_dir and not self._profile_done
                and self.steps_per_call > 1):
            warnings.warn(
                "--profile_dir produced no trace: the run dispatched "
                f"only {self._profile_chunks_seen} chunk(s) and the "
                "first chunk (warm-up) is never traced — run at "
                "least 2 chunks", stacklevel=2)
        if self.logs:
            self.logs.write_best(self.best_prec1)
        if (self.save_attention >= 0 and self.attn_epoch_source
                and self.primary):
            # attention-value dumps (main.py:304-306), under the
            # experiment dir
            np.savetxt(os.path.join(self.path_exp,
                                    f"attn_source_{self.save_attention}.log"),
                       np.stack(self.attn_epoch_source), fmt="%s")
            np.savetxt(os.path.join(self.path_exp,
                                    f"attn_target_{self.save_attention}.log"),
                       np.stack(self.attn_epoch_target), fmt="%s")
        self.tb.close()
        return self.best_prec1
