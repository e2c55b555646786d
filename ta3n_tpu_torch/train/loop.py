"""The training driver: epoch loop, validation, checkpointing, logging.

Port of `ta3n_tpu/train/loop.py` (reference main.py:33-306 ``main()``,
``train()`` and ``validate()``) for one card: one optimizer step per call
of the train step (`train/step.py`), fed from the host loaders or, with
``device_store``, by index batches into feature stores uploaded once
(``FeatureStore.to_device``, ``TSNLoader.index_epoch``).  Per-step Python
work is schedule arithmetic and meter updates; metrics stay on the device
until the print-frequency flush, which fetches them in one copy.

What the JAX Trainer runs and the port does not yet raises
``NotImplementedError`` naming its ROADMAP.md item: several steps per call
(queue 1, item 4), gradient accumulation and narrow stores (item 8),
shard streaming, the device sampler and more than one device (item 9),
``pretrain_source`` (item 6), tensorboard and the profiler window
(item 5).
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import (FeatureStore, TSNLoader,
                                 epoch_balance_counts, parse_list_file)
from ta3n_tpu_torch.io_utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from ta3n_tpu_torch.io_utils.logs import AverageMeter, LogFiles
from ta3n_tpu_torch.train.schedules import (alpha_schedule, dann_lr,
                                            effective_beta, loss_plateau_lr,
                                            progress, step_decay_lr)
from ta3n_tpu_torch.train.step import (StepScalars, TrainState,
                                       create_train_state, make_eval_step,
                                       make_multi_eval_step, make_train_step)

__all__ = ["Trainer", "TrainingDivergedError", "build_loaders",
           "class_weights_from_list"]

_METRICS = ("loss", "loss_c", "loss_a", "loss_e", "top1", "top5", "n")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"queue 1, item {item})")


class TrainingDivergedError(RuntimeError):
    """Raised by the Trainer's nan_guard when a training loss is
    non-finite at the metric flush (a host sync the loop makes anyway);
    fit() writes an emergency checkpoint before the exception propagates.
    The reference trains on through NaN (main.py:569)."""


@contextlib.contextmanager
def _sigterm_as_interrupt():
    """Deliver SIGTERM as KeyboardInterrupt for the duration of fit(), so
    that a scheduler's kill (or ``timeout``) goes through fit()'s
    emergency checkpoint.  Installed only in the main thread and only when
    SIGTERM has its default disposition; the previous one is restored."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.getsignal(signal.SIGTERM)
    if prev is not signal.SIG_DFL:
        yield
        return

    def _raise(signum, frame):
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
    ``seed``.  Without the JAX Trainer's ``use_mesh`` and
    ``prefetch_depth``: one device, and no prefetch thread."""

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
                 device="cuda"):
        for on, what, item in (
                (steps_per_call > 1, "steps_per_call > 1 (several steps "
                 "per call)", "4"),
                (accum_steps > 1, "accum_steps > 1 (gradient "
                 "accumulation)", "8"),
                (store_dtype not in (None, "", "float32"),
                 f"store_dtype={store_dtype!r}", "8"),
                (bool(store_budget_rows), "store_budget_rows (shard "
                 "streaming)", "9"),
                (device_sampler, "device_sampler", "9"),
                (model_parallel > 1, "model_parallel > 1", "9"),
                (num_devices is not None and num_devices > 1,
                 "num_devices > 1", "9"),
                (da_cfg.pretrain_source, "pretrain_source", "6"),
                (tensorboard_dir is not None, "tensorboard", "5"),
                (profile_dir is not None, "profile_dir", "5")):
            if on:
                raise _unported(what, item)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; the Trainer "
                               "runs on the card by default (pass "
                               "device='cpu' for the CPU)")
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
        self.nan_guard = nan_guard
        self.device_store = device_store

        self.state = create_train_state(
            model_cfg, train_cfg, torch.Generator().manual_seed(seed),
            self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        model = self.state.model
        self.train_step = make_train_step(
            model, da_cfg, train_cfg, class_weights, domain_weights,
            gather_on_device=device_store, return_aux=save_attention >= 0)
        self.eval_step = make_eval_step(model, class_weights,
                                        gather_on_device=device_store)
        if device_store:
            # stores uploaded once; each step then sends index batches
            uploaded = {}

            def put(store):
                if id(store) not in uploaded:
                    uploaded[id(store)] = store.to_device(self.device)
                return uploaded[id(store)]

            self._dev_store_s = put(source_loader.store)
            self._dev_store_t = put(target_loader.store)
            self._dev_store_v = put(val_loader.store)
        # a whole validation in one call and one fetch: resident store and
        # a deterministic val epoch, whose stacked indices are cached
        self.multi_eval_step = (
            make_multi_eval_step(model, class_weights)
            if device_store and not val_loader.shuffle else None)
        self._val_stack = None

        self.lr_current = train_cfg.lr
        self.best_prec1 = 0.0
        self.start_epoch = 1
        self.loss_c_current = 999.0
        self.loss_c_previous = 999.0
        self.attn_epoch_source = []
        self.attn_epoch_target = []
        self._last_epoch_done = 0

    # ---- checkpoint (main.py:91-106,266-274) ----
    def resume(self, path: str, resume_hp: bool = False) -> int:
        """Restore the model, epoch and best accuracy from a checkpoint
        ``.pth.tar``; with ``resume_hp`` also the optimizer (its momentum
        buffers) and the current lr.  Returns the epoch to start at."""
        payload = load_checkpoint(path)
        state = {(k[len("module."):] if k.startswith("module.") else k): v
                 for k, v in payload["state_dict"].items()}
        self.state.model.load_state_dict(state, strict=True)
        if resume_hp:
            self.state.optimizer.load_state_dict(payload["optimizer"])
            # the reference's --resume_hp also restores the optimizer's
            # current lr (main.py:102-104); the DANN rule decays it after
            # every step (main.py:619-621), so it is saved as lr_current
            if "lr_current" in payload:
                self.lr_current = float(payload["lr_current"])
        self.start_epoch = int(payload["epoch"]) + 1
        self.best_prec1 = float(payload["best_prec1"])
        step = int(payload.get("step", 0))
        if step == 0 and self.start_epoch > 1:
            spe = min(len(self.source_loader), len(self.target_loader))
            step = (self.start_epoch - 1) * spe
        self.state = self.state._replace(step=step)
        return self.start_epoch

    def _ckpt_payload(self, epoch: int, prec1: float) -> dict:
        return {
            "epoch": epoch,
            "arch": self.model_cfg.base_model,
            "state_dict": {f"module.{k}": v.detach().cpu() for k, v in
                           self.state.model.state_dict().items()},
            "optimizer": self.state.optimizer.state_dict(),
            "best_prec1": self.best_prec1,
            "prec1": prec1,
            "lr_current": float(self.lr_current),
            "step": int(self.state.step),
        }

    def save(self, epoch: int, prec1: float, is_best: bool):
        save_checkpoint(self.path_exp, self._ckpt_payload(epoch, prec1),
                        is_best)

    # ---- one epoch (main.py:309-667) ----
    def train_epoch(self, epoch: int) -> float:
        tc = self.train_cfg
        meters = {k: AverageMeter() for k in
                  ("batch_time", "data_time", "loss", "loss_c", "loss_d",
                   "loss_a", "loss_e", "loss_s", "top1", "top5")}
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
            ``keep_last`` (still running on the device), as the JAX
            Trainer does (printed values lag up to keep_last steps; the
            meters' averages are exact)."""
            if meters["loss"].count == 0:
                keep_last = 0  # first print of the epoch: real values
            if len(pending) <= keep_last:
                return
            take = pending[:len(pending) - keep_last]
            del pending[:len(pending) - keep_last]
            keys = [k for k in _METRICS if k in take[0]]
            host = torch.stack([torch.stack([m[k] for k in keys])
                                for m in take]).cpu().tolist()
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
                for key in ("loss_a", "loss_e"):
                    if key in m:
                        meters[key].update(m[key], n)
                meters["top1"].update(100.0 * m["top1"] / max(n, 1), n)
                meters["top5"].update(100.0 * m["top5"] / max(n, 1), n)

        epochs = ((self.source_loader.index_epoch(),
                   self.target_loader.index_epoch()) if self.device_store
                  else (self.source_loader.epoch(),
                        self.target_loader.epoch()))
        for i, (bs, bt) in enumerate(zip(*epochs)):
            p = progress(i, start_steps, total_steps)
            beta = effective_beta(tc.beta, p)
            meters["data_time"].update(time.time() - end)
            scalars = StepScalars(beta, tc.mu, alpha, tc.gamma,
                                  self.lr_current)
            if self.device_store:
                args = (self._dev_store_s, bs.abs_indices, bs.labels,
                        bs.mask, self._dev_store_t, bt.abs_indices,
                        bt.labels, bt.mask)
            else:
                args = (bs.features, bs.labels, bs.mask,
                        bt.features, bt.labels, bt.mask)
            self.state, m = self.train_step(self.state, *args, scalars,
                                            self.generator)
            if self.save_attention >= 0:
                # attention rows of the selected class (main.py:623-628)
                a_s = m.pop("attn_s").cpu().numpy()
                a_t = m.pop("attn_t").cpu().numpy()
                sel_s = (bs.labels == self.save_attention) & (bs.mask > 0)
                sel_t = (bt.labels == self.save_attention) & (bt.mask > 0)
                attn_src_epoch.append(a_s[sel_s])
                attn_tgt_epoch.append(a_t[sel_t])
            pending.append(m)

            meters["batch_time"].update(time.time() - end)
            end = time.time()

            if i % self.print_freq == 0:
                flush(keep_last=2)
                last_line = self._format_train_line(
                    epoch, i, len_loader, meters, alpha, beta, tc)
                if i % self.show_freq == 0:
                    print(last_line)
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
            batches = (self.val_loader.index_epoch() if self.device_store
                       else self.val_loader.epoch())
            for b in batches:
                if self.device_store:
                    r = self.eval_step(self._dev_store_v, b.abs_indices,
                                       b.labels, b.mask)
                else:
                    r = self.eval_step(b.features, b.labels, b.mask)
                loss, t1, t5, n = torch.stack(
                    [r["loss"], r["top1"], r["top5"], r["n"]]).cpu().tolist()
                meters["loss"].update(loss, n)
                meters["top1"].update(100.0 * t1 / max(n, 1), n)
                meters["top5"].update(100.0 * t5 / max(n, 1), n)
            top1, top5, loss = (meters["top1"].avg, meters["top5"].avg,
                                meters["loss"].avg)
        line = (f"Testing Results: Prec@1 {top1:.3f} Prec@5 {top5:.3f} "
                f"Loss {loss:.5f}")
        print(line)
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
            with _sigterm_as_interrupt():
                return self._fit()
        except BaseException:
            if self.save_model and self._last_epoch_done >= 1:
                self.save(self._last_epoch_done, self.best_prec1, False)
                print(f"emergency checkpoint saved at epoch "
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
                print(f"Best score {self.best_prec1} vs current score "
                      f"{prec1}{line_update}")
                if self.logs:
                    self.logs.write("val_short.log", "%.3f" % prec1)
                self.best_prec1 = max(prec1, self.best_prec1)
                if self.save_model:
                    self.save(epoch, prec1, is_best)
        if self.logs:
            self.logs.write_best(self.best_prec1)
        if self.save_attention >= 0 and self.attn_epoch_source:
            # attention-value dumps (main.py:304-306), under the
            # experiment dir
            np.savetxt(os.path.join(self.path_exp,
                                    f"attn_source_{self.save_attention}.log"),
                       np.stack(self.attn_epoch_source), fmt="%s")
            np.savetxt(os.path.join(self.path_exp,
                                    f"attn_target_{self.save_attention}.log"),
                       np.stack(self.attn_epoch_target), fmt="%s")
        return self.best_prec1
