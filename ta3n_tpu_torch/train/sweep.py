"""Sweep runner: a (seed, lr, alpha) member grid trained as one ensemble
(`train/ensemble.py`) against real TSNLoader streams.

The counterpart of `ta3n_tpu/train/sweep.py`: the whole grid advances in
one K-step call per epoch (``make_ensemble_multi_step``, K the epoch's
steps) with per-member schedule scalars, validates through the ensemble
eval step, and writes each member as a solo checkpoint of the port's
format (``member_XX/checkpoint.pth.tar``, ``model_best.pth.tar``), which
the Trainer's ``--resume``, the eval CLI and ``cli.serve`` read; each
holds the member's dropout generator state, as the Trainer's do.

Data protocol: one shared stream for every member (the loaders' own
order), the members differing in init and dropout seed and in lr and
alpha: the classic controlled sweep.  The schedule follows the Trainer:
the DANN lr decay with ``dann_lr_decay`` and the DANN beta ramp for
negative beta entries (`train/schedules.py`).

Over several cards (``mesh=``: ``make_ensemble_mesh(S)`` or a 1-D mesh,
`train/ensemble.py`): the member list is padded to a multiple of the S
member shards with copies of member 0, whose results are dropped, each
shard trains its members, each of its ranks its rows of the batches, and
the members' rows, validation counts and ensemble votes are gathered
over the member axis.  Rank 0 receives every member's checkpoint and
writes the one-process sweep's directory; an emergency save (a failure
or a SIGTERM) needs no collective: each shard's first rank writes its
own members there.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ta3n_tpu_torch.io_utils.checkpoint import (BEST_NAME, CKPT_NAME,
                                                load_checkpoint,
                                                save_checkpoint)
from ta3n_tpu_torch.io_utils.convert import (export_reference_state,
                                             live_state)
from ta3n_tpu_torch.models.video_model import VideoModel
from ta3n_tpu_torch.train.ensemble import (_member_grid,
                                           create_ensemble_state,
                                           ensemble_generators,
                                           extract_member,
                                           make_ensemble_eval_step,
                                           make_ensemble_multi_step,
                                           member_rows, stack_members,
                                           stack_scalars)
from ta3n_tpu_torch.train.loop import _sigterm_as_interrupt
from ta3n_tpu_torch.train.optim import member_optimizer_state
from ta3n_tpu_torch.train.schedules import dann_lr, effective_beta, progress
from ta3n_tpu_torch.train.step import StepScalars

__all__ = ["run_sweep", "pad_members"]


def _member_dir(save_dir: str, k: int) -> str:
    return os.path.join(save_dir, f"member_{k:02d}")


def _restack_members(save_dir: str, n: int, n_padded: int, model_cfg,
                     train_cfg, device, rows: slice = slice(None)):
    """Inverse of the member saves: the member_XX/checkpoint.pth.tar
    states (e.g. a preempted sweep's emergency saves) stacked back into
    one ensemble of the padded list's members ``rows``; padded slots
    replay member 0.  Returns (state, the generators' states,
    start_epoch)."""
    payloads = [load_checkpoint(os.path.join(_member_dir(save_dir, k),
                                             CKPT_NAME)) for k in range(n)]
    epochs = {int(p["epoch"]) for p in payloads}
    if len(epochs) != 1:
        raise ValueError("member checkpoints disagree on epoch: "
                         f"{sorted(epochs)} — not one sweep's save set")
    idx = (list(range(n)) + [0] * (n_padded - n))[rows]
    models, opts = [], []
    for i in idx:
        model = VideoModel(model_cfg, torch.Generator().manual_seed(0),
                           device)
        model.load_state_dict(live_state(payloads[i]["state_dict"]))
        models.append(model)
        opts.append(payloads[i]["optimizer"]["state"])
    state = stack_members(models, train_cfg)
    state = state._replace(opt=_stack_opt(state, opts, train_cfg),
                           step=int(payloads[0].get("step", 0)))
    rng = [payloads[i]["rng_state"] for i in idx]
    return state, rng, epochs.pop() + 1


def _stack_opt(state, opts, train_cfg) -> dict:
    """The stacked optimizer state of the members' torch.optim state
    dicts' ``state`` (keyed by parameter index, in the model's parameter
    order)."""
    names = list(state.params)
    opt = member_optimizer_state(state.params, train_cfg)
    device = next(iter(state.params.values())).device
    for key in ("momentum_buffer", "exp_avg", "exp_avg_sq"):
        if key in opt:
            for i, name in enumerate(names):
                if all(i in o and key in o[i] for o in opts):
                    opt[key][name] = torch.stack(
                        [o[i][key] for o in opts]).to(device)
    if "step" in opt and opts[0]:
        opt["step"] = int(float(next(iter(opts[0].values()))["step"]))
    return opt


def _member_payload(state, generators, j: int, arch: str, epoch: int,
                    prec1: float, best_prec1: float, lr_current: float,
                    train_cfg) -> dict:
    """The state's member j as a solo checkpoint's payload (the
    Trainer's), its tensors on the CPU."""
    member = extract_member(state, j, train_cfg)

    def cpu(v):
        if torch.is_tensor(v):
            return v.cpu()
        if isinstance(v, dict):
            return {k: cpu(x) for k, x in v.items()}
        return v

    return cpu({
        "epoch": epoch, "arch": arch,
        "state_dict": {f"module.{key}": v for key, v in
                       export_reference_state(member.model).items()},
        "optimizer": member.optimizer.state_dict(),
        "best_prec1": float(best_prec1), "prec1": float(prec1),
        "lr_current": float(lr_current), "step": int(member.step),
        "rng_state": generators[j].get_state(),
    })


class _Shard:
    """This rank's members of a sweep's padded list of ``n_padded`` (all
    of them without a mesh), the first ``n`` of which are real, and the
    member axis they are gathered over."""

    def __init__(self, mesh, n: int, n_padded: int):
        self.axis, data = _member_grid(mesh)
        self.rows = member_rows(mesh, n_padded)
        self.n = n
        # whether this rank writes its members when no collective may run
        # (the first rank of its shard's data axis)
        self.leader = data is None or data.rank == 0
        self.primary = mesh is None or mesh.is_primary

    def real(self) -> list:
        """(global k, local j) of this rank's real members."""
        return [(k, k - self.rows.start)
                for k in range(self.rows.start, min(self.rows.stop,
                                                    self.n))]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's members' values [N_local, ...] as every member's
        [N, ...], gathered over the member axis."""
        if self.axis.size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.axis.size)]
        dist.all_gather(parts, t.contiguous(), group=self.axis.group)
        return torch.cat(parts)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the member axis's shards."""
        if self.axis.size > 1:
            t = t.clone()
            dist.all_reduce(t, group=self.axis.group)
        return t

    def write(self, payloads: dict, save_dir: str, is_best: bool = False,
              gather: bool = True) -> dict:
        """Each member k's payload in ``payloads`` (this rank's) written to
        member_XX/ (``is_best`` also to its model_best.pth.tar): gathered
        on rank 0 over the member axis, or with ``gather`` off written
        by each shard's first rank.  Returns {k: checkpoint path}."""
        if gather and self.axis.size > 1:
            every = [None] * self.axis.size
            dist.all_gather_object(every, payloads, group=self.axis.group)
            payloads = {k: p for part in every for k, p in part.items()}
        if not (self.primary if gather else self.leader):
            return {k: os.path.join(_member_dir(save_dir, k), CKPT_NAME)
                    for k in payloads}
        return {k: save_checkpoint(_member_dir(save_dir, k), p,
                                   is_best=is_best)
                for k, p in sorted(payloads.items())}


def _save_members(shard, state, generators, save_dir, arch, epoch, top1,
                  lrs, train_cfg, best=None, gather=True) -> list:
    """The real members as solo checkpoints; returns their paths.
    ``top1``, ``lrs`` and ``best`` (each member's running best top-1,
    recorded as best_prec1 like the Trainer's checkpoints; default its
    top1) are every member's."""
    payloads = {k: _member_payload(
        state, generators, j, arch, epoch, float(top1[k]),
        float(max(top1[k], best[k])) if best is not None else
        float(top1[k]), lrs[k], train_cfg) for k, j in shard.real()}
    paths = shard.write(payloads, save_dir, gather=gather)
    return [paths.get(k) for k in range(shard.n)]


def pad_members(members: Sequence[Tuple], member_shards: int,
                log=print) -> list:
    """Pad the member list to a multiple of the member axis' shards
    (duplicates of member 0, whose results are dropped).  One card has one
    shard, so nothing is padded there."""
    members = list(members)
    if member_shards > 1 and len(members) % member_shards:
        pad = -len(members) % member_shards
        log(f"# padded {len(members)} members to {len(members) + pad} "
            f"(member axis {member_shards})")
        members += members[:1] * pad
    return members


def run_sweep(model_cfg, da_cfg, train_cfg, source_loader, target_loader,
              val_loader, members: Sequence[Tuple[int, float, float]], *,
              dann_lr_decay: bool = False, mesh=None,
              class_weights=None, domain_weights=None,
              save_dir: Optional[str] = None, arch: str = "none",
              eval_freq: int = 0, resume: bool = False,
              store_dtype: Optional[str] = None, log=print,
              device="cuda") -> dict:
    """Train every (seed, lr, alpha) member on ``device`` and return
    {"results": [{member, seed, lr, alpha, top1, final_loss, checkpoint?,
    ...}, ...], "train_wall_s": float, "ensemble_top1": float or None}.

    ``train_cfg`` supplies the epochs, batch sizes, beta, gamma and mu; lr
    and alpha come per member.  Negative beta entries follow the DANN ramp
    as in the Trainer.  ``eval_freq`` > 0 validates every E epochs (the
    Trainer's -ef): rows then carry best_top1 and best_epoch and, with
    ``save_dir``, each member's best state lands in
    member_XX/model_best.pth.tar beside the final checkpoint.pth.tar;
    ``eval_freq`` 0 validates once, at the end.  ``resume`` restacks
    ``save_dir``'s member checkpoints and continues from their step
    counter (the loaders fast-forwarded, the generators restored), so a
    deterministic setup reproduces the uninterrupted run bitwise; the
    sweep's identity in save_dir/sweep_meta.json must match.  A SIGTERM or
    a failure after a finished epoch saves every member first.  The
    deep-ensemble top-1 averages the members' softmax (skipped for the
    frame and tsn baselines, whose eval rows are frames).  ``mesh``: the
    member axis over several ranks (the module docstring); every batch
    size must divide by its data axis, and rank 0 alone logs and returns
    the rows."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = len(members)
    axis, data = _member_grid(mesh)
    if data is not None:
        # all three batches split over the data axis: the train batches in
        # the multi-step, the val batch in the eval step
        for b in train_cfg.batch_size:
            if b % data.size:
                raise ValueError(f"batch size {b} not divisible by the "
                                 f"mesh's data axis ({data.size})")
    if mesh is not None and not mesh.is_primary:
        log = lambda *a: None  # noqa: E731 — rank 0 alone logs
    members = pad_members(members, axis.size, log=log)
    shard = _Shard(mesh, n, len(members))
    mine = members[shard.rows]
    seeds = [m[0] for m in mine]
    spe = min(len(source_loader), len(target_loader))
    best_top1 = np.full(len(members), -1.0)
    best_epoch = np.zeros(len(members), np.int64)

    # the sweep's identity, written at its start and checked on resume: a
    # resume under other members, epochs or batches would continue member
    # k's state under member j's schedule
    ident = {"members": [list(m) for m in members[:n]],
             "epochs": int(train_cfg.epochs), "spe": int(spe),
             "batch_size": [int(b) for b in train_cfg.batch_size]}
    meta_path = (os.path.join(save_dir, "sweep_meta.json")
                 if save_dir else None)

    generators = ensemble_generators(seeds, device)
    start_epoch = 1
    if resume:
        if not save_dir:
            raise ValueError("resume=True requires save_dir (the sweep's "
                             "member checkpoints live there)")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                prev = json.load(f)
            if prev != ident:
                raise ValueError(
                    "resume with a different sweep configuration: "
                    f"saved {prev} vs current {ident}")
        state, rng, start_epoch = _restack_members(
            save_dir, n, len(members), model_cfg, train_cfg, device,
            shard.rows)
        for gen, st in zip(generators, rng):
            gen.set_state(st)
        # the step counter is authoritative: an interrupt between an
        # epoch's call and its bookkeeping saves a state that holds epoch
        # E labelled E-1
        if state.step // spe != start_epoch - 1:
            log(f"# meta epoch {start_epoch - 1} != step-derived "
                f"{state.step // spe}; trusting the step counter")
            start_epoch = state.step // spe + 1
        # best tracking from the persisted model_best checkpoints, so a
        # best from before the preemption survives the resume
        for k in range(n):
            mb = os.path.join(_member_dir(save_dir, k), BEST_NAME)
            if os.path.exists(mb):
                payload = load_checkpoint(mb)
                best_top1[k] = float(payload.get("best_prec1", -1.0))
                best_epoch[k] = int(payload.get("epoch", 0))
        log(f"# resumed sweep from {save_dir} at epoch {start_epoch}")
    else:
        state = create_ensemble_state(model_cfg, train_cfg, seeds, device)
        if meta_path and shard.primary:
            os.makedirs(save_dir, exist_ok=True)
            with open(meta_path, "w") as f:
                json.dump(ident, f)
    multi = make_ensemble_multi_step(state.model, da_cfg, train_cfg,
                                     class_weights, domain_weights,
                                     mesh=mesh)
    total_steps = spe * train_cfg.epochs
    uploaded = {}

    def put(store):
        # --store_dtype as in the Trainer: one copy serves every member
        if id(store) not in uploaded:
            uploaded[id(store)] = store.to_device(device, store_dtype)
        return uploaded[id(store)]

    store_s = put(source_loader.store)
    store_t = put(target_loader.store)
    _ev = {}

    def validate():
        """Every member's top-1 on the val split, and the deep-ensemble
        top-1 over the real members (None for frame-level rows).  The eval
        step and the val store are made at the first validation."""
        if not _ev:
            _ev["step"] = make_ensemble_eval_step(
                state.model, class_weights, gather_on_device=True,
                mesh=mesh)
            _ev["store"] = put(val_loader.store)
        ev, store_v = _ev["step"], _ev["store"]
        hits = torch.zeros(len(mine), dtype=torch.float64)
        count = torch.zeros(len(mine), dtype=torch.float64)
        real = [j for _, j in shard.real()]
        ens_hits, ens_count = 0.0, 0.0
        for b in val_loader.index_epoch():
            m = ev(state, store_v, b.abs_indices, b.labels, b.mask)
            hits += m["top1"].cpu().double()
            count += m["n"].cpu().double()
            logits = m["logits"][real].double()
            if logits.shape[1] == len(b.labels):
                # the real members' mean softmax, summed over the shards
                probs = shard.sum(torch.softmax(logits, -1).sum(0)) / n
                pred = probs.cpu().numpy().argmax(-1)
                mask = np.asarray(b.mask)
                ens_hits += float(((pred == b.labels) * mask).sum())
                ens_count += float(mask.sum())
        hits, count = (shard.gather(t.to(device)).cpu().numpy()
                       for t in (hits, count))
        top1 = 100.0 * hits / np.maximum(count, 1)
        ens = (round(100.0 * ens_hits / ens_count, 2)
               if ens_count else None)
        return top1, ens

    if start_epoch > train_cfg.epochs:
        raise ValueError(f"nothing to resume: checkpoints are at epoch "
                         f"{start_epoch - 1} of {train_cfg.epochs}")
    t0 = time.time()
    gstep = (start_epoch - 1) * spe
    # fast-forward the shared streams past the finished epochs
    for _ in range(start_epoch - 1):
        list(itertools.islice(source_loader.index_epoch(), spe))
        list(itertools.islice(target_loader.index_epoch(), spe))
    epochs_done = start_epoch - 1
    lrs = [lr for _, lr, _ in members]
    final_scores = None
    try:
        with _sigterm_as_interrupt():
            for epoch in range(start_epoch, train_cfg.epochs + 1):
                # one call an epoch: spe stacked index batches of the
                # shared stream and per-member scalars [spe, N]
                b_s = list(itertools.islice(source_loader.index_epoch(),
                                            spe))
                b_t = list(itertools.islice(target_loader.index_epoch(),
                                            spe))
                steps = []
                for i in range(spe):
                    p = progress(gstep + i, 0, total_steps)
                    beta = tuple(effective_beta(train_cfg.beta, p))
                    lrs = [dann_lr(lr, p) if dann_lr_decay else lr
                           for _, lr, _ in members]
                    steps.append(stack_scalars([
                        StepScalars(beta, train_cfg.mu, alpha,
                                    train_cfg.gamma, lr_k)
                        for (_, _, alpha), lr_k in zip(
                            mine, lrs[shard.rows])]))
                sc = StepScalars(*(np.stack(f) for f in zip(*steps)))
                state, metrics = multi(
                    state, store_s,
                    np.stack([b.abs_indices for b in b_s]),
                    np.stack([b.labels for b in b_s]),
                    np.stack([b.mask for b in b_s]), store_t,
                    np.stack([b.abs_indices for b in b_t]),
                    np.stack([b.labels for b in b_t]),
                    np.stack([b.mask for b in b_t]), sc, generators)
                gstep += spe
                epochs_done = epoch
                if eval_freq and (epoch % eval_freq == 0
                                  or epoch == train_cfg.epochs):
                    # the Trainer's -ef: each member's best epoch, saved
                    # to member_XX/model_best at once, so that it
                    # survives a preemption and seeds a resume
                    top1_e, ens_e = validate()
                    improved = [k for k in range(n)
                                if top1_e[k] > best_top1[k]]
                    for k in improved:
                        best_top1[k] = top1_e[k]
                        best_epoch[k] = epoch
                    if save_dir:
                        shard.write({k: _member_payload(
                            state, generators, j, arch, epoch,
                            float(top1_e[k]), float(best_top1[k]), lrs[k],
                            train_cfg) for k, j in shard.real()
                            if k in improved}, save_dir, is_best=True)
                    if epoch == train_cfg.epochs:
                        final_scores = (top1_e, ens_e)
            # the last step's losses (one fetch; the calls above only
            # enqueue work on the card, so the wait is here, inside the
            # protected region)
            final_loss = shard.gather(metrics["loss"][-1]).cpu().numpy()
            train_s = time.time() - t0
            if final_scores is None:
                final_scores = validate()
    except BaseException:
        # preemption or a crash mid-sweep (or mid-eval): every member's
        # resumable state is saved before re-raising, as the Trainer's
        # emergency checkpoint
        if save_dir and epochs_done >= 1:
            _save_members(shard, state, generators, save_dir, arch,
                          epochs_done, np.full(n, -1.0), lrs, train_cfg,
                          best=best_top1[:n] if eval_freq else None,
                          gather=False)
            log(f"emergency sweep checkpoints saved at epoch "
                f"{epochs_done} -> {save_dir}")
        raise
    top1, ensemble_top1 = final_scores
    paths = (_save_members(shard, state, generators, save_dir, arch,
                           train_cfg.epochs, top1, lrs, train_cfg,
                           best=best_top1[:n] if eval_freq else None)
             if save_dir else None)
    results = []
    for k, (seed, lr, alpha) in enumerate(members[:n]):
        finite = bool(np.isfinite(final_loss[k]))
        row = {"member": k, "seed": seed, "lr": lr, "alpha": alpha,
               "top1": round(float(top1[k]), 2),
               # JSON null for a non-finite loss: a bare NaN is not JSON
               "final_loss": (round(float(final_loss[k]), 4)
                              if finite else None)}
        if eval_freq:
            row["best_top1"] = round(float(best_top1[k]), 2)
            row["best_epoch"] = int(best_epoch[k])
            mb = os.path.join(_member_dir(save_dir or "", k), BEST_NAME)
            if save_dir and os.path.isfile(mb):
                row["best_checkpoint"] = mb
        if not finite:
            row["diverged"] = True
            log(f"# member {k} (seed {seed}, lr {lr}, alpha {alpha}) "
                f"diverged: final loss {final_loss[k]}")
        if paths:
            row["checkpoint"] = paths[k]
        results.append(row)
    if save_dir and shard.primary:
        with open(os.path.join(save_dir, "sweep.json"), "w") as f:
            json.dump(results, f, indent=1)
        log(f"# saved {n} member checkpoints -> {save_dir}")
    return {"results": results, "train_wall_s": round(train_s, 1),
            "ensemble_top1": ensemble_top1}
