"""The sweep driver: a (seed x lr) member grid trained as one ensemble,
epoch after epoch, as ``ta3n_tpu_torch.train.sweep.run_sweep`` drives it.

Per epoch: one ``make_ensemble_multi_step(..., per_member_scalars=True)``
call over the epoch's ``spe`` stacked index batches from the loaders'
``index_epoch()`` (spe = min of the two training loaders' lengths) with
the per-member DANN-schedule scalars, then the validation of every member
on the val split through ``make_ensemble_eval_step`` (eval_freq 1, each
batch's hits fetched, the members' mean softmax voted), in run_sweep's
order.  Checkpoints are not written.  ``run_sweep`` cannot stop on a
clock, so this calls the same builders in the same order.

Set-up builds the one ensemble state, drives it from the seed through
epoch 1 (its first step, then steps 2-3, then the rest: the same call on
the same feed), and reads after step 1 the momentum buffers' norms,
after step 3 the parameters' change and the validation logits; the
window then runs the same object on.  The reference follows those first
three steps after the window (`check.py`).

After the window, more whole epochs run on the same state under the
profiler: with ``--trace 1``, ``trace_epochs`` of them in the full trace
of the per-layer metrics; else ``device_epochs`` with the device's
activity alone, whose busy time over their training steps is
``device_ms_per_step``.  The host paces these
cells, so the window's rate follows the host's speed; the device's time
of the same work does not.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch

from bench_port import check, inputs, manifest, trace as tracing
from bench_port.yardstick import window_flops

# members a block of the reference computes at once
_BLOCK = 16


def members(traffic: dict, lr0: float) -> list:
    """(seed index, lr) of each member: the seeds x learning rates grid,
    seeds outermost, as ``cli.sweep`` orders its product."""
    lrs = [lr0 * 2.0 ** k for k in traffic["lr_exponents"]]
    n = int(traffic["members"])
    if n % len(lrs):
        raise ValueError(f"{n} members do not fill a grid of {len(lrs)} "
                         "learning rates")
    return list(itertools.product(range(n // len(lrs)), lrs))


def port_configs(cfg: dict, traffic: dict):
    """The port's ModelConfig, DAConfig and TrainConfig of a
    configuration file."""
    from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
    model = ModelConfig(**{**cfg["model"],
                           "compute_dtype": traffic["compute_dtype"]})
    da = DAConfig(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in cfg["da"].items()})
    train = TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg["train"].items()})
    return model, da, train


class _Loaders:
    """The port's TSNLoaders over the benchmark's stores, as
    ``train.loop.build_loaders`` makes them (test-mode sampling, shuffled
    training streams seeded 1 and 2, the target repeated to the source's
    iteration count); the loaders read only the stores' layout."""

    def __init__(self, splits: dict, model, train):
        from ta3n_tpu_torch.data import FeatureStore, TSNLoader
        from ta3n_tpu_torch.data.manifest import epoch_balance_counts
        stores = {}
        for name, sp in splits.items():
            rows = np.broadcast_to(np.zeros((1, sp.rows.shape[1]),
                                            np.float32),
                                   (int(sp.offsets[-1]), sp.rows.shape[1]))
            stores[name] = FeatureStore(
                rows, sp.offsets, [f"{name}_{i:05d}" for i in
                                   range(len(sp.labels))], sp.labels)
        n_src, n_tgt = epoch_balance_counts(
            len(splits["source"].labels), len(splits["target"].labels),
            train.batch_size[0], train.batch_size[1], train.copy_list)
        kw = dict(num_segments=model.train_segments, new_length=1,
                  mode="test")
        self.source = TSNLoader(stores["source"], num_dataload=n_src,
                                batch_size=train.batch_size[0],
                                shuffle=True, seed=1, **kw)
        self.target = TSNLoader(stores["target"], num_dataload=n_tgt,
                                batch_size=train.batch_size[1],
                                shuffle=True, seed=2, **kw)
        self.val = TSNLoader(stores["val"], batch_size=train.batch_size[2],
                             shuffle=False, seed=3,
                             **{**kw, "num_segments": model.val_segments})
        self.spe = min(len(self.source), len(self.target))


class Sweep:
    """The program under test and its feed: the ensemble state, its
    multi-step and eval step, the members' generators, the loaders and
    the device stores."""

    def __init__(self, cell: dict, seed: int, device, log=print):
        from ta3n_tpu_torch.models.video_model import VideoModel
        from ta3n_tpu_torch.train.ensemble import (
            EnsembleState, ensemble_generators, make_ensemble_eval_step,
            make_ensemble_multi_step)
        from ta3n_tpu_torch.train.optim import member_optimizer_state
        cfg, traffic = cell["model"], cell["traffic"]
        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.model_cfg, self.da, self.train = port_configs(cfg, traffic)
        reference = manifest.reference(cfg["reference"])
        self.grid = members(traffic, self.train.lr)
        self.n = len(self.grid)
        seed_index = [s for s, _ in self.grid]
        self.splits = inputs.make_splits(
            seed, cfg["data"], self.model_cfg.num_class,
            self.model_cfg.input_feature_dim, self.device)
        self.loaders = _Loaders(self.splits, self.model_cfg, self.train)
        self.spe = self.loaders.spe
        params = inputs.make_weights(reference.param_specs(cfg["model"]),
                                     seed_index, seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"inputs made in {time.perf_counter() - t0:.2f} s")
        template = VideoModel(self.model_cfg, torch.Generator().manual_seed(0),
                              self.device)
        have = {k: tuple(v.shape) for k, v in template.named_parameters()}
        want = {k: tuple(v.shape[1:]) for k, v in params.items()}
        if have != want:
            raise ValueError(f"the reference's parameters {want} are not "
                             f"the program's {have}")
        self.state = EnsembleState(template, params, {},
                                   member_optimizer_state(params,
                                                          self.train), 0)
        self.multi = make_ensemble_multi_step(template, self.da, self.train,
                                              per_member_scalars=True)
        self.ev = make_ensemble_eval_step(template, gather_on_device=True)
        log(f"steps built in {time.perf_counter() - t0:.2f} s")
        self.generators = ensemble_generators(
            inputs.dropout_seeds(seed, seed_index), self.device)
        self.stores = {k: sp.rows for k, sp in self.splits.items()}
        self.total_steps = self.spe * self.train.epochs
        self.gstep = 0

    # ---- run_sweep's epoch, in its order ----
    def epoch_feed(self) -> tuple:
        """The next epoch's stacked index batches and per-member scalars
        [spe, N]."""
        from ta3n_tpu_torch.train.ensemble import stack_scalars
        from ta3n_tpu_torch.train.schedules import (dann_lr, effective_beta,
                                                    progress)
        from ta3n_tpu_torch.train.step import StepScalars
        b_s = list(itertools.islice(self.loaders.source.index_epoch(),
                                    self.spe))
        b_t = list(itertools.islice(self.loaders.target.index_epoch(),
                                    self.spe))
        decay = self.train.lr_adaptive == "dann"
        steps = []
        for i in range(self.spe):
            p = progress(self.gstep + i, 0, self.total_steps)
            beta = tuple(effective_beta(self.train.beta, p))
            steps.append(stack_scalars([
                StepScalars(beta, self.train.mu, self.train.alpha,
                            self.train.gamma, dann_lr(lr, p) if decay
                            else lr) for _, lr in self.grid]))
        sc = StepScalars(*(np.stack(f) for f in zip(*steps)))
        return b_s, b_t, sc

    def call(self, feed, part: slice = slice(None)) -> dict:
        """One multi-step call over ``part`` of an epoch's feed."""
        from ta3n_tpu_torch.train.step import StepScalars
        b_s, b_t, sc = feed
        b_s, b_t = b_s[part], b_t[part]
        sc = StepScalars(*(f[part] for f in sc))
        self.state, metrics = self.multi(
            self.state, self.stores["source"],
            np.stack([b.abs_indices for b in b_s]),
            np.stack([b.labels for b in b_s]),
            np.stack([b.mask for b in b_s]), self.stores["target"],
            np.stack([b.abs_indices for b in b_t]),
            np.stack([b.labels for b in b_t]),
            np.stack([b.mask for b in b_t]), sc, self.generators)
        self.gstep += len(b_s)
        return metrics

    def validate(self, keep_logits: bool = False):
        """Every member's hits on the val split, each batch's fetched, and
        the members' mean softmax voted, as run_sweep validates; with
        ``keep_logits`` the logits [N, rows, C] and the row mask."""
        hits = torch.zeros(self.n, dtype=torch.float64)
        count = torch.zeros(self.n, dtype=torch.float64)
        votes, logits, masks = 0.0, [], []
        for b in self.loaders.val.index_epoch():
            m = self.ev(self.state, self.stores["val"], b.abs_indices,
                        b.labels, b.mask)
            hits += m["top1"].cpu().double()
            count += m["n"].cpu().double()
            probs = torch.softmax(m["logits"].double(), -1).mean(0)
            pred = probs.cpu().numpy().argmax(-1)
            votes += float(((pred == b.labels) * b.mask).sum())
            if keep_logits:
                logits.append(m["logits"].cpu())
                masks.append(b.mask)
        if keep_logits:
            return torch.cat(logits, 1), np.concatenate(masks)
        return None

    def epoch(self, spans: Optional[dict] = None) -> tuple:
        """One epoch: the call over its steps, then the validation; the
        host time of each in ``spans``.  (the call's metrics, the real
        source videos of its batches, padding left out)"""
        feed = self.epoch_feed()
        videos = sum(int(b.mask.sum()) for b in feed[0])
        t0 = time.perf_counter()
        with tracing.span("train_call"):
            metrics = self.call(feed)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        with tracing.span("val"):
            self.validate()
        t3 = time.perf_counter()
        if spans is not None:
            spans.setdefault("step_enqueue", []).append((t1 - t0) / self.spe)
            spans.setdefault("val", []).append(t3 - t2)
        return metrics, videos


def _first_steps(sw: Sweep, k: int) -> dict:
    """Set-up's epoch 1: step 1, then steps 2..k, then the rest, with the
    program's readings of the first k steps: losses [k, N], the momentum
    buffers' norms after step 1, the change's norms after step k, the
    validation logits after step k."""
    feed = sw.epoch_feed()
    p0 = {n: v.clone() for n, v in sw.state.params.items()}
    losses = [sw.call(feed, slice(0, 1))["loss"]]
    first = check.leaf_norms(sw.state.opt.get("momentum_buffer", {}))
    if k > 1:
        losses.append(sw.call(feed, slice(1, k))["loss"])
    change = check.leaf_norms({n: sw.state.params[n] - p0[n] for n in p0})
    del p0
    logits, mask = sw.validate(keep_logits=True)
    sw.call(feed, slice(k, None))
    sw.validate()
    return {"losses": torch.cat(losses).cpu().double().numpy(),
            "first": first, "change": change,
            "val_logits": logits.double().numpy(), "val_mask": mask}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        started: float, log=print) -> dict:
    """One run of a sweep cell; see the module docstring.  ``started`` is
    the process's start on ``time.time()``'s clock."""
    traffic = cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    log(f"process up {time.time() - started:.2f} s")
    sw = Sweep(cell, seed, dev, log)
    k = int(traffic["check_steps"])
    prog = _first_steps(sw, k)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.time() - started
    log(f"set-up {setup_s:.2f} s: {sw.n} members, {sw.spe} steps an epoch")

    # the window: whole epochs while the clock allows
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    spans, losses = {}, []
    t0 = time.perf_counter()
    steps = epochs = videos = 0
    while True:
        metrics, real = sw.epoch(spans)
        losses.append(metrics["loss"])
        videos += real
        steps += sw.spe
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    log(f"window {window_s:.3f} s: {epochs} epochs, {steps} steps, "
        f"{videos} source videos a member")
    result = {"window_s": window_s, "steps": steps, "spans": spans,
              "end_to_end": {
                  "train_videos_per_s": videos * sw.n / window_s,
                  "setup_s": setup_s}}
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0)

    # whole epochs after the window, on the same state, under the profiler
    n_epochs = int(traffic["trace_epochs" if trace else "device_epochs"])

    def more_epochs():
        for _ in range(n_epochs):
            sw.epoch()

    if trace:
        result["trace"] = tracing.profile(more_epochs, sw.spe * n_epochs,
                                          cell["per_layer"], dev)
        result["trace"]["flops"] = window_flops(
            cell["model"]["model"], sw.train.batch_size, sw.spe * n_epochs,
            n_epochs * len(sw.loaders.val), sw.n)
    elif cuda:
        busy = tracing.device_time(more_epochs, dev)
        result["end_to_end"]["device_ms_per_step"] = \
            busy / (sw.spe * n_epochs) * 1e3
        log(f"device busy {busy:.4f} s over {n_epochs} epochs, "
            f"{sw.spe * n_epochs} steps")
    loss = torch.cat(losses)
    result["attempted"] = int(loss.numel())
    result["failed"] = int((~torch.isfinite(loss)).sum())
    result["flops"] = window_flops(cell["model"]["model"],
                                   sw.train.batch_size, steps,
                                   epochs * len(sw.loaders.val), sw.n)

    # the program's state freed before the reference runs
    names, n = [n for n, _ in sw.state.model.named_parameters()], sw.n
    del sw, loss, losses
    if cuda:
        torch.cuda.empty_cache()
    result["readings"], ref_s, _ = compare(cell, seed, prog, names, k, dev)
    log(f"reference: {ref_s:.1f} s over {n} members")
    return result


def _readings(out) -> dict:
    """A side's readings of its first steps, from the reference's run of
    one block of members."""
    return {"losses": out.losses.cpu().double().numpy(),
            "first": check.leaf_norms(out.first),
            "raw": check.leaf_norms(out.raw),
            "change": check.leaf_norms(out.change),
            "val_logits": out.val_logits.cpu().double().numpy()}


def compare(cell: dict, seed: int, prog, names: list, k: int, dev,
            control=None) -> tuple:
    """The reference over the first ``k`` steps, member block by member
    block, from the inputs of ``seed`` made anew, against the program's
    readings ``prog``, or, with ``prog`` None, against the reference
    computed through ``control`` (a product in another precision): the
    numbers of `check.py`, the seconds it took, and each gap's value for
    every member."""
    cfg = cell["model"]
    reference = manifest.reference(cfg["reference"])
    model, tc = cfg["model"], cfg["train"]
    grid = members(cell["traffic"], float(tc["lr"]))
    seed_index = [i for i, _ in grid]
    bs, bt, bv = tc["batch_size"]
    s = int(model["train_segments"])
    t0 = time.perf_counter()
    splits = inputs.make_splits(seed, cfg["data"], int(model["num_class"]),
                                int(model["feature_dim"]), dev)
    src, tgt, val = (splits[n] for n in ("source", "target", "val"))
    n_src, n_tgt = reference.epoch_counts(len(src.labels), len(tgt.labels),
                                          bs, bt, tc["copy_list"])
    spe = min(-(-n_src // bs), -(-n_tgt // bt))
    total = spe * int(tc["epochs"])
    train_b = list(zip(
        reference.batches(src.offsets, src.labels, n_src, bs, s, True, 1)[0],
        reference.batches(tgt.offsets, tgt.labels, n_tgt, bt, s, True, 2)[0]
    ))[:k]
    val_b = reference.batches(val.offsets, val.labels, len(val.labels), bv,
                              s, False, 3)[0]
    val_mask = np.concatenate([b.mask for b in val_b])
    stores = {n: sp.rows for n, sp in splits.items()}
    seeds = inputs.dropout_seeds(seed, seed_index)
    decay = tc["lr_adaptive"] == "dann"
    per_member = {n: [] for n in check.GAPS}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p0_all = inputs.make_weights(reference.param_specs(model),
                                     seed_index, seed, dev)
        for a in range(0, len(grid), _BLOCK):
            rows = slice(a, min(a + _BLOCK, len(grid)))
            p0 = {n: v[rows] for n, v in p0_all.items()}
            lrs = [[reference.dann_lr(lr, j / total) if decay else lr
                    for _, lr in grid[rows]] for j in range(k)]

            def side(mm):
                gens = [torch.Generator(dev).manual_seed(x)
                        for x in seeds[rows]]
                return _readings(reference.run_block(
                    p0, cfg, stores, train_b, val_b, lrs, gens, mm, dev))

            ref = side(torch.matmul)
            if prog is None:
                mine = side(control)
            else:
                mine = {"losses": prog["losses"][:, rows],
                        "first": {n: v[rows] for n, v in
                                  prog["first"].items()},
                        "change": {n: v[rows] for n, v in
                                   prog["change"].items()},
                        "val_logits": prog["val_logits"][rows]}
            g = check.gaps(mine, ref, names, val_mask)
            for n in check.GAPS:
                per_member[n].append(g[n])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    per_member = {n: np.concatenate(v) for n, v in per_member.items()}
    return (check.readings(per_member), time.perf_counter() - t0,
            per_member)
