"""Ensembles: N independent runs advance in one step.

The counterpart of `ta3n_tpu/train/ensemble.py`, whose ``jax.vmap`` over
a member axis runs N members as one program.  Here the members' parameters
and buffers are stacked [N, ...] (``torch.func.stack_module_state``) and
one step is ``torch.func.vmap(torch.func.grad(...))`` over
``torch.func.functional_call`` of the solo step's forward and losses
(``make_train_step(...).loss_fn``), then one member-stacked optimizer step
(`train/optim.py::member_optimizer_step`).  Under the transform each of
the TRN and gather kernels launches once for all N members: their
autograd Functions carry vmap rules that call the member-batched kernels
(a member grid axis, `ops/trn_fused.py`, `ops/gather_gemm.py`), so an
N-member step launches K3 twice, K1 (train) once and K2 once, as a solo
step does.

Axes of variation per member, as in the JAX package:
  * the init and dropout seed: member k is initialised from
    ``torch.Generator().manual_seed(seeds[k])`` as the solo
    ``create_train_state`` does, and draws its dropout masks from its own
    generator (``ensemble_generators``, the counterpart of
    ``ensemble_keys``) in the solo order (`models/video_model.py::
    MemberGenerators`), so member k is the solo run seeded k: bitwise on
    the CPU;
  * every schedule scalar: ``StepScalars`` stacked [N, ...]
    (``stack_scalars``) give each member its own beta, mu, alpha, gamma
    and lr (``per_member_scalars``);
  * the data stream: ``per_member_data=True`` gives each member its own
    batches or index batches ([N, ...]); the default shares one stream.
    The feature stores are never stacked: one copy on the card serves
    every member.

At either compute dtype: under ``compute_dtype="bfloat16"`` each member
casts its float32 parameters to bfloat16 where the solo model does, the
bfloat16 kernels launch once for all members, and the optimizer updates
the float32 parameters, as a solo bfloat16 step does.

Over several cards (``mesh=``, the JAX package's ``_sharding_rules``):
a (member x data) grid (``make_ensemble_mesh``) gives each of its S
member shards, a row of ranks, N / S of the members, and each rank of a
shard its rows of the global batch, as a solo step's 1-D data grid does
(`parallel/mesh.py`):
the outputs and BN sums are gathered over the shard's data group and
the members' gradients summed over it in one all-reduce; members never
communicate.  A 1-D mesh shards the members alone over its ranks, with
no collective at all.  The steps take the state of this rank's members
(``member_rows``) and every per-member argument (scalars, generators,
per-member batches) for those members only; the batches' rows are the
global batch's, and the metrics this rank's members'.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad, stack_module_state, vmap

from ta3n_tpu_torch.config import DAConfig, TrainConfig
from ta3n_tpu_torch.models.layers import bf16_f32_reduction, no_cudnn_tf32
from ta3n_tpu_torch.models.video_model import MemberGenerators, VideoModel
from ta3n_tpu_torch.ops.gather_gemm import (RowIndex, gathered_linear,
                                            row_index, upload)
from ta3n_tpu_torch.parallel.mesh import (Axis, active, all_gather_rows,
                                          all_reduce_tensors, lift_to_global,
                                          process_grid)
from ta3n_tpu_torch.train.optim import (member_optimizer_state,
                                        member_optimizer_step,
                                        member_solo_optimizer)
from ta3n_tpu_torch.train.step import (_EVAL_BETA, StepScalars, TrainState,
                                       _as, _eval_gathered, _eval_metrics,
                                       _first_fc, _per_step, _stacked_parts,
                                       _store_part, _store_rows,
                                       make_train_step)

__all__ = ["EnsembleState", "ensemble_generators", "create_ensemble_state",
           "stack_scalars", "extract_member", "make_ensemble_step",
           "make_ensemble_multi_step", "make_ensemble_eval_step",
           "make_ensemble_mesh", "member_rows", "reached_parameters"]


class EnsembleState(NamedTuple):
    """N members' stacked state: ``model`` is a template `VideoModel`
    (member 0 as made, its own tensors unused by the steps), ``params`` and
    ``buffers`` every member's parameters and buffers by the model's names,
    stacked [N, ...], ``opt`` their optimizer state
    (`train/optim.py::member_optimizer_state`) and ``step`` the steps
    taken."""

    model: VideoModel
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt: dict
    step: int

    @property
    def members(self) -> int:
        return next(iter(self.params.values())).shape[0]


def make_ensemble_mesh(member_shards: int, devices=None):
    """The (member x data) grid of the initialised process group's ranks
    (`ta3n_tpu/train/ensemble.py:92-106`): ``member_shards`` shards of the
    members, each over W / member_shards ranks that split its batch,
    rank r at (r // (W / member_shards), r % (W / member_shards)).
    ``devices`` names this rank's device (default: its current one)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_ensemble_mesh: the grid is one process a "
                         "device; initialise the process group first "
                         "(parallel/distributed.py::initialize_multihost)")
    world = dist.get_world_size()
    if world % member_shards:
        raise ValueError(f"{world} devices not divisible by "
                         f"member_shards={member_shards}")
    return process_grid((member_shards, world // member_shards),
                        ("member", "data"), devices)


def _member_grid(mesh):
    """(the member axis, the data mesh or None) of an ensemble step's
    ``mesh``: a (member x data) grid's two axes; a 1-D mesh's ranks as
    the member axis, without a data axis (the JAX package's 1-D rule)."""
    if mesh is None:
        return Axis(), None
    if "member" in mesh.axis_names:
        return mesh.member, (mesh if active(mesh) else None)
    if mesh.group is None and mesh.size > 1:
        raise ValueError("the ensemble steps take a process group's grid "
                         "(make_ensemble_mesh or make_mesh under a group), "
                         "not a single process's devices")
    if mesh.model.size > 1:
        raise ValueError("the ensemble steps take a (member x data) grid "
                         "or a 1-D mesh, not a model axis")
    return Axis(mesh.size, mesh.rank, mesh.group), None


def member_rows(mesh, n: int) -> slice:
    """The members of N = ``n`` that this rank's shard of ``mesh``'s
    member axis holds (all of them without a mesh)."""
    axis, _ = _member_grid(mesh)
    if n % axis.size:
        raise ValueError(f"{n} members do not divide over {axis.size} "
                         "member shards: pad them (train/sweep.py::"
                         "pad_members)")
    per = n // axis.size
    return slice(axis.rank * per, (axis.rank + 1) * per)


def _own(a, data, dim: int):
    """This rank's rows of ``a`` (numpy or a tensor) along ``dim``: the
    batch's axis, after any member and step axes."""
    if data is None:
        return a
    return a[(slice(None),) * dim + (data.rows(a.shape[dim]),)]


def ensemble_generators(seeds: Sequence[int],
                        device="cuda") -> tuple:
    """Each member's dropout generator on ``device``, seeded as the solo
    Trainer seeds its own (``torch.Generator(device).manual_seed(seed)``),
    the counterpart of ``ensemble_keys``."""
    return tuple(torch.Generator(torch.device(device)).manual_seed(int(s))
                 for s in seeds)


def create_ensemble_state(cfg, train_cfg: TrainConfig, seeds: Sequence[int],
                          device="cuda") -> EnsembleState:
    """N members on ``device``, member k initialised from
    ``torch.Generator().manual_seed(seeds[k])`` as ``create_train_state``
    initialises a solo run, stacked, with fresh optimizer state and step
    0."""
    return stack_members(
        [VideoModel(cfg, torch.Generator().manual_seed(int(s)), device)
         for s in seeds], train_cfg)


def stack_members(models: Sequence[VideoModel], train_cfg: TrainConfig,
                  opt: Optional[dict] = None, step: int = 0
                  ) -> EnsembleState:
    """An ensemble of given solo models (their tensors copied), with fresh
    optimizer state unless ``opt`` is given."""
    params, buffers = stack_module_state(list(models))
    params = {k: v.detach() for k, v in params.items()}
    template = copy.deepcopy(models[0])
    return EnsembleState(template, params, buffers,
                         opt if opt is not None else
                         member_optimizer_state(params, train_cfg), step)


def stack_scalars(scalars_list: Sequence[StepScalars]) -> StepScalars:
    """Per-member ``StepScalars`` stacked into the [N, ...] layout the
    ensemble steps take (``per_member_scalars=True``), on the host (numpy
    float64, as the solo step's numbers): beta [N, 3], the others [N]."""
    return StepScalars(*(np.stack([np.asarray(f, np.float64) for f in fs])
                         for fs in zip(*scalars_list)))


def extract_member(state: EnsembleState, k: int,
                   train_cfg: TrainConfig) -> TrainState:
    """Member k as a solo ``TrainState``: a `VideoModel` holding its
    parameters and buffers and an optimizer holding its momentum buffers
    (or Adam moments and count), at the ensemble's step.  The Trainer,
    ``save_checkpoint``, the eval CLI and ``cli.serve`` take it as they
    take a solo run's."""
    model = copy.deepcopy(state.model)
    model.load_state_dict({**{n: t[k] for n, t in state.params.items()},
                           **{n: t[k] for n, t in state.buffers.items()}})
    return TrainState(model, member_solo_optimizer(model, state.opt, k,
                                                   train_cfg), state.step)


def reached_parameters(model: VideoModel, da: DAConfig,
                       train_cfg: TrainConfig, class_weights=None,
                       domain_weights=None) -> Dict[str, bool]:
    """Which parameters the train step's loss reaches: those that a solo
    step's backward gives a gradient (``grad`` not None), found once on a
    CPU copy of ``model`` from a batch of the configured sizes.  The
    graph, not the values, decides it, and it is the same every step."""
    cpu = copy.deepcopy(model).to("cpu")
    loss_fn = make_train_step(cpu, da, train_cfg, class_weights,
                              domain_weights).loss_fn
    cfg = cpu.cfg
    bs, bt = train_cfg.batch_size[0], train_cfg.batch_size[1]
    g = torch.Generator().manual_seed(0)

    def feats(b):
        return torch.randn((b, cfg.train_segments, cfg.input_feature_dim),
                           generator=g)

    pre = cpu.shared_pre(feats(bs), feats(bt))
    loss, _ = loss_fn(cpu, pre, torch.zeros(bs, dtype=torch.long),
                      torch.ones(bs), torch.zeros(bt, dtype=torch.long),
                      torch.ones(bt), StepScalars((1.0, 1.0, 1.0), 1.0,
                                                  1.0, 1.0, 0.0), g)
    names, params = zip(*cpu.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: gr is not None for n, gr in zip(names, grads)}


class _MemberLoss(nn.Module):
    """One member's first shared FC, forwards and losses, as ``forward``
    of a module holding the template model (``functional_call`` calls only
    ``forward``): from host features ``(xs, xt)`` or from store parts
    ``(part_s, part_t)``: this rank's rows over a data mesh."""

    def __init__(self, net: VideoModel, loss_fn, gather: bool):
        super().__init__()
        self.net = net
        self.loss_fn = loss_fn
        self.gather = gather

    def forward(self, data, ys, mask_s, yt, mask_t, scalars, generator):
        if self.gather:
            fcs = _first_fc(self.net, ("source", "target"))
            pre = gathered_linear(list(data), [w for w, _ in fcs],
                                  [b for _, b in fcs])
        else:
            pre = self.net.shared_pre(*data)
        return self.loss_fn(self.net, pre, ys, mask_s, yt, mask_t, scalars,
                            generator)


def _prefixed(state: EnsembleState) -> tuple:
    """The stacked parameters and buffers under the wrapper's names."""
    return ({f"net.{k}": v for k, v in state.params.items()},
            {f"net.{k}": v for k, v in state.buffers.items()})


def _scalar_tensors(scalars: StepScalars, n: int, device,
                    per_member: bool):
    """(the scalars the forward reads, as [N, ...] tensors or as numbers,
    and each member's lr as a number)."""
    if not per_member:
        return scalars, [float(scalars.lr)] * n
    t = StepScalars(*(torch.as_tensor(np.asarray(f, np.float32)).to(device)
                      for f in scalars))
    if t.lr.shape != (n,) or t.beta.shape != (n, 3):
        raise ValueError(f"per-member scalars are [{n}] ([{n}, 3] for "
                         f"beta), got lr {tuple(t.lr.shape)} and beta "
                         f"{tuple(t.beta.shape)}")
    return t, [float(lr) for lr in np.asarray(scalars.lr, np.float64)]


def make_ensemble_step(model: VideoModel, da: DAConfig,
                       train_cfg: TrainConfig, class_weights=None,
                       domain_weights=None, *,
                       gather_on_device: bool = False,
                       per_member_data: bool = False,
                       per_member_scalars: bool = True, mesh=None):
    """One optimizer step of every member (``model``: the state's
    template, on the members' device).

    Returned signature, that of ``make_train_step``'s step with the
    members' state and generators:
      step(state, xs, ys, mask_s, xt, yt, mask_t, scalars, generators)
        -> (state, metrics, each [N])
    or, with ``gather_on_device``,
      step(state, store_s, idx_s, ys, mask_s, store_t, idx_t, yt, mask_t,
           scalars, generators)
    The batches (features, labels, masks, index batches) carry a leading
    member axis [N, ...] iff ``per_member_data``; the stores never do.
    ``scalars`` is a `StepScalars` of [N]-long fields ([N, 3] beta,
    ``stack_scalars``) iff ``per_member_scalars``, else of numbers shared
    by every member.  ``generators``: ``ensemble_generators(seeds)``.
    The step updates the stacked parameters, buffers and optimizer state
    in place and returns the state with ``step + 1``.  The returned step
    carries ``parts_step`` (store parts already on the device) and
    ``reached`` (`reached_parameters`).

    ``mesh``: see the module docstring; ``state`` then holds this rank's
    members, and the per-member arguments are theirs."""
    _, data = _member_grid(mesh)
    loss_fn = make_train_step(model, da, train_cfg, class_weights,
                              domain_weights, mesh=data).loss_fn
    reached = reached_parameters(model, da, train_cfg, class_weights,
                                 domain_weights)
    wrapper = _MemberLoss(model, loss_fn, gather_on_device)
    d = 0 if per_member_data else None
    sc = 0 if per_member_scalars else None
    device = next(model.parameters()).device
    f32, i64 = torch.float32, torch.long

    def member_loss(params, buffers, member, data, ys, mask_s, yt, mask_t,
                    scalars, generators):
        loss, metrics = functional_call(
            wrapper, {**params, **buffers},
            (data, ys, mask_s, yt, mask_t, scalars,
             MemberGenerators(generators, member)))
        return loss, {k: v.detach().float() for k, v in metrics.items()}

    member_grad = grad(member_loss, has_aux=True)
    # the batched leaves of per-member store parts: the indices and scales
    part_dims = (None, RowIndex(0, None), 0)

    def run(state: EnsembleState, feed, ys, mask_s, yt, mask_t,
            scalars: StepScalars, generators):
        n = state.members
        if len(generators) != n:
            raise ValueError(f"{n} members need {n} generators, got "
                             f"{len(generators)}")
        forward_sc, lr = _scalar_tensors(scalars, n, device,
                                         per_member_scalars)
        params, buffers = _prefixed(state)
        data_dims = ((part_dims, part_dims) if gather_on_device and
                     per_member_data else d)
        vstep = vmap(member_grad,
                     in_dims=(0, 0, 0, data_dims, d, d, d, d, sc, None),
                     randomness="same")
        # TF32 off for the transform's backward: cudnn_f32 pins only the
        # forwards under a transform
        with bf16_f32_reduction(), no_cudnn_tf32():
            grads, metrics = vstep(params, buffers,
                                   torch.arange(n, device=device), feed,
                                   ys, mask_s, yt, mask_t, forward_sc,
                                   tuple(generators))
            if data is not None:
                all_reduce_tensors(list(grads.values()), data.group)
            member_optimizer_step(
                state.params, {k[4:]: g for k, g in grads.items()},
                state.opt, lr, train_cfg, reached)
        return state._replace(step=state.step + 1), metrics

    row_dim = 0 if d is None else 1

    def step(state, xs, ys, mask_s, xt, yt, mask_t, scalars, generators):
        return run(state, (_as(_own(xs, data, row_dim), device, f32),
                           _as(_own(xt, data, row_dim), device, f32)),
                   _as(ys, device, i64), _as(mask_s, device, f32),
                   _as(yt, device, i64), _as(mask_t, device, f32), scalars,
                   generators)

    def parts_step(state, part_s, ys, mask_s, part_t, yt, mask_t, scalars,
                   generators):
        """The device-store step from store parts whose indices, labels
        and masks are on the device already (the parts of this rank's rows
        over a data mesh, the labels and masks the global batch's)."""
        return run(state, (part_s, part_t), ys, mask_s, yt, mask_t, scalars,
                   generators)

    def gather_step(state, store_s, idx_s, ys, mask_s, store_t, idx_t, yt,
                    mask_t, scalars, generators):
        mask_s, mask_t = _as(mask_s, device, f32), _as(mask_t, device, f32)
        return parts_step(
            state, _member_part(store_s, _own(idx_s, data, row_dim),
                                _own(mask_s, data, row_dim), d),
            _as(ys, device, i64), mask_s,
            _member_part(store_t, _own(idx_t, data, row_dim),
                         _own(mask_t, data, row_dim), d),
            _as(yt, device, i64), mask_t, scalars, generators)

    built = gather_step if gather_on_device else step
    built.parts_step = parts_step
    built.reached = reached
    return built


def _member_part(store, idx, mask: torch.Tensor, member_dim) -> tuple:
    """(store, checked indices, per-row scale) of an index batch [B, T]
    (shared, ``_store_part``) or [N, B, T] (``member_dim`` 0: one per
    member; its indices and scales then [N, B*T])."""
    if member_dim is None:
        return _store_part(store, idx, mask)
    idx = np.asarray(idx)
    rows = _store_rows(store)
    checked = row_index(idx, rows.shape[0], rows.device)
    if idx.ndim != 3:
        raise ValueError(f"per-member index batches are [N, B, T], got "
                         f"{idx.shape}")
    n, _, t = idx.shape
    return (store, RowIndex(checked.rows.reshape(n, -1), checked.end),
            mask.repeat_interleave(t, dim=1))


def make_ensemble_multi_step(model: VideoModel, da: DAConfig,
                             train_cfg: TrainConfig, class_weights=None,
                             domain_weights=None, *,
                             per_member_data: bool = False,
                             per_member_scalars: bool = True, mesh=None):
    """K ensemble steps per call over stacked index batches into stores on
    the device (the JAX ``make_ensemble_multi_step``'s scan, a loop here):
      multi(state, store_s, idx_s, ys, mask_s, store_t, idx_t, yt, mask_t,
            scalars, generators) -> (state, metrics each [K, N])
    Per-step arguments are stacked [K, ...], the member axis after K when
    per member (idx [K, N, B, T], scalars' fields [K, N], beta [K, N, 3]);
    shared scalars are a `StepScalars` of K-long sequences.  The stacked
    indices are checked and uploaded once for the call, labels and masks
    likewise; the K steps are bitwise K single steps.  ``mesh`` as for
    ``make_ensemble_step``."""
    _, data = _member_grid(mesh)
    parts_step = make_ensemble_step(
        model, da, train_cfg, class_weights, domain_weights,
        gather_on_device=True, per_member_data=per_member_data,
        per_member_scalars=per_member_scalars, mesh=mesh).parts_step
    row_dim = 2 if per_member_data else 1
    device = next(model.parameters()).device

    def per_step(scalars, k):
        if per_member_scalars:
            return [StepScalars(*(np.asarray(f)[j] for f in scalars))
                    for j in range(k)]
        return _per_step(scalars)

    def multi(state, store_s, idx_s, ys, mask_s, store_t, idx_t, yt, mask_t,
              scalars, generators):
        streams = []
        for store, idx, y, mask in ((store_s, idx_s, ys, mask_s),
                                    (store_t, idx_t, yt, mask_t)):
            mask = upload(mask, torch.float32, device)
            own = _own(mask, data, row_dim)
            idx = _own(np.asarray(idx), data, row_dim)
            if per_member_data:
                # [K, N, B, T]: each step's [N, B*T] indices and scales
                idx = np.asarray(idx)
                rows = _store_rows(store)
                checked = row_index(idx, rows.shape[0], rows.device)
                scale = own.repeat_interleave(idx.shape[-1], dim=-1)
                parts = [(store, RowIndex(r.reshape(idx.shape[1], -1),
                                          checked.end), s)
                         for r, s in zip(checked.rows.reshape(
                             idx.shape[0], -1), scale)]
            else:
                parts = _stacked_parts(store, idx, own)
            streams.append((parts, upload(y, torch.long, device), mask))
        (parts_s, ys, mask_s), (parts_t, yt, mask_t) = streams
        steps = per_step(scalars, len(parts_s))
        if len(steps) != len(parts_s):
            raise ValueError(f"{len(parts_s)} stacked index batches for "
                             f"{len(steps)} steps")
        metrics = []
        for j, sc in enumerate(steps):
            state, m = parts_step(state, parts_s[j], ys[j], mask_s[j],
                                  parts_t[j], yt[j], mask_t[j], sc,
                                  generators)
            metrics.append(m)
        return state, {key: torch.stack([m[key] for m in metrics])
                       for key in metrics[0]}

    return multi


class _MemberEval(nn.Module):
    """One member's eval forward and metrics as ``forward`` of a module
    holding the template model: from features x, or from a store part,
    of this rank's rows over a data mesh (their logits and features then
    gathered)."""

    def __init__(self, net: VideoModel, class_weights, gather: bool,
                 mesh):
        super().__init__()
        self.net = net
        self.class_weights = class_weights
        self.gather = gather
        self.mesh = mesh

    def forward(self, data, y, mask):
        if self.gather:
            ranks = 1 if self.mesh is None else self.mesh.size
            out = _eval_gathered(self.net, data, mask.shape[0] // ranks)
        else:
            _, out = self.net(data[:0], data, _EVAL_BETA, 0.0, False, False)
        logits, feat = all_gather_rows(
            (out.out, out.feat[min(1, len(out.feat) - 1)]), self.mesh)
        logits, loss, top1, top5, n = _eval_metrics(logits, y, mask,
                                                    self.class_weights)
        return {"loss": loss.float(), "top1": top1, "top5": top5, "n": n,
                "logits": logits, "feat": feat}


def make_ensemble_eval_step(model: VideoModel, class_weights=None, *,
                            gather_on_device: bool = False, mesh=None):
    """Every member evaluates the same batch in one vmapped pass (K1
    (infer) and, from a store, K3 launched once for all members):
      ev(state, x, y, mask) or, with ``gather_on_device``,
      ev(state, store, idx [B, T], y, mask) -> metrics with a leading
      member axis [N, ...] (those of ``make_eval_step``).  ``mesh`` as
    for ``make_ensemble_step``: this rank's members, each rank of a shard
    running its rows of the batch."""
    _, data = _member_grid(mesh)
    device = next(model.parameters()).device
    if class_weights is not None:
        class_weights = _as(class_weights, device, torch.float32)
    wrapper = _MemberEval(model, class_weights, gather_on_device, data)

    def member_eval(params, buffers, data, y, mask):
        return functional_call(wrapper, {**params, **buffers},
                               (data, y, mask))

    veval = vmap(member_eval, in_dims=(0, 0, None, None, None))

    @torch.no_grad()
    @bf16_f32_reduction()
    def ev(state, x, y, mask):
        params, buffers = _prefixed(state)
        return veval(params, buffers,
                     _as(lift_to_global(x, data), device, torch.float32),
                     _as(y, device, torch.long),
                     _as(mask, device, torch.float32))

    @torch.no_grad()
    @bf16_f32_reduction()
    def ev_gather(state, store, idx, y, mask):
        mask = _as(mask, device, torch.float32)
        params, buffers = _prefixed(state)
        return veval(params, buffers,
                     _member_part(store, lift_to_global(idx, data),
                                  lift_to_global(mask, data), None),
                     _as(y, device, torch.long), mask)

    return ev_gather if gather_on_device else ev
