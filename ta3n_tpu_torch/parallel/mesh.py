"""Data parallelism over cards: a 1-D grid of ranks or devices.

Port of `ta3n_tpu/parallel/mesh.py`.  The JAX package runs one global
program over a ``data`` mesh axis; the port runs one process per card
under ``torch.distributed`` and keeps the JAX package's contract: every
process holds the identical full global batch (the loaders and samplers
are seeded alike on every rank) and computes only the rows it owns, rank
r of W the rows ``[r * P / W, (r + 1) * P / W)`` of the padded global
batch of P rows.  A loader's batch is padded to a multiple of W with
masked rows (``pad_to_multiple``), as the JAX Trainer pads it.

Everything that couples the rows of a batch is computed over the GLOBAL
batch, so that W ranks take the one-card step on the global batch:

* the model runs on each rank's own rows; its outputs are gathered in
  rank order (``all_gather_rows``: each rank then holds the global batch's
  outputs) and every rank computes the same losses, metrics and top-k
  counts on them, the backward keeping the gradient of its own rows;
* BN statistics are sums over every rank's rows (``shard_sum``, whose
  consumers are each rank's own rows, so its backward sums the partial
  gradients too), and dropout masks are drawn at the global batch's shape
  from the generator every rank shares, each rank keeping its rows;
* the parameter gradients, each rank's share, are summed over the ranks
  in one flat ``all_reduce`` a step (``all_reduce_grads``), and the
  optimizer step, the same on every rank, leaves every rank's parameters
  bitwise equal.  No parameter is used after the gather, so none is
  counted twice.

A ``Mesh`` without a process group and with several devices is a single
process's grid for inference (`serve.py`, the eval CLI's
``--data_parallel``), one replica a device, as the JAX package's
single-controller serving.  Without a mesh, or on a mesh of one, every
helper here is the identity and launches nothing.

The 2-D grids (`make_mesh_2d`, and `train/ensemble.py::
make_ensemble_mesh`) lay the ranks out row-major over two axes, rank r
at ``(r // B, r % B)`` of an ``(A, B)`` grid, as the JAX package reshapes
its devices, and give each axis a subgroup: the ranks that differ only in
that axis's index (``dist.new_group``, made on every rank in one order).
A mesh's ``size``, ``rank`` and ``group`` are always its ``data`` axis's,
so every 1-D helper here splits and gathers rows over the data axis
alone; a data axis of one rank has no group, and the helpers are then
the identity.  The second axis is ``mesh.model`` (tensor parallelism:
`column_parallel`, the planned Linears of `parallel/tensor.py`) or
``mesh.member`` (ensemble members, which never communicate in a step).
With ``model_parallel=1`` `make_mesh_2d` is `make_mesh`.

Collectives used: ``all_reduce``, ``all_gather``, ``broadcast`` and
``barrier``, which NCCL and gloo both run on CUDA tensors.  The row and
column gathers and the BN sums carry vmap rules, so that an ensemble step
(``torch.func.vmap`` over stacked members, `train/ensemble.py`) runs them
once for all of a rank's members.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "Axis", "make_mesh", "make_mesh_2d", "process_grid",
           "pad_to_multiple", "lift_to_global", "shard_train_step",
           "all_gather_rows", "shard_sum", "all_reduce_grads",
           "all_reduce_tensors", "column_parallel", "gather_columns",
           "active"]


class Axis(NamedTuple):
    """One axis of a grid of ranks: its size, this rank's index on it and
    the subgroup of the ranks along it (None for an axis of one)."""

    size: int = 1
    rank: int = 0
    group: Any = None

    def __deepcopy__(self, memo):
        # a process group is a handle of the process, not copied with a
        # module that holds the axis
        return self


class Mesh:
    """A grid of ranks, or of one process's devices.

    Under a process group: the data axis has ``size`` ranks, this process
    at ``rank``, over ``group`` (None for a data axis of one rank of a 2-D
    grid), driving one device, ``devices[0]``; ``axes`` holds a second
    axis ("model" or "member") and ``process_rank`` is the process's rank
    in the whole group.  Without a group: a single process's grid of
    ``size = len(devices)`` devices, one replica a device (inference
    only)."""

    def __init__(self, devices: Sequence, rank: int = 0, group=None,
                 size: Optional[int] = None,
                 axes: Optional[Dict[str, Axis]] = None,
                 axis_names: Sequence[str] = ("data",),
                 process_rank: Optional[int] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = rank
        self.axes = dict(axes or {})
        self.axis_names = tuple(axis_names)
        if group is not None:
            if len(self.devices) != 1:
                raise ValueError("a rank of a process group drives one "
                                 f"device, got {len(self.devices)}")
            self.size = dist.get_world_size(group) if size is None else size
        else:
            self.size = len(self.devices)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.process_rank = rank if process_rank is None else process_rank

    @property
    def model(self) -> Axis:
        """The model axis (tensor parallelism); of size 1 on other
        grids."""
        return self.axes.get("model", Axis())

    @property
    def member(self) -> Axis:
        """The member axis of an ensemble grid; of size 1 on other
        grids."""
        return self.axes.get("member", Axis())

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device of a single process's
        grid)."""
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        """Whether the mesh is a process group's (of any size: a group of
        one runs the collectives too)."""
        return self.group is not None

    @property
    def is_primary(self) -> bool:
        """Whether this is the process of rank 0, the one that writes."""
        return self.process_rank == 0

    def rows(self, n: int, rank: Optional[int] = None) -> slice:
        """The rows of a batch of ``n`` that ``rank`` (this one by
        default) owns; ``n`` must divide by the mesh's size."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not divide over "
                             f"{self.size} ranks: pad it with masked rows "
                             "(pad_to_multiple)")
        per = n // self.size
        r = self.rank if rank is None else rank
        return slice(r * per, (r + 1) * per)

    def __repr__(self) -> str:
        if self.axes:
            shape = " x ".join(
                f"{n} {self.size if n == 'data' else self.axes[n].size}"
                for n in self.axis_names)
            return (f"Mesh({shape}, rank {self.process_rank}, "
                    f"{[str(d) for d in self.devices]})")
        kind = "ranks" if self.group is not None else "devices"
        return (f"Mesh({self.size} {kind}, rank {self.rank}, "
                f"{[str(d) for d in self.devices]})")


def active(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits a step over the ranks of a process group."""
    return mesh is not None and mesh.distributed


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D data mesh.  Under an initialised process group
    (`parallel/distributed.py`): every rank, this process on its current
    device (``devices``, if given, names that one device).  Otherwise a
    single process's grid over ``devices``, by default every visible
    card; without a card, CPU callers name their devices."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(_this_device(devices), dist.get_rank(),
                    dist.group.WORLD)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device is visible; "
                               "name the devices (make_mesh(['cpu']) for "
                               "the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def _this_device(devices):
    """The device of this rank of an initialised process group."""
    if devices is not None:
        return list(devices)
    return [torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" or torch.cuda.is_available()
            else torch.device("cpu")]


def process_grid(shape, axis_names: Sequence[str], devices=None) -> Mesh:
    """This rank's place in a 2-D ``shape`` = (A, B) grid of the
    initialised process group's ranks, rank r at (r // B, r % B), axes
    named ``axis_names`` (one of them "data").  Each axis of more than one
    rank gets its subgroups, made on every rank in one order: axis 0's
    groups are the ranks that share their axis-1 index, axis 1's those
    that share their axis-0 index."""
    a, b = shape
    world, r = dist.get_world_size(), dist.get_rank()
    if a * b != world:
        raise ValueError(f"a {a} x {b} grid of {world} ranks")
    groups = []
    for axis, (n, m) in enumerate(((a, b), (b, a))):
        mine = None
        if n > 1:
            for j in range(m):
                ranks = ([i * b + j for i in range(a)] if axis == 0 else
                         [j * b + i for i in range(b)])
                g = dist.new_group(ranks)
                if r in ranks:
                    mine = g
        groups.append(mine)
    index = (r // b, r % b)
    axes = {name: Axis(n, i, g) for name, n, i, g in
            zip(axis_names, shape, index, groups)}
    data = axes.pop("data")
    return Mesh(_this_device(devices), data.rank, data.group, data.size,
                axes=axes, axis_names=axis_names, process_rank=r)


def make_mesh_2d(devices=None, model_parallel: int = 1,
                 axis_names=("data", "model")) -> Mesh:
    """The (data x model) grid of tensor parallelism (`ta3n_tpu/parallel/
    mesh.py:56-72`): the process group's W ranks as W / M data rows of
    ``model_parallel`` = M ranks, rank r at (r // M, r % M).  The batch is
    split over the data axis; the ranks of a model group hold the same
    rows and one column slice each of the planned weights
    (`parallel/tensor.py`).  M = 1 is `make_mesh`."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh_2d: the grid is one process a device; "
                         "initialise the process group first "
                         "(parallel/distributed.py::initialize_multihost)")
    world = dist.get_world_size()
    if world % model_parallel != 0:
        raise ValueError(f"{world} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if model_parallel == 1:
        return make_mesh(devices)
    return process_grid((world // model_parallel, model_parallel),
                        axis_names, devices)


def pad_to_multiple(batch_size: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= batch_size (mask covers the
    rest)."""
    return -(-batch_size // n_devices) * n_devices


def lift_to_global(a, mesh: Optional[Mesh]):
    """This rank's rows of ``a``, a batch every rank holds in full (the
    multi-host batch contract; the counterpart of the JAX function, which
    makes the global array from each process's shards).  ``a`` unchanged
    without a process group."""
    if not active(mesh):
        return a
    return a[mesh.rows(len(a))]


def shard_train_step(train_step, mesh: Mesh):
    """A train step built without a mesh, built again over ``mesh``: the
    builders of `train/step.py` attach ``with_mesh``.  Prefer passing
    ``mesh=`` to the builder."""
    rebuild = getattr(train_step, "with_mesh", None)
    if rebuild is None:
        raise ValueError("train_step has no .with_mesh; build it with "
                         "make_train_step(..., mesh=mesh) instead")
    return rebuild(mesh)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _ShardSum(torch.autograd.Function):
    """all_reduce in the forward and in the backward: for a sum whose
    consumers are each rank's own rows (BN statistics), each rank holding
    a part of the gradient.  Under vmap one all-reduce sums every
    member's at once."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ShardSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _all_reduce(x, group), in_dims[0]


def shard_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of ``x`` over the ranks, for consumers that are each rank's own
    rows: the backward sums the ranks' partial gradients.  (Every
    consumer that all ranks compute alike sits after ``all_gather_rows``,
    whose backward keeps this rank's rows; an all-reduce whose backward
    summed again there would make a gradient W times too large.)  ``x``
    itself without a process group."""
    if not active(mesh):
        return x
    return _ShardSum.apply(x, mesh.group)


def _gather_blocks(xs, dims, size: int, group) -> tuple:
    """Every rank's block of each tensor, concatenated in rank order
    along its dim in ``dims``, in one all_gather of a flat buffer (float32
    over gloo, which holds bfloat16 values exactly; the tensors' own dtype
    over NCCL when they share one)."""
    dtype = xs[0].dtype
    if dist.get_backend(group) != "nccl" or any(x.dtype != dtype
                                                 for x in xs):
        dtype = torch.float32
    flat = torch.cat([x.detach().reshape(-1).to(dtype) for x in xs])
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    parts = [p.split([x.numel() for x in xs]) for p in parts]
    return tuple(
        torch.cat([p[i].reshape(x.shape) for p in parts], dim=d).to(x.dtype)
        for i, (x, d) in enumerate(zip(xs, dims)))


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of each tensor, concatenated in rank order along
    dim 0, in one collective; the backward keeps the gradient of this
    rank's rows.  Under vmap the member axis is moved first and the rows
    are gathered along dim 1, for every member in the one collective."""

    @staticmethod
    def forward(mesh, *xs):
        return _gather_blocks(xs, [0] * len(xs), mesh.size, mesh.group)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.mesh = inputs[0]
        ctx.meta = [(x.shape, x.dtype) for x in inputs[1:]]

    @staticmethod
    def backward(ctx, *grads):
        rank = ctx.mesh.rank
        out = []
        for g, (shape, dtype) in zip(grads, ctx.meta):
            n = shape[0]
            out.append(None if g is None else
                       g[rank * n:(rank + 1) * n].to(dtype))
        return (None, *out)

    @staticmethod
    def vmap(info, in_dims, mesh, *xs):
        xs = [x if d is None else x.movedim(d, 0)
              for x, d in zip(xs, in_dims[1:])]
        dims = [0 if d is None else 1 for d in in_dims[1:]]
        out = _gather_blocks(xs, dims, mesh.size, mesh.group)
        return out, tuple(None if d is None else 0 for d in in_dims[1:])


def all_gather_rows(tensors: Sequence[torch.Tensor],
                    mesh: Optional[Mesh]) -> tuple:
    """Every rank's rows of each tensor in ``tensors`` (batch-first, the
    same shapes on every rank), concatenated in rank order, so every rank
    holds the global batch's; one collective for them all.  The backward
    keeps the gradient of this rank's rows, for consumers that every rank
    computes alike.  The tensors unchanged without a process group."""
    tensors = tuple(tensors)
    if not active(mesh) or not tensors:
        return tensors
    return _GatherRows.apply(mesh, *tensors)


def all_reduce_tensors(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group``'s ranks, in place, in one flat
    ``all_reduce`` (one bucket, not a collective a tensor)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the parameters' gradients over the data axis's ranks in one
    flat ``all_reduce`` (one bucket, not a collective a parameter): the
    replicated parameters' and, on a model grid, this rank's weight
    slices' alike.  A parameter whose ``grad`` is None stays so (the same
    on every rank: every rank runs the same graph).  Nothing without a
    process group."""
    if not active(mesh):
        return
    all_reduce_tensors([p.grad for p in params if p.grad is not None],
                       mesh.group)


# ---- tensor parallelism: a column-parallel Linear over the model axis ----
#
# A planned Linear (`parallel/tensor.py`) holds rows [m * o, (m + 1) * o)
# of its torch weight [out, in], o = out / M, on model rank m: the columns
# of the JAX kernel [in, out] that ``P(None, "model")`` gives it.  Its
# forward is ``z_m = x @ W_mᵀ`` on this rank's columns, an all-gather of
# the M column blocks in rank order, then the replicated bias; its
# backward keeps this rank's columns of dz, so that autograd gives the
# slice's dW_m = dz_mᵀ x, and all-reduces the partial dx = dz_m W_m over
# the model group (not when x needs no gradient, as the first FC's
# features).  The ranks of a model group hold the same rows, and
# everything after the gather is computed alike on them, so their
# replicated parameters' gradients are equal.


class _GatherColumns(torch.autograd.Function):
    """The model group's column blocks of z, concatenated in rank order
    along the last dim; the backward keeps this rank's block."""

    @staticmethod
    def forward(z, axis):
        return _gather_blocks((z,), (z.dim() - 1,), axis.size,
                              axis.group)[0]

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.axis, ctx.width = inputs[1], inputs[0].shape[-1]

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis.rank * ctx.width
        return g[..., a:a + ctx.width].contiguous(), None


class _ReduceInputGrad(torch.autograd.Function):
    """The identity, whose backward sums the model group's partial
    input gradients."""

    @staticmethod
    def forward(x, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.axis.group), None


def gather_columns(z: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The model group's column blocks of ``z`` [..., o], in rank order:
    [..., M * o]; its backward keeps this rank's block."""
    return _GatherColumns.apply(z, axis)


def column_parallel(x: torch.Tensor, product, axis: Axis) -> torch.Tensor:
    """``product(x)``, this rank's columns of a Linear without its bias,
    gathered over the model axis ``axis`` into all of them; the gradient
    of ``x`` summed over the model group (skipped when ``x`` needs
    none)."""
    if x.requires_grad:
        x = _ReduceInputGrad.apply(x, axis)
    return gather_columns(product(x), axis)


def stacked_rows(a, mesh: Optional[Mesh]):
    """This rank's rows of each of the stacked batches ``a`` [K, B, ...]
    (axis 1), a numpy array or a tensor."""
    if not active(mesh):
        return a
    return a[:, mesh.rows(a.shape[1])]


def own_two_stream_rows(x: torch.Tensor, bs: int, bt: int, per: int,
                        mesh: Mesh) -> torch.Tensor:
    """This rank's rows of ``x``, rows of a global two-stream batch laid
    out as the model lays it out (the bs * W source videos, then the
    bt * W target videos, ``per`` rows a video): its source rows, then its
    target rows.  ``bs`` and ``bt`` are this rank's video counts."""
    w, r = mesh.size, mesh.rank
    src = x[r * bs * per:(r + 1) * bs * per]
    tgt_at = w * bs * per
    tgt = x[tgt_at + r * bt * per:tgt_at + (r + 1) * bt * per]
    return torch.cat([src, tgt])


def replicas(module, mesh: Mesh) -> list:
    """One copy of ``module`` on each device of a single process's grid
    (the module itself serves the first device)."""
    first = module.to(mesh.devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in mesh.devices[1:]]


def device_scope(device: torch.device):
    """``device`` made current for the duration (a card), or nothing (the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def split_rows(n: int, mesh: Mesh) -> list:
    """The row slices of a batch of ``n`` over a single process's grid,
    one a device, in device order."""
    return [mesh.rows(n, r) for r in range(mesh.size)]
