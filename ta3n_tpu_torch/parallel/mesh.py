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

Collectives used: ``all_reduce``, ``all_gather``, ``broadcast`` and
``barrier``, which NCCL and gloo both run on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "pad_to_multiple",
           "lift_to_global", "shard_train_step", "all_gather_rows",
           "shard_sum", "all_reduce_grads", "active"]

_TWO_D = ("is not ported yet (ROADMAP.md queue 1, item 9: the 2-D grids, "
          "data x model and member x data)")


class Mesh:
    """A 1-D data grid.

    Under a process group (``group`` set): ``size`` ranks, this process
    rank ``rank``, driving one device, ``devices[0]``.  Without one: a
    single process's grid of ``size = len(devices)`` devices, one replica
    a device (inference only)."""

    def __init__(self, devices: Sequence, rank: int = 0, group=None,
                 size: Optional[int] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = rank
        if group is not None:
            if len(self.devices) != 1:
                raise ValueError("a rank of a process group drives one "
                                 f"device, got {len(self.devices)}")
            self.size = dist.get_world_size(group) if size is None else size
        else:
            self.size = len(self.devices)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")

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
        return self.rank == 0

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
        if devices is None:
            devices = [torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       or torch.cuda.is_available() else
                       torch.device("cpu")]
        return Mesh(devices, dist.get_rank(), dist.group.WORLD)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA device is visible; "
                               "name the devices (make_mesh(['cpu']) for "
                               "the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def make_mesh_2d(devices=None, model_parallel: int = 1,
                 axis_names=("data", "model")):
    """The JAX package's (data x model) mesh: not ported."""
    raise NotImplementedError(f"make_mesh_2d {_TWO_D}")


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


class _ShardSum(torch.autograd.Function):
    """all_reduce in the forward and in the backward: for a sum whose
    consumers are each rank's own rows (BN statistics), each rank holding
    a part of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


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


def _gather(flat: torch.Tensor, mesh: Mesh) -> list:
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(parts, flat.contiguous(), group=mesh.group)
    return parts


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of each tensor, concatenated in rank order along
    dim 0, in one collective (the tensors packed into one float32 buffer,
    which holds bfloat16 values exactly); the backward keeps the gradient
    of this rank's rows."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.meta = [(x.shape, x.dtype) for x in xs]
        flat = torch.cat([x.detach().reshape(-1).float() for x in xs])
        parts = [p.split([x.numel() for x in xs]) for p in _gather(flat,
                                                                   mesh)]
        return tuple(
            torch.cat([p[i].reshape(x.shape) for p in parts]).to(x.dtype)
            for i, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *grads):
        rank = ctx.mesh.rank
        out = []
        for g, (shape, dtype) in zip(grads, ctx.meta):
            n = shape[0]
            out.append(None if g is None else
                       g[rank * n:(rank + 1) * n].to(dtype))
        return (None, *out)


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


def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the parameters' gradients over the ranks in one flat
    ``all_reduce`` (one bucket, not a collective a parameter).  A
    parameter whose ``grad`` is None stays so (the same on every rank:
    every rank runs the same graph).  Nothing without a process group."""
    if not active(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


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
