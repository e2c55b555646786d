"""Multi-process and multi-host start-up.

Port of `ta3n_tpu/parallel/distributed.py`.  In the port a process drives
one card, so a "host" of the JAX package's functions is a rank here: the
process of one card, whichever machine it runs on.  Run the same command
on every machine under ``torchrun`` (which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``), or let the
train CLI's ``--num_devices`` start one process a card on one machine;
each then calls `initialize_multihost` before `parallel.make_mesh`.

Every rank holds the identical full global batch (seed-synchronised
loaders and samplers) and computes its own rows of it
(`parallel/mesh.py`); ``host_batch_slice`` gives a rank's row range for
callers that feed only their own rows.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "host_batch_slice", "is_primary_host",
           "default_backend", "process_count", "process_index"]

# a collective that waits longer than this for a peer (one that has left)
# raises instead of waiting forever
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> None:
    """``torch.distributed.init_process_group`` for this rank.

    ``coordinator_address`` ("host:port" of rank 0, or an init URL such
    as ``tcp://...`` or ``file://...``), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them.  Under NCCL
    the process's card is ``LOCAL_RANK`` (0 by default), made current
    first.  ``backend`` defaults to NCCL where a card is visible and gloo
    on the CPU; nothing falls back from one to the other."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator: pass coordinator_address or "
                             "set MASTER_ADDR and MASTER_PORT (torchrun "
                             "does)")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if backend is None:
        backend = default_backend(
            "cuda" if torch.cuda.is_available() else "cpu")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary_host() -> bool:
    """Whether this process is rank 0, the one that writes logs and
    checkpoints."""
    return process_index() == 0


def host_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, end) rows of the global batch this rank must feed.

    global_batch must divide evenly by the number of ranks (pad with
    masked rows via TSNLoader.pad_to otherwise).
    """
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes — pad with masked rows")
    per = global_batch // n
    start = process_index() * per
    return start, start + per
