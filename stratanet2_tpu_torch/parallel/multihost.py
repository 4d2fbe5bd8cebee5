"""Process-group start-up and per-host slices (counterpart of
`stratanet2_tpu/parallel/multihost.py`).

JAX joins hosts with `jax.distributed.initialize`; here each rank is one
process and `torch.distributed` joins them. `initialize` reads the rank and
the world size from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or from the JAX package's (JAX_NUM_PROCESSES,
JAX_PROCESS_ID, JAX_COORDINATOR_ADDRESS); explicit arguments win. One
process is a no-op.

The backend is always named by the caller: `nccl` for ranks on distinct
cards, `gloo` for the CPU or for ranks that share one card (NCCL refuses
two ranks on one card). The group's timeout is minutes, not gloo's 30, so
that a rank that raises does not leave its peers waiting for half an hour.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist

logger = logging.getLogger("stratanet2_tpu_torch")

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 600.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address:
        # file:// and tcp:// pass as they are; a bare host:port is TCP
        if "://" in coordinator_address:
            return coordinator_address
        return f"tcp://{coordinator_address}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    raise ValueError(
        "no rendezvous: pass coordinator_address or set MASTER_ADDR/MASTER_PORT "
        "(torchrun) or JAX_COORDINATOR_ADDRESS"
    )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size). With one process
    (no argument and no environment naming more) nothing is started and
    (0, 1) is returned. A group already started is returned as it is."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    n = num_processes if num_processes is not None else _env_int("WORLD_SIZE",
                                                                 "JAX_NUM_PROCESSES")
    if n is None or n <= 1:
        return 0, 1
    pid = process_id if process_id is not None else _env_int("RANK", "JAX_PROCESS_ID")
    if pid is None or not 0 <= pid < n:
        raise ValueError(f"process id {pid} out of range for {n} processes")
    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS} for {n} processes, got {backend!r}: "
            "nccl for ranks on distinct cards, gloo for the CPU or ranks sharing a card"
        )
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address), world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=timeout),
    )
    logger.info("multihost: rank %d/%d, backend %s", pid, n, backend)
    return pid, n


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return rank() == 0


def rank_device(device: Optional[Union[str, torch.device]] = None) -> Optional[torch.device]:
    """A rank's device: `device` as given, except a bare "cuda" in a group
    of several ranks, which is this rank's card `cuda:{LOCAL_RANK}`. Ranks
    that share one card are given it by index (e.g. "cuda:0")."""
    if device is None or world_size() == 1:
        return None if device is None else torch.device(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = _env_int("LOCAL_RANK")
        if local is None:
            raise ValueError("device 'cuda' with several ranks needs LOCAL_RANK, or an index")
        return torch.device("cuda", local)
    return dev


def broadcast_object(obj=None, src: int = 0):
    """`obj` of rank `src` on every rank (pickled; the identity alone)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def from_writer(read: Callable[[], Any]):
    """`read()` run on rank 0 alone, its result on every rank: files are
    read, as they are written, by rank 0 only, so the ranks need not share
    a filesystem."""
    return broadcast_object(read() if is_writer() else None)


def host_batch_slice(
    global_batch: int,
    process_id: Optional[int] = None,
    n_processes: Optional[int] = None,
) -> slice:
    """The contiguous slice of the global batch that process `process_id`
    of `n_processes` feeds (default: this rank of the group)."""
    n = world_size() if n_processes is None else n_processes
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % hosts {n} != 0")
    per = global_batch // n
    pid = rank() if process_id is None else process_id
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} out of range for {n} hosts")
    return slice(pid * per, (pid + 1) * per)
