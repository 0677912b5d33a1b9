"""Processes and devices: the port of resnet_tpu.parallel.distributed.

One process drives one device (a rank). The ranks start under ``torchrun``
(which sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT) or are spawned by a caller that passes the same facts as
arguments, with a ``torch.distributed`` store of its own (a ``FileStore``,
as the tests and ``tools.distributed_worker`` use). The backend is always
the caller's choice: ``nccl`` where each rank has a GPU of its own (NCCL
refuses two ranks on one GPU), ``gloo`` on the CPU, or for ranks that share
one card. A backend that fails to start raises; nothing falls back to
another backend or to one process.

A host is one machine: JAX runs one process per host, the port one per
device, so JAX's "process" is the port's host (``host_count``,
``host_index``) and its local devices are the host's ranks
(``local_device_count``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    store: Optional[dist.Store] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the ranks of a run into the default process group; True if it
    did. ``num_processes`` and ``process_id`` default to torchrun's
    WORLD_SIZE and RANK. A no-op (False) for one process, as in the JAX
    package: ``num_processes`` of 1, or neither it nor WORLD_SIZE given.
    ``coordinator_address`` is an init method (``tcp://host:port``, or
    ``host:port``), else torchrun's ``env://``; ``store`` replaces both.
    ``timeout_s`` bounds each collective's wait (torch's default else)."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if num_processes is None or num_processes <= 1:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} of {num_processes} processes")
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: a process group is running already")
    if backend == "nccl":
        # before the group starts: NCCL binds each rank to its device
        torch.cuda.set_device(rank_device("nccl"))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        dist.init_process_group(backend, store=store, rank=process_id,
                                world_size=num_processes, **kw)
    else:
        method = coordinator_address or "env://"
        if "://" not in method:
            method = f"tcp://{method}"
        dist.init_process_group(backend, init_method=method, rank=process_id,
                                world_size=num_processes, **kw)
    return True


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count() -> int:
    """The ranks (one device each) of this host: torchrun's
    LOCAL_WORLD_SIZE, else the whole world (one host)."""
    return _env_int("LOCAL_WORLD_SIZE") or world_size()


def local_rank() -> int:
    """This rank's index among its host's ranks: torchrun's LOCAL_RANK, else
    the rank (one host)."""
    value = _env_int("LOCAL_RANK")
    return rank() if value is None else value


def host_count() -> int:
    """Hosts of the run: the world over each host's ranks."""
    n, local = world_size(), local_device_count()
    if n % local:
        raise ValueError(f"{n} ranks do not split into hosts of {local}")
    return n // local


def host_index() -> int:
    return rank() // local_device_count()


def host_batch_slice(global_batch_size: int) -> tuple:
    """(host_batch_size, host_index): this host's share of the global
    batch, for offsetting its stream (JAX's, with the port's hosts)."""
    n = host_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} hosts")
    return global_batch_size // n, host_index()


def rank_device(backend: str, device="cuda") -> torch.device:
    """The device this rank drives: ``cuda:<local rank>`` under NCCL, the
    device the caller names under gloo (the card unless the caller names
    the CPU). Raises where that device does not exist, and under NCCL for a
    device that is not a card."""
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError(f"backend 'nccl' drives a CUDA device, not {device!r}")
        dev = torch.device("cuda", local_rank())
    elif backend == "gloo":
        dev = torch.device(device)
    else:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = dev.index if dev.index is not None else 0
        if index >= count:
            raise RuntimeError(f"rank {rank()} maps to cuda:{index}, but this host has "
                               f"{count} CUDA device(s)")
    return dev
