"""The process group of a data-parallel run (port of
gdkvm_tpu/parallel/distributed.py on ``torch.distributed``).

The reference trains with PyTorch DDP over NCCL, one process per GPU,
launched by ``torchrun`` (SURVEY.md §2.4).  The port keeps that layout: one
process per device, each holding a replica of the parameters and its share
of the global batch; gradients and metrics are summed over the group by
``all_reduce``.

:func:`maybe_initialize_distributed` reads either launcher's environment:

- ``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT`` (rendezvous ``env://``);
- the JAX package's: ``GDKVM_COORDINATOR`` (host:port),
  ``GDKVM_NUM_PROCESSES``, ``GDKVM_PROCESS_ID`` (rendezvous
  ``tcp://host:port``; the local rank is ``LOCAL_RANK``, else the process
  id, one host).

``GDKVM_DIST_TIMEOUT`` (seconds, default 300) bounds the rendezvous and
every collective.  Without either environment it does nothing: a run of one
process needs no group.  The backend is ``nccl`` for a CUDA device and
``gloo`` for the CPU; nothing falls back: a failed init raises, and so does
a rank whose card is not there.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_DEVICE: List[Optional[torch.device]] = [None]     # the rank's device, set at init


def _env_spec() -> Optional[Tuple[str, int, int, int]]:
    """(init_method, world size, rank, local rank) from the environment, or
    None where no launcher set one; a launcher's set that is missing a
    variable raises, naming it."""
    env = os.environ
    gdkvm = ("GDKVM_COORDINATOR", "GDKVM_NUM_PROCESSES", "GDKVM_PROCESS_ID")
    torchrun = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    for names in (gdkvm, torchrun):
        present = [n for n in names if env.get(n)]
        if present and len(present) < len(names):
            missing = [n for n in names if n not in present]
            raise RuntimeError(
                f"distributed environment incomplete: {', '.join(present)} set, "
                f"{', '.join(missing)} unset")
    if env.get("GDKVM_COORDINATOR"):
        pid = int(env["GDKVM_PROCESS_ID"])
        return (f"tcp://{env['GDKVM_COORDINATOR']}", int(env["GDKVM_NUM_PROCESSES"]),
                pid, int(env.get("LOCAL_RANK", pid)))
    if env.get("RANK"):
        return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", "0")))
    return None


def rank_device(device: Optional[torch.device | str], local_rank: int) -> torch.device:
    """The device of rank ``local_rank`` on its host: ``device`` as given,
    but a CUDA device without an index (or None) is ``cuda:{local_rank}``.
    A CUDA device that is not there raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank device {device}: no CUDA device; pass "
                           f"device='cpu' to run the group on the CPU")
    if device.index is None:
        device = torch.device("cuda", local_rank)
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank device {device}: this host has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 device: Optional[torch.device | str] = None) -> bool:
    """Join the process group that the environment describes; True once
    the group exists, False (a no-op) when no launcher set the environment.

    ``device``: the rank's device (default ``cuda:{LOCAL_RANK}``; see
    :func:`rank_device`), made current on a card.  ``backend``: default
    ``nccl`` for a CUDA device and ``gloo`` for the CPU; ``gloo`` on a card
    runs ``all_reduce``, ``broadcast`` and ``barrier`` there and no other
    collective, which is all the port uses on device tensors.  An init
    that fails raises RuntimeError: it is never retried on another backend.
    """
    if dist.is_initialized():
        return True
    spec = _env_spec()
    if spec is None:
        return False
    init_method, world, rank_, local_rank = spec
    dev = rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=int(os.environ.get("GDKVM_DIST_TIMEOUT", "300")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, init_method=init_method, world_size=world,
              rank=rank_, timeout=timeout)
    if backend == "nccl":
        kw["device_id"] = dev
    try:
        dist.init_process_group(**kw)
    except Exception as exc:
        raise RuntimeError(
            f"torch.distributed initialization failed (backend {backend}, rank "
            f"{rank_} of {world}, {init_method}, device {dev}): {exc}") from exc
    _DEVICE[0] = dev
    return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE[0] = None


def device() -> Optional[torch.device]:
    """The rank's device chosen at init (None outside a process group)."""
    return _DEVICE[0] if dist.is_initialized() else None


def in_group() -> bool:
    """Whether this process is in a process group (of any size, one too)."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes a run's files."""
    return rank() == 0


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Align every rank at ``name``; a no-op outside a process group.  On
    ``gloo`` it is ``monitored_barrier``, which names a rank that did not
    arrive within ``timeout_ms``; on ``nccl`` a device barrier on the rank's
    card, bounded by the group's timeout."""
    if not dist.is_initialized():
        return
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=datetime.timedelta(milliseconds=timeout_ms))
        else:
            dev = device()
            dist.barrier(device_ids=[dev.index] if dev is not None and dev.type == "cuda"
                         else None)
    except Exception as exc:
        raise RuntimeError(f"barrier {name!r} failed on rank {rank()}: {exc}") from exc


def process_info() -> Dict[str, int]:
    """This process's place: its rank, the number of ranks, the devices it
    drives (one in a process group; the visible cards, or the CPU, alone)
    and the devices of the whole group."""
    if dist.is_initialized():
        return {"process_index": rank(), "process_count": world_size(),
                "local_devices": 1, "global_devices": world_size()}
    local = max(torch.cuda.device_count(), 1)
    return {"process_index": 0, "process_count": 1, "local_devices": local,
            "global_devices": local}


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` summed over the ranks, as new tensors: one ``all_reduce``
    of a flat buffer per dtype, in a group of one too.  Outside a process
    group, ``tensors``."""
    if not dist.is_initialized() or not tensors:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` averaged over the ranks (see :func:`all_reduce_sum`)."""
    if not dist.is_initialized():
        return list(tensors)
    return [t / world_size() for t in all_reduce_sum(tensors)]
