"""The process group of a distributed run (port of
gdkvm_tpu/parallel/distributed.py on ``torch.distributed``).

The reference trains with PyTorch DDP over NCCL, one process per GPU,
launched by ``torchrun`` (SURVEY.md §2.4).  The port keeps that layout: one
process per device.  Over a ``data`` × ``model`` mesh (parallel/mesh.py)
each rank holds its model position's head shard of the parameters and its
data position's share of the global batch; gradients and metrics are
summed by ``all_reduce`` over the rank's data group (the ranks of its model
position) and, where a head shard needs it, over its model group (the
ranks of its data position).  :func:`mesh_groups` makes both kinds;
:func:`model_copy` and :func:`model_sum` are the model group's two
collectives inside the forward, with their gradients.

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
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_DEVICE: List[Optional[torch.device]] = [None]     # the rank's device, set at init
# (data, model) → (data group of each model position, model group of each
# data position), made once per process group (see mesh_groups).
_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


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
    _GROUPS.clear()


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


def mesh_groups(data: int, model: int) -> Tuple[Any, Any]:
    """This rank's (data group, model group) on a ``data`` × ``model`` mesh
    of the whole group, ranks laid out row-major: rank r sits at data
    position r // model and model position r % model.  Its data group holds
    the ranks of its model position (r % model, + model, ...), its model
    group those of its data position.  An axis of one has no group (None:
    nothing to reduce over it); a group that spans the world is
    ``dist.group.WORLD``; the others are made by ``dist.new_group``, every
    one on every rank in the same order (a collective call), once per mesh
    shape.  Outside a process group: (None, None)."""
    if not dist.is_initialized():
        return None, None
    world = world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} must span the process group's "
                         f"{world} ranks")
    if (data, model) not in _GROUPS:
        whole = dist.group.WORLD
        data_groups = ([None] * model if data == 1 else [whole] if model == 1 else
                       [dist.new_group(list(range(m, world, model))) for m in range(model)])
        model_groups = ([None] * data if model == 1 else [whole] if data == 1 else
                        [dist.new_group(list(range(d * model, (d + 1) * model)))
                         for d in range(data)])
        _GROUPS[(data, model)] = (data_groups, model_groups)
    data_groups, model_groups = _GROUPS[(data, model)]
    r = rank()
    return data_groups[r % model % len(data_groups)], model_groups[r // model % len(model_groups)]


def all_reduce_sum(tensors: List[torch.Tensor], group: Any = None) -> List[torch.Tensor]:
    """``tensors`` summed over ``group`` (default: every rank), as new
    tensors: one ``all_reduce`` of a flat buffer per dtype, in a group of
    one too.  Outside a process group, ``tensors``."""
    if not dist.is_initialized() or not tensors:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_reduce_mean(tensors: List[torch.Tensor], group: Any = None) -> List[torch.Tensor]:
    """``tensors`` averaged over ``group`` (see :func:`all_reduce_sum`)."""
    if not dist.is_initialized():
        return list(tensors)
    n = dist.get_world_size(group)
    return [t / n for t in all_reduce_sum(tensors, group)]


def _sum_fp32(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` summed over ``group`` in fp32 (gloo has no bf16 sum), in x's
    dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _ModelSum(torch.autograd.Function):
    """The model group's sum of the heads' partial ``out_proj`` outputs:
    ``all_reduce`` forward; backward the identity (every position's partial
    output feeds the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelCopy(torch.autograd.Function):
    """The entry into the head-parallel region: the identity forward (every
    position reads the same features); backward the sum of the positions'
    gradients, each of which covers its own heads only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_fp32(grad, ctx.group), None


def model_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` summed over the model group ``group`` (fp32 sum, x's dtype),
    with the gradient passed through unchanged."""
    return _ModelSum.apply(x, group)


def model_copy(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the model group ``group``."""
    return _ModelCopy.apply(x, group)
