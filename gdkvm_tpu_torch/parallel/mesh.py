"""The device mesh of the port (port of gdkvm_tpu/parallel/mesh.py).

The JAX package lays a ``('data', 'model')`` mesh over its devices and
lets ``jit`` insert the collectives.  The port has no such compiler: a mesh
here is a plain record of the ``data`` axis, and the code that runs over it
does the splitting and the reductions itself.

- In a distributed run (one process per device, parallel/distributed.py)
  ``data`` counts the ranks; this process holds one device, at position
  ``rank`` of the axis.  Training and eval split every global batch by
  :func:`batch_slice` and sum over the group.
- In one process (serving) ``data`` counts the devices it is given, and
  the process drives them all: the serving engine keeps one model replica
  and one group of slots on each.

``model`` > 1, which shards the LKVA heads in the JAX package
(``param_shardings``), is not ported and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from gdkvm_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def head_parallel_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the LKVA heads sharded over a 'model' axis are not ported "
        f"(ROADMAP Queue 1, item 7: head parallelism)")


@dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` mesh: ``data`` positions, of which this
    process drives ``devices`` from position ``index`` on (all of them in
    one process; its own one, at its rank, in a distributed run)."""
    data: int
    devices: Tuple[torch.device, ...]
    index: int = 0
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def distributed(self) -> bool:
        return len(self.devices) < self.data


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A ``('data', 'model')`` mesh; ``data=-1`` takes every device left.

    ``devices`` default: in a process group, one per rank (this process's
    own device at its rank); else every visible card (none raises: pass
    ``devices=[torch.device("cpu")] * D`` for D replicas on the CPU).  The
    JAX package's errors hold: ``model`` must divide the devices when
    ``data`` is -1, and ``data × model`` must not exceed them; a mesh over
    a process group must also span every rank."""
    group = devices is None and distributed.world_size() > 1
    if group:
        n = distributed.world_size()
    else:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: no CUDA device; pass devices= to "
                                   "lay the mesh over the CPU")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        n = len(devices)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if model != 1:
        raise head_parallel_error(f"make_mesh(model={model})")
    if group:
        if data != n:
            raise ValueError(f"mesh data={data} must span the process group's "
                             f"{n} ranks")
        dev = distributed.device() or torch.device("cpu")
        return Mesh(data=data, devices=(dev,), index=distributed.rank())
    return Mesh(data=data, devices=tuple(devices[:data]))


def batch_slice(where: Mesh | int, b: int) -> slice:
    """The rows of a global batch of ``b`` that one position of the data
    axis owns: ``where`` is a Mesh (this process's position on it) or a
    rank of the process group.  Position p of D owns rows [p·b/D,
    (p+1)·b/D); ``b`` must split evenly."""
    if isinstance(where, Mesh):
        pos, parts = where.index, where.data
    else:
        pos, parts = where, distributed.world_size()
    if b % parts:
        raise ValueError(f"batch of {b} does not split over {parts} data positions")
    per = b // parts
    return slice(pos * per, (pos + 1) * per)
