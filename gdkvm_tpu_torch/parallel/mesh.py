"""The device mesh of the port (port of gdkvm_tpu/parallel/mesh.py).

The JAX package lays a ``('data', 'model')`` mesh over its devices and
lets ``jit`` insert the collectives.  The port has no such compiler: a mesh
here is a record of the two axes and of this process's place on them, and
the code that runs over it does the splitting and the reductions itself.
Devices (or ranks) are laid out row-major, as JAX's
``np.asarray(devices).reshape(data, model)``: entry r sits at data position
r // model and model position r % model.

- In a distributed run (one process per device, parallel/distributed.py)
  the mesh spans every rank; this process holds one device, at data
  position ``index`` and model position ``model_index``.  Training and eval
  split every global batch over the data positions (:func:`batch_slice`)
  and sum over the rank's data group; with ``model`` > 1 each rank holds
  its model position's shard of the LKVA heads and sums the heads' partial
  outputs over its model group.
- In one process (serving) the mesh holds ``data × model`` devices, and
  the process drives them all: the serving engine keeps one group of slots
  on each row of ``model`` devices, its heads split over the row.

:func:`param_shardings` names the parameters that ``model`` > 1 shards (the
JAX package's rule, on the port's (out, in) ``Dense`` weights);
:func:`shard_state_dict` and :func:`gather_state_dicts` cut a state dict
into model positions and put it back together.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from gdkvm_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` mesh.  In one process ``devices`` holds all
    ``data × model`` devices, row-major; in a distributed run it holds this
    rank's one, which sits at data position ``index`` and model position
    ``model_index``."""
    data: int
    devices: Tuple[torch.device, ...]
    index: int = 0
    model: int = 1
    model_index: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def distributed(self) -> bool:
        return len(self.devices) < self.data * self.model

    @property
    def heads(self) -> Tuple[int, int]:
        """(model axis, model position): the head shard this rank holds."""
        return self.model, self.model_index

    @property
    def data_group(self) -> Any:
        """The ranks of this rank's model position; None where there is
        nothing to reduce over (one process, or a data axis of one)."""
        return distributed.mesh_groups(self.data, self.model)[0] if self.distributed else None

    @property
    def model_group(self) -> Any:
        """The ranks of this rank's data position; None where there is
        nothing to reduce over (one process, or a model axis of one)."""
        return distributed.mesh_groups(self.data, self.model)[1] if self.distributed else None

    def row(self, d: int) -> Tuple[torch.device, ...]:
        """The ``model`` devices of data position ``d`` (one process)."""
        return self.devices[d * self.model:(d + 1) * self.model]


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A ``('data', 'model')`` mesh; ``data=-1`` takes every device left.

    ``devices`` default: in a process group, one per rank (this process's
    own device at its rank); else every visible card (none raises: pass
    ``devices=[torch.device("cpu")] * (D * M)`` for a D × M mesh on the
    CPU; one device may stand more than once).  The JAX package's errors
    hold: ``model`` must divide the devices when ``data`` is -1, and ``data
    × model`` must not exceed them; a mesh over a process group must also
    span every rank, and making it makes the group's data and model groups
    (a collective call: every rank makes the same mesh)."""
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
    if group:
        if data * model != n:
            raise ValueError(f"mesh {data}x{model} must span the process group's "
                             f"{n} ranks")
        distributed.mesh_groups(data, model)      # every rank makes the groups
        dev = distributed.device() or torch.device("cpu")
        r = distributed.rank()
        return Mesh(data=data, devices=(dev,), index=r // model, model=model,
                    model_index=r % model)
    return Mesh(data=data, devices=tuple(devices[:data * model]), model=model)


def run_mesh(cfg, device: torch.device | str) -> Mesh:
    """The ``parallel.data_axis`` × ``parallel.model_axis`` mesh of a
    training or eval run of ``cfg`` (checked by
    ``config.schema.data_parallel_size``): over the process group's ranks,
    or over ``device`` alone in one process, where a model axis > 1 raises
    as the JAX package's ``make_mesh`` does on one device."""
    from gdkvm_tpu_torch.config.schema import data_parallel_size
    world = distributed.world_size()
    data_parallel_size(cfg, world)
    p = cfg.parallel
    return (make_mesh(p.data_axis, p.model_axis) if world > 1 else
            make_mesh(p.data_axis, p.model_axis, devices=[device]))


def process_mesh(device: torch.device | str) -> Mesh:
    """The data-only mesh of this process: every rank of the process group
    (one process outside one) a data position, ``device`` this rank's."""
    r = distributed.rank()
    return Mesh(data=distributed.world_size(), devices=(torch.device(device),), index=r)


def batch_slice(where: Mesh | int, b: int) -> slice:
    """The rows of a global batch of ``b`` that one position of the data
    axis owns: ``where`` is a Mesh (this process's data position on it) or
    the rank of a data-only process group.  Position p of D owns rows
    [p·b/D, (p+1)·b/D); ``b`` must split evenly.  The model positions of
    one data position share its rows."""
    if isinstance(where, Mesh):
        pos, parts = where.index, where.data
    else:
        pos, parts = where, distributed.world_size()
    if b % parts:
        raise ValueError(f"batch of {b} does not split over {parts} data positions")
    per = b // parts
    return slice(pos * per, (pos + 1) * per)


# The LKVA projections whose features are head-major (H·d), as the JAX
# package names them (its ``_MODEL_SHARDED_KERNELS``): the port's Dense
# weight is (out, in), so the output features of q/k/v/mask/gate are dim 0,
# and out_proj's input features dim 1.
_MODEL_SHARDED = re.compile(
    r"lkva\.(q_proj|k_proj|v_proj|gate_proj|mask_proj|out_proj)\.weight$")


def head_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` that holds head-major features (the
    one ``model`` > 1 shards), or None for a parameter that is replicated."""
    m = _MODEL_SHARDED.search(name)
    return None if m is None else (1 if m.group(1) == "out_proj" else 0)


def param_shardings(mesh: Mesh | int, state_dict: Mapping[str, torch.Tensor]
                    ) -> Dict[str, Optional[int]]:
    """{name: the dim sharded over ``model``, or None where replicated} for
    a whole model's ``state_dict`` (``mesh``: a Mesh, or its model axis).
    The JAX package's rule: with ``model`` > 1 the head-major dim of the
    LKVA q/k/v/mask/gate/out projections' weights, where it divides by
    ``model``; everything else (the biases, the β/α/η projections,
    ``o_norm``) is replicated."""
    model = mesh.model if isinstance(mesh, Mesh) else mesh
    out: Dict[str, Optional[int]] = {}
    for name, t in state_dict.items():
        dim = head_dim(name) if model > 1 and t.ndim == 2 else None
        out[name] = dim if dim is not None and t.shape[dim] % model == 0 else None
    return out


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], model: int,
                     position: int) -> Dict[str, torch.Tensor]:
    """Model position ``position``'s share of a whole model's state dict:
    each sharded entry's slice (:func:`param_shardings`), a copy; the
    replicated entries as they are."""
    dims = param_shardings(model, state_dict)
    return {name: (t if dims[name] is None else
                   t.chunk(model, dims[name])[position].contiguous())
            for name, t in state_dict.items()}


def gather_state_dicts(shards: Sequence[Mapping[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model position's (in order): the
    sharded entries concatenated, the replicated ones position 0's."""
    first = shards[0]
    out = {}
    for name, t in first.items():
        dim = head_dim(name) if len(shards) > 1 else None
        out[name] = t if dim is None else torch.cat([s[name] for s in shards], dim)
    return out


def gather_shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's shard along ``dim``,
    gathered over its model group: an ``all_reduce`` of the shard placed in
    zeros (exact; gloo carries no ``all_gather`` of CUDA tensors)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * mesh.model
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.model_index * n, n).copy_(t)
    return distributed.all_reduce_sum([full], mesh.model_group)[0]
