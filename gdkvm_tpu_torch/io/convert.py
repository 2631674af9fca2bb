"""Carry weights from the JAX package's flax param tree to the port.

The tree comes in as nested dicts of numpy arrays (``{"params": {...}}`` or
the inner dict), so this module needs no JAX.  Each flax leaf maps to one
parameter of ``GDKVM(cfg)``: the module path is kept (``/`` → ``.``), and
the layout changes as follows:

- conv ``kernel`` HWIO → ``weight`` OIHW;
- dense ``kernel`` (in, out) → ``weight`` (out, in);
- the KPFF block's bare kernels (``global_proj``, ``local_pw``,
  ``pixel_proj``, ``Conv_0``) stay ``kernel``, squeezed from (1, 1, in, out)
  to (in, out);
- ``bias`` and ``scale`` are copied.

The conversion is strict: a leaf that maps to no parameter, a parameter no
leaf fills, or a shape that differs raises, naming them.  ``heads=(M, m)``
then cuts model position m's share out of it (parallel/mesh.py's
``shard_state_dict``, the JAX package's ``param_shardings``), the state
dict of ``GDKVM(cfg, heads=(M, m))``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.parallel.mesh import shard_state_dict


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _convert_leaf(path: str, arr: np.ndarray, expected: Mapping[str, torch.Tensor]
                  ) -> Tuple[str, np.ndarray] | None:
    """(torch name, converted array) for one flax leaf, or None."""
    module, leaf = path.rsplit("/", 1) if "/" in path else ("", path)
    base = module.replace("/", ".")
    if leaf == "kernel":
        if f"{base}.kernel" in expected and arr.ndim == 4 and arr.shape[:2] == (1, 1):
            return f"{base}.kernel", arr[0, 0]
        if f"{base}.weight" in expected:
            if arr.ndim == 4:
                return f"{base}.weight", arr.transpose(3, 2, 0, 1)
            if arr.ndim == 2:
                return f"{base}.weight", arr.T
        return None
    if leaf in ("bias", "scale") and f"{base}.{leaf}" in expected:
        return f"{base}.{leaf}", arr
    return None


def state_dict_from_flax(params: Dict[str, dict | np.ndarray], cfg: ModelConfig,
                         heads: Tuple[int, int] = (1, 0)) -> Dict[str, torch.Tensor]:
    """A ``GDKVM(cfg, heads=heads)`` state dict (fp32, CPU) from the flax
    param tree."""
    tree = params["params"] if set(params) == {"params"} else params
    expected = GDKVM(cfg, device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    unused, bad_shape = [], []
    for path, arr in _flatten(tree):
        hit = _convert_leaf(path, arr, expected)
        if hit is None or hit[0] in out:
            unused.append(path)
            continue
        name, val = hit
        if tuple(val.shape) != tuple(expected[name].shape):
            bad_shape.append(f"{path} {arr.shape} → {name} "
                             f"{tuple(expected[name].shape)}")
            continue
        out[name] = torch.from_numpy(np.array(val, dtype=np.float32))
    missing = sorted(set(expected) - set(out))
    if unused or missing or bad_shape:
        raise ValueError(
            "flax params do not match GDKVM(cfg): "
            f"leaves not consumed {unused}; parameters not filled {missing}; "
            f"shapes that differ {bad_shape}")
    return shard_state_dict(out, *heads)
