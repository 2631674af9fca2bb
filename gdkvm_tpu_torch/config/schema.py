"""Model hyperparameters of the port.

The same fields and defaults as ``gdkvm_tpu.config.schema.ModelConfig``
(a test holds the two equal); this copy exists because the port must import
without JAX or yaml.  Run configs, data and training settings are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class ModelConfig:
    """GDKVM model hyperparameters (see gdkvm_tpu_torch/models/gdkvm.py)."""
    in_channels: int = 1
    num_classes: int = 2
    # Encoder: stem + stages at strides 4/8/16.
    enc_channels: Tuple[int, ...] = (32, 64, 96, 128)
    enc_blocks: Tuple[int, ...] = (1, 2, 2, 2)
    enc_stem: str = "s2d"              # "s2d" (4×4 space-to-depth) | "conv"
    # LKVA / GDR memory.
    num_heads: int = 4
    head_dim_k: int = 64
    head_dim_v: int = 64
    mem_stride: int = 16               # must be 16, the encoder's deepest stride
    # KPFF decoder widths from stride 16 downward (2 entries: sub-pixel head
    # at stride 8; 3 entries: head at stride 4).
    kpff_channels: Tuple[int, ...] = (96, 64, 48)
    # Numerics: params stay fp32, ops run in compute_dtype.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # GDR scan: "auto" (CUDA kernel for CUDA tensors, chunked for CPU
    # tensors) | "pallas" (force the kernel) | "chunked" | "ref".
    gdr_impl: str = "auto"
    gdr_variant: str = "gdn"           # only the coupled rule is ported
    quant: str = "none"                # quantized serving is not ported
