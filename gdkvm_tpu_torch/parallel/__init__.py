"""Data-parallel distribution: the process group, the device mesh and the
rank's share of a batch (port of gdkvm_tpu/parallel/)."""

from gdkvm_tpu_torch.parallel.distributed import (  # noqa: F401
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    is_main_process,
    maybe_initialize_distributed,
    process_info,
    rank,
    world_size,
)
from gdkvm_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh  # noqa: F401
