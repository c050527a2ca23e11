from dafne_torch.parallel.distributed import (
    is_main_process,
    local_batch_slice,
    local_device,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from dafne_torch.parallel.mesh import create_mesh, mesh_from_config

__all__ = [
    "create_mesh",
    "is_main_process",
    "local_batch_slice",
    "local_device",
    "maybe_initialize_distributed",
    "mesh_from_config",
    "process_count",
    "process_index",
]
