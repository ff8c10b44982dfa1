"""The data-parallel mesh (ducosy_tpu/parallel): ``mesh.py`` holds the mesh,
the row slices and the collectives, ``launch.py`` spawns one rank a device."""
from ducosy_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    all_reduce_mean,
    data_mesh,
    gather_batch,
    init_distributed,
    process_row_slice,
    replicate,
    shard_batch,
    world_size,
)
