"""The device mesh (ducosy_tpu/parallel): ``mesh.py`` holds the data and
(data, sp) meshes, the row slices and the collectives, ``spatial.py`` the
row bands of the ``sp`` axis, ``launch.py`` spawns one rank a mesh row."""
from ducosy_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SP_AXIS,
    all_reduce_mean,
    data_mesh,
    data_sp_mesh,
    gather_batch,
    init_distributed,
    mesh_shape,
    process_row_slice,
    replicate,
    shard_batch,
    world_size,
)
