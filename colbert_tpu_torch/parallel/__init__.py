from colbert_tpu_torch.parallel.mesh import (
    AXES, Mesh, MeshAxes, device_mesh, init_distributed, local_shard_bounds, make_mesh, pad_to_multiple,
)

__all__ = ["AXES", "Mesh", "MeshAxes", "device_mesh", "init_distributed", "local_shard_bounds", "make_mesh",
           "pad_to_multiple"]
