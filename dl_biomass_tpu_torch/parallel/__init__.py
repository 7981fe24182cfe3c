from dl_biomass_tpu_torch.parallel.mesh import (data_parallel, init_from_env, make_mesh,
                                                mesh_shape, shard_batch, shard_points, spawn)

__all__ = ["make_mesh", "mesh_shape", "shard_batch", "shard_points", "data_parallel",
           "init_from_env", "spawn"]
