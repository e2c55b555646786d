from ta3n_tpu_torch.parallel.mesh import (Mesh, make_mesh, make_mesh_2d,
                                          pad_to_multiple, shard_train_step)

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "pad_to_multiple",
           "shard_train_step"]
