from gptst_tpu_torch.parallel.mesh import (
    DATA_AXIS, GRAPH_AXIS, Mesh, choose_mesh_shape, gather_rows, make_mesh,
    shard_rows,
)

__all__ = ["DATA_AXIS", "GRAPH_AXIS", "Mesh", "choose_mesh_shape",
           "gather_rows", "make_mesh", "shard_rows"]
