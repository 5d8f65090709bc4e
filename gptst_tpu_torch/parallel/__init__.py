from gptst_tpu_torch.parallel.mesh import (
    DATA_AXIS, GRAPH_AXIS, Mesh, batch_pspec, batch_spec, choose_mesh_shape,
    gather_rows, make_mesh, param_pspec, shard_batch, shard_params,
    shard_rows,
)
from gptst_tpu_torch.parallel.spmd import (
    DataParallel, make_spmd_train_state, run_one_step,
)

__all__ = ["DATA_AXIS", "GRAPH_AXIS", "DataParallel", "Mesh", "batch_pspec",
           "batch_spec", "choose_mesh_shape", "gather_rows",
           "make_mesh", "make_spmd_train_state", "param_pspec",
           "run_one_step", "shard_batch", "shard_params", "shard_rows"]
