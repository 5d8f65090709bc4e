from gptst_tpu_torch.ops.graph_conv import (
    ShardedSupport, SparseSupport, graph_matmul, make_sharded_support,
    make_support, make_support_coo, use_sharding_mesh,
)

__all__ = ["ShardedSupport", "SparseSupport", "graph_matmul",
           "make_sharded_support", "make_support", "make_support_coo",
           "use_sharding_mesh"]
