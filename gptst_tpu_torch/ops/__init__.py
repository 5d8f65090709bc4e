from gptst_tpu_torch.ops.graph_conv import (
    SparseSupport, graph_matmul, make_support, make_support_coo,
)

__all__ = ["SparseSupport", "graph_matmul", "make_support",
           "make_support_coo"]
