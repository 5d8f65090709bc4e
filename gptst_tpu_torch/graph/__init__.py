from gptst_tpu_torch.graph.artifacts import (
    asym_adj, cheb_poly_stack, dense_to_edges, gaussian_weight_matrix,
    normalized_adj_wave, random_sensor_graph, scaled_laplacian, sym_adj,
    sym_norm_laplacian,
)
from gptst_tpu_torch.graph.partition import rcm_order, rcm_order_coo

__all__ = [
    "asym_adj", "cheb_poly_stack", "dense_to_edges",
    "gaussian_weight_matrix", "normalized_adj_wave", "random_sensor_graph",
    "scaled_laplacian", "sym_adj", "sym_norm_laplacian", "rcm_order",
    "rcm_order_coo",
]
