"""DMVST-Net: a simplified multi-view demand predictor.

Counterpart of the JAX package's `models/predictors/dmvstnet.py` (the
reference's `model/DMVSTNET_demand/DMVSTNET.py`): three views fused per
time step, a local GNN spatial view (a dense adjacency product and a
residual, `:4-14, 45-48`), an LSTM temporal view over [spatial ‖
temporal] projections shared by all B * N node sequences (`:52-55`),
and a semantic view from a node-embedding weight pool (`:57-58`),
concatenated into a linear head. Defaults follow
`conf/DMVSTNET_demand/*.conf` (hidden_dim 64, topo_embedded_dim 16).
The LSTM is 2 * hidden_dim wide, as in the JAX package (the reference's
hidden_dim * dim_out only type-checks at dim_out 2, where the two
agree).

The adjacency is what the builder passes: `load_base_adjacency`'s
matrix as it is, not row-normalized (the JAX module's docstring says
row-normalized; its builder passes the raw matrix, and the port keeps
that, `ROADMAP.md` Queue 3).

No kernel of `csrc/` is on this path: the graph product is a dense
einsum, as in the JAX package. The LSTM is stepped in Python
(`ops/recurrent.LSTMCell`).

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards. The ranks meet only at the spatial view's product, rank g's
rows of the raw adjacency times the gathered x_spa
(`ops/graph_conv.NodeRows`); rank g reads its rows of
`node_embeddings`; the LSTM (shared by the nodes) and the rest are
node-local.

Parameters, by the flax scope each one mirrors (`convert.py`). The
Dense layers are `nn.Linear` at flax's init (lecun-normal weights, zero
bias); `node_embeddings` (N, E) and `w` (E, h, h) are flax's
`xavier_uniform` with flax's fans:
  lin_in_spa, lin_in_tem, lin_in_sen, local_gnn, lin_spa, output
  lstm            OptimizedLSTMCell_0 (`weight_ih`, `weight_hh`,
                  `bias_hh`: `ops/recurrent.LSTMCell`)
  node_embeddings, w
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted
from gptst_tpu_torch.ops.graph_conv import NodeRows
from gptst_tpu_torch.ops.param_pool import node_param_linear
from gptst_tpu_torch.ops.recurrent import LSTMCell, xavier_uniform_
from gptst_tpu_torch.ops.temporal import dense
from gptst_tpu_torch.parallel.mesh import NodeShards, each, module_on


@dataclasses.dataclass(frozen=True)
class DMVSTNetConfig:
    num_nodes: int
    hidden_dim: int = 64
    topo_embedded_dim: int = 16


class DMVSTNet(nn.Module):
    """x (B, T, N, dim_in), adj (N, N) -> (B, T, N, dim_out)."""

    def __init__(self, cfg: DMVSTNetConfig, dim_in: int, dim_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, e = cfg.hidden_dim, cfg.topo_embedded_dim
        self.lin_in_spa = dense(dim_in, h, generator)
        self.lin_in_tem = dense(dim_in, h, generator)
        self.lin_in_sen = dense(dim_in, h, generator)
        self.local_gnn = dense(h, h, generator)
        self.lin_spa = dense(h, h, generator)
        self.lstm = LSTMCell(2 * h, 2 * h, generator)
        self.node_embeddings = nn.Parameter(xavier_uniform_(
            torch.empty(cfg.num_nodes, e), generator))
        self.w = nn.Parameter(xavier_uniform_(torch.empty(e, h, h),
                                              generator))
        self.output = dense(3 * h, dim_out, generator)

    def forward(self, x, adj: torch.Tensor,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards (the local GNN view's product by adj's rows gathers
        x_spa; the rest is node-local); the output likewise."""
        x_spa = each(self.lin_in_spa, x, shards, linear)
        if shards is None:
            agg = torch.einsum("vn,btnd->btvd", *promoted(adj, x_spa))
            return self._views(x, x_spa, agg, self.node_embeddings)
        return [self._views(*a) for a in zip(
            x, x_spa, NodeRows.of(adj, shards).matmul(x_spa),
            shards.split(self.node_embeddings, dim=0))]

    def _views(self, x, x_spa, agg, node_embeddings):
        """The three views on one set of nodes (x's device), from
        adj @ x_spa and those nodes' embeddings."""
        b, t, n, _ = x.shape

        def on(name: str):
            return module_on(getattr(self, name), x.device)

        x_tem = linear(on("lin_in_tem"), x)
        x_sen = linear(on("lin_in_sen"), x)

        # local GNN view and its residual (`DMVSTNET.py:12-13, 46-47`)
        g = torch.relu(linear(on("local_gnn"), agg))
        spatial_out = linear(on("lin_spa"), g) + x_spa

        # temporal view: one LSTM over time, shared by the nodes; the
        # last hidden state is added to every step
        seq = torch.cat([spatial_out, x_tem], dim=-1)      # (B, T, N, 2h)
        seq = seq.transpose(1, 2).reshape(b * n, t, seq.shape[-1])
        out = on("lstm")(seq)                              # (BN, T, 2h)
        temporal = (out + out[:, -1:]).reshape(b, n, t, -1).transpose(1, 2)

        # semantic view: the node-embedding weight pool (`:57-58`)
        sem = node_param_linear(*promoted(x_sen, node_embeddings,
                                          self.w.to(x.device)), None)
        return linear(on("output"), torch.cat([temporal, sem], dim=-1))
