"""MTGNN: graph structure learning and mix-hop propagation.

Counterpart of the JAX package's `models/predictors/mtgnn.py` (the
reference's `model/MTGNN/MTGNN.py`): a learned directed graph
relu(tanh(alpha (M1 M2^T - M2 M1^T))) with top-k row sparsification
(`MTGNN.py:149-202`, `ops/graph_conv.mtgnn_graph`), dilated inception
blocks over time (kernels 2, 3, 6, 7), MixProp graph convolutions both
ways, `mixprop(x, A) + mixprop(x, A^T)` (`:487`), per-layer skip convs
that collapse the remaining time axis, and a LayerNorm over the whole
(T, N, C) slab with a per-(T, N, C) affine (`:294-327`). The learned
graph is dense (N, N): no kernel of `csrc/` is on this path, as in the
JAX package. Defaults follow `conf/MTGNN/*.conf` (layers 3, gcn_depth
2, subgraph_size 20, node_dim 40, dilation_exponential 1, conv and
residual 32, skip 64, end 128, propalpha 0.05, tanhalpha 3).

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards. Each rank maps its rows of the (N, node_dim) embeddings, the
maps' tanh are all-gathered (small) and rank g keeps its rows of the
learned graph, each row's top k being its own
(`ops/graph_conv.mtgnn_graph_rows`); MixProp by A all-gathers
each hop's input, by Aᵀ reduce-scatters each hop's partial products
(Aᵀ's row sums are A's column sums, summed over the ranks); each
LayerNorm sums over the ranks' nodes and each rank reads its nodes of
the (T, N, C) scale and bias; dropout's draw is the one-device draw.
The inception and skip convolutions act along time, on each rank's
nodes.

The input is front-padded to the receptive field (with
dilation_exponential 1: layers * (7 - 1) + dim_out), so, as in GWN,
the time left is dim_out and the final projection's channel axis
becomes the horizon.

Parameters, by the flax scope each one mirrors (`convert.py`):
  gc             GraphConstructor `gc`: `emb1`, `emb2` (N, node_dim),
                 `lin1`, `lin2` (nn.Linear)
  start_conv, end_conv_1, end_conv_2     nn.Linear (flax Dense)
  skip0, skipE   `TimeConv` (weight (C_out, C_in, kt, 1))
  inception.{j}  DilatedInception_j (j = 2i filter, 2i + 1 gate of
                 layer i), its convs `conv.{0..3}`
  skips.{i}      Conv_i, layer i's skip conv
  dense.{i}      Dense_i, the residual projection without gcn_true
  norm.{i}       NodeLayerNorm_i (`weight`, `bias`: (T_i, N, C))
  mixprop{1,2}_{w,b}_{i}                 raw parameters
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear
from gptst_tpu_torch.ops.graph_conv import (
    NodeRows, mixprop, mtgnn_graph, mtgnn_graph_rows,
)
from gptst_tpu_torch.ops.norm import dropout, node_moments
from gptst_tpu_torch.ops.recurrent import xavier_uniform_
from gptst_tpu_torch.ops.temporal import (
    INCEPTION_KERNELS, DilatedInception, TimeConv, dense,
)
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank


@dataclasses.dataclass(frozen=True)
class MTGNNConfig:
    num_nodes: int
    gcn_true: bool = True
    build_adj: bool = True
    gcn_depth: int = 2
    dropout: float = 0.3
    subgraph_size: int = 20
    node_dim: int = 40
    dilation_exponential: int = 1
    conv_channels: int = 32
    residual_channels: int = 32
    skip_channels: int = 64
    end_channels: int = 128
    layers: int = 3
    propalpha: float = 0.05
    tanhalpha: float = 3.0
    kernel_size: int = 7

    def receptive_field(self, dim_out: int) -> int:
        k = self.kernel_size - 1
        if self.dilation_exponential > 1:
            e = self.dilation_exponential
            return int(dim_out + k * (e ** self.layers - 1) / (e - 1))
        return self.layers * k + dim_out


class NodeLayerNorm(nn.Module):
    """LayerNorm over the whole (T, N, C) slab of each sample, eps 1e-5,
    with a per-(T, N, C) affine: `weight` ones, `bias` zeros
    (`MTGNN.py:294-327`)."""

    def __init__(self, shape: tuple[int, int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x, shards: NodeShards | None = None):
        """x (B, T, N, C); with `shards`, the list of the ranks' node
        shards, each normalized by its sample's statistics over the row's
        whole (T, N, C) slab (two sums over the ranks' nodes, in f32)."""
        if shards is None:
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            var = x.var(dim=(1, 2, 3), keepdim=True, correction=0)
            return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight \
                + self.bias
        return [(xg - m.to(xg.dtype)) * torch.rsqrt(v.to(xg.dtype) + 1e-5)
                * w + b
                for xg, w, b, (m, v) in zip(
                    x, shards.split(self.weight, dim=1),
                    shards.split(self.bias, dim=1),
                    node_moments(x, (1, 2, 3), shards))]


class GraphConstructor(nn.Module):
    """The learned directed adjacency (`MTGNN.py:149-202`): emb1, emb2
    ~ N(0, 1), each through its linear map, then `mtgnn_graph`."""

    def __init__(self, num_nodes: int, node_dim: int, alpha: float, k: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.alpha, self.k = alpha, k
        self.emb1 = nn.Parameter(torch.randn(num_nodes, node_dim,
                                             generator=generator))
        self.emb2 = nn.Parameter(torch.randn(num_nodes, node_dim,
                                             generator=generator))
        self.lin1 = dense(node_dim, node_dim, generator)
        self.lin2 = dense(node_dim, node_dim, generator)

    def forward(self, shards: NodeShards | None = None):
        """The (N, N) graph, or with `shards` its ranks' rows, each rank
        mapping its rows of the embeddings."""
        if shards is None:
            return mtgnn_graph(linear(self.lin1, self.emb1),
                               linear(self.lin2, self.emb2), self.alpha,
                               self.k)
        return mtgnn_graph_rows(
            each(self.lin1, shards.split(self.emb1, dim=0), shards, linear),
            each(self.lin2, shards.split(self.emb2, dim=0), shards, linear),
            self.alpha, self.k, shards)


class MTGNN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out); `forward` takes
    the predefined adjacency used when `build_adj` is off. Dropout runs
    whenever `forward` gets a generator (the trainer's, in training and
    at test), as the JAX builder's dropout runs whenever it gets a
    key."""

    def __init__(self, cfg: MTGNNConfig, dim_in: int, dim_out: int,
                 horizon: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = self.cfg = cfg
        self.dim_out = dim_out
        rf = c.receptive_field(dim_out)
        self.t_full = max(lag, rf)
        conv, res = c.conv_channels, c.residual_channels
        if c.gcn_true and c.build_adj:
            self.gc = GraphConstructor(c.num_nodes, c.node_dim, c.tanhalpha,
                                       c.subgraph_size, generator)
        self.start_conv = dense(dim_in, res, generator)
        self.skip0 = TimeConv(dim_in, c.skip_channels, self.t_full,
                              generator=generator)
        self.inception = nn.ModuleList()
        self.skips = nn.ModuleList()
        self.dense = nn.ModuleList()
        self.norm = nn.ModuleList()
        t = self.t_full
        for i in range(c.layers):
            for _ in ("filter", "gate"):
                self.inception.append(DilatedInception(res, conv,
                                                       generator=generator))
            t -= max(INCEPTION_KERNELS) - 1   # its widest kernel, dilation 1
            self.skips.append(TimeConv(conv, c.skip_channels, t,
                                       generator=generator))
            if c.gcn_true:
                for side in (1, 2):
                    w = nn.Parameter(torch.empty((c.gcn_depth + 1) * conv, res))
                    self.register_parameter(f"mixprop{side}_w_{i}",
                                            xavier_uniform_(w, generator))
                    self.register_parameter(f"mixprop{side}_b_{i}",
                                            nn.Parameter(torch.zeros(res)))
            else:
                self.dense.append(dense(conv, res, generator))
            self.norm.append(NodeLayerNorm((t, c.num_nodes, res)))
        self.skipE = TimeConv(res, c.skip_channels, t - dim_out + 1,
                              generator=generator)
        self.end_conv_1 = dense(c.skip_channels, c.end_channels, generator)
        self.end_conv_2 = dense(c.end_channels, horizon, generator)

    def forward(self, x, predefined_adj=None,
                generator: torch.Generator | None = None,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise."""
        c = self.cfg
        rf = c.receptive_field(self.dim_out)
        steps = (x if shards is None else x[0]).shape[1]
        if steps < rf:
            x = per_rank(lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, rf - steps, 0)), x)
        adp = None
        if c.gcn_true:
            if c.build_adj:
                adp = self.gc(shards)
            elif shards is None:
                adp = predefined_adj
            else:
                adp = NodeRows.of(predefined_adj, shards)

        def drop(h):
            return dropout(h, c.dropout, generator, shards)

        h = each(self.start_conv, x, shards, linear)
        # skip0: a conv over the whole (padded) time axis -> time 1
        skip = each(self.skip0, drop(x), shards)
        for i in range(c.layers):
            residual = h
            h = drop(per_rank(lambda f, g: torch.tanh(f) * torch.sigmoid(g),
                              each(self.inception[2 * i], h, shards),
                              each(self.inception[2 * i + 1], h, shards)))
            # each layer's skip collapses the remaining time axis to 1
            skip = per_rank(torch.add, each(self.skips[i], h, shards), skip)
            if c.gcn_true:
                b1 = getattr(self, f"mixprop1_b_{i}")
                b2 = getattr(self, f"mixprop2_b_{i}")
                h = per_rank(
                    lambda m1, m2: m1 + b1.to(m1.device) + m2
                    + b2.to(m2.device),
                    mixprop(h, adp, getattr(self, f"mixprop1_w_{i}"),
                            c.gcn_depth, c.propalpha),
                    mixprop(h, adp.T, getattr(self, f"mixprop2_w_{i}"),
                            c.gcn_depth, c.propalpha))
            else:
                h = each(self.dense[i], h, shards, linear)
            h = per_rank(lambda a, r: a + r[:, -a.shape[1]:], h, residual)
            h = self.norm[i](h, shards)
        skip = per_rank(torch.add, each(self.skipE, h, shards), skip)
        h = per_rank(torch.relu, skip)
        h = per_rank(torch.relu, each(self.end_conv_1, h, shards, linear))
        h = each(self.end_conv_2, h, shards, linear)
        # (B, dim_out, N, horizon) -> (B, horizon, N, dim_out)
        return per_rank(lambda t: t.permute(0, 3, 2, 1), h)
