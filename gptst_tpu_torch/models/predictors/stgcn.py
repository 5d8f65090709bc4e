"""STGCN — spatio-temporal graph convolutional network.

Counterpart of the JAX package's `models/predictors/stgcn.py` (the
reference's `model/STGCN/stgcn.py`): channels-last (B, T, N, C), the
Chebyshev spatial conv as two dense products over a precomputed
(K, N, N) polynomial stack (`ops/graph_conv.cheb_conv`), SAME-padded
temporal convs (`ops/temporal.py`). Defaults follow `conf/STGCN/*.conf`
(Ks=3, Kt=3, blocks1=[64, 32, 128], outputl_ks=3).

Architecture (`stgcn.py:127-155`): two ST-Conv sandwich blocks
(TemporalGLU -> ChebConv -> TemporalReLU -> LayerNorm -> Dropout) and an
output head (TemporalGLU -> LayerNorm -> sigmoid temporal conv -> 1x1
projection). `dim_in` is free, so the same module serves ori mode (the
raw channels) and eval mode (the 64-wide fused embedding). The
Chebyshev stack is dense: STGCN runs at the reference datasets' sizes
(N <= 266).

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards. The temporal convolutions are node-local; the ranks meet at the
Chebyshev products (each rank's rows of the stack times the
all-gathered x, `ops/graph_conv.sharded_cheb_conv`) and at the
LayerNorms over (N, C) (two sums over nodes), whose (N, C) scale and
bias each rank reads by its rows. Dropout's draw is the one-device
draw (`ops/norm.dropout`).

Parameters, by the flax scope each one mirrors (`convert.py`):
  block0, block1        STConvBlock_0, STConvBlock_1
    .tconv0, .tconv1      TemporalConv_0, TemporalConv_1 (`kernel`,
                          `bias`, `proj` = Dense_0 when shrinking)
    .sconv                SpatioConvLayer_0 (`theta` (C_in, C_out, ks),
                          `bias`, `proj`)
    .norm                 LayerNorm_0 (`weight`, `bias`: (N, C), flax's
                          `scale` and `bias`)
  output                OutputLayer_0: .tconv0, .norm, .tconv1, .dense
                          (Dense_0)
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted, widened
from gptst_tpu_torch.ops.graph_conv import cheb_conv, sharded_cheb_conv
from gptst_tpu_torch.ops.norm import dropout, node_moments
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank
from gptst_tpu_torch.ops.temporal import TemporalConv, align_channels, dense


@dataclasses.dataclass(frozen=True)
class STGCNConfig:
    num_nodes: int
    ks: int = 3
    kt: int = 3
    blocks1: tuple[int, int, int] = (64, 32, 128)
    drop_prob: float = 0.0
    outputl_ks: int = 3


class NodeLayerNorm(nn.Module):
    """flax `LayerNorm(reduction_axes=(-2, -1), feature_axes=(-2, -1))`:
    normalizes jointly over (N, C) with an (N, C) scale and bias,
    epsilon 1e-6, as torch's `LayerNorm([N, C])` does in the reference."""

    def __init__(self, num_nodes: int, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_nodes, channels))
        self.bias = nn.Parameter(torch.zeros(num_nodes, channels))

    def forward(self, x, shards: NodeShards | None = None):
        """x (..., N, C); with `shards`, the list of the ranks' node
        shards, each normalized by the statistics of the row's whole
        (N, C) slab (two sums over the ranks' nodes, in f32)."""
        if shards is None:
            x, w, b = promoted(x, self.weight, self.bias)
            return F.layer_norm(x, tuple(w.shape), w, b, eps=1e-6)
        out = []
        for xg, ws, bs, (m, v) in zip(
                x, shards.split(self.weight, dim=0),
                shards.split(self.bias, dim=0),
                node_moments(x, (-2, -1), shards)):
            dt = torch.promote_types(xg.dtype, ws.dtype)
            out.append(((widened(xg) - m) * torch.rsqrt(v + 1e-6)
                        * widened(ws) + widened(bs)).to(dt))
        return out


class SpatioConvLayer(nn.Module):
    """Chebyshev graph conv + aligned residual (`stgcn.py:56-80`)."""

    def __init__(self, ks: int, c_in: int, c_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c_out = c_out
        # flax kaiming_uniform on (C_in, C_out, ks): fan_in is
        # C_out * C_in (in axis -2, the leading axis a receptive field)
        lim = math.sqrt(6.0 / (c_in * c_out))
        self.theta = nn.Parameter(
            torch.rand(c_in, c_out, ks, generator=generator) * (2 * lim)
            - lim)
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.proj = dense(c_in, c_out, generator) if c_in > c_out else None

    def forward(self, x, cheb: torch.Tensor,
                shards: NodeShards | None = None):
        if shards is None:
            x_gc = cheb_conv(x, cheb, self.theta, self.bias)
        else:
            x_gc = sharded_cheb_conv(x, cheb, self.theta, self.bias, shards)
        res = each(self.proj, x, shards,
                   lambda p, t: align_channels(t, self.c_out, p))
        return per_rank(lambda a, r: torch.relu(a + r), x_gc, res)


class STConvBlock(nn.Module):
    """GLU-TConv -> ChebConv -> TConv -> LayerNorm over (N, C) ->
    Dropout (`stgcn.py:82-97`)."""

    def __init__(self, ks: int, kt: int, channels: tuple[int, int, int],
                 num_nodes: int, drop_prob: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = channels
        self.drop_prob = drop_prob
        self.tconv0 = TemporalConv(kt, c[0], c[1], "GLU", generator)
        self.sconv = SpatioConvLayer(ks, c[1], c[1], generator)
        self.tconv1 = TemporalConv(kt, c[1], c[2], "relu", generator)
        self.norm = NodeLayerNorm(num_nodes, c[2])

    def forward(self, x, cheb, generator: torch.Generator | None = None,
                shards: NodeShards | None = None):
        x = self.sconv(each(self.tconv0, x, shards), cheb, shards)
        x = self.norm(each(self.tconv1, x, shards), shards)
        return dropout(x, self.drop_prob, generator, shards)


class OutputLayer(nn.Module):
    """GLU-TConv -> LayerNorm -> sigmoid TConv(1) -> 1x1 head
    (`stgcn.py:108-124`)."""

    def __init__(self, c: int, t_kernel: int, dim_out: int, num_nodes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.tconv0 = TemporalConv(t_kernel, c, c, "GLU", generator)
        self.norm = NodeLayerNorm(num_nodes, c)
        self.tconv1 = TemporalConv(1, c, c, "sigmoid", generator)
        self.dense = dense(c, dim_out, generator)

    def forward(self, x, shards: NodeShards | None = None):
        x = self.norm(each(self.tconv0, x, shards), shards)
        return each(self.dense, each(self.tconv1, x, shards), shards, linear)


class STGCN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, T, N, dim_out), with the (K, N, N)
    Chebyshev stack passed in. Dropout (`drop_prob` > 0) runs whenever
    a `generator` is given (the trainer's, in training and at test), as
    the JAX builder's runs whenever it gets a key."""

    def __init__(self, cfg: STGCNConfig, dim_in: int, dim_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        b1, n = cfg.blocks1, cfg.num_nodes
        blocks0 = (dim_in, b1[1], b1[0])   # `stgcn.py:133`
        self.block0 = STConvBlock(cfg.ks, cfg.kt, blocks0, n, cfg.drop_prob,
                                  generator)
        self.block1 = STConvBlock(cfg.ks, cfg.kt, b1, n, cfg.drop_prob,
                                  generator)
        self.output = OutputLayer(b1[2], cfg.outputl_ks, dim_out, n,
                                  generator)

    def forward(self, x, cheb: torch.Tensor,
                generator: torch.Generator | None = None,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise."""
        x = self.block0(x, cheb, generator, shards)
        x = self.block1(x, cheb, generator, shards)
        return self.output(x, shards)
