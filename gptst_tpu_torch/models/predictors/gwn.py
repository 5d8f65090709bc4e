"""Graph WaveNet (GWN).

Counterpart of the JAX package's `models/predictors/gwn.py` (the
reference's `model/GWN/GWN.py`): gated dilated causal convolutions over
time (WaveNet) with skip and residual paths, diffusion graph
convolution over a support list (`ops/graph_conv.diffusion_conv`), and
a learned adaptive adjacency softmax(relu(E1 @ E2)) (`GWN.py:238`).
Defaults follow `conf/GWN/*.conf` (blocks 4, layers 2, kernel 2, nhid
32, aptonly, addaptadj and randomadj on: the adaptive adjacency is then
the only support).

Layout: channels-last (B, T, N, C); the dilated convolutions are VALID
over T, so time shrinks as in the reference. The input is front-padded
by at least one step, up to the receptive field
`dim_out + blocks * (kernel - 1) * (2^layers - 1)` (`GWN.py:152,
177-201`): the time left after the last block is dim_out, and the final
projection's channel axis becomes the horizon. Both quirks are kept.

The reference aggregates with einsum('ncvl,vw->ncwl'), i.e. by A^T: the
supports are transposed once per forward (`SparseSupport.T` swaps the
structures, so the forward runs the transposed block-CSR or DIA band
and the backward the original one).

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh), with the adaptive adjacency as the only support (the
conf's aptonly; static supports under a graph axis raise, as in the
JAX package: ROADMAP.md Queue 3, item 15): x and every activation are
lists of the ranks' node shards. Rank g holds its rows of nodevec1 and
so its rows of A (`ops/graph_conv.adaptive_rows`, no meeting); each
diffusion hop by Aᵀ reduce-scatters the ranks' partial products
(`NodeRows.matmul`), the BatchStatsNorms sum over the ranks' nodes and
the data rows, and dropout's draw is the one-device draw. The gated
dilated convolutions act along time, on each rank's nodes.

Parameters, by the flax scope each one mirrors (`convert.py`):
  start_conv, end_conv_1, end_conv_2     nn.Linear (flax Dense)
  dilated.{j}    DilatedCausal_j's Conv_0 (`TimeConv`: weight
                 (C_out, C_in, kt, 1)); j = 2i filter, 2i + 1 gate of
                 layer i
  dense.{k}      Dense_k in flax's order: each layer's skip projection,
                 and after it, without graph convolution, the residual
                 projection
  norm.{i}       BatchStatsNorm_i (`scale`, `bias`)
  gconv_w_{b}_{l}, gconv_b_{b}_{l}, nodevec1, nodevec2   raw parameters
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear
from gptst_tpu_torch.ops.graph_conv import (
    adaptive_adj, adaptive_rows, diffusion_conv,
)
from gptst_tpu_torch.ops.norm import BatchStatsNorm, dropout
from gptst_tpu_torch.ops.recurrent import xavier_uniform_
from gptst_tpu_torch.ops.temporal import TimeConv, dense
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank


@dataclasses.dataclass(frozen=True)
class GWNConfig:
    num_nodes: int
    dropout: float = 0.3
    blocks: int = 4
    layers: int = 2
    gcn_bool: bool = True
    addaptadj: bool = True
    aptonly: bool = True
    # support preprocessing (`GWN.py:299-313`) and the nodevec init
    # source: randomadj=False seeds the adaptive adjacency from the
    # rank-10 SVD of supports[0] (`GWN.py:159-175`)
    adjtype: str = "doubletransition"
    randomadj: bool = True
    kernel_size: int = 2
    nhid: int = 32
    residual_channels: int = 32
    dilation_channels: int = 32
    adapt_rank: int = 10

    @property
    def skip_channels(self) -> int:
        return self.nhid * 8

    @property
    def end_channels(self) -> int:
        return self.nhid * 16

    def receptive_field(self, dim_out: int) -> int:
        per_block = (self.kernel_size - 1) * (2 ** self.layers - 1)
        return dim_out + self.blocks * per_block


class GWN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out), with the static
    supports (`num_supports` of them: dense tensors or `SparseSupport`s)
    passed to `forward`. `nodevec_init`: optional (E1, E2) numpy arrays
    for the adaptive adjacency's embeddings (the SVD-seeded
    `randomadj=False` branch); else N(0, 1) from `generator`. Dropout
    runs whenever `forward` gets a generator (the trainer's, in training
    and at test), in either module mode, as the JAX builder's dropout
    runs whenever it gets a key."""

    def __init__(self, cfg: GWNConfig, dim_in: int, dim_out: int,
                 horizon: int, num_supports: int = 0,
                 nodevec_init: tuple | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = self.cfg = cfg
        self.dim_out = dim_out
        self.adaptive = c.gcn_bool and c.addaptadj
        n_sup = num_supports + int(self.adaptive)
        self.gconv = c.gcn_bool and n_sup > 0
        res, dil = c.residual_channels, c.dilation_channels
        self.start_conv = dense(dim_in, res, generator)
        if self.adaptive:
            if nodevec_init is None:
                e1 = torch.randn(c.num_nodes, c.adapt_rank,
                                 generator=generator)
                e2 = torch.randn(c.adapt_rank, c.num_nodes,
                                 generator=generator)
            else:
                e1, e2 = (torch.as_tensor(np.asarray(v, np.float32))
                          for v in nodevec_init)
            self.nodevec1 = nn.Parameter(e1)
            self.nodevec2 = nn.Parameter(e2)
        self.dilated = nn.ModuleList()
        self.dense = nn.ModuleList()
        self.norm = nn.ModuleList()
        for b in range(c.blocks):
            for layer in range(c.layers):
                for _ in ("filter", "gate"):
                    self.dilated.append(TimeConv(res, dil, c.kernel_size,
                                                 2 ** layer, generator))
                self.dense.append(dense(dil, c.skip_channels, generator))
                if self.gconv:
                    w = nn.Parameter(torch.empty((2 * n_sup + 1) * dil, res))
                    self.register_parameter(f"gconv_w_{b}_{layer}",
                                            xavier_uniform_(w, generator))
                    self.register_parameter(f"gconv_b_{b}_{layer}",
                                            nn.Parameter(torch.zeros(res)))
                else:
                    self.dense.append(dense(dil, res, generator))
                self.norm.append(BatchStatsNorm(res))
        self.end_conv_1 = dense(c.skip_channels, c.end_channels, generator)
        self.end_conv_2 = dense(c.end_channels, horizon, generator)

    def forward(self, x, supports: tuple = (),
                generator: torch.Generator | None = None,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise."""
        c = self.cfg
        steps = (x if shards is None else x[0]).shape[1]
        pad = max(1, c.receptive_field(self.dim_out) - steps)
        x = per_rank(lambda t: F.pad(t, (0, 0, 0, 0, pad, 0)), x)
        sup = [s.T for s in supports]
        if self.adaptive:
            sup.append(adaptive_adj(self.nodevec1, self.nodevec2).T
                       if shards is None else
                       adaptive_rows(self.nodevec1, self.nodevec2, shards).T)
        x = each(self.start_conv, x, shards, linear)
        skip = None
        i = 0
        for b in range(c.blocks):
            for layer in range(c.layers):
                residual = x
                x = per_rank(lambda f, g: torch.tanh(f) * torch.sigmoid(g),
                             each(self.dilated[2 * i], residual, shards),
                             each(self.dilated[2 * i + 1], residual, shards))
                d = i if self.gconv else 2 * i
                s = each(self.dense[d], x, shards, linear)
                skip = s if skip is None else per_rank(
                    lambda a, k: a + k[:, -a.shape[1]:], s, skip)
                if self.gconv:
                    x = diffusion_conv(
                        x, sup, getattr(self, f"gconv_w_{b}_{layer}"),
                        getattr(self, f"gconv_b_{b}_{layer}"), order=2)
                    x = dropout(x, c.dropout, generator, shards)
                else:
                    x = each(self.dense[d + 1], x, shards, linear)
                x = per_rank(lambda a, r: a + r[:, -a.shape[1]:], x,
                             residual)
                x = self.norm[i](x, shards)
                i += 1
        x = per_rank(torch.relu, skip)
        x = per_rank(torch.relu, each(self.end_conv_1, x, shards, linear))
        x = each(self.end_conv_2, x, shards, linear)
        # (B, t_rem = dim_out, N, horizon) -> (B, horizon, N, dim_out)
        return per_rank(lambda t: t.permute(0, 3, 2, 1), x)
