"""STGODE: spatio-temporal graph neural ODE.

Counterpart of the JAX package's `models/predictors/stgode.py` (the
reference's `model/STGODE/STGODE.py` + `odegcn.py`): parallel branches
over a spatial gaussian-kernel graph and a DTW semantic graph
(n_layers = 3 each), every branch two blocks of TCN -> graph ODE -> TCN
-> BatchNorm over nodes, an elementwise max over the branches' outputs,
then a two-layer head over each node's flattened (T, C)
(`STGODE.py:133-178`). The ODE

    dx/dt = sigmoid(alpha)/2 A x - 3x + x W + W2 x + x0

with W = (w ⊙ clip(d, 0, 1)) w^T (`odegcn.py:33-48`) is integrated by
torchdiffeq's fixed-grid Euler on t = [0, 6], which is ONE Euler step of
size 6; x0 is detached (`odegcn.py:57`). Defaults follow
`conf/STGODE/*.conf` (out_channels [64, 32, 64], huber loss). The
integration time and the TCN dropout are fixed (6, none), as in the JAX
package, so the config has no field for either: `--ode_time` and
`--dropout` are refused on the command line, and an INI file's keys for
them are ignored.

The TCN keeps the reference's precedence quirk (`STGODE.py:64`, the JAX
package's `stgode.py:52-77`): when its input already has the last
channel width there is no downsample, and the block returns relu(x) and
DISCARDS its conv chain. The convs' parameters exist all the same, and
get no gradient (None here, zero in the JAX package). At dim_in 64
(eval mode) even the first TCN of every block discards its convs.

No kernel of `csrc/` is on this path: the graph products are dense.

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards. The ranks meet only at the ODE's graph products, rank g's rows
of each graph times the gathered x (`ops/graph_conv.NodeRows`). alpha,
`NodeBatchNorm` (each node's statistics over (B, T, C); over every data
row's batch in a data-parallel step), the TCNs, the max merge and the
head are node-local; rank g reads its entries of alpha, scale and bias.

Parameters, by the flax scope each one mirrors (`convert.py`):
  blocks.{sp|se}_{i}_{j}   {sp|se}_{i}_{j} (STGODEBlock)
    .tcn.{0,1}             TemporalConvNet_{0,1}: `conv.{k}` = Conv_{k}
                           (`ops/temporal.TimeConv`), `down` = Conv_3
                           (the 1x1 downsample, when the widths differ)
    .odeg                  ODEG_0 (alpha, w, d, w2, d2)
    .norm                  NodeBatchNorm_0 (scale, bias)
  dense.{0,1}              Dense_{0,1} (xavier uniform kernels)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted
from gptst_tpu_torch.ops.graph_conv import NodeRows
from gptst_tpu_torch.ops.norm import batch_moments
from gptst_tpu_torch.ops.recurrent import xavier_uniform_
from gptst_tpu_torch.ops.temporal import TimeConv
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank


@dataclasses.dataclass(frozen=True)
class STGODEConfig:
    num_nodes: int
    out_channels: tuple[int, int, int] = (64, 32, 64)
    n_layers: int = 3


def stgode_normalized_adj(a: np.ndarray) -> np.ndarray:
    """A_reg = 0.4 * (I + D^-1/2 A D^-1/2) (`args.py:133-144`)."""
    d = np.maximum(a.sum(axis=1), 1e-4)
    diag = 1.0 / np.sqrt(d)
    a_wave = diag[:, None] * a * diag[None, :]
    return (0.4 * (np.eye(a.shape[0]) + a_wave)).astype(np.float32)


def _clip01(d: torch.Tensor) -> torch.Tensor:
    """`jnp.clip(d, 0, 1)` with JAX's gradient: half of it at either
    bound, where torch's `clamp` passes all of it (d starts at 1)."""
    return torch.minimum(torch.maximum(d, d.new_zeros(())), d.new_ones(()))


class TemporalConvNet(nn.Module):
    """Causal dilated TCN, kernel 2, dilations 1, 2, 4, residual 1x1
    (`STGODE.py:22-66`), on (B, T, N, C). Conv kernels N(0, 0.01^2),
    zero biases."""

    def __init__(self, c_in: int, channels: tuple[int, ...],
                 generator: torch.Generator | None = None):
        super().__init__()
        convs, c = [], c_in
        for i, c_out in enumerate(channels):
            d = 2 ** i
            convs.append(TimeConv(c, c_out, 2, d, generator, padding=(d, 0)))
            c = c_out
        self.conv = nn.ModuleList(convs)
        self.down = (TimeConv(c_in, channels[-1], 1, generator=generator)
                     if c_in != channels[-1] else None)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, TimeConv):
                    m.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down is None:
            return torch.relu(x)      # the conv chain's output is discarded
        y = x
        for conv in self.conv:
            y = torch.relu(conv(y))
        return torch.relu(y + self.down(x))


class ODEG(nn.Module):
    """One Euler step of size 6 of the graph ODE (`odegcn.py:20-75`)."""

    def __init__(self, feature_dim: int, temporal_dim: int, num_nodes: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_nodes,), 0.8))
        self.w = nn.Parameter(torch.eye(feature_dim))
        self.d = nn.Parameter(torch.ones(feature_dim))
        self.w2 = nn.Parameter(torch.eye(temporal_dim))
        self.d2 = nn.Parameter(torch.ones(temporal_dim))

    def forward(self, x, adj, shards: NodeShards | None = None):
        """x (B, T, N, C) and adj (N, N); with `shards`, x the ranks'
        node shards and adj a `NodeRows` (its rows times the gathered
        x), the rest node-local."""
        if shards is None:
            return self._step(x, torch.einsum(
                "nm,btmc->btnc", *promoted(adj, x)), self.alpha)
        return [self._step(xg, xa, al) for xg, xa, al in zip(
            x, adj.matmul(x), shards.split(self.alpha, dim=0))]

    def _step(self, x: torch.Tensor, xa: torch.Tensor,
              alpha: torch.Tensor) -> torch.Tensor:
        dev = x.device
        x, xa, alpha, w, d, w2, d2 = promoted(
            x, xa, alpha, self.w.to(dev), self.d.to(dev), self.w2.to(dev),
            self.d2.to(dev))
        x0 = x.detach()
        a = torch.sigmoid(alpha)[None, None, :, None]
        xw = x @ ((w * _clip01(d)) @ w.T)
        w2c = (w2 * _clip01(d2)) @ w2.T
        xw2 = torch.einsum("btnc,ts->bsnc", x, w2c)
        f = a / 2 * xa - x + xw - x + xw2 - x + x0
        return torch.relu(x + 6.0 * f)


class NodeBatchNorm(nn.Module):
    """torch `BatchNorm2d` over the NODE axis with batch statistics
    (`STGODE.py:114` runs on (B, N, T, F), N the channels): the
    population variance, epsilon 1e-5; the global batch's in a
    data-parallel step (`ops/norm.batch_moments`)."""

    def __init__(self, num_nodes: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_nodes))
        self.bias = nn.Parameter(torch.zeros(num_nodes))

    def forward(self, x, shards: NodeShards | None = None):
        """x (B, T, N, C), or with `shards` the ranks' node shards, each
        normalized by its own nodes' statistics."""
        if shards is None:
            return self._norm(x, self.scale, self.bias)
        return [self._norm(xg, sc, b) for xg, sc, b in zip(
            x, shards.split(self.scale, dim=0),
            shards.split(self.bias, dim=0))]

    def _norm(self, x, scale, bias) -> torch.Tensor:
        x, scale, bias = promoted(x, scale, bias)
        mean, var = batch_moments(x, (0, 1, 3))
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * scale[:, None] + bias[:, None]


class STGODEBlock(nn.Module):
    def __init__(self, cfg: STGODEConfig, c_in: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        ch = tuple(cfg.out_channels)
        self.tcn = nn.ModuleList([TemporalConvNet(c_in, ch, generator),
                                  TemporalConvNet(ch[-1], ch, generator)])
        self.odeg = ODEG(ch[-1], lag, cfg.num_nodes)
        self.norm = NodeBatchNorm(cfg.num_nodes)

    def forward(self, x, adj, shards: NodeShards | None = None):
        h = self.odeg(each(self.tcn[0], x, shards), adj, shards)
        return self.norm(each(self.tcn[1], per_rank(torch.relu, h), shards),
                         shards)


class STGODE(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out), with the
    normalized spatial and semantic graphs (N, N) passed in."""

    def __init__(self, cfg: STGODEConfig, dim_in: int, dim_out: int,
                 horizon: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.dim_out, self.horizon = cfg, dim_out, horizon
        c = cfg.out_channels
        blocks = {}
        for tag in ("sp", "se"):
            for i in range(cfg.n_layers):
                blocks[f"{tag}_{i}_0"] = STGODEBlock(cfg, dim_in, lag,
                                                     generator)
                blocks[f"{tag}_{i}_1"] = STGODEBlock(cfg, c[-1], lag,
                                                     generator)
        self.blocks = nn.ModuleDict(blocks)
        self.dense = nn.ModuleList([
            nn.Linear(lag * c[2], horizon * c[1]),
            nn.Linear(horizon * c[1], horizon * dim_out)])
        for lin in self.dense:
            xavier_uniform_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x, adj_sp: torch.Tensor, adj_se: torch.Tensor,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise."""
        outs = []
        for tag, adj in (("sp", adj_sp), ("se", adj_se)):
            if shards is not None:
                adj = NodeRows.of(adj, shards)
            for i in range(self.cfg.n_layers):
                h = self.blocks[f"{tag}_{i}_0"](x, adj, shards)
                outs.append(self.blocks[f"{tag}_{i}_1"](h, adj, shards))
        h = per_rank(lambda *hs: torch.stack(hs).amax(dim=0), *outs)
        return each(self.dense, h, shards, self._head)

    def _head(self, dense: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
        b, _, n, _ = h.shape                                   # (B, T, N, C)
        flat = h.transpose(1, 2).reshape(b, n, -1)
        h = torch.relu(linear(dense[0], flat))
        out = linear(dense[1], h).reshape(b, n, self.horizon, self.dim_out)
        return out.transpose(1, 2)
