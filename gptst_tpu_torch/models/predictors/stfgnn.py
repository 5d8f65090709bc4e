"""STFGNN: spatio-temporal fusion graph neural network.

Counterpart of the JAX package's `models/predictors/stfgnn.py` (the
reference's `model/STFGNN/STFGNN.py`): STSGCN's synchronous conv with
stride 4 over a 4N x 4N fusion graph that mixes the spatial adjacency
and a DTW temporal-similarity graph (`construct_adj_fusion`,
`args.py:110-151`), plus a gated pair of dilated convs (kernel (2, 1),
dilation 3, VALID: sigmoid * tanh, T - 3 steps) added to the windows'
outputs (`STFGNN.py:130-131, 176-183`). Defaults follow
`conf/STFGNN/*.conf` (3 layers of [64, 64, 64], strides 4,
first_layer_embedding 64, out_layer_dim 128, huber loss).

Windows are batched into (B, W, 4N, C) and the per-window weights into
(W, C, F) stacks (`stsgcn.glu_graph_layers`). No kernel of `csrc/` is
on this path.

Init: position embeddings N(0, 3e-4^2) (`STFGNN.py:155-161`),
per-window weights U(+-1/sqrt(C * W)), zero biases, convs and Dense
layers lecun normal with zero biases.

Parameters, by the flax scope each one mirrors (`convert.py`):
  first_fc            first_fc (nn.Linear)
  fusion_layers.{i}   FusionLayer_{i}: temporal_emb, spatial_emb, w{l},
                      b{l}, `conv1`, `conv2` (`ops/temporal.TimeConv`)
  dense.{k}           Dense_{k}: per horizon step its out_layer_dim-wide
                      layer (2k) and its output layer (2k + 1)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.models.predictors.stsgcn import (
    glu_graph_layers, horizon_heads, window_stack,
)
from gptst_tpu_torch.ops.dtypes import linear
from gptst_tpu_torch.ops.recurrent import fan_in_uniform_
from gptst_tpu_torch.ops.temporal import TimeConv, dense


@dataclasses.dataclass(frozen=True)
class STFGNNConfig:
    num_nodes: int
    hidden_dims: tuple = ((64, 64, 64),) * 3
    first_layer_embedding_size: int = 64
    out_layer_dim: int = 128
    strides: int = 4
    temporal_emb: bool = True
    spatial_emb: bool = True


def construct_adj_fusion(a: np.ndarray, a_dtw: np.ndarray,
                         steps: int = 4) -> np.ndarray:
    """The 4N fusion graph (`model/STFGNN/args.py:110-151`): diagonal
    blocks [DTW, A, A, DTW], adjacent-step self edges, DTW corner
    blocks, A-block couplings, self loops."""
    n = a.shape[0]
    adj = np.zeros((n * steps, n * steps), dtype=np.float32)
    for i in range(steps):
        blk = a if i in (1, 2) else a_dtw
        adj[i * n:(i + 1) * n, i * n:(i + 1) * n] = blk
    idx = np.arange(n)
    for k in range(steps - 1):
        adj[k * n + idx, (k + 1) * n + idx] = 1.0
        adj[(k + 1) * n + idx, k * n + idx] = 1.0
    adj[3 * n:4 * n, 0:n] = a_dtw
    adj[0:n, 3 * n:4 * n] = a_dtw
    coupling = adj[0:n, n:2 * n]
    adj[2 * n:3 * n, 0:n] = coupling
    adj[0:n, 2 * n:3 * n] = coupling
    adj[n:2 * n, 3 * n:4 * n] = coupling
    adj[3 * n:4 * n, n:2 * n] = coupling
    np.fill_diagonal(adj, 1.0)
    return adj


class FusionLayer(nn.Module):
    """One STSGCL over the fusion graph with the gated dilated-conv data
    path: x (B, T, N, C) -> (B, T - strides + 1, N, F)."""

    def __init__(self, cfg: STFGNNConfig, filters: tuple[int, ...],
                 timesteps: int, feat: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.strides = cfg.strides
        w_cnt = timesteps - cfg.strides + 1
        if cfg.temporal_emb:
            self.temporal_emb = nn.Parameter(
                3e-4 * torch.randn(1, timesteps, 1, feat,
                                   generator=generator))
        if cfg.spatial_emb:
            self.spatial_emb = nn.Parameter(
                3e-4 * torch.randn(1, 1, cfg.num_nodes, feat,
                                   generator=generator))
        self.conv1 = TimeConv(feat, filters[-1], 2, 3, generator)
        self.conv2 = TimeConv(feat, filters[-1], 2, 3, generator)
        self.n_sub = len(filters)
        for li, f in enumerate(filters):
            w = torch.empty(w_cnt, feat, 2 * f)
            self.register_parameter(
                f"w{li}", nn.Parameter(fan_in_uniform_(w, generator)))
            self.register_parameter(
                f"b{li}", nn.Parameter(torch.zeros(w_cnt, 1, 2 * f)))
            feat = f

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "temporal_emb"):
            x = x + self.temporal_emb
        if hasattr(self, "spatial_emb"):
            x = x + self.spatial_emb
        # gated dual dilated conv over time: kernel 2, dilation 3 -> T - 3
        data_res = torch.sigmoid(self.conv1(x)) * torch.tanh(self.conv2(x))
        ws = [getattr(self, f"w{li}") for li in range(self.n_sub)]
        bs = [getattr(self, f"b{li}") for li in range(self.n_sub)]
        mid = glu_graph_layers(window_stack(x, self.strides), adj, ws, bs,
                               x.shape[2])
        return mid + data_res


class STFGNN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out), with the
    (strides * N, strides * N) fusion graph passed in."""

    def __init__(self, cfg: STFGNNConfig, dim_in: int, dim_out: int,
                 horizon: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.horizon = horizon
        feat = cfg.first_layer_embedding_size
        self.first_fc = dense(dim_in, feat, generator)
        t, layers = lag, []
        for filters in cfg.hidden_dims:
            layers.append(FusionLayer(cfg, tuple(filters), t, feat,
                                      generator))
            feat, t = filters[-1], t - (cfg.strides - 1)
        self.fusion_layers = nn.ModuleList(layers)
        heads = []
        for _ in range(horizon):
            heads += [dense(t * feat, cfg.out_layer_dim, generator),
                      dense(cfg.out_layer_dim, dim_out, generator)]
        self.dense = nn.ModuleList(heads)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        x = torch.relu(linear(self.first_fc, x))
        for layer in self.fusion_layers:
            x = layer(x, adj)
        return horizon_heads(self.dense, x, self.horizon)
