"""STSGCN: spatio-temporal synchronous graph convolutional network.

Counterpart of the JAX package's `models/predictors/stsgcn.py` (the
reference's `model/STSGCN/STSGCN.py`): a 3N x 3N localized synchronous
adjacency (block-diagonal copies of A, cross-step self edges and the
identity, `construct_adj` `:237-253`), GLU graph-conv modules that crop
the middle N rows and take the max over their 3 sub-layers (`:29-82`),
applied over sliding 3-step windows with weights of their own per
window (`:114-154`), and one output head per horizon step (`:310-313`).
Defaults follow `conf/STSGCN/*.conf` (4 layers of [64, 64, 64], GLU,
first_layer_embedding_size 64, loss mask_huber).

As in the JAX package, all windows are batched into one (B, W, 3N, C)
tensor and the per-window weights into a (W, C, F) stack: one dense
product with the adjacency and one batched einsum per sub-layer. No
kernel of `csrc/` is on this path.

Init: the per-window weights U(+-1/sqrt(fan_in)) with flax's fan_in =
C * W (`ops/recurrent.fan_in_uniform_`), zero biases, zero position
embeddings (`:15-18`), Dense layers lecun normal with zero biases.

Parameters, by the flax scope each one mirrors (`convert.py`):
  dense.{k}         Dense_{k}: the first-layer embedding (when
                    first_layer_embedding_size), then per horizon step
                    its 128-wide layer and its output layer
  sync_layers.{i}   SyncLayer_{i}: temporal_emb, spatial_emb, w{l}, b{l}
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted
from gptst_tpu_torch.ops.recurrent import fan_in_uniform_
from gptst_tpu_torch.ops.temporal import dense


@dataclasses.dataclass(frozen=True)
class STSGCNConfig:
    num_nodes: int
    filter_list: tuple = ((64, 64, 64),) * 4
    feature_dim: int = 64
    activation: str = "GLU"
    temporal_emb: bool = True
    spatial_emb: bool = True
    steps: int = 3
    first_layer_embedding_size: int = 64


def construct_sync_adj(a: np.ndarray, steps: int = 3) -> np.ndarray:
    """Block-diagonal A copies + adjacent-step self edges + I
    (`STSGCN.py:237-253`)."""
    n = a.shape[0]
    adj = np.zeros((n * steps, n * steps), dtype=np.float32)
    for i in range(steps):
        adj[i * n:(i + 1) * n, i * n:(i + 1) * n] = a
    for k in range(steps - 1):
        idx = np.arange(n)
        adj[k * n + idx, (k + 1) * n + idx] = 1.0
        adj[(k + 1) * n + idx, k * n + idx] = 1.0
    np.fill_diagonal(adj, 1.0)
    return adj


def window_stack(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, T, N, C) -> the T - width + 1 sliding windows of `width`
    steps, each flattened to width * N rows: (B, W, width * N, C)."""
    b, t, n, c = x.shape
    wins = torch.stack([x[:, i:i + width] for i in range(t - width + 1)],
                       dim=1)
    return wins.reshape(b, t - width + 1, width * n, c)


def glu_graph_layers(h: torch.Tensor, adj: torch.Tensor, ws, bs,
                     n: int, glu: bool = True) -> torch.Tensor:
    """Sub-layers A h -> GLU (or relu) of h W_w + b_w on the windows
    h (B, W, sN, C), each cropped to the rows [N, 2N) (the windows'
    second step); the max over the sub-layers' crops (B, W, N, F)
    (`STSGCN.py:29-82`)."""
    crops = []
    for w, b in zip(ws, bs):
        h, adj_, w, b = promoted(h, adj, w, b)
        h = torch.einsum("mn,bwnc->bwmc", adj_, h)
        z = torch.einsum("bwnc,wcf->bwnf", h, w) + b
        if glu:
            lhs, rhs = z.chunk(2, dim=-1)
            h = lhs * torch.sigmoid(rhs)
        else:
            h = torch.relu(z)
        crops.append(h[:, :, n:2 * n])
    return torch.stack(crops).amax(dim=0)


class SyncLayer(nn.Module):
    """One STSGCL with weights of its own per window, vectorized: x
    (B, T, N, C) -> (B, T - 2, N, F)."""

    def __init__(self, cfg: STSGCNConfig, filters: tuple[int, ...],
                 timesteps: int, num_nodes: int, feat: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.glu = cfg.activation == "GLU"
        w_cnt = timesteps - 2
        if cfg.temporal_emb:
            self.temporal_emb = nn.Parameter(torch.zeros(1, timesteps, 1,
                                                         feat))
        if cfg.spatial_emb:
            self.spatial_emb = nn.Parameter(torch.zeros(1, 1, num_nodes,
                                                        feat))
        self.n_sub = len(filters)
        for li, f in enumerate(filters):
            width = 2 * f if self.glu else f
            w = torch.empty(w_cnt, feat, width)
            self.register_parameter(
                f"w{li}", nn.Parameter(fan_in_uniform_(w, generator)))
            self.register_parameter(
                f"b{li}", nn.Parameter(torch.zeros(w_cnt, 1, width)))
            feat = f

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "temporal_emb"):
            x = x + self.temporal_emb
        if hasattr(self, "spatial_emb"):
            x = x + self.spatial_emb
        ws = [getattr(self, f"w{li}") for li in range(self.n_sub)]
        bs = [getattr(self, f"b{li}") for li in range(self.n_sub)]
        return glu_graph_layers(window_stack(x, 3), adj, ws, bs,
                                x.shape[2], self.glu)


def horizon_heads(dense_layers, x: torch.Tensor,
                  horizon: int) -> torch.Tensor:
    """Per-horizon heads (`STSGCN.py:310-313`): head k, the linear pair
    `dense_layers[2k]`, `[2k + 1]`, maps each node's flattened (T, C) to
    step k. x (B, T, N, C) -> (B, horizon, N, D)."""
    b, t, n, c = x.shape
    flat = x.transpose(1, 2).reshape(b, n, t * c)
    return torch.stack([linear(dense_layers[2 * k + 1],
                               linear(dense_layers[2 * k], flat))
                        for k in range(horizon)], dim=1)


class STSGCN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out), with the
    (3N, 3N) synchronous adjacency passed in."""

    def __init__(self, cfg: STSGCNConfig, dim_in: int, dim_out: int,
                 horizon: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.horizon = cfg, horizon
        feat = min(dim_in, cfg.feature_dim)
        layers = []
        if cfg.first_layer_embedding_size:
            layers.append(dense(feat, cfg.first_layer_embedding_size,
                                generator))
            feat = cfg.first_layer_embedding_size
        t, sync = lag, []
        for filters in cfg.filter_list:
            sync.append(SyncLayer(cfg, tuple(filters), t, cfg.num_nodes,
                                  feat, generator))
            feat, t = filters[-1], t - 2
        self.sync_layers = nn.ModuleList(sync)
        for _ in range(horizon):
            layers += [dense(t * feat, 128, generator),
                       dense(128, dim_out, generator)]
        self.dense = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x[..., :cfg.feature_dim]
        heads = list(self.dense)
        if cfg.first_layer_embedding_size:
            x = torch.relu(linear(heads.pop(0), x))
        for layer in self.sync_layers:
            x = layer(x, adj)
        return horizon_heads(heads, x, self.horizon)
