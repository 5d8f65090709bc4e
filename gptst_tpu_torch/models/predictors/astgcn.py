"""ASTGCN: attention-based spatio-temporal graph convolutional network.

Counterpart of the JAX package's `models/predictors/astgcn.py` (the
reference's `model/ASTGCN/ASTGCN.py`): a low-rank bilinear temporal
attention E (T x T) re-mixes the time axis, a spatial attention S
(N x N) modulates a K = 3 Chebyshev conv (T_k ⊙ S), then a (3, 1)
temporal conv + 1x1 residual + LayerNorm over channels, twice, and a
final conv over the feature axis that emits every horizon step at once
(`ASTGCN.py:294-311`). Both attentions take their softmax over axis 1,
as the reference does. Defaults follow `conf/ASTGCN/*.conf` (2 blocks,
K 3, 64/64 filters, time_strides 1).

No kernel of `csrc/` is on this path: the attended Chebyshev conv is
dense, (K, B, N, N) materialised, as in the JAX package.

Init as the JAX package's (the reference's global xavier sweep,
`model/Run.py:79-85`): matrices xavier uniform with flax's fans
(`ops/recurrent.flax_fans`), vectors U[0, 1), convs lecun normal with
zero biases, LayerNorm ones and zeros (epsilon 1e-6, flax's).

Parameters, by the flax scope each one mirrors (`convert.py`):
  block.{i}                 ASTGCNBlock_{i}: `Theta` (K, F, O)
    .temporal_att           TemporalAttention_0 (U1, U2, U3, be, Ve)
    .spatial_att            SpatialAttention_0 (W1, W2, W3, bs, Vs)
    .time_conv              time_conv (`ops/temporal.TimeConv`)
    .residual_conv          residual_conv (`TimeConv`)
    .norm                   LayerNorm_0 (`weight` = flax's `scale`, `bias`)
  final_w (T, F, H * D), final_b
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.ops.dtypes import promoted
from gptst_tpu_torch.ops.recurrent import xavier_uniform_
from gptst_tpu_torch.ops.temporal import TimeConv


@dataclasses.dataclass(frozen=True)
class ASTGCNConfig:
    num_nodes: int
    nb_block: int = 2
    K: int = 3
    nb_chev_filter: int = 64
    nb_time_filter: int = 64
    time_strides: int = 1


def _xavier(shape, generator) -> nn.Parameter:
    return nn.Parameter(xavier_uniform_(torch.empty(shape), generator))


def _unit_uniform(shape, generator) -> nn.Parameter:
    """flax `uniform(scale=1.0)`: U[0, 1)."""
    return nn.Parameter(torch.rand(shape, generator=generator))


class SpatialAttention(nn.Module):
    """(B, T, N, F) -> (B, N, N) scores, softmax over axis 1
    (`ASTGCN.py:49-78`)."""

    def __init__(self, timesteps: int, num_nodes: int, feat: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        t, n = timesteps, num_nodes
        self.W1 = _unit_uniform((t,), generator)
        self.W2 = _xavier((feat, t), generator)
        self.W3 = _unit_uniform((feat,), generator)
        self.bs = _xavier((1, n, n), generator)
        self.Vs = _xavier((n, n), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w1, w2, w3, bs, vs = promoted(x, self.W1, self.W2, self.W3,
                                         self.bs, self.Vs)
        lhs = torch.einsum("btnf,t->bnf", x, w1) @ w2         # (B, N, T)
        rhs = torch.einsum("f,btnf->bnt", w3, x)              # (B, N, T)
        product = lhs @ rhs.transpose(1, 2)                   # (B, N, N)
        s = torch.einsum("nk,bkm->bnm", vs, torch.sigmoid(product + bs))
        return torch.softmax(s, dim=1)


class TemporalAttention(nn.Module):
    """(B, T, N, F) -> (B, T, T) scores, softmax over axis 1
    (`ASTGCN.py:134-163`)."""

    def __init__(self, timesteps: int, num_nodes: int, feat: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        t, n = timesteps, num_nodes
        self.U1 = _unit_uniform((n,), generator)
        self.U2 = _xavier((feat, n), generator)
        self.U3 = _unit_uniform((feat,), generator)
        self.be = _xavier((1, t, t), generator)
        self.Ve = _xavier((t, t), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, u1, u2, u3, be, ve = promoted(x, self.U1, self.U2, self.U3,
                                         self.be, self.Ve)
        lhs = torch.einsum("btnf,n->btf", x, u1) @ u2         # (B, T, N)
        rhs = torch.einsum("f,btnf->bnt", u3, x)              # (B, N, T)
        product = lhs @ rhs                                   # (B, T, T)
        e = torch.einsum("ts,bsr->btr", ve, torch.sigmoid(product + be))
        return torch.softmax(e, dim=1)


def attended_cheb_conv(x: torch.Tensor, cheb: torch.Tensor,
                       s_at: torch.Tensor,
                       theta: torch.Tensor) -> torch.Tensor:
    """relu(sum_k sum_m (T_k ⊙ S)[b, m, n] x[b, t, m, i] Θ_k[i, o]):
    x (B, T, N, F), cheb (K, N, N), s_at (B, N, N), theta (K, F, O) ->
    (B, T, N, O). The (K, B, N, N) attended stack is one batched
    product with x Θ_k (the reference loops over time, `:100-131`)."""
    k, b, t, n = cheb.shape[0], *x.shape[:3]
    x, cheb, s_at, theta = promoted(x, cheb, s_at, theta)
    a = cheb[:, None] * s_at[None]                            # (K, B, M, N)
    xt = torch.einsum("btmi,kio->kbmto", x, theta)            # (K, B, M, T, O)
    out = torch.bmm(a.flatten(0, 1).transpose(1, 2),
                    xt.flatten(0, 1).flatten(2))
    out = out.reshape(k, b, n, t, -1).sum(0)                  # (B, N, T, O)
    return torch.relu(out.transpose(1, 2))


class ASTGCNBlock(nn.Module):
    """TAt -> SAt -> attended Chebyshev conv -> time conv + residual ->
    LayerNorm (`ASTGCN.py:217-255`)."""

    def __init__(self, cfg: ASTGCNConfig, timesteps: int, feat: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        n, s = cfg.num_nodes, cfg.time_strides
        self.temporal_att = TemporalAttention(timesteps, n, feat, generator)
        self.spatial_att = SpatialAttention(timesteps, n, feat, generator)
        self.Theta = _xavier((cfg.K, feat, cfg.nb_chev_filter), generator)
        self.time_conv = TimeConv(cfg.nb_chev_filter, cfg.nb_time_filter, 3,
                                  padding=(1, 1), stride=s,
                                  generator=generator)
        self.residual_conv = TimeConv(feat, cfg.nb_time_filter, 1, stride=s,
                                      generator=generator)
        self.norm = nn.LayerNorm(cfg.nb_time_filter, eps=1e-6)

    def forward(self, x: torch.Tensor, cheb: torch.Tensor) -> torch.Tensor:
        e = self.temporal_att(x)
        # x_TAt[..., t] = sum_s x[..., s] E[s, t] on the flattened (N, F)
        x_tat = torch.einsum("bsnf,bst->btnf", *promoted(x, e))
        gcn = attended_cheb_conv(x, cheb, self.spatial_att(x_tat),
                                 self.Theta)
        h = torch.relu(self.residual_conv(x) + self.time_conv(gcn))
        h, w, b = promoted(h, self.norm.weight, self.norm.bias)
        return F.layer_norm(h, w.shape, w, b, eps=1e-6)


class ASTGCN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out), with the
    (K, N, N) Chebyshev stack passed in."""

    def __init__(self, cfg: ASTGCNConfig, dim_in: int, dim_out: int,
                 horizon: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.dim_out, self.horizon = cfg, dim_out, horizon
        blocks, t, feat = [], lag, dim_in
        for i in range(cfg.nb_block):
            blocks.append(ASTGCNBlock(cfg, t, feat, generator))
            # the block keeps `timesteps` of its input; T shrinks by the
            # stride only after block 0 (`astgcn.py:127`)
            t = t // cfg.time_strides if i == 0 else t
            feat = cfg.nb_time_filter
        self.block = nn.ModuleList(blocks)
        t_out = lag
        for _ in range(cfg.nb_block):
            t_out = (t_out - 1) // cfg.time_strides + 1
        self.final_w = _xavier((t_out, cfg.nb_time_filter,
                                horizon * dim_out), generator)
        self.final_b = _unit_uniform((horizon * dim_out,), generator)

    def forward(self, x: torch.Tensor, cheb: torch.Tensor) -> torch.Tensor:
        for block in self.block:
            x = block(x, cheb)
        b, t, n, f = x.shape
        x, w, bias = promoted(x, self.final_w, self.final_b)
        # the final conv's kernel spans the feature axis, the time axis
        # acting as input channels (`ASTGCN.py:294, 309-311`)
        out = x.transpose(1, 2).reshape(b, n, t * f) @ w.flatten(0, 1) + bias
        out = out.reshape(b, n, self.horizon, self.dim_out)
        return out.transpose(1, 2)
