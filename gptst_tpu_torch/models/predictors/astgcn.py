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

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards. The temporal attention's two sums over nodes meet (`all_sum`;
rank g reads its entries of U1 and columns of U2). The spatial
attention's rank g holds its rows of lhs, Vs and bs against the
gathered rhs, gathers the sigmoid's rows for Vs's contraction and takes
the softmax over the sharded axis 1 by meeting maxima and sums
(`NodeShards.softmax`). The attended Chebyshev conv contracts over the
rows rank g holds: partial sums, reduce-scattered. Time conv, residual,
LayerNorm and the final conv are node-local.

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

from gptst_tpu_torch.ops.dtypes import promoted, widened
from gptst_tpu_torch.ops.recurrent import xavier_uniform_
from gptst_tpu_torch.ops.temporal import TimeConv
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank


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

    def forward(self, x, shards: NodeShards | None = None):
        """x (B, T, N, F) -> (B, N, N); with `shards`, x the ranks' node
        shards and rank g's rows (B, N / G, N) of the scores."""
        if shards is None:
            x, w1, w2, w3, bs, vs = promoted(x, self.W1, self.W2, self.W3,
                                             self.bs, self.Vs)
            lhs = torch.einsum("btnf,t->bnf", x, w1) @ w2         # (B, N, T)
            rhs = torch.einsum("f,btnf->bnt", w3, x)              # (B, N, T)
            product = lhs @ rhs.transpose(1, 2)                   # (B, N, N)
            s = torch.einsum("nk,bkm->bnm", vs, torch.sigmoid(product + bs))
            return torch.softmax(s, dim=1)
        # rank g: its rows of lhs, Vs and bs against the gathered rhs; the
        # sigmoid's rows gathered for Vs's contraction over them; the
        # softmax over the sharded axis 1
        sig, vss = [], []
        rhs_all = shards.all_gather([torch.einsum(
            "f,btnf->bnt", *promoted(self.W3.to(xg.device), xg))
            for xg in x])
        for xg, rhs, bs, vs in zip(x, rhs_all,
                                   shards.split(self.bs, dim=1),
                                   shards.split(self.Vs, dim=0)):
            xg, w1, w2, rhs, bs, vs = promoted(
                xg, self.W1.to(xg.device), self.W2.to(xg.device), rhs, bs,
                vs)
            lhs = torch.einsum("btnf,t->bnf", xg, w1) @ w2
            sig.append(torch.sigmoid(lhs @ rhs.transpose(1, 2) + bs))
            vss.append(vs)
        return shards.softmax([torch.einsum("nk,bkm->bnm", vs, s)
                               for vs, s in zip(vss, shards.all_gather(
                                   sig, dim=1))], dim=1)


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

    def forward(self, x, shards: NodeShards | None = None) -> torch.Tensor:
        """x (B, T, N, F), or with `shards` the ranks' node shards (the
        two sums over nodes meet); (B, T, T), on every rank with
        `shards`."""
        if shards is None:
            x, u1, u2, u3, be, ve = promoted(x, self.U1, self.U2, self.U3,
                                             self.be, self.Ve)
            lhs = torch.einsum("btnf,n->btf", x, u1) @ u2         # (B, T, N)
            rhs = torch.einsum("f,btnf->bnt", u3, x)              # (B, N, T)
            product = lhs @ rhs                                   # (B, T, T)
            return self._scores(product, be, ve)
        u1s, u2s = shards.split(self.U1, dim=0), shards.split(self.U2, dim=1)
        lhs = shards.all_sum([torch.einsum("btnf,n->btf", *promoted(xg, u1))
                              for xg, u1 in zip(x, u1s)])
        product = shards.all_sum([
            torch.matmul(*promoted(lf, u2)) @ torch.einsum(
                "f,btnf->bnt", *promoted(self.U3.to(xg.device), xg))
            for xg, lf, u2 in zip(x, lhs, u2s)])
        return [self._scores(*promoted(p, self.be.to(p.device)),
                             self.Ve.to(p.device, p.dtype))
                for p in product]

    @staticmethod
    def _scores(product, be, ve) -> torch.Tensor:
        e = torch.einsum("ts,bsr->btr", ve, torch.sigmoid(product + be))
        return torch.softmax(e, dim=1)


def attended_cheb_conv(x: torch.Tensor, cheb: torch.Tensor,
                       s_at: torch.Tensor,
                       theta: torch.Tensor) -> torch.Tensor:
    """relu(sum_k sum_m (T_k ⊙ S)[b, m, n] x[b, t, m, i] Θ_k[i, o]):
    x (B, T, N, F), cheb (K, N, N), s_at (B, N, N), theta (K, F, O) ->
    (B, T, N, O). The (K, B, N, N) attended stack is one batched
    product with x Θ_k (the reference loops over time, `:100-131`)."""
    return torch.relu(attended_cheb_sum(x, cheb, s_at, theta))


def attended_cheb_sum(x: torch.Tensor, cheb: torch.Tensor,
                      s_at: torch.Tensor, theta: torch.Tensor
                      ) -> torch.Tensor:
    """`attended_cheb_conv` before its relu, over the nodes m of x's,
    cheb's and s_at's rows: x (B, T, M, F), cheb (K, M, N), s_at
    (B, M, N) -> (B, T, N, O), a partial sum where M is a rank's
    nodes."""
    k, b, t = cheb.shape[0], *x.shape[:2]
    n = cheb.shape[2]
    x, cheb, s_at, theta = promoted(x, cheb, s_at, theta)
    a = cheb[:, None] * s_at[None]                            # (K, B, M, N)
    xt = torch.einsum("btmi,kio->kbmto", x, theta)            # (K, B, M, T, O)
    out = torch.bmm(a.flatten(0, 1).transpose(1, 2),
                    xt.flatten(0, 1).flatten(2))
    out = out.reshape(k, b, n, t, -1).sum(0)                  # (B, N, T, O)
    return out.transpose(1, 2)


def sharded_attended_cheb_conv(xs: list, cheb: torch.Tensor, s_at: list,
                               theta: torch.Tensor,
                               shards: NodeShards) -> list:
    """`attended_cheb_conv` on the ranks' node shards: the contraction
    runs over the first node index m of (T_k ⊙ S)[b, m, n], the rows
    rank g holds, so each rank's partial over its m (B, T, N, O) is
    reduce-scattered (the Aᵀ form of `NodeRows.matmul`), then relu."""
    parts = [widened(attended_cheb_sum(xg, c, sg, theta.to(xg.device)))
             for xg, c, sg in zip(xs, shards.split(cheb, dim=1), s_at)]
    dt = torch.promote_types(torch.promote_types(xs[0].dtype, theta.dtype),
                             cheb.dtype)
    return [torch.relu(p.to(dt)) for p in shards.reduce_scatter(parts)]


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

    def forward(self, x, cheb: torch.Tensor,
                shards: NodeShards | None = None):
        e = self.temporal_att(x, shards)
        # x_TAt[..., t] = sum_s x[..., s] E[s, t] on the flattened (N, F)
        x_tat = per_rank(lambda xg, eg: torch.einsum(
            "bsnf,bst->btnf", *promoted(xg, eg)), x, e)
        s_at = self.spatial_att(x_tat, shards)
        if shards is None:
            gcn = attended_cheb_conv(x, cheb, s_at, self.Theta)
        else:
            gcn = sharded_attended_cheb_conv(x, cheb, s_at, self.Theta,
                                             shards)
        h = per_rank(lambda r, t: torch.relu(r + t),
                     each(self.residual_conv, x, shards),
                     each(self.time_conv, gcn, shards))
        return each(self.norm, h, shards, _layer_norm)


def _layer_norm(norm: nn.LayerNorm, h: torch.Tensor) -> torch.Tensor:
    h, w, b = promoted(h, norm.weight, norm.bias)
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

    def forward(self, x, cheb: torch.Tensor,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise."""
        for block in self.block:
            x = block(x, cheb, shards)
        return per_rank(self._final, x)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, f = x.shape
        x, w, bias = promoted(x, self.final_w.to(x.device),
                              self.final_b.to(x.device))
        # the final conv's kernel spans the feature axis, the time axis
        # acting as input channels (`ASTGCN.py:294, 309-311`)
        out = x.transpose(1, 2).reshape(b, n, t * f) @ w.flatten(0, 1) + bias
        out = out.reshape(b, n, self.horizon, self.dim_out)
        return out.transpose(1, 2)
