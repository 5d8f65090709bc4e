"""ST-MGCN: spatio-temporal multi-graph convolutional network (demand).

Counterpart of the JAX package's `models/predictors/stmgcn.py` (the
reference's `model/STMGCN_demand/STMGCN.py` + `GCN.py`): for each of
M = 2 graphs (distance, Pearson correlation) a context-gated LSTM (the
node's temporal profile is graph-convolved, pooled over nodes and
squeezed through one `fc` applied twice into per-step sigmoid gates
that re-weight the sequence, `STMGCN.py:36-49` eq. 6-9) feeds a 3-layer
LSTM shared by all B * N node sequences; its last state runs through a
K-support GCN, and the graphs' outputs are summed into a linear head
that emits every horizon step (`:110-129`). The supports are
Chebyshev stacks of K = 2 (3 terms) per graph, dense (`GCN.py:61-140`).
Defaults follow `conf/STMGCN_demand/*.conf` (LSTM 64 x 3, GCN 64).

No kernel of `csrc/` is on this path: the graph products are dense
einsums, as in the JAX package. The LSTM is stepped in Python, each step
under `ops/recurrent.remat_cell` ("auto" resolves by node count).

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards, and the stacks a `MeshRows` that holds rank g's
(M, K + 1, N / G, N) rows of them. Each graph product is rank g's rows
times the all-gathered features, the context gate's node mean the sum
of the ranks' partial sums over N (`NodeShards.all_sum`); the gate's
`fc`, the LSTM and the head are node-local.

Parameters, by the flax scope each one mirrors (`convert.py`):
  cg_lstm.{m}       cg_lstm{m}: `gconv_temporal` (W, b), `fc`
                    (nn.Linear) and `lstm.{l}`, flax's
                    `OptimizedLSTMCell_{l}` in torch `nn.LSTM`'s layout
                    (`weight_ih`, `weight_hh`, `bias_hh`)
  gcn.{m}           gcn{m} (W, b)
  fc                fc (nn.Linear)
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted
from gptst_tpu_torch.ops.recurrent import (
    LSTMStack, resolve_remat, xavier_normal_,
)
from gptst_tpu_torch.ops.temporal import dense
from gptst_tpu_torch.parallel.mesh import NodeShards


@dataclasses.dataclass(frozen=True)
class STMGCNConfig:
    num_nodes: int
    m_graphs: int = 2
    lstm_hidden_dim: int = 64
    lstm_num_layers: int = 3
    gcn_hidden_dim: int = 64
    cheb_k: int = 2
    # activation remat for the LSTM steps: auto|none|full|dots
    # (`ops/recurrent.remat_cell`; "auto" resolves by node count)
    remat: str = "auto"


class MultiSupportGCN(nn.Module):
    """K-support graph conv (`GCN.py:5-42`): [A_k x]_k concatenated on
    channels, then relu(x W + b) (W (K * C, H) xavier normal, b zero).
    Given rows of the supports ((K, n, N) of them) it gives those rows
    of the product."""

    def __init__(self, k: int, c_in: int, hidden: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.W = nn.Parameter(torch.empty(k * c_in, hidden))
        self.b = nn.Parameter(torch.zeros(hidden))
        xavier_normal_(self.W, generator)

    def forward(self, supports: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:  # (K, N, N), (B, N, C)
        supports, x, w, b = promoted(supports, x, self.W, self.b)
        sup = torch.einsum("knm,bmc->bnkc", supports, x)
        return torch.relu(sup.flatten(2) @ w + b)


class ContextGatedLSTM(nn.Module):
    """The CG-LSTM of one graph (`STMGCN.py:5-49`): obs (B, T, N, D) ->
    the last LSTM state of every node (B, N, H)."""

    def __init__(self, cfg: STMGCNConfig, seq_len: int, dim_in: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.remat = cfg.remat
        self.gconv_temporal = MultiSupportGCN(cfg.cheb_k + 1, seq_len,
                                              seq_len, generator=generator)
        self.fc = dense(seq_len, seq_len, generator)   # shared twice (`:43`)
        self.lstm = LSTMStack(dim_in, cfg.lstm_hidden_dim,
                              cfg.lstm_num_layers, generator)

    def forward(self, supports, obs, shards: NodeShards | None = None):
        """With `shards`, obs and the result are the lists of the ranks'
        node shards and `supports` the ranks' rows of the stack."""
        if shards is None:
            x_seq = obs.sum(-1).transpose(1, 2)              # (B, N, T)
            x_hat = x_seq + self.gconv_temporal(supports, x_seq)  # eq. 6
            return self._gated_lstm(obs, x_hat.mean(dim=1),   # eq. 7
                                    obs.shape[2])
        x_seq = [o.sum(-1).transpose(1, 2) for o in obs]
        x_hat = [x + shards.module_on(self.gconv_temporal, g)(a, whole)
                 for g, (x, a, whole) in enumerate(zip(
                     x_seq, supports, shards.all_gather(x_seq)))]
        z = shards.all_sum([h.sum(dim=1) for h in x_hat])
        return [shards.module_on(self, g)._gated_lstm(o, zg / shards.n,
                                                      shards.n)
                for g, (o, zg) in enumerate(zip(obs, z))]

    def _gated_lstm(self, obs: torch.Tensor, z: torch.Tensor,
                    n: int) -> torch.Tensor:
        """The gate of eq. 8-9 from x_hat's node mean z (B, T), and the
        LSTM on obs's nodes (B, T, n, D) -> (B, n, H); `n`: the model's
        node count, which the remat policy reads."""
        b, t, m, d = obs.shape
        s = torch.sigmoid(linear(self.fc, torch.relu(linear(self.fc, z))))
        rew = obs * s[:, :, None, None]                      # eq. 9
        seq = rew.transpose(1, 2).reshape(b * m, t, d)
        h = self.lstm(seq, resolve_remat(self.remat, n))
        return h.reshape(b, m, -1)


class STMGCN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, T, N, dim_out), with the (M, K, N, N)
    support stacks passed in."""

    def __init__(self, cfg: STMGCNConfig, dim_in: int, dim_out: int,
                 seq_len: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.dim_out = cfg, dim_out
        m, k = cfg.m_graphs, cfg.cheb_k + 1
        self.cg_lstm = nn.ModuleList(
            ContextGatedLSTM(cfg, seq_len, dim_in, generator)
            for _ in range(m))
        self.gcn = nn.ModuleList(
            MultiSupportGCN(k, cfg.lstm_hidden_dim, cfg.gcn_hidden_dim,
                            generator=generator) for _ in range(m))
        self.fc = dense(cfg.gcn_hidden_dim, dim_out * seq_len, generator)

    def forward(self, x, support_stacks,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards (then `support_stacks` is a `MeshRows`); the output
        likewise."""
        if shards is None:
            fused = sum(gcn(sup, cg(sup, x)) for cg, gcn, sup in zip(
                self.cg_lstm, self.gcn, support_stacks))      # (B, N, H)
            return self._head(self.fc, fused, x.shape[1])
        rows = support_stacks.of(shards)      # rank g's (M, K, N / G, N)
        fused = None
        for m, (cg, gcn) in enumerate(zip(self.cg_lstm, self.gcn)):
            sup = [r[m] for r in rows]
            out = [shards.module_on(gcn, g)(a, whole)
                   for g, (a, whole) in enumerate(zip(
                       sup, shards.all_gather(cg(sup, x, shards))))]
            fused = out if fused is None else [
                f + o for f, o in zip(fused, out)]
        return [self._head(shards.module_on(self.fc, g), f, x[0].shape[1])
                for g, f in enumerate(fused)]

    def _head(self, fc: nn.Linear, fused: torch.Tensor,
              t: int) -> torch.Tensor:
        """(B, n, H) -> every step's output (B, t, n, dim_out)."""
        b, n, _ = fused.shape
        out = linear(fc, fused).reshape(b, n, t, self.dim_out)
        return out.transpose(1, 2)
