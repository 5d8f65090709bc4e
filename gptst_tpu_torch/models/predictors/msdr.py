"""MSDR — multi-step dependency relation networks (GMSDR).

Counterpart of the JAX package's `models/predictors/msdr.py` (and of
the reference's `model/MSDR/gmsdr_model.py` + `gmsdr_cell.py`): a
seq2seq stack of GMSDR cells that keep a rolling window of the last
`pre_k` hidden states. Per step:

  preH   = concat of the last pre_v hidden states
  conv   = leaky_relu(gconv([x ‖ preH]))   # diffusion over the dual
           random-walk supports and the learned adjacency
  output = conv @ W + b + attention(hx_k + R)
  hx_k  <- shift-append(output)

W, b, R and the attention linear start at zero as in the reference; the
gconv bias starts at 1.0. The time loops are Python loops over a step
of the layer stack, the carry a tuple with one (B, K, N, U) window per
layer. Each layer's learned adjacency is built once per forward, from
its own node-embedding pair: dense `softmax(relu(E1 E2))` without a
pattern, `kernels/sddmm.adaptive_support` on an `SDDMMPattern` (the
path above the dense threshold). Defaults follow `conf/MSDR/*.conf`.

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): the carry, x and every activation are lists of the
ranks' node shards. The static supports are `ShardedSupport`s that take
and give the shards (`ShardedSupport.on_shards`: the halo exchange, no
gather); each learned adjacency is a `NodeRows`, rank g's rows from its
rows of E1 and the whole E2; the attention logits sum over nodes, the
ranks' partial sums meeting (`all_sum`); rank g reads its rows of b, R
and att_w.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gptst_tpu_torch.graph.artifacts import asym_adj
from gptst_tpu_torch.kernels.sddmm import adaptive_support
from gptst_tpu_torch.ops.graph_conv import (
    adaptive_rows, graph_matmul, refuse_promoting_dense_support,
)
from gptst_tpu_torch.ops.recurrent import (
    remat_cell, resolve_remat, variance_scaling_, xavier_normal_,
)
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank


@dataclasses.dataclass(frozen=True)
class MSDRConfig:
    num_nodes: int
    rnn_units: int = 64
    num_rnn_layers: int = 2
    max_diffusion_step: int = 1
    pre_k: int = 4
    pre_v: int = 1
    adapt_rank: int = 10
    # activation remat of the time loop: auto|none|full|dots; "auto"
    # resolves to "full" from 32768 nodes, as in the JAX package (the
    # cell recompute is SpMM-heavy, so below that storing wins)
    remat: str = "auto"


def dual_random_walk_supports(adj: np.ndarray) -> list[np.ndarray]:
    """[(D^-1 A)^T, (D^-1 A^T)^T] (`gmsdr_cell.py:86-89`)."""
    return [asym_adj(adj).T.copy(), asym_adj(adj.T).T.copy()]


def _pick_chunk(t: int) -> int:
    """Largest divisor of t no bigger than ceil(t/2): 2+ segments, so
    the stored boundary carries drop by the segment count."""
    for chunk in range(-(-t // 2), 0, -1):
        if t % chunk == 0:
            return chunk
    return t


class GMSDRCell(nn.Module):
    """One layer's step: (hx_k, x) -> (hx_k', output). Parameters keep
    the flax names and layouts (`gconv_w` is (num_mats * Z, U))."""

    def __init__(self, cfg: MSDRConfig, dim_in: int, num_supports: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, u = cfg, cfg.rnn_units
        self.cfg = cfg
        zdim = dim_in + c.pre_v * u
        num_mats = 1 + (num_supports + 1) * c.max_diffusion_step
        self.gconv_w = nn.Parameter(torch.empty(num_mats * zdim, u))
        xavier_normal_(self.gconv_w, generator)
        self.gconv_b = nn.Parameter(torch.ones(u))
        self.W = nn.Parameter(torch.zeros(u, u))
        self.b = nn.Parameter(torch.zeros(c.num_nodes, u))
        self.R = nn.Parameter(torch.zeros(c.pre_k, c.num_nodes, u))
        self.att_w = nn.Parameter(torch.zeros(c.num_nodes * u, 1))
        self.att_b = nn.Parameter(torch.zeros(1))

    def forward(self, hx_k, x, supports, adp,
                shards: NodeShards | None = None) -> tuple:
        # hx_k: (B, K, N, U); x: (B, N, Din); supports: the static
        # supports; adp: this layer's learned adjacency. With `shards`,
        # hx_k and x are the lists of the ranks' node shards, the
        # supports `ShardedSupport`s and adp a `NodeRows`, and so are
        # the step's outputs
        c = self.cfg

        def window(h, xg):
            b, _, n, u = h.shape
            pre_h = h[:, -c.pre_v:].movedim(1, 2).reshape(b, n, c.pre_v * u)
            return torch.cat([xg, pre_h], dim=-1)             # (B, N, Z)

        z = per_rank(window, hx_k, x)
        mats = [z]
        for sup in supports:
            h1 = graph_matmul(sup, z)
            mats.append(h1)
            h0 = z
            for _ in range(2, c.max_diffusion_step + 1):
                h2 = per_rank(lambda a, b: 2 * a - b, graph_matmul(sup, h1),
                              h0)
                mats.append(h2)
                h1, h0 = h2, h1
        h1 = graph_matmul(adp, z)
        mats.append(h1)
        h0 = z
        for _ in range(2, c.max_diffusion_step + 1):
            h2 = per_rank(torch.sub, graph_matmul(adp, h1), h0)
            mats.append(h2)
            h1, h0 = h2, h1
        conv = per_rank(lambda *ms: self._gconv(ms), *mats)

        # pre_k attention with the logits and the weighted sum split
        # into the hx_k term and the constant R term, so (hx_k + R) is
        # never stored; the logits sum over nodes, so the ranks meet
        u = c.rnn_units
        aw = self.att_w.reshape(-1, u)
        if shards is None:
            return self._attend(conv, hx_k, self.R, self.b,
                                self._logits(hx_k, aw, self.R))
        parts = list(zip(hx_k, shards.split(aw, dim=0),
                         shards.split(self.R, dim=1),
                         shards.split(self.b, dim=0)))
        logits = shards.all_sum([self._logits(h, a, r)
                                 for h, a, r, _ in parts])
        return tuple(map(list, zip(*(
            self._attend(cg, h, r, b, lg)
            for cg, (h, _, r, b), lg in zip(conv, parts, logits)))))

    def _gconv(self, mats) -> torch.Tensor:
        # gconv as a sum of per-matrix products, not `concat @ W`: each
        # diffusion output is read once and no (B, N, num_mats * Z)
        # concatenation is stored
        zdim = mats[0].shape[-1]
        w = self.gconv_w.to(mats[0].device)
        pre = self.gconv_b.to(mats[0].device)
        for i, m in enumerate(mats):
            pre = pre + m @ w[i * zdim:(i + 1) * zdim]
        return F.leaky_relu(pre, 0.01)

    @staticmethod
    def _logits(hx_k, aw, r) -> torch.Tensor:
        """The attention logits' sum over the nodes of hx_k (B, K, n, U),
        aw (n, U) and R (K, n, U): (B, K)."""
        return (torch.einsum("bknu,nu->bk", hx_k, aw)
                + torch.einsum("knu,nu->k", r, aw)[None])

    def _attend(self, conv, hx_k, r, b, logits) -> tuple:
        """The step's output and the shifted window, from the summed
        logits, on the nodes of hx_k, R and b."""
        dev = conv.device
        weight = torch.softmax(logits + self.att_b.to(dev), dim=1)  # (B, K)
        att = (torch.einsum("bk,bknu->bnu", weight, hx_k)
               + torch.einsum("bk,knu->bnu", weight, r))
        output = conv @ self.W.to(dev) + b[None] + att
        hx_k = torch.cat([hx_k[:, 1:], output[:, None]], dim=1)
        return hx_k, output


def _linear(dim_in: int, dim_out: int,
            generator: torch.Generator | None) -> nn.Linear:
    """flax `Dense`: lecun_normal kernel, zero bias."""
    lin = nn.Linear(dim_in, dim_out)
    variance_scaling_(lin.weight, dim_in, generator)
    nn.init.zeros_(lin.bias)
    return lin


class MSDR(nn.Module):
    """x: (B, T, N, dim_in) -> (B, T, N, dim_out).

    Parameters, with flax's names (`convert.py` maps the trees):
    `enc_mlp`, `nodevec{1,2}_{enc,dec}{i}` (E1 (N, r), E2 (r, N) of
    layer i's learned adjacency), `encoder.{i}` / `decoder.{i}` (the
    cells, flax's `encoder/cell{i}`) and `projection`.
    """

    def __init__(self, cfg: MSDRConfig, dim_in: int, dim_out: int,
                 num_supports: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = self.cfg = cfg
        u, n, r = c.rnn_units, c.num_nodes, c.adapt_rank
        self.enc_mlp = _linear(dim_in, u, generator)
        for tag in ("enc", "dec"):
            for i in range(c.num_rnn_layers):
                self.register_parameter(f"nodevec1_{tag}{i}", nn.Parameter(
                    torch.randn(n, r, generator=generator)))
                self.register_parameter(f"nodevec2_{tag}{i}", nn.Parameter(
                    torch.randn(r, n, generator=generator)))
        self.encoder = nn.ModuleList(
            GMSDRCell(c, u, num_supports, generator)
            for _ in range(c.num_rnn_layers))
        self.decoder = nn.ModuleList(
            GMSDRCell(c, u, num_supports, generator)
            for _ in range(c.num_rnn_layers))
        self.projection = _linear(u, dim_out, generator)

    def _adjacency(self, tag: str, layer: int, adapt_pattern,
                   shards: NodeShards | None):
        e1 = getattr(self, f"nodevec1_{tag}{layer}")
        e2 = getattr(self, f"nodevec2_{tag}{layer}")
        if shards is not None:
            # row-local: rank g's rows of E1 against the whole E2
            return adaptive_rows(e1, e2, shards)
        if adapt_pattern is None:
            return torch.softmax(torch.relu(e1 @ e2), dim=1)
        return adaptive_support(adapt_pattern, e1, e2)

    def forward(self, x, supports, adapt_pattern=None,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise. adapt_pattern: None -> each
        layer's learned adjacency is the reference's dense
        softmax(relu(E1 E2)), O(N^2) memory (by rows under `shards`);
        an SDDMMPattern -> the same graph restricted to the pattern."""
        split = shards is not None
        refuse_promoting_dense_support("MSDR", supports,
                                       x[0] if split else x)
        c = self.cfg
        B, T = (x[0] if split else x).shape[:2]
        L = c.num_rnn_layers
        enc_adps = [self._adjacency("enc", i, adapt_pattern, shards)
                    for i in range(L)]
        dec_adps = [self._adjacency("dec", i, adapt_pattern, shards)
                    for i in range(L)]
        rm = resolve_remat(c.remat, c.num_nodes, threshold=32768)
        x = each(self.enc_mlp, x, shards)                 # (B, T, N, U)
        h0 = tuple(per_rank(lambda t: t.new_zeros(
            B, c.pre_k, t.shape[2], c.rnn_units), x) for _ in range(L))

        def run(cells, adps, carry, xs):
            def segment(carry, xs_seg):
                outs = []
                steps = (xs_seg[0] if split else xs_seg).shape[1]
                for t in range(steps):
                    out, new = per_rank(lambda a: a[:, t], xs_seg), []
                    for layer, cell in enumerate(cells):
                        hx, out = cell(carry[layer], out, supports,
                                       adps[layer], shards)
                        new.append(hx)
                    carry = tuple(new)
                    outs.append(out)
                return carry, (torch.stack(outs, dim=1) if not split else
                               [torch.stack(o, dim=1) for o in zip(*outs)])

            if rm == "none":
                return segment(carry, xs)
            # chunked two-level checkpointing: only the carries at
            # segment boundaries are stored; each segment's steps are
            # recomputed in the backward (the learned adjacencies enter
            # as captured tensors, hence the non-reentrant checkpoint
            # of `remat_cell`)
            seg, chunk, ys = remat_cell(segment, rm), _pick_chunk(T), []
            for s in range(0, T, chunk):
                carry, y = seg(carry, per_rank(
                    lambda a: a[:, s:s + chunk], xs))
                ys.append(y)
            return carry, (torch.cat(ys, dim=1) if not split else
                           [torch.cat(y, dim=1) for y in zip(*ys)])

        hx_k, enc_out = run(self.encoder, enc_adps, h0, x)
        _, dec_out = run(self.decoder, dec_adps, hx_k, enc_out)
        return each(self.projection, dec_out, shards)
