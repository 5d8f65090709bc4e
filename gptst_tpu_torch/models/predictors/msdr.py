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
    graph_matmul, refuse_promoting_dense_support,
)
from gptst_tpu_torch.ops.recurrent import (
    remat_cell, resolve_remat, variance_scaling_, xavier_normal_,
)


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

    def forward(self, hx_k: torch.Tensor, x: torch.Tensor, supports,
                adp) -> tuple[torch.Tensor, torch.Tensor]:
        # hx_k: (B, K, N, U); x: (B, N, Din); supports: the static
        # supports; adp: this layer's learned adjacency
        c = self.cfg
        B, K, N, U = hx_k.shape
        pre_h = hx_k[:, -c.pre_v:].movedim(1, 2).reshape(B, N, c.pre_v * U)
        z = torch.cat([x, pre_h], dim=-1)                 # (B, N, Z)

        mats = [z]
        for sup in supports:
            h1 = graph_matmul(sup, z)
            mats.append(h1)
            h0 = z
            for _ in range(2, c.max_diffusion_step + 1):
                h2 = 2 * graph_matmul(sup, h1) - h0
                mats.append(h2)
                h1, h0 = h2, h1
        h1 = graph_matmul(adp, z)
        mats.append(h1)
        h0 = z
        for _ in range(2, c.max_diffusion_step + 1):
            h2 = graph_matmul(adp, h1) - h0
            mats.append(h2)
            h1, h0 = h2, h1
        # gconv as a sum of per-matrix products, not `concat @ W`: each
        # diffusion output is read once and no (B, N, num_mats * Z)
        # concatenation is stored
        zdim = z.shape[-1]
        pre = self.gconv_b
        for i, m in enumerate(mats):
            pre = pre + m @ self.gconv_w[i * zdim:(i + 1) * zdim]
        conv = F.leaky_relu(pre, 0.01)

        # pre_k attention with the logits and the weighted sum split
        # into the hx_k term and the constant R term, so (hx_k + R) is
        # never stored
        aw = self.att_w.reshape(N, U)
        r_dot = torch.einsum("knu,nu->k", self.R, aw)     # (K,)
        logits = (torch.einsum("bknu,nu->bk", hx_k, aw) + r_dot[None]
                  + self.att_b)
        weight = torch.softmax(logits, dim=1)             # (B, K)
        att = (torch.einsum("bk,bknu->bnu", weight, hx_k)
               + torch.einsum("bk,knu->bnu", weight, self.R))

        output = conv @ self.W + self.b[None] + att
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

    def _adjacency(self, tag: str, layer: int, adapt_pattern):
        e1 = getattr(self, f"nodevec1_{tag}{layer}")
        e2 = getattr(self, f"nodevec2_{tag}{layer}")
        if adapt_pattern is None:
            return torch.softmax(torch.relu(e1 @ e2), dim=1)
        return adaptive_support(adapt_pattern, e1, e2)

    def forward(self, x: torch.Tensor, supports,
                adapt_pattern=None) -> torch.Tensor:
        # adapt_pattern: None -> each layer's learned adjacency is the
        # reference's dense softmax(relu(E1 E2)), O(N^2) memory; an
        # SDDMMPattern -> the same graph restricted to the pattern
        refuse_promoting_dense_support("MSDR", supports, x)
        c = self.cfg
        B, T, N, _ = x.shape
        L = c.num_rnn_layers
        enc_adps = [self._adjacency("enc", i, adapt_pattern) for i in range(L)]
        dec_adps = [self._adjacency("dec", i, adapt_pattern) for i in range(L)]
        rm = resolve_remat(c.remat, N, threshold=32768)
        x = self.enc_mlp(x)                               # (B, T, N, U)
        h0 = tuple(x.new_zeros(B, c.pre_k, N, c.rnn_units) for _ in range(L))

        def run(cells, adps, carry, xs):
            def segment(carry, xs_seg):
                outs = []
                for t in range(xs_seg.shape[1]):
                    out, new = xs_seg[:, t], []
                    for layer, cell in enumerate(cells):
                        hx, out = cell(carry[layer], out, supports,
                                       adps[layer])
                        new.append(hx)
                    carry = tuple(new)
                    outs.append(out)
                return carry, torch.stack(outs, dim=1)

            if rm == "none":
                return segment(carry, xs)
            # chunked two-level checkpointing: only the carries at
            # segment boundaries are stored; each segment's steps are
            # recomputed in the backward (the learned adjacencies enter
            # as captured tensors, hence the non-reentrant checkpoint
            # of `remat_cell`)
            seg, chunk, ys = remat_cell(segment, rm), _pick_chunk(T), []
            for s in range(0, T, chunk):
                carry, y = seg(carry, xs[:, s:s + chunk])
                ys.append(y)
            return carry, torch.cat(ys, dim=1)

        hx_k, enc_out = run(self.encoder, enc_adps, h0, x)
        _, dec_out = run(self.decoder, dec_adps, hx_k, enc_out)
        return self.projection(dec_out)
