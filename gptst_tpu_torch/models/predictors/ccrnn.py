"""CCRNN: coupled layer-wise convolutional recurrent network (demand).

Counterpart of the JAX package's `models/predictors/ccrnn.py` (the
reference's `model/CCRNN_demand/CCRNN.py`): a DCGRU seq2seq whose graph
evolves layer by layer. graph0 = leaky_relu(E1 E2) from an SVD of a
data-driven support, then each next graph from affine-transformed
embeddings (`CCRNN.py:170-192`), with Chebyshev diffusion graph
convolutions (`:198-233`), an attention merge over gconv layers
(`:29-36`) and scheduled-sampling teacher forcing with threshold
cl / (cl + exp(step / cl)) in the decoder (`:125-126, 194-195`).
Defaults follow `conf/CCRNN_demand/*.conf` (hidden 25, n_dim 50,
k_hop 3, 1 rnn layer, 1 gconv layer, cl_decay_steps 300).

The three graphs are dense (N, N) products of the embeddings: no kernel
of `csrc/` is on this path, as in the JAX package. The encoder and
decoder are Python loops over time (the JAX package's `nn.scan`s), each
step under `ops/recurrent.remat_cell`.

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x, the states and every activation are lists of the
ranks' node shards. Rank g holds its rows of nodevec1 and so its rows
of each graph (`NodeRows`; nodevec2 and the (n_dim, n_dim) maps read
whole); each Chebyshev hop multiplies them by the all-gathered input;
the attention over the gconv layers, a Dense over the flattened N·C,
takes each rank's slice of its weight and sums the partials over the
ranks before the softmax. The teacher-forcing coins are one draw for
every rank and data row (`parallel/rows.shared_draw`).

Teacher forcing needs the targets, a generator and the trainer's step
count (`train/trainer.jax_step_counts`): one coin per horizon step,
U[0, 1) < threshold, drawn from the generator on its device. The
trainer hands the threshold itself, computed on the host and staged on
the device for every step of an epoch (`step_inputs`), so that a step
captured in a CUDA graph reads each replay's own. Without any of the
three the decoder feeds back its own predictions.

Parameters, by the flax scope each one mirrors (`convert.py`):
  nodevec1, nodevec2, w1, w2, b1, b2      raw parameters
  encoder.cell{l}   Scan_EncoderStep_0/cell{l}: `ru`, `cand` evolution
                    cells, each `gconv{i}` and `attlinear` (nn.Linear)
  decoder.cell{l}, decoder.out            Scan_DecoderStep_0
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted, widened
from gptst_tpu_torch.ops.graph_conv import NodeRows
from gptst_tpu_torch.ops.recurrent import (
    remat_cell, resolve_remat, xavier_normal_,
)
from gptst_tpu_torch.ops.temporal import dense
from gptst_tpu_torch.parallel.mesh import NodeShards, each, per_rank
from gptst_tpu_torch.parallel.rows import shared_draw


@dataclasses.dataclass(frozen=True)
class CCRNNConfig:
    num_nodes: int
    hidden_size: int = 25
    n_dim: int = 50
    n_supports: int = 1
    k_hop: int = 3
    n_rnn_layers: int = 1
    n_gconv_layers: int = 1
    cl_decay_steps: int = 300
    # activation remat for the encoder and decoder steps:
    # auto|none|full|dots (`ops/recurrent.remat_cell`; "auto" resolves
    # by node count, `ops/recurrent.resolve_remat`)
    remat: str = "auto"


def svd_graph_embeddings(support: np.ndarray, n_dim: int):
    """SVD init of the coupled node embeddings (`CCRNN.py:155-159`)."""
    m, p, n = np.linalg.svd(support)
    e1 = m[:, :n_dim] @ np.diag(p[:n_dim] ** 0.5)
    e2 = np.diag(p[:n_dim] ** 0.5) @ n[:n_dim, :]
    return e1.astype(np.float32), e2.astype(np.float32)


def teacher_forcing_threshold(step: int, cl_decay_steps: int) -> torch.Tensor:
    """cl / (cl + exp(step / cl)) in float32, as the JAX package
    computes it (0 once exp overflows)."""
    s = torch.tensor(step, dtype=torch.float32)
    return cl_decay_steps / (cl_decay_steps + torch.exp(s / cl_decay_steps))


def teacher_forcing_coins(horizon: int, step, cl_decay_steps: int,
                          generator: torch.Generator) -> torch.Tensor:
    """One coin per horizon step, U[0, 1) < the step's threshold, drawn
    from `generator` on its device: True feeds the target back. `step`
    is the step count, or the 0-dim tensor of its threshold that the
    trainer staged on the device (`CCRNN.step_inputs`)."""
    thr = (step if isinstance(step, torch.Tensor)
           else teacher_forcing_threshold(step, cl_decay_steps))
    return torch.rand(horizon, generator=generator,
                      device=generator.device) < thr.to(generator.device)


def cheb_diffusion(z, support, k_hop: int):
    """[z, S z, 2 S (S z) - z, ...] on channels (`CCRNN.py:198-233`).
    z: (B, N, C); support: (N, N). With `support` a `NodeRows`, z and
    the result are lists of the ranks' node shards."""
    if isinstance(support, NodeRows):
        mats = [z]
        if k_hop > 0:
            h1, h0 = support.matmul(z), z
            mats.append(h1)
            for _ in range(2, k_hop + 1):
                h2 = per_rank(lambda a, b: 2 * a - b, support.matmul(h1), h0)
                mats.append(h2)
                h1, h0 = h2, h1
        return per_rank(lambda *m: torch.cat(m, dim=-1), *mats)
    mats = [z]
    if k_hop > 0:
        support, z = promoted(support, z)
        h1 = torch.einsum("nm,bmc->bnc", support, z)
        mats.append(h1)
        h0 = z
        for _ in range(2, k_hop + 1):
            h2 = 2 * torch.einsum("nm,bmc->bnc", support, h1) - h0
            mats.append(h2)
            h1, h0 = h2, h1
    return torch.cat(mats, dim=-1)


class EvolutionCell(nn.Module):
    """One graph convolution per gconv layer over its graph, merged by
    attention over the layers (`CCRNN.py:9-36`)."""

    def __init__(self, cfg: CCRNNConfig, in_dim: int, out_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        width = (cfg.k_hop + 1) * in_dim
        for i in range(cfg.n_gconv_layers):
            # flax Dense with kernel_init=xavier_normal (fan_avg: the
            # same law on the transposed weight) and a zero bias
            lin = nn.Linear(width, out_dim)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"gconv{i}", lin)
            width = (cfg.k_hop + 1) * out_dim
        self.attlinear = dense(cfg.num_nodes * out_dim, 1, generator)

    def forward(self, z, graphs, shards: NodeShards | None = None):
        """z (B, N, C) and `graphs` (G, N, N), or with `shards` the
        ranks' node shards and a list of G `NodeRows`."""
        outs = []
        h = z
        for i in range(self.cfg.n_gconv_layers):
            h = each(getattr(self, f"gconv{i}"),
                     cheb_diffusion(h, graphs[i], self.cfg.k_hop), shards,
                     linear)
            outs.append(h)
        # (B, G, N, F), flattened to (B, G, N * F)
        stack = per_rank(lambda *o: torch.stack(o, dim=1), *outs)
        flat = per_rank(lambda t: t.flatten(2), stack)
        if shards is None:
            w = torch.softmax(linear(self.attlinear, flat), dim=1)
            return (flat * w).sum(dim=1).reshape(stack.shape[0], -1,
                                                 stack.shape[-1])
        # each rank's columns of the Dense over N * F, summed in f32
        fd = stack[0].shape[-1]
        dt = torch.promote_types(flat[0].dtype, self.attlinear.weight.dtype)
        cols = shards.split(self.attlinear.weight.unflatten(
            1, (shards.n, fd)), dim=1)
        logits = shards.node_sum([widened(f) @ widened(wg.flatten(1)).T
                                  for f, wg in zip(flat, cols)])
        w = torch.softmax((logits + widened(self.attlinear.bias).to(
            logits.device)).to(dt), dim=1)
        return [(f * wg).sum(dim=1).reshape(f.shape[0], -1, fd)
                for f, wg in zip(flat, shards.replicate(w))]


class CCRNNGRUCell(nn.Module):
    """DCGRU cell with evolution-cell gates (`CCRNN.py:39-61`)."""

    def __init__(self, cfg: CCRNNConfig, in_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        h = cfg.hidden_size
        self.ru = EvolutionCell(cfg, in_dim + h, 2 * h, generator)
        self.cand = EvolutionCell(cfg, in_dim + h, h, generator)

    def forward(self, state, x, graphs, shards: NodeShards | None = None):
        def cat(a, b):
            return torch.cat([a, b], dim=-1)

        ru = per_rank(torch.sigmoid,
                      self.ru(per_rank(cat, x, state), graphs, shards))
        r = per_rank(lambda t: t.chunk(2, dim=-1)[0], ru)
        u = per_rank(lambda t: t.chunk(2, dim=-1)[1], ru)
        c = per_rank(torch.tanh, self.cand(
            per_rank(lambda a, r_, s: cat(a, r_ * s), x, r, state), graphs,
            shards))
        return per_rank(lambda u_, s, c_: u_ * s + (1.0 - u_) * c_, u, state,
                        c)


class _Stack(nn.Module):
    """The rnn layers of one time step (`cell{l}`), and the decoder's
    `out` projection."""

    def __init__(self, cfg: CCRNNConfig, dim_in: int, out_dim: int | None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_layers = cfg.n_rnn_layers
        for layer in range(cfg.n_rnn_layers):
            self.add_module(f"cell{layer}", CCRNNGRUCell(
                cfg, dim_in if layer == 0 else cfg.hidden_size, generator))
        if out_dim is not None:
            self.out = dense(cfg.hidden_size, out_dim, generator)

    def forward(self, states, x, graphs, shards: NodeShards | None = None):
        out, new = x, []
        for layer in range(self.n_layers):
            out = getattr(self, f"cell{layer}")(
                per_rank(lambda s: s[layer], states), out, graphs, shards)
            new.append(out)
        return per_rank(lambda *n: torch.stack(n), *new)  # (L, B, N, H)


class CCRNN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out). `emb1_init`,
    `emb2_init`: the SVD embeddings of the data-driven support
    (`svd_graph_embeddings`)."""

    def __init__(self, cfg: CCRNNConfig, dim_in: int, dim_out: int,
                 horizon: int, emb1_init: np.ndarray, emb2_init: np.ndarray,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dim_out, self.horizon = dim_out, horizon
        self.nodevec1 = nn.Parameter(torch.as_tensor(emb1_init).float())
        self.nodevec2 = nn.Parameter(torch.as_tensor(emb2_init).float())
        self.w1 = nn.Parameter(torch.eye(cfg.n_dim))
        self.w2 = nn.Parameter(torch.eye(cfg.n_dim))
        self.b1 = nn.Parameter(torch.zeros(cfg.n_dim))
        self.b2 = nn.Parameter(torch.zeros(cfg.n_dim))
        self.encoder = _Stack(cfg, dim_in, None, generator)
        self.decoder = _Stack(cfg, dim_out, dim_out, generator)

    def graphs(self, shards: NodeShards | None = None):
        """The three coupled graphs (3, N, N) (`CCRNN.py:170-186`), or
        with `shards` three `NodeRows`: rank g's rows from its rows of
        nodevec1, the rest read whole."""
        if shards is None:
            return torch.stack(self._graphs(self.nodevec1, self.nodevec2,
                                            self.w1, self.w2, self.b1,
                                            self.b2))
        # stacked as the whole graphs are: an unused graph's maps get a
        # zero gradient, not none
        ranks = [torch.stack(self._graphs(e1, *(p.to(e1.device) for p in (
                    self.nodevec2, self.w1, self.w2, self.b1, self.b2))))
                 for e1 in shards.split(self.nodevec1, dim=0)]
        return [NodeRows(tuple(r[i] for r in ranks), shards)
                for i in range(len(ranks[0]))]

    @staticmethod
    def _graphs(e1, e2, w1, w2, b1, b2) -> list:
        graphs = [F.leaky_relu(e1 @ e2)]
        v1, v2 = e1 @ w1 + b1, (e2.T @ w1 + b1).T
        graphs.append(F.leaky_relu(v1 @ v2))
        v1, v2 = v1 @ w2 + b2, (v2.T @ w2 + b2).T
        graphs.append(F.leaky_relu(v1 @ v2))
        return graphs

    def step_inputs(self, counts: list[int]) -> torch.Tensor:
        """The trainer's per-step input for step counts `counts`: each
        count's teacher-forcing threshold, computed on the host in f32
        (`teacher_forcing_threshold`), staged on the device once per
        epoch and handed to `forward` as `step`."""
        return torch.stack([teacher_forcing_threshold(
            c, self.cfg.cl_decay_steps) for c in counts])

    def forward(self, x, y: torch.Tensor | None = None,
                step: int | torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards (the output likewise); y whole, or with `shards`
        already split so (the trainer's resident split)."""
        c = self.cfg
        B, T = (x if shards is None else x[0]).shape[:2]
        graphs = self.graphs(shards)
        rm = resolve_remat(c.remat, c.num_nodes)
        enc, dec = remat_cell(self.encoder, rm), remat_cell(self.decoder, rm)
        states = per_rank(lambda t: t.new_zeros(
            c.n_rnn_layers, B, t.shape[2], c.hidden_size), x)
        for t in range(T):
            states = enc(states, per_rank(lambda a: a[:, t], x), graphs,
                         shards)

        # scheduled sampling (`CCRNN.py:125-126, 194-195`)
        use_tf = None
        if y is not None and generator is not None and step is not None:
            # one draw for the whole batch: in a data-parallel step
            # every data row reads the same coins
            use_tf = shared_draw(lambda: teacher_forcing_coins(
                self.horizon, step, c.cl_decay_steps, generator))
            if shards is not None:
                y = shards.split(y)
        inp = per_rank(lambda t: t.new_zeros(B, t.shape[2], self.dim_out), x)
        preds = []
        for t in range(self.horizon):
            states = dec(states, inp, graphs, shards)
            pred = each(self.decoder.out, per_rank(lambda s: s[-1], states),
                        shards, linear)
            preds.append(pred)
            inp = pred if use_tf is None else per_rank(
                lambda p, yt: torch.where(
                    use_tf[t].to(p.device),
                    yt[:, t, :, : self.dim_out].to(p.dtype), p), pred, y)
        # (B, T_out, N, D)
        return per_rank(lambda *p: torch.stack(p, dim=1), *preds)
