"""ST-WA: spatio-temporal aware window attention.

Counterpart of the JAX package's `models/predictors/stwa.py` (the
reference's `model/ST_WA/ST_WA.py` + `attention.py`): three layers of
windowed attention over temporal cuts (12 -> 3 -> 1) with learnable
proxy queries carried across cuts, 8-head temporal and spatial
attention whose key and value projections are generated per
(batch, node) from stochastic latents (mu + eps * exp(logvar / 2), from
the input series and from per-layer memories, `ST_WA.py:51-75,
117-120`), a sigmoid aggregator pooling the proxies, per-layer skip
projections into a 256-wide stream, and an MLP head that emits every
horizon step (`:44-47`). Defaults follow `conf/ST-WA/*.conf`
(channels 16, dynamic, memory_size 16).

Quirk kept: layer 1 is 12 cuts x 6 steps over T = 12 (`ST_WA.py:31-33`),
so cuts 2-11 slice an empty window and attend over the proxies (and
the carried state) alone.

The draws. With `dynamic`, the forward takes four N(0, 1) draws, in
this order: the data latent's eps (B, N, memory_size), then one
(N, memory_size) eps per layer for its memory. They come from
`generator` (the trainer's, in training and at test), else from a fresh
generator seeded 0 (validation: fixed draws, the counterpart of the
JAX package's `PRNGKey(0)` default, though not its values), or are
given as `draws` (the parity tests replay JAX's key splits). The
static branch draws nothing.

No kernel of `csrc/` is on this path: the attention products are
`torch.einsum`s, as they are `jnp.einsum`s in the JAX package.

Node-sharded over a data row's graph ranks (`forward(..., shards=)`,
`parallel/mesh.NodeShards`; `models/build.GraphPredictor` passes them
under a mesh): x and every activation are lists of the ranks' node
shards, and the draws the one-device draws cut into them. The ranks
meet only in the spatial attention: rank g keeps its query rows against
the gathered keys and values, so it holds its (B, heads, P, N / G, N)
share of the maps. Rank g reads its rows of the proxies and memories;
the latent MLPs, the parameter generators, the temporal attention, the
gate, the pooling, the skips and the head are node-local.

Parameters, by the flax scope each one mirrors (`convert.py`). Every
Dense is an `nn.Linear` with `variance_scaling(1/3, fan_in, uniform)`
weights (torch's own law) and a zero bias; `proxies`, `mu` and `logvar`
are N(0, 1):
  eval_dimin                    Dense to 1 channel (dynamic, dim_in != 1)
  mu_est.{0,1,2}, logvar_est.{0,1,2}     mu_est_k, logvar_est_k
  start_fc, skip.{l}, proj1, proj2       start_fc, skip{l}, proj1, proj2
  layers.{l}                    layer{l}: `proxies` (1, cuts * P, N, C),
                                `mu`, `logvar` (N, memory_size),
                                `aggregator.{0,1}` (aggregator_k),
                                `temporal_att`, `spatial_att`
                                (`projection1`, `projection2`), and the
                                generators `tpg.{i}`, `spg.{i}` (tpg{i},
                                spg{i}): `wgen.{k}`, `bgen.{k}` (wgen_k,
                                bgen_k) when dynamic, else `weights`
                                (C, C) and `biases` (C,), U[0, 1)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear
from gptst_tpu_torch.ops.recurrent import fan_in_uniform_
from gptst_tpu_torch.parallel.mesh import (
    NodeShards, each, module_on, per_rank,
)
from gptst_tpu_torch.parallel.rows import batch_draw, shared_draw


@dataclasses.dataclass(frozen=True)
class STWAConfig:
    num_nodes: int
    channels: int = 16
    dynamic: bool = True
    memory_size: int = 16
    heads: int = 8
    layer_cuts: tuple = ((12, 6), (3, 4), (1, 3))
    no_proxies: int = 2


def torch_dense(c_in: int, c_out: int,
                generator: torch.Generator | None = None) -> nn.Linear:
    """flax `Dense(kernel_init=variance_scaling(1/3, "fan_in",
    "uniform"))`: weights U(+-1/sqrt(c_in)), zero bias."""
    lin = nn.Linear(c_in, c_out)
    fan_in_uniform_(lin.weight.T, generator)
    nn.init.zeros_(lin.bias)
    return lin


class MLP(nn.ModuleList):
    """Dense layers of `sizes`, `act` between them (the JAX module's
    `_mlp`); layer k is flax's `<name>_k`."""

    def __init__(self, c_in: int, sizes: Sequence[int], act,
                 generator: torch.Generator | None = None):
        dims = [c_in, *sizes]
        super().__init__(torch_dense(a, b, generator)
                         for a, b in zip(dims, dims[1:]))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k, lin in enumerate(self):
            x = linear(lin, x)
            if k < len(self) - 1:
                x = self.act(x)
        return x


class ParameterGenerator(nn.Module):
    """Latent z (B, N, M) -> a projection's weights (B, N, C, C) and
    bias (B, N, C) from two ReLU MLPs (dynamic), or one static (C, C)
    weight and (C,) bias (`ST_WA.py:166-202`)."""

    def __init__(self, cfg: STWAConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, m = cfg.channels, cfg.memory_size
        self.dynamic, self.channels = cfg.dynamic, d
        if cfg.dynamic:
            self.wgen = MLP(m, (32, 5, d * d), torch.relu, generator)
            self.bgen = MLP(m, (32, 5, d), torch.relu, generator)
        else:
            self.weights = nn.Parameter(
                torch.rand(d, d, generator=generator))
            self.biases = nn.Parameter(torch.rand(d, generator=generator))

    def forward(self, z) -> tuple[torch.Tensor, torch.Tensor]:
        if not self.dynamic:
            return self.weights, self.biases
        d = self.channels
        return self.wgen(z).reshape(*z.shape[:2], d, d), self.bgen(z)


def custom_linear(x: torch.Tensor, wb) -> torch.Tensor:
    """x (B, T, N, C) through per-(b, n) weights (B, N, C, C) and bias
    (B, N, C), or a static (C, C) / (C,) pair (`attention.py:99-107`)."""
    w, b = wb
    if w.dim() > 2:
        return torch.einsum("btni,bnio->btno", x, w) + b[:, None]
    return x @ w + b


def split_heads(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, N, C) -> (B, K, T, N, C / K)."""
    b, t, n, c = x.shape
    return x.reshape(b, t, n, k, c // k).movedim(3, 1)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """`split_heads`' inverse: (B, K, T, N, hs) -> (B, T, N, K * hs)."""
    b, k, t, n, hs = x.shape
    return x.movedim(1, 3).reshape(b, t, n, k * hs)


class TemporalAttention(nn.Module):
    """Proxy-query attention over a cut (`attention.py:5-55`): the
    proxies attend over [proxies ‖ window] along time, per node."""

    def __init__(self, cfg: STWAConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = cfg.channels
        self.heads = cfg.heads
        self.projection1 = torch_dense(c, c, generator)
        self.projection2 = torch_dense(c, c, generator)

    def forward(self, query, key, value, params) -> torch.Tensor:
        key = custom_linear(key, params[0])
        value = custom_linear(value, params[1])
        q = split_heads(query, self.heads)        # (B, K, Tq, N, hs)
        kk = split_heads(key, self.heads)
        vv = split_heads(value, self.heads)
        att = torch.einsum("bkqnh,bksnh->bknqs", q, kk) / q.shape[-1] ** 0.5
        att = torch.softmax(att, dim=-1)
        out = merge_heads(torch.einsum("bknqs,bksnh->bkqnh", att, vv))
        out = torch.tanh(linear(self.projection1, out))
        return linear(self.projection2, out)


class SpatialAttention(nn.Module):
    """Node-axis attention of the proxies (`attention.py:58-96`): an
    (N, N) softmax per (batch, head, proxy)."""

    def __init__(self, cfg: STWAConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = cfg.channels
        self.heads = cfg.heads
        self.projection1 = torch_dense(c, c, generator)
        self.projection2 = torch_dense(c, c, generator)

    def forward(self, x, params, shards: NodeShards | None = None):
        """x (B, P, N, C) and the generated (key, value) params; with
        `shards`, the ranks' node shards of x and params: rank g keeps
        its query rows against the gathered keys and values, so it holds
        its (B, K, P, N / G, N) share of the maps."""
        if shards is None:
            kv = custom_linear(x, params[0]), custom_linear(x, params[1])
            return self._attend(self, x, *kv)
        c = x[0].shape[-1]
        kv = shards.all_gather([torch.cat([
            custom_linear(xg, pg[0]), custom_linear(xg, pg[1])], dim=-1)
            for xg, pg in zip(x, params)])
        return [self._attend(shards.module_on(self, g), xg, t[..., :c],
                             t[..., c:])
                for g, (xg, t) in enumerate(zip(x, kv))]

    @staticmethod
    def _attend(m: "SpatialAttention", x, key, value) -> torch.Tensor:
        q = split_heads(x, m.heads)               # (B, K, P, n, hs)
        kk = split_heads(key, m.heads)            # (B, K, P, N, hs)
        vv = split_heads(value, m.heads)
        att = torch.einsum("bkpnh,bkpmh->bkpnm", q, kk) / q.shape[-1] ** 0.5
        att = torch.softmax(att, dim=-1)
        out = merge_heads(torch.einsum("bkpnm,bkpmh->bkpnh", att, vv))
        out = torch.relu(linear(m.projection1, out))
        return linear(m.projection2, out)


class WindowLayer(nn.Module):
    """One layer of `cuts` windows of `cut_size` steps
    (`ST_WA.py:101-164`): x (B, T, N, C) -> (B, cuts, N, C)."""

    def __init__(self, cfg: STWAConfig, cuts: int, cut_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, n = cfg.channels, cfg.num_nodes
        self.cfg, self.cuts, self.cut_size = cfg, cuts, cut_size
        self.proxies = nn.Parameter(torch.randn(
            1, cuts * cfg.no_proxies, n, c, generator=generator))
        if cfg.dynamic:
            self.mu = nn.Parameter(torch.randn(n, cfg.memory_size,
                                               generator=generator))
            self.logvar = nn.Parameter(torch.randn(n, cfg.memory_size,
                                                   generator=generator))
        self.tpg = nn.ModuleList(ParameterGenerator(cfg, generator)
                                 for _ in range(2))
        self.spg = nn.ModuleList(ParameterGenerator(cfg, generator)
                                 for _ in range(2))
        self.temporal_att = TemporalAttention(cfg, generator)
        self.spatial_att = SpatialAttention(cfg, generator)
        self.aggregator = MLP(c, (c, c), torch.relu, generator)

    def forward(self, x, z_data, eps, shards: NodeShards | None = None):
        """x (B, T, N, C), z_data (B, N, M) (0.0 when static) and eps
        (N, M) (None when static) -> (B, cuts, N, C); with `shards`,
        lists of the ranks' node shards. Rank g reads its rows of the
        proxies and memories; the ranks meet only in the spatial
        attention."""
        c = self.cfg
        p, size = c.no_proxies, self.cut_size
        split = shards is not None
        xs = x if split else [x]
        # the generators, the temporal attention and the aggregator as
        # each rank reads them (not the layer's node tables)
        ms = [tuple(module_on(m, xg.device) for m in (
            self.tpg, self.spg, self.temporal_att, self.aggregator))
            for xg in xs]

        def rows(t, dim):
            return shards.split(t, dim) if split else [t]

        zs = z_data if split else [z_data]
        if c.dynamic:
            # the layer's memory, reparameterised
            zs = [z + (mu + e * torch.exp(0.5 * lv)) for z, e, mu, lv in zip(
                zs, eps if split else [eps], rows(self.mu, 0),
                rows(self.logvar, 0))]
        t_params = [[g(z) for g in tpg] for (tpg, *_), z in zip(ms, zs)]
        s_params = [[g(z) for g in spg] for (_, spg, *_), z in zip(ms, zs)]
        proxies = rows(self.proxies, -2)
        outs = [xg.new_zeros(xg.shape[0], p, xg.shape[2], c.channels)
                for xg in xs]
        pieces = [[] for _ in xs]
        for i in range(self.cuts):
            att = []
            for (*_, t_att, _), xg, prox, out, tp in zip(
                    ms, xs, proxies, outs, t_params):
                t = torch.cat([prox[:, i * p:(i + 1) * p] + out,
                               xg[:, i * size:(i + 1) * size]], dim=1)
                att.append(t_att(t[:, :p], t, t, tp))
            if split:
                att = self.spatial_att(att, s_params, shards)
            else:
                att = [self.spatial_att(att[0], s_params[0])]
            outs = []
            for (*_, agg), out, piece in zip(ms, att, pieces):
                gate = torch.sigmoid(agg(out))
                pooled = (gate * out).sum(dim=1, keepdim=True)
                piece.append(pooled)
                outs.append(pooled.expand(out.shape))
        out = [torch.cat(piece, dim=1) for piece in pieces]
        return out if split else out[0]


class STWA(nn.Module):
    """x (B, T, N, dim_in) -> (B, horizon, N, dim_out)."""

    def __init__(self, cfg: STWAConfig, dim_in: int, dim_out: int,
                 horizon: int, lag: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, m = cfg.channels, cfg.memory_size
        self.cfg, self.dim_out, self.horizon = cfg, dim_out, horizon
        self.eval_dimin = (torch_dense(dim_in, 1, generator)
                           if cfg.dynamic and dim_in != 1 else None)
        if cfg.dynamic:
            self.mu_est = MLP(lag, (32, 32, m), torch.tanh, generator)
            self.logvar_est = MLP(lag, (32, 32, m), torch.tanh, generator)
        self.start_fc = torch_dense(dim_in, c, generator)
        self.layers = nn.ModuleList(
            WindowLayer(cfg, cuts, size, generator)
            for cuts, size in cfg.layer_cuts)
        self.skip = nn.ModuleList(torch_dense(cuts * c, 256, generator)
                                  for cuts, _ in cfg.layer_cuts)
        self.proj1 = torch_dense(256, 512, generator)
        self.proj2 = torch_dense(512, horizon * dim_out, generator)

    def draw(self, x: torch.Tensor,
             generator: torch.Generator | None) -> list[torch.Tensor]:
        """The forward's four N(0, 1) draws, in the JAX module's order:
        the data latent's eps (B, N, M), then each layer's (N, M)
        (`parallel/rows.py` in a data-parallel step)."""
        c = self.cfg
        if generator is None:
            generator = shared_draw(
                lambda: torch.Generator(device=x.device).manual_seed(0))

        def normal(shape):
            return torch.randn(shape, generator=generator,
                               device=generator.device, dtype=x.dtype)

        # in a data-parallel step the data latent is the global batch's,
        # sliced, and every data row reads the same layer latents
        layer = (c.num_nodes, c.memory_size)
        return [batch_draw(normal, (x.shape[0], *layer), x.device)] + [
            shared_draw(lambda: normal(layer), x.device)
            for _ in self.layers]

    def forward(self, x, generator: torch.Generator | None = None,
                draws: Sequence[torch.Tensor] | None = None,
                shards: NodeShards | None = None):
        """x (B, T, N, dim_in), or with `shards` the list of the ranks'
        node shards; the output likewise. The draws are the one-device
        draws, cut into the ranks' shards."""
        c = self.cfg
        split = shards is not None
        x0 = x[0] if split else x
        z_data = [0.0] * shards.parts if split else 0.0
        layer_eps = [None] * len(self.layers)
        if c.dynamic:
            eps, *layer_eps = (self.draw(x0, generator) if draws is None
                               else draws)
            if split:
                eps = shards.split(eps)
                layer_eps = [shards.split(e, dim=0) for e in layer_eps]
            x_dm = x if self.eval_dimin is None else each(
                self.eval_dimin, x, shards, linear)
            series = per_rank(lambda t: t[..., 0].transpose(1, 2), x_dm)
            mu = each(self.mu_est, series, shards)          # (B, N, M)
            logvar = each(self.logvar_est, series, shards)
            z_data = per_rank(lambda m, e, lv: m + e * torch.exp(0.5 * lv),
                              mu, eps, logvar)
        h = each(self.start_fc, x, shards, linear)
        skip = [0.0] * shards.parts if split else 0.0
        for layer, proj, e in zip(self.layers, self.skip, layer_eps):
            h = layer(h, z_data, e, shards)
            skip = per_rank(lambda s_, hg: s_ + linear(
                module_on(proj, hg.device), hg.transpose(1, 2).reshape(
                    hg.shape[0], hg.shape[2], -1)), skip, h)
        return per_rank(self._head, skip)

    def _head(self, skip: torch.Tensor) -> torch.Tensor:
        b, n = skip.shape[:2]
        h = torch.relu(skip)
        h = torch.relu(linear(module_on(self.proj1, h.device), h))
        out = linear(module_on(self.proj2, h.device), h).reshape(
            b, n, self.horizon, self.dim_out)
        return out.transpose(1, 2)
