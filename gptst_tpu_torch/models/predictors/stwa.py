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

    def forward(self, x: torch.Tensor, params) -> torch.Tensor:
        key = custom_linear(x, params[0])
        value = custom_linear(x, params[1])
        q = split_heads(x, self.heads)            # (B, K, P, N, hs)
        kk = split_heads(key, self.heads)
        vv = split_heads(value, self.heads)
        att = torch.einsum("bkpnh,bkpmh->bkpnm", q, kk) / q.shape[-1] ** 0.5
        att = torch.softmax(att, dim=-1)
        out = merge_heads(torch.einsum("bkpnm,bkpmh->bkpnh", att, vv))
        out = torch.relu(linear(self.projection1, out))
        return linear(self.projection2, out)


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

    def forward(self, x: torch.Tensor, z_data,
                eps: torch.Tensor | None) -> torch.Tensor:
        c = self.cfg
        p = c.no_proxies
        if c.dynamic:
            # the layer's memory, reparameterised
            z_data = z_data + (self.mu + eps * torch.exp(0.5 * self.logvar))
        t_params = [g(z_data) for g in self.tpg]
        s_params = [g(z_data) for g in self.spg]
        out = x.new_zeros(x.shape[0], p, c.num_nodes, c.channels)
        pieces = []
        for i in range(self.cuts):
            t = x[:, i * self.cut_size:(i + 1) * self.cut_size]
            prox = self.proxies[:, i * p:(i + 1) * p] + out
            t = torch.cat([prox, t], dim=1)
            out = self.temporal_att(t[:, :p], t, t, t_params)
            out = self.spatial_att(out, s_params)
            gate = torch.sigmoid(self.aggregator(out))
            pooled = (gate * out).sum(dim=1, keepdim=True)
            pieces.append(pooled)
            out = pooled.expand(out.shape)
        return torch.cat(pieces, dim=1)


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

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                draws: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        c = self.cfg
        b = x.shape[0]
        z_data, layer_eps = 0.0, [None] * len(self.layers)
        if c.dynamic:
            eps, *layer_eps = (self.draw(x, generator) if draws is None
                               else draws)
            x_dm = x if self.eval_dimin is None else linear(
                self.eval_dimin, x)
            series = x_dm[..., 0].transpose(1, 2)          # (B, N, T)
            mu = self.mu_est(series)
            logvar = self.logvar_est(series)
            z_data = mu + eps * torch.exp(0.5 * logvar)
        h = linear(self.start_fc, x)
        skip = 0.0
        for layer, proj, e in zip(self.layers, self.skip, layer_eps):
            h = layer(h, z_data, e)
            skip = skip + linear(proj, h.transpose(1, 2).reshape(
                b, c.num_nodes, -1))
        h = torch.relu(skip)
        h = torch.relu(linear(self.proj1, h))
        out = linear(self.proj2, h).reshape(b, c.num_nodes, self.horizon,
                                            self.dim_out)
        return out.transpose(1, 2)
