"""Model factory: wires configs and graph artifacts into modules.

The counterpart of the JAX package's `models/build.py`: one explicit
registry of predictor builders. A builder returns an `nn.Module` whose
`forward(x_base, y=None, step=None)` is the bare predictor on the base
channels; `build_model` wraps it into the `ModelOutput` contract of a
mode. Parameters are drawn on the host from a `torch.Generator` seeded
with `seed` and then moved to `device`.

Ported so far: `-mode ori` with TGCN. Other modes and predictors raise
`NotImplementedError` naming the slice they wait for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.graph.artifacts import random_sensor_graph
from gptst_tpu_torch.models.api import ModelOutput
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.utils.device import resolve_device


def load_base_adjacency(cfg: FrameworkConfig, seed: int = 0) -> np.ndarray:
    """The raw sensor graph: real files under `cfg.data_root` when
    present, otherwise a synthetic sparse sensor graph with matching
    node count."""
    from gptst_tpu_torch.graph.io import resolve_adjacency

    real = resolve_adjacency(cfg.data_root, cfg.dataset, cfg.num_nodes)
    if real is not None:
        return real
    return random_sensor_graph(cfg.num_nodes, avg_degree=6, seed=seed)


_PREDICTOR_CONFIGS = {"TGCN": ("tgcn", "TGCNConfig")}

# predictors of the JAX package not ported yet, and the slice each one
# waits for
_LATER = {
    "STGCN": "the STGCN slice", "MSDR": "the MSDR slice",
    **{m: "the slice of the remaining predictors"
       for m in ("GWN", "MTGNN", "CCRNN", "STMGCN", "ASTGCN", "STSGCN",
                 "STFGNN", "STGODE", "ST_WA", "DMVSTNET")},
}
_LATER_MODES = {"pretrain": "the GPT-ST pretrain slice",
                "eval": "the eval/test-mode slice",
                "test": "the eval/test-mode slice"}


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to gptst_tpu_torch yet; it comes with "
        f"{slice_name}")


def predictor_config_class(model: str):
    """The config dataclass for a ported predictor, or None (used by
    the CLI to expose every field as a `--flag`)."""
    import importlib

    if model not in _PREDICTOR_CONFIGS:
        return None
    mod, cls = _PREDICTOR_CONFIGS[model]
    return getattr(importlib.import_module(
        f"gptst_tpu_torch.models.predictors.{mod}"), cls)


def make_predictor_config(cls, cfg: FrameworkConfig, **kw):
    """Predictor config: built-in defaults, optionally overridden by
    reference-format INI files (`cfg.predictor_conf_root`), then by CLI
    `--flag` overrides (`cfg.predictor_overrides`)."""
    c = cls(**kw)
    if cfg.predictor_conf_root:
        from gptst_tpu_torch.config.predictor_ini import (
            load_predictor_overrides,
        )

        ov = load_predictor_overrides(
            cfg.model, cfg.dataset, cfg.predictor_conf_root, cls)
        if ov:
            c = dataclasses.replace(c, **ov)
    if cfg.predictor_overrides:
        from gptst_tpu_torch.config.predictor_ini import _coerce

        fields = {f.name for f in dataclasses.fields(cls)}
        ov = {k: _coerce(v, getattr(c, k))
              for k, v in cfg.predictor_overrides if k in fields}
        if ov:
            c = dataclasses.replace(c, **ov)
    return c


ModelBuilder = Callable[..., nn.Module]
_REGISTRY: dict[str, ModelBuilder] = {}


def register_model(name: str):
    def deco(fn: ModelBuilder) -> ModelBuilder:
        _REGISTRY[name] = fn
        return fn
    return deco


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def build_predictor(cfg: FrameworkConfig, dim_in: int | None = None,
                    adj: np.ndarray | None = None, device="cuda",
                    seed: int | None = None) -> nn.Module:
    """The bare predictor for `cfg.model` (ori-mode input width by
    default), on `device`, its fresh parameters drawn from `seed`
    (default `cfg.seed`)."""
    if cfg.model in _LATER:
        raise _not_ported(f"predictor {cfg.model!r}", _LATER[cfg.model])
    if cfg.model not in _REGISTRY:
        raise ValueError(
            f"unknown model {cfg.model!r}; available: {available_models()}")
    dev = resolve_device(device)
    if dim_in is None:
        dim_in = cfg.input_base_dim
    if adj is None:
        adj = load_base_adjacency(cfg)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return _REGISTRY[cfg.model](cfg, dim_in, adj, dev, gen)


class OriModel(nn.Module):
    """Ori mode: the bare predictor on the base channels of the full
    (B, T, N, base+2) input (`model/Model.py:119-127`)."""

    def __init__(self, predictor: nn.Module, input_base_dim: int):
        super().__init__()
        self.predictor = predictor
        self.input_base_dim = input_base_dim

    def forward(self, x: torch.Tensor, y=None, step=None) -> ModelOutput:
        return ModelOutput(pred=self.predictor(
            x[..., : self.input_base_dim], y=y, step=step))


def predictor_forward(cfg: FrameworkConfig, predictor: nn.Module) -> OriModel:
    """Wrap a bare predictor into the `ModelOutput` contract (ori
    mode)."""
    return OriModel(predictor, cfg.input_base_dim)


def build_model(cfg: FrameworkConfig, adj: np.ndarray | None = None,
                device="cuda", seed: int | None = None) -> nn.Module:
    """Mode dispatch; the port has the ori branch (bare predictor)."""
    if cfg.mode in _LATER_MODES:
        raise _not_ported(f"-mode {cfg.mode}", _LATER_MODES[cfg.mode])
    return predictor_forward(
        cfg, build_predictor(cfg, adj=adj, device=device, seed=seed))


class GraphPredictor(nn.Module):
    """A predictor network bound to its constant graph support."""

    def __init__(self, net: nn.Module, support):
        super().__init__()
        self.net = net
        self.support = support

    def forward(self, x_base: torch.Tensor, y=None, step=None):
        return self.net(x_base, self.support)


# --- registrations ----------------------------------------------------------

@register_model("TGCN")
def _build_tgcn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.graph.artifacts import sym_adj
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig

    pcfg = make_predictor_config(TGCNConfig, cfg, num_nodes=cfg.num_nodes)
    support = make_support(sym_adj(adj), device=device)
    net = TGCN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
               horizon=cfg.horizon, generator=generator).to(device)
    return GraphPredictor(net, support)
