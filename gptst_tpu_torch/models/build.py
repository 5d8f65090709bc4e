"""Model factory: wires configs and graph artifacts into modules.

The counterpart of the JAX package's `models/build.py`: one explicit
registry of predictor builders. A builder returns an `nn.Module` whose
`forward(x_base, y=None, step=None)` is the bare predictor on the base
channels; `build_model` wraps it into the `ModelOutput` contract of a
mode. Parameters are drawn on the host from a `torch.Generator` seeded
with `seed` and then moved to `device`.

Ported: the four modes (`pretrain`: GPT-ST; `eval`: the frozen GPT-ST
encoder, the Fusion head and a predictor; `ori` and `test`: the bare
predictor) with all 13 predictors of the JAX package: STGCN, TGCN,
MSDR, GWN, MTGNN, CCRNN, STMGCN, ASTGCN, STSGCN, STFGNN, STGODE, ST_WA
and DMVSTNET.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.graph.artifacts import random_sensor_graph
from gptst_tpu_torch.models.api import ModelOutput
from gptst_tpu_torch.ops.graph_conv import (
    MeshRows, SparseSupport, make_support, sharding_mesh, strided_rows,
    use_sharding_mesh,
)
from gptst_tpu_torch.parallel.mesh import (
    GRAPH_AXIS, NodeShards, node_shards, per_rank,
)
from gptst_tpu_torch.parallel.rows import current_row
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


_PREDICTOR_CONFIGS = {"STGCN": ("stgcn", "STGCNConfig"),
                      "TGCN": ("tgcn", "TGCNConfig"),
                      "MSDR": ("msdr", "MSDRConfig"),
                      "GWN": ("gwn", "GWNConfig"),
                      "MTGNN": ("mtgnn", "MTGNNConfig"),
                      "CCRNN": ("ccrnn", "CCRNNConfig"),
                      "STMGCN": ("stmgcn", "STMGCNConfig"),
                      "ASTGCN": ("astgcn", "ASTGCNConfig"),
                      "STSGCN": ("stsgcn", "STSGCNConfig"),
                      "STFGNN": ("stfgnn", "STFGNNConfig"),
                      "STGODE": ("stgode", "STGODEConfig"),
                      "ST_WA": ("stwa", "STWAConfig"),
                      "DMVSTNET": ("dmvstnet", "DMVSTNetConfig")}


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
                    seed: int | None = None,
                    series_graph: np.ndarray | None = None) -> nn.Module:
    """The bare predictor for `cfg.model` (ori-mode input width by
    default), on `device`, its fresh parameters drawn from `seed`
    (default `cfg.seed`). `series_graph`, for STMGCN, STFGNN and STGODE
    only, is the (N, N) graph to use in place of the one their builders
    derive from the dataset (the Pearson or DTW graph of its series);
    no prefab or series is read then."""
    if cfg.model not in _REGISTRY:
        raise ValueError(
            f"unknown model {cfg.model!r}; available: {available_models()}")
    dev = resolve_device(device)
    if dim_in is None:
        dim_in = cfg.input_base_dim
    if adj is None:
        adj = load_base_adjacency(cfg)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    kw = {} if series_graph is None else {"series_graph": series_graph}
    return _REGISTRY[cfg.model](cfg, dim_in, adj, dev, gen, **kw)


class OriModel(nn.Module):
    """Ori mode: the bare predictor on the base channels of the full
    (B, T, N, base+2) input (`model/Model.py:119-127`), or of each of
    its node shards, a list (a data row's batch from the resident
    split)."""

    def __init__(self, predictor: nn.Module, input_base_dim: int):
        super().__init__()
        self.predictor = predictor
        self.input_base_dim = input_base_dim

    def forward(self, x: torch.Tensor, y=None, step=None,
                generator: torch.Generator | None = None) -> ModelOutput:
        return ModelOutput(pred=self.predictor(
            per_rank(lambda t: t[..., : self.input_base_dim], x), y=y,
            step=step, generator=generator))


def predictor_forward(cfg: FrameworkConfig, predictor: nn.Module) -> OriModel:
    """Wrap a bare predictor into the `ModelOutput` contract (ori
    mode)."""
    return OriModel(predictor, cfg.input_base_dim)


class PretrainModel(nn.Module):
    """Pretrain mode: GPT-ST in the `ModelOutput` contract. Called with
    a generator and an epoch it runs the masked autoencoder
    (`GPTST.pretrain`); without them, the encoder alone (`pred` is the
    embedding)."""

    def __init__(self, gptst: nn.Module):
        super().__init__()
        self.gptst = gptst

    def forward(self, x: torch.Tensor, y=None, step=None,
                generator: torch.Generator | None = None,
                epoch: int | None = None) -> ModelOutput:
        out = self.gptst(x, generator, epoch)
        if generator is None:
            return ModelOutput(pred=out)
        flow_out, dec, inv_mask, prob, hs_cat = out
        return ModelOutput(pred=flow_out, out_time=dec, mask=inv_mask,
                           probability=prob, routing=hs_cat)


def build_pretrain(cfg: FrameworkConfig, scaler_zeros: float = 0.0,
                   device="cuda", seed: int | None = None,
                   mesh=None) -> PretrainModel:
    """GPT-ST masked-autoencoder pretraining model on `device`, its
    parameters drawn from `seed` (default `cfg.seed`); with `mesh`,
    node-sharded over its graph axis (`models/gptst.py`)."""
    from gptst_tpu_torch.models.gptst import GPTST, GPTSTConfig

    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    net = GPTST(GPTSTConfig.from_framework(cfg, scaler_zeros), gen, mesh)
    return PretrainModel(net).to(resolve_device(device))


def build_enhanced(cfg: FrameworkConfig, scaler_zeros: float,
                   encoder_or_state, adj: np.ndarray | None = None,
                   device="cuda", seed: int | None = None,
                   mesh=None) -> nn.Module:
    """Eval mode (`model/Model.py:106-117`): the frozen GPT-ST encoder,
    the Fusion head and the predictor at `dim_in = hidden_dim`.

    `encoder_or_state` is the pretrained GPT-ST (a `GPTST` or a
    `PretrainModel`) or its `state_dict` (the pretrain checkpoint),
    loaded strictly into `build_pretrain(cfg.replace(mode="pretrain"))`'s
    GPT-ST. The head is drawn from a generator seeded with `seed`
    (default `cfg.seed`), the predictor from `seed + 1`. With `mesh` the
    encoder runs node-sharded over its graph axis: a GPT-ST passed in
    is left as it is, the model holds a shallow copy of it (the same
    parameters) whose `mesh` is set."""
    from gptst_tpu_torch.models.enhance import EnhanceHead, EnhancedModel

    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    encoder = encoder_or_state
    if isinstance(encoder, PretrainModel):
        encoder = encoder.gptst
    if isinstance(encoder, nn.Module):
        encoder = copy.copy(encoder)
    else:
        encoder = build_pretrain(cfg.replace(mode="pretrain"), scaler_zeros,
                                 dev, seed).gptst
        encoder.load_state_dict(encoder_or_state, strict=True)
    encoder.mesh = mesh
    head = EnhanceHead(cfg.hidden_dim, cfg.input_base_dim,
                       torch.Generator().manual_seed(seed))
    predictor = build_predictor(cfg, dim_in=cfg.hidden_dim, adj=adj,
                                device=dev, seed=seed + 1)
    return EnhancedModel(encoder, head, predictor).to(dev)


def build_model(cfg: FrameworkConfig, adj: np.ndarray | None = None,
                device="cuda", seed: int | None = None,
                mesh=None, scaler_zeros: float = 0.0,
                pretrain_params=None) -> nn.Module:
    """Mode dispatch: pretrain -> GPT-ST (`scaler_zeros` is the
    normalized zero that fills masked inputs); eval -> the frozen
    encoder, Fusion head and predictor (`build_enhanced`;
    `pretrain_params` is the pretrained GPT-ST or its state dict, and
    is required); ori and test -> the bare predictor.

    With `mesh` (`parallel/mesh.make_mesh`), `device` is its root: the
    model is data-parallel over the mesh's data rows in the trainer
    (`parallel/spmd.py`), and with a graph axis above 1 the predictor's
    graph supports are built node-sharded on every data row's graph
    ranks (`ops/graph_conv.make_sharded_support`), and GPT-ST (pretrain,
    and eval's frozen encoder) and every predictor run node-sharded on
    them when the graph axis divides `num_nodes` (`models/gptst.py`,
    `GraphPredictor.mesh`). A model whose node count the graph axis does
    not divide runs whole on each row's first device: one WARNING says
    so (`warn_whole_node_tables`)."""
    if cfg.mode == "pretrain":
        model = build_pretrain(cfg, scaler_zeros, device, seed, mesh)
    else:
        with use_sharding_mesh(mesh):
            if cfg.mode == "eval":
                if pretrain_params is None:
                    raise ValueError("eval mode requires pretrain_params "
                                     "(the pretrained GPT-ST or its state "
                                     "dict)")
                model = build_enhanced(cfg, scaler_zeros, pretrain_params,
                                       adj, device, seed, mesh)
            else:
                model = predictor_forward(cfg, build_predictor(
                    cfg, adj=adj, device=device, seed=seed))
    if mesh is not None and mesh.shape[GRAPH_AXIS] > 1:
        warn_whole_node_tables(cfg, model, mesh)
    return model


def warn_whole_node_tables(cfg: FrameworkConfig, model: nn.Module,
                           mesh) -> None:
    """One WARNING when a model under a graph axis above 1 runs whole on
    each data row's first device: where the graph axis does not divide
    `num_nodes` (GPT-ST and every predictor run node-sharded where it
    does). It counts the node tables (parameters whose first axis is
    `num_nodes`, which the JAX package shards over 'graph'), the GPT-ST
    and the dense graph operands that then stay whole."""
    from gptst_tpu_torch.ops.graph_conv import ShardedSupport
    from gptst_tpu_torch.utils.logger import get_logger

    if cfg.num_nodes % mesh.shape[GRAPH_AXIS] == 0:
        return
    tables = [k for k, p in model.named_parameters()
              if p.dim() and p.shape[0] == cfg.num_nodes]

    def flat(graph):
        for g in graph:
            if isinstance(g, (tuple, list)):
                yield from flat(g)
            elif g is not None:
                yield g

    dense = [g for m in model.modules() if isinstance(m, GraphPredictor)
             for g in flat(m.graph) if not isinstance(g, ShardedSupport)]
    gptst = cfg.mode in ("pretrain", "eval")
    get_logger("build", debug=cfg.debug).warning(
        "%s under a graph axis of %d, which does not divide its %d nodes, "
        "runs whole on each data row's first device (the same math): %d "
        "node tables%s%s stay whole there",
        "GPT-ST" if cfg.mode == "pretrain" else cfg.model,
        mesh.shape[GRAPH_AXIS], cfg.num_nodes, len(tables),
        ", the GPT-ST" if gptst else "",
        f", {len(dense)} graph operands" if dense else "")


class GraphPredictor(nn.Module):
    """A predictor network bound to its constant graph arguments (the
    support, STGCN's and ASTGCN's Chebyshev stacks, MSDR's static
    supports and learned-adjacency pattern, GWN's supports, MTGNN's
    predefined adjacency, STMGCN's support stacks, STSGCN's and STFGNN's
    synchronous graphs, STGODE's two graphs or DMVSTNET's adjacency).
    With `takes_generator` the trainer's generator reaches the network
    (dropout, ST_WA's latent draws); with
    `takes_targets` the labels, the step count and the generator do
    (CCRNN's scheduled sampling).

    `mesh` (under a mesh, every predictor's): the network runs
    node-sharded over the graph ranks of the calling data row
    (`shards`) where the graph axis is above 1 and divides N: its input
    is cut into the ranks' node shards (or comes so, from eval's
    node-sharded encoder or the trainer's resident split, as does
    CCRNN's y) and its output gathered on the row's first device, where
    the loss reads it. Else it runs whole there. A
    constant graph that the sharded network reads only by rows is then
    a `MeshRows` (`sharded_graph`)."""

    def __init__(self, net: nn.Module, *graph, takes_generator=False,
                 takes_targets=False, mesh=None):
        super().__init__()
        self.net = net
        self.graph = graph
        self.takes_generator = takes_generator
        self.takes_targets = takes_targets
        self.mesh = mesh

    def shards(self, device: torch.device) -> NodeShards | None:
        """The calling data row's graph ranks when the network runs
        node-sharded, else None."""
        if self.mesh is None:
            return None
        sh = node_shards(self.mesh, self.net.cfg.num_nodes,
                         current_row() or 0, device)
        return sh if sh.parts > 1 else None

    def forward(self, x_base, y=None, step=None,
                generator: torch.Generator | None = None):
        """x_base (B, T, N, C), or the list of the ranks' node shards of
        it (`shards`); the prediction whole."""
        kw = {}
        if self.takes_targets:
            kw = dict(y=y, step=step, generator=generator)
        elif self.takes_generator:
            kw = dict(generator=generator)
        split = isinstance(x_base, list)
        shards = self.shards((x_base[0] if split else x_base).device)
        if shards is None:
            return self.net(x_base, *self.graph, **kw)
        return shards.gather(self.net(shards.split(x_base), *self.graph,
                                      shards=shards, **kw))


# --- registrations ----------------------------------------------------------

@register_model("STGCN")
def _build_stgcn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                 device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.graph.artifacts import (
        cheb_poly_stack, scaled_laplacian,
    )
    from gptst_tpu_torch.models.predictors.stgcn import STGCN, STGCNConfig

    pcfg = make_predictor_config(STGCNConfig, cfg, num_nodes=cfg.num_nodes)
    cheb = torch.as_tensor(cheb_poly_stack(scaled_laplacian(adj), pcfg.ks),
                           dtype=torch.float32, device=device)
    net = STGCN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                generator=generator).to(device)
    return GraphPredictor(net, cheb, takes_generator=True,
                          mesh=sharding_mesh())


@register_model("TGCN")
def _build_tgcn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.graph.artifacts import sym_adj
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig

    pcfg = make_predictor_config(TGCNConfig, cfg, num_nodes=cfg.num_nodes)
    support = make_support(sym_adj(adj), device=device)
    net = TGCN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
               horizon=cfg.horizon, generator=generator).to(device)
    return GraphPredictor(net, support, mesh=sharding_mesh())


def msdr_adapt_pattern(mat0: np.ndarray, num_nodes: int, device="cuda"):
    """SDDMM pattern of MSDR's learned adjacency, from the first static
    support's edge list in ORIGINAL node order, with the pattern's own
    128 tile. The static supports may carry an RCM permutation, but the
    model's activations are in dataset order and `adaptive_support`
    returns an unpermuted support, so a pattern lifted from a permuted
    `supports[0].bcsr` would connect the wrong node pairs (and that
    bcsr is a placeholder when a DIA band takes the block part).
    Straggler-block edges are left out, as in the hybrid split."""
    from gptst_tpu_torch.kernels.sddmm import SDDMMPattern
    from gptst_tpu_torch.kernels.spmm import BlockCSR, coo_split_mask

    m0 = np.asarray(mat0)
    rows, cols = np.nonzero(m0)
    mk = coo_split_mask(rows, cols, num_nodes)
    return SDDMMPattern.from_bcsr(BlockCSR.from_coo(
        rows[mk], cols[mk], m0[rows, cols][mk], num_nodes, device=device))


@register_model("MSDR")
def _build_msdr(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.models.predictors.msdr import (
        MSDR, MSDRConfig, dual_random_walk_supports,
    )

    pcfg = make_predictor_config(MSDRConfig, cfg, num_nodes=cfg.num_nodes)
    mats = dual_random_walk_supports(adj)
    supports = tuple(make_support(s, device=device) for s in mats)
    # above the dense threshold the learned adjacency cannot be dense
    # (softmax(relu(E1 E2)) is O(N^2) memory): it is restricted to the
    # static graph's block pattern through the SDDMM path. Under a mesh
    # the static supports are node-sharded and the learned adjacency is
    # dense, as in the JAX package (by rows where the network runs
    # node-sharded).
    pattern = None
    if isinstance(supports[0], SparseSupport):
        pattern = msdr_adapt_pattern(mats[0], cfg.num_nodes, device)
    net = MSDR(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
               num_supports=len(supports), generator=generator).to(device)
    return GraphPredictor(net, supports, pattern, mesh=sharding_mesh())


@register_model("CCRNN")
def _build_ccrnn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                 device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.data.pipeline import load_raw_series, split_by_ratio
    from gptst_tpu_torch.graph.artifacts import svd_rbf_support
    from gptst_tpu_torch.models.predictors.ccrnn import (
        CCRNN, CCRNNConfig, svd_graph_embeddings,
    )

    pcfg = make_predictor_config(CCRNNConfig, cfg, num_nodes=cfg.num_nodes,
                                 n_dim=min(50, cfg.num_nodes))
    # the data-driven support of the training period (`args.py:57-76`),
    # from the dataset's default series as the JAX package reads it
    raw = load_raw_series(cfg.dataset)[:, : cfg.num_nodes]
    train, _, _ = split_by_ratio(raw, cfg.val_ratio, cfg.test_ratio)
    e1, e2 = svd_graph_embeddings(svd_rbf_support(train, hidden_size=20),
                                  pcfg.n_dim)
    net = CCRNN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                horizon=cfg.horizon, emb1_init=e1, emb2_init=e2,
                generator=generator).to(device)
    return GraphPredictor(net, takes_targets=True, mesh=sharding_mesh())


@register_model("MTGNN")
def _build_mtgnn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                 device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.models.predictors.mtgnn import MTGNN, MTGNNConfig

    pcfg = make_predictor_config(MTGNNConfig, cfg, num_nodes=cfg.num_nodes)
    net = MTGNN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                horizon=cfg.horizon, lag=cfg.lag,
                generator=generator).to(device)
    # the predefined graph of `build_adj=False` (`MTGNN.py` reads A - I)
    pre_adj = torch.as_tensor(
        np.asarray(adj - np.eye(cfg.num_nodes, dtype=adj.dtype), np.float32),
        device=device)
    return GraphPredictor(net, pre_adj, takes_generator=True,
                          mesh=sharding_mesh())


def gwn_adj_mats(adjtype: str, adj: np.ndarray) -> list[np.ndarray]:
    """GWN's support preprocessing (`GWN.py:299-313`)."""
    from gptst_tpu_torch.graph.artifacts import (
        asym_adj, scaled_laplacian, sym_adj, sym_norm_laplacian,
    )

    if adjtype == "doubletransition":
        return [asym_adj(adj), asym_adj(adj.T)]
    if adjtype == "transition":
        return [asym_adj(adj)]
    if adjtype == "symnadj":
        return [sym_adj(adj)]
    if adjtype == "scalap":
        return [np.asarray(scaled_laplacian(adj), np.float32)]
    if adjtype == "normlap":
        return [np.asarray(sym_norm_laplacian(adj), np.float32)]
    if adjtype == "identity":
        return [np.eye(adj.shape[0], dtype=np.float32)]
    raise ValueError(f"adj type not defined: {adjtype}")


@register_model("GWN")
def _build_gwn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
               device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.models.predictors.gwn import GWN, GWNConfig

    pcfg = make_predictor_config(GWNConfig, cfg, num_nodes=cfg.num_nodes)
    # aptonly drops the static supports from the forward, but the
    # SVD-seeded nodevecs still read supports[0] (`GWN.py:143-149`): the
    # matrices are built whenever either needs them
    mats = None
    supports: tuple = ()
    if not pcfg.aptonly:
        mats = gwn_adj_mats(pcfg.adjtype, adj)
        supports = tuple(make_support(m, device=device) for m in mats)
    nodevec_init = None
    if pcfg.gcn_bool and pcfg.addaptadj and not pcfg.randomadj:
        # E1 = U_k sqrt(S_k), E2 = sqrt(S_k) V_k^T of supports[0]
        # (`GWN.py:159-175`)
        if mats is None:
            mats = gwn_adj_mats(pcfg.adjtype, adj)
        u, s, vh = np.linalg.svd(mats[0].astype(np.float64))
        k = pcfg.adapt_rank
        nodevec_init = ((u[:, :k] * np.sqrt(s[:k])).astype(np.float32),
                        (np.sqrt(s[:k])[:, None] * vh[:k]).astype(np.float32))
    net = GWN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
              horizon=cfg.horizon, num_supports=len(supports),
              nodevec_init=nodevec_init, generator=generator).to(device)
    return GraphPredictor(net, supports, takes_generator=True,
                          mesh=sharding_mesh())


# --- the graph-convolution predictors of the ninth slice --------------------
#
# Each keeps what the JAX package's builder does (`gptst_tpu/models/
# build.py`), quirks included: STMGCN (without its prefabs), STFGNN and
# STGODE read `load_raw_series(cfg.dataset)`, the dataset's default
# series and not `cfg.data_root`'s, and slice it `[:, :num_nodes]`, which
# keeps fewer columns than `num_nodes` where the series has fewer nodes.


def _dense_graph(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def sharded_graph(a: np.ndarray, cfg: FrameworkConfig, device, rows=None):
    """A constant dense f32 graph operand: whole on `device`, or, under a
    sharding mesh (`use_sharding_mesh`) whose graph axis above 1 divides
    `num_nodes`, where the network runs node-sharded, cut into its graph
    ranks' rows (`MeshRows.cut`, with `rows`)."""
    mesh = sharding_mesh()
    g = 1 if mesh is None else mesh.shape[GRAPH_AXIS]
    if g == 1 or cfg.num_nodes % g:
        return _dense_graph(a, device)
    return MeshRows.cut(torch.as_tensor(np.asarray(a, np.float32)), mesh,
                        cfg.num_nodes, rows)


def stmgcn_support_stacks(cfg: FrameworkConfig, adj: np.ndarray,
                          cheb_k: int,
                          series_graph: np.ndarray | None = None
                          ) -> np.ndarray:
    """STMGCN's (2, K + 1, N, N) Chebyshev stacks: of `adj` and
    `series_graph` when it is given; else of the NYC prefab distance and
    Pearson graphs under `cfg.data_root` when present
    (`data/STMGCN_demand/{dis,pcc}_{bb,tt}.csv`,
    `model/STMGCN_demand/args.py:35-53`), else of `adj` and the Pearson
    graph of the training split."""
    from gptst_tpu_torch.data.pipeline import load_raw_series, split_by_ratio
    from gptst_tpu_torch.graph.artifacts import (
        cheb_poly_stack_rescaled, pearson_graph,
    )
    from gptst_tpu_torch.graph.io import load_stmgcn_prefabs

    if series_graph is not None:
        dis_graph, pcc_graph = adj, series_graph
    elif (prefab := load_stmgcn_prefabs(cfg.data_root,
                                        cfg.dataset)) is not None:
        dis_graph, pcc_graph = prefab
    else:
        raw = load_raw_series(cfg.dataset)[:, : cfg.num_nodes]
        train, _, _ = split_by_ratio(raw, cfg.val_ratio, cfg.test_ratio)
        dis_graph, pcc_graph = adj, pearson_graph(train)
    return np.nan_to_num(np.stack([
        cheb_poly_stack_rescaled(dis_graph, cheb_k),
        cheb_poly_stack_rescaled(pcc_graph, cheb_k)]))


@register_model("STMGCN")
def _build_stmgcn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                  device: torch.device, generator: torch.Generator,
                  series_graph: np.ndarray | None = None):
    from gptst_tpu_torch.models.predictors.stmgcn import STMGCN, STMGCNConfig

    pcfg = make_predictor_config(STMGCNConfig, cfg, num_nodes=cfg.num_nodes)
    stacks = sharded_graph(
        stmgcn_support_stacks(cfg, adj, pcfg.cheb_k, series_graph), cfg,
        device)
    net = STMGCN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                 seq_len=cfg.lag, generator=generator).to(device)
    return GraphPredictor(net, stacks, mesh=sharding_mesh())


@register_model("ASTGCN")
def _build_astgcn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                  device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.graph.artifacts import (
        cheb_poly_stack, scaled_laplacian,
    )
    from gptst_tpu_torch.models.predictors.astgcn import ASTGCN, ASTGCNConfig

    pcfg = make_predictor_config(ASTGCNConfig, cfg, num_nodes=cfg.num_nodes)
    cheb = _dense_graph(cheb_poly_stack(scaled_laplacian(adj), pcfg.K),
                        device)
    net = ASTGCN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                 horizon=cfg.horizon, lag=cfg.lag,
                 generator=generator).to(device)
    return GraphPredictor(net, cheb, mesh=sharding_mesh())


@register_model("STSGCN")
def _build_stsgcn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                  device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.models.predictors.stsgcn import (
        STSGCN, STSGCNConfig, construct_sync_adj,
    )

    pcfg = make_predictor_config(STSGCNConfig, cfg, num_nodes=cfg.num_nodes)
    sync_adj = sharded_graph(
        construct_sync_adj(adj, pcfg.steps), cfg, device,
        functools.partial(strided_rows, steps=pcfg.steps))
    net = STSGCN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                 horizon=cfg.horizon, lag=cfg.lag,
                 generator=generator).to(device)
    return GraphPredictor(net, sync_adj, mesh=sharding_mesh())


def _steps_per_day(dataset: str) -> int:
    from gptst_tpu_torch.config.datasets import get_dataset_spec

    return (24 * 60) // get_dataset_spec(dataset).interval


def stfgnn_fusion_graph(cfg: FrameworkConfig, adj: np.ndarray,
                        strides: int,
                        series_graph: np.ndarray | None = None
                        ) -> np.ndarray:
    """STFGNN's (strides * N)^2 fusion graph: of `adj` and
    `series_graph` when it is given; else the prefab under
    `cfg.data_root` when its shape fits (`data/STFGNN/<ds>/
    <ds>_adj_mx.npy`, the reference's cache of the FINAL fusion graph,
    `model/STFGNN/args.py:196-207`), else built from `adj` and the DTW
    graph of the training days (cached under `./.gptst_cache`)."""
    from gptst_tpu_torch.data.pipeline import load_raw_series
    from gptst_tpu_torch.graph.dtw import cached_artifact, stfgnn_dtw_graph
    from gptst_tpu_torch.graph.io import load_stfgnn_fusion_prefab
    from gptst_tpu_torch.models.predictors.stfgnn import construct_adj_fusion

    if series_graph is not None:
        return construct_adj_fusion(adj, series_graph, strides)
    fusion = load_stfgnn_fusion_prefab(cfg.data_root, cfg.dataset)
    if fusion is not None and fusion.shape[0] == strides * cfg.num_nodes:
        return fusion
    spd = _steps_per_day(cfg.dataset)
    raw = load_raw_series(cfg.dataset)[:, : cfg.num_nodes, 0]
    train_days = int((raw.shape[0] // spd) * 0.6)
    train = raw[: max(train_days, 1) * spd]
    a_dtw = cached_artifact(
        "./.gptst_cache", f"stfgnn_dtw_{cfg.dataset}_{cfg.num_nodes}",
        [raw[:1000]], lambda: stfgnn_dtw_graph(train, steps_per_day=spd))
    return construct_adj_fusion(adj, a_dtw, strides)


@register_model("STFGNN")
def _build_stfgnn(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                  device: torch.device, generator: torch.Generator,
                  series_graph: np.ndarray | None = None):
    from gptst_tpu_torch.models.predictors.stfgnn import STFGNN, STFGNNConfig

    pcfg = make_predictor_config(STFGNNConfig, cfg, num_nodes=cfg.num_nodes)
    fusion = sharded_graph(
        stfgnn_fusion_graph(cfg, adj, pcfg.strides, series_graph), cfg,
        device, functools.partial(strided_rows, steps=pcfg.strides))
    net = STFGNN(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                 horizon=cfg.horizon, lag=cfg.lag,
                 generator=generator).to(device)
    return GraphPredictor(net, fusion, mesh=sharding_mesh())


def stgode_graphs(cfg: FrameworkConfig, adj: np.ndarray,
                  series_graph: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """STGODE's normalized (spatial, semantic) graphs: of `adj` and
    `series_graph` when it is given; else of the prefab distance files
    under `cfg.data_root` when present (`data/STGODE/<ds>/
    <ds>_{dtw,spatial}_distance.npy`, `model/STGODE/args.py:57-125`),
    else of `adj` and the banded-DTW graph of the z-scored series
    (cached under `./.gptst_cache`)."""
    from gptst_tpu_torch.data.pipeline import load_raw_series
    from gptst_tpu_torch.graph.dtw import cached_artifact, stgode_dtw_graph
    from gptst_tpu_torch.graph.io import load_stgode_prefabs
    from gptst_tpu_torch.models.predictors.stgode import (
        stgode_normalized_adj,
    )

    if series_graph is not None:
        a_se, a_sp = series_graph, adj
    elif (prefab := load_stgode_prefabs(cfg.data_root,
                                        cfg.dataset)) is not None:
        a_se, a_sp = prefab
    else:
        spd = _steps_per_day(cfg.dataset)
        raw = load_raw_series(cfg.dataset)[:, : cfg.num_nodes, 0]
        mean, std = raw.mean(), max(raw.std(), 1e-8)
        a_se = cached_artifact(
            "./.gptst_cache", f"stgode_dtw_{cfg.dataset}_{cfg.num_nodes}",
            [raw[:1000]],
            lambda: stgode_dtw_graph((raw - mean) / std, steps_per_day=spd))
        a_sp = adj
    return stgode_normalized_adj(a_sp), stgode_normalized_adj(a_se)


@register_model("STGODE")
def _build_stgode(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                  device: torch.device, generator: torch.Generator,
                  series_graph: np.ndarray | None = None):
    from gptst_tpu_torch.models.predictors.stgode import STGODE, STGODEConfig

    pcfg = make_predictor_config(STGODEConfig, cfg, num_nodes=cfg.num_nodes)
    adj_sp, adj_se = (_dense_graph(a, device)
                      for a in stgode_graphs(cfg, adj, series_graph))
    net = STGODE(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                 horizon=cfg.horizon, lag=cfg.lag,
                 generator=generator).to(device)
    return GraphPredictor(net, adj_sp, adj_se, mesh=sharding_mesh())


# --- the last two predictors ------------------------------------------------


@register_model("ST_WA")
def _build_stwa(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.models.predictors.stwa import STWA, STWAConfig

    pcfg = make_predictor_config(STWAConfig, cfg, num_nodes=cfg.num_nodes)
    net = STWA(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
               horizon=cfg.horizon, lag=cfg.lag,
               generator=generator).to(device)
    return GraphPredictor(net, takes_generator=True, mesh=sharding_mesh())


@register_model("DMVSTNET")
def _build_dmvstnet(cfg: FrameworkConfig, dim_in: int, adj: np.ndarray,
                    device: torch.device, generator: torch.Generator):
    from gptst_tpu_torch.models.predictors.dmvstnet import (
        DMVSTNet, DMVSTNetConfig,
    )

    pcfg = make_predictor_config(DMVSTNetConfig, cfg,
                                 num_nodes=cfg.num_nodes)
    net = DMVSTNet(pcfg, dim_in=dim_in, dim_out=cfg.output_dim,
                   generator=generator).to(device)
    # the raw adjacency, not row-normalized, as the JAX builder passes it
    return GraphPredictor(net, _dense_graph(adj, device),
                          mesh=sharding_mesh())
