"""GPT-ST: generative pretraining network for spatio-temporal graphs.

Counterpart of the JAX package's `models/gptst.py` (the reference's
`model/Pretrain_model/GPTST.py`): a masked autoencoder whose encoder
and decoder are STHCN trunks (temporal hypergraph convolutions
interleaved with capsule cluster encoders), plus an adaptive-mask
curriculum driven by a mask-policy network (`MLPRL`).

Differences of form from the JAX package, not of math:
  * the random -> adaptive switch of the curriculum is a Python `if` on
    the integer epoch (a `lax.cond` there), and every random draw takes
    an explicit `torch.Generator`;
  * routing is a Python loop on detached tensors (`ops/capsule.py`);
  * in a data-parallel step the mask is drawn once from the global
    batch's guide and each data row takes its rows of it
    (`parallel/rows.on_global_batch`).

Node-sharded over a mesh's 'graph' axis (`GPTST.mesh`, set by
`models/build.py`; G ranks when G > 1 divides N, else whole on the
row's first device, as the JAX package's `batch_spec` replicates such a
node axis): rank g holds nodes `NodeShards.node_range(g)` of every
(B, T, N, .) activation and (B, T, HS, N) routing tensor of the trunks,
the mask policy and the output projection, and reads its rows of the
node tables (and of `Cap.adj`'s node axis) and every other parameter
through `.to()` (the gradients meet on the parameters' device). The
ranks meet only where the one-device math couples nodes, in program
order:
  * the time embeddings read node 0's calendar channels: computed once
    from the row's whole input and copied to each rank;
  * the mask: drawn once from the guide gathered over the row's ranks
    (and over the data rows), each rank taking its nodes;
  * Cap's sums over nodes (the routing's two, `ops/capsule.py`, and the
    cluster sum s): per-rank partials summed on the row's first device
    (`NodeShards.node_sum`), the node-free cluster stage run there once
    and its result copied to each rank;
  * what the loss reads (flow_out, the mask, the guide, the first
    routing) is gathered on the row's first device; the decoder
    output, which no loss reads, is not (`out_time` is None then).

Initialization is the reference's effective one (pretrain configs set
`xavier=True`, so every >1-D parameter is xavier-uniform and every 1-D
one uniform[0, 1)), drawn from the `generator` passed to the module.

State-dict keys of `GPTST` (the pretrain checkpoint that
`run.py -mode pretrain` writes with `torch.save`; `convert.py` maps each
to the flax tree, `Dense_k` <-> `dense.k`, `HyperTem_k` <->
`hyper_tem.k`, `Cap_k` <-> `cap.k`, `TimeFeature_k` <-> `time_feature.k`,
`TimeFeatureSPG_0` <-> `time_feature_spg`, kernels transposed):

  dim_in_flow.{weight,bias}            (hidden, base), (hidden,)
  dim_flow_out.{weight,bias}           (base, hidden), (base,)
  neb4mask                             (N, embed_dim)
  teb4mask.dense.{0..4}.{weight,bias}  a TimeFeature(embed_dim)
  mlp_rl.{weights_pool_spa,bias_pool_spa,weights_pool_tem,bias_pool_tem}
  mlp_rl.dense.{0,1}.{weight,bias}     (hidden, base), (HS, hidden)
  {encoder,decoder}.node_embeddings, .node_embeddings_spg   (N, embed_dim)
  {encoder,decoder}.time_feature.{0,1}.dense.{0..4}.*   embed_dim, embed_dim_spa
  {encoder,decoder}.time_feature_spg.dense.{0..4}.*     embed_dim_spa
  {encoder,decoder}.hyper_tem.{0..3}.{adj,weights_pool,bias_pool}
  {encoder,decoder}.cap.{0,1}.{t_adj,adj,weights_spa,bias_spa}
  {encoder,decoder}.cap.{0,1}.dense.0.{weight,bias}
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.ops.capsule import dynamic_routing, squash
from gptst_tpu_torch.ops.param_pool import node_param_linear, time_param_linear
from gptst_tpu_torch.ops.recurrent import remat_cell
from gptst_tpu_torch.parallel.mesh import NodeShards, node_shards
from gptst_tpu_torch.parallel.rows import current_row, on_global_batch


def xavier_limit(shape: tuple[int, ...]) -> float:
    """flax `xavier_uniform()`'s bound for a parameter of flax `shape`:
    fans over the last two axes, the leading ones a receptive field."""
    field = math.prod(shape[:-2])
    fan_in = (shape[-2] if len(shape) > 1 else 1) * field
    return math.sqrt(6.0 / (fan_in + shape[-1] * field))


def _xavier(shape: tuple[int, ...], gen: torch.Generator) -> nn.Parameter:
    lim = xavier_limit(shape)
    return nn.Parameter(torch.rand(shape, generator=gen) * (2 * lim) - lim)


def _at(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Parameter t on x's rank (t itself when it lies there)."""
    return t.to(x.device)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`lin(x)` on x's rank."""
    return F.linear(x, _at(lin.weight, x), _at(lin.bias, x))


def _dense(din: int, dout: int, gen: torch.Generator) -> nn.Linear:
    """flax Dense under the reference's xavier sweep: xavier-uniform
    kernel, uniform[0, 1) bias."""
    lin = nn.Linear(din, dout)
    with torch.no_grad():
        lin.weight.copy_(_xavier((din, dout), gen).T)
        lin.bias.copy_(torch.rand(dout, generator=gen))
    return lin


@dataclasses.dataclass(frozen=True)
class GPTSTConfig:
    num_nodes: int
    input_base_dim: int = 1
    hidden_dim: int = 64
    horizon: int = 12           # == lag; both are 12 in every config
    embed_dim: int = 16
    embed_dim_spa: int = 4
    HS: int = 10
    HT: int = 16
    HT_Tem: int = 8
    num_route: int = 2
    mask_ratio: float = 0.25
    ada_mask_ratio: float = 0.5
    ada_type: str = "all"
    change_epoch: int = 10
    epochs: int = 300
    scaler_zeros: float = 0.0
    # activation remat of each HyperTem and Cap call of the trunks
    # (none|full|dots, `ops/recurrent.remat_cell`)
    remat: str = "none"

    @staticmethod
    def from_framework(cfg: FrameworkConfig,
                       scaler_zeros: float) -> "GPTSTConfig":
        return GPTSTConfig(
            num_nodes=cfg.num_nodes, input_base_dim=cfg.input_base_dim,
            hidden_dim=cfg.hidden_dim, horizon=cfg.horizon,
            embed_dim=cfg.embed_dim, embed_dim_spa=cfg.embed_dim_spa,
            HS=cfg.HS, HT=cfg.HT, HT_Tem=cfg.HT_Tem,
            num_route=cfg.num_route, mask_ratio=cfg.mask_ratio,
            ada_mask_ratio=cfg.ada_mask_ratio, ada_type=cfg.ada_type,
            change_epoch=cfg.change_epoch, epochs=cfg.epochs,
            scaler_zeros=float(scaler_zeros), remat=cfg.pretrain_remat)


class TimeFeature(nn.Module):
    """Per-(b, t) embedding of the (day slot, weekday) scalars:
    (B, T, 2) -> (B, T, E)."""

    def __init__(self, embed_dim: int, gen: torch.Generator,
                 din: int = 1):
        super().__init__()
        e = embed_dim
        self.dense = nn.ModuleList(
            [_dense(din, e, gen), _dense(din, e, gen), _dense(e, e, gen),
             _dense(e, e, gen), _dense(e, e, gen)])

    def _embed(self, day, week):
        d = self.dense
        h = F.relu(d[2](d[0](day) + d[1](week)))
        return d[4](F.relu(d[3](h)))

    def forward(self, eb: torch.Tensor) -> torch.Tensor:
        return self._embed(eb[:, :, 0:1], eb[:, :, 1:2])


class TimeFeatureSPG(TimeFeature):
    """Whole-window time embedding, a Linear over the T steps:
    (B, T, 2) -> (B, E)."""

    def __init__(self, embed_dim: int, timesteps: int,
                 gen: torch.Generator):
        super().__init__(embed_dim, gen, din=timesteps)

    def forward(self, eb: torch.Tensor) -> torch.Tensor:
        return self._embed(eb[:, :, 0], eb[:, :, 1])


class HyperTem(nn.Module):
    """Temporal hypergraph convolution: a node-conditioned incidence over
    time (HT_Tem hyperedges x T steps) aggregates along time and
    broadcasts back, then a time-conditioned parameter-pool linear,
    residual and LeakyReLU."""

    def __init__(self, timesteps: int, dim_in: int, dim_out: int,
                 embed_dim: int, ht_tem: int, gen: torch.Generator):
        super().__init__()
        self.adj = _xavier((embed_dim, ht_tem, timesteps), gen)
        self.weights_pool = _xavier((embed_dim, dim_in, dim_out), gen)
        self.bias_pool = _xavier((embed_dim, dim_out), gen)

    def forward(self, eb, node_emb, time_eb):
        """Per node: on a rank, eb and node_emb are its nodes' shard and
        rows, time_eb its copy."""
        # (N, E) x (E, H, T) -> (H, T, N)
        adj_dyn = torch.einsum("nk,kht->nht", node_emb,
                               _at(self.adj, eb)).permute(1, 2, 0)
        hyper = torch.einsum("htn,btnd->bhnd", adj_dyn, eb)
        ret = torch.einsum("thn,bhnd->btnd", adj_dyn.permute(1, 0, 2), hyper)
        out = time_param_linear(ret, time_eb, _at(self.weights_pool, eb),
                                _at(self.bias_pool, eb))
        return F.leaky_relu(out + eb)


class Cap(nn.Module):
    """Hierarchical spatial pattern encoder: primary capsules ->
    time-conditioned cluster routing -> per-timestep positional offset
    -> inter-cluster hypergraph message passing over HT hyperedges ->
    reconstruction to nodes -> per-node parameter-pool output, residual
    and LeakyReLU.

    Returns (out, routing c, dynamic inter-cluster incidence), the last
    two detached as in the reference.

    With `shards` (`parallel/mesh.NodeShards`), x, node_emb and teb are
    lists, each rank's node shard, its rows of the node table and its
    copy of teb, and so are out and c; time_eb_spg and the cluster stage
    (B, HS*T, D) live on the row's first device."""

    def __init__(self, dim: int, num_nodes: int, timesteps: int,
                 embed_dim: int, embed_dim_spa: int, hs: int, ht: int,
                 num_route: int, gen: torch.Generator):
        super().__init__()
        self.hs, self.timesteps, self.num_route = hs, timesteps, num_route
        self.t_adj = _xavier((embed_dim_spa, ht, hs * timesteps), gen)
        self.adj = _xavier((embed_dim_spa, hs, num_nodes), gen)
        self.weights_spa = _xavier((embed_dim, dim, dim), gen)
        self.bias_spa = _xavier((embed_dim, dim), gen)
        self.dense = nn.ModuleList([_dense(dim, dim, gen)])

    def forward(self, x, node_emb, time_eb_spg, teb,
                shards: NodeShards | None = None):
        whole = shards is None
        if whole:
            shards = NodeShards((x.device,), x.shape[2])
            x, node_emb, teb = [x], [node_emb], [teb]
        adj = shards.split(self.adj, dim=-1)
        pcaps = [squash(_linear(self.dense[0], xg)) for xg in x]  # (B,T,N,D)
        dadj = [torch.einsum("btd,dhn->bthn", tg, ag)             # (B,T,HS,N)
                for tg, ag in zip(teb, adj)]
        c = dynamic_routing(pcaps, dadj, self.num_route, shards)  # (B,T,HS,N)

        s = shards.node_sum([torch.einsum("bthn,btnd->bthd", cg, pg)
                             for cg, pg in zip(c, pcaps)])      # (B,T,HS,D)
        B, T, _, D = s.shape
        time_index = (torch.arange(1, T + 1, dtype=s.dtype, device=s.device)
                      / 12.0)[None, :, None, None]
        hyper_spa = (s + time_index).reshape(B, self.hs * T, D)

        dyn = torch.einsum("bd,dhk->bhk", time_eb_spg,
                           _at(self.t_adj, s))                  # (B,HT,TT)
        hyper_tem = F.leaky_relu(torch.einsum("bhk,bkd->bhd", dyn, hyper_spa))
        ret_tem = F.leaky_relu(torch.einsum(
            "bkh,bhd->bkd", dyn.transpose(1, 2), hyper_tem))
        ret = ret_tem.reshape(B, T, self.hs, D) + s

        out = []
        for xg, cg, rg, ng in zip(x, c, shards.replicate(squash(ret)),
                                  node_emb):
            recon = torch.einsum("bthn,bthd->btnd", cg, rg)
            og = node_param_linear(recon, ng, _at(self.weights_spa, xg),
                                   _at(self.bias_spa, xg))
            out.append(F.leaky_relu(og + xg))
        c = [cg.detach() for cg in c]
        if whole:
            return out[0], c[0], dyn.detach()
        return out, c, dyn.detach()


class MLPRL(nn.Module):
    """Mask-policy network: per-node then per-(b, t) parameter-pool
    MLPs giving HS cluster logits per (b, t, n)."""

    def __init__(self, dim_in: int, dim_out: int, hidden_dim: int,
                 embed_dim: int, gen: torch.Generator):
        super().__init__()
        h = hidden_dim
        self.weights_pool_spa = _xavier((embed_dim, h, h), gen)
        self.bias_pool_spa = _xavier((embed_dim, h), gen)
        self.weights_pool_tem = _xavier((embed_dim, h, h), gen)
        self.bias_pool_tem = _xavier((embed_dim, h), gen)
        self.dense = nn.ModuleList([_dense(dim_in, h, gen),
                                    _dense(h, dim_out, gen)])

    def forward(self, eb, time_eb, node_eb):
        """Per node, as `HyperTem.forward`."""
        h = _linear(self.dense[0], eb)
        h = F.leaky_relu(node_param_linear(
            h, node_eb, _at(self.weights_pool_spa, h),
            _at(self.bias_pool_spa, h)))
        h = F.leaky_relu(time_param_linear(
            h, time_eb, _at(self.weights_pool_tem, h),
            _at(self.bias_pool_tem, h)))
        return _linear(self.dense[1], h)


class STHCN(nn.Module):
    """Encoder/decoder trunk: hyperTem1 -> cap1 -> hyperTem2 ->
    hyperTem3 -> cap2 -> hyperTem4, with the time embeddings computed
    once from node 0's calendar channels. Returns (out, routing of cap1,
    routing of cap2); with `shards`, x_in and the results are lists of
    the ranks' node shards, and `source` is the row's whole input."""

    def __init__(self, cfg: GPTSTConfig, gen: torch.Generator):
        super().__init__()
        c = self.cfg = cfg
        self.node_embeddings = _xavier((c.num_nodes, c.embed_dim), gen)
        self.node_embeddings_spg = _xavier((c.num_nodes, c.embed_dim), gen)
        self.time_feature = nn.ModuleList([
            TimeFeature(c.embed_dim, gen), TimeFeature(c.embed_dim_spa, gen)])
        self.time_feature_spg = TimeFeatureSPG(c.embed_dim_spa, c.horizon, gen)
        self.hyper_tem = nn.ModuleList([
            HyperTem(c.horizon, c.hidden_dim, c.hidden_dim, c.embed_dim,
                     c.HT_Tem, gen) for _ in range(4)])
        self.cap = nn.ModuleList([
            Cap(c.hidden_dim, c.num_nodes, c.horizon, c.embed_dim,
                c.embed_dim_spa, c.HS, c.HT, c.num_route, gen)
            for _ in range(2)])

    def forward(self, source, x_in, shards: NodeShards | None = None):
        whole = shards is None
        if whole:
            shards = NodeShards((x_in.device,), x_in.shape[2])
            x_in = [x_in]
        b = self.cfg.input_base_dim
        tcat = source[:, :, 0, b:b + 2]
        time_eb = shards.replicate(self.time_feature[0](tcat))
        teb = shards.replicate(self.time_feature[1](tcat))
        time_eb_spg = self.time_feature_spg(tcat)
        node_emb = shards.split(self.node_embeddings, dim=0)
        node_emb_spg = shards.split(self.node_embeddings_spg, dim=0)

        def ht(i, x):
            cell = remat_cell(self.hyper_tem[i], self.cfg.remat)
            return [cell(xg, ng, tg)
                    for xg, ng, tg in zip(x, node_emb, time_eb)]

        def cap(i, x):
            return remat_cell(self.cap[i], self.cfg.remat)(
                x, node_emb_spg, time_eb_spg, teb, shards)

        xg1, hs1, _ = cap(0, ht(0, x_in))
        xg3, hs3, _ = cap(1, ht(2, ht(1, xg1)))
        out = ht(3, xg3)
        if whole:
            return out[0], hs1[0], hs3[0]
        return out, hs1, hs3


def _rank_desc(score: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of element i in the stable descending sort of
    `score` (ties keep index order, as `jnp.argsort` does)."""
    order = torch.argsort(-score, stable=True)
    return torch.argsort(order, stable=True)


def generate_mask(cfg: GPTSTConfig, generator: torch.Generator,
                  guide: torch.Tensor, epoch: int,
                  shape: tuple[int, int, int, int]) -> torch.Tensor:
    """The mask curriculum, in fixed-shape rank arithmetic.

    guide: (B, T, N, HS) mask-policy softmax; epoch: the integer epoch;
    shape: (B, T, N, base); `generator` on guide's device. Returns the
    f32 mask in {0, 1} (0 = masked) on guide's device.

    epoch <= change_epoch: exactly int(mask_ratio * numel) uniformly
    random entries over all (b, t, n, channel) positions are masked (one
    draw: u).

    epoch > change_epoch: the clusters (argmax of guide) are visited in
    a random order; whole clusters are masked until the adaptive budget
    a_num = floor(int(mask_ratio * B*T*N) * min(ramp, 1)) is crossed,
    and the boundary cluster is sampled to fill it exactly
    (ada_type 'all'; 'half' samples the budget from the union of the
    visited clusters instead); the rest of the budget is filled by
    uniformly random masking of still-unmasked positions, and the
    (B, T, N) mask repeats across channels. Draws, in order: the visit
    order (a permutation of HS), u1 (boundary sampling), u2 (random
    completion). The budget arithmetic is f32 and int, as in the JAX
    package.
    """
    B, T, N, base = shape
    dev = guide.device

    def uniform(n):
        return torch.rand(n, generator=generator, device=dev)

    if epoch <= cfg.change_epoch:
        numel = B * T * N * base
        k = int(numel * cfg.mask_ratio)
        return (_rank_desc(uniform(numel)) >= k).float().reshape(shape)

    m = B * T * N
    mask_num_sum = int(m * cfg.mask_ratio)
    ramp = (np.float32(epoch - cfg.change_epoch)
            / np.float32(cfg.epochs - cfg.change_epoch)
            * np.float32(cfg.ada_mask_ratio))
    ramp = min(ramp, np.float32(1.0))
    a_num = int(np.floor(np.float32(mask_num_sum) * ramp))
    rand_num = mask_num_sum - a_num

    label_c = guide.argmax(-1).reshape(-1)
    perm = torch.randperm(cfg.HS, generator=generator, device=dev)
    elem_rank = torch.argsort(perm)[label_c]       # visit rank of each element
    cum = torch.bincount(elem_rank, minlength=cfg.HS).cumsum(0)
    # i = number of clusters visited until the budget is crossed
    if a_num > 0:
        i = torch.searchsorted(
            cum, torch.tensor([a_num], device=dev, dtype=cum.dtype))[0] + 1
    else:
        i = torch.zeros((), dtype=torch.long, device=dev)

    if cfg.ada_type == "all":
        select_d = (elem_rank <= i - 2).float()
        select_f = (elem_rank == i - 1).float()
    else:  # 'half'
        select_d = torch.zeros(m, device=dev)
        select_f = (elem_rank <= i - 1).float()
    dnum = select_d.sum().int()

    masked1 = (_rank_desc(select_f * uniform(m)) < a_num - dnum).float()
    mask_adaptive = (1.0 - masked1) * (1.0 - select_d)
    masked2 = (_rank_desc(mask_adaptive * uniform(m)) < rand_num).float()
    final = (mask_adaptive * (1.0 - masked2)).reshape(B, T, N, 1)
    return final.expand(B, T, N, base)


class GPTST(nn.Module):
    """The pretrain network: `pretrain` (masked autoencoding) and
    `encode` (the frozen encoder's embedding), node-sharded over the
    graph ranks of the calling data row when `mesh` is set (see the
    module docstring)."""

    def __init__(self, cfg: GPTSTConfig,
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        # a `parallel/mesh.Mesh`, or None: one device
        self.mesh = mesh
        c = self.cfg = cfg
        gen = generator if generator is not None else torch.Generator()
        self.dim_in_flow = _dense(c.input_base_dim, c.hidden_dim, gen)
        self.encoder = STHCN(c, gen)
        self.decoder = STHCN(c, gen)
        self.dim_flow_out = _dense(c.hidden_dim, c.input_base_dim, gen)
        self.mlp_rl = MLPRL(c.input_base_dim, c.HS, c.hidden_dim,
                            c.embed_dim, gen)
        self.teb4mask = TimeFeature(c.embed_dim, gen)
        self.neb4mask = _xavier((c.num_nodes, c.embed_dim), gen)

    def shards(self, source: torch.Tensor) -> NodeShards:
        """The node shards of the calling data row (row 0 outside a
        data-parallel forward), or one shard on source's device."""
        return node_shards(self.mesh, self.cfg.num_nodes,
                           current_row() or 0, source.device)

    def policy(self, source, base, shards) -> list[torch.Tensor]:
        """The mask policy's (B, T, n_g, HS) softmax on each rank's
        nodes; `base` the ranks' shards of the base channels."""
        b = self.cfg.input_base_dim
        time_eb = shards.replicate(self.teb4mask(source[:, :, 0, b:b + 2]))
        return [torch.softmax(self.mlp_rl(xg, tg, ng), dim=-1)
                for xg, tg, ng in zip(base, time_eb,
                                      shards.split(self.neb4mask, dim=0))]

    def pretrain(self, source: torch.Tensor, generator: torch.Generator,
                 epoch: int):
        """Returns (flow_out, decoder output, 1 - mask, policy softmax,
        routing of the encoder's first Cap as (B, T, N, HS)); node-
        sharded, the decoder output is None."""
        c = self.cfg
        b = c.input_base_dim
        shards = self.shards(source)
        base = shards.split(source[..., :b])
        guide = shards.gather(self.policy(source, base, shards))
        # in a data-parallel step: once, from the global batch's guide
        mask = on_global_batch(lambda g: generate_mask(
            c, generator, g, epoch, (g.shape[0], c.horizon, c.num_nodes, b)),
            guide.detach())
        # built in f32 for exact budget arithmetic, then cast so that a
        # bf16 forward stays bf16
        mask = mask.to(source.dtype)
        x_in = [_linear(self.dim_in_flow, torch.where(
                    mg == 0, c.scaler_zeros, mg * xg))
                for mg, xg in zip(shards.split(mask), base)]
        enc, hs1, _ = self.encoder(source, x_in, shards)
        dec, _, _ = self.decoder(source, enc, shards)
        flow = shards.gather([_linear(self.dim_flow_out, d) for d in dec])
        return (flow, dec[0] if shards.parts == 1 else None, 1.0 - mask,
                guide, shards.gather(hs1, dim=-1).permute(0, 1, 3, 2))

    def encode(self, source: torch.Tensor) -> torch.Tensor:
        """The frozen-encoder embedding (B, T, N, hidden) of the
        unmasked input, on source's device."""
        shards, out = self.encode_shards(source)
        return shards.gather(out)

    def encode_shards(self, source: torch.Tensor
                      ) -> tuple[NodeShards, list[torch.Tensor]]:
        """The node shards and each rank's shard of `encode(source)`, left
        on its rank (for a node-sharded predictor)."""
        shards = self.shards(source)
        x_flow = [_linear(self.dim_in_flow, xg) for xg in
                  shards.split(source[..., : self.cfg.input_base_dim])]
        return shards, self.encoder(source, x_flow, shards)[0]

    def forward(self, source: torch.Tensor,
                generator: torch.Generator | None = None,
                epoch: int | None = None):
        if generator is None:
            return self.encode(source)
        return self.pretrain(source, generator, epoch)
