"""Graph aggregation: `graph_matmul` over a dense or sparse support.

All graph aggregation flows through `graph_matmul`, which dispatches on
the support representation:

  * a plain (N, N) tensor — one dense matmul (f32 support, the product
    in the promoted dtype); the default at reference scale (N <= 266)
    and below `DENSE_THRESHOLD` nodes;
  * `SparseSupport` — the hand-written CUDA kernels of
    `kernels/spmm.py` (DIA band or block-CSR) plus the COO straggler
    tail, with an optional RCM node reordering that concentrates the
    nonzero blocks;
  * `ShardedSupport` — node-sharded aggregation over a mesh's 'graph'
    axis (`parallel/halo.py`: the boundary halo exchange or the ring).

A dense graph that a node-sharded predictor computes or reads (GWN's
adaptive adjacency, MTGNN's and CCRNN's learned graphs, a predefined
adjacency) is a `NodeRows`: rank g holds its rows, and the products
(`NodeRows.matmul`, `mixprop`, `diffusion_conv`, `sharded_cheb_conv`)
take and give lists of the ranks' node shards. A constant graph that
only rows ever read (STMGCN's support stacks, STSGCN's and STFGNN's
synchronous graphs, `strided_rows`) is cut into them once, at build
(`MeshRows`).

`make_support` picks the representation from the node count, or the
sharded one under a mesh, so model code is representation-agnostic.
Layout: x is (..., N, C); supports act on the N axis.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch

from gptst_tpu_torch.kernels.spmm import (
    BlockCSR, COOTail, DIABand, coo_matmul, coo_split_mask, dia_matmul,
    dia_pair_from_coo, spmm, split_coo_hybrid,
)
from gptst_tpu_torch.ops.dtypes import promoted, widened
from gptst_tpu_torch.parallel.mesh import GRAPH_AXIS, NodeShards
from gptst_tpu_torch.parallel.rows import current_row
from gptst_tpu_torch.utils.device import resolve_device

# The mesh that `make_support` shards over when it is given none: set
# for the duration of a model build by `use_sharding_mesh(mesh)`.
_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "gptst_tpu_torch_sharding_mesh", default=None)


def sharding_mesh():
    """The mesh set by the enclosing `use_sharding_mesh`, or None."""
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def use_sharding_mesh(mesh):
    """Within the block, `make_support` routes aggregation through the
    node-sharded paths on `mesh`'s 'graph' axis (when it is above 1)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


# Below this node count a dense (N, N) matmul is the support: the same
# threshold as the JAX package, so both pick the same representation.
DENSE_THRESHOLD = 4096


@dataclasses.dataclass
class SparseSupport:
    """Block-CSR adjacency (+ its transpose, for the backward), optionally
    behind an RCM node permutation, optionally with a COO straggler tail,
    and with a DIA band in place of the block-CSR kernels when the block
    part is a narrow tile band (then `bcsr`/`bcsr_t` are 1-zero-block
    placeholders that are never read).

    With a permutation, `graph_matmul` computes Pᵀ (A_perm @ (P x)) so
    callers keep the original node order.
    """

    bcsr: BlockCSR
    bcsr_t: BlockCSR
    perm: torch.Tensor | None = None      # (N,) permuted pos -> original
    inv_perm: torch.Tensor | None = None
    coo: COOTail | None = None
    coo_t: COOTail | None = None
    dia: DIABand | None = None
    dia_t: DIABand | None = None

    @property
    def T(self) -> "SparseSupport":
        return SparseSupport(self.bcsr_t, self.bcsr, self.perm,
                             self.inv_perm, self.coo_t, self.coo,
                             self.dia_t, self.dia)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.bcsr.n, self.bcsr.n)


def _count_blocks(rows: np.ndarray, cols: np.ndarray, tile: int) -> int:
    pairs = (rows // tile).astype(np.int64) * (1 << 32) + cols // tile
    return int(np.unique(pairs).size)


@dataclasses.dataclass(frozen=True)
class ShardedSupport:
    """Node-sharded aggregation over a mesh's 'graph' axis: `fn` is the
    sharded A @ x on data row 0's graph ranks (the boundary halo
    exchange, or the ring for halo-heavy graphs, `parallel/halo.py`),
    chosen from the partition's traffic
    (`graph/partition.partition_stats`); `row_fns` the same product on
    the graph ranks of data rows 1, 2, ... (the same function where a
    row's ranks are row 0's devices). `graph_matmul` pads x's node axis
    to `n_pad`, runs the product of the data row it is called from
    (`parallel/rows.current_row`) and slices back. Given the list of a
    node-sharded model's node shards it runs `on_shards`: the ranks'
    shards in, the ranks' shards out, no gather."""

    fn: object                # `parallel/halo.ShardProduct`
    n: int
    n_pad: int
    kind: str                 # 'halo' | 'ring'
    row_fns: tuple = ()
    # the partition keeps the dataset's node order (`reorder=False`)
    in_node_order: bool = True

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def T(self):
        raise AttributeError(
            "a ShardedSupport has no transpose: GWN with static supports "
            "(--aptonly False) under a graph axis raises here as in the "
            "JAX package (ROADMAP.md Queue 3, item 15); run it with the "
            "adaptive adjacency alone (aptonly) or without a graph axis")

    def fn_of_row(self, row: int | None):
        """The product on data row `row`'s graph ranks (row 0 for
        None)."""
        if not row:
            return self.fn
        if row > len(self.row_fns):
            raise ValueError(f"data row {row}: the support was built for "
                             f"{1 + len(self.row_fns)} data rows")
        return self.row_fns[row - 1]

    def on_shards(self, xs: list) -> list:
        """A @ x with x the calling data row's node shards, rank g's
        (..., N / G, C) on its device (`parallel/mesh.NodeShards`): the
        partition's rank ranges are those shards' when it keeps the node
        order and G divides N (then `n_pad` is N), which is asserted."""
        n_loc = self.n_pad // len(xs)
        if not (self.in_node_order and self.n_pad == self.n
                and all(x.shape[-2] == n_loc for x in xs)):
            raise ValueError(
                f"node shards of {[x.shape[-2] for x in xs]} rows do not "
                f"match the partition of {self.n} nodes into "
                f"{len(xs)} x {n_loc} (padded to {self.n_pad}, node order "
                f"kept: {self.in_node_order})")
        return self.fn_of_row(current_row()).on_shards(xs)


def make_sharded_support(adj: np.ndarray | None, mesh,
                         part=None) -> ShardedSupport:
    """Partition `adj` over the mesh's 'graph' axis and pick the path
    that moves fewer feature rows per call: the boundary halo exchange,
    or the ring, built on the graph ranks of every data row (once per
    distinct set of ranks). Pass a prebuilt `GraphPartition` (e.g. from
    `partition_graph_coo` for graphs too big to densify) to skip the
    dense partitioning; the ring needs the dense `adj`."""
    from gptst_tpu_torch.graph.partition import (
        partition_graph, partition_stats,
    )
    from gptst_tpu_torch.parallel.halo import make_halo_spmm, make_ring_spmm

    parts = mesh.shape[GRAPH_AXIS]
    if part is None:
        # reorder=False: the model's node order is the dataset's
        # (node-indexed parameters, metrics and labels use it)
        part = partition_graph(adj, parts, reorder=False)
    stats = partition_stats(part)
    kind = ("halo" if adj is None
            or stats["halo_rows_moved"] <= stats["ring_rows_moved"]
            else "ring")
    built: dict[tuple, object] = {}
    fns = []
    for row in range(mesh.local_rows):
        ranks = tuple(mesh.graph_devices(row))
        if ranks not in built:
            built[ranks], n_pad = (make_halo_spmm(mesh, part, row)
                                   if kind == "halo"
                                   else make_ring_spmm(mesh, adj, row))
        fns.append(built[ranks])
    return ShardedSupport(
        fn=fns[0], n=part.n, n_pad=n_pad, kind=kind, row_fns=tuple(fns[1:]),
        in_node_order=bool(np.array_equal(part.perm, np.arange(part.n))))


def make_support(adj: np.ndarray, *, dense_threshold: int = DENSE_THRESHOLD,
                 tile: int = 128, reorder: bool = True, hybrid: bool = True,
                 device="cuda", mesh=None):
    """Pick the aggregation representation for a precomputed support:
    a dense f32 tensor up to `dense_threshold` nodes, a `SparseSupport`
    above it. With `reorder=True` an RCM ordering is kept only if it
    cuts the nonzero block count by more than 10%. `hybrid=True` routes
    edges in nearly empty blocks through the COO tail.

    With a `mesh` (or one set by `use_sharding_mesh`) whose 'graph' axis
    is above 1, aggregation runs node-sharded on the mesh's devices
    (`make_sharded_support`) whatever the node count."""
    n = adj.shape[0]
    if mesh is None:
        mesh = sharding_mesh()
    if mesh is not None and mesh.shape[GRAPH_AXIS] > 1:
        return make_sharded_support(np.asarray(adj), mesh)
    if n <= dense_threshold:
        return torch.as_tensor(np.asarray(adj, np.float32),
                               device=resolve_device(device))
    adj = np.asarray(adj)
    rows, cols = np.nonzero(adj)
    return make_support_coo(rows, cols, adj[rows, cols], n, tile=tile,
                            reorder=reorder, hybrid=hybrid, device=device)


def make_support_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     n: int, *, tile: int = 128, reorder: bool = True,
                     hybrid: bool = True, vals_dtype=torch.float32,
                     device="cuda") -> SparseSupport:
    """`SparseSupport` straight from an edge list (no dense (N, N))."""
    dev = resolve_device(device)
    perm = inv_perm = None
    if reorder:
        from gptst_tpu_torch.graph.partition import rcm_order_coo

        p = rcm_order_coo(rows, cols, n)
        inv = np.empty_like(p)
        inv[p] = np.arange(n)
        if (_count_blocks(inv[rows], inv[cols], tile)
                < 0.9 * _count_blocks(rows, cols, tile)):
            rows, cols = inv[rows], inv[cols]
            perm = torch.as_tensor(p, device=dev)
            inv_perm = torch.as_tensor(inv, device=dev)
    dia = dia_t = None
    if hybrid:
        # the DIA band takes the block part when it is a narrow, dense
        # enough tile band; the block-CSR slots then hold placeholders
        mask = coo_split_mask(rows, cols, n, tile)
        pair = dia_pair_from_coo(rows[mask], cols[mask], vals[mask], n,
                                 tile, vals_dtype, dev)
        if pair is not None:
            dia, dia_t = pair
        bcsr, bcsr_t, coo, coo_t = split_coo_hybrid(
            rows, cols, vals, n, tile=tile, vals_dtype=vals_dtype,
            mask=mask, build_blocks=pair is None, device=dev)
    else:
        bcsr, bcsr_t = BlockCSR.pair_from_coo(rows, cols, vals, n, tile,
                                              vals_dtype, dev)
        coo = coo_t = None
    return SparseSupport(bcsr, bcsr_t, perm, inv_perm, coo, coo_t,
                         dia, dia_t)


def graph_matmul(support, x: torch.Tensor) -> torch.Tensor:
    """support @ x over the node axis.

    support: (N, N) tensor, `SparseSupport` or `ShardedSupport`; x:
    (..., N, C), or for a `ShardedSupport` or `NodeRows` the list of a
    data row's node shards (then the result is too). Dense: one matmul
    in the promoted dtype of the support and x, as `jnp.einsum` promotes
    in the JAX package (a bf16 x on the f32 support gives an f32
    product). Sparse: the DIA or block-CSR
    kernel (leading dims fold into the feature axis inside the call)
    plus the COO tail, inside the RCM permutation. Sharded: x
    zero-padded to the support's node count, the sharded product, the
    padding sliced off; on node shards, the shards' product.
    """
    if isinstance(x, list):
        return (support.matmul(x) if isinstance(support, NodeRows)
                else support.on_shards(x))
    if isinstance(support, ShardedSupport):
        n = x.shape[-2]
        if n != support.n_pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, support.n_pad - n))
        out = support.fn_of_row(current_row())(x)
        return out[..., :n, :] if n != support.n_pad else out
    if isinstance(support, SparseSupport):
        if support.perm is not None:
            x = x.index_select(-2, support.perm)
        if support.dia is not None:
            out = dia_matmul(support.dia, support.dia_t, x)
        else:
            out = spmm(support.bcsr, support.bcsr_t, x)
        if support.coo is not None:
            out = out + coo_matmul(support.coo, support.coo_t, x)
        if support.inv_perm is not None:
            out = out.index_select(-2, support.inv_perm)
        return out
    support, x = promoted(support, x)
    if x.dim() > 3:
        # one (N, N) @ (N, prod(...) * C) product, as `jnp.einsum` folds
        # it: `torch.matmul` would broadcast the support over the
        # leading dims (B * T copies of (N, N) at GWN's 16,384 nodes)
        return torch.einsum("nm,...mc->...nc", support, x)
    return torch.matmul(support, x)


def refuse_promoting_dense_support(model: str, supports,
                                   x: torch.Tensor) -> None:
    """Raise the JAX package's TypeError for a recurrent predictor whose
    input `x` would be promoted by a dense support (a bf16 x on an f32
    support): its state would change dtype between steps, which the JAX
    package's scan carry refuses (ROADMAP.md Queue 3, item 6)."""
    for s in supports:
        if (isinstance(s, torch.Tensor)
                and torch.promote_types(s.dtype, x.dtype) != x.dtype):
            raise TypeError(
                f"{model} on a dense {s.dtype} support with a {x.dtype} "
                "input: the dense product promotes to the support's "
                "dtype, so the recurrent state would change dtype between "
                "steps. The JAX package raises a TypeError here too (its "
                "scan carry); see ROADMAP.md Queue 3, item 6. Use "
                "compute_dtype=float32, or a sparse support (above 4096 "
                "nodes) for bfloat16.")


def cheb_conv(x: torch.Tensor, cheb_stack: torch.Tensor,
              theta: torch.Tensor, bias: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Chebyshev spatial convolution with a precomputed polynomial stack
    (the JAX package's `cheb_conv`, STGCN's SpatioConvLayer).

    x: (B, T, N, Ci); cheb_stack: (K, N, N); theta: (Ci, Co, K); bias:
    (Co,) or None. Returns (B, T, N, Co). Two dense products, each in
    the promoted dtype of its operands, as `jnp.einsum` computes them:
    a bf16 x on the f32 stack gives f32."""
    cheb_stack, x = promoted(cheb_stack, x)
    xc = torch.einsum("knm,btmi->btkni", cheb_stack, x)
    theta, xc = promoted(theta, xc)
    out = torch.einsum("iok,btkni->btno", theta, xc)
    return out if bias is None else out + bias


def _project(hs, weight: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """The channel concatenation of `hs` times `weight` (+ `bias`), read
    on the shards' device, in the promoted dtype."""
    h, w = promoted(torch.cat(hs, dim=-1), weight.to(hs[0].device))
    out = h @ w
    return out if bias is None else out + bias.to(out.device)


def diffusion_conv(x, supports, weight: torch.Tensor,
                   bias: torch.Tensor | None = None, order: int = 2,
                   include_self: bool = True):
    """GWN's diffusion convolution (`model/GWN/GWN.py:77-98`): [x, A1 x,
    A1^2 x, ..., Ak x, Ak^2 x, ...] along channels, then one projection.
    x: (..., N, Ci); each support dense, `SparseSupport` (or its `.T`)
    or sharded, through `graph_matmul`; weight:
    ((1 + order * len(supports)) * Ci, Co). With `NodeRows` supports, x
    and the result are lists of the ranks' node shards (one meeting a
    hop)."""
    if supports and isinstance(supports[0], NodeRows):
        feats = [x] if include_self else []
        for a in supports:
            h = x
            for _ in range(order):
                h = a.matmul(h)
                feats.append(h)
        return [_project(hs, weight, bias) for hs in zip(*feats)]
    feats = [x] if include_self else []
    for a in supports:
        h = x
        for _ in range(order):
            h = graph_matmul(a, h)
            feats.append(h)
    h, weight = promoted(torch.cat(feats, dim=-1), weight)
    out = h @ weight
    return out if bias is None else out + bias


def mixprop(x, adj, weight: torch.Tensor, gdep: int, alpha: float):
    """MTGNN's MixProp (`model/MTGNN/MTGNN.py:57-77`): with A the
    row-normalized (adj + I), h_k = alpha x + (1 - alpha) A h_{k-1};
    every hop concatenated on channels, then projected. x: (..., N, Ci);
    weight: ((gdep + 1) * Ci, Co). With `adj` a `NodeRows` (or its
    `.T`), x and the result are lists of the ranks' node shards."""
    if isinstance(adj, NodeRows):
        a = _mixprop_rows(adj)
        h, outs = x, [x]
        for _ in range(gdep):
            h = [alpha * xg + (1.0 - alpha) * ag
                 for xg, ag in zip(x, a.matmul(h))]
            outs.append(h)
        return [_project(hs, weight) for hs in zip(*outs)]
    a = adj + torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
    a = a / a.sum(dim=1, keepdim=True)
    h = x
    outs = [h]
    for _ in range(gdep):
        h = alpha * x + (1.0 - alpha) * graph_matmul(a, h)
        outs.append(h)
    h, weight = promoted(torch.cat(outs, dim=-1), weight)
    return h @ weight


def adaptive_adj(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """GWN's adaptive adjacency softmax(relu(E1 @ E2)) over rows
    (`GWN.py:238`). e1: (N, r), e2: (r, N); returns (N, N)."""
    e1, e2 = promoted(e1, e2)
    return torch.softmax(torch.relu(e1 @ e2), dim=1)


def mtgnn_graph(v1: torch.Tensor, v2: torch.Tensor, alpha: float,
                k: int) -> torch.Tensor:
    """MTGNN's learned directed graph (`MTGNN.py:149-202`): with
    m_i = tanh(alpha v_i), relu(tanh(alpha (m1 m2^T - m2 m1^T))), each
    row kept where it is at least its k-th largest value (ties and the
    zeros of a row with fewer than k positive entries included, as the
    JAX package's `jax.lax.top_k` threshold keeps them)."""
    m1 = torch.tanh(alpha * v1)
    m2 = torch.tanh(alpha * v2)
    return _mtgnn_rows(m1, m2, m1, m2, alpha, k)


def _mtgnn_rows(r1: torch.Tensor, r2: torch.Tensor, m1: torch.Tensor,
                m2: torch.Tensor, alpha: float, k: int) -> torch.Tensor:
    """`mtgnn_graph`'s rows of the nodes whose rows of m1 and m2 are
    `r1` and `r2`."""
    a = torch.relu(torch.tanh(alpha * (r1 @ m2.T - r2 @ m1.T)))
    if k >= a.shape[1]:
        return a
    kth = torch.topk(a, k, dim=1).values[:, -1:]
    return torch.where(a >= kth, a, 0.0)


# --- dense graphs over a data row's graph ranks ------------------------------

@dataclasses.dataclass(frozen=True)
class NodeRows:
    """A dense (N, N) graph A over a data row's graph ranks: `rows[g]` is
    rank g's rows `shards.node_range(g)` of A, (n_g, N) on its device;
    `transposed` marks Aᵀ."""

    rows: tuple
    shards: NodeShards
    transposed: bool = False

    @staticmethod
    def of(a: torch.Tensor, shards: NodeShards) -> "NodeRows":
        """The ranks' rows of a whole (N, N) tensor."""
        return NodeRows(tuple(shards.split(a, dim=0)), shards)

    @property
    def T(self) -> "NodeRows":
        return dataclasses.replace(self, transposed=not self.transposed)

    def matmul(self, xs: list) -> list:
        """The ranks' shards of A @ x (or Aᵀ @ x), x (..., N, C) as the
        ranks' shards `xs`. A @ x: each rank's rows times the
        all-gathered x. Aᵀ @ x: each rank's partial product over its
        nodes, (..., N, C) in at least f32, reduce-scattered, so the rows never
        move. In the promoted dtype of A and x, as `graph_matmul`."""
        sh = self.shards
        if not self.transposed:
            return [torch.einsum("nm,...mc->...nc", *promoted(a, h))
                    for a, h in zip(self.rows, sh.all_gather(xs))]
        dt = torch.promote_types(self.rows[0].dtype, xs[0].dtype)
        parts = [torch.einsum("vw,...vc->...wc", widened(a), widened(h))
                 for a, h in zip(self.rows, xs)]
        return [p.to(dt) for p in sh.reduce_scatter(parts)]


def _eye_rows(shards: NodeShards, g: int, like: torch.Tensor
              ) -> torch.Tensor:
    """Rank g's rows of the (N, N) identity, as `like`."""
    lo, hi = shards.node_range(g)
    eye = torch.zeros(hi - lo, shards.n, dtype=like.dtype, device=like.device)
    idx = torch.arange(hi - lo, device=like.device)
    eye[idx, idx + lo] = 1
    return eye


def sharded_cheb_conv(xs: list, cheb_stack: torch.Tensor,
                      theta: torch.Tensor, bias: torch.Tensor | None,
                      shards: NodeShards) -> list:
    """`cheb_conv` on the ranks' node shards: rank g's rows of the
    (K, N, N) stack (a constant, read where it lies) times the
    all-gathered x."""
    return [cheb_conv(x, c, theta.to(x.device),
                      None if bias is None else bias.to(x.device))
            for x, c in zip(shards.all_gather(xs),
                            shards.split(cheb_stack, dim=1))]


def adaptive_rows(e1: torch.Tensor, e2: torch.Tensor,
                  shards: NodeShards) -> NodeRows:
    """`adaptive_adj` as `NodeRows`: rank g's rows of E1 and the whole
    E2 give its rows of the row softmax, with no meeting."""
    return NodeRows(tuple(
        adaptive_adj(r, e2.to(r.device))
        for r in shards.split(e1, dim=0)), shards)


def mtgnn_graph_rows(v1: list, v2: list, alpha: float, k: int,
                     shards: NodeShards) -> NodeRows:
    """`mtgnn_graph` as `NodeRows`, from the ranks' rows of v1 and v2:
    m1 and m2 ((N, node_dim) each, small) all-gathered, rank g's rows
    against them with the one-device contraction, each row's top k its
    own."""
    m1 = [torch.tanh(alpha * v) for v in v1]
    m2 = [torch.tanh(alpha * v) for v in v2]
    return NodeRows(tuple(
        _mtgnn_rows(r1, r2, a1, a2, alpha, k) for r1, r2, a1, a2 in zip(
            m1, m2, shards.all_gather(m1), shards.all_gather(m2))), shards)


def _mixprop_rows(adj: NodeRows) -> NodeRows:
    """MixProp's row-normalized (A + I) as `NodeRows`: of
    A from its rows' own sums; of Aᵀ from A's column sums, summed over
    the ranks, (A + I) / (colsum + 1) by columns, still transposed."""
    sh = adj.shards
    plus = [a + _eye_rows(sh, g, a) for g, a in enumerate(adj.rows)]
    if not adj.transposed:
        return NodeRows(tuple(a / a.sum(dim=1, keepdim=True) for a in plus),
                        sh)
    deg = sh.all_sum([a.sum(dim=0) for a in adj.rows])
    return NodeRows(tuple(a / (d + 1.0) for a, d in zip(plus, deg)), sh,
                    transposed=True)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshRows:
    """A constant dense graph operand of a node-sharded predictor, cut
    once, at build, into the rows its graph ranks read: for the graph
    ranks of each data row of a mesh (once per distinct set of ranks),
    rank g's rows on its device. No device keeps the whole operand (on
    CPU ranks the rows may be views of the host tensor)."""

    by_ranks: dict            # tuple of the ranks' devices -> their rows

    @staticmethod
    def cut(a: torch.Tensor, mesh, n: int, rows=None) -> "MeshRows":
        """`a` cut on the graph ranks of `mesh`'s data rows for an
        n-node model: `rows(a, shards)` gives the ranks' rows, by default
        `shards.split(a, dim=-2)` (a stack of (N, N) graphs by its rows).
        Build `a` on the host: each rank's rows are copied to its
        device."""
        from gptst_tpu_torch.parallel.mesh import node_shards

        by: dict = {}
        for row in range(mesh.local_rows):
            sh = node_shards(mesh, n, row, mesh.row_devices[row])
            if sh.devices not in by:
                by[sh.devices] = tuple(sh.split(a, dim=-2) if rows is None
                                       else rows(a, sh))
        return MeshRows(by)

    def of(self, shards: NodeShards) -> tuple:
        """The rows of the calling data row's graph ranks."""
        return self.by_ranks[tuple(shards.devices)]


def strided_rows(a: torch.Tensor, shards: NodeShards,
                 steps: int) -> list:
    """The ranks' rows of an (S N, S N) graph whose row s N + v is node v
    at window step s (STSGCN's synchronous graph, STFGNN's fusion
    graph): rank g's rows {s N + v : s < S, v in node_range(g)}, step
    by step, as `window_stack` lays out rank g's (B, T, N / G, C) shard,
    with the columns in the order of the ranks' window stacks
    all-gathered (rank, then step, then node), on rank g's device. Rank
    g's rows times the gathered windows are then its rows of the whole
    product, with no permutation per step."""
    n, parts = shards.n, shards.parts
    n_loc = n // parts
    node = torch.arange(n_loc, device=a.device)
    step = torch.arange(steps, device=a.device)[:, None] * n
    cols = (step[None] + n_loc * torch.arange(parts, device=a.device)[
        :, None, None] + node).reshape(-1)
    return [a.index_select(0, (step + lo + node).reshape(-1))
            .index_select(1, cols).to(dev)
            for dev, (lo, _) in zip(
                shards.devices, map(shards.node_range, range(parts)))]
