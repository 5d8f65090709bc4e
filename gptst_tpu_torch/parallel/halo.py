"""Node-sharded graph aggregation with explicit exchanges.

Nodes are block-partitioned over the mesh's 'graph' axis (P ranks,
`parallel/mesh.py`) and `A @ x` runs shard by shard, in one process:

  * `make_ring_spmm` — the ring collective matmul: P steps, each a
    product of the local adjacency block column that matches the x
    shard a rank holds, then a shift of every shard to the left
    neighbour rank. It moves P*(P-1)*n_loc rows per call.
  * `make_halo_spmm` — the boundary exchange of a `GraphPartition`:
    each rank gathers the rows other shards read, the pieces are
    exchanged (shard o's piece for d moves to d's device, the
    single-process `all_to_all`), and one local dense product runs over
    [local rows ‖ halo rows]. It moves sum(halo_size) rows per call.

The products are `torch.matmul`, as the JAX package leaves them to XLA;
the fused ring kernel (`kernels/halo_spmm.py`) is the hand-written
version of the ring. Both functions take x of shape (..., n_pad, C) on
any device, fold the leading dims into the feature axis, and return the
same shape on x's device; their `on_shards` takes and gives the
ranks' node shards instead, with no gather (a node-sharded model's
static supports, `ops/graph_conv.graph_matmul` on a list). Autograd
runs through them (`.to(device)` and `index_select` carry gradients).
"""

from __future__ import annotations

import numpy as np
import torch

from gptst_tpu_torch.graph.partition import GraphPartition
from gptst_tpu_torch.parallel.mesh import (
    GRAPH_AXIS, Mesh, gather_rows, shard_rows,
)


def _fold_nodes_first(x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """(..., n, c) -> (n, prod(lead)*c) plus restore info."""
    *lead, n, c = x.shape
    flat = x.reshape(-1, n, c).movedim(1, 0).reshape(n, -1)
    return flat, (tuple(lead), c)


def _unfold_nodes(flat: torch.Tensor, info: tuple) -> torch.Tensor:
    lead, c = info
    n = flat.shape[0]
    return flat.reshape(n, -1, c).movedim(0, 1).reshape(*lead, n, c)


def _product_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a product of the f32 adjacency by x: f32 for f32 and
    narrower x (accumulated in f32), float64 for float64 x, as a dense
    support's product promotes (`ops/graph_conv.graph_matmul`)."""
    return torch.promote_types(x.dtype, torch.float32)


def partition_adjacency(adj: np.ndarray, parts: int) -> np.ndarray:
    """Pad N to a multiple of `parts` and return per-destination row
    blocks split by source shard: (parts, n_loc, parts, n_loc)."""
    n = adj.shape[0]
    n_loc = -(-n // parts)
    n_pad = n_loc * parts
    a = np.zeros((n_pad, n_pad), dtype=np.float32)
    a[:n, :n] = adj
    return a.reshape(parts, n_loc, parts, n_loc)


class ShardProduct:
    """A sharded `A @ x` on one data row's graph ranks. Called with x
    (..., n_pad, C) on any device it splits x into the ranks' row
    shards, runs the product and gathers the result on x's device;
    `on_shards` takes the ranks' shards ((..., n_loc, C) each, on its
    rank) and returns the ranks' shards of the product, in x's dtype,
    with no gather: the layout of a node-sharded model
    (`parallel/mesh.NodeShards`), whose ranks hold the contiguous node
    ranges [g n_loc, (g + 1) n_loc) that both products shard by."""

    def __init__(self, mesh: Mesh, row: int, local):
        self.mesh, self.row = mesh, row
        # the ranks' (n_loc, F) shards -> the ranks' (n_loc, F) rows of
        # the product, f32 (float64 for float64 x)
        self._local = local

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xf, info = _fold_nodes_first(x)
        outs = self._local(shard_rows(xf, self.mesh, self.row))
        out = gather_rows(outs, x.device)
        return _unfold_nodes(out.to(x.dtype), info)

    def on_shards(self, xs: list) -> list:
        devs = self.mesh.graph_devices(self.row)
        if [x.device for x in xs] != devs:
            raise ValueError(f"shards on {[x.device for x in xs]}, the "
                             f"product's ranks are {devs}")
        folded = [_fold_nodes_first(x) for x in xs]
        outs = self._local([f for f, _ in folded])
        return [_unfold_nodes(o.to(x.dtype), info)
                for o, x, (_, info) in zip(outs, xs, folded)]


def make_ring_spmm(mesh: Mesh, adj: np.ndarray, row: int = 0):
    """Sharded `A @ x` as a ring over the 'graph' axis of data row
    `row` of the mesh.

    Returns (fn, n_pad): fn (a `ShardProduct`) takes x (..., n_pad, C)
    and returns A_pad @ x_pad with the same shape and dtype, accumulated
    in f32 (float64 for float64 x).
    """
    parts = mesh.shape[GRAPH_AXIS]
    devs = mesh.graph_devices(row)
    blocks = partition_adjacency(adj, parts)
    n_pad = blocks.shape[1] * parts
    a = [torch.as_tensor(blocks[p]).to(devs[p]) for p in range(parts)]

    def local(bufs: list) -> list:
        dt = _product_dtype(bufs[0])
        accs = [None] * parts
        for i in range(parts):
            for p in range(parts):
                # after i shifts rank p holds shard (p + i) mod P
                prod = torch.matmul(a[p][:, (p + i) % parts].to(dt),
                                    bufs[p].to(dt))
                accs[p] = prod if i == 0 else accs[p] + prod
            if i < parts - 1:
                bufs = [bufs[(p + 1) % parts].to(devs[p])
                        for p in range(parts)]
        return accs

    return ShardProduct(mesh, row, local), n_pad


def make_halo_spmm(mesh: Mesh, part: GraphPartition, row: int = 0):
    """Sharded `A @ x` over the boundary-exchange layout of a
    `GraphPartition`, on the 'graph' axis of data row `row` of the mesh.

    Returns (fn, n_pad): fn is a `ShardProduct`. x: (..., n_pad, C) in
    the partition's permuted node order (`part.pad_features` at
    ingestion, or a partition built with `reorder=False`).
    """
    parts = part.parts
    devs = mesh.graph_devices(row)
    if len(devs) != parts:
        raise ValueError(f"partition of {parts} shards on a graph axis of "
                         f"{len(devs)}")
    smax = part.send_max

    def on(p, arr, dtype):
        return torch.as_tensor(np.asarray(arr), dtype=dtype).to(devs[p])

    adj_loc = [on(p, part.local_adj[p], torch.float32) for p in range(parts)]
    send_idx = [on(p, part.send_idx[p].reshape(-1), torch.long)
                for p in range(parts)]
    halo_src = [on(p, part.halo_src[p], torch.long) for p in range(parts)]

    def local(shards: list) -> list:
        f = shards[0].shape[1]
        send = [shards[o].index_select(0, send_idx[o]).view(parts, smax, f)
                for o in range(parts)]
        outs = []
        for d in range(parts):
            recv = torch.cat([send[o][d].to(devs[d]) for o in range(parts)])
            halo = recv.index_select(0, halo_src[d])
            xcat = torch.cat([shards[d], halo])
            dt = _product_dtype(xcat)
            outs.append(torch.matmul(adj_loc[d].to(dt), xcat.to(dt)))
        return outs

    return ShardProduct(mesh, row, local), part.n_pad
