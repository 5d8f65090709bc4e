"""Bandwidth-reducing node ordering for the sparse aggregation path.

Reverse Cuthill-McKee clusters nonzeros near the diagonal, so tiling
the adjacency into (TB x TB) blocks touches far fewer blocks
(`ops/graph_conv.make_support_coo` keeps the ordering only when it
pays). Host-side numpy, identical to the JAX package's traversal.

The partition layouts of node-sharded aggregation (`parallel/halo.py`)
are here too: P contiguous node-range shards, each with its rows of the
adjacency and its halo, the non-local source nodes those rows read.
Numpy copies of the JAX package's functions; the tests hold the arrays
equal.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


def rcm_order(adj: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering (pure numpy BFS).

    Returns `perm` such that `adj[perm][:, perm]` has small bandwidth.
    """
    rows, cols = np.nonzero(adj)
    return rcm_order_coo(rows, cols, adj.shape[0])


def rcm_order_coo(rows: np.ndarray, cols: np.ndarray,
                  n: int) -> np.ndarray:
    """RCM from an edge list, without a dense (N, N) pattern:
    min-degree start per component, neighbors visited in stable degree
    order."""
    r = np.concatenate([rows, cols]).astype(np.int64)
    c = np.concatenate([cols, rows]).astype(np.int64)
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    r, c = key // n, key % n
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    degree = np.diff(ptr)
    visited = np.zeros(n, dtype=bool)
    # component starts: a cursor over the degree-sorted node order (the
    # stable sort keeps the smallest index among minimum-degree nodes)
    by_degree = np.argsort(degree, kind="stable")
    cursor = 0
    order: list[int] = []
    while len(order) < n:
        while visited[by_degree[cursor]]:
            cursor += 1
        start = int(by_degree[cursor])
        visited[start] = True
        queue = deque([start])
        while queue:
            u = queue.popleft()
            order.append(u)
            nbrs = c[ptr[u]:ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(int(v) for v in nbrs)
    return np.asarray(order[::-1], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """P contiguous node-range shards of a (possibly reordered) graph.

    All index arrays refer to *permuted* node ids; `perm` maps permuted
    position -> original node id (`inv_perm` the other way). Features
    must be permuted once at ingestion: `x_perm = x[..., perm, :]`.
    """

    perm: np.ndarray          # (n,) permuted position -> original id
    inv_perm: np.ndarray      # (n,) original id -> permuted position
    parts: int
    n: int                    # logical node count
    n_loc: int                # padded nodes per shard (n_pad = P * n_loc)
    # per-shard halo: permuted ids of non-local source nodes each
    # shard's rows read, padded to the max halo size with self-indices
    halo_idx: np.ndarray      # (P, halo_max) int32, global permuted ids
    halo_size: np.ndarray     # (P,) int32 true halo sizes
    # per-shard rows of the permuted+padded adjacency, columns reordered
    # to [local block | gathered halo block] so the local SpMM is dense
    # over n_loc + halo_max columns
    local_adj: np.ndarray     # (P, n_loc, n_loc + halo_max) float32
    # boundary-exchange (all_to_all) layout: shard p sends the local
    # rows `send_idx[p, d, :]` to shard d; after the exchange, shard d
    # reads its halo slot k from flat position `halo_src[d, k]` of the
    # received (P, send_max) buffer. Only boundary nodes move — total
    # traffic is sum(halo_size) rows vs the ring's P*(P-1)*n_loc.
    send_idx: np.ndarray      # (P, P, send_max) int32, local row ids
    halo_src: np.ndarray      # (P, halo_max) int32, flat recv positions

    @property
    def n_pad(self) -> int:
        return self.parts * self.n_loc

    @property
    def halo_max(self) -> int:
        return self.halo_idx.shape[1]

    @property
    def send_max(self) -> int:
        return self.send_idx.shape[2]

    def pad_features(self, x: np.ndarray) -> np.ndarray:
        """Permute the node axis (axis -2) and zero-pad to n_pad."""
        x = np.take(x, self.perm, axis=-2)
        pad = [(0, 0)] * x.ndim
        pad[-2] = (0, self.n_pad - self.n)
        return np.pad(x, pad)

    def unpad_features(self, x: np.ndarray) -> np.ndarray:
        """Drop padding and undo the permutation on axis -2."""
        x = np.take(x, np.arange(self.n), axis=-2)
        return np.take(x, self.inv_perm, axis=-2)


def partition_graph(adj: np.ndarray, parts: int,
                    reorder: bool = True) -> GraphPartition:
    """Split `adj` into P contiguous row shards with halo index sets.

    With `reorder=True` the nodes are RCM-permuted first, shrinking
    both block fill and halo sizes (locality-aware partitioning; the
    contiguous-range split of the reordered graph plays the role of a
    METIS/greedy edge partitioner without the external dependency).
    """
    n = adj.shape[0]
    if reorder:
        perm = rcm_order(adj)
    else:
        perm = np.arange(n, dtype=np.int64)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n)
    a = adj[perm][:, perm].astype(np.float32)

    n_loc = -(-n // parts)
    n_pad = n_loc * parts
    a_pad = np.zeros((n_pad, n_pad), np.float32)
    a_pad[:n, :n] = a

    halo_lists = []
    for p in range(parts):
        lo, hi = p * n_loc, (p + 1) * n_loc
        rows = a_pad[lo:hi]                      # (n_loc, n_pad)
        used = np.flatnonzero(np.any(rows != 0, axis=0))
        halo_lists.append(used[(used < lo) | (used >= hi)])
    halo_size = np.asarray([len(h) for h in halo_lists], np.int32)
    halo_max = max(1, int(halo_size.max()))

    halo_idx = np.zeros((parts, halo_max), np.int32)
    local_adj = np.zeros((parts, n_loc, n_loc + halo_max), np.float32)
    for p in range(parts):
        lo, hi = p * n_loc, (p + 1) * n_loc
        h = halo_lists[p]
        # pad the halo set with local index lo (a gather of an already
        # -local row whose adjacency columns are zero — harmless)
        halo_idx[p, : len(h)] = h
        halo_idx[p, len(h):] = lo
        rows = a_pad[lo:hi]
        local_adj[p, :, :n_loc] = rows[:, lo:hi]
        local_adj[p, :, n_loc: n_loc + len(h)] = rows[:, h]

    send_idx, halo_src = _exchange_layout(halo_lists, parts, n_loc,
                                          halo_max)
    return GraphPartition(
        perm=perm, inv_perm=inv_perm, parts=parts, n=n, n_loc=n_loc,
        halo_idx=halo_idx, halo_size=halo_size, local_adj=local_adj,
        send_idx=send_idx, halo_src=halo_src)


def _exchange_layout(halo_lists, parts: int, n_loc: int, halo_max: int):
    """all_to_all exchange layout: halo ids are sorted ascending, so a
    shard's halo is contiguous runs per owning shard. Shard o sends
    local rows `send_idx[o, d]` to shard d; shard d reads halo slot k
    from flat recv position `halo_src[d, k]`."""
    counts = np.zeros((parts, parts), np.int64)   # [owner, dest]
    for d in range(parts):
        owners = halo_lists[d] // n_loc
        for o, c in zip(*np.unique(owners, return_counts=True)):
            counts[int(o), d] = int(c)
    send_max = max(1, int(counts.max()))
    send_idx = np.zeros((parts, parts, send_max), np.int32)
    halo_src = np.zeros((parts, halo_max), np.int32)
    for d in range(parts):
        h = halo_lists[d]
        owners = h // n_loc
        k = 0
        for o in np.unique(owners):
            ids = h[owners == o]
            send_idx[int(o), d, : len(ids)] = ids - int(o) * n_loc
            halo_src[d, k: k + len(ids)] = (
                int(o) * send_max + np.arange(len(ids)))
            k += len(ids)
    return send_idx, halo_src


def partition_graph_coo(rows: np.ndarray, cols: np.ndarray,
                        vals: np.ndarray, n: int,
                        parts: int) -> GraphPartition:
    """Edge-list variant of `partition_graph` — never materializes the
    dense (N, N) adjacency, so partitions build for graphs far past the
    dense-memory wall (N >= 64k). Nodes are taken in the given order
    (identity permutation): pre-order with `rcm_order` on the pattern
    if the input ordering is scrambled.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    perm = np.arange(n, dtype=np.int64)
    n_loc = -(-n // parts)

    halo_lists = []
    shard_edges = []
    owner = rows // n_loc
    for p in range(parts):
        lo = p * n_loc
        sel = owner == p
        r, c, v = rows[sel] - lo, cols[sel], vals[sel]
        used = np.unique(c)
        h = used[(used < lo) | (used >= lo + n_loc)]
        halo_lists.append(h)
        shard_edges.append((r, c, v))
    halo_size = np.asarray([len(h) for h in halo_lists], np.int32)
    halo_max = max(1, int(halo_size.max()))

    halo_idx = np.zeros((parts, halo_max), np.int32)
    local_adj = np.zeros((parts, n_loc, n_loc + halo_max), np.float32)
    for p in range(parts):
        lo = p * n_loc
        h = halo_lists[p]
        halo_idx[p, : len(h)] = h
        halo_idx[p, len(h):] = lo
        r, c, v = shard_edges[p]
        # map columns: local -> [0, n_loc); halo -> n_loc + rank in h
        is_local = (c >= lo) & (c < lo + n_loc)
        cm = np.where(is_local, c - lo,
                      n_loc + np.searchsorted(h, c))
        np.add.at(local_adj[p], (r, cm), v)

    send_idx, halo_src = _exchange_layout(halo_lists, parts, n_loc,
                                          halo_max)
    return GraphPartition(
        perm=perm, inv_perm=perm.copy(), parts=parts, n=n, n_loc=n_loc,
        halo_idx=halo_idx, halo_size=halo_size, local_adj=local_adj,
        send_idx=send_idx, halo_src=halo_src)


def partition_stats(part: GraphPartition) -> dict:
    """Diagnostics: halo fraction and local-block density per shard."""
    nnz_local = np.count_nonzero(part.local_adj[:, :, : part.n_loc])
    nnz_halo = np.count_nonzero(part.local_adj[:, :, part.n_loc:])
    # feature rows moved per A@x, whole mesh: the halo exchange ships
    # exactly the boundary rows; the ring circulates every shard to
    # every other device
    halo_rows = int(part.halo_size.sum())
    ring_rows = part.parts * (part.parts - 1) * part.n_loc
    return {
        "parts": part.parts,
        "n_loc": part.n_loc,
        "halo_max": part.halo_max,
        "halo_mean": float(part.halo_size.mean()),
        "halo_frac": float(part.halo_size.mean()) / max(part.n_loc, 1),
        "nnz_local": int(nnz_local),
        "nnz_halo": int(nnz_halo),
        "halo_rows_moved": halo_rows,
        "ring_rows_moved": ring_rows,
    }
