"""Bandwidth-reducing node ordering for the sparse aggregation path.

Reverse Cuthill-McKee clusters nonzeros near the diagonal, so tiling
the adjacency into (TB x TB) blocks touches far fewer blocks
(`ops/graph_conv.make_support_coo` keeps the ordering only when it
pays). Host-side numpy, identical to the JAX package's traversal; the
graph-partition layouts for sharded aggregation come with the parallel
slice.
"""

from __future__ import annotations

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
