"""Graph artifact construction.

Pure-numpy (host-side, cacheable) graph preprocessing: adjacency
loading/synthesis, Laplacians, Chebyshev polynomial stacks, and the
normalizations used across the predictor zoo. Equivalent coverage to
`lib/predifineGraph.py` and the per-model `args.py` graph builders, but
vectorized (the reference normalizes Laplacians with O(N^2) python
loops, e.g. `model/STGCN/args.py:7-26`).

All functions return dense float32 arrays: reference graphs are tiny
(N <= 266), where a dense N x N matmul is the support. The
block-sparse layout for large graphs lives in `kernels/spmm.py`.
"""

from __future__ import annotations

import numpy as np


def sym_norm_laplacian(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (D - A) D^-1/2 with zero-degree rows left unscaled.

    Matches the loop at `model/STGCN/args.py:7-26` (entries i,j are
    scaled only when both degrees are positive). Reference quirk kept:
    the diagonal is OVERWRITTEN with the degree (`L = -W;
    L[diag] = d`), so self-loop weights do not subtract from it —
    visible on graphs with self loops (e.g. sym_adj outputs).
    """
    d = adj.sum(axis=1)
    lap = -adj.astype(np.float64, copy=True)
    np.fill_diagonal(lap, d)
    pos = d > 0
    scale = np.zeros_like(d)
    scale[pos] = 1.0 / np.sqrt(d[pos])
    outer_pos = np.outer(pos, pos)
    lap = np.where(outer_pos, lap * np.outer(scale, scale), lap)
    lap[np.isinf(lap)] = 0.0
    lap[np.isnan(lap)] = 0.0
    return lap


def scaled_laplacian(adj: np.ndarray) -> np.ndarray:
    """2 L / lambda_max - I (Chebyshev rescaling), `STGCN/args.py:7-26`."""
    lap = sym_norm_laplacian(adj)
    lam = np.linalg.eigvals(lap).max().real
    return (2.0 * lap / lam - np.eye(adj.shape[0])).astype(np.float32)


def cheb_poly_stack(lap: np.ndarray, k: int) -> np.ndarray:
    """Stack [T_0(L), ..., T_{k-1}(L)], shape (k, N, N).

    `model/STGCN/args.py:28-49` recurrence T_n = 2 L T_{n-1} - T_{n-2}.
    """
    n = lap.shape[0]
    if k < 1:
        raise ValueError("cheb_poly_stack: k must be >= 1")
    mats = [np.eye(n, dtype=np.float64)]
    if k > 1:
        mats.append(lap.astype(np.float64).copy())
    for _ in range(k - 2):
        mats.append(2.0 * lap @ mats[-1] - mats[-2])
    return np.stack(mats, axis=0).astype(np.float32)


def sym_adj(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 — GWN 'normlap'-family (`GWN/GWN.py:10-24`)."""
    a = adj + np.eye(adj.shape[0], dtype=adj.dtype)
    d = a.sum(axis=1)
    d_inv_sqrt = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-12)), 0.0)
    return (a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]).astype(np.float32)


def asym_adj(adj: np.ndarray) -> np.ndarray:
    """Row-normalized D^-1 A — random-walk transition (`GWN/GWN.py:26-33`)."""
    rowsum = adj.sum(axis=1)
    d_inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    return (d_inv[:, None] * adj).astype(np.float32)


def normalized_adj_wave(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 with degree clamping (`lib/predifineGraph.py:152-163`)."""
    a = adj + np.eye(adj.shape[0], dtype=np.float32)
    d = np.maximum(a.sum(axis=1), 1e-4)
    diag = 1.0 / np.sqrt(d)
    return (diag[:, None] * a * diag[None, :]).astype(np.float32)


def gaussian_weight_matrix(dist: np.ndarray, sigma2: float = 0.1,
                           epsilon: float = 0.5) -> np.ndarray:
    """STGCN-style thresholded Gaussian kernel of a distance matrix
    (`lib/predifineGraph.py:103-131`, Eq.10 of STGCN/IJCAI-18)."""
    n = dist.shape[0]
    w = dist / 10000.0
    w2 = w * w
    mask = np.ones((n, n), dtype=np.float32) - np.eye(n, dtype=np.float32)
    g = np.exp(-w2 / sigma2)
    return (g * (g >= epsilon) * mask).astype(np.float32)


def random_sensor_graph(num_nodes: int, avg_degree: int = 6,
                        seed: int = 0, directed: bool = False) -> np.ndarray:
    """Synthetic sparse sensor graph (0/1 adjacency, no self loops).

    Used when the real distance CSVs are absent: a ring backbone (so the
    graph is connected) plus random chords, mirroring the sparsity of
    PEMS-style road graphs.
    """
    rng = np.random.default_rng(seed)
    a = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    ring = np.arange(num_nodes)
    a[ring, (ring + 1) % num_nodes] = 1.0
    extra = max(0, num_nodes * avg_degree // 2 - num_nodes)
    src = rng.integers(0, num_nodes, size=extra)
    dst = rng.integers(0, num_nodes, size=extra)
    keep = src != dst
    a[src[keep], dst[keep]] = 1.0
    if not directed:
        a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return a


def svd_rbf_support(series: np.ndarray, hidden_size: int = 20) -> np.ndarray:
    """CCRNN data-driven support (`model/CCRNN_demand/args.py:40-76`).

    series: (T, N, D) training-period data. SVD-compress to (N, h) node
    factors w = (diag(s_h) V_h)^T, RBF of pairwise euclidean distances
    exp(-d / std(d)^2), remove self loops, random-walk normalize.
    """
    t, n, d = series.shape
    flat = np.moveaxis(series, 2, 1).reshape(t * d, n)
    _, s, v = np.linalg.svd(flat, full_matrices=False)
    h = min(hidden_size, s.shape[0])
    w = (np.diag(s[:h]) @ v[:h]).T                         # (N, h)
    diff = w[:, None, :] - w[None, :, :]
    dist = np.sqrt((diff * diff).sum(-1))
    sup = np.exp(-dist / max(np.std(dist), 1e-8) ** 2)
    sup = sup - np.eye(n)
    return asym_adj(sup)


def pearson_graph(series: np.ndarray) -> np.ndarray:
    """Node-wise Pearson correlation graph (STMGCN's `pcc` input,
    `model/STMGCN_demand/args.py`). series: (T, N, D); negative
    correlations clipped to 0, self loops removed."""
    t, n, d = series.shape
    flat = series.reshape(t, n * d) if d == 1 else series.mean(-1)
    flat = flat.reshape(t, n)
    c = np.corrcoef(flat.T)
    c = np.nan_to_num(c)
    np.fill_diagonal(c, 0.0)
    return np.maximum(c, 0.0).astype(np.float32)


def cheb_poly_stack_rescaled(adj: np.ndarray, k: int) -> np.ndarray:
    """STMGCN chebyshev kernel stack (K+1 terms) of the rescaled
    symmetric laplacian (`model/STMGCN_demand/GCN.py:61-140`)."""
    d = adj.sum(axis=1)
    d_inv_sqrt = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-12)), 0.0)
    a_norm = adj * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    lap = np.eye(adj.shape[0]) - a_norm
    try:
        lam = float(np.max(np.linalg.eigvals(lap).real))
    except np.linalg.LinAlgError:
        lam = 2.0
    lap = (2.0 / lam) * lap - np.eye(adj.shape[0])
    return np.nan_to_num(cheb_poly_stack(lap, k + 1)).astype(np.float32)


def dense_to_edges(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row, col, weight) COO triplets of nonzero entries, row-major."""
    rows, cols = np.nonzero(adj)
    return rows.astype(np.int32), cols.astype(np.int32), adj[rows, cols].astype(np.float32)
