"""Banded dynamic-time-warping graph artifacts.

Counterpart of the reference's DTW preprocessing, which runs at config
parse time in per-node-pair Python loops and caches .npy files:
  * STFGNN: banded DTW (Sakoe-Chiba Ts=12) on L1 day-profile distances,
    top-1% per row sparsification (`model/STFGNN/args.py:31-97`);
  * STGODE: fastdtw(radius=6) on daily means, gaussian kernel +
    threshold (`model/STGODE/args.py:44-72`).

A copy of the JAX package's `graph/dtw.py`: one banded-DTW sweep over
ALL node pairs at once, in C++ (`gptst_tpu_torch/native`, float32
series summed in double, OpenMP over pairs) or, where no library could
be built, in numpy over the pair axis (float64 costs). STGODE's fastdtw
is approximated by the same banded DTW with radius 6, as in the JAX
package. Results are cached by `cached_artifact` under file names of
the port's own (`torch_` prefix): the two packages never read each
other's cache.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

_BIG = 1e18


def daily_profiles(data: np.ndarray, steps_per_day: int) -> np.ndarray:
    """Mean daily profile per node: (T, N) -> (N, steps_per_day)
    (`model/STGODE/args.py:45-47`)."""
    days = data.shape[0] // steps_per_day
    trimmed = data[: days * steps_per_day].reshape(
        days, steps_per_day, -1)
    return trimmed.mean(axis=0).T.astype(np.float64)


def banded_dtw_all_pairs(d: np.ndarray, radius: int,
                         order: int = 1) -> np.ndarray:
    """Banded DTW over a stack of pairwise local-cost matrices.

    d: (P, T, T) local costs d[p, i, j]; radius: Sakoe-Chiba band.
    Returns (P,) alignment costs D[p, T-1, T-1] ** (1/order)
    (`model/STFGNN/args.py:30-57`, vectorized over the pair axis).
    """
    p, t, _ = d.shape
    dc = d ** order
    prev = np.full((p, t), _BIG)
    for i in range(t):
        cur = np.full((p, t), _BIG)
        j_lo, j_hi = max(0, i - radius), min(t, i + radius + 1)
        for j in range(j_lo, j_hi):
            c = dc[:, i, j]
            if i == 0 and j == 0:
                cur[:, j] = c
                continue
            best = np.full(p, _BIG)
            if i > 0:
                best = np.minimum(best, prev[:, j])         # insertion
                if j > 0:
                    best = np.minimum(best, prev[:, j - 1])  # match
            if j > 0:
                best = np.minimum(best, cur[:, j - 1])       # deletion
            cur[:, j] = c + best
        prev = cur
    return prev[:, -1] ** (1.0 / order)


def dtw_distance_matrix(series_by_day: np.ndarray, radius: int,
                        order: int = 1, normalize: bool = True) -> np.ndarray:
    """All-pairs banded DTW distances.

    series_by_day: (days, T0, N) — STFGNN's `gen_data` layout
    (`args.py:64-70`); cost d[i,j] = sum_days |a[d,j] - b[d,i]| with
    per-day normalization (`args.py:25-36`). For single-profile inputs
    pass days=1.
    """
    days, t0, n = series_by_day.shape
    x = series_by_day
    if normalize:
        mu = x.mean(axis=1, keepdims=True)
        sd = x.std(axis=1, keepdims=True)
        sd = np.where(sd > 0, sd, 1.0)
        x = (x - mu) / sd
    iu, ju = np.triu_indices(n, k=1)
    dist = np.zeros((n, n))

    # native C++ path (OpenMP over pairs); numpy fallback below
    from gptst_tpu_torch.native import native_banded_dtw_pairs

    costs = native_banded_dtw_pairs(
        x.astype(np.float32), iu.astype(np.int32), ju.astype(np.int32),
        radius, order)
    if costs is not None:
        dist[iu, ju] = costs
        return dist + dist.T
    # chunk pairs to bound the (P, T, T) cost tensor's memory
    chunk = max(1, int(2e8 // (t0 * t0 * 8)))
    for s in range(0, iu.size, chunk):
        ii, jj = iu[s:s + chunk], ju[s:s + chunk]
        # d[p, i, j] = sum_d |x[d, j, a] - x[d, i, b]|  (a=ii, b=jj)
        a = x[:, :, ii]   # (days, T, P)
        b = x[:, :, jj]
        local = np.abs(a[:, None, :, :] - b[:, :, None, :]).sum(axis=0)
        local = np.moveaxis(local, 2, 0)         # (P, T_i, T_j)
        dist[ii, jj] = banded_dtw_all_pairs(local, radius, order)
    return dist + dist.T


def stfgnn_dtw_graph(data: np.ndarray, steps_per_day: int = 288,
                     radius: int = 12, sparsity: float = 0.01) -> np.ndarray:
    """STFGNN temporal graph: banded DTW distances on the train period's
    day-stacked series, keep the `sparsity` nearest per row,
    symmetrize, add self loops (`model/STFGNN/args.py:58-97`)."""
    t, n = data.shape
    days = max(1, t // steps_per_day)
    x = data[: days * steps_per_day].reshape(days, steps_per_day, n)
    dtw = dtw_distance_matrix(x, radius)
    top = max(1, int(n * sparsity))
    w = np.zeros((n, n), dtype=np.float32)
    nearest = np.argsort(dtw, axis=1)[:, :top]
    rows = np.repeat(np.arange(n), top)
    w[rows, nearest.ravel()] = 1.0
    w = np.maximum(w, w.T)        # `if w[i,j] != w[j,i] and w[i,j]==0: 1`
    np.fill_diagonal(w, 1.0)
    return w


def stgode_dtw_graph(data: np.ndarray, steps_per_day: int = 288,
                     radius: int = 6, sigma: float = 0.1,
                     thres: float = 0.6) -> np.ndarray:
    """STGODE semantic graph: DTW on mean daily profiles, z-scored,
    gaussian kernel, binary threshold (`model/STGODE/args.py:44-72`)."""
    prof = daily_profiles(data, steps_per_day)       # (N, T0)
    x = prof.T[None]                                 # (1, T0, N)
    dist = dtw_distance_matrix(x, radius, normalize=False)
    z = (dist - dist.mean()) / max(dist.std(), 1e-8)
    k = np.exp(-(z ** 2) / sigma ** 2)
    return (k > thres).astype(np.float32)


def cached_artifact(cache_dir: str, name: str, key_arrays: list,
                    build_fn) -> np.ndarray:
    """Build-or-load an expensive graph artifact, keyed by input hash
    (the reference caches to `data/STFGNN/<ds>_adj_mx.npy` etc.). The
    file is `torch_<name>_<hash>.npy`: the JAX package writes
    `<name>_<hash>.npy` to the same default directory, and neither reads
    the other's."""
    h = hashlib.sha1()
    for a in key_arrays:
        h.update(np.ascontiguousarray(a).tobytes()[:65536])
    path = os.path.join(cache_dir, f"torch_{name}_{h.hexdigest()[:12]}.npy")
    if os.path.exists(path):
        return np.load(path)
    out = build_fn()
    os.makedirs(cache_dir, exist_ok=True)
    np.save(path, out)
    return out
