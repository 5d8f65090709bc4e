"""Real graph-artifact ingestion.

Counterpart of `lib/predifineGraph.py:6-74`: edge-list / dense-matrix
CSV adjacency readers, the METR-LA `adj_mx.pkl` pickle, the gaussian
weight matrix of a distance CSV, and the prefab graphs that STGODE,
STFGNN and STMGCN read when the reference's files are under the data
root (`load_stgode_prefabs`, `load_stfgnn_fusion_prefab`,
`load_stmgcn_prefabs`). All readers are
host-side numpy; `resolve_adjacency` implements the per-dataset
dispatch every reference `args.py` repeats (METR_LA -> pkl,
NYC_* -> dense CSV, else -> edge-list CSV) with a synthetic fallback
when no data root is available.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np


def read_edge_csv(path: str, num_nodes: int,
                  id_filename: str | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Edge-list CSV "from,to,cost" (header skipped) -> (A01, dist).

    Matches `lib/predifineGraph.py:6-62`: A is 0/1 directed, `dist`
    carries the costs; with `id_filename`, raw sensor ids are remapped
    to 0-based indices.
    """
    a = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    dist = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    id_map = None
    if id_filename:
        with open(id_filename) as f:
            id_map = {int(i): idx
                      for idx, i in enumerate(f.read().strip().split("\n"))}
    with open(path) as f:
        f.readline()
        for row in csv.reader(f):
            if len(row) != 3:
                continue
            i, j, d = int(row[0]), int(row[1]), float(row[2])
            if id_map is not None:
                i, j = id_map[i], id_map[j]
            a[i, j] = 1.0
            dist[i, j] = d
    return a, dist


def read_matrix_csv(path: str) -> np.ndarray:
    """Dense adjacency CSV with no header (NYC_*.csv, dis/pcc_*.csv)."""
    return np.loadtxt(path, delimiter=",").astype(np.float32)


def load_adj_pickle(path: str) -> np.ndarray:
    """METR-LA `adj_mx.pkl` -> (N, N) adjacency
    (`lib/predifineGraph.py:64-74`; payload is
    (sensor_ids, sensor_id_to_ind, adj_mx))."""
    try:
        with open(path, "rb") as f:
            data = pickle.load(f)
    except UnicodeDecodeError:
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    if isinstance(data, (tuple, list)):
        data = data[-1]
    return np.asarray(data, dtype=np.float32)


def weight_matrix_csv(path: str, sigma2: float = 0.1,
                      epsilon: float = 0.5,
                      scaling: bool = True) -> np.ndarray:
    """STGCN-IJCAI18 gaussian-kernel weighted adjacency from a distance
    CSV (`lib/predifineGraph.py:103-131`)."""
    w = read_matrix_csv(path)
    if set(np.unique(w).tolist()) == {0.0, 1.0}:
        return w
    if not scaling:
        return w
    n = w.shape[0]
    w = w / 10000.0
    w2 = w * w
    mask = np.ones((n, n), dtype=np.float32) - np.identity(n,
                                                           dtype=np.float32)
    k = np.exp(-w2 / sigma2)
    return (k * (k >= epsilon) * mask).astype(np.float32)


def resolve_adjacency(data_root: str, dataset: str,
                      num_nodes: int) -> np.ndarray | None:
    """Per-dataset adjacency dispatch shared by every reference
    `args.py` (e.g. `model/STGCN/args.py:78-86`): METR_LA ->
    `adj_mx.pkl`; NYC_* -> dense `<ds>.csv`; else -> edge-list
    `<ds>.csv`. Returns None when the files are absent.
    """
    d = os.path.join(data_root, dataset)
    if dataset == "METR_LA":
        p = os.path.join(d, "adj_mx.pkl")
        return load_adj_pickle(p) if os.path.exists(p) else None
    p = os.path.join(d, dataset + ".csv")
    if not os.path.exists(p):
        return None
    if dataset in ("NYC_BIKE", "NYC_TAXI"):
        return read_matrix_csv(p)
    return read_edge_csv(p, num_nodes)[0]


# --- STGODE prefab distance artifacts (`model/STGODE/args.py:57-125`) -------

def stgode_semantic_graph(dtw_distance: np.ndarray, sigma1: float = 0.1,
                          thres1: float = 0.6) -> np.ndarray:
    """0/1 semantic graph from a DTW distance matrix: z-score ->
    gaussian kernel -> threshold (`args.py:59-65`)."""
    z = (dtw_distance - dtw_distance.mean()) / max(dtw_distance.std(), 1e-12)
    k = np.exp(-(z ** 2) / sigma1 ** 2)
    return (k > thres1).astype(np.float32)


def stgode_spatial_graph(spatial_distance: np.ndarray, sigma2: float = 10.0,
                         thres2: float = 0.5) -> np.ndarray:
    """Continuous spatial graph: z-score over finite entries ->
    gaussian kernel, zero below threshold (`args.py:118-125`)."""
    d = spatial_distance.astype(np.float64)
    finite = np.isfinite(d)
    mean = d[finite].mean()
    std = max(d[finite].std(), 1e-12)
    z = (d - mean) / std
    k = np.exp(-(z ** 2) / sigma2 ** 2)
    k[~np.isfinite(k)] = 0.0
    k[k < thres2] = 0.0
    return k.astype(np.float32)


def load_stgode_prefabs(data_root: str, dataset: str
                        ) -> tuple[np.ndarray, np.ndarray] | None:
    """Shipped `data/STGODE/<ds>/<ds>_{dtw,spatial}_distance.npy` ->
    (semantic 0/1 graph, spatial continuous graph)."""
    d = os.path.join(data_root, "STGODE", dataset)
    p_dtw = os.path.join(d, f"{dataset}_dtw_distance.npy")
    p_sp = os.path.join(d, f"{dataset}_spatial_distance.npy")
    if not (os.path.exists(p_dtw) and os.path.exists(p_sp)):
        return None
    return (stgode_semantic_graph(np.load(p_dtw)),
            stgode_spatial_graph(np.load(p_sp)))


def load_stfgnn_fusion_prefab(data_root: str,
                              dataset: str) -> np.ndarray | None:
    """Shipped `data/STFGNN/<ds>/<ds>_adj_mx.npy` — note this cache is
    the FINAL (strides*N x strides*N) fusion adjacency
    (`construct_adj_fusion` output, `model/STFGNN/args.py:196-207`),
    not the N x N DTW graph."""
    p = os.path.join(data_root, "STFGNN", dataset, f"{dataset}_adj_mx.npy")
    return np.load(p).astype(np.float32) if os.path.exists(p) else None


def load_stmgcn_prefabs(data_root: str, dataset: str
                        ) -> tuple[np.ndarray, np.ndarray] | None:
    """Shipped `data/STMGCN_demand/{dis,pcc}_{bb,tt}.csv` ->
    (distance graph, pearson graph); bb = NYC_BIKE, tt = NYC_TAXI
    (`model/STMGCN_demand/args.py:43-53`)."""
    suffix = {"NYC_BIKE": "bb", "NYC_TAXI": "tt"}.get(dataset)
    if suffix is None:
        return None
    d = os.path.join(data_root, "STMGCN_demand")
    p_dis = os.path.join(d, f"dis_{suffix}.csv")
    p_pcc = os.path.join(d, f"pcc_{suffix}.csv")
    if not (os.path.exists(p_dis) and os.path.exists(p_pcc)):
        return None
    return read_matrix_csv(p_dis), read_matrix_csv(p_pcc)
