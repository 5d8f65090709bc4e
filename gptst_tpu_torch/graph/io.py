"""Real graph-artifact ingestion.

Counterpart of `lib/predifineGraph.py:6-74`: edge-list / dense-matrix
CSV adjacency readers and the METR-LA `adj_mx.pkl` pickle. The
per-model prefab loaders come with their predictors. All readers are
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

