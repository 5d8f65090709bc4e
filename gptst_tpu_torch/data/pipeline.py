"""End-to-end data pipeline.

Replaces `lib/dataloader.py:get_dataloader` with a pure-numpy
preparation stage and a lightweight shuffled batch iterator. Steps
(mirroring the reference order, `lib/dataloader.py:101-159`):

  1. load raw series (real `.npz` if present, synthetic otherwise)
  2. append day/week calendar channels
  3. chronological split (by ratio or by days)
  4. sliding-window into (X, Y) pairs per split
  5. fit per-channel-group std scalers on the *train split* only
  6. transform every split channel-wise

The prepared arrays stay in host memory as numpy; batches are converted
to device arrays by the trainer (one H2D per batch — on TPU the whole
split would not fit HBM for large graphs, and this overlaps with
compute via async dispatch).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.config.datasets import get_dataset_spec
from gptst_tpu_torch.data.scalers import StandardScaler, fit_channel_scalers
from gptst_tpu_torch.data.synthetic import synthesize_raw_series
from gptst_tpu_torch.data.timefeat import attach_time_channels
from gptst_tpu_torch.data.window import add_window_horizon

# Candidate locations for real dataset archives, relative to a data root.
_NPZ_NAMES = {
    "PEMS08": "PEMS08/PEMS08.npz",
    "METR_LA": "METR_LA/metr_la.npz",
    "NYC_BIKE": "NYC_BIKE/NYC_BIKE.npz",
    "NYC_TAXI": "NYC_TAXI/NYC_TAXI.npz",
}


def load_raw_series(dataset: str, data_root: str | None = None,
                    num_steps: int | None = None, seed: int = 0) -> np.ndarray:
    """Load raw (T, N, D_base) data; fall back to the synthetic generator.

    Real-file handling mirrors `lib/load_dataset.py`: PEMS08 keeps only
    channel 0 (flow); NYC sets keep 2 channels (pick/drop).
    """
    spec = get_dataset_spec(dataset)
    roots = [data_root] if data_root else []
    roots += [os.environ.get("GPTST_DATA_ROOT", ""), "./data", "../data"]
    for root in roots:
        if not root:
            continue
        path = os.path.join(root, _NPZ_NAMES[dataset])
        if os.path.exists(path):
            data = np.load(path)["data"]
            if dataset == "PEMS08":
                data = data[:, :, 0]
            if data.ndim == 2:
                data = data[..., None]
            return data[..., :spec.input_base_dim].astype(np.float32)
    return synthesize_raw_series(spec, num_steps=num_steps, seed=seed)


def split_by_ratio(data: np.ndarray, val_ratio: float, test_ratio: float):
    """Chronological split, `lib/dataloader.py:85-90` semantics."""
    n = data.shape[0]
    n_test = int(n * test_ratio)
    n_val_end = int(n * (test_ratio + val_ratio))
    test = data[-n_test:]
    val = data[-n_val_end:-n_test]
    train = data[:-n_val_end]
    return train, val, test


def split_by_days(data: np.ndarray, val_days: float, test_days: float,
                  interval: int):
    """`lib/dataloader.py:71-83` semantics (test_ratio > 1 ⇒ days)."""
    T = int(24 * 60 / interval)
    vd, td = int(val_days), int(test_days)
    test = data[-T * td:]
    val = data[-T * (td + vd):-T * td]
    train = data[:-T * (td + vd)]
    return train, val, test


@dataclasses.dataclass
class STDataset:
    """Prepared splits + scalers. All arrays are float32 numpy."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    scaler_data: StandardScaler
    scaler_day: StandardScaler
    scaler_week: StandardScaler

    @property
    def scaler_zeros(self) -> float:
        # transform(0) — the fill value for masked inputs (`Run.py:67`).
        return self.scaler_data.transform(0.0)

    def batches(self, split: str, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_last: bool = False,
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        x = getattr(self, f"x_{split}")
        y = getattr(self, f"y_{split}")
        n = x.shape[0]
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        stop = (n // batch_size) * batch_size if drop_last else n
        for s in range(0, stop, batch_size):
            sel = idx[s:s + batch_size]
            yield x[sel], y[sel]

    def num_batches(self, split: str, batch_size: int,
                    drop_last: bool = False) -> int:
        n = getattr(self, f"x_{split}").shape[0]
        return n // batch_size if drop_last else -(-n // batch_size)


def _transform_splitwise(x: np.ndarray, base_dim: int,
                         s_data, s_day, s_week) -> np.ndarray:
    return np.concatenate(
        [
            s_data.transform(x[..., :base_dim]),
            s_day.transform(x[..., base_dim:base_dim + 1]),
            s_week.transform(x[..., base_dim + 1:base_dim + 2]),
        ],
        axis=-1,
    ).astype(np.float32)


def build_dataset(cfg: FrameworkConfig, data_root: str | None = None,
                  num_steps: int | None = None, seed: int = 0) -> STDataset:
    spec = get_dataset_spec(cfg.dataset)
    raw = load_raw_series(cfg.dataset, data_root, num_steps, seed)
    if raw.shape[1] != cfg.num_nodes:
        if raw.shape[1] > cfg.num_nodes:
            # cfg is the source of truth for model sizing; a smaller
            # num_nodes (tests, smokes) takes a node subset.
            raw = raw[:, : cfg.num_nodes]
        else:
            raise ValueError(
                f"dataset has {raw.shape[1]} nodes < cfg.num_nodes="
                f"{cfg.num_nodes}")
    data = attach_time_channels(raw, spec.week_start, spec.interval)

    if cfg.test_ratio > 1:
        train, val, test = split_by_days(
            data, cfg.val_ratio, cfg.test_ratio, spec.interval)
    else:
        train, val, test = split_by_ratio(data, cfg.val_ratio, cfg.test_ratio)

    x_tra, y_tra = add_window_horizon(train, cfg.lag, cfg.horizon)
    x_val, y_val = add_window_horizon(val, cfg.lag, cfg.horizon)
    x_test, y_test = add_window_horizon(test, cfg.lag, cfg.horizon)

    if cfg.column_wise and cfg.mode in ("pretrain", "eval"):
        # column-wise stats make scaler_zeros an (N, C) array; the mask
        # fill (`GPTST.py:416-417`) and the reference's own pretrain
        # configs assume a scalar — reject loudly instead of diverging
        raise ValueError("column_wise normalization is not supported in "
                         "pretrain/eval modes (scaler_zeros must be "
                         "scalar)")
    s_data, s_day, s_week = fit_channel_scalers(
        train, cfg.input_base_dim, cfg.normalizer, cfg.column_wise)

    b = cfg.input_base_dim
    return STDataset(
        x_train=_transform_splitwise(x_tra, b, s_data, s_day, s_week),
        y_train=_transform_splitwise(y_tra, b, s_data, s_day, s_week),
        x_val=_transform_splitwise(x_val, b, s_data, s_day, s_week),
        y_val=_transform_splitwise(y_val, b, s_data, s_day, s_week),
        x_test=_transform_splitwise(x_test, b, s_data, s_day, s_week),
        y_test=_transform_splitwise(y_test, b, s_data, s_day, s_week),
        scaler_data=s_data, scaler_day=s_day, scaler_week=s_week,
    )
