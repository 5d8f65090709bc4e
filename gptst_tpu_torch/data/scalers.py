"""Normalization scalers.

Functional counterparts of `lib/normalization.py`. Each scaler is a
frozen dataclass whose transform/inverse_transform work uniformly on
numpy arrays and torch tensors (pure arithmetic, no device state). Statistics are
always fit on the train split only (`lib/dataloader.py:119`).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NScaler:
    def transform(self, x):
        return x

    def inverse_transform(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class StandardScaler:
    """Scalar stats by default; `column_wise` fitting stores (N, C)
    arrays instead — both broadcast against (..., N, C) data."""

    mean: float
    std: float

    def transform(self, x):
        return (x - self.mean) / self.std

    def inverse_transform(self, x):
        return x * self.std + self.mean


@dataclasses.dataclass(frozen=True)
class MinMax01Scaler:
    min: float
    max: float

    def transform(self, x):
        return (x - self.min) / (self.max - self.min)

    def inverse_transform(self, x):
        return x * (self.max - self.min) + self.min


@dataclasses.dataclass(frozen=True)
class MinMax11Scaler:
    min: float
    max: float

    def transform(self, x):
        return ((x - self.min) / (self.max - self.min)) * 2.0 - 1.0

    def inverse_transform(self, x):
        return ((x + 1.0) / 2.0) * (self.max - self.min) + self.min


@dataclasses.dataclass(frozen=True)
class ColumnMinMaxScaler:
    """Per-column min-max (`lib/normalization.py:65-87`, the 'cmax'
    normalizer option): min/max are arrays over the spatial axis;
    zero-range columns scale by 1."""

    min: np.ndarray
    min_max: np.ndarray

    @classmethod
    def fit(cls, x) -> "ColumnMinMaxScaler":
        lo = np.asarray(x).min(axis=0)
        rng = np.asarray(x).max(axis=0) - lo
        rng = np.where(rng == 0, 1.0, rng)
        return cls(min=lo, min_max=rng)

    def transform(self, x):
        return (x - self.min) / self.min_max

    def inverse_transform(self, x):
        return x * self.min_max + self.min


def fit_standard_scaler(x: np.ndarray) -> StandardScaler:
    std = float(x.std())
    # guard constant channels (e.g. the weekday channel of a series
    # shorter than a week) — the reference would divide by zero here
    return StandardScaler(mean=float(x.mean()), std=std if std > 0 else 1.0)


def fit_scaler(x: np.ndarray, normalizer: str = "std"):
    """One scaler by name (`lib/dataloader.py:8-69`): std | max01 |
    max11 | None."""
    if normalizer == "std":
        return fit_standard_scaler(x)
    if normalizer == "max01":
        return MinMax01Scaler(min=float(x.min()), max=float(x.max()))
    if normalizer == "max11":
        return MinMax11Scaler(min=float(x.min()), max=float(x.max()))
    if normalizer == "cmax":
        return ColumnMinMaxScaler.fit(x)
    if normalizer in ("None", "none", None):
        return NScaler()
    raise ValueError(f"unknown normalizer {normalizer!r}")


def fit_channel_scalers(
    train_data: np.ndarray, input_base_dim: int, normalizer: str = "std",
    column_wise: bool = False,
) -> tuple:
    """Fit separate scalers for (base, day, week) channel groups.

    Matches `lib/dataloader.py:36-54`: the base channels share one
    scalar stat; day and week channels each get their own (always
    std-scaled, as the reference does regardless of `normalizer`).

    `column_wise=True` fits the base-channel stats per (node, channel)
    column over time, mirroring the reference's intent at
    `lib/dataloader.py:30-34` (`mean/std(axis=0, keepdims=True)`). The
    reference's own branch is unrunnable on its shipped data shapes —
    it computes stats over all D channels then transforms only the
    base slice, a broadcast error whenever the calendar channels are
    attached (always, `lib/load_dataset.py:4-40`) — so per-group
    column stats are the working completion of that config surface.
    Day/week channels keep scalar stats in both modes.
    """
    base = train_data[..., :input_base_dim]
    day = train_data[..., input_base_dim:input_base_dim + 1]
    week = train_data[..., input_base_dim + 1:input_base_dim + 2]
    if column_wise and normalizer == "std":
        # stats over time -> (N, C) arrays; zero-variance columns
        # (constant sensors) scale by 1 like fit_standard_scaler
        mean = base.mean(axis=0)
        std = base.std(axis=0)
        s_base = StandardScaler(mean=mean,
                                std=np.where(std > 0, std, 1.0))
    else:
        s_base = fit_scaler(base, normalizer)
    return (
        s_base,
        fit_standard_scaler(day),
        fit_standard_scaler(week),
    )
