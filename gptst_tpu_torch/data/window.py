"""Sliding-window dataset construction.

Vectorized equivalent of `lib/add_window.py:3-28` (a python while-loop
there). Produces X = (B, window, N, D) inputs and Y = (B, horizon, N, D)
targets from a chronological (T, N, D) series. Number of windows is
T - window - horizon + 1, matching the reference's `end_index`.
"""

from __future__ import annotations

import numpy as np


def add_window_horizon(
    data: np.ndarray, window: int = 12, horizon: int = 12,
    single: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    T = data.shape[0]
    num = T - window - horizon + 1
    if num <= 0:
        raise ValueError(
            f"series of length {T} too short for window={window} "
            f"horizon={horizon}"
        )
    starts = np.arange(num)
    x_idx = starts[:, None] + np.arange(window)[None, :]
    X = data[x_idx]
    if single:
        y_idx = starts + window + horizon - 1
        Y = data[y_idx][:, None]
    else:
        y_idx = starts[:, None] + window + np.arange(horizon)[None, :]
        Y = data[y_idx]
    return X, Y
