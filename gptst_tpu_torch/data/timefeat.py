"""Calendar-feature synthesis.

Vectorized equivalent of the reference's `time_add` python loop
(`lib/load_dataset.py:4-40`): for every timestep produce a 1-based
slot-of-day index and a 1..week_max weekday index. The reference
iterates over all T timesteps on the host; here both channels are
closed-form numpy expressions.
"""

from __future__ import annotations

import numpy as np


def time_features(
    num_steps: int,
    week_start: int,
    interval: int = 5,
    weekday_only: bool = False,
    day_start: int = 0,
    hour_of_day: int = 24,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (day_index, week_index), each shaped (num_steps,).

    day_index[t]  = day_start + (t mod steps_per_day) + 1
    week_index[t] = ((week_start - 1 + t div steps_per_day) mod week_max) + 1

    Matches the reference loop exactly, including the 1-based day slot
    and the week counter that advances at each midnight boundary.
    """
    week_max = 5 if weekday_only else 7
    steps_per_day = hour_of_day * 60 // interval
    idx = np.arange(num_steps, dtype=np.int64)
    day = day_start + (idx % steps_per_day) + 1
    week = ((week_start - 1 + idx // steps_per_day) % week_max) + 1
    return day, week


def attach_time_channels(
    data: np.ndarray,
    week_start: int,
    interval: int = 5,
    weekday_only: bool = False,
) -> np.ndarray:
    """Append day/week channels to raw (T, N) or (T, N, D) data.

    Returns float array (T, N, D + 2) as in `lib/load_dataset.py:91-101`.
    """
    if data.ndim == 2:
        data = data[..., None]
    T, N = data.shape[0], data.shape[1]
    day, week = time_features(T, week_start, interval, weekday_only)
    day_ch = np.broadcast_to(day[:, None, None], (T, N, 1)).astype(data.dtype)
    week_ch = np.broadcast_to(week[:, None, None], (T, N, 1)).astype(data.dtype)
    return np.concatenate([data, day_ch, week_ch], axis=-1)
