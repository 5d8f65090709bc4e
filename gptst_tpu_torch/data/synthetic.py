"""Synthetic spatio-temporal traffic generator.

The reference repo ships no raw datasets (users download PEMS08 etc.
separately, `readme.md`). To keep the framework runnable end-to-end —
tests, benchmarks, smoke training — this module synthesizes series with
the statistical shape of the real data: strong diurnal cycles, weekday/
weekend contrast, spatial correlation along a random sensor graph, and
multiplicative noise. Shapes and value ranges follow the reference's
dataset descriptions (`lib/load_dataset.py:44-89`).
"""

from __future__ import annotations

import numpy as np

from gptst_tpu_torch.config.datasets import DatasetSpec


def synthesize_raw_series(
    spec: DatasetSpec, num_steps: int | None = None, seed: int = 0
) -> np.ndarray:
    """Return raw (T, N, input_base_dim) series resembling `spec`'s data."""
    rng = np.random.default_rng(seed)
    T = num_steps if num_steps is not None else spec.typical_length
    N = spec.num_nodes
    D = spec.input_base_dim
    spd = spec.steps_per_day

    t = np.arange(T)
    tod = (t % spd) / spd                       # time-of-day in [0,1)
    dow = ((spec.week_start - 1 + t // spd) % spec.week_day)  # 0..6

    # Two gaussian rush-hour bumps + base level; weekends damped.
    morning = np.exp(-0.5 * ((tod - 0.33) / 0.06) ** 2)
    evening = np.exp(-0.5 * ((tod - 0.73) / 0.08) ** 2)
    weekend = (dow >= 5).astype(np.float64)
    profile = 0.25 + (morning + 0.9 * evening) * (1.0 - 0.45 * weekend)

    # Node personalities: scale + phase jitter, spatially smoothed so
    # neighbouring node ids correlate (stand-in for graph locality).
    scale = rng.lognormal(mean=0.0, sigma=0.35, size=(N, D))
    kernel = np.ones(7) / 7.0
    for d in range(D):
        scale[:, d] = np.convolve(
            np.pad(scale[:, d], 3, mode="wrap"), kernel, mode="valid"
        )
    phase = rng.normal(0.0, 0.02, size=(N, D))

    tod_shifted = (tod[:, None, None] + phase[None]) % 1.0
    m = np.exp(-0.5 * ((tod_shifted - 0.33) / 0.06) ** 2)
    e = np.exp(-0.5 * ((tod_shifted - 0.73) / 0.08) ** 2)
    prof = 0.25 + (m + 0.9 * e) * (1.0 - 0.45 * weekend[:, None, None])

    base_level = 220.0 if spec.interval == 5 else 25.0
    x = base_level * scale[None] * prof
    # AR(1) multiplicative noise for temporal roughness.
    eps = rng.normal(0.0, 0.08, size=(T, N, D))
    for i in range(1, T):
        eps[i] += 0.7 * eps[i - 1]
    x = x * np.exp(eps)
    x = np.maximum(x, 0.0)
    del profile  # only the phase-shifted variant is used
    return x.astype(np.float32)
