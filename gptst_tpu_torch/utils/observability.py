"""Observability: step timing, determinism, model stats.

  * `StepTimer` — per-step wall clock with samples/s (the caller
    synchronizes the device before each `tick`).
  * `init_determinism` — numpy and torch seeding, the counterpart of the
    reference's `lib/TrainInits.py:5-16`.
  * `count_parameters` — `print_model_parameters` equivalent.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class StepTimer:
    """Wall-clock per-step timing; call `tick(n_samples)` after the
    step's outputs are ready (`torch.cuda.synchronize()` on the card)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self.samples = 0
        self._last = time.perf_counter()

    def start(self) -> None:
        """Start the next interval now (work since the last tick that
        is not to be timed, such as validation, is left out)."""
        self._last = time.perf_counter()

    def tick(self, n_samples: int = 0) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
            self.samples += n_samples
        return dt

    @property
    def mean_step_s(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n

    @property
    def samples_per_s(self) -> float:
        return self.samples / self.total if self.total > 0 else 0.0


def init_determinism(seed: int, seed_mode: bool = True) -> None:
    """Seed numpy and torch (CPU and every card); `seed_mode=False`
    leaves both unseeded, as the reference's toggle does."""
    if seed_mode:
        np.random.seed(seed)
        torch.manual_seed(seed)


def count_parameters(module: torch.nn.Module, logger=None) -> int:
    """Total parameter count (`lib/TrainInits.py:41-48`)."""
    total = sum(p.numel() for p in module.parameters())
    if logger is not None:
        logger.info("Total trainable parameters: %s", f"{total:,}")
    return total
