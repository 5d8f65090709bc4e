"""Normalization and dropout.

`BatchStatsNorm` is the JAX package's `ops/norm.py`: torch BatchNorm's
*training-mode* math (normalize by the current batch's statistics, a
learnable affine), applied the same way in evaluation. There are no
running averages, so every forward is a function of the parameters and
the batch alone (GWN, `GWN.py:197`). It is not `nn.BatchNorm2d`, whose
eval mode reads running statistics. In a data-parallel step the
statistics are the global batch's, summed over the data rows
(`parallel/rows.py`), and dropout's draw is the global batch's, sliced.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gptst_tpu_torch.parallel.rows import (
    batch_count, batch_draw, batch_sum, current_row,
)


def batch_moments(x: torch.Tensor, dims: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and biased variance of x over `dims`, the batch axis 0
    among them (keepdim); in a data row of a data-parallel step, over
    the entries of every row (`parallel/rows.py`)."""
    if current_row() is None:
        return (x.mean(dim=dims, keepdim=True),
                x.var(dim=dims, keepdim=True, correction=0))
    n = batch_count(math.prod(x.shape[d] for d in dims))
    mean = batch_sum(x.sum(dim=dims, keepdim=True)) / n
    var = batch_sum(((x - mean) ** 2).sum(dim=dims, keepdim=True)) / n
    return mean, var


class BatchStatsNorm(nn.Module):
    """Normalize over every axis but the last (channel) by the batch's
    mean and biased variance, eps 1e-5; `scale` (ones) and `bias`
    (zeros) per channel, flax's names."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = batch_moments(x, tuple(range(x.dim() - 1)))
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax `nn.Dropout(rate)`: each entry kept with probability
    1 - rate and scaled by 1 / (1 - rate), the draw from `generator`
    (on x's device). Identity without a generator or at rate 0, as flax
    is with `deterministic=True`."""
    if rate <= 0 or generator is None:
        return x
    keep = batch_draw(lambda shape: torch.rand(
        shape, generator=generator, device=generator.device),
        x.shape, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
