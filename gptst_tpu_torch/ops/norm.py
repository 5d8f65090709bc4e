"""Normalization and dropout.

`BatchStatsNorm` is the JAX package's `ops/norm.py`: torch BatchNorm's
*training-mode* math (normalize by the current batch's statistics, a
learnable affine), applied the same way in evaluation. There are no
running averages, so every forward is a function of the parameters and
the batch alone (GWN, `GWN.py:197`). It is not `nn.BatchNorm2d`, whose
eval mode reads running statistics.
"""

from __future__ import annotations

import torch
from torch import nn


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
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, correction=0)
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
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
