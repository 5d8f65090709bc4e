"""Normalization and dropout.

`BatchStatsNorm` is the JAX package's `ops/norm.py`: torch BatchNorm's
*training-mode* math (normalize by the current batch's statistics, a
learnable affine), applied the same way in evaluation. There are no
running averages, so every forward is a function of the parameters and
the batch alone (GWN, `GWN.py:197`). It is not `nn.BatchNorm2d`, whose
eval mode reads running statistics. In a data-parallel step the
statistics are the global batch's, summed over the data rows
(`parallel/rows.py`), and dropout's draw is the global batch's, sliced.
Over a data row's graph ranks (`parallel/mesh.NodeShards`) each takes
lists of the ranks' node shards: the statistics sum the ranks' partial
sums (in f32) before the data rows', and dropout's draw is the row's
whole node axis, cut into the ranks' shards (`NodeShards.split_draw`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gptst_tpu_torch.ops.dtypes import widened
from gptst_tpu_torch.parallel.mesh import NodeShards
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


def node_moments(xs: list, dims: tuple[int, ...], shards: NodeShards,
                 batch: bool = False) -> list[tuple]:
    """The mean and biased variance over `dims` (keepdim; the node axis
    among them) of the row's whole node axis, the ranks' shards `xs`,
    for each rank on its device, in at least f32: two meetings of the ranks, the
    mean back on every rank before the second pass. With `batch`, over
    every data row's entries too (`parallel/rows.batch_sum`)."""
    n = math.prod(xs[0].shape[d] for d in dims) * shards.parts
    if batch:
        n = batch_count(n)

    def total(partials):
        s = shards.node_sum(partials)
        return shards.replicate((batch_sum(s) if batch else s) / n)

    means = total([widened(x).sum(dim=dims, keepdim=True) for x in xs])
    var = total([((widened(x) - m) ** 2).sum(dim=dims, keepdim=True)
                 for x, m in zip(xs, means)])
    return list(zip(means, var))


class BatchStatsNorm(nn.Module):
    """Normalize over every axis but the last (channel) by the batch's
    mean and biased variance, eps 1e-5; `scale` (ones) and `bias`
    (zeros) per channel, flax's names."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, shards: NodeShards | None = None):
        """x a tensor, or with `shards` the list of the ranks' node
        shards (axis -2)."""
        if shards is not None:
            stats = node_moments(x, tuple(range(x[0].dim() - 1)), shards,
                                 batch=True)
            return [(xg - m.to(xg.dtype)) * torch.rsqrt(v.to(xg.dtype)
                                                        + self.eps)
                    * self.scale.to(xg.device) + self.bias.to(xg.device)
                    for xg, (m, v) in zip(x, stats)]
        mean, var = batch_moments(x, tuple(range(x.dim() - 1)))
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


def dropout(x, rate: float, generator: torch.Generator | None,
            shards: NodeShards | None = None):
    """flax `nn.Dropout(rate)`: each entry kept with probability
    1 - rate and scaled by 1 / (1 - rate), the draw from `generator`
    (on x's device). Identity without a generator or at rate 0, as flax
    is with `deterministic=True`. With `shards`, x is the list of the
    ranks' node shards (axis -2) and the draw the one-device draw."""
    if rate <= 0 or generator is None:
        return x

    def draw(shape, device):
        return batch_draw(lambda s: torch.rand(
            s, generator=generator, device=generator.device),
            shape, device)

    if shards is None:
        return torch.where(draw(x.shape, x.device) >= rate,
                           x / (1.0 - rate), 0.0)
    whole = list(x[0].shape)
    whole[-2] = shards.n
    keep = shards.split_draw(lambda s: draw(s, generator.device), whole)
    return [torch.where(k >= rate, xg / (1.0 - rate), 0.0)
            for k, xg in zip(keep, x)]
