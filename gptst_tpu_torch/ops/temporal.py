"""Temporal convolution blocks (the JAX package's `ops/temporal.py`).

Channels-last (B, T, N, C) layout: the time axis is convolved with a
(kt, 1) kernel kept in flax's `Conv` layout (kt, 1, C_in, C_out), as
one matmul over the kt time-shifted copies of x stacked on the channel
axis (an im2col). Equivalent to the reference's Conv2d over a
(B, C, T, N) layout (`model/STGCN/stgcn.py:25-53`). The products
follow JAX's dtype promotion (`ops/dtypes.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.ops.dtypes import linear, promoted
from gptst_tpu_torch.ops.recurrent import variance_scaling_


def dense(c_in: int, c_out: int,
          generator: torch.Generator | None = None) -> nn.Linear:
    """flax `Dense` at its default init: lecun-normal kernel, zero bias."""
    lin = nn.Linear(c_in, c_out)
    variance_scaling_(lin.weight, c_in, generator)
    nn.init.zeros_(lin.bias)
    return lin


def align_channels(x: torch.Tensor, c_out: int,
                   proj: nn.Linear | None = None) -> torch.Tensor:
    """Match the channel width for residuals (`stgcn.py:10-23`): a 1x1
    projection when shrinking, zero padding when growing."""
    c_in = x.shape[-1]
    if c_in > c_out:
        return linear(proj, x)
    if c_in < c_out:
        return F.pad(x, (0, c_out - c_in))
    return x


class TemporalConv(nn.Module):
    """STGCN's temporal conv layer with a GLU, sigmoid or relu
    activation: a SAME-padded (kt, 1) conv plus the aligned residual.
    GLU: (P + x_in) * sigmoid(Q), where the conv gives [P ‖ Q].

    Parameters (flax's `TemporalConv_k` scope): `kernel` (kt, 1, C_in,
    width) and `bias` (width,) of its `Conv_0`, and `proj` (its
    `Dense_0`) when C_in > C_out."""

    def __init__(self, kt: int, c_in: int, c_out: int, act: str = "relu",
                 generator: torch.Generator | None = None):
        super().__init__()
        if act not in ("GLU", "sigmoid", "relu"):
            raise ValueError(f"act must be GLU|sigmoid|relu, got {act!r}")
        self.kt, self.c_out, self.act = kt, c_out, act
        width = 2 * c_out if act == "GLU" else c_out
        self.proj = dense(c_in, c_out, generator) if c_in > c_out else None
        self.kernel = nn.Parameter(torch.empty(kt, 1, c_in, width))
        self.bias = nn.Parameter(torch.zeros(width))
        # flax Conv: lecun-normal over fan_in = kt * C_in
        variance_scaling_(self.kernel, kt * c_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, N, C)
        kt, t = self.kt, x.shape[1]
        x_in = align_channels(x, self.c_out, self.proj)
        p = (kt - 1) // 2
        xp = F.pad(x, (0, 0, 0, 0, p, kt - 1 - p))
        cols = torch.cat([xp[:, k:k + t] for k in range(kt)], dim=-1)
        cols, w, b = promoted(cols, self.kernel.flatten(0, 2), self.bias)
        x_conv = cols @ w + b
        if self.act == "GLU":
            c = self.c_out
            return (x_conv[..., :c] + x_in) * torch.sigmoid(x_conv[..., c:])
        if self.act == "sigmoid":
            return torch.sigmoid(x_conv + x_in)
        return torch.relu(x_conv + x_in)
