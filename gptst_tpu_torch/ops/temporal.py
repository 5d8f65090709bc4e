"""Temporal convolution blocks (the JAX package's `ops/temporal.py`).

Channels-last (B, T, N, C) layout: the time axis is convolved with a
(kt, 1) kernel as one matmul over the kt time-shifted copies of x
stacked on the channel axis (an im2col). Equivalent to the reference's
Conv2d over a (B, C, T, N) layout (`model/STGCN/stgcn.py:25-53`).
STGCN's `TemporalConv` keeps flax's `Conv` kernel layout
(kt, 1, C_in, C_out); `TimeConv` (GWN, MTGNN) keeps torch's `Conv2d`
layout (C_out, C_in, kt, 1). The products follow JAX's dtype promotion
(`ops/dtypes.py`).
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


class TimeConv(nn.Module):
    """flax `Conv(c_out, kernel_size=(kt, 1), kernel_dilation=(d, 1),
    strides=(stride, 1), padding=((p0, p1), (0, 0)))` over the T axis of
    (B, T, N, C_in) (VALID by default: T shrinks by d * (kt - 1)).
    `weight` (C_out, C_in, kt, 1), lecun-normal over fan_in = kt * C_in,
    and a zero `bias`. A 1-wide kernel at `stride` is flax's SAME conv
    too: SAME pads such a kernel by nothing."""

    def __init__(self, c_in: int, c_out: int, kt: int, dilation: int = 1,
                 generator: torch.Generator | None = None,
                 padding: tuple[int, int] = (0, 0), stride: int = 1):
        super().__init__()
        self.kt, self.dilation = kt, dilation
        self.padding, self.stride = padding, stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kt, 1))
        self.bias = nn.Parameter(torch.zeros(c_out))
        variance_scaling_(self.weight, kt * c_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, N, C)
        kt, d, s = self.kt, self.dilation, self.stride
        if any(self.padding):
            x = F.pad(x, (0, 0, 0, 0, *self.padding))
        reach = d * (kt - 1) + 1
        if x.shape[1] < reach:
            raise ValueError(f"time axis {x.shape[1]} shorter than the "
                             f"kernel's reach {reach}")
        span = (x.shape[1] - reach) // s * s + 1
        cols = torch.cat([x[:, k * d:k * d + span:s] for k in range(kt)],
                         dim=-1) if kt > 1 else x[:, :span:s]
        # (C_out, C_in, kt) -> (kt * C_in, C_out), the order of `cols`
        w = self.weight[..., 0].permute(2, 1, 0).reshape(-1,
                                                         self.weight.shape[0])
        cols, w, b = promoted(cols, w, self.bias)
        return cols @ w + b


# the dilated inception layer's kernel sizes (`MTGNN.py:130-146`)
INCEPTION_KERNELS = (2, 3, 6, 7)


class DilatedInception(nn.Module):
    """MTGNN's dilated inception layer (`model/MTGNN/MTGNN.py:130-146`):
    VALID convs with kernels 2, 3, 6 and 7 at one dilation, c_out / 4
    channels each, every output cut to the shortest time (its last
    steps) and concatenated. Parameters: `conv.{0..3}` (flax's
    `Conv_0..3`)."""

    def __init__(self, c_in: int, c_out: int, dilation: int = 1,
                 kernel_set: tuple[int, ...] = INCEPTION_KERNELS,
                 generator: torch.Generator | None = None):
        super().__init__()
        per = c_out // len(kernel_set)
        self.conv = nn.ModuleList(TimeConv(c_in, per, k, dilation, generator)
                                  for k in kernel_set)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [conv(x) for conv in self.conv]
        t_min = min(o.shape[1] for o in outs)
        return torch.cat([o[:, -t_min:] for o in outs], dim=-1)


class GatedDilatedConv(nn.Module):
    """WaveNet's gated dilated temporal conv (the JAX package's
    `ops/temporal.GatedDilatedConv`, `model/GWN/GWN.py:242-265`):
    tanh(filter(x)) * sigmoid(gate(x)), two VALID (kt, 1) convs at one
    dilation. Parameters: `conv.0` (the filter, flax's `Conv_0`) and
    `conv.1` (the gate, `Conv_1`). No predictor of either package uses
    it: GWN gates its own convs."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 2,
                 dilation: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = nn.ModuleList(
            TimeConv(c_in, c_out, kernel, dilation, generator)
            for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, N, C)
        return torch.tanh(self.conv[0](x)) * torch.sigmoid(self.conv[1](x))
