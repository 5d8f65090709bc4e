"""Recurrent cells and flax's initializers.

The JAX package lifts each cell over time with `nn.scan` (or `nn.RNN`);
here a cell is an `nn.Module` stepped by a Python loop over T (in its
predictor, `scan_over_time` or `LSTMCell.forward`), and activation
rematerialization is `torch.utils.checkpoint` around each step
(`remat_cell`). The GRU cells serve TGCN, `LSTMStack` STMGCN. The
initializers draw flax's laws with flax's fans (`flax_fans`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gptst_tpu_torch.ops.dtypes import promoted
from gptst_tpu_torch.ops.graph_conv import graph_matmul

# flax's truncated-normal initializers draw from N(0, 1) cut at +-2 and
# divide by this (the std of that truncated distribution), so that the
# result has exactly the asked-for variance
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(t: torch.Tensor, fan: float,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """flax `variance_scaling(1.0, <fan>, "truncated_normal")` in place:
    the distribution of `xavier_normal` (fan = (in + out) / 2) and of
    `lecun_normal` (fan = in)."""
    std = math.sqrt(1.0 / fan) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def flax_fans(shape) -> tuple[float, float]:
    """flax's (fan_in, fan_out) of a kernel: the last axis is the output,
    the one before it the input, and every other axis a receptive field
    that multiplies both (`jax.nn.initializers.variance_scaling`). torch's
    `_calculate_fan_in_and_fan_out` reads axis 1 as the input and the
    axes from 2 on as the field, which differs for every kernel of more
    than two axes here: ASTGCN's `bs` (1, N, N), `Theta` (K, F, O) and
    `final_w` (T, F, O); the per-window (W, C, F) weights of STSGCN and
    STFGNN; flax `Conv` kernels (kh, kw, in, out)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_normal_(t: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """flax `xavier_normal()`: truncated normal of variance
    2 / (fan_in + fan_out), flax's fans (`flax_fans`)."""
    fan_in, fan_out = flax_fans(t.shape)
    return variance_scaling_(t, (fan_in + fan_out) / 2.0, generator)


def xavier_uniform_(t: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """flax `xavier_uniform()` in place: U(+-sqrt(6 / (fan_in +
    fan_out))), flax's fans (`flax_fans`)."""
    fan_in, fan_out = flax_fans(t.shape)
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-lim, lim, generator=generator)


def fan_in_uniform_(t: torch.Tensor,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """flax `variance_scaling(1/3, "fan_in", "uniform")`, torch
    `nn.Linear`'s default law U(+-1/sqrt(fan_in)), with flax's fans: a
    (W, C, F) stack of per-window weights has fan_in C * W."""
    lim = 1.0 / math.sqrt(flax_fans(t.shape)[0])
    with torch.no_grad():
        return t.uniform_(-lim, lim, generator=generator)


class GraphGRUCell(nn.Module):
    """TGCN's GRU with graph-convolution gates, batch-major (the JAX
    package's `GraphGRUCell`, the reference's `model/TGCN/TGCN.py`):

        gates = sigmoid(A [x ‖ h] W0 + b0) -> r, u
        c     = tanh  (A [x ‖ r*h] W1 + b1)
        h'    = u * h + (1 - u) * c

    h: (B, N, U), x: (B, N, D): two aggregations per step, each of the
    (B, N, D+U) concatenation. The node-sharded path runs this layout
    (`ShardedSupport.fn` takes (..., N, C)). Weights keep flax's
    (in, out) layout and names; `GraphGRUCellNM` has the same
    parameters, as both cells are `ScanGraphGRUCell_0` in flax.
    """

    def __init__(self, dim_in: int, num_units: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, u = dim_in, num_units
        self.dim_in, self.num_units = d, u
        self.weights_0 = nn.Parameter(torch.empty(d + u, 2 * u))
        self.bias_0 = nn.Parameter(torch.zeros(2 * u))
        self.weights_1 = nn.Parameter(torch.empty(d + u, u))
        self.bias_1 = nn.Parameter(torch.zeros(u))
        xavier_normal_(self.weights_0, generator)
        xavier_normal_(self.weights_1, generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                support) -> torch.Tensor:
        def gc(inp, state, w, b):
            z = torch.cat([inp, state], dim=-1)
            az, w = promoted(graph_matmul(support, z), w)
            return az @ w + b

        gates = torch.sigmoid(gc(x, h, self.weights_0, self.bias_0))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(gc(x, r * h, self.weights_1, self.bias_1))
        return u * h + (1.0 - u) * c


class GraphGRUCellNM(GraphGRUCell):
    """The same GRU, node-major and concat-free (the JAX package's
    `GraphGRUCellNM`), with the parameters of `GraphGRUCell`:

        gates = sigmoid(A x W0[:D] + A h W0[D:] + b0) -> r, u
        c     = tanh  (A x W1[:D] + A (r*h) W1[D:] + b1)
        h'    = u * h + (1 - u) * c

    h: (N, B, U), x: (N, B, D), so the (N, B*F) operand of each
    aggregation is a free view. A·[x ‖ h] == [A·x ‖ A·h], so the
    concatenation never materializes and A·x is shared by both gates:
    three aggregations per step, of widths B*D, B*U and B*U.
    """

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                support) -> torch.Tensor:
        n, b, d = x.shape

        def agg(t):
            f = t.shape[-1]
            return graph_matmul(support, t.reshape(n, b * f)).reshape(n, b, f)

        # an f32 x (the eval-mode fused embedding) against bf16 weights
        # computes in f32, as the JAX cell's `@` promotes
        dt = torch.promote_types(x.dtype, self.weights_0.dtype)
        w0, w1 = self.weights_0.to(dt), self.weights_1.to(dt)
        ax = agg(x)
        ah = agg(h)
        gates = torch.sigmoid(ax @ w0[:d] + ah @ w0[d:] + self.bias_0)
        r, u = gates.chunk(2, dim=-1)
        arh = agg(r * h)
        c = torch.tanh(ax @ w1[:d] + arh @ w1[d:] + self.bias_1)
        return u * h + (1.0 - u) * c


def scan_over_time(step, h0: torch.Tensor, xs: torch.Tensor,
                   *broadcast) -> torch.Tensor:
    """Step a cell over axis 1 of xs (B, T, ...): `step(h, x_t,
    *broadcast) -> h'`; returns the final state. (The JAX package's
    `nn.scan` lift also stacks every state, which XLA drops when no one
    reads it; eagerly that stack would be a copy of all T states, and
    no caller reads it.)"""
    h = h0
    for t in range(xs.shape[1]):
        h = step(h, xs[:, t], *broadcast)
    return h


def resolve_remat(remat: str, num_nodes: int,
                  threshold: int = 4096) -> str:
    """Resolve the "auto" policy: "full" at >= `threshold` nodes, where
    the T-step residual stack dominates device memory, else "none"."""
    if remat != "auto":
        return remat
    return "full" if num_nodes >= threshold else "none"


def _save_matmuls_policy():
    """Selective-checkpoint policy of "dots": keep matmul outputs,
    recompute the elementwise chains."""
    from torch.utils.checkpoint import CheckpointPolicy

    ops = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def remat_cell(cell, remat: str = "none"):
    """Wrap a cell call in activation rematerialization.

    remat: "none" (store everything), "full" (store only the step's
    inputs and recompute the cell in backward) or "dots" (store the
    matmul outputs, recompute the elementwise chains). Values are
    identical either way: the same ops run again.
    """
    if remat == "none":
        return cell
    if remat not in ("full", "dots"):
        raise ValueError(f"remat must be none|full|dots, got {remat!r}")
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )

    kw = {}
    if remat == "dots":
        policy = _save_matmuls_policy()
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            policy)

    def wrapped(*args):
        return checkpoint(cell, *args, use_reentrant=False, **kw)

    return wrapped


class LSTMCell(nn.Module):
    """flax `nn.OptimizedLSTMCell(h)` in torch `nn.LSTM`'s layout for one
    layer: `weight_ih` (4h, D) and `weight_hh` (4h, h), the gates
    stacked i, f, g, o, and `bias_hh` (4h,). flax's input kernels have
    no bias, so there is no `bias_ih`:

        z = x W_ih^T + (h W_hh^T + b_hh) -> i, f, g, o
        c' = sigmoid(f) c + sigmoid(i) tanh(g);  h' = sigmoid(o) tanh(c')

    Init as flax's: lecun-normal input kernels (fan_in D), an orthogonal
    (h, h) recurrent kernel per gate, zero biases."""

    def __init__(self, dim_in: int, hidden: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, dim_in))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        variance_scaling_(self.weight_ih, dim_in, generator)
        with torch.no_grad():
            for g in self.weight_hh.split(hidden):
                nn.init.orthogonal_(g, generator=generator)

    def step(self, c: torch.Tensor, h: torch.Tensor,
             xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One step from the input's share `xi` = x W_ih^T."""
        h_, w, b = promoted(h, self.weight_hh, self.bias_hh)
        z = F.linear(h_, w, b) + xi
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def forward(self, seq: torch.Tensor, remat: str = "none") -> torch.Tensor:
        """seq (S, T, D) from a zero carry -> every step's h (S, T, h).
        The input products of all T steps are one matmul; each step runs
        under `remat_cell(·, remat)`."""
        x, w = promoted(seq, self.weight_ih)
        xi = F.linear(x, w)
        c = h = xi.new_zeros(seq.shape[0], self.hidden)
        step = remat_cell(self.step, remat)
        hs = []
        for t in range(seq.shape[1]):
            c, h = step(c, h, xi[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1)


class LSTMStack(nn.ModuleList):
    """`num_layers` `LSTMCell`s, each over the previous one's outputs
    (the JAX package's `nn.RNN(OptimizedLSTMCell)` loop, STMGCN's
    `ContextGatedLSTM`): seq (S, T, D) -> the last step's h of the last
    layer (S, h). Layer l is `{l}` of the list."""

    def __init__(self, dim_in: int, hidden: int, num_layers: int,
                 generator: torch.Generator | None = None):
        super().__init__(LSTMCell(dim_in if i == 0 else hidden, hidden,
                                  generator) for i in range(num_layers))

    def forward(self, seq: torch.Tensor, remat: str = "none") -> torch.Tensor:
        for cell in self:
            seq = cell(seq, remat)
        return seq[:, -1]
