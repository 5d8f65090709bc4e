"""Recurrent graph cells.

The JAX package lifts each cell over time with `nn.scan`; here a cell
is an `nn.Module` stepped by a Python loop over T in its predictor, and
activation rematerialization is `torch.utils.checkpoint` around each
step (`remat_cell`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

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


def xavier_normal_(t: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """flax `xavier_normal()` for an (in, out) kernel."""
    return variance_scaling_(t, (t.shape[0] + t.shape[1]) / 2.0, generator)


class GraphGRUCellNM(nn.Module):
    """TGCN's GRU with graph-convolution gates, node-major and
    concat-free (the JAX package's `GraphGRUCellNM`):

        gates = sigmoid(A x W0[:D] + A h W0[D:] + b0) -> r, u
        c     = tanh  (A x W1[:D] + A (r*h) W1[D:] + b1)
        h'    = u * h + (1 - u) * c

    h: (N, B, U), x: (N, B, D), so the (N, B*F) operand of each
    aggregation is a free view. A·[x ‖ h] == [A·x ‖ A·h], so the
    concatenation never materializes and A·x is shared by both gates:
    three aggregations per step, of widths B*D, B*U and B*U. Weights
    keep flax's (in, out) layout and names.
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
        n, b, d = x.shape

        def agg(t):
            f = t.shape[-1]
            return graph_matmul(support, t.reshape(n, b * f)).reshape(n, b, f)

        w0, w1 = self.weights_0, self.weights_1
        ax = agg(x)
        ah = agg(h)
        gates = torch.sigmoid(ax @ w0[:d] + ah @ w0[d:] + self.bias_0)
        r, u = gates.chunk(2, dim=-1)
        arh = agg(r * h)
        c = torch.tanh(ax @ w1[:d] + arh @ w1[d:] + self.bias_1)
        return u * h + (1.0 - u) * c


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
