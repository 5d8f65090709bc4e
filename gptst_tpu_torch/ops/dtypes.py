"""JAX's dtype promotion for the products that torch does not promote.

`jnp.einsum`, `@` and flax's `Dense`/`Conv`/`LayerNorm` compute in the
promoted dtype of their operands (a bf16 activation against an f32
weight gives f32); `torch.matmul`, `einsum` and `F.linear` refuse mixed
dtypes. These helpers cast the operands up first, so a bf16 forward
takes the dtypes the JAX package takes. Elementwise torch ops already
promote.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def promoted(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """`ts` cast to their promoted dtype (no copy where it is theirs)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)


def widened(t: torch.Tensor) -> torch.Tensor:
    """t in at least f32 (a bf16 t in f32; f32 and float64 as they are):
    where partial sums over node shards accumulate before they meet."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax `Dense` semantics of `lin(x)`: x, weight and bias promoted."""
    x, w, b = promoted(x, lin.weight, lin.bias)
    return F.linear(x, w, b)
