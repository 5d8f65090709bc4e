"""Capsule primitives: squash nonlinearity and dynamic routing.

Counterpart of the JAX package's `ops/capsule.py`, used by GPT-ST's
hierarchical spatial pattern encoder (`models/gptst.Cap`). The routing
loop runs a fixed `num_route` iterations on detached tensors (the
primary capsules and the routing seed), so only the final posterior
`softmax(b + dadj)` carries gradients, into `dadj`.
"""

from __future__ import annotations

import torch


def squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Capsule squash: (|x|^2 / (1 + |x|^2)) * x / (|x| + 1e-8)."""
    sq = (x * x).sum(dim, keepdim=True)
    return sq / (1.0 + sq) * x / (sq.sqrt() + 1e-8)


def dynamic_routing(pcaps: torch.Tensor, dadj: torch.Tensor,
                    num_route: int = 2) -> torch.Tensor:
    """Cluster-assignment routing.

    pcaps: (B, T, N, D) squashed primary capsules.
    dadj:  (B, T, H, N) time-conditioned assignment prior.
    Returns the posterior c: (B, T, H, N) = softmax over H of
    (b + dadj), b the agreement summed over `num_route` iterations.

    The reference's u_hat[b,t,h,n,:] = squash(s0)[b,t,h,:] * k[b,t,n,:]
    enters only through sum_n c[b,t,h,n] u_hat[b,t,h,n,:], which is
    squash(s0)[b,t,h,:] * einsum('bthn,btnd->bthd', c, k): the
    (B, T, H, N, D) tensor is never built.
    """
    k = pcaps.detach()
    prior = torch.softmax(dadj, dim=-2)
    u_hat_seed = squash(torch.einsum("bthn,btnd->bthd", prior, k)).detach()
    b = torch.zeros_like(dadj)
    for _ in range(num_route):
        c = torch.softmax(b, dim=2)
        v = squash(u_hat_seed * torch.einsum("bthn,btnd->bthd", c, k))
        b = b + torch.einsum("bthd,btnd->bthn", v, k)
    return torch.softmax(b + dadj, dim=2)
