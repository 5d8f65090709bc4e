"""Capsule primitives: squash nonlinearity and dynamic routing.

Counterpart of the JAX package's `ops/capsule.py`, used by GPT-ST's
hierarchical spatial pattern encoder (`models/gptst.Cap`). The routing
loop runs a fixed `num_route` iterations on detached tensors (the
primary capsules and the routing seed), so only the final posterior
`softmax(b + dadj)` carries gradients, into `dadj`.

Node-sharded (a `parallel/mesh.NodeShards` layout), only the routing's
two sums over nodes couple the ranks: each rank sums its own nodes, the
partials meet in `NodeShards.node_sum`, and the agreement update and
both softmaxes over clusters run per node on each rank.
"""

from __future__ import annotations

import torch

from gptst_tpu_torch.parallel.mesh import NodeShards


def squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Capsule squash: (|x|^2 / (1 + |x|^2)) * x / (|x| + 1e-8)."""
    sq = (x * x).sum(dim, keepdim=True)
    return sq / (1.0 + sq) * x / (sq.sqrt() + 1e-8)


def dynamic_routing(pcaps, dadj, num_route: int = 2,
                    shards: NodeShards | None = None):
    """Cluster-assignment routing.

    pcaps: (B, T, N, D) squashed primary capsules.
    dadj:  (B, T, H, N) time-conditioned assignment prior.
    Returns the posterior c: (B, T, H, N) = softmax over H of
    (b + dadj), b the agreement summed over `num_route` iterations.
    With `shards`, pcaps, dadj and c are lists of the ranks' node shards.

    The reference's u_hat[b,t,h,n,:] = squash(s0)[b,t,h,:] * k[b,t,n,:]
    enters only through sum_n c[b,t,h,n] u_hat[b,t,h,n,:], which is
    squash(s0)[b,t,h,:] * einsum('bthn,btnd->bthd', c, k): the
    (B, T, H, N, D) tensor is never built.
    """
    if shards is None:
        return dynamic_routing([pcaps], [dadj], num_route, NodeShards(
            (pcaps.device,), pcaps.shape[-2]))[0]
    k = [p.detach() for p in pcaps]

    def node_sum(c):
        # sum_n c[b,t,h,n] k[b,t,n,:] over every rank's nodes
        return shards.node_sum([torch.einsum("bthn,btnd->bthd", cg, kg)
                                for cg, kg in zip(c, k)])

    prior = [torch.softmax(d, dim=-2) for d in dadj]
    u_hat_seed = squash(node_sum(prior)).detach()
    b = [torch.zeros_like(d) for d in dadj]
    for _ in range(num_route):
        c = [torch.softmax(bg, dim=2) for bg in b]
        v = shards.replicate(squash(u_hat_seed * node_sum(c)))
        b = [bg + torch.einsum("bthd,btnd->bthn", vg, kg)
             for bg, vg, kg in zip(b, v, k)]
    return [torch.softmax(bg + d, dim=2) for bg, d in zip(b, dadj)]
