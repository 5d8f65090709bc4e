"""Customized parameter learners: weights drawn from a pool.

Counterpart of the JAX package's `ops/param_pool.py`. Instead of one
shared weight matrix, a pool of weights indexed by a low-rank embedding
gives every node (`node_param_linear`) or every (batch, time) pair
(`time_param_linear`) its own linear map. Both are plain batched
products (`torch.einsum` lowers them to `bmm`).
"""

from __future__ import annotations

import torch


def node_param_linear(x: torch.Tensor, node_emb: torch.Tensor,
                      w_pool: torch.Tensor,
                      b_pool: torch.Tensor | None) -> torch.Tensor:
    """Per-node linear map from a weight pool.

    x: (B, T, N, Di), node_emb: (N, E), w_pool: (E, Di, Do),
    b_pool: (E, Do) or None. Returns (B, T, N, Do).
    """
    weights = torch.einsum("nd,dio->nio", node_emb, w_pool)
    out = torch.einsum("btni,nio->btno", x, weights)
    if b_pool is None:
        return out
    return out + node_emb @ b_pool


def time_param_linear(x: torch.Tensor, time_eb: torch.Tensor,
                      w_pool: torch.Tensor,
                      b_pool: torch.Tensor) -> torch.Tensor:
    """Per-(batch, time) linear map from a weight pool.

    x: (B, T, N, Di), time_eb: (B, T, E), w_pool: (E, Di, Do),
    b_pool: (E, Do). Returns (B, T, N, Do).
    """
    weights = torch.einsum("btd,dio->btio", time_eb, w_pool)
    out = torch.einsum("btni,btio->btno", x, weights)
    return out + (time_eb @ b_pool)[:, :, None, :]
