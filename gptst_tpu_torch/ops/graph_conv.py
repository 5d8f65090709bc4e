"""Graph aggregation: `graph_matmul` over a dense or sparse support.

All graph aggregation flows through `graph_matmul`, which dispatches on
the support representation:

  * a plain (N, N) tensor — one dense matmul; the default at reference
    scale (N <= 266) and below `DENSE_THRESHOLD` nodes;
  * `SparseSupport` — the hand-written CUDA kernels of
    `kernels/spmm.py` (DIA band or block-CSR) plus the COO straggler
    tail, with an optional RCM node reordering that concentrates the
    nonzero blocks.

`make_support` picks the representation from the node count, so model
code is representation-agnostic. Layout: x is (..., N, C); supports act
on the N axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gptst_tpu_torch.kernels.spmm import (
    BlockCSR, COOTail, DIABand, coo_matmul, coo_split_mask, dia_matmul,
    dia_pair_from_coo, spmm, split_coo_hybrid,
)
from gptst_tpu_torch.utils.device import resolve_device

# Below this node count a dense (N, N) matmul is the support: the same
# threshold as the JAX package, so both pick the same representation.
DENSE_THRESHOLD = 4096


@dataclasses.dataclass
class SparseSupport:
    """Block-CSR adjacency (+ its transpose, for the backward), optionally
    behind an RCM node permutation, optionally with a COO straggler tail,
    and with a DIA band in place of the block-CSR kernels when the block
    part is a narrow tile band (then `bcsr`/`bcsr_t` are 1-zero-block
    placeholders that are never read).

    With a permutation, `graph_matmul` computes Pᵀ (A_perm @ (P x)) so
    callers keep the original node order.
    """

    bcsr: BlockCSR
    bcsr_t: BlockCSR
    perm: torch.Tensor | None = None      # (N,) permuted pos -> original
    inv_perm: torch.Tensor | None = None
    coo: COOTail | None = None
    coo_t: COOTail | None = None
    dia: DIABand | None = None
    dia_t: DIABand | None = None

    @property
    def T(self) -> "SparseSupport":
        return SparseSupport(self.bcsr_t, self.bcsr, self.perm,
                             self.inv_perm, self.coo_t, self.coo,
                             self.dia_t, self.dia)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.bcsr.n, self.bcsr.n)


def _count_blocks(rows: np.ndarray, cols: np.ndarray, tile: int) -> int:
    pairs = (rows // tile).astype(np.int64) * (1 << 32) + cols // tile
    return int(np.unique(pairs).size)


def make_support(adj: np.ndarray, *, dense_threshold: int = DENSE_THRESHOLD,
                 tile: int = 128, reorder: bool = True, hybrid: bool = True,
                 device="cuda"):
    """Pick the aggregation representation for a precomputed support:
    a dense f32 tensor up to `dense_threshold` nodes, a `SparseSupport`
    above it. With `reorder=True` an RCM ordering is kept only if it
    cuts the nonzero block count by more than 10%. `hybrid=True` routes
    edges in nearly empty blocks through the COO tail."""
    n = adj.shape[0]
    if n <= dense_threshold:
        return torch.as_tensor(np.asarray(adj, np.float32),
                               device=resolve_device(device))
    adj = np.asarray(adj)
    rows, cols = np.nonzero(adj)
    return make_support_coo(rows, cols, adj[rows, cols], n, tile=tile,
                            reorder=reorder, hybrid=hybrid, device=device)


def make_support_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     n: int, *, tile: int = 128, reorder: bool = True,
                     hybrid: bool = True, vals_dtype=torch.float32,
                     device="cuda") -> SparseSupport:
    """`SparseSupport` straight from an edge list (no dense (N, N))."""
    dev = resolve_device(device)
    perm = inv_perm = None
    if reorder:
        from gptst_tpu_torch.graph.partition import rcm_order_coo

        p = rcm_order_coo(rows, cols, n)
        inv = np.empty_like(p)
        inv[p] = np.arange(n)
        if (_count_blocks(inv[rows], inv[cols], tile)
                < 0.9 * _count_blocks(rows, cols, tile)):
            rows, cols = inv[rows], inv[cols]
            perm = torch.as_tensor(p, device=dev)
            inv_perm = torch.as_tensor(inv, device=dev)
    dia = dia_t = None
    if hybrid:
        # the DIA band takes the block part when it is a narrow, dense
        # enough tile band; the block-CSR slots then hold placeholders
        mask = coo_split_mask(rows, cols, n, tile)
        pair = dia_pair_from_coo(rows[mask], cols[mask], vals[mask], n,
                                 tile, vals_dtype, dev)
        if pair is not None:
            dia, dia_t = pair
        bcsr, bcsr_t, coo, coo_t = split_coo_hybrid(
            rows, cols, vals, n, tile=tile, vals_dtype=vals_dtype,
            mask=mask, build_blocks=pair is None, device=dev)
    else:
        bcsr, bcsr_t = BlockCSR.pair_from_coo(rows, cols, vals, n, tile,
                                              vals_dtype, dev)
        coo = coo_t = None
    return SparseSupport(bcsr, bcsr_t, perm, inv_perm, coo, coo_t,
                         dia, dia_t)


def graph_matmul(support, x: torch.Tensor) -> torch.Tensor:
    """support @ x over the node axis.

    support: (N, N) tensor or `SparseSupport`; x: (..., N, C). Dense:
    one matmul, the support cast to x's dtype. Sparse: the DIA or
    block-CSR kernel (leading dims fold into the feature axis inside
    the call) plus the COO tail, inside the RCM permutation.
    """
    if isinstance(support, SparseSupport):
        if support.perm is not None:
            x = x.index_select(-2, support.perm)
        if support.dia is not None:
            out = dia_matmul(support.dia, support.dia_t, x)
        else:
            out = spmm(support.bcsr, support.bcsr_t, x)
        if support.coo is not None:
            out = out + coo_matmul(support.coo, support.coo_t, x)
        if support.inv_perm is not None:
            out = out.index_select(-2, support.inv_perm)
        return out
    return torch.matmul(support.to(x.dtype), x)
