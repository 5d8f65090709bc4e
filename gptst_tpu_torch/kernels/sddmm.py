"""Block-sparse SDDMM — sampled E1 @ E2 products — and the learned
sparse supports built on it.

The counterpart of the JAX package's `kernels/sddmm.py`. An adaptive
adjacency model learns a dense graph from node embeddings (GWN's
`softmax(relu(E1 @ E2))`, MTGNN's `relu(tanh(alpha * (M1 M2^T - M2 M1^T)))`);
at large N the dense N x N product does not fit, so it is computed only
on a fixed block pattern: for every stored (TB x TB) block (i, j),
`E1[i-tile] @ E2[:, j-tile]`, times the pattern's mask. The result is
the block values of a `BlockCSR` that the SpMM kernels run directly.

`sddmm_blocks` runs the CUDA kernel `csrc/sddmm.cu` on CUDA tensors
(counted in `kernels.spmm.LAUNCHES["sddmm"]`) and the plain version
`sddmm_plain` on CPU tensors. The backward (dE1, dE2) is a tile gather,
a batched product and `index_add_`, as the JAX package leaves it to XLA.

The sparse softmax normalizes over pattern entries only, whereas a
dense softmax also counts exp(0) = 1 for every non-edge: the standard
sparse-attention definition, the same as the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gptst_tpu_torch.kernels.spmm import (
    _TILES, BlockCSR, EntryLists, _check_same_device, _dtype_code,
    _raise_on, _row_tiles, count_launch, entry_lists,
)
from gptst_tpu_torch.ops.graph_conv import SparseSupport


@dataclasses.dataclass
class SDDMMPattern:
    """Static sparsity pattern for SDDMM, derived from a BlockCSR.

    Block b lives at block-row `row_ids[b]`, block-col `cols[b]`;
    `mask` zeroes entries of stored blocks that are not pattern edges
    (and the whole pad blocks). `t_*` give the transposed block order,
    so that a learned adjacency's backward structure is
    t_vals = vals[t_order].transpose(1, 2). `entries` and `t_entries`
    are the mask's slots in the two block orders, for `bsr_spmm`.
    """

    row_ids: torch.Tensor   # (nnzb,) int32
    cols: torch.Tensor      # (nnzb,) int32
    ptr: torch.Tensor       # (row_tiles + 1,) int32
    mask: torch.Tensor      # (nnzb, TB, TB) float32 in {0, 1}
    t_ptr: torch.Tensor     # (row_tiles + 1,) int32
    t_cols: torch.Tensor    # (nnzb,) int32
    t_order: torch.Tensor   # (nnzb,) int64 (an index)
    n: int
    n_pad: int
    tile: int
    entries: EntryLists
    t_entries: EntryLists

    @property
    def nnzb(self) -> int:
        return self.cols.shape[0]

    @property
    def row_tiles(self) -> int:
        return self.n_pad // self.tile

    @classmethod
    def from_bcsr(cls, bcsr: BlockCSR) -> "SDDMMPattern":
        """Pattern of an existing block-CSR adjacency (its pad blocks
        included, masked to zero), on the same device."""
        ptr = bcsr.block_ptr.cpu().numpy().astype(np.int64)
        cols = bcsr.block_cols.cpu().numpy().astype(np.int64)
        vals = bcsr.block_vals.float().cpu().numpy()
        nnzb = cols.shape[0]
        real = int(ptr[-1])
        row_ids = np.zeros(nnzb, np.int64)
        row_ids[:real] = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        mask = (vals != 0).astype(np.float32)
        mask[real:] = 0.0

        # transposed block order over the real blocks, pad blocks
        # appended unchanged at the tail
        t_sort = np.lexsort((row_ids[:real], cols[:real]))
        t_order = np.concatenate([t_sort, np.arange(real, nnzb)])
        t_rows_real = cols[:real][t_sort]
        rt = len(ptr) - 1
        t_ptr = np.zeros(rt + 1, np.int64)
        np.add.at(t_ptr, t_rows_real + 1, 1)
        t_ptr = np.cumsum(t_ptr)
        t_cols = np.concatenate([row_ids[:real][t_sort], cols[real:]])
        dev = bcsr.block_vals.device
        slots = mask != 0

        def i32(a):
            return torch.as_tensor(a.astype(np.int32), device=dev)

        return cls(row_ids=i32(row_ids), cols=i32(cols), ptr=i32(ptr),
                   mask=torch.as_tensor(mask, device=dev), t_ptr=i32(t_ptr),
                   t_cols=i32(t_cols),
                   t_order=torch.as_tensor(t_order, device=dev),
                   n=bcsr.n, n_pad=bcsr.n_pad, tile=bcsr.tile,
                   entries=entry_lists(slots, ptr, bcsr.n_pad, bcsr.tile,
                                       dev),
                   t_entries=entry_lists(
                       slots[t_order].transpose(0, 2, 1), t_ptr, bcsr.n_pad,
                       bcsr.tile, dev))


def sddmm_plain(pattern: SDDMMPattern, e1: torch.Tensor,
                e2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sampled product: the referenced row tiles of e1 and
    column tiles of e2, one batched product per block, times the mask.
    e1: (N, d), e2: (d, N); returns (nnzb, TB, TB) f32."""
    t1 = _row_tiles(e1, pattern.n_pad, pattern.tile)[pattern.row_ids.long()]
    t2 = _row_tiles(e2.t(), pattern.n_pad, pattern.tile)[pattern.cols.long()]
    return torch.bmm(t1, t2.transpose(1, 2)) * pattern.mask


def sddmm_blocks(pattern: SDDMMPattern, e1: torch.Tensor,
                 e2: torch.Tensor) -> torch.Tensor:
    """(E1 @ E2) on the pattern's stored blocks, times the mask, by the
    CUDA kernel `csrc/sddmm.cu`; the plain version for CPU tensors.
    e1: (N, d), e2: (d, N), each f32 or bf16; returns (nnzb, TB, TB)
    f32."""
    if e1.device.type == "cpu":
        return sddmm_plain(pattern, e1, e2)
    if e1.device.type != "cuda":
        raise ValueError(f"sddmm: unsupported device {e1.device}")
    n, tb = pattern.n, pattern.tile
    if e1.dim() != 2 or e1.shape[0] != n or e1.shape[1] == 0:
        raise ValueError(f"e1 must be (n={n}, d), got {tuple(e1.shape)}")
    if e2.shape != (e1.shape[1], n):
        raise ValueError(f"e2 must be (d={e1.shape[1]}, n={n}), "
                         f"got {tuple(e2.shape)}")
    if not (e1.is_contiguous() and e2.is_contiguous()):
        raise ValueError("e1 and e2 must be contiguous")
    if tb not in _TILES:
        raise ValueError(f"tile {tb} not in {_TILES}")
    rids, cols, mask = pattern.row_ids, pattern.cols, pattern.mask
    _check_same_device(e1, e2, rids, cols, mask)
    if rids.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("row_ids and cols must be int32")
    nnzb = cols.shape[0]
    if rids.shape != (nnzb,) or mask.shape != (nnzb, tb, tb):
        raise ValueError(f"row_ids {tuple(rids.shape)} / mask "
                         f"{tuple(mask.shape)} do not fit {nnzb} blocks")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    c1 = _dtype_code(e1, "e1")
    c2 = _dtype_code(e2, "e2")
    from gptst_tpu_torch.kernels.build import load

    lib = load("sddmm")
    out = torch.empty(nnzb, tb, tb, dtype=torch.float32, device=e1.device)
    with torch.cuda.device(e1.device):
        stream = torch.cuda.current_stream(e1.device).cuda_stream
        err = lib.sddmm(rids.data_ptr(), cols.data_ptr(), e1.data_ptr(),
                        e2.data_ptr(), mask.data_ptr(), out.data_ptr(), n,
                        e1.shape[1], nnzb, tb, c1, c2, stream)
    _raise_on(err, "sddmm")
    count_launch("sddmm")
    return out


def _sddmm_bwd(pattern: SDDMMPattern, e1: torch.Tensor, e2: torch.Tensor,
               g: torch.Tensor):
    """dE1, dE2 of the sampled product: tile gathers, batched products
    and a sum per tile (the JAX package's `_sddmm_bwd`)."""
    n, d = e1.shape
    tb, rt = pattern.tile, pattern.row_tiles
    rids, cols = pattern.row_ids.long(), pattern.cols.long()
    g = g.float() * pattern.mask
    # dE1[row tile r] += sum over b in row r of g[b] @ E2[:, col b]^T
    e2_tiles = _row_tiles(e2.t(), pattern.n_pad, tb)[cols]   # (nnzb, TB, d)
    de1 = torch.zeros(rt, tb, d, dtype=torch.float32, device=g.device)
    de1.index_add_(0, rids, torch.bmm(g, e2_tiles))
    # dE2[:, col tile c] += sum over b in col c of E1[row b]^T @ g[b]
    e1_tiles = _row_tiles(e1, pattern.n_pad, tb)[rids]
    de2 = torch.zeros(rt, d, tb, dtype=torch.float32, device=g.device)
    de2.index_add_(0, cols, torch.bmm(e1_tiles.transpose(1, 2), g))
    de1 = de1.view(pattern.n_pad, d)[:n]
    de2 = de2.movedim(0, 1).reshape(d, pattern.n_pad)[:, :n]
    return de1.to(e1.dtype), de2.to(e2.dtype)


class _SddmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e1, e2, pattern):
        ctx.pattern = pattern
        ctx.save_for_backward(e1, e2)
        return sddmm_blocks(pattern, e1, e2)

    @staticmethod
    def backward(ctx, g):
        e1, e2 = ctx.saved_tensors
        de1, de2 = _sddmm_bwd(ctx.pattern, e1, e2, g)
        return de1, de2, None


def sddmm(pattern: SDDMMPattern, e1: torch.Tensor,
          e2: torch.Tensor) -> torch.Tensor:
    """Sampled (E1 @ E2) on the pattern's stored blocks, differentiable
    in e1 (N, d) and e2 (d, N). Returns (nnzb, TB, TB) f32 block values,
    zero at the non-edges of stored blocks and in the pad blocks."""
    return _SddmmFn.apply(e1.contiguous(), e2.contiguous(), pattern)


def _block_row_softmax(pattern: SDDMMPattern,
                       scores: torch.Tensor) -> torch.Tensor:
    """Row softmax restricted to pattern entries.

    scores: (nnzb, TB, TB) with non-edges already 0 (post-relu, so all
    entries >= 0; exp runs unshifted exactly like the reference's
    softmax over non-negative relu outputs)."""
    ex = torch.exp(scores) * pattern.mask
    rids = pattern.row_ids.long()
    row_sums = torch.zeros(pattern.row_tiles, pattern.tile,
                           dtype=ex.dtype, device=ex.device)
    row_sums = row_sums.index_add(0, rids, ex.sum(dim=2))     # (rt, TB)
    denom = row_sums[rids]                                     # (nnzb, TB)
    return ex / torch.clamp_min(denom[:, :, None], 1e-38)


def _learned_support(pattern: SDDMMPattern,
                     vals: torch.Tensor) -> SparseSupport:
    """A `SparseSupport` over learned block values: the forward
    structure, and the transposed one for the backward (no gradient
    flows through the transposed values: d vals of the forward carries
    all of it)."""
    t_vals = vals[pattern.t_order].transpose(1, 2).contiguous()
    fwd = BlockCSR(block_ptr=pattern.ptr, block_cols=pattern.cols,
                   block_vals=vals, n=pattern.n, n_pad=pattern.n_pad,
                   tile=pattern.tile, entries=pattern.entries)
    bwd = BlockCSR(block_ptr=pattern.t_ptr, block_cols=pattern.t_cols,
                   block_vals=t_vals, n=pattern.n, n_pad=pattern.n_pad,
                   tile=pattern.tile, entries=pattern.t_entries)
    return SparseSupport(fwd, bwd)


def adaptive_support(pattern: SDDMMPattern, e1: torch.Tensor,
                     e2: torch.Tensor) -> SparseSupport:
    """GWN-style sparse adaptive adjacency, softmax(relu(E1 @ E2))
    restricted to the pattern, as a `SparseSupport` whose gradients flow
    through the block values to e1 (N, d) and e2 (d, N)."""
    vals = _block_row_softmax(pattern, torch.relu(sddmm(pattern, e1, e2)))
    return _learned_support(pattern, vals)


def mtgnn_support(pattern: SDDMMPattern, m1: torch.Tensor,
                  m2: torch.Tensor, alpha: float) -> SparseSupport:
    """MTGNN-style sparse learned graph,
    relu(tanh(alpha * (M1 M2^T - M2 M1^T))) on the pattern (the pattern
    plays the role of the reference's top-k mask). m1, m2: (N, d)."""
    s12 = sddmm(pattern, m1, m2.t())
    s21 = sddmm(pattern, m2, m1.t())
    vals = torch.relu(torch.tanh(alpha * (s12 - s21))) * pattern.mask
    return _learned_support(pattern, vals)
