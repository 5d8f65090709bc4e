"""Sparse graph aggregation: block-CSR and DIA-band SpMM, plus the COO tail.

All graph aggregation above the dense threshold is `A @ X` over the
node axis with A stored in (TB x TB) blocks. Three representations:

  * `BlockCSR` — nonzero blocks only, run by the CUDA kernel
    `csrc/bsr_spmm.cu` (`bsr_spmm`);
  * `DIABand` — a narrow tile-diagonal band (road graphs after RCM and
    the hybrid split), run by `csrc/dia_spmm.cu` (`dia_spmm`);
  * `COOTail` — straggler edges in nearly empty blocks, a gather plus
    `index_add_` (`coo_matmul`).

The host builders are numpy and give the same arrays as the JAX
package's, including the 8 zero pad blocks `_pad_chunk` appends (the
TPU kernels over-read in chunks; the CUDA kernel never reads them).

Each kernel wrapper runs its kernel on CUDA tensors, counts the launch
in `LAUNCHES`, and raises on anything the kernel does not take; it
takes the plain PyTorch version (`*_plain`, same module) only for
tensors on the CPU. The autograd functions follow the JAX custom VJPs:
dX is the same kernel on the transposed structure; no gradient flows
into a constant band or COO tail; d block_vals is computed only when
asked for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gptst_tpu_torch.utils.device import resolve_device

# launches of each CUDA kernel since the last `reset_launch_counts()`
LAUNCHES = {"bsr_spmm": 0, "dia_spmm": 0}
_TILES = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_F = 65535 * 64          # grid.y limit times the kernels' feature tile


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# Zero blocks appended after the real ones, as the JAX package does for
# its chunked DMAs, so that the builders' arrays compare equal.
_DMA_CHUNK = 8


def _pad_chunk(cols: np.ndarray, vals: np.ndarray, tile: int):
    """Append _DMA_CHUNK zero blocks (never read by the CUDA kernel)."""
    pad = _DMA_CHUNK
    cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
    vals = np.concatenate(
        [vals, np.zeros((pad, tile, tile), vals.dtype)])
    return cols, vals


@dataclasses.dataclass
class BlockCSR:
    """Block-compressed sparse row adjacency (padded to the tile grid)."""

    block_ptr: torch.Tensor    # (row_tiles + 1,) int32
    block_cols: torch.Tensor   # (nnzb + 8,) int32
    block_vals: torch.Tensor   # (nnzb + 8, TB, TB) float32 | bfloat16
    n: int                     # logical node count
    n_pad: int                 # padded node count
    tile: int

    @property
    def row_tiles(self) -> int:
        return self.n_pad // self.tile

    @property
    def nnzb_logical(self) -> int:
        """Real block count (without the _DMA_CHUNK pad blocks)."""
        return self.block_vals.shape[0] - _DMA_CHUNK

    @classmethod
    def _from_blocks(cls, u_rows: np.ndarray, u_cols: np.ndarray,
                     blocks: np.ndarray, n: int, n_pad: int, tile: int,
                     vals_dtype=torch.float32,
                     device="cuda") -> "BlockCSR":
        """Assemble from host-side unique (row, col, block) triples
        (lexsorted by (row, col))."""
        dev = resolve_device(device)
        rt = n_pad // tile
        ptr = np.zeros(rt + 1, np.int64)
        np.add.at(ptr, u_rows + 1, 1)
        ptr = np.cumsum(ptr)
        if u_rows.size == 0:  # keep shapes non-empty for the kernel
            u_cols = np.zeros(1, np.int64)
            blocks = np.zeros((1, tile, tile), np.float32)
            ptr = np.concatenate(
                [np.zeros(rt, np.int64), np.ones(1, np.int64)])
        u_cols, blocks = _pad_chunk(u_cols, blocks, tile)
        return cls(
            block_ptr=torch.as_tensor(ptr.astype(np.int32), device=dev),
            block_cols=torch.as_tensor(u_cols.astype(np.int32), device=dev),
            block_vals=torch.as_tensor(
                np.asarray(blocks, np.float32), device=dev).to(vals_dtype),
            n=n, n_pad=n_pad, tile=tile)

    @staticmethod
    def _coo_blocks(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    n_pad: int, tile: int):
        """Edge list -> lexsorted unique block triples (host-side)."""
        rt = n_pad // tile
        br = rows // tile
        bc = cols // tile
        key = br.astype(np.int64) * rt + bc
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((uniq.size, tile, tile), np.float32)
        np.add.at(blocks, (inv, rows % tile, cols % tile),
                  vals.astype(np.float32))
        return (uniq // rt).astype(np.int64), (uniq % rt).astype(np.int64), \
            blocks

    @classmethod
    def from_dense(cls, adj: np.ndarray, tile: int = 128,
                   vals_dtype=torch.float32, device="cuda") -> "BlockCSR":
        n = adj.shape[0]
        n_pad = _round_up(n, tile)
        rows, cols = np.nonzero(adj)
        u_rows, u_cols, blocks = cls._coo_blocks(
            rows, cols, adj[rows, cols], n_pad, tile)
        return cls._from_blocks(u_rows, u_cols, blocks, n, n_pad, tile,
                                vals_dtype, device)

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, n: int, tile: int = 128,
                 vals_dtype=torch.float32, device="cuda") -> "BlockCSR":
        """Build from an edge list without a dense (N, N) adjacency."""
        n_pad = _round_up(n, tile)
        u_rows, u_cols, blocks = cls._coo_blocks(rows, cols, vals,
                                                 n_pad, tile)
        return cls._from_blocks(u_rows, u_cols, blocks, n, n_pad, tile,
                                vals_dtype, device)

    @classmethod
    def pair_from_coo(cls, rows: np.ndarray, cols: np.ndarray,
                      vals: np.ndarray, n: int, tile: int = 128,
                      vals_dtype=torch.float32, device="cuda"
                      ) -> tuple["BlockCSR", "BlockCSR"]:
        """(A, A^T) built in one host-side pass."""
        n_pad = _round_up(n, tile)
        u_rows, u_cols, blocks = cls._coo_blocks(rows, cols, vals,
                                                 n_pad, tile)
        a = cls._from_blocks(u_rows, u_cols, blocks, n, n_pad, tile,
                             vals_dtype, device)
        order = np.lexsort((u_rows, u_cols))
        at = cls._from_blocks(
            u_cols[order], u_rows[order],
            np.ascontiguousarray(blocks[order].transpose(0, 2, 1)),
            n, n_pad, tile, vals_dtype, device)
        return a, at

    @classmethod
    def pair_from_dense(cls, adj: np.ndarray, tile: int = 128,
                        vals_dtype=torch.float32, device="cuda"
                        ) -> tuple["BlockCSR", "BlockCSR"]:
        rows, cols = np.nonzero(adj)
        return cls.pair_from_coo(rows, cols, adj[rows, cols],
                                 adj.shape[0], tile, vals_dtype, device)

    def transpose(self) -> "BlockCSR":
        """Block structure of A^T, on the same device and dtype. Copies
        the blocks to the host: prefer `pair_from_coo`/`pair_from_dense`
        when the edge data is at hand."""
        rt = self.row_tiles
        ptr = self.block_ptr.cpu().numpy()
        cols = self.block_cols.cpu().numpy()
        vals = self.block_vals.float().cpu().numpy()
        nb = int(ptr[-1])
        u_rows = np.repeat(np.arange(rt, dtype=np.int64),
                           np.diff(ptr).astype(np.int64))
        u_cols = cols[:nb].astype(np.int64)
        order = np.lexsort((u_rows, u_cols))
        return BlockCSR._from_blocks(
            u_cols[order], u_rows[order],
            np.ascontiguousarray(vals[:nb][order].transpose(0, 2, 1)),
            self.n, self.n_pad, self.tile, self.block_vals.dtype,
            self.block_vals.device)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def _check_operand(x: torch.Tensor, n: int, tile: int) -> None:
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"x must be (n={n}, F), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[1] == 0 or x.shape[1] > _MAX_F:
        raise ValueError(f"feature width {x.shape[1]} outside (0, {_MAX_F}]")
    if tile not in _TILES:
        raise ValueError(f"tile {tile} not in {_TILES}")


def _check_same_device(x: torch.Tensor, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("graph arrays must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def bsr_spmm_plain(bcsr: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A @ x for x (n, F): gather the referenced x
    tiles, one batched product per real block, and a sum per row tile.
    x is cast to the value dtype before the f32 product; returns x's
    dtype."""
    n, f = x.shape
    tb, rt = bcsr.tile, bcsr.row_tiles
    ptr = bcsr.block_ptr.long()
    nb = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(rt, device=x.device), ptr.diff())
    cols = bcsr.block_cols[:nb].long()
    xp = torch.zeros(bcsr.n_pad, f, dtype=torch.float32, device=x.device)
    xp[:n] = x.to(bcsr.block_vals.dtype).float()
    prod = torch.bmm(bcsr.block_vals[:nb].float(),
                     xp.view(rt, tb, f)[cols])
    out = torch.zeros(rt, tb, f, dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, prod)
    return out.view(bcsr.n_pad, f)[:n].to(x.dtype)


def bsr_spmm(bcsr: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ x for x (n, F), by the CUDA kernel `csrc/bsr_spmm.cu`;
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return bsr_spmm_plain(bcsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {x.device}")
    _check_operand(x, bcsr.n, bcsr.tile)
    vals, ptr, cols = bcsr.block_vals, bcsr.block_ptr, bcsr.block_cols
    _check_same_device(x, vals, ptr, cols)
    if ptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("block_ptr and block_cols must be int32")
    if ptr.shape != (bcsr.row_tiles + 1,):
        raise ValueError(f"block_ptr shape {tuple(ptr.shape)}")
    if vals.dim() != 3 or vals.shape[1:] != (bcsr.tile, bcsr.tile) \
            or vals.shape[0] != cols.shape[0]:
        raise ValueError(f"block_vals shape {tuple(vals.shape)}")
    vcode = _dtype_code(vals, "block_vals")
    xcode = _dtype_code(x, "x")
    from gptst_tpu_torch.kernels.build import load

    lib = load("bsr_spmm")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bsr_spmm(
            ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
            out.data_ptr(), bcsr.n, x.shape[1], bcsr.row_tiles, bcsr.tile,
            vcode, xcode, stream)
    _raise_on(err, "bsr_spmm")
    LAUNCHES["bsr_spmm"] += 1
    return out


def _fold(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N, C) -> node-major (N, prod(...) * C); free for 2-D x."""
    if x.dim() < 2 or x.shape[-2] != n:
        raise ValueError(f"x must be (..., N={n}, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    return x.reshape(-1, n, c).movedim(1, 0).reshape(n, -1).contiguous()


def _unfold(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    *lead, n, c = like.shape
    return out.reshape(n, -1, c).movedim(0, 1).reshape(*lead, n, c)


def _spmm_impl(bcsr: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """Leading dims fold into the feature axis: one kernel call."""
    return _unfold(bsr_spmm(bcsr, _fold(x, bcsr.n)), x)


def spmm_dvals_plain(bcsr: BlockCSR, g: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """d block_vals[b] = dY[row tile b] @ X[col tile b]^T in f32, with
    the pad blocks zero. g, x: (..., N, C)."""
    tb, rt = bcsr.tile, bcsr.row_tiles
    ptr = bcsr.block_ptr.long()
    nb = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(rt, device=g.device), ptr.diff())
    cols = bcsr.block_cols[:nb].long()

    def tiles(t):
        flat = _fold(t, bcsr.n).float()
        pad = torch.zeros(bcsr.n_pad, flat.shape[1], device=t.device)
        pad[: bcsr.n] = flat
        return pad.view(rt, tb, -1)

    gt, xt = tiles(g), tiles(x)
    out = torch.zeros(bcsr.block_vals.shape, dtype=torch.float32,
                      device=g.device)
    out[:nb] = torch.bmm(gt[rows], xt[cols].transpose(1, 2))
    return out


def spmm_dvals(bcsr: BlockCSR, g: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    if g.device.type == "cpu":
        return spmm_dvals_plain(bcsr, g, x)
    raise NotImplementedError(
        "d block_vals on the card needs the port of "
        "gptst_tpu/kernels/spmm.py:_dvals_kernel (not ported yet)")


class _SpmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_vals, x, bcsr, bcsr_t):
        ctx.bcsr, ctx.bcsr_t = bcsr, bcsr_t
        ctx.save_for_backward(x if ctx.needs_input_grad[0] else None)
        return _spmm_impl(bcsr, x)

    @staticmethod
    def backward(ctx, g):
        dvals = dx = None
        if ctx.needs_input_grad[0]:
            (x,) = ctx.saved_tensors
            dvals = spmm_dvals(ctx.bcsr, g, x).to(ctx.bcsr.block_vals.dtype)
        if ctx.needs_input_grad[1]:
            dx = _spmm_impl(ctx.bcsr_t, g)
        return dvals, dx, None, None


def spmm(bcsr: BlockCSR, bcsr_t: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """A @ x over the node axis. x: (..., N, C); returns (..., N, C).
    `bcsr_t` is the transposed structure that runs the backward."""
    return _SpmmFn.apply(bcsr.block_vals, x, bcsr, bcsr_t)


# --------------------------------------------------------------------------
# Diagonal-band (DIA) variant
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DIABand:
    """Tile-diagonal band storage: vals[i, d] is block (i, i + d - w)."""

    vals: torch.Tensor   # (row_tiles, 2w+1, TB, TB)
    w: int               # half-bandwidth in tiles
    n: int
    n_pad: int
    tile: int

    @property
    def row_tiles(self) -> int:
        return self.n_pad // self.tile


# Widest band the DIA path accepts, and the least fraction of the
# band's block slots that must be nonzero (the JAX package's choice).
_DIA_MAX_W = 5
_DIA_MIN_FILL = 0.4


def dia_pair_from_coo(rows: np.ndarray, cols: np.ndarray,
                      vals: np.ndarray, n: int, tile: int = 128,
                      vals_dtype=torch.float32, device="cuda"
                      ) -> tuple["DIABand", "DIABand"] | None:
    """(A, A^T) in DIA layout, or None when the edge set is not a
    narrow/dense-enough tile band."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size == 0:
        return None
    n_pad = _round_up(n, tile)
    rt = n_pad // tile
    br, bc = rows // tile, cols // tile
    d = bc - br
    w = int(max(d.max(), -d.min()))
    if w > _DIA_MAX_W:
        return None
    nblocks = np.unique(br * rt + bc).size
    if nblocks < _DIA_MIN_FILL * min(rt * (2 * w + 1), rt * rt):
        return None
    dev = resolve_device(device)
    dense = np.zeros((rt, 2 * w + 1, tile, tile), np.float32)
    np.add.at(dense, (br, d + w, rows % tile, cols % tile),
              vals.astype(np.float32))
    a = DIABand(torch.as_tensor(dense, device=dev).to(vals_dtype),
                w, n, n_pad, tile)
    # A^T: block (i, i+d-w)^T lands at row i+d-w, diagonal -d
    dense_t = np.zeros_like(dense)
    for dd in range(2 * w + 1):
        off = dd - w
        src = dense[:, dd].transpose(0, 2, 1)   # (rt, TB, TB)
        if off >= 0:
            dense_t[off:rt, 2 * w - dd][: rt - off] = src[: rt - off]
        else:
            dense_t[: rt + off, 2 * w - dd] = src[-off:]
    at = DIABand(torch.as_tensor(dense_t, device=dev).to(vals_dtype),
                 w, n, n_pad, tile)
    return a, at


def dia_spmm_plain(dia: DIABand, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A @ x for x (n, F): one batched product per
    diagonal over all row tiles, with the clamped x tile index (its
    band block is zero) as the kernel does."""
    n, f = x.shape
    tb, rt, w = dia.tile, dia.row_tiles, dia.w
    xp = torch.zeros(dia.n_pad, f, dtype=torch.float32, device=x.device)
    xp[:n] = x.to(dia.vals.dtype).float()
    xt = xp.view(rt, tb, f)
    i = torch.arange(rt, device=x.device)
    out = torch.zeros(rt, tb, f, dtype=torch.float32, device=x.device)
    for d in range(2 * w + 1):
        c = (i + d - w).clamp(0, rt - 1)
        out += torch.bmm(dia.vals[:, d].float(), xt[c])
    return out.view(dia.n_pad, f)[:n].to(x.dtype)


def dia_spmm(dia: DIABand, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ x for x (n, F), by the CUDA kernel `csrc/dia_spmm.cu`;
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return dia_spmm_plain(dia, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm: unsupported device {x.device}")
    _check_operand(x, dia.n, dia.tile)
    vals = dia.vals
    _check_same_device(x, vals)
    if vals.shape != (dia.row_tiles, 2 * dia.w + 1, dia.tile, dia.tile):
        raise ValueError(f"band vals shape {tuple(vals.shape)}")
    vcode = _dtype_code(vals, "band vals")
    xcode = _dtype_code(x, "x")
    from gptst_tpu_torch.kernels.build import load

    lib = load("dia_spmm")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dia_spmm(
            vals.data_ptr(), x.data_ptr(), out.data_ptr(), dia.n, x.shape[1],
            dia.row_tiles, dia.w, dia.tile, vcode, xcode, stream)
    _raise_on(err, "dia_spmm")
    LAUNCHES["dia_spmm"] += 1
    return out


def _dia_impl(dia: DIABand, x: torch.Tensor) -> torch.Tensor:
    return _unfold(dia_spmm(dia, _fold(x, dia.n)), x)


class _DiaFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dia, dia_t):
        ctx.dia_t = dia_t
        return _dia_impl(dia, x)

    @staticmethod
    def backward(ctx, g):
        return _dia_impl(ctx.dia_t, g), None, None


def dia_matmul(dia: DIABand, dia_t: DIABand, x: torch.Tensor) -> torch.Tensor:
    """A @ x for a DIA-banded adjacency. x: (..., N, C). The band is a
    constant graph artifact: no gradient flows to its values."""
    return _DiaFn.apply(x, dia, dia_t)


# --------------------------------------------------------------------------
# Hybrid block + COO representation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class COOTail:
    """Straggler edges as sorted COO (device-resident)."""

    rows: torch.Tensor   # (e,) int64, sorted
    cols: torch.Tensor   # (e,) int64
    vals: torch.Tensor   # (e,) float32
    n: int

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]


def _coo_impl(coo: COOTail, x: torch.Tensor) -> torch.Tensor:
    """coo @ x via gather + index_add_. Accumulates in f32 and returns
    x.dtype."""
    xg = x.index_select(-2, coo.cols).float() * coo.vals[:, None]
    shape = list(x.shape)
    out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    out.index_add_(x.dim() - 2, coo.rows, xg)
    return out.to(x.dtype)


class _CooFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coo, coo_t):
        ctx.coo_t = coo_t
        return _coo_impl(coo, x)

    @staticmethod
    def backward(ctx, g):
        return _coo_impl(ctx.coo_t, g), None, None


def coo_matmul(coo: COOTail, coo_t: COOTail, x: torch.Tensor) -> torch.Tensor:
    """coo @ x over the node axis. x: (..., N, C); `coo_t` is the
    transposed tail that runs the backward. The tail is a constant
    graph artifact: no gradient flows to its values."""
    return _CooFn.apply(x, coo, coo_t)


def _coo_split_edges(tile: int) -> int:
    """Blocks holding fewer edges than this ride the COO tail (32 at
    TB=128, scaled quadratically for other tiles)."""
    return max(1, tile * tile // 512)


def coo_split_mask(rows: np.ndarray, cols: np.ndarray, n: int,
                   tile: int = 128,
                   min_edges: int | None = None) -> np.ndarray:
    """Boolean mask: True for edges whose block is dense enough for the
    block path."""
    if min_edges is None:
        min_edges = _coo_split_edges(tile)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    rt = _round_up(n, tile) // tile
    key = (rows // tile) * rt + cols // tile
    _, inv, counts = np.unique(key, return_inverse=True,
                               return_counts=True)
    return counts[inv] >= min_edges


def split_coo_hybrid(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     n: int, tile: int = 128,
                     min_edges: int | None = None,
                     vals_dtype=torch.float32,
                     mask: np.ndarray | None = None,
                     build_blocks: bool = True, device="cuda"):
    """Partition an edge list into (BlockCSR A, A^T, COOTail, COOTail^T).

    Edges whose (row-tile, col-tile) block holds >= min_edges edges go
    to the block path; the rest form the COO tail (None when empty).
    `build_blocks=False` returns 1-zero-block placeholder CSRs (when a
    DIA band takes the block part).
    """
    dev = resolve_device(device)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    dense = (coo_split_mask(rows, cols, n, tile, min_edges)
             if mask is None else mask)
    if build_blocks:
        a, at = BlockCSR.pair_from_coo(rows[dense], cols[dense],
                                       vals[dense], n, tile, vals_dtype,
                                       dev)
    else:
        empty = np.zeros(0, np.int64)
        a, at = BlockCSR.pair_from_coo(empty, empty,
                                       np.zeros(0, np.float32), n, tile,
                                       vals_dtype, dev)
    if dense.all():
        return a, at, None, None
    r, c, v = rows[~dense], cols[~dense], vals[~dense]

    def tail(r, c, v):
        return COOTail(torch.as_tensor(r, device=dev),
                       torch.as_tensor(c, device=dev),
                       torch.as_tensor(v, device=dev), n)

    o = np.lexsort((c, r))
    ot = np.lexsort((r, c))
    return a, at, tail(r[o], c[o], v[o]), tail(c[ot], r[ot], v[ot])
