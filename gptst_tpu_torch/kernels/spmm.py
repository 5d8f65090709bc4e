"""Sparse graph aggregation: block-CSR and DIA-band SpMM, plus the COO tail.

All graph aggregation above the dense threshold is `A @ X` over the
node axis with A stored in (TB x TB) blocks. Three representations:

  * `BlockCSR` — nonzero blocks only, run by the CUDA kernel
    `csrc/block_spmm.cu` (`bsr_spmm`);
  * `DIABand` — a narrow tile-diagonal band (road graphs after RCM and
    the hybrid split), run by `csrc/block_spmm.cu` (`dia_spmm`) through
    its block-CSR view (`DIABand.blocks`);
  * `COOTail` — straggler edges in nearly empty blocks, a gather plus
    `index_add_` (`coo_matmul`).

The two block kernels compute what the dense block product computes,
NaN and Inf included, but sum only the block slots that may hold a
nonzero ("entries", `EntryLists`, built once per structure on the
host). A block runs densely, zeros included, only where a non-finite x
or a nonzero value outside its entries needs it; `DENSE_BLOCKS` counts
those (CUDA block, stored block) pairs on the device.

When the block values are learned (`kernels/sddmm.adaptive_support`),
their gradient is `spmm_dvals`, run by `csrc/spmm_dvals.cu`.

The host builders are numpy and give the same arrays as the JAX
package's, including the 8 zero pad blocks `_pad_chunk` appends (the
TPU kernels over-read in chunks; the CUDA kernels never multiply them).

Each kernel wrapper runs its kernel on CUDA tensors, counts the launch
in `LAUNCHES`, and raises on anything the kernel does not take; it
takes the plain PyTorch version (`*_plain`, same module) only for
tensors on the CPU. The autograd functions follow the JAX custom VJPs:
dX is the same kernel on the transposed structure; no gradient flows
into a constant band or COO tail; d block_vals is computed only when
asked for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from gptst_tpu_torch.utils.device import resolve_device

# launches of each CUDA kernel since the last `reset_launch_counts()`
LAUNCHES = {"bsr_spmm": 0, "dia_spmm": 0, "sddmm": 0, "spmm_dvals": 0,
            "ring_spmm": 0}
# guards `LAUNCHES`, the tallies and `DENSE_BLOCKS` (threads launch
# concurrently: the data rows of `parallel/spmd.py`)
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()
# per (kernel, device): an int32 tensor on the device that the block
# kernels add one to for each (CUDA block, stored block) pair that ran
# densely; read by `dense_block_counts()` only, never on the main path
DENSE_BLOCKS: dict[tuple[str, torch.device], torch.Tensor] = {}
_TILES = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_BN = 64                     # the block kernels' feature tile
_MAX_F = 65535 * _BN         # grid.y limit times the feature tile


def reset_launch_counts() -> None:
    """Zero `LAUNCHES` and the dense-block counters (on the device, no
    synchronize)."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for t in DENSE_BLOCKS.values():
        t.zero_()


@contextlib.contextmanager
def tally_launches(counts: dict[str, int]):
    """Within the block, the calling thread's launches are also added
    to `counts`, by kernel."""
    saved = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts
    try:
        yield counts
    finally:
        _TALLY.counts = saved


def count_launch(name: str) -> None:
    """Add one launch of kernel `name`, to `LAUNCHES` and to the
    calling thread's tally."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        counts = getattr(_TALLY, "counts", None)
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1


def dense_block_counts() -> dict[str, int]:
    """(CUDA block, stored block) pairs that took the dense path since
    the last reset, per block kernel. Synchronizes with the device."""
    out = {"bsr_spmm": 0, "dia_spmm": 0}
    for (name, _), t in DENSE_BLOCKS.items():
        out[name] += int(t.item())
    return out


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# Zero blocks appended after the real ones, as the JAX package does for
# its chunked DMAs, so that the builders' arrays compare equal.
_DMA_CHUNK = 8


def _pad_chunk(cols: np.ndarray, vals: np.ndarray, tile: int):
    """Append _DMA_CHUNK zero blocks (never multiplied by the CUDA
    kernels)."""
    pad = _DMA_CHUNK
    cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
    vals = np.concatenate(
        [vals, np.zeros((pad, tile, tile), vals.dtype)])
    return cols, vals


@dataclasses.dataclass
class EntryLists:
    """The slots of a block structure that may hold a nonzero (edges of
    the support, or pattern slots of a learned adjacency), as the block
    kernels read them. Row r's entries are idx[ptr[r]:ptr[r + 1]] in the
    order the dense block loop sums them: by the block's position in
    its row tile's range, then by in-block column k."""

    ptr: torch.Tensor    # (n_pad + 1,) int32, per padded output row
    idx: torch.Tensor    # (entries,) int32: b * TB + k, b into the values
    mask: torch.Tensor   # (blocks, TB, ceil(TB / 32)) int32 bit patterns:
    #                      bit k % 32 of word k // 32 of row r of block b


def entry_lists(nonzero: np.ndarray, block_ptr: np.ndarray, n_pad: int,
                tile: int, device) -> EntryLists:
    """`EntryLists` of the entry slots `nonzero` (blocks, TB, TB) bool,
    in the value array's block order; the blocks of row tile i are
    block_ptr[i]:block_ptr[i + 1], and later (pad) blocks are empty."""
    block_ptr = np.asarray(block_ptr, np.int64)
    nb = nonzero.shape[0]
    if nonzero[block_ptr[-1]:].any():
        raise ValueError("a block outside the row tiles' ranges has entries")
    if nb * tile >= 2 ** 31:
        raise ValueError(f"{nb} blocks of {tile} overflow the int32 entries")
    b, r, k = np.nonzero(nonzero)           # sorted by (b, r, k)
    tile_of = np.repeat(np.arange(len(block_ptr) - 1), np.diff(block_ptr))
    row = tile_of[b] * tile + r
    order = np.argsort(row, kind="stable")  # (row, b, k): the dense order
    ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n_pad), out=ptr[1:])
    words = -(-tile // 32)
    bits = np.zeros((nb, tile, words * 32), bool)
    bits[..., :tile] = nonzero
    mask = np.packbits(bits, axis=-1, bitorder="little").view("<u4")
    dev = resolve_device(device)
    return EntryLists(
        ptr=torch.as_tensor(ptr.astype(np.int32), device=dev),
        idx=torch.as_tensor((b * tile + k)[order].astype(np.int32),
                            device=dev),
        mask=torch.as_tensor(mask.view(np.int32), device=dev))


def entry_mask_bits(mask: torch.Tensor, tile: int) -> torch.Tensor:
    """`EntryLists.mask` (blocks, TB, words) -> (blocks, TB, TB) bool."""
    k = torch.arange(tile, device=mask.device)
    words = mask[:, :, k // 32].long() & 0xFFFFFFFF
    return (words >> (k % 32)) & 1 == 1


@dataclasses.dataclass
class BlockCSR:
    """Block-compressed sparse row adjacency (padded to the tile grid).
    The builders fill `entries`; `bsr_spmm` on the card needs them."""

    block_ptr: torch.Tensor    # (row_tiles + 1,) int32
    block_cols: torch.Tensor   # (nnzb + 8,) int32
    block_vals: torch.Tensor   # (nnzb + 8, TB, TB) float32 | bfloat16
    n: int                     # logical node count
    n_pad: int                 # padded node count
    tile: int
    entries: EntryLists | None = None

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
            n=n, n_pad=n_pad, tile=tile,
            entries=entry_lists(blocks != 0, ptr, n_pad, tile, dev))

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


def _entries_plain(a: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """The block kernels' algorithm in plain PyTorch, for tests and
    checks: per (stored block, 64-wide feature tile), the entries' sum
    where the block is clean, the whole block's product where its values
    are nonzero outside its entries or its x tile (cast to the value
    dtype) holds a non-finite value."""
    n, f = x.shape
    tb, rt, e = a.tile, a.row_tiles, a.entries
    vals = a.block_vals
    xp = torch.zeros(a.n_pad, f, dtype=torch.float32, device=x.device)
    xp[:n] = x.to(vals.dtype).float()
    nft = -(-f // _BN)
    xf = torch.nn.functional.pad(xp, (0, nft * _BN - f))
    nonfin = (~torch.isfinite(xf.view(rt, tb, nft, _BN))).any(3).any(1)
    bad = ((vals != 0) & ~entry_mask_bits(e.mask, tb)).flatten(1).any(1)
    ptr = a.block_ptr.long()
    nb = int(ptr[-1])
    cols = a.block_cols[:nb].long()
    dense = bad[:nb, None] | nonfin[cols]                 # (nb, nft)
    dense_f = dense.repeat_interleave(_BN, 1)[:, :f]     # (nb, f)
    out = torch.zeros(a.n_pad, f, dtype=torch.float32, device=x.device)
    rows = torch.repeat_interleave(torch.arange(a.n_pad, device=x.device),
                                   e.ptr.long().diff())
    b, k = e.idx.long() // tb, e.idx.long() % tb
    v = vals[b, rows % tb, k].float()
    out.index_add_(0, rows, torch.where(dense_f[b], 0.0,
                                        v[:, None] * xp[cols[b] * tb + k]))
    db = dense.any(1).nonzero().squeeze(1)
    brow = torch.repeat_interleave(torch.arange(rt, device=x.device),
                                   ptr.diff())
    prod = torch.bmm(vals[db].float(), xp.view(rt, tb, f)[cols[db]])
    out.view(rt, tb, f).index_add_(
        0, brow[db], torch.where(dense_f[db][:, None], prod, 0.0))
    return out[:n].to(x.dtype)


def bsr_spmm_entries_plain(bcsr: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """`bsr_spmm`'s algorithm in plain PyTorch (tests and checks only)."""
    return _entries_plain(bcsr, x)


def _dense_counter(name: str, device: torch.device) -> torch.Tensor:
    with _COUNT_LOCK:
        t = DENSE_BLOCKS.get((name, device))
        if t is None:
            t = DENSE_BLOCKS[(name, device)] = torch.zeros(
                1, dtype=torch.int32, device=device)
        return t


def _block_kernel(name: str, a: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """Launch the entry point `name` (`bsr_spmm` or `dia_spmm`) of
    `csrc/block_spmm.cu` on the block-CSR structure `a` and CUDA x
    (n, F)."""
    _check_operand(x, a.n, a.tile)
    e = a.entries
    if e is None:
        raise ValueError(f"{name}: the structure has no entry lists; build "
                         "it with the BlockCSR or DIA builders")
    vals, ptr, cols = a.block_vals, a.block_ptr, a.block_cols
    _check_same_device(x, vals, ptr, cols, e.ptr, e.idx, e.mask)
    if any(t.dtype != torch.int32 for t in (ptr, cols, e.ptr, e.idx, e.mask)):
        raise TypeError("block_ptr, block_cols and the entry lists must be "
                        "int32")
    nb, tb = vals.shape[0], a.tile
    if ptr.shape != (a.row_tiles + 1,):
        raise ValueError(f"block_ptr shape {tuple(ptr.shape)}")
    if (vals.dim() != 3 or vals.shape[1:] != (tb, tb)
            or cols.shape != (nb,) or e.ptr.shape != (a.n_pad + 1,)
            or e.mask.shape != (nb, tb, -(-tb // 32))):
        raise ValueError(f"block_vals {tuple(vals.shape)}, block_cols "
                         f"{tuple(cols.shape)} and entry lists "
                         f"{tuple(e.ptr.shape)}, {tuple(e.mask.shape)} do "
                         "not fit the structure")
    if vals.data_ptr() % 16:
        raise ValueError("block values must be 16-byte aligned (the value "
                         "pass reads four at a time)")
    vcode = _dtype_code(vals, "block values")
    xcode = _dtype_code(x, "x")
    from gptst_tpu_torch.kernels.build import load

    lib = load("block_spmm")
    out = torch.empty_like(x)
    bad = torch.empty(nb, dtype=torch.int32, device=x.device)
    count = _dense_counter(name, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(
            ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            e.ptr.data_ptr(), e.idx.data_ptr(), e.mask.data_ptr(),
            bad.data_ptr(), count.data_ptr(), x.data_ptr(), out.data_ptr(),
            a.n, x.shape[1], a.row_tiles, nb, tb, vcode, xcode, stream)
    _raise_on(err, name)
    count_launch(name)
    return out


def bsr_spmm(bcsr: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ x for x (n, F), by the CUDA kernel `bsr_spmm`
    (`csrc/block_spmm.cu`); the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return bsr_spmm_plain(bcsr, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {x.device}")
    return _block_kernel("bsr_spmm", bcsr, x)


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


def _row_tiles(t: torch.Tensor, n_pad: int, tile: int) -> torch.Tensor:
    """(n, d) -> zero-padded (n_pad / tile, tile, d) f32 row tiles."""
    pad = torch.zeros(n_pad, t.shape[1], dtype=torch.float32, device=t.device)
    pad[: t.shape[0]] = t.float()
    return pad.view(n_pad // tile, tile, -1)


def spmm_dvals_plain(bcsr: BlockCSR, g: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """d block_vals[b] = dY[row tile b] @ X[col tile b]^T, with the pad
    blocks zero. g, x: (..., N, C). The products are summed in float64
    and rounded to f32 once: a reference for the kernel that is exact
    to f32, whatever order the kernel sums in (an f32 sum over F ~ 1000
    terms can be off by twice the kernels' tolerance)."""
    rt = bcsr.row_tiles
    ptr = bcsr.block_ptr.long()
    nb = int(ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(rt, device=g.device), ptr.diff())
    cols = bcsr.block_cols[:nb].long()
    gt, xt = (_row_tiles(_fold(t, bcsr.n), bcsr.n_pad, bcsr.tile)
              for t in (g, x))
    out = torch.zeros(bcsr.block_vals.shape, dtype=torch.float32,
                      device=g.device)
    out[:nb] = torch.bmm(gt[rows].double(),
                         xt[cols].transpose(1, 2).double()).float()
    return out


def spmm_dvals(bcsr: BlockCSR, g: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """d block_vals (nnzb + 8, TB, TB) f32 for g, x (..., N, C), by the
    CUDA kernel `csrc/spmm_dvals.cu`; the plain version for CPU
    tensors."""
    if g.device.type == "cpu":
        return spmm_dvals_plain(bcsr, g, x)
    if g.device.type != "cuda":
        raise ValueError(f"spmm_dvals: unsupported device {g.device}")
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} differ")
    gf, xf = _fold(g, bcsr.n), _fold(x, bcsr.n)
    if bcsr.tile not in _TILES:
        raise ValueError(f"tile {bcsr.tile} not in {_TILES}")
    vals, ptr, cols = bcsr.block_vals, bcsr.block_ptr, bcsr.block_cols
    _check_same_device(gf, xf, ptr, cols)
    if ptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("block_ptr and block_cols must be int32")
    if (ptr.shape != (bcsr.row_tiles + 1,) or vals.dim() != 3
            or vals.shape[1:] != (bcsr.tile, bcsr.tile)
            or cols.shape != vals.shape[:1]):
        raise ValueError(f"block_ptr {tuple(ptr.shape)}, block_cols "
                         f"{tuple(cols.shape)} and block_vals "
                         f"{tuple(vals.shape)} do not fit the structure")
    gcode = _dtype_code(gf, "g")
    xcode = _dtype_code(xf, "x")
    from gptst_tpu_torch.kernels.build import load

    lib = load("spmm_dvals")
    out = torch.empty(vals.shape, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.spmm_dvals(
            ptr.data_ptr(), cols.data_ptr(), gf.data_ptr(), xf.data_ptr(),
            out.data_ptr(), bcsr.n, gf.shape[1], bcsr.row_tiles,
            vals.shape[0], bcsr.tile, gcode, xcode, stream)
    _raise_on(err, "spmm_dvals")
    count_launch("spmm_dvals")
    return out


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
    """Tile-diagonal band storage: vals[i, d] is block (i, i + d - w).

    `block_ptr` and `block_cols` give its block-CSR view (`blocks`):
    2w + 1 blocks per row tile, the column tile clamped to the grid.
    The clamped blocks at the ends of the band are structurally zero
    and have no entries, but are multiplied all the same, as in the JAX
    package."""

    vals: torch.Tensor   # (row_tiles, 2w+1, TB, TB)
    w: int               # half-bandwidth in tiles
    n: int
    n_pad: int
    tile: int
    block_ptr: torch.Tensor    # (row_tiles + 1,) int32: i * (2w + 1)
    block_cols: torch.Tensor   # (row_tiles * (2w+1),) int32
    entries: EntryLists

    @property
    def row_tiles(self) -> int:
        return self.n_pad // self.tile

    def blocks(self) -> BlockCSR:
        """The band as a `BlockCSR` over the same values (no copy)."""
        tb = self.tile
        return BlockCSR(self.block_ptr, self.block_cols,
                        self.vals.view(-1, tb, tb), self.n, self.n_pad, tb,
                        self.entries)


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
    nd = 2 * w + 1
    i = np.arange(rt)
    ptr = np.arange(rt + 1) * nd
    bcols = np.clip(i[:, None] + np.arange(nd) - w, 0, rt - 1).reshape(-1)

    def band(dense):
        return DIABand(
            torch.as_tensor(dense, device=dev).to(vals_dtype), w, n, n_pad,
            tile, torch.as_tensor(ptr.astype(np.int32), device=dev),
            torch.as_tensor(bcols.astype(np.int32), device=dev),
            entry_lists(dense.reshape(rt * nd, tile, tile) != 0, ptr, n_pad,
                        tile, dev))

    dense = np.zeros((rt, nd, tile, tile), np.float32)
    np.add.at(dense, (br, d + w, rows % tile, cols % tile),
              vals.astype(np.float32))
    a = band(dense)
    # A^T: block (i, i+d-w)^T lands at row i+d-w, diagonal -d
    dense_t = np.zeros_like(dense)
    for dd in range(2 * w + 1):
        off = dd - w
        src = dense[:, dd].transpose(0, 2, 1)   # (rt, TB, TB)
        if off >= 0:
            dense_t[off:rt, 2 * w - dd][: rt - off] = src[: rt - off]
        else:
            dense_t[: rt + off, 2 * w - dd] = src[-off:]
    return a, band(dense_t)


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


def dia_spmm_entries_plain(dia: DIABand, x: torch.Tensor) -> torch.Tensor:
    """`dia_spmm`'s algorithm in plain PyTorch (tests and checks only)."""
    return _entries_plain(dia.blocks(), x)


def dia_spmm(dia: DIABand, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ x for x (n, F), by the CUDA kernel `dia_spmm`
    (`csrc/block_spmm.cu`) on the band's block-CSR view; the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return dia_spmm_plain(dia, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm: unsupported device {x.device}")
    if dia.vals.shape != (dia.row_tiles, 2 * dia.w + 1, dia.tile, dia.tile):
        raise ValueError(f"band vals shape {tuple(dia.vals.shape)}")
    return _block_kernel("dia_spmm", dia.blocks(), x)


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
