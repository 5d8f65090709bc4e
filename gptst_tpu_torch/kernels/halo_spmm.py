"""Fused ring SpMM over the mesh's 'graph' axis.

The hand-written counterpart of the ring collective matmul
(`parallel/halo.make_ring_spmm`): nodes are block-partitioned over P
ranks; rank p holds its adjacency rows split by source shard, rotated
so that block s is the one it multiplies at ring step s, and its x
shard. Each step multiplies the resident shard while the next one is
passed in, P steps in all:

  step s: rank p copies its resident shard (buffer slot s % 2) into
          slot (s + 1) % 2 of its left neighbour, and meanwhile runs
          acc_p (+)= A_rot[p][:, s] . buf_p[s % 2]   (`csrc/ring_spmm.cu`)

On CUDA ranks the buffers hold x^T shards, (F, K) with K = n_loc
rounded up to 4 (the tensor-core kernel reads both operands K-major),
written by the copy of each shard into slot 0; the peer copies move
them as they are.

The TPU kernel (`gptst_tpu/kernels/halo_spmm.py:_ring_kernel`) runs the
whole ring inside one kernel per device, with RDMA and semaphores. On
CUDA ranks here the block product is the kernel (`ring_spmm`, P launches
per rank, P^2 per call, counted in `LAUNCHES["ring_spmm"]`), each rank
has a compute stream and a copy stream, the copies are peer copies
(`ring_copy`), and CUDA events play the semaphores:

  * recv — rank p's slot s % 2 has arrived: the copy of step s - 1 from
    its right neighbour. Step s's kernel and copy on p wait for it.
  * free — the left neighbour's step s - 1 kernel, which read the slot
    p's copy of step s overwrites, has finished.
  * send — the left neighbour's own outgoing copy of step s - 1, which
    read that slot too, has finished. It runs on another stream than
    p's copy, so the stream order does not cover it.

The streams, buffers, accumulators and events are made once per
`make_fused_ring_spmm` and reused by every call (`_RingState`); a call
writes a rank's buffer only after the last call's kernels and copies of
that rank. Memory used on the side streams is marked with
`record_stream`, so the caching allocator does not hand it out while a
copy or kernel still runs; the caller's current stream waits on every
rank's last event (no host synchronize), so the result is ordered on it.
`cudaStreamWaitEvent` works across cards, and every event is recorded
on a stream of the card whose work it marks: the same code runs P ranks
on one card or on P cards.

On CPU ranks `ring_spmm_plain` runs the same schedule in torch ops. The
function is forward only, as the TPU kernel has no VJP.
"""

from __future__ import annotations

import numpy as np
import torch

from gptst_tpu_torch.kernels.spmm import _raise_on, count_launch
from gptst_tpu_torch.parallel.halo import partition_adjacency
from gptst_tpu_torch.parallel.mesh import GRAPH_AXIS, Mesh

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _rotate_blocks(blocks: np.ndarray) -> np.ndarray:
    """(P, n_loc, P, n_loc) dest-major blocks -> ring order: rank p's
    s-th block is A[p, :, (p+s) % P, :]."""
    parts = blocks.shape[0]
    out = np.empty_like(blocks)
    for p in range(parts):
        for s in range(parts):
            out[p, :, s, :] = blocks[p, :, (p + s) % parts, :]
    return out


def _ring_k(n_loc: int) -> int:
    """The kernel's inner dimension: n_loc rounded up to 4, so that every
    row of the blocks and of the transposed buffers is 16-byte aligned."""
    return -(-n_loc // 4) * 4


def _pad_blocks(blocks: np.ndarray) -> np.ndarray:
    """(P, n_loc, P, n_loc) ring-ordered blocks -> (P, n_loc, P, K) with
    zero columns past n_loc: the CUDA ranks' layout."""
    n_loc = blocks.shape[1]
    out = np.zeros((*blocks.shape[:3], _ring_k(n_loc)), np.float32)
    out[..., :n_loc] = blocks
    return out


def ring_spmm_plain(a_rot: list[torch.Tensor],
                    xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ring schedule in torch ops: a_rot[p] (n_loc, P, n_loc) f32,
    xs[p] (n_loc, F), each on rank p's device; returns the P output
    shards in x's dtype, summed in f32."""
    parts = len(xs)
    bufs = [x.float() for x in xs]
    accs = [None] * parts
    for s in range(parts):
        for p in range(parts):
            prod = torch.matmul(a_rot[p][:, s], bufs[p])
            accs[p] = prod if s == 0 else accs[p] + prod
        if s < parts - 1:
            bufs = [bufs[(p + 1) % parts].to(xs[p].device)
                    for p in range(parts)]
    return [acc.to(x.dtype) for acc, x in zip(accs, xs)]


def ring_step(lib, a_rot: torch.Tensor, s: int, buf: torch.Tensor,
              acc: torch.Tensor | None, out: torch.Tensor | None,
              stream) -> None:
    """Launch the kernel of ring step `s` of one rank on `stream`:
    acc (+)= a_rot[:, s] . buf^T (step 0 writes), or, with `out`, the
    sum into out in its dtype. a_rot (n_loc, P, K) f32 and buf (F, K)
    f32 (an x^T shard), K = n_loc rounded up to 4, their columns past
    n_loc zero (`_pad_blocks`); acc (n_loc, F) f32, out (n_loc, F) f32 or
    bf16; all contiguous on the stream's card. Unchecked: `_ring_cuda`
    checks the operands once per call and owns every buffer."""
    n_loc, parts, k = a_rot.shape
    err = lib.ring_spmm(
        a_rot.data_ptr() + s * k * a_rot.element_size(), parts * k,
        buf.data_ptr(), acc.data_ptr() if acc is not None else None,
        out.data_ptr() if out is not None else None,
        n_loc, buf.shape[0], int(s > 0),
        int(out is not None and out.dtype == torch.bfloat16),
        stream.cuda_stream)
    _raise_on(err, "ring_spmm")
    count_launch("ring_spmm")


class _RingState:
    """What every call of one fused ring reuses: the library, each rank's
    compute and copy streams, its double buffer of x^T shards, (2, F, K)
    f32 with K = n_loc rounded up to 4 and zero columns past n_loc, its
    (n_loc, F) f32 accumulator, and the events of the schedule. Before a
    call writes a rank's buffer, the caller's stream waits for the last
    call's kernels and copies of that rank (`done`): the caller may be
    another stream than the last call's."""

    def __init__(self, lib, devs: list[torch.device], n_loc: int,
                 feat: int, comp: list, copy: list):
        parts = len(devs)
        self.lib, self.devs, self.comp, self.copy = lib, devs, comp, copy
        self.bufs, self.accs = [], []
        for p, d in enumerate(devs):
            buf = torch.zeros((2, feat, _ring_k(n_loc)),
                              dtype=torch.float32, device=d)
            acc = (torch.empty((n_loc, feat), dtype=torch.float32, device=d)
                   if parts > 1 else None)
            # freed only when every queued kernel and copy has finished
            for t in (buf, acc):
                if t is not None:
                    t.record_stream(comp[p])
                    t.record_stream(copy[p])
                    t.record_stream(copy[(p + 1) % parts])
            self.bufs.append(buf)
            self.accs.append(acc)

        def events(n):
            return [[torch.cuda.Event() for _ in range(n)]
                    for _ in range(parts)]

        self.ready = [torch.cuda.Event() for _ in range(parts)]
        self.kern = events(parts)                  # [rank][step]
        self.sent = events(max(parts - 1, 1))      # [rank][step]
        self.done = events(2)      # [rank][compute, copy] of the last call
        self.called = False


def _ring_cuda(a_rot: list[torch.Tensor], xs: list[torch.Tensor],
               st: _RingState) -> list[torch.Tensor]:
    """The ring on CUDA ranks: P^2 kernel launches and P(P-1) copies,
    ordered by events (see the module docstring). The operands are
    checked by the caller."""
    parts = len(xs)
    devs, comp, copy, bufs, accs = st.devs, st.comp, st.copy, st.bufs, st.accs
    kern, sent = st.kern, st.sent
    callers = [torch.cuda.current_stream(d) for d in devs]
    outs = []
    for p in range(parts):
        with torch.cuda.device(devs[p]):
            if st.called:
                # the last call's kernels on p (which waited for the
                # copies into its buffer) and p's copies out of it
                callers[p].wait_event(st.done[p][0])
                callers[p].wait_event(st.done[p][1])
            bufs[p][0, :, :xs[p].shape[0]].copy_(xs[p].t())
            outs.append(torch.empty_like(xs[p]))
            st.ready[p].record(callers[p])
    for p in range(parts):
        comp[p].wait_event(st.ready[p])
        copy[p].wait_event(st.ready[p])
        copy[p].wait_event(st.ready[(p - 1) % parts])   # writes into left
    nbytes = bufs[0][0].numel() * 4
    for s in range(parts):
        slot, nxt = s % 2, (s + 1) % 2
        for p in range(parts):
            with torch.cuda.device(devs[p]):
                if s > 0:
                    comp[p].wait_event(sent[(p + 1) % parts][s - 1])  # recv
                ring_step(st.lib, a_rot[p], s, bufs[p][slot], accs[p],
                          outs[p] if s == parts - 1 else None, comp[p])
                kern[p][s].record(comp[p])
        if s == parts - 1:
            break
        for p in range(parts):
            left = (p - 1) % parts
            if s > 0:
                copy[p].wait_event(sent[(p + 1) % parts][s - 1])    # recv
                copy[p].wait_event(kern[left][s - 1])               # free
                copy[p].wait_event(sent[left][s - 1])               # send
            with torch.cuda.device(devs[p]):
                err = st.lib.ring_copy(bufs[left][nxt].data_ptr(),
                                       devs[left].index,
                                       bufs[p][slot].data_ptr(),
                                       devs[p].index, nbytes,
                                       copy[p].cuda_stream)
            _raise_on(err, "ring_copy")
            sent[p][s].record(copy[p])
    for p in range(parts):
        st.done[p][0].record(comp[p])
        st.done[p][1].record(copy[p])
        callers[p].wait_event(kern[p][parts - 1])
        outs[p].record_stream(comp[p])
    st.called = True
    return outs


def make_fused_ring_spmm(mesh: Mesh, adj: np.ndarray, feat: int,
                         row: int = 0):
    """Build the fused ring `A @ x` over the 'graph' axis of data row
    `row` of the mesh.

    Returns (fn, n_pad): fn takes a list of P row shards, shard p
    (n_pad / P, feat) f32 or bf16 on rank p's device, and returns the P
    output shards of A_pad @ x_pad in the same layout and dtype. CUDA
    ranks run the kernel; CPU ranks the plain version. Forward only.
    """
    parts = mesh.shape[GRAPH_AXIS]
    devs = mesh.graph_devices(row)
    blocks = _rotate_blocks(partition_adjacency(adj, parts))
    n_loc = blocks.shape[1]
    on_cuda = devs[0].type == "cuda"
    if on_cuda:
        blocks = _pad_blocks(blocks)
    a_rot = [torch.as_tensor(blocks[p]).to(devs[p]) for p in range(parts)]
    del blocks
    if on_cuda:
        from gptst_tpu_torch.kernels.build import load

        state = _RingState(load("ring_spmm"), devs, n_loc, feat,
                           [torch.cuda.Stream(d) for d in devs],
                           [torch.cuda.Stream(d) for d in devs])

    def fn(xs: list[torch.Tensor]) -> list[torch.Tensor]:
        if len(xs) != parts:
            raise ValueError(f"{len(xs)} shards for {parts} ranks")
        for x, d in zip(xs, devs):
            if x.shape != (n_loc, feat):
                raise ValueError(f"shard must be (n_loc={n_loc}, "
                                 f"feat={feat}), got {tuple(x.shape)}")
            if x.device != d:
                raise ValueError(f"shard on {x.device}, its rank on {d}")
            if x.dtype not in _OUT_DTYPES:
                raise TypeError(f"x must be float32 or bfloat16, got "
                                f"{x.dtype}")
        if not on_cuda:
            return ring_spmm_plain(a_rot, xs)
        if not all(x.is_contiguous() for x in xs):
            raise ValueError("shards must be contiguous")
        return _ring_cuda(a_rot, xs, state)

    return fn, n_loc * parts
