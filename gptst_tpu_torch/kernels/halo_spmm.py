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

Buffers used on the side streams are marked with `record_stream`, so
the caching allocator does not hand their memory out while a copy or
kernel still runs; the caller's current stream waits on every rank's
last event (no host synchronize), so the result is ordered on it.
`cudaStreamWaitEvent` works across cards, and every event is recorded
on a stream of the card whose work it marks: the same code runs P ranks
on one card or on P cards.

On CPU ranks `ring_spmm_plain` runs the same schedule in torch ops. The
function is forward only, as the TPU kernel has no VJP.
"""

from __future__ import annotations

import numpy as np
import torch

from gptst_tpu_torch.kernels.spmm import LAUNCHES, _raise_on
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


def ring_step(a_rot: torch.Tensor, s: int, buf: torch.Tensor,
              acc: torch.Tensor | None, out: torch.Tensor | None) -> None:
    """Launch the kernel of ring step `s` of one rank on the current
    stream of its card: acc (+)= a_rot[:, s] . buf (step 0 writes), or,
    with `out`, the sum into out in its dtype. a_rot (n_loc, P, n_loc)
    f32, buf and acc (n_loc, F) f32, out (n_loc, F) f32 or bf16; all
    contiguous on one CUDA device."""
    if a_rot.dim() != 3 or a_rot.shape[0] != a_rot.shape[2]:
        raise ValueError(f"a_rot must be (n_loc, P, n_loc), got "
                         f"{tuple(a_rot.shape)}")
    n_loc, parts = a_rot.shape[0], a_rot.shape[1]
    if not 0 <= s < parts:
        raise ValueError(f"step {s} outside [0, {parts})")
    if buf.dim() != 2 or buf.shape[0] != n_loc or buf.shape[1] == 0:
        raise ValueError(f"buf must be (n_loc={n_loc}, F), got "
                         f"{tuple(buf.shape)}")
    f = buf.shape[1]
    ts = [t for t in (a_rot, buf, acc, out) if t is not None]
    for t in ts:
        if t.device != buf.device or t.device.type != "cuda":
            raise ValueError(f"ring_step: operand on {t.device}, buf on "
                             f"{buf.device}; all must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("ring_step operands must be contiguous")
    for t, what in ((a_rot, "a_rot"), (buf, "buf"), (acc, "acc")):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {t.dtype}")
    for t, what in ((acc, "acc"), (out, "out")):
        if t is not None and t.shape != buf.shape:
            raise ValueError(f"{what} shape {tuple(t.shape)} differs from "
                             f"buf {tuple(buf.shape)}")
    if out is not None and out.dtype not in _OUT_DTYPES:
        raise TypeError(f"out must be float32 or bfloat16, got {out.dtype}")
    if acc is None and (s > 0 or out is None):
        raise ValueError("acc is needed unless step 0 writes out")
    from gptst_tpu_torch.kernels.build import load

    lib = load("ring_spmm")
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.ring_spmm(
            a_rot.data_ptr() + s * n_loc * a_rot.element_size(),
            parts * n_loc, buf.data_ptr(),
            acc.data_ptr() if acc is not None else None,
            out.data_ptr() if out is not None else None,
            n_loc, f, int(s > 0), int(out is not None
                                      and out.dtype == torch.bfloat16),
            stream)
    _raise_on(err, "ring_spmm")
    LAUNCHES["ring_spmm"] += 1


def _ring_cuda(a_rot: list[torch.Tensor], xs: list[torch.Tensor],
               comp: list[torch.cuda.Stream],
               copy: list[torch.cuda.Stream]) -> list[torch.Tensor]:
    """The ring on CUDA ranks: P^2 kernel launches and P(P-1) copies,
    ordered by events (see the module docstring)."""
    from gptst_tpu_torch.kernels.build import load

    lib = load("ring_spmm")
    parts = len(xs)
    devs = [x.device for x in xs]
    callers = [torch.cuda.current_stream(d) for d in devs]
    bufs, accs, outs, ready = [], [], [], []
    for p in range(parts):
        with torch.cuda.device(devs[p]):
            buf = torch.empty((2, *xs[p].shape), dtype=torch.float32,
                              device=devs[p])
            buf[0].copy_(xs[p])
            bufs.append(buf)
            accs.append(torch.empty_like(buf[0]) if parts > 1 else None)
            outs.append(torch.empty_like(xs[p]))
            ev = torch.cuda.Event()
            ev.record(callers[p])
            ready.append(ev)
    for p in range(parts):
        comp[p].wait_event(ready[p])
        copy[p].wait_event(ready[p])
        copy[p].wait_event(ready[(p - 1) % parts])   # writes into left
    nbytes = bufs[0][0].numel() * 4
    kern = [[None] * parts for _ in range(parts)]   # [rank][step]
    sent = [[None] * parts for _ in range(parts)]   # [rank][step]
    for s in range(parts):
        slot, nxt = s % 2, (s + 1) % 2
        for p in range(parts):
            if s > 0:
                comp[p].wait_event(sent[(p + 1) % parts][s - 1])    # recv
            with torch.cuda.stream(comp[p]):
                ring_step(a_rot[p], s, bufs[p][slot], accs[p],
                          outs[p] if s == parts - 1 else None)
            kern[p][s] = torch.cuda.Event()
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
                err = lib.ring_copy(bufs[left][nxt].data_ptr(),
                                    devs[left].index,
                                    bufs[p][slot].data_ptr(), devs[p].index,
                                    nbytes, copy[p].cuda_stream)
            _raise_on(err, "ring_copy")
            sent[p][s] = torch.cuda.Event()
            sent[p][s].record(copy[p])
    for p in range(parts):
        callers[p].wait_event(kern[p][parts - 1])
        for t in (bufs[p], accs[p], outs[p]):
            if t is not None:
                t.record_stream(comp[p])
                t.record_stream(copy[(p + 1) % parts])    # writes into p
                t.record_stream(copy[p])                  # reads from p
    return outs


def make_fused_ring_spmm(mesh: Mesh, adj: np.ndarray, feat: int):
    """Build the fused ring `A @ x` over the mesh's 'graph' axis.

    Returns (fn, n_pad): fn takes a list of P row shards, shard p
    (n_pad / P, feat) f32 or bf16 on rank p's device, and returns the P
    output shards of A_pad @ x_pad in the same layout and dtype. CUDA
    ranks run the kernel; CPU ranks the plain version. Forward only.
    """
    parts = mesh.shape[GRAPH_AXIS]
    devs = mesh.graph_devices
    blocks = _rotate_blocks(partition_adjacency(adj, parts))
    n_loc = blocks.shape[1]
    a_rot = [torch.as_tensor(blocks[p]).to(devs[p]) for p in range(parts)]
    on_cuda = devs[0].type == "cuda"
    streams: dict[str, list] = {}

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
        if not streams:
            streams["comp"] = [torch.cuda.Stream(d) for d in devs]
            streams["copy"] = [torch.cuda.Stream(d) for d in devs]
        return _ring_cuda(a_rot, xs, streams["comp"], streams["copy"])

    return fn, n_loc * parts
