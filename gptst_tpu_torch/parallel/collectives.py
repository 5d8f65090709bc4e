"""The collectives of a data axis that spans processes.

With one process per card (or per host, `core/distributed.py`) the
processes of a training run meet over `torch.distributed`'s default
process group, in program order, as XLA's collectives do under GSPMD:

  * `all_reduce_sum` — a differentiable SUM over processes whose
    backward is the SUM of the gradients (every process uses the total);
    the backward's reduces run in the reverse order of the forward's on
    every process, whatever the autograd engine's scheduling
    (`AllReduceChain`);
  * `gather_batch` — the processes' batch slices concatenated in
    process order; its backward keeps this process's slice;
  * `all_gather_cat`, `broadcast_floats`, `any_process` and
    `reduce_gradients` (one flat bucket of gradients, summed), with no
    gradient.

NCCL takes CUDA tensors; gloo takes CPU tensors and, for these
collectives, CUDA tensors too (it copies them through host memory
itself), so two processes can share one card over gloo.

The collectives a train step reaches (`all_reduce_sum_`,
`all_gather_cat`, `reduce_gradients`, `all_reduce_sum`, `gather_batch`)
read nothing back to the host and size every buffer from the shapes of
their inputs alone, so over NCCL a train step that calls them is
captured in a CUDA graph and replayed (`train/step.StepGraph`): each
replay runs the same collectives on the same buffers, in the same
order on every process. `broadcast_floats`, `any_process` and
`barrier` read or wait on the host and run only between steps.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) without
    a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """The SUM over processes of t (a new tensor), no gradient."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every process's t (the same shape) concatenated on axis 0 in
    process order, no gradient: one all-gather into one buffer."""
    t = t.contiguous()
    out = t.new_empty((world()[1] * t.shape[0], *t.shape[1:]))
    # `all_gather_single` is the newer name of the same collective
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, t)
    return out


def broadcast_floats(values: Sequence[float],
                     device: torch.device) -> list[float]:
    """Rank 0's `values` on every process (float64)."""
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return t.tolist()


def any_process(flag: bool, device: torch.device) -> bool:
    """Whether `flag` holds on any process (a read on the host: between
    steps only)."""
    t = torch.tensor([float(flag)], dtype=torch.float64, device=device)
    return bool(all_reduce_sum_(t).item() > 0)


def barrier() -> None:
    """Every process waits here for the others (no-op alone)."""
    if world()[1] > 1:
        dist.barrier()


def reduce_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over processes in place, as one
    flat bucket (the exact gradient of a loss that every process
    computes whole from its own rows' share: no division). Parameters
    with no gradient are left out; every process has the same ones."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


class AllReduceChain(torch.autograd.Function):
    """(SUM over processes of t, a token): the token of the previous
    reduce goes in, so the backward of reduce k runs only after that of
    reduce k + 1, on every process in the same order."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, token):
        return all_reduce_sum_(t), t.new_zeros(())

    @staticmethod
    def backward(ctx, grad, _token_grad):
        return all_reduce_sum_(grad), None


def all_reduce_sum(t: torch.Tensor, token=None):
    """(SUM over processes of t, the token for the next reduce);
    differentiable."""
    return AllReduceChain.apply(t, token)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor):
        ctx.rank, ctx.n = world()[0], t.shape[0]
        return all_gather_cat(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.rank * ctx.n, ctx.n)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """Every process's batch slice (the same shape) concatenated in
    process order; the backward keeps this process's slice (each
    process adds its own rows' gradients, `reduce_gradients` sums
    them)."""
    return _GatherBatch.apply(t)
