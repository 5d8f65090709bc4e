"""Data-parallel training over the mesh's 'data' axis.

The JAX package jits the one-device train step over a mesh and lets
GSPMD split the batch over 'data' and insert the gradient all-reduce
(`gptst_tpu/parallel/spmd.py`). The port writes that step out, in one
process:

  * the parameters live once, on `mesh.root`;
  * the batch is split over the data rows (`parallel/mesh.shard_batch`:
    row r's slice on its first device, or the whole ragged batch on row
    0), and each row runs the forward of its slice on its own devices,
    one host thread per row (as `torch.nn.parallel.parallel_apply`
    does), reading the parameters through `.to(row device)` where the
    row lies on another device (`torch.func.functional_call` on a copy
    of the model whose graph operands are on that device);
  * where the one-device math couples the batch (batch statistics, the
    generator's draws, GPT-ST's mask), the rows meet in
    `parallel/rows.py`;
  * the rows' outputs are gathered on the root in batch order, and the
    loss is the one-device loss of the gathered output (the masked
    losses' sums over the global batch's kept entries);
  * one `backward()` sums every row's gradient into the root's
    parameters (the all-reduce over 'data'), and the optimizer,
    gradient clipping included, runs once.

So the step's numbers are the one-device step's, up to the order of f32
sums. With a graph axis above 1 each row's aggregation runs on its own
graph ranks (`ops/graph_conv.ShardedSupport.fn_of_row`), and so does
each row's GPT-ST (`models/gptst.py`): its ranks read the parameters
of the row's module through `.to(rank device)`, so a row needs a copy
of the model only on its first device, and autograd carries every
rank's gradient back through the row's copy to the root.

Where the mesh's 'data' axis spans processes (`core/distributed.py`:
one process per card or host, each with its own copy of the
parameters and optimizer), each process runs its rows' slices of the
global batch as above, the rows meet across processes as well
(`parallel/rows.py`), and the rows' outputs are all-gathered in global
batch order (`parallel/collectives.gather_batch`), so every process
computes the same global loss; the gather's backward keeps this
process's slice. After the one `backward()`, `reduce_gradients` sums
the gradients over processes (one flat bucket; the exact gradient, no
division), and the optimizer, clipping included, runs on every
process, so the parameters stay equal everywhere. A ragged batch runs
whole on every process's first row and its gradient is not summed.
With one data row in this process the row runs in the calling thread,
with no thread pool and no wait at its meetings, so over NCCL the whole
step, collectives included, is captured in a CUDA graph
(`train/step.StepGraph`).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from gptst_tpu_torch.parallel import collectives
from gptst_tpu_torch.parallel.mesh import Mesh, batch_spec, shard_batch
from gptst_tpu_torch.parallel.rows import RowGroup, RowReleased, row_scope


def _tensors_in(obj, seen: set) -> list[torch.Tensor]:
    """The tensors a plain attribute holds: in tuples, lists, dicts and
    dataclasses (a graph support), not in modules."""
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        items = obj
    elif isinstance(obj, dict):
        items = obj.values()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for item in items for t in _tensors_in(item, seen)]


def replicate(model: nn.Module, device: torch.device) -> nn.Module:
    """A copy of `model` on `device`: its parameters, buffers and the
    graph operands its modules hold as plain attributes (supports,
    Chebyshev stacks) copied there once. A sharded support is shared:
    it runs on the graph ranks of the row that calls it."""
    memo: dict[int, Any] = {}
    for p in model.parameters():
        memo[id(p)] = nn.Parameter(p.detach().to(device),
                                   requires_grad=p.requires_grad)
    seen: set = set()
    for m in model.modules():
        for name, value in vars(m).items():
            if not name.startswith("_") and not isinstance(value, nn.Module):
                for t in _tensors_in(value, seen):
                    memo.setdefault(id(t), t.to(device))
    return copy.deepcopy(model, memo).to(device)


def _device_scope(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Rows(nn.Module):
    """The model and its copies on the other row devices, so that one
    `functional_call` swaps the parameters of all of them at once (the
    rows then run the swapped modules concurrently)."""

    def __init__(self, model: nn.Module, copies: dict[str, nn.Module]):
        super().__init__()
        self.model = model
        self.copies = nn.ModuleDict(copies)

    def forward(self, run: Callable[["_Rows"], Any]):
        return run(self)


def _gather(outs: list, root: torch.device, processes: bool = False):
    """Row outputs (`ModelOutput`s) concatenated on the batch axis on
    the root, field by field; with `processes`, every process's in
    process order."""
    if len(outs) == 1 and not processes:
        return outs[0]
    fields = []
    for vals in zip(*outs):
        if vals[0] is None:
            fields.append(None)
            continue
        t = torch.cat([v.to(root) for v in vals])
        fields.append(collectives.gather_batch(t) if processes else t)
    return type(outs[0])(*fields)


class DataParallel:
    """The forward of `model` (a `ModelOutput` module whose parameters
    lie on `mesh.root`) over the mesh's data rows:
    `dp(x, params=None, **kw)` splits x and a tensor `y` in `kw` with
    `shard_batch`, runs each row's slice on its devices and returns the
    gathered `ModelOutput` on the root (the global batch's, when the
    data axis spans processes). `params`, by name, replaces the model's
    parameters (the train step's bf16 cast of them,
    `train/step.model_forwards`). After a backward through its output,
    `reduce_gradients()` sums the gradients over processes."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.model, self.mesh = model, mesh
        self.devices = mesh.row_devices
        self.copies = {str(d): replicate(model, d)
                       for d in dict.fromkeys(self.devices)
                       if d != mesh.root}
        self.rows = _Rows(model, self.copies)
        self.pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=len(self.devices), thread_name_prefix="data-row")
            if len(self.devices) > 1 else None)
        # whether the last call split its batch over processes
        self.across = False

    def reduce_gradients(self) -> None:
        """Sum the model's gradients over processes, where the last call
        split its batch over them (a ragged batch ran whole on every
        process: its gradient is already the batch's)."""
        if self.across:
            collectives.reduce_gradients(list(self.model.parameters()))

    def _module(self, rows: _Rows, device: torch.device) -> nn.Module:
        return (rows.model if device == self.mesh.root
                else rows.copies[str(device)])

    def _params(self, params: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        """`params` of the model as each module of `_Rows` reads them,
        by name."""
        out = {f"model.{k}": p for k, p in params.items()}
        for key in self.copies:
            dev = torch.device(key)
            out.update({f"copies.{key}.{k}": p.to(dev)
                        for k, p in params.items()})
        return out

    def __call__(self, x: torch.Tensor,
                 params: dict[str, torch.Tensor] | None = None, **kw):
        xs = shard_batch(x, self.mesh)
        y = kw.pop("y", None)
        ys = ([None] * len(xs) if y is None else shard_batch(y, self.mesh))
        devices = self.devices[:len(xs)]
        grad = torch.is_grad_enabled()
        threads = torch.get_num_threads()
        across = self.across = (self.mesh.processes > 1 and batch_spec(
            x.shape, self.mesh)[0] is not None)
        group = (RowGroup(len(xs), self.mesh.processes,
                          self.mesh.data_offset // self.mesh.local_rows)
                 if across else RowGroup(len(xs)))

        def row(rows: _Rows, r: int):
            module = self._module(rows, devices[r])
            torch.set_num_threads(threads)    # a new thread's default
            try:
                with torch.set_grad_enabled(grad), \
                        _device_scope(devices[r]), row_scope(group, r):
                    return module(xs[r], y=ys[r], **kw)
            except BaseException:
                group.fail()
                raise

        def run(rows: _Rows) -> list:
            if len(xs) == 1 and not across:     # the whole batch on row 0
                return [self._module(rows, devices[0])(xs[0], y=ys[0],
                                                       **kw)]
            if len(xs) == 1:          # one row here, meeting the others'
                return [row(rows, 0)]
            futures = [self.pool.submit(row, rows, r)
                       for r in range(len(xs))]
            errors = [e for e in (f.exception() for f in futures) if e]
            if errors:    # the failing row's error, not a released row's
                raise next((e for e in errors
                            if not isinstance(e, RowReleased)), errors[0])
            return [f.result() for f in futures]

        if params is not None or self.copies:
            params = (dict(self.model.named_parameters()) if params is None
                      else params)
            outs = functional_call(self.rows, self._params(params), (run,))
        else:
            outs = run(self.rows)
        return _gather(outs, self.mesh.root, across)


def make_spmd_train_state(cfg, mesh: Mesh, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          data_mean: float = 0.0, data_std: float = 1.0
                          ) -> tuple[nn.Module, torch.optim.Optimizer,
                                     Callable]:
    """Place the parameters on the mesh (`shard_params`: whole, on the
    root) and build the data-parallel train step; `optimizer` is over
    `model.parameters()`. Returns (model, optimizer, step) where
    step(x, y, generator=None, epoch=None, step_count=None) -> (total,
    flow) takes one optimizer step on the whole batch, split over the
    data rows (the JAX package's step(params, opt_state, x, y, rng,
    epoch, step_count), its state held by the module and the
    optimizer)."""
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import (
        make_loss_terms, model_forwards, train_step,
    )

    loss_fn = build_loss(cfg.loss_func, data_mean, data_std,
                         cfg.mape_thresh, cfg.mode == "pretrain")
    _, forward = model_forwards(model, cfg, mesh)
    loss_terms = make_loss_terms(model, loss_fn, cfg, forward=forward)

    def step(x, y, generator: Optional[torch.Generator] = None,
             epoch: Optional[int] = None, step_count=None):
        kw = {"generator": generator}
        if cfg.mode == "pretrain":
            kw["epoch"] = epoch
        return train_step(loss_terms, optimizer, x, y, step_count, **kw)

    return model, optimizer, step


def run_one_step(cfg, mesh: Mesh, model: nn.Module, x, y,
                 seed: int = 0) -> tuple[float, float]:
    """Convenience: one Adam step (`cfg.lr_init`, no clipping) under the
    mesh at epoch 1, the generator seeded `seed` on the root; returns
    the losses. The model's parameters are updated in place."""
    from gptst_tpu_torch.train.trainer import ClippedAdam

    optimizer = ClippedAdam(model.parameters(), lambda count: cfg.lr_init)
    model, optimizer, step = make_spmd_train_state(cfg, mesh, model,
                                                   optimizer)
    root = mesh.root
    # numpy inputs are copied (a JAX array's numpy view is read-only)
    x, y = (a.to(root) if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.array(a)).to(root) for a in (x, y))
    gen = torch.Generator(device=root).manual_seed(seed)
    total, flow = step(x, y, gen, epoch=1, step_count=0)
    return float(total), float(flow)
