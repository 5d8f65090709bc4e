"""Loss assembly, one optimizer step, and K steps per dispatch.

Mirrors the JAX package's `train/step.py` (`model/BasicTrainer.py:81-97`):
ori mode is the flow loss on the labels; pretrain mode is the flow loss
on the input itself under the model's mask, plus 0.1 * KL(mask policy ||
routing) once the epoch passes `change_epoch`.
`cfg.compute_dtype == "bfloat16"` runs the forward on a bf16 cast of
the parameters and inputs while the master parameters, the optimizer
state and the loss stay f32; gradients flow back through the cast and
arrive in f32.

`StepGraph` is the counterpart of `make_scanned_train_step` and
`make_indexed_train_step`: where the JAX package scans K steps in one
dispatch, a whole train step is captured once in a `torch.cuda.CUDAGraph`
and replayed for each step of a chunk, with no kernel launched from
Python and no host sync between the steps. The step reads everything
that changes from step to step from device buffers at the optimizer's
slot (`trainer.ClippedAdam.slot`): its batch (gathered there, or copied
into static buffers before the replay), its step input, its learning
rate and bias corrections; it writes its losses there and advances the
slot. One captured step serves every step of every chunk: it needs one
step's memory and one capture, where a graph of K steps would hold K
steps' activations, capture K times the work and need a second graph
for a shorter chunk.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Hashable

import torch
from torch import nn
from torch.func import functional_call

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.kernels.spmm import capture_launches, replay_launches
from gptst_tpu_torch.parallel.mesh import Mesh, PlacedBatch, shard_params
from gptst_tpu_torch.parallel.spmd import DataParallel
from gptst_tpu_torch.train.loss import kl_div_sum


def _cast_bf16(t):
    if isinstance(t, PlacedBatch):
        return t.map(_cast_bf16)
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(torch.bfloat16)
    return t


def labels(t, cols: int) -> torch.Tensor:
    """What the loss reads of a batch: its first `cols` channels, whole
    (a `PlacedBatch` carries them, brought to the mesh's root from the
    ranks' shards)."""
    return t.label if isinstance(t, PlacedBatch) else t[..., :cols]


def model_forwards(model: nn.Module, cfg: FrameworkConfig,
                   mesh: Mesh | None = None) -> tuple[Callable, Callable]:
    """(eval_forward, train_forward) of `model`, each `forward(x, **kw)
    -> ModelOutput`. The eval forward is f32; the train step's runs,
    with `cfg.compute_dtype == "bfloat16"`, on a bf16 cast of the
    trainable parameters, of x and of a tensor `y`. With a `mesh` both
    run over its data rows (`parallel/spmd.DataParallel`), the
    parameters placed on its root (`shard_params`), and the train
    forward's `reduce_gradients()` sums the gradients over the processes
    a data axis spans (`make_loss_terms` hands it to `train_step`)."""
    if mesh is None:
        run = model

        def call(params, x, kw):
            return functional_call(model, params, (x,), kw)
    else:
        shard_params(model, mesh, cfg.num_nodes)
        run = DataParallel(model, mesh)

        def call(params, x, kw):
            return run(x, params=params, **kw)
    if cfg.compute_dtype != "bfloat16":
        return run, run

    def forward(x, **kw):
        params = {k: _cast_bf16(p) for k, p in model.named_parameters()}
        # y only, as the JAX step casts params, x and y: the step input
        # (CCRNN's f32 teacher-forcing threshold) keeps its dtype
        return call(params, _cast_bf16(x),
                    {k: _cast_bf16(v) if k == "y" else v
                     for k, v in kw.items()})

    if mesh is not None:       # the f32 master gradients, summed
        forward.reduce_gradients = run.reduce_gradients
    return run, forward


def make_loss_terms(model: nn.Module, loss_fn: Callable,
                    cfg: FrameworkConfig,
                    forward: Callable | None = None) -> Callable:
    """Returns loss_terms(x, y, step=None, epoch=None, generator=None)
    -> (total, flow), running `model` (a `ModelOutput` module,
    `models/build.build_model`) through `forward` (default the
    one-device train forward of `model_forwards`; the data-parallel
    step passes its own). `generator` draws pretrain's mask (and
    a predictor's dropout in the other modes); `epoch` is pretrain's.
    In eval mode the cast reaches only the trainable parameters: the
    frozen encoder, outside them, stays f32. `loss_terms.reduce_gradients`
    is the forward's (None on one process). Under a mesh x and y may be
    `PlacedBatch`es (the trainer's resident split): the forward takes
    their rows as they lie and the loss their label on the root."""
    pretrain = cfg.mode == "pretrain"
    if forward is None:
        forward = model_forwards(model, cfg)[1]

    def loss_terms(x, y, step=None, epoch=None, generator=None):
        label = x if pretrain else y
        kw = {"y": y, "step": step, "generator": generator}
        if pretrain:
            kw["epoch"] = epoch
        out = forward(x, **kw)
        pred = out.pred.float()
        mask = None if out.mask is None else out.mask.float()
        flow = loss_fn(pred, labels(label, cfg.output_dim), mask)
        if pretrain and epoch > cfg.change_epoch:
            log_prob = out.probability.float().clamp_min(1e-38).log()
            return flow + 0.1 * kl_div_sum(log_prob, out.routing), flow
        return flow, flow

    loss_terms.reduce_gradients = getattr(forward, "reduce_gradients", None)
    return loss_terms


def train_step(loss_terms: Callable, optimizer: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor, step=None, **kw
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on a batch (`kw`: pretrain's epoch and
    generator), the gradients summed over processes before it where the
    data axis spans them; returns the (total, flow) losses as detached
    tensors (reading them synchronizes the device)."""
    optimizer.zero_grad(set_to_none=True)
    total, flow = loss_terms(x, y, step, **kw)
    total.backward()
    reduce = getattr(loss_terms, "reduce_gradients", None)
    if reduce is not None:
        reduce()
    optimizer.step()
    return total.detach(), flow.detach()


def step_inputs(model: nn.Module, counts: list[int]) -> torch.Tensor:
    """What the train steps of `counts` (the JAX trainer's step counts,
    `trainer.jax_step_counts`) hand the forward as `step`, on the host:
    the values of the first submodule with a `step_inputs(counts)`
    (CCRNN's teacher-forcing thresholds), else the counts (int64)."""
    for m in model.modules():
        fn = getattr(m, "step_inputs", None)
        if fn is not None:
            return fn(counts)
    return torch.tensor(counts, dtype=torch.long)


class StepGraph:
    """Runs chunks of train steps: with `capture` (on CUDA), the step
    captured once in a CUDA graph and replayed; else the same step run
    eagerly.

    `body()` is one whole train step on `optimizer` (a
    `trainer.ClippedAdam`): it reads its batch and scalars from device
    buffers at `optimizer.slot`, writes its losses there and advances
    the slot. `run(steps, key, feed)` takes `steps` steps, calling
    `feed(i)` (when given) before the i-th to put its batch into the
    buffers `body` reads. The first `WARMUP_STEPS` steps under a new
    `key` run eagerly on a side stream (real steps, kept); the next is
    captured and every step after it, in this chunk and the next ones,
    is a replay. `key` holds what the step reads as a Python constant
    (pretrain's epoch) and the storage of the buffers it reads: a new
    key drops the graph, and with it its private memory pool, and
    captures again: one live graph at a time. `generator` (re-seeded in
    place between epochs, never replaced) is registered with it, so
    each replay draws what the eager step would. A capture that fails
    raises: nothing falls back to eager steps.

    The graph's pool stays reserved between chunks, so an eager step
    beside it (a leftover or ragged-tail batch, run under `beside()`)
    takes a second step's memory: `beside()` drops the graph first
    where the device's free memory is less than the pool took at
    capture (the next chunk captures again), and gives the eager steps'
    cached blocks back after them.

    Across processes (`body` a data-parallel step whose collectives
    go over NCCL) each process captures its own step, collectives
    included, and every process must replay in the same order: the
    processes warm up, capture and replay at the same steps, since each
    takes the same chunks. `agree(flag)` (given there) tells whether
    `flag` holds on any process; `beside()` drops the graph on every
    process where one of them needs the room, so that no process
    captures while another replays.

    Kernel launches recorded at the capture (`kernels/spmm.
    capture_launches`) are counted at each replay, and each replay
    advances `optimizer.count`. `captures` counts captures; `capture`
    False runs the steps eagerly (the CPU; on the card, the reference
    that replays are held against, and a gloo process group, whose
    collectives cannot be captured)."""

    WARMUP_STEPS = 2

    def __init__(self, body: Callable[[], object],
                 optimizer: torch.optim.Optimizer,
                 generator: torch.Generator | None,
                 device: torch.device, capture: bool,
                 agree: Callable[[bool], bool] | None = None):
        self.body, self.optimizer, self.generator = body, optimizer, generator
        self.device, self.capture, self.agree = device, capture, agree
        self.captures = 0
        self.graph = None
        self.pool_bytes = 0
        self.launches: dict[str, int] = {}
        self._key = None
        self._warm = 0
        self._side = None

    def run(self, steps: int, key: Hashable,
            feed: Callable[[int], None] | None = None) -> None:
        if not self.capture:
            for i in range(steps):
                if feed is not None:
                    feed(i)
                self.body()
            return
        if key != self._key:
            self.graph, self._key, self._warm = None, key, 0
        for i in range(steps):
            if feed is not None:
                feed(i)
            if self.graph is None and self._warm < self.WARMUP_STEPS:
                self._warm_step()
                continue
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.optimizer.count += 1
            replay_launches(self.launches)

    def release(self) -> None:
        """Drop the graph and the gradients made in its pool, so that the
        pool's memory goes back to the device; the next `run` warms up
        and captures again."""
        self.graph, self._key = None, None
        self.optimizer.zero_grad(set_to_none=True)

    @contextlib.contextmanager
    def beside(self):
        """Around eager steps on the card while a graph is held: the
        cache's free blocks go back to the device before and after
        them, and the graph is dropped before them where what is free
        then is less than its pool took (an eager step needs about
        that much), on every process where `agree` is given."""
        if self.graph is None:
            yield
            return
        torch.cuda.empty_cache()
        drop = torch.cuda.mem_get_info(self.device)[0] < self.pool_bytes
        if self.agree is not None:
            drop = self.agree(drop)
        if drop:
            self.release()
            torch.cuda.empty_cache()
        try:
            yield
        finally:
            if self.graph is not None:
                torch.cuda.empty_cache()

    def _warm_step(self) -> None:
        """One eager step on a side stream, ordered after and before the
        current stream's work."""
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            self.body()
        cur.wait_stream(self._side)
        self._warm += 1

    def _capture(self) -> None:
        """Capture `body` into a new graph; `optimizer.count` is left as
        it was (the capture runs nothing)."""
        opt = self.optimizer
        count = opt.count
        # the gradients are made inside the graph's pool, and the
        # eager steps' cached blocks go back to the device before the
        # pool grows
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with capture_launches() as launches, torch.cuda.graph(graph):
            self.body()
        opt.count = count
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - held
        self.graph, self.launches = graph, launches
        self.captures += 1
