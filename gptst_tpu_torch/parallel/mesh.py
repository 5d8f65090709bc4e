"""Device mesh and the sharding layout.

The JAX package is single-controller: one process drives every device
of a `jax.sharding.Mesh` with axes ('data', 'graph'). The port keeps
that model. A `Mesh` is a (data, graph) array of `torch.device`s held
by one process; a device may appear more than once, so P ranks on one
card stand in for P cards (as the JAX tests' forced host devices stand
in for chips), and `["cpu"] * P` runs the same code on the CPU.

Row r of the mesh is a data row: its graph axis, `mesh.graph_devices(r)`,
holds the node shards of row r's batch slice. A data-parallel step
(`parallel/spmd.py`) runs the forward of each row's batch slice on the
row's devices; the parameters live once, on `mesh.root`
(`devices[0, 0]`), and every gradient ends there.

The layout rules are the JAX package's (`gptst_tpu/parallel/mesh.py`),
with partition specs written as tuples of axis names:
  * `batch_pspec`: (B, T, N, D) batches over ('data', None, 'graph',
    None); `shard_batch` splits an axis only when the mesh axis divides
    it, so a ragged tail batch runs whole on data row 0 (JAX replicates
    it over 'data': the same math, no batch parallelism);
  * `param_pspec`: a leaf whose first axis is `num_nodes` (a node table)
    over 'graph', everything else replicated. In this port every
    parameter stays whole on `mesh.root` (`shard_params`); what is
    node-sharded is the activations: graph aggregation
    (`ops/graph_conv.ShardedSupport`), GPT-ST's trunks and the
    node-sharded predictors, whose ranks read the rows of a node table
    they need through `.to()`.

With one process per card or host (`core/distributed.global_mesh`) a
`Mesh` holds this process's rows of a global 'data' axis that spans
processes: `shape` is the global (data, graph) shape, as a JAX mesh
over every process's devices is, `devices` this process's rows, which
start at global row `data_offset`; a data row's graph ranks never span
processes. `batch_spec` applies the divisibility rule to the global
data axis and `shard_batch` gives this process its rows' slices of the
global batch (a ragged batch runs whole on every process's first row).

The train split that the trainer keeps on the devices (`place_split`,
a `ResidentSplit`) is laid out as the JAX package's `_put_split` lays it
(`gptst_tpu/train/trainer.py`): its node axis over 'graph', its windows
replicated over 'data'. Data row r's graph rank g holds nodes
`NodeShards.node_range(g)` of every window; where the row runs whole (a
graph axis of 1, or one that does not divide N) the row's first device
holds the whole split. Each step's batch is then gathered on every rank
from its own arrays (`ResidentSplit.batch`, a `PlacedBatch`), and the
data-parallel step hands each row its ranks' shards as they lie: no
batch of x crosses between devices. Only the labels the loss reads go
to the root, from row 0's ranks, which hold every window. Validation and
test batches, and the host path's train batches, still come whole to
the root and are split there (`shard_batch`, then `NodeShards.split`).

`shard_rows` / `gather_rows` cut a tensor into a row's node shards on
its ranks and concatenate them back (the sharded supports' whole-tensor
entry, `parallel/halo.py`: what `NamedSharding(mesh, P('graph', None))`
does to one row in the JAX package); `NodeShards` is a row's node axis
over its graph ranks, with the
differentiable meetings over them, GSPMD's collectives over 'graph' in
one process: `node_sum` (the all-reduce of a sum over nodes, on the
row's first device) and `all_sum` (on every rank), `softmax` (over
the node axis: maxima, then sums), `all_gather`, `reduce_scatter` and
`split_draw` (one draw over the whole node axis, each rank taking its
slice). A rank reads a parameter where it lies
through `.to()` (`module_on` for a module), so the gradients meet
there.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

DATA_AXIS = "data"
GRAPH_AXIS = "graph"


def choose_mesh_shape(n_devices: int,
                      graph_axis_size: Optional[int] = None) -> tuple[int, int]:
    """(data, graph) factorization of ``n_devices``; a 2-way graph axis
    by default when the count is even, as in the JAX package."""
    if graph_axis_size is None:
        graph_axis_size = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % graph_axis_size:
        raise ValueError(
            f"{n_devices} devices not divisible by graph axis "
            f"{graph_axis_size}")
    return n_devices // graph_axis_size, graph_axis_size


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, graph) array of torch devices held by one process: the
    whole mesh, or this process's rows of a 'data' axis that spans
    processes."""

    devices: np.ndarray       # (data, graph), dtype object: torch.device
    # this process's first row on the global 'data' axis, and that
    # axis's rows over every process (None: this process's alone)
    data_offset: int = 0
    global_data: Optional[int] = None

    axis_names = (DATA_AXIS, GRAPH_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        """The global (data, graph) shape."""
        d, g = self.devices.shape
        return dict(zip(self.axis_names, (self.global_data or d, g)))

    @property
    def local_rows(self) -> int:
        """The data rows this process holds."""
        return self.devices.shape[0]

    @property
    def processes(self) -> int:
        """The processes the 'data' axis spans."""
        return self.shape[DATA_AXIS] // self.local_rows

    @property
    def root(self) -> torch.device:
        """Where the parameters, the optimizer and the loss live."""
        return self.devices[0, 0]

    def graph_devices(self, row: int) -> list[torch.device]:
        """The graph axis of data row `row`, rank by rank."""
        return list(self.devices[row])

    @property
    def row_devices(self) -> list[torch.device]:
        """The first device of every data row (where its forward runs)."""
        return list(self.devices[:, 0])


def normalize_device(device) -> torch.device:
    """cuda -> cuda:0, cpu:0 -> cpu, so that ranks compare equal to
    the devices of the tensors placed on them."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


def make_mesh(n_devices: Optional[int] = None,
              graph_axis_size: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, graph) mesh over `devices` (default: every visible CUDA
    device), shaped by `choose_mesh_shape`; a device may repeat. Raises
    on a mix of CPU and CUDA devices and on a CUDA index past
    `torch.cuda.device_count()`."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=['cpu'] * P to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [normalize_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                         "devices given")
    devices = devices[:n_devices]
    kinds = {d.type for d in devices}
    if len(kinds) > 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh holds CPU devices or CUDA devices, not "
                         f"{sorted(kinds)}")
    count = torch.cuda.device_count()
    for d in devices:
        if d.type == "cuda" and d.index >= count:
            raise ValueError(f"{d} is not a visible CUDA device "
                             f"({count} visible)")
    d, g = choose_mesh_shape(n_devices, graph_axis_size)
    grid = np.empty((d, g), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // g, i % g] = dev
    return Mesh(grid)


def batch_pspec() -> tuple:
    """(B, T, N, D) activations: batch over 'data', nodes over
    'graph'."""
    return (DATA_AXIS, None, GRAPH_AXIS, None)


def batch_spec(shape: Sequence[int], mesh: Mesh) -> tuple:
    """The spec `shard_batch` gives a (B, T, N, D) leaf (the JAX
    package's `batch_sharding` with its divisibility rule): an axis is
    split only when the mesh axis divides it."""
    d_ax = DATA_AXIS if shape[0] % mesh.shape[DATA_AXIS] == 0 else None
    g_ax = GRAPH_AXIS if shape[2] % mesh.shape[GRAPH_AXIS] == 0 else None
    return (d_ax, None, g_ax, None)


def param_pspec(leaf, num_nodes: int) -> tuple:
    """Node-indexed tables shard their node dimension over 'graph';
    everything else is replicated."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 1 and shape[0] == num_nodes:
        return (GRAPH_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def shard_params(model: torch.nn.Module, mesh: Mesh,
                 num_nodes: int) -> dict[str, tuple]:
    """The layout of `model`'s parameters on the mesh, by name (the JAX
    package's). Every parameter lives whole on `mesh.root`, a
    node-sharded GPT-ST's ranks reading their rows through `.to()`:
    raises when one lies elsewhere, since the model's graph operands
    were built beside its parameters."""
    layout = {}
    for name, p in model.named_parameters():
        if p.device != mesh.root:
            raise ValueError(f"parameter {name} is on {p.device}; build the "
                             f"model on the mesh's root {mesh.root}")
        layout[name] = param_pspec(p, num_nodes)
    return layout


def shard_batch(batch, mesh: Mesh):
    """Split (B, T, N, D) batch leaves (a tensor, or a tuple of them)
    over the mesh's data rows: this process's row r's slice of the
    global batch on its first device, when the global data axis divides
    B; else the whole leaf on data row 0 (one shard, on every process).
    The node axis stays whole: a row's sharded graph support splits it
    over the row's graph ranks. Returns, per leaf, the list of row
    shards."""

    def put(a: torch.Tensor) -> list[torch.Tensor]:
        devs = mesh.row_devices
        if batch_spec(a.shape, mesh)[0] is None:
            return [a.to(devs[0])]
        rows = a.chunk(mesh.shape[DATA_AXIS])[mesh.data_offset:]
        return [s.to(d) for s, d in zip(rows, devs)]

    if isinstance(batch, torch.Tensor):
        return put(batch)
    return type(batch)(put(a) for a in batch)


def shard_rows(x: torch.Tensor, mesh: Mesh,
               row: int = 0) -> list[torch.Tensor]:
    """Split axis -2 of x into P equal row shards, shard p on rank p's
    device of data row `row` (a view where x already lies there).
    Differentiable."""
    devs = mesh.graph_devices(row)
    n = x.shape[-2]
    if n % len(devs):
        raise ValueError(f"{n} rows do not split over {len(devs)} ranks")
    return [s.to(d) for s, d in zip(x.split(n // len(devs), dim=-2), devs)]


def gather_rows(shards: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Concatenate row shards along axis -2 on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=-2)


@dataclasses.dataclass(frozen=True)
class NodeShards:
    """The node axis of one data row over its graph ranks: rank g holds
    nodes `node_range(g)` on `devices[g]`. A node-sharded activation is
    the list of the ranks' shards; one rank is the one-device layout,
    where every helper below is the identity (no copy, no extra op)."""

    devices: tuple            # torch.device per rank
    n: int                    # nodes in all

    @property
    def parts(self) -> int:
        return len(self.devices)

    def node_range(self, g: int) -> tuple[int, int]:
        """Rank g's nodes [lo, hi)."""
        n_loc = self.n // self.parts
        return g * n_loc, (g + 1) * n_loc

    def split(self, x, dim: int = -2) -> list[torch.Tensor]:
        """Axis `dim` of x (n long: activations, node tables, routing
        priors) cut into the ranks' shards, shard g on rank g's device.
        Differentiable: the gradients meet where x lies. A list is
        already split (the resident split's batch): each shard's device
        and length are checked, and nothing is copied."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.parts:
                raise ValueError(f"{len(x)} shards for {self.parts} ranks")
            for g, (s, dev) in enumerate(zip(x, self.devices)):
                lo, hi = self.node_range(g)
                if s.device != dev or s.shape[dim] != hi - lo:
                    raise ValueError(
                        f"shard {g} is {tuple(s.shape)} on {s.device}; "
                        f"rank {g} holds {hi - lo} nodes on {dev}")
            return list(x)
        if self.parts == 1:
            return [x.to(self.devices[0])]
        return [s.to(d) for s, d in zip(
            x.split(self.n // self.parts, dim), self.devices)]

    def gather(self, shards: Sequence[torch.Tensor],
               dim: int = -2) -> torch.Tensor:
        """The shards concatenated on `dim`, on the row's first device."""
        if len(shards) == 1:
            return shards[0]
        return torch.cat([s.to(self.devices[0]) for s in shards], dim)

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """t on every rank (a node-free value: time embeddings, the
        clusters of a capsule layer)."""
        return [t.to(d) for d in self.devices]

    def node_sum(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the ranks' partial sums over their nodes, on the
        row's first device: the all-reduce over 'graph' of a sum over
        nodes, in one process. Differentiable: each rank's partial gets
        the gradient of the total."""
        total = partials[0].to(self.devices[0])
        for p in partials[1:]:
            total = total + p.to(self.devices[0])
        return total

    def all_sum(self, partials: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
        """`node_sum` on every rank (a norm's statistics over nodes)."""
        if self.parts == 1:
            return list(partials)
        return self.replicate(self.node_sum(partials))

    def softmax(self, xs: Sequence[torch.Tensor], dim: int
                ) -> list[torch.Tensor]:
        """`torch.softmax` over the node axis `dim` of the ranks' shards
        `xs`: the ranks' maxima meet (detached: the shift, which the
        softmax's value and gradient do not see), then the sums of the
        exponentials (`all_sum`)."""
        if self.parts == 1:
            return [torch.softmax(xs[0], dim=dim)]
        top = None
        for x in xs:
            m = x.detach().amax(dim=dim, keepdim=True).to(self.devices[0])
            top = m if top is None else torch.maximum(top, m)
        es = [torch.exp(x - m) for x, m in zip(xs, self.replicate(top))]
        sums = self.all_sum([e.sum(dim=dim, keepdim=True) for e in es])
        return [e / s for e, s in zip(es, sums)]

    def all_gather(self, shards: Sequence[torch.Tensor],
                   dim: int = -2) -> list[torch.Tensor]:
        """The whole node axis on every rank (where a rank's rows of a
        graph multiply every node's features)."""
        if self.parts == 1:
            return list(shards)
        return self.replicate(self.gather(shards, dim))

    def reduce_scatter(self, partials: Sequence[torch.Tensor],
                       dim: int = -2) -> list[torch.Tensor]:
        """The sum of the ranks' partials, each over the whole node axis
        on `dim`, rank g taking its nodes (a product by Aᵀ where rank g
        holds rows of A)."""
        if self.parts == 1:
            return list(partials)
        out = []
        for g, dev in enumerate(self.devices):
            lo, hi = self.node_range(g)
            total = None
            for p in partials:
                part = p.narrow(dim, lo, hi - lo).to(dev)
                total = part if total is None else total + part
            out.append(total)
        return out

    def split_draw(self, draw: Callable[[tuple], torch.Tensor],
                   shape: Sequence[int], dim: int = -2
                   ) -> list[torch.Tensor]:
        """`draw(shape)` of the row's whole node axis (on the device of
        the draw's generator), made once and cut into the ranks' shards:
        the one-device draw, whatever the ranks."""
        return self.split(draw(tuple(shape)), dim)

    def module_on(self, module: Optional[nn.Module],
                  g: int) -> Optional[nn.Module]:
        """`module` as rank g calls it (`module_on(module, devices[g])`)."""
        return module_on(module, self.devices[g])


def each(module: nn.Module, x, shards: Optional[NodeShards] = None,
         fn: Optional[Callable] = None):
    """`module(x)`, or `fn(module, x)`: a node-local layer on x, or with
    `shards` on each rank's shard of the list x, the module as the rank
    reads it (`module_on`)."""
    if fn is None:
        def fn(m, t):
            return m(t)
    if shards is None:
        return fn(module, x)
    return [fn(shards.module_on(module, g), t) for g, t in enumerate(x)]


def per_rank(fn: Callable, *xs):
    """`fn(*xs)`, or where xs[0] is a list of the ranks' node shards,
    `fn` on each rank's (an elementwise step of a node-sharded
    model)."""
    if isinstance(xs[0], list):
        return [fn(*a) for a in zip(*xs)]
    return fn(*xs)


def module_on(module: Optional[nn.Module],
              device: torch.device) -> Optional[nn.Module]:
    """`module` itself where its parameters lie on `device`; else a
    shallow copy of its tree whose parameters and buffers are read
    through `.to(device)` (differentiable: the gradients meet where the
    parameters lie; None for None). Made per call, so two data rows never
    share it."""
    if module is None:
        return None
    first = next(module.parameters(), None)
    if first is None or first.device == device:
        return module
    view = copy.copy(module)
    view.__dict__["_parameters"] = {
        k: None if v is None else v.to(device)
        for k, v in module._parameters.items()}
    view.__dict__["_buffers"] = {
        k: None if v is None else v.to(device)
        for k, v in module._buffers.items()}
    view.__dict__["_modules"] = {
        k: None if m is None else module_on(m, device)
        for k, m in module._modules.items()}
    return view


def node_shards(mesh: Optional[Mesh], n: int, row: int,
                device: torch.device) -> NodeShards:
    """The node shards of data row `row` of `mesh` for an n-node model:
    its graph ranks when the graph axis is above 1 and divides n (the
    JAX package's `batch_spec` rule), else one shard on `device`
    (JAX replicates such a node axis: the same math, whole)."""
    if mesh is None or n % mesh.shape[GRAPH_AXIS] or \
            mesh.shape[GRAPH_AXIS] == 1:
        return NodeShards((device,), n)
    return NodeShards(tuple(mesh.graph_devices(row)), n)


def put_array(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array copied to `device` (`place_split`'s one copy)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class PlacedBatch:
    """A (B, T, N, D) train batch that already lies on the mesh
    (`ResidentSplit.batch`): `rows[r]` is this process's data row r's
    slice of the global batch, the list of its graph ranks' node shards
    (each on its rank) or, where the row runs whole, one tensor on the
    row's first device; a ragged batch, or one the global data axis does
    not divide, is row 0's alone (`shard_batch`'s rule). `rows` is None
    where no row reads the batch (y, unless the model takes targets).
    `shape` is the global batch's; `label`, where set, is its first
    channels, whole, on the mesh's root: what the loss reads."""

    rows: Optional[list]
    shape: tuple
    label: Optional[torch.Tensor] = None

    def map(self, fn: Callable) -> "PlacedBatch":
        """`fn` on every shard (the bf16 cast); the label as it is."""
        if self.rows is None:
            return self
        return dataclasses.replace(
            self, rows=[per_rank(fn, r) for r in self.rows])


@dataclasses.dataclass(frozen=True, eq=False)
class ResidentSplit:
    """The train split's x and y on this process's rows of a mesh
    (`place_split`): `x[r][g]` and `y[r][g]` are data row r's graph rank
    g's arrays, nodes `rows[r].node_range(g)` of every window on
    `rows[r].devices[g]` (the whole split on the row's first device
    where the row runs whole). A device that appears more than once
    holds each of its slices once."""

    rows: tuple               # NodeShards of each data row
    x: tuple                  # [row][rank] tensors
    y: tuple
    data: int                 # the global 'data' axis
    offset: int               # this process's first row on it

    @property
    def root(self) -> torch.device:
        return self.rows[0].devices[0]

    @property
    def devices(self) -> list[torch.device]:
        """Every device that holds a part, once."""
        return list(dict.fromkeys(a.device for a in self.tensors()))

    def tensors(self) -> list[torch.Tensor]:
        """Every placed tensor, once."""
        seen = {id(a): a for arrs in (self.x, self.y)
                for ranks in arrs for a in ranks}
        return list(seen.values())

    def rank_bytes(self) -> list[list[int]]:
        """The bytes of x and y that each (row, rank) reads."""
        return [[a.nbytes + b.nbytes for a, b in zip(xs, ys)]
                for xs, ys in zip(self.x, self.y)]

    def batch(self, sel: Callable[[torch.device], torch.Tensor],
              targets: bool, label: int, cols: int
              ) -> tuple[PlacedBatch, PlacedBatch]:
        """The global batch of the windows `sel(device)` (the same
        indices, on each device that holds a part) as (x, y): each data
        row's slice gathered by `index_select` on each of its ranks from
        the rank's own arrays (y's only with `targets`, where the model
        reads the labels), and the label the loss reads, the first
        `cols` channels of x (`label` 0, pretrain) or y (1) of the whole
        batch, gathered on row 0's ranks, which hold every window, and
        brought to the root."""
        sels = {d: sel(d) for d in self.devices}
        size = sels[self.root].shape[0]
        per = size // self.data
        spans = ([((self.offset + r) * per, per)
                  for r in range(len(self.rows))]
                 if size % self.data == 0 else [(0, size)])

        def rows_of(arrs) -> list:
            out = []
            for (start, m), sh, ranks in zip(spans, self.rows, arrs):
                got = [a.index_select(0, sels[a.device].narrow(0, start, m))
                       for a in ranks]
                out.append(got if sh.parts > 1 else got[0])
            return out

        arrays = (self.x, self.y)
        rows = [rows_of(self.x), rows_of(self.y) if targets else None]
        if spans[0] == (0, size) and rows[label] is not None:
            pieces = rows[label][0]           # row 0 holds the whole batch
            pieces = pieces if isinstance(pieces, list) else [pieces]
        else:
            pieces = [a.index_select(0, sels[a.device])
                      for a in arrays[label][0]]
        labels = [p[..., :cols].to(self.root) for p in pieces]
        whole = labels[0] if len(labels) == 1 else torch.cat(labels, dim=-2)
        n = self.rows[0].n
        shapes = [(size, a[0][0].shape[1], n, a[0][0].shape[3])
                  for a in arrays]
        return tuple(PlacedBatch(r, s, whole if i == label else None)
                     for i, (r, s) in enumerate(zip(rows, shapes)))


def place_split(arrays: Sequence[np.ndarray], mesh: Mesh) -> ResidentSplit:
    """The train split's (x, y), (windows, T, N, D) host arrays, placed
    on this process's rows of `mesh` as the JAX package's `_put_split`
    places them: each data row's graph rank g takes nodes
    `node_range(g)` of every window where the graph axis is above 1 and
    divides N, else the row's first device takes the whole split (rows
    hold the same parts: the windows are replicated over 'data'). Each
    (device, slice) is copied from the host once (`put_array`); a
    `torch.OutOfMemoryError` propagates."""
    n = arrays[0].shape[2]
    rows = tuple(node_shards(mesh, n, r, dev)
                 for r, dev in enumerate(mesh.row_devices))
    placed: dict = {}

    def on(i: int, dev: torch.device, lo: int, hi: int) -> torch.Tensor:
        key = (i, dev, lo, hi)
        if key not in placed:
            a = arrays[i]
            placed[key] = put_array(a if hi - lo == n else a[:, :, lo:hi],
                                    dev)
        return placed[key]

    x, y = [tuple(tuple(on(i, dev, *sh.node_range(g))
                        for g, dev in enumerate(sh.devices))
                  for sh in rows) for i in range(2)]
    return ResidentSplit(rows, x, y, mesh.shape[DATA_AXIS], mesh.data_offset)
