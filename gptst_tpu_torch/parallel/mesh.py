"""Device mesh for node-sharded graph aggregation.

The JAX package is single-controller: one process drives every device
of a `jax.sharding.Mesh` with axes ('data', 'graph'). The port keeps
that model. A `Mesh` is a (data, graph) array of `torch.device`s held
by one process; a device may appear more than once, so P ranks on one
card stand in for P cards (as the JAX tests' forced host devices stand
in for chips), and `["cpu"] * P` runs the same code on the CPU.

This slice takes the graph axis only: a data axis above 1 (batch
parallelism, `parallel/spmd.py` in the JAX package) raises.
`shard_rows` / `gather_rows` stand in for placing a tensor with
`NamedSharding(mesh, P('graph', None))` and reading it back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

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
    """A (data, graph) array of torch devices, one process for all."""

    devices: np.ndarray       # (data, graph), dtype object: torch.device

    axis_names = (DATA_AXIS, GRAPH_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def graph_devices(self) -> list[torch.device]:
        """The devices of the graph axis, rank by rank."""
        return list(self.devices[0])


def _normalize(device) -> torch.device:
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
    """A mesh over `devices` (default: every visible CUDA device); a
    device may repeat. Raises on a mix of CPU and CUDA devices, on a
    CUDA index past `torch.cuda.device_count()`, and on a data axis
    above 1."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=['cpu'] * P to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_normalize(d) for d in devices]
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
    if d > 1:
        raise NotImplementedError(
            f"a data axis of {d} (batch parallelism) is not ported to "
            "gptst_tpu_torch yet; it comes with the data-parallel slice. "
            "Pass graph_axis_size equal to the device count")
    grid = np.empty((d, g), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // g, i % g] = dev
    return Mesh(grid)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Split axis -2 of x into P equal row shards, shard p on rank p's
    device (a view where x already lies there). Differentiable."""
    devs = mesh.graph_devices
    n = x.shape[-2]
    if n % len(devs):
        raise ValueError(f"{n} rows do not split over {len(devs)} ranks")
    return [s.to(d) for s, d in zip(x.split(n // len(devs), dim=-2), devs)]


def gather_rows(shards: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Concatenate row shards along axis -2 on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=-2)
