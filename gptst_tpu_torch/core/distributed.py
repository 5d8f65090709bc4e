"""Multi-process initialization and the global mesh.

The JAX package runs the same program on every host:
`initialize_distributed` wires the JAX runtime across hosts and
`global_mesh` lays the ('data', 'graph') mesh over every device of
every host, so that GSPMD splits the batch and inserts the gradient
all-reduce (`gptst_tpu/core/distributed.py`). The port runs one process
per card (or per host): `initialize_distributed` joins the processes in
a `torch.distributed` process group, and `global_mesh` gives each
process a `Mesh` over its own devices (its data rows are threads, its
graph ranks its devices, `parallel/mesh.py`) that knows its place on a
global 'data' axis spanning every process. The data-parallel step
(`parallel/spmd.py`) and `Trainer(mesh=...)` then run across processes:

    initialize_distributed()            # torchrun's environment
    mesh = global_mesh(graph_axis_size=1)
    model = build_model(cfg, adj=adj, device=mesh.root, mesh=mesh)
    Trainer(model=model, cfg=cfg, dataset=ds, device=mesh.root,
            mesh=mesh).train()

Every process loads the whole dataset from the same seed, walks the same
shuffled batches and takes its rows' slice of each global batch
(`cfg.batch_size` is the global batch); only the coordinator writes
checkpoints and logs. The resident train split goes on this process's
rows alone: with a graph axis G above 1 (which never spans processes)
each of its rows' graph ranks holds its nodes of every window, as on
one process (`parallel/mesh.place_split`), so each process gathers its
rows' slices, and the loss's labels of the whole global batch, from
its own devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from gptst_tpu_torch.parallel.mesh import Mesh, make_mesh

# seconds a collective waits for a peer before it fails
DEFAULT_TIMEOUT_S = 600.0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the run's process group.

    A no-op for one process (the common case on one card), as in the
    JAX package: `num_processes` defaults to `GPTST_NUM_PROCESSES`,
    then torchrun's `WORLD_SIZE`, then 1. Otherwise `process_id`
    defaults to `RANK` and `coordinator_address` ("host:port", or a
    `tcp://` / `file://` init method) to `MASTER_ADDR:MASTER_PORT`,
    which stand in for `jax.distributed.initialize`'s discovery.
    `backend` defaults to NCCL where CUDA is available (each process on
    its own cards) and gloo otherwise (a CPU mesh); pass "gloo" for a
    CPU mesh on a machine with cards, or for several processes on one
    card, which NCCL refuses. A collective whose peer is gone fails
    after `timeout` seconds instead of hanging."""
    if num_processes is None:
        num_processes = int(os.environ.get("GPTST_NUM_PROCESSES")
                            or os.environ.get("WORLD_SIZE") or 1)
    if num_processes <= 1 and coordinator_address is None:
        return
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: a process group "
                           "already exists")
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("initialize_distributed: pass process_id or "
                             "set RANK")
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        try:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
        except KeyError:
            raise ValueError("initialize_distributed: pass "
                             "coordinator_address or set MASTER_ADDR and "
                             "MASTER_PORT") from None
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))


def local_devices() -> list[torch.device]:
    """This process's CUDA devices: the visible ones, shared out by
    torchrun's `LOCAL_RANK` among `LOCAL_WORLD_SIZE` processes where
    there are enough (else the one at `LOCAL_RANK` modulo the count)."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("global_mesh: no CUDA device is visible; pass "
                           "devices=['cpu'] * P to run on the CPU")
    procs = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    if procs <= 1:
        return [torch.device("cuda", i) for i in range(count)]
    if count % procs == 0:
        share = count // procs
        return [torch.device("cuda", i)
                for i in range(rank * share, (rank + 1) * share)]
    return [torch.device("cuda", rank % count)]


def global_mesh(graph_axis_size: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """('data', 'graph') mesh of this process over `devices` (default
    `local_devices()`; `["cpu"] * P` for a CPU mesh), shaped by
    `choose_mesh_shape`, which raises where the graph axis does not
    divide the local device count. With a process group, the 'data'
    axis spans every process (each must hold as many rows): this
    process's rows start at row `rank * rows` of `world * rows`.
    Without one it is `make_mesh` over the local devices, as JAX's is
    over `jax.devices()`."""
    if devices is None:
        devices = local_devices()
    mesh = make_mesh(devices=devices, graph_axis_size=graph_axis_size)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return mesh
    if mesh.root.type == "cuda":
        torch.cuda.set_device(mesh.root)
    elif dist.get_backend() == "nccl":
        raise ValueError("global_mesh: a CPU mesh needs the gloo backend")
    world, rank = dist.get_world_size(), dist.get_rank()
    shapes: list = [None] * world
    dist.all_gather_object(shapes, tuple(mesh.devices.shape))
    if len(set(shapes)) > 1:
        raise ValueError(f"global_mesh: the processes' meshes differ: "
                         f"{shapes}")
    rows = mesh.local_rows
    return dataclasses.replace(mesh, data_offset=rank * rows,
                               global_data=world * rows)


def is_coordinator() -> bool:
    """Rank 0 (the process that writes checkpoints and logs); True
    without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
