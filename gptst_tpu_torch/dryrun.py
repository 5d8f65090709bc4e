"""Compile-and-run checks of the flagship model and the sharded paths.

The port of the JAX package's `__graft_entry__.py`:

  entry()              -> (fn, example_args): the GPT-ST pretrain
                          forward at 16 nodes, batch 8; `fn(*args)` is
                          the prediction.
  dryrun_multichip(P)  -> one full GPT-ST pretrain train step per mask
                          branch (forward, loss, KL, gradients, Adam) at
                          PEMS08's 170 nodes (padded to a multiple of the
                          graph axis) and batch 64 on a ('data', 'graph')
                          mesh of P ranks, the batch over 'data' and the
                          nodes over 'graph'; the ring (`parallel/halo.
                          make_ring_spmm`) and the fused ring kernel
                          (`kernels/halo_spmm.make_fused_ring_spmm`,
                          `csrc/ring_spmm.cu` on CUDA ranks) held against
                          `adj @ x` on a P-rank graph mesh; and a TGCN
                          train step whose aggregation runs node-sharded
                          (`ops/graph_conv.ShardedSupport`).

    python -m gptst_tpu_torch.dryrun            # 4 ranks: the first 4
                                                # cards, else 4 ranks of
                                                # cuda:0
    python -m gptst_tpu_torch.dryrun -ranks 8 -device cpu

Ranks may repeat a device: `devices=["cpu"] * 4` runs everything on the
CPU (the fused ring then takes its plain version), `["cuda:0"] * 4` on
one card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _tiny_cfg(num_nodes: int = 16, batch_size: int = 8):
    """`-mode pretrain` at PEMS08's published widths, cut to
    `num_nodes` and `batch_size`, `change_epoch` 1."""
    from gptst_tpu_torch.config.config import default_config

    return default_config("PEMS08", mode="pretrain", model="STGCN",
                          num_nodes=num_nodes, batch_size=batch_size,
                          epochs=20, change_epoch=1, log_dir=None)


def entry(device="cuda"):
    """One-device check: the GPT-ST pretrain forward at epoch 2 (the
    adaptive mask). Returns (fn, (model, x, generator, epoch)) with
    `fn(*args)` the prediction (B, T, N, 1)."""
    from gptst_tpu_torch.models.build import build_model
    from gptst_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = _tiny_cfg()
    model = build_model(cfg, device=dev, seed=0, scaler_zeros=0.0)
    x = torch.zeros((cfg.batch_size, cfg.lag, cfg.num_nodes,
                     cfg.input_base_dim + 2), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def fn(model, x, generator, epoch):
        return model(x, generator=generator, epoch=epoch).pred

    return fn, (model, x, gen, 2)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The sharded training step and the explicit collectives on a mesh
    of `n_devices` ranks of `devices` (default: every visible card).
    Raises when a loss is not finite or a ring misses `adj @ x`
    (rtol 1e-4, atol 1e-4, as the JAX package's dry run). Returns the
    losses, the shape of each mesh, and the rings' outputs beside
    `adj @ x` (float64) on the unpadded nodes, as numpy arrays."""
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.kernels.halo_spmm import make_fused_ring_spmm
    from gptst_tpu_torch.models.build import build_model
    from gptst_tpu_torch.ops.graph_conv import ShardedSupport, make_support
    from gptst_tpu_torch.parallel import (
        GRAPH_AXIS, choose_mesh_shape, gather_rows, make_mesh,
        make_spmd_train_state, run_one_step, shard_rows,
    )
    from gptst_tpu_torch.parallel.halo import make_ring_spmm
    from gptst_tpu_torch.train.trainer import ClippedAdam

    _, g = choose_mesh_shape(n_devices)
    # reference scale: PEMS08's nodes padded up to a multiple of the
    # graph axis; the reference's batch
    num_nodes = -(-170 // g) * g
    cfg = _tiny_cfg(num_nodes=num_nodes, batch_size=64)
    mesh = make_mesh(n_devices, devices=devices)
    root = mesh.root
    model = build_model(cfg, device=root, seed=0, scaler_zeros=0.0,
                        mesh=mesh)
    opt = ClippedAdam(model.parameters(), lambda count: cfg.lr_init)
    model, opt, step = make_spmd_train_state(cfg, mesh, model, opt)
    x = torch.zeros((cfg.batch_size, cfg.lag, cfg.num_nodes,
                     cfg.input_base_dim + 2), device=root)
    gen = torch.Generator(device=root).manual_seed(0)
    # epoch 1: the random mask; epoch 2 (> change_epoch): the adaptive
    # mask and the KL term
    losses = [tuple(float(v) for v in step(x, x, gen, epoch=e, step_count=i))
              for i, e in enumerate((1, 2))]
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"GPT-ST step losses {losses}")

    # explicit-collective aggregation over a graph-only mesh
    gmesh = make_mesh(n_devices, graph_axis_size=n_devices, devices=devices)
    adj = sym_adj(random_sensor_graph(num_nodes, avg_degree=6, seed=0))
    feat = 64
    ring, n_pad = make_ring_spmm(gmesh, adj)
    fused, n_pad2 = make_fused_ring_spmm(gmesh, adj, feat)
    assert n_pad == n_pad2, (n_pad, n_pad2)
    xg = np.random.default_rng(0).normal(size=(n_pad, feat)).astype(
        np.float32)
    xt = torch.from_numpy(xg).to(gmesh.root)
    n = adj.shape[0]
    want = adj.astype(np.float64) @ xg[:n].astype(np.float64)
    got_ring = ring(xt)[:n].cpu().numpy()
    got_fused = gather_rows(fused(shard_rows(xt, gmesh)),
                            gmesh.root)[:n].cpu().numpy()
    for name, got in (("ring", got_ring), ("fused ring", got_fused)):
        if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(
                f"{name} misses adj @ x by {np.abs(got - want).max()}")

    # a model train step whose aggregation runs node-sharded: TGCN built
    # under the mesh gets a ShardedSupport (halo or ring) on every data
    # row's graph ranks
    tcfg = cfg.replace(mode="ori", model="TGCN")
    if mesh.shape[GRAPH_AXIS] > 1:
        sup = make_support(sym_adj(adj), mesh=mesh)
        assert isinstance(sup, ShardedSupport), type(sup)
    tmodel = build_model(tcfg, device=root, seed=1, mesh=mesh)
    total_t, _ = run_one_step(tcfg, mesh, tmodel, x, x)
    if not np.isfinite(total_t):
        raise FloatingPointError(f"TGCN step loss {total_t}")
    return {"mesh": dict(mesh.shape), "graph_mesh": dict(gmesh.shape),
            "num_nodes": num_nodes, "gptst_losses": losses,
            "tgcn_loss": total_t, "ring": got_ring, "fused_ring": got_fused,
            "adj_x": want}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="gptst_tpu_torch.dryrun")
    p.add_argument("-ranks", type=int, default=4)
    p.add_argument("-device", default="cuda",
                   help="cuda: the first `ranks` cards, or `ranks` ranks "
                        "of cuda:0 when fewer are visible; cpu: CPU ranks")
    ns = p.parse_args(argv)
    if ns.device == "cpu":
        devices = ["cpu"] * ns.ranks
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is visible; pass -device cpu")
        devices = ([f"cuda:{i}" for i in range(ns.ranks)]
                   if count >= ns.ranks else ["cuda:0"] * ns.ranks)
    fn, args = entry("cpu" if ns.device == "cpu" else "cuda")
    print("entry ok:", tuple(fn(*args).shape))
    out = dryrun_multichip(ns.ranks, devices=devices)
    print("dryrun_multichip ok:", {k: out[k] for k in (
        "mesh", "graph_mesh", "num_nodes", "gptst_losses", "tgcn_loss")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
