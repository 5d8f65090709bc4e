#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gptst_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card, no arguments

Phases, one JSON line each; any failure exits non-zero:
  build      compile every CUDA kernel of `gptst_tpu_torch/csrc/` (one
             `nvcc` per source, all started together).
  bsr        `bsr_spmm` at the CLI graph's shape: the support TGCN
             builds from `sym_adj(random_sensor_graph(16384))` (RCM,
             block-CSR, COO tail). Forward and transposed structure,
             F = 16 and 1600, f32 / bf16 x / bf16 values, a NaN in a
             stored block; each against the plain PyTorch version.
             Times the kernel, the plain version and `torch.sparse.mm`
             on the CSR of the same matrix (CUDA events, median of 20).
  dia        `dia_spmm` the same way on the road graph (DIA band, w=1)
             and on a w=5 band at 4096 nodes.
  cli        `python -m gptst_tpu_torch.run -mode ori -model TGCN` at
             16,384 nodes from a PEMS08.npz of that size written into a
             temporary directory: the block-CSR main path.
  dia_model  TGCN train steps through the library on the road graph's
             DIA support: the DIA main path.
  profile    `torch.profiler` over 2 TGCN train steps on each graph:
             device time by kernel group and the device busy share.
  reference  a small ragged graph (1000 nodes) with and without RCM
             (DIA and block-CSR): the TGCN forward and gradients with
             the kernels on the card against the plain versions on the
             CPU.

Before the last line: one JSON object with every kernel's launches on
its main path, error, times and bound, and the card's name and power
limit from `nvidia-smi`. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PHASES = ("build", "bsr", "dia", "cli", "dia_model", "profile",
          "reference")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores and
# HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

N_BIG = 16384
BATCH, UNITS = 16, 100
F_WIDE = BATCH * UNITS          # the h aggregations of a TGCN step
F_NARROW = BATCH * 1            # the x aggregation (input_base_dim 1)

# rtol of a bf16 output: a different summation order may flip the
# final rounding by one bf16 ulp (2^-8 relative, up to 2^-7 of the
# value); f32 outputs differ only by summation order
TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 1e-6)}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def road_graph_edges(n: int, degree: int, band: int = 48,
                     p_far: float = 0.02, seed: int = 0):
    """Banded local edges (road-network locality) plus a small
    long-range fraction; ~n*degree edges, deduplicated. The generator
    of the JAX package's large-graph bench."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), degree)
    local = rng.integers(-band, band + 1, size=rows.shape)
    cols = np.clip(rows + local, 0, n - 1)
    far = rng.random(rows.shape) < p_far
    cols[far] = rng.integers(0, n, size=int(far.sum()))
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    key = np.unique(rows.astype(np.int64) * n + cols)
    return key // n, key % n


def road_support(n: int, band: int, device):
    """sym-normalized (A + I) of the road graph as an edge list, built
    without a dense (N, N) as the bench builds it."""
    import numpy as np

    from gptst_tpu_torch.ops.graph_conv import make_support_coo

    rows, cols = road_graph_edges(n, 16, band)
    r = np.concatenate([rows, np.arange(n)])
    c = np.concatenate([cols, np.arange(n)])
    deg = np.bincount(r, minlength=n).astype(np.float64)
    vals = (1.0 / np.sqrt(deg[r] * deg[c])).astype(np.float32)
    return make_support_coo(r, c, vals, n, reorder=False, device=device)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of `fn` over `reps` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def compare(got, want, kind: str) -> float:
    """Max abs error; raises unless every element is within
    atol + rtol * |want| and NaNs sit in the same places."""
    import torch

    rtol, atol = TOL[kind]
    g, w = got.float(), want.float()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError("kernel and plain version differ in NaNs")
    fin = ~torch.isnan(w)
    diff = (g[fin] - w[fin]).abs()
    bad = diff > atol + rtol * w[fin].abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(
            f"{int(bad.sum())} elements outside rtol={rtol} atol={atol}; "
            f"max abs err {err}")
    return err


def csr_of(dense_blocks, rows_tile, cols_tile, tb: int, n: int):
    """`torch.sparse_csr_tensor` of the nonzeros of (TB, TB) blocks at
    tile coordinates (rows_tile[b], cols_tile[b])."""
    import torch

    b, r, c = torch.nonzero(dense_blocks, as_tuple=True)
    rows = rows_tile[b] * tb + r
    cols = cols_tile[b] * tb + c
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                  dense_blocks[b, r, c], (n, n))
    return coo.coalesce().to_sparse_csr()


def kernel_cases(name, kernel, plain, structs, n, seed):
    """Every correctness case of one kernel: structure (A, A^T) x width
    x dtype, then the NaN case; returns the f32 wide-forward error."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    main_err = None
    for sname, st, vals_attr in structs:
        for f in (F_NARROW, F_WIDE):
            x32 = torch.randn(n, f, device="cuda", generator=gen)
            cases = [("f32", st, x32, "f32"),
                     ("bf16_x", st, x32.bfloat16(), "bf16"),
                     ("bf16_vals", dataclasses.replace(
                         st, **{vals_attr: getattr(st, vals_attr).bfloat16()}),
                      x32, "f32")]
            for cname, s, x, kind in cases:
                got = kernel(s, x)
                torch.cuda.synchronize()
                err = compare(got, plain(s, x), kind)
                emit(name, case=f"{sname}_F{f}_{cname}", max_abs_err=err,
                     tol=dict(zip(("rtol", "atol"), TOL[kind])))
                if sname == "A" and f == F_WIDE and cname == "f32":
                    main_err = err
    return main_err


def phase_build() -> None:
    from gptst_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    logs = build_all(force=True)
    secs = time.perf_counter() - t0
    regs, spills = {}, {}
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, log in logs.items():
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(log)
        regs[name] = max((int(w.split()[0]) for w in log.split("Used ")[1:]),
                         default=0)
        spills[name] = sum(int(t.split()[0]) for t in
                           log.replace(",", "\n").splitlines()
                           for t in [t.strip()] if t.endswith("spill stores")
                           or t.endswith("spill loads"))
    emit("build", seconds=secs, kernels=sorted(logs),
         max_registers=regs, spill_bytes=spills)


def phase_bsr(rec: dict) -> None:
    import torch

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.ops.graph_conv import SparseSupport, make_support

    sup = make_support(sym_adj(random_sensor_graph(N_BIG, avg_degree=6,
                                                   seed=0)), device="cuda")
    assert isinstance(sup, SparseSupport) and sup.dia is None
    rec["_supports"] = {"cli_graph": sup}
    a = sup.bcsr
    nnzb = a.nnzb_logical
    emit("bsr", graph="sym_adj(random_sensor_graph(16384))",
         rcm=sup.perm is not None, nnzb=nnzb, row_tiles=a.row_tiles,
         coo_tail_edges=sup.coo.nnz if sup.coo is not None else 0)
    structs = [("A", a, "block_vals"), ("AT", sup.bcsr_t, "block_vals")]
    err = kernel_cases("bsr", K.bsr_spmm, K.bsr_spmm_plain, structs, a.n, 1)

    # NaN in a stored block: its row reaches every output column
    vals = a.block_vals.clone()
    b0 = int(a.block_ptr[1:].ne(a.block_ptr[:-1]).nonzero()[0])
    b0 = int(a.block_ptr[b0])
    vals[b0, 5, 7] = float("nan")
    an = dataclasses.replace(a, block_vals=vals)
    x = torch.randn(a.n, F_WIDE, device="cuda")
    got = K.bsr_spmm(an, x)
    compare(got, K.bsr_spmm_plain(an, x), "f32")
    nan_rows = int(torch.isnan(got).all(dim=1).sum())
    assert nan_rows == 1 and int(torch.isnan(got).any(dim=1).sum()) == 1
    emit("bsr", case="nan_in_block", nan_rows=nan_rows)

    ptr = a.block_ptr.long()
    rows_t = torch.repeat_interleave(torch.arange(a.row_tiles,
                                                  device="cuda"), ptr.diff())
    csr = csr_of(a.block_vals[:nnzb], rows_t, a.block_cols[:nnzb].long(),
                 a.tile, a.n)
    ms = time_ms(lambda: K.bsr_spmm(a, x))
    plain_ms = time_ms(lambda: K.bsr_spmm_plain(a, x))
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x))
    nnz = int(csr.values().numel())
    block_flops = 2 * nnzb * a.tile ** 2 * F_WIDE
    flops = 2 * nnz * F_WIDE
    nbytes = (nnzb * a.tile ** 2 * a.block_vals.element_size()
              + (a.block_ptr.numel() + nnzb) * 4
              + 2 * a.n * F_WIDE * x.element_size())
    rec["bsr_spmm"] = dict(
        name="bsr_spmm", route="cuda", source="gptst_tpu_torch/csrc/bsr_spmm.cu",
        replaces="gptst_tpu/kernels/spmm.py:213 (_spmm_kernel; also "
                 ":280 _spmm_kernel_stream, :369 _spmm_kernel_panel)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes), library_ms=lib_ms)
    emit("bsr", case="timing", shape=[a.n, F_WIDE], nnzb=nnzb, ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, nnz=nnz, flops=flops,
         bytes=nbytes, **bound(flops, nbytes),
         achieved_bytes_per_s=nbytes / ms * 1e3,
         dense_block_flops=block_flops,
         dense_block_fma_tflops=block_flops / ms / 1e9)


def bound(flops: float, nbytes: float) -> dict:
    """Least time for the work the product needs: 2 FLOPs per stored
    nonzero and column over the FP32 rate, or the bytes of the stored
    values, indices, x and out, each once, over the HBM rate. The FMAs
    the kernel spends on the zeros of its dense blocks are not counted
    (they are `dense_block_flops` in the timing line)."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_dia(rec: dict) -> None:
    import torch

    from gptst_tpu_torch.kernels import spmm as K

    errs = {}
    for n, band in ((N_BIG, 48), (4096, 600)):
        sup = road_support(n, band, "cuda")
        d = sup.dia
        assert d is not None, f"no DIA band at n={n} band={band}"
        emit("dia", graph=f"road_graph_edges({n}, 16, {band})", w=d.w,
             vals_shape=list(d.vals.shape),
             coo_tail_edges=sup.coo.nnz if sup.coo is not None else 0)
        structs = [("A", d, "vals"), ("AT", sup.dia_t, "vals")]
        errs[n] = kernel_cases(f"dia_w{d.w}", K.dia_spmm, K.dia_spmm_plain,
                               structs, n, 2)
        if n == N_BIG:
            assert d.w == 1
            big = (d, sup)
    d, sup = big
    # a NaN in x at the first tile reaches the whole first row tile
    # through the clamped window (its band block is structurally zero),
    # as in the JAX package
    x = torch.randn(d.n, F_WIDE, device="cuda")
    xn = x.clone()
    xn[3, 11] = float("nan")
    got = K.dia_spmm(d, xn)
    compare(got, K.dia_spmm_plain(d, xn), "f32")
    emit("dia", case="nan_in_x_clamped_window",
         nan_rows=int(torch.isnan(got).any(dim=1).sum()))

    rt, nd, tb = d.row_tiles, 2 * d.w + 1, d.tile
    idx = torch.arange(rt, device="cuda")
    rows_t = idx.repeat_interleave(nd)
    cols_t = (idx[:, None] + torch.arange(nd, device="cuda") - d.w).reshape(-1)
    keep = (cols_t >= 0) & (cols_t < rt)
    csr = csr_of(d.vals.reshape(rt * nd, tb, tb)[keep], rows_t[keep],
                 cols_t[keep], tb, d.n)
    ms = time_ms(lambda: K.dia_spmm(d, x))
    plain_ms = time_ms(lambda: K.dia_spmm_plain(d, x))
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x))
    nnz = int(torch.count_nonzero(d.vals))
    block_flops = 2 * rt * nd * tb * tb * F_WIDE
    flops = 2 * nnz * F_WIDE
    nbytes = (d.vals.numel() * d.vals.element_size()
              + 2 * d.n * F_WIDE * x.element_size())
    rec["dia_spmm"] = dict(
        name="dia_spmm", route="cuda", source="gptst_tpu_torch/csrc/dia_spmm.cu",
        replaces="gptst_tpu/kernels/spmm.py:784 (_dia_kernel; also "
                 ":813 _dia_kernel_ring)",
        max_abs_err=errs[N_BIG], ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes), library_ms=lib_ms)
    emit("dia", case="timing", shape=[d.n, F_WIDE], ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, nnz=nnz, flops=flops, bytes=nbytes,
         **bound(flops, nbytes), achieved_bytes_per_s=nbytes / ms * 1e3,
         dense_block_flops=block_flops,
         dense_block_fma_tflops=block_flops / ms / 1e9)


def phase_cli(rec: dict) -> None:
    import numpy as np
    import torch

    from gptst_tpu_torch.config.datasets import get_dataset_spec
    from gptst_tpu_torch.data.synthetic import synthesize_raw_series
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.run import main

    with tempfile.TemporaryDirectory() as tmp:
        spec = dataclasses.replace(get_dataset_spec("PEMS08"),
                                   num_nodes=N_BIG)
        os.makedirs(os.path.join(tmp, "data", "PEMS08"))
        np.savez(os.path.join(tmp, "data", "PEMS08", "PEMS08.npz"),
                 data=synthesize_raw_series(spec, num_steps=600, seed=0))
        metrics = os.path.join(tmp, "metrics.json")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        main(["-dataset", "PEMS08", "-mode", "ori", "-model", "TGCN",
              "-num_nodes", str(N_BIG), "-data_root",
              os.path.join(tmp, "data"), "-batch_size", str(BATCH),
              "-epochs", "2", "-lr_decay", "False", "-early_stop", "False",
              "-log_dir", os.path.join(tmp, "save"), "-log_step", "1000",
              "-metrics_out", metrics])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        with open(metrics) as f:
            rep = json.load(f)
    assert launches["bsr_spmm"] > 0 and launches["dia_spmm"] == 0, launches
    vals = np.asarray(rep["per_horizon"] + [rep["average"]], np.float64)
    assert np.isfinite(vals).all() and np.isfinite(rep["history"]).all()
    steps = rep["steps_per_epoch"]
    ms_step = [s / steps * 1e3 for s in rep["epoch_seconds"]]
    rec["bsr_spmm"]["launches"] = launches["bsr_spmm"]
    emit("cli", nodes=N_BIG, batch=BATCH, rnn_units=UNITS, epochs=2,
         steps_per_epoch=steps, ms_per_step_by_epoch=ms_step,
         samples_per_s_epoch2=steps * BATCH / rep["epoch_seconds"][-1],
         train_loss_by_epoch=rep["history"], test_average=rep["average"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches,
         launches_per_step=launches["bsr_spmm"] / (2 * steps),
         wall_s=wall)


def tgcn_train_steps(sup, warm: int, steps: int, trace: str | None = None):
    """Train steps of a TGCN (published widths, batch 16, random
    weights and data from seed 0) on `sup` through the port's library.
    Returns the losses, ms per timed step, the kernel launches of all
    steps, and (with `trace`) the timed steps' profiler trace."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.models.build import GraphPredictor, predictor_forward
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import make_loss_terms, train_step
    from gptst_tpu_torch.train.trainer import make_optimizer

    cfg = default_config("PEMS08", mode="ori", model="TGCN",
                         num_nodes=N_BIG, batch_size=BATCH, lr_decay=False)
    net = TGCN(TGCNConfig(num_nodes=N_BIG), dim_in=1, dim_out=1,
               horizon=cfg.horizon,
               generator=torch.Generator().manual_seed(0)).to("cuda")
    model = predictor_forward(cfg, GraphPredictor(net, sup))
    opt = make_optimizer(cfg, model.parameters(), steps_per_epoch=10)
    loss_terms = make_loss_terms(
        model, build_loss("mask_mae", 200.0, 100.0, 0.0, False), cfg)
    rng = np.random.default_rng(0)
    shape = (BATCH, cfg.lag, N_BIG, 3)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
    reset_launch_counts()
    losses = [train_step(loss_terms, opt, x, y)[0] for _ in range(warm)]
    torch.cuda.synchronize()
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(train_step(loss_terms, opt, x, y)[0])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(trace)
    losses = [float(v) for v in losses]
    assert np.isfinite(losses).all(), losses
    return losses, dt * 1e3, dict(LAUNCHES)


def phase_dia_model(rec: dict) -> None:
    import torch

    sup = road_support(N_BIG, 48, "cuda")
    rec["_supports"]["road_graph"] = sup
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 2, 5
    losses, ms, launches = tgcn_train_steps(sup, warm, steps)
    assert launches["dia_spmm"] > 0 and launches["bsr_spmm"] == 0, launches
    rec["dia_spmm"]["launches"] = launches["dia_spmm"]
    emit("dia_model", nodes=N_BIG, batch=BATCH, rnn_units=UNITS,
         steps=warm + steps, ms_per_step=ms, samples_per_s=BATCH / ms * 1e3,
         losses=losses,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches,
         launches_per_step=launches["dia_spmm"] / (warm + steps))


# kernel-name fragments -> what they are on the TGCN step
KERNEL_GROUPS = (
    ("bsr_spmm_kernel", "bsr_spmm"), ("dia_spmm_kernel", "dia_spmm"),
    ("indexFunc", "index_add_ (COO tail scatter, RCM gather backward)"),
    ("indexSelect", "index_select (COO tail gather, RCM permutation)"),
    ("gemm", "dense matmul"), ("xmma", "dense matmul"),
    ("cutlass", "dense matmul"), ("elementwise", "elementwise"),
    ("reduce", "reduction"),
)


def phase_profile(rec: dict) -> None:
    """Device time by kernel group and device busy share of 2 profiled
    TGCN train steps on each graph (after 1 warm-up step)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, sup in rec["_supports"].items():
        path = os.path.join(OUT_DIR, f"trace_{name}.json")
        _, ms, _ = tgcn_train_steps(sup, 1, 2, trace=path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        groups: dict = {}
        for e in kern:
            g = next((v for k, v in KERNEL_GROUPS if k in e["name"]), "other")
            groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3 / 2
        busy = sum(groups.values())
        emit("profile", graph=name, ms_per_step_profiled=ms,
             device_ms_per_step=busy, device_busy_share=busy / ms,
             kernels_per_step=len(kern) / 2,
             device_ms_by_group=dict(sorted(groups.items(),
                                            key=lambda kv: -kv[1])))


def phase_reference() -> None:
    import numpy as np
    import torch

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
    from gptst_tpu_torch.ops.graph_conv import make_support

    n, b = 1000, 4
    adj = sym_adj(random_sensor_graph(n, avg_degree=6, seed=3))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, 12, n, 1), np.float32))
    paths = set()
    for reorder in (True, False):   # RCM gives a band, no RCM block-CSR
        out = {}
        for dev in ("cpu", "cuda"):
            sup = make_support(adj, dense_threshold=0, reorder=reorder,
                               device=dev)
            path = "dia_spmm" if sup.dia is not None else "bsr_spmm"
            net = TGCN(TGCNConfig(num_nodes=n), dim_in=1, dim_out=1,
                       horizon=12,
                       generator=torch.Generator().manual_seed(0)).to(dev)
            pred = net(x.to(dev), sup)
            pred.square().mean().backward()
            out[dev] = [pred.detach().cpu()] + [
                p.grad.cpu() for p in net.parameters()]
        errs = []
        for want, got in zip(out["cpu"], out["cuda"]):
            errs.append(float((got - want).abs().max()))
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        paths.add(path)
        emit("reference", nodes=n, batch=b, reorder=reorder, kernel=path,
             pred_max_abs_err=errs[0], grad_max_abs_err=max(errs[1:]),
             tol={"rtol": 1e-4, "atol": 1e-4})
    assert paths == {"dia_spmm", "bsr_spmm"}, paths


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import gptst_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(gptst_tpu_torch not found beside it)", file=sys.stderr)
        return 2
    from gptst_tpu_torch.run import set_precision
    from gptst_tpu_torch.config.config import default_config

    set_precision(default_config("PEMS08"))
    rec: dict = {"_supports": {}}
    for name in PHASES:
        t0 = time.perf_counter()
        fn = globals()[f"phase_{name}"]
        if name in ("bsr", "dia", "cli", "dia_model", "profile"):
            fn(rec)
        else:
            fn()
        emit(name, done=True, seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [rec["bsr_spmm"], rec["dia_spmm"]]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
