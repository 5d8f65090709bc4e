#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gptst_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card, no arguments

Phases, one JSON line each; any failure exits non-zero:
  build      compile every CUDA kernel of `gptst_tpu_torch/csrc/` (one
             `nvcc` per source, all started together).
  bsr        `bsr_spmm` at the CLI graph's shape: the support TGCN
             builds from `sym_adj(random_sensor_graph(16384))` (RCM,
             block-CSR, COO tail). Forward and transposed structure,
             F = 16, 1024 (eval mode's x) and 1600, f32 / bf16 x / bf16
             values (no block may run densely), a NaN in a stored block,
             and the non-finite cases that make blocks run densely (a
             NaN in x under zero slots, an Inf in x, a NaN and a finite
             value outside the entries; the dense-block counter must
             rise); each against the plain PyTorch version. Times the
             kernel, the plain version, `torch.sparse.mm` on the CSR of
             the same matrix and the kernel on the same blocks with zero
             values and no entries, which stages and checks every x tile
             but sums nothing (CUDA events, median of 20); and, at
             F = 1024, the kernel on both structures, the plain version
             and `torch.sparse.mm`.
  dia        `dia_spmm` the same way on the road graph (DIA band, w=1)
             and on a w=5 band at 4096 nodes, plus a NaN in x that
             reaches the first row tile through the clamped band block.
  sddmm      `sddmm_blocks` at rank 10 on MSDR's two learned-adjacency
             patterns (CLI graph: 128 blocks; road graph: 382 blocks)
             and on a ragged 1000-node one: f32 and bf16 e1/e2, a NaN
             in e1. Times the kernel, the plain version and
             `torch.sparse.sampled_addmm` on the pattern's entries, by
             CUDA events and, each kernel alone, by `torch.profiler`
             (`device_ms_by_kernel`).
  dvals      `spmm_dvals` on the same two patterns at F = 1024 (batch 8
             x the 128-wide z of MSDR) and a ragged F: f32 and bf16 g/x,
             pad blocks zero, a NaN in x, an Inf in x (Inf where g is
             nonzero, NaN where it is 0) and FLT_MAX in x (finite
             result). Times the kernel, the plain version and
             `torch.sparse.sampled_addmm` on every slot of the stored
             blocks (and, labelled, on the pattern entries); bounds on
             the tensor cores (3xTF32) and on the FP32 pipe.
  gwn_kernels
             `bsr_spmm` and `dia_spmm` on the transposed structure that
             GWN's forward runs (and on A, its backward) of D^-1 A: the
             CLI graph's (block-CSR behind RCM, values not symmetric)
             and the directed road graph's (DIA band, pattern and
             values not symmetric), at F = 3,072 and 256; times against
             the plain version and `torch.sparse.mm`.
  ring       `make_fused_ring_spmm` (`ring_spmm`) on P ranks of cuda:0: the
             main path at TGCN's batch-major width (F = 16 x 101) on the
             CLI graph, 4 ranks; `scripts/halo_bench.py`'s default (4096
             nodes, F = 128, P = 2 and 8) and `dryrun_multichip`'s shape
             (172 nodes, F = 64, P = 4). f32, bf16, NaN, Inf and FLT_MAX
             x against the plain version; P^2 launches per call. Times
             the ring call, its P^2 kernels without the copies, the
             plain version, the port's `make_ring_spmm` and
             `torch.matmul` of the dense padded adjacency; bounds on the
             tensor cores (3xTF32) and on the FP32 pipe. With 2 or more
             cards the main case runs again with one rank per card.
  cli        `python -m gptst_tpu_torch.run -mode ori -model TGCN` at
             16,384 nodes from a PEMS08.npz of that size written into a
             temporary directory: the block-CSR main path. No block may
             run densely (the whole run gathers entries).
  dia_model  TGCN train steps through the library on the road graph's
             DIA support: the DIA main path, no block run densely.
  msdr_cli   `python -m gptst_tpu_torch.run -mode ori -model MSDR` at
             16,384 nodes, batch 8: the learned-adjacency main path
             (`bsr_spmm`, `sddmm`, `spmm_dvals`), no block run densely.
  msdr_model MSDR train steps through the library on the road graph
             (DIA static supports, the 382-block pattern).
  sharded_model
             TGCN train steps with node-sharded aggregation on 4 ranks
             of cuda:0: the CLI graph through `build_model(cfg,
             mesh=...)`, the road graph through `partition_graph_coo`
             (both the boundary halo exchange); the road graph's losses
             against `dia_model`'s.
  data_parallel
             batch-parallel training over a (data, graph) mesh of
             repeated `cuda:0` ranks (`parallel/spmd.py`, one thread per
             data row): TGCN on the CLI graph through `build_model(cfg,
             mesh=(2 x 1))` against the one-device steps (losses and
             every parameter), `bsr_spmm` launched in both rows'
             forwards, no block run densely, and `bsr_spmm` timed at a
             row's widths (F = 800, 8); TGCN on the road graph at (2 x 1)
             (`dia_spmm` in both rows) and at (2 x 2) (a 2-rank halo per
             row), each against `dia_model`'s losses; GPT-ST pretrain at
             16,384 nodes (epochs 1 and 2) and MTGNN at 2,048 (dropout)
             against the one-device loss and gradients; a ragged batch
             of 15 on row 0. With 2 or more cards, TGCN with one data
             row per card, and `run.main` building the CLI's mesh.
  gptst_graph
             GPT-ST over the 'graph' axis, f32, 16,384 nodes, batch 8,
             published widths: (a) pretrain loss and every gradient on a
             (1, 2) mesh of `[cuda:0, cuda:0]` (nodes split over the two
             ranks) against the one-device step at epochs (1, 2, 2),
             both mask branches; (b) the same on (2, 2); ms per step and
             peak memory of both sides; (c) eval-mode TGCN under (1, 2)
             (encoder node-sharded, TGCN through a 2-rank halo of the
             CLI graph) against the one-device eval step (`bsr_spmm`);
             (d) `dryrun.dryrun_multichip(4)` on 4 ranks of cuda:0: the
             sharded GPT-ST and TGCN steps and the fused ring
             (`ring_spmm`, launched) against `adj @ x`. With 2 or more
             cards, (a) over cuda:0 and cuda:1; with 4, (b) over the
             four beside GPT-ST whole on each data row's first card,
             and one profiled step of each.
  distributed
             data-parallel training across processes
             (`core/distributed.py`): two processes on cuda:0 over gloo
             (explicit: NCCL refuses two ranks on one device), each a
             (1, 1) mesh of a global (2, 1) data axis, started with a
             deadline and killed past it: TGCN `-mode ori` on the CLI
             graph at 16,384 nodes, global batch 16 (`bsr_spmm` in each
             process), and GPT-ST pretrain at 16,384 nodes, global batch
             8, through the library; losses and final parameters
             against the same runs in one process on a (2, 1) mesh of
             `[cuda:0, cuda:0]`, both processes' parameters equal; ms per
             step and each process's peak memory; gloo runs every
             collective on the CUDA tensors. With 2 or more cards, NCCL
             with one process per card, beside one card and the
             one-process mesh over the same cards.
  predictors_graph
             STGCN, GWN, MTGNN and CCRNN node-sharded over a data row's
             graph ranks (`models/build.GraphPredictor.mesh`), f32, TF32
             off, on a (1, 2) mesh of `[cuda:0, cuda:0]` beside the
             one-device model from the same weights: GWN at 16,384
             nodes, batch 8, conf widths (aptonly), STGCN, MTGNN and
             CCRNN at 2,048 nodes, batch 16 (CCRNN's SVD embeddings of a
             random-walk normalized random sensor graph in place of its
             series' support); 1 warm and
             3 timed Adam steps with dropout drawn from a generator
             (CCRNN teacher-forced), in f32 free (ms per step, peak
             memory, the first loss rtol 1e-5) and from the same
             weights in float64 step-locked (the sharded model set to
             the one-device model's parameters and Adam state before
             each step), where every step's loss (rtol 1e-5) and the
             parameters after it (rtol 1e-4 with an atol of 1e-5 of
             each tensor's largest entry) must match; then eval STGCN
             at 2,048 nodes
             with the frozen GPT-ST encoder and the predictor both
             sharded. No kernel of `csrc/` is on this path. With 2 or
             more cards, the same over cuda:0 and cuda:1, the peak per
             card against one card.
  last_predictors_graph
             MSDR, ASTGCN, STGODE, ST_WA and DMVSTNET node-sharded as
             in predictors_graph (`graph_pair_line`), built under the
             mesh (MSDR's static supports the halo exchange, taking the
             ranks' shards), at conf widths, 2,048 nodes of a random
             sensor graph (STGODE's semantic graph another one): MSDR,
             ASTGCN, STGODE at batch 16, ST_WA at batch 8, DMVSTNET at
             batch 16; float64 step-locked at the same batch, ST_WA's at
             batch 2 (its f32 step at batch 8 holds ~42 GB). Prints each
             rank's share of ST_WA's spatial attention maps. With 2 or
             more cards, the five over cuda:0 and cuda:1 too.
  gptst_model
             GPT-ST `-mode pretrain` train steps through the library at
             16,384 nodes, PEMS08's published widths, batch 8, f32: one
             warm step at epoch 1 (random mask), 3 timed at epoch 2
             (adaptive mask and KL term, `change_epoch` 1); then bf16
             steps (`compute_dtype=bfloat16`), whose loss must be finite.
             No kernel of `csrc/` is on this path (dense einsums).
  gptst_cli  `python -m gptst_tpu_torch.run -dataset PEMS08 -mode
             pretrain` (the default `-model`) at PEMS08's 170 nodes,
             batch 64, 2 epochs across `change_epoch` 1, from a
             PEMS08.npz the phase writes; the pretrain checkpoint must
             load strictly into a fresh GPT-ST whose `encode` equals the
             trained model's.
  device_data
             the trainer's device-resident train split (the default:
             `device_data` True, `scan_steps` 0) against the host path
             (`-device_data False`): `cli`'s TGCN run (16,384 nodes,
             batch 16, 480 time steps, 2 epochs) and `gptst_cli`'s
             pretrain run (170 nodes, batch 64), each run again on the
             host path. For both paths: ms per step by epoch, the peak
             over what the run found allocated, the split's bytes on the
             card, and the host-to-device copies inside the train steps
             (`HostCopies`), which must be 0 batch copies on the
             resident path and two a step on the host path. The paths'
             train losses, best loss and test (GPT-ST: train split)
             averages must agree within `DEVICE_DATA_RTOL`.
             `chip_phases.py device_data_abba` runs each model's paths
             afresh in the order host, resident, resident, host. Then
             the split over 'graph' (`case="graph"`): the TGCN CLI
             trainer at 16,384 nodes, batch 16, 51 windows, on a (1, 2)
             mesh of `[cuda:0, cuda:0]`, each rank holding its half of
             every window, against `-device_data False` from the same
             weights: the split's bytes per rank (half the whole), no
             batch copied from the host in the train steps, the paths'
             losses within `DEVICE_DATA_RTOL`. With 2 or more cards
             (`case="graph_cards"`): the same trainer on (1, 2) and on
             (2, 1) of cuda:0 and cuda:1 (`bsr_spmm` launched in both
             rows), and with 4 GPT-ST pretrain at 16,384 nodes, batch
             8, on (2, 2): ms per step by epoch, peak allocated and the
             split's bytes per card, and epoch 1's device-to-device
             copies by what they carried (`BatchCopies`: x, y, the
             labels brought to the root, the rest), from its profiler
             trace; x's must be 0 on the resident path. With one card
             it prints that it did not run.
  step_graph the trainer's K steps per dispatch (`train/step.StepGraph`,
             K = 4 here): trainers built as `run.main` builds them take
             2 epochs of 2 K + 2 steps with each chunk of K full batches
             replayed from one captured CUDA graph of the train step,
             and again with the same step body run eagerly on the card,
             from the same weights and generator seeds; every step's
             losses and the final parameters agree within rtol 1e-5
             (1e-4 where the COO tail's atomics sum), bitwise equality
             reported. TGCN at 16,384 nodes, batch 16, on the CLI graph
             (`bsr_spmm`) and on the road graph (`dia_spmm`), each
             kernel launched inside the captured step and counted at
             every replay; GPT-ST pretrain at 170 nodes, batch 64,
             across `change_epoch` (two captures); eval STGCN at 170
             nodes; the 13 predictors `-mode ori` at their CLI sizes
             (170 / 250 nodes, batch 64). For both paths: ms and host ms
             per step over the last epoch's runner steps, peak allocated
             and reserved over what was held, captures, kernel launches
             per step. The CLI phases above and below run graphed too
             (K = 16, the default).
  step_graph_cards
             with 2 or more cards: the same K steps per dispatch across
             two processes over NCCL, one card each (a global (2, 1)
             mesh): each process captures its data-parallel step, the
             collectives included, and replays it. TGCN on the CLI graph
             at 16,384 nodes (global batch 16), GPT-ST pretrain and GWN
             at 170 nodes (global batch 64), graphed against the same
             steps eagerly in the same processes and against one card's
             graphed run of the same global batch; GWN again with one
             process short of memory (both drop the graph and capture
             again). With one card it prints that it did not run.
  eval_cli   the main path: `run.main` at 16,384 nodes from a 480-step
             PEMS08.npz, `-mode pretrain` (batch 8, 1 epoch), then
             `-mode eval -model TGCN` (frozen encoder, Fusion head,
             TGCN at dim_in 64; batch 16, 2 epochs, under
             `-profile_dir`, whose trace must be non-empty and is then
             deleted), then `-mode test`. `bsr_spmm` must launch,
             transposed launches at F = 1,024 (the gradient into the
             head) included, with no block run densely; the encoder
             bitwise equal to the pretrain checkpoint; the test report
             equal to the eval run's (rtol 1e-4: atomics in
             `index_add_`).
  eval_model eval-mode TGCN train steps through the library on the road
             graph's DIA support (1 warm, 3 timed; encoder from
             `build_pretrain`'s random init): `dia_spmm`, no block run
             densely.
  stgcn_cli  STGCN (the default `-model`) through `run.main` at 170
             nodes, batch 64: `-mode ori`, then pretrain -> eval ->
             test; finite losses, the test report equal to eval's.
  gwn_cli    the slice's main path: `run.main -mode ori -model GWN
             --aptonly False` at 16,384 nodes on the CLI graph, batch 8,
             2 epochs of 7 steps. `bsr_spmm` launches 32 times a train
             step on the supports' transposed structures and 28 on A
             (the last layer's products reach no loss), 32 per
             evaluation batch, with no block run densely.
  gwn_model  GWN library steps on the directed road graph's DIA bands
             (`dia_spmm` on the transposed bands forward, on A's
             backward: other bands), then sparse against dense supports
             on the card at 1,000 nodes.
  predictors_cli
             MTGNN (PEMS08, 170 nodes) and CCRNN (NYC_BIKE, 250 nodes)
             `-mode ori`, then eval and test of GWN, MTGNN and CCRNN
             from one pretrain checkpoint per dataset, batch 64; each
             test report (GWN's and MTGNN's with dropout: the trainer's
             test generator) equal to its eval run's; peak memory.
  graph_predictors_cli
             STMGCN (NYC_BIKE, 250 nodes), ASTGCN, STSGCN, STFGNN and
             STGODE (PEMS08, 170 nodes) through `run.main` at published
             widths, f32 with TF32 off, batch 64, 2 epochs: `-mode ori`,
             then `-mode eval` and `-mode test` from one pretrain
             checkpoint per dataset; each test report equal to its eval
             run's. STFGNN's and STGODE's DTW graphs are built by the
             port's native library (`gptst_tpu_torch/native`), which
             must build here, in a fresh working directory (no cached
             graph). No kernel of `csrc/` launches.
  graph_predictors_model
             library train steps (1 warm, 3 timed) of the same five at
             2,048 nodes (`random_sensor_graph(2048)`), batch 16,
             published widths; STMGCN's Pearson graph and STFGNN's and
             STGODE's DTW graph are a second random sensor graph (seed
             1): ms per step, samples/s, peak device memory.
  last_predictors_cli
             ST_WA (PEMS08, 170 nodes) and DMVSTNET (NYC_BIKE, 250
             nodes) the same way as `graph_predictors_cli`; ST_WA's
             test-time latents come from the trainer's test generator.
  last_predictors_model
             library train steps of the same two at 2,048 nodes: ST_WA
             at batch 8 (its 16 windows keep a 2.15 GB softmax each),
             DMVSTNET at batch 16.
  profile    `torch.profiler` over 2 TGCN train steps on each graph (and
             on the CLI graph's halo support),
             2 MSDR train steps on the CLI graph, 2 GPT-ST pretrain
             steps of `gptst_model`'s shape, 2 eval-mode TGCN steps
             on the CLI graph (with the encoder's no-grad forward
             profiled alone as its share), 2 GWN steps of `gwn_cli`'s
             shape and 1 ST_WA step of `last_predictors_model`'s shape:
             device time by kernel group, the busy share and the 10
             costliest kernels.
  reference  a small ragged graph (1000 nodes) with and without RCM
             (DIA and block-CSR): the TGCN, MSDR (learned sparse
             adjacency, random nonzero weights) and eval-mode TGCN
             (encoder, head, TGCN at dim_in 64) forward and gradients
             with the kernels on the card against the plain versions on
             the CPU; TGCN at 1002 nodes through a halo and a ring
             `ShardedSupport` on 4 ranks of the card against 4 CPU ranks;
             GPT-ST's pretrain loss, `encode` and gradients at 64 nodes
             (hidden 16, mask_ratio 1.0), STGCN at 170 nodes, GWN on
             a directed 1,000-node graph with and without RCM, and
             MTGNN, CCRNN, STMGCN, ASTGCN, STSGCN, STFGNN, STGODE,
             ST_WA (both branches, its draws passed in) and DMVSTNET
             at 64 nodes, card against CPU.

Before the last line: one JSON object with every kernel's launches on
its main path, error, times and bound, and the card's name and power
limit from `nvidia-smi`. The ptxas reports go to `chiprun_out/`. The
last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PHASES = ("build", "bsr", "dia", "gwn_kernels", "sddmm", "dvals", "ring",
          "cli", "dia_model", "msdr_cli", "msdr_model", "sharded_model",
          "data_parallel", "gptst_graph", "predictors_graph",
          "last_predictors_graph", "final_predictors_graph",
          "distributed", "gptst_model",
          "gptst_cli", "device_data", "step_graph", "step_graph_cards",
          "eval_cli",
          "eval_model", "stgcn_cli", "gwn_cli", "gwn_model",
          "predictors_cli", "graph_predictors_cli", "graph_predictors_model",
          "last_predictors_cli", "last_predictors_model", "profile",
          "reference")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores,
# dense TF32 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
FLT_MAX = 3.4028234663852886e38

N_BIG = 16384
BATCH, UNITS = 16, 100
F_WIDE = BATCH * UNITS          # the h aggregations of a TGCN step
F_NARROW = BATCH * 1            # the x aggregation (input_base_dim 1)
# a data row's share of those at batch 16 on two rows (data_parallel)
F_ROW_WIDE, F_ROW_NARROW = F_WIDE // 2, F_NARROW // 2
# eval mode: TGCN's x is the 64-wide fused embedding (hidden_dim 64)
HIDDEN = 64
F_EVAL = BATCH * HIDDEN
# MSDR at its published width: rnn_units 64, so z = [x ‖ h] is 128 wide
MSDR_BATCH = 8
F_MSDR = MSDR_BATCH * 128       # every aggregation of an MSDR step
# TGCN's batch-major aggregation, the width of the node-sharded path:
# batch 16 x [x ‖ h] = 16 x (1 + 100)
F_RING = BATCH * (1 + UNITS)
ADAPT_RANK = 10
# GPT-ST pretrain: the JAX bench's flagship shape (16,384 nodes) at
# batch 8, and the CLI at PEMS08's own 170 nodes and batch 64
GPTST_BATCH = 8
GPTST_CLI_NODES, GPTST_CLI_BATCH = 170, 64
# time steps of the 16,384-node CLI runs: the fewest that leave 16 full
# train batches (TGCN at batch 16: 265 windows; MSDR at batch 8: 133),
# so the default K = 16 replays one chunk an epoch besides the tail
CLI_TIME_STEPS, MSDR_TIME_STEPS = 480, 260

# rtol of a bf16 output: a different summation order may flip the
# final rounding by one bf16 ulp (2^-8 relative, up to 2^-7 of the
# value); f32 outputs differ only by summation order. d block_vals sums
# ~1000 products of N(0, 1) values per slot in another order than the
# plain version's batched product, hence its atol.
TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 1e-6),
       "dvals": (1e-5, 1e-4)}


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


def road_coo(n: int, band: int = 48):
    """sym-normalized (A + I) of the road graph as an edge list (rows,
    cols, values), built without a dense (N, N) as the bench builds
    it."""
    import numpy as np

    rows, cols = road_graph_edges(n, 16, band)
    r = np.concatenate([rows, np.arange(n)])
    c = np.concatenate([cols, np.arange(n)])
    deg = np.bincount(r, minlength=n).astype(np.float64)
    return r, c, (1.0 / np.sqrt(deg[r] * deg[c])).astype(np.float32)


def road_support(n: int, band: int, device):
    """`road_coo`'s matrix as the one-device support."""
    from gptst_tpu_torch.ops.graph_conv import make_support_coo

    return make_support_coo(*road_coo(n, band), n, reorder=False,
                            device=device)


def msdr_cli_graph(n: int, device, seed: int = 0):
    """MSDR's static supports and learned-adjacency pattern on the graph
    the CLI synthesizes, built as `models/build.py:_build_msdr` builds
    them."""
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph
    from gptst_tpu_torch.models.build import msdr_adapt_pattern
    from gptst_tpu_torch.models.predictors.msdr import (
        dual_random_walk_supports,
    )
    from gptst_tpu_torch.ops.graph_conv import make_support

    mats = dual_random_walk_supports(random_sensor_graph(n, avg_degree=6,
                                                         seed=seed))
    return (tuple(make_support(m, device=device) for m in mats),
            msdr_adapt_pattern(mats[0], n, device))


def msdr_road_graph(device):
    """MSDR's dual random-walk supports of the road graph from its edge
    list ([(D^-1 A)^T, (D^-1 A^T)^T], no RCM, DIA band + COO tail) and
    the learned-adjacency pattern of the first one's blocked edges, as
    the JAX package's bench builds them (f32 values here)."""
    import numpy as np

    from gptst_tpu_torch.kernels.sddmm import SDDMMPattern
    from gptst_tpu_torch.kernels.spmm import BlockCSR, coo_split_mask
    from gptst_tpu_torch.ops.graph_conv import make_support_coo

    n = N_BIG
    r, c = road_graph_edges(n, 16, 48)
    deg_out = np.maximum(np.bincount(r, minlength=n), 1)
    deg_in = np.maximum(np.bincount(c, minlength=n), 1)
    v1 = (1.0 / deg_out[r]).astype(np.float32)
    sups = (make_support_coo(c, r, v1, n, reorder=False, device=device),
            make_support_coo(r, c, (1.0 / deg_in[c]).astype(np.float32), n,
                             reorder=False, device=device))
    assert all(s.dia is not None for s in sups)
    mk = coo_split_mask(c, r, n)
    return sups, SDDMMPattern.from_bcsr(BlockCSR.from_coo(
        c[mk], r[mk], v1[mk], n, device=device))


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


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device ms per call of each kernel `fn` launches, by its profile
    group (`KERNEL_GROUPS`, the value passes apart), from
    `torch.profiler` over `reps` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k, _ in KERNEL_GROUPS if k in e.name), e.name)
        out[name] = out.get(name, 0.0) + e.device_time / 1e3 / reps
    return out


def compare(got, want, kind: str) -> float:
    """Max abs error over the finite elements; raises unless each is
    within atol + rtol * |want|, NaNs sit in the same places and Infs
    are equal."""
    import torch

    rtol, atol = TOL[kind]
    g, w = got.float(), want.float()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError("kernel and plain version differ in NaNs")
    inf = torch.isinf(w)
    if not torch.equal(torch.isinf(g), inf) or not torch.equal(g[inf], w[inf]):
        raise AssertionError("kernel and plain version differ in Infs")
    fin = torch.isfinite(w)
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
    """Every finite correctness case of one kernel: structure (A, A^T) x
    width x dtype, with no block run densely; returns the f32
    wide-forward error."""
    import torch

    from gptst_tpu_torch.kernels.spmm import (
        dense_block_counts, reset_launch_counts,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    main_err = None
    reset_launch_counts()
    for sname, st, vals_attr in structs:
        for f in (F_ROW_NARROW, F_NARROW, F_EVAL, F_ROW_WIDE, F_WIDE):
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
    dense = dense_block_counts()
    assert not any(dense.values()), dense
    return main_err


def nonfinite_cases(name: str, kernel, plain, st, blocks, vals_attr: str):
    """The inputs whose dense block product needs zeros multiplied: a
    NaN in x where most rows of its blocks have no entry, an Inf in x
    (0 * Inf = NaN), a NaN and a finite nonzero written outside a
    block's entries. Each against the plain version; the kernel must
    count the blocks it ran densely."""
    import torch

    from gptst_tpu_torch.kernels.spmm import (
        dense_block_counts, entry_mask_bits, reset_launch_counts,
    )

    kname = f"{name}_spmm"
    tb = blocks.tile
    x = torch.randn(st.n, F_WIDE, device="cuda")
    b = int(blocks.block_ptr[1])          # the first block of row tile 1
    r, k = map(int, (~entry_mask_bits(blocks.entries.mask[b:b + 1], tb)[0])
               .nonzero()[0])
    node = int(blocks.block_cols[b]) * tb + 5
    for case in ("nan_x_under_zero_slot", "inf_x", "nan_value_off_entry",
                 "finite_value_off_entry"):
        s, xx = st, x
        if case in ("nan_x_under_zero_slot", "inf_x"):
            xx = x.clone()
            xx[node, 70] = float("nan" if case.startswith("nan") else "inf")
        else:
            v = getattr(st, vals_attr).clone()
            v.view(-1, tb, tb)[b, r, k] = float(
                "nan" if case.startswith("nan") else 0.5)
            s = dataclasses.replace(st, **{vals_attr: v})
        reset_launch_counts()
        got = kernel(s, xx)
        dense = dense_block_counts()[kname]
        err = compare(got, plain(s, xx), "f32")
        assert dense > 0, (case, dense)
        emit(name, case=case, max_abs_err=err, dense_blocks=dense,
             nan_rows=int(torch.isnan(got).any(dim=1).sum()),
             inf_values=int(torch.isinf(got).sum()),
             tol=dict(zip(("rtol", "atol"), TOL["f32"])))


def phase_build(rec: dict) -> None:
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

    # the graph the CLI synthesizes at 16,384 nodes; later phases reuse it
    rec["_cli_base"] = random_sensor_graph(N_BIG, avg_degree=6, seed=0)
    rec["_cli_sym"] = sym_adj(rec["_cli_base"])
    sup = make_support(rec["_cli_sym"], device="cuda")
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
    nonfinite_cases("bsr", K.bsr_spmm, K.bsr_spmm_plain, a, a, "block_vals")

    csr = bsr_csr(a)
    ms = time_ms(lambda: K.bsr_spmm(a, x))
    plain_ms = time_ms(lambda: K.bsr_spmm_plain(a, x))
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x))
    empty = without_entries(a, "block_vals")
    no_entries_ms = time_ms(lambda: K.bsr_spmm(empty, x))
    nnz = int(csr.values().numel())
    flops = 2 * nnz * F_WIDE
    nbytes = (nnzb * a.tile ** 2 * a.block_vals.element_size()
              + (a.block_ptr.numel() + nnzb) * 4
              + 2 * a.n * F_WIDE * x.element_size())
    rec["bsr_spmm"] = dict(
        name="bsr_spmm", route="cuda", launches_by_path={},
        source="gptst_tpu_torch/csrc/block_spmm.cu",
        replaces="gptst_tpu/kernels/spmm.py:213 (_spmm_kernel; also "
                 ":280 _spmm_kernel_stream, :369 _spmm_kernel_panel)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes), library_ms=lib_ms)
    emit("bsr", case="timing", shape=[a.n, F_WIDE], nnzb=nnzb, ms=ms,
         device_ms=device_ms_by_kernel(lambda: K.bsr_spmm(a, x)),
         plain_ms=plain_ms, library_ms=lib_ms, no_entries_ms=no_entries_ms,
         nnz=nnz, entries=int(a.entries.idx.numel()), flops=flops,
         bytes=nbytes, entry_bytes=entry_bytes(a),
         l2_bytes_computed=l2_bytes_computed(nnzb, a.tile, x),
         **bound(flops, nbytes), achieved_bytes_per_s=nbytes / ms * 1e3)
    eval_width_timing("bsr", K.bsr_spmm, K.bsr_spmm_plain, a, sup.bcsr_t,
                      csr, nnz, nbytes - 2 * a.n * F_WIDE * x.element_size())


def eval_width_timing(name, kernel, plain, a, a_t, csr, nnz,
                      struct_bytes) -> None:
    """Times at the eval-mode x width (F = 1,024): the kernel on A and
    on the transposed structure (the launch that carries the gradient
    into the head), the plain version and `torch.sparse.mm`; the bound
    counts the structure's `struct_bytes`, x and the output once."""
    import torch

    x = torch.randn(a.n, F_EVAL, device="cuda")
    ms = time_ms(lambda: kernel(a, x))
    nbytes = struct_bytes + 2 * a.n * F_EVAL * x.element_size()
    emit(name, case="timing_eval_width", shape=[a.n, F_EVAL], ms=ms,
         ms_transposed=time_ms(lambda: kernel(a_t, x)),
         plain_ms=time_ms(lambda: plain(a, x)),
         library_ms=time_ms(lambda: torch.sparse.mm(csr, x)),
         **bound(2 * nnz * F_EVAL, nbytes))


def entry_bytes(a) -> int:
    """Bytes of a structure's entry lists (row pointer, indices, mask),
    which the design reads besides the function's operands."""
    e = a.entries
    return 4 * (e.ptr.numel() + e.idx.numel() + e.mask.numel())


def l2_bytes_computed(nblocks: int, tile: int, x) -> int:
    """The gather's L2-to-SM traffic as the design implies it, computed
    from this call's shapes (not a counter reading): one staged (TB x 64)
    x tile per (stored block, feature tile)."""
    return nblocks * -(-x.shape[1] // 64) * tile * 64 * x.element_size()


def without_entries(st, vals_attr: str):
    """The block structure `st` with zero values (`vals_attr`) and no
    entries: the gather still runs the value pass and stages and checks
    every x tile, but sums nothing. Its time is the floor under the entry
    sums."""
    import torch

    from gptst_tpu_torch.kernels.spmm import EntryLists

    e = st.entries
    return dataclasses.replace(
        st, **{vals_attr: torch.zeros_like(getattr(st, vals_attr))},
        entries=EntryLists(ptr=torch.zeros_like(e.ptr), idx=e.idx[:0],
                           mask=torch.zeros_like(e.mask)))


def bound(flops: float, nbytes: float) -> dict:
    """Least time for the work the product needs: 2 FLOPs per stored
    nonzero and column over the FP32 rate, or the bytes of the stored
    values, indices, x and out, each once, over the HBM rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bound_3xtf32(flops: float, nbytes: float, ms: float) -> dict:
    """The bounds of a 3xTF32 kernel (`csrc/tf32x3.cuh`): `bound_ms` on
    the units it uses, three TF32 products per f32 product at the
    tensor cores' rate, or its bytes over the HBM rate; `bound_ms_fp32`
    the FP32-pipe bound of the earlier designs; the achieved f32 rate
    and each bound's share of `ms`."""
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    fp32 = bound(flops, nbytes)
    line = {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_fp32": fp32["bound_ms"],
            "bound_by_fp32": fp32["bound_by"],
            "achieved_tflops": flops / ms / 1e9}
    line["of_bound"] = line["bound_ms"] / ms
    line["of_bound_fp32"] = line["bound_ms_fp32"] / ms
    return line


def phase_dia(rec: dict) -> None:
    import torch

    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.kernels.spmm import (
        dense_block_counts, reset_launch_counts,
    )

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
    reset_launch_counts()
    got = K.dia_spmm(d, xn)
    compare(got, K.dia_spmm_plain(d, xn), "f32")
    dense = dense_block_counts()["dia_spmm"]
    assert dense > 0, dense
    emit("dia", case="nan_in_x_clamped_window",
         nan_rows=int(torch.isnan(got).any(dim=1).sum()), dense_blocks=dense)
    nonfinite_cases("dia", K.dia_spmm, K.dia_spmm_plain, d, d.blocks(),
                    "vals")

    rt, nd, tb = d.row_tiles, 2 * d.w + 1, d.tile
    csr = dia_csr(d)
    ms = time_ms(lambda: K.dia_spmm(d, x))
    plain_ms = time_ms(lambda: K.dia_spmm_plain(d, x))
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x))
    empty = without_entries(d, "vals")
    no_entries_ms = time_ms(lambda: K.dia_spmm(empty, x))
    nnz = int(torch.count_nonzero(d.vals))
    flops = 2 * nnz * F_WIDE
    nbytes = (d.vals.numel() * d.vals.element_size()
              + 2 * d.n * F_WIDE * x.element_size())
    rec["dia_spmm"] = dict(
        name="dia_spmm", route="cuda", launches_by_path={},
        source="gptst_tpu_torch/csrc/block_spmm.cu",
        replaces="gptst_tpu/kernels/spmm.py:784 (_dia_kernel; also "
                 ":813 _dia_kernel_ring)",
        max_abs_err=errs[N_BIG], ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes), library_ms=lib_ms)
    emit("dia", case="timing", shape=[d.n, F_WIDE], ms=ms,
         device_ms=device_ms_by_kernel(lambda: K.dia_spmm(d, x)),
         plain_ms=plain_ms, library_ms=lib_ms, no_entries_ms=no_entries_ms,
         nnz=nnz, entries=int(d.entries.idx.numel()), flops=flops,
         bytes=nbytes, entry_bytes=entry_bytes(d),
         l2_bytes_computed=l2_bytes_computed(rt * nd, tb, x),
         **bound(flops, nbytes), achieved_bytes_per_s=nbytes / ms * 1e3)
    eval_width_timing("dia", K.dia_spmm, K.dia_spmm_plain, d, sup.dia_t, csr,
                      nnz, d.vals.numel() * d.vals.element_size())


def phase_sddmm(rec: dict) -> None:
    import torch

    from gptst_tpu_torch.kernels import sddmm as S

    rec["_msdr"] = {"cli_graph": msdr_cli_graph(N_BIG, "cuda"),
                    "road_graph": msdr_road_graph("cuda")}
    pats = rec["_patterns"] = {k: g[1] for k, g in rec["_msdr"].items()}
    pats["ragged_1000"] = msdr_cli_graph(1000, "cuda", seed=3)[1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, p in pats.items():
        real = int(p.ptr[-1])
        e1 = torch.randn(p.n, ADAPT_RANK, device="cuda", generator=gen)
        e2 = torch.randn(ADAPT_RANK, p.n, device="cuda", generator=gen)
        # a NaN outside row tile 0 (the pad blocks' tile): it reaches
        # every slot of its row in its row tile's blocks, masked or not
        r = p.n - 3
        e1n = e1.clone()
        e1n[r, 4] = float("nan")
        cases = [("f32", e1, e2), ("bf16", e1.bfloat16(), e2.bfloat16()),
                 ("f32_bf16", e1, e2.bfloat16()), ("nan_in_e1", e1n, e2)]
        for cname, a, b in cases:
            got = S.sddmm_blocks(p, a, b)
            torch.cuda.synchronize()
            err = compare(got, S.sddmm_plain(p, a, b), "f32")
            assert not got[real:].any(), "pad blocks not zero"
            nan_slots = int(torch.isnan(got).sum())
            if cname == "nan_in_e1":
                assert nan_slots == int((p.row_ids == r // p.tile).sum()) \
                    * p.tile, nan_slots
            emit("sddmm", pattern=name, case=cname, max_abs_err=err,
                 nan_slots=nan_slots, tol=dict(zip(("rtol", "atol"),
                                                   TOL["f32"])))
            if name == "cli_graph" and cname == "f32":
                main_err = err
        if name == "ragged_1000":
            continue
        nnz = int(p.mask.sum())
        csr = csr_of(p.mask, p.row_ids.long(), p.cols.long(), p.tile, p.n)
        ms = time_ms(lambda: S.sddmm_blocks(p, e1, e2))
        plain_ms = time_ms(lambda: S.sddmm_plain(p, e1, e2))
        lib_ms = time_ms(lambda: torch.sparse.sampled_addmm(csr, e1, e2,
                                                            beta=0.0))
        # each alone on the device: the event times above also hold the
        # wrapper's host time when the host lags the card
        dev = {"sddmm_blocks": device_ms_by_kernel(
                   lambda: S.sddmm_blocks(p, e1, e2)),
               "sampled_addmm": device_ms_by_kernel(
                   lambda: torch.sparse.sampled_addmm(csr, e1, e2,
                                                      beta=0.0))}
        # the function's own work: rank-10 dots at the pattern entries;
        # its bytes: mask in and blocks out (pad blocks included), the
        # embeddings and the block indices, each once
        flops = 2 * nnz * ADAPT_RANK
        nbytes = (2 * p.mask.numel() * 4 + 2 * p.n * ADAPT_RANK * 4
                  + 2 * p.nnzb * 4)
        line = dict(ms=ms, device_ms=dev["sddmm_blocks"]["sddmm_kernel"],
                    plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=sum(dev["sampled_addmm"].values()),
                    **bound(flops, nbytes))
        emit("sddmm", pattern=name, case="timing", nnzb=real,
             pattern_nnz=nnz, flops=flops, bytes=nbytes, **line,
             device_ms_by_kernel=dev,
             achieved_bytes_per_s=nbytes / ms * 1e3)
        if name == "cli_graph":
            rec["sddmm"] = dict(
                name="sddmm", route="cuda",
                source="gptst_tpu_torch/csrc/sddmm.cu",
                replaces="gptst_tpu/kernels/sddmm.py:116 (_sddmm_kernel)",
                max_abs_err=main_err, **line)


def phase_dvals(rec: dict) -> None:
    import torch

    from gptst_tpu_torch.kernels import spmm as K

    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, p in rec["_patterns"].items():
        real, n, tb = int(p.ptr[-1]), p.n, p.tile
        a = K.BlockCSR(block_ptr=p.ptr, block_cols=p.cols, block_vals=p.mask,
                       n=n, n_pad=p.n_pad, tile=tb)
        for f in (F_MSDR, 1000):
            g = torch.randn(n, f, device="cuda", generator=gen)
            x = torch.randn(n, f, device="cuda", generator=gen)
            # a NaN in x at node r reaches column r % TB of exactly the
            # blocks whose column tile holds r
            r = n // 3
            xn = x.clone()
            xn[r, 7] = float("nan")
            # an Inf in x: +-Inf where g is nonzero, NaN where g is 0
            # (every other node); FLT_MAX (the top binade, where rounding
            # to TF32 would overflow) under |g| <= 0.5 stays finite
            gi = g.clone()
            gi[::2, 7] = 0.0
            xi = x.clone()
            xi[r, 7] = float("inf")
            gm = g.clone()
            gm[:, 7] = gm[:, 7].clamp(-0.5, 0.5)
            xm = x.clone()
            xm[r, 7] = FLT_MAX
            cases = [("f32", g, x), ("bf16", g.bfloat16(), x.bfloat16()),
                     ("bf16_g", g.bfloat16(), x), ("nan_in_x", g, xn),
                     ("inf_in_x", gi, xi), ("flt_max_in_x", gm, xm)]
            for cname, gg, xx in cases:
                got = K.spmm_dvals(a, gg, xx)
                torch.cuda.synchronize()
                err = compare(got, K.spmm_dvals_plain(a, gg, xx), "dvals")
                assert not got[real:].any(), "pad blocks not zero"
                nan_slots = int(torch.isnan(got).sum())
                inf_slots = int(torch.isinf(got).sum())
                hit = int((p.cols[:real] == r // tb).sum())
                if cname == "nan_in_x":
                    assert nan_slots == hit * tb, nan_slots
                if cname == "inf_in_x":
                    assert nan_slots > 0 and inf_slots > 0
                    assert nan_slots + inf_slots == hit * tb
                if cname == "flt_max_in_x":
                    assert nan_slots == inf_slots == 0
                    assert float(got.abs().max()) > 1e37
                emit("dvals", pattern=name, case=f"F{f}_{cname}",
                     max_abs_err=err, nan_slots=nan_slots,
                     inf_slots=inf_slots,
                     tol=dict(zip(("rtol", "atol"), TOL["dvals"])))
                if name == "cli_graph" and f == F_MSDR and cname == "f32":
                    main_err = err
        if name == "ragged_1000":
            continue
        g = torch.randn(n, F_MSDR, device="cuda", generator=gen)
        x = torch.randn(n, F_MSDR, device="cuda", generator=gen)
        xt = x.t().contiguous()
        rows, cols = p.row_ids[:real].long(), p.cols[:real].long()
        slots = csr_of(torch.ones_like(p.mask[:real]), rows, cols, tb, n)
        edges = csr_of(p.mask[:real], rows, cols, tb, n)
        ms = time_ms(lambda: K.spmm_dvals(a, g, x))
        # the kernel's own device time: `ms` brackets each call with
        # events, so a wrapper slower than its kernel shows in it
        device_ms = device_ms_by_kernel(
            lambda: K.spmm_dvals(a, g, x))["spmm_dvals_kernel"]
        plain_ms = time_ms(lambda: K.spmm_dvals_plain(a, g, x))
        lib_ms = time_ms(lambda: torch.sparse.sampled_addmm(slots, g, xt,
                                                            beta=0.0))
        lib_edges_ms = time_ms(lambda: torch.sparse.sampled_addmm(
            edges, g, xt, beta=0.0))
        # the function computes every slot of each stored block (the
        # softmax mask zeroes most of them downstream, which is not this
        # function's business): 2 * TB^2 * F FLOPs per real block; bytes
        # of g, x, the blocks out (pad blocks included) and the indices
        flops = 2 * real * tb * tb * F_MSDR
        nbytes = (2 * n * F_MSDR * 4 + p.mask.numel() * 4
                  + (p.ptr.numel() + p.nnzb) * 4)
        line = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, **bound_3xtf32(flops, nbytes, ms))
        emit("dvals", pattern=name, case="timing", shape=[n, F_MSDR],
             nnzb=real, slots=real * tb * tb,
             pattern_nnz=int(edges.values().numel()), flops=flops,
             bytes=nbytes, **line,
             library_ms_pattern_entries_only=lib_edges_ms)
        if name == "cli_graph":
            rec["spmm_dvals"] = dict(
                name="spmm_dvals", route="cuda",
                source="gptst_tpu_torch/csrc/spmm_dvals.cu",
                replaces="gptst_tpu/kernels/spmm.py:604 (_dvals_kernel)",
                max_abs_err=main_err, **line)
    # MSDR's batch-major layout: every aggregation folds its (B, N, Z)
    # operand into the kernels' node-major (N, B*Z) with a copy and
    # unfolds the result; `spmm_dvals` folds g and x
    z = torch.randn(MSDR_BATCH, N_BIG, 128, device="cuda", generator=gen)
    zf = K._fold(z, N_BIG)
    rec["_fold_ms"] = {"fold": time_ms(lambda: K._fold(z, N_BIG)),
                       "unfold": time_ms(lambda: K._unfold(zf, z))}
    emit("dvals", case="fold", shape=list(z.shape), **rec["_fold_ms"])


def ring_kernels_only(R, a_rot, bufs, accs, outs, streams) -> None:
    """The P^2 step kernels of one ring call on the same per-rank
    streams, without the copies and their events."""
    import torch

    from gptst_tpu_torch.kernels.build import load

    lib = load("ring_spmm")
    cur = torch.cuda.current_stream()
    parts = len(a_rot)
    for p in range(parts):
        streams[p].wait_stream(cur)
        for s in range(parts):
            R.ring_step(lib, a_rot[p], s, bufs[p][s % 2], accs[p],
                        outs[p] if s == parts - 1 else None, streams[p])
    for p in range(parts):
        cur.wait_stream(streams[p])


def ring_case(rec: dict, name: str, adj, feat: int, parts: int,
              main: bool = False) -> dict:
    """`make_fused_ring_spmm` on P ranks of cuda:0: f32, bf16 and NaN x
    against the plain version on the card, then the timings. With
    `main`, the first call is the main path's, counted alone."""
    import numpy as np
    import torch

    from gptst_tpu_torch.kernels import halo_spmm as R
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.parallel.halo import (
        make_ring_spmm, partition_adjacency,
    )
    from gptst_tpu_torch.parallel.mesh import (
        gather_rows, make_mesh, shard_rows,
    )

    mesh = make_mesh(devices=["cuda:0"] * parts, graph_axis_size=parts)
    fn, n_pad = R.make_fused_ring_spmm(mesh, adj, feat)
    n_loc = n_pad // parts
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n_pad, feat, device="cuda", generator=gen)
    x[adj.shape[0]:] = 0.0
    xs = shard_rows(x, mesh)
    line = {"case": name, "n": adj.shape[0], "n_pad": n_pad, "feat": feat,
            "parts": parts}
    if main:
        reset_launch_counts()
        got = fn(xs)
        torch.cuda.synchronize()
        line["launches"] = LAUNCHES["ring_spmm"]
        assert dict(LAUNCHES, ring_spmm=0) == dict.fromkeys(LAUNCHES, 0)
    else:
        got = fn(xs)
    blocks = R._rotate_blocks(partition_adjacency(adj, parts))
    a_rot = [torch.as_tensor(b, device="cuda") for b in blocks]
    a_pad = [torch.as_tensor(b, device="cuda") for b in R._pad_blocks(blocks)]
    del blocks
    errs = {"f32": compare(gather_rows(got, x.device),
                           gather_rows(R.ring_spmm_plain(a_rot, xs), x.device),
                           "f32")}
    xb = shard_rows(x.bfloat16(), mesh)
    before = LAUNCHES["ring_spmm"]
    gb = fn(xb)
    assert LAUNCHES["ring_spmm"] - before == parts * parts
    assert all(g.dtype == torch.bfloat16 for g in gb)
    errs["bf16"] = compare(gather_rows(gb, x.device),
                           gather_rows(R.ring_spmm_plain(a_rot, xb), x.device),
                           "bf16")
    # a NaN in one x row reaches every output row of its column, on every
    # rank: the kernel multiplies dense blocks, zeros included
    xn = x.clone()
    xn[n_pad // 3, feat // 2] = float("nan")
    xns = shard_rows(xn, mesh)
    gn = gather_rows(fn(xns), x.device)
    compare(gn, gather_rows(R.ring_spmm_plain(a_rot, xns), x.device), "f32")
    nan = torch.isnan(gn)
    assert bool(nan[:, feat // 2].all()) and int(nan.sum()) == n_pad
    # an Inf in one x row: +Inf in every output row of its column whose
    # weight is nonzero, NaN (0 * Inf) in the others
    xi = x.clone()
    xi[n_pad // 3, feat // 2] = float("inf")
    xis = shard_rows(xi, mesh)
    gi = gather_rows(fn(xis), x.device)
    errs["inf_x"] = compare(
        gi, gather_rows(R.ring_spmm_plain(a_rot, xis), x.device), "f32")
    col = gi[:, feat // 2]
    assert bool(torch.isinf(col).any()) and bool(torch.isnan(col).any())
    assert int((~torch.isfinite(gi)).sum()) == n_pad
    # FLT_MAX (the top binade, where rounding to TF32 would overflow),
    # alone in its column, under weights <= 1: finite everywhere
    xm = x.clone()
    xm[:, feat // 2] = 0.0
    xm[n_pad // 3, feat // 2] = FLT_MAX
    xms = shard_rows(xm, mesh)
    gm = gather_rows(fn(xms), x.device)
    errs["flt_max_x"] = compare(
        gm, gather_rows(R.ring_spmm_plain(a_rot, xms), x.device), "f32")
    assert bool(torch.isfinite(gm).all()) and float(gm.abs().max()) > 1e36
    line.update(max_abs_err=errs, nan_rows=int(nan.any(dim=1).sum()),
                inf_x_inf_rows=int(torch.isinf(col).sum()),
                inf_x_nan_rows=int(torch.isnan(col).sum()),
                tol={k: dict(zip(("rtol", "atol"),
                                 TOL["bf16" if k == "bf16" else "f32"]))
                     for k in errs})

    # timings (CUDA events, median of 20)
    bufs = [torch.zeros(2, feat, R._ring_k(n_loc), device="cuda")
            for _ in range(parts)]
    accs = [torch.zeros(n_loc, feat, device="cuda") for _ in range(parts)]
    outs = [torch.zeros(n_loc, feat, device="cuda") for _ in range(parts)]
    streams = [torch.cuda.Stream() for _ in range(parts)]
    ring_fn, _ = make_ring_spmm(mesh, adj)
    a_dense = torch.zeros(n_pad, n_pad, device="cuda")
    a_dense[:adj.shape[0], :adj.shape[0]] = torch.as_tensor(
        np.asarray(adj, np.float32), device="cuda")
    line.update(
        ms=time_ms(lambda: fn(xs)),
        kernels_only_ms=time_ms(lambda: ring_kernels_only(
            R, a_pad, bufs, accs, outs, streams)),
        plain_ms=time_ms(lambda: R.ring_spmm_plain(a_rot, xs)),
        make_ring_spmm_ms=time_ms(lambda: ring_fn(x)),
        library_ms=time_ms(lambda: torch.matmul(a_dense, x)))
    torch.testing.assert_close(ring_fn(x), torch.matmul(a_dense, x),
                               rtol=1e-5, atol=1e-5)
    # the work the function does: dense blocks, 2 n_pad^2 F FLOPs; its
    # bytes: the blocks, x and out once, and each of the P (P - 1) shard
    # copies read and written once
    flops = 2 * n_pad * n_pad * feat
    nbytes = (n_pad * n_pad * 4 + 2 * n_pad * feat * 4
              + 2 * parts * (parts - 1) * n_loc * feat * 4)
    line.update(flops=flops, bytes=nbytes,
                **bound_3xtf32(flops, nbytes, line["ms"]),
                kernels_only_tflops=flops / line["kernels_only_ms"] / 1e9)
    emit("ring", **line)
    del a_rot, a_pad, a_dense
    torch.cuda.empty_cache()
    return line


def ring_distinct_cards(rec: dict) -> None:
    """The 16,384-node case once more with one rank per card, when there
    are at least 2 cards: against the same ring on ranks of cuda:0, and
    timed on the host clock (median of 20 calls, each followed by a
    synchronize of every card)."""
    import torch

    from gptst_tpu_torch.kernels import halo_spmm as R
    from gptst_tpu_torch.parallel.mesh import (
        gather_rows, make_mesh, shard_rows,
    )

    count = torch.cuda.device_count()
    if count < 2:
        emit("ring", case="distinct_cards", cards=count,
             run=False, why="one card visible")
        return
    parts = min(4, count)
    adj = rec["_cli_sym"]
    devs = [f"cuda:{i}" for i in range(parts)]
    mesh = make_mesh(devices=devs, graph_axis_size=parts)
    one = make_mesh(devices=["cuda:0"] * parts, graph_axis_size=parts)
    fn, n_pad = R.make_fused_ring_spmm(mesh, adj, F_RING)
    ref, _ = R.make_fused_ring_spmm(one, adj, F_RING)
    x = torch.randn(n_pad, F_RING, device="cuda:0")
    xs = shard_rows(x, mesh)
    err = compare(gather_rows(fn(xs), x.device),
                  gather_rows(ref(shard_rows(x, one)), x.device), "f32")
    del ref

    def call():
        fn(xs)
        for d in devs:
            torch.cuda.synchronize(d)

    for _ in range(3):
        call()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    emit("ring", case="distinct_cards", cards=parts, run=True,
         max_abs_err=err, host_ms=statistics.median(times))


def phase_ring(rec: dict) -> None:
    """The fused ring at TGCN's batch-major width on the CLI graph (the
    main path), at `scripts/halo_bench.py`'s default and at
    `dryrun_multichip`'s shape."""
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj

    main = ring_case(rec, "tgcn_cli_graph", rec["_cli_sym"], F_RING, 4,
                     main=True)
    assert main["launches"] == 16, main
    bench = sym_adj(random_sensor_graph(4096, avg_degree=8, seed=0))
    for parts in (2, 8):
        ring_case(rec, f"halo_bench_P{parts}", bench, 128, parts)
    ring_case(rec, "dryrun_multichip",
              sym_adj(random_sensor_graph(172, avg_degree=6, seed=0)), 64, 4)
    ring_distinct_cards(rec)
    rec["ring_spmm"] = dict(
        name="ring_spmm", route="cuda",
        source="gptst_tpu_torch/csrc/ring_spmm.cu",
        replaces="gptst_tpu/kernels/halo_spmm.py:39 (_ring_kernel, "
                 "called at :112)",
        launches=main["launches"], max_abs_err=main["max_abs_err"]["f32"],
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "bound_ms_fp32", "bound_by_fp32",
                                "achieved_tflops", "of_bound",
                                "of_bound_fp32")})


class HostCopies:
    """Counts the host-to-device copies made while `active`: the
    results on a CUDA device of `Tensor.to`, `Tensor.cuda`, `Tensor.
    copy_`, `torch.as_tensor` and `torch.tensor` from host memory (a CPU
    tensor, a numpy array, a Python value); `batch_copies` are those of
    4-d (B, T, N, D) tensors. A context manager: patches on enter,
    restores on exit."""

    def __init__(self):
        self.active = False
        self.copies = self.batch_copies = self.bytes = 0

    def _count(self, from_host: bool, out) -> None:
        import torch

        if (self.active and from_host and isinstance(out, torch.Tensor)
                and out.is_cuda):
            self.copies += 1
            self.bytes += out.nbytes
            self.batch_copies += out.dim() == 4

    def __enter__(self):
        import torch

        def on_host(a) -> bool:
            return not (isinstance(a, torch.Tensor) and a.is_cuda)

        T = torch.Tensor
        self._saved = [(T, "to", T.to), (T, "cuda", T.cuda),
                       (T, "copy_", T.copy_),
                       (torch, "as_tensor", torch.as_tensor),
                       (torch, "tensor", torch.tensor)]
        to, cuda, copy_, as_tensor, tensor = (f for *_, f in self._saved)

        def counted(fn, src):
            def call(*args, **kw):
                out = fn(*args, **kw)
                self._count(on_host(src(args, kw)), out)
                return out
            return call

        def first(args, kw):
            return args[0] if args else kw.get("data")

        T.to, T.cuda = counted(to, first), counted(cuda, first)
        T.copy_ = counted(copy_, lambda args, kw: (
            args[1] if len(args) > 1 else kw["src"]))
        torch.as_tensor = counted(as_tensor, first)
        torch.tensor = counted(tensor, first)
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def split_bytes(tr) -> dict:
    """The bytes of a trainer's resident train split on each device
    (empty on the host path): the (x, y) pair on its device, or under a
    mesh each device's parts (`parallel/mesh.ResidentSplit`)."""
    split = tr.train_split
    if split is None:
        return {}
    out: dict = {}
    for t in split if isinstance(split, tuple) else split.tensors():
        out[str(t.device)] = out.get(str(t.device), 0) + t.nbytes
    return out


class TrainProbe:
    """Watches `Trainer`'s train steps while entered (`_train_batch`,
    one step, and `_train_steps`, a chunk through `StepGraph`): the
    kernels' launches inside them (`in_steps`, replays included), the
    host-to-device copies inside them (`copies`, a `HostCopies`) and
    the bytes of each trainer's resident train split (`split_bytes`, 0
    on the host path). With `keep` it also keeps each trainer
    (`trainers`); without, the split is freed with the run."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.trainers: list = []

    def __enter__(self):
        from gptst_tpu_torch.kernels.spmm import LAUNCHES
        from gptst_tpu_torch.train.trainer import Trainer

        self.in_steps = dict.fromkeys(LAUNCHES, 0)
        self.split_bytes: list[int] = []
        self.copies = HostCopies().__enter__()
        self._saved = (Trainer._train_batch, Trainer._train_steps,
                       Trainer.train)
        train_batch, train_steps, train = self._saved

        def counting(fn):
            def counted(tr, *args):
                before = dict(LAUNCHES)
                self.copies.active = True
                try:
                    return fn(tr, *args)
                finally:
                    self.copies.active = False
                    for k in self.in_steps:
                        self.in_steps[k] += LAUNCHES[k] - before[k]
            return counted

        def keep(tr, *args, **kw):
            self.split_bytes.append(sum(split_bytes(tr).values()))
            if self.keep:
                self.trainers.append(tr)
            return train(tr, *args, **kw)

        Trainer._train_batch, Trainer._train_steps, Trainer.train = (
            counting(train_batch), counting(train_steps), keep)
        return self

    def __exit__(self, *exc) -> None:
        from gptst_tpu_torch.train.trainer import Trainer

        (Trainer._train_batch, Trainer._train_steps,
         Trainer.train) = self._saved
        self.copies.__exit__(*exc)

    def line(self, steps: int) -> dict:
        """The probe's fields of a phase line, `steps` train steps."""
        (split,) = self.split_bytes
        return dict(resident_split_bytes=split,
                    h2d_copies_in_train_steps=self.copies.copies,
                    h2d_batch_copies_in_train_steps=self.copies.batch_copies,
                    h2d_bytes_in_train_steps=self.copies.bytes,
                    launches_per_train_step={
                        k: v / steps for k, v in self.in_steps.items()})


def run_cli(model: str, batch: int, num_steps: int, epochs: int = 2,
            extra: tuple = ()) -> dict:
    """`gptst_tpu_torch.run.main` with `-mode ori -model <model>` at
    16,384 nodes from a PEMS08.npz of that size and `num_steps` time
    steps, and the arguments `extra`. Checks the losses and metrics are
    finite and returns what the phase line reports, with the launches
    of the whole run and of its train steps alone, and `TrainProbe`'s
    fields."""
    import numpy as np
    import torch

    from gptst_tpu_torch.kernels.spmm import (
        LAUNCHES, dense_block_counts, reset_launch_counts,
    )
    from gptst_tpu_torch.run import main

    with tempfile.TemporaryDirectory() as tmp:
        data = write_pems08(tmp, N_BIG, num_steps)
        metrics = os.path.join(tmp, "metrics.json")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with TrainProbe() as probe:
            main(["-dataset", "PEMS08", "-mode", "ori", "-model", model,
                  "-num_nodes", str(N_BIG), "-data_root", data,
                  "-batch_size", str(batch),
                  "-epochs", str(epochs), "-lr_decay", "False",
                  "-early_stop", "False", "-log_dir",
                  os.path.join(tmp, "save"), "-log_step", "1000",
                  "-metrics_out", metrics, *extra])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        dense = dense_block_counts()
        with open(metrics) as f:
            rep = json.load(f)
    vals = np.asarray(rep["per_horizon"] + [rep["average"]], np.float64)
    assert np.isfinite(vals).all() and np.isfinite(rep["history"]).all()
    # the training steps (and evaluation) gathered entries only
    assert not any(dense.values()), dense
    steps = rep["steps_per_epoch"]
    peak = torch.cuda.max_memory_allocated()
    return dict(
        nodes=N_BIG, batch=batch, epochs=epochs, time_steps=num_steps,
        extra_args=list(extra), steps_per_epoch=steps,
        ms_per_step_by_epoch=[s / steps * 1e3 for s in rep["epoch_seconds"]],
        samples_per_s_last_epoch=steps * batch / rep["epoch_seconds"][-1],
        train_loss_by_epoch=rep["history"], best_loss=rep["best_loss"],
        test_average=rep["average"], max_memory_allocated=peak,
        held_before=held, peak_over_held=peak - held,
        launches=launches, dense_blocks=dense,
        **probe.line(epochs * steps), wall_s=wall)


def phase_cli(rec: dict) -> None:
    line = run_cli("TGCN", BATCH, num_steps=CLI_TIME_STEPS)
    launches = line["launches"]
    assert launches["bsr_spmm"] > 0 and launches["dia_spmm"] == 0, launches
    rec["bsr_spmm"]["launches"] = launches["bsr_spmm"]
    rec["bsr_spmm"]["launches_by_path"]["cli"] = launches["bsr_spmm"]
    rec["_cli_run"] = line
    emit("cli", model="TGCN", rnn_units=UNITS, **line)


def phase_msdr_cli(rec: dict) -> None:
    line = run_cli("MSDR", MSDR_BATCH, num_steps=MSDR_TIME_STEPS)
    launches = line["launches"]
    for k in ("bsr_spmm", "sddmm", "spmm_dvals"):
        assert launches[k] > 0, launches
    rec["sddmm"]["launches"] = launches["sddmm"]
    rec["spmm_dvals"]["launches"] = launches["spmm_dvals"]
    # the fold copies of a train step: timed calls x counted calls
    per, fold = line["launches_per_train_step"], rec["_fold_ms"]
    fold_ms = ((per["bsr_spmm"] + per["dia_spmm"])
               * (fold["fold"] + fold["unfold"])
               + 2 * per["spmm_dvals"] * fold["fold"])
    emit("msdr_cli", model="MSDR", rnn_units=64, **line,
         fold_ms_per_train_step_estimate=fold_ms)


def tgcn_net():
    """TGCN at its published widths, random weights from seed 0."""
    import torch

    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig

    return TGCN(TGCNConfig(num_nodes=N_BIG), dim_in=1, dim_out=1, horizon=12,
                generator=torch.Generator().manual_seed(0)).to("cuda")


def msdr_net():
    """MSDR at its published widths (rnn_units 64, 2 layers, pre_k 4,
    adapt_rank 10), random weights from seed 0."""
    import torch

    from gptst_tpu_torch.models.predictors.msdr import MSDR, MSDRConfig

    return MSDR(MSDRConfig(num_nodes=N_BIG), dim_in=1, dim_out=1,
                generator=torch.Generator().manual_seed(0)).to("cuda")


def bind(model: str, net, graph: tuple, dataset: str = "PEMS08"):
    """`net` bound to its graph arguments in the ori-mode contract, as
    `models/build.py` binds them."""
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import GraphPredictor, predictor_forward

    return predictor_forward(default_config(dataset, mode="ori", model=model),
                             GraphPredictor(net, *graph))


def run_steps(step, warm: int, steps: int, trace: str | None = None):
    """`step(i)` for i = 1 .. warm + steps, each returning a loss; the
    last `steps` are timed (host clock, synchronized) and, with
    `trace`, profiled into that file. Returns the losses (all finite)
    and ms per timed step."""
    import numpy as np
    import torch

    losses = [step(i) for i in range(1, warm + 1)]
    torch.cuda.synchronize()
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    losses += [step(i) for i in range(warm + 1, warm + steps + 1)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(trace)
    losses = [float(v) for v in losses]
    assert np.isfinite(losses).all(), losses
    return losses, dt * 1e3


def train_steps(model: str, forward, batch: int, warm: int,
                steps: int, trace: str | None = None, nodes: int = N_BIG,
                dataset: str = "PEMS08", loss_func: str = "mask_mae",
                mesh=None):
    """Train steps of a `model` module in the ori-mode contract, through
    the port's library, on random (batch, 12, nodes, base + 2) data of
    `dataset` from seed 0 under `loss_func`; with `mesh`, data-parallel
    over its data rows (`parallel/spmd.DataParallel`, the trainer's
    step under a mesh). Returns the losses, ms per timed step, the
    kernel launches of all steps and their dense-block counts (the
    rows' forward launches are in `parallel.rows.ROW_LAUNCHES`), and
    (with `trace`) writes the timed steps' profiler trace."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.kernels.spmm import (
        LAUNCHES, dense_block_counts, reset_launch_counts,
    )
    from gptst_tpu_torch.parallel.rows import ROW_LAUNCHES
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import (
        make_loss_terms, model_forwards, train_step,
    )
    from gptst_tpu_torch.train.trainer import make_optimizer

    cfg = default_config(dataset, mode="ori", model=model,
                         num_nodes=nodes, batch_size=batch, lr_decay=False)
    opt = make_optimizer(cfg, forward.parameters(), steps_per_epoch=10)
    loss_terms = make_loss_terms(
        forward, build_loss(loss_func, 200.0, 100.0, 0.0, False), cfg,
        forward=None if mesh is None else model_forwards(forward, cfg,
                                                         mesh)[1])
    rng = np.random.default_rng(0)
    shape = (batch, cfg.lag, nodes, cfg.input_base_dim + 2)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
    reset_launch_counts()
    ROW_LAUNCHES.clear()
    losses, ms = run_steps(lambda i: train_step(loss_terms, opt, x, y)[0],
                           warm, steps, trace)
    return losses, ms, dict(LAUNCHES), dense_block_counts()


def phase_dia_model(rec: dict) -> None:
    import torch

    sup = road_support(N_BIG, 48, "cuda")
    rec["_supports"]["road_graph"] = sup
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 2, 5
    losses, ms, launches, dense = train_steps(
        "TGCN", bind("TGCN", tgcn_net(), (sup,)), BATCH, warm, steps)
    assert launches["dia_spmm"] > 0 and launches["bsr_spmm"] == 0, launches
    assert not any(dense.values()), dense
    rec["dia_spmm"]["launches"] = launches["dia_spmm"]
    rec["dia_spmm"]["launches_by_path"]["dia_model"] = launches["dia_spmm"]
    rec["_road_losses"] = losses
    emit("dia_model", nodes=N_BIG, batch=BATCH, rnn_units=UNITS,
         steps=warm + steps, ms_per_step=ms, samples_per_s=BATCH / ms * 1e3,
         losses=losses,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, dense_blocks=dense,
         launches_per_step=launches["dia_spmm"] / (warm + steps))


def phase_msdr_model(rec: dict) -> None:
    import torch

    sups, pat = rec["_msdr"]["road_graph"]
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 2, 3
    losses, ms, launches, dense = train_steps(
        "MSDR", bind("MSDR", msdr_net(), (sups, pat)), MSDR_BATCH, warm,
        steps)
    for k in ("dia_spmm", "bsr_spmm", "sddmm", "spmm_dvals"):
        assert launches[k] > 0, launches
    emit("msdr_model", graph="road_graph_edges(16384, 16, 48)",
         nodes=N_BIG, batch=MSDR_BATCH, rnn_units=64,
         pattern_nnzb=int(pat.ptr[-1]),
         steps=warm + steps, ms_per_step=ms,
         samples_per_s=MSDR_BATCH / ms * 1e3, losses=losses,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, dense_blocks=dense,
         launches_per_step={k: v / (warm + steps)
                            for k, v in launches.items()})


def phase_sharded_model(rec: dict) -> None:
    """TGCN train steps node-sharded on 4 ranks of cuda:0 (the network on
    the ranks' node shards, `GraphPredictor.mesh`): the CLI graph
    through `build_model(cfg, mesh=...)`, the road graph through a
    `partition_graph_coo` partition. Both take the boundary halo
    exchange. On the road graph the same weights, data and optimizer as
    `dia_model` (one card, the `dia_spmm` support of the same matrix)
    must give its losses: rtol 2e-5, as the CPU tests hold loss
    trajectories."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import build_model
    from gptst_tpu_torch.ops.graph_conv import (
        ShardedSupport, make_sharded_support,
    )
    from gptst_tpu_torch.parallel.mesh import make_mesh

    from gptst_tpu_torch.graph import partition as P

    mesh = make_mesh(devices=["cuda:0"] * 4, graph_axis_size=4)
    cfg = default_config("PEMS08", mode="ori", model="TGCN", num_nodes=N_BIG,
                         batch_size=BATCH, lr_decay=False)
    # the statistics `make_sharded_support` chooses the path by
    seen, stats_fn = [], P.partition_stats
    P.partition_stats = lambda part: seen.append(stats_fn(part)) or seen[-1]
    t0 = time.perf_counter()
    try:
        cli = build_model(cfg, adj=rec["_cli_base"], device="cuda", mesh=mesh)
    finally:
        P.partition_stats = stats_fn
    cli_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = P.partition_graph_coo(*road_coo(N_BIG), N_BIG, 4)
    road_sup = make_sharded_support(None, mesh, part=part)
    road_build = time.perf_counter() - t0
    (cli_stats,) = seen
    road = bind("TGCN", tgcn_net(), (road_sup,))
    road.predictor.mesh = mesh
    runs = [("cli_graph", cli, cli_build, cli_stats),
            ("road_graph", road, road_build, P.partition_stats(part))]
    for name, model, build_s, stats in runs:
        (sup,) = model.predictor.graph
        assert model.predictor.shards(torch.device("cuda", 0)).parts == 4
        assert isinstance(sup, ShardedSupport) and sup.kind == "halo", sup
        torch.cuda.reset_peak_memory_stats()
        warm, steps = 1, 2
        losses, ms, launches, _ = train_steps("TGCN", model, BATCH, warm,
                                              steps)
        assert not any(launches.values()), launches  # torch.matmul only
        if name == "road_graph":
            np.testing.assert_allclose(
                losses, rec["_road_losses"][:len(losses)], rtol=2e-5)
        else:
            rec["_sharded_cli"] = sup
        emit("sharded_model", graph=name, nodes=N_BIG, batch=BATCH,
             rnn_units=UNITS, ranks=["cuda:0"] * 4, kind=sup.kind,
             n_pad=sup.n_pad, partition=stats, build_s=build_s,
             steps=warm + steps, ms_per_step=ms,
             samples_per_s=BATCH / ms * 1e3, losses=losses,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        del model, sup
    torch.cuda.empty_cache()


def grads_of(model, loss_terms, x, y, **kw) -> tuple[float, float, dict]:
    """One loss and backward of `loss_terms` on `model`'s parameters:
    the total and flow losses and the gradients (zeros where none
    reaches the loss); the gradients are cleared."""
    import torch

    model.zero_grad(set_to_none=True)
    total, flow = loss_terms(x, y, **kw)
    total.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(total.detach()), float(flow.detach()), grads


def dp_pair(model, loss_fn, cfg, mesh, x, y, seed: int = 0,
            epochs: tuple = (None,),
            sides: tuple = ("one_device", "data_parallel")) -> dict:
    """The losses and every gradient of `model` on (x, y), one step at
    each epoch of `epochs` (None: no epoch argument), on each of
    `sides`: `one_device`, `data_parallel` over `mesh` (a GPT-ST whole
    on each data row's first device) and `sharded` (GPT-ST node-sharded
    over the mesh's graph axis, `GPTST.mesh`). Each side runs its steps
    twice with a generator seeded `seed` on the card, a warm pass and a
    timed one (host clock, every card of the mesh synchronized), whose
    peak memory is read on each card. Every side is held to the first:
    the losses and flow losses at rtol 1e-5, the gradients at rtol
    1e-4 with an atol of 1e-5 of each tensor's largest entry. Returns
    each side's losses, flow losses, ms per step and peaks, and the
    largest gradient error."""
    import numpy as np
    import torch

    from gptst_tpu_torch.train.step import make_loss_terms, model_forwards

    cards = sorted({d.index for d in mesh.devices.flat})
    gptst = getattr(model, "gptst", None)
    kept = getattr(gptst, "mesh", None)
    out = {}
    for side in sides:
        if gptst is not None:
            gptst.mesh = mesh if side == "sharded" else None
        forward = (None if side == "one_device"
                   else model_forwards(model, cfg, mesh)[1])
        terms = make_loss_terms(model, loss_fn, cfg, forward=forward)
        for _ in ("warm", "timed"):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            steps = []
            for epoch in epochs:
                kw = {} if epoch is None else {"epoch": epoch}
                for c in cards:
                    torch.cuda.synchronize(c)
                t0 = time.perf_counter()
                total, flow, grads = grads_of(model, terms, x, y,
                                              generator=gen, **kw)
                for c in cards:
                    torch.cuda.synchronize(c)
                ms = (time.perf_counter() - t0) * 1e3
                steps.append((total, flow,
                              {k: v.cpu() for k, v in grads.items()}, ms))
        out[side] = (steps, {f"cuda:{c}": torch.cuda.max_memory_allocated(c)
                             for c in cards})
    if gptst is not None:
        gptst.mesh = kept
    errs = {}
    for side in sides[1:]:
        for (t1, f1, g1, _), (t2, f2, g2, _) in zip(out[sides[0]][0],
                                                    out[side][0]):
            np.testing.assert_allclose([t2, f2], [t1, f1], rtol=1e-5)
            errs.update({k: max(v, errs.get(k, 0.0)) for k, v in
                         assert_grads_close(g2, g1, side).items()})
    line = {side: dict(losses=[s[0] for s in steps],
                       flow_losses=[s[1] for s in steps],
                       ms=[s[3] for s in steps],
                       ms_per_step=statistics.mean(s[3] for s in steps),
                       max_memory_allocated=mem)
            for side, (steps, mem) in out.items()}
    return dict(epochs=list(epochs), max_grad_err=max(errs.values()), **line)


def row_widths(kernel, plain, st) -> dict:
    """The kernel at a data row's widths at batch 16 on two rows
    (`F_ROW_WIDE` for h, `F_ROW_NARROW` for x) against its plain version
    on the same x (f32 tolerance), with both times."""
    import torch

    out = {}
    for f in (F_ROW_WIDE, F_ROW_NARROW):
        x = torch.randn(st.n, f, device="cuda")
        out[f"F{f}"] = dict(
            max_abs_err=compare(kernel(st, x), plain(st, x), "f32"),
            ms=time_ms(lambda: kernel(st, x)),
            plain_ms=time_ms(lambda: plain(st, x)))
    return out


def row_launches() -> dict:
    """`parallel.rows.ROW_LAUNCHES` as {"row r": {kernel: n}}."""
    from gptst_tpu_torch.parallel.rows import ROW_LAUNCHES

    return {f"row {r}": dict(v) for r, v in sorted(ROW_LAUNCHES.items())}


def phase_data_parallel(rec: dict) -> None:
    """Batch-parallel training over a (data, graph) mesh of repeated
    `cuda:0` ranks (`parallel/spmd.py`; one thread per data row, the
    rows serialize on the card): (a) TGCN on the CLI graph through
    `build_model(cfg, mesh=(2 x 1))`, 1 warm and 3 timed steps against
    the one-device steps from the same weights (losses rtol 1e-4, every
    parameter after the steps rtol 1e-4 with an atol of 1e-5 of its
    largest entry: `index_add_` sums with atomics), `bsr_spmm` on both
    rows and no block run densely; (b) TGCN on the road graph at
    (2 x 1) on its DIA support (`dia_spmm` on both rows) and at (2 x 2)
    through a 2-rank halo partition per row, each against `dia_model`'s
    losses (rtol 2e-5); (c) GPT-ST pretrain at 16,384 nodes, batch 8,
    epochs 1 (random mask) and 2 (adaptive mask, KL term), and (d)
    MTGNN at 2,048 nodes, batch 16 with dropout: loss and every
    gradient against the one-device step with the same generator; (e)
    a ragged batch of 15 runs on row 0 and equals the one-device step.
    With 2 or more cards, (a) again with one data row per card and
    `run.main` building the CLI's mesh."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.graph import partition as P
    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.models.build import build_model, predictor_forward
    from gptst_tpu_torch.ops.graph_conv import (
        SparseSupport, make_sharded_support,
    )
    from gptst_tpu_torch.parallel.mesh import make_mesh
    from gptst_tpu_torch.parallel.rows import ROW_LAUNCHES
    from gptst_tpu_torch.train.loss import build_loss

    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=1)
    cfg = default_config("PEMS08", mode="ori", model="TGCN", num_nodes=N_BIG,
                         batch_size=BATCH, lr_decay=False)

    # (a) the CLI graph through build_model under the mesh
    t0 = time.perf_counter()
    dp_model = build_model(cfg, adj=rec["_cli_base"], device="cuda",
                           mesh=mesh)
    build_s = time.perf_counter() - t0
    (sup,) = dp_model.predictor.graph
    assert isinstance(sup, SparseSupport) and sup.dia is None, sup
    net0 = copy.deepcopy(dp_model.predictor.net)
    one = bind("TGCN", copy.deepcopy(net0), (sup,))
    warm, steps = 1, 3
    torch.cuda.reset_peak_memory_stats()
    one_losses, one_ms, _, _ = train_steps("TGCN", one, BATCH, warm, steps)
    one_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, dense = train_steps("TGCN", dp_model, BATCH, warm,
                                              steps, mesh=mesh)
    peak = torch.cuda.max_memory_allocated()
    rows = row_launches()
    for r in ("row 0", "row 1"):
        assert rows.get(r, {}).get("bsr_spmm", 0) > 0, rows
    assert launches["dia_spmm"] == 0 and not any(dense.values()), dense
    np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
    errs = assert_grads_close(
        {k: p.detach().cpu() for k, p in dp_model.named_parameters()},
        {k: p.detach().cpu() for k, p in one.named_parameters()},
        "data_parallel params")
    rec["bsr_spmm"]["launches_by_path"]["data_parallel"] = {
        r: v["bsr_spmm"] for r, v in rows.items()}
    rec["bsr_spmm"]["launches_by_path"]["data_parallel"]["total"] = \
        launches["bsr_spmm"]
    widths = row_widths(K.bsr_spmm, K.bsr_spmm_plain, sup.bcsr)
    emit("data_parallel", case="a", model="TGCN",
         graph=f"random_sensor_graph({N_BIG}) CLI graph", mesh=mesh.shape,
         ranks=["cuda:0"] * 2, nodes=N_BIG, batch=BATCH, rnn_units=UNITS,
         build_s=build_s, steps=warm + steps, ms_per_step=ms,
         samples_per_s=BATCH / ms * 1e3, losses=losses,
         max_memory_allocated=peak, one_device_ms_per_step=one_ms,
         one_device_samples_per_s=BATCH / one_ms * 1e3,
         one_device_losses=one_losses, one_device_max_memory=one_peak,
         max_param_err=max(errs.values()), launches=launches,
         row_launches=rows, dense_blocks=dense, bsr_row_widths=widths)

    # (e) a ragged batch of 15: the whole batch on row 0
    ragged = bind("TGCN", copy.deepcopy(net0), (sup,))
    rng = np.random.default_rng(1)
    xr = torch.from_numpy(rng.standard_normal(
        (15, 12, N_BIG, 3), np.float32)).cuda()
    K.reset_launch_counts()
    ROW_LAUNCHES.clear()
    line = dp_pair(ragged, build_loss("mask_mae", 200.0, 100.0, 0.0, False),
                   cfg, mesh, xr, xr)
    assert not ROW_LAUNCHES and K.LAUNCHES["bsr_spmm"] > 0, ROW_LAUNCHES
    emit("data_parallel", case="e", model="TGCN", batch=15, mesh=mesh.shape,
         runs_on="row 0", **line)
    del dp_model, one, ragged
    torch.cuda.empty_cache()

    # (b) the road graph: DIA under (2 x 1), halo under (2 x 2)
    road = rec["_supports"]["road_graph"]
    warm, steps = 1, 2
    losses, ms, launches, dense = train_steps(
        "TGCN", bind("TGCN", tgcn_net(), (road,)), BATCH, warm, steps,
        mesh=mesh)
    rows = row_launches()
    for r in ("row 0", "row 1"):
        assert rows.get(r, {}).get("dia_spmm", 0) > 0, rows
    assert launches["bsr_spmm"] == 0 and not any(dense.values()), dense
    np.testing.assert_allclose(losses, rec["_road_losses"][:len(losses)],
                               rtol=2e-5)
    rec["dia_spmm"]["launches_by_path"]["data_parallel"] = {
        **{r: v["dia_spmm"] for r, v in rows.items()},
        "total": launches["dia_spmm"]}
    emit("data_parallel", case="b", model="TGCN",
         graph="road_graph_edges(16384, 16, 48)", mesh=mesh.shape,
         nodes=N_BIG, batch=BATCH, steps=warm + steps, ms_per_step=ms,
         samples_per_s=BATCH / ms * 1e3, losses=losses, launches=launches,
         row_launches=rows, dense_blocks=dense,
         dia_row_widths=row_widths(K.dia_spmm, K.dia_spmm_plain, road.dia))
    mesh22 = make_mesh(devices=["cuda:0"] * 4, graph_axis_size=2)
    rows_, cols_ = road_graph_edges(N_BIG, 16, 48)
    r = np.concatenate([rows_, np.arange(N_BIG)])
    c = np.concatenate([cols_, np.arange(N_BIG)])
    deg = np.bincount(r, minlength=N_BIG).astype(np.float64)
    vals = (1.0 / np.sqrt(deg[r] * deg[c])).astype(np.float32)
    t0 = time.perf_counter()
    halo = make_sharded_support(
        None, mesh22, part=P.partition_graph_coo(r, c, vals, N_BIG, 2))
    build_s = time.perf_counter() - t0
    assert halo.kind == "halo" and halo.row_fns == (halo.fn,), halo
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, _ = train_steps(
        "TGCN", bind("TGCN", tgcn_net(), (halo,)), BATCH, warm, steps,
        mesh=mesh22)
    assert not any(launches.values()), launches    # torch.matmul only
    np.testing.assert_allclose(losses, rec["_road_losses"][:len(losses)],
                               rtol=2e-5)
    emit("data_parallel", case="b", model="TGCN",
         graph="road_graph_edges(16384, 16, 48)", mesh=mesh22.shape,
         ranks=["cuda:0"] * 4, kind=halo.kind, n_pad=halo.n_pad,
         build_s=build_s, nodes=N_BIG, batch=BATCH, steps=warm + steps,
         ms_per_step=ms, samples_per_s=BATCH / ms * 1e3, losses=losses,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del halo
    torch.cuda.empty_cache()

    # (c) GPT-ST pretrain at 16,384 nodes, both branches of the mask
    gcfg = gptst_cfg(batch_size=GPTST_BATCH)
    model = gptst_net(gcfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (GPTST_BATCH, gcfg.lag, N_BIG, 3), np.float32)).cuda()
    loss_fn = build_loss("mask_mae", 200.0, 100.0, 0.0, True)
    line = dp_pair(model, loss_fn, gcfg, mesh, x, x, epochs=(1, 2))
    emit("data_parallel", case="c", model="GPT-ST", mode="pretrain",
         nodes=N_BIG, batch=GPTST_BATCH, change_epoch=gcfg.change_epoch,
         mesh=mesh.shape, **line)
    del model, x
    torch.cuda.empty_cache()

    # (d) MTGNN at 2,048 nodes: dropout from the generator
    n = GRAPH_MODEL_NODES
    mcfg = default_config("PEMS08", mode="ori", model="MTGNN", num_nodes=n)
    model = predictor_forward(mcfg, graph_predictor("MTGNN", "PEMS08", n,
                                                    "cuda"))
    rng = np.random.default_rng(0)
    xm, ym = (torch.from_numpy(rng.standard_normal(
        (16, 12, n, 3), np.float32)).cuda() for _ in range(2))
    line = dp_pair(model, build_loss(mcfg.loss_func, 200.0, 100.0, 0.0,
                                     False), mcfg, mesh, xm, ym)
    emit("data_parallel", case="d", model="MTGNN", nodes=n, batch=16,
         mesh=mesh.shape, **line)
    del model
    torch.cuda.empty_cache()
    data_parallel_cards(rec)


def data_parallel_cards(rec: dict) -> None:
    """With 2 or more cards: case (a) with one data row per card (the
    model copied to the second card with its support), against the one
    card's steps; then `run.main -mode ori -model TGCN` on every card,
    which must build and log the (data, graph) mesh. On one card it
    prints that it did not run."""
    import copy
    import logging

    import numpy as np
    import torch

    from gptst_tpu_torch.models.build import build_predictor
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit("data_parallel", case="cards", ran=False, cards=count)
        return
    mesh = make_mesh(devices=["cuda:0", "cuda:1"], graph_axis_size=1)
    cfg = default_config("PEMS08", mode="ori", model="TGCN", num_nodes=N_BIG)
    # TGCN at its published widths on the CLI graph's support, random
    # weights from seed 0
    pred = build_predictor(cfg, adj=rec["_cli_base"], device="cuda", seed=0)
    nets = [bind("TGCN", copy.deepcopy(pred.net), pred.graph)
            for _ in range(2)]
    one_losses, one_ms, _, _ = train_steps("TGCN", nets[0], BATCH, 1, 3)
    losses, ms, launches, _ = train_steps("TGCN", nets[1], BATCH, 1, 3,
                                          mesh=mesh)
    rows = row_launches()
    assert all(rows.get(f"row {r}", {}).get("bsr_spmm", 0) > 0
               for r in (0, 1)), rows
    np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
    seen = []

    class Seen(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Seen()
    logging.getLogger("run").addHandler(handler)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run_main(["-dataset", "PEMS08", "-mode", "ori", "-model", "TGCN",
                      "-num_nodes", "170", "-batch_size", "64", "-epochs",
                      "1", "-num_steps", "600", "-log_dir",
                      os.path.join(tmp, "save"), "-log_step", "1000"])
    finally:
        logging.getLogger("run").removeHandler(handler)
    logged = [m for m in seen if m.startswith("device mesh:")]
    assert logged, seen
    emit("data_parallel", case="cards", ran=True, cards=count,
         mesh=mesh.shape, ranks=["cuda:0", "cuda:1"], ms_per_step=ms,
         one_card_ms_per_step=one_ms, losses=losses,
         one_card_losses=one_losses, row_launches=rows, cli_log=logged[0])


def phase_gptst_graph(rec: dict) -> None:
    """GPT-ST over the 'graph' axis (`models/gptst.py`), f32 with TF32
    off, at 16,384 nodes, batch 8, PEMS08's published widths, seed-0
    weights: (a) pretrain loss and gradients on a (1, 2) mesh of
    `[cuda:0, cuda:0]` against the one-device step at epochs (1, 2, 2)
    (both mask branches, the KL term from epoch 2), ms per step and peak
    memory of both; (b) the same on (2, 2); (c) eval-mode TGCN train
    steps under (1, 2), the encoder node-sharded and TGCN through a
    2-rank halo of the CLI graph, against the one-device eval step on
    the CLI graph's `bsr_spmm` support (losses rtol 1e-4); (d)
    `dryrun.dryrun_multichip(4, devices=[cuda:0] * 4)`, whose fused
    ring launches `ring_spmm` (counted from 0 around the call) and must
    agree with `adj @ x` within `TOL["f32"]`. With 2 or more cards, (a)
    again over cuda:0 and cuda:1 (`gptst_graph_cards`)."""
    import numpy as np
    import torch

    from gptst_tpu_torch.dryrun import dryrun_multichip
    from gptst_tpu_torch.graph import partition as P
    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.ops.graph_conv import make_sharded_support
    from gptst_tpu_torch.parallel.mesh import make_mesh
    from gptst_tpu_torch.train.loss import build_loss

    gcfg = gptst_cfg(batch_size=GPTST_BATCH)
    model = gptst_net(gcfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (GPTST_BATCH, gcfg.lag, N_BIG, 3), np.float32)).cuda()
    loss_fn = build_loss("mask_mae", 200.0, 100.0, 0.0, True)
    for case, (d, g) in (("a", (1, 2)), ("b", (2, 2))):
        mesh = make_mesh(devices=["cuda:0"] * (d * g), graph_axis_size=g)
        line = dp_pair(model, loss_fn, gcfg, mesh, x, x, epochs=(1, 2, 2),
                       sides=("one_device", "sharded"))
        emit("gptst_graph", case=case, model="GPT-ST", mode="pretrain",
             nodes=N_BIG, batch=GPTST_BATCH, mesh=mesh.shape,
             ranks=["cuda:0"] * (d * g), **line)
    del model, x
    torch.cuda.empty_cache()

    # (c) eval TGCN: the one-device step on the CLI graph's block-CSR
    # support, and under (1, 2) with the encoder node-sharded and a
    # 2-rank halo partition of the same matrix
    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=2)
    sym = rec["_cli_sym"]
    rows, cols = np.nonzero(sym)
    t0 = time.perf_counter()
    halo = make_sharded_support(None, mesh, part=P.partition_graph_coo(
        rows, cols, sym[rows, cols], N_BIG, 2))
    build_s = time.perf_counter() - t0
    del rows, cols
    runs = {}
    for side, sup, m in (("one_device", rec["_supports"]["cli_graph"], None),
                         ("sharded", halo, mesh)):
        net = eval_net(sup).to("cuda")
        net.encoder.mesh = m
        torch.cuda.reset_peak_memory_stats()
        losses, ms, launches, _ = train_steps("TGCN", net, BATCH, 1, 2,
                                              mesh=m)
        runs[side] = dict(losses=losses, ms_per_step=ms, launches=launches,
                          max_memory_allocated=
                          torch.cuda.max_memory_allocated())
        del net
        torch.cuda.empty_cache()
    np.testing.assert_allclose(runs["sharded"]["losses"],
                               runs["one_device"]["losses"], rtol=1e-4)
    assert runs["one_device"]["launches"]["bsr_spmm"] > 0, runs
    assert not any(runs["sharded"]["launches"].values()), runs  # matmuls
    emit("gptst_graph", case="c", model="eval TGCN", nodes=N_BIG,
         batch=BATCH, mesh=mesh.shape, ranks=["cuda:0"] * 2,
         graph=f"random_sensor_graph({N_BIG}) CLI graph", kind=halo.kind,
         halo_build_s=build_s, **runs)
    del halo
    torch.cuda.empty_cache()

    # (d) the dry run on 4 ranks of the card: its ring_spmm launches
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = dryrun_multichip(4, devices=["cuda:0"] * 4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert launches["ring_spmm"] > 0, launches
    err = compare(torch.from_numpy(out["fused_ring"]),
                  torch.from_numpy(out["adj_x"]), "f32")
    ring_err = compare(torch.from_numpy(out["ring"]),
                       torch.from_numpy(out["adj_x"]), "f32")
    rec.setdefault("ring_spmm", {}).setdefault("launches_by_path", {})[
        "dryrun_multichip"] = launches["ring_spmm"]
    emit("gptst_graph", case="d", entry="dryrun.dryrun_multichip(4)",
         ranks=["cuda:0"] * 4, mesh=out["mesh"], graph_mesh=out["graph_mesh"],
         nodes=out["num_nodes"], gptst_losses=out["gptst_losses"],
         tgcn_loss=out["tgcn_loss"], launches=launches,
         fused_ring_max_abs_err=err, ring_max_abs_err=ring_err,
         tol=dict(zip(("rtol", "atol"), TOL["f32"])), seconds=seconds)
    gptst_graph_cards(rec)


def gptst_graph_cards(rec: dict) -> None:
    """With 2 or more cards: (a) with its two ranks on cuda:0 and
    cuda:1, against the one-device step on cuda:0; each card's peak
    memory and both step times. With 4, (b) with one rank per card
    beside the same (2, 2) mesh with GPT-ST whole on each data row's
    first card (cuda:0 and cuda:2, a model copy on cuda:2: the layout
    before GPT-ST was node-sharded), and one profiled step of each of
    the two at epoch 2. On one card it prints that it did not run."""
    import numpy as np
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import make_loss_terms, model_forwards

    count = torch.cuda.device_count()
    if count < 2:
        emit("gptst_graph", case="cards", ran=False, cards=count)
        return
    gcfg = gptst_cfg(batch_size=GPTST_BATCH)
    model = gptst_net(gcfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (GPTST_BATCH, gcfg.lag, N_BIG, 3), np.float32)).cuda()
    loss_fn = build_loss("mask_mae", 200.0, 100.0, 0.0, True)
    for n in (2, 4)[:1 + (count >= 4)]:
        ranks = [f"cuda:{i}" for i in range(n)]
        mesh = make_mesh(devices=ranks, graph_axis_size=2)
        sides = ("one_device",) + ("data_parallel",) * (n == 4) + (
            "sharded",)
        line = dp_pair(model, loss_fn, gcfg, mesh, x, x, epochs=(1, 2, 2),
                       sides=sides)
        emit("gptst_graph", case="cards", ran=True, cards=count,
             model="GPT-ST", mode="pretrain", nodes=N_BIG,
             batch=GPTST_BATCH, mesh=mesh.shape, ranks=ranks, **line)
    if count >= 4:
        for side in ("data_parallel", "sharded"):
            model.gptst.mesh = mesh if side == "sharded" else None
            terms = make_loss_terms(model, loss_fn, gcfg,
                                    forward=model_forwards(model, gcfg,
                                                           mesh)[1])
            gen = torch.Generator(device="cuda").manual_seed(0)
            grads_of(model, terms, x, x, generator=gen, epoch=2)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for c in range(4):
                        torch.cuda.synchronize(c)
                    t0 = time.perf_counter()
                    grads_of(model, terms, x, x, generator=gen, epoch=2)
                    for c in range(4):
                        torch.cuda.synchronize(c)
                    ms = (time.perf_counter() - t0) * 1e3
                prof.export_chrome_trace(path)
                profile_line(f"gptst_graph_cards_{side}", ms, path, steps=1,
                             mesh=mesh.shape, ranks=ranks, epoch=2)
        model.gptst.mesh = None
    del model, x
    torch.cuda.empty_cache()


# --- STGCN, GWN, MTGNN and CCRNN over the graph axis -----------------------

PG_WARM, PG_STEPS = 1, 3
# the largest parameter difference a float64 step-locked run may show
F64_LOCKED_ATOL = 1e-12
PG_STEP0 = 1711          # CCRNN's teacher-forcing coins are fair here


def predictors_graph_models(mesh) -> list:
    """(name, one-device model, its copy node-sharded over `mesh`, cfg,
    batch, nodes, graph) of the phase: built by `build_model` (CCRNN's
    network by hand, its SVD embeddings of the random-walk normalized
    `random_sensor_graph(2048, seed 1)`, D^-1 A as the builder's
    `svd_rbf_support` normalizes, in place of the support it derives
    from the dataset's series, which has fewer nodes: ROADMAP.md Queue
    3.9; with the symmetric D^-1/2 A D^-1/2 its f32 forward was 3% off
    float64 on one device), the sharded one a deep copy whose
    `GraphPredictor.mesh` is set (what `build_model(mesh=)` sets for
    these four; their graphs are dense, whole or computed)."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.graph.artifacts import (
        asym_adj, random_sensor_graph,
    )
    from gptst_tpu_torch.models.build import (
        GraphPredictor, build_model, make_predictor_config,
        predictor_forward,
    )
    from gptst_tpu_torch.models.predictors.ccrnn import (
        CCRNN, CCRNNConfig, svd_graph_embeddings,
    )

    n = GRAPH_MODEL_NODES
    adj = random_sensor_graph(n, avg_degree=6, seed=0)
    out = []
    for name, dataset, nodes, batch in (
            ("GWN", "PEMS08", N_BIG, GWN_BATCH),
            ("STGCN", "PEMS08", n, GRAPH_MODEL_BATCH),
            ("MTGNN", "PEMS08", n, GRAPH_MODEL_BATCH),
            ("CCRNN", "NYC_BIKE", n, GRAPH_MODEL_BATCH)):
        cfg = default_config(dataset, mode="ori", model=name,
                             num_nodes=nodes, batch_size=batch,
                             lr_decay=False)
        graph = f"random_sensor_graph({n}, 6, seed 0)"
        if name == "GWN":        # aptonly: the adjacency is not read
            one = build_model(cfg, adj=np.zeros((1, 1)), device="cuda",
                              seed=0)
            graph = "adaptive adjacency only (aptonly)"
        elif name == "CCRNN":
            pcfg = make_predictor_config(CCRNNConfig, cfg, num_nodes=n,
                                         n_dim=min(50, n))
            e1, e2 = svd_graph_embeddings(asym_adj(
                random_sensor_graph(n, avg_degree=6, seed=1)), pcfg.n_dim)
            net = CCRNN(pcfg, dim_in=cfg.input_base_dim,
                        dim_out=cfg.output_dim, horizon=cfg.horizon,
                        emb1_init=e1, emb2_init=e2,
                        generator=torch.Generator().manual_seed(0))
            one = predictor_forward(cfg, GraphPredictor(
                net.to("cuda"), takes_targets=True))
            graph = (f"SVD embeddings of asym_adj(random_sensor_graph({n}, "
                     "6, seed 1))")
        else:
            one = build_model(cfg, adj=adj, device="cuda", seed=0)
        sharded = copy.deepcopy(one)
        sharded.predictor.mesh = mesh
        out.append((name, one, sharded, cfg, batch, nodes, graph))
    return out


def graph_steps(model, cfg, mesh, x, y) -> dict:
    """`PG_WARM` + `PG_STEPS` Adam steps of `model` on (x, y), in their
    dtype, dropout from a generator seeded 0 on the card (CCRNN's coins
    at steps from `PG_STEP0`), data-parallel over `mesh` when given;
    the losses, ms per timed step, the peak memory on every card of the
    mesh, the kernel launches and the parameters after the steps."""
    import torch

    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import (
        make_loss_terms, model_forwards, train_step,
    )
    from gptst_tpu_torch.train.trainer import make_optimizer

    cards = sorted({d.index for d in mesh.devices.flat}) if mesh else [0]
    opt = make_optimizer(cfg, model.parameters(), steps_per_epoch=10)
    terms = make_loss_terms(
        model, build_loss(cfg.loss_func, 200.0, 100.0, cfg.mape_thresh,
                          False), cfg,
        forward=None if mesh is None else model_forwards(model, cfg,
                                                         mesh)[1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    reset_launch_counts()
    losses, ms = run_steps(lambda i: train_step(
        terms, opt, x, y, PG_STEP0 + i, generator=gen)[0],
        PG_WARM, PG_STEPS)
    return dict(losses=losses, ms_per_step=ms,
                max_memory_allocated={
                    f"cuda:{c}": torch.cuda.max_memory_allocated(c)
                    for c in cards},
                launches=dict(LAUNCHES),
                params={k: p.detach().cpu()
                        for k, p in model.named_parameters()})


def params_close(got: dict, want: dict) -> dict:
    """Every parameter at rtol 1e-4 with an atol of 1e-5 of its largest
    entry; a tensor whose largest entry is at most 1e-5 of the model's
    largest (zero in exact arithmetic, as MSDR's att_b, whose gradient
    a softmax's shift cancels) at 1e-5 of the latter, as the CPU tests
    hold gradients (`tests/torch_parity.py`). Returns the largest
    error."""
    import torch

    err = 0.0
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = max(err, float((got[k] - w).abs().max()))
        scale = float(w.abs().max())
        torch.testing.assert_close(
            got[k], w, rtol=1e-4,
            atol=1e-5 * (scale if scale > 1e-5 * top else top),
            msg=lambda m: f"{k}: {m}")
    return dict(max_param_err=err)


def param_gaps(got: dict, want: dict) -> dict:
    """The largest parameter difference and the entries beyond rtol 1e-4
    with an atol of 1e-5 of each tensor's largest entry (not asserted)."""
    err, off, size = 0.0, 0, 0
    for k, w in want.items():
        diff = (got[k] - w).abs()
        err = max(err, float(diff.max()))
        off += int((diff > 1e-4 * w.abs() + 1e-5 * w.abs().max()).sum())
        size += w.numel()
    return dict(max_param_err=err, entries_off=off, entries=size)


def locked_steps(one, sharded, cfg, mesh, x, y, x_sharded=None) -> dict:
    """`PG_WARM` + `PG_STEPS` Adam steps of `one` and of `sharded` (over
    `mesh`), the sharded model set to the one-device model's parameters
    and optimizer state before each step, each with its own generator
    seeded 0 (the same draws): each step's loss at rtol 1e-5 and every
    parameter after it at rtol 1e-4 with an atol of 1e-5 of its largest
    entry (`params_close`). Step by step, since a trajectory need not
    be well conditioned (CCRNN's from these weights moves by 1% at its
    third step for a 1e-14 nudge of x, in float64, on one device).
    `x_sharded` (default x) is the second side's input. Returns the
    largest errors."""
    import numpy as np
    import torch

    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import (
        make_loss_terms, model_forwards, train_step,
    )
    from gptst_tpu_torch.train.trainer import make_optimizer

    loss = build_loss(cfg.loss_func, 200.0, 100.0, cfg.mape_thresh, False)
    side = {}
    for name, model, m in (("one", one, None), ("sharded", sharded, mesh)):
        side[name] = (
            model, make_optimizer(cfg, model.parameters(), 10),
            make_loss_terms(model, loss, cfg, forward=None if m is None
                            else model_forwards(model, cfg, m)[1]),
            torch.Generator(device="cuda").manual_seed(0))
    errs = dict(max_param_err=0.0, loss_rel_err=0.0)
    xs = (x, x if x_sharded is None else x_sharded)
    for i in range(1, PG_WARM + PG_STEPS + 1):
        with torch.no_grad():
            for p, q in zip(sharded.parameters(), one.parameters()):
                p.copy_(q)
        side["sharded"][1].load_state_dict(side["one"][1].state_dict())
        losses = [float(train_step(terms, opt, xi, y, PG_STEP0 + i,
                                   generator=gen)[0])
                  for xi, (_, opt, terms, gen) in zip(xs, side.values())]
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
        check = params_close(
            {k: p.detach().cpu() for k, p in sharded.named_parameters()},
            {k: p.detach().cpu() for k, p in one.named_parameters()})
        errs["max_param_err"] = max(errs["max_param_err"],
                                    check["max_param_err"])
        errs["loss_rel_err"] = max(errs["loss_rel_err"],
                                   abs(losses[1] - losses[0]) / abs(losses[0]))
    return errs


def pair_inputs(cfg, batch: int, nodes: int, seed: int = 0):
    """Random f32 (x, y) of `graph_pair_line` on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (batch, cfg.lag, nodes, cfg.input_base_dim + 2)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .cuda() for _ in range(2))


def graph_pair_line(one, sharded, cfg, mesh, batch: int, nodes: int,
                    seed: int = 0, f64_batch: int | None = None) -> dict:
    """The one-device model and its sharded copy on the same random
    (x, y) from `seed`, from the same initial weights, neither launching
    a kernel of `csrc/`: in f32 each runs `graph_steps` free (ms per
    step, peak memory; the first loss at rtol 1e-5, the rest and the
    parameters after the steps recorded: a ReLU whose input lies within
    f32 rounding of 0 flips its gradient when the sums run in another
    order, one-device f32 runs flip against float64 too, and Adam
    turns a flipped gradient entry into a step of up to lr); in float64
    (the graph operands stay f32) they run `locked_steps` on the first
    `f64_batch` samples (all by default), where both sides compute the
    same math to ~1e-13."""
    import copy

    import numpy as np
    import torch

    x, y = pair_inputs(cfg, batch, nodes, seed)
    runs = {}
    for side, model, m in (("one_device", one, None),
                           ("sharded", sharded, mesh)):
        model = copy.deepcopy(model)
        runs[side] = graph_steps(model, cfg, m, x, y)
        assert not any(runs[side]["launches"].values()), runs
        del model
        torch.cuda.empty_cache()
    one32, sh32 = runs["one_device"], runs["sharded"]
    np.testing.assert_allclose(sh32["losses"][0], one32["losses"][0],
                               rtol=1e-5)
    f32 = param_gaps(sh32.pop("params"), one32.pop("params"))
    rel = (np.abs(np.subtract(sh32["losses"], one32["losses"]))
           / np.abs(one32["losses"]))
    t0 = time.perf_counter()
    b64 = f64_batch or batch
    f64 = locked_steps(copy.deepcopy(one).double(),
                       copy.deepcopy(sharded).double(), cfg, mesh,
                       x[:b64].double(), y[:b64].double())
    # the same math in another order: float64 rounding alone
    assert f64["max_param_err"] <= F64_LOCKED_ATOL, f64
    torch.cuda.empty_cache()
    return dict(float64_step_locked=dict(
                    **f64, batch=b64, seconds=time.perf_counter() - t0),
                f32=dict(**f32, loss_rel_err=[float(v) for v in rel]),
                one_device=one32, sharded=sh32,
                ms_ratio=sh32["ms_per_step"] / one32["ms_per_step"])


def predictors_graph_eval(mesh) -> tuple:
    """Eval STGCN at 2,048 nodes, PEMS08's published widths: a GPT-ST
    encoder from seed 0, the head and STGCN from seed 1
    (`build_model(-mode eval)`), and its deep copy with the encoder and
    the predictor both over `mesh`."""
    import copy

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph
    from gptst_tpu_torch.models.build import build_model, build_pretrain

    n = GRAPH_MODEL_NODES
    cfg = default_config("PEMS08", mode="eval", model="STGCN", num_nodes=n,
                         batch_size=GRAPH_MODEL_BATCH, lr_decay=False)
    pre = build_pretrain(cfg.replace(mode="pretrain"), -0.5, "cuda", 0)
    one = build_model(cfg, adj=random_sensor_graph(n, avg_degree=6, seed=0),
                      device="cuda", seed=1, scaler_zeros=-0.5,
                      pretrain_params=pre)
    sharded = copy.deepcopy(one)
    sharded.predictor.mesh = sharded.encoder.mesh = mesh
    return cfg, one, sharded


def phase_predictors_graph(rec: dict) -> None:
    """STGCN, GWN, MTGNN and CCRNN node-sharded on (1, 2) of cuda:0
    beside one device (`graph_pair_line`), then eval STGCN with the
    encoder's node shards handed to the sharded predictor; with 2 or
    more cards, `predictors_graph_cards`."""
    import torch

    from gptst_tpu_torch.models import gptst as G
    from gptst_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=2)
    for name, one, sharded, cfg, batch, nodes, graph in \
            predictors_graph_models(mesh):
        assert sharded.predictor.shards(torch.device("cuda", 0)).parts == 2
        line = graph_pair_line(one, sharded, cfg, mesh, batch, nodes)
        emit("predictors_graph", model=name, mode="ori", nodes=nodes,
             batch=batch, graph=graph, mesh=mesh.shape,
             ranks=["cuda:0"] * 2, steps=PG_WARM + PG_STEPS, **line)
        del one, sharded
        torch.cuda.empty_cache()
    cfg, one, sharded = predictors_graph_eval(mesh)
    gathered = []
    encode = G.GPTST.encode
    G.GPTST.encode = lambda self, s: gathered.append(s.shape) or encode(
        self, s)
    try:
        line = graph_pair_line(one, sharded, cfg, mesh, cfg.batch_size,
                               cfg.num_nodes)
    finally:
        G.GPTST.encode = encode
    # the one-device runs (f32, float64) gather their whole embedding
    # (one rank), the sharded ones never: the shards stay on their ranks
    assert len(gathered) == 2 * (PG_WARM + PG_STEPS), gathered
    emit("predictors_graph", model="STGCN", mode="eval",
         nodes=cfg.num_nodes, batch=cfg.batch_size, mesh=mesh.shape,
         ranks=["cuda:0"] * 2, encoder="GPT-ST, PEMS08 widths, seed 0",
         embedding_gathers={"one_device": len(gathered) // 2,
                            "sharded": 0},
         **line)
    del one, sharded
    torch.cuda.empty_cache()
    predictors_graph_cards(rec)


def predictors_graph_cards(rec: dict) -> None:
    """With 2 or more cards: each model of the phase with its two ranks
    on cuda:0 and cuda:1 against the one-device model on cuda:0, the
    peak on each card against the one card's. On one card it prints
    that it did not run."""
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit("predictors_graph", case="cards", ran=False, cards=count)
        return
    mesh = make_mesh(devices=["cuda:0", "cuda:1"], graph_axis_size=2)
    for name, one, sharded, cfg, batch, nodes, graph in \
            predictors_graph_models(mesh):
        line = graph_pair_line(one, sharded, cfg, mesh, batch, nodes)
        one_peak = line["one_device"]["max_memory_allocated"]["cuda:0"]
        emit("predictors_graph", case="cards", ran=True, cards=count,
             model=name, nodes=nodes, batch=batch, mesh=mesh.shape,
             ranks=["cuda:0", "cuda:1"], peak_per_card_over_one_card={
                 k: v / one_peak for k, v in
                 line["sharded"]["max_memory_allocated"].items()}, **line)
        del one, sharded
        torch.cuda.empty_cache()


# --- MSDR, ASTGCN, STGODE, ST_WA and DMVSTNET over the graph axis ----------

def last_graph_models() -> tuple:
    """(model, dataset, f32 batch, float64 batch) of the phase: the
    batches of `graph_predictors_model` and `last_predictors_model`;
    ST_WA's float64 at batch 2, since its f32 step at batch 8 holds
    ~42 GB (PERF.md), which float64 would double past the card."""
    b = GRAPH_MODEL_BATCH
    return (("MSDR", "PEMS08", b, b), ("ASTGCN", "PEMS08", b, b),
            ("STGODE", "PEMS08", b, b),
            ("ST_WA", "PEMS08", LAST_MODEL_BATCH["ST_WA"], 2),
            ("DMVSTNET", "NYC_BIKE", LAST_MODEL_BATCH["DMVSTNET"],
             LAST_MODEL_BATCH["DMVSTNET"]))


def last_predictors_graph_models(mesh, models=None):
    """(name, one-device model, the same weights built under `mesh`,
    cfg, batch, float64 batch) of each of `models` (by default
    `last_graph_models()`), one at a time: each built by
    `graph_predictor` at 2,048 nodes and conf widths, once on the card
    and once inside `use_sharding_mesh(mesh)` (what `build_model(mesh=)`
    does: MSDR's and TGCN's supports become the halo exchange, dense
    graphs that only rows read are cut into the ranks' rows, every
    `GraphPredictor.mesh` is set), the one-device weights loaded into
    the sharded copy."""
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import predictor_forward
    from gptst_tpu_torch.ops.graph_conv import use_sharding_mesh

    n = GRAPH_MODEL_NODES
    for name, dataset, batch, b64 in models or last_graph_models():
        cfg = default_config(dataset, mode="ori", model=name, num_nodes=n,
                             batch_size=batch, lr_decay=False)
        one = predictor_forward(cfg, graph_predictor(name, dataset, n,
                                                     "cuda"))
        with use_sharding_mesh(mesh):
            sharded = predictor_forward(cfg, graph_predictor(
                name, dataset, n, "cuda"))
        sharded.load_state_dict(one.state_dict())
        assert sharded.predictor.shards(torch.device("cuda", 0)).parts == 2
        yield name, one, sharded, cfg, batch, b64
        del one, sharded
        torch.cuda.empty_cache()


def stwa_map_shares(run):
    """`run()` with ST_WA's spatial attention maps recorded: returns its
    value and, per call, each rank's share n / N of the (B, heads, P, N,
    N) maps of one device (its (B, heads, P, n, N) maps)."""
    from gptst_tpu_torch.models.predictors import stwa

    attend = stwa.SpatialAttention._attend
    shares = set()

    def record(m, x, key, value):
        shares.add(x.shape[-2] / key.shape[-2])
        return attend(m, x, key, value)

    stwa.SpatialAttention._attend = staticmethod(record)
    try:
        return run(), sorted(shares)
    finally:
        stwa.SpatialAttention._attend = staticmethod(attend)


def phase_last_predictors_graph(rec: dict) -> None:
    """MSDR, ASTGCN, STGODE, ST_WA and DMVSTNET node-sharded on (1, 2)
    of cuda:0 beside one device (`graph_pair_line`); ST_WA's spatial
    maps per rank; with 2 or more cards, `last_predictors_graph_cards`."""
    from gptst_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=2)
    for name, one, sharded, cfg, batch, b64 in \
            last_predictors_graph_models(mesh):
        line, shares = stwa_map_shares(lambda: graph_pair_line(
            one, sharded, cfg, mesh, batch, cfg.num_nodes, f64_batch=b64))
        extra = {}
        if name == "ST_WA":
            # the one-device runs see whole maps (1.0), the sharded ones
            # each rank's rows (0.5)
            assert shares == [0.5, 1.0], shares
            extra["spatial_map_share_per_rank"] = 0.5
        if name == "MSDR":
            extra["static_supports"] = [
                s.kind for s in sharded.predictor.graph[0]]
        emit("last_predictors_graph", model=name, mode="ori",
             nodes=cfg.num_nodes, batch=batch, float64_batch=b64,
             graph="random_sensor_graph(2048, 6, seed 0; series graph "
                   "seed 1)", mesh=mesh.shape, ranks=["cuda:0"] * 2,
             steps=PG_WARM + PG_STEPS, **extra, **line)
    last_predictors_graph_cards(rec)


def last_predictors_graph_cards(rec: dict) -> None:
    """With 2 or more cards: each model of the phase with its two ranks
    on cuda:0 and cuda:1 against the one-device model on cuda:0, the
    peak on each card against the one card's. On one card it prints
    that it did not run."""
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit("last_predictors_graph", case="cards", ran=False, cards=count)
        return
    mesh = make_mesh(devices=["cuda:0", "cuda:1"], graph_axis_size=2)
    for name, one, sharded, cfg, batch, b64 in \
            last_predictors_graph_models(mesh):
        line = graph_pair_line(one, sharded, cfg, mesh, batch,
                               cfg.num_nodes, f64_batch=b64)
        one_peak = line["one_device"]["max_memory_allocated"]["cuda:0"]
        emit("last_predictors_graph", case="cards", ran=True, cards=count,
             model=name, nodes=cfg.num_nodes, batch=batch,
             float64_batch=b64, mesh=mesh.shape, ranks=["cuda:0", "cuda:1"],
             peak_per_card_over_one_card={
                 k: v / one_peak for k, v in
                 line["sharded"]["max_memory_allocated"].items()}, **line)


# --- TGCN, STMGCN, STSGCN and STFGNN over the graph axis -------------------

def final_graph_models() -> tuple:
    """(model, dataset, f32 batch, float64 batch) of the phase at 2,048
    nodes."""
    b = GRAPH_MODEL_BATCH
    return tuple((m, d, b, b) for m, d in (
        ("TGCN", "PEMS08"), ("STMGCN", "NYC_BIKE"), ("STSGCN", "PEMS08"),
        ("STFGNN", "PEMS08")))


def final_graph_pairs(mesh):
    """`last_predictors_graph_models` of `final_graph_models()`."""
    return last_predictors_graph_models(mesh, final_graph_models())


# the window steps of STSGCN's and STFGNN's synchronous graphs
SYNC_GRAPH_STEPS = {"STSGCN": 3, "STFGNN": 4}


def row_normalize_sync_graph(one, sharded, mesh) -> None:
    """STSGCN's or STFGNN's synchronous graph divided by its row sums on
    both sides (the sharded side cut anew into its ranks' strided
    rows), as the CPU parity tests feed it: on the raw graphs of
    `random_sensor_graph(2048)` both models' f32 losses grow by three
    orders of magnitude in three steps, and float64 rounding grows with
    them (`raw_graph_gaps`)."""
    import functools

    from gptst_tpu_torch.ops.graph_conv import MeshRows, strided_rows

    (a,) = one.predictor.graph
    a = a / a.sum(dim=1, keepdim=True)
    one.predictor.graph = (a,)
    sharded.predictor.graph = (MeshRows.cut(
        a.cpu(), mesh, one.predictor.net.cfg.num_nodes, functools.partial(
            strided_rows, steps=SYNC_GRAPH_STEPS[
                type(one.predictor.net).__name__])),)


def raw_graph_gaps(one, sharded, cfg, mesh, batch: int) -> dict:
    """On the raw synchronous graph, in float64 (not asserted): the
    step-locked gap of the sharded model to one device, and the rounding
    floor beside it: the one-device model locked to itself with x times
    1 + 2^-52 (each entry moved by one or two ulps) on one side."""
    import copy

    x, y = (t.double() for t in pair_inputs(cfg, batch, cfg.num_nodes))
    one64 = copy.deepcopy(one).double()
    gaps = dict(sharded=locked_steps(one64, copy.deepcopy(sharded).double(),
                                     cfg, mesh, x, y))
    gaps["one_ulp_of_x"] = locked_steps(
        one64, copy.deepcopy(one64), cfg, None, x, y,
        x_sharded=x * (1.0 + 2.0 ** -52))
    return gaps


def graph_rows_line(model) -> dict:
    """What the sharded `model`'s ranks hold of its graph operand: the
    support's kind, or each rank's rows (`MeshRows`) and their bytes."""
    import torch

    (graph,) = model.predictor.graph
    if not hasattr(graph, "of"):
        return dict(support=graph.kind)
    rows = graph.of(model.predictor.shards(torch.device("cuda", 0)))
    return dict(graph_rows_per_rank=[list(r.shape) for r in rows],
                graph_bytes_per_rank=[r.numel() * r.element_size()
                                      for r in rows])


def tgcn_big_pairs(rec: dict, mesh):
    """TGCN at 16,384 nodes, batch 16, published widths, one device
    beside node-sharded on `mesh`'s graph ranks (`GraphPredictor.mesh`),
    the same seed-0 weights: on the road graph (one device: its
    `dia_spmm` support; sharded: a `partition_graph_coo` halo of the
    same matrix, a band's edges), on the CLI graph (`bsr_spmm` against
    its 2-rank halo, nearly dense) and in eval mode on the CLI graph
    with the encoder's node shards handed to the predictor. Yields
    (case, one, sharded, halo build seconds)."""
    from gptst_tpu_torch.graph import partition as P
    from gptst_tpu_torch.ops.graph_conv import make_sharded_support

    import numpy as np

    sym = rec["_cli_sym"]
    rows, cols = np.nonzero(sym)
    coo = {"road_graph": road_coo(N_BIG),
           "cli_graph": (rows, cols, sym[rows, cols])}
    del rows, cols
    if "road_graph" not in rec["_supports"]:
        rec["_supports"]["road_graph"] = road_support(N_BIG, 48, "cuda")
    for case, graph in (("road_graph", "road_graph"),
                        ("cli_graph", "cli_graph"),
                        ("eval_cli_graph", "cli_graph")):
        t0 = time.perf_counter()
        halo = make_sharded_support(None, mesh, part=P.partition_graph_coo(
            *coo[graph], N_BIG, mesh.shape["graph"]))
        build_s = time.perf_counter() - t0
        one_sup = rec["_supports"][graph]
        if case.startswith("eval"):
            one = eval_net(one_sup).to("cuda")
            sharded = eval_net(halo).to("cuda")
            sharded.encoder.mesh = mesh
        else:
            one = bind("TGCN", tgcn_net(), (one_sup,))
            sharded = bind("TGCN", tgcn_net(), (halo,))
        sharded.predictor.mesh = mesh
        yield case, one, sharded, halo, build_s
        del one, sharded, halo


def tgcn_big_line(one, sharded, mesh, rtol: float) -> dict:
    """`graph_steps` of both (f32, 1 warm + 3 timed): the losses at
    `rtol` (the one-device kernels and the halo's dense products sum in
    another order), no `csrc/` launch sharded."""
    import numpy as np

    from gptst_tpu_torch.config.config import default_config

    cfg = default_config("PEMS08", mode="ori", model="TGCN",
                         num_nodes=N_BIG, batch_size=BATCH, lr_decay=False)
    x, y = pair_inputs(cfg, BATCH, N_BIG)
    runs = {side: graph_steps(model, cfg, m, x, y)
            for side, model, m in (("one_device", one, None),
                                   ("sharded", sharded, mesh))}
    for run in runs.values():
        run.pop("params")
    np.testing.assert_allclose(runs["sharded"]["losses"],
                               runs["one_device"]["losses"], rtol=rtol)
    assert any(runs["one_device"]["launches"].values()), runs
    assert not any(runs["sharded"]["launches"].values()), runs
    return dict(**runs, ms_ratio=runs["sharded"]["ms_per_step"]
                / runs["one_device"]["ms_per_step"])


def phase_final_predictors_graph(rec: dict) -> None:
    """TGCN, STMGCN, STSGCN and STFGNN node-sharded on (1, 2) of cuda:0
    beside one device: each at 2,048 nodes built as under the mesh
    (`final_graph_pairs`; STSGCN's and STFGNN's synchronous graphs
    row-normalized, STFGNN's raw-graph float64 gaps recorded first;
    `graph_pair_line`: f32 ms and peak memory, float64 step-locked),
    then TGCN at 16,384 nodes on the road
    graph, the CLI graph and in eval mode (`tgcn_big_pairs`: f32 ms and
    peak; the losses at rtol 2e-5 as `sharded_model`'s, eval's at 1e-4
    as `gptst_graph` (c)'s, where the encoder's embedding is gathered
    for TGCN); with 2 or more cards, `final_predictors_graph_cards`."""
    import torch

    from gptst_tpu_torch.models import gptst as G
    from gptst_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=2)
    for name, one, sharded, cfg, batch, b64 in final_graph_pairs(mesh):
        extra = {}
        if name == "STFGNN":
            extra["raw_fusion_graph_float64"] = raw_graph_gaps(
                one, sharded, cfg, mesh, batch)
        graph = "random_sensor_graph(2048, 6, seed 0; series graph seed 1)"
        if name in SYNC_GRAPH_STEPS:
            row_normalize_sync_graph(one, sharded, mesh)
            graph += ", synchronous graph row-normalized"
        line = graph_pair_line(one, sharded, cfg, mesh, batch,
                               cfg.num_nodes, f64_batch=b64)
        emit("final_predictors_graph", model=name, mode="ori",
             nodes=cfg.num_nodes, batch=batch, float64_batch=b64,
             graph=graph, mesh=mesh.shape, ranks=["cuda:0"] * 2,
             steps=PG_WARM + PG_STEPS, **graph_rows_line(sharded), **extra,
             **line)
    encode = G.GPTST.encode
    for case, one, sharded, halo, build_s in tgcn_big_pairs(rec, mesh):
        gathered = []
        G.GPTST.encode = lambda self, s: gathered.append(s.shape) or encode(
            self, s)
        try:
            line = tgcn_big_line(one, sharded, mesh,
                                 1e-4 if case.startswith("eval") else 2e-5)
        finally:
            G.GPTST.encode = encode
        if case.startswith("eval"):
            # the one-device steps encode whole, the sharded ones never
            assert len(gathered) == PG_WARM + PG_STEPS, gathered
        emit("final_predictors_graph", model="TGCN", case=case,
             mode="eval" if case.startswith("eval") else "ori",
             nodes=N_BIG, batch=BATCH, rnn_units=UNITS, mesh=mesh.shape,
             ranks=["cuda:0"] * 2, kind=halo.kind, halo_build_s=build_s,
             steps=PG_WARM + PG_STEPS, **line)
        torch.cuda.empty_cache()
    final_predictors_graph_cards(rec)


def final_predictors_graph_cards(rec: dict) -> None:
    """With 2 or more cards: the four at 2,048 nodes and TGCN at 16,384
    on the road graph with their two ranks on cuda:0 and cuda:1 against
    one device on cuda:0, the peak on each card against the one card's.
    On one card it prints that it did not run."""
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit("final_predictors_graph", case="cards", ran=False, cards=count)
        return
    mesh = make_mesh(devices=["cuda:0", "cuda:1"], graph_axis_size=2)

    def per_card(line):
        one_peak = line["one_device"]["max_memory_allocated"]["cuda:0"]
        return {k: v / one_peak for k, v in
                line["sharded"]["max_memory_allocated"].items()}

    for name, one, sharded, cfg, batch, b64 in final_graph_pairs(mesh):
        if name in SYNC_GRAPH_STEPS:
            row_normalize_sync_graph(one, sharded, mesh)
        line = graph_pair_line(one, sharded, cfg, mesh, batch,
                               cfg.num_nodes, f64_batch=b64)
        emit("final_predictors_graph", case="cards", ran=True, cards=count,
             model=name, nodes=cfg.num_nodes, batch=batch,
             float64_batch=b64, mesh=mesh.shape, ranks=["cuda:0", "cuda:1"],
             peak_per_card_over_one_card=per_card(line), **line)
    for case, one, sharded, halo, build_s in tgcn_big_pairs(rec, mesh):
        line = tgcn_big_line(one, sharded, mesh, 2e-5)
        emit("final_predictors_graph", case="cards", ran=True, cards=count,
             model="TGCN", graph=case, nodes=N_BIG, batch=BATCH,
             mesh=mesh.shape, ranks=["cuda:0", "cuda:1"], kind=halo.kind,
             peak_per_card_over_one_card=per_card(line), **line)
        break                                   # the road graph only


# the distributed phase: seconds a collective waits for a peer, and the
# seconds a run's processes may take in all before they are killed
DIST_TIMEOUT_S = 120
DIST_DEADLINE_S = 420
DIST_TGCN_STEPS = (1, 3)          # warm, timed
DIST_GPTST_EPOCHS = (1, 2, 2)     # one warm step, two timed


def dist_models(mesh, adj) -> dict:
    """The distributed phase's two runs through the port's library under
    `mesh` (None: one device), from seed-0 weights and seed-0 data of
    the global batch: TGCN `-mode ori` on the CLI graph `adj` at 16,384
    nodes, global batch 16 (1 warm and 3 timed steps), then GPT-ST
    pretrain at 16,384 nodes, global batch 8 (epochs 1, 2, 2: both mask
    branches, the KL term; 1 warm and 2 timed). Per model: the losses,
    ms per timed step, the peak memory on the mesh's root (this
    process's), the kernel launches of its steps and the parameters
    after them (on the CPU)."""
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.models.build import build_model

    root = torch.device("cuda", torch.cuda.current_device()) \
        if mesh is None else mesh.root
    out = {}
    cfg = default_config("PEMS08", mode="ori", model="TGCN", num_nodes=N_BIG,
                         batch_size=BATCH, lr_decay=False)
    model = build_model(cfg, adj=adj, device=root, seed=0, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(root)
    losses, ms, launches, dense = train_steps(
        "TGCN", model, BATCH, *DIST_TGCN_STEPS, mesh=mesh)
    assert not any(dense.values()), dense
    out["TGCN"] = dict(losses=losses, ms_per_step=ms, launches=launches,
                       lr=cfg.lr_init,
                       max_memory_allocated=torch.cuda.max_memory_allocated(
                           root),
                       params={k: v.detach().cpu()
                               for k, v in model.state_dict().items()})
    del model
    torch.cuda.empty_cache()
    gcfg = gptst_cfg(batch_size=GPTST_BATCH)
    model = build_model(gcfg, device=root, seed=0, scaler_zeros=-0.5,
                        mesh=mesh)
    torch.cuda.reset_peak_memory_stats(root)
    reset_launch_counts()
    losses, ms = gptst_steps(model, gcfg, GPTST_BATCH, DIST_GPTST_EPOCHS,
                             mesh=mesh)
    out["GPT-ST"] = dict(losses=losses, ms_per_step=ms, lr=gcfg.lr_init,
                         launches=dict(LAUNCHES),
                         max_memory_allocated=torch.cuda.max_memory_allocated(
                             root),
                         params={k: v.detach().cpu()
                                 for k, v in model.state_dict().items()})
    del model
    torch.cuda.empty_cache()
    return out


def distributed_child() -> int:
    """One process of a `dist_run`: joins the process group from
    torchrun's variables (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
    `MASTER_PORT`) with the backend `GPTST_SMOKE_BACKEND`, lays its
    global mesh over `GPTST_SMOKE_DEVICE` (one data row), runs
    `dist_models`, then the trainer's collectives (rank 0's values
    broadcast, a barrier) on that device, and writes the results to
    `$GPTST_SMOKE_OUT/rank<RANK>.pt`."""
    import torch

    sys.path.insert(0, ROOT)
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.core.distributed import (
        global_mesh, initialize_distributed, is_coordinator,
    )
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph
    from gptst_tpu_torch.parallel import collectives
    from gptst_tpu_torch.run import set_precision

    set_precision(default_config("PEMS08"))
    env = os.environ
    initialize_distributed(backend=env["GPTST_SMOKE_BACKEND"],
                           timeout=DIST_TIMEOUT_S)
    mesh = global_mesh(1, devices=[env["GPTST_SMOKE_DEVICE"]])
    t0 = time.perf_counter()
    adj = random_sensor_graph(N_BIG, avg_degree=6, seed=0)
    out = dist_models(mesh, adj)
    rank = torch.distributed.get_rank()
    assert collectives.broadcast_floats([rank, 1.5], mesh.root) == [0, 1.5]
    collectives.barrier()
    out.update(rank=rank, coordinator=is_coordinator(),
               backend=torch.distributed.get_backend(), mesh=mesh.shape,
               data_offset=mesh.data_offset, device=str(mesh.root),
               seconds=time.perf_counter() - t0)
    torch.save(out, os.path.join(env["GPTST_SMOKE_OUT"],
                                 f"rank{out['rank']}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def dist_run(world: int, backend: str, devices: list[str],
             child: str = "distributed_child", env_extra=None,
             deadline: float = DIST_DEADLINE_S) -> list[dict]:
    """`world` processes of `child` (a function of this module), rank r
    on devices[r], `env_extra` added to their environment, started
    together with a fresh localhost port; joined within `deadline`
    seconds, else every one is killed. Raises, with the end of each
    process's output, when one fails; returns their results."""
    import socket

    import torch

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(world):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                   "GPTST_SMOKE_BACKEND": backend,
                   "GPTST_SMOKE_DEVICE": devices[r], "GPTST_SMOKE_OUT": tmp,
                   **(env_extra or {})}
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 f"sys.exit(chip_smoke.{child}())"],
                cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline
        try:
            for p in procs:
                p.wait(timeout=max(end - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(f"rank {r} (exit {procs[r].returncode}): "
                         + log.read()[-2000:])
            log.close()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"{world} processes over {backend}: a "
                               "process failed or passed the deadline\n"
                               + "\n".join(tails))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def dist_check(results: list[dict], want: dict,
               adam_noise: bool = False) -> dict:
    """Every process's runs against the one-process runs `want` of the
    same global mesh: the losses at rtol 1e-5, every parameter at rtol
    1e-4 with an atol of 1e-5 of its largest entry; every process's
    parameters equal to rank 0's, bit for bit. With `adam_noise` (more
    than two processes, whose gradient sum runs in another order than
    one process's), at most 1e-3 of a model's entries may miss that
    tolerance, each by at most 2 lr a step: Adam turns a gradient that
    is f32 noise around 0 into a step of up to lr either way. Returns
    per model the largest parameter error and the entries that missed
    the tolerance."""
    import numpy as np
    import torch

    errs = {}
    for model, ref in want.items():
        for res in results:
            got = res[model]
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=1e-5, err_msg=model)
            err, off, size = 0.0, 0, 0
            for k, w in ref["params"].items():
                diff = (got["params"][k] - w).abs()
                tol = 1e-4 * w.abs() + 1e-5 * w.abs().max()
                miss = diff > tol
                err = max(err, float(diff.max()))
                off += int(miss.sum())
                size += w.numel()
                bound = 2 * ref["lr"] * len(ref["losses"])
                assert not miss.any() or (
                    adam_noise and float(diff[miss].max()) <= bound), (
                    f"{model} rank {res['rank']} params {k}: "
                    f"{int(miss.sum())} entries off, up to "
                    f"{float(diff.max())}")
                assert torch.equal(got["params"][k],
                                   results[0][model]["params"][k]), k
            assert off <= 1e-3 * size, (model, off, size)
            prev = errs.get(model, {"max_param_err": 0.0, "entries_off": 0})
            errs[model] = {"max_param_err": max(prev["max_param_err"], err),
                           "entries_off": max(prev["entries_off"], off),
                           "entries": size}
    return errs


def dist_summary(runs: dict) -> dict:
    """`dist_models`' runs without their parameters."""
    return {m: {k: v for k, v in r.items() if k != "params"}
            for m, r in runs.items()}


def dist_line(results: list[dict]) -> dict:
    """What each process reports, without its parameters."""
    return {f"rank {res['rank']}": {
        **{k: res[k] for k in ("device", "backend", "mesh", "data_offset",
                               "coordinator", "seconds")},
        **dist_summary({m: res[m] for m in ("TGCN", "GPT-ST")})}
        for res in results}


def phase_distributed(rec: dict) -> None:
    """Data-parallel training across processes (`core/distributed.py`):
    two processes on cuda:0 over gloo (NCCL refuses two ranks on one
    device; the backend is chosen explicitly), each with a (1, 1) mesh
    of a global (2, 1) data axis, run `dist_models` (TGCN on the CLI
    graph through `bsr_spmm` in each process, GPT-ST pretrain) against
    the same runs in this process on a (2, 1) mesh of `[cuda:0,
    cuda:0]`: `dist_check`'s tolerances, `bsr_spmm` launched in every
    process, ms per step and each process's peak memory beside the
    one-process run's. Gloo runs every collective of the step and the
    trainer (all-gather, all-reduce, broadcast, barrier) on the CUDA
    tensors, copying them through host memory itself. With 2 or more
    cards, `distributed_cards`."""
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=1)
    t0 = time.perf_counter()
    want = dist_models(mesh, rec["_cli_base"])
    one_s = time.perf_counter() - t0
    assert want["TGCN"]["launches"]["bsr_spmm"] > 0, want["TGCN"]
    t0 = time.perf_counter()
    results = dist_run(2, "gloo", ["cuda:0"] * 2)
    run_s = time.perf_counter() - t0
    errs = dist_check(results, want)
    for res in results:
        assert res["backend"] == "gloo" and res["mesh"] == mesh.shape, res
        assert res["TGCN"]["launches"]["bsr_spmm"] > 0, res["TGCN"]
    rec["bsr_spmm"]["launches_by_path"]["distributed"] = {
        f"rank {res['rank']}": res["TGCN"]["launches"]["bsr_spmm"]
        for res in results}
    emit("distributed", case="one card", processes=2, backend="gloo",
         devices=["cuda:0"] * 2, global_mesh=mesh.shape, nodes=N_BIG,
         batch={"TGCN": BATCH, "GPT-ST": GPTST_BATCH},
         one_process=dist_summary(want), one_process_s=one_s,
         processes_s=run_s, check=errs,
         tol={"losses_rtol": 1e-5, "params_rtol": 1e-4,
              "params_atol_of_largest": 1e-5},
         **dist_line(results))
    torch.cuda.empty_cache()
    distributed_cards(rec)


def distributed_cards(rec: dict) -> None:
    """With 2 or more cards: NCCL, one process per card, 2 processes
    (and 4 with 4 cards), against the one-process mesh over the same
    cards (`dist_check`), and beside one card's runs (no mesh). On one
    card it prints that it did not run."""
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit("distributed", case="cards", ran=False, cards=count)
        return
    one_card = dist_models(None, rec["_cli_base"])
    for world in (2, 4)[:1 + (count >= 4)]:
        cards = [f"cuda:{i}" for i in range(world)]
        mesh = make_mesh(devices=cards, graph_axis_size=1)
        want = dist_models(mesh, rec["_cli_base"])
        results = dist_run(world, "nccl", cards)
        emit("distributed", case="cards", ran=True, cards=count,
             processes=world, backend="nccl", devices=cards,
             global_mesh=mesh.shape, one_card=dist_summary(one_card),
             one_process=dist_summary(want), **dist_line(results))
        emit("distributed", case="cards", processes=world,
             check=dist_check(results, want, adam_noise=world > 2))
        torch.cuda.empty_cache()


def gptst_cfg(**kw):
    """`-mode pretrain` at PEMS08's published widths (hidden 64, embed
    16, spa 4, HS 10, HT 16, HT_Tem 8, 2 routing rounds, lag = horizon
    12) at 16,384 nodes, `change_epoch` 1."""
    from gptst_tpu_torch.config.config import default_config

    return default_config("PEMS08", mode="pretrain", num_nodes=N_BIG,
                          change_epoch=1, lr_decay=False, **kw)


def gptst_net(cfg):
    """GPT-ST in the pretrain contract, random weights from seed 0."""
    from gptst_tpu_torch.models.build import build_model

    return build_model(cfg, device="cuda", seed=0, scaler_zeros=-0.5)


def gptst_steps(model, cfg, batch: int, epochs: tuple,
                trace: str | None = None, mesh=None):
    """Pretrain train steps of `model` through the port's library on
    random data from seed 0, one at each epoch of `epochs`; the steps
    after the first are timed and, with `trace`, profiled
    (`run_steps`); with `mesh`, data-parallel over its data rows.
    Returns the losses and ms per timed step."""
    import numpy as np
    import torch

    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import (
        make_loss_terms, model_forwards, train_step,
    )
    from gptst_tpu_torch.train.trainer import make_optimizer

    opt = make_optimizer(cfg, model.parameters(), steps_per_epoch=10)
    loss_terms = make_loss_terms(
        model, build_loss("mask_mae", 200.0, 100.0, 0.0, True), cfg,
        forward=None if mesh is None else model_forwards(model, cfg,
                                                         mesh)[1])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.lag, cfg.num_nodes, 3), np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    return run_steps(lambda i: train_step(
        loss_terms, opt, x, x, i, epoch=epochs[i - 1], generator=gen)[0],
        1, len(epochs) - 1, trace)


def phase_gptst_model(rec: dict) -> None:
    import torch

    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts

    cfg = gptst_cfg(batch_size=GPTST_BATCH)
    model = gptst_net(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    epochs = (1, 2, 2, 2)
    losses, ms = gptst_steps(model, cfg, GPTST_BATCH, epochs)
    peak = torch.cuda.max_memory_allocated()
    assert not any(LAUNCHES.values()), LAUNCHES   # dense einsums only
    bf_losses, bf_ms = gptst_steps(
        model, cfg.replace(compute_dtype="bfloat16"), GPTST_BATCH, (2, 2))
    emit("gptst_model", nodes=N_BIG, batch=GPTST_BATCH,
         widths=dict(hidden_dim=cfg.hidden_dim, embed_dim=cfg.embed_dim,
                     embed_dim_spa=cfg.embed_dim_spa, HS=cfg.HS, HT=cfg.HT,
                     HT_Tem=cfg.HT_Tem, num_route=cfg.num_route,
                     lag=cfg.lag, horizon=cfg.horizon),
         parameters=sum(p.numel() for p in model.parameters()),
         epochs=epochs, change_epoch=cfg.change_epoch, ms_per_step=ms,
         samples_per_s=GPTST_BATCH / ms * 1e3, losses=losses,
         max_memory_allocated=peak, bf16_losses=bf_losses,
         bf16_ms_per_step=bf_ms)
    del model
    torch.cuda.empty_cache()


def run_gptst_cli(tmp: str, extra: tuple = ()):
    """`run.main` in pretrain mode at PEMS08's 170 nodes, batch 64, 2
    epochs across `change_epoch` 1, under `tmp`, with the arguments
    `extra`; returns its phase line's fields (finite losses and
    metrics, no `csrc/` launch) and the trainer."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.datasets import get_dataset_spec
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.run import main

    epochs, num_steps = 2, 2000
    assert get_dataset_spec("PEMS08").num_nodes == GPTST_CLI_NODES
    data = write_pems08(tmp, GPTST_CLI_NODES, num_steps)
    metrics = os.path.join(tmp, "metrics.json")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with TrainProbe(keep=True) as probe:
        main(["-dataset", "PEMS08", "-mode", "pretrain", "-data_root",
              data, "-batch_size", str(GPTST_CLI_BATCH),
              "-epochs", str(epochs),
              "-change_epoch", "1", "-lr_decay", "False", "-log_dir",
              os.path.join(tmp, "save"), "-log_step", "1000",
              "-metrics_out", metrics, *extra])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    with open(metrics) as f:
        rep = json.load(f)
    assert not any(launches.values()), launches   # dense einsums only
    vals = np.asarray(rep["per_horizon"] + [rep["average"]], np.float64)
    assert np.isfinite(vals).all() and np.isfinite(rep["history"]).all()
    steps = rep["steps_per_epoch"]
    peak = torch.cuda.max_memory_allocated()
    (tr,) = probe.trainers
    return dict(
        nodes=GPTST_CLI_NODES, batch=GPTST_CLI_BATCH, epochs=epochs,
        change_epoch=1, time_steps=num_steps, extra_args=list(extra),
        steps_per_epoch=steps,
        ms_per_step_by_epoch=[s / steps * 1e3 for s in rep["epoch_seconds"]],
        samples_per_s_last_epoch=steps * GPTST_CLI_BATCH
        / rep["epoch_seconds"][-1],
        train_loss_by_epoch=rep["history"], best_loss=rep["best_loss"],
        test_average=rep["average"], max_memory_allocated=peak,
        held_before=held, peak_over_held=peak - held,
        **probe.line(epochs * steps), wall_s=wall), tr


def phase_gptst_cli(rec: dict) -> None:
    """`run.main` in pretrain mode (`run_gptst_cli`); the trained model
    is taken from the Trainer, and the checkpoint must give a fresh
    GPT-ST the same `encode` (rtol 1e-6, atol 1e-6: the same weights
    on the same card repeat the same products). `test_average` is the
    report on the train split."""
    import torch

    from gptst_tpu_torch.models.gptst import GPTST, GPTSTConfig

    with tempfile.TemporaryDirectory() as tmp:
        line, tr = run_gptst_cli(tmp)
        ckpt = os.path.join(tmp, "save", "PEMS08", tr.cfg.save_pretrain_path)
        assert os.path.isfile(ckpt), ckpt
        fresh = GPTST(GPTSTConfig.from_framework(
            tr.cfg, tr.dataset.scaler_zeros)).cuda()
        fresh.load_state_dict(torch.load(ckpt, map_location="cuda",
                                         weights_only=True), strict=True)
    x = torch.from_numpy(tr.dataset.x_train[:GPTST_CLI_BATCH]).cuda()
    with torch.no_grad():
        want = tr.model(x).pred
        got = fresh.encode(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    rec["_gptst_cli_run"] = line
    emit("gptst_cli", mode="pretrain", model_flag="STGCN (default, unread)",
         **line, checkpoint_keys=len(fresh.state_dict()),
         encode_max_abs_err=float((got - want).abs().max()))


# the resident and the host path feed the same batch values; the runs
# differ only by the order of atomic sums (`index_add_` of the COO tail
# and of the gathers' backward), amplified through Adam: in `cli`'s
# TGCN two host runs were up to 4.5e-6 apart, two resident runs 3.0e-6,
# the paths 6.8e-6 (PERF.md, section 6); GPT-ST at 170 nodes was bitwise
DEVICE_DATA_RTOL = 1e-4
_KEPT = ("ms_per_step_by_epoch", "max_memory_allocated", "held_before",
         "peak_over_held", "resident_split_bytes",
         "h2d_copies_in_train_steps", "h2d_batch_copies_in_train_steps",
         "h2d_bytes_in_train_steps", "train_loss_by_epoch", "best_loss",
         "test_average", "wall_s")


def device_data_pair(resident: list, host: list) -> dict:
    """The resident and the host runs' fields side by side: epoch 2's
    ms per step of the host path over the resident path's (their
    means), and the largest relative gap of the losses, best loss and
    test average between the paths, within each path where it ran twice
    (`check_device_data` holds them)."""
    import itertools

    import numpy as np

    def vals(a: dict):
        return np.asarray(a["train_loss_by_epoch"] + [a["best_loss"]]
                          + list(a["test_average"]), np.float64)

    def gap(pairs) -> float | None:
        return max((float((np.abs(vals(a) - vals(b)) / np.abs(vals(b))).max())
                    for a, b in pairs), default=None)

    def epoch2(runs) -> float:
        return statistics.mean(r["ms_per_step_by_epoch"][-1] for r in runs)

    return dict(
        steps_per_epoch=resident[0]["steps_per_epoch"],
        resident=[{k: r[k] for k in _KEPT} for r in resident],
        host=[{k: h[k] for k in _KEPT} for h in host],
        epoch2_ms_host_over_resident=epoch2(host) / epoch2(resident),
        rel_gap_resident_host=gap(itertools.product(resident, host)),
        rel_gap_host_host=gap(itertools.combinations(host, 2)),
        rel_gap_resident_resident=gap(itertools.combinations(resident, 2)),
        rtol=DEVICE_DATA_RTOL)


def check_device_data(line: dict) -> None:
    """`device_data_pair`'s line: the resident path holds its split and
    copies no batch in its train steps; the counter sees the host
    path's x and y of every step; the paths agree within the rtol."""
    steps = 2 * line["steps_per_epoch"]
    for r in line["resident"]:
        assert r["resident_split_bytes"] > 0, r
        # no copy at all: GPT-ST's per-step 8-byte copy is gone too
        assert r["h2d_copies_in_train_steps"] == 0, r
    for h in line["host"]:
        assert h["resident_split_bytes"] == 0, h
        assert h["h2d_batch_copies_in_train_steps"] == 2 * steps, h
    assert line["rel_gap_resident_host"] <= line["rtol"], line


def phase_device_data(rec: dict, abba: bool = False) -> None:
    """`cli`'s TGCN run and `gptst_cli`'s pretrain run (made here where
    those phases did not run) against a run of each with `-device_data
    False` (`device_data_pair`). With `abba`, fresh runs of each model
    in the order host, resident, resident, host. Then the split over
    'graph': `device_data_graph` on one card, and
    `device_data_graph_cards` with 2 or more."""
    host = ("-device_data", "False")

    def gptst(extra):
        with tempfile.TemporaryDirectory() as tmp:
            return run_gptst_cli(tmp, extra)[0]

    for model, run, kept, kw in (
            ("TGCN", lambda extra: run_cli("TGCN", BATCH, CLI_TIME_STEPS,
                                           extra=extra),
             "_cli_run", dict(nodes=N_BIG, batch=BATCH,
                              time_steps=CLI_TIME_STEPS)),
            ("GPT-ST pretrain", gptst, "_gptst_cli_run",
             dict(nodes=GPTST_CLI_NODES, batch=GPTST_CLI_BATCH,
                  time_steps=2000))):
        earlier = rec.pop(kept, None)
        if abba:
            h1, r1, r2, h2 = (run(e) for e in (host, (), (), host))
            resident, hosted = [r1, r2], [h1, h2]
        else:
            resident, hosted = [earlier or run(())], [run(host)]
        line = device_data_pair(resident, hosted)
        emit("device_data", model=model, order="host, resident, resident, "
             "host" if abba else "resident (earlier phase), host",
             **kw, **line)
        check_device_data(line)
    device_data_graphs(rec)


def device_data_graphs(rec: dict, one_card: bool = True) -> None:
    """The device_data cases over 'graph' on a 16,384-node PEMS08.npz of
    `DEVICE_DATA_GRAPH_TIME_STEPS` steps: `device_data_graph` (unless not
    `one_card`) and `device_data_graph_cards`."""
    with tempfile.TemporaryDirectory() as tmp:
        common = ["-dataset", "PEMS08", "-num_nodes", str(N_BIG),
                  "-data_root", write_pems08(tmp, N_BIG,
                                             DEVICE_DATA_GRAPH_TIME_STEPS),
                  "-epochs", "2", "-lr_decay", "False", "-early_stop",
                  "False", "-log_step", "1000"]
        argv = [*common, "-mode", "ori", "-model", "TGCN", "-batch_size",
                str(BATCH)]
        if one_card:
            device_data_graph(rec, argv)
        device_data_graph_cards(rec, argv, [
            *common, "-mode", "pretrain", "-batch_size", str(GPTST_BATCH),
            "-change_epoch", "1"])


# the device_data phase's cases over 'graph': a PEMS08.npz of these time
# steps (3 validation and 3 test batches of 16), the CLI trainer's train
# split cut to these windows (full batches and a ragged tail), 2 epochs
DEVICE_DATA_GRAPH_TIME_STEPS = 300
DEVICE_DATA_GRAPH_WINDOWS = 3 * BATCH + 3
DEVICE_DATA_GPTST_WINDOWS = 3 * GPTST_BATCH + 3
# the memcpy kinds between devices in a profiler trace
D2D_KINDS = ("DtoD", "PtoP")


class BatchCopies:
    """While entered, the copies of a train step's batch between
    devices are tagged and sized. `batch_x` and `batch_y` tag each
    `Tensor.to` whose source shares its storage with the x or y that a
    data-parallel step was handed (its rows' shards, or the whole batch,
    and views of either), or with an earlier tagged copy's result;
    `labels` tags `ResidentSplit.batch`, whose only copies between
    devices are the labels it brings to the root. Each tag's copies run
    inside `torch.profiler.record_function` ranges of its name, and
    `moved` holds the bytes of their results that landed on another
    device. A context manager: patches on enter, restores on exit.

    `count(trace, steps)` reads a profiler trace of the steps: each
    memcpy event between devices (`gpu_memcpy`, DtoD or PtoP) and each
    copy kernel is joined by its correlation id to the runtime call that
    launched it, and goes to the tag of the range that holds that call
    on the same thread, or to `other` (the halo exchange, the outputs'
    gather, the parameters read on other devices). A contiguous copy
    between cards is a memcpy, which the trace sizes; a strided one
    (a channel of the batch: the base channel the model reads, the
    labels' flow channel) runs as a copy kernel that reads the peer
    card, which the trace does not size: its bytes come from `moved`.
    Returns, per step, `moved` by tag and the trace's memcpy events,
    their bytes and the copy kernels by tag."""

    TAGS = ("batch_x", "batch_y", "labels")

    def __enter__(self):
        import torch

        from gptst_tpu_torch.parallel import mesh as M, spmd

        self.moved = dict.fromkeys(self.TAGS, 0)
        self.storages = {"batch_x": set(), "batch_y": set()}
        record = torch.profiler.record_function
        T = torch.Tensor
        call, batch, to = self._saved = (spmd.DataParallel.__call__,
                                         M.ResidentSplit.batch, T.to)

        def storages(x) -> set:
            if x is None:
                return set()
            rows = x.rows if isinstance(x, M.PlacedBatch) else [x]
            return {t.untyped_storage().data_ptr() for r in rows or ()
                    for t in (r if isinstance(r, list) else [r])}

        def calling(dp, x, *args, **kw):
            self.storages = {"batch_x": storages(x),
                             "batch_y": storages(kw.get("y"))}
            return call(dp, x, *args, **kw)

        def moving(t, *args, **kw):
            try:
                src = t.untyped_storage().data_ptr()
            except (RuntimeError, NotImplementedError):    # no storage
                return to(t, *args, **kw)
            tag = next((k for k, v in self.storages.items() if src in v),
                       None)
            if tag is None:
                return to(t, *args, **kw)
            with record(tag):
                out = to(t, *args, **kw)
            if out.device != t.device:
                self.moved[tag] += out.nbytes
                self.storages[tag].add(out.untyped_storage().data_ptr())
            return out

        def gathering(rs, *args, **kw):
            self.storages = {"batch_x": set(), "batch_y": set()}
            with record("labels"):
                out = batch(rs, *args, **kw)
            label = next(b.label for b in out if b.label is not None)
            sh = rs.rows[0]
            off = sum(hi - lo for (lo, hi), d in zip(
                map(sh.node_range, range(sh.parts)), sh.devices)
                if d != rs.root)
            self.moved["labels"] += label.nbytes * off // sh.n
            return out

        spmd.DataParallel.__call__, M.ResidentSplit.batch = calling, gathering
        T.to = moving
        return self

    def __exit__(self, *exc) -> None:
        import torch

        from gptst_tpu_torch.parallel import mesh as M, spmd

        spmd.DataParallel.__call__, M.ResidentSplit.batch, torch.Tensor.to = (
            self._saved)

    def count(self, path: str, steps: int) -> dict:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ranges: dict = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e["name"] in self.TAGS:
                ranges.setdefault((e["pid"], e["tid"]), []).append(
                    (e["ts"], e["ts"] + e["dur"], e["name"]))
        calls = {e["args"]["correlation"]: e for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
        trace = {t: dict(memcpy=0.0, memcpy_bytes=0.0, copy_kernels=0.0)
                 for t in (*self.TAGS, "other")}
        for e in events:
            memcpy = e.get("cat") == "gpu_memcpy" and any(
                k in e["name"] for k in D2D_KINDS)
            kernel = e.get("cat") == "kernel" and "copy" in e["name"].lower()
            if not (memcpy or kernel):
                continue
            tag = "other"
            c = calls.get(e.get("args", {}).get("correlation"))
            if c is not None:
                tag = next((name for lo, hi, name in ranges.get(
                    (c["pid"], c["tid"]), ()) if lo <= c["ts"] <= hi),
                    "other")
            if memcpy:
                trace[tag]["memcpy"] += 1 / steps
                trace[tag]["memcpy_bytes"] += e["args"].get("bytes", 0) / steps
            else:
                trace[tag]["copy_kernels"] += 1 / steps
        return dict(d2d_bytes_per_step={k: v / steps
                                        for k, v in self.moved.items()},
                    trace_copies_per_step=trace)


def graph_data_run(cfg, ds, model, mesh, host: bool, trace: str | None):
    """Two epochs through `Trainer.train` of `model` under `mesh` on the
    resident split (or, with `host`, `-device_data False`): ms per step
    by epoch, peak allocated on each card over what it held before, the
    split's bytes on each card and each rank's, `TrainProbe`'s
    host-to-device copies inside the train steps, the losses, best loss
    and test average, each data row's forward launches, and with `trace`
    the device-to-device copies of epoch 1's train steps by what they
    carried (`BatchCopies`, its trace read and deleted)."""
    import torch

    from gptst_tpu_torch.parallel.rows import ROW_LAUNCHES
    from gptst_tpu_torch.train import Trainer

    devs = list(dict.fromkeys(mesh.devices.flat))
    for d in devs:
        torch.cuda.synchronize(d)
    held = {str(d): torch.cuda.memory_allocated(d) for d in devs}
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    ROW_LAUNCHES.clear()
    copies: dict = {}
    with TrainProbe() as probe:
        tr = Trainer(model=model, cfg=cfg.replace(device_data=not host),
                     dataset=ds, seed=cfg.seed, device=mesh.root, mesh=mesh)
        epoch_fn = tr.train_epoch

        def train_epoch(epoch: int):
            if trace is None or epoch != 1:
                return epoch_fn(epoch)
            with BatchCopies() as tagged, torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                out = epoch_fn(epoch)
                for d in devs:
                    torch.cuda.synchronize(d)
            prof.export_chrome_trace(trace)
            copies.update(tagged.count(trace, tr.steps_per_epoch))
            os.remove(trace)
            return out

        tr.train_epoch = train_epoch
        res = tr.train()
        for d in devs:
            torch.cuda.synchronize(d)
    steps = res["steps_per_epoch"]
    split = tr.train_split
    run = dict(
        steps_per_epoch=steps,
        ms_per_step_by_epoch=[s / steps * 1e3 for s in res["epoch_seconds"]],
        peak_over_held_by_card={str(d): torch.cuda.max_memory_allocated(d)
                                - held[str(d)] for d in devs},
        split_bytes_by_card=split_bytes(tr),
        split_bytes_by_rank=(split.rank_bytes() if split is not None
                             else None),
        train_loss_by_epoch=res["history"], best_loss=res["best_loss"],
        test_average=res["report"]["average"],
        row_forward_launches={r: {k: v for k, v in n.items() if v}
                              for r, n in sorted(ROW_LAUNCHES.items())},
        **probe.line(len(res["history"]) * steps), **copies)
    run.pop("resident_split_bytes")
    del tr, split
    torch.cuda.empty_cache()
    return run


def graph_data_pair(argv: list[str], windows: int, model, mesh,
                    profile: bool = False) -> dict:
    """`graph_data_run` of `model` on the resident split, then on the
    host path from the same weights (reloaded), each the CLI trainer of
    `argv` cut to `windows`; the largest relative gap between the
    paths' losses, best loss and test average."""
    import numpy as np

    cfg, ds = cli_dataset(tuple(argv), windows)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, host in (("resident", False), ("host", True)):
            model.load_state_dict(init)
            runs[path] = graph_data_run(
                cfg, ds, model, mesh, host,
                os.path.join(tmp, "trace.json") if profile else None)

    def vals(a: dict):
        return np.asarray(a["train_loss_by_epoch"] + [a["best_loss"]]
                          + list(a["test_average"]), np.float64)

    r, h = vals(runs["resident"]), vals(runs["host"])
    return dict(mesh=dict(mesh.shape), devices=[str(d) for d in
                                                mesh.devices.flat],
                steps_per_epoch=runs["resident"]["steps_per_epoch"],
                split_bytes_whole=int(ds.x_train.nbytes + ds.y_train.nbytes),
                **runs, rel_gap_resident_host=float(
                    (np.abs(r - h) / np.abs(h)).max()),
                rtol=DEVICE_DATA_RTOL)


def check_graph_data(line: dict) -> None:
    """A `graph_data_pair` line: the resident path holds its split on
    every rank, 1/G of it each where the graph axis divides N, copies no
    batch from the host in its train steps and, where its copies were
    counted, none of x between devices; the host path holds none; the
    paths agree within the rtol."""
    res, host = line["resident"], line["host"]
    g = line["mesh"]["graph"]
    ranks = [b for row in res["split_bytes_by_rank"] for b in row]
    assert ranks and all(b * g == line["split_bytes_whole"] for b in ranks), (
        line)
    assert res["h2d_batch_copies_in_train_steps"] == 0, res
    assert host["split_bytes_by_card"] == {}, host
    steps = 2 * line["steps_per_epoch"]
    assert host["h2d_batch_copies_in_train_steps"] == 2 * steps, host
    if "d2d_bytes_per_step" in res:
        # the resident path moves no x and no y between devices; the
        # host path's root sends its rows and ranks their x (the check
        # sees copies where there are some)
        for tag in ("batch_x", "batch_y"):
            assert res["d2d_bytes_per_step"][tag] == 0, res
            assert not any(res["trace_copies_per_step"][tag].values()), res
        assert host["d2d_bytes_per_step"]["batch_x"] > 0, host
    assert line["rel_gap_resident_host"] <= line["rtol"], line


def tgcn_halo_model(rec: dict, mesh):
    """TGCN at its published widths (seed 0) on a halo of the CLI graph
    over `mesh`'s graph ranks, node-sharded (`GraphPredictor.mesh`)."""
    import numpy as np

    from gptst_tpu_torch.graph import partition as P
    from gptst_tpu_torch.ops.graph_conv import make_sharded_support

    sym = rec["_cli_sym"]
    rows, cols = np.nonzero(sym)
    halo = make_sharded_support(None, mesh, part=P.partition_graph_coo(
        rows, cols, sym[rows, cols], N_BIG, mesh.shape["graph"]))
    model = bind("TGCN", tgcn_net(), (halo,))
    model.predictor.mesh = mesh
    return model


def device_data_graph(rec: dict, argv: list[str]) -> None:
    """`case="graph"`: the TGCN CLI trainer at 16,384 nodes on a (1, 2)
    mesh of `[cuda:0, cuda:0]`, its split node-sharded over the two
    ranks, against `-device_data False` (`graph_data_pair`)."""
    from gptst_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(devices=["cuda:0"] * 2, graph_axis_size=2)
    model = tgcn_halo_model(rec, mesh)
    line = graph_data_pair(argv, DEVICE_DATA_GRAPH_WINDOWS, model, mesh)
    del model
    emit("device_data", case="graph", model="TGCN", nodes=N_BIG,
         batch=BATCH, windows=DEVICE_DATA_GRAPH_WINDOWS, **line,
         seconds=time.perf_counter() - t0)
    check_graph_data(line)


def device_data_graph_cards(rec: dict, argv: list[str],
                            gptst_argv: list[str]) -> None:
    """`case="graph_cards"`, with 2 or more cards: the TGCN CLI trainer
    at 16,384 nodes on (1, 2) of cuda:0 and cuda:1 (a halo of the CLI
    graph) and on (2, 1) (each data row's own whole split and
    `bsr_spmm` support), and with 4 cards GPT-ST pretrain at 16,384
    nodes, batch 8, on (2, 2); each resident run against the host path
    from the same weights (`graph_data_pair`), epoch 1's train steps
    profiled for the device-to-device copies by what they carried
    (`BatchCopies`). On one card it prints that it did not run."""
    import torch

    from gptst_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit("device_data", case="graph_cards", ran=False, cards=count)
        return
    from gptst_tpu_torch.models.build import build_model

    cases = [("TGCN", (1, 2)), ("TGCN", (2, 1))]
    if count >= 4:
        cases.append(("GPT-ST pretrain", (2, 2)))
    for name, (d, g) in cases:
        t0 = time.perf_counter()
        mesh = make_mesh(devices=[f"cuda:{i}" for i in range(d * g)],
                         graph_axis_size=g)
        if name == "TGCN" and g > 1:
            model, args, windows = (tgcn_halo_model(rec, mesh), argv,
                                    DEVICE_DATA_GRAPH_WINDOWS)
        elif name == "TGCN":
            model = bind("TGCN", tgcn_net(),
                         (rec["_supports"]["cli_graph"],))
            model.predictor.mesh = mesh
            args, windows = argv, DEVICE_DATA_GRAPH_WINDOWS
        else:
            args, windows = gptst_argv, DEVICE_DATA_GPTST_WINDOWS
            cfg, ds = cli_dataset(tuple(args), windows)
            model = build_model(cfg, device=mesh.root, seed=cfg.seed,
                                scaler_zeros=ds.scaler_zeros, mesh=mesh)
        line = graph_data_pair(args, windows, model, mesh, profile=True)
        del model
        if d > 1 and name == "TGCN":      # each row's own support
            for run in (line["resident"], line["host"]):
                launched = run["row_forward_launches"]
                assert all(launched.get(r, {}).get("bsr_spmm", 0) > 0
                           for r in range(d)), launched
        emit("device_data", case="graph_cards", model=name,
             nodes=N_BIG, batch=(BATCH if name == "TGCN"
                                 else GPTST_BATCH),
             windows=windows, **line, seconds=time.perf_counter() - t0)
        check_graph_data(line)
        torch.cuda.empty_cache()


# K of the step_graph phase's trainers: 2 K full batches (two chunks
# of replays), then a full batch and a ragged tail (one step each)
STEP_GRAPH_K = 4
STEP_GRAPH_EPOCHS = 2
# replays against eager steps on the card: the same kernels in the same
# order, unless a library picks another algorithm under capture; where
# `index_add_`'s atomics sum (the COO tail), as `device_data`
STEP_GRAPH_RTOL = 1e-5
STEP_GRAPH_ATOMIC_RTOL = DEVICE_DATA_RTOL
STEP_GRAPH_PREDICTORS = (
    ("STGCN", "PEMS08"), ("TGCN", "PEMS08"), ("MSDR", "PEMS08"),
    ("GWN", "PEMS08"), ("MTGNN", "PEMS08"), ("CCRNN", "NYC_BIKE"),
    ("STMGCN", "NYC_BIKE"), ("ASTGCN", "PEMS08"), ("STSGCN", "PEMS08"),
    ("STFGNN", "PEMS08"), ("STGODE", "PEMS08"), ("ST_WA", "PEMS08"),
    ("DMVSTNET", "NYC_BIKE"))


class RunnerProbe:
    """While entered, every `train/step.StepGraph` made is kept
    (`runners`) and each of its `run` calls is measured (`calls`): the
    card synchronized before it, the host seconds until it returns, the
    wall seconds until the card has run it, and the kernel launches it
    counted (through its replays). With `eager`, the runners take their
    steps eagerly on the card (`capture` False): the reference the
    replays are held against."""

    def __init__(self, eager: bool = False):
        self.eager = eager
        self.runners: list = []
        self.calls: list[dict] = []

    def __enter__(self):
        import torch

        from gptst_tpu_torch.kernels.spmm import LAUNCHES
        from gptst_tpu_torch.train.step import StepGraph

        self._saved = (StepGraph.__init__, StepGraph.run)
        init, run = self._saved

        def made(rn, *args, **kw):
            init(rn, *args, **kw)
            rn.capture = rn.capture and not self.eager
            self.runners.append(rn)

        def measured(rn, steps, key, feed=None):
            torch.cuda.synchronize()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            run(rn, steps, key, feed)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            self.calls.append(dict(
                steps=steps, host_s=host, wall_s=time.perf_counter() - t0,
                launches={k: LAUNCHES[k] - before[k] for k in LAUNCHES}))

        StepGraph.__init__, StepGraph.run = made, measured
        return self

    def __exit__(self, *exc) -> None:
        from gptst_tpu_torch.train.step import StepGraph

        StepGraph.__init__, StepGraph.run = self._saved


@functools.lru_cache(maxsize=1)
def cli_dataset(argv: tuple, windows: int):
    """The config and dataset `run.main(argv)` builds, the train split
    cut to `windows`: the last one is kept, so that the graphed and the
    eager trainer of a step_graph case read one dataset (a build at
    16,384 nodes takes seconds)."""
    from gptst_tpu_torch.data import build_dataset
    from gptst_tpu_torch.run import make_config, parse_args

    ns = parse_args(list(argv))
    cfg = make_config(ns)
    ds = build_dataset(cfg, data_root=cfg.data_root, num_steps=ns.num_steps,
                       seed=cfg.seed)
    assert ds.x_train.shape[0] >= windows, ds.x_train.shape
    ds.x_train, ds.y_train = ds.x_train[:windows], ds.y_train[:windows]
    return cfg, ds


def cli_trainer(argv: list[str], windows: int, model=None, mesh=None):
    """The one-card `Trainer` that `run.main(argv)` builds (dataset,
    model from the seed, config), its train split cut to `windows`;
    `model` in place of the built one; with `mesh`, the data-parallel
    trainer on its root (the library's entry across processes). In
    eval mode the frozen GPT-ST is `build_pretrain`'s random init."""
    from gptst_tpu_torch.models.build import build_model, build_pretrain
    from gptst_tpu_torch.train import Trainer

    cfg, ds = cli_dataset(tuple(argv), windows)
    device = "cuda" if mesh is None else mesh.root
    if model is None:
        pretrain = None
        if cfg.mode == "eval":
            pretrain = build_pretrain(cfg.replace(mode="pretrain"),
                                      device=device, seed=cfg.seed).gptst
        model = build_model(cfg, device=device, seed=cfg.seed,
                            scaler_zeros=ds.scaler_zeros,
                            pretrain_params=pretrain, mesh=mesh)
    return Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                   device=device, mesh=mesh)


def step_graph_run(make, eager: bool) -> tuple[dict, object, dict]:
    """`STEP_GRAPH_EPOCHS` train epochs of the trainer `make()` builds:
    graphed (the default on the card) or, with `eager`, the same step
    body eagerly. Returns the line's fields (ms and host ms per step
    over the last epoch's runner steps, which hold pretrain's warm-up
    and capture, and over its last chunk, replays only; kernel launches
    per step; peak allocated and reserved over what was held, captures),
    the per-step losses (epochs, steps, 2) and the parameters."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    held_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    with RunnerProbe(eager) as probe:
        tr = make()
        losses = []
        for epoch in range(1, STEP_GRAPH_EPOCHS + 1):
            tr.train_epoch(epoch)
            losses.append(tr._losses.clone())
        tr.release_graph()
    torch.cuda.synchronize()
    (runner,) = probe.runners
    last = probe.calls[len(probe.calls) // STEP_GRAPH_EPOCHS
                       * (STEP_GRAPH_EPOCHS - 1):]
    steps, chunk = sum(c["steps"] for c in last), probe.calls[-1]
    line = dict(
        runner_steps_last_epoch=steps,
        ms_per_step=sum(c["wall_s"] for c in last) / steps * 1e3,
        host_ms_per_step=sum(c["host_s"] for c in last) / steps * 1e3,
        # the last chunk: replays only, also where the epoch captured
        ms_per_step_last_chunk=chunk["wall_s"] / chunk["steps"] * 1e3,
        host_ms_per_step_last_chunk=chunk["host_s"] / chunk["steps"] * 1e3,
        peak_over_held=torch.cuda.max_memory_allocated() - held,
        reserved_peak_over_held=torch.cuda.max_memory_reserved()
        - held_reserved,
        captures=runner.captures,
        launches_per_step={k: sum(c["launches"][k] for c in last) / steps
                           for k in last[0]["launches"]},
        captured_step_launches=dict(runner.launches))
    assert runner.graph is None           # released: its pool is freed
    params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    del tr, probe, runner
    return line, torch.stack(losses), params


def step_graph_case(name: str, make, rtol: float) -> tuple:
    """`make()`'s trainer graphed against the same trainer's step body
    eagerly on the card, from the same weights and generator seeds:
    every step's losses within `rtol` and every parameter within `rtol`
    with an atol of `rtol` of its tensor's largest entry (bitwise
    equality reported where it holds). Returns the line, and the
    graphed run's losses and parameters."""
    import torch

    eager, want_l, want_p = step_graph_run(make, eager=True)
    graphed, got_l, got_p = step_graph_run(make, eager=False)
    assert torch.isfinite(got_l).all(), (name, got_l)
    assert graphed["captures"] >= 1 and eager["captures"] == 0, name
    torch.testing.assert_close(got_l, want_l, rtol=rtol, atol=0)
    gaps = {}
    for k, w in want_p.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got_p[k], w, rtol=rtol,
                                   atol=rtol * scale,
                                   msg=lambda m: f"{k}: {m}")
        gaps[k] = float((got_p[k] - w).abs().max()) / max(scale, 1e-30)
    rel = (got_l - want_l).abs() / want_l.abs().clamp_min(1e-30)
    return dict(
        case=name, steps_per_epoch=got_l.shape[1], rtol=rtol,
        losses_bitwise_equal=bool(torch.equal(got_l, want_l)),
        params_bitwise_equal=all(torch.equal(got_p[k], w)
                                 for k, w in want_p.items()),
        loss_max_rel_gap=float(rel.max()),
        param_max_gap_of_scale=max(gaps.values()),
        graphed=graphed, eager=eager,
        eager_over_graphed_ms=eager["ms_per_step"] / graphed["ms_per_step"],
        eager_over_graphed_ms_last_chunk=eager["ms_per_step_last_chunk"]
        / graphed["ms_per_step_last_chunk"]), got_l, got_p


def step_graph_cli(dataset_args: list[str], mode: str, model: str,
                   batch: int, net=None, mesh=None):
    """`make()` of a step_graph case: the trainer `cli_trainer` builds
    for `-mode mode -model model` at `-batch_size batch` (under `mesh`
    where given), K = `STEP_GRAPH_K`, `STEP_GRAPH_EPOCHS` epochs, 2 K +
    1 full batches and a ragged tail; `net()` in place of the built
    model."""
    k = STEP_GRAPH_K
    argv = [*dataset_args, "-mode", mode, "-model", model,
            "-batch_size", str(batch), "-epochs", str(STEP_GRAPH_EPOCHS),
            "-change_epoch", "1", "-lr_decay", "False", "-scan_steps",
            str(k), "-log_step", "1000"]
    windows = batch * (2 * k + 1) + batch // 4
    return lambda: cli_trainer(argv, windows, model=net() if net else None,
                               mesh=mesh)


def step_graph_data(tmp: str) -> dict:
    """The step_graph phases' `-dataset` arguments, data under `tmp`:
    PEMS08 at 170 nodes, NYC_BIKE, and PEMS08 at 16,384 nodes
    (`big`)."""
    return {"PEMS08": ["-dataset", "PEMS08", "-data_root", write_pems08(
                tmp, GPTST_CLI_NODES, 1400)],
            "NYC_BIKE": ["-dataset", "NYC_BIKE", "-num_steps", "1400"],
            "big": ["-dataset", "PEMS08", "-num_nodes", str(N_BIG),
                    "-data_root", write_pems08(os.path.join(tmp, "big"),
                                               N_BIG, 400)]}


def step_graph_cases(rec: dict, tmp: str) -> list[tuple]:
    """The step_graph phase's cases, (name, make, rtol, kernel): `make()`
    builds the case's trainer; `kernel`, where not None, must launch
    inside the captured step. Data goes under `tmp`."""
    data = step_graph_data(tmp)
    big, cli = data["big"], step_graph_cli

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.ops.graph_conv import make_support

    sups = rec["_supports"]
    if "cli_graph" not in sups:       # the graph `run.main` builds
        sups["cli_graph"] = make_support(sym_adj(random_sensor_graph(
            N_BIG, avg_degree=6, seed=0)), device="cuda")
    if "road_graph" not in sups:
        sups["road_graph"] = road_support(N_BIG, 48, "cuda")
    cli_sup, road = sups["cli_graph"], sups["road_graph"]
    return [
        ("TGCN, CLI graph, 16,384 nodes",
         cli(big, "ori", "TGCN", BATCH,
             lambda: bind("TGCN", tgcn_net(), (cli_sup,))),
         STEP_GRAPH_ATOMIC_RTOL, "bsr_spmm"),
        ("TGCN, road graph, 16,384 nodes",
         cli(big, "ori", "TGCN", BATCH,
             lambda: bind("TGCN", tgcn_net(), (road,))),
         STEP_GRAPH_ATOMIC_RTOL, "dia_spmm"),
        ("GPT-ST pretrain, 170 nodes",
         cli(data["PEMS08"], "pretrain", "STGCN", GPTST_CLI_BATCH),
         STEP_GRAPH_RTOL, None),
        ("eval STGCN, 170 nodes",
         cli(data["PEMS08"], "eval", "STGCN", GPTST_CLI_BATCH),
         STEP_GRAPH_RTOL, None),
    ] + [(f"{m} ori, {ds}", cli(data[ds], "ori", m, GPTST_CLI_BATCH),
          STEP_GRAPH_RTOL, None) for m, ds in STEP_GRAPH_PREDICTORS]


def step_graph_line(rec: dict, name: str, make, rtol: float,
                    kernel: str | None) -> dict:
    """One case of the phase (`step_graph_case`), with its kernel's
    launches inside the captured step checked and recorded."""
    t0 = time.perf_counter()
    line = step_graph_case(name, make, rtol)[0]
    line["seconds"] = time.perf_counter() - t0
    if kernel is not None:
        # the kernel ran inside the captured step, counted at each replay
        assert line["graphed"]["captured_step_launches"][kernel] > 0, line
        rec[kernel]["launches_by_path"][f"step_graph {name}"] = line[
            "graphed"]["launches_per_step"][kernel]
    return line


def phase_step_graph(rec: dict) -> None:
    """The trainer's K steps per dispatch (`train/step.StepGraph`, K =
    `STEP_GRAPH_K`): each case's trainer (`step_graph_cases`), as
    `run.main` builds it on the card, takes 2 epochs of 2 K + 2 steps
    graphed (two chunks of K full batches replayed from one captured
    step, then a full batch and a ragged tail one step each) and again
    with the same step body run eagerly, from the same weights
    (`step_graph_case`). Cases: TGCN at 16,384 nodes, batch 16, on the
    CLI graph (`bsr_spmm` and the COO tail inside the captured step)
    and on the road graph (`dia_spmm`); GPT-ST pretrain at 170 nodes,
    batch 64, across `change_epoch` 1 (two captures); eval STGCN at 170
    nodes with the frozen encoder; each of the 13 predictors `-mode
    ori` at its CLI size (PEMS08 170 nodes, NYC_BIKE 250), batch 64.
    The work runs in a fresh directory (STFGNN's and STGODE's DTW
    graphs are cached there)."""
    import torch

    cwd = os.getcwd()
    lines = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            work = os.path.join(tmp, "run", "work")
            os.makedirs(work)
            os.chdir(work)
            for case in step_graph_cases(rec, tmp):
                line = step_graph_line(rec, *case)
                emit("step_graph", **line)
                lines.append(line)
                torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    emit("step_graph", k=STEP_GRAPH_K, epochs=STEP_GRAPH_EPOCHS,
         cases=len(lines),
         bitwise_equal=[ln["case"] for ln in lines
                        if ln["losses_bitwise_equal"]
                        and ln["params_bitwise_equal"]])


# the step_graph_cards phase: (case, data, mode, model, global batch,
# rtol of replays against eager steps, the kernel that must launch in
# the captured step, whether replays must equal eager steps bit for
# bit), and the seconds its two processes may take in all
STEP_GRAPH_CARDS = (
    ("TGCN, CLI graph, 16,384 nodes", "big", "ori", "TGCN", BATCH,
     STEP_GRAPH_ATOMIC_RTOL, "bsr_spmm", False),
    ("GPT-ST pretrain, 170 nodes", "PEMS08", "pretrain", "STGCN",
     GPTST_CLI_BATCH, STEP_GRAPH_RTOL, None, True),
    ("GWN ori, 170 nodes", "PEMS08", "ori", "GWN", GPTST_CLI_BATCH,
     STEP_GRAPH_RTOL, None, True),
)
STEP_GRAPH_CARDS_SHORT = "GWN ori, 170 nodes, rank 1 short of memory"
STEP_GRAPH_CARDS_DEADLINE_S = 240


def step_graph_card_makes(data: dict, sup, mesh) -> list[tuple]:
    """`STEP_GRAPH_CARDS`' cases with their `make()` under `mesh` (None:
    one card), TGCN bound to the CLI graph's support `sup`."""
    return [(name, step_graph_cli(
        data[ds], mode, model, batch, mesh=mesh,
        net=(lambda: bind("TGCN", tgcn_net(), (sup,)))
        if model == "TGCN" else None), rtol, kernel, bitwise)
        for name, ds, mode, model, batch, rtol, kernel, bitwise
        in STEP_GRAPH_CARDS]


def step_graph_child() -> int:
    """One process of `phase_step_graph_cards`: joins the process group
    (NCCL) as `distributed_child` does, lays its global mesh over
    `GPTST_SMOKE_DEVICE` (one data row of a global (2, 1)) and runs
    each `STEP_GRAPH_CARDS` case graphed and eagerly
    (`step_graph_case`) on the data under `GPTST_SMOKE_DATA` (a JSON
    dict of `-dataset` arguments), TGCN on the CLI graph's support saved
    at `GPTST_SMOKE_SUPPORT`; then GWN graphed again with this
    process's free memory reported as 0 on rank 1 (`StepGraph.beside`
    drops the graph on every process: both capture twice). Writes the
    lines, losses and parameters to `$GPTST_SMOKE_OUT/rank<RANK>.pt`."""
    import torch

    sys.path.insert(0, ROOT)
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.core.distributed import (
        global_mesh, initialize_distributed,
    )
    from gptst_tpu_torch.run import set_precision

    set_precision(default_config("PEMS08"))
    env = os.environ
    initialize_distributed(backend=env["GPTST_SMOKE_BACKEND"],
                           timeout=DIST_TIMEOUT_S)
    mesh = global_mesh(1, devices=[env["GPTST_SMOKE_DEVICE"]])
    rank = torch.distributed.get_rank()
    os.chdir(env["GPTST_SMOKE_OUT"])       # the models' graph caches
    t0 = time.perf_counter()
    sup = torch.load(env["GPTST_SMOKE_SUPPORT"], map_location=mesh.root,
                     weights_only=False)
    cases = step_graph_card_makes(json.loads(env["GPTST_SMOKE_DATA"]), sup,
                                  mesh)
    out = {"rank": rank, "device": str(mesh.root), "mesh": mesh.shape,
           "backend": torch.distributed.get_backend()}
    out["support_s"] = time.perf_counter() - t0
    for name, make, rtol, _, _ in cases:
        t1 = time.perf_counter()
        line, losses, params = step_graph_case(name, make, rtol)
        line["seconds"] = time.perf_counter() - t1
        out[name] = dict(line=line, losses=losses.cpu(),
                         params={k: v.cpu() for k, v in params.items()})
        torch.cuda.empty_cache()
    name, make = cases[-1][:2]
    total = torch.cuda.mem_get_info(mesh.root)[1]
    saved = torch.cuda.mem_get_info
    if rank == 1:
        torch.cuda.mem_get_info = lambda device=None: (0, total)
    try:
        line, losses, params = step_graph_run(make, eager=False)
    finally:
        torch.cuda.mem_get_info = saved
    out[STEP_GRAPH_CARDS_SHORT] = dict(
        line=line, losses=losses.cpu(),
        params={k: v.cpu() for k, v in params.items()})
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(env["GPTST_SMOKE_OUT"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def loss_gap(got, want) -> float:
    """The largest relative gap of two runs' per-step losses."""
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def first_chunk(losses):
    """The total losses of the first chunk of K steps (epoch 1) of a
    step_graph run's (epochs, steps, 2) losses."""
    return losses[0, :STEP_GRAPH_K, 0]


def phase_step_graph_cards(rec: dict) -> None:
    """K steps per dispatch across processes: with 2 or more cards, two
    processes over NCCL, one card each, each a (1, 1) mesh of a global
    (2, 1) data axis, spawned once (`step_graph_child`). Each runs the
    trainer `step_graph_cli` builds at K = `STEP_GRAPH_K` (2 epochs of
    10 steps, 8 replayed in ori mode) graphed, its data-parallel step
    and its collectives captured once, and again eagerly from the same
    weights: TGCN on the CLI graph at 16,384 nodes, global batch 16
    (`bsr_spmm` and the COO tail in the graph), GPT-ST pretrain at 170
    nodes, global batch 64 (its mask meets through `on_global_batch`),
    GWN at 170 nodes, global batch 64 (batch statistics through
    `batch_count`), and GWN once more with rank 1 short of memory (both
    processes drop the graph before the tail and capture again). Per
    case and process: ms and host ms per step graphed and eager,
    captures, `bsr_spmm` launches per replay against per eager step,
    peak allocated and reserved, the replays' gaps to the eager steps
    (bitwise for GPT-ST and GWN, rtol 1e-4 for TGCN), the ranks'
    parameters bit for bit, and the gap to one card's graphed run of
    the same global batch: the first chunk's losses held at
    `dist_check`'s rtol 1e-5; over the whole run the largest loss gap
    and the parameters beyond `dist_check`'s tolerances are recorded,
    not held (f32 sums in another order drift apart through Adam over
    20 steps: GPT-ST 1.3e-3, GWN 5.6e-4 at the last steps on two
    H100s). With fewer cards it prints that it did not run."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        emit("step_graph_cards", ran=False, cards=count)
        return
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.ops.graph_conv import make_support

    sups = rec["_supports"]
    if "cli_graph" not in sups:
        sups["cli_graph"] = make_support(sym_adj(random_sensor_graph(
            N_BIG, avg_degree=6, seed=0)), device="cuda")
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            work = os.path.join(tmp, "run", "work")
            os.makedirs(work)
            os.chdir(work)
            data = step_graph_data(tmp)
            one_card = {}
            t0 = time.perf_counter()
            for name, make, _, _, _ in step_graph_card_makes(
                    data, sups["cli_graph"], None):
                line, losses, params = step_graph_run(make, eager=False)
                one_card[name] = dict(line=line, losses=losses.cpu(),
                                      params={k: v.cpu()
                                              for k, v in params.items()})
            one_card_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            support = os.path.join(tmp, "cli_support.pt")
            torch.save(sups["cli_graph"], support)
            results = dist_run(2, "nccl", ["cuda:0", "cuda:1"],
                               child="step_graph_child",
                               env_extra={"GPTST_SMOKE_DATA":
                                          json.dumps(data),
                                          "GPTST_SMOKE_SUPPORT": support},
                               deadline=STEP_GRAPH_CARDS_DEADLINE_S)
            run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    checks = []
    for name, _, _, _, _, _, kernel, bitwise in STEP_GRAPH_CARDS:
        want = one_card[name]
        ranks = {}
        for res in results:
            got = res[name]
            line = got["line"]
            ranks[f"rank {res['rank']}"] = dict(
                **{k: line[k] for k in (
                    "losses_bitwise_equal", "params_bitwise_equal",
                    "loss_max_rel_gap", "param_max_gap_of_scale",
                    "eager_over_graphed_ms",
                    "eager_over_graphed_ms_last_chunk")},
                graphed=line["graphed"], eager=line["eager"],
                one_card_loss_max_rel_gap=loss_gap(got["losses"],
                                                   want["losses"]),
                one_card_first_chunk_loss_max_rel_gap=loss_gap(
                    first_chunk(got["losses"]), first_chunk(want["losses"])),
                one_card=param_gaps(got["params"], want["params"]))
            checks.append((name, res, line, kernel, bitwise))
        emit("step_graph_cards", case=name, ran=True, cards=count,
             processes=2, backend=results[0]["backend"],
             global_mesh=results[0]["mesh"], k=STEP_GRAPH_K,
             epochs=STEP_GRAPH_EPOCHS, one_card_graphed=want["line"],
             ranks_params_bitwise_equal=all(
                 torch.equal(res[name]["params"][k], v)
                 for res in results[1:]
                 for k, v in results[0][name]["params"].items()),
             **ranks)
    short = {f"rank {res['rank']}": res[STEP_GRAPH_CARDS_SHORT]["line"]
             for res in results}
    emit("step_graph_cards", case=STEP_GRAPH_CARDS_SHORT, **short,
         losses_equal_to_room=[bool(torch.equal(
             res[STEP_GRAPH_CARDS_SHORT]["losses"],
             res[STEP_GRAPH_CARDS[-1][0]]["losses"])) for res in results])
    emit("step_graph_cards", one_card_s=one_card_s, processes_s=run_s,
         child_seconds=[res["seconds"] for res in results],
         child_support_s=[res["support_s"] for res in results])
    for name, res, line, kernel, bitwise in checks:
        g, e = line["graphed"], line["eager"]
        captures = STEP_GRAPH_EPOCHS if "pretrain" in name else 1
        assert g["captures"] == captures and e["captures"] == 0, (name, g)
        assert not bitwise or (line["losses_bitwise_equal"]
                               and line["params_bitwise_equal"]), line
        if kernel is not None:
            assert g["captured_step_launches"][kernel] > 0, g
            assert (g["launches_per_step"][kernel]
                    == e["launches_per_step"][kernel]), (g, e)
            rec[kernel]["launches_by_path"][
                f"step_graph_cards {name}, rank {res['rank']}"] = g[
                "launches_per_step"][kernel]
    for res in results:
        got = res[STEP_GRAPH_CARDS_SHORT]
        assert got["line"]["captures"] == 2, got["line"]
        assert torch.equal(got["losses"],
                           res[STEP_GRAPH_CARDS[-1][0]]["losses"])
    for name, want in one_card.items():
        for res in results:
            torch.testing.assert_close(
                first_chunk(res[name]["losses"]), first_chunk(want["losses"]),
                rtol=1e-5, atol=0, msg=lambda m: f"{name}: {m}")


def write_pems08(tmp: str, nodes: int, num_steps: int) -> str:
    """A synthetic `PEMS08/PEMS08.npz` of `nodes` sensors and
    `num_steps` time steps under `tmp`; returns the `-data_root`."""
    import numpy as np

    from gptst_tpu_torch.config.datasets import get_dataset_spec
    from gptst_tpu_torch.data.synthetic import synthesize_raw_series

    spec = dataclasses.replace(get_dataset_spec("PEMS08"), num_nodes=nodes)
    root = os.path.join(tmp, "data")
    os.makedirs(os.path.join(root, "PEMS08"))
    np.savez(os.path.join(root, "PEMS08", "PEMS08.npz"),
             data=synthesize_raw_series(spec, num_steps=num_steps, seed=0))
    return root


def run_main(argv: list[str]) -> float:
    """`gptst_tpu_torch.run.main(argv)` on the card; returns its wall
    seconds (synchronized)."""
    import torch

    from gptst_tpu_torch.run import main

    t0 = time.perf_counter()
    assert main(argv) == 0
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_report(got: dict, want: dict, rtol: float) -> float:
    """Max relative difference of two test reports (per-horizon and
    average MAE/RMSE/MAPE/CORR); raises above `rtol`."""
    import numpy as np

    g = np.asarray(got["per_horizon"] + [got["average"]], np.float64)
    w = np.asarray(want["per_horizon"] + [want["average"]], np.float64)
    assert np.isfinite(g).all() and np.isfinite(w).all()
    np.testing.assert_allclose(g, w, rtol=rtol)
    return float((np.abs(g - w) / np.abs(w)).max())


def phase_eval_cli(rec: dict) -> None:
    """The slice's main path through `run.main` at 16,384 nodes: GPT-ST
    pretrain (batch 8, 1 epoch), then `-mode eval -model TGCN` (batch
    16, 2 epochs, under `-profile_dir`), then `-mode test`. Every
    aggregation of the eval run is `bsr_spmm` on the CLI graph: x at
    F = 1,024 (the fused embedding), h at 1,600, and the transposed
    launches of the backward, x's included (it comes from the trainable
    head). Launches are counted from 0 over the eval run alone."""
    import torch

    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.ops.graph_conv import SparseSupport
    from gptst_tpu_torch.train.trainer import Trainer

    calls = []
    block_kernel = K._block_kernel

    def recording(name, a, x):
        calls.append((name, a.block_vals.data_ptr(), x.shape[1]))
        return block_kernel(name, a, x)

    trainers = []
    train = Trainer.train

    def keep(self, *args, **kw):
        trainers.append(self)
        return train(self, *args, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "save")
        common = ["-dataset", "PEMS08", "-num_nodes", str(N_BIG),
                  "-data_root", write_pems08(tmp, N_BIG, CLI_TIME_STEPS),
                  "-lr_decay", "False", "-early_stop", "False",
                  "-log_dir", save, "-log_step", "1000"]
        pretrain_s = run_main(["-mode", "pretrain", "-batch_size", "8",
                               "-epochs", "1", *common])
        want_enc = torch.load(
            os.path.join(save, "PEMS08", "gptst_pretrain.ckpt"),
            map_location="cuda", weights_only=True)
        eval_flags = ["-model", "TGCN", "-batch_size", str(BATCH), *common]
        prof, ev, te = (os.path.join(tmp, f)
                        for f in ("profile", "eval.json", "test.json"))
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        K._block_kernel, Trainer.train = recording, keep
        try:
            eval_s = run_main(["-mode", "eval", "-epochs", "2",
                               "-profile_dir", prof, "-metrics_out", ev,
                               *eval_flags])
        finally:
            K._block_kernel, Trainer.train = block_kernel, train
        launches = dict(K.LAUNCHES)
        dense = K.dense_block_counts()
        peak = torch.cuda.max_memory_allocated()
        trace = os.path.join(prof, "trace.json")
        trace_bytes = os.path.getsize(trace)
        assert trace_bytes > 0
        os.remove(trace)    # tens of MB: not brought back
        (tr,) = trainers
        for k, v in tr.model.encoder.state_dict().items():
            assert torch.equal(v, want_enc[k]), k
        (sup,) = tr.model.predictor.graph
        assert isinstance(sup, SparseSupport) and sup.dia is None
        t_ptr = sup.bcsr_t.block_vals.data_ptr()
        by_width: dict = {}
        for name, ptr, f in calls:
            key = f"{'AT' if ptr == t_ptr else 'A'}_F{f}"
            by_width[key] = by_width.get(key, 0) + 1
        test_s = run_main(["-mode", "test", "-metrics_out", te, *eval_flags])
        with open(ev) as f:
            ev = json.load(f)
        with open(te) as f:
            te = json.load(f)
    assert launches["bsr_spmm"] > 0 and launches["dia_spmm"] == 0, launches
    assert by_width.get(f"AT_F{F_EVAL}", 0) > 0, by_width
    assert not any(dense.values()), dense
    # the test run rebuilds the support and the head: the same report,
    # up to the order of `index_add_`'s float atomics
    rel = same_report(te, ev, rtol=1e-4)
    steps = ev["steps_per_epoch"]
    rec["bsr_spmm"]["launches"] = launches["bsr_spmm"]
    rec["bsr_spmm"]["launches_by_path"]["eval_cli"] = launches["bsr_spmm"]
    emit("eval_cli", model="TGCN", nodes=N_BIG, batch=BATCH, epochs=2,
         hidden_dim=HIDDEN, rnn_units=UNITS, time_steps=CLI_TIME_STEPS,
         steps_per_epoch=steps,
         ms_per_step_by_epoch=[s / steps * 1e3 for s in ev["epoch_seconds"]],
         samples_per_s_epoch2=steps * BATCH / ev["epoch_seconds"][-1],
         profiled=True, train_loss_by_epoch=ev["history"],
         test_average=ev["average"], test_report_max_rel_diff=rel,
         max_memory_allocated=peak, launches=launches, dense_blocks=dense,
         bsr_spmm_launches_by_structure_and_width=by_width,
         encoder_bitwise_unchanged=True, trace_bytes=trace_bytes,
         pretrain_s=pretrain_s, eval_s=eval_s, test_s=test_s)


def eval_net(sup, n: int = N_BIG, seed: int = 0):
    """The eval-mode model at PEMS08's published widths on the CPU: a
    GPT-ST encoder from `build_pretrain`'s random init (seed `seed`),
    the Fusion head and TGCN at dim_in 64 (seed `seed + 1`), TGCN bound
    to `sup` (which `.to()` does not move)."""
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import GraphPredictor, build_pretrain
    from gptst_tpu_torch.models.enhance import EnhanceHead, EnhancedModel
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig

    cfg = default_config("PEMS08", mode="pretrain", num_nodes=n)
    encoder = build_pretrain(cfg, device="cpu", seed=seed).gptst
    gen = torch.Generator().manual_seed(seed + 1)
    head = EnhanceHead(cfg.hidden_dim, cfg.input_base_dim, gen)
    tgcn = TGCN(TGCNConfig(num_nodes=n), dim_in=cfg.hidden_dim, dim_out=1,
                horizon=12, generator=gen)
    return EnhancedModel(encoder, head, GraphPredictor(tgcn, sup))


def phase_eval_model(rec: dict) -> None:
    """Eval-mode TGCN train steps through the library on the road
    graph's DIA support (1 warm, 3 timed): `dia_spmm` on x at F = 1,024
    and h at 1,600, forward and transposed; no block run densely; the
    encoder unchanged."""
    import torch

    model = eval_net(rec["_supports"]["road_graph"]).to("cuda")
    enc = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 1, 3
    losses, ms, launches, dense = train_steps("TGCN", model, BATCH, warm,
                                              steps)
    assert launches["dia_spmm"] > 0 and launches["bsr_spmm"] == 0, launches
    assert not any(dense.values()), dense
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, enc[k]), k
    rec["dia_spmm"]["launches"] = launches["dia_spmm"]
    rec["dia_spmm"]["launches_by_path"]["eval_model"] = launches["dia_spmm"]
    emit("eval_model", graph="road_graph_edges(16384, 16, 48)", nodes=N_BIG,
         batch=BATCH, hidden_dim=HIDDEN, rnn_units=UNITS, steps=warm + steps,
         ms_per_step=ms, samples_per_s=BATCH / ms * 1e3, losses=losses,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, dense_blocks=dense,
         launches_per_step=launches["dia_spmm"] / (warm + steps))
    del model
    torch.cuda.empty_cache()


def phase_stgcn_cli(rec: dict) -> None:
    """STGCN, the CLI's default `-model`, through `run.main` at PEMS08's
    170 nodes, batch 64, 2 epochs each: `-mode ori`, then pretrain ->
    eval -> test. Dense Chebyshev products only (no kernel of `csrc/`).
    Losses finite; the test report equal to eval's (rtol 1e-5)."""
    import numpy as np

    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts

    out, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        common = ["-dataset", "PEMS08",
                  "-data_root", write_pems08(tmp, GPTST_CLI_NODES, 2000),
                  "-batch_size", str(GPTST_CLI_BATCH), "-epochs", "2",
                  "-change_epoch", "1", "-lr_decay", "False",
                  "-log_dir", os.path.join(tmp, "save"), "-log_step", "1000"]
        reset_launch_counts()
        for mode in ("ori", "pretrain", "eval", "test"):
            path = os.path.join(tmp, f"{mode}.json")
            secs[mode] = run_main(["-mode", mode, "-metrics_out", path,
                                   *common])
            with open(path) as f:
                out[mode] = json.load(f)
    for mode in ("ori", "pretrain", "eval"):
        assert np.isfinite(out[mode]["history"]).all(), mode
    rel = same_report(out["test"], out["eval"], rtol=1e-5)
    assert not any(LAUNCHES.values()), LAUNCHES   # dense products only
    emit("stgcn_cli", model="STGCN (default)", nodes=GPTST_CLI_NODES,
         batch=GPTST_CLI_BATCH, epochs=2, seconds=secs,
         ms_per_step_by_epoch={
             m: [t / out[m]["steps_per_epoch"] * 1e3
                 for t in out[m]["epoch_seconds"]]
             for m in ("ori", "pretrain", "eval")},
         train_loss_by_epoch={m: out[m]["history"]
                              for m in ("ori", "pretrain", "eval")},
         average={m: out[m]["average"] for m in out},
         test_report_max_rel_diff=rel)


# kernel-name fragments -> what they are on the TGCN and MSDR steps
KERNEL_GROUPS = (
    ("bsr_spmm_kernel", "bsr_spmm"), ("bsr_spmm_value_pass", "bsr_spmm"),
    ("dia_spmm_kernel", "dia_spmm"), ("dia_spmm_value_pass", "dia_spmm"),
    ("sddmm_kernel", "sddmm"), ("spmm_dvals_kernel", "spmm_dvals"),
    ("indexFunc", "index_add_ (COO tail scatter, RCM gather backward)"),
    ("indexSelect", "index_select (COO tail gather, RCM permutation)"),
    ("gemm", "dense matmul"), ("xmma", "dense matmul"),
    ("cutlass", "dense matmul"), ("softmax", "softmax"),
    ("SoftMax", "softmax"),
    ("elementwise", "elementwise"), ("reduce", "reduction"),
)


def profile_line(run: str, ms: float, path: str, steps: int = 2,
                 **extra) -> None:
    """Device ms per step by kernel group, the busy share (of all cards
    together, and of each card) and the 10 costliest kernels of a
    profiler trace of `steps` train steps (`extra` joins the line)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    groups: dict = {}
    names: dict = {}
    cards: dict = {}
    for e in kern:
        g = next((v for k, v in KERNEL_GROUPS if k in e["name"]), "other")
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3 / steps
        names[e["name"]] = names.get(e["name"], 0.0) + e["dur"] / 1e3 / steps
        c = f"cuda:{e.get('args', {}).get('device', e.get('pid'))}"
        cards[c] = cards.get(c, 0.0) + e["dur"] / 1e3 / steps
    busy = sum(groups.values())
    emit("profile", run=run, ms_per_step_profiled=ms,
         device_ms_per_step=busy, device_busy_share=busy / ms,
         device_busy_share_by_card={c: v / ms for c, v in sorted(
             cards.items())},
         kernels_per_step=len(kern) / steps,
         device_ms_by_group=dict(sorted(groups.items(),
                                        key=lambda kv: -kv[1])),
         top_kernels=[[k[:120], v] for k, v in sorted(
             names.items(), key=lambda kv: -kv[1])[:10]], **extra)


def phase_profile(rec: dict) -> None:
    """Device time by kernel group and device busy share of 2 profiled
    train steps (after 1 warm-up step): TGCN on each graph, MSDR on the
    CLI graph, TGCN on the CLI graph's halo support on 4 ranks, GPT-ST
    pretrain at `gptst_model`'s shape (adaptive mask and KL), eval TGCN
    and GWN on the CLI graph; and 1 ST_WA step at
    `last_predictors_model`'s shape. The traces (tens of MB each) are
    read and deleted."""
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import predictor_forward

    runs = [(f"tgcn_{name}", "TGCN", tgcn_net, (sup,), BATCH)
            for name, sup in rec["_supports"].items()]
    runs.append(("msdr_cli_graph", "MSDR", msdr_net,
                 rec["_msdr"]["cli_graph"], MSDR_BATCH))
    runs.append(("tgcn_sharded_cli_graph", "TGCN", tgcn_net,
                 (rec.pop("_sharded_cli"),), BATCH))
    for name, model, make_net, graph, batch in runs:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            _, ms, _, _ = train_steps(model, bind(model, make_net(), graph),
                                      batch, 1, 2, trace=path)
            profile_line(name, ms, path)
    torch.cuda.empty_cache()
    cfg = gptst_cfg(batch_size=GPTST_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        _, ms = gptst_steps(gptst_net(cfg), cfg, GPTST_BATCH, (2, 2, 2),
                            trace=path)
        profile_line("gptst_pretrain", ms, path)
    torch.cuda.empty_cache()
    # eval TGCN on the CLI graph; the encoder's share is its no-grad
    # forward alone on a batch of the same shape
    model = eval_net(rec["_supports"]["cli_graph"]).to("cuda")
    x = torch.randn(BATCH, 12, N_BIG, 3, device="cuda")
    enc = device_ms_by_kernel(lambda: model.encode(x), reps=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        _, ms, _, _ = train_steps("TGCN", model, BATCH, 1, 2, trace=path)
        profile_line("eval_tgcn_cli_graph", ms, path,
                     encoder_device_ms_per_step=sum(enc.values()),
                     encoder_device_ms_by_kernel=dict(sorted(
                         enc.items(), key=lambda kv: -kv[1])[:5]))
    del model
    torch.cuda.empty_cache()
    # GWN at gwn_cli's shape: the CLI graph's doubletransition supports
    # (block-CSR behind RCM) and the dense adaptive adjacency
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        _, ms, _, _ = train_steps(
            "GWN", bind("GWN", gwn_net(), (rec["_gwn"]["cli_graph"],)),
            GWN_BATCH, 1, 2, trace=path)
        profile_line("gwn_cli_graph", ms, path)
    torch.cuda.empty_cache()
    # ST_WA at last_predictors_model's shape: one step after one warm
    cfg = default_config("PEMS08", mode="ori", model="ST_WA",
                         num_nodes=GRAPH_MODEL_NODES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        _, ms, _, _ = train_steps(
            "ST_WA", predictor_forward(cfg, graph_predictor(
                "ST_WA", "PEMS08", GRAPH_MODEL_NODES, "cuda")),
            LAST_MODEL_BATCH["ST_WA"], 1, 1, trace=path,
            nodes=GRAPH_MODEL_NODES, loss_func=cfg.loss_func)
        profile_line("stwa_2048", ms, path, steps=1)
    torch.cuda.empty_cache()


def reference_grads(make_net, graph_on, x, dev: str) -> dict:
    """The prediction and every parameter gradient of mean(pred^2), by
    name, with the network and its graph on `dev`. On the card under
    `torch.use_deterministic_algorithms`: `index_add_` (the COO tails,
    the SDDMM backward, the gathers' backward) then sums in a fixed
    order instead of by float atomics, so a run's errors repeat. With
    atomics, a run on an H100 put 4 of MSDR's 64,000 encoder.0.b
    gradient entries 7.5e-7 from the CPU's, against 4.9e-7 allowed."""
    import torch

    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        net = make_net().to(dev)
        pred = net(x.to(dev), *graph_on(dev))
        pred.square().mean().backward()
        return {"pred": pred.detach().cpu(), **{
            k: p.grad.cpu() for k, p in net.named_parameters()}}
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def phase_reference(rec: dict) -> None:
    """TGCN: rtol/atol 1e-4. MSDR: rtol 1e-4 and an atol of 1e-4 of each
    tensor's largest entry plus 1e-7 (its gradients are small under a
    mean loss, and an absolute 1e-4 would not see a wrong learned-
    adjacency backward); att_b's gradient, zero in exact arithmetic (it
    shifts all pre_k logits of a softmax), is rounding noise and is held
    to an atol of 1e-5, as in the CPU parity tests."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.models.build import msdr_adapt_pattern
    from gptst_tpu_torch.models.predictors.msdr import (
        MSDR, MSDRConfig, dual_random_walk_supports,
    )
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
    from gptst_tpu_torch.ops.graph_conv import make_support

    n, b = 1000, 4
    base = random_sensor_graph(n, avg_degree=6, seed=3)
    adj = sym_adj(base)
    mats = dual_random_walk_supports(base)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, 12, n, 1), np.float32))
    tgcn = TGCN(TGCNConfig(num_nodes=n), dim_in=1, dim_out=1, horizon=12,
                generator=torch.Generator().manual_seed(0))
    # MSDR with every weight nonzero: at its init W, b, R and the
    # attention are zero, and the gradients into gconv_w and the node
    # embeddings (the SDDMM and d block_vals path) would be zero too.
    # The weights are kept where float32 is well conditioned, so that
    # the comparison measures the kernels and not cancellation: noise of
    # std 0.02 (at 0.1 the 64 x 64 W amplifies the recurrence over 24
    # steps, |pred| ~ 1e5 at 1000 nodes), and node embeddings at 0.3 of
    # their init scale (at 1.0 the rank-10 scores spread by ~10 and the
    # unshifted block-row softmax puts ~all weight on one entry, where
    # its gradient is a difference of nearly equal terms).
    msdr = MSDR(MSDRConfig(num_nodes=n), dim_in=1, dim_out=1,
                generator=torch.Generator().manual_seed(0))
    noise = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for k, p in msdr.named_parameters():
            if k.startswith("nodevec"):
                p.mul_(0.3)
            p.add_(0.02 * torch.randn(p.shape, generator=noise))
    paths = set()
    for reorder in (True, False):   # RCM gives a band, no RCM block-CSR
        cases = {
            "TGCN": (lambda: copy.deepcopy(tgcn), lambda dev: (make_support(
                adj, dense_threshold=0, reorder=reorder, device=dev),)),
            "MSDR": (lambda: copy.deepcopy(msdr), lambda dev: (
                tuple(make_support(m, dense_threshold=0, reorder=reorder,
                                   device=dev) for m in mats),
                msdr_adapt_pattern(mats[0], n, dev))),
        }
        for model, (make_net, graph_on) in cases.items():
            want = reference_grads(make_net, graph_on, x, "cpu")
            reset_launch_counts()
            got = reference_grads(make_net, graph_on, x, "cuda")
            ran = sorted(k for k, v in LAUNCHES.items() if v)
            errs = {}
            for k, w in want.items():
                atol = (1e-4 if model == "TGCN" else 1e-5
                        if k.endswith("att_b")
                        else 1e-4 * float(w.abs().max()) + 1e-7)
                errs[k] = float((got[k] - w).abs().max())
                torch.testing.assert_close(got[k], w, rtol=1e-4, atol=atol,
                                           msg=lambda m: f"{model} {k}: {m}")
            if model == "MSDR":
                assert {"sddmm", "spmm_dvals", "bsr_spmm"} <= set(ran), ran
                assert all(bool(want[k].abs().max() > 0) for k in want
                           if k.startswith(("nodevec", "encoder.0.gconv_w")))
            paths.update(ran)
            emit("reference", model=model, nodes=n, batch=b, reorder=reorder,
                 kernels=ran, pred_max_abs_err=errs.pop("pred"),
                 grad_max_abs_err=max(errs.values()),
                 nodevec_grad_scale=min(
                     (float(want[k].abs().max()) for k in want
                      if k.startswith("nodevec")), default=None),
                 tol={"rtol": 1e-4, "atol": "1e-4" if model == "TGCN"
                      else "1e-4 * max|want| + 1e-7 (att_b: 1e-5)"})
    assert {"dia_spmm", "bsr_spmm", "sddmm", "spmm_dvals"} <= paths, paths
    reference_sharded(b)
    reference_gptst(b)
    reference_eval(b)
    reference_stgcn(b)
    reference_gwn(b)
    reference_dense_predictors(b)
    reference_graph_predictors(b)
    reference_last_predictors(b)


def reference_sharded(b: int) -> None:
    """TGCN through node-sharded supports (the boundary halo exchange
    and the ring) on 4 ranks of the card against 4 ranks of the CPU, at
    a ragged node count (1,002 nodes, padded to 1,004): rtol/atol 1e-4,
    as the unsharded TGCN reference."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
    from gptst_tpu_torch.ops.graph_conv import (
        ShardedSupport, make_sharded_support,
    )
    from gptst_tpu_torch.parallel.halo import make_ring_spmm
    from gptst_tpu_torch.parallel.mesh import make_mesh

    n, ranks = 1002, 4
    adj = sym_adj(random_sensor_graph(n, avg_degree=6, seed=4))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((b, 12, n, 1), np.float32))
    tgcn = TGCN(TGCNConfig(num_nodes=n), dim_in=1, dim_out=1, horizon=12,
                generator=torch.Generator().manual_seed(1))

    def sharded_on(kind):
        def graph_on(dev):
            mesh = make_mesh(devices=[dev] * ranks, graph_axis_size=ranks)
            if kind == "halo":
                sup = make_sharded_support(adj, mesh)
            else:
                fn, n_pad = make_ring_spmm(mesh, adj)
                sup = ShardedSupport(fn, n, n_pad, "ring")
            assert sup.kind == kind and sup.n_pad == 1004, sup
            return (sup,)
        return graph_on

    for kind in ("halo", "ring"):
        want = reference_grads(lambda: copy.deepcopy(tgcn), sharded_on(kind),
                               x, "cpu")
        got = reference_grads(lambda: copy.deepcopy(tgcn), sharded_on(kind),
                              x, "cuda")
        errs = {}
        for k, w in want.items():
            errs[k] = float((got[k] - w).abs().max())
            torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"sharded {kind} {k}: {m}")
        emit("reference", model="TGCN", nodes=n, batch=b,
             support=f"sharded_{kind}", ranks=ranks,
             pred_max_abs_err=errs.pop("pred"),
             grad_max_abs_err=max(errs.values()),
             tol={"rtol": 1e-4, "atol": 1e-4})


def reference_gptst(b: int) -> None:
    """GPT-ST at 64 nodes (hidden 16, the other widths PEMS08's), card
    against CPU from the same weights: the pretrain loss at epoch 2
    (adaptive branch and KL term; mask_ratio 1.0 masks every point
    whatever the draws), every parameter gradient and the `encode`
    output. rtol 1e-4 and an atol of 1e-5 of each tensor's largest
    entry (the losses rtol 1e-5), as the CPU tests hold the port
    against the JAX package."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import build_model
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import make_loss_terms

    n = 64
    cfg = default_config("PEMS08", mode="pretrain", num_nodes=n,
                         hidden_dim=16, mask_ratio=1.0, change_epoch=1)
    x = np.random.default_rng(5).standard_normal((b, 12, n, 3), np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev, seed=0, scaler_zeros=-0.5)
        loss_terms = make_loss_terms(
            model, build_loss("mask_mae", 200.0, 100.0, 0.0, True), cfg)
        xd = torch.from_numpy(x).to(dev)
        total, flow = loss_terms(
            xd, xd, 1, epoch=2,
            generator=torch.Generator(device=dev).manual_seed(0))
        total.backward()
        with torch.no_grad():
            enc = model(xd).pred
        out[dev] = {"loss": torch.stack([total, flow]).detach().cpu(),
                    "encode": enc.cpu(),
                    **{k: p.grad.cpu() for k, p in model.named_parameters()}}
    want, got = out["cpu"], out["cuda"]
    torch.testing.assert_close(got.pop("loss"), want.pop("loss"),
                               rtol=1e-5, atol=0)
    errs = {}
    for k, w in want.items():
        errs[k] = float((got[k] - w).abs().max())
        torch.testing.assert_close(got[k], w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m: f"GPT-ST {k}: {m}")
    emit("reference", model="GPTST", mode="pretrain", nodes=n, batch=b,
         hidden_dim=16, epoch=2, encode_max_abs_err=errs.pop("encode"),
         grad_max_abs_err=max(errs.values()), parameters=len(errs),
         tol={"rtol": 1e-4, "atol": "1e-5 * max|want|",
              "loss_rtol": 1e-5})


def reference_eval(b: int) -> None:
    """Eval-mode TGCN (frozen GPT-ST encoder, Fusion head, TGCN at
    dim_in 64, PEMS08's widths) at 1,000 nodes with and without RCM (a
    DIA band and block-CSR), card against CPU from the same weights:
    the prediction and every head and predictor gradient of
    mean(pred^2), rtol and atol 1e-4 as TGCN's, under deterministic
    algorithms."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.models.build import GraphPredictor
    from gptst_tpu_torch.models.enhance import EnhancedModel
    from gptst_tpu_torch.ops.graph_conv import make_support

    n = 1000
    adj = sym_adj(random_sensor_graph(n, avg_degree=6, seed=3))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, 12, n, 3), np.float32))
    base = eval_net(None, n=n, seed=2)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for reorder in (True, False):
            out = {}
            for dev in ("cpu", "cuda"):
                sup = make_support(adj, dense_threshold=0, reorder=reorder,
                                   device=dev)
                model = EnhancedModel(
                    copy.deepcopy(base.encoder), copy.deepcopy(base.head),
                    GraphPredictor(copy.deepcopy(base.predictor.net), sup)
                ).to(dev)
                reset_launch_counts()
                pred = model(x.to(dev)).pred
                pred.square().mean().backward()
                ran = sorted(k for k, v in LAUNCHES.items() if v)
                out[dev] = {"pred": pred.detach().cpu(), **{
                    k: p.grad.cpu() for k, p in model.named_parameters()}}
            errs = {}
            for k, w in out["cpu"].items():
                errs[k] = float((out["cuda"][k] - w).abs().max())
                torch.testing.assert_close(out["cuda"][k], w, rtol=1e-4,
                                           atol=1e-4,
                                           msg=lambda m: f"eval {k}: {m}")
            assert ran == (["dia_spmm"] if reorder else ["bsr_spmm"]), ran
            assert any(k.startswith("head.") for k in errs)
            emit("reference", model="eval TGCN", nodes=n, batch=b,
                 reorder=reorder, kernels=ran,
                 pred_max_abs_err=errs.pop("pred"),
                 grad_max_abs_err=max(errs.values()), parameters=len(errs),
                 tol={"rtol": 1e-4, "atol": 1e-4})
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def reference_stgcn(b: int) -> None:
    """STGCN at PEMS08's 170 nodes and published widths, card against
    CPU from the same random weights: the prediction and every gradient
    of mean(pred^2), rtol 1e-4 and an atol of 1e-5 of each tensor's
    largest entry."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.graph.artifacts import (
        cheb_poly_stack, random_sensor_graph, scaled_laplacian,
    )
    from gptst_tpu_torch.models.predictors.stgcn import STGCN, STGCNConfig

    n = GPTST_CLI_NODES
    cheb = torch.from_numpy(cheb_poly_stack(scaled_laplacian(
        random_sensor_graph(n, avg_degree=6, seed=5)), 3).astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b, 12, n, 1), np.float32))
    net = STGCN(STGCNConfig(num_nodes=n), dim_in=1, dim_out=1,
                generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(net).to(dev)
        pred = m(x.to(dev), cheb.to(dev))
        pred.square().mean().backward()
        out[dev] = {"pred": pred.detach().cpu(), **{
            k: p.grad.cpu() for k, p in m.named_parameters()}}
    errs = {}
    for k, w in out["cpu"].items():
        errs[k] = float((out["cuda"][k] - w).abs().max())
        torch.testing.assert_close(out["cuda"][k], w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m: f"STGCN {k}: {m}")
    emit("reference", model="STGCN", nodes=n, batch=b,
         pred_max_abs_err=errs.pop("pred"),
         grad_max_abs_err=max(errs.values()), parameters=len(errs),
         tol={"rtol": 1e-4, "atol": "1e-5 * max|want|"})


# --- GWN, MTGNN and CCRNN ------------------------------------------------

# GWN at its published widths (blocks 4, layers 2, nhid 32), batch 8: x is
# (8, T_l, N, 32) through the 8 layers, T_l = 12, 10, 9, 7, 6, 4, 3, 1, so
# the folded widths of its aggregations run from 3,072 down to 256
GWN_BATCH = 8
GWN_WIDTHS = (3072, 256)
# a 130-step series: 55 training windows, 7 steps an epoch (the last one
# a batch of 7), and 3 validation and 3 test windows (the per-horizon
# correlation of the test report needs 2 or more)
GWN_TIME_STEPS = 130
# per train step: 2 supports x 2 hops x 8 layers forward on the
# transposed structures; the backward runs on A for all but the last
# layer's 4 products, whose outputs reach no loss (only the skip path
# leaves the last layer)
GWN_FWD, GWN_BWD = 32, 28
PRED_CLI_STEPS = 1000


def gwn_road_supports(n: int, device):
    """GWN's doubletransition supports of the directed road graph from
    its edge list (no dense (N, N)): D_out^-1 A and D_in^-1 A^T, no
    RCM; a DIA band and a COO tail each, and the band of A^T is not
    A's."""
    import numpy as np

    from gptst_tpu_torch.ops.graph_conv import make_support_coo

    rows, cols = road_graph_edges(n, 16, 48)
    deg_out = np.bincount(rows, minlength=n)
    deg_in = np.bincount(cols, minlength=n)
    return (make_support_coo(rows, cols,
                             (1.0 / deg_out[rows]).astype(np.float32), n,
                             reorder=False, device=device),
            make_support_coo(cols, rows,
                             (1.0 / deg_in[cols]).astype(np.float32), n,
                             reorder=False, device=device))


def gwn_net(n: int = N_BIG, seed: int = 0):
    """GWN at its published widths with two static supports and the
    adaptive adjacency (`aptonly` off), random weights from `seed`."""
    import torch

    from gptst_tpu_torch.models.predictors.gwn import GWN, GWNConfig

    return GWN(GWNConfig(num_nodes=n, aptonly=False), dim_in=1, dim_out=1,
               horizon=12, num_supports=2,
               generator=torch.Generator().manual_seed(seed)).to("cuda")


def record_block_launches(tag=lambda: None):
    """Wrap `_block_kernel` to record (entry point, values pointer, F,
    `tag()`) of every launch; returns the list and the function that
    unwraps."""
    from gptst_tpu_torch.kernels import spmm as K

    calls, orig = [], K._block_kernel

    def recording(name, a, x):
        calls.append((name, a.block_vals.data_ptr(), x.shape[1], tag()))
        return orig(name, a, x)

    K._block_kernel = recording

    def undo():
        K._block_kernel = orig
    return calls, undo


def by_direction(calls, sups, band: bool) -> dict:
    """Launches of `calls` on the supports' transposed structures (the
    forward of GWN's A^T aggregation) and on A (its backward)."""
    def ptr(st):
        return (st.vals if band else st.block_vals).data_ptr()

    fwd = {ptr(s.dia_t if band else s.bcsr_t) for s in sups}
    bwd = {ptr(s.dia if band else s.bcsr) for s in sups}
    out = {"AT": 0, "A": 0, "other": 0}
    for _, p, _, _ in calls:
        out["AT" if p in fwd else "A" if p in bwd else "other"] += 1
    return out


def bsr_csr(a):
    """`torch.sparse_csr_tensor` of a block-CSR structure's nonzeros."""
    import torch

    nnzb = a.nnzb_logical
    rows_t = torch.repeat_interleave(
        torch.arange(a.row_tiles, device="cuda"), a.block_ptr.long().diff())
    return csr_of(a.block_vals[:nnzb], rows_t, a.block_cols[:nnzb].long(),
                  a.tile, a.n)


def dia_csr(d):
    """`torch.sparse_csr_tensor` of a DIA band's nonzeros."""
    import torch

    rt, nd, tb = d.row_tiles, 2 * d.w + 1, d.tile
    idx = torch.arange(rt, device="cuda")
    rows_t = idx.repeat_interleave(nd)
    cols_t = (idx[:, None] + torch.arange(nd, device="cuda") - d.w).reshape(-1)
    keep = (cols_t >= 0) & (cols_t < rt)
    return csr_of(d.vals.reshape(rt * nd, tb, tb)[keep], rows_t[keep],
                  cols_t[keep], tb, d.n)


def phase_gwn_kernels(rec: dict) -> None:
    """`bsr_spmm` and `dia_spmm` at GWN's shapes: the transposed
    structure that GWN's forward runs (and A, its backward) of the
    first doubletransition support, D^-1 A, of the CLI graph (block-CSR
    behind RCM, values not symmetric) and of the directed road graph
    (DIA band, pattern and values not symmetric), at F = 3,072 and 256.
    Each against the plain version, no block run densely; times of the
    kernel, the plain version and `torch.sparse.mm` on the transposed
    CSR (CUDA events, median of 20), with the bound."""
    import torch

    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.models.build import gwn_adj_mats
    from gptst_tpu_torch.ops.graph_conv import make_support

    t0 = time.perf_counter()
    cli = tuple(make_support(m, device="cuda") for m in
                gwn_adj_mats("doubletransition", rec["_cli_base"]))
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    road = gwn_road_supports(N_BIG, "cuda")
    road_s = time.perf_counter() - t0
    rec["_gwn"] = {"cli_graph": cli, "road_graph": road}
    assert all(s.dia is None and s.perm is not None for s in cli)
    assert all(s.dia is not None for s in road)
    for s in road:
        assert s.dia.vals.shape != s.dia_t.vals.shape or not torch.equal(
            s.dia.vals, s.dia_t.vals)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for name, kernel, plain, attr, s in (
            ("bsr", K.bsr_spmm, K.bsr_spmm_plain, "block_vals", cli[0]),
            ("dia", K.dia_spmm, K.dia_spmm_plain, "vals", road[0])):
        at, a = (s.dia_t, s.dia) if attr == "vals" else (s.bcsr_t, s.bcsr)
        csr = dia_csr(at) if attr == "vals" else bsr_csr(at)
        nnz = int(csr.values().numel())
        vals = getattr(at, attr)
        struct_bytes = (vals.numel() * vals.element_size() if attr == "vals"
                        else at.nnzb_logical * at.tile ** 2
                        * vals.element_size()
                        + (at.block_ptr.numel() + at.nnzb_logical) * 4)
        timing = {}
        for f in GWN_WIDTHS:
            x = torch.randn(at.n, f, device="cuda", generator=gen)
            K.reset_launch_counts()
            errs = {k: compare(kernel(st, x), plain(st, x), "f32")
                    for k, st in (("AT", at), ("A", a))}
            dense = K.dense_block_counts()
            assert not any(dense.values()), dense
            ms = time_ms(lambda: kernel(at, x))
            nbytes = struct_bytes + 2 * at.n * f * x.element_size()
            line = dict(ms=ms, plain_ms=time_ms(lambda: plain(at, x)),
                        library_ms=time_ms(lambda: torch.sparse.mm(csr, x)),
                        **bound(2 * nnz * f, nbytes))
            timing[f"F{f}"] = line
            emit("gwn_kernels", kernel=f"{name}_spmm", case=f"timing_F{f}",
                 structure="AT (GWN's forward)",
                 graph="cli_graph" if attr == "block_vals" else "road_graph",
                 shape=[at.n, f], nnz=nnz, max_abs_err=errs,
                 tol=dict(zip(("rtol", "atol"), TOL["f32"])), flops=2 * nnz
                 * f, bytes=nbytes, ms_A=time_ms(lambda: kernel(a, x)),
                 **line)
        rec[f"{name}_spmm"]["at_gwn_widths"] = timing
    emit("gwn_kernels", cli_graph_build_s=cli_s, road_graph_build_s=road_s,
         cli_nnzb=[s.bcsr.nnzb_logical for s in cli],
         road_band_w=[[s.dia.w, s.dia_t.w] for s in road],
         coo_tail_edges={k: [0 if s.coo is None else int(s.coo.nnz)
                             for s in v] for k, v in rec["_gwn"].items()})


def phase_gwn_cli(rec: dict) -> None:
    """The slice's main path: `run.main -mode ori -model GWN --aptonly
    False` at 16,384 nodes on the CLI graph (doubletransition supports,
    block-CSR behind RCM, and the adaptive adjacency), batch 8, 2
    epochs of 7 steps, from a PEMS08.npz the phase writes. Counts from
    0: per train step `bsr_spmm` launches 32 times on the transposed
    structures and 28 on A; per evaluation batch 32 on the transposed
    ones; no block runs densely."""
    import numpy as np
    import torch

    from gptst_tpu_torch.kernels import spmm as K
    from gptst_tpu_torch.train.trainer import Trainer

    trainers, train = [], Trainer.train
    phase = {"train": False}
    train_batch = Trainer._train_batch

    def keep(self, *args, **kw):
        trainers.append(self)
        return train(self, *args, **kw)

    def flagged(self, *args):
        phase["train"] = True
        try:
            return train_batch(self, *args)
        finally:
            phase["train"] = False

    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.json")
        argv = ["-dataset", "PEMS08", "-mode", "ori", "-model", "GWN",
                "--aptonly", "False", "-num_nodes", str(N_BIG),
                "-data_root", write_pems08(tmp, N_BIG, GWN_TIME_STEPS),
                "-batch_size", str(GWN_BATCH), "-epochs", "2",
                "-lr_decay", "False", "-early_stop", "False",
                "-log_dir", os.path.join(tmp, "save"), "-log_step", "1000",
                "-metrics_out", metrics]
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        calls, undo = record_block_launches(lambda: phase["train"])
        Trainer.train, Trainer._train_batch = keep, flagged
        try:
            wall = run_main(argv)
        finally:
            Trainer.train, Trainer._train_batch = train, train_batch
            undo()
        launches = dict(K.LAUNCHES)
        dense = K.dense_block_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(metrics) as f:
            rep = json.load(f)
    (tr,) = trainers
    (sups,) = tr.model.predictor.graph
    assert len(sups) == 2 and all(s.dia is None for s in sups)
    steps, epochs = rep["steps_per_epoch"], 2
    ds, bs = tr.dataset, GWN_BATCH
    eval_batches = (epochs * ds.num_batches("val", bs)
                    + ds.num_batches("test", bs))
    train_calls = [c for c in calls if c[3]]
    eval_calls = [c for c in calls if not c[3]]
    per_train = by_direction(train_calls, sups, band=False)
    per_eval = by_direction(eval_calls, sups, band=False)
    assert per_train == {"AT": GWN_FWD * steps * epochs,
                         "A": GWN_BWD * steps * epochs, "other": 0}, per_train
    assert per_eval == {"AT": GWN_FWD * eval_batches, "A": 0,
                        "other": 0}, per_eval
    assert launches["bsr_spmm"] == len(calls) and launches["dia_spmm"] == 0
    assert not any(dense.values()), dense
    vals = np.asarray(rep["per_horizon"] + [rep["average"]], np.float64)
    assert np.isfinite(vals).all() and np.isfinite(rep["history"]).all()
    rec["bsr_spmm"]["launches"] = launches["bsr_spmm"]
    rec["bsr_spmm"]["launches_by_path"]["gwn_cli"] = launches["bsr_spmm"]
    emit("gwn_cli", model="GWN", aptonly=False, nodes=N_BIG, batch=bs,
         epochs=epochs, time_steps=GWN_TIME_STEPS, steps_per_epoch=steps,
         ms_per_step_by_epoch=[s / steps * 1e3 for s in rep["epoch_seconds"]],
         samples_per_s_by_epoch=[ds.x_train.shape[0] / s
                                 for s in rep["epoch_seconds"]],
         train_loss_by_epoch=rep["history"], test_average=rep["average"],
         max_memory_allocated=peak, launches=launches, dense_blocks=dense,
         bsr_spmm_train_steps=per_train, bsr_spmm_eval=per_eval,
         eval_batches=eval_batches,
         bsr_spmm_per_train_step={k: v / (steps * epochs)
                                  for k, v in per_train.items()},
         widths=sorted({c[2] for c in calls}), wall_s=wall)


def gwn_grads(net, sups, x) -> dict:
    """GWN's prediction and every gradient of mean(pred^2) (zeros where
    a parameter reaches no output: the last layer's gconv and norm)."""
    import torch

    pred = net(x, sups)
    pred.square().mean().backward()
    return {"pred": pred.detach().cpu(), **{
        k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
        for k, p in net.named_parameters()}}


def assert_grads_close(got: dict, want: dict, what: str,
                       want64: dict | None = None,
                       extra: dict | None = None) -> dict:
    """rtol 1e-4 and an atol of 1e-5 of each tensor's largest entry; a
    GWN gconv bias (0 in exact arithmetic: a BatchStatsNorm follows it)
    an atol of 1e-5 of the model's largest gradient. With `want64` (the
    same run in float64), each atol also gets twice `want`'s own largest
    distance from it: a gradient that is a difference of nearly equal
    sums (GWN's nodevecs, through a softmax over 1,000 columns) is
    that far off in f32 on either device. `extra[k]`, where given, is
    added to tensor k's atol. Returns the errors."""
    import torch

    scale = max(float(w.abs().max()) for k, w in want.items() if k != "pred")
    errs = {}
    for k, w in want.items():
        atol = 1e-5 * (scale if "gconv_b" in k else float(w.abs().max()))
        if want64 is not None:
            atol += 2 * float((w.double() - want64[k]).abs().max())
        if extra is not None:
            atol += extra[k]
        errs[k] = float((got[k] - w).abs().max())
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=atol,
                                   msg=lambda m: f"{what} {k}: {m}")
    return errs


def phase_gwn_model(rec: dict) -> None:
    """GWN train steps through the library on the directed road graph's
    doubletransition supports (DIA bands and COO tails, built from the
    edge list): `dia_spmm` launches 32 times a step on the transposed
    bands and 28 on A's, which are other bands; no block runs densely.
    Then, on a ragged 1,000-node cut of the same generator, the loss and
    every gradient on the sparse supports against the same model on the
    dense supports, both on the card (deterministic algorithms): rtol
    1e-4 with an atol of 1e-5 of each tensor's largest entry."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.kernels import spmm as K

    sups = rec["_gwn"]["road_graph"]
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 1, 3
    calls, undo = record_block_launches()
    try:
        losses, ms, launches, dense = train_steps(
            "GWN", bind("GWN", gwn_net(), (sups,)), GWN_BATCH, warm, steps)
    finally:
        undo()
    per = by_direction(calls, sups, band=True)
    n_steps = warm + steps
    assert per == {"AT": GWN_FWD * n_steps, "A": GWN_BWD * n_steps,
                   "other": 0}, per
    assert launches["bsr_spmm"] == 0 and not any(dense.values())
    rec["dia_spmm"]["launches"] = launches["dia_spmm"]
    rec["dia_spmm"]["launches_by_path"]["gwn_model"] = launches["dia_spmm"]
    emit("gwn_model", graph="road_graph_edges(16384, 16, 48), directed",
         nodes=N_BIG, batch=GWN_BATCH, steps=n_steps, ms_per_step=ms,
         samples_per_s=GWN_BATCH / ms * 1e3, losses=losses,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, dense_blocks=dense, dia_spmm_by_structure=per)
    torch.cuda.empty_cache()

    n = 1000
    small = gwn_road_supports(n, "cuda")
    assert all(s.dia is not None for s in small)
    rows, cols = road_graph_edges(n, 16, 48)
    a = np.zeros((n, n), np.float32)
    a[rows, cols] = 1.0
    from gptst_tpu_torch.models.build import gwn_adj_mats

    dense_sups = tuple(torch.tensor(m, device="cuda")
                       for m in gwn_adj_mats("doubletransition", a))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 12, n, 1), np.float32)).cuda()
    base = gwn_net(n, seed=1)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        K.reset_launch_counts()
        got = gwn_grads(copy.deepcopy(base), small, x)
        ran = dict(K.LAUNCHES)
        want = gwn_grads(copy.deepcopy(base), dense_sups, x)
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    assert ran["dia_spmm"] == GWN_FWD + GWN_BWD and ran["bsr_spmm"] == 0, ran
    errs = assert_grads_close(got, want, "GWN sparse vs dense")
    emit("gwn_model", check="sparse_vs_dense_supports", nodes=n, batch=4,
         pred_max_abs_err=errs.pop("pred"),
         grad_max_abs_err=max(errs.values()), parameters=len(errs),
         tol={"rtol": 1e-4, "atol": "1e-5 * max|want| (gconv_b: of the "
              "model's largest gradient)"})


def cli_cycles(tmp: str, ori, evaluated) -> dict:
    """`run.main` at published widths, batch 64, 2 epochs over 1,000
    time steps: `-mode ori` of each (model, dataset) of `ori`, then per
    dataset of `evaluated` one `-mode pretrain` and, from its
    checkpoint, `-mode eval` and `-mode test` of each of its models.
    PEMS08 reads a 170-node PEMS08.npz written under `tmp`, NYC_BIKE
    its own 250-node series. Returns, by run (`<mode>_<model>`,
    `pretrain_<dataset>`), the metrics file, the seconds, the peak
    device memory and what was allocated before the run."""
    import torch

    data = {"PEMS08": ["-data_root", write_pems08(
        tmp, GPTST_CLI_NODES, PRED_CLI_STEPS)],
        "NYC_BIKE": ["-num_steps", str(PRED_CLI_STEPS)]}
    runs: dict = {"out": {}, "seconds": {}, "peak": {}, "held": {}}

    def run(dataset, mode, model=None):
        key = f"{mode}_{model or dataset}"
        path = os.path.join(tmp, f"{key}.json")
        argv = ["-dataset", dataset, "-mode", mode, *data[dataset],
                "-batch_size", str(GPTST_CLI_BATCH), "-epochs", "2",
                "-change_epoch", "1", "-lr_decay", "False",
                "-log_dir", os.path.join(
                    tmp, "save_ori" if mode == "ori" else "save"),
                "-log_step", "1000", "-metrics_out", path]
        torch.cuda.reset_peak_memory_stats()
        runs["held"][key] = torch.cuda.memory_allocated()
        runs["seconds"][key] = run_main(
            argv + (["-model", model] if model else []))
        runs["peak"][key] = torch.cuda.max_memory_allocated()
        with open(path) as f:
            runs["out"][key] = json.load(f)

    for model, dataset in ori:
        run(dataset, "ori", model)
    for dataset in dict.fromkeys(ds for _, ds in evaluated):
        run(dataset, "pretrain")
        for model, ds in evaluated:
            if ds == dataset:
                run(dataset, "eval", model)
                run(dataset, "test", model)
    return runs


def cli_summary(runs: dict, models) -> dict:
    """A CLI phase's line from `cli_cycles`' runs. Every training run's
    losses are finite, and each model's test report equals its eval
    run's (rtol 1e-5: the same weights, windows and test generator,
    dense products only); epoch ms per step, the peak device memory
    and the peak over what was held before each run."""
    import numpy as np

    out, peak = runs["out"], runs["peak"]
    rel = {m: same_report(out[f"test_{m}"], out[f"eval_{m}"], rtol=1e-5)
           for m in models}
    trained = [k for k in out if not k.startswith("test")]
    for k in trained:
        assert np.isfinite(out[k]["history"]).all(), k
    return dict(
        nodes={"PEMS08": GPTST_CLI_NODES, "NYC_BIKE": 250},
        batch=GPTST_CLI_BATCH, epochs=2, time_steps=PRED_CLI_STEPS,
        seconds=runs["seconds"],
        ms_per_step_by_epoch={k: [t / out[k]["steps_per_epoch"] * 1e3
                                  for t in out[k]["epoch_seconds"]]
                              for k in trained},
        max_memory_allocated=peak,
        peak_over_held={k: peak[k] - runs["held"][k] for k in peak},
        train_loss_by_epoch={k: out[k]["history"] for k in trained},
        test_report_max_rel_diff=rel,
        average={k: out[k]["average"] for k in out})


def phase_predictors_cli(rec: dict) -> None:
    """MTGNN (PEMS08, 170 nodes) and CCRNN (NYC_BIKE, 250 nodes)
    through `run.main -mode ori`, batch 64, 2 epochs; then, from one
    `-mode pretrain` checkpoint per dataset, `-mode eval` and `-mode
    test` of GWN, MTGNN (PEMS08) and CCRNN (NYC_BIKE) (`cli_cycles`).
    GWN's and MTGNN's test reports run dropout (the trainer's test
    generator), as the JAX package's do; each equals its eval run's.
    No kernel of `csrc/` launches (GWN's default is the adaptive
    adjacency alone)."""
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts

    evaluated = (("GWN", "PEMS08"), ("MTGNN", "PEMS08"),
                 ("CCRNN", "NYC_BIKE"))
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        runs = cli_cycles(tmp, evaluated[1:], evaluated)
    assert not any(LAUNCHES.values()), LAUNCHES
    emit("predictors_cli", **cli_summary(runs, [m for m, _ in evaluated]))


def reference_gwn(b: int) -> None:
    """GWN at its published widths (aptonly off: doubletransition
    supports of a directed 1,000-node graph and the adaptive adjacency)
    with and without RCM (a DIA band and block-CSR), card against CPU
    from the same weights, under deterministic algorithms: the
    prediction and every gradient of mean(pred^2), rtol 1e-4 and an
    atol of 1e-5 of each tensor's largest entry (gconv biases: of the
    model's largest gradient) plus twice the CPU's own distance from
    the float64 run on the dense supports (`assert_grads_close`)."""
    import copy

    import numpy as np
    import torch

    from gptst_tpu_torch.graph.artifacts import random_sensor_graph
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts
    from gptst_tpu_torch.models.build import gwn_adj_mats
    from gptst_tpu_torch.ops.graph_conv import make_support

    n = 1000
    base = random_sensor_graph(n, avg_degree=6, seed=3, directed=True)
    mats = gwn_adj_mats("doubletransition", base)
    assert not np.array_equal(mats[0] != 0, mats[0].T != 0)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (b, 12, n, 1), np.float32))
    net = gwn_net(n, seed=2).cpu()
    want64 = gwn_grads(copy.deepcopy(net).double(), tuple(
        torch.tensor(m, dtype=torch.float64) for m in mats), x.double())
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for reorder in (True, False):
            out = {}
            for dev in ("cpu", "cuda"):
                sups = tuple(make_support(m, dense_threshold=0,
                                          reorder=reorder, device=dev)
                             for m in mats)
                reset_launch_counts()
                out[dev] = gwn_grads(copy.deepcopy(net).to(dev), sups,
                                     x.to(dev))
                ran = sorted(k for k, v in LAUNCHES.items() if v)
            assert ran == (["dia_spmm"] if sups[0].dia is not None
                           else ["bsr_spmm"]), ran
            errs = assert_grads_close(out["cuda"], out["cpu"], "GWN",
                                      want64)
            emit("reference", model="GWN", nodes=n, batch=b,
                 reorder=reorder, graph="directed", kernels=ran,
                 pred_max_abs_err=errs.pop("pred"),
                 grad_max_abs_err=max(errs.values()), parameters=len(errs),
                 nodevec_grad_err={k: [errs[k], float(
                     (out["cpu"][k].double() - want64[k]).abs().max())]
                     for k in ("nodevec1", "nodevec2")},
                 tol={"rtol": 1e-4, "atol": "1e-5 * max|want| (gconv_b: "
                      "of the model's largest gradient) + 2 * max|want - "
                      "want_float64|"})
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def reference_dense_predictors(b: int) -> None:
    """MTGNN (PEMS08's widths) and CCRNN (NYC_BIKE's) at 64 nodes, card
    against CPU from the same weights: the prediction and every
    gradient of mean(pred^2), rtol 1e-4 and an atol of 1e-5 of each
    tensor's largest entry plus twice the CPU's own distance from its
    float64 run (`assert_grads_close`). MTGNN's embeddings are scaled to 0.1 of
    their init: its top-k is a threshold, and where tanh saturates an
    entry that rounds to 1.0 on one side and 1 - 2^-24 on the other
    falls on the other side of a tie (as in the CPU tests)."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import build_predictor

    n = 64
    for model, dataset in (("MTGNN", "PEMS08"), ("CCRNN", "NYC_BIKE")):
        cfg = default_config(dataset, mode="ori", model=model, num_nodes=n)
        net = build_predictor(cfg, device="cpu", seed=0).net
        if model == "MTGNN":
            with torch.no_grad():
                net.gc.emb1.mul_(0.1)
                net.gc.emb2.mul_(0.1)
        x = torch.from_numpy(np.random.default_rng(10).standard_normal(
            (b, 12, n, cfg.input_base_dim), np.float32))
        out = device_grads(net, (), x)
        errs = assert_grads_close(out["cuda"], out["cpu"], model, out["f64"])
        emit("reference", model=model, nodes=n, batch=b,
             pred_max_abs_err=errs.pop("pred"),
             grad_max_abs_err=max(errs.values()), parameters=len(errs),
             tol={"rtol": 1e-4, "atol": "1e-5 * max|want| + 2 * max|want "
                  "- want_float64|"})


# --- STMGCN, ASTGCN, STSGCN, STFGNN and STGODE -----------------------------

GRAPH_MODELS = (("STMGCN", "NYC_BIKE"), ("ASTGCN", "PEMS08"),
                ("STSGCN", "PEMS08"), ("STFGNN", "PEMS08"),
                ("STGODE", "PEMS08"))
GRAPH_MODEL_NODES, GRAPH_MODEL_BATCH = 2048, 16


def count_native_dtw():
    """Wrap the port's native DTW entry point: every call must return
    costs (the library built). Returns the call list and an undo."""
    from gptst_tpu_torch import native

    orig = native.native_banded_dtw_pairs
    calls = []

    def counted(x, ii, *a, **k):
        out = orig(x, ii, *a, **k)
        assert out is not None, "the native DTW library did not build"
        calls.append(int(ii.size))
        return out

    native.native_banded_dtw_pairs = counted
    return calls, lambda: setattr(native, "native_banded_dtw_pairs", orig)


def phase_graph_predictors_cli(rec: dict) -> None:
    """The five predictors of the ninth slice through `run.main` at
    published widths, f32 with TF32 off (`cli_cycles`): STMGCN on
    NYC_BIKE (250 nodes), the other four on PEMS08 (170 nodes); each
    test report equal to its eval run's. The run works in a fresh
    directory, so STFGNN's and STGODE's DTW graphs are built there, by
    the port's native library (the DTW graphs read the dataset's
    default series, as the JAX package's builders do). Losses finite;
    no kernel of `csrc/` launches."""
    import torch

    from gptst_tpu_torch import native
    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts

    assert native.load("dtw") is not None, "g++ could not build libdtw.so"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    cwd = os.getcwd()
    dtw_calls, undo = count_native_dtw()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # a working directory with no `./data` or `../data`, where
            # `load_raw_series` would look for the default series
            work = os.path.join(tmp, "run", "work")
            os.makedirs(work)
            os.chdir(work)
            reset_launch_counts()
            runs = cli_cycles(tmp, GRAPH_MODELS, GRAPH_MODELS)
            cached = sorted(os.listdir(os.path.join(work, ".gptst_cache")))
    finally:
        os.chdir(cwd)
        undo()
    # STFGNN's and STGODE's graphs, each built once and then read back
    assert len(dtw_calls) == 2 and len(cached) == 2, (dtw_calls, cached)
    assert all(c.startswith("torch_") for c in cached), cached
    assert not any(LAUNCHES.values()), LAUNCHES
    emit("graph_predictors_cli", native_dtw_pairs=dtw_calls,
         dtw_cache=cached,
         **cli_summary(runs, [m for m, _ in GRAPH_MODELS]))


def graph_predictor(model: str, dataset: str, n: int, device, seed: int = 0):
    """`model` at published widths on `n` nodes, built by
    `build_predictor` from `random_sensor_graph(n)`; the series-derived
    graph (STMGCN's Pearson graph, STFGNN's and STGODE's DTW graph) is
    `random_sensor_graph(n, seed=1)`, passed as `series_graph`, since
    the builders' `[:, :num_nodes]` slice of the default series has
    fewer nodes than `n` here. Returns the `GraphPredictor`."""
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.graph.artifacts import random_sensor_graph
    from gptst_tpu_torch.models.build import build_predictor

    cfg = default_config(dataset, mode="ori", model=model, num_nodes=n)
    series = (random_sensor_graph(n, avg_degree=6, seed=1)
              if model in ("STMGCN", "STFGNN", "STGODE") else None)
    return build_predictor(cfg, adj=random_sensor_graph(n, avg_degree=6,
                                                         seed=0),
                           device=device, seed=seed, series_graph=series)


def library_steps(phase: str, models, batch: dict,
                  n: int = GRAPH_MODEL_NODES) -> None:
    """Library train steps (1 warm, 3 timed) of each (model, dataset) of
    `models` at `n` nodes (`graph_predictor`), batch `batch[model]`,
    published widths, each config's loss: ms per step, samples/s and
    peak device memory (also over what was allocated before the model
    was built); no kernel of `csrc/`."""
    import torch

    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.models.build import predictor_forward

    for model, dataset in models:
        b = batch[model]
        cfg = default_config(dataset, mode="ori", model=model, num_nodes=n)
        # the peak over what earlier phases still hold is the model's
        # footprint: weights, graphs, optimizer state and activations
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pred = graph_predictor(model, dataset, n, "cuda")
        build_s = time.perf_counter() - t0
        losses, ms, launches, _ = train_steps(
            model, predictor_forward(cfg, pred), b, 1, 3, nodes=n,
            dataset=dataset, loss_func=cfg.loss_func)
        assert not any(launches.values()), launches
        peak = torch.cuda.max_memory_allocated()
        emit(phase, model=model, dataset=dataset,
             graph=f"random_sensor_graph({n}, 6, seed 0; series graph "
                   "seed 1)", nodes=n, batch=b, steps=4,
             loss_func=cfg.loss_func, build_s=build_s, ms_per_step=ms,
             samples_per_s=b / ms * 1e3, losses=losses,
             max_memory_allocated=peak, memory_held_before=held,
             peak_over_held=peak - held,
             parameters=sum(p.numel() for p in pred.parameters()))
        del pred
        torch.cuda.empty_cache()


def phase_graph_predictors_model(rec: dict) -> None:
    """Library steps of the five at 2,048 nodes, batch 16
    (`library_steps`): STSGCN's and STFGNN's synchronous graphs are
    6,144 and 8,192 rows, dense."""
    library_steps("graph_predictors_model", GRAPH_MODELS,
                  dict.fromkeys((m for m, _ in GRAPH_MODELS),
                                GRAPH_MODEL_BATCH))


def grads_on(base, graph: tuple, x, dev: str, dtype, **lists) -> dict:
    """The prediction and every parameter gradient of mean(pred^2) of a
    copy of `base` on `dev` in `dtype`, run on `x`, the `graph` tensors
    and the tensor lists of `lists` (keyword arguments of the forward),
    all moved there. A parameter that reaches no output has a zero
    gradient."""
    import copy

    import torch

    net = copy.deepcopy(base).to(dev, dtype)
    pred = net(x.to(dev, dtype), *(g.to(dev, dtype) for g in graph), **{
        k: [t.to(dev, dtype) for t in v] for k, v in lists.items()})
    pred.square().mean().backward()
    return {"pred": pred.detach().cpu(), **{
        k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
        for k, p in net.named_parameters()}}


def device_grads(base, graph: tuple, x, **lists) -> dict:
    """`grads_on` on the CPU (f32), on the card (f32) and on the CPU in
    float64, keyed "cpu", "cuda" and "f64"."""
    import torch

    return {key: grads_on(base, graph, x, dev, dt, **lists)
            for key, dev, dt in (("cpu", "cpu", torch.float32),
                                 ("cuda", "cuda", torch.float32),
                                 ("f64", "cpu", torch.float64))}


def reference_graph_predictors(b: int) -> None:
    """STMGCN (NYC_BIKE's widths), ASTGCN, STSGCN, STFGNN and STGODE
    (PEMS08's) at 64 nodes, card against CPU from the same weights and
    graphs (`graph_predictor`): the prediction and every gradient of
    mean(pred^2), rtol 1e-4 and an atol of 1e-5 of each tensor's largest
    entry plus twice the CPU's own distance from its float64 run
    (`assert_grads_close`); a parameter that reaches no output (STGODE's
    discarded TCN convs) has a zero gradient on every side. TF32 is off
    (`set_precision`): with it on, the card's products would be ~1e-3
    from the CPU's."""
    import numpy as np
    import torch

    from gptst_tpu_torch.config.config import default_config

    n = 64
    for model, dataset in GRAPH_MODELS:
        base = graph_predictor(model, dataset, n, "cpu")
        din = default_config(dataset).input_base_dim
        x = torch.from_numpy(np.random.default_rng(11).standard_normal(
            (b, 12, n, din), np.float32))
        out = device_grads(base.net, base.graph, x)
        errs = assert_grads_close(out["cuda"], out["cpu"], model, out["f64"])
        emit("reference", model=model, nodes=n, batch=b,
             pred_max_abs_err=errs.pop("pred"),
             grad_max_abs_err=max(errs.values()), parameters=len(errs),
             allow_tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
             tol={"rtol": 1e-4, "atol": "1e-5 * max|want| + 2 * max|want "
                  "- want_float64|"})


# --- ST_WA and DMVSTNET, the last two predictors ---------------------------

LAST_MODELS = (("ST_WA", "PEMS08"), ("DMVSTNET", "NYC_BIKE"))
# ST_WA's 16 windows each keep a (B, 8 heads, 2 proxies, N, N) softmax
# for the backward: 2.15 GB a window at 2,048 nodes and batch 8, ~34 GB
# a step (~69 GB at batch 16)
LAST_MODEL_BATCH = {"ST_WA": 8, "DMVSTNET": GRAPH_MODEL_BATCH}


def phase_last_predictors_cli(rec: dict) -> None:
    """ST_WA on PEMS08 (170 nodes) and DMVSTNET on NYC_BIKE (250, its
    home dataset, dim_out 2) through `run.main` at published widths, f32
    with TF32 off (`cli_cycles`): `-mode ori`, then one pretrain -> eval
    -> test per dataset; each test report (ST_WA's latents drawn from
    the trainer's test generator) equal to its eval run's. No kernel of
    `csrc/` launches."""
    import torch

    from gptst_tpu_torch.kernels.spmm import LAUNCHES, reset_launch_counts

    assert not torch.backends.cuda.matmul.allow_tf32
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        runs = cli_cycles(tmp, LAST_MODELS, LAST_MODELS)
    assert not any(LAUNCHES.values()), LAUNCHES
    emit("last_predictors_cli",
         **cli_summary(runs, [m for m, _ in LAST_MODELS]))


def phase_last_predictors_model(rec: dict) -> None:
    """Library steps of ST_WA (batch 8) and DMVSTNET (batch 16) at 2,048
    nodes (`library_steps`)."""
    library_steps("last_predictors_model", LAST_MODELS, LAST_MODEL_BATCH)


def relu_net_reference(model: str, base, graph: tuple, x, **lists) -> dict:
    """Card against CPU for a network whose gradients pass many ReLUs
    (ST_WA, DMVSTNET), from the same weights and inputs: the prediction
    and every gradient of mean(pred^2) (`grads_on`).

    In float64: rtol 1e-9 and an atol of 1e-9 of each tensor's largest
    entry. In f32 (TF32 off): the other predictors' tolerance, rtol 1e-4
    and an atol of 1e-5 of each tensor's largest entry plus twice the
    CPU's distance from its float64 run (`assert_grads_close`), plus
    twice the CPU's largest move over 4 f32 runs on x moved by one ulp:
    rounding decides
    on which side of a ReLU's kink a pre-activation near 0 falls, and a
    gradient jumps there (on the CPU a one-ulp move of x moved ST_WA's
    `mu_est.0.weight` gradient by 2e-4 of its largest entry in half the
    runs). Both added terms are the CPU's alone. In either precision a
    tensor whose largest entry is at most that rtol times the model's
    largest gradient (ST_WA's key biases: a softmax is blind to a shift
    of its logits, so their gradient is 0 in exact arithmetic) is held
    at that rtol times the latter. Returns the fields of the line."""
    import torch

    def vanishing(want: dict, rel: float) -> dict:
        scale = max(float(w.abs().max()) for k, w in want.items()
                    if k != "pred")
        return {k: rel * scale if float(w.abs().max()) <= rel * scale
                else 0.0 for k, w in want.items()}

    cpu64 = grads_on(base, graph, x, "cpu", torch.float64, **lists)
    card64 = grads_on(base, graph, x, "cuda", torch.float64, **lists)
    floor64 = vanishing(cpu64, 1e-9)
    errs64 = {}
    for k, w in cpu64.items():
        errs64[k] = float((card64[k] - w).abs().max())
        torch.testing.assert_close(
            card64[k], w, rtol=1e-9,
            atol=1e-9 * float(w.abs().max()) + floor64[k],
            msg=lambda m: f"{model} float64 {k}: {m}")
    cpu = grads_on(base, graph, x, "cpu", torch.float32, **lists)
    card = grads_on(base, graph, x, "cuda", torch.float32, **lists)
    ulp = torch.Generator().manual_seed(14)
    spread = dict.fromkeys(cpu, 0.0)
    for _ in range(4):
        moved = x * (1 + 2.0 ** -23 * torch.randn(
            x.shape, generator=ulp).sign())
        for k, v in grads_on(base, graph, moved, "cpu", torch.float32,
                             **lists).items():
            spread[k] = max(spread[k], float((v - cpu[k]).abs().max()))
    floor = vanishing(cpu, 1e-5)
    errs = assert_grads_close(card, cpu, model, cpu64, extra={
        k: 2 * spread[k] + floor[k] for k in cpu})
    return dict(pred_max_abs_err=errs.pop("pred"),
                grad_max_abs_err=max(errs.values()), parameters=len(errs),
                float64_max_abs_err=max(errs64.values()),
                ulp_spread_max=max(spread.values()),
                widened_by_spread=sorted(
                    k for k in cpu if 2 * spread[k] > 1e-5 * float(
                        cpu[k].abs().max())),
                tol={"float64": {"rtol": 1e-9, "atol": "1e-9 * max|want|"},
                     "f32": {"rtol": 1e-4, "atol": "1e-5 * max|want| + 2 * "
                             "max|want - want_float64| + 2 * one-ulp "
                             "spread of x on the CPU"},
                     "vanishing": "max|want| <= rtol * model's largest "
                                  "gradient: + rtol * that"})


def reference_last_predictors(b: int) -> None:
    """ST_WA in both branches (PEMS08's widths; the dynamic one with its
    four draws made once on the CPU and passed to every run) and
    DMVSTNET (NYC_BIKE's widths, `graph_predictor`'s raw adjacency) at
    64 nodes, card against CPU (`relu_net_reference`)."""
    import numpy as np
    import torch

    from gptst_tpu_torch.models.predictors.stwa import STWA, STWAConfig

    n = 64
    rng = np.random.default_rng(12)
    for dynamic in (True, False):
        net = STWA(STWAConfig(num_nodes=n, dynamic=dynamic), 1, 1, 12, 12,
                   generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(rng.standard_normal((b, 12, n, 1), np.float32))
        lists = ({"draws": net.draw(x, torch.Generator().manual_seed(13))}
                 if dynamic else {})
        emit("reference", model="ST_WA", dynamic=dynamic, nodes=n, batch=b,
             **relu_net_reference("ST_WA", net, (), x, **lists))
    base = graph_predictor("DMVSTNET", "NYC_BIKE", n, "cpu")
    x = torch.from_numpy(rng.standard_normal((b, 12, n, 2), np.float32))
    emit("reference", model="DMVSTNET", nodes=n, batch=b,
         **relu_net_reference("DMVSTNET", base.net, base.graph, x))


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
        globals()[f"phase_{name}"](rec)
        emit(name, done=True, seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": [rec[k] for k in (
        "bsr_spmm", "dia_spmm", "sddmm", "spmm_dvals", "ring_spmm")]}))
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
