"""Run some phases of `chip_smoke.py` alone, on the card.

    python3 chip_phases.py build bsr dia dia_model data_parallel
    python3 chip_phases.py build ring gptst_graph
    python3 chip_phases.py build predictors_graph
    python3 chip_phases.py last_predictors_graph
    python3 chip_phases.py final_predictors_graph
    python3 chip_phases.py build distributed
    python3 chip_phases.py build device_data_abba
    python3 chip_phases.py build device_data_graph   # 2+ cards: graph_cards
    python3 chip_phases.py build step_graph
    python3 chip_phases.py build step_graph_cards   # with 2+ cards
    python3 chip_phases.py build cards      # with 2+ cards

Each name is a phase of `chip_smoke.PHASES`, run in the order given,
or `device_data_abba`: `device_data` with fresh runs of each model in
the order host, resident, resident, host (the gaps within each path
beside the gap between them), or `device_data_graph`: `device_data`'s
cases over 'graph' alone (`device_data_graphs`; needs `build` for the
CLI graph's TGCN on (2, 1)), or
`cards`: the several-card parts of `data_parallel` (one data row per
card and the CLI graph's mesh), of `gptst_graph` (GPT-ST's two graph
ranks on two cards), of `predictors_graph` (STGCN, GWN, MTGNN and
CCRNN on two cards), of `last_predictors_graph` (MSDR, ASTGCN, STGODE,
ST_WA and DMVSTNET on two cards), of `final_predictors_graph` (TGCN,
STMGCN, STSGCN and STFGNN on two cards), of `distributed` (NCCL, one
process per card), `step_graph_cards` (the same processes, each
replaying its captured data-parallel train step) and `device_data`'s
`graph_cards` (the split over 'graph' on two and four cards).
The state that earlier phases leave for later ones is made up front:
the CLI graph's adjacency, its sym-normalized form and `bsr_spmm`
support, and empty `bsr_spmm`/`dia_spmm` records.
`data_parallel` also needs `dia_model` before it (the road graph's
support and losses). Prints the phases' lines, the kernel records and
the card's name and power limit.
"""

import json
import subprocess
import sys
import time

import chip_smoke as c
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.run import set_precision


def main(names: list[str]) -> int:
    set_precision(default_config("PEMS08"))
    rec = {"_supports": {}, "bsr_spmm": {"launches_by_path": {}},
           "dia_spmm": {"launches_by_path": {}},
           "_cli_base": random_sensor_graph(c.N_BIG, avg_degree=6, seed=0)}
    rec["_cli_sym"] = sym_adj(rec["_cli_base"])
    rec["_supports"]["cli_graph"] = make_support(rec["_cli_sym"],
                                                 device="cuda")
    for name in names:
        runs = ((c.data_parallel_cards, c.gptst_graph_cards,
                 c.predictors_graph_cards, c.last_predictors_graph_cards,
                 c.final_predictors_graph_cards, c.distributed_cards,
                 c.phase_step_graph_cards,
                 lambda rec: c.device_data_graphs(rec, one_card=False))
                if name == "cards" else
                (lambda rec: c.phase_device_data(rec, abba=True),)
                if name == "device_data_abba"
                else (c.device_data_graphs,)
                if name == "device_data_graph"
                else (getattr(c, f"phase_{name}"),))
        t0 = time.perf_counter()
        for run in runs:
            run(rec)
        c.emit(name, done=True, seconds=time.perf_counter() - t0)
    print(json.dumps({k: rec[k] for k in ("bsr_spmm", "dia_spmm")}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: " + smi.stderr.strip())
    return 0


if __name__ == "__main__":
    extra = ("cards", "device_data_abba", "device_data_graph")
    unknown = [n for n in sys.argv[1:] if n not in c.PHASES + extra]
    if unknown or len(sys.argv) < 2:
        print(f"usage: chip_phases.py PHASE... (of {c.PHASES} and "
              f"{extra}); "
              f"unknown: {unknown}", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
