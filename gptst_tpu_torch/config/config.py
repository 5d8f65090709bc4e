"""Typed framework configuration + INI ingestion.

The reference drives everything through INI files parsed into argparse
namespaces (`lib/Params_pretrain.py`, `lib/Params_predictor.py`). Here
the same information lives in a frozen dataclass. `from_ini` reads
reference-format `.conf` files so existing configs map 1:1;
`default_config` carries the built-in per-dataset defaults from
`conf/GPTST_pretrain/*.conf`.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Sequence

from gptst_tpu_torch.config.datasets import get_dataset_spec


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """The pretrain/framework namespace (single-hyphen flags upstream)."""

    dataset: str = "PEMS08"
    mode: str = "ori"            # ori | eval | pretrain | test
    model: str = "STGCN"

    # [data]
    num_nodes: int = 170
    lag: int = 12
    horizon: int = 12
    val_ratio: float = 0.2
    test_ratio: float = 0.2
    tod: bool = False
    normalizer: str = "std"
    column_wise: bool = False
    default_graph: bool = True

    # [model]
    input_base_dim: int = 1
    input_extra_dim: int = 2
    output_dim: int = 1
    embed_dim: int = 16
    embed_dim_spa: int = 4
    hidden_dim: int = 64
    HS: int = 10
    HT: int = 16
    HT_Tem: int = 8
    num_route: int = 2
    mask_ratio: float = 0.25
    ada_mask_ratio: float = 0.5
    ada_type: str = "all"        # all | half

    # [train]
    loss_func: str = "mask_mae"
    seed: int = 12
    batch_size: int = 64
    epochs: int = 300
    lr_init: float = 3e-3
    lr_decay: bool = True
    lr_decay_rate: float = 0.3
    lr_decay_step: Sequence[int] = (150, 250)
    early_stop: bool = True
    early_stop_patience: int = 100
    change_epoch: int = 10
    up_epoch: Sequence[int] = (110, 170, 250)
    grad_norm: bool = True
    max_grad_norm: float = 5.0
    debug: bool = True
    real_value: bool = False
    seed_mode: bool = True
    xavier: bool = True
    load_pretrain_path: str = "gptst_pretrain.ckpt"
    save_pretrain_path: str = "gptst_pretrain.ckpt"

    # [test]
    mae_thresh: float | None = None
    mape_thresh: float = 0.0

    # [log]
    log_step: int = 20
    log_dir: str = "./SAVE"

    # precision policy: compute dtype for model internals ("float32"|"bfloat16")
    compute_dtype: str = "float32"
    # activation remat for the GPT-ST STHCN trunks in pretrain/eval
    # builds (none|full|dots — `models/gptst.py:GPTSTConfig.remat`);
    # "none" default, flip to "full" to trade a recomputed trunk
    # forward for the stored intermediates that cap large-N batches
    pretrain_remat: str = "none"
    # MXU matmul precision for the training run: "auto" resolves to
    # "highest" when compute_dtype is float32 (true-f32 contractions —
    # the torch reference trains full f32; the TPU default would run
    # f32 operands through single-pass bf16 multiplies, which measurably
    # degrades GPT-ST pretrain convergence vs the reference) and to
    # "default" under the bf16 throughput mode. Any explicit jax
    # precision name ("default"|"high"|"highest") overrides.
    matmul_precision: str = "auto"
    # optimizer steps fused into one dispatch via lax.scan (1 = off);
    # amortizes host->device dispatch latency (~10x at reference scale).
    # 0 = auto (the default): the trainer uses 16 — the benched fast
    # path — falling back to per-batch dispatch only where fusion can't
    # apply (ragged tails fuse at their own width; the device-resident
    # indexed gather additionally needs the split to fit in HBM)
    scan_steps: int = 0
    # root of reference-format conf/<MODEL>/<DATASET>.conf predictor
    # configs; empty = use the built-in dataclass defaults
    predictor_conf_root: str = ""
    # root of reference-format data files (adjacency CSVs/pkl, prefab
    # graph artifacts under <root>/{STGODE,STFGNN,STMGCN_demand});
    # builders fall back to synthesis when files are absent
    data_root: str = "./data"
    # keep the train split device-resident and gather each batch on the
    # device by index (needs scan_steps other than 1); the reference
    # keeps splits wholly on the GPU (`lib/dataloader.py:92-99`)
    device_data: bool = True
    # periodic resumable checkpoint every N epochs (0 = off); restored
    # by `-resume True` (SURVEY §5: checkpoint-every-N + auto-resume)
    ckpt_every_epochs: int = 0
    # multi-chip: build a ('data','graph') mesh over all visible devices
    # when more than one is present (batch over 'data', node axis +
    # node-indexed tables over 'graph'); graph_axis_size 0 = auto
    # (`parallel/mesh.py:choose_mesh_shape`)
    use_mesh: bool = True
    graph_axis_size: int = 0
    # CLI `--flag` overrides of predictor-config fields, as ((name,
    # raw-string), ...) — the reference's double-hyphen surface
    # (`readme.md:78-82`); applied by `models/build.make_predictor_config`
    predictor_overrides: Sequence = ()

    def replace(self, **kw) -> "FrameworkConfig":
        return dataclasses.replace(self, **kw)


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


def _parse_int_list(s) -> tuple[int, ...]:
    if isinstance(s, (tuple, list)):
        return tuple(int(i) for i in s)
    return tuple(int(i) for i in str(s).split(",") if str(i).strip())


def _parse_optional_float(s) -> float | None:
    if s is None:
        return None
    t = str(s).strip().lower()
    if t in ("none", ""):
        return None
    return float(t)


def from_ini(path: str, dataset: str, mode: str = "ori",
             model: str = "STGCN", **overrides) -> FrameworkConfig:
    """Read a reference-format GPTST_pretrain `.conf` into a FrameworkConfig.

    Section/key layout matches `lib/Params_pretrain.py:25-75`.
    """
    cp = configparser.ConfigParser()
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(path)
    d, m, t, te, lg = cp["data"], cp["model"], cp["train"], cp["test"], cp["log"]
    cfg = FrameworkConfig(
        dataset=dataset, mode=mode, model=model,
        num_nodes=int(d["num_nodes"]), lag=int(d["lag"]),
        horizon=int(d["horizon"]), val_ratio=float(d["val_ratio"]),
        test_ratio=float(d["test_ratio"]), tod=_parse_bool(d["tod"]),
        normalizer=d["normalizer"], column_wise=_parse_bool(d["column_wise"]),
        default_graph=_parse_bool(d["default_graph"]),
        input_base_dim=int(m["input_base_dim"]),
        input_extra_dim=int(m["input_extra_dim"]),
        output_dim=int(m["output_dim"]), embed_dim=int(m["embed_dim"]),
        embed_dim_spa=int(m["embed_dim_spa"]), hidden_dim=int(m["hidden_dim"]),
        HS=int(m["HS"]), HT=int(m["HT"]), HT_Tem=int(m["HT_Tem"]),
        num_route=int(m["num_route"]), mask_ratio=float(m["mask_ratio"]),
        ada_mask_ratio=float(m["ada_mask_ratio"]), ada_type=m["ada_type"],
        loss_func=t["loss_func"], seed=int(t["seed"]),
        batch_size=int(t["batch_size"]), epochs=int(t["epochs"]),
        lr_init=float(t["lr_init"]), lr_decay=_parse_bool(t["lr_decay"]),
        lr_decay_rate=float(t["lr_decay_rate"]),
        lr_decay_step=_parse_int_list(t["lr_decay_step"]),
        early_stop=_parse_bool(t["early_stop"]),
        early_stop_patience=int(t["early_stop_patience"]),
        change_epoch=int(t["change_epoch"]),
        up_epoch=_parse_int_list(t["up_epoch"]),
        grad_norm=_parse_bool(t["grad_norm"]),
        max_grad_norm=float(t["max_grad_norm"]),
        debug=_parse_bool(t["debug"]), real_value=_parse_bool(t["real_value"]),
        seed_mode=_parse_bool(t["seed_mode"]), xavier=_parse_bool(t["xavier"]),
        load_pretrain_path=t["load_pretrain_path"],
        save_pretrain_path=t["save_pretrain_path"],
        mae_thresh=_parse_optional_float(te["mae_thresh"]),
        mape_thresh=float(te["mape_thresh"]),
        log_step=int(lg["log_step"]),
    )
    return cfg.replace(**overrides) if overrides else cfg


# Per-dataset [model]/[train] deltas from conf/GPTST_pretrain/*.conf.
_DATASET_DELTAS: dict[str, dict] = {
    "PEMS08": dict(ada_type="all", ada_mask_ratio=0.5, seed=12,
                   lr_decay=True, early_stop_patience=100),
    "METR_LA": dict(ada_type="half", ada_mask_ratio=0.5, seed=0,
                    lr_decay=True, early_stop_patience=100),
    "NYC_BIKE": dict(ada_type="all", ada_mask_ratio=1.0, seed=12,
                     lr_decay=False, early_stop_patience=80),
    "NYC_TAXI": dict(ada_type="all", ada_mask_ratio=1.0, seed=12,
                     lr_decay=False, early_stop_patience=80),
}


# Shared downstream [train] block from
# `conf/GPTST_pretrain/params_predictors.conf` — applied in non-pretrain
# modes before the per-model overrides (`lib/Params_predictor.py:6-23`).
_DOWNSTREAM_TRAIN_DEFAULTS: dict = dict(
    batch_size=64, epochs=100, lr_init=3e-3, lr_decay=True,
    lr_decay_rate=0.3, lr_decay_step=(25, 50, 75), early_stop=True,
    early_stop_patience=25, change_epoch=0, grad_norm=True,
    max_grad_norm=5.0, debug=False, real_value=False, seed_mode=True,
    seed=12, xavier=False, loss_func="mask_mae",
)

# Per-predictor [train] overrides from `conf/<MODEL>/*.conf`. In the
# reference, predictor args override framework args for overlapping
# names in non-pretrain modes (`model/Run.py:37-43`) — this table is
# that merge, made explicit (full transcription of every shipped
# conf's [train] section).
PREDICTOR_TRAIN_DEFAULTS: dict[str, dict] = {
    "STGCN": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "TGCN": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "MSDR": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "STMGCN": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "CCRNN": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "DMVSTNET": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "ST_WA": dict(seed_mode=True, xavier=False, loss_func="mask_mae"),
    "GWN": dict(seed_mode=False, xavier=False, loss_func="mask_mae"),
    "MTGNN": dict(seed_mode=False, xavier=False, loss_func="mask_mae"),
    "ASTGCN": dict(seed_mode=True, xavier=True, loss_func="mask_mae"),
    "STSGCN": dict(seed_mode=True, xavier=False, loss_func="mask_huber"),
    "STFGNN": dict(seed_mode=False, xavier=False, loss_func="mask_huber"),
    "STGODE": dict(seed_mode=False, xavier=True, loss_func="mask_huber"),
}

# Per-(model, dataset) seeds where `conf/<MODEL>/<DATASET>.conf` departs
# from the rule "METR_LA -> 0, else 12".
_PREDICTOR_SEED_EXCEPTIONS: dict[tuple[str, str], int] = {
    ("ASTGCN", "NYC_TAXI"): 52,
    ("GWN", "PEMS08"): 13,
    ("ST_WA", "PEMS08"): 11,
    ("ST_WA", "NYC_BIKE"): 0,
    ("STSGCN", "NYC_BIKE"): 0,
}


def predictor_train_overrides(model: str, dataset: str) -> dict:
    """The effective [train] namespace a predictor contributes in
    non-pretrain modes (the `model/Run.py:37-43` merge)."""
    out = dict(PREDICTOR_TRAIN_DEFAULTS.get(model, {}))
    if out:
        out["seed"] = _PREDICTOR_SEED_EXCEPTIONS.get(
            (model, dataset), 0 if dataset == "METR_LA" else 12)
    return out


def default_config(dataset: str, mode: str = "ori",
                   model: str = "STGCN", **overrides) -> FrameworkConfig:
    """Built-in defaults mirroring `conf/GPTST_pretrain/<dataset>.conf`
    plus, for non-pretrain modes, the shared downstream train block and
    the per-model conf overrides."""
    spec = get_dataset_spec(dataset)
    base = dict(
        dataset=dataset, mode=mode, model=model,
        num_nodes=spec.num_nodes, input_base_dim=spec.input_base_dim,
        output_dim=spec.input_base_dim,
        val_ratio=spec.val_ratio, test_ratio=spec.test_ratio,
        mae_thresh=spec.mae_thresh, mape_thresh=spec.mape_thresh,
    )
    base.update(_DATASET_DELTAS[dataset])
    if mode != "pretrain":
        base.update(_DOWNSTREAM_TRAIN_DEFAULTS)
        base.update(predictor_train_overrides(model, dataset))
    base.update(overrides)
    return FrameworkConfig(**base)
