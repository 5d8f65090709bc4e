"""Experiment CLI — the port's counterpart of `gptst_tpu.run`.

Usage:

  python -m gptst_tpu_torch.run -dataset PEMS08 -mode ori -model TGCN
  python -m gptst_tpu_torch.run ... -device cpu      # no card needed

Single-hyphen flags override the framework config (any FrameworkConfig
field); the predictor's config fields are `--flags`. Extras:
`-num_steps` limits the synthetic dataset length, `-data_root` points
at real `.npz` files (and at a `PEMS08/PEMS08.npz` of any node count,
the way to train above the dataset's own node count), `-device` picks
the device (default `cuda`; raises when no card is present) and
`-metrics_out` writes the final report as JSON.

Flow: config -> seed -> dataset -> model -> trainer. The port runs
`-mode ori` with TGCN; other modes and predictors raise
`NotImplementedError` naming the slice they wait for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Optional


def parse_args(argv: Optional[list[str]] = None):
    from gptst_tpu_torch.config.config import FrameworkConfig
    from gptst_tpu_torch.models.build import predictor_config_class

    p = argparse.ArgumentParser(
        prog="gptst_tpu_torch.run", prefix_chars="-",
        description="GPT-ST framework CLI (PyTorch/CUDA port)")
    p.add_argument("-dataset", default="PEMS08")
    p.add_argument("-mode", default="ori",
                   choices=["ori", "eval", "pretrain", "test"])
    p.add_argument("-model", default="STGCN")
    p.add_argument("-num_steps", type=int, default=None,
                   help="truncate dataset length (synthetic fallback)")
    p.add_argument("-device", default="cuda",
                   help="torch device to run on (cuda | cpu)")
    p.add_argument("-metrics_out", type=str, default=None,
                   help="write the final test report (per-horizon + "
                        "average MAE/RMSE/MAPE/CORR) to this JSON file")
    # every FrameworkConfig field becomes an override flag
    fw_names = set()
    for f in dataclasses.fields(FrameworkConfig):
        if f.name in ("dataset", "mode", "model", "predictor_overrides"):
            continue
        fw_names.add(f.name)
        p.add_argument(f"-{f.name}", f"--{f.name}", default=None, type=str)
    # every field of the selected predictor's config becomes a `--flag`;
    # framework names win collisions
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-model", "--model", default="STGCN")
    known, _ = pre.parse_known_args(argv)
    pred_fields: list[str] = []
    cls = predictor_config_class(known.model)
    if cls is not None:
        for f in dataclasses.fields(cls):
            if f.name in fw_names or f.name == "num_nodes":
                continue
            p.add_argument(f"--{f.name}", dest=f"pred_{f.name}",
                           default=None, type=str)
            pred_fields.append(f.name)
    ns = p.parse_args(argv)
    ns.pred_fields = pred_fields
    return ns


def make_config(ns: argparse.Namespace):
    from gptst_tpu_torch.config.config import FrameworkConfig, default_config

    cfg = default_config(ns.dataset, mode=ns.mode, model=ns.model)
    pred_ov = tuple(
        (name, str(getattr(ns, f"pred_{name}")))
        for name in getattr(ns, "pred_fields", ())
        if getattr(ns, f"pred_{name}", None) is not None)
    if pred_ov:
        cfg = cfg.replace(predictor_overrides=pred_ov)
    overrides: dict[str, Any] = {}
    for f in dataclasses.fields(FrameworkConfig):
        v = getattr(ns, f.name, None)
        if f.name in ("dataset", "mode", "model",
                      "predictor_overrides") or v is None:
            continue
        # parse strings into the field's type
        ft = str(f.type)
        if "bool" in ft:
            overrides[f.name] = str(v).strip().lower() in ("true", "1", "yes")
        elif "int" in ft and "Sequence" not in ft:
            overrides[f.name] = int(v)
        elif "float" in ft:
            overrides[f.name] = None if str(v).lower() == "none" else float(v)
        elif "Sequence" in ft:
            overrides[f.name] = tuple(
                int(i) for i in str(v).split(",") if i.strip())
        else:
            overrides[f.name] = v
    return cfg.replace(**overrides)


def set_precision(cfg) -> str:
    """True-f32 matmuls for f32 runs (`matmul_precision` "auto" ->
    "highest", as the JAX package resolves it): TF32 off for both
    matmuls and cuDNN convolutions."""
    import torch

    prec = cfg.matmul_precision
    if prec == "auto":
        prec = "highest" if cfg.compute_dtype == "float32" else "high"
    torch.set_float32_matmul_precision(prec)
    tf32 = prec != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return prec


def main(argv: Optional[list[str]] = None) -> int:
    ns = parse_args(argv)
    cfg = make_config(ns)

    from gptst_tpu_torch.data import build_dataset
    from gptst_tpu_torch.models.build import build_model
    from gptst_tpu_torch.train import Trainer
    from gptst_tpu_torch.utils.device import resolve_device
    from gptst_tpu_torch.utils.logger import get_logger
    from gptst_tpu_torch.utils.observability import (
        count_parameters, init_determinism,
    )

    device = resolve_device(ns.device)
    prec = set_precision(cfg)
    logger = get_logger("run", debug=cfg.debug)
    logger.info("dataset=%s mode=%s model=%s device=%s precision=%s",
                cfg.dataset, cfg.mode, cfg.model, device, prec)

    init_determinism(cfg.seed, cfg.seed_mode)
    ds = build_dataset(cfg, data_root=cfg.data_root, num_steps=ns.num_steps,
                       seed=cfg.seed)
    model = build_model(cfg, device=device, seed=cfg.seed)
    count_parameters(model, logger)

    log_dir = os.path.join(cfg.log_dir, cfg.dataset)
    os.makedirs(log_dir, exist_ok=True)
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 log_dir=log_dir, device=device)
    result = tr.train()
    logger.info("best loss: %.6f  avg MAE: %.4f", result["best_loss"],
                result["report"]["average"][0])
    if ns.metrics_out:
        with open(ns.metrics_out, "w") as f:
            json.dump(dict(result["report"], best_loss=result["best_loss"],
                           history=result["history"],
                           epoch_seconds=result["epoch_seconds"],
                           steps_per_epoch=result["steps_per_epoch"]), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
