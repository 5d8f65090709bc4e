"""Experiment CLI — the port's counterpart of `gptst_tpu.run`.

Usage:

  python -m gptst_tpu_torch.run -dataset PEMS08 -mode pretrain
  python -m gptst_tpu_torch.run -dataset PEMS08 -mode eval -model TGCN
  python -m gptst_tpu_torch.run -dataset PEMS08 -mode test -model TGCN
  python -m gptst_tpu_torch.run -dataset PEMS08 -mode ori -model MSDR
  python -m gptst_tpu_torch.run -dataset PEMS08 -mode ori -model GWN
  python -m gptst_tpu_torch.run -dataset PEMS08 -mode ori -model MTGNN
  python -m gptst_tpu_torch.run -dataset NYC_BIKE -mode ori -model CCRNN
  python -m gptst_tpu_torch.run -dataset PEMS08 -mode ori -model ST_WA
  python -m gptst_tpu_torch.run -dataset NYC_BIKE -mode ori -model DMVSTNET
  python -m gptst_tpu_torch.run ... -device cpu      # no card needed

Single-hyphen flags override the framework config (any FrameworkConfig
field); the predictor's config fields are `--flags`. Extras:
`-num_steps` limits the synthetic dataset length, `-data_root` points
at real `.npz` files (and at a `PEMS08/PEMS08.npz` of any node count,
the way to train above the dataset's own node count), `-device` picks
the device (default `cuda`; raises when no card is present),
`-metrics_out` writes the final report as JSON, `-use_mesh` (default
True) trains data-parallel over a (data, graph) mesh of every visible
card when there are several (`-graph_axis_size` its graph axis, 0 for
the default split, as in the JAX CLI; one card or `-device cpu` builds
none), `-resume True`
restarts from `<log_dir>/<dataset>/full_ckpt.pt` (written every
`-ckpt_every_epochs` epochs), `-profile_dir` writes a `torch.profiler`
Chrome trace of the training there, and `-device_seed` is parsed and
unused, as in the JAX package.

Flow: config -> seed -> dataset -> model -> trainer. The predictors
are STGCN (the default `-model`), TGCN, MSDR (above 4096 nodes MSDR's
learned adjacency is sparse: `kernels/sddmm.adaptive_support`), GWN
(`--aptonly False` adds its static supports), MTGNN, CCRNN, STMGCN,
ASTGCN, STSGCN, STFGNN, STGODE (STFGNN's and STGODE's DTW graphs are
built on the host, `graph/dtw.py`, and cached under `./.gptst_cache`),
ST_WA and DMVSTNET. The test report hands the model a generator seeded
with `seed + 777` in every mode, as the JAX trainer hands it a key: GWN's
and MTGNN's dropout and ST_WA's latent draws run at test.
Files, under `<log_dir>/<dataset>/`:
  * `-mode pretrain` (GPT-ST; `-model` is not read) writes the best
    GPT-ST parameters with `torch.save(state_dict)` to
    `<save_pretrain_path>` (default `gptst_pretrain.ckpt`; keys in
    `models/gptst.py`'s docstring);
  * `-mode eval` reads `<load_pretrain_path>` into the frozen encoder
    and, like `ori`, writes `best_model.pt` (eval: `head.*` and
    `predictor.*` keys, no encoder);
  * `-mode test` reads `best_model.pt` and rebuilds the model it holds
    (`checkpoint_is_enhanced`: eval semantics, the pretrain checkpoint
    read again, or ori semantics), then reports on the test split.
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
    p.add_argument("-resume", default="False",
                   help="resume from <log_dir>/<dataset>/full_ckpt.pt "
                        "(written every -ckpt_every_epochs epochs)")
    p.add_argument("-device_seed", type=int, default=None)
    p.add_argument("-profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the training "
                        "here")
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


def _pretrain_ckpt_path(cfg, save: bool) -> str:
    name = cfg.save_pretrain_path if save else cfg.load_pretrain_path
    return os.path.abspath(os.path.join(cfg.log_dir, cfg.dataset, name))


def checkpoint_is_enhanced(path: str) -> bool:
    """True when the `best_model.pt` at `path` holds an eval-mode
    (enhanced) model, its keys `head.*` and `predictor.*`; False when
    it holds a bare predictor or is missing. Only the saved dict is
    read (memory-mapped), no model is built. The reference's `-mode
    test` breaks for eval-trained models (`model/Model.py:40-44`); this
    tells `main` to rebuild the frozen-encoder model instead."""
    import torch

    if not os.path.isfile(path):
        return False
    keys = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True).keys()
    return (any(k.startswith("head.") for k in keys)
            and any(k.startswith("predictor.") for k in keys))


def load_pretrain_params(cfg, scaler_zeros: float, device="cuda"):
    """The pretrained GPT-ST for eval mode (`model/Model.py:95-98`): a
    strict `load_state_dict` of `<log_dir>/<dataset>/<load_pretrain_path>`
    into `build_pretrain(cfg.replace(mode="pretrain"))`'s GPT-ST."""
    import torch

    from gptst_tpu_torch.models.build import build_pretrain

    net = build_pretrain(cfg.replace(mode="pretrain"), scaler_zeros,
                         device).gptst
    path = _pretrain_ckpt_path(cfg, save=False)
    net.load_state_dict(torch.load(path, map_location=net.neb4mask.device,
                                   weights_only=True), strict=True)
    return net


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


def mesh_devices(device) -> list:
    """The devices a CLI mesh may span: every visible CUDA device for a
    run on the card, only `device` itself otherwise (a CPU run builds no
    mesh, as the JAX CLI builds none for one device)."""
    import torch

    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def main(argv: Optional[list[str]] = None) -> int:
    ns = parse_args(argv)
    cfg = make_config(ns)

    from gptst_tpu_torch.data import build_dataset
    from gptst_tpu_torch.models.build import build_model
    from gptst_tpu_torch.train import Trainer
    from gptst_tpu_torch.utils.device import resolve_device
    from gptst_tpu_torch.utils.logger import get_logger
    from gptst_tpu_torch.utils.observability import (
        count_parameters, init_determinism, profile_trace,
    )

    device = resolve_device(ns.device)
    prec = set_precision(cfg)
    logger = get_logger("run", debug=cfg.debug)
    logger.info("dataset=%s mode=%s model=%s device=%s precision=%s",
                cfg.dataset, cfg.mode, cfg.model, device, prec)

    # several cards: a (data, graph) mesh over all of them, the batch
    # over 'data' and the node axis of the graph supports over 'graph'
    # (`parallel/spmd.py`); the parameters live on its root
    mesh = None
    devices = mesh_devices(device)
    if cfg.use_mesh and len(devices) > 1:
        from gptst_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=devices,
                         graph_axis_size=cfg.graph_axis_size or None)
        device = mesh.root
        logger.info("device mesh: %s", dict(mesh.shape))

    init_determinism(cfg.seed, cfg.seed_mode)
    ds = build_dataset(cfg, data_root=cfg.data_root, num_steps=ns.num_steps,
                       seed=cfg.seed)
    log_dir = os.path.join(cfg.log_dir, cfg.dataset)
    best_path = os.path.join(log_dir, "best_model.pt")
    # `-mode test` rebuilds what best_model.pt holds: the enhanced model
    # (which needs the pretrain checkpoint) or the bare predictor
    build_cfg = cfg
    if cfg.mode == "test":
        build_cfg = cfg.replace(
            mode="eval" if checkpoint_is_enhanced(best_path) else "ori")
    pretrain = None
    if build_cfg.mode == "eval":
        pretrain = load_pretrain_params(cfg, ds.scaler_zeros, device)
    model = build_model(build_cfg, device=device, seed=cfg.seed,
                        scaler_zeros=ds.scaler_zeros,
                        pretrain_params=pretrain, mesh=mesh)
    count_parameters(model, logger)

    os.makedirs(log_dir, exist_ok=True)
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 log_dir=log_dir, device=device, mesh=mesh)
    logger.info("train split: %s", tr.split_layout())
    if cfg.mode == "test":
        tr.load_checkpoint(best_path)
        report = tr.test()
        if ns.metrics_out:
            with open(ns.metrics_out, "w") as f:
                json.dump(report, f)
        return 0
    resume = str(ns.resume).strip().lower() in ("true", "1", "yes")
    with profile_trace(ns.profile_dir):
        result = tr.train(resume=resume)
    if cfg.mode == "pretrain":
        import torch

        path = _pretrain_ckpt_path(cfg, save=True)
        torch.save(model.gptst.state_dict(), path)
        logger.info("Saved the pretrained GPT-ST to %s", path)
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
