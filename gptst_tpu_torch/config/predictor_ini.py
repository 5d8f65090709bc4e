"""Reference-format predictor INI ingestion.

Counterpart of `lib/Params_predictor.py` + the per-model `args.py`
parsers: reads `conf/<MODEL>/<DATASET>.conf` [model] sections and maps
them onto our predictor config dataclasses, so the reference's shipped
configs drive this framework 1:1. Keys that configure behavior we
intentionally dropped (dead code, trainer-level settings handled by
`PREDICTOR_TRAIN_DEFAULTS`) are ignored.
"""

from __future__ import annotations

import ast
import configparser
import dataclasses
import os
from typing import Any

# conf-key -> dataclass-field renames (identity mapping otherwise)
_KEY_MAPS: dict[str, dict[str, str]] = {
    "STGCN": {"Ks": "ks", "Kt": "kt"},
    "MTGNN": {"buildA_true": "build_adj"},
    "STFGNN": {},
    "STSGCN": {},
    "ASTGCN": {},
    "TGCN": {},
    "GWN": {},
    "STGODE": {},
    "MSDR": {"num_rnn_layers": "num_rnn_layers"},
    "ST_WA": {},
    "CCRNN": {"n_dim": "n_dim", "hidden_size": "hidden_size"},
    "STMGCN": {"lstm_hidden_dim": "lstm_hidden_dim"},
}

# reference conf directory name per model
_CONF_DIRS = {
    "ST_WA": "ST-WA", "CCRNN": "CCRNN_demand", "STMGCN": "STMGCN_demand",
    "DMVSTNET": "DMVSTNET_demand",
}


def _coerce(value: str, target: Any) -> Any:
    s = value.strip()
    if isinstance(target, bool):
        return s.lower() in ("true", "1", "yes")
    if isinstance(target, int):
        return int(float(s))
    if isinstance(target, float):
        return float(s)
    if isinstance(target, tuple):
        parsed = ast.literal_eval(s)
        return tuple(tuple(p) if isinstance(p, list) else p for p in parsed)
    return s


def load_predictor_overrides(model: str, dataset: str, conf_root: str,
                             config_cls) -> dict:
    """Parse `conf/<MODEL>/<DATASET>.conf` [model] into dataclass
    overrides for `config_cls`. Missing file -> {} (builders keep their
    built-in defaults, which mirror the same confs)."""
    path = os.path.join(conf_root, _CONF_DIRS.get(model, model),
                        f"{dataset}.conf")
    cp = configparser.ConfigParser()
    cp.optionxform = str  # preserve case (Ks, K, buildA_true, ...)
    if not cp.read(path) or "model" not in cp:
        return {}
    fields = {f.name: f for f in dataclasses.fields(config_cls)}
    defaults = config_cls(num_nodes=1)
    key_map = _KEY_MAPS.get(model, {})
    out = {}
    for key, raw in cp["model"].items():
        name = key_map.get(key, key)
        if name in fields and name != "num_nodes":
            out[name] = _coerce(raw, getattr(defaults, name))
    return out
