"""Carry weights between the JAX package's flax trees and the port's
`state_dict`s, for TGCN, MSDR and GPT-ST (told apart by the tree's
keys).

TGCN's flax tree (numpy arrays):
  {'params': {'ScanGraphGRUCell_0': {'weights_0': (D+U, 2U), 'bias_0',
                                     'weights_1': (D+U, U), 'bias_1'},
              'Dense_0': {'kernel': (U, H*D_out), 'bias'}}}

MSDR's:
  {'params': {'enc_mlp': {'kernel', 'bias'},
              'nodevec1_enc0': (N, r), 'nodevec2_enc0': (r, N), ...
              (one pair per encoder and decoder layer),
              'encoder': {'cell0': {'gconv_w', 'gconv_b', 'W', 'b', 'R',
                                    'att_w', 'att_b'}, ...},
              'decoder': {...},
              'projection': {'kernel', 'bias'}}}
With chunked remat ("full"/"dots") the cells sit one level deeper, at
`encoder/seg/cell{i}`; `flax_to_state_dict` reads both layouts and
`state_dict_to_flax(..., chunked=True)` writes the deeper one.

GPT-ST's tree (`models/gptst.py`'s docstring lists the port's keys) is
renamed scope by scope: `Dense_k` <-> `dense.k`, `HyperTem_k` <->
`hyper_tem.k`, `Cap_k` <-> `cap.k`, `TimeFeature_k` <->
`time_feature.k`, `TimeFeatureSPG_0` <-> `time_feature_spg`; every other
name is the same. Trunk remat (`pretrain_remat` full/dots) gives the
same flax tree as none (the JAX package's `remat_cell` keeps the class
names), so one mapping serves both.

Recurrent weights keep flax's (in, out) layout (the cells compute
`x @ W`); Dense kernels are transposed into `nn.Linear.weight`. Keys of
the returned state dict are those of `TGCN` / `MSDR`; pass `prefix` for
a wrapping module's keys.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_CELL = "ScanGraphGRUCell_0"
_GRU = ("weights_0", "bias_0", "weights_1", "bias_1")
_MSDR_CELL = ("gconv_w", "gconv_b", "W", "b", "R", "att_w", "att_b")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _dense_to_linear(d: dict, key: str) -> dict:
    return {f"{key}.weight": _t(np.asarray(d["kernel"]).T),
            f"{key}.bias": _t(d["bias"])}


def _msdr_to_state_dict(p: dict) -> dict:
    sd = {**_dense_to_linear(p["enc_mlp"], "enc_mlp"),
          **_dense_to_linear(p["projection"], "projection")}
    for k, v in p.items():
        if k.startswith("nodevec"):
            sd[k] = _t(v)
    for scope in ("encoder", "decoder"):
        cells = p[scope].get("seg", p[scope])
        for name, cell in cells.items():
            i = int(name.removeprefix("cell"))
            sd.update({f"{scope}.{i}.{k}": _t(cell[k]) for k in _MSDR_CELL})
    return sd


_GPTST_SCOPES = {"Dense": "dense", "HyperTem": "hyper_tem", "Cap": "cap",
                 "TimeFeature": "time_feature"}
_FLAX_SCOPES = {v: k for k, v in _GPTST_SCOPES.items()}
_SPG = ("TimeFeatureSPG_0", "time_feature_spg")


def _gptst_key(path: tuple[str, ...]) -> str:
    """The port's key of a flax GPT-ST leaf path."""
    out = []
    for name in path[:-1]:
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
        if name == _SPG[0]:
            out.append(_SPG[1])
        elif m and m[1] in _GPTST_SCOPES:
            out += [_GPTST_SCOPES[m[1]], m[2]]
        else:
            out.append(name)
    return ".".join(out + ["weight" if path[-1] == "kernel" else path[-1]])


def _gptst_path(key: str) -> list[str]:
    """The flax leaf path of a port GPT-ST key (`_gptst_key`'s inverse)."""
    parts, out, i = key.split("."), [], 0
    while i < len(parts) - 1:
        if parts[i] == _SPG[1]:
            out.append(_SPG[0])
        elif parts[i] in _FLAX_SCOPES:
            out.append(f"{_FLAX_SCOPES[parts[i]]}_{parts[i + 1]}")
            i += 1
        else:
            out.append(parts[i])
        i += 1
    return out + ["kernel" if parts[-1] == "weight" else parts[-1]]


def _gptst_to_state_dict(p: dict, path: tuple[str, ...] = ()) -> dict:
    sd = {}
    for k, v in p.items():
        if isinstance(v, dict):
            sd.update(_gptst_to_state_dict(v, path + (k,)))
        else:
            a = np.asarray(v)
            sd[_gptst_key(path + (k,))] = _t(a.T if k == "kernel" else a)
    return sd


def _gptst_to_flax(sd: dict) -> dict:
    p: dict = {}
    for k, v in sd.items():
        *scopes, leaf = _gptst_path(k)
        d = p
        for name in scopes:
            d = d.setdefault(name, {})
        d[leaf] = v.T.copy() if leaf == "kernel" else v
    return {"params": p}


def flax_to_state_dict(params: dict, prefix: str = "") -> dict:
    p = params.get("params", params)
    if "dim_in_flow" in p:
        sd = _gptst_to_state_dict(p)
    elif "enc_mlp" in p:
        sd = _msdr_to_state_dict(p)
    else:
        sd = {f"cell.{k}": _t(p[_CELL][k]) for k in _GRU}
        sd.update(_dense_to_linear(p["Dense_0"], "dense"))
    return {prefix + k: v for k, v in sd.items()}


def state_dict_to_flax(sd: dict, prefix: str = "",
                       chunked: bool = False) -> dict:
    """The flax tree of a TGCN, MSDR or GPT-ST state dict; `chunked`
    nests MSDR's cells as the chunked-remat layout does."""
    sd = {k[len(prefix):]: v.detach().cpu().numpy()
          for k, v in sd.items() if k.startswith(prefix)}
    if "dim_in_flow.weight" in sd:
        return _gptst_to_flax(sd)

    def dense(key):
        return {"kernel": sd[f"{key}.weight"].T.copy(),
                "bias": sd[f"{key}.bias"]}

    if "enc_mlp.weight" not in sd:
        return {"params": {_CELL: {k: sd[f"cell.{k}"] for k in _GRU},
                           "Dense_0": dense("dense")}}
    p = {"enc_mlp": dense("enc_mlp"), "projection": dense("projection")}
    p.update({k: v for k, v in sd.items() if k.startswith("nodevec")})
    for scope in ("encoder", "decoder"):
        cells: dict = {}
        for k, v in sd.items():
            if k.startswith(scope + "."):
                _, i, name = k.split(".")
                cells.setdefault(f"cell{i}", {})[name] = v
        p[scope] = {"seg": cells} if chunked else cells
    return {"params": p}
