"""Carry weights between the JAX package's flax trees and the port's
`state_dict`s, for TGCN and MSDR (told apart by the tree's keys).

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

Recurrent weights keep flax's (in, out) layout (the cells compute
`x @ W`); Dense kernels are transposed into `nn.Linear.weight`. Keys of
the returned state dict are those of `TGCN` / `MSDR`; pass `prefix` for
a wrapping module's keys.
"""

from __future__ import annotations

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


def flax_to_state_dict(params: dict, prefix: str = "") -> dict:
    p = params.get("params", params)
    if "enc_mlp" in p:
        sd = _msdr_to_state_dict(p)
    else:
        sd = {f"cell.{k}": _t(p[_CELL][k]) for k in _GRU}
        sd.update(_dense_to_linear(p["Dense_0"], "dense"))
    return {prefix + k: v for k, v in sd.items()}


def state_dict_to_flax(sd: dict, prefix: str = "",
                       chunked: bool = False) -> dict:
    """The flax tree of a TGCN or MSDR state dict; `chunked` nests
    MSDR's cells as the chunked-remat layout does."""
    sd = {k[len(prefix):]: v.detach().cpu().numpy()
          for k, v in sd.items() if k.startswith(prefix)}

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
