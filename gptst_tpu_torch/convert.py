"""Carry weights between the JAX package's flax trees and the port's
`state_dict`s, for TGCN, MSDR, STGCN, GPT-ST, GWN, MTGNN, CCRNN, STMGCN,
ASTGCN, STSGCN, STFGNN, STGODE, ST_WA, DMVSTNET and the eval-mode
(enhanced) model (told apart by the tree's keys).

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

STGCN's tree is renamed scope by scope as `models/predictors/stgcn.py`'s
docstring lists: `STConvBlock_i` <-> `block{i}`, `OutputLayer_0` <->
`output`, `TemporalConv_j` <-> `tconv{j}` (its `Conv_0` kernel and bias
sit on the tconv itself, in flax's (kt, 1, C_in, C_out) layout),
`SpatioConvLayer_0` <-> `sconv`, `LayerNorm_0` <-> `norm` (`scale` <->
`weight`), `Dense_0` <-> `proj` (`dense` in the output layer).

The eval-mode (enhanced) tree `{"head": {"params": {"Dense_0",
"Fusion_0": {"Dense_0", "Dense_1", "Dense_2"}}}, "predictor": <a
predictor's tree>}` maps to `EnhancedModel`'s keys: `head.proj`,
`head.fusion.dense.{0,1,2}` and `predictor.net.<the predictor's keys>`.

GWN's, MTGNN's, CCRNN's, STMGCN's, ASTGCN's, STSGCN's, STFGNN's,
STGODE's, ST_WA's and DMVSTNET's trees are renamed by the path rules of
`_RULES` (the modules' docstrings list their keys): flax scopes such as
`DilatedCausal_j/Conv_0` <-> `dilated.j`, `Dense_k` <-> `dense.k`,
`Scan_EncoderStep_0` <-> `encoder`, ST_WA's `layer{l}/tpg{i}/wgen_{k}`
<-> `layers.{l}.tpg.{i}.wgen.{k}`. A Dense `kernel` (in, out) becomes
an `nn.Linear` `weight` (out, in); a Conv `kernel` (kt, 1, in, out) a
`TimeConv` `weight` (out, in, kt, 1); raw parameters (`gconv_w_*`,
`mixprop*`, `nodevec*`, `w1`, ...) and norm parameters keep their names
and layouts. STMGCN's `OptimizedLSTMCell_{l}` (`ii`..`io` kernels
(D, h), `hi`..`ho` kernels (h, h) and biases) becomes one `LSTMCell`
(`weight_ih` (4h, D), `weight_hh` (4h, h), `bias_hh` (4h,), gates i,
f, g, o), and back; so does DMVSTNET's `OptimizedLSTMCell_0`
(`lstm`). ASTGCN's `LayerNorm_0` `scale` is the port's norm `weight`.
STGODE's TCN convs that the forward discards are carried both ways like
the others.

Recurrent weights keep flax's (in, out) layout (the cells compute
`x @ W`); Dense kernels are transposed into `nn.Linear.weight`. Keys of
the returned state dict are those of `TGCN` / `MSDR` / `STGCN` /
`GPTST` / `EnhancedModel`; pass `prefix` for a wrapping module's keys.
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




_STGCN_SCOPES = {"STConvBlock": "block", "TemporalConv": "tconv"}
_STGCN_NAMES = {"OutputLayer_0": "output", "SpatioConvLayer_0": "sconv",
                "LayerNorm_0": "norm"}


def _stgcn_key(path: tuple[str, ...]) -> tuple[str, bool]:
    """The port's key of a flax STGCN leaf path, and whether the leaf is
    a Dense kernel (transposed into `nn.Linear.weight`)."""
    out, leaf = [], path[-1]
    for i, name in enumerate(path[:-1]):
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
        if name in _STGCN_NAMES:
            out.append(_STGCN_NAMES[name])
        elif m[1] in _STGCN_SCOPES:
            out.append(_STGCN_SCOPES[m[1]] + m[2])
        elif m[1] == "Dense":
            out.append("dense" if path[i - 1] == "OutputLayer_0"
                       else "proj")
        # Conv_0: its kernel and bias sit on the TemporalConv itself
    dense_kernel = out[-1] in ("proj", "dense") and leaf == "kernel"
    if dense_kernel or leaf == "scale":
        leaf = "weight"
    return ".".join(out + [leaf]), dense_kernel


def _stgcn_path(key: str) -> list[str]:
    """The flax leaf path of a port STGCN key (`_stgcn_key`'s inverse)."""
    names = {v: k for k, v in _STGCN_NAMES.items()}
    *scopes, leaf = key.split(".")
    out = []
    for name in scopes:
        m = re.fullmatch(r"(block|tconv)(\d+)", name)
        if m:
            flax = {v: k for k, v in _STGCN_SCOPES.items()}[m[1]]
            out.append(f"{flax}_{m[2]}")
        elif name in ("proj", "dense"):
            out.append("Dense_0")
        else:
            out.append(names[name])
    if scopes[-1].startswith("tconv"):
        out.append("Conv_0")
    elif scopes[-1] == "norm" and leaf == "weight":
        leaf = "scale"
    elif scopes[-1] in ("proj", "dense") and leaf == "weight":
        leaf = "kernel"
    return out + [leaf]


def _stgcn_to_state_dict(p: dict, path: tuple[str, ...] = ()) -> dict:
    sd = {}
    for k, v in p.items():
        if isinstance(v, dict):
            sd.update(_stgcn_to_state_dict(v, path + (k,)))
        else:
            key, transpose = _stgcn_key(path + (k,))
            a = np.asarray(v)
            sd[key] = _t(a.T if transpose else a)
    return sd


def _nested(sd: dict, path_of, transpose) -> dict:
    """A flax tree from port keys: `path_of(key)` gives the leaf path,
    `transpose(path)` whether the leaf is a Dense kernel."""
    p: dict = {}
    for k, v in sd.items():
        *scopes, leaf = path = path_of(k)
        d = p
        for name in scopes:
            d = d.setdefault(name, {})
        d[leaf] = v.T.copy() if transpose(path) else v
    return {"params": p}


def _head_to_state_dict(p: dict) -> dict:
    sd = _dense_to_linear(p["Dense_0"], "proj")
    for i in range(3):
        sd.update(_dense_to_linear(p["Fusion_0"][f"Dense_{i}"],
                                   f"fusion.dense.{i}"))
    return sd


# (flax leaf path, port key) templates of each model, tried in order.
# `{leaf}` is a Dense or Conv leaf (`kernel` <-> `weight`, with the
# layout change), `{p}` a leaf kept as it is; `{i}`, `{j}`, `{k}` are
# indices, `{a}`, `{b}` names and `{g}` a name of letters alone.
_RULES = {
    "GWN": (("DilatedCausal_{i}/Conv_0/{leaf}", "dilated.{i}.{leaf}"),
            ("Dense_{i}/{leaf}", "dense.{i}.{leaf}"),
            ("BatchStatsNorm_{i}/{p}", "norm.{i}.{p}"),
            ("{a}/{leaf}", "{a}.{leaf}"),
            ("{p}", "{p}")),
    "MTGNN": (("gc/{a}/{leaf}", "gc.{a}.{leaf}"),
              ("gc/{p}", "gc.{p}"),
              ("DilatedInception_{i}/Conv_{j}/{leaf}",
               "inception.{i}.conv.{j}.{leaf}"),
              ("Conv_{i}/{leaf}", "skips.{i}.{leaf}"),
              ("Dense_{i}/{leaf}", "dense.{i}.{leaf}"),
              ("NodeLayerNorm_{i}/{p}", "norm.{i}.{p}"),
              ("{a}/{leaf}", "{a}.{leaf}"),
              ("{p}", "{p}")),
    "CCRNN": (("Scan_EncoderStep_0/{a}/{b}/{p}/{leaf}",
               "encoder.{a}.{b}.{p}.{leaf}"),
              ("Scan_DecoderStep_0/{a}/{b}/{p}/{leaf}",
               "decoder.{a}.{b}.{p}.{leaf}"),
              ("Scan_DecoderStep_0/{a}/{leaf}", "decoder.{a}.{leaf}"),
              ("{p}", "{p}")),
    "STMGCN": (("cg_lstm{i}/OptimizedLSTMCell_{j}/{p}",
                "cg_lstm.{i}.lstm.{j}.{p}"),
               ("cg_lstm{i}/gconv_temporal/{p}",
                "cg_lstm.{i}.gconv_temporal.{p}"),
               ("cg_lstm{i}/fc/{leaf}", "cg_lstm.{i}.fc.{leaf}"),
               ("gcn{i}/{p}", "gcn.{i}.{p}"),
               ("fc/{leaf}", "fc.{leaf}")),
    "ASTGCN": (("ASTGCNBlock_{i}/TemporalAttention_0/{p}",
                "block.{i}.temporal_att.{p}"),
               ("ASTGCNBlock_{i}/SpatialAttention_0/{p}",
                "block.{i}.spatial_att.{p}"),
               ("ASTGCNBlock_{i}/LayerNorm_0/scale", "block.{i}.norm.weight"),
               ("ASTGCNBlock_{i}/LayerNorm_0/bias", "block.{i}.norm.bias"),
               ("ASTGCNBlock_{i}/{a}/{leaf}", "block.{i}.{a}.{leaf}"),
               ("ASTGCNBlock_{i}/{p}", "block.{i}.{p}"),
               ("{p}", "{p}")),
    "STSGCN": (("SyncLayer_{i}/{p}", "sync_layers.{i}.{p}"),
               ("Dense_{i}/{leaf}", "dense.{i}.{leaf}")),
    "STFGNN": (("FusionLayer_{i}/{a}/{leaf}", "fusion_layers.{i}.{a}.{leaf}"),
               ("FusionLayer_{i}/{p}", "fusion_layers.{i}.{p}"),
               ("Dense_{i}/{leaf}", "dense.{i}.{leaf}"),
               ("{a}/{leaf}", "{a}.{leaf}")),
    "STGODE": (("{a}/TemporalConvNet_{i}/Conv_3/{leaf}",
                "blocks.{a}.tcn.{i}.down.{leaf}"),
               ("{a}/TemporalConvNet_{i}/Conv_{j}/{leaf}",
                "blocks.{a}.tcn.{i}.conv.{j}.{leaf}"),
               ("{a}/ODEG_0/{p}", "blocks.{a}.odeg.{p}"),
               ("{a}/NodeBatchNorm_0/{p}", "blocks.{a}.norm.{p}"),
               ("Dense_{i}/{leaf}", "dense.{i}.{leaf}")),
    "ST_WA": (("layer{i}/{g}{j}/wgen_{k}/{leaf}",
               "layers.{i}.{g}.{j}.wgen.{k}.{leaf}"),
              ("layer{i}/{g}{j}/bgen_{k}/{leaf}",
               "layers.{i}.{g}.{j}.bgen.{k}.{leaf}"),
              ("layer{i}/aggregator_{j}/{leaf}",
               "layers.{i}.aggregator.{j}.{leaf}"),
              ("layer{i}/{g}{j}/{p}", "layers.{i}.{g}.{j}.{p}"),
              ("layer{i}/{a}/{b}/{leaf}", "layers.{i}.{a}.{b}.{leaf}"),
              ("layer{i}/{p}", "layers.{i}.{p}"),
              ("{a}_est_{i}/{leaf}", "{a}_est.{i}.{leaf}"),
              ("skip{i}/{leaf}", "skip.{i}.{leaf}"),
              ("{a}/{leaf}", "{a}.{leaf}")),
    "DMVSTNET": (("OptimizedLSTMCell_0/{p}", "lstm.{p}"),
                 ("{a}/{leaf}", "{a}.{leaf}"),
                 ("{p}", "{p}")),
}
# a key of each model's tree, flax side and port side, tried in order
# (ST_WA's flax tree also holds MTGNN's `skip0`)
_RULE_KEYS = {"ST_WA": ("start_fc", "start_fc.weight"),
              "GWN": ("DilatedCausal_0", "dilated.0.weight"),
              "MTGNN": ("skip0", "skip0.weight"),
              "CCRNN": ("Scan_EncoderStep_0",
                        "encoder.cell0.ru.attlinear.weight"),
              "STMGCN": ("cg_lstm0", "cg_lstm.0.fc.weight"),
              "ASTGCN": ("ASTGCNBlock_0", "block.0.Theta"),
              "STSGCN": ("SyncLayer_0", "sync_layers.0.w0"),
              "STFGNN": ("FusionLayer_0", "fusion_layers.0.w0"),
              "STGODE": ("sp_0_0", "blocks.sp_0_0.odeg.w"),
              "DMVSTNET": ("lin_in_spa", "lin_in_spa.weight")}
# the models whose flax LSTM cells map through `_lstm_to_port`
_LSTM_MODELS = ("STMGCN", "DMVSTNET")
_GATES = ("i", "f", "g", "o")


def _lstm_to_port(cell: dict) -> dict:
    """flax `OptimizedLSTMCell` params -> `LSTMCell`'s, gates stacked
    i, f, g, o on the rows."""
    return {"weight_ih": np.concatenate(
                [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES]),
            "weight_hh": np.concatenate(
                [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]),
            "bias_hh": np.concatenate(
                [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])}


def _lstm_to_flax(cell: dict) -> dict:
    """`_lstm_to_port`'s inverse."""
    w_ih, w_hh, b_hh = (np.split(cell[k], 4) for k in
                        ("weight_ih", "weight_hh", "bias_hh"))
    out = {}
    for g, wi, wh, b in zip(_GATES, w_ih, w_hh, b_hh):
        out[f"i{g}"] = {"kernel": np.ascontiguousarray(wi.T)}
        out[f"h{g}"] = {"kernel": np.ascontiguousarray(wh.T), "bias": b}
    return out


def _map_lstm_cells(p: dict, fn) -> dict:
    """`p` with every `OptimizedLSTMCell_{l}` scope mapped by `fn`."""
    return {k: (fn(v) if k.startswith("OptimizedLSTMCell_")
                else _map_lstm_cells(v, fn) if isinstance(v, dict) else v)
            for k, v in p.items()}


def _template_re(tpl: str, sep: str) -> re.Pattern:
    groups = {"i": r"\d+", "j": r"\d+", "k": r"\d+", "g": r"[A-Za-z]+",
              "a": r"[A-Za-z0-9_]+",
              "b": r"[A-Za-z0-9_]+", "p": r"[A-Za-z0-9_]+",
              "leaf": r"[A-Za-z0-9_]+"}
    pat = re.escape(tpl.replace("/", sep))
    for g, rx in groups.items():
        pat = pat.replace(re.escape("{" + g + "}"), f"(?P<{g}>{rx})")
    return re.compile(pat + "$")


def _rename(path: str, model: str, to_port: bool) -> tuple[str, bool]:
    """The other side's name of `path` ('/'-joined flax path or port
    key), and whether the leaf is a Dense or Conv kernel."""
    src, dst = (0, 1) if to_port else (1, 0)
    for rule in _RULES[model]:
        m = _template_re(rule[src], "/" if to_port else ".").match(path)
        if m is None:
            continue
        g = m.groupdict()
        kernel = "leaf" in g and g["leaf"] == ("kernel" if to_port
                                               else "weight")
        if kernel:
            g["leaf"] = "weight" if to_port else "kernel"
        return rule[dst].replace("/", "." if to_port else "/").format(
            **g), kernel
    raise KeyError(f"{model}: no rule for {path!r}")


def _kernel_to_port(a: np.ndarray) -> np.ndarray:
    # Dense (in, out) -> (out, in); Conv (kt, 1, in, out) -> (out, in, kt, 1)
    return a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1))


def _kernel_to_flax(a: np.ndarray) -> np.ndarray:
    return a.T if a.ndim == 2 else np.transpose(a, (2, 3, 1, 0))


def _flat(p: dict, path: tuple[str, ...] = ()):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _rules_to_state_dict(p: dict, model: str) -> dict:
    sd = {}
    for path, v in _flat(p):
        key, kernel = _rename(path, model, to_port=True)
        a = np.asarray(v)
        sd[key] = _t(_kernel_to_port(a) if kernel else a)
    return sd


def _rules_to_flax(sd: dict, model: str) -> dict:
    p: dict = {}
    for k, v in sd.items():
        path, kernel = _rename(k, model, to_port=False)
        *scopes, leaf = path.split("/")
        d = p
        for name in scopes:
            d = d.setdefault(name, {})
        d[leaf] = np.ascontiguousarray(_kernel_to_flax(v)) if kernel else v
    return {"params": p}


def flax_to_state_dict(params: dict, prefix: str = "") -> dict:
    if "head" in params and "predictor" in params:
        return {**flax_to_state_dict(params["head"], prefix + "head."),
                **flax_to_state_dict(params["predictor"],
                                     prefix + "predictor.net.")}
    p = params.get("params", params)
    model = next((m for m, (k, _) in _RULE_KEYS.items() if k in p), None)
    if model in _LSTM_MODELS:
        p = _map_lstm_cells(p, _lstm_to_port)
    if model is not None:
        sd = _rules_to_state_dict(p, model)
    elif "Fusion_0" in p:
        sd = _head_to_state_dict(p)
    elif "STConvBlock_0" in p:
        sd = _stgcn_to_state_dict(p)
    elif "dim_in_flow" in p:
        sd = _gptst_to_state_dict(p)
    elif "enc_mlp" in p:
        sd = _msdr_to_state_dict(p)
    else:
        sd = {f"cell.{k}": _t(p[_CELL][k]) for k in _GRU}
        sd.update(_dense_to_linear(p["Dense_0"], "dense"))
    return {prefix + k: v for k, v in sd.items()}


def state_dict_to_flax(sd: dict, prefix: str = "",
                       chunked: bool = False) -> dict:
    """The flax tree of a TGCN, MSDR, STGCN, GPT-ST, GWN, MTGNN, CCRNN,
    STMGCN, ASTGCN, STSGCN, STFGNN, STGODE, ST_WA, DMVSTNET or
    `EnhancedModel` state dict; `chunked` nests MSDR's cells as the
    chunked-remat layout does."""
    if f"{prefix}head.proj.weight" in sd:
        return {"head": state_dict_to_flax(sd, prefix + "head."),
                "predictor": state_dict_to_flax(
                    sd, prefix + "predictor.net.", chunked)}
    sd = {k[len(prefix):]: v.detach().cpu().numpy()
          for k, v in sd.items() if k.startswith(prefix)}
    for model, (_, key) in _RULE_KEYS.items():
        if key in sd:
            tree = _rules_to_flax(sd, model)
            if model in _LSTM_MODELS:
                tree = {"params": _map_lstm_cells(tree["params"],
                                                  _lstm_to_flax)}
            return tree
    if "dim_in_flow.weight" in sd:
        return _nested(sd, _gptst_path, lambda path: path[-1] == "kernel")
    if "block0.tconv0.kernel" in sd:
        return _nested(sd, _stgcn_path, lambda path: path[-1] == "kernel"
                       and path[-2] == "Dense_0")

    def dense(key):
        return {"kernel": sd[f"{key}.weight"].T.copy(),
                "bias": sd[f"{key}.bias"]}

    if "fusion.dense.0.weight" in sd:
        return {"params": {"Dense_0": dense("proj"), "Fusion_0": {
            f"Dense_{i}": dense(f"fusion.dense.{i}") for i in range(3)}}}
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
