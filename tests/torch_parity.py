"""Helpers of the port's parity tests for STMGCN, ASTGCN, STSGCN, STFGNN,
STGODE, ST_WA and DMVSTNET: noisy JAX weights, the gradient tree of a
torch network in flax's layout, and the model check (the loss at rtol 1e-5; the
prediction and every gradient at rtol 1e-4 with an atol of 1e-5 of each
tensor's largest entry; where the f32 sums drift, both packages also in
float64)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax


@pytest.fixture
def one_torch_thread():
    """Many tiny torch ops: one intra-op thread, as in the other port
    test files (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noisy(params, seed=7, scale=0.1):
    """The JAX init with N(0, scale^2) noise on every leaf: at init,
    zero embeddings and biases, identities and ones would hide a broken
    backward."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)


def grad_tree(net) -> tuple[dict, set]:
    """Every parameter gradient of `net` in flax's layout, by leaf path
    (a None gradient, of a parameter that reaches no output, as JAX's
    zero), and the paths whose gradient is None."""
    tree = state_dict_to_flax({
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in net.named_parameters()})
    none = state_dict_to_flax({k: torch.full_like(p, p.grad is None)
                               for k, p in net.named_parameters()})
    return (dict(jax.tree_util.tree_leaves_with_path(tree)),
            {path for path, v in jax.tree_util.tree_leaves_with_path(none)
             if np.asarray(v).all()})


def jax_value_and_grad(jm, params, x, graph, y, jit=True,
                       dtype=np.float32):
    """JAX's mean |pred - y| loss, prediction and gradients, by leaf
    path, with inputs and weights in `dtype` (float64 only under
    `jax.enable_x64`)."""
    xs = [jnp.asarray(np.asarray(a, dtype)) for a in (x, *graph)]
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                          params)

    def loss(p):
        pred = jm.apply(p, *xs)
        return jnp.abs(pred - jnp.asarray(np.asarray(y, dtype))).mean(), pred

    fn = jax.value_and_grad(loss, has_aux=True)
    (jl, jpred), jgrads = (jax.jit(fn) if jit else fn)(params)
    grads = {path: np.asarray(w)
             for path, w in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert np.asarray(jpred).dtype == dtype
    assert all(w.dtype == dtype for w in grads.values())
    return float(jl), np.asarray(jpred), grads


def torch_value_and_grad(net, x, graph, y, dtype=torch.float32, kw=None):
    """The port's loss, prediction, gradients by leaf path and the
    paths whose gradient is None; `kw` are more keyword arguments of
    the forward."""
    net = net.to(dtype)
    pred = net(torch.tensor(x, dtype=dtype),
               *(torch.tensor(g, dtype=dtype) for g in graph), **(kw or {}))
    loss = (pred - torch.tensor(y, dtype=dtype)).abs().mean()
    loss.backward()
    return (loss.item(), pred.detach().numpy(), *grad_tree(net))


def _assert_close(got, want, loss_rtol, rtol, rel, extra=None):
    """Loss, prediction and gradients `got` against `want` (each a
    (loss, pred, grads) triple): the loss at `loss_rtol`, the rest at
    `rtol`
    with an atol of `rel` times each tensor's largest entry, plus
    `extra[key]` where given. A gradient whose largest entry in `want`
    is at most `rel` times the model's largest gradient entry is held at
    `rel` times the latter: an L1 loss whose signs cancel over a head's
    batch gives 0 in exact arithmetic, and rounding noise in another
    summation order."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    model_max = max(float(np.abs(w).max()) for w in want[2].values())
    assert set(got[2]) == set(want[2])
    for key, g, w in [(None, got[1], want[1]),
                      *((k, got[2][k], w) for k, w in want[2].items())]:
        scale = np.abs(w).max()
        atol = rel * (scale if scale > rel * model_max else model_max)
        if extra is not None:
            atol += extra[key]
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol,
            err_msg="pred" if key is None else jax.tree_util.keystr(key))


def assert_model_matches(jm, net, params, x, graph, y, jit=True,
                         against64=False, torch_kw=None):
    """`net` with `params` carried over by `convert.py` against the JAX
    module `jm` in f32: the loss rtol 1e-5, the prediction and every
    gradient rtol 1e-4 with an atol of 1e-5 of each tensor's largest
    entry. Every parameter that JAX gives a nonzero gradient has a
    gradient in the port.

    With `against64` (models whose f32 sums drift from exact ones), both
    packages also run in float64, and the port's float64 run is held to
    JAX's at rtol 1e-9 with an atol of 1e-9 of each tensor's largest
    entry; each f32 atol then adds twice JAX's own f32 distance from its
    float64 run, a term of the reference alone.

    `torch_kw(dtype)`, where given, returns more keyword arguments of the
    port's forward for a run in numpy `dtype` (ST_WA's draws, which JAX
    makes in the run's own precision)."""

    def kw(dtype):
        return None if torch_kw is None else torch_kw(dtype)

    f32 = jax_value_and_grad(jm, params, x, graph, y, jit)
    net.load_state_dict(flax_to_state_dict(params))
    extra = None
    if against64:
        import copy

        with jax.enable_x64(True):
            j64 = jax_value_and_grad(jm, params, x, graph, y, jit,
                                     np.float64)
        t64 = torch_value_and_grad(copy.deepcopy(net), x, graph, y,
                                   torch.float64, kw(np.float64))
        _assert_close(t64[:3], j64, loss_rtol=1e-9, rtol=1e-9, rel=1e-9)
        extra = {key: 2 * np.abs(w - j64[2][key]).max()
                 for key, w in f32[2].items()}
        extra[None] = 2 * np.abs(f32[1] - j64[1]).max()
    *got, none = torch_value_and_grad(net, x, graph, y,
                                      kw=kw(np.float32))
    assert not [jax.tree_util.keystr(k) for k in none if f32[2][k].any()]
    _assert_close(got, f32, loss_rtol=1e-5, rtol=1e-4, rel=1e-5,
                  extra=extra)
    return f32[2]


def gptst_by_path(tensors: dict, model) -> dict:
    """GPT-ST tensors by torch name (`model.gptst`'s parameters) as a
    dict by flax path, a missing or None one as zeros."""
    return dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax({
        k: torch.zeros_like(p) if tensors.get(k) is None else tensors[k]
        for k, p in model.gptst.named_parameters()})))


def assert_step_matches_jax(model, grads: dict, params: dict, jgrads: dict,
                            stepped, lr: float) -> None:
    """A port step of `model`'s GPT-ST against JAX's: its gradients
    `grads` and the parameters after it `params` (by torch name) against
    `jax.grad`'s `jgrads` (by flax path) and JAX's stepped parameters
    `stepped` (a flax tree). The gradients at rtol 1e-4 with an atol of
    1e-5 of each tensor's largest entry; every parameter at atol 1e-5
    where JAX's gradient is 0 or at least 1e-6: there Adam's first step
    is 0 or lr * g / (|g| + 1e-8), lr to 1%. Where 0 < |g| < 1e-6 in
    JAX (gradients within f32 summation noise of zero) the step's size
    is that noise amplified, and the parameter is held to within lr of
    JAX's."""
    grads = gptst_by_path(grads, model)
    got = gptst_by_path(params, model)
    assert grads.keys() == jgrads.keys()
    for path, want in jax.tree_util.tree_leaves_with_path(stepped):
        want, name = np.asarray(want), jax.tree_util.keystr(path)
        jg = np.asarray(jgrads[path])
        np.testing.assert_allclose(grads[path], jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)
        sure = (np.abs(jg) >= 1e-6) | (jg == 0)
        np.testing.assert_allclose(got[path][sure], want[sure], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got[path], want, atol=lr, err_msg=name)


def assert_round_trip(net, jm, *init_args):
    """`convert.py` both ways: the state dict comes back equal, and its
    flax tree has the JAX init's paths and shapes."""
    sd = net.state_dict()
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *init_args)
    assert (jax.tree.map(np.shape, state_dict_to_flax(sd))
            == jax.tree.map(lambda a: a.shape, shapes))


def closure_array(fn, name: str) -> np.ndarray:
    """The array `name` that a JAX builder's `apply_fn` closes over."""
    return np.asarray(inspect.getclosurevars(fn).nonlocals[name])


# GPT-ST at tiny widths for the pretrain -> eval -> test cycle
_CLI_FLAGS = ["-num_nodes", "12", "-batch_size", "8", "-epochs", "2",
              "-num_steps", "220", "-lr_decay", "False", "-early_stop",
              "False", "-hidden_dim", "16", "-embed_dim", "8",
              "-embed_dim_spa", "4", "-HS", "4", "-HT", "6", "-HT_Tem", "4",
              "-change_epoch", "1", "-log_step", "10000", "-device", "cpu"]


def cli_cycle(tmp_path, dataset: str, model: str, widths: list[str]):
    """`run.main` on the CPU at tiny widths: `-mode ori`, then `-mode
    pretrain`, `-mode eval` and `-mode test` of `model` from that
    checkpoint. Every training loss is finite, and the test report
    equals the eval run's (the same weights on the same split)."""
    import json

    from gptst_tpu_torch.run import main

    out = {}
    for mode in ("ori", "pretrain", "eval", "test"):
        path = tmp_path / f"{mode}.json"
        # ori's best_model.pt in a directory of its own
        log_dir = tmp_path / ("ori" if mode == "ori" else "gptst")
        argv = ["-dataset", dataset, "-mode", mode, "-model", model,
                *widths, *_CLI_FLAGS, "-log_dir", str(log_dir),
                "-metrics_out", str(path)]
        assert main(argv) == 0
        out[mode] = json.loads(path.read_text())
    for mode in ("ori", "pretrain", "eval"):
        assert np.isfinite(out[mode]["history"]).all(), mode
    assert out["test"]["per_horizon"] == out["eval"]["per_horizon"]
    assert out["test"]["average"] == out["eval"]["average"]
    assert np.isfinite(out["test"]["average"]).all()
    return out
