"""The port's GPT-ST pretraining against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs and the same weights
(a random init, carried across by `convert.py`), at the tiny
config of `tests/test_gptst.py` (N 12, hidden 16, embed 8, spa 4, HS 4,
HT 6, HT_Tem 4, batch 2).

Tolerances: forwards rtol 1e-5, atol 1e-5; gradients rtol 1e-4 and an
atol of 1e-5 of each tensor's largest entry (f32 sums in another order
over two 6-layer trunks); losses rtol 1e-5, also after 3 Adam steps.

The two RNGs differ, so the values of the full pretrain loss are held
at mask_ratio 1.0, where both mask branches mask every point and no
draw matters; the curriculum itself is held by its distribution:
exact masked counts, whole clusters plus at most one partial boundary
cluster, the ramp's saturation, and per-position mask frequencies over
400 seeds against the JAX `generate_mask`'s.

The KL term takes log(max(prob, 1e-38)); XLA on the CPU flushes that
subnormal floor to zero, so a probability that underflowed would give
-inf there and -87.3 in the port. No policy probability here comes near
it: the tests assert the smallest is above 1e-30.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models import gptst as jg
from gptst_tpu.ops import capsule as jcap
from gptst_tpu.ops import param_pool as jpool
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.loss import kl_div_sum as jkl_div_sum
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu.train.trainer import make_optimizer as jmake_optimizer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models import gptst as tg
from gptst_tpu_torch.models.build import build_model
from gptst_tpu_torch.ops import capsule as tcap
from gptst_tpu_torch.ops import param_pool as tpool
from gptst_tpu_torch.train.loss import build_loss, kl_div_sum
from gptst_tpu_torch.train.step import make_loss_terms, train_step
from gptst_tpu_torch.train.trainer import make_optimizer
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B, T = 12, 2, 12
SMALL = dict(num_nodes=N, hidden_dim=16, embed_dim=8, embed_dim_spa=4,
             HS=4, HT=6, HT_Tem=4, change_epoch=2, epochs=10)
SCALER_ZEROS = -0.5
FWD = dict(rtol=1e-5, atol=1e-5)


def _gcfg(**kw):
    return {**SMALL, "input_base_dim": 1, "horizon": T, "num_route": 2,
            "mask_ratio": 0.25, "ada_mask_ratio": 0.5, "ada_type": "all",
            "scaler_zeros": SCALER_ZEROS, **kw}


def _fw_cfg(default, **kw):
    return default("PEMS08", mode="pretrain", **SMALL, mask_ratio=1.0,
                   lr_decay=False, **kw)


def _x(seed=0, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, T, N, 3)).astype(np.float32)


def _assert_grads(got: dict, want, rtol=1e-4, rel_atol=1e-5):
    """Every leaf of the flax gradient tree `want` against the port's
    (a flax tree from `state_dict_to_flax`; a parameter the port's
    graph does not reach has no gradient and must be zero in JAX)."""
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == 135
    for path, w in paths:
        w = np.asarray(w)
        g = flat.get(path)
        if g is None:
            assert not w.any(), path
            continue
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_gptst():
    """The JAX model (mask_ratio 1.0) and, as its numpy flax tree, the
    port's init from seed 0 (`convert.py`; a JAX init would only cost
    a compile)."""
    model = jg.GPTST(jg.GPTSTConfig(**_gcfg(mask_ratio=1.0)))
    net = tg.GPTST(tg.GPTSTConfig(**_gcfg(mask_ratio=1.0)),
                   torch.Generator().manual_seed(0))
    return model, state_dict_to_flax(net.state_dict())


def _port_net(params, **kw) -> tg.GPTST:
    net = tg.GPTST(tg.GPTSTConfig(**_gcfg(mask_ratio=1.0, **kw)))
    net.load_state_dict(flax_to_state_dict(params))
    return net


def test_squash_and_routing_value_and_grad():
    rng = np.random.default_rng(1)
    pcaps = rng.standard_normal((B, 3, N, 5)).astype(np.float32)
    dadj = rng.standard_normal((B, 3, 4, N)).astype(np.float32)
    g = rng.standard_normal((B, 3, 4, N)).astype(np.float32)

    def jfn(p, d):
        return (jnp.sum(jcap.squash(p) ** 3)
                + jnp.sum(jcap.dynamic_routing(jcap.squash(p), d, 3) * g))

    want = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(pcaps, dadj)
    p, d = torch.tensor(pcaps, requires_grad=True), torch.tensor(
        dadj, requires_grad=True)
    val = ((tcap.squash(p) ** 3).sum()
           + (tcap.dynamic_routing(tcap.squash(p), d, 3)
              * torch.tensor(g)).sum())
    val.backward()
    np.testing.assert_allclose(val.item(), float(want[0]), rtol=1e-5)
    for got, w in zip((p.grad, d.grad), want[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **FWD)
    # routing reaches pcaps only through the detached agreement loop
    jr = jax.jit(jax.grad(
        lambda q: jnp.sum(jcap.dynamic_routing(q, dadj) * g)))(pcaps)
    assert not np.asarray(jr).any()


@pytest.mark.parametrize("kind", ["node", "time"])
def test_param_pool_linear_value_and_grad(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, N, 5)).astype(np.float32)
    emb = rng.standard_normal(
        (N, 3) if kind == "node" else (B, T, 3)).astype(np.float32)
    w = rng.standard_normal((3, 5, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4)).astype(np.float32)
    g = rng.standard_normal((B, T, N, 4)).astype(np.float32)
    jf = getattr(jpool, f"{kind}_param_linear")
    tf = getattr(tpool, f"{kind}_param_linear")
    args = (x, emb, w, b)
    want = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(jf(*a) * g), argnums=(0, 1, 2, 3)))(*args)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    val = (tf(*targs) * torch.tensor(g)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(want[0]), rtol=1e-5)
    for got, w_ in zip(targs, want[1]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w_), **FWD)


def _trunk_inputs(net):
    """The encoder trunk's inputs on both sides: source, x_in, node
    embeddings and the three time embeddings."""
    x = _x(3)
    src = torch.tensor(x)
    enc = net.encoder
    tcat = src[:, :, 0, 1:3]
    with torch.no_grad():
        x_in = net.dim_in_flow(src[..., :1])
        t = dict(time_eb=enc.time_feature[0](tcat),
                 teb=enc.time_feature[1](tcat),
                 time_eb_spg=enc.time_feature_spg(tcat))
    return x, x_in, t


@pytest.mark.parametrize("module", ["HyperTem", "Cap", "MLPRL", "STHCN"])
def test_module_forward_matches(jax_gptst, module):
    _, params = jax_gptst
    net = _port_net(params)
    p = params["params"]
    c = jg.GPTSTConfig(**_gcfg(mask_ratio=1.0))
    x, x_in, t = _trunk_inputs(net)
    enc = net.encoder
    ne, ne_spg = enc.node_embeddings.detach(), enc.node_embeddings_spg.detach()
    j = lambda a: jnp.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    with torch.no_grad():
        if module == "HyperTem":
            got = (enc.hyper_tem[1](x_in, ne, t["time_eb"]),)
            want = (jg.HyperTem(T, 16, 16, 8, 4).apply(
                {"params": p["encoder"]["HyperTem_1"]}, j(x_in), j(ne),
                j(t["time_eb"])),)
        elif module == "Cap":
            got = enc.cap[0](x_in, ne_spg, t["time_eb_spg"], t["teb"])
            want = jg.Cap(16, N, T, 8, 4, 4, 6, 2).apply(
                {"params": p["encoder"]["Cap_0"]}, j(x_in), j(ne_spg),
                j(t["time_eb_spg"]), j(t["teb"]))
        elif module == "MLPRL":
            tcat = torch.tensor(x)[:, :, 0, 1:3]
            teb = net.teb4mask(tcat)
            got = (net.mlp_rl(torch.tensor(x[..., :1]), teb, net.neb4mask),)
            want = (jg.MLPRL(1, 4, 16, 8).apply(
                {"params": p["mlp_rl"]}, x[..., :1], j(teb),
                p["neb4mask"]),)
        else:
            got = enc(torch.tensor(x), x_in)
            want = jg.STHCN(c).apply({"params": p["encoder"]}, x, j(x_in))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **FWD)


def test_encode_matches(jax_gptst):
    model, params = jax_gptst
    x = _x(4)
    want = jax.jit(model.apply)(params, x)
    with torch.no_grad():
        got = _port_net(params).encode(torch.tensor(x))
    assert got.shape == (B, T, N, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_kl_div_sum_matches():
    rng = np.random.default_rng(5)
    target = rng.dirichlet(np.ones(4), size=(B, T, N)).astype(np.float32)
    target[0, 0, :3] = [1.0, 0.0, 0.0, 0.0]     # exact zeros: 0 log 0 = 0
    logp = np.log(rng.dirichlet(np.ones(4), size=(B, T, N))).astype(
        np.float32)
    want = float(jkl_div_sum(jnp.asarray(logp), jnp.asarray(target)))
    got = kl_div_sum(torch.tensor(logp), torch.tensor(target))
    assert got.dtype == torch.float32 and np.isfinite(want)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def loss_pair(jax_gptst):
    """Both packages' pretrain loss terms at mask_ratio 1.0 on the same
    weights: the jitted JAX value_and_grad per trunk remat (the epoch
    traced, so one compile serves both branches), and a factory of the
    port's."""
    _, params = jax_gptst

    @functools.cache
    def jvg(remat="none"):
        jcfg = _fw_cfg(jax_default_config, pretrain_remat=remat)
        _, forward = jbuild.build_pretrain(jcfg, SCALER_ZEROS)
        jloss = jbuild_loss("mask_mae", 50.0, 20.0, 0.0, True)
        return jax.jit(jax.value_and_grad(
            jmake_loss_terms(forward, jloss, jcfg), has_aux=True))

    def port(**kw):
        cfg = _fw_cfg(default_config, **kw)
        model = build_model(cfg, device="cpu", scaler_zeros=SCALER_ZEROS)
        model.gptst.load_state_dict(flax_to_state_dict(params))
        loss = build_loss("mask_mae", 50.0, 20.0, 0.0, True)
        return model, make_loss_terms(model, loss, cfg), cfg

    return params, jvg, port


def _jax_step(jvg, params, x, epoch):
    (total, flow), grads = jvg(params, jnp.asarray(x), jnp.asarray(x),
                               jax.random.PRNGKey(7),
                               jnp.asarray(epoch, jnp.int32), 1)
    return float(total), float(flow), grads


@pytest.mark.parametrize("epoch, remat", [(2, "none"), (3, "none"),
                                          (3, "full")],
                         ids=["random", "adaptive_kl", "adaptive_kl_remat"])
def test_pretrain_loss_and_every_grad_match(loss_pair, epoch, remat):
    """Epoch 2 = change_epoch: the random branch, flow loss alone (the
    mask policy gets no gradient); epoch 3: the adaptive branch and the
    KL term, also with both trunks under remat "full" (the remat layout
    of the flax tree)."""
    params, jvg, port = loss_pair
    x = _x(6)
    jtotal, jflow, jgrads = _jax_step(jvg(remat), params, x, epoch)
    model, loss_terms, _ = port(pretrain_remat=remat)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = model(torch.tensor(x), generator=gen, epoch=epoch)
    assert out.mask.eq(1).all() and out.pred.shape == (B, T, N, 1)
    assert float(out.probability.min()) > 1e-30
    total, flow = loss_terms(torch.tensor(x), torch.tensor(x), 1,
                             epoch=epoch, generator=gen)
    total.backward()
    assert (total.item() > flow.item()) == (epoch > 2)
    np.testing.assert_allclose([total.item(), flow.item()], [jtotal, jflow],
                               rtol=1e-5)
    _assert_grads(state_dict_to_flax(
        {k: p.grad for k, p in model.gptst.named_parameters()
         if p.grad is not None}), jgrads)


def test_three_adam_steps_match(loss_pair):
    """3 steps of clip_by_global_norm(5) + Adam(3e-3) from the same
    weights at epoch 3 (adaptive branch, KL on), on 3 batches."""
    params, jvg, port = loss_pair
    jcfg = _fw_cfg(jax_default_config)
    opt = jmake_optimizer(jcfg, 10)

    @jax.jit
    def update(g, s, p):
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s

    xs = [_x(10 + i) for i in range(3)]
    jlosses, p, s = [], params, opt.init(params)
    for x in xs:
        total, _, grads = _jax_step(jvg(), p, x, 3)
        p, s = update(grads, s, p)
        jlosses.append(total)
    model, loss_terms, cfg = port()
    topt = make_optimizer(cfg, model.parameters(), 10)
    gen = torch.Generator().manual_seed(0)
    tlosses = [train_step(loss_terms, topt, torch.tensor(x), torch.tensor(x),
                          i + 1, epoch=3, generator=gen)[0].item()
               for i, x in enumerate(xs)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[0] != tlosses[-1]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_equal_loss_and_grads(jax_gptst, remat):
    _, params = jax_gptst
    x = torch.tensor(_x(8))
    out = {}
    for rm in ("none", remat):
        net = _port_net(params, remat=rm)
        res = net.pretrain(x, torch.Generator().manual_seed(0), 3)
        loss = res[0].square().mean() + kl_div_sum(res[3].log(), res[4])
        loss.backward()
        out[rm] = [loss.detach()] + [p.grad for p in net.parameters()]
    for a, b in zip(out["none"], out[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_convert_round_trips(jax_gptst, remat):
    """The JAX package's own tree, plain and under trunk remat (the same
    paths), is the tree `convert.py` writes; random weights in it go to
    a state dict that loads strictly and come back equal."""
    _, params = jax_gptst
    model = jg.GPTST(jg.GPTSTConfig(**_gcfg(remat=remat)))
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.asarray(_x()),
        jax.random.PRNGKey(1), jnp.asarray(1, jnp.int32))
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(params)
    assert [s.shape for s in jax.tree_util.tree_leaves(shapes)] == \
        [a.shape for a in jax.tree_util.tree_leaves(params)]
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda s: rng.standard_normal(
        s.shape).astype(np.float32), shapes)
    sd = flax_to_state_dict(params, prefix="gptst.")
    built = build_model(_fw_cfg(default_config, pretrain_remat=remat),
                        device="cpu")
    built.load_state_dict(sd, strict=True)
    back = state_dict_to_flax(built.state_dict(), prefix="gptst.")
    (flat, tree), (flat2, tree2) = (jax.tree_util.tree_flatten(t)
                                    for t in (params, back))
    assert tree == tree2 and len(flat) == 135
    for a, b in zip(flat, flat2):
        np.testing.assert_array_equal(a, b)


def test_init_within_xavier_and_unit_bounds():
    net = tg.GPTST(tg.GPTSTConfig(**_gcfg()), torch.Generator().manual_seed(0))
    for k, p in net.named_parameters():
        v = p.detach()
        if v.ndim == 1:
            assert 0 <= float(v.min()) and float(v.max()) < 1, k
            continue
        shape = tuple(v.T.shape) if k.endswith(".weight") else tuple(v.shape)
        lim = tg.xavier_limit(shape)
        assert float(v.abs().max()) <= lim, k
        assert float(v.abs().max()) > 0.5 * lim, k


# --- the mask curriculum ------------------------------------------------

MB, MT, HS = 2, 4, 4


def _labels(seed=0):
    return np.random.default_rng(seed).integers(0, HS, (MB, MT, N))


def _guide(labels):
    return np.eye(HS, dtype=np.float32)[labels]


def _mask_cfgs(**kw):
    base = _gcfg(horizon=MT, **kw)
    return jg.GPTSTConfig(**base), tg.GPTSTConfig(**base)


def _port_mask(cfg, guide, epoch, seed):
    m = tg.generate_mask(cfg, torch.Generator().manual_seed(seed),
                         torch.tensor(guide), epoch, (MB, MT, N, 1))
    return m.numpy()[..., 0]


def test_random_mask_exact_count():
    _, cfg = _mask_cfgs()
    guide = np.full((MB, MT, N, HS), 1.0 / HS, np.float32)
    for seed in range(5):
        m = _port_mask(cfg, guide, 1, seed)
        assert set(np.unique(m)) <= {0.0, 1.0}
        assert int((m == 0).sum()) == int(m.size * cfg.mask_ratio)


@pytest.mark.parametrize("epoch", [6, 10, 40], ids=["ramp_half", "ramp_full",
                                                  "saturated"])
@pytest.mark.parametrize("ada_type", ["all", "half"])
def test_adaptive_mask_budget_and_clusters(ada_type, epoch):
    """The adaptive branch against its own draws: the visit order is the
    generator's first draw (a permutation of HS), so it is recomputed
    here. ramp = (epoch - 2) / 8 * ada_mask_ratio 1, capped at 1: 0.5,
    1 and (capped) 4.75. The mask holds exactly int(mask_ratio * m)
    points; under 'all' the clusters visited before the boundary one
    are wholly masked and the boundary one holds at least the rest of
    the adaptive budget a_num; under 'half' the visited clusters hold
    at least a_num. At a full ramp the random part is empty, so nothing
    outside the visited clusters is masked and under 'all' the boundary
    cluster holds exactly the rest."""
    _, cfg = _mask_cfgs(ada_type=ada_type, ada_mask_ratio=1.0,
                        mask_ratio=0.5)
    labels = _labels(1)
    mask_num_sum = int(MB * MT * N * cfg.mask_ratio)
    ramp = min(np.float32(epoch - 2) / np.float32(8), np.float32(1))
    a_num = int(np.floor(np.float32(mask_num_sum) * ramp))
    for seed in range(10):
        m = _port_mask(cfg, _guide(labels), epoch, seed) == 0
        assert int(m.sum()) == mask_num_sum
        order = torch.randperm(
            HS, generator=torch.Generator().manual_seed(seed)).tolist()
        cum = np.cumsum([(labels == c).sum() for c in order])
        i = int(np.searchsorted(cum, a_num)) + 1
        visited = np.isin(labels, order[:i])
        if ada_type == "all":
            whole = np.isin(labels, order[:i - 1])
            assert m[whole].all()
            boundary = int(m[labels == order[i - 1]].sum())
            rest = a_num - int(whole.sum())
            assert boundary == rest if a_num == mask_num_sum \
                else boundary >= rest
        assert int(m[visited].sum()) >= a_num
        if a_num == mask_num_sum:
            assert not m[~visited].any()


@pytest.mark.parametrize("branch", ["random", "all", "half"])
def test_mask_frequencies_match_jax(branch):
    """Per-position masking frequency over K = 400 seeds on each side,
    against the JAX `generate_mask`'s: |f_port - f_jax| within
    5 * sqrt(2 p (1 - p) / K) + 1 / K at every one of the 96 positions
    (p the pooled frequency; a two-sample binomial bound at 5 sigma)."""
    K = 400
    ada = "all" if branch == "random" else branch
    jcfg, cfg = _mask_cfgs(ada_type=ada, ada_mask_ratio=1.0, mask_ratio=0.5)
    epoch = 1 if branch == "random" else 6
    labels = _labels(3)
    guide = _guide(labels)
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    jm = jax.jit(jax.vmap(lambda k: jg.generate_mask(
        jcfg, k, jnp.asarray(guide), jnp.asarray(epoch, jnp.int32),
        (MB, MT, N, 1))))(keys)
    f_jax = (np.asarray(jm)[..., 0] == 0).mean(0)
    f_port = np.mean([_port_mask(cfg, guide, epoch, 1000 + s) == 0
                      for s in range(K)], axis=0)
    p = (f_jax + f_port) / 2
    bound = 5 * np.sqrt(2 * p * (1 - p) / K) + 1 / K
    assert np.all(np.abs(f_port - f_jax) <= bound), \
        float(np.max(np.abs(f_port - f_jax) - bound))


def test_cli_pretrain_on_cpu(tmp_path, monkeypatch):
    """`-mode pretrain` with the CLI's default `-model`: 2 tiny epochs
    across `change_epoch`, the checkpoint reloads strictly into a fresh
    GPT-ST with the same `encode`, and the report is on the train
    split."""
    from gptst_tpu_torch.run import main
    from gptst_tpu_torch.train.trainer import Trainer

    splits = []
    test = Trainer.test
    monkeypatch.setattr(Trainer, "test", lambda self, split="test": (
        splits.append(split), test(self, split))[1])
    out = tmp_path / "m.json"
    argv = ["-dataset", "PEMS08", "-mode", "pretrain", "-num_nodes", str(N),
            "-hidden_dim", "16", "-embed_dim", "8", "-embed_dim_spa", "4",
            "-HS", "4", "-HT", "6", "-HT_Tem", "4", "-epochs", "2",
            "-change_epoch", "1", "-batch_size", "16", "-num_steps", "200",
            "-device", "cpu", "-log_dir", str(tmp_path), "-log_step", "1000",
            "-metrics_out", str(out)]
    assert main(argv) == 0
    assert splits == ["train"]
    rep = json.loads(out.read_text())
    assert len(rep["history"]) == 2 and np.isfinite(rep["average"]).all()
    sd = torch.load(tmp_path / "PEMS08" / "gptst_pretrain.ckpt",
                    weights_only=True)
    cfg = default_config("PEMS08", mode="pretrain", **{
        **SMALL, "change_epoch": 1, "epochs": 2})
    fresh = tg.GPTST(tg.GPTSTConfig.from_framework(cfg, 0.0))
    fresh.load_state_dict(sd, strict=True)
    best = torch.load(tmp_path / "PEMS08" / "best_model.pt",
                      weights_only=True)
    assert all(torch.equal(v, best["gptst." + k]) for k, v in sd.items())
    x = torch.tensor(_x(12))
    trained = build_model(cfg, device="cpu")
    trained.load_state_dict(best)
    with torch.no_grad():
        torch.testing.assert_close(fresh.encode(x),
                                   trained(x).pred, rtol=0, atol=0)


def test_gptst_config_fields_match_jax():
    assert dataclasses.asdict(tg.GPTSTConfig(num_nodes=5)) == \
        dataclasses.asdict(jg.GPTSTConfig(num_nodes=5))
