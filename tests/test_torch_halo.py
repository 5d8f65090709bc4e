"""The port's node-sharded aggregation against the JAX package's.

The JAX side runs on the 8-device CPU mesh of `tests/conftest.py`, its
fused ring kernel in Pallas interpret mode (as `tests/test_halo_fused.py`
runs it); the port runs P ranks on the CPU (`make_mesh(devices=["cpu"]
* P)`), where the fused ring takes its plain version. The same numpy
inputs go to both. Tolerances: the partition functions are numpy copies,
so their arrays are equal; f32 products rtol/atol 1e-5 (the JAX tests'
own; sums in another order); a bf16 output may differ by one bf16
rounding of the same f32 sum (rtol 2^-7); TGCN forward and gradients
rtol 1e-4 (as `tests/test_torch_tgcn.py`), loss trajectories rtol 2e-5
(`tests/test_sharded_training.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gptst_tpu.graph import partition as jpart
from gptst_tpu.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu.kernels import halo_spmm as jhalo_k
from gptst_tpu.models.predictors.tgcn import TGCN as JTGCN
from gptst_tpu.models.predictors.tgcn import TGCNConfig as JTGCNConfig
from gptst_tpu.ops import graph_conv as jgc
from gptst_tpu.parallel import halo as jhalo
from gptst_tpu.parallel.mesh import GRAPH_AXIS, make_mesh as jmake_mesh
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.graph import partition as tpart
from gptst_tpu_torch.kernels import halo_spmm as thalo_k
from gptst_tpu_torch.models.build import build_model
from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.ops.recurrent import GraphGRUCell, GraphGRUCellNM
from gptst_tpu_torch.parallel import halo as thalo
from gptst_tpu_torch.parallel.mesh import (
    gather_rows, make_mesh, shard_rows,
)
from gptst_tpu_torch.train.trainer import ClippedAdam
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32 = dict(rtol=1e-5, atol=1e-5)


def _graph(n, seed, degree=5):
    return sym_adj(random_sensor_graph(n, avg_degree=degree, seed=seed))


def _meshes(parts):
    return (jmake_mesh(parts, graph_axis_size=parts),
            make_mesh(devices=["cpu"] * parts, graph_axis_size=parts))


def _banded_coo(n, band=8, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 3 * n)
    dst = np.clip(src + rng.integers(-band, band + 1, 3 * n), 0, n - 1)
    key = np.unique(np.concatenate([src * n + dst, np.arange(n) * (n + 1)]))
    rows, cols = key // n, key % n
    return rows, cols, rng.uniform(0.1, 1.0, rows.size).astype(np.float32)


def _assert_partitions_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
        np.testing.assert_array_equal(va, vb, err_msg=f.name)
    assert tpart.partition_stats(b) == jpart.partition_stats(a)


@pytest.mark.parametrize("n,parts,reorder", [(50, 4, True), (50, 4, False),
                                             (61, 8, True), (64, 2, False)])
def test_partition_arrays_equal(n, parts, reorder):
    """`partition_graph` (RCM on and off, ragged n), `partition_adjacency`
    and `_rotate_blocks`, and the padding helpers."""
    adj = _graph(n, seed=n)
    want = jpart.partition_graph(adj, parts, reorder=reorder)
    got = tpart.partition_graph(adj, parts, reorder=reorder)
    _assert_partitions_equal(want, got)
    x = np.random.default_rng(1).normal(size=(2, n, 3))
    np.testing.assert_array_equal(got.pad_features(x), want.pad_features(x))
    np.testing.assert_array_equal(
        got.unpad_features(got.pad_features(x)), x)
    blocks = thalo.partition_adjacency(adj, parts)
    np.testing.assert_array_equal(blocks,
                                  jhalo.partition_adjacency(adj, parts))
    np.testing.assert_array_equal(thalo_k._rotate_blocks(blocks),
                                  jhalo_k._rotate_blocks(blocks))


def test_partition_graph_coo_arrays_equal():
    rows, cols, vals = _banded_coo(203, seed=3)
    for parts in (2, 4):
        _assert_partitions_equal(
            jpart.partition_graph_coo(rows, cols, vals, 203, parts),
            tpart.partition_graph_coo(rows, cols, vals, 203, parts))


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_ring_spmm_matches_jax(parts):
    """x with leading batch dims (2, n_pad, 5); the port's ring on P CPU
    ranks against the JAX ppermute ring."""
    jmesh, mesh = _meshes(parts)
    adj = _graph(70, seed=parts)
    jfn, n_pad = jhalo.make_ring_spmm(jmesh, adj)
    fn, n_pad2 = thalo.make_ring_spmm(mesh, adj)
    assert n_pad == n_pad2
    x = np.random.default_rng(parts).normal(size=(2, n_pad, 5)).astype(
        np.float32)
    x[:, 70:] = 0.0
    got = fn(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))), **F32)
    np.testing.assert_allclose(got[:, :70], adj @ x[:, :70], **F32)


@pytest.mark.parametrize("parts", [2, 4])
def test_halo_spmm_matches_jax(parts):
    """Dense partition (ragged n) and edge-list partition."""
    jmesh, mesh = _meshes(parts)
    rows, cols, vals = _banded_coo(150, seed=parts)
    adj = _graph(70, seed=7)
    for jp, tp in ((jpart.partition_graph(adj, parts, reorder=False),
                    tpart.partition_graph(adj, parts, reorder=False)),
                   (jpart.partition_graph_coo(rows, cols, vals, 150, parts),
                    tpart.partition_graph_coo(rows, cols, vals, 150, parts))):
        jfn, n_pad = jhalo.make_halo_spmm(jmesh, jp)
        fn, n_pad2 = thalo.make_halo_spmm(mesh, tp)
        assert n_pad == n_pad2
        x = np.random.default_rng(5).normal(size=(3, n_pad, 4)).astype(
            np.float32)
        x[:, tp.n:] = 0.0
        got = fn(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))),
                                   **F32)


@pytest.fixture
def _pallas_interpret(monkeypatch):
    """The JAX fused ring as `tests/test_halo_fused.py` runs it."""
    orig = jhalo_k.make_fused_ring_spmm
    monkeypatch.setattr(
        jhalo_k, "make_fused_ring_spmm",
        lambda mesh, adj, feat: orig(mesh, adj, feat, interpret=True))


@pytest.mark.parametrize("parts,dtype", [(2, "float32"), (4, "float32"),
                                         (8, "float32"), (4, "bfloat16")])
def test_fused_ring_plain_matches_jax(_pallas_interpret, parts, dtype):
    """n = 96, F = 16: the fused ring's plain version on CPU ranks
    against the JAX Pallas kernel; a bf16 x gives a bf16 output. The
    JAX kernel refuses a bf16 x (`buf[0] = x_ref[:]` stores it into its
    f32 buffer, which Pallas does not cast), so in that case it gets
    the bf16 values as f32 and its output is rounded to bf16."""
    n, feat = 96, 16
    jmesh, mesh = _meshes(parts)
    adj = _graph(n, seed=0)
    jfn, n_pad = jhalo_k.make_fused_ring_spmm(jmesh, adj, feat)
    fn, n_pad2 = thalo_k.make_fused_ring_spmm(mesh, adj, feat)
    assert n_pad == n_pad2
    x = np.zeros((n_pad, feat), np.float32)
    x[:n] = np.random.default_rng(1).normal(size=(n, feat))
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
    jx = jax.device_put(jnp.asarray(x),
                        NamedSharding(jmesh, P(GRAPH_AXIS, None)))
    want = np.asarray(jfn(jx).astype(dtype).astype(jnp.float32))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    outs = fn(shard_rows(xt, mesh))
    assert len(outs) == parts
    assert all(o.dtype == xt.dtype and o.shape == (n_pad // parts, feat)
               for o in outs)
    got = gather_rows(outs, torch.device("cpu")).float().numpy()
    tol = F32 if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)
    if dtype == "float32":
        np.testing.assert_allclose(got[:n], adj @ x[:n], **F32)


def test_fused_ring_plain_schedule_and_nan():
    """The plain schedule equals the XLA-style ring on every shard; a
    NaN in one x row reaches every output row of its column on every
    rank (dense blocks, zeros included); shapes and ranks are checked."""
    mesh = make_mesh(devices=["cpu"] * 4, graph_axis_size=4)
    adj = _graph(40, seed=2)
    fn, n_pad = thalo_k.make_fused_ring_spmm(mesh, adj, 6)
    ring, _ = thalo.make_ring_spmm(mesh, adj)
    x = torch.tensor(np.random.default_rng(3).normal(size=(n_pad, 6)),
                     dtype=torch.float32)
    got = gather_rows(fn(shard_rows(x, mesh)), torch.device("cpu"))
    torch.testing.assert_close(got, ring(x), **F32)
    x[17, 4] = float("nan")
    got = gather_rows(fn(shard_rows(x, mesh)), torch.device("cpu"))
    assert bool(torch.isnan(got[:, 4]).all())
    assert not torch.isnan(got[:, [0, 1, 2, 3, 5]]).any()
    with pytest.raises(ValueError):
        fn(shard_rows(x, mesh)[:3])
    with pytest.raises(ValueError):
        fn(shard_rows(x[:, :5].contiguous(), mesh))
    with pytest.raises(TypeError):
        fn(shard_rows(x.double(), mesh))


class _SimStream:
    """A CUDA stream as a queue of ops, event records and event waits."""

    def __init__(self):
        self.q = []
        self.cuda_stream = self

    def wait_event(self, ev):
        self.q.append(("wait", ev, ev.gen))


class _SimEvent:
    def __init__(self):
        self.gen = self.done = 0

    def record(self, stream):
        self.gen += 1
        stream.q.append(("record", self, self.gen))


def test_ring_event_schedule_orders_every_hazard(monkeypatch):
    """The CUDA ranks' schedule (`_ring_cuda`) with its streams, events
    and copies simulated on the CPU: each kernel and copy (the copy of x
    into the double buffer included) is queued on its stream and runs
    whole, in a random order that keeps stream order and event waits.
    Each rank has its own caller stream, as with one card per rank, and
    two calls, each from new caller streams, are queued before any op
    runs, on the same reused buffers, accumulators and events. Every order must give the plain result of
    each call; leaving out any one of the recv, free or send waits, or
    the waits of a call on the last one's kernels and copies, makes some
    order fail (checked when the schedule was written)."""
    import contextlib
    import ctypes
    import random

    current, device, keep = [None], [None], []
    callers = {}

    def current_stream(dev=None):
        return current[0] or callers.setdefault(str(dev or device[0]),
                                                _SimStream())

    @contextlib.contextmanager
    def on(cell, value):
        prev, cell[0] = cell[0], value
        try:
            yield
        finally:
            cell[0] = prev

    copy_ = torch.Tensor.copy_

    def step(lib, a_rot, s, buf, acc, out, stream):
        def run():                  # buf holds the x^T shard
            v = a_rot[:, s] @ buf.t() + (acc if s else 0)
            copy_(acc if out is None else out, v)
        stream.q.append(("op", run, None))

    def queued_copy(dst, src):
        current_stream().q.append(("op", lambda: copy_(dst, src), None))
        return dst

    class Lib:
        @staticmethod
        def ring_copy(dst, dst_dev, src, src_dev, nbytes, stream):
            stream.q.append(
                ("op", lambda: ctypes.memmove(dst, src, nbytes), None))
            return 0

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda st: on(current, st))
    monkeypatch.setattr(torch.cuda, "device", lambda d: on(device, d))
    monkeypatch.setattr(torch.cuda, "Event", _SimEvent)
    # record_stream keeps the memory from reuse; here: keeps it alive
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, st: keep.append(t))
    monkeypatch.setattr(thalo_k, "ring_step", step)
    rng = random.Random(0)
    for parts in (1, 2, 3, 4, 8):
        blocks = thalo_k._rotate_blocks(thalo.partition_adjacency(
            np.random.default_rng(parts).normal(size=(4 * parts, 4 * parts)),
            parts))
        a_rot = [torch.as_tensor(b) for b in blocks]
        comp = [_SimStream() for _ in range(parts)]
        copy = [_SimStream() for _ in range(parts)]
        # one caller stream per rank, as with one card per rank
        devs = [torch.device("cpu", p) for p in range(parts)]
        ring = thalo_k._RingState(Lib, devs, 4, 3, comp, copy)
        for _ in range(30):
            calls = [[torch.randn(4, 3) for _ in range(parts)]
                     for _ in range(2)]
            outs, streams = [], comp + copy
            monkeypatch.setattr(torch.Tensor, "copy_", queued_copy)
            for xs in calls:      # each call from other caller streams
                callers.clear()
                outs.append(thalo_k._ring_cuda(a_rot, xs, ring))
                streams += callers.values()
            monkeypatch.setattr(torch.Tensor, "copy_", copy_)
            while any(st.q for st in streams):
                ready = [st for st in streams if st.q and not (
                    st.q[0][0] == "wait" and st.q[0][1].done < st.q[0][2])]
                assert ready, "the schedule deadlocks"
                kind, obj, gen = rng.choice(ready).q.pop(0)
                if kind == "op":
                    obj()
                elif kind == "record":
                    obj.done = gen
            for out, xs in zip(outs, calls):
                for got, want in zip(out, thalo_k.ring_spmm_plain(a_rot, xs)):
                    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("parts", [2, 4])
def test_graph_matmul_through_sharded_support(parts):
    """`make_sharded_support` picks the same kind as the JAX package and
    `graph_matmul` (pad, sharded product, slice) gives the same values,
    from a dense graph and from a prebuilt edge-list partition."""
    jmesh, mesh = _meshes(parts)
    adj = _graph(67, seed=11, degree=8)
    rows, cols, vals = _banded_coo(130, seed=4)
    cases = [
        (jgc.make_sharded_support(adj, jmesh),
         tgc.make_sharded_support(adj, mesh), 67),
        (jgc.make_sharded_support(
            None, jmesh, jpart.partition_graph_coo(rows, cols, vals, 130,
                                                   parts)),
         tgc.make_sharded_support(
             None, mesh, tpart.partition_graph_coo(rows, cols, vals, 130,
                                                   parts)), 130),
    ]
    for jsup, tsup, n in cases:
        assert isinstance(tsup, tgc.ShardedSupport)
        assert (tsup.kind, tsup.n, tsup.n_pad) == (jsup.kind, jsup.n,
                                                   jsup.n_pad)
        x = np.random.default_rng(n).normal(size=(2, n, 3)).astype(np.float32)
        got = tgc.graph_matmul(tsup, torch.tensor(x)).numpy()
        assert got.shape == x.shape
        np.testing.assert_allclose(
            got, np.asarray(jgc.graph_matmul(jsup, jnp.asarray(x))), **F32)
    # make_support routes through the mesh whatever the node count
    assert isinstance(tgc.make_support(adj, mesh=mesh), tgc.ShardedSupport)
    with tgc.use_sharding_mesh(mesh):
        assert tgc.make_support(adj).kind == cases[0][1].kind
    assert not isinstance(tgc.make_support(adj, device="cpu"),
                          tgc.ShardedSupport)


N, B, U, T, H = 90, 3, 8, 6, 4


def _supports(kind):
    """A halo support from `make_sharded_support`, or a ring support
    built with `make_ring_spmm`, on P = 4 ranks in each package."""
    jmesh, mesh = _meshes(4)
    adj = _graph(N, seed=21)
    if kind == "halo":
        jsup = jgc.make_sharded_support(adj, jmesh)
        tsup = tgc.make_sharded_support(adj, mesh)
        assert jsup.kind == tsup.kind == "halo"
        return jsup, tsup
    jfn, n_pad = jhalo.make_ring_spmm(jmesh, adj)
    fn, _ = thalo.make_ring_spmm(mesh, adj)
    return (jgc.ShardedSupport(jfn, N, n_pad, "ring"),
            tgc.ShardedSupport(fn, N, n_pad, "ring"))


def _nonzero_params():
    """The port's TGCN init plus noise, so that every weight is nonzero
    (the GRU and readout biases start at zero), as a flax tree."""
    net = TGCN(TGCNConfig(num_nodes=N, rnn_units=U), dim_in=1, dim_out=1,
               horizon=H, generator=torch.Generator().manual_seed(1))
    noise = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=noise))
    return state_dict_to_flax(net.state_dict())


def _torch_tgcn(params):
    net = TGCN(TGCNConfig(num_nodes=N, rnn_units=U), dim_in=1, dim_out=1,
               horizon=H)
    net.load_state_dict(flax_to_state_dict(params))
    return net


@pytest.fixture(scope="module")
def jax_tgcn():
    """Per support kind: the port's support, and the JAX TGCN's jitted
    mean-absolute-error loss with its gradient (and prediction) on the
    JAX support. Compiled once for the gradient and trajectory tests."""
    model = JTGCN(cfg=JTGCNConfig(num_nodes=N, rnn_units=U), dim_in=1,
                  dim_out=1, horizon=H)
    out = {}
    for kind in ("halo", "ring"):
        jsup, tsup = _supports(kind)

        def loss(p, x, y, jsup=jsup):
            pred = model.apply(p, x, jsup)
            return jnp.abs(pred - y).mean(), pred

        out[kind] = (tsup, jax.jit(jax.value_and_grad(loss, has_aux=True)))
    return out


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, T, N, 1)).astype(np.float32),
             rng.standard_normal((B, H, N, 1)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["halo", "ring"])
def test_tgcn_sharded_forward_and_grads_match(jax_tgcn, kind):
    tsup, jvg = jax_tgcn[kind]
    params = _nonzero_params()
    ((x, y),) = _batches(1, 0)
    (_, jpred), jgrads = jvg(params, jnp.asarray(x), jnp.asarray(y))
    net = _torch_tgcn(params)
    pred = net(torch.tensor(x), tsup)
    (pred - torch.tensor(y)).abs().mean().backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=1e-4, atol=1e-6)
    tgrads = state_dict_to_flax({k: p.grad for k, p in net.named_parameters()})
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jgrads),
            jax.tree_util.tree_leaves(tgrads)):
        assert np.abs(np.asarray(want)).max() > 0, path
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


def test_tgcn_sharded_trajectory_matches_jax(jax_tgcn):
    """3 steps of clip(5) + Adam(1e-2) on the halo support, from the
    same nonzero weights, against optax on the JAX side."""
    tsup, jvg = jax_tgcn["halo"]
    batches = _batches(3, 1)
    params = _nonzero_params()
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-2))

    @jax.jit
    def apply(gr, s, p):
        upd, s = opt.update(gr, s, p)
        return optax.apply_updates(p, upd), s

    jlosses, p, s = [], params, jax.jit(opt.init)(params)
    for x, y in batches:
        (loss, _), gr = jvg(p, jnp.asarray(x), jnp.asarray(y))
        p, s = apply(gr, s, p)
        jlosses.append(float(loss))

    net = _torch_tgcn(params)
    topt = ClippedAdam(net.parameters(), lambda count: 1e-2, max_norm=5.0)
    tlosses = []
    for x, y in batches:
        topt.zero_grad()
        loss = (net(torch.tensor(x), tsup) - torch.tensor(y)).abs().mean()
        loss.backward()
        topt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-5)
    assert tlosses[-1] != tlosses[0]


def test_batch_major_cell_shares_the_node_major_parameters():
    """Both cells are `ScanGraphGRUCell_0` in flax: the same state_dict
    keys and shapes, so `convert.py` takes either."""
    a, b = GraphGRUCell(2, 5), GraphGRUCellNM(2, 5)
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    b.load_state_dict(a.state_dict())
    adj = torch.tensor(_graph(7, seed=1))
    h, x = torch.randn(3, 7, 5), torch.randn(3, 7, 2)
    torch.testing.assert_close(
        GraphGRUCellNM.forward(b, h.transpose(0, 1), x.transpose(0, 1),
                               adj).transpose(0, 1),
        a(h, x, adj), rtol=1e-5, atol=1e-6)


def test_build_model_with_a_mesh_gives_tgcn_a_sharded_support():
    mesh = make_mesh(devices=["cpu"] * 4, graph_axis_size=4)
    cfg = default_config("PEMS08", mode="ori", model="TGCN", num_nodes=42,
                         predictor_overrides=(("rnn_units", "4"),))
    model = build_model(cfg, device="cpu", mesh=mesh)
    (sup,) = model.predictor.graph
    assert isinstance(sup, tgc.ShardedSupport) and sup.kind == "halo"
    assert sup.n_pad == 44
    out = model(torch.zeros(2, cfg.lag, 42, 3)).pred
    assert out.shape == (2, cfg.horizon, 42, 1)
    assert tgc.sharding_mesh() is None
    plain = build_model(cfg, device="cpu")
    assert not isinstance(plain.predictor.graph[0], tgc.ShardedSupport)


def test_msdr_under_a_mesh_matches_jax():
    """MSDR built under a 4-rank graph mesh in both packages: the two
    static supports node-sharded (halo), the learned adjacency one dense
    product (no SDDMM pattern). Random nonzero weights (the port's init
    plus N(0, 0.1^2) noise: at MSDR's init W, b, R and the attention are
    zero and the learned-adjacency gradients vanish) go to both through
    `convert.py`; forward rtol 1e-4, every gradient rtol 1e-4 with an
    atol of 1e-4 of its largest entry (att_b's, zero in exact
    arithmetic, 1e-5), as `tests/test_torch_msdr.py` holds the
    unsharded model."""
    from gptst_tpu.config.config import default_config as jdefault_config
    from gptst_tpu.models import build as jbuild

    n = 64
    adj = random_sensor_graph(n, avg_degree=4, seed=0)
    kw = dict(mode="ori", model="MSDR", num_nodes=n,
              predictor_overrides=(("rnn_units", "8"),))
    jmesh, mesh = _meshes(4)
    model = build_model(default_config("PEMS08", **kw), adj=adj,
                        device="cpu", mesh=mesh)
    supports, pattern = model.predictor.graph
    assert pattern is None and all(
        isinstance(sp, tgc.ShardedSupport) and sp.kind == "halo"
        for sp in supports)
    noise = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(0.1 * torch.randn(prm.shape, generator=noise))
    params = state_dict_to_flax(model.predictor.net.state_dict())
    _, forward = jbuild.build_model(jdefault_config("PEMS08", **kw),
                                    adj=adj, mesh=jmesh)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, n, 3)).astype(np.float32)
    g = rng.standard_normal((2, 12, n, 1)).astype(np.float32)

    def jloss(prm):
        pred = forward(prm, jnp.asarray(x)).pred
        return jnp.sum(pred * g), pred

    (_, jpred), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pred = model(torch.tensor(x)).pred
    (pred * torch.tensor(g)).sum().backward()
    assert pred.shape == (2, 12, n, 1)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=1e-4, atol=1e-5)
    tgrads = state_dict_to_flax(
        {k: prm.grad for k, prm in model.predictor.net.named_parameters()})
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jgrads),
            jax.tree_util.tree_leaves(tgrads)):
        want = np.asarray(want)
        scale = 1e-1 if path[-1].key == "att_b" else np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=str(path))


def test_mesh_errors():
    with pytest.raises(ValueError, match="CPU devices or CUDA"):
        make_mesh(devices=["cpu", "cuda:0"], graph_axis_size=2)
    # a data axis above 1 is ported: the JAX package's shapes
    assert make_mesh(devices=["cpu"] * 4,
                     graph_axis_size=2).shape == {"data": 2, "graph": 2}
    mesh = make_mesh(devices=["cpu"] * 4)      # the default (2, 2) split
    assert mesh.shape == {"data": 2, "graph": 2}
    assert mesh.graph_devices(1) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not a visible CUDA device"):
        make_mesh(devices=[f"cuda:{torch.cuda.device_count()}"])
    mesh = make_mesh(devices=["cpu"] * 3, graph_axis_size=3)
    assert mesh.shape == {"data": 1, "graph": 3}
    assert mesh.graph_devices(0) == [torch.device("cpu")] * 3
    x = torch.arange(12.0).reshape(6, 2)
    torch.testing.assert_close(gather_rows(shard_rows(x, mesh), x.device), x)
    with pytest.raises(ValueError):
        shard_rows(x[:5], mesh)
