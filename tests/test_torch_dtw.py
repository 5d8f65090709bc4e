"""The port's DTW graph builders, its native DTW library and its prefab
readers against the JAX package's, on the CPU.

  * both DTW paths, each against the same path of the JAX package, on
    N = 6 nodes, 24 steps a day, 3 days: the C++ library (float32
    series, double sums; the port's own build in
    `gptst_tpu_torch/_build/`) and the numpy path (float64), for
    `dtw_distance_matrix`, `stfgnn_dtw_graph`, `stgode_dtw_graph`,
    `daily_profiles` and `banded_dtw_all_pairs`: equal (the same
    operations in the same order);
  * the readers (`weight_matrix_csv`, `stgode_semantic_graph`,
    `stgode_spatial_graph`, `load_stgode_prefabs`,
    `load_stfgnn_fusion_prefab`, `load_stmgcn_prefabs`) on small files
    the test writes: equal;
  * `cached_artifact`: neither package reads the other's cache file.
"""

import numpy as np
import pytest

from gptst_tpu.graph import dtw as jdtw
from gptst_tpu.graph import io as jio
from gptst_tpu_torch import native as tnative
from gptst_tpu_torch.graph import dtw as tdtw
from gptst_tpu_torch.graph import io as tio
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPD, DAYS, N = 24, 3, 6


def _series(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(SPD * DAYS)
    base = np.sin(2 * np.pi * t / SPD)[:, None] * rng.random(N)
    return (base + 0.3 * rng.standard_normal((SPD * DAYS, N))).astype(
        np.float32)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """The C++ path (the port's library must build here) or the numpy
    path (both packages' native entry points return None)."""
    if request.param == "numpy":
        import gptst_tpu.native as jnative

        monkeypatch.setattr(jnative, "native_banded_dtw_pairs",
                            lambda *a, **k: None)
        monkeypatch.setattr(tnative, "native_banded_dtw_pairs",
                            lambda *a, **k: None)
    else:
        assert tnative.load("dtw") is not None
    return request.param


def test_dtw_graphs_equal_jax(path):
    x = _series()
    np.testing.assert_array_equal(tdtw.daily_profiles(x, SPD),
                                  jdtw.daily_profiles(x, SPD))
    by_day = x.reshape(DAYS, SPD, N)
    for radius, order in ((3, 1), (5, 2)):
        np.testing.assert_array_equal(
            tdtw.dtw_distance_matrix(by_day, radius, order),
            jdtw.dtw_distance_matrix(by_day, radius, order))
    graphs = {}
    for name, kw in (("stfgnn", dict(radius=4, sparsity=0.4)),
                     ("stgode", dict(radius=2, sigma=1.0, thres=0.5))):
        got = getattr(tdtw, f"{name}_dtw_graph")(x, SPD, **kw)
        np.testing.assert_array_equal(
            got, getattr(jdtw, f"{name}_dtw_graph")(x, SPD, **kw))
        graphs[name] = got
    # neither graph is trivial
    assert 0 < graphs["stfgnn"].sum() - N < N * (N - 1)
    assert 0 < graphs["stgode"].sum() < N * N


def test_native_library_is_the_ports_own_and_agrees_with_numpy():
    lib = tnative.load("dtw")
    assert lib is not None
    assert tnative.library_path("dtw").parent.name == "_build"
    assert "gptst_tpu_torch" in str(tnative.library_path("dtw"))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((DAYS, SPD, N)).astype(np.float32)
    iu, ju = np.triu_indices(N, k=1)
    costs = tnative.native_banded_dtw_pairs(x, iu, ju, 3)
    local = np.abs(x[:, :, iu][:, None] - x[:, :, ju][:, :, None]).sum(0)
    want = tdtw.banded_dtw_all_pairs(np.moveaxis(local, 2, 0), 3)
    np.testing.assert_array_equal(
        want, jdtw.banded_dtw_all_pairs(np.moveaxis(local, 2, 0), 3))
    # the numpy path sums the f32 local costs in f32, the library in
    # double: rtol 1e-5
    np.testing.assert_allclose(costs, want, rtol=1e-5)
    with pytest.raises(ValueError, match="outside"):
        tnative.native_banded_dtw_pairs(x, iu, ju + N, 3)


def test_prefab_readers_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 8
    dist = 30000 * rng.random((n, n))
    np.savetxt(tmp_path / "dist.csv", dist, delimiter=",")
    np.savetxt(tmp_path / "binary.csv", (dist > 15000).astype(float),
               delimiter=",")
    for name in ("dist.csv", "binary.csv"):
        for scaling in (True, False):
            np.testing.assert_array_equal(
                tio.weight_matrix_csv(str(tmp_path / name), scaling=scaling),
                jio.weight_matrix_csv(str(tmp_path / name), scaling=scaling))
    d = rng.random((n, n))
    np.testing.assert_array_equal(tio.stgode_semantic_graph(d),
                                  jio.stgode_semantic_graph(d))
    sp = 100 * rng.random((n, n))
    sp[rng.random((n, n)) < 0.3] = np.inf
    np.testing.assert_array_equal(tio.stgode_spatial_graph(sp),
                                  jio.stgode_spatial_graph(sp))
    root = str(tmp_path)
    for reader, args in (("load_stgode_prefabs", ("PEMS08",)),
                         ("load_stfgnn_fusion_prefab", ("PEMS08",)),
                         ("load_stmgcn_prefabs", ("NYC_TAXI",)),
                         ("load_stmgcn_prefabs", ("PEMS08",))):
        assert getattr(tio, reader)(root, *args) is None
        assert getattr(jio, reader)(root, *args) is None
    (tmp_path / "STGODE" / "PEMS08").mkdir(parents=True)
    np.save(tmp_path / "STGODE" / "PEMS08" / "PEMS08_dtw_distance.npy", d)
    np.save(tmp_path / "STGODE" / "PEMS08" / "PEMS08_spatial_distance.npy",
            sp)
    (tmp_path / "STFGNN" / "PEMS08").mkdir(parents=True)
    np.save(tmp_path / "STFGNN" / "PEMS08" / "PEMS08_adj_mx.npy",
            rng.random((4 * n, 4 * n)))
    (tmp_path / "STMGCN_demand").mkdir()
    for name in ("dis_tt", "pcc_tt"):
        np.savetxt(tmp_path / "STMGCN_demand" / f"{name}.csv",
                   rng.random((n, n)), delimiter=",")
    for reader, ds in (("load_stgode_prefabs", "PEMS08"),
                       ("load_stfgnn_fusion_prefab", "PEMS08"),
                       ("load_stmgcn_prefabs", "NYC_TAXI")):
        got, want = getattr(tio, reader)(root, ds), getattr(jio, reader)(
            root, ds)
        for g, w in zip(np.atleast_1d(got) if isinstance(got, tuple)
                        else [got], want if isinstance(want, tuple)
                        else [want]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_neither_package_reads_the_others_cache(tmp_path):
    key = [np.arange(10.0)]
    jdtw.cached_artifact(str(tmp_path), "g", key, lambda: np.zeros(2))
    got = tdtw.cached_artifact(str(tmp_path), "g", key, lambda: np.ones(2))
    np.testing.assert_array_equal(got, np.ones(2))
    again = jdtw.cached_artifact(str(tmp_path), "g", key,
                                 lambda: np.full(2, 5.0))
    np.testing.assert_array_equal(again, np.zeros(2))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and names[1] == "torch_" + names[0]
