"""Device (XLA) merge + symmetrize vs the host paths.

VERDICT r1 item 3: the hierarchy's merge segment-sums and the kNN-graph
symmetrization move on-device; these tests pin layout equality and value
agreement (f32 reorder tolerance) against the host numpy/native paths on
randomized inputs including truncation, and exercise the public dispatch
via SPH_DEVICE_RESTRUCT=1.
"""

import os

import numpy as np
import pytest

from sph_tpu.ops.device_merge import (merge_by_parents_device,
                                      symmetrize_graph_device)
from sph_tpu.ops.graph import KnnGraph, symmetrize_graph
from sph_tpu.ops.sparse import (SparseRows, _compact, merge_rows_by_parents,
                                merge_rows_min_by_parents)


def random_sparse(n, r, num_cols=None, seed=0, zero_frac=0.1):
    rng = np.random.default_rng(seed)
    num_cols = num_cols or n
    idx = np.sort(rng.integers(0, num_cols, (n, r)).astype(np.int32), axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    idx = np.where(dup, -1, idx)
    val = np.where(idx >= 0, rng.random((n, r)).astype(np.float32), 0.0)
    val = np.where(rng.random((n, r)) < zero_frac, 0.0, val)
    idx = np.where(val == 0, -1, idx)
    return _compact(idx, val, num_cols)


def _pad_pair(a, b, fill):
    """Pad both arrays to a common width: the device path keeps power-of-two
    widths for compiled-program sharing, the host path exact widths."""
    w = max(a.shape[1], b.shape[1])

    def padto(x):
        out = np.full((x.shape[0], w), fill, x.dtype)
        out[:, :x.shape[1]] = x
        return out

    return padto(a), padto(b)


def host_only(fn, *args, **kw):
    os.environ["SPH_DEVICE_RESTRUCT"] = "0"
    try:
        return fn(*args, **kw)
    finally:
        os.environ["SPH_DEVICE_RESTRUCT"] = "1"


@pytest.fixture(autouse=True)
def force_device_dispatch():
    os.environ["SPH_DEVICE_RESTRUCT"] = "1"
    yield
    os.environ.pop("SPH_DEVICE_RESTRUCT", None)


@pytest.mark.parametrize("wbs", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_merge_sum_device_matches_host(wbs, seed):
    sr = random_sparse(400, 12, seed=seed)
    rng = np.random.default_rng(seed + 7)
    m = 90
    parents = rng.integers(0, m, 400)
    dev = merge_rows_by_parents(sr, parents, m, weight_by_size=wbs)
    host = host_only(merge_rows_by_parents, sr, parents, m,
                     weight_by_size=wbs)
    assert dev.num_rows == host.num_rows
    assert np.array_equal(*_pad_pair(dev.indices, host.indices, -1))
    assert np.allclose(*_pad_pair(dev.values, host.values, 0),
                       rtol=2e-5, atol=1e-7)


def test_merge_sum_device_truncation_keeps_largest():
    sr = random_sparse(600, 16, seed=1, zero_frac=0.0)
    parents = np.zeros(600, np.int64)   # one mega-parent -> wide row
    host = host_only(merge_rows_by_parents, sr, parents, 1,
                     weight_by_size=True, max_width=32)
    dev = merge_rows_by_parents(sr, parents, 1, weight_by_size=True,
                                max_width=32)
    assert dev.width <= 32 and host.width <= 32
    assert np.array_equal(dev.indices, host.indices)
    assert np.allclose(dev.values, host.values, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("wbs", [True, False])
@pytest.mark.parametrize("combine", ["sum", "min"])
def test_merge_lane_path_matches_host(wbs, combine):
    """Opt-in lane-local merge (SPH_MERGE_LANE_BUDGET) vs host path."""
    if combine == "min" and wbs:
        # min-merge has no size weighting by design (reference min
        # semantics: SparseMatrixAlgorithms.cpp:443-484 pick one exact
        # input value; weighting would change the value picked) — the
        # parameter is structurally unrepresentable, so passing it raises
        with pytest.raises(TypeError):
            merge_rows_min_by_parents(random_sparse(8, 3, seed=0),
                                      np.zeros(8, np.int64), 1,
                                      weight_by_size=True)
        return
    sr = random_sparse(400, 12, seed=11)
    rng = np.random.default_rng(13)
    m = 90
    parents = rng.integers(0, m, 400)
    fn = (merge_rows_by_parents if combine == "sum"
          else merge_rows_min_by_parents)
    kw = {"weight_by_size": wbs} if combine == "sum" else {}
    os.environ["SPH_MERGE_LANE_BUDGET"] = str(1 << 16)
    try:
        dev = fn(sr, parents, m, **kw)
    finally:
        os.environ.pop("SPH_MERGE_LANE_BUDGET", None)
    host = host_only(fn, sr, parents, m, **kw)
    assert np.array_equal(*_pad_pair(dev.indices, host.indices, -1))
    if combine == "min":
        assert np.array_equal(*_pad_pair(dev.values, host.values, 0))
    else:
        assert np.allclose(*_pad_pair(dev.values, host.values, 0),
                           rtol=2e-5, atol=1e-7)


def test_merge_min_device_matches_host():
    sr = random_sparse(300, 10, seed=5)
    parents = np.random.default_rng(2).integers(0, 40, 300)
    dev = merge_rows_min_by_parents(sr, parents, 40)
    host = host_only(merge_rows_min_by_parents, sr, parents, 40)
    assert np.array_equal(*_pad_pair(dev.indices, host.indices, -1))
    # min semantics pick one exact input value: bitwise equal
    assert np.array_equal(*_pad_pair(dev.values, host.values, 0))


def test_merge_min_device_truncation_keeps_smallest():
    sr = random_sparse(500, 8, seed=9, zero_frac=0.0)
    parents = np.zeros(500, np.int64)
    dev = merge_rows_min_by_parents(sr, parents, 1, max_width=16)
    host = host_only(merge_rows_min_by_parents, sr, parents, 1,
                     max_width=16)
    assert np.array_equal(dev.indices, host.indices)
    assert np.array_equal(dev.values, host.values)


def test_merge_device_rejects_out_of_domain():
    idx = np.array([[0, 999]], np.int32)
    val = np.ones((1, 2), np.float32)
    assert merge_by_parents_device(idx, val, np.zeros(1, np.int64), 1,
                                   False, "sum", None) is None


def random_knn(n, k, seed):
    rng = np.random.default_rng(seed)
    idx = np.empty((n, k), np.int32)
    idx[:, 0] = np.arange(n)
    for i in range(n):
        idx[i, 1:] = rng.choice(n, k - 1, replace=False)
    dist = np.sort(rng.random((n, k)).astype(np.float32), axis=1)
    dist[:, 0] = 0.0
    return KnnGraph(idx, dist)


@pytest.mark.parametrize("seed", [0, 4])
def test_symmetrize_device_matches_host(seed):
    g = random_knn(250, 6, seed)
    dev = symmetrize_graph(g)
    host = host_only(symmetrize_graph, g)
    assert np.array_equal(dev.counts, host.counts)
    for i in range(250):
        ia, da = dev.row(i)
        ib, db = host.row(i)
        assert sorted(ia.tolist()) == sorted(ib.tolist())
        assert np.allclose(np.sort(da), np.sort(db))
        assert ia[0] == i and da[0] == 0
        assert np.all(np.diff(da) >= 0)


def test_symmetrize_device_min_dedup():
    idx = np.array([[0, 1], [1, 0], [2, 0]], np.int32)
    dist = np.array([[0, 1], [0, 3], [0, 5]], np.float32)
    oi, od, oc = symmetrize_graph_device(idx, dist, 0)
    assert oi[0].tolist()[:3] == [0, 1, 2]
    assert np.allclose(od[0][:3], [0, 1, 5])
    assert oc.tolist() == [3, 2, 2]


def test_symmetrize_device_width_cap():
    # star graph: node 0 is in everyone's list -> hub row
    n = 64
    idx = np.stack([np.arange(n, dtype=np.int32),
                    np.zeros(n, np.int32)], axis=1)
    idx[0, 1] = 1
    dist = np.stack([np.zeros(n, np.float32),
                     np.linspace(0.1, 1.0, n).astype(np.float32)], axis=1)
    oi, od, oc = symmetrize_graph_device(idx, dist, 8)
    assert oi.shape[1] == 8
    # hub keeps its 7 closest neighbors after the self slot
    assert oi[0, 0] == 0 and np.all(np.diff(od[0]) >= 0)


def test_symmetrize_device_rejects_out_of_domain():
    idx = np.array([[0, 9]], np.int32)
    dist = np.zeros((1, 2), np.float32)
    assert symmetrize_graph_device(idx, dist, 0) is None


def test_full_hierarchy_device_equals_host():
    """The complete hierarchy (merges + symmetrize on device) must produce
    identical levels and parents to the host path."""
    from sph_tpu import (ComputeHierarchy, ImageHierarchySettings,
                         ImageStack, LevelSimilaritiesSettings,
                         NearestNeighborsSettings, RandomWalkSettings,
                         Scaler, scale)
    from sph_tpu.utils.testdata import create_checker_image

    img = create_checker_image(8, 8, channels=4, block=2, noise=0.02)
    stack = ImageStack.from_array(img)
    data = scale(stack.data, Scaler.STANDARD)

    def build():
        ch = ComputeHierarchy().init(
            data, 8, 8,
            ihs=ImageHierarchySettings(),
            lss=LevelSimilaritiesSettings(ks=[8]),
            rws=RandomWalkSettings(num_random_walks=10,
                                   single_walk_length=5, random_seed=1),
            nns=NearestNeighborsSettings(num_nearest_neighbors=8))
        ch.compute()
        return ch.image_hierarchy.hierarchy

    h_dev = build()                      # SPH_DEVICE_RESTRUCT=1 (fixture)
    h_host = host_only(build)
    assert h_dev.num_components == h_host.num_components
    for a, b in zip(h_dev.parents, h_host.parents):
        assert np.array_equal(a, b)


def test_connect_components_device_equals_host():
    """The device connect path (matmul closest pairs + targeted row updates)
    must produce the same connected graph as the host path."""
    import jax.numpy as jnp

    from sph_tpu.models.nearest_neighbors import NearestNeighbors
    from sph_tpu.settings import NearestNeighborsSettings
    from sph_tpu.ops.graph import PaddedGraph

    rng = np.random.default_rng(3)
    # three well-separated blobs so the kNN graph has >1 component
    blobs = [rng.normal(c, 0.05, (40, 6)) for c in (0.0, 10.0, 30.0)]
    data = np.concatenate(blobs).astype(np.float32)
    nns = NearestNeighborsSettings(num_nearest_neighbors=8,
                                   symmetric_neighbors=True,
                                   compute_connect_components=True,
                                   neighbor_connect_components=True)

    host = NearestNeighbors(data, nns)
    host.compute()
    g_host = host.connected_graph
    assert host.num_connected_components == 3

    dev = NearestNeighbors(data, nns)
    dev._nns = nns
    # rebuild with a device-resident symmetrized graph to force the
    # device insert path
    from sph_tpu.ops.knn import compute_knn
    from sph_tpu.ops.graph import KnnGraph, symmetrize_graph
    idx, dist = compute_knn(data, 8)
    dev.knn_graph = KnnGraph(idx, dist)
    sym = host.sym_graph
    dev.sym_graph = PaddedGraph(jnp.asarray(sym.indices),
                                jnp.asarray(sym.distances),
                                jnp.asarray(sym.counts))
    assert dev.sym_graph.device_only
    dev.compute_connected_components()
    g_dev = dev.connect_components()

    assert np.array_equal(g_dev.counts, g_host.counts)
    assert np.array_equal(*_pad_pair(g_dev.indices, g_host.indices, -1))
    assert np.allclose(*_pad_pair(
        np.where(g_dev.indices >= 0, g_dev.distances, 0.0),
        np.where(g_host.indices >= 0, g_host.distances, 0.0), 0.0),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["tsne", "umap"])
def test_symmetrize_p_device_matches_scipy(mode):
    """Transpose-only device symmetrization == the scipy union formulas."""
    import jax.numpy as jnp

    from sph_tpu.ops.sparse import (symmetrize_tsne, symmetrize_umap,
                                    _symmetrize_p_device_dispatch)

    sr = random_sparse(120, 9, seed=11)
    fn = symmetrize_tsne if mode == "tsne" else symmetrize_umap
    want = fn(sr)  # host-backed input -> scipy path
    dev_in = SparseRows(jnp.asarray(sr.indices), jnp.asarray(sr.values),
                        sr.num_cols)
    got = _symmetrize_p_device_dispatch(dev_in, mode)
    assert np.array_equal(*_pad_pair(got.indices, want.indices, -1))
    assert np.allclose(*_pad_pair(got.values, want.values, 0),
                       rtol=1e-6, atol=1e-7)


def test_use_device_restruct_follows_backend(monkeypatch):
    """Auto mode: the host merges on the CPU backend, the device kernels
    on any accelerator; the variable forces either way."""
    from sph_tpu.ops import device_merge
    monkeypatch.setenv("SPH_DEVICE_RESTRUCT", "auto")
    assert not device_merge.use_device_restruct()
    monkeypatch.setattr(device_merge.jax, "default_backend", lambda: "gpu")
    assert device_merge.use_device_restruct()
    monkeypatch.setenv("SPH_DEVICE_RESTRUCT", "0")
    assert not device_merge.use_device_restruct()
    monkeypatch.setenv("SPH_DEVICE_RESTRUCT", "1")
    monkeypatch.setattr(device_merge.jax, "default_backend", lambda: "cpu")
    assert device_merge.use_device_restruct()
