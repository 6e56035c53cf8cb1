"""kNN engine tests vs. numpy exact reference (mirrors reference
tests exercising FAISS wrappers indirectly through hand-checked fixtures)."""

import numpy as np
import pytest

from sph_tpu.ops.knn import (compute_knn, index_heuristic, knn_bruteforce,
                             knn_ivf)
from sph_tpu.settings import KnnIndex, KnnMetric
from sph_tpu.utils.testdata import create_3d_gaussians, create_random_data


def numpy_exact_knn(data, k):
    d2 = ((data[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dist = np.sqrt(np.take_along_axis(d2, idx, axis=1))
    return idx, dist


def test_bruteforce_matches_numpy():
    data = create_random_data(8, 200, seed=3)
    idx, dist = knn_bruteforce(data, 10)
    ridx, rdist = numpy_exact_knn(data, 10)
    assert np.allclose(np.sort(dist, axis=1), dist)  # ascending
    assert np.all(idx[:, 0] == np.arange(200))
    assert np.all(dist[:, 0] == 0)
    # distances must match the exact ones (indices may differ on ties)
    assert np.allclose(dist, rdist, atol=1e-4)


def test_bruteforce_blocking_edges():
    # n not a multiple of blocks
    data = create_random_data(5, 333, seed=7)
    idx, dist = knn_bruteforce(data, 7, row_block=64, col_block=128)
    ridx, rdist = numpy_exact_knn(data, 7)
    assert np.allclose(dist, rdist, atol=1e-4)
    assert np.all(idx >= 0)


def test_bruteforce_l2_squared():
    data = create_random_data(4, 100, seed=1)
    _, dist = knn_bruteforce(data, 5, l2_squared=True)
    _, dist_sqrt = knn_bruteforce(data, 5, l2_squared=False)
    assert np.allclose(np.sqrt(dist), dist_sqrt, atol=1e-4)


def test_cosine_metric():
    data = create_random_data(6, 150, seed=5) + 0.1
    idx, dist = knn_bruteforce(data, 5, metric=KnnMetric.COSINE)
    # chord distance on normalized vectors
    normed = data / np.linalg.norm(data, axis=1, keepdims=True)
    d2 = np.maximum(2 - 2 * normed @ normed.T, 0)
    rdist = np.sqrt(np.sort(d2, axis=1)[:, :5])
    assert np.allclose(np.sort(dist, axis=1), rdist, atol=1e-3)
    assert np.all(idx[:, 0] == np.arange(150))


def test_ivf_recall():
    pos, _ = create_3d_gaussians(2000, random_state=9,
                                 centers=np.array([[0, 0, 0], [8, 8, 8],
                                                   [-8, 8, 0]]))
    idx_e, dist_e = knn_bruteforce(pos, 10)
    idx_a, dist_a = knn_ivf(pos, 10, nlist=20, nprobe=5)
    # recall@10 should be high for well-separated clusters
    recall = np.mean([len(set(a) & set(b)) / 10.0
                      for a, b in zip(idx_e, idx_a)])
    assert recall > 0.95
    assert np.all(idx_a[:, 0] == np.arange(2000))


def test_index_heuristic():
    assert index_heuristic(5_000) == KnnIndex.BRUTE_FORCE
    # blocked-matmul exact tier extends past the reference's 10k CPU cutoff
    assert index_heuristic(50_000) == KnnIndex.BRUTE_FORCE
    assert index_heuristic(80_000) == KnnIndex.IVF_FLAT
    assert index_heuristic(1_000_000) == KnnIndex.HNSW


def test_knn_exact_rows_matches_bruteforce():
    from sph_tpu.ops.knn import knn_exact_rows
    pos, _ = create_3d_gaussians(500, random_state=4,
                                 centers=np.array([[0, 0, 0], [8, 8, 8]]))
    idx_e, dist_e = knn_bruteforce(pos, 8)
    rows = np.array([0, 17, 123, 499])
    ridx, rdist = knn_exact_rows(pos, rows, 8)
    np.testing.assert_array_equal(ridx, idx_e[rows])
    np.testing.assert_allclose(rdist, dist_e[rows], rtol=1e-6, atol=1e-6)


def test_ivf_missing_rows_refilled_exactly():
    # k larger than most inverted lists: IVF leaves -1s, the dispatch
    # must refill those rows with the exact pass instead of recomputing
    # the full N x N (reference: Knn.cpp:214-243 refill semantics)
    from sph_tpu.ops.knn import knn_ivf
    pos, _ = create_3d_gaussians(600, random_state=5,
                                 centers=np.array([[0, 0, 0], [9, 9, 9],
                                                   [-9, 9, 0]]))
    raw_i, _ = knn_ivf(pos, 64, seed=0)
    miss = np.unique(np.nonzero(raw_i < 0)[0])
    assert miss.size > 0, "config no longer exercises the refill path"
    idx, dist = compute_knn(pos, 64, KnnIndex.IVF_FLAT)
    assert np.all(idx >= 0)
    assert np.all(idx[:, 0] == np.arange(600))
    # the rows that were incomplete must now be EXACT (not approximate):
    # the driven property is the targeted refill, not aggregate IVF
    # recall, which is platform-sensitive at this tiny N / large k
    idx_e, dist_e = knn_bruteforce(pos, 64)
    sets_match = [set(idx[r]) == set(idx_e[r]) for r in miss]
    assert np.mean(sets_match) == 1.0
    np.testing.assert_allclose(np.sort(dist[miss], axis=1),
                               np.sort(dist_e[miss], axis=1),
                               rtol=1e-5, atol=1e-5)


def test_compute_knn_dispatch():
    data = create_random_data(4, 64, seed=2)
    i1, d1 = compute_knn(data, 5, KnnIndex.FLAT)
    i2, d2 = compute_knn(data, 5, KnnIndex.BRUTE_FORCE)
    assert np.allclose(d1, d2)


def test_ivf_quantized_recall():
    pos, _ = create_3d_gaussians(1500, random_state=4,
                                 centers=np.array([[0, 0, 0], [9, 9, 9]]))
    idx_e, _ = knn_bruteforce(pos, 8)
    idx_q, dist_q = knn_ivf(pos, 8, nlist=16, nprobe=6, quantize=True)
    recall = np.mean([len(set(a) & set(b)) / 8.0
                      for a, b in zip(idx_e, idx_q)])
    assert recall > 0.9
    assert np.all(np.diff(dist_q, axis=1) >= 0)


def test_compute_knn_quantized_tier():
    data = create_random_data(6, 300, seed=8)
    i, d = compute_knn(data, 6, KnnIndex.HNSWSQ)
    assert np.all(i[:, 0] == np.arange(300))


def test_connect_components_s_curve():
    """Sparse kNN on a noisy S-curve fragments into >1 weak components;
    connectComponents makes it one (reference:
    testConnectingComponentsKnnGraph, UtilsTests.cpp:662-703)."""
    from sph_tpu.models.nearest_neighbors import NearestNeighbors
    from sph_tpu.ops.graph import weak_connected_components
    from sph_tpu.settings import NearestNeighborsSettings
    from sph_tpu.utils.testdata import create_s_curve

    pos, _ = create_s_curve(1000, noise=0.2, random_state=123)
    nn = NearestNeighbors(pos.astype(np.float32),
                          NearestNeighborsSettings(num_nearest_neighbors=3))
    nn.compute()
    ncc, _ = nn.compute_connected_components()
    assert ncc > 1
    connected = nn.connect_components()
    new_ncc, _ = weak_connected_components(connected)
    assert new_ncc == 1


def test_knn_ivf_query_rows():
    """query_rows searches only the sampled queries; results match the
    full-graph IVF rows for those queries (same index seed)."""
    import numpy as np
    from sph_tpu.ops.knn import knn_ivf

    rng = np.random.default_rng(5)
    pos = rng.standard_normal((600, 8)).astype(np.float32)
    full_idx, full_dist = knn_ivf(pos, 6, nlist=24, nprobe=24)  # exhaustive
    q = np.array([3, 77, 410, 599])
    q_idx, q_dist = knn_ivf(pos, 6, nlist=24, nprobe=24, query_rows=q)
    for r, row in enumerate(q):
        # full path applies the self-first fixup, query path does not;
        # compare as sets + distances sorted
        assert set(q_idx[r]) == set(full_idx[row])
        assert np.allclose(np.sort(q_dist[r]), np.sort(full_dist[row]),
                           atol=1e-5)
