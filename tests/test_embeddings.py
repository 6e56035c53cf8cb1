"""Embedding engine tests: t-SNE KL decrease + cluster separation, UMAP
structure preservation (the reference validates via HDILib/umappp internals;
here: quality-of-result invariants on seeded blob data)."""

import numpy as np
import pytest

from sph_tpu.models.compute_embedding import (ComputeEmbedding,
                                              ComputeEmbeddingSettings)
from sph_tpu.models.tsne import (TsneComputation, TsneParameters,
                                 default_exaggeration)
from sph_tpu.models.umap import (UmapComputation, UmapParameters,
                                 choose_num_epochs, find_ab,
                                 make_epochs_per_sample)
from sph_tpu.ops.knn import knn_bruteforce
from sph_tpu.ops.sparse import SparseRows, symmetrize_tsne
from sph_tpu.ops.distributions import gaussian_row_distributions
from sph_tpu.utils.testdata import create_3d_gaussians

import jax.numpy as jnp


def blob_probdist(n=120, k=15, seed=4):
    centers = np.array([[0, 0, 0], [12, 0, 0], [0, 12, 0]])
    pos, labels = create_3d_gaussians(n, random_state=seed, centers=centers)
    idx, dist = knn_bruteforce(pos, k)
    mask = np.ones_like(idx, dtype=bool)
    p = gaussian_row_distributions(jnp.asarray(dist ** 2), jnp.asarray(mask),
                                   jnp.float32((k - 1) / 3), ignore_first=True)
    rows = SparseRows(idx.astype(np.int32), np.asarray(p), n)
    return symmetrize_tsne(rows), labels, pos


def cluster_separation(emb, labels):
    """Mean inter-centroid distance / mean intra-cluster spread."""
    cents = np.stack([emb[labels == c].mean(0) for c in np.unique(labels)])
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[i], axis=1).mean()
                     for i, c in enumerate(np.unique(labels))])
    inter = np.mean([np.linalg.norm(cents[i] - cents[j])
                     for i in range(len(cents)) for j in range(i)])
    return inter / max(intra, 1e-9)


def test_default_exaggeration():
    # reference: clamp(4 + N/60000, 4, 20) (EmbedTsne.cpp:138-139)
    assert np.isclose(default_exaggeration(1000), 4.0 + 1000 / 60000)
    assert np.isclose(default_exaggeration(600_000), 14.0)
    assert default_exaggeration(10_000_000) == 20.0


def test_tsne_kl_decreases_and_separates():
    p, labels, _ = blob_probdist()
    params = TsneParameters(num_iterations=400,
                            remove_exaggeration_iter=150,
                            mom_switching_iter=150)
    tsne = TsneComputation(params, block=64)
    tsne.set_probability_distribution(p)
    tsne.compute(50, verbose=False)
    kl_early = tsne.kl_divergence()
    tsne.continue_gradient_descent(350, verbose=False)
    kl_late = tsne.kl_divergence()
    assert np.isfinite(kl_early) and np.isfinite(kl_late)
    assert kl_late < kl_early
    emb = tsne.embedding
    assert emb.shape == (120, 2)
    assert np.all(np.isfinite(emb))
    assert cluster_separation(emb, labels) > 2.0


def test_tsne_deterministic():
    p, _, _ = blob_probdist()
    outs = []
    for _ in range(2):
        t = TsneComputation(TsneParameters(num_iterations=100), block=64)
        t.set_probability_distribution(p)
        t.set_initial_embedding(np.linspace(
            -0.1, 0.1, 240, dtype=np.float32).reshape(120, 2))
        t.compute(100, verbose=False)
        outs.append(t.embedding)
    assert np.allclose(outs[0], outs[1])


def test_tsne_single_point():
    emb_settings = ComputeEmbeddingSettings()
    ce = ComputeEmbedding(emb_settings)
    p = SparseRows.from_dense(np.array([[1.0]], np.float32))
    out = ce.compute_tsne(p)
    assert out.shape == (1, 2)
    assert np.all(out == 0)


def test_find_ab_defaults():
    a, b = find_ab(1.0, 0.1)
    # umap-learn canonical values for spread=1, min_dist=0.1
    assert np.isclose(a, 1.577, atol=0.05)
    assert np.isclose(b, 0.8951, atol=0.02)


def test_choose_num_epochs():
    assert choose_num_epochs(250, 100) == 250
    assert choose_num_epochs(-1, 100) == 500
    assert choose_num_epochs(-1, 100_000) == 200


def test_make_epochs_per_sample():
    w = np.array([1.0, 0.5, 0.1])
    eps = make_epochs_per_sample(w, 100)
    assert np.allclose(eps, [1.0, 2.0, 10.0])


def test_umap_separates_blobs():
    p, labels, _ = blob_probdist()
    umap = UmapComputation(UmapParameters(num_epochs=150, seed=3))
    umap.set_neighbor_matrix(p)
    umap.compute()
    emb = umap.embedding
    assert emb.shape == (120, 2)
    assert np.all(np.isfinite(emb))
    assert cluster_separation(emb, labels) > 1.5


def test_compute_embedding_facade():
    p, labels, _ = blob_probdist()
    s = ComputeEmbeddingSettings()
    s.tsne.num_iterations = 150
    ce = ComputeEmbedding(s)
    emb = ce.compute_tsne(p, track_kl=True)
    assert emb.shape == (120, 2)
    assert ce.last_kl is not None and np.isfinite(ce.last_kl)
    emb2 = ce.compute_umap(p)
    assert emb2.shape == (120, 2)


def test_kl_nonnegative_with_diagonal_p_mass():
    """KL must stay a proper (non-negative) divergence even when P carries
    diagonal mass (walks-as-distances levels where a merged row's self
    similarity is not its largest entry)."""
    import numpy as np
    from sph_tpu.models.tsne import TsneComputation, TsneParameters
    from sph_tpu.ops.sparse import SparseRows
    rng = np.random.default_rng(0)
    n = 8
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 3.0)   # heavy diagonal mass
    d /= d.sum()
    p = SparseRows.from_dense(d)
    t = TsneComputation(TsneParameters(num_iterations=200))
    t.set_probability_distribution(p)
    t.compute(verbose=False)
    assert t.kl_divergence() >= 0.0


def test_grid_repulsion_matches_exact():
    """Grid-interpolated repulsion (ops/tsne_grid.py) vs exact tiled
    repulsion: forces and Z agree to interpolation error on a realistic
    clustered layout."""
    from sph_tpu.models.tsne import _repulsive_forces
    from sph_tpu.ops.tsne_grid import grid_repulsion, pick_grid_size

    rng = np.random.default_rng(3)
    n = 1500
    y = (rng.standard_normal((n, 2)) * 4.0).astype(np.float32)
    y += rng.choice([-10.0, 0.0, 10.0], size=(n, 2)).astype(np.float32)
    npad = 1536
    yp = np.zeros((npad, 2), np.float32)
    yp[:n] = y
    yj = jnp.asarray(yp)
    rex, zex = _repulsive_forces(yj, jnp.int32(n), 256)
    g = pick_grid_size(float(y.max() - y.min()))
    rgr, zgr = grid_repulsion(yj, jnp.int32(n), g)
    rex = np.asarray(rex)[:n]
    rgr = np.asarray(rgr)[:n]
    assert abs(float(zgr) - float(zex)) / float(zex) < 5e-3
    rel = np.linalg.norm(rgr - rex) / np.linalg.norm(rex)
    assert rel < 2e-2
    # pad rows carry no force
    assert np.all(np.asarray(rgr == rgr))
    assert np.allclose(np.asarray(grid_repulsion(yj, jnp.int32(n), g)[0])[n:],
                       0.0)


def test_tsne_grid_mode_quality(monkeypatch):
    """End-to-end t-SNE with grid repulsion forced on: KL lands within a
    few % of the exact path on identical P (the VERDICT acceptance bar for
    the large-N tier, checked at small N where exact is cheap)."""
    p, labels, _ = blob_probdist(n=240, k=15, seed=11)
    params = TsneParameters(num_iterations=350,
                            remove_exaggeration_iter=120,
                            mom_switching_iter=120)

    def run(grid_env):
        monkeypatch.setenv("SPH_TSNE_GRID", grid_env)
        tsne = TsneComputation(params, block=64)
        tsne.set_probability_distribution(p)
        tsne.set_initial_embedding(
            np.asarray(np.random.default_rng(0).standard_normal(
                (240, 2)) * 0.05, np.float32))
        tsne.compute(verbose=False)
        monkeypatch.setenv("SPH_TSNE_GRID", "0")
        kl = tsne.kl_divergence()
        return kl, tsne.embedding

    kl_exact, _ = run("0")
    kl_grid, emb = run("1")
    assert np.all(np.isfinite(emb))
    assert cluster_separation(emb, labels) > 2.0
    # within a few % of the exact optimizer's KL
    assert kl_grid < kl_exact * 1.05 + 0.02


def test_attractive_forces_chunked_parity(monkeypatch):
    """Row-chunked sparse attraction (the >33M-entry tier that avoids the
    multi-GB fusion buffers at N=1M, R=128) is
    bit-identical to the single-fusion path."""
    from sph_tpu.models.tsne import _attractive_forces

    rng = np.random.default_rng(3)
    n, w = 1003, 37
    y = jnp.asarray(rng.standard_normal((n, 2)).astype(np.float32))
    pi = rng.integers(0, n, (n, w)).astype(np.int32)
    pi[rng.random((n, w)) < 0.1] = -1
    pv = rng.random((n, w)).astype(np.float32)
    pi_j, pv_j = jnp.asarray(pi), jnp.asarray(pv)

    monkeypatch.setenv("SPH_TSNE_ATTR_FUSE_MAX", str(1 << 30))
    fused = np.asarray(_attractive_forces(y, pi_j, pv_j))
    monkeypatch.setenv("SPH_TSNE_ATTR_FUSE_MAX", "1")
    _attractive_forces._clear_cache()
    chunked = np.asarray(_attractive_forces(y, pi_j, pv_j))
    _attractive_forces._clear_cache()
    np.testing.assert_array_equal(fused, chunked)

    # packed-bf16 single-gather tier: the neighbor position is quantized
    # to bf16 (RTN), everything else identical — force error stays within
    # a few bf16 ulps of the exact f32 result
    packed = np.asarray(_attractive_forces(y, pi_j, pv_j, True))
    _attractive_forces._clear_cache()
    assert np.isfinite(packed).all()
    scale = np.abs(fused).max()
    err = np.abs(packed - fused) / scale
    assert err.max() < 2e-2, err.max()
    assert np.median(err) < 2e-3


def test_tsne_grid_tier_configuration(monkeypatch):
    """The large-N tier wiring: grid mode activates above SPH_TSNE_GRID_MIN
    and brings the P width cap + packed single-gather attraction with it;
    below the threshold none of the three engage."""
    p, _, _ = blob_probdist(n=300, k=24, seed=3)

    monkeypatch.setenv("SPH_TSNE_GRID_MIN", "200")
    monkeypatch.setenv("SPH_TSNE_GRID_P_WIDTH", "16")
    t = TsneComputation(TsneParameters(num_iterations=1))
    t.set_probability_distribution(p)
    t._init_gradient_descent()
    assert t._use_grid and t._attr_packed
    assert t._p.width <= 16
    # padded P width follows the cap (pow2 bucket)
    assert t._p_idx.shape[1] <= 16

    monkeypatch.setenv("SPH_TSNE_GRID_MIN", "100000")
    t2 = TsneComputation(TsneParameters(num_iterations=1))
    t2.set_probability_distribution(p)
    t2._init_gradient_descent()
    assert not t2._use_grid and not t2._attr_packed
    assert t2._p.width > 16  # no grid-tier cap applied

    # forcing packed works without grid mode
    monkeypatch.setenv("SPH_TSNE_ATTR_PACKED", "1")
    t3 = TsneComputation(TsneParameters(num_iterations=1))
    t3.set_probability_distribution(p)
    t3._init_gradient_descent()
    assert t3._attr_packed and not t3._use_grid


def test_umap_tiers_agree_on_attraction_only():
    """With negative_sample_rate=0 the three optimizer tiers share exact
    semantics (scheduled, clipped, batched attraction over a symmetric
    membership): dense == rows == edges up to f32 summation order.

    The epoch count is kept small on purpose: the SGD map is chaotic, so
    per-epoch summation-order roundoff (~1e-7) amplifies exponentially
    (measured: 8e-6 at 8 epochs -> 0.87 at 30 epochs).  Eight epochs sits
    inside the window where any *semantic* difference between the tiers
    would still dwarf accumulated roundoff."""
    import os
    import numpy as np
    from sph_tpu.models.umap import UmapComputation, UmapParameters
    from sph_tpu.ops.sparse import SparseRows, symmetrize_umap

    rng = np.random.default_rng(3)
    n, k = 120, 8
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(n)])
    val = rng.random((n, k)).astype(np.float32) * 0.9 + 0.1
    m = symmetrize_umap(SparseRows(idx.astype(np.int32), val, n))

    init = (rng.standard_normal((n, 2)) * 5.0).astype(np.float32)

    def run(env):
        for kk, vv in env.items():
            os.environ[kk] = vv
        try:
            u = UmapComputation(UmapParameters(
                num_epochs=8, seed=11, negative_sample_rate=0))
            u.set_neighbor_matrix(m)
            # fixed init: the spectral solver's iterative start is not
            # seeded, so compute()'s default init differs run to run
            u.set_initial_embedding(init)
            u.compute()
            return u.embedding.copy()
        finally:
            for kk in env:
                os.environ.pop(kk, None)

    dense = run({})
    rows = run({"SPH_UMAP_DENSE_MAX": "0", "SPH_UMAP_PACKED": "0"})
    edges = run({"SPH_UMAP_EDGE_PATH": "1"})
    assert np.allclose(dense, rows, rtol=1e-4, atol=1e-5)
    # the edge tier's .at[].add scatters accumulate in a different order
    # than the row reductions, so its roundoff floor is higher (measured
    # 4.3e-5 at 8 epochs, exact at 1 epoch)
    assert np.allclose(dense, edges, rtol=1e-3, atol=5e-4)


def test_dense_p_selected_by_size(monkeypatch):
    """Dense joint P up to SPH_TSNE_DENSE_P_MAX points on every backend;
    above it (or in the grid tier) the sparse attraction runs."""
    from sph_tpu.models.tsne import dense_tiling, use_dense_p
    p, _, _ = blob_probdist(n=300, k=24, seed=3)

    def init(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        t = TsneComputation(TsneParameters(num_iterations=1))
        t.set_probability_distribution(p)
        t._init_gradient_descent()
        return t

    t = init()
    assert use_dense_p(300) and t._p_dense is not None
    assert (t._block_eff, t._npad) == dense_tiling(300)
    assert t._npad % t._block_eff == 0 and t._npad >= 300
    assert t._p_dense.shape == (t._npad, t._npad)
    assert np.isclose(float(t._p_dense.sum()), 1.0, rtol=1e-5)

    t = init(SPH_TSNE_DENSE_P_MAX="299")
    assert not use_dense_p(300) and t._p_dense is None

    t = init(SPH_TSNE_DENSE_P_MAX="32768", SPH_TSNE_GRID_MIN="200")
    assert t._use_grid and t._p_dense is None


@pytest.mark.parametrize("n", [300, 5358, 16384, 16385, 28807, 32768])
def test_dense_tiling(n):
    """One tile up to 16384 padded points, equal row tiles of at most
    DENSE_TILE_ELEMS elements above."""
    from sph_tpu.models.tsne import (DENSE_ONE_TILE_MAX, DENSE_TILE_ELEMS,
                                     dense_tiling)
    rows, npad = dense_tiling(n)
    assert npad >= n and npad % rows == 0 and rows % 128 == 0
    if n <= DENSE_ONE_TILE_MAX:
        assert rows == npad == -(-n // 128) * 128
    else:
        assert rows < npad and rows * npad <= DENSE_TILE_ELEMS + 128 * npad
        assert npad - n < npad // 8


def test_dense_and_sparse_paths_agree(monkeypatch):
    """The fused dense-P pass and the sparse attraction + tiled repulsion
    are the same forces: a short run lands on the same embedding.  Kept
    to a few iterations because the gains update amplifies summation-order
    roundoff exponentially (measured 1e-7 after 1, 9e-6 after 5, O(1)
    after 30)."""
    p, _, _ = blob_probdist(n=200, k=15, seed=5)
    init = np.asarray(np.random.default_rng(1).standard_normal((200, 2))
                      * 0.05, np.float32)

    def run(dense_max):
        monkeypatch.setenv("SPH_TSNE_DENSE_P_MAX", dense_max)
        t = TsneComputation(TsneParameters(num_iterations=3), block=64)
        t.set_probability_distribution(p)
        t.set_initial_embedding(init)
        t.compute(verbose=False)
        return t.embedding, t._p_dense is not None

    emb_d, dense = run("32768")
    emb_s, sparse_dense = run("0")
    assert dense and not sparse_dense
    scale = np.abs(emb_s).max()
    assert np.abs(emb_d - emb_s).max() <= 1e-4 * scale
