"""Multi-chip sharding tests on the 8-device virtual CPU mesh:
sharded kNN == single-chip kNN; sharded t-SNE matches the single-chip
optimizer trajectory; multi-scene batching produces per-scene results."""

import numpy as np
import pytest

import jax

from sph_tpu.ops.knn import knn_bruteforce
from sph_tpu.ops.sparse import SparseRows
from sph_tpu.parallel.mesh import make_mesh
from sph_tpu.parallel.sharded import (multi_scene_tsne, sharded_knn,
                                      sharded_tsne)
from sph_tpu.utils.testdata import create_3d_gaussians


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_knn_matches_single():
    pos, _ = create_3d_gaussians(300, random_state=2,
                                 centers=np.array([[0, 0, 0], [6, 6, 6]]))
    mesh = make_mesh()
    idx_s, dist_s = sharded_knn(pos, 8, mesh)
    idx_1, dist_1 = knn_bruteforce(pos, 8)
    assert np.allclose(dist_s, dist_1, atol=1e-4)
    assert np.all(idx_s[:, 0] == np.arange(300))


def probdist(n=96, k=10, seed=3):
    from sph_tpu.ops.distributions import gaussian_row_distributions
    from sph_tpu.ops.sparse import symmetrize_tsne
    import jax.numpy as jnp
    pos, labels = create_3d_gaussians(
        n, random_state=seed, centers=np.array([[0, 0, 0], [10, 0, 0]]))
    idx, dist = knn_bruteforce(pos, k)
    p = gaussian_row_distributions(jnp.asarray(dist ** 2),
                                   jnp.ones_like(idx, dtype=bool),
                                   jnp.float32(3.0), ignore_first=True)
    return symmetrize_tsne(SparseRows(idx.astype(np.int32), np.asarray(p),
                                      n)), labels


def test_sharded_tsne_matches_single_chip():
    """The multi-chip step must follow the single-chip optimizer trajectory
    (same math, different reduction layout) before f32 chaos separates
    them."""
    import jax.numpy as jnp
    from sph_tpu.models.tsne import (TsneParameters, default_exaggeration,
                                     tsne_iterations)
    from sph_tpu.parallel.sharded import make_sharded_tsne_step
    from sph_tpu.parallel.mesh import shard_rows
    from sph_tpu.ops.math import random_disk_init

    p, labels = probdist()
    n, npad = p.num_rows, 96
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray(
        [params.eta, params.momentum, params.final_momentum,
         params.mom_switching_iter, params.exaggeration_factor,
         params.remove_exaggeration_iter, params.exponential_decay_iter,
         params.minimum_gain], jnp.float32)
    y0 = random_disk_init(n, 0.1, 0)
    pi = p.indices.astype(np.int32)
    pv = (p.values / p.values.sum()).astype(np.float32)

    # the gain updates bifurcate on f32 sign comparisons, so trajectories
    # separate exponentially; 5 steps stays well inside the deterministic
    # window (single-step agreement is ~5e-7)
    iters = 5
    y1, _, _, _ = tsne_iterations(
        jnp.asarray(y0), jnp.zeros((npad, 2)), jnp.ones((npad, 2)),
        jnp.int32(0), jnp.asarray(pi), jnp.asarray(pv), jnp.int32(n),
        pvec, iters, 32)

    mesh = make_mesh()
    step = make_sharded_tsne_step(mesh)
    y = shard_rows(mesh, jnp.asarray(y0))
    vel = shard_rows(mesh, jnp.zeros((npad, 2), jnp.float32))
    gain = shard_rows(mesh, jnp.ones((npad, 2), jnp.float32))
    pis = shard_rows(mesh, jnp.asarray(pi))
    pvs = shard_rows(mesh, jnp.asarray(pv))
    for it in range(iters):
        y, vel, gain = step(y, vel, gain, pis, pvs, jnp.int32(n), pvec,
                            jnp.int32(it))
    y2 = np.asarray(y)
    scale = np.abs(np.asarray(y1)).max()
    assert np.abs(np.asarray(y1) - y2).max() < 1e-3 * max(scale, 1.0)


def test_sharded_tsne_finite():
    p, labels = probdist()
    mesh = make_mesh()
    emb = sharded_tsne(p.indices, p.values, 100, mesh)
    assert emb.shape == (96, 2)
    assert np.all(np.isfinite(emb))


def test_multi_scene_tsne():
    p, labels = probdist()
    s = 8
    pi = np.stack([p.indices] * s)
    pv = np.stack([p.values] * s)
    mesh = make_mesh()
    embs = multi_scene_tsne(pi, pv, 60, mesh)
    assert embs.shape == (s, 96, 2)
    assert np.all(np.isfinite(embs))
    # different seeds per scene -> different layouts
    assert not np.allclose(embs[0], embs[1])


def test_sharded_umap_finite_and_clustered():
    """Edge-sharded UMAP epochs over the virtual mesh: finite output and
    neighbors end up closer than non-neighbors on a two-blob membership."""
    import jax
    import numpy as np
    from sph_tpu.ops.knn import knn_bruteforce
    from sph_tpu.ops.distributions import smooth_knn_distributions
    from sph_tpu.ops.sparse import SparseRows, symmetrize_umap
    from sph_tpu.parallel.mesh import make_mesh
    from sph_tpu.parallel.sharded import sharded_umap
    from sph_tpu.utils.testdata import create_3d_gaussians

    pos, lab = create_3d_gaussians(
        128, random_state=0, centers=np.array([[0, 0, 0], [8, 8, 8]]))
    idx, dist = knn_bruteforce(pos.astype(np.float32), 8)
    import jax.numpy as jnp
    mask = np.ones_like(idx, bool)
    mask[:, 0] = False
    sims = np.asarray(smooth_knn_distributions(jnp.asarray(dist),
                                               jnp.asarray(mask)))
    rows = symmetrize_umap(SparseRows(
        np.where(mask, idx, -1).astype(np.int32), sims, len(pos)))

    mesh = make_mesh()
    emb = sharded_umap(rows.indices, rows.values, num_epochs=60, mesh=mesh)
    assert emb.shape == (128, 2)
    assert np.all(np.isfinite(emb))
    c0 = emb[lab == 0].mean(0)
    c1 = emb[lab == 1].mean(0)
    spread0 = np.linalg.norm(emb[lab == 0] - c0, axis=1).mean()
    assert np.linalg.norm(c0 - c1) > spread0


def test_sharded_grid_tsne_matches_single_device():
    """Grid-tier decomposition check: psum'd per-shard charge deposits +
    replicated FFT must reproduce the 1-device trajectory (identical math,
    different reduction layout)."""
    import jax.numpy as jnp
    from sph_tpu.parallel.sharded import make_sharded_grid_tsne_step
    from sph_tpu.parallel.mesh import shard_rows
    from sph_tpu.models.tsne import TsneParameters, default_exaggeration
    from sph_tpu.ops.math import random_disk_init

    p, labels = probdist()
    n, npad, grid = p.num_rows, 96, 32
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray(
        [params.eta, params.momentum, params.final_momentum,
         params.mom_switching_iter, params.exaggeration_factor,
         params.remove_exaggeration_iter, params.exponential_decay_iter,
         params.minimum_gain], jnp.float32)
    y0 = random_disk_init(n, 0.1, 0)
    pi = p.indices.astype(np.int32)
    pv = (p.values / p.values.sum()).astype(np.float32)

    outs = []
    for ndev in (1, 8):
        mesh = make_mesh(ndev)
        step = make_sharded_grid_tsne_step(mesh, grid)
        y = shard_rows(mesh, jnp.asarray(y0))
        vel = shard_rows(mesh, jnp.zeros((npad, 2), jnp.float32))
        gain = shard_rows(mesh, jnp.ones((npad, 2), jnp.float32))
        pis = shard_rows(mesh, jnp.asarray(pi))
        pvs = shard_rows(mesh, jnp.asarray(pv))
        for it in range(5):
            y, vel, gain = step(y, vel, gain, pis, pvs, jnp.int32(n),
                                pvec, jnp.int32(it))
        outs.append(np.asarray(y))
    scale = np.abs(outs[0]).max()
    assert np.abs(outs[0] - outs[1]).max() < 1e-3 * max(scale, 1.0)


def test_sharded_grid_tsne_auto_regrid():
    """grid=0 re-buckets the node count from the live span between
    iteration chunks (the long-run stability fix: a grid sized at init
    degenerates once the embedding expands past the kernel width)."""
    import sph_tpu.ops.tsne_grid as tg
    from sph_tpu.parallel.sharded import sharded_grid_tsne
    p, labels = probdist()
    calls = []
    orig_pick = tg.pick_grid_size
    tg.pick_grid_size = lambda *a, **k: calls.append(a) or orig_pick(*a, **k)
    try:
        emb = sharded_grid_tsne(p.indices, p.values, 60, make_mesh())
    finally:
        tg.pick_grid_size = orig_pick
    assert emb.shape == (96, 2)
    assert np.all(np.isfinite(emb))
    # auto mode really re-picks from the live span between chunks
    # (one init pick + one per 50-iteration chunk)
    assert len(calls) >= 2


def test_sharded_grid_tsne_finite_and_separates():
    """A caller's grid of 32 nodes is a floor: once the span outgrows its
    cells (about 60 here, where a grid held at 32 runs away) it grows."""
    import sph_tpu.parallel.sharded as sh
    p, labels = probdist()
    mesh = make_mesh()
    grids = []
    orig_make = sh.make_sharded_grid_tsne_step
    sh.make_sharded_grid_tsne_step = (
        lambda m, g, *a, **k: grids.append(g) or orig_make(m, g, *a, **k))
    try:
        emb = sh.sharded_grid_tsne(p.indices, p.values, 150, mesh, grid=32)
    finally:
        sh.make_sharded_grid_tsne_step = orig_make
    assert grids[0] == 32 and min(grids) == 32 and max(grids) > 32
    assert emb.shape == (96, 2)
    assert np.all(np.isfinite(emb))
    cents = np.stack([emb[labels == c].mean(0) for c in range(2)])
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[c],
                                    axis=1).mean() for c in range(2)])
    inter = np.linalg.norm(cents[0] - cents[1])
    assert inter / intra > 1.5


# ---------------------------------------------------------------------------
# scene-parallel stage 1 + hierarchy (VERDICT r3 item 2 / BASELINE config #5)
# ---------------------------------------------------------------------------

def _scene_batch(s=4, side=10, channels=6):
    from sph_tpu.utils.testdata import create_checker_image
    datas = np.stack([
        create_checker_image(side, side, channels=channels, block=5,
                             noise=0.02, seed=100 + i
                             ).reshape(side * side, channels)
        for i in range(s)]).astype(np.float32)
    return datas, side, side


def test_multi_scene_stage1_matches_serial_ops():
    from sph_tpu.parallel.sharded import multi_scene_stage1
    from sph_tpu.ops.knn import compute_knn, KnnIndex
    from sph_tpu.ops.distributions import distance_rows_to_probabilities
    from sph_tpu.ops.walks import do_random_walks
    from sph_tpu.settings import NormalizationScheme, RandomWalkSettings

    datas, rows, cols = _scene_batch()
    k = 8
    rws = RandomWalkSettings(num_random_walks=8, single_walk_length=4,
                             random_seed=3)
    out = multi_scene_stage1(datas, k, rws=rws,
                             norm=NormalizationScheme.TSNE)
    assert out["idx"].shape == (4, rows * cols, k)

    for i in (0, 3):
        idx_s, dist_s = compute_knn(datas[i], k, KnnIndex.FLAT)
        assert np.array_equal(out["idx"][i], idx_s)
        assert np.allclose(out["dist"][i], dist_s, rtol=1e-5, atol=1e-6)
        mask = np.ones_like(idx_s, dtype=bool)
        probs_s = np.asarray(distance_rows_to_probabilities(
            dist_s, mask, NormalizationScheme.TSNE, perplexity=-1.0,
            ignore_first=True, umap_row_norm=True))
        assert np.allclose(out["probs"][i], probs_s, rtol=1e-4, atol=1e-6)

    # walks: scene seed == rws seed + scene index; scene 0 must reproduce
    # the serial walk rows exactly (same threefry stream)
    from sph_tpu.ops.sparse import SparseRows
    n = rows * cols
    pd0 = SparseRows(np.where(out["probs"][0] > 0, out["idx"][0],
                              -1).astype(np.int32), out["probs"][0], n)
    serial = do_random_walks(pd0, rws)
    dense_serial = serial.to_dense()
    widx, wval = out["walks_idx"][0], out["walks_val"][0]
    dense_batch = np.zeros_like(dense_serial)
    for r in range(n):
        sel = widx[r] >= 0
        dense_batch[r, widx[r][sel]] = wval[r][sel]
    assert np.allclose(dense_batch, dense_serial, rtol=1e-5, atol=1e-7)


def test_multi_scene_hierarchy_end_to_end():
    from sph_tpu.parallel.sharded import multi_scene_hierarchy
    from sph_tpu.settings import (ComponentSim, ImageHierarchySettings,
                                  LevelSimilaritiesSettings,
                                  NormalizationScheme, RandomWalkSettings)

    datas, rows, cols = _scene_batch()
    ihs = ImageHierarchySettings(component_sim=ComponentSim.NEIGH_WALKS,
                                 merge_multiple=False, use_percentile=False)
    rws = RandomWalkSettings(num_random_walks=10, single_walk_length=5,
                             random_seed=1)
    lss = LevelSimilaritiesSettings(
        component_sim=ComponentSim.NEIGH_WALKS, ks=[8],
        random_walk_pair_sims=True,
        normalize_prob_dist=NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=NormalizationScheme.TSNE)
    results = multi_scene_hierarchy(datas, rows, cols, k=8,
                                    ihs=ihs, rws=rws, lss=lss)
    assert len(results) == 4
    for ih, ls in results:
        levels = list(ih.hierarchy.num_components)
        assert levels[0] == rows * cols
        assert all(b < a for a, b in zip(levels, levels[1:]))
        assert ls is not None
        for lvl in range(ih.hierarchy.num_levels):
            pd = ls.get_prob_dist(lvl)
            assert pd is not None
            assert pd.num_rows == levels[lvl]


def test_multi_scene_hierarchy_scene0_matches_serial_pipeline():
    """Scene 0 of the batched path must reproduce the serial
    ComputeHierarchy levels exactly (same kNN, same probdist, same walk
    stream, same merge decisions)."""
    from sph_tpu.parallel.sharded import multi_scene_hierarchy
    from sph_tpu import (ComputeHierarchy, ImageHierarchySettings,
                         LevelSimilaritiesSettings, NearestNeighborsSettings,
                         RandomWalkSettings)

    datas, rows, cols = _scene_batch(s=2)
    ihs = ImageHierarchySettings(merge_multiple=False, use_percentile=False)
    rws = RandomWalkSettings(num_random_walks=10, single_walk_length=5,
                             random_seed=1)
    results = multi_scene_hierarchy(datas, rows, cols, k=8,
                                    ihs=ihs, rws=rws)

    ch = ComputeHierarchy().init(
        datas[0], rows, cols, ihs=ihs, rws=rws,
        nns=NearestNeighborsSettings(num_nearest_neighbors=8))
    ch.compute_knn_graph()
    ch.compute_image_hierarchy()
    serial_levels = list(ch.image_hierarchy.hierarchy.num_components)
    batched_levels = list(results[0][0].hierarchy.num_components)
    assert batched_levels == serial_levels
