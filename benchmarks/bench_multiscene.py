"""BASELINE config #5: batched multi-scene evaluation — S hyperspectral
scenes run hierarchy AND embedding concurrently, scenes sharded over the
device mesh (the reference runs scenes strictly serially,
RunEvaluation.cpp:148-172's outer loop).

Phases measured (within one process, A/B interleaved so host noise
cancels):
  1. stage-1 serial:   per-scene kNN + data-level P + random walks, looped
  2. stage-1 batched:  the same work in ONE sharded device program
                       (parallel/sharded.multi_scene_stage1)
  3. hierarchy:        the batched kNN, then per scene the single-scene P,
                       walks and Borůvka levels over shared compiled
                       kernels (host loop; data-dependent per scene)
  4. batched t-SNE:    all scenes' level-0 embeddings in one program

Usage: python benchmarks/bench_multiscene.py [num_scenes] [side] [iters]
On a single device the scenes still batch (vmap); on several the same
code spreads scenes over the mesh.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import jax
    from sph_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np
    from sph_tpu.parallel.mesh import make_mesh
    from sph_tpu.parallel.sharded import (multi_scene_hierarchy,
                                          multi_scene_stage1,
                                          multi_scene_tsne)
    from sph_tpu.ops.knn import compute_knn, KnnIndex
    from sph_tpu.ops.distributions import distance_rows_to_probabilities
    from sph_tpu.ops.sparse import SparseRows
    from sph_tpu.ops.walks import do_random_walks
    from sph_tpu.settings import (ComponentSim, ImageHierarchySettings,
                                  LevelSimilaritiesSettings,
                                  NormalizationScheme, RandomWalkSettings)
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    from sph_tpu.utils.logging import set_level

    set_level("WARNING")
    s = int(sys.argv[1]) if len(sys.argv) > 1 else max(
        8, len(jax.devices()))
    side = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 250
    k = 16
    n = side * side

    datas = np.stack([
        create_hyperspectral_scene(side, side, 32, seed=i
                                   ).reshape(n, 32)
        for i in range(s)]).astype(np.float32)
    mesh = make_mesh()
    ndev = len(mesh.devices.ravel())

    rws = RandomWalkSettings(num_random_walks=20, single_walk_length=6,
                             random_seed=1)
    ihs = ImageHierarchySettings(component_sim=ComponentSim.NEIGH_WALKS,
                                 merge_multiple=False, use_percentile=False)
    lss = LevelSimilaritiesSettings(
        component_sim=ComponentSim.NEIGH_WALKS, ks=[k],
        random_walk_pair_sims=True,
        normalize_prob_dist=NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=NormalizationScheme.TSNE)

    # --- stage-1: batched (compile) then A/B warm batched vs serial ------
    t0 = time.perf_counter()
    stage1 = multi_scene_stage1(datas, k, rws=rws,
                                norm=ihs.norm_knn_distances, mesh=mesh)
    batched_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage1 = multi_scene_stage1(datas, k, rws=rws,
                                norm=ihs.norm_knn_distances, mesh=mesh)
    batched_warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(s):
        idx_i, dist_i = compute_knn(datas[i], k, KnnIndex.FLAT)
        mask = np.ones_like(idx_i, dtype=bool)
        probs_i = np.asarray(distance_rows_to_probabilities(
            dist_i, mask, ihs.norm_knn_distances, perplexity=-1.0,
            ignore_first=True, umap_row_norm=True))
        do_random_walks(SparseRows(
            np.where(probs_i > 0, idx_i, -1).astype(np.int32),
            probs_i, n), rws)
    serial_warm = time.perf_counter() - t0

    print(json.dumps({
        "metric": "multiscene_stage1", "value": round(batched_warm, 2),
        "unit": "seconds",
        "detail": {"scenes": s, "points_per_scene": n, "devices": ndev,
                   "batched_cold_s": round(batched_cold, 2),
                   "serial_warm_s": round(serial_warm, 2),
                   "speedup_vs_serial": round(
                       serial_warm / max(batched_warm, 1e-9), 2)}}),
        flush=True)

    # --- full hierarchy end-to-end (batched kNN + per-scene levels) -----
    t0 = time.perf_counter()
    results = multi_scene_hierarchy(datas, side, side, k=k, ihs=ihs,
                                    rws=rws, lss=lss, mesh=mesh)
    hier_s = time.perf_counter() - t0
    level_counts = [list(ih.hierarchy.num_components) for ih, _ in results]
    print(json.dumps({
        "metric": "multiscene_hierarchy_e2e", "value": round(hier_s, 2),
        "unit": "seconds",
        "detail": {"scenes": s,
                   "levels_scene0": level_counts[0],
                   "per_scene_s": round(hier_s / s, 2)}}), flush=True)

    # --- batched embeddings: level-0 probdists of ALL scenes ------------
    width = max(r.get_prob_dist(0).width for _, r in results)
    pi = np.full((s, n, width), -1, np.int32)
    pv = np.zeros((s, n, width), np.float32)
    for i, (_, ls) in enumerate(results):
        m = ls.get_prob_dist(0)
        pi[i, :, :m.width] = np.asarray(m.indices)
        pv[i, :, :m.width] = np.asarray(m.values)

    t0 = time.perf_counter()
    embs = multi_scene_tsne(pi, pv, iters, mesh)
    dt = time.perf_counter() - t0
    assert np.all(np.isfinite(embs))
    print(json.dumps({
        "metric": "multiscene_tsne", "value": round(dt, 2),
        "unit": "seconds",
        "detail": {"scenes": s, "points_per_scene": n, "iters": iters,
                   "devices": ndev,
                   "scene_iters_per_s": round(s * iters / dt, 1)}}),
        flush=True)


if __name__ == "__main__":
    main()
