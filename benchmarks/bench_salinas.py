"""Salinas-scale (512x217x224 = 111k px) end-to-end on one device: full
hierarchy + level similarities + level-1 t-SNE at ~28k components (inside
the dense-P tier).  Also times a level-2 UMAP.

Config mirrors bench.py's Pines config (comparison_pines_embed.json
semantics: NEIGH_WALKS + MERGE_RW_ONLY, symmetrized component-connected
kNN) at the Salinas geometry from comparison/comparison_salinas_*.json.

Usage: python benchmarks/bench_salinas.py [tsne_iters]
Prints one JSON line per phase.
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

    from sph_tpu import (ComputeEmbedding, ComputeEmbeddingSettings,
                         ComputeHierarchy, ComponentSim,
                         ImageHierarchySettings, ImageStack,
                         ImportanceWeighting, LevelSimilaritiesSettings,
                         NearestNeighborsSettings, NormalizationScheme,
                         RandomWalkHandling, RandomWalkReduction,
                         RandomWalkSettings, Scaler, scale)
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene

    set_level("WARNING")
    rows, cols, channels = 512, 217, 224
    tsne_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    k = 31

    img = create_hyperspectral_scene(rows, cols, channels, seed=13)
    stack = ImageStack.from_array(img, name="salinas_synth")
    data = scale(stack.data, Scaler.NONE)

    def build():
        ch = ComputeHierarchy().init(
            data, rows, cols,
            ihs=ImageHierarchySettings(
                component_sim=ComponentSim.NEIGH_WALKS,
                merge_multiple=False, use_percentile=False, max_dist=0.0,
                min_num_comp=1, min_reduction=98.0, max_levels=10,
                rw_handling=RandomWalkHandling.MERGE_RW_ONLY,
                rw_reduction=(
                    RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION),
                norm_knn_distances=NormalizationScheme.TSNE),
            lss=LevelSimilaritiesSettings(
                component_sim=ComponentSim.NEIGH_WALKS, ks=[k],
                random_walk_pair_sims=True,
                normalize_prob_dist=NormalizationScheme.TSNE,
                compute_symmetric_prob_dist=NormalizationScheme.TSNE),
            rws=RandomWalkSettings(
                num_random_walks=50, single_walk_length=10,
                importance_weighting=ImportanceWeighting.NORMAL,
                random_seed=1),
            nns=NearestNeighborsSettings(
                num_nearest_neighbors=k, symmetric_neighbors=True,
                compute_connect_components=True,
                neighbor_connect_components=True))
        ch.compute()
        return ch

    from sph_tpu.utils.timer import phase_report, phases_enabled
    t0 = time.perf_counter()
    ch = build()
    hierarchy_cold_s = time.perf_counter() - t0
    if phases_enabled():
        print("--- COLD hierarchy phases (incl. compiles) ---", flush=True)
        print(phase_report(min_s=0.5), flush=True)

    hierarchy_s = hierarchy_cold_s
    if os.environ.get("SALINAS_WARM_PASS", "1") == "1":
        t0 = time.perf_counter()
        ch = build()
        hierarchy_s = time.perf_counter() - t0
        if phases_enabled():
            print("--- WARM hierarchy phases (kernels compiled) ---",
                  flush=True)
            print(phase_report(min_s=0.5), flush=True)

    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    print(json.dumps({
        "metric": "salinas_e2e_hierarchy", "value": round(hierarchy_s, 2),
        "unit": "seconds",
        "detail": {"levels": levels, "device": str(jax.devices()[0]),
                   "cold_s": round(hierarchy_cold_s, 2),
                   "note": "value is the warm pass; cold_s incl. compiles"}
    }), flush=True)

    emb_settings = ComputeEmbeddingSettings()
    emb_settings.tsne.num_iterations = tsne_iters
    for level in (1, 2):
        if level >= h.num_levels:
            break
        pd = ch.level_similarities.get_prob_dist(level)
        ce = ComputeEmbedding(emb_settings)
        t1 = time.perf_counter()
        emb = ce.compute_tsne(pd, track_kl=True)
        tsne_s = time.perf_counter() - t1
        assert emb.shape[0] == levels[level]
        # KL gate at level 1, pinned to the 28k-component independent
        # anchor (docs/anchors_salinas.json, scripts/anchor_kl.py with
        # ANCHOR_SCENE=salinas): tracked KL must stay within 1% of the
        # sklearn-BH anchor — same methodology as bench.py's Pines gate
        kl_anchor = None
        kl_ok = None
        if level == 1 and ce.last_kl is not None:
            try:
                apath = os.path.join(
                    os.path.dirname(os.path.abspath(__file__)), "..",
                    "docs", "anchors_salinas.json")
                with open(apath) as f:
                    kl_anchor = json.load(f)["kl_under_p_sklearn_bh"]
                kl_ok = bool(ce.last_kl <= kl_anchor * 1.01)
            except (OSError, KeyError, ValueError):
                pass
        print(json.dumps({
            "metric": f"salinas_level{level}_tsne{tsne_iters}",
            "value": round(tsne_s, 2), "unit": "seconds",
            "detail": {"components": levels[level],
                       "iters_per_s": round(tsne_iters / tsne_s, 1),
                       "kl": None if ce.last_kl is None
                       else round(ce.last_kl, 4),
                       "kl_anchor_sklearn_bh": kl_anchor,
                       "kl_within_anchor": kl_ok}}), flush=True)

    # per-level UMAP (reference eval also runs UMAP per level); level 1 is
    # the 28k-component rows-tier measurement (VERDICT r3 item 4), level 2
    # lands in the dense tier
    import numpy as np
    from sph_tpu.models.umap import UmapComputation, UmapParameters
    for level in (1, 2):
        if level >= h.num_levels:
            break
        pd = ch.level_similarities.get_prob_dist(level)
        um = UmapComputation(UmapParameters(num_epochs=500))
        um.set_neighbor_matrix(pd)
        t2 = time.perf_counter()
        um.compute()
        umap_s = time.perf_counter() - t2
        assert np.all(np.isfinite(um.embedding))
        # steady state: identical re-run, all scan shapes compiled
        um2 = UmapComputation(UmapParameters(num_epochs=500))
        um2.set_neighbor_matrix(pd)
        t3 = time.perf_counter()
        um2.compute()
        umap_steady_s = time.perf_counter() - t3
        print(json.dumps({
            "metric": f"salinas_level{level}_umap500",
            "value": round(umap_steady_s, 2), "unit": "seconds",
            "detail": {"components": levels[level],
                       "tier": um._tier,
                       "first_run_s": round(umap_s, 2),
                       "ms_per_epoch": round(umap_steady_s * 2, 2)}}),
            flush=True)


if __name__ == "__main__":
    main()
