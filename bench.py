"""Flagship benchmark: Indian-Pines-scale end-to-end hierarchy + level-1
t-SNE on one GPU.

Config mirrors the reference's comparison_pines_embed.json: 145x145x200
hyperspectral stack, NEIGH_WALKS similarity, MERGE_RW_ONLY, symmetrized +
component-connected kNN graph with k = 90 + 1, 50 walks x 10 steps with
NORMAL step weighting, pairwise random-walk similarities, TSNE
normalization, then 2000 t-SNE iterations on level 1 (the reference's
t-SNE schedule gives 1000-2000 iterations at level-1 component counts).

Three tiers, one process on the card at a time:
  truly cold  a child process with an emptied compile cache directory
              (`<cache>/truly_cold`), run before this process touches JAX;
  disk cold   this process's first pass, persistent cache on disk;
  warm        best of BENCH_PASSES passes with every program compiled.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "detail"}
with the device (platform, kind, count, card name and power limit) in
the detail.  Exits without a result unless JAX runs on an NVIDIA GPU.
"""

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sph_tpu.utils.compile_cache import (ENV_VAR,  # noqa: E402
                                         compile_cache_dir,
                                         enable_compile_cache)
from sph_tpu.utils.device import (device_info,  # noqa: E402
                                  nvidia_smi_name_power, require_gpu)


def _run_pipeline():
    """Build the Pines-config hierarchy (shared by the truly-cold child and
    the main measurement passes).  Returns (computed ComputeHierarchy,
    rebuild closure)."""
    from sph_tpu import (ComputeHierarchy, ComponentSim,
                         ImageHierarchySettings, ImageStack,
                         ImportanceWeighting, LevelSimilaritiesSettings,
                         NearestNeighborsSettings, NormalizationScheme,
                         RandomWalkHandling, RandomWalkReduction,
                         RandomWalkSettings, Scaler, scale)
    from sph_tpu.utils.logging import set_level
    from sph_tpu.utils.testdata import create_hyperspectral_scene

    set_level("WARNING")
    rows = int(os.environ.get("BENCH_ROWS", 145))
    cols = int(os.environ.get("BENCH_COLS", 145))
    channels = int(os.environ.get("BENCH_CHANNELS", 200))
    img = create_hyperspectral_scene(rows, cols, channels, seed=7)
    stack = ImageStack.from_array(img, name="pines_synth")
    data = scale(stack.data, Scaler.NONE)

    k = 91  # 90 + self (comparison_pines_embed.json nKnns: [90])

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

    return build(), build


def _run_tsne(pd):
    """Level-1 t-SNE with KL tracking; returns (ComputeEmbedding, emb)."""
    from sph_tpu import ComputeEmbedding, ComputeEmbeddingSettings
    emb_settings = ComputeEmbeddingSettings()
    emb_settings.tsne.num_iterations = int(
        os.environ.get("BENCH_TSNE_ITERS", 2000))
    ce = ComputeEmbedding(emb_settings)
    emb = ce.compute_tsne(pd, track_kl=True)
    return ce, emb


def _truly_cold_child():
    """Child mode: the first-ever compile bill — a fresh process whose
    cache directory the parent emptied runs the hierarchy + t-SNE once and
    reports its wall clock.  Prints one JSON line on stdout."""
    enable_compile_cache()
    require_gpu()
    from sph_tpu.utils.compile_count import count_compiles
    t0 = time.perf_counter()
    with count_compiles() as cc:
        ch, _build = _run_pipeline()
        h = ch.image_hierarchy.hierarchy
        level = min(1, h.num_levels - 1)
        _run_tsne(ch.level_similarities.get_prob_dist(level))
    wall = time.perf_counter() - t0
    print(json.dumps({"truly_cold_s": round(wall, 3),
                      "programs": cc.total,
                      "residual_top": cc.top(12)}), flush=True)


def _measure_truly_cold(timeout_s: float):
    """Run the truly-cold child in its own process with an emptied, fixed
    cache subdirectory (the parent's in-memory executables cannot be
    dropped).  Must run before this process initializes JAX: a second
    process on the card would find most of its memory reserved."""
    cache = os.path.join(compile_cache_dir(), "truly_cold")
    shutil.rmtree(cache, ignore_errors=True)
    env = dict(os.environ, BENCH_STAGE="truly_cold_child")
    env[ENV_VAR] = cache
    p = subprocess.run([sys.executable, os.path.abspath(__file__)],
                       env=env, stdout=subprocess.PIPE, timeout=timeout_s,
                       text=True, check=True)
    for line in reversed(p.stdout.strip().splitlines()):
        d = json.loads(line)
        if "truly_cold_s" in d:
            return d
    raise RuntimeError("truly-cold child printed no result")


def main():
    if os.environ.get("BENCH_STAGE") == "truly_cold_child":
        _truly_cold_child()
        return

    if nvidia_smi_name_power() is None:
        raise SystemExit("needs an NVIDIA GPU; nvidia-smi does not answer")
    truly_cold = None
    if os.environ.get("BENCH_SKIP_TRULY_COLD") != "1":
        truly_cold = _measure_truly_cold(
            float(os.environ.get("BENCH_TRULY_COLD_TIMEOUT_S", "2400")))

    enable_compile_cache()
    require_gpu()
    from sph_tpu.utils.compile_count import count_compiles
    device = device_info()

    # compile pass: with the persistent disk cache warm this measures the
    # DISK-COLD tier (deserialization + re-trace); the passes below are
    # pure execution (warm tier).
    t0 = time.perf_counter()
    with count_compiles() as cc_hier:
        ch, build = _run_pipeline()
    compile_hierarchy_s = time.perf_counter() - t0

    h = ch.image_hierarchy.hierarchy
    level = min(1, h.num_levels - 1)
    pd = ch.level_similarities.get_prob_dist(level)

    tsne_iters = int(os.environ.get("BENCH_TSNE_ITERS", 2000))
    t1 = time.perf_counter()
    with count_compiles() as cc_tsne:
        ce, emb = _run_tsne(pd)
    compile_tsne_s = time.perf_counter() - t1

    # measured passes: best of N.  BENCH_TRACE=<dir> captures a
    # jax.profiler trace of the first pass.
    import contextlib
    passes = int(os.environ.get("BENCH_PASSES", "3"))
    hierarchy_s = tsne_s = float("inf")
    for p in range(max(passes, 1)):
        trace_ctx = contextlib.nullcontext()
        if os.environ.get("BENCH_TRACE") and p == 0:
            from sph_tpu.utils.profiling import trace
            trace_ctx = trace(os.environ["BENCH_TRACE"])
        t2 = time.perf_counter()
        with trace_ctx:
            ch = build()
        hierarchy_s = min(hierarchy_s, time.perf_counter() - t2)
        pd = ch.level_similarities.get_prob_dist(level)
        t3 = time.perf_counter()
        ce, emb = _run_tsne(pd)
        tsne_s = min(tsne_s, time.perf_counter() - t3)
    total_s = hierarchy_s + tsne_s

    # KL quality gate against the independent sklearn Barnes-Hut anchor
    # (docs/anchors_pines.json, scripts/anchor_kl.py): the tracked KL must
    # not exceed it by more than 1%.
    apath = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "docs", "anchors_pines.json")
    with open(apath) as f:
        kl_anchor_bh = json.load(f)["kl_under_p_sklearn_bh"]
    kl_ok = ce.last_kl is not None and ce.last_kl <= kl_anchor_bh * 1.01

    result = {
        "metric": "pines_e2e_hierarchy_plus_level1_tsne2000",
        "value": round(total_s, 3),
        "unit": "seconds",
        "detail": {
            "hierarchy_s": round(hierarchy_s, 3),
            "tsne_s": round(tsne_s, 3),
            "tsne_iters_per_s": round(tsne_iters / tsne_s, 1),
            "level": level,
            "level_components": int(h.num_components[level]),
            "num_levels": h.num_levels,
            "kl": None if ce.last_kl is None else round(ce.last_kl, 5),
            "kl_anchor_sklearn_bh": kl_anchor_bh,
            "kl_within_anchor": bool(kl_ok),
            # disk-cold tier: compile pass of THIS process
            "compile_hierarchy_s": round(compile_hierarchy_s, 3),
            "compile_tsne_s": round(compile_tsne_s, 3),
            "disk_cold_total_s": round(
                compile_hierarchy_s + compile_tsne_s, 3),
            "truly_cold_s": (None if truly_cold is None
                             else truly_cold["truly_cold_s"]),
            "truly_cold_programs": (None if truly_cold is None
                                    else truly_cold["programs"]),
            "compiled_programs_hierarchy": cc_hier.total,
            "compiled_programs_tsne": cc_tsne.total,
            "persistent_cache_hits": (cc_hier.persistent_hits
                                      + cc_tsne.persistent_hits),
            "device": device,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
