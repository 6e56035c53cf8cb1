"""Grid-repulsion t-SNE validation + scaling benchmark (VERDICT r2 item 2).

Modes:
  python benchmarks/bench_grid_tsne.py kl [n] [iters]     — run full t-SNE
      twice on identical P (exact tiled repulsion vs grid-interpolated)
      and report final KL under the same P; n where exact is feasible
      (50k: ~2.5e9 pairs/iter).
  python benchmarks/bench_grid_tsne.py speed [n] [iters]  — grid-mode
      iters/s at scale (1M default), uniform random sparse P.

Prints one JSON line per phase.  Reference intent: the theta-scaled
Barnes-Hut approximation of sph/EmbedTsne.cpp:165-178 — more
approximation at larger N; here the approximation is kernel grid
interpolation (O(N + G^2 log G) per iteration).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def make_blob_p(n, k, seed=0):
    """Clustered data -> symmetrized sparse P (a realistic attraction
    structure without paying a full pipeline at 1M: the IVF tier supplies
    the kNN above 200k, exact brute force below)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = 16
    n_blobs = max(8, n // 5000)
    centers = rng.standard_normal((n_blobs, d)).astype(np.float32) * 8.0
    lab = rng.integers(0, n_blobs, n)
    data = centers[lab] + rng.standard_normal((n, d)).astype(np.float32)

    if n > 200_000:
        from sph_tpu.ops.knn import knn_ivf
        idx, dist = knn_ivf(data, k)
    else:
        from sph_tpu.ops.knn import knn_bruteforce
        idx, dist = knn_bruteforce(data, k, row_block=256, col_block=8192)

    import jax.numpy as jnp
    from sph_tpu.ops.distributions import gaussian_row_distributions
    from sph_tpu.ops.sparse import SparseRows, symmetrize_tsne
    mask = np.ones_like(idx, dtype=bool)
    p = gaussian_row_distributions(jnp.asarray(dist), jnp.asarray(mask),
                                   jnp.float32((k - 1) / 3),
                                   ignore_first=True)
    rows = SparseRows(idx.astype(np.int32), np.asarray(p), n)
    return symmetrize_tsne(rows)


def run_tsne(p, iters, grid_env, seed=0):
    import numpy as np
    from sph_tpu.models.tsne import TsneComputation, TsneParameters
    from sph_tpu.ops.math import random_disk_init
    os.environ["SPH_TSNE_GRID"] = grid_env
    params = TsneParameters(num_iterations=iters)
    t = TsneComputation(params)
    t.set_probability_distribution(p)
    t.set_initial_embedding(random_disk_init(p.num_rows, 0.1, seed))
    t0 = time.perf_counter()
    done = 0
    chunk = 50
    while done < iters:
        step = min(chunk, iters - done)
        t.compute(step, verbose=False) if done == 0 else (
            t.continue_gradient_descent(step, verbose=False))
        done += step
        print(f"#   grid_env={grid_env} iter {done}/{iters} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    emb = t.embedding  # sync
    wall = time.perf_counter() - t0
    os.environ["SPH_TSNE_GRID"] = "auto"
    return emb, wall


def score_kl(emb, p, block=512):
    """KL under the FULL-width P with the exact-Z path for both runs —
    the grid tier additionally caps P width (SPH_TSNE_GRID_P_WIDTH), so
    scoring each run under its own internal P would compare different
    objectives."""
    import jax.numpy as jnp
    import numpy as np
    from sph_tpu.models.tsne import tsne_kl_divergence, _ceil_to
    n = p.num_rows
    npad = _ceil_to(n, block)
    idx = np.pad(p.indices, ((0, npad - n), (0, 0)), constant_values=-1)
    total = p.row_sums().sum()
    val = np.pad(p.values, ((0, npad - n), (0, 0))) / max(total, 1e-12)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = emb
    return float(tsne_kl_divergence(jnp.asarray(y), jnp.asarray(idx),
                                    jnp.asarray(val), jnp.int32(n), block))


def main():
    from sph_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    mode = sys.argv[1] if len(sys.argv) > 1 else "kl"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else (
        50_000 if mode == "kl" else 1_000_000)
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else (
        1000 if mode == "kl" else 100)
    k = 31

    t_p = time.perf_counter()
    p = make_blob_p(n, k)
    print(f"# P built: {time.perf_counter() - t_p:.1f}s (n={n})",
          flush=True)

    if mode == "kl":
        emb_g, wall_g = run_tsne(p, iters, "1")
        emb_e, wall_e = run_tsne(p, iters, "0")
        kl_g = score_kl(emb_g, p)
        kl_e = score_kl(emb_e, p)
        print(json.dumps({
            "metric": "tsne_grid_vs_exact_kl", "value": round(kl_g, 5),
            "unit": "kl",
            "detail": {"n": n, "iters": iters,
                       "kl_exact": round(kl_e, 5),
                       "kl_grid": round(kl_g, 5),
                       "kl_ratio": round(kl_g / max(kl_e, 1e-9), 4),
                       "wall_exact_s": round(wall_e, 1),
                       "wall_grid_s": round(wall_g, 1),
                       "note": "grid run = full large-N tier (grid "
                               "repulsion + P width cap + packed-bf16 "
                               "gather); both KLs scored under the "
                               "identical full-width P"}}))
    else:
        import numpy as np
        # warm-up chunk compiles; measured chunks are pure execution
        emb, wall = run_tsne(p, iters, "1")
        assert np.all(np.isfinite(emb))
        print(json.dumps({
            "metric": "tsne_1m_grid_repulsion",
            "value": round(iters / wall, 2), "unit": "iters_per_s",
            "detail": {"n": n, "iters": iters,
                       "wall_s": round(wall, 1),
                       "note": "wall incl. compile of first chunk"}}))


if __name__ == "__main__":
    main()
