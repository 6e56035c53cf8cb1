"""BASELINE config #4: 1-megapixel x 100-channel synthetic stack —
streaming brute-force matmul kNN at 1M points + exact tiled-repulsion
t-SNE at 1M points (the reference is impractical at this scale;
BASELINE.md).

Usage: python benchmarks/bench_1m.py [n_points] [channels] [tsne_iters]
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
    from sph_tpu.utils.device import device_info
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from sph_tpu.ops.knn import knn_bruteforce
    from sph_tpu.models.tsne import (TsneParameters, default_exaggeration,
                                     tsne_iterations)
    from sph_tpu.ops.math import random_disk_init

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    k = 16

    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, d)).astype(np.float32)

    # --- kNN at scale: streaming column blocks, O(row_block*col_block) mem
    t0 = time.perf_counter()
    idx, dist = knn_bruteforce(data, k, row_block=256, col_block=8192)
    knn_s = time.perf_counter() - t0
    flops = 2.0 * n * n * d
    print(json.dumps({
        "metric": "knn_1m_bruteforce", "value": round(knn_s, 2),
        "unit": "seconds",
        "detail": {"n": n, "d": d, "k": k,
                   "tflops_per_s": round(flops / knn_s / 1e12, 2),
                   "device": device_info()}}))

    # --- t-SNE repulsion at scale (uniform random P for the benchmark)
    block = 512
    npad = ((n + block - 1) // block) * block
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray(
        [params.eta, params.momentum, params.final_momentum,
         params.mom_switching_iter, params.exaggeration_factor,
         params.remove_exaggeration_iter, params.exponential_decay_iter,
         params.minimum_gain], jnp.float32)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = random_disk_init(n, 0.1, 0)
    r = 32
    p_idx = np.full((npad, r), -1, np.int32)
    p_val = np.zeros((npad, r), np.float32)
    p_idx[:n] = idx[:, :r] if k >= r else rng.integers(0, n, (n, r))
    vals = rng.random((n, r)).astype(np.float32)
    p_val[:n] = vals / vals.sum()

    # warm-up runs one chunk; the measured loop must run at least one more.
    # One exact-repulsion iteration at 1M is ~8 TFLOP — one per dispatch
    # keeps each program short.
    chunk = 1 if n > 300_000 else max(1, min(10, iters // 2))
    args = [jnp.asarray(y), jnp.zeros((npad, 2), jnp.float32),
            jnp.ones((npad, 2), jnp.float32), jnp.int32(0),
            jnp.asarray(p_idx), jnp.asarray(p_val), jnp.int32(n), pvec]
    # warm-up
    out = tsne_iterations(*args, chunk, block)
    jax.block_until_ready(out)
    t1 = time.perf_counter()
    done = chunk
    state = out
    while done < max(iters, 2 * chunk):
        state = tsne_iterations(state[0], state[1], state[2], state[3],
                                jnp.asarray(p_idx), jnp.asarray(p_val),
                                jnp.int32(n), pvec, chunk, block)
        done += chunk
    jax.block_until_ready(state)
    tsne_s = time.perf_counter() - t1
    print(json.dumps({
        "metric": "tsne_1m_exact_repulsion",
        "value": round((done - chunk) / tsne_s, 2),
        "unit": "iters_per_s",
        "detail": {"n": n, "device": device_info(),
                   "pair_interactions_per_s":
                       round((done - chunk) * float(n) ** 2 / tsne_s
                             / 1e12, 2)}}))


if __name__ == "__main__":
    main()
