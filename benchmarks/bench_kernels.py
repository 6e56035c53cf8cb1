"""Kernel-tuning harness: times the hot device kernels at Pines scale and
sweeps their block-size knobs.  Run on the GPU to pick the fastest
variants; prints one JSON line per measurement, each naming the device.

Usage:
    python benchmarks/bench_kernels.py            # full sweep
    python benchmarks/bench_kernels.py knn tsne   # subset

The hot ops (bench.py profile, SURVEY.md §6):
  knn    data-level kNN, 21025 x 200, k=91  (col_block sweep = how many
         distance columns are scored per streaming top-k merge)
  walks  21025 components x 50 walkers x 10 steps
  tsne   level-1 t-SNE at 5358 points: the dense-P pass alone, per
         iteration inside the loop, and 2000 iterations end to end
  pairs  walk pairwise Bhattacharyya similarities (blocked sqrt-matmul)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

# SPH_BENCH_SCALE in (0, 1] shrinks every problem size for smoke runs on
# slow hosts; 1.0 = the Pines-scale shapes a tuning run should use.
SCALE = float(os.environ.get("SPH_BENCH_SCALE", "1.0"))


def _s(n, lo=64):
    return max(lo, int(n * SCALE))


def _timeit(fn, repeats=3, warmup=1):
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(repeats):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / repeats


def _emit(name, seconds, **extra):
    print(json.dumps({"kernel": name, "seconds": seconds, **extra}),
          flush=True)


def _pines_like(n=None, d=200, seed=0):
    n = n or _s(21025)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2
    lab = rng.integers(0, 16, n)
    return (centers[lab] + rng.standard_normal((n, d)).astype(np.float32)
            ).astype(np.float32)


def bench_knn():
    from sph_tpu.ops.knn import knn_bruteforce
    data = _pines_like()
    for col_block in (512, 1024, 2048, 4096, 8192):
        for row_block in (256, 512, 1024):
            dt = _timeit(lambda: knn_bruteforce(
                data, 91, row_block=row_block, col_block=col_block),
                repeats=2)
            _emit("knn", dt, row_block=row_block, col_block=col_block)


def bench_walks():
    from sph_tpu.ops.sparse import SparseRows
    from sph_tpu.ops.walks import do_random_walks
    from sph_tpu.settings import RandomWalkSettings
    rng = np.random.default_rng(1)
    n, k = _s(21025), 92
    idx = np.empty((n, k), np.int32)
    idx[:, 0] = np.arange(n)
    idx[:, 1:] = rng.integers(0, n, (n, k - 1))
    val = rng.random((n, k)).astype(np.float32)
    val /= val.sum(1, keepdims=True)
    rows = SparseRows(idx, val, n)
    rws = RandomWalkSettings(num_random_walks=50, single_walk_length=10)
    dt = _timeit(lambda: do_random_walks(rows, rws), repeats=2)
    _emit("walks", dt, n=n, walkers=50, steps=10)


def bench_pairs():
    from sph_tpu.ops.sparse import SparseRows, pairwise_similarities
    from sph_tpu.ops.walks import do_random_walks
    from sph_tpu.settings import RandomWalkSettings
    rng = np.random.default_rng(2)
    n, k = _s(5365), 32
    idx = np.empty((n, k), np.int32)
    idx[:, 0] = np.arange(n)
    idx[:, 1:] = rng.integers(0, n, (n, k - 1))
    val = rng.random((n, k)).astype(np.float32)
    val /= val.sum(1, keepdims=True)
    walks = do_random_walks(SparseRows(idx, val, n),
                            RandomWalkSettings(num_random_walks=50,
                                               single_walk_length=10))
    topk = min(91, n - 1)
    dt = _timeit(lambda: pairwise_similarities(walks, topk), repeats=2)
    _emit("pairs", dt, n=n, topk=topk)


def _level1_p(n):
    from sph_tpu.ops.sparse import SparseRows, symmetrize_tsne
    rng = np.random.default_rng(3)
    k = 92
    idx = np.empty((n, k), np.int32)
    idx[:, 0] = np.arange(n)
    idx[:, 1:] = rng.integers(0, n, (n, k - 1))
    val = rng.random((n, k)).astype(np.float32)
    val /= val.sum(1, keepdims=True)
    return symmetrize_tsne(SparseRows(idx, val, n))


def bench_tsne():
    """The dense-P force pass at the Pines level-1 shape (n = 5358): alone
    (100 chained calls in one program) at the production tiling and at
    256-row tiles, beside the tiled exact repulsion; then per iteration
    inside `tsne_iterations` and over a 2000-iteration `TsneComputation`,
    dense tier against the sparse attraction + tiled repulsion path."""
    import jax
    import jax.numpy as jnp
    from sph_tpu.models import tsne as T

    n = _s(5358)
    p = _level1_p(n)
    rng = np.random.default_rng(0)
    block, npad = T.dense_tiling(n)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)) * 10
    pd = np.zeros((npad, npad), np.float32)
    pd[:n, :n] = p.to_dense() / p.row_sums().sum()
    y, pd = jnp.asarray(y), jnp.asarray(pd)
    tile = 256 if npad % 256 == 0 else 128
    variants = {"dense": lambda y: T._dense_forces(y, pd, n, block),
                f"dense_rows{tile}": lambda y: T._dense_forces(y, pd, n,
                                                               tile),
                "repulsion": lambda y: (None,) + T._repulsive_forces(
                    y, n, tile)}
    for name, fn in variants.items():
        def loop(y, fn=fn):
            def body(_, y):
                a, r, z = fn(y)
                return y + 1e-9 * ((0.0 if a is None else a) - r / z)
            return jax.lax.fori_loop(0, 100, body, y)
        f = jax.jit(loop)
        dt = _timeit(lambda: f(y), repeats=3) / 100
        _emit(f"tsne_pass_{name}", dt, n=n, npad=npad,
              p_bytes=npad * npad * 4,
              p_gb_per_s=round(npad * npad * 4 / dt / 1e9, 1))

    iters = max(50, int(2000 * SCALE))
    try:
        for name in ("dense", "sparse", "sparse", "dense"):
            os.environ["SPH_TSNE_DENSE_P_MAX"] = (
                "0" if name == "sparse" else "32768")
            for count in (200, iters):
                def run(count=count):
                    t = T.TsneComputation(
                        T.TsneParameters(num_iterations=count))
                    t.set_probability_distribution(p)
                    t.compute(verbose=False)
                    return t._state.embedding
                dt = _timeit(run, repeats=1)
                _emit(f"tsne{count}_{name}", dt, n=n,
                      ms_per_iter=round(1e3 * dt / count, 4))
    finally:
        os.environ.pop("SPH_TSNE_DENSE_P_MAX", None)

    if os.environ.get("BENCH_TRACE"):
        def run200():
            t = T.TsneComputation(T.TsneParameters(num_iterations=200))
            t.set_probability_distribution(p)
            t.compute(verbose=False)
            return t._state.embedding
        for op, ns, count, scope in _trace_top(run200,
                                               os.environ["BENCH_TRACE"]):
            _emit("trace_tsne200_top", ns * 1e-9, op=op, events=count,
                  scope=scope)


def _trace_top(fn, log_dir, top=12):
    """Trace one call of `fn` (after a warm-up) and return the device
    operations that took the most time: (hlo op, total ns, event count,
    name scope)."""
    import glob
    import jax
    from collections import defaultdict
    jax.block_until_ready(fn())
    with jax.profiler.trace(log_dir):
        jax.block_until_ready(fn())
    path = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    total = defaultdict(lambda: [0, 0, ""])
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                rec = total[stats.get("hlo_op", ev.name)]
                rec[0] += ev.duration_ns
                rec[1] += 1
                rec[2] = rec[2] or str(stats.get("tf_op", ""))[:120]
    ranked = sorted(total.items(), key=lambda kv: -kv[1][0])[:top]
    return [(k, v[0], v[1], v[2]) for k, v in ranked]


def bench_merge():
    from sph_tpu.ops.sparse import SparseRows, _compact, \
        merge_rows_by_parents
    rng = np.random.default_rng(4)
    n, r = _s(21025), 500
    idx = np.sort(rng.integers(0, n, (n, r)).astype(np.int32), axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    idx = np.where(dup, -1, idx)
    val = np.where(idx >= 0, rng.random((n, r)).astype(np.float32), 0)
    sr = _compact(idx, val, n)
    parents = rng.integers(0, max(n // 4, 1), n)
    dt = _timeit(lambda: merge_rows_by_parents(sr, parents,
                                               max(n // 4, 1)), repeats=3)
    _emit("merge_host", dt, n=n, width=r)


def main():
    which = set(sys.argv[1:]) or {"knn", "walks", "pairs", "tsne", "merge"}
    from sph_tpu.utils.device import device_info
    print(json.dumps(device_info()), flush=True)
    if "knn" in which:
        bench_knn()
    if "walks" in which:
        bench_walks()
    if "pairs" in which:
        bench_pairs()
    if "tsne" in which:
        bench_tsne()
    if "merge" in which:
        bench_merge()


if __name__ == "__main__":
    main()