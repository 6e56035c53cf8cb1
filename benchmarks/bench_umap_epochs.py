"""UMAP epoch-throughput microbenchmark (VERDICT r3 item 4).

Times `UmapComputation` end-to-end at Salinas-level-2-like size and
attributes the wall between (a) init/spectral, (b) compile, (c) warm epoch
execution under different dispatch chunk sizes.  Within-run A/B only
(host timings vary run to run).

Usage: python benchmarks/bench_umap_epochs.py [n] [k] [epochs]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1934
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 59
    epochs = int(sys.argv[3]) if len(sys.argv) > 3 else 500

    import jax
    from sph_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp  # noqa: F401

    from sph_tpu.models.umap import UmapComputation, UmapParameters
    from sph_tpu.ops.sparse import SparseRows

    rng = np.random.default_rng(0)
    # synthetic symmetric-ish membership rows: k neighbors, positive weights
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(n)])
    idx = idx.astype(np.int32)
    val = rng.random((n, k)).astype(np.float32) * 0.9 + 0.1
    p = SparseRows(idx, val, n)

    print(f"devices: {jax.devices()}", flush=True)

    tiers = [("dense", {}),
             ("rows", {"SPH_UMAP_DENSE_MAX": "0"}),
             ("edges", {"SPH_UMAP_DENSE_MAX": "0",
                        "SPH_UMAP_EDGE_PATH": "1"})]
    if os.environ.get("BENCH_TIERS"):
        want = os.environ["BENCH_TIERS"].split(",")
        tiers = [t for t in tiers if t[0] in want]
    for tag, env in tiers:
        for kk, vv in env.items():
            os.environ[kk] = vv
        u = UmapComputation(UmapParameters(num_epochs=epochs, seed=7))
        u.set_neighbor_matrix(p)
        t0 = time.time()
        u.init_optimization()
        t_init = time.time() - t0
        # cold chunk (compile)
        t0 = time.time()
        u.run_for_epochs(1)
        np.asarray(u.embedding)
        t_cold = time.time() - t0
        # first warm run: may still compile new scan-length shapes
        t0 = time.time()
        u.run_for_epochs(epochs - 1)
        np.asarray(u.embedding)
        t_warm = time.time() - t0
        # steady state: identical second run, every shape compiled
        u2 = UmapComputation(UmapParameters(num_epochs=epochs, seed=8))
        u2.set_neighbor_matrix(p)
        u2.init_optimization()
        t0 = time.time()
        u2.run_for_epochs(epochs)
        np.asarray(u2.embedding)
        t_steady = time.time() - t0
        per = t_steady / max(epochs, 1)
        print(f"[{tag}] init {t_init:.2f}s  cold(1ep) {t_cold:.2f}s  "
              f"warm1({epochs-1}ep) {t_warm:.2f}s  "
              f"steady({epochs}ep) {t_steady:.2f}s = {per*1000:.2f} ms/ep",
              flush=True)
        assert np.isfinite(u.embedding).all()
        assert np.isfinite(u2.embedding).all()
        for kk in env:
            os.environ.pop(kk, None)


if __name__ == "__main__":
    main()
