"""Approximate-kNN recall at scale (VERDICT r1 item 5).

The reference promises HNSW-tier behavior up to 25M points
(sph/NearestNeighbors.hpp:50-63, practical efSearch=128 regime ~0.95+
recall@10 on typical data, Knn.cpp:177-244).  Our substitution is IVF
cluster pruning (+ optional 8-bit SQ) — this harness measures its
recall@k against exact brute force on SAMPLED queries, which keeps the
ground truth affordable at any N (Q x N blocked matmul instead of N x N).

Usage:
  python benchmarks/bench_recall.py [n] [d] [k] [num_queries]
Env:
  RECALL_DATASET=clustered|gaussian (default clustered — gaussian noise is
  the IVF worst case and unlike any real scene), RECALL_NPROBES=8,16,32
  (sweep), RECALL_QUANTIZE=1 to add the SQ8 tier.

Prints one JSON line per configuration.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def make_data(kind: str, n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        return rng.standard_normal((n, d)).astype(np.float32)
    # clustered: mixture of sqrt(n) gaussian blobs (hyperspectral-scene-like
    # class structure; matches what the pipeline actually feeds the index)
    ncl = max(32, int(np.sqrt(n) / 4))
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 4.0
    labels = rng.integers(0, ncl, n)
    return (centers[labels]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(
                np.float32)


def exact_query_knn(data: np.ndarray, q_ids: np.ndarray, k: int
                    ) -> np.ndarray:
    """Ground-truth top-k ids for the sampled queries: [Q, N] blocked."""
    import jax
    import jax.numpy as jnp

    d_dev = jnp.asarray(data)
    q_dev = d_dev[jnp.asarray(q_ids)]

    @jax.jit
    def run(q, db):
        # HIGHEST precision is load-bearing: default-precision f32 dots
        # may multiply in bf16 or TF32, and with clustered-data norms
        # (~2000) the |q|^2+|db|^2-2qb expansion error reaches ~1 in d^2
        # — enough to misrank ~6% of k-boundary neighbors.  A bf16 ground
        # truth silently capped measured recall at 0.9394 for ANY index
        # configuration (round-2's "assignment boundary effects" analysis
        # was chasing this harness artifact; the IVF kernel itself always
        # used HIGHEST).
        d2 = (jnp.sum(q * q, 1)[:, None] + jnp.sum(db * db, 1)[None, :]
              - 2.0 * jnp.dot(q, db.T,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST))
        _, ids = jax.lax.top_k(-d2, k)
        return ids

    # block over queries to bound the [B, N] buffer
    out = []
    bs = 128
    for i in range(0, len(q_ids), bs):
        out.append(np.asarray(run(q_dev[i:i + bs], d_dev)))
    return np.concatenate(out, axis=0)


def main():
    from sph_tpu.ops.knn import knn_ivf

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 250_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    nq = int(sys.argv[4]) if len(sys.argv) > 4 else 512
    kind = os.environ.get("RECALL_DATASET", "clustered")
    nprobes = [int(x) for x in os.environ.get(
        "RECALL_NPROBES", "0").split(",")]   # 0 = default sqrt(nlist)
    nlists = [int(x) for x in os.environ.get(
        "RECALL_NLISTS", "0").split(",")]    # 0 = default max(100, sqrt(n))

    data = make_data(kind, n, d)
    rng = np.random.default_rng(1)
    q_ids = rng.choice(n, nq, replace=False)

    t0 = time.perf_counter()
    gt = exact_query_knn(data, q_ids, k)
    gt_s = time.perf_counter() - t0

    configs = [("ivf", "flat", p, nl) for p in nprobes for nl in nlists]
    if os.environ.get("RECALL_QUANTIZE") == "1":
        configs += [("ivf_sq8", "sq8", p, nl)
                    for p in nprobes for nl in nlists]
    if os.environ.get("RECALL_PQ") == "1":
        configs += [("ivf_pq", "pq", p, nl)
                    for p in nprobes for nl in nlists]

    for name, codec, nprobe, nlist in configs:
        t1 = time.perf_counter()
        idx, _ = knn_ivf(data, k, quantize=(codec == "sq8"),
                         pq=(codec == "pq"),
                         nlist=(None if nlist == 0 else nlist),
                         nprobe=(None if nprobe == 0 else nprobe),
                         query_rows=q_ids)
        q_s = time.perf_counter() - t1
        hits = 0
        for r in range(nq):
            hits += len(np.intersect1d(idx[r], gt[r], assume_unique=False))
        recall = hits / (nq * k)
        print(json.dumps({
            "metric": f"knn_recall_{name}",
            "value": round(recall, 4), "unit": f"recall@{k}",
            "detail": {"n": n, "d": d, "k": k, "queries": nq,
                       "dataset": kind,
                       "nlist": nlist or "max(100, sqrt(n))",
                       "nprobe": nprobe or "sqrt(nlist)",
                       "codec_bytes_per_vec": (
                           16 if codec == "pq"
                           else d if codec == "sq8" else 4 * d),
                       "query_s": round(q_s, 2),
                       "ground_truth_s": round(gt_s, 2)}}), flush=True)


if __name__ == "__main__":
    main()
