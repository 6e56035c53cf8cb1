"""Exact and approximate kNN as blocked matmuls.

Reference: sph/utils/Knn.cpp — FAISS BruteForce/Flat/IVFFlat/HNSW* engines —
and sph/NearestNeighbors.cpp:131-170 post-processing (sqrt of L2^2, epsilon
cleanup, non-decreasing check, self-first).

Design: all engines reduce to *blocked distance matmuls + streaming
top-k*.  A [rows_block, D] x [D, cols_block] tile runs on the 128x128 systolic
array; a running top-k per row is carried across column tiles so the full
[N, N] distance matrix never materializes.  This scales to millions of points
(memory is O(row_block * col_block)) and replaces FAISS's CPU SIMD heaps.

The IVF tier (`knn_ivf`) clusters with a few k-means sweeps (also matmuls) and
prunes to the `nprobe` nearest cluster lists, mirroring FAISS IndexIVFFlat
semantics (Knn.cpp:138-175: nlist = max(100, sqrt(n)), nprobe = sqrt(nlist)).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..settings import KnnIndex, KnnMetric
from ..utils.logging import Log

_F32_EPS = float(np.finfo(np.float32).eps)


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def candidate_width(k: int) -> int:
    """Candidates the streaming pass keeps per row before the exact
    re-rank: k plus a margin wide enough to hold every point whose
    expansion distance is within its rounding error of the k-th."""
    return _ceil_to(k + max(8, k // 4), 8)


def refine_candidates(rows, row_ids, cand_i, data, n_valid, k: int):
    """Exact re-rank of streamed candidates: squared distances recomputed
    as sum((a - b)^2) and the best k kept, ties broken by column id.

    The streaming pass scores with |a|^2 + |b|^2 - 2 a.b, whose f32
    rounding error grows with the norms (~1e-3 relative in d at Pines
    norms); dense hyperspectral clusters put neighbors closer together
    than that, so the expansion alone ranks them by rounding noise, and
    two backends (different accumulation orders) disagree on most rows.
    Direct differences carry error relative to d^2 itself.

    rows [B, D], row_ids [B] global ids, cand_i [B, C] candidate ids
    (-1 = none) into data [Np, D].  Returns (d2 [B, k], idx [B, k])."""
    cand = data[jnp.maximum(cand_i, 0)]                   # [B, C, D]
    diff = rows[:, None, :] - cand
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(cand_i == row_ids[:, None], 0.0, d2)
    d2 = jnp.where((cand_i < 0) | (cand_i >= n_valid), jnp.inf, d2)
    sd, si = jax.lax.sort((d2, cand_i), num_keys=2, dimension=1,
                          is_stable=True)
    return sd[:, :k], si[:, :k]


@functools.partial(jax.jit, static_argnames=(
    "k", "metric", "row_block", "col_block", "l2_squared", "row_window"))
def _knn_device(data: jax.Array, n_valid: jax.Array, k: int, metric: str,
                row_block: int, col_block: int, l2_squared: bool,
                row_window: int = 0, row0=0) -> Tuple[jax.Array, jax.Array]:
    """Streaming blocked brute-force kNN.

    data: [Np, D] (padded to multiples of the block sizes; pad rows must be
    zeros).  Returns (indices [Np, k] int32, distances [Np, k] f32) where
    distances are sorted ascending per row.  Pad columns are masked to +inf.
    L2 and cosine candidates are re-ranked exactly (`refine_candidates`).

    row_window > 0 computes only rows [row0, row0 + row_window) (still
    against ALL columns): at millions of points one monolithic program
    runs for minutes, so callers chunk the row space into per-window
    dispatches instead.
    """
    npad, d = data.shape
    window = row_window if row_window > 0 else npad
    row_base = jnp.int32(row0) if row_window > 0 else jnp.int32(0)
    num_row_blocks = window // row_block
    num_col_blocks = npad // col_block

    sq_norms = jnp.sum(data * data, axis=1)  # [Np]

    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, col_block), 1)
    refine = metric != "inner_product"
    kc = candidate_width(k) if refine else k

    def row_block_fn(rb):
        r0 = rb * row_block + row_base
        rows = jax.lax.dynamic_slice_in_dim(data, r0, row_block)
        row_sq = jax.lax.dynamic_slice_in_dim(sq_norms, r0, row_block)

        def col_step(carry, cb):
            top_d, top_i = carry
            cols = jax.lax.dynamic_slice_in_dim(data, cb * col_block,
                                                col_block)
            col_sq = jax.lax.dynamic_slice_in_dim(sq_norms, cb * col_block,
                                                  col_block)
            # HIGHEST precision: merge decisions downstream are argmin-over-
            # float sensitive, so full f32 products (not bf16/TF32) are
            # required
            ip = jnp.dot(rows, cols.T, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            if metric == "l2":
                dist = row_sq[:, None] + col_sq[None, :] - 2.0 * ip
                dist = jnp.maximum(dist, 0.0)
            elif metric == "cosine":
                # data pre-normalized: chord distance^2 = 2 - 2 cos
                dist = jnp.maximum(2.0 - 2.0 * ip, 0.0)
            else:  # inner_product: ascending distance == descending similarity
                dist = -ip
            ids = col_ids + cb * col_block  # [1, col_block]
            ids = jnp.broadcast_to(ids, dist.shape)
            # force exact-zero self distance (floating-point cancellation in
            # ||x||^2 + ||y||^2 - 2xy can leave tiny residues on the diagonal)
            row_ids = (jax.lax.broadcasted_iota(jnp.int32, dist.shape, 0)
                       + r0)
            if metric != "inner_product":
                dist = jnp.where(ids == row_ids, 0.0, dist)
            # pad columns (zero vectors) must never win the top-k
            dist = jnp.where(ids >= n_valid, jnp.inf, dist)

            merged_d = jnp.concatenate([top_d, dist], axis=1)
            merged_i = jnp.concatenate([top_i, ids], axis=1)
            # streaming bottom-k: one stable two-operand row sort + slice
            # (ties keep the lower column id)
            sd, si = jax.lax.sort((merged_d, merged_i), num_keys=1,
                                  dimension=1, is_stable=True)
            new_d, new_i = sd[:, :kc], si[:, :kc]
            return (new_d, new_i), None

        init = (jnp.full((row_block, kc), jnp.inf, jnp.float32),
                jnp.full((row_block, kc), -1, jnp.int32))
        (top_d, top_i), _ = jax.lax.scan(col_step, init,
                                         jnp.arange(num_col_blocks))
        if refine:
            row_ids = jnp.arange(row_block, dtype=jnp.int32) + r0
            top_d, top_i = refine_candidates(rows, row_ids, top_i, data,
                                             n_valid, k)
        return top_d, top_i

    top_d, top_i = jax.lax.map(row_block_fn, jnp.arange(num_row_blocks))
    top_d = top_d.reshape(window, k)
    top_i = top_i.reshape(window, k)

    if metric == "l2":
        # epsilon cleanup then sqrt (reference: NearestNeighbors.cpp:224-242)
        top_d = jnp.where(top_d <= _F32_EPS, 0.0, top_d)
        if not l2_squared:
            top_d = jnp.sqrt(top_d)
    elif metric == "cosine":
        top_d = jnp.where(top_d <= _F32_EPS, 0.0, top_d)
        top_d = jnp.sqrt(top_d)
    return top_i, top_d


def _pad_rows(data: np.ndarray, npad: int) -> np.ndarray:
    n = data.shape[0]
    if npad == n:
        return data
    out = np.zeros((npad, data.shape[1]), dtype=np.float32)
    out[:n] = data
    return out


def knn_bruteforce(data: np.ndarray, k: int,
                   metric: KnnMetric = KnnMetric.L2,
                   l2_squared: bool = False,
                   row_block: int = 256,
                   col_block: int = 2048,
                   keep_on_device: bool = False,
                   data_dev=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN: returns (indices [N, k] int32, distances [N, k] f32).

    The self point is guaranteed to be in slot 0 with distance 0 (reference:
    NearestNeighbors.cpp:162-170 via GraphUtils ensureClosestPointIsSelf).
    COSINE uses chord distance on L2-normalized vectors (monotone in cosine
    distance; reference uses inner product on renormed copies,
    NearestNeighbors.cpp:208-222).

    keep_on_device: return jax arrays (self-first fixup on device) so the
    graph feeds the device symmetrize/probdist chain without a download.
    data_dev: optional pre-uploaded [N, D] device copy of `data` (reused
    across the kNN and the component-bridging matmuls).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, _ = data.shape
    if k > n:
        raise ValueError(f"k={k} > num_points={n}")

    if metric == KnnMetric.COSINE:
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        data = data / norms
        data_dev = None  # renormalized copy differs from the raw upload

    row_block = min(row_block, _ceil_to(n, 8))
    col_block = min(col_block, _ceil_to(n, 128))
    npad = _ceil_to(n, int(np.lcm(row_block, col_block)))
    if data_dev is not None and data_dev.shape == data.shape:
        padded_d = (jnp.pad(data_dev, ((0, npad - n), (0, 0)))
                    if npad != n else data_dev)
    else:
        padded_d = jnp.asarray(_pad_rows(data, npad))

    window = int(os.environ.get("SPH_KNN_ROW_WINDOW", str(1 << 17)))
    window = _ceil_to(min(window, npad), row_block)
    if npad > window:
        # chunk the row space into per-window dispatches rather than one
        # multi-minute program
        parts_i, parts_d = [], []
        for r0 in range(0, npad, window):
            pi, pdist = _knn_device(padded_d, jnp.int32(n), k,
                                    metric.value, row_block, col_block,
                                    l2_squared, row_window=window, row0=r0)
            parts_i.append(pi)
            parts_d.append(pdist)
        idx = jnp.concatenate(parts_i, axis=0)
        dist = jnp.concatenate(parts_d, axis=0)
    else:
        idx, dist = _knn_device(padded_d, jnp.int32(n), k,
                                metric.value, row_block, col_block,
                                l2_squared)
    if keep_on_device:
        from .graph import ensure_self_first_device
        idx, dist, adjusted = ensure_self_first_device(idx[:n], dist[:n])
        if adjusted:
            Log.info("knn_bruteforce: self-first adjusted %d of %d rows",
                     adjusted, n)
        return idx, dist
    idx = np.asarray(idx[:n])
    dist = np.asarray(dist[:n])

    from .graph import ensure_self_first
    idx, dist, adjusted = ensure_self_first(idx, dist)
    if adjusted:
        Log.info("knn_bruteforce: self-first adjusted %d of %d rows",
                 adjusted, n)
    return idx.astype(np.int32), dist.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("k", "metric", "col_block",
                                              "l2_squared"))
def _knn_queries_device(data: jax.Array, queries: jax.Array,
                        q_ids: jax.Array, n_valid: jax.Array, k: int,
                        metric: str, col_block: int, l2_squared: bool
                        ) -> Tuple[jax.Array, jax.Array]:
    """Exact kNN for an explicit query block against the full base.

    data: [Np, D] zero-padded base; queries: [Qp, D] rows sliced from it
    (already metric-normalized); q_ids: [Qp] global row ids (-1 pad rows).
    Same streaming top-k as `_knn_device`, but only Qp rows — used to
    refill the handful of rows an approximate tier left incomplete
    without re-running the full N x N pass.
    """
    npad, _ = data.shape
    num_col_blocks = npad // col_block
    sq_norms = jnp.sum(data * data, axis=1)
    q_sq = jnp.sum(queries * queries, axis=1)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, col_block), 1)
    refine = metric != "inner_product"
    kc = candidate_width(k) if refine else k

    def col_step(carry, cb):
        top_d, top_i = carry
        cols = jax.lax.dynamic_slice_in_dim(data, cb * col_block, col_block)
        col_sq = jax.lax.dynamic_slice_in_dim(sq_norms, cb * col_block,
                                              col_block)
        ip = jnp.dot(queries, cols.T, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
        if metric == "l2":
            dist = q_sq[:, None] + col_sq[None, :] - 2.0 * ip
            dist = jnp.maximum(dist, 0.0)
        elif metric == "cosine":
            dist = jnp.maximum(2.0 - 2.0 * ip, 0.0)
        else:  # inner_product
            dist = -ip
        ids = jnp.broadcast_to(col_ids + cb * col_block, dist.shape)
        if metric != "inner_product":
            dist = jnp.where(ids == q_ids[:, None], 0.0, dist)
        dist = jnp.where(ids >= n_valid, jnp.inf, dist)
        merged_d = jnp.concatenate([top_d, dist], axis=1)
        merged_i = jnp.concatenate([top_i, ids], axis=1)
        sd, si = jax.lax.sort((merged_d, merged_i), num_keys=1,
                              dimension=1, is_stable=True)
        return (sd[:, :kc], si[:, :kc]), None

    qp = queries.shape[0]
    init = (jnp.full((qp, kc), jnp.inf, jnp.float32),
            jnp.full((qp, kc), -1, jnp.int32))
    (top_d, top_i), _ = jax.lax.scan(col_step, init,
                                     jnp.arange(num_col_blocks))
    if refine:
        top_d, top_i = refine_candidates(queries, q_ids, top_i, data,
                                         n_valid, k)
    if metric in ("l2", "cosine"):
        top_d = jnp.where(top_d <= _F32_EPS, 0.0, top_d)
        if metric == "cosine" or not l2_squared:
            top_d = jnp.sqrt(top_d)
    return top_i, top_d


def knn_exact_rows(data: np.ndarray, rows: np.ndarray, k: int,
                   metric: KnnMetric = KnnMetric.L2,
                   l2_squared: bool = False,
                   col_block: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN restricted to `rows` query ids (refill / serving path).

    Returns (indices [M, k] int32, distances [M, k] f32) matching
    `knn_bruteforce`'s semantics for those rows.  Query count is padded
    to a power-of-two bucket so repeated refills share compiled shapes.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, _ = data.shape
    rows = np.asarray(rows, dtype=np.int64)
    m = rows.shape[0]
    if metric == KnnMetric.COSINE:
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        data = data / norms
    npad = _ceil_to(n, min(col_block, _ceil_to(n, 128)))
    cb = min(col_block, npad)
    base = jnp.asarray(_pad_rows(data, npad))
    qp = max(8, 1 << (m - 1).bit_length())
    q = np.zeros((qp, data.shape[1]), dtype=np.float32)
    q[:m] = data[rows]
    q_ids = np.full(qp, -1, dtype=np.int32)
    q_ids[:m] = rows
    ti, td = _knn_queries_device(base, jnp.asarray(q), jnp.asarray(q_ids),
                                 jnp.int32(n), k, metric.value, cb,
                                 l2_squared)
    return (np.asarray(ti[:m]).astype(np.int32),
            np.asarray(td[:m]).astype(np.float32))


# ---------------------------------------------------------------------------
# IVF tier: k-means coarse quantizer + cluster-grouped exact search
# ---------------------------------------------------------------------------
# Layout: queries are grouped by their OWN cluster, and a whole
# query cluster scores against each of its probe clusters' member lists as
# one [L, L] distance tile with a streaming top-k carry — the direct
# analogue of FAISS's inverted-list scan, but batched so the work is
# matmuls instead of per-query gathers (which would move terabytes at 1M
# points).  Probe sets are per-cluster (nprobe nearest centroids of the
# query's own centroid) rather than per-query — for self-kNN the query
# sits in its cluster, so this matches FAISS's probe choice up to
# centroid-boundary effects; recall is measured empirically
# (benchmarks/bench_recall.py).


@functools.partial(jax.jit, static_argnames=("k", "metric", "l2_squared"))
def _ivf_grouped_device(data: jax.Array, segtab: jax.Array,
                        qtab: jax.Array, psegs: jax.Array, k: int,
                        metric: str, l2_squared: bool):
    """Score a window of query segments against their probe segments.

    data: [N, D]; segtab: [S, seg] point ids per segment (-1 pad) — every
    cluster's inverted list split into fixed-size segments so one compiled
    shape covers arbitrary cluster-size skew — used for CANDIDATE lookups
    (global segment ids); qtab: [W, seg] the window's query segments;
    psegs: [W, P] candidate SEGMENT ids per query segment (-1 pad).
    Returns (ids [W, seg, k], dists [W, seg, k]) ascending.
    """
    _, seg = qtab.shape
    p = psegs.shape[1]

    def one_segment(args):
        qids, plist = args             # [seg], [P]
        q = data[jnp.maximum(qids, 0)]             # [seg, D]
        qsq = jnp.sum(q * q, axis=1)

        def probe_step(carry, pi):
            top_d, top_i = carry
            sid = plist[pi]
            ids = jnp.where(sid >= 0, segtab[jnp.maximum(sid, 0)], -1)
            c = data[jnp.maximum(ids, 0)]          # [seg, D]
            csq = jnp.sum(c * c, axis=1)
            ip = jnp.dot(q, c.T, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            if metric == "inner_product":
                dist = -ip
            else:
                dist = jnp.maximum(qsq[:, None] + csq[None, :] - 2.0 * ip,
                                   0.0)
            dist = jnp.where((ids >= 0)[None, :], dist, jnp.inf)
            dist = jnp.where((qids >= 0)[:, None], dist, jnp.inf)
            merged_d = jnp.concatenate([top_d, dist], axis=1)
            merged_i = jnp.concatenate(
                [top_i, jnp.broadcast_to(ids[None, :], dist.shape)], axis=1)
            sd, si = jax.lax.sort((merged_d, merged_i), num_keys=1,
                                  dimension=1, is_stable=True)
            return (sd[:, :k], si[:, :k]), None

        init = (jnp.full((seg, k), jnp.inf, jnp.float32),
                jnp.full((seg, k), -1, jnp.int32))
        (top_d, top_i), _ = jax.lax.scan(probe_step, init, jnp.arange(p))
        return top_d, top_i

    dists, ids = jax.lax.map(one_segment, (qtab, psegs))
    if metric != "inner_product":
        dists = jnp.where(dists <= _F32_EPS, 0.0, dists)
        if not l2_squared:
            dists = jnp.sqrt(dists)
    return ids, dists

@functools.partial(jax.jit, static_argnames=("nlist", "iters", "block"))
def _kmeans(data: jax.Array, n_valid, init: jax.Array, nlist: int,
            iters: int, block: int = 65536):
    """A few Lloyd sweeps as matmuls, blocked over rows: the [N, nlist]
    distance/one-hot buffers would be multi-GB at 1M points, so each sweep
    scans [block, nlist] tiles and accumulates centroid sums.  Pad rows
    (>= n_valid) are excluded from the update."""
    npts = data.shape[0]
    nblocks = npts // block
    sq = jnp.sum(data * data, axis=1)

    def assign_tile(cents, csq, b):
        x = jax.lax.dynamic_slice_in_dim(data, b * block, block)
        xsq = jax.lax.dynamic_slice_in_dim(sq, b * block, block)
        d = (xsq[:, None] + csq[None, :]
             - 2.0 * jnp.dot(x, cents.T,
                             preferred_element_type=jnp.float32))
        a = jnp.argmin(d, axis=1)
        rows = jax.lax.broadcasted_iota(jnp.int32, (block,), 0) + b * block
        return x, jnp.where(rows < n_valid, a, nlist)

    def step(cents, _):
        csq = jnp.sum(cents * cents, axis=1)

        def acc(carry, b):
            sums, cnts = carry
            x, a = assign_tile(cents, csq, b)
            oh = jax.nn.one_hot(a, nlist, dtype=jnp.float32)  # OOB -> 0
            sums = sums + jnp.dot(oh.T, x,
                                  preferred_element_type=jnp.float32)
            cnts = cnts + jnp.sum(oh, axis=0)
            return (sums, cnts), None

        (sums, cnts), _ = jax.lax.scan(
            acc, (jnp.zeros((nlist, data.shape[1]), jnp.float32),
                  jnp.zeros(nlist, jnp.float32)), jnp.arange(nblocks))
        new = jnp.where(cnts[:, None] > 0,
                        sums / jnp.maximum(cnts, 1.0)[:, None], cents)
        return new, None

    cents, _ = jax.lax.scan(step, init, None, length=iters)
    csq = jnp.sum(cents * cents, axis=1)

    def final(b):
        _, a = assign_tile(cents, csq, b)
        return a

    assign = jax.lax.map(final, jnp.arange(nblocks)).reshape(npts)
    return cents, assign


# ---------------------------------------------------------------------------
# Product quantization (the HNSW_IVFPQ tier's codec)
# ---------------------------------------------------------------------------
# Reference: Knn.cpp computeIndexHNSW_IVFPQ:322-368 — faiss IndexIVFPQ with
# m=16 subquantizers, nbits=8, residual encoding (FAISS by_residual default):
# each database vector is stored as 16 one-byte centroid ids over the
# RESIDUAL x - coarse_centroid(x), i.e. 16 bytes/vector instead of 4*D.
#
# Scoring: FAISS's per-query LUT gathers are the CPU idiom; on an
# accelerator per-element gathers are the slow path, so candidates are
# DECODED on the fly — one_hot(codes) @ codebook is a batched
# [seg, 256] x [256, ds] matmul
# per subspace — and scored with the same [seg, seg] distance tiles as the
# flat tier.  Asymmetric (ADC): queries stay full precision.


def pq_train(data: np.ndarray, cents: np.ndarray, assign: np.ndarray,
             m: int = 16, ksub: int = 256, sample: int = 65536,
             seed: int = 0, iters: int = 10) -> np.ndarray:
    """Train per-subspace codebooks on coarse residuals.

    Returns codebooks [m, ksub, ds] f32 where ds = ceil(D/m); the input
    dimensionality is zero-padded to m*ds (centroids learn ~0 there, so
    padded dims contribute ~nothing to ADC distances).
    """
    n, d = data.shape
    ds = (d + m - 1) // m
    rng = np.random.default_rng(seed)
    take = rng.choice(n, min(sample, n), replace=False)
    resid = data[take] - cents[assign[take]]
    if m * ds != d:
        resid = np.pad(resid, ((0, 0), (0, m * ds - d)))
    sub = resid.reshape(-1, m, ds)

    codebooks = np.zeros((m, ksub, ds), np.float32)
    block = min(65536, _ceil_to(sub.shape[0], 1024))
    for s in range(m):
        x = np.ascontiguousarray(sub[:, s, :], np.float32)
        kk = min(ksub, x.shape[0])
        init = x[rng.choice(x.shape[0], kk, replace=False)]
        if kk < ksub:
            init = np.pad(init, ((0, ksub - kk), (0, 0)))
        npad = _ceil_to(x.shape[0], block)
        cb, _ = _kmeans(jnp.asarray(_pad_rows(x, npad)),
                        jnp.int32(x.shape[0]), jnp.asarray(init), ksub,
                        iters, block=block)
        codebooks[s] = np.asarray(cb)
    return codebooks


@functools.partial(jax.jit, static_argnames=())
def _pq_encode_block(resid: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Assign each subvector to its nearest codebook centroid.

    resid: [B, m, ds]; codebooks: [m, ksub, ds].  Returns [B, m] uint8.
    """
    # [m, B, ds] x [m, ds, ksub] -> [m, B, ksub] batched matmul
    r = jnp.swapaxes(resid, 0, 1)
    ip = jnp.einsum("mbd,mkd->mbk", r, codebooks,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    csq = jnp.sum(codebooks * codebooks, axis=2)          # [m, ksub]
    d2 = csq[:, None, :] - 2.0 * ip                       # + |r|^2 const/row
    return jnp.argmin(d2, axis=2).astype(jnp.uint8).T     # [B, m]


def pq_encode(data: np.ndarray, cents: np.ndarray, assign: np.ndarray,
              codebooks: np.ndarray, block: int = 131072) -> np.ndarray:
    """Encode all vectors' coarse residuals as [N, m] uint8 codes."""
    n, d = data.shape
    m, _, ds = codebooks.shape
    cb_d = jnp.asarray(codebooks)
    out = np.empty((n, m), np.uint8)
    for b0 in range(0, n, block):
        be = min(b0 + block, n)
        resid = data[b0:be] - cents[assign[b0:be]]
        if m * ds != d:
            resid = np.pad(resid, ((0, 0), (0, m * ds - d)))
        out[b0:be] = np.asarray(_pq_encode_block(
            jnp.asarray(resid.reshape(be - b0, m, ds)), cb_d))
    return out


@functools.partial(jax.jit, static_argnames=("k", "metric", "l2_squared"))
def _ivf_grouped_device_pq(data: jax.Array, codes: jax.Array,
                           codebooks: jax.Array, cents: jax.Array,
                           seg_cluster: jax.Array, segtab: jax.Array,
                           qtab: jax.Array, qsegs_psegs: jax.Array, k: int,
                           metric: str, l2_squared: bool):
    """PQ variant of _ivf_grouped_device: candidates are decoded from their
    residual codes (one_hot @ codebook matmuls) plus the probe
    segment's coarse centroid; queries read full-precision rows (ADC)."""
    _, seg = qtab.shape
    p = qsegs_psegs.shape[1]
    m, ksub, ds = codebooks.shape
    dfull = m * ds
    dpad = dfull - data.shape[1]

    def one_segment(args):
        qids, plist = args             # [seg], [P]
        q = data[jnp.maximum(qids, 0)]             # [seg, D]
        if dpad:
            q = jnp.pad(q, ((0, 0), (0, dpad)))
        qsq = jnp.sum(q * q, axis=1)

        def probe_step(carry, pi):
            top_d, top_i = carry
            sid = plist[pi]
            ids = jnp.where(sid >= 0, segtab[jnp.maximum(sid, 0)], -1)
            cc = codes[jnp.maximum(ids, 0)]        # [seg, m] u8 row gather
            oh = jax.nn.one_hot(cc, ksub, dtype=jnp.float32)  # [seg, m, ksub]
            dec = jnp.einsum("amk,mkd->amd", oh, codebooks,
                             preferred_element_type=jnp.float32)
            coarse = cents[jnp.maximum(seg_cluster[jnp.maximum(sid, 0)], 0)]
            if dpad:
                coarse = jnp.pad(coarse, (0, dpad))
            c = dec.reshape(seg, dfull) + coarse[None, :]
            csq = jnp.sum(c * c, axis=1)
            ip = jnp.dot(q, c.T, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            if metric == "inner_product":
                dist = -ip
            else:
                dist = jnp.maximum(qsq[:, None] + csq[None, :] - 2.0 * ip,
                                   0.0)
            dist = jnp.where((ids >= 0)[None, :], dist, jnp.inf)
            dist = jnp.where((qids >= 0)[:, None], dist, jnp.inf)
            merged_d = jnp.concatenate([top_d, dist], axis=1)
            merged_i = jnp.concatenate(
                [top_i, jnp.broadcast_to(ids[None, :], dist.shape)], axis=1)
            sd, si = jax.lax.sort((merged_d, merged_i), num_keys=1,
                                  dimension=1, is_stable=True)
            return (sd[:, :k], si[:, :k]), None

        init = (jnp.full((seg, k), jnp.inf, jnp.float32),
                jnp.full((seg, k), -1, jnp.int32))
        (top_d, top_i), _ = jax.lax.scan(probe_step, init, jnp.arange(p))
        return top_d, top_i

    dists, ids = jax.lax.map(one_segment, (qtab, qsegs_psegs))
    if metric != "inner_product":
        dists = jnp.where(dists <= _F32_EPS, 0.0, dists)
        if not l2_squared:
            dists = jnp.sqrt(dists)
    return ids, dists


@functools.partial(jax.jit, static_argnames=("k", "metric", "l2_squared"))
def _rerank_exact_block(q: jax.Array, qids: jax.Array, data: jax.Array,
                        ids: jax.Array, k: int, metric: str,
                        l2_squared: bool):
    """Exact re-rank of an ADC shortlist (the refine stage of the PQ tier).

    q: [B, D] full-precision query rows; qids: [B] their point ids;
    ids: [B, L] candidate ids (-1 pad).  The PQ codes are the
    accelerator-resident index (16 B/vec); only the L shortlisted rows per
    query are read at full precision — the DiskANN / faiss-IndexRefineFlat
    serving pattern.  Returns exact top-k.
    """
    if ids.shape[1] < k:
        # a small probe pool can clamp the shortlist below k; keep the
        # [B, k] output contract by padding with -1/inf lanes
        ids = jnp.pad(ids, ((0, 0), (0, k - ids.shape[1])),
                      constant_values=-1)
    c = data[jnp.maximum(ids, 0)]                          # [B, L, D]
    ip = jnp.einsum("bd,bld->bl", q, c,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
    if metric == "inner_product":
        dist = -ip
    else:
        qsq = jnp.sum(q * q, axis=1)
        csq = jnp.sum(c * c, axis=2)
        dist = jnp.maximum(qsq[:, None] + csq - 2.0 * ip, 0.0)
        # |q|^2+|c|^2-2qc cancels catastrophically at q==c (error ~
        # eps*|q|^2, far above _F32_EPS); the self pair is exactly 0
        dist = jnp.where(ids == qids[:, None], 0.0, dist)
    dist = jnp.where(ids >= 0, dist, jnp.inf)
    sd, si = jax.lax.sort((dist, ids), num_keys=1, dimension=1,
                          is_stable=True)
    sd, si = sd[:, :k], si[:, :k]
    if metric != "inner_product":
        sd = jnp.where(sd <= _F32_EPS, 0.0, sd)
        if not l2_squared:
            sd = jnp.sqrt(sd)
    return si, sd


def sq8_reconstruct(data: np.ndarray) -> np.ndarray:
    """HNSWSQ-tier 8-bit scalar quantization round-trip (reference: Knn.cpp
    computeIndexHNSWSQ:246-319 with faiss QT_8bit): per-dimension affine
    int8 codes; candidates are scored on dequantized values, quartering the
    resident dataset memory at very large N.  Shared by the IVF scoring
    path and the exact refill so one result never mixes full-precision and
    reconstruction distance scales.
    """
    lo = data.min(axis=0)
    hi = data.max(axis=0)
    scale_q = np.where(hi > lo, (hi - lo) / 255.0, 1.0)
    codes = np.clip(np.round((data - lo) / scale_q), 0, 255).astype(np.uint8)
    return (codes.astype(np.float32) * scale_q + lo).astype(np.float32)


def pq_reconstruct_rows(codes: np.ndarray, cents: np.ndarray,
                        assign: np.ndarray, codebooks: np.ndarray,
                        d: int, block: int = 262144) -> np.ndarray:
    """Decode PQ codes back to [N, d] f32 (coarse centroid + codebook
    entries).  Used by the exact-refill path so refilled rows share the
    reconstruction distance scale."""
    n, m = codes.shape
    ds = codebooks.shape[2]
    cb_d = jnp.asarray(codebooks)
    out = np.empty((n, d), np.float32)
    for b0 in range(0, n, block):
        be = min(b0 + block, n)
        oh = jax.nn.one_hot(jnp.asarray(codes[b0:be]), codebooks.shape[1],
                            dtype=jnp.float32)
        dec = np.asarray(jnp.einsum(
            "amk,mkd->amd", oh, cb_d,
            preferred_element_type=jnp.float32)).reshape(be - b0, m * ds)
        out[b0:be] = dec[:, :d] + cents[assign[b0:be]]
    return out


def knn_ivf(data: np.ndarray, k: int,
            metric: KnnMetric = KnnMetric.L2,
            l2_squared: bool = False,
            nlist: Optional[int] = None,
            nprobe: Optional[int] = None,
            seed: int = 0,
            quantize: bool = False,
            pq: bool = False,
            query_rows: Optional[np.ndarray] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate kNN via IVF cluster pruning (reference: Knn.cpp
    computeIndexIVFFlat:138-175 — nlist = max(100, sqrt(n)), nprobe =
    sqrt(nlist)).

    Queries search only the `nprobe` nearest cluster inverted lists; the
    candidate set per query is gathered into a padded [Q, C] block and scored
    with one masked matmul per query block.

    query_rows: optional [Q] row ids — search only these queries (recall
    measurement / serving); the result rows then correspond to query_rows
    order and the self-first fixup is skipped (row index != point id).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    if metric == KnnMetric.COSINE:
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        data = data / norms

    if nlist is None:
        nlist = max(100, int(math.sqrt(n)))
    nlist = min(nlist, n)
    if nprobe is None:
        nprobe = max(1, int(math.sqrt(nlist)))
    nprobe = min(nprobe, nlist)

    rng = np.random.default_rng(seed)
    init = data[rng.choice(n, nlist, replace=False)]
    km_block = min(65536, _ceil_to(n, 1024))
    npad_km = _ceil_to(n, km_block)
    data_dev = jnp.asarray(_pad_rows(data, npad_km))
    cents_d, assign_d = _kmeans(data_dev, jnp.int32(n), jnp.asarray(init),
                                nlist, 10, block=km_block)
    # empty-cell reseeding (FAISS Clustering::train semantics): Lloyd
    # leaves empty cells stuck — their centroids never move — which on
    # clustered data wastes most of nlist and caps recall (BASELINE.md
    # nprobe sweep: misses are assignment effects, not probe-limited).
    # Reseed empties with points drawn from the biggest clusters and
    # re-run a few sweeps until (almost) every cell is populated.
    for _ in range(3):
        assign = np.asarray(assign_d)[:n]
        counts0 = np.bincount(assign, minlength=nlist)
        empty = np.nonzero(counts0 == 0)[0]
        if len(empty) <= max(nlist // 200, 0):
            break
        # np.array (copy): np.asarray of a CPU-backend jax array is a
        # zero-copy READ-ONLY view and the reseed assignment would crash
        cents = np.array(cents_d)
        big = np.argsort(-counts0)[:max(len(empty), 1)]
        donors = rng.permutation(np.nonzero(np.isin(assign, big))[0])
        take = donors[:len(empty)] if len(donors) >= len(empty) else (
            rng.choice(n, len(empty)))
        cents[empty] = data[take] * (1.0 + 1e-4) + 1e-6
        cents_d, assign_d = _kmeans(data_dev, jnp.int32(n),
                                    jnp.asarray(cents), nlist, 5,
                                    block=km_block)
    cents = np.asarray(cents_d)
    assign = np.asarray(assign_d)[:n]

    # cluster-sorted point order (the inverted lists, implicitly)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(assign, minlength=nlist)
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    if quantize:
        data = sq8_reconstruct(data)

    # nprobe nearest centroids per CLUSTER (the cluster-grouped layout
    # shares one probe set across a query cluster; see _ivf_grouped_device)
    ccd = (np.sum(cents * cents, 1)[:, None]
           + np.sum(cents * cents, 1)[None, :] - 2.0 * cents @ cents.T)
    probes = np.argpartition(ccd, min(nprobe, nlist - 1),
                             axis=1)[:, :nprobe].astype(np.int32)
    # the cluster itself must always be probed (argpartition ties can push
    # it out); replace slot 0 only when missing so probe ids stay unique
    # (a duplicated probe would duplicate candidates in the top-k)
    has_self = (probes == np.arange(nlist)[:, None]).any(axis=1)
    probes[:, 0] = np.where(has_self, probes[:, 0], np.arange(nlist))

    # uniform segmentation: every inverted list splits into fixed [seg]
    # chunks (seg ~ the average list size), so one compiled shape covers
    # arbitrary cluster-size skew and tiles stay [seg, seg]
    seg = max(256, 1 << max(int(math.ceil(n / nlist)) - 1, 0).bit_length())
    seg = min(seg, 8192)
    nseg_per = np.maximum((counts + seg - 1) // seg, 0)
    seg_starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(nseg_per, out=seg_starts[1:])
    s_total = int(seg_starts[-1])

    # segment table from the cluster-sorted point order
    flat = np.full(s_total * seg, -1, np.int32)
    # position of point j (order[j], cluster sorted_assign[j]) in the
    # segment layout: cluster base + within-cluster offset
    within = np.arange(n) - starts[sorted_assign]
    pos = seg_starts[sorted_assign] * seg + within
    flat[pos] = order.astype(np.int32)
    segtab = flat.reshape(s_total, seg)
    seg_cluster = np.repeat(np.arange(nlist), nseg_per)

    if pq:
        # true product quantization (HNSW_IVFPQ tier): m=16 x 8-bit
        # residual codes, ADC scoring with on-the-fly matmul decode
        codebooks = pq_train(data, cents, assign, seed=seed)
        codes = pq_encode(data, cents, assign, codebooks)
        pq_state = (codes, codebooks)
        Log.info("knn_ivf: PQ codec m=%d ksub=%d ds=%d (%d B/vec vs %d)",
                 codebooks.shape[0], codebooks.shape[1],
                 codebooks.shape[2], codebooks.shape[0], 4 * d)

    # probe SEGMENT list per cluster: all segments of each probed cluster
    psegs_counts = nseg_per[probes].sum(axis=1)            # [nlist]
    max_psegs = max(int(psegs_counts.max()), 1)
    psegs_cl = np.full((nlist, max_psegs), -1, np.int32)
    for c in range(nlist):
        out = []
        for pc in probes[c]:
            out.extend(range(int(seg_starts[pc]),
                             int(seg_starts[pc + 1])))
        psegs_cl[c, :len(out)] = out
    psegs = psegs_cl[seg_cluster]                          # [S, max_psegs]

    import jax
    data_d = jnp.asarray(data)
    segtab_d = jnp.asarray(segtab)
    psegs_d = jnp.asarray(psegs)

    if pq:
        codes_d = jnp.asarray(pq_state[0])
        cb_d = jnp.asarray(pq_state[1])
        cents_dev = jnp.asarray(cents.astype(np.float32))
        segcl_d = jnp.asarray(seg_cluster.astype(np.int32))
        # ADC alone misranks within-cluster near-ties (16-byte codes can't
        # separate true top-k neighbors whose gaps are below quantization
        # noise) — search a wider shortlist, then exact re-rank below
        ksearch = min(max(int(os.environ.get("SPH_PQ_RERANK", "512")),
                          2 * k), seg * max_psegs)

        def _score(qt_w, ps_w):
            return _ivf_grouped_device_pq(
                data_d, codes_d, cb_d, cents_dev, segcl_d, segtab_d,
                qt_w, ps_w, ksearch, metric.value, l2_squared)
    else:
        def _score(qt_w, ps_w):
            return _ivf_grouped_device(data_d, segtab_d, qt_w, ps_w, k,
                                       metric.value, l2_squared)

    def _rerank_window(qt_w: jax.Array, ib: jax.Array):
        """Exact re-rank of ONE window's ADC shortlists, [W, seg, ksearch]
        -> [W, seg, k], immediately after that window is scored.  Fusing
        the refine into the dispatch loop keeps the peak extra memory at
        O(window), not O(n * ksearch) — at the tier's own 50M-point scale
        a whole-index shortlist would be tens of GB (advisor r4 medium).
        Final distances are exact full-precision, matching the flat tier.
        """
        w = qt_w.shape[0]
        flat_qw = qt_w.reshape(-1)
        rows = flat_qw.shape[0]
        rb = min(8192, rows)
        rpad = _ceil_to(rows, rb)
        idsw = ib.reshape(rows, -1)
        if rpad != rows:
            flat_qw = jnp.pad(flat_qw, (0, rpad - rows),
                              constant_values=-1)
            idsw = jnp.pad(idsw, ((0, rpad - rows), (0, 0)),
                           constant_values=-1)
        qw = data_d[jnp.maximum(flat_qw, 0)]
        ri, rd = [], []
        for b0 in range(0, rpad, rb):
            si, sd = _rerank_exact_block(
                qw[b0:b0 + rb], flat_qw[b0:b0 + rb], data_d,
                idsw[b0:b0 + rb], k, metric.value, l2_squared)
            jax.block_until_ready(sd)
            ri.append(si)
            rd.append(sd)
        return (jnp.concatenate(ri, axis=0)[:rows].reshape(w, seg, k),
                jnp.concatenate(rd, axis=0)[:rows].reshape(w, seg, k))

    # dispatch in windows of query segments rather than one monolithic map
    # over all segments that runs for minutes at scale (same guard as
    # knn_bruteforce's row windows)
    max_tiles = int(os.environ.get("SPH_IVF_TILES_PER_DISPATCH", "4096"))
    swin = max(1, max_tiles // max(max_psegs, 1))
    if s_total > swin:
        # pad S to a window multiple so every dispatch shares one shape
        spad = _ceil_to(s_total, swin)
        if spad != s_total:
            qt = jnp.pad(segtab_d, ((0, spad - s_total), (0, 0)),
                         constant_values=-1)
            ps = jnp.pad(psegs_d, ((0, spad - s_total), (0, 0)),
                         constant_values=-1)
        else:
            qt, ps = segtab_d, psegs_d
        parts = []
        for s0 in range(0, spad, swin):
            ib, db = _score(qt[s0:s0 + swin], ps[s0:s0 + swin])
            jax.block_until_ready(db)
            if pq:
                ib, db = _rerank_window(qt[s0:s0 + swin], ib)
            parts.append((ib, db))
        ids_b = jnp.concatenate([p[0] for p in parts], axis=0)[:s_total]
        dists_b = jnp.concatenate([p[1] for p in parts], axis=0)[:s_total]
    else:
        ids_b, dists_b = _score(segtab_d, psegs_d)
        if pq:
            ids_b, dists_b = _rerank_window(segtab_d, ids_b)

    flat_q = segtab_d.reshape(-1)
    # pad lanes scatter out of bounds and drop — routing them to row 0
    # with their old value would race real writes to row 0 (duplicate
    # scatter indices have no ordering guarantee)
    tgt = jnp.where(flat_q >= 0, flat_q, jnp.int32(n))
    n_out_i = jnp.full((n, k), -1, jnp.int32).at[tgt].set(
        ids_b.reshape(-1, k), mode="drop")
    n_out_d = jnp.full((n, k), np.inf, jnp.float32).at[tgt].set(
        dists_b.reshape(-1, k), mode="drop")

    from .graph import ensure_self_first_device
    idx_d2, dist_d2, _ = ensure_self_first_device(n_out_i, n_out_d)
    if query_rows is not None:
        qr = jnp.asarray(np.asarray(query_rows, np.int64))
        return (np.asarray(idx_d2[qr]).astype(np.int32),
                np.asarray(dist_d2[qr]).astype(np.float32))
    return (np.asarray(idx_d2).astype(np.int32),
            np.asarray(dist_d2).astype(np.float32))


# ---------------------------------------------------------------------------
# Engine dispatch + size heuristic
# ---------------------------------------------------------------------------

def index_heuristic(num_points: int) -> KnnIndex:
    """Size-tier engine choice (reference: sph/NearestNeighbors.hpp:50-63).

    The reference's brute-force cutoff is 10k (CPU SIMD heaps); as blocked
    matmuls the exact pass is cheap well past that and the IVF tier's
    k-means + grouping overhead only pays for itself far beyond it, so the
    exact tier extends to 50k here.
    """
    if num_points <= 50_000:
        return KnnIndex.BRUTE_FORCE
    if num_points <= 100_000:
        return KnnIndex.IVF_FLAT
    if num_points <= 25_000_000:
        return KnnIndex.HNSW
    if num_points <= 50_000_000:
        return KnnIndex.HNSWSQ
    return KnnIndex.HNSW_IVFPQ


def compute_knn(data: np.ndarray, k: int,
                index: KnnIndex = KnnIndex.FLAT,
                metric: KnnMetric = KnnMetric.L2,
                l2_squared: bool = False,
                seed: int = 0,
                keep_on_device: bool = False,
                data_dev=None) -> Tuple[np.ndarray, np.ndarray]:
    """Engine dispatch (reference: NearestNeighbors.cpp:131-141).

    The exact engines (BRUTE_FORCE / FLAT) are the blocked matmul; the
    approximate tiers map to IVF cluster pruning — blocked brute force is
    fast enough far beyond the reference's 10k cutoff, so the IVF tier only
    engages for very large N.
    """
    if index in (KnnIndex.BRUTE_FORCE, KnnIndex.FLAT):
        return knn_bruteforce(data, k, metric, l2_squared,
                              keep_on_device=keep_on_device,
                              data_dev=data_dev)
    if index in (KnnIndex.IVF_FLAT, KnnIndex.HNSW, KnnIndex.HNSWSQ,
                 KnnIndex.HNSW_IVFPQ):
        quantize = index == KnnIndex.HNSWSQ
        pq = index == KnnIndex.HNSW_IVFPQ
        idx, dist = knn_ivf(data, k, metric, l2_squared, seed=seed,
                            quantize=quantize, pq=pq)
        # the PQ tier's refine stage re-ranks shortlists at full precision,
        # so its final distances share the flat tier's scale — incomplete
        # rows take the standard targeted exact refill below (no scale mix)
        # reference refills missing neighbors with an exact pass
        # (Knn.cpp:214-243); here: incomplete rows get a targeted exact
        # refill (query-block kernel) — only a widespread failure falls
        # back to the full N x N recompute
        if np.any(idx < 0):
            miss = np.unique(np.nonzero(idx < 0)[0])
            if miss.size > max(1024, idx.shape[0] // 4):
                Log.warn("compute_knn: IVF left %d/%d incomplete rows, "
                         "falling back to exact (reference: "
                         "NearestNeighbors.cpp:143-148)", miss.size,
                         idx.shape[0])
                return knn_bruteforce(data, k, metric, l2_squared)
            Log.warn("compute_knn: exact refill of %d/%d incomplete IVF "
                     "rows (reference: NearestNeighbors.cpp:143-148)",
                     miss.size, idx.shape[0])
            # quantized tiers score on SQ8 reconstructions — refill on the
            # same reconstruction so every row shares one distance scale
            refill_data = sq8_reconstruct(np.ascontiguousarray(
                data, dtype=np.float32)) if quantize else data
            ridx, rdist = knn_exact_rows(refill_data, miss, k, metric,
                                         l2_squared)
            idx = idx.copy()
            dist = dist.copy()
            idx[miss] = ridx
            dist[miss] = rdist
            from .graph import ensure_self_first
            idx, dist, _ = ensure_self_first(idx, dist)
            return idx.astype(np.int32), dist.astype(np.float32)
        return idx, dist
    raise ValueError(f"unknown index {index}")
