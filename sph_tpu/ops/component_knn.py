"""Exact kNN in component metric spaces.

Reference: sph/LevelSimilarities.cpp computeNearestNeighborOnLevel
(:191-442) — per-level kNN over components whose "vectors" are
ComponentID{level, id} structs, searched either exactly (O(n^2) loop,
:211-252) or via hnswlib HNSW with the 5 custom SpaceInterface adapters
(sph/utils/*Space.hpp).

Redesign: component counts shrink geometrically per level, so the
exact O(C^2) computation is cheap *if* it is laid out as blocked matmuls:

* NEIGH_OVERLAP      -> 0/1 membership matrix product M M^T
* NEIGH_WALKS        -> sqrt-walk product (Bhattacharyya)
* NEIGH_WALKS_SINGLE -> max(W, W^T) from densified walk blocks
* EUCLID_CENTROID    -> blocked sampled-point Hausdorff (batched matmuls)
* GEO_*              -> SSSP fields (ops/shortest_path) + Hausdorff gather

Each returns a fixed-k distance graph (indices [C, k], distances [C, k],
ascending, self first) — the exact analogue of the reference's per-level
`_distanceGraphs`.  HNSW is unnecessary: a blocked matmul evaluates the full
matrix faster than an index could be built.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .graph import ensure_self_first
from .sparse import SparseRows

_HP = jax.lax.Precision.HIGHEST


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# NEIGH_OVERLAP
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "block"))
def _overlap_knn(members: jax.Array, counts: jax.Array, n_valid, k: int,
                 block: int):
    """members: [Cpad, N] int8 0/1 membership; sim = |A^B| / min(|A|,|B|);
    dist = 1 - sim (reference: NeighborOverlapSpace.hpp:31-42).

    int8 storage keeps Salinas-scale membership (50k comps x 111k pixels)
    under a device-memory budget; the intersection counts come out exact
    through the int8 x int8 -> f32 matmul (counts << 2^24)."""
    cpad, n = members.shape
    num_blocks = cpad // block
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, cpad), 1)

    def row_block(rb):
        rows = jax.lax.dynamic_slice_in_dim(members, rb * block, block)
        inter = jnp.dot(rows.astype(jnp.bfloat16),
                        members.T.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)  # [block, Cpad]
        rc = jax.lax.dynamic_slice_in_dim(counts, rb * block, block)
        m = jnp.minimum(rc[:, None], counts[None, :])
        sim = jnp.where(m > 0, inter / jnp.maximum(m, 1.0), 0.0)
        dist = 1.0 - sim
        row_ids = (jax.lax.broadcasted_iota(jnp.int32, dist.shape, 0)
                   + rb * block)
        dist = jnp.where(col_ids == row_ids, 0.0, dist)
        dist = jnp.where(col_ids >= n_valid, jnp.inf, dist)
        neg, sel = jax.lax.top_k(-dist, k)
        return -neg, sel

    dists, ids = jax.lax.map(row_block, jnp.arange(num_blocks))
    return ids.reshape(cpad, k), dists.reshape(cpad, k)


def knn_neighbor_overlap(unions: SparseRows, k: int, block: int = 256
                         ) -> Tuple[np.ndarray, np.ndarray]:
    c = unions.num_rows
    n = unions.num_cols
    from .bucketing import bucket_k, bucket_rows
    cpad = _ceil_to(bucket_rows(max(8, c)), 8)
    block = min(block, cpad)
    cpad = _ceil_to(cpad, block)
    members = np.zeros((cpad, n), dtype=np.int8)
    mask = unions.mask
    rows = np.broadcast_to(np.arange(c)[:, None], unions.indices.shape)[mask]
    members[rows, unions.indices[mask]] = 1
    counts = np.zeros(cpad, dtype=np.float32)
    counts[:c] = unions.row_nnz()
    kk = min(bucket_k(k), cpad)
    ids, dists = _overlap_knn(jnp.asarray(members), jnp.asarray(counts),
                              jnp.int32(c), kk, block)
    return _finalize(np.asarray(ids)[:c, :min(k, c)],
                     np.asarray(dists)[:c, :min(k, c)])


# ---------------------------------------------------------------------------
# NEIGH_WALKS (Bhattacharyya) and SINGLE_OVERLAP
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "block", "single"))
def _walks_knn(indices: jax.Array, values: jax.Array, n_valid, k: int,
               block: int, single: bool):
    cpad, r = indices.shape
    num_blocks = cpad // block

    def densify(b, sqrt_vals):
        idx = jax.lax.dynamic_slice_in_dim(indices, b * block, block)
        val = jax.lax.dynamic_slice_in_dim(values, b * block, block)
        v = jnp.where(idx < 0, 0.0, val)
        if sqrt_vals:
            v = jnp.sqrt(jnp.maximum(v, 0.0))
        # pads route to strictly-increasing off-grid columns (cpad + lane)
        # so per-row indices are truly sorted AND unique for the scatter
        # lowering — a shared pad column makes the hint false, and a
        # scatter under a false hint may silently write zeros (see
        # pairwise_similarities densify)
        rr2 = jax.lax.broadcasted_iota(jnp.int32, (block, r), 0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (block, r), 1)
        safe = jnp.where(idx < 0, cpad + lane, idx)
        dense = jnp.zeros((block, cpad + r), jnp.float32)
        dense = dense.at[rr2, safe].add(v, indices_are_sorted=True,
                                        unique_indices=True)
        return dense[:, :cpad]

    if single:
        # sim = max(w[a, b], w[b, a]): blocked densify of both the row and
        # column blocks — the transposed entries come from slicing the
        # column block's dense rows, not from per-element sparse lookups
        # (vmapped searchsorted lowers to per-element gathers; see
        # sparse._bhattacharyya_pairs_device)
        def row_block(rb):
            rows_dense = densify(rb, False)        # w[a, :] for the block
            row_ids = (jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0)
                       + rb * block)

            def col_step(carry, cb):
                top_d, top_i = carry
                cols_dense = densify(cb, False)    # w[b, :] for the block
                wab = jax.lax.dynamic_slice_in_dim(rows_dense, cb * block,
                                                   block, axis=1)
                wba = jax.lax.dynamic_slice_in_dim(cols_dense, rb * block,
                                                   block, axis=1)
                sim = jnp.maximum(wab, wba.T)
                ids = (jax.lax.broadcasted_iota(jnp.int32, sim.shape, 1)
                       + cb * block)
                dist = 1.0 - sim
                dist = jnp.where(ids == row_ids, 0.0, dist)
                dist = jnp.where(ids >= n_valid, jnp.inf, dist)
                merged_d = jnp.concatenate([top_d, dist], axis=1)
                merged_i = jnp.concatenate([top_i, ids], axis=1)
                neg, sel = jax.lax.top_k(-merged_d, k)
                rr3 = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 0)
                return (-neg, merged_i[rr3, sel]), None

            init = (jnp.full((block, k), jnp.inf, jnp.float32),
                    jnp.full((block, k), -1, jnp.int32))
            (top_d, top_i), _ = jax.lax.scan(col_step, init,
                                             jnp.arange(num_blocks))
            return top_d, top_i

        dists, ids = jax.lax.map(row_block, jnp.arange(num_blocks))
        return ids.reshape(cpad, k), dists.reshape(cpad, k)

    # Bhattacharyya: blocked sqrt-row products; no full [C, C] densify
    def row_block(rb):
        rows_dense = densify(rb, True)
        row_ids = (jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0)
                   + rb * block)

        def col_step(carry, cb):
            top_d, top_i = carry
            cols_dense = densify(cb, True)
            bc = jnp.dot(rows_dense[:, :], cols_dense.T,
                         preferred_element_type=jnp.float32,
                         precision=_HP)
            # inner product runs over the full column space; restrict to
            # the cb block's columns for ids
            ids = (jax.lax.broadcasted_iota(jnp.int32, bc.shape, 1)
                   + cb * block)
            dist = 1.0 - jnp.minimum(bc, 1.0)
            dist = jnp.where(ids == row_ids, 0.0, dist)
            dist = jnp.where(ids >= n_valid, jnp.inf, dist)
            merged_d = jnp.concatenate([top_d, dist], axis=1)
            merged_i = jnp.concatenate([top_i, ids], axis=1)
            neg, sel = jax.lax.top_k(-merged_d, k)
            rr3 = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 0)
            return (-neg, merged_i[rr3, sel]), None

        init = (jnp.full((block, k), jnp.inf, jnp.float32),
                jnp.full((block, k), -1, jnp.int32))
        (top_d, top_i), _ = jax.lax.scan(col_step, init,
                                         jnp.arange(num_blocks))
        return top_d, top_i

    dists, ids = jax.lax.map(row_block, jnp.arange(num_blocks))
    return ids.reshape(cpad, k), dists.reshape(cpad, k)


def knn_walks(walks: SparseRows, k: int, single_overlap: bool = False,
              block: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """dist = 1 - BC (NeighborWalksBhattacharyyaSpace) or 1 - max transition
    (NeighborWalksSingleOverlapSpace).  k and the row width are bucketed so
    levels share compiled programs.

    block: row-tile size.  The per-tile densify scatter dominates at
    scale and its total count falls quadratically with block (measured
    6.3x on the sibling pairwise kernel at 28k rows; docs/performance.md
    round-5); override with SPH_WALKS_KNN_BLOCK."""
    import os
    from .bucketing import bucket_k, bucket_rows, bucket_width
    block = int(os.environ.get("SPH_WALKS_KNN_BLOCK", block))
    c = walks.num_rows
    # canonical shapes: row bucket (512 floor) + one k bucket independent
    # of the level's component count, so the shrinking level loop shares
    # ONE compiled program (raw cpad/kk compiled this per level before)
    cpad = _ceil_to(bucket_rows(max(8, c)), 8)
    block = min(block, cpad)
    cpad = _ceil_to(cpad, block)
    wpad = bucket_width(walks.width)
    kk = min(bucket_k(k), cpad)
    idx = np.full((cpad, wpad), -1, dtype=np.int32)
    val = np.zeros((cpad, wpad), dtype=np.float32)
    idx[:c, :walks.width] = walks.indices
    val[:c, :walks.width] = walks.values
    ids, dists = _walks_knn(jnp.asarray(idx), jnp.asarray(val),
                            jnp.int32(c), kk, block, single_overlap)
    return _finalize(np.asarray(ids)[:c, :min(k, c)],
                     np.asarray(dists)[:c, :min(k, c)])


# ---------------------------------------------------------------------------
# EUCLID_CENTROID: sampled-point Hausdorff matrix
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "block"))
def _hausdorff_knn(points: jax.Array, mask: jax.Array, n_valid, k: int,
                   block: int):
    """points: [Cpad, S, D] sampled representative points, mask [Cpad, S].

    Hausdorff over sampled sets, blocked over row components; the inner
    [block*S, Cpad*S] distance product runs as one matmul.
    """
    cpad, s, d = points.shape
    num_blocks = cpad // block
    flat = points.reshape(cpad * s, d)
    flat_sq = jnp.sum(flat * flat, axis=1)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, cpad), 1)

    def row_block(rb):
        rows = jax.lax.dynamic_slice_in_dim(points, rb * block, block)
        rmask = jax.lax.dynamic_slice_in_dim(mask, rb * block, block)
        rflat = rows.reshape(block * s, d)
        rsq = jnp.sum(rflat * rflat, axis=1)
        ip = jnp.dot(rflat, flat.T, preferred_element_type=jnp.float32,
                     precision=_HP)
        d2 = jnp.maximum(rsq[:, None] + flat_sq[None, :] - 2.0 * ip, 0.0)
        dist = jnp.sqrt(d2).reshape(block, s, cpad, s)
        pair_ok = rmask[:, :, None, None] & mask[None, None, :, :]
        dist_inf = jnp.where(pair_ok, dist, jnp.inf)
        # h1: max over row samples of min over col samples
        m1 = jnp.min(dist_inf, axis=3)                       # [block,S,Cpad]
        m1 = jnp.where(rmask[:, :, None], m1, -jnp.inf)
        h1 = jnp.max(m1, axis=1)                             # [block, Cpad]
        m2 = jnp.min(dist_inf, axis=1)                       # [block,Cpad,S]
        m2 = jnp.where(mask[None], m2, -jnp.inf)
        h2 = jnp.max(m2, axis=2)
        h = jnp.maximum(h1, h2)
        row_ids = (jax.lax.broadcasted_iota(jnp.int32, h.shape, 0)
                   + rb * block)
        h = jnp.where(col_ids == row_ids, 0.0, h)
        h = jnp.where(col_ids >= n_valid, jnp.inf, h)
        neg, sel = jax.lax.top_k(-h, k)
        return -neg, sel

    dists, ids = jax.lax.map(row_block, jnp.arange(num_blocks))
    return ids.reshape(cpad, k), dists.reshape(cpad, k)


def knn_hausdorff(data: np.ndarray, rep_samples: np.ndarray, k: int,
                  block: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """rep_samples: [C, S] padded (-1) data-point ids per component.
    S and k are bucketed so levels share compiled programs."""
    from .bucketing import bucket_k, bucket_rows, next_pow2
    c, s = rep_samples.shape
    spad = next_pow2(s)
    cpad = _ceil_to(bucket_rows(max(8, c)), 8)
    block = min(block, cpad)
    cpad = _ceil_to(cpad, block)
    kk = min(bucket_k(k), cpad)
    samples = np.full((cpad, spad), -1, dtype=np.int64)
    samples[:c, :s] = rep_samples
    mask = samples >= 0
    pts = data[np.maximum(samples, 0)]
    pts = np.where(mask[:, :, None], pts, 0.0).astype(np.float32)
    ids, dists = _hausdorff_knn(jnp.asarray(pts), jnp.asarray(mask),
                                jnp.int32(c), kk, block)
    return _finalize(np.asarray(ids)[:c, :min(k, c)],
                     np.asarray(dists)[:c, :min(k, c)])


# ---------------------------------------------------------------------------

def _finalize(ids: np.ndarray, dists: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Self-first + ascending invariant for the per-level distance graph
    (the reference gets this from sorted exact search + ComponentID self
    distance 0)."""
    ids, dists, _ = ensure_self_first(ids.astype(np.int32),
                                      dists.astype(np.float32))
    return ids, dists


# ---------------------------------------------------------------------------
# Approximate tier: IVF cluster pruning in proxy sketch spaces.
#
# Reference: computeApproximateKnn (LevelSimilarities.cpp:254-334) builds an
# hnswlib HNSW (M=16, efC=200) whose "points" are ComponentID structs and
# whose distance calls the virtual component metric.  Graph-walk indexes are
# pointer-chasing and serialize on an accelerator; the device equivalent
# keeps the approximation *in the candidate generation*: k-means cluster
# pruning over a dense proxy sketch of each component (all matmuls), then
# the EXACT pair metric on only the pruned candidate set.  Recall is controlled by nprobe,
# like FAISS IVF / hnswlib efSearch.

def project_sparse_rows(rows: SparseRows, dim: int = 128,
                        seed: int = 0) -> np.ndarray:
    """JL sketch of sqrt-valued sparse rows: feat = sqrt(S) @ R.

    Bhattacharyya(a, b) = <sqrt a, sqrt b>, so euclidean geometry on the
    sqrt-row sketches approximates BC ordering; membership overlap is the
    same with 0/1 values."""
    import scipy.sparse as sp
    c, n = rows.num_rows, rows.num_cols
    mask = rows.indices >= 0
    indptr = np.zeros(c + 1, np.int64)
    np.cumsum(mask.sum(1), out=indptr[1:])
    data = np.sqrt(np.maximum(rows.values[mask], 0.0)).astype(np.float32)
    cols = rows.indices[mask].astype(np.int64)
    s = sp.csr_matrix((data, cols, indptr), shape=(c, n))
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((n, dim)) / np.sqrt(dim)).astype(np.float32)
    return np.asarray(s @ r, dtype=np.float32)


def ivf_candidate_table(features: np.ndarray, nlist: int | None = None,
                        nprobe: int | None = None, seed: int = 0,
                        kmeans_iters: int = 8) -> np.ndarray:
    """Candidate component ids per component: [C, nprobe * Lmax] int32, -1
    padded.  Every component's own cluster is its nearest centroid, so self
    is always a candidate."""
    import math as _math
    from .knn import _kmeans
    c, _ = features.shape
    if nlist is None:
        nlist = max(16, int(_math.sqrt(c)))
    nlist = min(nlist, c)
    if nprobe is None:
        nprobe = max(4, int(_math.sqrt(nlist)))
    nprobe = min(nprobe, nlist)

    rng = np.random.default_rng(seed)
    init = features[rng.choice(c, nlist, replace=False)]
    km_block = min(65536, ((c + 1023) // 1024) * 1024)
    cpad = ((c + km_block - 1) // km_block) * km_block
    feats_pad = np.zeros((cpad, features.shape[1]), np.float32)
    feats_pad[:c] = features
    cents, assign = _kmeans(jnp.asarray(feats_pad), jnp.int32(c),
                            jnp.asarray(init), nlist, kmeans_iters,
                            block=km_block)
    cents = np.asarray(cents)
    assign = np.asarray(assign)[:c]

    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist)
    lmax = int(counts.max())
    lists = np.full((nlist, lmax), -1, dtype=np.int32)
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(c) - starts[assign[order]]
    lists[assign[order], slot] = order.astype(np.int32)

    cd = (np.sum(features * features, 1)[:, None]
          + np.sum(cents * cents, 1)[None, :] - 2.0 * features @ cents.T)
    probes = np.argpartition(cd, min(nprobe, nlist - 1),
                             axis=1)[:, :nprobe]
    return lists[probes].reshape(c, -1)


def approx_pair_metric_knn(pair_fn, features: np.ndarray, k: int,
                           seed: int = 0,
                           nlist: int | None = None,
                           nprobe: int | None = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate component kNN: IVF candidates from `features`, exact
    distances from `pair_fn(rows_a, rows_b) -> [E] float32`, then per-row
    bottom-k.  Self-first/ascending invariants match the exact tier."""
    c = features.shape[0]
    cand = ivf_candidate_table(features, nlist=nlist, nprobe=nprobe,
                               seed=seed)
    m = cand.shape[1]
    rows = np.repeat(np.arange(c, dtype=np.int32), m)
    cols = cand.ravel()
    valid = cols >= 0
    d = np.full(c * m, np.inf, dtype=np.float32)
    d[valid] = pair_fn(rows[valid], cols[valid])
    d = d.reshape(c, m)
    # exclude self from the neighbor ranking; _finalize re-inserts it first
    d = np.where(cand == np.arange(c)[:, None], np.inf, d)

    kk = min(k, m)
    part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
    r = np.arange(c)[:, None]
    dk = d[r, part]
    order = np.argsort(dk, axis=1, kind="stable")
    ids = cand[r, part[r, order]]
    dists = dk[r, order]
    if kk < k:
        ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
        dists = np.pad(dists, ((0, 0), (0, k - kk)),
                       constant_values=np.inf)
    # drop unfilled (inf) candidate slots beyond the real neighbors
    ids = np.where(np.isfinite(dists), ids, -1)
    # self goes to slot 0 with distance 0; the last neighbor is displaced
    ids = np.concatenate([np.arange(c, dtype=ids.dtype)[:, None],
                          ids[:, :-1]], axis=1)
    dists = np.concatenate([np.zeros((c, 1), np.float32),
                            dists[:, :-1]], axis=1)
    return _finalize(ids, dists)
