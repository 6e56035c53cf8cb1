"""Batched component-pair similarity/distance kernels.

Reference: sph/utils/Similarities.cpp — `componentDistance` (:123-156)
dispatches per ComponentSim to NEIGH_OVERLAP (:174-228), GEO_* (:234-310),
NEIGH_WALKS Bhattacharyya (:353-396), NEIGH_WALKS_SINGLE_OVERLAP (:328-351,
:374-377), EUCLID_CENTROID Hausdorff (:414-483).

Redesign: the reference calls a virtual distance function once per
edge inside an OpenMP loop, memoized by a mutex-guarded DistanceCache.  Here
every metric is a *batched* kernel over all requested (a, b) pairs at once:
gathers + elementwise reductions for the sparse overlap metrics and matmuls for
the Hausdorff point-set metrics.  No cache is needed — recomputation is
cheaper than the mutex (the reference itself concluded this and disabled the
cache, ComputeHierarchy.cpp:187).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sparse import PAD, SparseRows

_BIG_I32 = np.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# sparse row lookups (NEIGH_WALKS / NEIGH_WALKS_SINGLE_OVERLAP)
# ---------------------------------------------------------------------------

@jax.jit
def _lookup_pairs(indices, values, rows, cols):
    """values[rows[e], cols[e]] for sparse rows.  One [E, R] lane-parallel
    compare + masked sum — vmapped binary search lowers to per-element
    gathers (see _bhattacharyya_pairs_device)."""
    ir = indices[rows]
    vr = values[rows]
    m = (ir == cols[:, None]) & (ir >= 0)
    return jnp.sum(jnp.where(m, vr, 0.0), axis=1)


def _pair_chunks(e: int, width: int):
    """Chunk boundaries for per-pair row gathers: bound the [E, R] gather
    buffer to ~2^26 entries (mirrors bhattacharyya_pairs / walk chunking)."""
    chunk = max(4096, (1 << 26) // max(width, 1))
    return chunk


def walks_single_overlap_distance(walks: SparseRows, pairs_a: np.ndarray,
                                  pairs_b: np.ndarray) -> np.ndarray:
    """1 - max(w[a, b], w[b, a]) (reference: simRandomWalksSingleOverlay,
    Similarities.cpp:328-351)."""
    from .bucketing import bucket_rows, bucket_width, pad_axis
    e = len(pairs_a)
    idx, val = walks.device()
    wp = bucket_width(walks.width)
    rp = bucket_rows(max(8, walks.num_rows))
    if (rp, wp) != (idx.shape[0], idx.shape[1]):
        from .sparse import _pad_pair_dev
        idx, val = _pad_pair_dev(idx, val, rp, wp)
    pairs_a = np.asarray(pairs_a, np.int32)
    pairs_b = np.asarray(pairs_b, np.int32)
    if e == 0:
        return np.empty(0, np.float32)
    chunk = _pair_chunks(e, wp)
    out = np.empty(e, np.float32)
    for i0 in range(0, max(e, 1), chunk):
        i1 = min(i0 + chunk, e)
        w = bucket_rows(i1 - i0) if e <= chunk else chunk
        a = jnp.asarray(pad_axis(pairs_a[i0:i1], 0, w, 0))
        b = jnp.asarray(pad_axis(pairs_b[i0:i1], 0, w, 0))
        ab = _lookup_pairs(idx, val, a, b)
        ba = _lookup_pairs(idx, val, b, a)
        sim = jnp.maximum(ab, ba)
        out[i0:i1] = np.asarray(1.0 - sim)[:i1 - i0]
    return out


def walks_bhattacharyya_distance(walks: SparseRows, pairs_a: np.ndarray,
                                 pairs_b: np.ndarray) -> np.ndarray:
    """1 - BC(row_a, row_b) (reference: simRandomWalksBhattacharyya)."""
    from .sparse import bhattacharyya_pairs
    bc = bhattacharyya_pairs(walks, pairs_a, pairs_b)
    return np.asarray(1.0 - bc)


# ---------------------------------------------------------------------------
# NEIGH_OVERLAP: kNN-union intersection over represented pixels
# ---------------------------------------------------------------------------

def build_union_neighborhoods(knn_indices: np.ndarray,
                              pixel_components: np.ndarray,
                              num_components: int) -> SparseRows:
    """Per component: sorted unique union of the kNN ids of its represented
    pixels (reference: representedOverlap getKnn, Similarities.cpp:192-205).
    Returned as SparseRows with value 1 at each member."""
    n, k = knn_indices.shape
    comp = np.repeat(pixel_components.astype(np.int64), k)
    nbr = knn_indices.ravel().astype(np.int64)
    # drop padded slots (-1) — mapping them to pixel 0 would inject a fake
    # shared member into every component with a ragged row
    ok = nbr >= 0
    comp, nbr = comp[ok], nbr[ok]
    key = np.unique(comp * n + nbr)
    rows = (key // n).astype(np.int64)
    cols = (key % n).astype(np.int32)
    counts = np.bincount(rows, minlength=num_components)
    width = max(int(counts.max()) if counts.size else 1, 1)
    indices = np.full((num_components, width), PAD, dtype=np.int32)
    values = np.zeros((num_components, width), dtype=np.float32)
    starts = np.zeros(num_components + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(rows.size) - starts[rows]
    indices[rows, slot] = cols
    values[rows, slot] = 1.0
    return SparseRows(indices, values, n)


@jax.jit
def _overlap_pairs(indices, counts, rows_a, rows_b):
    """|A intersect B| via a lane-local sorted merge: concatenate both id
    lists, sort along the lane axis, count adjacent equal ids (ids are
    unique per list, so every equal-adjacent pair is a cross-list match).
    Binary-search membership lowers to per-element gathers (see
    _bhattacharyya_pairs_device)."""
    ia = indices[rows_a]
    ib = indices[rows_b]
    ia_s = jnp.where(ia < 0, _BIG_I32, ia)
    ib_s = jnp.where(ib < 0, _BIG_I32, ib)
    both = jnp.concatenate([ia_s, ib_s], axis=1)
    (si,) = jax.lax.sort((both,), num_keys=1, dimension=1, is_stable=False)
    eq = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] < _BIG_I32)
    inter = jnp.sum(eq, axis=1)
    ca = counts[rows_a]
    cb = counts[rows_b]
    msize = jnp.minimum(ca, cb)
    return jnp.where(msize > 0, inter / msize.astype(jnp.float32), 0.0)


def neighbor_overlap_distance(unions: SparseRows, pairs_a: np.ndarray,
                              pairs_b: np.ndarray) -> np.ndarray:
    """1 - |inter| / min(|A|, |B|) (reference: simNeighborOverlap,
    Similarities.cpp:216-228)."""
    from .bucketing import bucket_rows, bucket_width, pad_axis
    e = len(pairs_a)
    wpad = bucket_width(unions.width)
    rpad = bucket_rows(max(8, unions.num_rows))
    counts = jnp.asarray(pad_axis(unions.row_nnz().astype(np.int32),
                                  0, rpad, 0))
    idx = jnp.asarray(pad_axis(pad_axis(unions.indices, 1, wpad, -1),
                               0, rpad, -1))
    pairs_a = np.asarray(pairs_a, np.int32)
    pairs_b = np.asarray(pairs_b, np.int32)
    if e == 0:
        return np.empty(0, np.float32)
    chunk = _pair_chunks(e, wpad)
    out = np.empty(e, np.float32)
    for i0 in range(0, max(e, 1), chunk):
        i1 = min(i0 + chunk, e)
        w = bucket_rows(i1 - i0) if e <= chunk else chunk
        sim = _overlap_pairs(idx, counts,
                             jnp.asarray(pad_axis(pairs_a[i0:i1], 0, w, 0)),
                             jnp.asarray(pad_axis(pairs_b[i0:i1], 0, w, 0)))
        out[i0:i1] = np.asarray(1.0 - sim)[:i1 - i0]
    return out


# ---------------------------------------------------------------------------
# EUCLID_CENTROID: symmetric Hausdorff of represented point sets
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("chunk",))
def _hausdorff_device(data, rep_a, rep_b, chunk: int = 32):
    """Symmetric Hausdorff distance per pair.

    rep_a/rep_b: [E, S] padded (-1) represented data point ids.  Processes
    edges in chunks; each chunk computes an [chunk, S, S] pairwise L2 block
    (one batched matmul) and reduces.
    """
    e, s = rep_a.shape

    def chunk_fn(c0):
        a = jax.lax.dynamic_slice_in_dim(rep_a, c0 * chunk, chunk)
        b = jax.lax.dynamic_slice_in_dim(rep_b, c0 * chunk, chunk)
        mask_a = a >= 0
        mask_b = b >= 0
        xa = data[jnp.maximum(a, 0)]     # [chunk, S, D]
        xb = data[jnp.maximum(b, 0)]
        na = jnp.sum(xa * xa, -1)
        nb = jnp.sum(xb * xb, -1)
        ip = jnp.einsum("csd,ctd->cst", xa, xb,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.maximum(na[:, :, None] + nb[:, None, :] - 2.0 * ip, 0.0)
        d = jnp.sqrt(d2)
        pair_valid = mask_a[:, :, None] & mask_b[:, None, :]
        d_inf = jnp.where(pair_valid, d, jnp.inf)
        # max over valid rows of min over valid cols (and transposed)
        row_min = jnp.min(d_inf, axis=2)
        row_min = jnp.where(mask_a, row_min, -jnp.inf)
        col_min = jnp.min(d_inf, axis=1)
        col_min = jnp.where(mask_b, col_min, -jnp.inf)
        return jnp.maximum(jnp.max(row_min, axis=1),
                           jnp.max(col_min, axis=1))

    nchunks = e // chunk
    out = jax.lax.map(chunk_fn, jnp.arange(nchunks))
    return out.reshape(e)


def hausdorff_point_set_distance(data: np.ndarray,
                                 rep_a: np.ndarray,
                                 rep_b: np.ndarray,
                                 chunk: int = 32) -> np.ndarray:
    """Symmetric Hausdorff over represented data points (reference:
    euclidDistance, Similarities.cpp:414-483 + symmetricHausdorffDistance).

    rep_a/rep_b: [E, S] arrays of data point ids, -1 padded (sampling to S is
    the caller's job, mirroring numGeodesicSamples, :438-474).
    """
    e, s = rep_a.shape
    epad = ((e + chunk - 1) // chunk) * chunk
    if epad != e:
        pad = np.zeros((epad - e, s), dtype=rep_a.dtype)
        rep_a = np.concatenate([rep_a, pad - 1])
        rep_b = np.concatenate([rep_b, pad - 1])
    out = _hausdorff_device(jnp.asarray(data), jnp.asarray(rep_a),
                            jnp.asarray(rep_b), chunk)
    return np.asarray(out[:e])


def sample_represented(rep_lists: list[np.ndarray], comp_ids: np.ndarray,
                       max_samples: int, seed: int) -> np.ndarray:
    """Pad/sample represented-point lists to a fixed width (reference:
    geodesic/euclid sampling, Similarities.cpp:286-305: uniform with
    replacement when the set exceeds numGeodesicSamples)."""
    rng = np.random.default_rng(seed)
    e = len(comp_ids)
    out = np.full((e, max_samples), -1, dtype=np.int64)
    for i, cid in enumerate(comp_ids):
        reps = rep_lists[cid]
        if len(reps) <= max_samples:
            out[i, :len(reps)] = reps
        else:
            out[i] = rng.choice(reps, size=max_samples, replace=True)
    return out
