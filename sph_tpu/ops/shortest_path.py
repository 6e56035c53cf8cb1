"""Batched geodesic distances over the kNN graph.

Reference: sph/utils/ShortestPath.cpp computeShortestPath (:100-166) — per
point pair: cache lookup, cross-component early-out, direct-neighbor
early-out, then Boost A* -> Dijkstra -> own A* fallbacks; and
sph/utils/Similarities.cpp geodesicDistance (:234-310) — symmetric Hausdorff
over (sampled) represented-point pairwise geodesics.

Redesign: per-pair A* is pointer-chasing and inherently serial, so
it is replaced by *multi-source Bellman-Ford sweeps*: one [F, N] distance
field per component (sources = its sampled represented pixels), iterated as
masked gather-mins under `lax.while_loop` until no distance changes.  The
Hausdorff identity  max_{p in A} min_{q in B} d(p, q) = max_{p in A} D_B(p)
(where D_B is the SSSP field seeded from B's samples) turns the reference's
O(|A||B|) per-pair path searches into two field lookups per edge.  The
direct-neighbor early-out (:127-134) is preserved at the pixel level.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


_FLOAT_MAX = np.float32(np.finfo(np.float32).max)


def build_reverse_adjacency(indices: np.ndarray, distances: np.ndarray,
                            mask: Optional[np.ndarray] = None):
    """Incoming-edge table for directed relaxation.

    Returns (in_idx [N, Dmax], in_w [N, Dmax]) with -1 / +inf padding:
    in_idx[v] lists all u with an edge u -> v of weight in_w.
    """
    n, k = indices.shape
    if mask is None:
        mask = np.ones_like(indices, dtype=bool)
    src = np.broadcast_to(np.arange(n)[:, None], (n, k))[mask]
    dst = indices[mask]
    w = distances[mask]
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    deg = np.bincount(dst, minlength=n)
    dmax = max(int(deg.max()) if deg.size else 1, 1)
    in_idx = np.full((n, dmax), -1, dtype=np.int32)
    in_w = np.full((n, dmax), np.inf, dtype=np.float32)
    order = np.argsort(dst, kind="stable")
    dst_s, src_s, w_s = dst[order], src[order], w[order]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(dst_s.size) - starts[dst_s]
    in_idx[dst_s, slot] = src_s
    in_w[dst_s, slot] = w_s
    return in_idx, in_w


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _bellman_ford(in_idx: jax.Array, in_w: jax.Array, init: jax.Array,
                  max_iter: int) -> jax.Array:
    """Relax F simultaneous fields until convergence.

    init: [F, N] initial distances (0 at sources, +inf elsewhere).
    Each iteration: d[v] = min(d[v], min_k d[in_idx[v,k]] + in_w[v,k]).
    The inner reduction loops over the (small) in-degree dimension to avoid
    materializing [F, N, Dmax].
    """
    n, dmax = in_idx.shape
    safe_idx = jnp.where(in_idx < 0, 0, in_idx)

    def relax(d):
        # fori over the in-degree dimension keeps the compiled graph O(1)
        # in dmax (hub nodes can have thousands of in-edges after
        # symmetrization; unrolling would explode compile time)
        def step(j, best):
            idx_j = jax.lax.dynamic_slice_in_dim(safe_idx, j, 1,
                                                 axis=1)[:, 0]
            w_j = jax.lax.dynamic_slice_in_dim(in_w, j, 1, axis=1)[:, 0]
            cand = d[:, idx_j] + w_j[None, :]
            return jnp.minimum(best, cand)

        return jax.lax.fori_loop(0, dmax, step, d)

    def cond(state):
        it, d, changed = state
        return jnp.logical_and(it < max_iter, changed)

    def body(state):
        it, d, _ = state
        nd = relax(d)
        return it + 1, nd, jnp.any(nd < d)

    _, out, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), init,
                                                jnp.bool_(True)))
    return out


def _source_init(field_samples: jax.Array, n: int) -> jax.Array:
    """[F, S] padded (-1) source-id lists -> [F, N] initial distances
    (0 at sources, +inf elsewhere), built on device."""
    f, s = field_samples.shape
    init = jnp.full((f, n), jnp.inf, dtype=jnp.float32)
    rows = jnp.repeat(jnp.arange(f), s)
    cols = field_samples.reshape(-1)
    vals = jnp.where(cols < 0, jnp.inf, 0.0).astype(jnp.float32)
    return init.at[rows, jnp.where(cols < 0, 0, cols)].min(vals)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _fields_component_max(in_idx: jax.Array, in_w: jax.Array,
                          field_samples: jax.Array, eval_samples: jax.Array,
                          eval_mask: jax.Array, max_iter: int) -> jax.Array:
    """Converged SSSP fields reduced to per-component sample maxima.

    The [F, N] fields never leave the device: the one-sided Hausdorff term
    max_{p in comp} D_field(p) is reduced on device and only the [F, C]
    result crosses to the host (the fields themselves are N-sized and
    host<->device bandwidth dominates GEO wall-clock otherwise).
    """
    n = in_idx.shape[0]
    f = field_samples.shape[0]
    c, s2 = eval_samples.shape
    d = _bellman_ford(in_idx, in_w, _source_init(field_samples, n), max_iter)

    def step(j, best):
        ids_j = jax.lax.dynamic_slice_in_dim(eval_samples, j, 1,
                                             axis=1)[:, 0]        # [C]
        m_j = jax.lax.dynamic_slice_in_dim(eval_mask, j, 1, axis=1)[:, 0]
        v = d[:, jnp.where(ids_j < 0, 0, ids_j)]                  # [F, C]
        v = jnp.where(m_j[None, :], v, -jnp.inf)
        return jnp.maximum(best, v)

    best0 = jnp.full((f, c), -jnp.inf, dtype=jnp.float32)
    return jax.lax.fori_loop(0, s2, step, best0)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _fields_pair_values(in_idx: jax.Array, in_w: jax.Array,
                        field_samples: jax.Array, eval_ids: jax.Array,
                        field_of_eval: jax.Array, max_iter: int) -> jax.Array:
    """Converged fields evaluated at per-pair (field, node) coordinates.

    eval_ids: [E] node ids (-1 pad); field_of_eval: [E] field row in
    [0, F) (-1 pad).  Returns [E] f32 D_{field_of_eval[j]}(eval_ids[j]).
    Only the E needed scalars cross to the host — the [F, N] fields
    never materialize off-device (the previous formulation shipped the
    full [F, E] matrix per batch and used ~one value per column: 103 MB
    D2H per batch at Pines-GEO scale).  The selection gathers the E
    needed columns of d ([F, E]) and picks one row per column — no
    [N, F] transpose materializes, which mattered at level-0 graphs
    where N is Salinas-sized.
    """
    n = in_idx.shape[0]
    d = _bellman_ford(in_idx, in_w, _source_init(field_samples, n), max_iter)
    cols = jnp.take(d, jnp.where(eval_ids < 0, 0, eval_ids), axis=1)
    fo = jnp.where(field_of_eval < 0, 0, field_of_eval)
    vals = jnp.take_along_axis(cols, fo[None, :], axis=0)[0]
    return jnp.where(field_of_eval < 0, jnp.inf, vals)


def _pair_values_batched(in_idx_d, in_w_d, srcs: np.ndarray,
                         field_pos: np.ndarray, eval_nodes: np.ndarray,
                         field_batch: int) -> np.ndarray:
    """Singleton-source SSSP values at per-pair eval nodes.

    srcs: [S] unique source node ids (one field each); field_pos: [E]
    index into srcs per pair; eval_nodes: [E] node to evaluate that
    pair's field at.  Returns [E] f32 (inf where unreachable).  Batches
    over fields; each batch only evaluates its own pairs, padded to a
    power-of-two bucket so batches share compiled shapes.
    """
    n = in_idx_d.shape[0]
    e = len(field_pos)
    out = np.full(e, np.inf, dtype=np.float32)
    for f0 in range(0, len(srcs), field_batch):
        fe = min(f0 + field_batch, len(srcs))
        fs = _pad_rows(srcs[f0:fe, None].astype(np.int32), field_batch, -1)
        sel = np.nonzero((field_pos >= f0) & (field_pos < fe))[0]
        if sel.size == 0:
            continue
        width = max(128, 1 << int(sel.size - 1).bit_length())
        ev = np.full(width, -1, dtype=np.int32)
        ev[:sel.size] = eval_nodes[sel]
        fo = np.full(width, -1, dtype=np.int32)
        fo[:sel.size] = field_pos[sel] - f0
        vals = np.asarray(_fields_pair_values(
            in_idx_d, in_w_d, jnp.asarray(fs), jnp.asarray(ev),
            jnp.asarray(fo), n))
        out[sel] = vals[:sel.size]
    return out


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _fields_full(in_idx: jax.Array, in_w: jax.Array,
                 field_samples: jax.Array, max_iter: int) -> jax.Array:
    """Converged fields, full [F, N] (for dense all-pairs outputs over
    small graphs; device-side source init, adjacency uploaded by caller)."""
    return _bellman_ford(in_idx, in_w,
                         _source_init(field_samples, in_idx.shape[0]),
                         max_iter)


@functools.partial(jax.jit, static_argnames=("max_iter", "kk"))
def _fields_topk(in_idx: jax.Array, in_w: jax.Array,
                 field_samples: jax.Array, max_iter: int, kk: int):
    """Converged fields reduced to per-field bottom-k (nearest components):
    returns (ids [F, kk] int32, dists [F, kk] f32), unreachable = FLOAT_MAX.
    Ties break toward the lower index, matching a stable ascending sort."""
    n = in_idx.shape[0]
    d = _bellman_ford(in_idx, in_w, _source_init(field_samples, n), max_iter)
    d = jnp.where(jnp.isfinite(d), d, _FLOAT_MAX)
    neg, ids = jax.lax.top_k(-d, kk)
    return ids.astype(jnp.int32), -neg


def _pad_rows(a: np.ndarray, rows: int, fill) -> np.ndarray:
    """Pad axis 0 to `rows` with `fill` (keeps one compiled shape across
    the trailing partial batch)."""
    if a.shape[0] == rows:
        return a
    pad = np.full((rows - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def sssp_fields(in_idx: np.ndarray, in_w: np.ndarray,
                source_sets: np.ndarray, max_iter: int = 0) -> np.ndarray:
    """Multi-source SSSP distance fields.

    source_sets: [F, S] padded (-1) node-id lists.  Returns [F, N] float32
    with unreachable nodes at +inf.
    """
    n = in_idx.shape[0]
    if max_iter <= 0:
        max_iter = n  # worst case; convergence check exits far earlier
    out = _bellman_ford(jnp.asarray(in_idx), jnp.asarray(in_w),
                        _source_init(jnp.asarray(source_sets), n), max_iter)
    return np.asarray(out)


def compute_shortest_path(graph, start: int, end: int,
                          cache=None) -> float:
    """Single point-pair geodesic (reference: computeShortestPath,
    ShortestPath.cpp:100-166 — with the direct-neighbor early-out; the A* /
    Dijkstra fallback chain becomes one converged Bellman-Ford field).

    cache: optional utils.distance_cache.DistanceCache bound to ``graph``
    (the reference's opt-in DistanceCache, ShortestPath.cpp:41-42) — reuses
    converged fields across repeated queries.

    Returns -1.0 when end is unreachable (the reference's cross-component
    sentinel)."""
    from .graph import KnnGraph

    if cache is not None:
        return cache.query(start, end)

    if isinstance(graph, KnnGraph):
        idx, dist = graph.indices, graph.distances
        mask = np.ones_like(idx, dtype=bool)
    else:
        idx, dist, mask = graph.indices, graph.distances, graph.mask

    if start == end:
        return 0.0
    # direct-neighbor early-out (reference: :127-134)
    row = idx[start][mask[start]]
    hit = np.nonzero(row == end)[0]
    if hit.size:
        return float(dist[start][mask[start]][hit[0]])

    in_idx, in_w = build_reverse_adjacency(idx, dist, mask)
    field = sssp_fields(in_idx, in_w,
                        np.array([[start]], dtype=np.int64))[0]
    d = float(field[end])
    return d if np.isfinite(d) else -1.0


def shortest_path_fields(graph, sources: np.ndarray) -> np.ndarray:
    """Distance fields from single-node sources [S] -> [S, N] (the batched
    public API; unreachable = +inf)."""
    from .graph import KnnGraph
    if isinstance(graph, KnnGraph):
        idx, dist = graph.indices, graph.distances
        mask = np.ones_like(idx, dtype=bool)
    else:
        idx, dist, mask = graph.indices, graph.distances, graph.mask
    in_idx, in_w = build_reverse_adjacency(idx, dist, mask)
    return sssp_fields(in_idx, in_w,
                       np.asarray(sources, np.int64)[:, None])


def contracted_geodesics(hierarchy, data: np.ndarray, level: int,
                         num_samples: int = 0, seed: int = 1,
                         batch: int = 256) -> np.ndarray:
    """All-pairs geodesic distances over the *contracted* component graph.

    Multilevel approximation for large component counts, where
    pixel-level SSSP fields (C fields x N pixels) are infeasible for any
    implementation (the reference's per-pair A* + cache has the same
    asymptotic wall): nodes are the level's components, edges its spatial
    adjacency, edge weights the sampled euclidean Hausdorff between the
    adjacent components (locally, euclid ~= geodesic — the standard manifold
    assumption), and geodesics are Bellman-Ford fields over this C-node
    graph.  Paths between distant components necessarily traverse component
    adjacencies, so the contraction preserves the geodesic structure the
    GEO similarities measure.

    Returns the dense [C, C] distance matrix (inf where unreachable).
    """
    from .similarities import (hausdorff_point_set_distance,
                               sample_represented)

    adj = hierarchy.spatial_neighbors_of(level)
    c, deg = adj.shape
    src = np.repeat(np.arange(c, dtype=np.int64), deg)
    dst = adj.ravel()
    ok = dst >= 0
    src, dst = src[ok], dst[ok]

    reps = hierarchy.represented_points(level)
    sizes = np.array([len(r) for r in reps])
    max_s = int(sizes.max())
    if num_samples and num_samples > 0:
        max_s = min(max_s, num_samples)
    rep_a = sample_represented(reps, src, max_s, seed=seed + level)
    rep_b = sample_represented(reps, dst, max_s, seed=seed + level + 1)
    w = hausdorff_point_set_distance(data, rep_a, rep_b)

    # per-node padded in-edge table over the component graph
    in_idx, in_w = _edge_list_reverse(c, src, dst, w)

    in_idx_d, in_w_d = jnp.asarray(in_idx), jnp.asarray(in_w)
    out = np.empty((c, c), dtype=np.float32)
    for f0 in range(0, c, batch):
        fe = min(f0 + batch, c)
        fs = _pad_rows(np.arange(f0, fe, dtype=np.int32)[:, None], batch, -1)
        out[f0:fe] = np.asarray(_fields_full(
            in_idx_d, in_w_d, jnp.asarray(fs), c))[:fe - f0]
    return out


def contracted_geodesic_knn(hierarchy, data: np.ndarray, level: int,
                            k: int, num_samples: int = 0, seed: int = 1,
                            batch: int = 256):
    """Streaming kNN over contracted geodesics: fields are computed per
    source batch and reduced to top-k immediately, so the [C, C] matrix
    never materializes (usable at tens of thousands of components)."""
    from .graph import ensure_self_first
    from .similarities import (hausdorff_point_set_distance,
                               sample_represented)

    adj = hierarchy.spatial_neighbors_of(level)
    c, deg = adj.shape
    src = np.repeat(np.arange(c, dtype=np.int64), deg)
    dst = adj.ravel()
    ok = dst >= 0
    src, dst = src[ok], dst[ok]

    reps = hierarchy.represented_points(level)
    sizes = np.array([len(r) for r in reps])
    max_s = int(sizes.max())
    if num_samples and num_samples > 0:
        max_s = min(max_s, num_samples)
    rep_a = sample_represented(reps, src, max_s, seed=seed + level)
    rep_b = sample_represented(reps, dst, max_s, seed=seed + level + 1)
    w = hausdorff_point_set_distance(data, rep_a, rep_b)
    in_idx, in_w = _edge_list_reverse(c, src, dst, w)

    kk = min(k, c)
    in_idx_d, in_w_d = jnp.asarray(in_idx), jnp.asarray(in_w)
    ids = np.empty((c, kk), dtype=np.int32)
    dists = np.empty((c, kk), dtype=np.float32)
    for f0 in range(0, c, batch):
        fe = min(f0 + batch, c)
        fs = _pad_rows(np.arange(f0, fe, dtype=np.int32)[:, None], batch, -1)
        bi, bd = _fields_topk(in_idx_d, in_w_d, jnp.asarray(fs), c, kk)
        ids[f0:fe] = np.asarray(bi)[:fe - f0]
        dists[f0:fe] = np.asarray(bd)[:fe - f0]
    return ensure_self_first(ids, dists)[:2]


def contracted_geodesic_pairs(hierarchy, data: np.ndarray, level: int,
                              a: np.ndarray, b: np.ndarray,
                              num_samples: int = 0, seed: int = 1,
                              batch: int = 256) -> np.ndarray:
    """Contracted geodesic distances for explicit (a, b) component pairs
    (the merge step's spatial-neighbor edges at large C)."""
    from .similarities import (hausdorff_point_set_distance,
                               sample_represented)

    adj = hierarchy.spatial_neighbors_of(level)
    c, deg = adj.shape
    src = np.repeat(np.arange(c, dtype=np.int64), deg)
    dst = adj.ravel()
    ok = dst >= 0
    src, dst = src[ok], dst[ok]

    reps = hierarchy.represented_points(level)
    sizes = np.array([len(r) for r in reps])
    max_s = int(sizes.max())
    if num_samples and num_samples > 0:
        max_s = min(max_s, num_samples)
    rep_a = sample_represented(reps, src, max_s, seed=seed + level)
    rep_b = sample_represented(reps, dst, max_s, seed=seed + level + 1)
    w = hausdorff_point_set_distance(data, rep_a, rep_b)
    in_idx, in_w = _edge_list_reverse(c, src, dst, w)

    srcs = np.unique(a)
    pos = np.full(int(srcs.max()) + 1, -1, dtype=np.int64)
    pos[srcs] = np.arange(len(srcs))
    in_idx_d, in_w_d = jnp.asarray(in_idx), jnp.asarray(in_w)
    vals = _pair_values_batched(in_idx_d, in_w_d, srcs, pos[a],
                                np.asarray(b, np.int32), batch)
    return np.where(np.isfinite(vals), vals, _FLOAT_MAX).astype(np.float32)


_SKETCH_CACHE: dict = {}


def get_geo_sketch(graph):
    """Bounded-hop geodesic sketch of the pixel graph, cached per graph
    object (the sketch depends only on the graph, not the level)."""
    import os
    from .geo_sketch import build_geo_sketch
    width = int(os.environ.get("SPH_GEO_SKETCH_WIDTH", "64"))
    hops = int(os.environ.get("SPH_GEO_SKETCH_HOPS", "3"))
    key = id(graph)
    hit = _SKETCH_CACHE.get(key)
    # the entry pins the graph object: without it, a GC'd graph's address
    # can be recycled by a NEW graph and id() would serve a stale sketch
    if hit is None or hit[2] != (width, hops) or hit[3] is not graph:
        # meet-in-the-middle sums two forward half-paths, which equals the
        # true geodesic only on undirected graphs (build_geo_sketch's
        # documented contract) — under settings without symmetric
        # neighbors the data graph arrives directed, so symmetrize here
        # (idempotent on an already-symmetric graph; one-time, cached)
        from .graph import symmetrize_graph
        base = symmetrize_graph(graph)
        si, sd = build_geo_sketch(base, width=width, hops=hops)
        _SKETCH_CACHE.clear()     # keep at most one (device-resident MBs)
        hit = (si, sd, (width, hops), graph)
        _SKETCH_CACHE[key] = hit
    return hit[0], hit[1]


def sketch_geodesic_pairs(graph, hierarchy, data: np.ndarray, level: int,
                          a: np.ndarray, b: np.ndarray,
                          num_samples: int = 0,
                          component_labels=None,
                          seed: int = 1) -> np.ndarray:
    """Geodesic-Hausdorff distances for component pairs via the pixel-graph
    sketch — the high-fidelity large-C tier (replaces the component-graph
    contraction, whose euclid-edge additivity scrambled ranks: Spearman
    0.42 on the round-2 validation).  Sampling mirrors the exact path
    (one sample set per component, Similarities.cpp:286-305); pairs whose
    sketches never meet fall back to sampled euclidean Hausdorff."""
    from .geo_sketch import sketch_hausdorff_pairs
    from .similarities import hausdorff_point_set_distance, sample_represented
    from ..utils.logging import Log

    si, sd = get_geo_sketch(graph)

    reps = hierarchy.represented_points(level)
    sizes = np.array([len(r) for r in reps])
    max_s = int(sizes.max())
    if num_samples and num_samples > 0:
        max_s = min(max_s, num_samples)
    comp_ids = np.unique(np.concatenate([a, b]))
    samples = sample_represented(reps, comp_ids, max_s, seed=seed + level)
    pos_of = np.full(int(comp_ids.max()) + 1, -1, dtype=np.int64)
    pos_of[comp_ids] = np.arange(len(comp_ids))
    rep_a = samples[pos_of[a]]
    rep_b = samples[pos_of[b]]

    out = sketch_hausdorff_pairs(si, sd, rep_a, rep_b)

    cross = None
    if component_labels is not None:
        first_rep = np.array([r[0] for r in reps], dtype=np.int64)
        comp_label = np.asarray(component_labels)[first_rep]
        cross = comp_label[a] != comp_label[b]

    miss = ~np.isfinite(out)
    if cross is not None:
        miss &= ~cross
    n_miss = int(miss.sum())
    if n_miss:
        Log.info("sketch_geodesic_pairs: %d/%d pairs without sketch meet "
                 "-> euclid-Hausdorff fallback", n_miss, len(out))
        out[miss] = hausdorff_point_set_distance(data, rep_a[miss],
                                                 rep_b[miss])
    if cross is not None:
        out[cross] = _FLOAT_MAX
    out[~np.isfinite(out)] = _FLOAT_MAX
    return out.astype(np.float32)


def _edge_list_reverse(n: int, src: np.ndarray, dst: np.ndarray,
                       w: np.ndarray):
    """Padded in-edge table from an explicit (src, dst, w) edge list;
    both directions are added (spatial adjacency is symmetric)."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    ww = np.concatenate([w, w]).astype(np.float32)
    deg = np.bincount(d, minlength=n)
    dmax = max(int(deg.max()) if deg.size else 1, 1)
    in_idx = np.full((n, dmax), -1, dtype=np.int32)
    in_w = np.full((n, dmax), np.inf, dtype=np.float32)
    order = np.argsort(d, kind="stable")
    d_s, s_s, w_s = d[order], s[order], ww[order]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(d_s.size) - starts[d_s]
    in_idx[d_s, slot] = s_s
    in_w[d_s, slot] = w_s
    return in_idx, in_w


# components above this count use the contracted-graph approximation
# (exact pixel-level fields scale as C x N and stop being feasible);
# overridable for experiments via SPH_CONTRACT_THRESHOLD
import os as _os

CONTRACT_THRESHOLD = int(_os.environ.get("SPH_CONTRACT_THRESHOLD", 4096))


def geodesic_hausdorff_knn(graph, hierarchy, level: int, k: int,
                           num_samples: int = 0, seed: int = 1,
                           field_batch: int = 256, data=None):
    """Exact kNN over components under the geodesic-Hausdorff metric.
    Above CONTRACT_THRESHOLD components, dispatches to the contracted-graph
    approximation (see contracted_geodesic_knn) — exact pixel-level fields
    scale as C x N and are infeasible there for any implementation.
    (reference: GeodesicPathSpace.hpp DISTFUNC + exact search loop,
    LevelSimilarities.cpp:211-252).

    Computes one SSSP field per component (sources = its sampled represented
    pixels) in batches and assembles Hausdorff rows
    H[a, b] = max(max_{p in a} D_b(p), max_{q in b} D_a(q)) via gathers,
    streaming a running top-k.  Returns (indices [C, k], distances [C, k]).
    """
    from .graph import KnnGraph, ensure_self_first

    c = hierarchy.num_components[level]
    if level > 0 and c > CONTRACT_THRESHOLD and data is not None:
        return contracted_geodesic_knn(hierarchy, data, level, k,
                                       num_samples, seed)

    if isinstance(graph, KnnGraph):
        idx, dist = graph.indices, graph.distances
        mask = np.ones_like(idx, dtype=bool)
    else:
        idx, dist, mask = graph.indices, graph.distances, graph.mask
    in_idx, in_w = build_reverse_adjacency(idx, dist, mask)

    from .similarities import sample_represented
    reps = hierarchy.represented_points(level)
    sizes = np.array([len(r) for r in reps])
    max_s = int(sizes.max())
    if num_samples and num_samples > 0:
        max_s = min(max_s, num_samples)
    samples = sample_represented(reps, np.arange(c), max_s, seed=seed + level)

    # term1[a, b] = max_{p in a} D_b(p); build column-batches of fields,
    # reduced to [F, C] on device (fields stay device-resident; the
    # adjacency uploads once)
    n = in_idx.shape[0]
    in_idx_d = jnp.asarray(in_idx)
    in_w_d = jnp.asarray(in_w)
    eval_d = jnp.asarray(samples.astype(np.int32))
    mask_d = eval_d >= 0
    term = np.full((c, c), np.inf, dtype=np.float32)
    for f0 in range(0, c, field_batch):
        fe = min(f0 + field_batch, c)
        fs = _pad_rows(samples[f0:fe].astype(np.int32), field_batch, -1)
        m = np.asarray(_fields_component_max(
            in_idx_d, in_w_d, jnp.asarray(fs), eval_d, mask_d, n))
        term[:, f0:fe] = m[:fe - f0].T                       # max over p in a
    # every component owns >= 1 pixel by construction (each level label
    # array maps each pixel to exactly one component), so no sample row is
    # ever fully padded and -inf (max over an empty set) is unreachable;
    # the rewrite pins the hypothetical empty-component case to +inf ->
    # FLOAT_MAX rather than letting -inf be dominated by the transpose term
    assert (np.asarray([len(r) for r in reps]) >= 1).all(), \
        "component with no represented pixels"
    term = np.where(np.isneginf(term), np.inf, term)

    h = np.maximum(term, term.T)
    np.fill_diagonal(h, 0.0)
    h = np.where(np.isfinite(h), h, _FLOAT_MAX)

    kk = min(k, c)
    sel = np.argsort(h, axis=1, kind="stable")[:, :kk]
    dists = np.take_along_axis(h, sel, axis=1)
    ids, dists, _ = ensure_self_first(sel.astype(np.int32),
                                      dists.astype(np.float32))
    return ids, dists


def geodesic_component_distances(graph, data: np.ndarray, hierarchy,
                                 level: int, a: np.ndarray, b: np.ndarray,
                                 num_samples: int = 0,
                                 component_labels: Optional[np.ndarray] = None,
                                 seed: int = 1,
                                 field_batch: int = 256) -> np.ndarray:
    """Geodesic component distances for edge pairs (a[e], b[e]) at `level`.

    Mirrors Similarities.cpp geodesicDistance: level-0 pairs use the single
    point-to-point geodesic (with direct-neighbor early-out); higher levels
    use the symmetric Hausdorff of sampled represented-point geodesics.
    Cross-component pairs (per kNN weak-CC labels) are float max (:114-124).
    """
    from .graph import KnnGraph
    from .similarities import sample_represented

    if isinstance(graph, KnnGraph):
        idx, dist = graph.indices, graph.distances
        mask = np.ones_like(idx, dtype=bool)
    else:
        idx, dist, mask = graph.indices, graph.distances, graph.mask

    in_idx, in_w = build_reverse_adjacency(idx, dist, mask)
    e = len(a)
    out = np.full(e, _FLOAT_MAX, dtype=np.float32)

    if level == 0:
        # pixel level: components are singletons — apply the reference's
        # direct-neighbor early-out (ShortestPath.cpp:127-134) in bulk.
        # Spatially adjacent pixels are almost always kNN-connected, so
        # SSSP fields are only needed for the rare unresolved pairs.
        def direct_lookup(src, dst):
            rows_i = idx[src]
            rows_d = np.where(mask[src], dist[src], np.inf)
            hit = rows_i == dst[:, None]
            has = hit.any(axis=1) & mask[src].any(axis=1)
            val = np.where(has,
                           np.where(hit, rows_d, np.inf).min(axis=1),
                           np.inf)
            return val

        d_ab = direct_lookup(a, b)
        d_ba = direct_lookup(b, a)
        resolved = np.isfinite(d_ab) & np.isfinite(d_ba)
        out[resolved] = np.maximum(d_ab, d_ba)[resolved].astype(np.float32)

        todo = np.nonzero(~resolved)[0]
        if todo.size:
            srcs = np.unique(np.concatenate([a[todo], b[todo]]))
            src_pos = np.full(int(srcs.max()) + 1, -1, dtype=np.int64)
            src_pos[srcs] = np.arange(len(srcs))
            in_idx_d = jnp.asarray(in_idx)
            in_w_d = jnp.asarray(in_w)
            # one [E] value per direction; fields stay on device and only
            # the per-pair scalars transfer (_fields_pair_values)
            field_pos = np.concatenate([src_pos[a[todo]], src_pos[b[todo]]])
            eval_nodes = np.concatenate([b[todo], a[todo]]).astype(np.int32)
            vals = _pair_values_batched(in_idx_d, in_w_d, srcs, field_pos,
                                        eval_nodes, field_batch)
            haus0 = np.maximum(vals[:todo.size], vals[todo.size:])
            ok = np.isfinite(haus0)
            out[todo[ok]] = haus0[ok]
        if component_labels is not None:
            out[np.asarray(component_labels)[a]
                != np.asarray(component_labels)[b]] = _FLOAT_MAX
        return out

    reps = hierarchy.represented_points(level)
    sizes = np.array([len(r) for r in reps])
    max_s = int(sizes.max())
    if num_samples and num_samples > 0:
        max_s = min(max_s, num_samples)

    comp_ids = np.unique(np.concatenate([a, b]))
    samples = sample_represented(reps, comp_ids, max_s, seed=seed + level)
    num_fields = len(comp_ids)
    pos_of = np.full(int(comp_ids.max()) + 1, -1, dtype=np.int64)
    pos_of[comp_ids] = np.arange(num_fields)
    a_pos = pos_of[a]
    b_pos = pos_of[b]

    # per (field component, evaluated component): max over the evaluated
    # component's samples of the field value == the one-sided Hausdorff
    # term; batched over fields, reduced to [F, C] on device (the [F, N]
    # fields and the adjacency never round-trip through the host)
    n = in_idx.shape[0]
    in_idx_d = jnp.asarray(in_idx)
    in_w_d = jnp.asarray(in_w)
    eval_d = jnp.asarray(samples.astype(np.int32))
    mask_d = eval_d >= 0
    max_over_b_at_a = np.full(e, -np.inf, dtype=np.float32)  # max_p D_B(p)
    max_over_a_at_b = np.full(e, -np.inf, dtype=np.float32)

    for f0 in range(0, num_fields, field_batch):
        fe = min(f0 + field_batch, num_fields)
        fs = _pad_rows(samples[f0:fe].astype(np.int32), field_batch, -1)
        m = np.asarray(_fields_component_max(
            in_idx_d, in_w_d, jnp.asarray(fs), eval_d, mask_d, n))  # [F, C]

        sel = (b_pos >= f0) & (b_pos < fe)
        max_over_b_at_a[sel] = np.maximum(
            max_over_b_at_a[sel], m[b_pos[sel] - f0, a_pos[sel]])
        sel = (a_pos >= f0) & (a_pos < fe)
        max_over_a_at_b[sel] = np.maximum(
            max_over_a_at_b[sel], m[a_pos[sel] - f0, b_pos[sel]])

    haus = np.maximum(max_over_b_at_a, max_over_a_at_b)
    reachable = np.isfinite(haus)
    out[reachable] = haus[reachable]

    if component_labels is not None:
        # WCC label of each component == label of any represented pixel
        first_rep = np.array([r[0] for r in reps], dtype=np.int64)
        comp_label = np.asarray(component_labels)[first_rep]
        out[comp_label[a] != comp_label[b]] = _FLOAT_MAX
    return out
