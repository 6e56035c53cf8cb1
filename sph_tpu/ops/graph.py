"""Graph containers and restructuring ops.

Reference: sph/utils/Graph.hpp — the ragged CSR kNN graph (`Graph`) and the
fixed-k variant (`KGraph`), with the global invariant *first neighbor is the
point itself with distance 0* (Graph.hpp:16-18).

Redesign: the ragged CSR layout fights XLA's static shapes, so both
variants become padded dense arrays:

* ``KnnGraph``    — fixed-k: indices/distances of shape [N, K]
* ``PaddedGraph`` — variable-k: [N, Kmax] with pad index -1, pad distance +inf,
  and a per-row count

Bulk numeric work on these arrays runs on device; the irregular one-off
restructurings (symmetrize, connected components, edge insertion) are
vectorized host ops — the same role the reference delegates to Boost/OpenMP
C++ (GraphUtils.cpp, NearestNeighbors.cpp:411-861).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

PAD_INDEX = -1
PAD_DIST = np.inf


class KnnGraph:
    """Fixed-k kNN graph (reference KGraph, Graph.hpp:399-564).

    Dual residency like PaddedGraph: numpy or jax arrays in, lazy cached
    copies on both sides.
    """

    __slots__ = ("_idx_np", "_dist_np", "_idx_dev", "_dist_dev")

    def __init__(self, indices, distances):
        import jax
        if isinstance(indices, jax.Array):
            self._idx_dev, self._idx_np = indices, None
        else:
            self._idx_np, self._idx_dev = np.asarray(indices), None
        if isinstance(distances, jax.Array):
            self._dist_dev, self._dist_np = distances, None
        else:
            self._dist_np, self._dist_dev = np.asarray(distances), None

    @property
    def indices(self) -> np.ndarray:    # [N, K] int32
        if self._idx_np is None:
            self._idx_np = np.asarray(self._idx_dev)
        return self._idx_np

    @property
    def distances(self) -> np.ndarray:  # [N, K] f32, non-decreasing per row
        if self._dist_np is None:
            self._dist_np = np.asarray(self._dist_dev)
        return self._dist_np

    @property
    def device_only(self) -> bool:
        return self._idx_dev is not None and self._idx_np is None

    def device(self):
        import jax.numpy as jnp
        if self._idx_dev is None:
            self._idx_dev = jnp.asarray(self._idx_np)
        if self._dist_dev is None:
            self._dist_dev = jnp.asarray(self._dist_np)
        return self._idx_dev, self._dist_dev

    @property
    def shape(self) -> tuple:
        src = self._idx_np if self._idx_np is not None else self._idx_dev
        return src.shape

    @property
    def num_points(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    def is_valid(self) -> bool:
        n, k = self.indices.shape
        if self.distances.shape != (n, k):
            return False
        if not np.all(self.indices[:, 0] == np.arange(n)):
            return False
        if not np.all(self.distances[:, 0] == 0):
            return False
        return bool(np.all(np.diff(self.distances, axis=1) >= 0))

    def to_padded(self) -> "PaddedGraph":
        n, k = self.shape
        if self.device_only:
            idx_d, dist_d = self.device()
            return PaddedGraph(idx_d, dist_d, np.full(n, k, dtype=np.int32))
        return PaddedGraph(self.indices.astype(np.int32).copy(),
                           self.distances.astype(np.float32).copy(),
                           np.full(n, k, dtype=np.int32))


class PaddedGraph:
    """Variable-k graph as padded arrays (reference Graph, Graph.hpp:155-273).

    Rows are sorted by distance with the self edge first; pads live at the end
    of each row (index PAD_INDEX, distance +inf).

    Dual residency like ops.sparse.SparseRows: the constructor accepts numpy
    or jax arrays; `.indices`/`.distances`/`.counts` download lazily (cached),
    `.device()` uploads lazily (cached).  The symmetrized data-level graph is
    ~100+ MB at Pines scale — keeping it on device saves its transfers
    every pipeline run.
    """

    __slots__ = ("_idx_np", "_dist_np", "_cnt_np", "_idx_dev", "_dist_dev",
                 "_cnt_dev")

    def __init__(self, indices, distances, counts):
        import jax
        if isinstance(indices, jax.Array):
            self._idx_dev, self._idx_np = indices, None
        else:
            self._idx_np, self._idx_dev = np.asarray(indices), None
        if isinstance(distances, jax.Array):
            self._dist_dev, self._dist_np = distances, None
        else:
            self._dist_np, self._dist_dev = np.asarray(distances), None
        if isinstance(counts, jax.Array):
            self._cnt_dev, self._cnt_np = counts, None
        else:
            self._cnt_np, self._cnt_dev = np.asarray(counts), None

    @property
    def indices(self) -> np.ndarray:    # [N, Kmax] int32, PAD_INDEX padded
        if self._idx_np is None:
            self._idx_np = np.asarray(self._idx_dev)
        return self._idx_np

    @property
    def distances(self) -> np.ndarray:  # [N, Kmax] f32, PAD_DIST padded
        if self._dist_np is None:
            self._dist_np = np.asarray(self._dist_dev)
        return self._dist_np

    @property
    def counts(self) -> np.ndarray:     # [N] int32, valid entries per row
        if self._cnt_np is None:
            self._cnt_np = np.asarray(self._cnt_dev)
        return self._cnt_np

    @property
    def device_only(self) -> bool:
        return self._idx_dev is not None and self._idx_np is None

    def device(self):
        """(indices, distances) device copies; uploaded once and cached."""
        import jax.numpy as jnp
        if self._idx_dev is None:
            self._idx_dev = jnp.asarray(self._idx_np)
        if self._dist_dev is None:
            self._dist_dev = jnp.asarray(self._dist_np)
        return self._idx_dev, self._dist_dev

    @property
    def shape(self) -> tuple:
        src = self._idx_np if self._idx_np is not None else self._idx_dev
        return src.shape

    @property
    def num_points(self) -> int:
        return self.shape[0]

    @property
    def max_k(self) -> int:
        return self.shape[1]

    @property
    def mask(self) -> np.ndarray:
        return self.indices >= 0

    def num_edges(self) -> int:
        if self.device_only and self._cnt_dev is not None:
            import jax.numpy as jnp
            return int(jnp.sum(self._cnt_dev))
        return int(self.counts.sum())

    def is_valid(self) -> bool:
        n = self.num_points
        if not np.all(self.indices[:, 0] == np.arange(n)):
            return False
        if not np.all(self.distances[:, 0] == 0):
            return False
        col = np.arange(self.max_k)[None, :]
        in_range = col < self.counts[:, None]
        if not np.all((self.indices >= 0) == in_range):
            return False
        # only compare adjacent *valid* entries; +inf pads would yield
        # inf - inf = NaN in the diff
        d = self.distances
        adj_valid = in_range[:, 1:]
        return bool(np.all(np.where(adj_valid,
                                    d[:, 1:] >= d[:, :-1], True)))

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        c = self.counts[i]
        return self.indices[i, :c], self.distances[i, :c]


def ensure_self_first(indices: np.ndarray, distances: np.ndarray,
                      counts: Optional[np.ndarray] = None,
                      ) -> tuple[np.ndarray, np.ndarray, int]:
    """Enforce the self-first invariant (reference: GraphUtils.cpp
    ensureClosestPointIsSelf:23-96).

    If the self edge appears elsewhere in the row, swap it to slot 0.  If it is
    missing, shift the row right (dropping the most distant neighbor) and put
    (self, 0) first.  Returns new arrays + the number of adjusted rows.
    """
    indices = np.asarray(indices).copy()
    distances = np.asarray(distances).copy()
    n, k = indices.shape
    rows = np.arange(n)

    already = indices[:, 0] == rows
    num_adjusted = int((~already).sum())
    if num_adjusted == 0:
        return indices, distances, 0

    is_self = indices == rows[:, None]
    has_self = is_self.any(axis=1)
    self_pos = np.where(has_self, is_self.argmax(axis=1), k - 1)

    fix = ~already
    fix_swap = fix & has_self
    if fix_swap.any():
        r = rows[fix_swap]
        p = self_pos[fix_swap]
        # swap slot 0 and slot p
        i0, d0 = indices[r, 0].copy(), distances[r, 0].copy()
        indices[r, 0] = indices[r, p]
        distances[r, 0] = distances[r, p]
        indices[r, p] = i0
        distances[r, p] = d0
        # self distance is 0 by definition
        distances[r, 0] = 0.0

    fix_ins = fix & ~has_self
    if fix_ins.any():
        r = rows[fix_ins]
        # shift right, drop the most distant neighbor, insert self at slot 0
        indices[r, 1:] = indices[r, :-1]
        distances[r, 1:] = distances[r, :-1]
        indices[r, 0] = r
        distances[r, 0] = 0.0

    if counts is not None:
        pass  # counts unchanged: we only permuted/replaced entries
    return indices, distances, num_adjusted


_ESF_JIT = None


def ensure_self_first_body(indices, distances):
    """Traceable body of the device self-first fixup (lane-parallel select
    instead of the host row edits): same three cases — already-first, swap
    the self entry to slot 0, or shift right and insert (self, 0).  Pure
    jax function: vmappable over a leading scene axis (each scene's rows
    are self-indexed 0..N-1)."""
    import jax.numpy as jnp

    n, k = indices.shape
    ar = jnp.arange(n, dtype=indices.dtype)
    is_self = indices == ar[:, None]
    has_self = jnp.any(is_self, axis=1)
    already = indices[:, 0] == ar
    idx0 = indices[:, 0]
    d0 = distances[:, 0]
    swapped_idx = jnp.where(is_self, idx0[:, None], indices)
    swapped_dist = jnp.where(is_self, d0[:, None], distances)
    shifted_idx = jnp.concatenate(
        [indices[:, :1], indices[:, :-1]], axis=1)
    shifted_dist = jnp.concatenate(
        [distances[:, :1], distances[:, :-1]], axis=1)
    case_swap = (~already & has_self)[:, None]
    case_shift = (~already & ~has_self)[:, None]
    out_idx = jnp.where(case_swap, swapped_idx,
                        jnp.where(case_shift, shifted_idx, indices))
    out_dist = jnp.where(case_swap, swapped_dist,
                         jnp.where(case_shift, shifted_dist,
                                   distances))
    out_idx = out_idx.at[:, 0].set(ar)
    out_dist = out_dist.at[:, 0].set(jnp.where(already, d0, 0.0))
    return out_idx, out_dist, jnp.sum(~already)


def ensure_self_first_device(indices, distances):
    """Device self-first fixup (jitted wrapper of ensure_self_first_body)."""
    import jax

    global _ESF_JIT
    fn = _ESF_JIT
    if fn is None:
        fn = jax.jit(ensure_self_first_body)
        _ESF_JIT = fn
    oi, od, adjusted = fn(indices, distances)
    return oi, od, int(adjusted)


def sort_rows(indices: np.ndarray, distances: np.ndarray,
              self_first: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Co-sort each row by distance (stable), keeping pads (+inf) last.
    With self_first, the self edge is forced to slot 0 afterwards."""
    order = np.argsort(distances, axis=1, kind="stable")
    r = np.arange(indices.shape[0])[:, None]
    indices = indices[r, order]
    distances = distances[r, order]
    if self_first:
        indices, distances, _ = ensure_self_first(indices, distances)
    return indices, distances


def symmetrize_graph(graph: KnnGraph | PaddedGraph,
                     use_native: bool = True) -> PaddedGraph:
    """Undirected union of edges with min-distance dedup (reference:
    GraphUtils.cpp symmetrizeGraph — union of i->j and j->i, duplicate edges
    keep the smaller distance, rows sorted by distance, self first).

    Uses the native C++ path (sph_tpu/native/graphops.cpp) when available;
    the numpy implementation below is the reference fallback.
    """
    if isinstance(graph, KnnGraph):
        graph = graph.to_padded()
    if use_native:
        from .device_merge import symmetrize_graph_device, \
            use_device_restruct
        cap = int(os.environ.get("SPH_SYM_WIDTH_CAP", "1024"))
        if use_device_restruct():
            # stays device-resident: output feeds the device probdist /
            # walk chain without a host round trip
            idx_d, dist_d = graph.device()
            import jax.numpy as jnp
            idx_d = jnp.where(idx_d >= 0, idx_d, -1)
            dist_d = jnp.where(idx_d >= 0, dist_d, 0.0)
            out = symmetrize_graph_device(idx_d, dist_d, max(cap, 0))
            if out is not None:
                oi, od, oc = out
                return _cap_width(PaddedGraph(oi, od, oc))
        idx_in = np.where(graph.mask, graph.indices, -1).astype(np.int32)
        dist_in = np.where(graph.mask, graph.distances,
                           0.0).astype(np.float32)
        from .. import native
        out = native.symmetrize(idx_in, dist_in, max_width=max(cap, 0))
        if out is not None:
            oi, od, oc = out
            return _cap_width(PaddedGraph(oi, od, oc))
    n, kmax = graph.indices.shape
    mask = graph.mask
    rows = np.broadcast_to(np.arange(n)[:, None], (n, kmax))[mask]
    cols = graph.indices[mask]
    dists = graph.distances[mask]

    # drop self edges; re-added below
    keep = rows != cols
    rows, cols, dists = rows[keep], cols[keep], dists[keep]

    # canonical undirected key, dedup by min distance
    a = np.minimum(rows, cols).astype(np.int64)
    b = np.maximum(rows, cols).astype(np.int64)
    key = a * n + b
    order = np.argsort(key, kind="stable")
    key, a, b, dists = key[order], a[order], b[order], dists[order]
    first = np.ones(key.shape, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    seg_id = np.cumsum(first) - 1
    nseg = int(seg_id[-1]) + 1 if key.size else 0
    min_d = np.full(nseg, np.inf, dtype=np.float32)
    np.minimum.at(min_d, seg_id, dists)
    ua, ub = a[first], b[first]
    ud = min_d

    # expand to both directions and build ragged rows
    er = np.concatenate([ua, ub])
    ec = np.concatenate([ub, ua])
    ed = np.concatenate([ud, ud])

    deg = np.bincount(er, minlength=n)
    new_kmax = int(deg.max()) + 1 if deg.size else 1

    indices = np.full((n, new_kmax), PAD_INDEX, dtype=np.int32)
    distances = np.full((n, new_kmax), PAD_DIST, dtype=np.float32)
    # self edges at slot 0
    indices[:, 0] = np.arange(n)
    distances[:, 0] = 0.0

    # place edges: sort by (row, dist) then use within-row rank + 1
    order = np.lexsort((ed, er))
    er, ec, ed = er[order], ec[order], ed[order]
    row_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_start[1:])
    slot = np.arange(er.size) - row_start[er] + 1
    indices[er, slot] = ec
    distances[er, slot] = ed

    counts = (deg + 1).astype(np.int32)
    return _cap_width(PaddedGraph(indices, distances, counts))


def _cap_width(g: PaddedGraph) -> PaddedGraph:
    """Bound the padded row width of a symmetrized graph.

    The reference's ragged rows pay memory per node degree
    (Graph.hpp offsets); the padded layout pays MAX degree for every row,
    and hub nodes (one point in thousands of kNN lists) can blow that to
    gigabytes and put the same width into every downstream kernel (walk
    cumsums, beta search).  Rows are distance-sorted, so truncation keeps
    each hub's closest edges.  SPH_SYM_WIDTH_CAP=0 disables."""
    cap = int(os.environ.get("SPH_SYM_WIDTH_CAP", "1024"))
    if cap <= 0 or g.max_k <= cap:
        return g
    from ..utils.logging import Log
    Log.info("symmetrize_graph: capping row width %d -> %d (hub nodes keep "
             "their closest edges)", g.max_k, cap)
    if g.device_only:
        import jax.numpy as jnp
        idx_d, dist_d = g.device()
        return PaddedGraph(idx_d[:, :cap], dist_d[:, :cap],
                           jnp.minimum(g._cnt_dev, cap)
                           if g._cnt_dev is not None
                           else np.minimum(g.counts, cap).astype(np.int32))
    return PaddedGraph(np.ascontiguousarray(g.indices[:, :cap]),
                       np.ascontiguousarray(g.distances[:, :cap]),
                       np.minimum(g.counts, cap).astype(np.int32))


def weak_connected_components(graph: KnnGraph | PaddedGraph,
                              use_native: bool = True
                              ) -> tuple[int, np.ndarray]:
    """Weak CC labels of the directed kNN graph (reference: GraphUtils
    labelGraphWeakComponents via Boost connected_components).  Labels are
    normalized to first-occurrence order.  Native union-find fast path when
    the C++ library is available."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if isinstance(graph, KnnGraph):
        g = graph.to_padded()
    else:
        g = graph
    if use_native:
        from .. import native
        idx_in = np.where(g.mask, g.indices, -1).astype(np.int32)
        out = native.weak_components(idx_in)
        if out is not None:
            return out
    n, kmax = g.indices.shape
    mask = g.mask
    rows = np.broadcast_to(np.arange(n)[:, None], (n, kmax))[mask]
    cols = g.indices[mask]
    m = sp.coo_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                      shape=(n, n))
    ncc, labels = connected_components(m, directed=True, connection="weak")
    return ncc, _normalize_labels(labels)


def strong_connected_components(graph: KnnGraph | PaddedGraph
                                ) -> tuple[int, np.ndarray]:
    """Strong CC labels (reference: labelGraphStrongComponents; used on the
    symmetrized graph where strong == weak)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if isinstance(graph, KnnGraph):
        g = graph.to_padded()
    else:
        g = graph
    n, kmax = g.indices.shape
    mask = g.mask
    rows = np.broadcast_to(np.arange(n)[:, None], (n, kmax))[mask]
    cols = g.indices[mask]
    m = sp.coo_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                      shape=(n, n))
    ncc, labels = connected_components(m, directed=True, connection="strong")
    return ncc, _normalize_labels(labels)


def _normalize_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel components in order of first appearance (deterministic and
    independent of the underlying CC algorithm's internal numbering)."""
    _, first_idx, inverse = np.unique(labels, return_index=True,
                                      return_inverse=True)
    rank = np.argsort(np.argsort(first_idx))
    return rank[inverse].astype(np.int64)


def edge_list_components(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                         use_native: bool = True) -> tuple[int, np.ndarray]:
    """Weak CC of an explicit edge list (used for the per-level merge graph,
    reference: ImageHierarchy.cpp:468-471)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if use_native:
        from .. import native
        out = native.edge_list_components(num_nodes, src, dst)
        if out is not None:
            return out

    m = sp.coo_matrix((np.ones(len(src), np.int8), (src, dst)),
                      shape=(num_nodes, num_nodes))
    ncc, labels = connected_components(m, directed=True, connection="weak")
    return ncc, _normalize_labels(labels)


def insert_edges_bidirectional(graph: PaddedGraph,
                               pairs: np.ndarray,
                               dists: np.ndarray) -> PaddedGraph:
    """Insert undirected edges keeping per-row distance sort and the self-first
    invariant (reference: NearestNeighbors.cpp insertDistance:547-571 — skips
    edges already present, never inserts before slot 0).
    """
    n, kmax = graph.indices.shape
    extra = np.zeros(n, dtype=np.int64)
    add: list[tuple[int, int, float]] = []
    for (a, b), d in zip(pairs, dists):
        a, b, d = int(a), int(b), float(d)
        if a == b:
            continue
        ca = graph.counts[a]
        if b not in graph.indices[a, :ca]:
            add.append((a, b, d))
            extra[a] += 1
        cb = graph.counts[b]
        if a not in graph.indices[b, :cb]:
            add.append((b, a, d))
            extra[b] += 1
    if not add:
        return graph

    new_kmax = int((graph.counts + extra).max())
    new_kmax = max(new_kmax, kmax)
    indices = np.full((n, new_kmax), PAD_INDEX, dtype=np.int32)
    distances = np.full((n, new_kmax), PAD_DIST, dtype=np.float32)
    indices[:, :kmax] = graph.indices
    distances[:, :kmax] = graph.distances
    counts = graph.counts.copy()

    for a, b, d in add:
        c = counts[a]
        # insertion point (upper bound), but never before slot 1
        pos = int(np.searchsorted(distances[a, :c], d, side="right"))
        pos = max(pos, 1)
        indices[a, pos + 1:c + 1] = indices[a, pos:c]
        distances[a, pos + 1:c + 1] = distances[a, pos:c]
        indices[a, pos] = b
        distances[a, pos] = d
        counts[a] = c + 1

    return PaddedGraph(indices, distances, counts)


def graph_sparsity(graph: KnnGraph | PaddedGraph) -> float:
    """Percentage of absent edges (reference: NearestNeighbors.cpp:193)."""
    if isinstance(graph, KnnGraph):
        edges = graph.num_points * graph.k
        n = graph.num_points
    else:
        edges = graph.num_edges()
        n = graph.num_points
    return 100.0 - 100.0 * edges / float(n * n)
