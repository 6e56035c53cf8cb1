"""NearestNeighbors — stage 1: the data-level kNN graph.

Reference: sph/NearestNeighbors.cpp — engine dispatch (:131-141), sqrt /
epsilon / non-decreasing / self-first post-processing (:152-170), optional
symmetrization (:176-177, :411-492), connected-component labeling
(:179-180, :318-409) and component connection via a Kruskal MST over
component centroids + min-distance pair insertion (:182-183, :494-861).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np

from ..settings import KnnIndex, KnnMetric, NearestNeighborsSettings
from ..utils.logging import Log
from ..ops.graph import (KnnGraph, PaddedGraph, graph_sparsity,
                         insert_edges_bidirectional,
                         strong_connected_components, symmetrize_graph,
                         weak_connected_components)
from ..ops.knn import compute_knn


def _mst_over_centroids(centers: np.ndarray) -> np.ndarray:
    """Kruskal MST edges over component centroids (reference:
    computeSpanningTree, NearestNeighbors.cpp:684-708 via Boost kruskal).
    Returns [ncc-1, 2] component-id pairs."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree

    ncc = centers.shape[0]
    d = np.sqrt(np.maximum(
        ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1), 0))
    # scipy sparse treats explicit zeros as absent edges: coincident
    # centroids must still be connectable, so lift zero weights to a tiny
    # positive value
    d = np.where(d <= 0, 1e-12, d)
    mst = minimum_spanning_tree(sp.csr_matrix(np.triu(d, 1)))
    rows, cols = mst.nonzero()
    return np.stack([rows, cols], axis=1)


class NearestNeighbors:
    """Reference: sph/NearestNeighbors.hpp:22."""

    def __init__(self, data: np.ndarray,
                 nns: Optional[NearestNeighborsSettings] = None):
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        self._data_dev = None   # lazily-uploaded device copy, shared by
        #                         the kNN matmuls and component bridging
        self._nns = nns or NearestNeighborsSettings()
        self.knn_graph: Optional[KnnGraph] = None
        self.sym_graph: Optional[PaddedGraph] = None
        self.connected_graph: Optional[PaddedGraph] = None
        self.connected_components: Optional[np.ndarray] = None
        self.num_connected_components: int = -1
        self._has_connected = False

    # ------------------------------------------------------------------

    def compute(self, nns: Optional[NearestNeighborsSettings] = None):
        """Reference: NearestNeighbors::compute (:98-189)."""
        if nns is not None:
            self._nns = nns
        s = self._nns
        Log.info("NearestNeighbors::compute: %d neighbors, metric %s, "
                 "index %s", s.num_nearest_neighbors, s.knn_metric.value,
                 s.knn_index.value)
        from ..ops.device_merge import use_device_restruct
        keep_dev = (use_device_restruct()
                    and s.knn_index in (KnnIndex.BRUTE_FORCE, KnnIndex.FLAT))
        if keep_dev:
            import jax.numpy as jnp
            if self._data_dev is None:
                self._data_dev = jnp.asarray(self._data)
        from ..utils.timer import phase
        with phase("nn.knn"):
            idx, dist = compute_knn(self._data, s.num_nearest_neighbors,
                                    s.knn_index, s.knn_metric, s.l2_squared,
                                    keep_on_device=keep_dev,
                                    data_dev=self._data_dev)
            self.knn_graph = KnnGraph(idx, dist)
            if keep_dev and s.compute_connect_components:
                # the CC union-find runs on the host: start the D2H copy
                # now so it overlaps the symmetrize device work instead of
                # stalling the CC step on a 7+ MB transfer
                try:
                    idx.copy_to_host_async()
                except Exception:
                    pass
        Log.info("NearestNeighbors: graph sparsity %.6f%%",
                 graph_sparsity(self.knn_graph))

        if s.symmetric_neighbors:
            with phase("nn.symmetrize"):
                self.compute_symmetrized_graph()
        if s.compute_connect_components:
            with phase("nn.cc"):
                self.compute_connected_components()
        if s.neighbor_connect_components:
            with phase("nn.connect"):
                self.connect_components()

    def compute_symmetrized_graph(self) -> PaddedGraph:
        """Reference: computeSymmetrizedNnGraph (:411-492)."""
        Log.info("NearestNeighbors::computeSymmetrizedNnGraph")
        self.sym_graph = symmetrize_graph(self.knn_graph)
        return self.sym_graph

    def compute_connected_components(self):
        """Reference: computeConnectedComponents (:318-409): strong CC on the
        symmetric graph, weak CC on the raw kNN graph.

        When the symmetrized graph is device-resident, the labels are
        computed from the directed kNN graph instead: strong CC of the
        undirected symmetrized union == weak CC of the directed graph
        (same edge set viewed undirected), and the kNN arrays are already
        on the host — this avoids downloading the much wider symmetrized
        rows just for the union-find."""
        if self.sym_graph is not None and not self.sym_graph.device_only:
            ncc, labels = strong_connected_components(self.sym_graph)
        else:
            # weak CC of the directed kNN graph == strong CC of its
            # symmetrized union; the indices were prefetched to the host
            # asynchronously during the symmetrize step
            ncc, labels = weak_connected_components(self.knn_graph)
        self.num_connected_components = ncc
        self.connected_components = labels
        Log.info("NearestNeighbors: %d connected components", ncc)
        return ncc, labels

    def connect_components(self) -> PaddedGraph:
        """Reference: connectComponents (:494-861): MST over component
        centroids, then for each MST edge find the min-distance point pair
        between the two components (here: one masked blocked matmul per
        pair instead of a per-pair FAISS index) and insert it
        bidirectionally."""
        if self.connected_components is None:
            self.compute_connected_components()

        base = (self.sym_graph if self.sym_graph is not None
                else self.knn_graph.to_padded())
        if self.num_connected_components == 1:
            Log.info("NearestNeighbors::connectComponents: already one "
                     "component")
            # no edges to insert: share the (immutable-on-device or
            # freshly-built) base arrays instead of downloading a copy
            if base.device_only:
                idx_d, dist_d = base.device()
                graph = PaddedGraph(idx_d, dist_d, base._cnt_dev
                                    if base._cnt_dev is not None
                                    else base.counts)
            else:
                graph = PaddedGraph(base.indices.copy(),
                                    base.distances.copy(),
                                    base.counts.copy())
            self.connected_graph = graph
            self._has_connected = True
            return graph

        labels = self.connected_components
        ncc = self.num_connected_components
        data = self._data
        if self._nns.knn_metric == KnnMetric.COSINE:
            norms = np.linalg.norm(data, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            data = data / norms

        centers = np.zeros((ncc, data.shape[1]), dtype=np.float64)
        np.add.at(centers, labels, data)
        counts = np.bincount(labels, minlength=ncc)
        centers /= np.maximum(counts, 1)[:, None]

        mst = _mst_over_centroids(centers.astype(np.float32))
        Log.info("NearestNeighbors::connectComponents: inserting %d MST "
                 "edges between components", len(mst))

        members = [np.nonzero(labels == c)[0] for c in range(ncc)]
        # graph distances are sqrt-scaled except for L2 + l2_squared
        # (cosine always stores chord distance, knn.py)
        squared = (self._nns.l2_squared
                   and self._nns.knn_metric == KnnMetric.L2)
        if base.device_only:
            # device path: min-distance pairs by matmul, then update only
            # the <= 2*(ncc-1) affected rows — downloading the full padded
            # graph (~100+ MB at Pines scale) to insert a handful of edges
            # was the single largest stage-1 cost
            pairs, dists = _closest_pairs_device(
                data, members, mst, squared,
                data_dev=self._data_dev if data is self._data else None)
            graph = _insert_edges_device(base, np.asarray(pairs),
                                         np.asarray(dists, np.float32))
        else:
            pairs, dists = [], []
            for ca, cb in mst:
                ia, ib, d = _closest_pair(data, members[ca], members[cb],
                                          squared)
                pairs.append((ia, ib))
                dists.append(d)
            graph = PaddedGraph(base.indices.copy(),
                                base.distances.copy(), base.counts.copy())
            if pairs:
                graph = insert_edges_bidirectional(
                    graph, np.asarray(pairs),
                    np.asarray(dists, dtype=np.float32))

        self.connected_graph = graph
        self._has_connected = True
        Log.info("NearestNeighbors::connectComponents: new edge count %d",
                 graph.num_edges())
        return graph

    @property
    def has_components_connected(self) -> bool:
        return self._has_connected


def _closest_tile_device(data_d, ids_a, ids_b):
    """jitted min-distance pair between two padded member-id lists (module
    level: defining the jit inside the caller would retrace every call)."""
    import jax
    import jax.numpy as jnp

    xa = data_d[jnp.maximum(ids_a, 0)]
    xb = data_d[jnp.maximum(ids_b, 0)]
    na = jnp.sum(xa * xa, 1)
    nb = jnp.sum(xb * xb, 1)
    d2 = (na[:, None] + nb[None, :]
          - 2.0 * jnp.dot(xa, xb.T,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST))
    d2 = jnp.where((ids_a >= 0)[:, None] & (ids_b >= 0)[None, :],
                   d2, jnp.inf)
    flat = jnp.argmin(d2.reshape(-1))
    r = flat // d2.shape[1]
    c = flat % d2.shape[1]
    # the inserted distance is recomputed from the difference: the
    # expansion's rounding grows with the norms (ops/knn.refine_candidates)
    diff = xa[r] - xb[c]
    return ids_a[r], ids_b[c], jnp.sum(diff * diff)


@functools.partial(jax.jit, static_argnames=())
def _closest_pairs_kernel(data_d, ids_a, ids_b):
    """All MST pairs in one dispatch: lax.map over the pair axis (a
    per-pair dispatch pays 2+ host<->device round trips PER PAIR)."""

    def one(pair):
        pa, pb = pair
        return _closest_tile_device(data_d, pa, pb)

    return jax.lax.map(one, (ids_a, ids_b))


def _closest_pairs_device(data: np.ndarray, members: list,
                          mst: np.ndarray, l2_squared: bool,
                          data_dev=None):
    """Min-distance point pair per MST edge, by matmul (device analogue of
    _closest_pair; reference: insertConnectionsBetweenComponents,
    NearestNeighbors.cpp:592-656).  Every pair is evaluated in a single
    batched device call; only oversized tiles fall back to the blocked
    host path."""
    import jax.numpy as jnp

    data_d = (data_dev if data_dev is not None
              else jnp.asarray(np.ascontiguousarray(data, np.float32)))

    def pow2(x: int) -> int:
        return max(1 << (x - 1).bit_length() if x else 1, 8)

    # larger component on the A side so the padded [P, A] x [P, B] batch
    # isn't blown up by a giant component appearing on the narrow side
    ordered = []
    device_rows = []
    host_rows = []
    for ca, cb in mst:
        a, b = (ca, cb) if len(members[ca]) >= len(members[cb]) else (cb, ca)
        if pow2(len(members[a])) * pow2(len(members[b])) > (1 << 26):
            host_rows.append((a, b))
        else:
            device_rows.append((a, b))
        ordered.append((a, b))

    out = {}
    # group by the A side's pow2 size: the per-pair 2^26 guard bounds
    # pow2(a)*pow2(b) per pair, and within an equal-pow2(a) group
    # amax*bmax inherits that bound — batching heterogeneous pairs into
    # one (global amax, global bmax) pad could otherwise materialize a
    # multi-GB [amax, bmax] tile no individual pair asked for
    groups: dict = {}
    for a, b in device_rows:
        groups.setdefault(pow2(len(members[a])), []).append((a, b))
    for amax, rows in groups.items():
        bmax = pow2(max(len(members[b]) for _, b in rows))
        p = len(rows)
        ids_a = np.full((p, amax), -1, np.int32)
        ids_b = np.full((p, bmax), -1, np.int32)
        for i, (a, b) in enumerate(rows):
            ids_a[i, :len(members[a])] = members[a]
            ids_b[i, :len(members[b])] = members[b]
        ia, ib, d2 = _closest_pairs_kernel(data_d, jnp.asarray(ids_a),
                                           jnp.asarray(ids_b))
        ia = np.asarray(ia)
        ib = np.asarray(ib)
        d2 = np.asarray(d2, np.float64)
        d = d2 if l2_squared else np.sqrt(np.maximum(d2, 0.0))
        for i, (a, b) in enumerate(rows):
            out[(a, b)] = (int(ia[i]), int(ib[i]), float(d[i]))
    for a, b in host_rows:
        ia, ib, dd = _closest_pair(data, members[a], members[b], l2_squared)
        out[(a, b)] = (ia, ib, dd)

    pairs = [(out[key][0], out[key][1]) for key in ordered]
    dists = [out[key][2] for key in ordered]
    return pairs, dists


def _insert_edges_device(base, pairs: np.ndarray, dists: np.ndarray):
    """Bidirectional edge insertion into a device-resident PaddedGraph by
    rewriting only the affected rows (reference semantics:
    NearestNeighbors.cpp insertDistance:547-571 — skip existing edges,
    never insert before slot 0)."""
    import jax.numpy as jnp

    from ..ops.graph import PAD_DIST, PAD_INDEX

    idx_d, dist_d = base.device()
    counts = np.asarray(base.counts).copy()
    n, kmax = base.shape

    affected = sorted({int(a) for a, b in pairs}
                      | {int(b) for a, b in pairs})
    aff = np.asarray(affected, np.int64)
    pos_of = {r: i for i, r in enumerate(affected)}
    # np.array (not asarray): the CPU backend returns read-only zero-copy
    # views and these rows are edited in place below
    rows_idx = np.array(idx_d[jnp.asarray(aff)])         # [A, Kmax]
    rows_dist = np.array(dist_d[jnp.asarray(aff)])

    extra = np.zeros(len(affected), np.int64)
    add = []
    for (a, b), d in zip(pairs, dists):
        a, b, d = int(a), int(b), float(d)
        if a == b:
            continue
        for (src, dst) in ((a, b), (b, a)):
            i = pos_of[src]
            c = counts[src]
            if dst not in rows_idx[i, :c]:
                add.append((i, dst, d))
                extra[i] += 1
    if not add:
        return PaddedGraph(idx_d, dist_d, base.counts)

    new_kmax = max(int((counts[aff] + extra).max()), kmax)
    if new_kmax > kmax:
        idx_d = jnp.pad(idx_d, ((0, 0), (0, new_kmax - kmax)),
                        constant_values=PAD_INDEX)
        dist_d = jnp.pad(dist_d, ((0, 0), (0, new_kmax - kmax)),
                         constant_values=PAD_DIST)
        pad_i = np.full((len(affected), new_kmax - kmax), PAD_INDEX,
                        rows_idx.dtype)
        pad_d = np.full((len(affected), new_kmax - kmax), PAD_DIST,
                        rows_dist.dtype)
        rows_idx = np.concatenate([rows_idx, pad_i], axis=1)
        rows_dist = np.concatenate([rows_dist, pad_d], axis=1)

    for i, dst, d in add:
        src = affected[i]
        c = counts[src]
        pos = int(np.searchsorted(rows_dist[i, :c], d, side="right"))
        pos = max(pos, 1)
        rows_idx[i, pos + 1:c + 1] = rows_idx[i, pos:c]
        rows_dist[i, pos + 1:c + 1] = rows_dist[i, pos:c]
        rows_idx[i, pos] = dst
        rows_dist[i, pos] = d
        counts[src] = c + 1

    aff_j = jnp.asarray(aff)
    idx_d = idx_d.at[aff_j].set(jnp.asarray(rows_idx))
    dist_d = dist_d.at[aff_j].set(jnp.asarray(rows_dist))
    return PaddedGraph(idx_d, dist_d, counts.astype(np.int32))


def _closest_pair(data: np.ndarray, ids_a: np.ndarray, ids_b: np.ndarray,
                  l2_squared: bool = False) -> tuple[int, int, float]:
    """Min-distance point pair between two components (reference:
    insertConnectionsBetweenComponents, NearestNeighbors.cpp:592-656 — the
    1-NN FAISS search becomes a blocked distance matrix + argmin).  The
    returned distance matches the graph's metric scale (squared L2 when
    l2_squared)."""
    a = data[ids_a]
    b = data[ids_b]
    best = (0, 0, np.inf)
    block = 4096
    bsq = np.sum(b * b, 1)
    for i0 in range(0, len(ids_a), block):
        ab = a[i0:i0 + block]
        absq = np.sum(ab * ab, 1)
        # block both sides: huge x huge component pairs must not
        # materialize an |A| x |B| tile wider than block
        for j0 in range(0, len(ids_b), block):
            bb = b[j0:j0 + block]
            d2 = (absq[:, None] + bsq[j0:j0 + block][None, :]
                  - 2.0 * ab @ bb.T)
            flat = np.argmin(d2)
            r, c = divmod(int(flat), d2.shape[1])
            val = float(d2[r, c])
            if val < best[2]:
                best = (int(ids_a[i0 + r]), int(ids_b[j0 + c]), val)
    # distance of the chosen pair from its difference, as on the device
    diff = data[best[0]].astype(np.float32) - data[best[1]]
    d2 = float(np.sum(diff * diff))
    return best[0], best[1], float(d2 if l2_squared else np.sqrt(d2))
