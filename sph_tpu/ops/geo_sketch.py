"""Bounded-hop geodesic sketch over the pixel kNN graph.

Device replacement for the reference's per-pair A* + DistanceCache
(ShortestPath.cpp:100-166, DistanceCache.hpp:12-60) at component counts
where per-component SSSP fields stop being feasible: every node keeps its
`width` geodesically-closest nodes within 2^hops graph hops (pruned
min-plus squaring of the kNN adjacency), and any pixel-pair geodesic is
answered by a meet-in-the-middle merge of the two rows — one lane-sort
per query batch, no data-dependent control flow.

Pruned squaring is the classic Dijkstra-prefix property in array form:
a shortest path of <= 2H hops decomposes into two <= H-hop halves whose
shared midpoint is among each endpoint's nearest H-hop set unless pruned
by `width`; wider sketches trade device memory for fidelity (validated in
scripts/validate_geo_salinas.py).

All kernels follow the repo's device idioms: multi-operand `lax.sort` along
rows + compare/select — no per-element gathers, no host round-trips
inside the build loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_I32_MAX = np.int32(2**31 - 1)


@functools.partial(jax.jit, static_argnames=("width",))
def _square_block(si, sd, bi, bd, width: int):
    """One pruned min-plus squaring step for a row block.

    si/sd: [N, W] full current sketch (ids -1-padded, dists inf-padded);
    bi/bd: [B, W] the block's own rows.  Returns [B, width] rows holding
    the `width` smallest deduped two-leg distances, id-ascending.
    """
    b, w = bi.shape
    n, w2 = si.shape
    ok = bi >= 0
    safe = jnp.clip(bi, 0, n - 1)
    gi = si[safe]                                   # [B, W, W2] row gather
    gd = sd[safe]
    cd = bd[:, :, None] + gd
    ci = jnp.where(ok[:, :, None] & (gi >= 0), gi, _I32_MAX)
    cd = jnp.where(ci < _I32_MAX, cd, jnp.inf)
    ci = ci.reshape(b, w * w2)
    cd = cd.reshape(b, w * w2)

    # dedup duplicate midpoint targets: 2-key lane sort puts each id's
    # minimum first in its run
    ci_s, cd_s = jax.lax.sort((ci, cd), num_keys=2, dimension=1,
                              is_stable=True)
    first = jnp.concatenate(
        [jnp.ones((b, 1), bool), ci_s[:, 1:] != ci_s[:, :-1]], axis=1)
    keep = first & (ci_s < _I32_MAX)
    dsel = jnp.where(keep, cd_s, jnp.inf)
    isel = jnp.where(keep, ci_s, _I32_MAX)

    # keep the `width` nearest, then restore ascending-id layout
    dsel, isel = jax.lax.sort((dsel, isel), num_keys=1, dimension=1,
                              is_stable=True)
    isel = isel[:, :width]
    dsel = dsel[:, :width]
    isel, dsel = jax.lax.sort((isel, dsel), num_keys=1, dimension=1,
                              is_stable=True)
    out_i = jnp.where(isel < _I32_MAX, isel, -1)
    out_d = jnp.where(isel < _I32_MAX, dsel, jnp.inf)
    return out_i, out_d


@jax.jit
def _query_block(si, sd, pa, pb):
    """Meet-in-the-middle geodesics for pixel pairs (pa[e], pb[e]).

    g(p, q) = min over shared sketch entries c of D_p(c) + D_q(c); the
    self entry (distance 0) makes one-sided containment exact.  Returns
    [E] f32, inf where the sketches do not intersect.
    """
    n = si.shape[0]
    ok_a = pa >= 0
    ok_b = pb >= 0
    ra_i = si[jnp.clip(pa, 0, n - 1)]
    ra_d = sd[jnp.clip(pa, 0, n - 1)]
    rb_i = si[jnp.clip(pb, 0, n - 1)]
    rb_d = sd[jnp.clip(pb, 0, n - 1)]
    ra_i = jnp.where(ok_a[:, None] & (ra_i >= 0), ra_i, _I32_MAX)
    rb_i = jnp.where(ok_b[:, None] & (rb_i >= 0), rb_i, _I32_MAX)

    ci = jnp.concatenate([ra_i, rb_i], axis=1)
    cd = jnp.concatenate([ra_d, rb_d], axis=1)
    side = jnp.concatenate(
        [jnp.zeros_like(ra_i), jnp.ones_like(rb_i)], axis=1)
    ci_s, side_s, cd_s = jax.lax.sort((ci, side, cd), num_keys=2,
                                      dimension=1, is_stable=True)
    meet = ((ci_s[:, 1:] == ci_s[:, :-1]) & (ci_s[:, 1:] < _I32_MAX)
            & (side_s[:, 1:] != side_s[:, :-1]))
    sums = jnp.where(meet, cd_s[:, 1:] + cd_s[:, :-1], jnp.inf)
    return jnp.min(sums, axis=1)


def build_geo_sketch(graph, width: int = 64, hops: int = 3,
                     row_block: int = 4096):
    """Build the [N, width] sketch from a (symmetrized) kNN graph.

    graph: KnnGraph or PaddedGraph (self-first rows).  The graph must be
    SYMMETRIZED — meet-in-the-middle sums two forward half-paths, which
    equals the true geodesic only on undirected graphs.  `hops` squarings
    cover paths of up to 2^hops base-graph hops.  Returns device arrays
    (si [N, width] i32, sd [N, width] f32).
    """
    from .graph import KnnGraph
    if isinstance(graph, KnnGraph):
        idx, dist = graph.indices, graph.distances
        mask = np.ones_like(idx, dtype=bool)
    else:
        idx, dist, mask = graph.indices, graph.distances, graph.mask

    n, k = idx.shape
    w0 = min(width, k)
    si0 = np.where(mask, idx, -1).astype(np.int32)
    sd0 = np.where(mask, dist, np.inf).astype(np.float32)
    # enforce the self entry (distance 0) — rows are self-first by
    # invariant, but make it explicit so meet-in-the-middle stays exact
    # for one-sided containment
    si0[:, 0] = np.arange(n, dtype=np.int32)
    sd0[:, 0] = 0.0
    if w0 < k:
        # keep the nearest w0 (rows are distance-ascending after self)
        si0 = si0[:, :w0]
        sd0 = sd0[:, :w0]
    order = np.argsort(np.where(si0 >= 0, si0, _I32_MAX), axis=1,
                       kind="stable")
    si = jnp.asarray(np.take_along_axis(si0, order, axis=1))
    sd = jnp.asarray(np.take_along_axis(sd0, order, axis=1))

    for _ in range(hops):
        blocks_i = []
        blocks_d = []
        for r0 in range(0, n, row_block):
            re = min(r0 + row_block, n)
            bi, bd = _square_block(si, sd, si[r0:re], sd[r0:re], width)
            blocks_i.append(bi)
            blocks_d.append(bd)
        si = jnp.concatenate(blocks_i, axis=0)
        sd = jnp.concatenate(blocks_d, axis=0)
    return si, sd


def sketch_pair_distances(si, sd, p: np.ndarray, q: np.ndarray,
                          chunk: int = 65536) -> np.ndarray:
    """Geodesic distances for explicit pixel pairs; inf = no sketch meet."""
    e = len(p)
    out = np.empty(e, dtype=np.float32)
    p = np.asarray(p, np.int32)
    q = np.asarray(q, np.int32)
    for c0 in range(0, e, chunk):
        ce = min(c0 + chunk, e)
        out[c0:ce] = np.asarray(_query_block(
            si, sd, jnp.asarray(p[c0:ce]), jnp.asarray(q[c0:ce])))
    return out


def sketch_hausdorff_pairs(si, sd, rep_a: np.ndarray, rep_b: np.ndarray,
                           chunk: int = 8192) -> np.ndarray:
    """Symmetric Hausdorff of sketch geodesics over sampled represented
    pixels (Similarities.cpp:234-310 semantics: max-of-directed with
    min over the other side's samples).

    rep_a/rep_b: [E, S] pixel ids, -1 padded.  Returns [E] f32; a pair is
    inf when any needed sample-pair geodesic has no sketch meet (caller
    decides the fallback).
    """
    e, s = rep_a.shape
    out = np.empty(e, dtype=np.float32)
    rep_a = np.asarray(rep_a, np.int32)
    rep_b = np.asarray(rep_b, np.int32)
    for c0 in range(0, e, chunk):
        ce = min(c0 + chunk, e)
        b = ce - c0
        pa = np.repeat(rep_a[c0:ce], s, axis=1).reshape(-1)   # [b*S*S]
        pb = np.tile(rep_b[c0:ce], (1, s)).reshape(-1)
        g = np.asarray(_query_block(si, sd, jnp.asarray(pa),
                                    jnp.asarray(pb))).reshape(b, s, s)
        va = rep_a[c0:ce] >= 0
        vb = rep_b[c0:ce] >= 0
        valid = va[:, :, None] & vb[:, None, :]
        gm = np.where(valid, g, np.inf)
        # directed terms over valid samples only: max_p min_q / max_q min_p
        d_ab = np.max(np.where(va, gm.min(axis=2), -np.inf), axis=1)
        d_ba = np.max(np.where(vb, gm.min(axis=1), -np.inf), axis=1)
        out[c0:ce] = np.maximum(d_ab, d_ba).astype(np.float32)
    return out
