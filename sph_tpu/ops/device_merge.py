"""On-device (XLA) sparse merges and graph symmetrization.

VERDICT r1 item 3: the per-level merge segment-sums and the kNN-graph
symmetrization were the last host-resident hot ops of the hierarchy loop
(numpy / native C++, reference hot path: SparseMatrixAlgorithms.cpp:292-441
and GraphUtils.cpp symmetrizeGraph).  Left on the host, their single-core
share would dominate the loop, so this module re-expresses both as
sort + cumulative-scan + scatter pipelines that XLA runs entirely on the
accelerator:

  merge:       flatten -> 2-key sort by (parent_row, parent_col) ->
               run-boundary flags -> scatter-add segment sums ->
               3-key sort by (row, -value, col) for width selection ->
               rank-in-row via cummax -> scatter into padded [M, W] ->
               per-row column re-sort
  symmetrize:  both edge directions -> 3-key sort (row, col, dist) ->
               first-of-run keeps the min-distance duplicate ->
               3-key sort (row, dist, col) -> rank-in-row -> scatter

No data-dependent shapes: callers pass a static width budget and get back
per-row counts; a doubling retry at the dispatch layer (sparse.py /
graph.py) grows the width bucket when a row overflows.  Truncation
semantics match the host paths exactly: sum-merge keeps the LARGEST values
per row, min-merge the SMALLEST, symmetrize the CLOSEST edges.

f32 accumulation order inside the scatter-add is XLA's, not the host
radix-sorted sequential order, so merged values agree with the host path to
~1e-6 relative (the same class of reordering as the reference's OpenMP
reductions); merged entry LAYOUTS are identical.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

_I32_MAX = np.int32(2**31 - 1)


def _run_starts(rows: jax.Array) -> jax.Array:
    """Index of the first element of each row-run (rows: sorted [E] i32).

    Returns [E] i32: for element e, the position where its row's run began.
    """
    e = rows.shape[0]
    iota = jnp.arange(e, dtype=jnp.int32)
    row_first = jnp.concatenate(
        [jnp.ones((1,), bool), rows[1:] != rows[:-1]])
    return jax.lax.cummax(jnp.where(row_first, iota, jnp.int32(-1)))


def _merge_flatten(indices, values, parents, m_pad: int,
                   weight_by_size: bool, combine: str):
    """Shared front half of the merges: flatten, 2-key sort by
    (parent_row, parent_col), dedup runs, segment-combine.  Returns
    (prow_u, pcol_u, agg_u, counts_full) — unique entries in (row, col)
    order packed at the front of a [N*R] buffer."""
    n, r = indices.shape
    nr = n * r
    sentinel = jnp.int32(m_pad)

    valid = (indices >= 0) & (values != 0.0)
    rp = jnp.where(valid, parents[:, None], sentinel)
    safe_col = jnp.clip(indices, 0, n - 1)
    cp = jnp.where(valid, parents[safe_col], sentinel)

    if weight_by_size:
        row_w = jnp.sum(valid, axis=1).astype(jnp.float32)
        v = jnp.where(valid, values * row_w[:, None], 0.0)
    else:
        row_w = None
        v = jnp.where(valid, values, 0.0)

    rp_s, cp_s, v_s = jax.lax.sort(
        (rp.reshape(nr), cp.reshape(nr), v.reshape(nr)),
        num_keys=2, is_stable=True)

    valid_s = rp_s < sentinel
    first = jnp.concatenate(
        [jnp.ones((1,), bool),
         (rp_s[1:] != rp_s[:-1]) | (cp_s[1:] != cp_s[:-1])]) & valid_s
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    seg_sc = jnp.where(valid_s, seg, nr)          # out-of-bounds -> dropped

    if combine == "sum":
        agg_u = jnp.zeros(nr, jnp.float32).at[seg_sc].add(
            v_s, mode="drop")
    else:
        agg_u = jnp.full(nr, jnp.inf, jnp.float32).at[seg_sc].min(
            v_s, mode="drop")
    prow_u = jnp.full(nr, sentinel, jnp.int32).at[seg_sc].set(
        rp_s, mode="drop")
    pcol_u = jnp.zeros(nr, jnp.int32).at[seg_sc].set(cp_s, mode="drop")

    if weight_by_size:
        merged_w = jnp.zeros(m_pad, jnp.float32).at[parents].add(
            row_w, mode="drop")
        denom = jnp.maximum(merged_w[jnp.clip(prow_u, 0, m_pad - 1)], 1.0)
        agg_u = agg_u / denom

    row_ok = prow_u < sentinel
    counts_full = jnp.zeros(m_pad, jnp.int32).at[prow_u].add(
        row_ok.astype(jnp.int32), mode="drop")
    return prow_u, pcol_u, agg_u, counts_full


@functools.partial(jax.jit,
                   static_argnames=("m_pad", "width", "weight_by_size",
                                    "combine"))
def _merge_device_fast(indices, values, parents, m_pad: int, width: int,
                       weight_by_size: bool, combine: str):
    """Merge assuming no row exceeds `width` (the caller verifies via
    counts and falls back to _merge_device on overflow — rare, only when
    a width cap truncates).  The unique entries leave the flatten sort in
    (row, col) order, so rows scatter directly into ascending-column
    layout: ONE global sort instead of three."""
    nr = indices.shape[0] * indices.shape[1]
    prow_u, pcol_u, agg_u, counts_full = _merge_flatten(
        indices, values, parents, m_pad, weight_by_size, combine)

    iota = jnp.arange(nr, dtype=jnp.int32)
    slot = iota - _run_starts(prow_u)
    row_ok = prow_u < jnp.int32(m_pad)
    slot_sc = jnp.where(row_ok, slot, jnp.int32(width))   # OOB -> dropped
    out_val = jnp.zeros((m_pad, width), jnp.float32).at[
        prow_u, slot_sc].set(agg_u, mode="drop")
    out_idx = jnp.full((m_pad, width), -1, jnp.int32).at[
        prow_u, slot_sc].set(pcol_u, mode="drop")
    return out_idx, out_val, counts_full


@functools.partial(jax.jit,
                   static_argnames=("m_pad", "width", "weight_by_size",
                                    "combine"))
def _merge_device(indices, values, parents, m_pad: int, width: int,
                  weight_by_size: bool, combine: str):
    """Truncating merge body (used when rows exceed the width cap).

    indices/values: [N, R] padded rows; parents: [N] i32 in [0, m_pad).
    Returns (out_idx [m_pad, W] i32, out_val [m_pad, W] f32,
    counts_full [m_pad] i32 — pre-truncation entry counts per merged row).
    """
    nr = indices.shape[0] * indices.shape[1]
    sentinel = jnp.int32(m_pad)
    prow_u, pcol_u, agg_u, counts_full = _merge_flatten(
        indices, values, parents, m_pad, weight_by_size, combine)

    # width selection order: sum-merge keeps LARGEST values per row,
    # min-merge keeps SMALLEST; ties resolve to the smaller column
    # (identical to the host lexsort semantics)
    sel = -agg_u if combine == "sum" else agg_u
    sel = jnp.where(prow_u < sentinel, sel, jnp.inf)
    rp2, _, cp2, v2 = jax.lax.sort((prow_u, sel, pcol_u, agg_u),
                                   num_keys=3, is_stable=True)

    iota = jnp.arange(nr, dtype=jnp.int32)
    slot = iota - _run_starts(rp2)
    row_ok = rp2 < sentinel

    slot_sc = jnp.where(row_ok, slot, jnp.int32(width))   # OOB -> dropped
    out_val = jnp.zeros((m_pad, width), jnp.float32).at[rp2, slot_sc].set(
        v2, mode="drop")
    out_idx = jnp.full((m_pad, width), -1, jnp.int32).at[rp2, slot_sc].set(
        cp2, mode="drop")

    # restore ascending-column order within each row, pads last — one
    # multi-operand lane sort (argsort + take_along_axis would lower to
    # per-element lane gathers, the slow path this avoids)
    colkey = jnp.where(out_idx < 0, _I32_MAX, out_idx)
    _, out_idx, out_val = jax.lax.sort((colkey, out_idx, out_val),
                                       num_keys=1, dimension=1,
                                       is_stable=True)
    return out_idx, out_val, counts_full


@functools.partial(jax.jit,
                   static_argnames=("width", "weight_by_size", "combine"))
def _merge_lanes(indices, values, parents, children, width: int,
                 weight_by_size: bool, combine: str):
    """Lane-local merge: gather each parent's child rows side by side and
    combine duplicate columns with per-row LANE sorts — no global [N*R]
    sort (the 2-key bitonic over 5.4M elements was 0.3+ s at Pines level-0
    scale; per-row lane sorts of the same data are an order of magnitude
    cheaper).

    indices/values: [N, R] child rows; parents: [N] i32; children:
    [M, C] i32 child-id table (-1 pad), C = max children per parent.
    Returns (out_idx [M, width], out_val [M, width], counts [M] i32
    pre-truncation run counts — caller falls back to the global sort when
    counts exceed `width`).
    """
    n, r = indices.shape
    m, c = children.shape
    sentinel = jnp.int32(m)

    ch_ok = children >= 0
    ch = jnp.maximum(children, 0)
    ci = indices[ch]                      # [M, C, R] row gather (fast)
    cv = values[ch]
    valid = ch_ok[:, :, None] & (ci >= 0) & (cv != 0.0)

    # columns map through parents (row gather from the [N] parent table)
    pc = jnp.where(valid, parents[jnp.clip(ci, 0, n - 1)], sentinel)

    if weight_by_size:
        roww = jnp.sum((indices >= 0) & (values != 0.0),
                       axis=1).astype(jnp.float32)     # [N] child nnz
        cw = jnp.where(ch_ok, roww[ch], 0.0)           # [M, C]
        cv = cv * cw[:, :, None]
        denom = jnp.maximum(jnp.sum(cw, axis=1), 1.0)  # [M]

    v = jnp.where(valid, cv, 0.0)
    key = pc.reshape(m, c * r)
    v = v.reshape(m, c * r)

    if combine == "sum":
        key_s, v_s = jax.lax.sort((key, v), num_keys=1, dimension=1,
                                  is_stable=True)
        # segmented run sums via a Hillis-Steele shifted-add scan: runs
        # are contiguous after the sort, so "same key 2^s lanes back" is
        # exactly the segment condition.  (A cumsum-difference trick
        # would accumulate the WHOLE row into each prefix and lose
        # precision on small runs late in long rows.)  Total lands on the
        # run's LAST element.
        w = key_s.shape[1]
        seg = v_s
        shift = 1
        while shift < w:
            sk = jnp.pad(key_s[:, :-shift], ((0, 0), (shift, 0)),
                         constant_values=-1)
            sv = jnp.pad(seg[:, :-shift], ((0, 0), (shift, 0)))
            seg = seg + jnp.where(sk == key_s, sv, 0.0)
            shift *= 2
        nxt_diff = jnp.concatenate(
            [key_s[:, 1:] != key_s[:, :-1], jnp.ones((m, 1), bool)], axis=1)
        out_ok = nxt_diff & (key_s < sentinel)
        out_v = jnp.where(out_ok, seg, 0.0)
    else:
        # min lands on the run's FIRST element after a 2-key sort
        key_s, v_s = jax.lax.sort((key, v), num_keys=2, is_stable=True,
                                  dimension=1)
        is_start = jnp.concatenate(
            [jnp.ones((m, 1), bool), key_s[:, 1:] != key_s[:, :-1]], axis=1)
        out_ok = is_start & (key_s < sentinel)
        out_v = jnp.where(out_ok, v_s, 0.0)

    out_i = jnp.where(out_ok, key_s, jnp.int32(2**31 - 1))
    counts = jnp.sum(out_ok, axis=1).astype(jnp.int32)

    # compact the surviving run entries to the lane front, ascending col
    _, oi, ov = jax.lax.sort((out_i, jnp.where(out_ok, key_s, -1), out_v),
                             num_keys=1, dimension=1, is_stable=True)
    oi = oi[:, :width]
    ov = ov[:, :width]
    if weight_by_size and combine == "sum":
        ov = ov / denom[:, None]
    return oi, ov, counts


@functools.partial(jax.jit, static_argnames=("width",))
def _symmetrize_device(indices, distances, width: int):
    """Undirected union with min-distance dedup, self edge first, rows
    sorted ascending by distance (GraphUtils.cpp symmetrizeGraph semantics).

    indices/distances: [N, K], pad < 0.  Returns (out_idx [N, W] i32,
    out_dist [N, W] f32, counts_full [N] i32 incl. the self slot).
    """
    n, k = indices.shape
    e = 2 * n * k
    sentinel = jnp.int32(n)

    rows = jax.lax.broadcasted_iota(jnp.int32, (n, k), 0)
    valid = (indices >= 0) & (indices != rows)
    r_fwd = jnp.where(valid, rows, sentinel)
    c_fwd = jnp.where(valid, indices, sentinel)
    r_rev = jnp.where(valid, indices, sentinel)
    c_rev = jnp.where(valid, rows, sentinel)
    d_all = jnp.where(valid, distances, jnp.inf)

    r0 = jnp.concatenate([r_fwd.reshape(-1), r_rev.reshape(-1)])
    c0 = jnp.concatenate([c_fwd.reshape(-1), c_rev.reshape(-1)])
    d0 = jnp.concatenate([d_all.reshape(-1), d_all.reshape(-1)])

    # dedup (row, col) keeping the smallest distance: sort puts the min
    # first within each run
    r1, c1, d1 = jax.lax.sort((r0, c0, d0), num_keys=3, is_stable=True)
    valid1 = r1 < sentinel
    first = jnp.concatenate(
        [jnp.ones((1,), bool),
         (r1[1:] != r1[:-1]) | (c1[1:] != c1[:-1])]) & valid1

    # rank surviving entries by distance within their row
    r2 = jnp.where(first, r1, sentinel)
    r3, d3, c3 = jax.lax.sort((r2, d1, c1), num_keys=3, is_stable=True)

    iota = jnp.arange(e, dtype=jnp.int32)
    slot = iota - _run_starts(r3)
    row_ok = r3 < sentinel
    counts_full = (jnp.zeros(n, jnp.int32).at[r3].add(
        row_ok.astype(jnp.int32), mode="drop") + 1)

    slot_sc = jnp.where(row_ok, slot + 1, jnp.int32(width))  # OOB -> drop
    out_idx = jnp.full((n, width), -1, jnp.int32).at[r3, slot_sc].set(
        c3, mode="drop")
    out_dist = jnp.full((n, width), jnp.inf, jnp.float32).at[
        r3, slot_sc].set(d3, mode="drop")
    out_idx = out_idx.at[:, 0].set(jnp.arange(n, dtype=jnp.int32))
    out_dist = out_dist.at[:, 0].set(0.0)
    return out_idx, out_dist, counts_full


# ---------------------------------------------------------------------------
# dispatch helpers (host-facing: numpy in / numpy out, doubling width retry)
# ---------------------------------------------------------------------------

def use_device_restruct() -> bool:
    """Device restructuring is on whenever the backend is an accelerator
    (any backend but the CPU, where the host path runs and is the
    reference).  SPH_DEVICE_RESTRUCT=1 forces it on, 0 off — the tests
    use this to compare the device kernels with the host path."""
    import os
    flag = os.environ.get("SPH_DEVICE_RESTRUCT", "auto")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return jax.default_backend() != "cpu"


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def merge_by_parents_device(indices, values,
                            parents: np.ndarray, num_merged: int,
                            weight_by_size: bool, combine: str,
                            max_width: int | None):
    """Device merge with doubling-width retry.

    indices/values may be numpy or device arrays (device-resident chains
    pass `sr.device()` so nothing crosses back to the host).  Returns
    (out_idx [M, w] i32, out_val [M, w] f32, truncated: bool) as DEVICE
    arrays with w == a power-of-two sufficient width (<= max_width when
    given), or None when the input is malformed (out-of-domain ids ->
    host fallback).
    """
    n, r = indices.shape
    if n == 0 or num_merged <= 0:
        return None
    if int(parents.min(initial=0)) < 0 or \
            int(parents.max(initial=0)) >= num_merged:
        return None

    if isinstance(indices, jax.Array):
        # trusted in-package rows: skip the id-domain probe (a scalar
        # device->host sync per merge); the kernels clip/drop
        # out-of-domain ids rather than corrupt memory
        idx_d = indices
        val_d = values
    else:
        if indices.size and int(indices.max()) >= n:
            return None
        idx_d = jnp.asarray(np.ascontiguousarray(indices, np.int32))
        val_d = jnp.asarray(np.ascontiguousarray(values, np.float32))

    # bucket the child-row count: raw per-level row counts made every
    # level transition compile a fresh merge program family (the global
    # [N*R] sort is among the most expensive compiles).  Padded rows are
    # all-invalid (idx -1, val 0) so they sort to the sentinel tail and
    # contribute nothing; their parent slot is 0, touched only by a
    # weight_by_size add of row_w == 0.
    from .bucketing import bucket_rows
    nb = bucket_rows(max(8, n))
    parents_dev = np.ascontiguousarray(parents, np.int32)
    if nb != n:
        # one fused jitted pad (two eager jnp.pads compiled and
        # dispatched two tiny programs per level shape)
        from .sparse import _pad_pair_dev
        idx_d, val_d = _pad_pair_dev(idx_d, val_d, nb, idx_d.shape[1])
        parents_dev = np.pad(parents_dev, (0, nb - n))

    m_pad = max(512, _next_pow2(num_merged))
    cap = max_width if max_width is not None else 1 << 30
    # floor the cap to a power of two: the stored width is pow2 (for
    # bucketed downstream kernels), and a non-pow2 cap used to be applied
    # as a FINAL column slice of ascending-column-ordered output — i.e.
    # truncation by column id, not by value, diverging from the
    # _merge_device keep-largest/keep-smallest semantics.  With a pow2
    # cap the width loop's `width >= cap` exit routes every truncating
    # case through _merge_device's value-ordered selection.
    cap = max(1 << (int(cap).bit_length() - 1), 1) if cap >= 1 else 1
    # initial guess: union of ~N/M child rows, each up to R wide
    guess = r * max(int(np.ceil(n / max(num_merged, 1))), 1)
    width = min(_next_pow2(max(min(guess, 4 * r), 16)), _next_pow2(cap))

    par_d = jnp.asarray(parents_dev)

    # lane path: per-parent child gather + per-row lane sorts, no global
    # [N*R] sort.  Applicable when the widest parent's concatenated child
    # rows fit a sane lane width (a mega-merge parent falls back to the
    # global-sort path)
    ch_counts = np.bincount(parents, minlength=num_merged)
    cmax = int(ch_counts.max()) if ch_counts.size else 0
    # the lane kernel avoids the global 2-key sort but adds per-merge host
    # costs (children-table upload + a counts.max() scalar sync), which
    # outweighed it end to end where it was last measured — so the lane
    # path is opt-in; enable via SPH_MERGE_LANE_BUDGET=<max c_pad*r>
    lane_budget = int(os.environ.get("SPH_MERGE_LANE_BUDGET", "0"))
    m_pad_lane = _next_pow2(num_merged)
    if (0 < cmax and _next_pow2(cmax) * r <= lane_budget
            # total [M, C, R] gather buffer <= 2^28 f32 elems (~1 GB)
            and m_pad_lane * _next_pow2(cmax) * r <= (1 << 28)
            and (combine == "sum" or not weight_by_size)):
        c_pad = _next_pow2(cmax)
        order = np.argsort(parents, kind="stable")
        starts = np.zeros(num_merged + 1, np.int64)
        np.cumsum(ch_counts, out=starts[1:])
        slot = np.arange(n) - starts[parents[order]]
        children = np.full((m_pad, c_pad), -1, np.int32)
        children[parents[order], slot] = order
        ch_d = jnp.asarray(children)
        while True:
            oi, ov, counts = _merge_lanes(idx_d, val_d, par_d, ch_d,
                                          width, bool(weight_by_size),
                                          combine)
            need = int(counts.max()) if num_merged else 0
            if need <= width:
                break
            if width >= cap:
                oi, ov, counts = _merge_device(idx_d, val_d, par_d, m_pad,
                                               width, bool(weight_by_size),
                                               combine)
                break
            width = min(_next_pow2(need), _next_pow2(cap))
        w = max(min(_next_pow2(max(need, 1)), width), 1)
        if w > cap:
            w = cap
        truncated = need > w
        return oi[:num_merged, :w], ov[:num_merged, :w], truncated

    while True:
        # fast path: single global sort, valid whenever no row overflows
        # `width`; the truncating 3-sort body only runs when a width cap
        # actually bites (keep-largest / keep-smallest selection)
        oi, ov, counts = _merge_device_fast(idx_d, val_d, par_d, m_pad,
                                            width, bool(weight_by_size),
                                            combine)
        need = int(counts.max()) if num_merged else 0
        if need <= width:
            break
        if width >= cap:
            oi, ov, counts = _merge_device(idx_d, val_d, par_d, m_pad,
                                           width, bool(weight_by_size),
                                           combine)
            break
        width = min(_next_pow2(need), _next_pow2(cap))

    # keep the stored width a power of two so downstream bucketed kernels
    # (bhattacharyya, walks, gaussian rows) share compiled programs
    w = max(min(_next_pow2(max(need, 1)), width), 1)
    if w > cap:
        w = cap
    truncated = need > w
    oi = oi[:num_merged, :w]
    ov = ov[:num_merged, :w]
    return oi, ov, truncated


def symmetrize_graph_device(indices, distances, max_width: int):
    """Device symmetrize with a guessed width and doubling retry: the
    counts the kernel returns are PRE-truncation, so one scalar fetch both
    sizes the final slice and detects overflow (a separate degree-bound
    probe cost a scatter-add pass plus an extra device->host sync).

    indices/distances may be numpy or device arrays.  Returns
    (out_idx [N, w] i32, out_dist [N, w] f32, counts [N] i32) as DEVICE
    arrays with w <= max_width (0 = uncapped), or None on malformed input.
    """
    n, k = indices.shape
    if n == 0:
        return None
    if isinstance(indices, jax.Array):
        idx_d = indices
        dist_d = distances
    else:
        if indices.size and int(indices.max()) >= n:
            return None
        idx_d = jnp.asarray(np.ascontiguousarray(indices, np.int32))
        dist_d = jnp.asarray(np.ascontiguousarray(distances, np.float32))

    cap = max_width if max_width > 0 else 1 << 30
    width = max(min(_next_pow2(3 * k + 1), _next_pow2(cap),
                    _next_pow2(n)), 2)
    # device-array inputs come from the in-package kNN pipeline and are
    # trusted (host-input ids are validated above; the kernel drops any
    # out-of-domain scatter anyway)
    while True:
        oi, od, counts = _symmetrize_device(idx_d, dist_d, width)
        need = int(counts.max())
        if need <= width or width >= min(cap, n):
            break
        width = min(_next_pow2(need), _next_pow2(cap), _next_pow2(n))
    w = max(min(_next_pow2(max(need, 1)), width), 1)
    if w > cap:
        w = cap
    counts_d = jnp.minimum(counts, w)
    return oi[:, :w], od[:, :w], counts_d
