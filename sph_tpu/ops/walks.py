"""Random-walk engine.

Reference: sph/utils/SparseMatrixAlgorithms.cpp doRandomWalks (:34-290) — per
point, `num_random_walks` walks of `single_walk_length` steps sampling the
next node by inverse-CDF over the similarity row (in ascending column order),
with five importance-weighting schemes, optional pruning, diagonal removal
and row normalization.

Redesign: all C * W walkers advance in lock-step under a
`lax.scan` over steps — each step is one gather of the cumulative-probability
rows plus a vectorized CDF inversion (a `sum(cum <= u)` count, identical to
the reference's first-crossing scan in index order).  Visit accumulation is a
per-row sort + run-length segment-sum, replacing the reference's per-thread
Eigen sparse scatter with omp locks.  The mt19937 streams become counter-based
threefry keys — bit-for-bit parity with the C++ streams is impossible, so
parity is statistical (see tests), matching SURVEY.md hard-part #2.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..settings import ImportanceWeighting, RandomWalkSettings
from ..utils.logging import Log
from .sparse import PAD, SparseRows


def step_linear(step, walk_length):
    """Reference: SparseMatrixAlgorithms.hpp:60-61."""
    return 1.0 - step / walk_length


def step_normal(step, walk_length):
    """Reference: SparseMatrixAlgorithms.hpp:64-70 (3 sigma over the walk)."""
    x = step * 3.0 / walk_length
    return np.exp(-0.5 * x * x)


def derive_prune_value(settings: RandomWalkSettings) -> float:
    """Reference: doRandomWalks prune-steps logic (:41-62)."""
    prune_value = settings.prune_value
    if settings.prune_steps > 0:
        l = settings.single_walk_length
        prune_step = min(l - 1, settings.prune_steps)
        prune_step_inv = l - prune_step
        iw = settings.importance_weighting
        if iw == ImportanceWeighting.LINEAR:
            prune_value = step_linear(prune_step_inv, l)
        elif iw == ImportanceWeighting.NORMAL:
            prune_value = step_normal(prune_step_inv, l)
        elif iw == ImportanceWeighting.CONSTANT:
            prune_value = float(prune_step_inv)
        elif iw == ImportanceWeighting.FIRST_VISIT:
            prune_value = float(prune_step) / l
        if prune_value > 0.5:
            Log.warn("doRandomWalks: derived prune value %.3f clamped to 0.5",
                     prune_value)
            prune_value = 0.5
    return float(prune_value)


@functools.partial(jax.jit, static_argnames=("num_walks", "walk_length"))
def _simulate(indices: jax.Array, values: jax.Array, seed: jax.Array,
              num_walks: int, walk_length: int) -> jax.Array:
    """Advance all walkers; returns visited nodes [walk_length, C * W].

    Sampling matches the reference: u ~ U(0,1); next = first column j (in
    ascending index order) with u < cumsum(row)[j]; if none, stay.

    The cumulative sums are taken in integers, over probabilities rounded
    to 2^-24 (f32 resolution at 1): exact in any summation order, so two
    backends, or a batched and an unbatched program, sample the same
    steps unless the probabilities themselves differ.  An f32 cumsum
    rounds in an order-dependent way (up to ~1e-6 across a wide row),
    enough to send walkers to different neighbors on two backends.
    """
    c, r = indices.shape
    w = num_walks
    scale = float(1 << 24)
    q = jnp.round(jnp.where(indices >= 0, values, 0.0) * scale)
    cum = jnp.cumsum(q.astype(jnp.int32), axis=1)  # [C, R], exact

    # derive the walker-state carry from the (data-dependent) indices so it
    # is "varying" when traced inside shard_map (the multi-scene stage-1
    # path); a constant init would type-mismatch the loop-carried output
    start = jnp.repeat(jnp.arange(c, dtype=jnp.int32) + indices[:, 0] * 0,
                       w)  # [C*W]
    key = jax.random.PRNGKey(seed)

    # chunk the walker axis: the per-step [walkers, R] cumsum gather is the
    # peak buffer (6.5M x 1024 at Salinas scale would be 26 GB); bound it to
    # ~2^26 entries per chunk.  The uniform stream is drawn whole per step,
    # so chunking does not change the sampled walks.
    total = c * w
    chunk = min(total, max(8192, (1 << 26) // max(r, 1)))
    npadw = ((total + chunk - 1) // chunk) * chunk
    start_p = jnp.concatenate(
        [start, jnp.broadcast_to(start[:1] * 0, (npadw - total,))])

    def step(nodes, t):
        u = jax.random.uniform(jax.random.fold_in(key, t), (total,))
        u = jnp.floor(u * scale).astype(jnp.int32)
        u_p = jnp.concatenate([u, jnp.zeros(npadw - total, jnp.int32)])

        def sub(args):
            nodes_c, u_c = args
            rows_cum = cum[nodes_c]          # [chunk, R] row gather
            pos = jnp.sum(rows_cum <= u_c[:, None], axis=1)
            in_range = pos < r
            safe_pos = jnp.minimum(pos, r - 1)
            # lane-select the sampled column instead of a per-element 2D
            # gather (indices[nodes_c, safe_pos] lowers to scalar lane
            # gathers, the slow path this avoids): one more row gather + a
            # lane-parallel select
            rows_idx = indices[nodes_c]      # [chunk, R]
            sel = (jax.lax.broadcasted_iota(jnp.int32, rows_idx.shape, 1)
                   == safe_pos[:, None])
            cand = jnp.sum(jnp.where(sel, rows_idx, 0), axis=1)
            return jnp.where(in_range & (cand >= 0), cand, nodes_c)

        nxt = jax.lax.map(sub, (nodes.reshape(-1, chunk),
                                u_p.reshape(-1, chunk))).reshape(npadw)
        return nxt, nxt[:total]

    _, visited = jax.lax.scan(step, start_p, jnp.arange(walk_length))
    return visited  # [L, C*W]


@functools.partial(jax.jit, static_argnames=(
    "num_walks", "walk_length", "weighting", "out_width"))
def _accumulate(visited: jax.Array, num_walks: int, walk_length: int,
                weighting: str, out_width: int
                ) -> Tuple[jax.Array, jax.Array]:
    """Turn the visit record into weighted per-start-point rows.

    visited: [L, C*W].  Returns (indices [C, out_width], values
    [C, out_width]) with per-row unique columns summed per the weighting
    scheme.  FIRST_VISIT implements the average-first-visit-step inversion
    (reference: :151-201).
    """
    l, cw = visited.shape
    w = num_walks
    c = cw // w

    steps = jnp.arange(l, dtype=jnp.float32)
    if weighting == "constant":
        step_w = jnp.ones(l, jnp.float32)
    elif weighting == "linear":
        step_w = 1.0 - steps / walk_length
    elif weighting == "normal":
        x = steps * 3.0 / walk_length
        step_w = jnp.exp(-0.5 * x * x)
    elif weighting == "onlylast":
        step_w = jnp.where(steps == l - 1, 1.0, 0.0)
    else:  # first_visit handled below
        step_w = steps + 1.0

    if weighting == "first_visit":
        # first visit within each walk: the step is the walk's earliest
        # occurrence of that node, and the node differs from the start.
        # Sort (node, step) along the step axis per walk and mark run
        # starts — O(L log L) instead of an O(L^2) unrolled trace (the
        # eval grid uses walk lengths up to 400).
        start = jnp.repeat(jnp.arange(c, dtype=jnp.int32), w)  # [C*W]
        order = jnp.argsort(visited, axis=0, stable=True)      # [L, CW]
        # stable: equal nodes keep step order, so run starts are earliest
        cols = jax.lax.broadcasted_iota(jnp.int32, (l, cw), 1)
        sorted_v = jnp.take_along_axis(visited, order, axis=0)
        new_run = jnp.concatenate(
            [jnp.ones((1, cw), bool), sorted_v[1:] != sorted_v[:-1]],
            axis=0)
        first_sorted = new_run & (sorted_v != start[None, :])
        first_mask = jnp.zeros((l, cw), bool).at[order, cols].set(
            first_sorted)
        weights = jnp.where(first_mask, step_w[:, None], 0.0)
        counts = first_mask.astype(jnp.float32)
    else:
        weights = jnp.broadcast_to(step_w[:, None], (l, cw))
        counts = jnp.ones((l, cw), jnp.float32)

    # reshape to per-start-point sample lists [C, W*L]
    ids = visited.reshape(l, c, w).transpose(1, 2, 0).reshape(c, w * l)
    wts = weights.reshape(l, c, w).transpose(1, 2, 0).reshape(c, w * l)
    cts = counts.reshape(l, c, w).transpose(1, 2, 0).reshape(c, w * l)

    # lane-local co-sort by node id — argsort + [rr, order] gathers and
    # .at[rr, run_id].add scatters lower to per-element ops (see
    # sparse._bhattacharyya_pairs_device); the sorted
    # layout lets segmented run sums come from cumsum + a cummax-propagated
    # run base instead
    ids_s, wts_s, cts_s = jax.lax.sort((ids, wts, cts), num_keys=1,
                                       dimension=1, is_stable=False)

    new_run = jnp.concatenate(
        [jnp.ones((c, 1), bool), ids_s[:, 1:] != ids_s[:, :-1]], axis=1)
    run_end = jnp.concatenate(
        [new_run[:, 1:], jnp.ones((c, 1), bool)], axis=1)

    def run_totals(x):
        """Per-run sums of x (x >= 0), placed at each run's END position."""
        cum = jnp.cumsum(x, axis=1)
        base = jnp.where(new_run, cum - x, -jnp.inf)
        base = jax.lax.cummax(base, axis=1)   # run-start base, propagated
        return cum - base

    sum_w = run_totals(wts_s)
    sum_c = run_totals(cts_s)
    valid_run = run_end

    if weighting == "first_visit":
        # average step of first visits, inverted to [0, 1]
        # (reference: :180-200 — m = -1/(L-1), c = L/(L-1))
        avg = jnp.where(sum_c > 0, sum_w / jnp.maximum(sum_c, 1.0), 0.0)
        m = -1.0 / (walk_length - 1.0)
        b = walk_length / (walk_length - 1.0)
        val = jnp.maximum(0.0, m * avg + b)
        # nodes visited only as repeats (count 0) are absent entirely
        valid_run = valid_run & (sum_c > 0)
    else:
        val = sum_w

    val = jnp.where(valid_run, val, 0.0)
    run_ids = jnp.where(valid_run & (val > 0), ids_s, PAD)

    s = w * l
    if out_width < s:
        # top-k via a value sort with id payload: top_k + a [C, k] gather
        # would reintroduce lane gathers
        neg_v, top_i = jax.lax.sort((-val, run_ids), num_keys=1,
                                    dimension=1, is_stable=True)
        return top_i[:, :out_width], -neg_v[:, :out_width]
    return run_ids, val


@functools.partial(jax.jit, static_argnames=(
    "do_remove_diagonal", "do_normalize"))
def _postprocess(idx: jax.Array, val: jax.Array, prune_value: jax.Array,
                 do_remove_diagonal: bool, do_normalize: bool):
    """Fused on-device post-processing: prune <= prune_value, remove the
    diagonal (keeping single-entry rows), sort by column id with pads last,
    row-normalize — one argsort instead of three host passes."""
    c, r = idx.shape
    valid = (idx >= 0) & (val > 0)
    valid = valid & (val > prune_value)

    if do_remove_diagonal:
        rows = jax.lax.broadcasted_iota(jnp.int32, (c, r), 0)
        diag = valid & (idx == rows)
        nnz = jnp.sum(valid, axis=1, keepdims=True)
        valid = valid & (~diag | (nnz <= 1))

    big = jnp.int32(2**31 - 1)
    key = jnp.where(valid, idx, big)
    # multi-operand lane sort instead of argsort + [rr, order] gathers
    # (per-element lane gathers are the slow path this avoids)
    _, idx_s, val_s = jax.lax.sort(
        (key, jnp.where(valid, idx, -1), jnp.where(valid, val, 0.0)),
        num_keys=1, dimension=1, is_stable=True)

    if do_normalize:
        s = jnp.sum(val_s, axis=1, keepdims=True)
        val_s = jnp.where(s > 0, val_s / jnp.maximum(s, 1e-38), 0.0)
    return idx_s, val_s


def do_random_walks(similarities: SparseRows,
                    settings: RandomWalkSettings,
                    verbose: bool = False) -> SparseRows:
    """Full doRandomWalks semantics (reference:
    SparseMatrixAlgorithms.cpp:34-290): simulate, weight, prune, remove
    diagonal (keeping single-entry rows), row-normalize — all on device;
    only the final fixed-width rows cross back to the host."""
    c = similarities.num_rows
    w = int(settings.num_random_walks)
    l = int(settings.single_walk_length)
    Log.info("Random walks: %d walks with %d steps each using %s weighting",
             w, l, settings.importance_weighting.value)

    prune_value = derive_prune_value(settings)
    if prune_value > 0:
        Log.info("Random walks: pruning all values below %s", prune_value)

    cap = settings.max_row_nnz or min(w * l, 2048)
    out_width = min(cap, w * l, c)

    sim_idx, sim_val = similarities.device()
    visited = _simulate(sim_idx, sim_val,
                        jnp.uint32(settings.random_seed), w, l)
    idx, val = _accumulate(visited, w, l,
                           settings.importance_weighting.value, out_width)
    idx, val = _postprocess(idx, val, jnp.float32(prune_value),
                            settings.remove_diagonal, settings.normalize)

    # stays device-resident: downstream merges / pair metrics read the
    # device copies; the host copy materializes lazily if ever needed.
    # Shrink the stored width to the widest surviving row (pruning can
    # empty most of the padded slots; downstream merge/pair costs scale
    # with the padded width).
    from .sparse import _nnz_rows_dev, _slice_pair_dev
    nnz_rows = np.asarray(_nnz_rows_dev(idx, val))
    need = int(nnz_rows.max()) if nnz_rows.size else 1
    from .bucketing import bucket_width
    wkeep = min(bucket_width(need), idx.shape[1])
    if wkeep < idx.shape[1]:
        idx, val = _slice_pair_dev(idx, val, idx.shape[0], wkeep)
    rows = SparseRows(idx, val, c)
    empty = int((nnz_rows == 0).sum())
    if empty:
        Log.warn("doRandomWalks: %d rows have no effective entries", empty)
    return rows
