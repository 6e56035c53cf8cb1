"""Distance -> probability kernels.

Reference: sph/utils/GraphNormalization.cpp — Gaussian (t-SNE, perplexity beta
binary search with tiny-sigma fallbacks, :38-338), linear (1/(1+d), :340-411)
and exponential (UMAP smooth-knn via umappp::neighbor_similarities, :413-593);
the core beta search is HDILibHelper.hpp:23-109.

Design: the per-row binary search becomes one vectorized `lax.while_loop`
over *all* rows simultaneously — each iteration is a handful of [N, K]
elementwise ops, so the 200-iteration search costs microseconds instead of
the reference's per-row scalar loops.

Row layout: `values [N, K]` with a parallel `mask [N, K]` (True = valid entry).
`ignore_first=True` excludes column 0 (the self edge) like the reference's
ignore-index-0 mode; `ignore_first=False` matches ignore == -1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_MIN_SIGMA = 0.001     # reference: GraphNormalization.cpp:96,249
_MIN_VAL = 1.0e-10     # values below are dropped (GraphNormalization.cpp:133)


@functools.partial(jax.jit, static_argnames=("ignore_first", "max_iter"))
def gaussian_row_distributions(values: jax.Array, mask: jax.Array,
                               perplexity: jax.Array,
                               ignore_first: bool = True,
                               max_iter: int = 200,
                               tol: float = 1e-6) -> jax.Array:
    """Per-row Gaussian kernel with fixed perplexity.

    values: [N, K] distances (or distance-like similarities), mask: [N, K].
    perplexity: scalar or [N]; <= 0 means "use (row_size)/3" like the
    reference's fixedPerplexity<=0 branch (GraphNormalization.cpp:75-79 uses
    nn/3 for in-place rows and (nn-1)/3 for graph rows — here row_size already
    excludes the ignored column).

    Returns probabilities [N, K] with each valid row summing to 1 (ignored /
    masked columns are 0).  Implements the exact HDILib search: beta=1 start,
    doubling/halving until bracketed then bisection, entropy tolerance 1e-6,
    uniform fallback when not converged, and the tiny-sigma fallback chain
    (copy distances -> unit-normalize -> invert -> renormalize).
    """
    n, k = values.shape
    eff_mask = mask
    if ignore_first:
        col0 = jax.lax.broadcasted_iota(jnp.int32, (n, k), 1) == 0
        eff_mask = jnp.logical_and(mask, ~col0)

    row_sizes = jnp.sum(eff_mask, axis=1).astype(jnp.float32)   # [N]
    perplexity = jnp.broadcast_to(jnp.asarray(perplexity, jnp.float32), (n,))
    perplexity = jnp.where(perplexity > 0, perplexity,
                           jnp.maximum(row_sizes / 3.0, 1.0))
    log_perp = jnp.log(perplexity)

    vals = jnp.where(eff_mask, values, 0.0).astype(jnp.float32)
    # the kernel is evaluated on distances shifted by the row minimum:
    # probabilities and entropy are invariant to the shift, and without it
    # exp(-beta * d) underflows f32 on tight rows (beta ~ 300, d ~ 0.4 on
    # dense hyperspectral clusters), where denormal handling then differs
    # between backends
    big = jnp.float32(np.finfo(np.float32).max)
    vmin = jnp.min(jnp.where(eff_mask, vals, big), axis=1, keepdims=True)
    shifted = jnp.where(eff_mask, vals - vmin, 0.0)

    def cond(state):
        it, beta, lo, hi, found, done = state[:6]
        return jnp.logical_and(it < max_iter, ~jnp.all(done))

    def body(state):
        it, beta, lo, hi, found, done = state
        # unnormalized kernel row
        p = jnp.where(eff_mask, jnp.exp(-beta[:, None] * shifted), 0.0)
        s = jnp.sum(p, axis=1) + jnp.float32(1e-38)  # f32-safe tiny
        h = jnp.sum(p * shifted, axis=1) * beta / s + jnp.log(s)
        hdiff = h - log_perp
        ok = jnp.abs(hdiff) < tol
        new_found = jnp.logical_or(found, ok)

        go_up = hdiff > 0
        new_lo = jnp.where(go_up, beta, lo)
        new_hi = jnp.where(go_up, hi, beta)
        beta_up = jnp.where(jnp.abs(hi) >= big, beta * 2.0,
                            (beta + hi) / 2.0)
        beta_dn = jnp.where(jnp.abs(lo) >= big, beta / 2.0,
                            (beta + lo) / 2.0)
        new_beta = jnp.where(go_up, beta_up, beta_dn)
        # f32 fixpoint: the update is a deterministic function of
        # (beta, lo, hi), so an unchanged state can never change again —
        # stop iterating the row (`done`) WITHOUT marking it converged
        # (`found` keeps the reference's uniform-fallback semantics for
        # rows that never meet the tolerance).  Output is bit-identical
        # to iterating to max_iter; the whole-batch iteration count drops
        # from "every degenerate row pins the batch at max_iter" to
        # "until the last row converges or freezes".
        pinned = (new_beta == beta) & (new_lo == lo) & (new_hi == hi)
        # a pinned search inside a finite bracket has found beta to f32
        # resolution: the entropy there is the closest f32 can reach, a
        # few ulps off the target, and whether those ulps fall under
        # `tol` is rounding noise that flips between backends.  The
        # reference's double-precision search converges at that beta, so
        # count it as found; only unbracketed (unreachable-target) rows
        # take the fallback.
        bracketed = (jnp.abs(lo) < big) & (jnp.abs(hi) < big)
        new_found = jnp.logical_or(new_found, pinned & bracketed)
        new_done = jnp.logical_or(done, jnp.logical_or(new_found, pinned))
        # freeze on new_found exactly like the single-flag original (beta
        # stays at the tolerance-achieving value); pinned rows continue
        # formally but their updates are f32 no-ops either way
        freeze = jnp.logical_or(new_found, done)
        new_beta = jnp.where(freeze, beta, new_beta)
        new_lo = jnp.where(freeze, lo, new_lo)
        new_hi = jnp.where(freeze, hi, new_hi)
        return (it + 1, new_beta, new_lo, new_hi, new_found, new_done)

    # empty / single-entry rows can never satisfy the entropy tolerance
    # (their sum underflows to 0 -> NaN entropy); mark them done up front
    # so they don't pin the whole batch at max_iter
    init_done = row_sizes <= 1
    # derive the numeric carries from the (data-dependent) row_sizes so the
    # carry is "varying" when traced inside shard_map (a constant init
    # would type-mismatch the loop-carried outputs there)
    vzero = row_sizes * 0.0
    init = (jnp.int32(0), vzero + 1.0,
            vzero - big, vzero + big,
            init_done, init_done)
    _, beta, _, _, found, _ = jax.lax.while_loop(cond, body, init)
    found = jnp.logical_and(found, row_sizes > 1)

    p = jnp.where(eff_mask, jnp.exp(-beta[:, None] * shifted), 0.0)
    s = jnp.sum(p, axis=1)
    prob = jnp.where(s[:, None] > 0, p / jnp.maximum(s, 1e-38)[:, None], 0.0)

    # not-found -> uniform over valid entries (HDILibHelper.hpp:98-104)
    uniform = jnp.where(eff_mask,
                        1.0 / jnp.maximum(row_sizes, 1.0)[:, None], 0.0)
    prob = jnp.where(found[:, None], prob, uniform)

    sigma = jnp.where(found, jnp.sqrt(1.0 / (2.0 * jnp.maximum(beta, 1e-38))),
                      0.0)

    # tiny-sigma fallback chain (GraphNormalization.cpp:96-130):
    #   copy distances; all-zero -> uniform; else unit-normalize, invert
    #   (1 - x); all-zero again -> uniform; else zero the ignored slot and
    #   renormalize.
    # Documented deviation: in the all-zero branch the reference's
    # assignSameProb writes 1/(nn-1) into ALL nn slots *including the self
    # slot*; here the self slot stays 0 so every returned row sums to 1
    # over valid entries (the invariant everything downstream relies on).
    # Forces are unaffected — consumers skip slot 0 — but degenerate rows
    # differ from the reference in the diagonal entry.
    degenerate = sigma < _MIN_SIGMA
    dsum = jnp.sum(vals, axis=1)
    all_zero = dsum == 0.0
    fb = jnp.where(eff_mask, vals / jnp.maximum(dsum, 1e-38)[:, None], 0.0)
    fb = jnp.where(eff_mask, 1.0 - fb, 0.0)
    fb_sum = jnp.sum(fb, axis=1)
    fb_zero = fb_sum == 0.0
    fb = jnp.where(eff_mask, fb / jnp.maximum(fb_sum, 1e-38)[:, None], 0.0)
    fallback = jnp.where((all_zero | fb_zero)[:, None], uniform, fb)
    prob = jnp.where(degenerate[:, None], fallback, prob)

    # drop numerically-zero entries (GraphNormalization.cpp minVal 1e-10)
    prob = jnp.where(prob < _MIN_VAL, 0.0, prob)

    # rows with <= 1 entries keep their input untouched in the reference
    # (GraphNormalization.cpp:72-73); here: single valid entry -> prob 1
    single = row_sizes <= 1
    one_entry = jnp.where(eff_mask, 1.0, 0.0)
    prob = jnp.where(single[:, None] & (row_sizes[:, None] > 0),
                     one_entry, prob)
    return prob


@jax.jit
def linear_row_distributions(values: jax.Array, mask: jax.Array,
                             ) -> jax.Array:
    """1/(1+d) then row-normalize (reference: computeLinearDistributions,
    GraphNormalization.cpp:340-411).  Column 0 (self) must already be masked
    out by the caller if desired."""
    p = jnp.where(mask, 1.0 / (1.0 + values), 0.0)
    s = jnp.sum(p, axis=1, keepdims=True)
    return jnp.where(s > 0, p / jnp.maximum(s, 1e-38), 0.0)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def smooth_knn_distributions(values: jax.Array, mask: jax.Array,
                             local_connectivity: float = 1.0,
                             bandwidth: float = 1.0,
                             max_iter: int = 64) -> jax.Array:
    """UMAP exponential kernel (reference: computeExponentialDistributions
    wrapping umappp::neighbor_similarities, GraphNormalization.cpp:413-593).

    Implements the smooth-knn-dist algorithm of the UMAP paper (the same
    algorithm umappp uses): per row, rho = distance to the
    `local_connectivity`-th nearest neighbor (with interpolation), then binary
    search sigma such that sum_j exp(-(max(0, d_j - rho)) / sigma) =
    log2(k) * bandwidth.  Returns similarities in (0, 1]; NOT row-normalized
    (UMAP memberships are not probabilities).
    """
    n, k = values.shape
    vals = jnp.where(mask, values, jnp.inf).astype(jnp.float32)
    counts = jnp.sum(mask, axis=1).astype(jnp.float32)

    sorted_vals = jnp.sort(vals, axis=1)
    nonzero = jnp.where(jnp.isfinite(sorted_vals) & (sorted_vals > 0),
                        sorted_vals, jnp.inf)
    nz_sorted = jnp.sort(nonzero, axis=1)
    num_nonzero = jnp.sum(jnp.isfinite(nonzero), axis=1)

    # rho: interpolated local_connectivity-th smallest nonzero distance
    lc = jnp.float32(local_connectivity)
    idx_lo = jnp.clip(jnp.int32(jnp.floor(lc)) - 1, 0, k - 1)
    frac = lc - jnp.floor(lc)
    lo_val = nz_sorted[:, idx_lo]
    hi_val = nz_sorted[jnp.arange(n), jnp.clip(idx_lo + 1, 0, k - 1)]
    rho = jnp.where(frac > 0, lo_val + frac * (hi_val - lo_val), lo_val)
    # fewer nonzero distances than local_connectivity: rho = max nonzero
    # (umap-learn smooth_knn_dist fallback)
    max_nz = jnp.max(jnp.where(jnp.isfinite(nonzero), nonzero, 0.0), axis=1)
    rho = jnp.where(num_nonzero >= jnp.ceil(lc), rho,
                    jnp.where(num_nonzero > 0, max_nz, 0.0))
    rho = jnp.where(jnp.isfinite(rho), rho, 0.0)

    target = jnp.log2(jnp.maximum(counts, 2.0)) * bandwidth

    def psum(sigma):
        d = jnp.maximum(values - rho[:, None], 0.0)
        p = jnp.where(mask, jnp.exp(-d / sigma[:, None]), 0.0)
        return jnp.sum(p, axis=1)

    def body(state, _):
        sigma, lo, hi = state
        cur = psum(sigma)
        too_big = cur > target
        new_hi = jnp.where(too_big, sigma, hi)
        new_lo = jnp.where(too_big, lo, sigma)
        new_sigma = jnp.where(
            too_big, (sigma + lo) / 2.0,
            jnp.where(jnp.isinf(hi), sigma * 2.0, (sigma + hi) / 2.0))
        return (new_sigma, new_lo, new_hi), None

    init = (jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.float32),
            jnp.full(n, jnp.inf, jnp.float32))
    (sigma, _, _), _ = jax.lax.scan(body, init, None, length=max_iter)

    # umap-learn clamps sigma from below relative to mean distances
    mean_d = jnp.sum(jnp.where(mask, values, 0.0), axis=1) / jnp.maximum(
        counts, 1.0)
    sigma = jnp.maximum(sigma, 1e-3 * jnp.maximum(mean_d, 1e-12))

    d = jnp.maximum(values - rho[:, None], 0.0)
    sims = jnp.where(mask, jnp.exp(-d / sigma[:, None]), 0.0)
    return sims


def _pad_rows_dev(arr: jax.Array, npad: int, wpad: int, fill) -> jax.Array:
    n, k = arr.shape
    if (npad, wpad) == (n, k):
        return arr
    return jnp.pad(arr, ((0, npad - n), (0, wpad - k)),
                   constant_values=fill)


@functools.partial(jax.jit, static_argnames=("npad", "wpad"))
def _pad_val_mask_dev(values: jax.Array, mask: jax.Array,
                      npad: int, wpad: int):
    """One fused program for the (values, mask) bucket pads (two eager
    jnp.pad calls otherwise compile two tiny programs per level shape)."""
    n, k = values.shape
    return (jnp.pad(values, ((0, npad - n), (0, wpad - k))),
            jnp.pad(mask, ((0, npad - n), (0, wpad - k)),
                    constant_values=False))


@functools.partial(jax.jit, static_argnames=("npad", "wpad"))
def _pad_idx_val_mask_dev(idx: jax.Array, values: jax.Array,
                          npad: int, wpad: int):
    """Fused mask-from-indices + bucket pads: the eager
    `(idx >= 0) & (val != 0)` at the call sites compiled three extra tiny
    programs per level shape."""
    n, k = values.shape
    mask = (idx >= 0) & (values != 0)
    return (jnp.pad(values, ((0, npad - n), (0, wpad - k))),
            jnp.pad(mask, ((0, npad - n), (0, wpad - k)),
                    constant_values=False))


def gaussian_rows_bucketed(values, mask, perplexity: float,
                           ignore_first: bool, indices=None):
    """Shape-bucketed wrapper around gaussian_row_distributions: pads
    rows/width to canonical sizes so every hierarchy level reuses one
    compiled program (see ops/bucketing.py).  Device arrays in -> device
    array out (padding stays on device); numpy in -> numpy out.

    indices: optional device index array; when given (device path) the
    `(idx >= 0) & (val != 0)` mask is fused into the pad program and the
    `mask` argument is ignored."""
    from .bucketing import bucket_rows, bucket_width, pad_axis
    n, k = values.shape
    npad = bucket_rows(n)
    wpad = bucket_width(k)
    if isinstance(values, jax.Array):
        if indices is not None:
            v, m = _pad_idx_val_mask_dev(indices, values, npad, wpad)
        else:
            v, m = _pad_val_mask_dev(values, mask, npad, wpad)
        out = gaussian_row_distributions(v, m, jnp.float32(perplexity),
                                         ignore_first=ignore_first)
        return out[:n, :k]
    if mask is None and indices is not None:
        mask = (np.asarray(indices) >= 0) & (np.asarray(values) != 0)
    v = pad_axis(pad_axis(np.asarray(values, np.float32), 0, npad, 0.0),
                 1, wpad, 0.0)
    m = pad_axis(pad_axis(np.asarray(mask, bool), 0, npad, False),
                 1, wpad, False)
    out = gaussian_row_distributions(jnp.asarray(v), jnp.asarray(m),
                                     jnp.float32(perplexity),
                                     ignore_first=ignore_first)
    return np.asarray(out)[:n, :k]


def smooth_knn_rows_bucketed(values, mask, indices=None):
    """Bucketed wrapper around smooth_knn_distributions (device arrays in ->
    device array out, like gaussian_rows_bucketed incl. the fused-mask
    `indices` option)."""
    from .bucketing import bucket_rows, bucket_width, pad_axis
    n, k = values.shape
    npad = bucket_rows(n)
    wpad = bucket_width(k)
    if isinstance(values, jax.Array):
        if indices is not None:
            v, m = _pad_idx_val_mask_dev(indices, values, npad, wpad)
        else:
            v, m = _pad_val_mask_dev(values, mask, npad, wpad)
        return smooth_knn_distributions(v, m)[:n, :k]
    if mask is None and indices is not None:
        mask = (np.asarray(indices) >= 0) & (np.asarray(values) != 0)
    v = pad_axis(pad_axis(np.asarray(values, np.float32), 0, npad, 0.0),
                 1, wpad, 0.0)
    m = pad_axis(pad_axis(np.asarray(mask, bool), 0, npad, False),
                 1, wpad, False)
    out = smooth_knn_distributions(jnp.asarray(v), jnp.asarray(m))
    return np.asarray(out)[:n, :k]


def distance_rows_to_probabilities(values, mask,
                                   scheme, perplexity: float = -1.0,
                                   ignore_first: bool = True,
                                   umap_row_norm: bool = False):
    """The single scheme dispatcher used by every distance-rows -> prob-rows
    site (reference: normalizeKnnDistances, GraphNormalization.hpp:36-53).

    TSNE -> Gaussian-perplexity rows; LINEAR -> 1/(1+d); UMAP -> smooth-knn
    memberships (row-normalized when umap_row_norm, e.g. when feeding the
    random-walk sampler); any other scheme falls back to Gaussian with a
    warning, matching the reference's default branch.

    Device arrays in -> device array out (residency-preserving); numpy in ->
    numpy out.
    """
    from ..settings import NormalizationScheme

    on_device = isinstance(values, jax.Array)
    if not on_device:
        mask = np.asarray(mask, bool)
    if scheme == NormalizationScheme.TSNE:
        return gaussian_rows_bucketed(values, mask, perplexity,
                                      ignore_first=ignore_first)
    if on_device:
        m2 = mask
        if ignore_first:
            n, k = mask.shape
            col0 = jax.lax.broadcasted_iota(jnp.int32, (n, k), 1) == 0
            m2 = mask & ~col0
    else:
        m2 = mask.copy()
        if ignore_first:
            m2[:, 0] = False
    if scheme == NormalizationScheme.LINEAR:
        p = linear_row_distributions(jnp.asarray(values), jnp.asarray(m2))
        return p if on_device else np.asarray(p)
    if scheme == NormalizationScheme.UMAP:
        if on_device:
            p = smooth_knn_rows_bucketed(values, m2)
            if umap_row_norm:
                s = jnp.sum(p, axis=1, keepdims=True)
                p = jnp.where(s > 0, p / jnp.maximum(s, 1e-12), 0.0)
            return p
        p = smooth_knn_rows_bucketed(np.asarray(values, np.float32), m2)
        if umap_row_norm:
            s = p.sum(axis=1, keepdims=True)
            p = np.where(s > 0, p / np.maximum(s, 1e-12), 0.0)
        return p.astype(np.float32)
    from ..utils.logging import Log
    Log.warn("distance_rows_to_probabilities: scheme %s not a probability "
             "kernel, falling back to Gaussian (reference: "
             "GraphNormalization.hpp default branch)", scheme)
    return gaussian_rows_bucketed(values, mask, perplexity,
                                  ignore_first=ignore_first)


def normalize_knn_distances(distances: np.ndarray, scheme,
                            perplexity: float = -1.0) -> np.ndarray:
    """Dispatcher over a fixed-k kNN graph's distance rows (reference:
    normalizeKnnDistances, GraphNormalization.hpp:36-53).  Column 0 is the
    self edge and is excluded; returns [N, K] probabilities with column 0 == 0.
    """
    from ..settings import NormalizationScheme

    d = jnp.asarray(distances, jnp.float32)
    mask = jnp.ones_like(d, dtype=bool)
    if scheme == NormalizationScheme.TSNE:
        p = gaussian_row_distributions(d, mask, jnp.float32(perplexity),
                                       ignore_first=True)
    elif scheme == NormalizationScheme.LINEAR:
        n, k = d.shape
        m2 = mask & (jax.lax.broadcasted_iota(jnp.int32, (n, k), 1) > 0)
        p = linear_row_distributions(d, m2)
    elif scheme == NormalizationScheme.UMAP:
        n, k = d.shape
        m2 = mask & (jax.lax.broadcasted_iota(jnp.int32, (n, k), 1) > 0)
        p = smooth_knn_distributions(d, m2)
    elif scheme == NormalizationScheme.NONE:
        p = d.at[:, 0].set(0.0)
    else:
        raise ValueError(f"unknown scheme {scheme}")
    return np.asarray(p)
