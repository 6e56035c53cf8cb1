"""UMAP gradient descent.

Reference: sph/EmbedUmap.cpp — umappp-backed: NeighborList conversion,
combine_neighbor_sets (fuzzy union), spectral init via normalized_laplacian
with random fallback (:192-202), find_ab / choose_num_epochs /
similarities_to_epochs (:204-221), then per-epoch `status->run` SGD
(:233-269).

Redesign: umappp's sequential per-edge SGD is replaced by *batched
epoch updates*: every epoch processes all currently-scheduled edges at once,
with `negative_sample_rate` negatives per active edge.  Per-edge scheduling
via epochs_per_sample is preserved, so strong edges are still sampled
proportionally more often.  Convergence matches sequential SGD statistically
but not bit-for-bit.

Three optimizer tiers (fastest applicable wins):

1. **dense** (N <= SPH_UMAP_DENSE_MAX, default 4096): the membership
   schedule lives on a dense [N, N] grid; attraction keeps exact per-edge
   scheduling semantics, and negative sampling is replaced by its
   *expectation* over the uniform negative distribution — the full
   repulsive field, computed as dense elementwise math plus one tiny
   [N, 2] x [2, N] matmul.  No gathers, no scatters: the round-3 edge-list
   kernel measured 73 ms/epoch at N=1934 (38·E gathered/scattered elements
   per epoch at ~100 M elem/s); this tier is pure arithmetic.
2. **rows** (any N): scatter-free padded-row formulation.  The fuzzy-union
   membership is symmetric, so each directed edge's head-update and its
   mirror's tail-update coincide — every row accumulates its own update as
   a lane reduction over its neighbor slots (no `.at[].add` scatters), and
   sampled negatives only ever push the row itself.
3. **edges** (SPH_UMAP_EDGE_PATH=1): the round-3 gather/scatter edge-list
   kernel, kept as the semantics oracle for A/B tests.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sparse import SparseRows, symmetrize_umap
from ..utils.logging import Log


@dataclass
class UmapParameters:
    """Reference: EmbedUmap.hpp:17-23 + umappp::Options defaults."""

    num_epochs: int = 500
    output_dims: int = 2
    min_dist: float = 0.1
    spread: float = 1.0
    negative_sample_rate: int = 5
    initial_alpha: float = 1.0
    seed: int = 123456
    preset_embedding: bool = False


def find_ab(spread: float = 1.0, min_dist: float = 0.1) -> tuple[float, float]:
    """Fit the 1/(1 + a d^{2b}) curve to the target exp decay (reference:
    umappp::find_ab / umap-learn find_ab_params)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def choose_num_epochs(requested: int, n: int) -> int:
    """Reference: umappp::choose_num_epochs — requested if >= 0, else 500
    for small data, 200 for large."""
    if requested >= 0:
        return requested
    return 500 if n < 10_000 else 200


def make_epochs_per_sample(weights: np.ndarray, n_epochs: int) -> np.ndarray:
    """Reference: umappp similarities_to_epochs / umap-learn
    make_epochs_per_sample: an edge of weight w is sampled every
    w_max / w epochs."""
    w_max = weights.max()
    out = np.full(weights.shape, np.inf, dtype=np.float64)
    n_samples = n_epochs * (weights / w_max)
    ok = n_samples > 0
    out[ok] = n_epochs / n_samples[ok]
    return out


@functools.partial(jax.jit, static_argnames=("neg_rate",))
def _epoch_update(y, src, dst, eps, next_sample, epoch, alpha, a, b, key,
                  n_valid, neg_rate: int):
    """One batched optimization epoch over all scheduled edges.

    Split-coordinate formulation: all per-edge gathers/scatters are 1-D
    (`y0[src]`, `y0.at[src].add`) — an [E, 2] gather output can tile-pad
    the minor dim 2 (same reasoning as the t-SNE attraction, models/tsne.py
    `_neighbor_diffs`)."""
    active = next_sample <= epoch
    y0, y1 = y[:, 0], y[:, 1]

    d0 = y0[src] - y0[dst]
    d1 = y1[src] - y1[dst]
    d2 = d0 * d0 + d1 * d1

    # attractive (umap-learn rdist gradient)
    gc = jnp.where(d2 > 0,
                   (-2.0 * a * b * d2 ** (b - 1.0))
                   / (a * d2 ** b + 1.0), 0.0)
    amask = jnp.where(active, alpha, 0.0)
    s0 = amask * jnp.clip(gc * d0, -4.0, 4.0)
    s1 = amask * jnp.clip(gc * d1, -4.0, 4.0)
    y0 = y0.at[src].add(s0).at[dst].add(-s0)
    y1 = y1.at[src].add(s1).at[dst].add(-s1)

    # negative sampling: neg_rate random targets per active edge
    for r in range(neg_rate):
        k = jax.random.fold_in(key, r)
        negs = jax.random.randint(k, src.shape, 0, n_valid)
        n0 = y0[src] - y0[negs]
        n1 = y1[src] - y1[negs]
        d2n = n0 * n0 + n1 * n1
        gcn = (2.0 * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0))
        # coincident negative pairs (d2n == 0) get the constant +4 push per
        # dimension, matching umap-learn's else-branch (gcn is always > 0
        # here, so branching on it would leave that arm dead)
        pos = d2n > 0
        dn0 = jnp.where(pos, jnp.clip(gcn * n0, -4.0, 4.0), 4.0)
        dn1 = jnp.where(pos, jnp.clip(gcn * n1, -4.0, 4.0), 4.0)
        nmask = jnp.where(active & (negs != src), alpha, 0.0)
        y0 = y0.at[src].add(nmask * dn0)
        y1 = y1.at[src].add(nmask * dn1)

    next_sample = jnp.where(active, next_sample + eps, next_sample)
    return jnp.stack([y0, y1], axis=1), next_sample


@functools.partial(jax.jit, static_argnames=("neg_rate", "epochs"))
def _run_epochs_scan(y, src, dst, eps, next_sample, epoch0, n_epochs_total,
                     initial_alpha, a, b, key, n_valid, neg_rate: int,
                     epochs: int):
    """`epochs` epoch updates fused into one device program (lax.scan):
    a per-epoch Python dispatch would add its host latency to every
    epoch."""
    def body(carry, i):
        y, next_sample = carry
        epoch = epoch0 + i
        ef = epoch.astype(jnp.float32)
        alpha = initial_alpha * (1.0 - ef / n_epochs_total)
        y, next_sample = _epoch_update(
            y, src, dst, eps, next_sample, ef, alpha, a, b,
            jax.random.fold_in(key, epoch), n_valid, neg_rate)
        return (y, next_sample), None

    (y, next_sample), _ = jax.lax.scan(body, (y, next_sample),
                                       jnp.arange(epochs), length=epochs)
    return y, next_sample


def _attract_coeff(d2, a, b):
    """umap-learn attractive gradient coefficient (rdist form)."""
    return jnp.where(d2 > 0,
                     (-2.0 * a * b * d2 ** (b - 1.0))
                     / (a * d2 ** b + 1.0), 0.0)


def _pack_positions(y0, y1):
    """u16 fixed-point packing over the live bbox: both coordinates fetched
    with ONE f32 gather per entry (same trick and rationale as the t-SNE
    attraction, models/tsne.py _attractive_forces: half the gathered
    elements, and fixed-point error span/65536 is
    uniform in absolute terms, which a difference-consuming force kernel
    requires — bf16's |y|-proportional error is not)."""
    lo0 = jnp.min(y0)
    lo1 = jnp.min(y1)
    s0 = jnp.maximum(jnp.max(y0) - lo0, 1e-30) / 65535.0
    s1 = jnp.maximum(jnp.max(y1) - lo1, 1e-30) / 65535.0
    q0 = jnp.round((y0 - lo0) / s0).astype(jnp.uint32)
    q1 = jnp.round((y1 - lo1) / s1).astype(jnp.uint32)
    table = jax.lax.bitcast_convert_type((q0 << 16) | q1, jnp.float32)
    return table, (lo0, s0, lo1, s1)


def _unpack_positions(g, prm):
    lo0, s0, lo1, s1 = prm
    u = jax.lax.bitcast_convert_type(g, jnp.uint32)
    return ((u >> 16).astype(jnp.float32) * s0 + lo0,
            (u & jnp.uint32(0xffff)).astype(jnp.float32) * s1 + lo1)


@functools.partial(jax.jit, static_argnames=("neg_rate", "epochs",
                                             "packed", "neg_budget"))
def _run_epochs_rows(y, nbr, eps, next_sample, epoch0, limit,
                     n_epochs_total, initial_alpha, a, b, key, n_valid,
                     neg_rate: int, epochs: int, packed: bool = True,
                     neg_budget: int = 0):
    """Scatter-free padded-row epochs (tier 2).

    nbr: [N, W] neighbor ids (-1 pad); eps: [N, W] epochs-per-sample
    (+inf pad); next_sample: [N, W].  Requires a *symmetric* membership
    (guaranteed by the fuzzy union): edge (i,j)'s tail-update equals the
    mirror edge (j,i)'s head-update, so summing each row's own head-updates
    over its W slots reproduces the edge-list scatter totals exactly.
    Negative samples are drawn per active edge slot (neg_rate per slot,
    matching umap-learn's per-edge loop) and applied to the row itself,
    from the post-attraction positions like the edge kernel.

    neg_budget > 0 replaces the per-slot draws with a BUDGETED sampled
    expectation: `neg_budget` uniform negatives per row, their mean
    clipped-repulsion scaled by the row's true draw count (active slots x
    neg_rate).  Same estimator as umap-learn's per-edge sampling — the
    per-draw expectation is identical, only the Monte-Carlo sample count
    differs — but the dominant [N, W*neg_rate] gather+pow cost drops to
    [N, neg_budget] (W is the PADDED hub width; most rows have far fewer
    active edges, so per-slot draws mostly sample masked zeros).
    Validated against the sequential per-edge oracle by the 28k-component
    anchor (scripts/anchor_umap_salinas.py).

    Epochs >= `limit` are masked no-ops, so callers always dispatch
    fixed-length scans — one compiled executable per (N, W) bucket.
    """
    n, w = nbr.shape
    safe = jnp.where(nbr >= 0, nbr, 0)

    def body(carry, i):
        y, next_sample = carry
        epoch = epoch0 + i
        ef = epoch.astype(jnp.float32)
        live = epoch < limit
        alpha = jnp.where(live,
                          initial_alpha * (1.0 - ef / n_epochs_total), 0.0)
        ekey = jax.random.fold_in(key, epoch)

        active = next_sample <= ef                       # [N, W]
        y0, y1 = y[:, 0], y[:, 1]
        if packed:
            table, prm = _pack_positions(y0, y1)
            n0, n1 = _unpack_positions(table[safe], prm)
        else:
            n0 = y0[safe]                                # major-axis gather
            n1 = y1[safe]
        d0 = y0[:, None] - n0
        d1 = y1[:, None] - n1
        d2 = d0 * d0 + d1 * d1
        gc = _attract_coeff(d2, a, b)
        s0 = jnp.clip(gc * d0, -4.0, 4.0)
        s1 = jnp.clip(gc * d1, -4.0, 4.0)
        # head-update of (i, j) plus tail-update of (j, i): the tail term
        # -clip(gc * (y_j - y_i)) equals +clip(gc * (y_i - y_j)) -> 2x
        att0 = 2.0 * jnp.sum(jnp.where(active, s0, 0.0), axis=1)
        att1 = 2.0 * jnp.sum(jnp.where(active, s1, 0.0), axis=1)
        y0m = y0 + alpha * att0
        y1m = y1 + alpha * att1

        nw = neg_budget if neg_budget > 0 else w * neg_rate
        negs = jax.random.randint(ekey, (n, nw), 0, n_valid)
        if packed:
            tbl_m, prm_m = _pack_positions(y0m, y1m)
            g0, g1 = _unpack_positions(tbl_m[negs], prm_m)
        else:
            g0 = y0m[negs]
            g1 = y1m[negs]
        e0 = y0m[:, None] - g0
        e1 = y1m[:, None] - g1
        e2 = e0 * e0 + e1 * e1
        gcn = (2.0 * b) / ((0.001 + e2) * (a * e2 ** b + 1.0))
        pos = e2 > 0
        r0 = jnp.where(pos, jnp.clip(gcn * e0, -4.0, 4.0), 4.0)
        r1 = jnp.where(pos, jnp.clip(gcn * e1, -4.0, 4.0), 4.0)
        rows = jax.lax.broadcasted_iota(jnp.int32, negs.shape, 0)
        if neg_budget > 0:
            # self draws contribute zero but consume a draw (umap-learn
            # semantics), so the mean keeps them as zeros
            notself = negs != rows
            cnt = jnp.sum(active, axis=1).astype(jnp.float32) * neg_rate
            scale = cnt / jnp.float32(nw)
            rep0 = scale * jnp.sum(jnp.where(notself, r0, 0.0), axis=1)
            rep1 = scale * jnp.sum(jnp.where(notself, r1, 0.0), axis=1)
        else:
            nmask = (jnp.repeat(active, neg_rate, axis=1)
                     & (negs != rows))
            rep0 = jnp.sum(jnp.where(nmask, r0, 0.0), axis=1)
            rep1 = jnp.sum(jnp.where(nmask, r1, 0.0), axis=1)
        y = jnp.stack([y0m + alpha * rep0, y1m + alpha * rep1], axis=1)
        next_sample = jnp.where(active & live, next_sample + eps,
                                next_sample)
        return (y, next_sample), None

    (y, next_sample), _ = jax.lax.scan(body, (y, next_sample),
                                       jnp.arange(epochs), length=epochs)
    return y, next_sample


@functools.partial(jax.jit, static_argnames=("neg_rate", "epochs"))
def _run_epochs_dense(y, eps_dense, next_sample, epoch0, limit,
                      n_epochs_total, initial_alpha, a, b, n_valid,
                      neg_rate: int, epochs: int):
    """Dense small-N epochs (tier 1).

    eps_dense/next_sample: [N, N] with +inf where no edge (so pads and
    non-edges never activate).  Attraction keeps the exact per-edge
    epochs_per_sample scheduling.  Negative sampling is replaced by its
    expectation: a head with c = active_count * neg_rate draws this epoch
    receives c/N times the sum of the clipped repulsive force over ALL
    candidate nodes (self excluded — a self draw contributes zero in
    umap-learn).  Deterministic, variance-free, and pure elementwise math;
    validated by the trustworthiness anchor (tests/test_umap_anchor.py).

    Epochs >= `limit` are masked no-ops (fixed-length dispatch shapes).
    """
    n = y.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    jota = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    notself = iota != jota
    valid_col = jota < n_valid

    def body(carry, i):
        y, next_sample = carry
        epoch = epoch0 + i
        ef = epoch.astype(jnp.float32)
        live = epoch < limit
        alpha = jnp.where(live,
                          initial_alpha * (1.0 - ef / n_epochs_total), 0.0)

        active = next_sample <= ef                       # [N, N]
        y0, y1 = y[:, 0], y[:, 1]
        d0 = y0[:, None] - y0[None, :]
        d1 = y1[:, None] - y1[None, :]
        d2 = d0 * d0 + d1 * d1
        gc = _attract_coeff(d2, a, b)
        s0 = jnp.clip(gc * d0, -4.0, 4.0)
        s1 = jnp.clip(gc * d1, -4.0, 4.0)
        att0 = 2.0 * jnp.sum(jnp.where(active, s0, 0.0), axis=1)
        att1 = 2.0 * jnp.sum(jnp.where(active, s1, 0.0), axis=1)
        y0m = y0 + alpha * att0
        y1m = y1 + alpha * att1

        e0 = y0m[:, None] - y0m[None, :]
        e1 = y1m[:, None] - y1m[None, :]
        e2 = e0 * e0 + e1 * e1
        gcn = (2.0 * b) / ((0.001 + e2) * (a * e2 ** b + 1.0))
        pos = e2 > 0
        r0 = jnp.where(pos, jnp.clip(gcn * e0, -4.0, 4.0), 4.0)
        r1 = jnp.where(pos, jnp.clip(gcn * e1, -4.0, 4.0), 4.0)
        rmask = notself & valid_col
        cnt = jnp.sum(active, axis=1).astype(jnp.float32) * neg_rate
        scale = cnt / jnp.maximum(n_valid.astype(jnp.float32), 1.0)
        rep0 = scale * jnp.sum(jnp.where(rmask, r0, 0.0), axis=1)
        rep1 = scale * jnp.sum(jnp.where(rmask, r1, 0.0), axis=1)
        y = jnp.stack([y0m + alpha * rep0, y1m + alpha * rep1], axis=1)
        next_sample = jnp.where(active & live, next_sample + eps_dense,
                                next_sample)
        return (y, next_sample), None

    (y, next_sample), _ = jax.lax.scan(body, (y, next_sample),
                                       jnp.arange(epochs), length=epochs)
    return y, next_sample


class UmapComputation:
    """Reference: sph/EmbedUmap.hpp:34 UmapComputation."""

    def __init__(self, params: Optional[UmapParameters] = None):
        self.params = params or UmapParameters()
        self._p: Optional[SparseRows] = None
        self._graph = None
        self._n = 0
        self._embedding: Optional[np.ndarray] = None
        self._preset_memberships: Optional[SparseRows] = None
        self._preset = False
        self._should_stop = False
        self.current_epoch = 0

    # ------------------------------------------------------------------

    def set_neighbor_matrix(self, p: SparseRows):
        """probdist path (reference: setNeighborMatrix) — similarities
        already computed upstream; combined with fuzzy union here."""
        self._p = p
        self._graph = None
        self._n = p.num_rows
        self._preset = False

    def set_neighbor_graph(self, indices: np.ndarray, distances: np.ndarray):
        """distance-graph path (reference: setNeighborGraph) — smooth-knn
        similarities are computed here like umappp::initialize."""
        self._graph = (indices, distances)
        self._p = None
        self._n = indices.shape[0]
        self._preset = False

    def set_memberships(self, m: SparseRows):
        """Supply ALREADY-SYMMETRIZED fuzzy memberships directly, skipping
        the fuzzy union (for callers that hold the final symmetric rows —
        e.g. anchor harnesses feeding both optimizers identical inputs)."""
        self._p = None
        self._graph = None
        self._preset_memberships = m
        self._n = m.num_rows

    def set_initial_embedding(self, emb: np.ndarray):
        if emb.shape[0] != self._n:
            Log.warn("UmapComputation: initial embedding wrong size, "
                     "ignoring")
            return
        self._embedding = np.asarray(emb, np.float32).copy()
        self._preset = True

    def stop(self):
        self._should_stop = True

    # ------------------------------------------------------------------

    def _memberships(self) -> SparseRows:
        if getattr(self, "_preset_memberships", None) is not None:
            return self._preset_memberships
        if self._p is not None:
            # fuzzy union (reference: combine_neighbor_sets with mix 0.5 ->
            # umappp applies the fuzzy set union)
            return symmetrize_umap(self._p)
        import jax.numpy as jnp2
        from ..ops.distributions import smooth_knn_distributions
        idx, dist = self._graph
        mask = idx >= 0
        mask = mask.copy()
        mask[:, 0] = False  # self edge
        sims = smooth_knn_distributions(jnp2.asarray(dist),
                                        jnp2.asarray(mask))
        rows = SparseRows(np.where(mask, idx, -1).astype(np.int32),
                          np.asarray(sims), self._n)
        return symmetrize_umap(rows)

    def _init_embedding(self, memberships: SparseRows):
        if self._preset and self._embedding is not None:
            return
        from ..ops.math import spectral_embedding
        # build padded [N, K] idx/dist-like arrays for the laplacian; use
        # membership weights as affinities
        idx = np.concatenate(
            [np.arange(self._n, dtype=np.int32)[:, None],
             memberships.indices], axis=1)
        val = np.concatenate(
            [np.zeros((self._n, 1), np.float32), memberships.values], axis=1)
        emb, ok = spectral_embedding(idx, val, self.params.output_dims)
        if not ok:
            Log.warn("UmapComputation: spectral init failed, random "
                     "fallback (reference: EmbedUmap.cpp:192-202)")
        rng = np.random.default_rng(self.params.seed)
        noise = rng.standard_normal(emb.shape).astype(np.float32) * 1e-4
        self._embedding = emb + noise

    def init_optimization(self):
        """Prepare memberships, layout init and the edge schedule
        (reference: initProbabilityDistribution, :52-231)."""
        m = self._memberships()
        self._init_embedding(m)

        self._a, self._b = find_ab(self.params.spread, self.params.min_dist)
        self._n_epochs = choose_num_epochs(self.params.num_epochs, self._n)
        Log.info("UMAP: a=%.4f b=%.4f epochs=%d", self._a, self._b,
                 self._n_epochs)

        mask = np.asarray(m.mask & (m.values > 0))
        m_idx = np.asarray(m.indices)
        m_val = np.asarray(m.values)
        eps_flat = make_epochs_per_sample(
            np.where(mask, m_val, 0.0)[mask], self._n_epochs
        ).astype(np.float32)

        edge_path = os.environ.get("SPH_UMAP_EDGE_PATH") == "1"
        dense_max = int(os.environ.get("SPH_UMAP_DENSE_MAX", "4096"))
        self._tier = ("edges" if edge_path
                      else "dense" if self._n <= dense_max else "rows")
        Log.info("UMAP: optimizer tier %s (n=%d)", self._tier, self._n)

        # pow2 bucketing: pad N (and the row width) to the next power of
        # two so shrinking eval levels reuse the same compiled scan
        # executables; pad rows/slots carry eps=+inf and never activate
        from ..ops.bucketing import next_pow2
        self._npad = next_pow2(self._n, lo=64)

        if self._tier == "dense":
            src = np.broadcast_to(np.arange(self._n)[:, None],
                                  m_idx.shape)[mask]
            dst = m_idx[mask]
            epsd = np.full((self._npad, self._npad), np.inf, np.float32)
            epsd[src, dst] = eps_flat
            self._eps = jnp.asarray(epsd)
            self._next_sample = jnp.asarray(epsd)
        elif self._tier == "rows":
            # hub-width cap: the attraction pass costs [N, W] gathers+pows
            # per epoch with W the PADDED hub width (observed 1056 at
            # Salinas level 1 against mean nnz 54).  Keep each row's top
            # `cap` edges by membership: the shed tail has the LARGEST
            # epochs_per_sample (faintest memberships, hence least-often
            # sampled edges), the same principled truncation as the
            # t-SNE attraction width cap (SPH_TSNE_GRID_P_WIDTH).
            cap = int(os.environ.get("SPH_UMAP_ROWS_WIDTH", "128"))
            m_idx_r, m_val_r, mask_r = m_idx, m_val, mask
            if 0 < cap < m_idx.shape[1]:
                vals = np.where(mask, m_val, -np.inf)
                order = np.argsort(-vals, axis=1, kind="stable")[:, :cap]
                rr = np.arange(m_idx.shape[0])[:, None]
                m_idx_r = np.where(np.isfinite(vals[rr, order]),
                                   m_idx[rr, order], -1)
                m_val_r = np.where(m_idx_r >= 0, m_val[rr, order], 0.0)
                mask_r = m_idx_r >= 0
                kept = float(m_val_r.sum()) / max(float(
                    np.where(mask, m_val, 0.0).sum()), 1e-30)
                Log.info("UMAP rows tier: width cap %d -> %d keeps %.2f%% "
                         "of membership mass", m_idx.shape[1], cap,
                         100.0 * kept)
                eps_flat = make_epochs_per_sample(
                    m_val_r[mask_r], self._n_epochs).astype(np.float32)
            wpad = next_pow2(m_idx_r.shape[1], lo=8)
            eps_rows = np.full((self._npad, wpad), np.inf, np.float32)
            eps_rows[:self._n, :m_idx_r.shape[1]][mask_r] = eps_flat
            nbr = np.full((self._npad, wpad), -1, np.int32)
            nbr[:self._n, :m_idx_r.shape[1]] = np.where(mask_r, m_idx_r, -1)
            self._nbr = jnp.asarray(nbr)
            self._eps = jnp.asarray(eps_rows)
            self._next_sample = jnp.asarray(eps_rows)
        else:
            src = np.broadcast_to(np.arange(self._n)[:, None],
                                  m_idx.shape)[mask].astype(np.int32)
            dst = m_idx[mask].astype(np.int32)
            self._src = jnp.asarray(src)
            self._dst = jnp.asarray(dst)
            self._eps = jnp.asarray(eps_flat)
            self._next_sample = jnp.asarray(eps_flat.copy())

        if self._tier in ("dense", "rows") and self._npad > self._n:
            emb = np.zeros((self._npad, 2), np.float32)
            emb[:self._n] = self._embedding
            self._y = jnp.asarray(emb)
        else:
            self._y = jnp.asarray(self._embedding)
        self._key = jax.random.PRNGKey(self.params.seed)
        # hoist the per-dispatch scalar uploads: each tiny host->device
        # constant is a round trip
        self._const = (jnp.float32(self._n_epochs),
                       jnp.float32(self.params.initial_alpha),
                       jnp.float32(self._a), jnp.float32(self._b))
        self._n_dev = jnp.int32(self._n)
        self.current_epoch = 0
        self._initialized = True

    def _dispatch_cost(self) -> int:
        """Per-epoch work units for the dispatch chunker."""
        if self._tier == "dense":
            return 2 * self._n * self._n
        if self._tier == "rows":
            return int(self._nbr.shape[0] * self._nbr.shape[1]
                       * (1 + self.params.negative_sample_rate))
        return int(self._src.shape[0]
                   * (1 + self.params.negative_sample_rate))

    def run_for_epochs(self, epochs: int):
        """Incremental optimization (reference:
        runGradientDescentForEpochs, :271-287)."""
        if not getattr(self, "_initialized", False):
            self.init_optimization()
        end = min(self.current_epoch + epochs, self._n_epochs)
        # chunk epochs per device program: bounded work per program
        # while amortizing the
        # per-dispatch latency over many epochs; same budget scheme as
        # t-SNE's continue_gradient_descent
        budget = int(os.environ.get("SPH_UMAP_DISPATCH_BUDGET",
                                    str(1 << 30)))
        per_dispatch = max(1, budget // max(self._dispatch_cost(), 1))
        # fixed-length dispatches: every scan has length per_dispatch (pow2)
        # with epochs >= `limit` masked to no-ops inside the kernel — one
        # compiled executable per (N, W) bucket regardless of epoch totals
        per_dispatch = 1 << max(per_dispatch.bit_length() - 1, 0)
        limit = jnp.int32(end)
        packed = os.environ.get("SPH_UMAP_PACKED", "1") != "0"
        while self.current_epoch < end:
            if self._should_stop:
                break
            # cap by pow2-ceil of the remaining span so incremental small
            # calls don't dispatch a mostly-masked full-size scan
            remaining = end - self.current_epoch
            step = min(per_dispatch,
                       1 << max((remaining - 1).bit_length(), 0))
            common = (jnp.int32(self.current_epoch), limit, *self._const)
            if self._tier == "dense":
                self._y, self._next_sample = _run_epochs_dense(
                    self._y, self._eps, self._next_sample, *common,
                    self._n_dev,
                    self.params.negative_sample_rate, step)
            elif self._tier == "rows":
                # budgeted negative sampling: per-slot draws cost
                # [N, W*neg_rate] gathers+pows where W is the padded hub
                # width; a 64-draw sampled expectation per row is the
                # same estimator at a fraction of the cost (see
                # _run_epochs_rows).  0 restores per-slot draws.
                budget = int(os.environ.get("SPH_UMAP_NEG_BUDGET", "64"))
                w_pad = self._nbr.shape[1]
                if budget >= w_pad * self.params.negative_sample_rate:
                    budget = 0
                self._y, self._next_sample = _run_epochs_rows(
                    self._y, self._nbr, self._eps, self._next_sample,
                    *common, self._key, self._n_dev,
                    self.params.negative_sample_rate, step,
                    packed=packed, neg_budget=budget)
            else:
                self._y, self._next_sample = _run_epochs_scan(
                    self._y, self._src, self._dst, self._eps,
                    self._next_sample, jnp.int32(self.current_epoch),
                    *self._const, self._key, self._n_dev,
                    self.params.negative_sample_rate,
                    min(step, end - self.current_epoch))
            if self.current_epoch + step < end:
                jax.block_until_ready(self._y)
            self.current_epoch += step
        self.current_epoch = min(self.current_epoch, end)
        self._embedding = np.asarray(self._y)[:self._n]

    def compute(self):
        """Reference: UmapComputation::compute (:289-300)."""
        if self._n == 1:
            self._embedding = np.zeros((1, 2), np.float32)
            return
        self._should_stop = False
        self._initialized = False
        self.init_optimization()
        self.run_for_epochs(self._n_epochs)

    # ------------------------------------------------------------------

    @property
    def embedding(self) -> np.ndarray:
        return self._embedding
