"""t-SNE gradient descent.

Reference: sph/EmbedTsne.cpp — HDILib `SparseTSNEUserDefProbabilities`
(CPU Barnes-Hut with theta = min(0.5, max(0, (N-1000)*5e-5)),
EmbedTsne.cpp:165-178) or the `GradientDescentTSNETexture` GL compute shader
(the reference's only accelerator path); exaggeration factor
clamp(4 + N/60000, 4, 20) (:138-139); chunked iteration driver
(ComputeEmbedding.cpp:85-129).

Redesign: Barnes-Hut trees are pointer-chasing and serialize badly on an
accelerator; the repulsive force is instead computed *exactly*.  Up to
SPH_TSNE_DENSE_P_MAX points the joint P is held dense and one fused pass
per iteration (`_dense_forces`) streams it once, computing the Student-t
weights on the fly for both the attractive and the repulsive sums.  Above
that, the sparse attractive term gathers fixed-width P rows and the
repulsion is tiled [block, N] Student-t weight blocks (`_repulsive_forces`)
or, past SPH_TSNE_GRID_MIN, grid-interpolated (ops/tsne_grid.py).  Exact
repulsion also *improves* on the reference: no theta approximation error.
Momentum/gains/eta and the exaggeration schedule follow HDILib's
TsneParameters defaults (minimum_gain 0.1, eta 200, momentum 0.2 -> 0.8 at
iteration 250, exaggeration removed at 250 with exponential decay over
150).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sparse import SparseRows
from ..utils.logging import Log


@dataclass
class TsneParameters:
    """HDILib hdi::dr::TsneParameters defaults (wired through
    TsneEmbeddingParameters, EmbedTsne.hpp:37-46)."""

    perplexity: float = 30.0
    perplexity_multiplier: int = 3
    num_iterations: int = 1000
    eta: float = 200.0
    momentum: float = 0.2
    final_momentum: float = 0.8
    mom_switching_iter: int = 250
    exaggeration_factor: float = 4.0     # overridden by N-dependent clamp
    remove_exaggeration_iter: int = 250
    exponential_decay_iter: int = 150
    minimum_gain: float = 0.1
    embedding_dims: int = 2


def default_exaggeration(num_points: int) -> float:
    """Reference: EmbedTsne.cpp:138-139."""
    return float(np.clip(4.0 + num_points / 60_000.0, 4.0, 20.0))


@dataclass
class TsneState:
    embedding: jax.Array      # [Np, 2]
    velocity: jax.Array       # [Np, 2]
    gain: jax.Array           # [Np, 2]
    iteration: int


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(jax.jit, static_argnames=("block",))
def _repulsive_forces(y: jax.Array, n_valid, block: int):
    """Exact O(N^2) Student-t repulsion, tiled.

    Returns (rep [Np, 2] = sum_j w_ij^2 (y_i - y_j), Z = sum_{i != j} w_ij).
    Pad rows (>= n_valid) contribute nothing.
    """
    npad, dim = y.shape
    num_blocks = npad // block
    sq = jnp.sum(y * y, axis=1)
    col_valid = (jax.lax.broadcasted_iota(jnp.int32, (1, npad), 1)
                 < n_valid)

    def row_block(rb):
        yb = jax.lax.dynamic_slice_in_dim(y, rb * block, block)
        sqb = jax.lax.dynamic_slice_in_dim(sq, rb * block, block)
        # HIGHEST: default-precision f32 dots may multiply in bf16/TF32,
        # and the |x|^2+|y|^2-2xy expansion amplifies that to ~0.3% in d2.
        d2 = (sqb[:, None] + sq[None, :]
              - 2.0 * jnp.dot(yb, y.T, preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST))
        w = 1.0 / (1.0 + jnp.maximum(d2, 0.0))
        row_ids = (jax.lax.broadcasted_iota(jnp.int32, w.shape, 0)
                   + rb * block)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, w.shape, 1)
        valid = (col_ids != row_ids) & col_valid & (row_ids < n_valid)
        w = jnp.where(valid, w, 0.0)
        z_part = jnp.sum(w)
        w2 = w * w
        s2 = jnp.sum(w2, axis=1)
        rep = s2[:, None] * yb - jnp.dot(
            w2, y, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        return rep, z_part

    with jax.named_scope("tsne_repulsion"):
        rep, z_parts = jax.lax.map(row_block, jnp.arange(num_blocks))
    return rep.reshape(npad, dim), jnp.sum(z_parts)


@functools.partial(jax.jit, static_argnames=("block",))
def _dense_forces(y: jax.Array, p_dense: jax.Array, n_valid, block: int):
    """Fused attraction + exact repulsion over a DENSE joint P.

    y [Npad, 2], p_dense [Npad, Npad] (zero off-support and on pads) ->
    (attr [Npad, 2] = sum_j p_ij w_ij (y_i - y_j),
     rep [Npad, 2] = sum_j w_ij^2 (y_i - y_j),  Z = sum_{i != j} w_ij).

    Each [block, Npad] row tile is elementwise work feeding five row sums,
    which XLA emits as one multi-output reduction fusion: P is read once
    per iteration and no [N, N] intermediate reaches device memory.  The
    pass is bound by the P read (Npad^2 * 4 bytes), so Npad should be the
    smallest multiple of `block` that holds the points.
    """
    npad = y.shape[0]
    yx, yy = y[:, 0], y[:, 1]
    col_ok = jax.lax.broadcasted_iota(jnp.int32, (1, npad), 1) < n_valid

    def row_block(rb):
        r0 = rb * block
        rx = jax.lax.dynamic_slice_in_dim(yx, r0, block)[:, None]
        ry = jax.lax.dynamic_slice_in_dim(yy, r0, block)[:, None]
        p = jax.lax.dynamic_slice_in_dim(p_dense, r0, block)
        dx = rx - yx[None, :]
        dy = ry - yy[None, :]
        rows = jax.lax.broadcasted_iota(jnp.int32, (block, npad), 0) + r0
        cols = jax.lax.broadcasted_iota(jnp.int32, (block, npad), 1)
        valid = (cols != rows) & col_ok & (rows < n_valid)
        w = jnp.where(valid, 1.0 / (1.0 + dx * dx + dy * dy), 0.0)
        pw = jnp.where(valid, p, 0.0) * w
        w2 = w * w
        return (jnp.sum(pw * dx, axis=1), jnp.sum(pw * dy, axis=1),
                jnp.sum(w2 * dx, axis=1), jnp.sum(w2 * dy, axis=1),
                jnp.sum(w, axis=1))

    with jax.named_scope("tsne_dense_forces"):
        ax, ay, rx, ry, zrow = jax.lax.map(row_block,
                                           jnp.arange(npad // block))
    attr = jnp.stack([ax.reshape(npad), ay.reshape(npad)], axis=1)
    rep = jnp.stack([rx.reshape(npad), ry.reshape(npad)], axis=1)
    return attr, rep, jnp.sum(zrow)


def _neighbor_diffs(y: jax.Array, p_idx: jax.Array):
    """Per-coordinate neighbor differences over P's support.

    Returns (d0, d1, w): [Np, R] each — y_i - y_j split by coordinate and
    the Student-t weight 1/(1+|d|^2).  Never materializes an [Np, R, 2]
    gather output: a tiled layout can pad the minor dim 2 up to a full
    tile.  1-D dim-0 gathers keep every intermediate at [Np, R]."""
    idx = jnp.maximum(p_idx, 0)
    d0 = y[:, 0:1] - y[:, 0][idx]
    d1 = y[:, 1:2] - y[:, 1][idx]
    w = 1.0 / (1.0 + d0 * d0 + d1 * d1)
    return d0, d1, w


@functools.partial(jax.jit, static_argnames=("packed",))
def _attractive_forces(y: jax.Array, p_idx: jax.Array, p_val: jax.Array,
                       packed: bool = False):
    """Sparse attraction: sum_j p_ij w_ij (y_i - y_j) over P's support.

    Above ~33M P entries the row axis is chunked with lax.map: one fused
    gather+elementwise over the full [Np, R] extent produces multi-GB
    fusion buffers at N=1M, R=128.  Chunks bound every live buffer to
    ~34 MB while each chunk is still a large parallel pass.

    packed=True (the grid tier's default): both neighbor coordinates are
    fetched with ONE f32 gather per entry — (u16(y0), u16(y1)) fixed-point
    over the live bounding box, bitcast into a single f32 table and
    unpacked with 2-D integer ops (a [c, R, 2] intermediate could
    tile-pad the minor dim 2).  This halves the gathered element count of
    a gather-bound pass.

    Fixed-point, NOT bf16: quantization error must be uniform in
    *absolute* terms because the force kernel consumes position
    DIFFERENCES — close pairs carry the largest p_ij w_ij weights while
    |d| is small, so a floating quantizer's |y|-proportional error
    (~span/512 for bf16) dominates exactly there (measured: bf16 packing
    degraded 50k KL by 9%; u16 fixed-point over the bbox has error
    span/65536 and measures at exact-KL parity).  The error is far below
    the grid tier's own interpolation error and the reference's
    Barnes-Hut theta=0.5 cell approximation (sph/EmbedTsne.cpp:165-178)."""
    npts, width = p_idx.shape
    fuse_max = int(os.environ.get("SPH_TSNE_ATTR_FUSE_MAX", str(1 << 25)))
    if npts * width <= fuse_max and not packed:
        d0, d1, w = _neighbor_diffs(y, p_idx)
        coef = jnp.where(p_idx >= 0, p_val * w, 0.0)
        return jnp.stack([jnp.sum(coef * d0, axis=1),
                          jnp.sum(coef * d1, axis=1)], axis=1)

    chunk = max(((1 << 23) // width) // 8 * 8, 8)
    chunk = min(chunk, _ceil_to(npts, 8))
    cpad = ((npts + chunk - 1) // chunk) * chunk
    pi = jnp.pad(p_idx, ((0, cpad - npts), (0, 0)), constant_values=-1)
    pv = jnp.pad(p_val, ((0, cpad - npts), (0, 0)))
    yp = jnp.pad(y, ((0, cpad - npts), (0, 0)))
    y0, y1 = y[:, 0], y[:, 1]
    if packed:
        lo0, hi0 = jnp.min(y0), jnp.max(y0)
        lo1, hi1 = jnp.min(y1), jnp.max(y1)
        s0 = jnp.maximum(hi0 - lo0, 1e-30) / 65535.0
        s1 = jnp.maximum(hi1 - lo1, 1e-30) / 65535.0
        q0 = jnp.round((y0 - lo0) / s0).astype(jnp.uint32)
        q1 = jnp.round((y1 - lo1) / s1).astype(jnp.uint32)
        table = jax.lax.bitcast_convert_type((q0 << 16) | q1, jnp.float32)

    def one(cb):
        s = cb * chunk
        idx = jax.lax.dynamic_slice_in_dim(pi, s, chunk)
        val = jax.lax.dynamic_slice_in_dim(pv, s, chunk)
        yc = jax.lax.dynamic_slice_in_dim(yp, s, chunk)
        safe = jnp.maximum(idx, 0)
        if packed:
            g = jax.lax.bitcast_convert_type(table[safe], jnp.uint32)
            n0 = (g >> 16).astype(jnp.float32) * s0 + lo0
            n1 = (g & jnp.uint32(0xffff)).astype(jnp.float32) * s1 + lo1
        else:
            n0 = y0[safe]
            n1 = y1[safe]
        d0 = yc[:, 0:1] - n0
        d1 = yc[:, 1:2] - n1
        w = 1.0 / (1.0 + d0 * d0 + d1 * d1)
        coef = jnp.where(idx >= 0, val * w, 0.0)
        return jnp.stack([jnp.sum(coef * d0, axis=1),
                          jnp.sum(coef * d1, axis=1)], axis=1)

    out = jax.lax.map(one, jnp.arange(cpad // chunk, dtype=jnp.int32))
    return out.reshape(cpad, 2)[:npts]


@functools.partial(jax.jit, static_argnames=("block", "iters", "grid",
                                             "attr_packed"))
def tsne_iterations(y, vel, gain, it0, p_idx, p_val, n_valid,
                    params_vec, iters: int, block: int, p_dense=None,
                    grid: int = 0, attr_packed: bool = False):
    """Run `iters` gradient-descent steps (jitted inner loop).

    params_vec: [eta, momentum, final_momentum, mom_switch, exag_factor,
                 remove_exag, decay_iter, min_gain] as f32.
    p_dense: the [Np, Np] joint P; given, each step is one fused dense
    pass (`_dense_forces`, row tiles of `block`) and p_idx/p_val are
    unused.  Otherwise the sparse attraction over (p_idx, p_val) plus the
    tiled exact repulsion, or with grid > 0 the O(N) grid-interpolated
    repulsion (ops/tsne_grid.py) with `grid` nodes per dim — the large-N
    tier (reference intent: theta-scaled Barnes-Hut, EmbedTsne.cpp:165-178).
    """
    (eta, mom0, mom1, mom_switch, exag_f, remove_exag, decay_iter,
     min_gain) = [params_vec[i] for i in range(8)]

    def body(carry, _):
        y, vel, gain, it = carry
        itf = it.astype(jnp.float32)
        # exaggeration schedule: constant, then exponential decay to 1
        decay = jnp.exp(-4.6 * jnp.maximum(itf - remove_exag, 0.0)
                        / jnp.maximum(decay_iter, 1.0))
        exag = 1.0 + (exag_f - 1.0) * jnp.where(itf < remove_exag, 1.0,
                                                decay)
        momentum = jnp.where(itf < mom_switch, mom0, mom1)

        if p_dense is not None:
            attr, rep, z = _dense_forces(y, p_dense, n_valid, block)
        else:
            with jax.named_scope("tsne_attraction"):
                attr = _attractive_forces(y, p_idx, p_val, attr_packed)
            if grid > 0:
                from ..ops.tsne_grid import grid_repulsion
                rep, z = grid_repulsion(y, n_valid, grid)
            else:
                rep, z = _repulsive_forces(y, n_valid, block)
        grad = 4.0 * (exag * attr - rep / jnp.maximum(z, 1e-12))

        same_sign = jnp.sign(grad) == jnp.sign(vel)
        gain = jnp.where(same_sign, gain * 0.8, gain + 0.2)
        gain = jnp.maximum(gain, min_gain)
        vel = momentum * vel - eta * gain * grad
        y = y + vel
        row_valid = (jax.lax.broadcasted_iota(jnp.int32, y.shape, 0)
                     < n_valid)
        y = jnp.where(row_valid, y, 0.0)
        # zero-mean each iteration (bhtsne/HDILib do the same): per-point
        # gains break force symmetry, so without centering the whole cloud
        # acquires a runaway translation that destroys f32 precision
        mean = (jnp.sum(y, axis=0, keepdims=True)
                / jnp.maximum(n_valid.astype(jnp.float32), 1.0))
        y = jnp.where(row_valid, y - mean, 0.0)
        return (y, vel, gain, it + 1), None

    (y, vel, gain, it), _ = jax.lax.scan(body, (y, vel, gain, it0), None,
                                         length=iters)
    return y, vel, gain, it


@functools.partial(jax.jit, static_argnames=("block", "grid"))
def tsne_kl_divergence(y, p_idx, p_val, n_valid, block: int,
                       grid: int = 0):
    """KL(P || Q) over P's off-diagonal support: sum p log(p / q), q = w/Z.

    Self pairs are excluded and P renormalized over the remaining support:
    Q assigns no mass to i == j (Z sums i != j), so diagonal P mass — which
    the walks-as-distances path can carry when a merged walk row's self
    similarity is not its largest entry (same position-0-skip quirk as the
    reference's HDILibHelper beta search) — would otherwise make the
    quantity ill-defined (it exerts zero force on the embedding either
    way, diff_ii = 0)."""
    if grid > 0:
        from ..ops.tsne_grid import grid_repulsion
        _, z = grid_repulsion(y, n_valid, grid)
    else:
        _, z = _repulsive_forces(y, n_valid, block)
    _, _, w = _neighbor_diffs(y, p_idx)
    rows = jax.lax.broadcasted_iota(jnp.int32, p_idx.shape, 0)
    valid = (p_idx >= 0) & (p_val > 0) & (p_idx != rows)
    p_mass = jnp.sum(jnp.where(valid, p_val, 0.0))
    pn = p_val / jnp.maximum(p_mass, 1e-12)
    q = jnp.maximum(w / jnp.maximum(z, 1e-12), 1e-38)
    p = jnp.maximum(pn, 1e-38)
    kl = jnp.where(valid, pn * (jnp.log(p) - jnp.log(q)), 0.0)
    return jnp.sum(kl)


# The dense pass is one [Npad, Npad] tile while XLA reduces a row of that
# length in one pass (up to 16384 columns on the H100); longer rows are
# split into partial sums, and there equal row tiles of DENSE_TILE_ELEMS
# elements are faster than one tile (PERF.md: 0.42 ms one tile vs 0.66 ms
# tiled at n = 16384; 2.43 ms vs 2.17 ms at n = 28807).
DENSE_ONE_TILE_MAX = 16384
DENSE_TILE_ELEMS = 1 << 26


def dense_tiling(n: int) -> tuple[int, int]:
    """(row tile, Npad) of the dense pass for n points: one tile up to
    DENSE_ONE_TILE_MAX; above it Npad a multiple of the tile, the tile a
    multiple of 128, as few tiles as fit DENSE_TILE_ELEMS."""
    npad = _ceil_to(n, 128)
    if npad <= DENSE_ONE_TILE_MAX:
        return npad, npad
    tiles = -(-npad * npad // DENSE_TILE_ELEMS)
    rows = _ceil_to(-(-npad // tiles), 128)
    return rows, rows * tiles


def use_dense_p(n: int) -> bool:
    """Dense joint P (one fused pass per iteration) up to
    SPH_TSNE_DENSE_P_MAX points: the default 32768 bounds P at
    32768^2 * 4 bytes = 4.3 GB and covers level 1 of a 512x217 scene
    (28,807 components).  Above it the sparse attraction runs."""
    return n <= int(os.environ.get("SPH_TSNE_DENSE_P_MAX", "32768"))


class TsneComputation:
    """Reference: sph/EmbedTsne.hpp:62 TsneComputation — compute /
    continueGradientDescent / stop, with a probability distribution or a kNN
    graph as input."""

    def __init__(self, params: Optional[TsneParameters] = None,
                 block: int = 512):
        self.params = params or TsneParameters()
        self._block = block
        self._p: Optional[SparseRows] = None
        self._knn = None
        self._state: Optional[TsneState] = None
        self._n = 0
        self._initial_embedding: Optional[np.ndarray] = None
        self._should_stop = False
        self._initialized = False

    # ------------------------------------------------------------------

    def set_probability_distribution(self, p: SparseRows):
        """P must already be row-normalized / symmetrized upstream
        (reference: setProbabilityDistribution, EmbedTsne.cpp:294-301)."""
        self._p = p
        self._knn = None
        self._n = p.num_rows
        self._initialized = False

    def set_neighbor_graph(self, indices: np.ndarray, distances: np.ndarray):
        """Compute P from a kNN graph (reference: initProbabilityDistribution
        EmbedTsne.cpp:96-123 — Gaussian rows with the configured
        perplexity)."""
        self._knn = (indices, distances)
        self._p = None
        self._n = indices.shape[0]
        self._initialized = False

    def set_initial_embedding(self, emb: np.ndarray):
        if emb.shape[0] != self._n:
            Log.warn("TsneComputation: initial embedding has wrong size, "
                     "ignoring")
            return
        self._initial_embedding = np.asarray(emb, dtype=np.float32)

    def stop(self):
        self._should_stop = True

    def reset_stop(self):
        self._should_stop = False

    # ------------------------------------------------------------------

    def _ensure_p(self):
        if self._p is not None:
            return
        from ..ops.distributions import gaussian_row_distributions
        idx, dist = self._knn
        mask = idx >= 0
        # the reference feeds the graph's distances to the beta search as-is
        # (EmbedTsne.cpp:117 passes getKnnDistances() — already sqrt'd
        # euclidean unless L2squared was requested)
        p = gaussian_row_distributions(
            jnp.asarray(np.where(mask, dist, 0.0)), jnp.asarray(mask),
            jnp.float32(self.params.perplexity), ignore_first=True)
        p_rows = SparseRows(np.where(mask, idx, -1).astype(np.int32),
                            np.asarray(p), self._n)
        from ..ops.sparse import symmetrize_tsne
        self._p = symmetrize_tsne(p_rows)

    def _init_gradient_descent(self):
        self._ensure_p()
        # bound the padded P width: one hub row (a component linked by
        # thousands of neighbors after symmetrization) otherwise sets the
        # per-iteration attractive-force gather width for EVERY row.  Keep
        # the largest-probability entries; the dropped tail is negligible
        # attractive mass (the reference's Barnes-Hut approximates far more
        # aggressively).  SPH_TSNE_P_WIDTH_CAP=0 disables.
        cap = int(os.environ.get("SPH_TSNE_P_WIDTH_CAP", "1024"))
        if cap > 0 and self._p.width > cap:
            from ..ops.sparse import topk_rows
            before = self._p.row_sums().sum()
            self._p = topk_rows(self._p, cap)
            kept = self._p.row_sums().sum() / max(before, 1e-12)
            Log.info("t-SNE: P width capped to %d (%.4f%% of mass kept)",
                     cap, 100.0 * kept)
        n = self._n
        exag = default_exaggeration(n)
        self.params.exaggeration_factor = exag
        Log.info("t-SNE: exaggeration %.2f for %d iters, decay over %d",
                 exag, self.params.remove_exaggeration_iter,
                 self.params.exponential_decay_iter)

        use_dense = use_dense_p(n)

        # grid-interpolated repulsion tier for large N (exact O(N^2)
        # repulsion is ~0.1 iters/s at N=1M): auto above SPH_TSNE_GRID_MIN
        # unless forced.  SPH_TSNE_GRID: "1"/"0" force, else auto.
        grid_min = int(os.environ.get("SPH_TSNE_GRID_MIN", "32768"))
        grid_env = os.environ.get("SPH_TSNE_GRID", "auto")
        if grid_env == "0":
            use_grid = False
        elif grid_env == "1":
            use_grid = True
        else:
            use_grid = n > grid_min
        self._use_grid = use_grid
        if use_grid:
            use_dense = False
            Log.info("t-SNE: grid-interpolated repulsion (N=%d)", n)
            # the attraction gathers dominate the large-N tier; cap the
            # padded P width harder than the general 1024 cap.  Mean
            # symmetrized nnz at 1M is ~47 (k=31), so top-64-by-probability
            # keeps almost all attractive mass — only hub rows lose their
            # faint tail.
            gcap = int(os.environ.get("SPH_TSNE_GRID_P_WIDTH", "64"))
            if gcap > 0 and self._p.width > gcap:
                from ..ops.sparse import topk_rows
                before = self._p.row_sums().sum()
                self._p = topk_rows(self._p, gcap)
                kept = self._p.row_sums().sum() / max(before, 1e-12)
                Log.info("t-SNE grid tier: P width %d (%.2f%% mass kept)",
                         gcap, 100.0 * kept)
        # single-gather packed-bf16 neighbor fetch (see _attractive_forces):
        # default on for the grid tier, forceable either way
        packed_env = os.environ.get("SPH_TSNE_ATTR_PACKED", "auto")
        self._attr_packed = (packed_env == "1"
                             or (packed_env != "0" and use_grid))

        if use_dense:
            block, npad = dense_tiling(n)
        else:
            block = min(self._block, _ceil_to(n, 8))
            npad = _ceil_to(n, block)
        self._block_eff = block
        self._npad = npad

        if self._initial_embedding is None:
            from ..ops.math import random_disk_init
            self._initial_embedding = random_disk_init(n, 0.1, seed=0)
        y = np.zeros((npad, 2), dtype=np.float32)
        y[:n] = self._initial_embedding

        # P normalized so the whole matrix sums to 1 (HDILib joint-P
        # convention); rows arrive summing to ~1 each after symmetrization.
        # Stays on device: a device-resident P from the pipeline is padded
        # and normalized without a host round trip.
        idx_d, val_d = self._p.device()
        total = float(jnp.sum(jnp.where(idx_d >= 0, val_d, 0.0)))
        pv = val_d / max(total, 1e-12)
        from ..ops.bucketing import next_pow2
        wpad = next_pow2(self._p.width)
        w0 = self._p.width
        p_idx = jnp.pad(idx_d, ((0, npad - n), (0, wpad - w0)),
                        constant_values=-1)
        p_val = jnp.pad(pv, ((0, npad - n), (0, wpad - w0)),
                        constant_values=0.0)

        self._p_idx = p_idx
        self._p_val = p_val
        self._p_dense = None
        if use_dense:
            rows = jax.lax.broadcasted_iota(jnp.int32, p_idx.shape, 0)
            safe_idx = jnp.where(p_idx >= 0, p_idx, rows)
            masked_val = jnp.where(p_idx >= 0, p_val, 0.0)
            self._p_dense = (jnp.zeros((npad, npad), jnp.float32)
                             .at[rows, safe_idx].add(masked_val))
        self._state = TsneState(
            embedding=jnp.asarray(y),
            velocity=jnp.zeros((npad, 2), jnp.float32),
            gain=jnp.ones((npad, 2), jnp.float32),
            iteration=0)
        self._initialized = True

    def _params_vec(self) -> jax.Array:
        p = self.params
        return jnp.asarray([p.eta, p.momentum, p.final_momentum,
                            p.mom_switching_iter, p.exaggeration_factor,
                            p.remove_exaggeration_iter,
                            p.exponential_decay_iter, p.minimum_gain],
                           jnp.float32)

    def compute(self, iterations: Optional[int] = None, verbose: bool = True):
        """Reference: TsneComputation::compute (EmbedTsne.cpp:267-283)."""
        if self._n == 1:
            self._single_point()
            return
        self._should_stop = False
        if not self._initialized:
            self._init_gradient_descent()
        self.continue_gradient_descent(
            iterations if iterations is not None
            else self.params.num_iterations, verbose)

    def continue_gradient_descent(self, iterations: int,
                                  verbose: bool = True):
        if self._n == 1 or self._should_stop or iterations < 1:
            return
        if not self._initialized:
            self._init_gradient_descent()
        # cap iterations per device program so that no single program runs
        # for minutes at N=1M.  Budget is "row-iterations" per dispatch;
        # exact tiled repulsion additionally scales with npad^2 / block.
        budget = int(os.environ.get("SPH_TSNE_DISPATCH_BUDGET",
                                    str(1 << 24)))
        if self._use_grid or self._p_dense is not None:
            cost = self._npad
        else:
            cost = max(self._npad,
                       (self._npad * self._npad) // max(self._block_eff,
                                                        1) // 8)
        per_dispatch = max(1, min(iterations, budget // max(cost, 1)))
        left = iterations
        while left > 0:
            step = min(per_dispatch, left)
            s = self._state
            y, vel, gain, it = tsne_iterations(
                s.embedding, s.velocity, s.gain, jnp.int32(s.iteration),
                self._p_idx, self._p_val, jnp.int32(self._n),
                self._params_vec(), step, self._block_eff, self._p_dense,
                self._current_grid(), getattr(self, "_attr_packed", False))
            self._state = TsneState(y, vel, gain, int(s.iteration) + step)
            left -= step

    def _current_grid(self) -> int:
        """Grid size for the next iteration chunk (0 = grid mode off).
        Sized from the current embedding span with margin for growth
        during the chunk; the bbox itself is recomputed dynamically every
        iteration inside the kernel, only the node count is static."""
        if not getattr(self, "_use_grid", False):
            return 0
        from ..ops.tsne_grid import pick_grid_size
        y = self._state.embedding
        span = float(jnp.max(jnp.max(y, axis=0) - jnp.min(y, axis=0)))
        max_g = int(os.environ.get("SPH_TSNE_GRID_MAX", "1024"))
        return pick_grid_size(max(span, 1.0) * 1.3, max_g=max_g)

    def _single_point(self):
        self._state = TsneState(jnp.zeros((1, 2), jnp.float32),
                                jnp.zeros((1, 2), jnp.float32),
                                jnp.ones((1, 2), jnp.float32), 0)
        self._npad = 1
        self._initialized = True

    # ------------------------------------------------------------------

    @property
    def embedding(self) -> np.ndarray:
        return np.asarray(self._state.embedding)[:self._n]

    @property
    def current_iteration(self) -> int:
        return self._state.iteration if self._state else 0

    def kl_divergence(self) -> float:
        if self._n <= 1:
            return 0.0
        return float(tsne_kl_divergence(
            self._state.embedding, self._p_idx, self._p_val,
            jnp.int32(self._n), self._block_eff, self._current_grid()))
