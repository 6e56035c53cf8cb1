"""Sharded compute paths: multi-chip kNN and t-SNE.

The O(N^2) kernels shard their *row* dimension over the ``data`` mesh axis:

* kNN: each chip scores its row block against the replicated (or gathered)
  point set — no cross-chip reduction needed beyond the initial layout.
* t-SNE: the repulsive sum for a row shard needs every embedding position
  (y is only [N, 2]) — one `all_gather` per iteration — and the
  normalization Z is a `psum`.  This is the textbook data-parallel N-body
  decomposition; the reference has no analogue (its only accelerator path
  is a single-GPU GL shader, EmbedTsne.hpp:64-67).

Multi-scene batching (`multi_scene_tsne`) shards independent scenes over the
same axis — the BASELINE.json "16 hyperspectral stacks" config.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import make_mesh, replicate, shard_rows

_F32_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# sharded kNN
# ---------------------------------------------------------------------------

def sharded_knn(data: np.ndarray, k: int, mesh: Optional[Mesh] = None,
                axis: str = "data") -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN with rows sharded over the mesh.

    Each device holds a row shard and the full point set (replicated);
    distances + top-k are purely local, so scaling is embarrassingly
    parallel-connected chips.
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n, d = data.shape
    npad = ((n + (8 * n_dev) - 1) // (8 * n_dev)) * (8 * n_dev)
    padded = np.zeros((npad, d), dtype=np.float32)
    padded[:n] = data

    col_block = min(4096, npad)
    while npad % col_block:
        col_block //= 2
    from ..ops.knn import candidate_width, refine_candidates
    kc = candidate_width(k)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=(P(axis, None), P(axis, None)))
    def _local_knn(rows, full):
        # stream column blocks with a running top-k so the full [shard, N]
        # distance tile never materializes (N can be millions)
        row_sq = jnp.sum(rows * rows, axis=1)
        full_sq = jnp.sum(full * full, axis=1)
        nblk = full.shape[0] // col_block

        def col_step(carry, cb):
            top_d, top_i = carry
            cols = jax.lax.dynamic_slice_in_dim(full, cb * col_block,
                                                col_block)
            csq = jax.lax.dynamic_slice_in_dim(full_sq, cb * col_block,
                                               col_block)
            ip = jnp.dot(rows, cols.T, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            d2 = jnp.maximum(row_sq[:, None] + csq[None, :] - 2.0 * ip,
                             0.0)
            ids = (jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
                   + cb * col_block)
            d2 = jnp.where(ids >= n, jnp.inf, d2)
            md = jnp.concatenate([top_d, d2], axis=1)
            mi = jnp.concatenate([top_i, ids], axis=1)
            sd, si = jax.lax.sort((md, mi), num_keys=1, dimension=1,
                                  is_stable=True)
            return (sd[:, :kc], si[:, :kc]), None

        # pcast to varying: the carry is per-device state inside shard_map
        init = (jax.lax.pcast(jnp.full((rows.shape[0], kc), jnp.inf,
                                       jnp.float32), axis, to="varying"),
                jax.lax.pcast(jnp.full((rows.shape[0], kc), -1, jnp.int32),
                              axis, to="varying"))
        (top_d, top_i), _ = jax.lax.scan(col_step, init,
                                         jnp.arange(nblk))
        row_ids = (jnp.arange(rows.shape[0], dtype=jnp.int32)
                   + jax.lax.axis_index(axis) * rows.shape[0])
        top_d, top_i = refine_candidates(rows, row_ids, top_i, full, n, k)
        top_d = jnp.where(top_d <= _F32_EPS, 0.0, top_d)
        return jnp.sqrt(top_d), top_i

    rows_sharded = shard_rows(mesh, jnp.asarray(padded), axis)
    full_repl = replicate(mesh, jnp.asarray(padded))
    dist, idx = jax.jit(_local_knn)(rows_sharded, full_repl)
    idx = np.asarray(idx)[:n]
    dist = np.asarray(dist)[:n]
    from ..ops.graph import ensure_self_first
    idx, dist, _ = ensure_self_first(idx.astype(np.int32),
                                     dist.astype(np.float32))
    return idx, dist


# ---------------------------------------------------------------------------
# sharded t-SNE training step
# ---------------------------------------------------------------------------

def make_sharded_tsne_step(mesh: Mesh, axis: str = "data"):
    """Build the jitted multi-chip t-SNE step.

    State layout: y/vel/gain [N, 2] row-sharded; P rows [N, R] row-sharded;
    per-iteration: all_gather(y) -> local [shard, N] repulsion -> psum(Z).

    Returns step_fn(y, vel, gain, p_idx, p_val, n_valid, params_vec, it)
    -> (y, vel, gain).  All shapes must be divisible by the mesh size.
    """

    def _step(y, vel, gain, p_idx, p_val, n_valid, params_vec, it):
        (eta, mom0, mom1, mom_switch, exag_f, remove_exag, decay_iter,
         min_gain) = [params_vec[i] for i in range(8)]
        shard_n = y.shape[0]
        my_idx = jax.lax.axis_index(axis)
        row0 = my_idx * shard_n

        y_full = jax.lax.all_gather(y, axis, tiled=True)  # [Npad, 2]

        # repulsion: local rows vs all columns
        sq_full = jnp.sum(y_full * y_full, axis=1)
        sq_loc = jnp.sum(y * y, axis=1)
        # HIGHEST as in models.tsne._repulsive_forces: the expansion
        # amplifies reduced-precision products into d2
        d2 = (sq_loc[:, None] + sq_full[None, :]
              - 2.0 * jnp.dot(y, y_full.T,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST))
        w = 1.0 / (1.0 + jnp.maximum(d2, 0.0))
        rows = (jax.lax.broadcasted_iota(jnp.int32, w.shape, 0) + row0)
        cols = jax.lax.broadcasted_iota(jnp.int32, w.shape, 1)
        valid = (cols != rows) & (cols < n_valid) & (rows < n_valid)
        w = jnp.where(valid, w, 0.0)
        z = jax.lax.psum(jnp.sum(w), axis)
        w2 = w * w
        rep = (jnp.sum(w2, axis=1)[:, None] * y
               - jnp.dot(w2, y_full, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST))

        # attraction over local P rows (global column ids)
        yj = y_full[jnp.maximum(p_idx, 0)]
        diff = y[:, None, :] - yj
        dd = jnp.sum(diff * diff, axis=-1)
        wat = 1.0 / (1.0 + dd)
        coef = jnp.where(p_idx >= 0, p_val * wat, 0.0)
        attr = jnp.sum(coef[:, :, None] * diff, axis=1)

        itf = it.astype(jnp.float32)
        decay = jnp.exp(-4.6 * jnp.maximum(itf - remove_exag, 0.0)
                        / jnp.maximum(decay_iter, 1.0))
        exag = 1.0 + (exag_f - 1.0) * jnp.where(itf < remove_exag, 1.0,
                                                decay)
        momentum = jnp.where(itf < mom_switch, mom0, mom1)

        grad = 4.0 * (exag * attr - rep / jnp.maximum(z, 1e-12))
        same = jnp.sign(grad) == jnp.sign(vel)
        gain = jnp.maximum(jnp.where(same, gain * 0.8, gain + 0.2),
                           min_gain)
        vel = momentum * vel - eta * gain * grad
        y = y + vel
        row_ok = rows[:, :1] < n_valid
        y = jnp.where(row_ok, y, 0.0)
        # global zero-mean via psum
        mean = jax.lax.psum(jnp.sum(y, axis=0), axis) / jnp.maximum(
            n_valid.astype(jnp.float32), 1.0)
        y = jnp.where(row_ok, y - mean[None, :], 0.0)
        return y, vel, gain

    step = shard_map(
        _step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)))
    return jax.jit(step)


def sharded_tsne(p_indices: np.ndarray, p_values: np.ndarray,
                 num_iterations: int, mesh: Optional[Mesh] = None,
                 axis: str = "data", seed: int = 0,
                 params=None) -> np.ndarray:
    """Run a full multi-chip t-SNE (P must be the symmetrized joint
    distribution rows, normalized to total sum 1)."""
    from ..models.tsne import TsneParameters, default_exaggeration
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n, r = p_indices.shape
    npad = ((n + (8 * n_dev) - 1) // (8 * n_dev)) * (8 * n_dev)

    params = params or TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray([params.eta, params.momentum, params.final_momentum,
                        params.mom_switching_iter,
                        params.exaggeration_factor,
                        params.remove_exaggeration_iter,
                        params.exponential_decay_iter,
                        params.minimum_gain], jnp.float32)

    from ..ops.math import random_disk_init
    y0 = np.zeros((npad, 2), np.float32)
    y0[:n] = random_disk_init(n, 0.1, seed)
    pi = np.full((npad, r), -1, np.int32)
    pv = np.zeros((npad, r), np.float32)
    pi[:n] = p_indices
    pv[:n] = p_values / max(p_values.sum(), 1e-12)

    y = shard_rows(mesh, jnp.asarray(y0), axis)
    vel = shard_rows(mesh, jnp.zeros((npad, 2), jnp.float32), axis)
    gain = shard_rows(mesh, jnp.ones((npad, 2), jnp.float32), axis)
    pi_s = shard_rows(mesh, jnp.asarray(pi), axis)
    pv_s = shard_rows(mesh, jnp.asarray(pv), axis)

    step = make_sharded_tsne_step(mesh, axis)
    for it in range(num_iterations):
        y, vel, gain = step(y, vel, gain, pi_s, pv_s, jnp.int32(n), pvec,
                            jnp.int32(it))
    return np.asarray(y)[:n]


# ---------------------------------------------------------------------------
# sharded grid t-SNE (the large-N tier across chips)
# ---------------------------------------------------------------------------

def make_sharded_grid_tsne_step(mesh: Mesh, grid: int, axis: str = "data",
                                chunk: int = 0):
    """Multi-chip step for the grid-interpolated large-N tier
    (ops/tsne_grid.py).

    Decomposition: rows (points) shard over ``axis``.  Each chip deposits
    its shard's charges onto the [3, G, G] grid locally (chunked
    matmuls), the grids are `psum`-reduced (the only O(G^2)
    collective — 3*G^2 floats, independent of N), every chip runs the
    small replicated FFT convolution, and interpolation/update stay local.
    Attraction all_gathers y (8 MB at 1M points) exactly like
    `make_sharded_tsne_step`.
    """
    from ..ops.tsne_grid import (deposit_charges, field_matrix, grid_coords,
                                 interpolate_fields, _MARGIN)

    def _step(y, vel, gain, p_idx, p_val, n_valid, params_vec, it):
        (eta, mom0, mom1, mom_switch, exag_f, remove_exag, decay_iter,
         min_gain) = [params_vec[i] for i in range(8)]
        shard_n = y.shape[0]
        my_idx = jax.lax.axis_index(axis)
        row0 = my_idx * shard_n
        rows = row0 + jnp.arange(shard_n, dtype=jnp.int32)
        valid = rows < n_valid

        # global bbox over valid rows (pmin/pmax across the mesh)
        big = jnp.float32(3.4e38)
        lo_x = jax.lax.pmin(jnp.min(jnp.where(valid, y[:, 0], big)), axis)
        lo_y = jax.lax.pmin(jnp.min(jnp.where(valid, y[:, 1], big)), axis)
        hi_x = jax.lax.pmax(jnp.max(jnp.where(valid, y[:, 0], -big)), axis)
        hi_y = jax.lax.pmax(jnp.max(jnp.where(valid, y[:, 1], -big)), axis)
        usable = jnp.float32(grid - 2 * _MARGIN - 1)
        hx = jnp.maximum((hi_x - lo_x) / usable, 1e-6)
        hy = jnp.maximum((hi_y - lo_y) / usable, 1e-6)

        c = chunk if chunk > 0 else max(
            min(shard_n, (1 << 24) // grid), 1024)
        if shard_n % c != 0:
            c = shard_n
        tx, ty = grid_coords(y, valid, lo_x, lo_y, hx, hy, grid)
        charges = deposit_charges(y, tx, ty, valid, grid, c)
        charges = jax.lax.psum(charges, axis)
        v_mat = field_matrix(charges, hx, hy, grid)
        f = interpolate_fields(v_mat, tx, ty, grid, c)
        phi0, phi_yx, phi_yy, phi_z = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
        rep = jnp.stack([y[:, 0] * phi0 - phi_yx,
                         y[:, 1] * phi0 - phi_yy], axis=1)
        rep = jnp.where(valid[:, None], rep, 0.0)
        z = jax.lax.psum(jnp.sum(jnp.where(valid, phi_z, 0.0)), axis)
        z = jnp.maximum(z - n_valid.astype(jnp.float32), 1e-12)

        # attraction over local P rows (global column ids)
        y_full = jax.lax.all_gather(y, axis, tiled=True)
        yj = y_full[jnp.maximum(p_idx, 0)]
        diff = y[:, None, :] - yj
        dd = jnp.sum(diff * diff, axis=-1)
        wat = 1.0 / (1.0 + dd)
        coef = jnp.where(p_idx >= 0, p_val * wat, 0.0)
        attr = jnp.sum(coef[:, :, None] * diff, axis=1)

        itf = it.astype(jnp.float32)
        decay = jnp.exp(-4.6 * jnp.maximum(itf - remove_exag, 0.0)
                        / jnp.maximum(decay_iter, 1.0))
        exag = 1.0 + (exag_f - 1.0) * jnp.where(itf < remove_exag, 1.0,
                                                decay)
        momentum = jnp.where(itf < mom_switch, mom0, mom1)

        grad = 4.0 * (exag * attr - rep / z)
        same = jnp.sign(grad) == jnp.sign(vel)
        gain = jnp.maximum(jnp.where(same, gain * 0.8, gain + 0.2),
                           min_gain)
        vel = momentum * vel - eta * gain * grad
        y = y + vel
        row_ok = valid[:, None]
        y = jnp.where(row_ok, y, 0.0)
        mean = jax.lax.psum(jnp.sum(y, axis=0), axis) / jnp.maximum(
            n_valid.astype(jnp.float32), 1.0)
        y = jnp.where(row_ok, y - mean[None, :], 0.0)
        return y, vel, gain

    step = shard_map(
        _step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None)))
    return jax.jit(step)


def sharded_grid_tsne(p_indices: np.ndarray, p_values: np.ndarray,
                      num_iterations: int, mesh: Optional[Mesh] = None,
                      axis: str = "data", seed: int = 0,
                      grid: int = 0, params=None) -> np.ndarray:
    """Full multi-chip grid-tier t-SNE (P = symmetrized joint rows,
    normalized to total sum 1).  grid=0 picks the size from the live span
    like the single-chip tier; grid > 0 is the smallest node count, kept
    until the span needs finer cells than it has."""
    from ..models.tsne import TsneParameters, default_exaggeration
    from ..ops.tsne_grid import pick_grid_size
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n, r = p_indices.shape
    npad = ((n + (8 * n_dev) - 1) // (8 * n_dev)) * (8 * n_dev)

    params = params or TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray([params.eta, params.momentum, params.final_momentum,
                        params.mom_switching_iter,
                        params.exaggeration_factor,
                        params.remove_exaggeration_iter,
                        params.exponential_decay_iter,
                        params.minimum_gain], jnp.float32)

    from ..ops.math import random_disk_init
    y0 = np.zeros((npad, 2), np.float32)
    y0[:n] = random_disk_init(n, 0.1, seed)
    min_grid = max(grid, 0)
    pi = np.full((npad, r), -1, np.int32)
    pv = np.zeros((npad, r), np.float32)
    pi[:n] = p_indices
    pv[:n] = p_values / max(p_values.sum(), 1e-12)

    y = shard_rows(mesh, jnp.asarray(y0), axis)
    vel = shard_rows(mesh, jnp.zeros((npad, 2), jnp.float32), axis)
    gain = shard_rows(mesh, jnp.ones((npad, 2), jnp.float32), axis)
    pi_s = shard_rows(mesh, jnp.asarray(pi), axis)
    pv_s = shard_rows(mesh, jnp.asarray(pv), axis)

    # The embedding span grows ~30x over a run while the kernel width stays
    # ~1, so a grid picked at init degenerates (cells wider than the kernel
    # curvature) and its repulsion error runs away.  Mirror the single-chip
    # tier: re-pick the pow2-bucketed grid from the live span between
    # iteration chunks; a caller's grid is a floor, never a ceiling.
    # Compiled steps are cached per grid size.
    steps: dict = {}
    regrid_every = 50
    it = 0
    while it < num_iterations:
        span = float(jnp.max(jnp.max(y, axis=0) - jnp.min(y, axis=0)))
        fine = pick_grid_size(max(span, 1.0) * 1.3,
                              min_g=1 if min_grid else 128)
        grid = max(min_grid, fine)
        if grid not in steps:
            steps[grid] = make_sharded_grid_tsne_step(mesh, grid, axis)
        step = steps[grid]
        stop = min(it + regrid_every, num_iterations)
        while it < stop:
            y, vel, gain = step(y, vel, gain, pi_s, pv_s, jnp.int32(n),
                                pvec, jnp.int32(it))
            it += 1
    return np.asarray(y)[:n]


# ---------------------------------------------------------------------------
# multi-scene batched embedding (BASELINE config #5)
# ---------------------------------------------------------------------------

def multi_scene_tsne(p_indices: np.ndarray, p_values: np.ndarray,
                     num_iterations: int, mesh: Optional[Mesh] = None,
                     axis: str = "data", seed: int = 0) -> np.ndarray:
    """Batched t-SNE over S independent scenes sharded across devices.

    p_indices/p_values: [S, N, R] per-scene symmetric P rows.  Each scene
    runs the full single-chip iteration locally on its device — pure data
    parallelism over scenes (the reference runs scenes serially,
    RunEvaluation.cpp main loop).
    """
    from ..models.tsne import TsneParameters, default_exaggeration, \
        tsne_iterations
    from ..ops.math import random_disk_init
    if mesh is None:
        mesh = make_mesh()
    s, n, r = p_indices.shape
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray([params.eta, params.momentum, params.final_momentum,
                        params.mom_switching_iter,
                        params.exaggeration_factor,
                        params.remove_exaggeration_iter,
                        params.exponential_decay_iter,
                        params.minimum_gain], jnp.float32)

    # block must divide npad (the tiled repulsion asserts it)
    block = 512 if n > 512 else ((n + 7) // 8) * 8
    npad = ((n + block - 1) // block) * block
    y0 = np.zeros((s, npad, 2), np.float32)
    for i in range(s):
        y0[i, :n] = random_disk_init(n, 0.1, seed + i)
    pi = np.full((s, npad, r), -1, np.int32)
    pv = np.zeros((s, npad, r), np.float32)
    pi[:, :n] = p_indices
    pv[:, :n] = p_values / np.maximum(
        p_values.sum(axis=(1, 2), keepdims=True), 1e-12)

    def one_scene(y, vel, gain, p_i, p_v):
        y, vel, gain, _ = tsne_iterations(
            y, vel, gain, jnp.int32(0), p_i, p_v, jnp.int32(n), pvec,
            num_iterations, block)
        return y

    batched = shard_map(
        lambda ys, vs, gs, pis, pvs: jax.vmap(one_scene)(ys, vs, gs, pis,
                                                         pvs),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis))

    y = shard_rows(mesh, jnp.asarray(y0), axis)
    vel = shard_rows(mesh, jnp.zeros_like(y0), axis)
    gain = shard_rows(mesh, jnp.ones_like(y0), axis)
    pi_s = shard_rows(mesh, jnp.asarray(pi), axis)
    pv_s = shard_rows(mesh, jnp.asarray(pv), axis)
    out = jax.jit(batched)(y, vel, gain, pi_s, pv_s)
    return np.asarray(out)[:, :n]


# ---------------------------------------------------------------------------
# sharded UMAP (edge-parallel epochs)
# ---------------------------------------------------------------------------

def make_sharded_umap_epoch(mesh: Mesh, axis: str = "data",
                            neg_rate: int = 5):
    """One UMAP optimization epoch with the edge list sharded over the mesh.

    y is replicated [N, 2]; each chip evaluates its edge shard and the
    per-phase position deltas are `psum`med — the data-parallel form of
    models/umap._epoch_update (same two-phase semantics: attraction applied,
    then negative rounds read the updated positions).  Negative-sample
    streams fold in the device index, so they differ from the single-chip
    stream (documented deviation — the reference's umappp is sequential).
    """

    def epoch(y, src, dst, eps, nxt, epoch_i, alpha, a, b, key, n_valid):
        active = nxt <= epoch_i

        ys = y[src]
        yd = y[dst]
        diff = ys - yd
        d2 = jnp.sum(diff * diff, axis=1)
        gc = jnp.where(d2 > 0,
                       (-2.0 * a * b * d2 ** (b - 1.0))
                       / (a * d2 ** b + 1.0), 0.0)
        delta = jnp.clip(gc[:, None] * diff, -4.0, 4.0)
        delta = jnp.where(active[:, None], delta, 0.0)
        dense = (jnp.zeros_like(y).at[src].add(alpha * delta)
                 .at[dst].add(-alpha * delta))
        y = y + jax.lax.psum(dense, axis)

        dev = jax.lax.axis_index(axis)
        for r in range(neg_rate):
            k = jax.random.fold_in(jax.random.fold_in(key, r), dev)
            negs = jax.random.randint(k, src.shape, 0, n_valid)
            ysn = y[src]
            yn = y[negs]
            diff_n = ysn - yn
            d2n = jnp.sum(diff_n * diff_n, axis=1)
            gcn = (2.0 * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0))
            delta_n = jnp.where(gcn[:, None] > 0,
                                jnp.clip(gcn[:, None] * diff_n, -4.0, 4.0),
                                4.0)
            hit_self = negs == src
            delta_n = jnp.where((active & ~hit_self)[:, None], delta_n, 0.0)
            dense_n = jnp.zeros_like(y).at[src].add(alpha * delta_n)
            y = y + jax.lax.psum(dense_n, axis)

        nxt = jnp.where(active, nxt + eps, nxt)
        return y, nxt

    sharded = shard_map(
        epoch, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis),
                  P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(axis)))
    return jax.jit(sharded)


def sharded_umap(p_indices: np.ndarray, p_values: np.ndarray,
                 num_epochs: int = 0, mesh: Optional[Mesh] = None,
                 axis: str = "data", seed: int = 0,
                 params=None) -> np.ndarray:
    """Full multi-chip UMAP on symmetric membership rows [N, R] (fuzzy
    union applied upstream, like models/umap set_neighbor_matrix)."""
    from ..models.umap import UmapComputation, UmapParameters
    from ..ops.sparse import SparseRows

    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size

    uc = UmapComputation(params or UmapParameters())
    if num_epochs:
        uc.params.num_epochs = num_epochs
    uc.params.seed = seed
    # skip the double fuzzy-union: rows are already symmetric memberships
    uc._p = SparseRows(np.asarray(p_indices, np.int32),
                       np.asarray(p_values, np.float32), p_indices.shape[0])
    uc._n = p_indices.shape[0]
    uc._memberships = lambda: uc._p  # type: ignore[assignment]
    # the edge-sharded step consumes the flat edge list, so pin the model's
    # state build to the edges tier regardless of the single-chip default
    import os
    os.environ["SPH_UMAP_EDGE_PATH"] = "1"
    try:
        uc.init_optimization()
    finally:
        os.environ.pop("SPH_UMAP_EDGE_PATH", None)

    e = int(uc._src.shape[0])
    epad = ((e + n_dev - 1) // n_dev) * n_dev
    pad = epad - e
    src = np.pad(np.asarray(uc._src), (0, pad))
    dst = np.pad(np.asarray(uc._dst), (0, pad))
    eps = np.pad(np.asarray(uc._eps), (0, pad))
    nxt = np.pad(np.asarray(uc._next_sample), (0, pad),
                 constant_values=np.inf)  # pad edges never activate

    def shard_edges(x):
        return jax.device_put(
            jnp.asarray(x),
            jax.sharding.NamedSharding(mesh, P(axis)))

    y = replicate(mesh, jnp.asarray(uc._embedding))
    src_s, dst_s, eps_s, nxt_s = map(shard_edges, (src, dst, eps, nxt))

    step = make_sharded_umap_epoch(mesh, axis,
                                   uc.params.negative_sample_rate)
    key = jax.random.PRNGKey(seed)
    for epoch in range(uc._n_epochs):
        alpha = uc.params.initial_alpha * (1.0 - epoch / uc._n_epochs)
        y, nxt_s = step(y, src_s, dst_s, eps_s, nxt_s,
                        jnp.float32(epoch), jnp.float32(alpha),
                        jnp.float32(uc._a), jnp.float32(uc._b),
                        jax.random.fold_in(key, epoch),
                        jnp.int32(uc._n))
    return np.asarray(y)


# ---------------------------------------------------------------------------
# scene-parallel stage 1: kNN + data-level probdist + random walks
# ---------------------------------------------------------------------------

def multi_scene_stage1(datas: np.ndarray, k: int,
                       rws=None,
                       norm=None,
                       mesh: Optional[Mesh] = None,
                       axis: str = "data",
                       seed_base: Optional[int] = None):
    """Batched stage-1 over S same-shape scenes, sharded across the mesh.

    The reference evaluates scenes strictly serially (the outer run loop,
    RunEvaluation.cpp:148-172); here every scene's exact kNN, data-level
    probability distribution and data-level random walks are computed in
    ONE sharded device program — scenes never split across devices, so the
    only communication is the initial layout.

    datas: [S, N, D] float32.  Returns a dict of numpy arrays:
      idx/dist [S, N, k]  (self-first, sorted ascending, sqrt'd L2)
      probs    [S, N, k]  (per `norm`, ignore_first semantics)
      walks_idx/walks_val [S, N, Wo] or None when `rws` is None
    The probabilities and walks round differently from the single-scene
    programs; `multi_scene_hierarchy` therefore takes only idx/dist.
    """
    from ..ops.graph import ensure_self_first_body
    from ..ops.distributions import gaussian_row_distributions, \
        linear_row_distributions, smooth_knn_distributions
    from ..ops.walks import _simulate, _accumulate, _postprocess, \
        derive_prune_value
    from ..settings import NormalizationScheme, RandomWalkSettings

    if norm is None:
        norm = NormalizationScheme.TSNE
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    s, n, d = datas.shape
    spad = ((s + n_dev - 1) // n_dev) * n_dev

    col_block = 256
    npad = ((n + col_block - 1) // col_block) * col_block
    padded = np.zeros((spad, npad, d), np.float32)
    padded[:s, :n] = datas

    if rws is not None:
        w = int(rws.num_random_walks)
        length = int(rws.single_walk_length)
        cap = rws.max_row_nnz or min(w * length, 2048)
        out_width = min(cap, w * length, n)
        prune_value = derive_prune_value(rws)
        if seed_base is None:
            seed_base = int(rws.random_seed)
    seeds = np.arange(spad, dtype=np.uint32) + np.uint32(seed_base or 0)

    from ..ops.knn import candidate_width, refine_candidates
    kc = candidate_width(k)

    def one_scene(pts, seed):
        # streaming exact self-kNN (same math as ops.knn._knn_device)
        row_sq = jnp.sum(pts * pts, axis=1)
        nblk = npad // col_block
        col_iota = jax.lax.broadcasted_iota(jnp.int32, (npad, col_block), 1)
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (npad, col_block), 0)

        def col_step(carry, cb):
            top_d, top_i = carry
            cols = jax.lax.dynamic_slice_in_dim(pts, cb * col_block,
                                                col_block)
            csq = jax.lax.dynamic_slice_in_dim(row_sq, cb * col_block,
                                               col_block)
            ip = jnp.dot(pts, cols.T, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            d2 = jnp.maximum(row_sq[:, None] + csq[None, :] - 2.0 * ip, 0.0)
            ids = col_iota + cb * col_block
            d2 = jnp.where(ids == row_ids, 0.0, d2)
            d2 = jnp.where(ids >= n, jnp.inf, d2)
            md = jnp.concatenate([top_d, d2], axis=1)
            mi = jnp.concatenate([top_i, ids], axis=1)
            sd, si = jax.lax.sort((md, mi), num_keys=1, dimension=1,
                                  is_stable=True)
            return (sd[:, :kc], si[:, :kc]), None

        # pcast to varying: the carry is per-device state inside shard_map
        init = (jax.lax.pcast(jnp.full((npad, kc), jnp.inf, jnp.float32),
                              axis, to="varying"),
                jax.lax.pcast(jnp.full((npad, kc), -1, jnp.int32),
                              axis, to="varying"))
        (top_d, top_i), _ = jax.lax.scan(col_step, init, jnp.arange(nblk))
        top_d, top_i = refine_candidates(
            pts, jnp.arange(npad, dtype=jnp.int32), top_i, pts, n, k)
        top_d = jnp.sqrt(jnp.where(top_d <= _F32_EPS, 0.0, top_d))
        idx, dist, _ = ensure_self_first_body(top_i[:n], top_d[:n])

        mask = jnp.ones_like(idx, dtype=bool)
        if norm == NormalizationScheme.TSNE:
            probs = gaussian_row_distributions(dist, mask, jnp.float32(-1.0),
                                               ignore_first=True)
        elif norm == NormalizationScheme.LINEAR:
            m2 = mask.at[:, 0].set(False)
            probs = linear_row_distributions(dist, m2)
        else:  # UMAP
            m2 = mask.at[:, 0].set(False)
            probs = smooth_knn_distributions(dist, m2)
            ps = jnp.sum(probs, axis=1, keepdims=True)
            probs = jnp.where(ps > 0, probs / jnp.maximum(ps, 1e-38), 0.0)

        if rws is None:
            return idx, dist, probs, jnp.zeros((n, 1), jnp.int32), \
                jnp.zeros((n, 1), jnp.float32)
        p_idx = jnp.where(mask, idx, -1)
        visited = _simulate(p_idx, probs, seed, w, length)
        widx, wval = _accumulate(visited, w, length,
                                 rws.importance_weighting.value, out_width)
        widx, wval = _postprocess(widx, wval, jnp.float32(prune_value),
                                  rws.remove_diagonal, rws.normalize)
        return idx, dist, probs, widx, wval

    batched = shard_map(
        lambda ps, sd: jax.vmap(one_scene)(ps, sd),
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)))

    pts_s = shard_rows(mesh, jnp.asarray(padded), axis)
    seeds_s = shard_rows(mesh, jnp.asarray(seeds), axis)
    idx, dist, probs, widx, wval = jax.jit(batched)(pts_s, seeds_s)

    out = {
        "idx": np.asarray(idx)[:s].astype(np.int32),
        "dist": np.asarray(dist)[:s].astype(np.float32),
        "probs": np.asarray(probs)[:s].astype(np.float32),
        "walks_idx": None, "walks_val": None,
    }
    if rws is not None:
        out["walks_idx"] = np.asarray(widx)[:s].astype(np.int32)
        out["walks_val"] = np.asarray(wval)[:s].astype(np.float32)
    return out


def multi_scene_hierarchy(datas: np.ndarray, rows: int, cols: int,
                          k: int, ihs=None, rws=None, lss=None,
                          mesh: Optional[Mesh] = None,
                          axis: str = "data"):
    """End-to-end scene-parallel hierarchy: the batched exact kNN on the
    mesh, then per scene the single-scene data-level P, walks, Borůvka
    level loop and level similarities over SHARED compiled kernels (levels
    are data-dependent per scene; the row-bucketed per-level kernels make
    the serial loops reuse the same executables across scenes).

    The batched kNN equals the single-scene kNN bit for bit, but a batched
    P program rounds differently, and the walk sampler turns ulp-level P
    differences into different levels; taking P and walks from the
    single-scene programs makes every scene's levels equal those of
    `ComputeHierarchy` on the raw kNN graph with walk seed
    `rws.random_seed + i`.

    Returns a list of (ImageHierarchy, LevelSimilarities or None) per
    scene.  Reference analogue being parallelized: the strictly serial
    outer run loop, RunEvaluation.cpp:148-172.
    """
    import dataclasses

    from ..models.image_hierarchy import ImageHierarchy
    from ..models.level_similarities import LevelSimilarities
    from ..ops.graph import KnnGraph
    from ..settings import ImageHierarchySettings, RandomWalkSettings

    ihs = ihs or ImageHierarchySettings()
    rws = rws or RandomWalkSettings()
    s, n, d = datas.shape
    assert n == rows * cols

    stage1 = multi_scene_stage1(datas, k, norm=ihs.norm_knn_distances,
                                mesh=mesh, axis=axis)

    results = []
    for i in range(s):
        g = KnnGraph(stage1["idx"][i], stage1["dist"][i])
        ih = ImageHierarchy(g, datas[i], rows, cols)
        ih.set_settings(ihs, dataclasses.replace(
            rws, random_seed=rws.random_seed + i))
        ih.compute()
        ls = None
        if lss is not None:
            ls = LevelSimilarities(ih.hierarchy, g, datas[i],
                                   dataclasses.replace(lss))
            ls.set_image_hierarchy(ih)
            ls.compute()
        results.append((ih, ls))
    return results
