"""Grid-interpolated t-SNE repulsion — the O(N + G^2 log G) large-N path.

Reference intent: sph/EmbedTsne.cpp:165-178 scales Barnes-Hut theta with N
(more approximation at larger N).  Trees are pointer-chasing and serialize
on an accelerator, so this module takes the polynomial-interpolation route
instead (the FIt-SNE family, Linderman et al. 2019): both repulsion terms
are convolutions of point charges with smooth shift-invariant kernels,

    F_i = sum_j k2(y_i - y_j) (y_i - y_j),   k2(r) = 1/(1+|r|^2)^2
        = y_i * (k2 * 1)(y_i) - (k2 * y)(y_i)
    Z   = sum_{i != j} k1(y_i - y_j),        k1(r) = 1/(1+|r|^2)

so the kernel is interpolated on a regular grid: deposit charges onto the
grid with cubic-Lagrange weights, convolve with the exact kernel sampled
at grid offsets (FFT), and interpolate the resulting fields back at the
point positions.  The kernel-interpolation form needs no Fourier
deconvolution — the only error is the cubic interpolation error of the
(smooth, bounded-curvature) kernels, O(h^4).

Formulation: scatter/gather of N points into a 2-D grid is made of
per-element scatters, which serialize on colliding cells.  Both transfers
are therefore written as dense matmuls: the separable weight
matrices W_x [c, G] and W_y [c, G] (4 nonzero taps per row, materialized
as dense elementwise rows) give

    deposit:     C_q = W_y^T @ (q * W_x)        one [G,c]x[c,3G] matmul
    interpolate: f_q = sum_v (W_x @ V)[.,v] * W_y[.,v]

which is 14*N*G^2 FLOPs per iteration — minutes-per-iteration exact
repulsion at N=1M becomes ~10 Hz.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# tap margin: cubic Lagrange uses nodes floor(t)-1 .. floor(t)+2, so map
# points into grid coordinates [3, G-4] to keep every tap in-bounds
_MARGIN = 3


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_grid_size(span: float, target_h: float = 0.35,
                   min_g: int = 128, max_g: int = 1024) -> int:
    """Grid nodes per dim for a given embedding span: pow2 bucket keeping
    the node spacing h <= target_h (FIt-SNE's default density is ~3 nodes
    per unit length; the kernels have curvature scale ~1)."""
    need = max(int(np.ceil(span / max(target_h, 1e-6))) + 2 * _MARGIN + 2,
               min_g)
    g = 1 << int(np.ceil(np.log2(need)))
    return int(np.clip(g, min_g, max_g))


def _lagrange_rows(t: jax.Array, grid: int) -> jax.Array:
    """Dense cubic-Lagrange cardinal weight rows.

    t: [c] continuous grid coordinates in [2, G-3].  Returns [c, G] rows
    with 4 nonzero taps each summing to 1.  L(s) is the even cardinal
    function of 4-point Lagrange interpolation on a uniform grid:
      |s| < 1:      (|s|+1)(|s|-1)(|s|-2)/2
      1 <= |s| < 2: -(|s|-1)(|s|-2)(|s|-3)/6
    """
    u = jax.lax.broadcasted_iota(jnp.float32, (t.shape[0], grid), 1)
    s = jnp.abs(t[:, None] - u)
    inner = (s + 1.0) * (s - 1.0) * (s - 2.0) * 0.5
    outer = -(s - 1.0) * (s - 2.0) * (s - 3.0) / 6.0
    return jnp.where(s < 1.0, inner,
                     jnp.where(s < 2.0, outer, 0.0))


def _kernel_grids(hx: jax.Array, hy: jax.Array, grid: int):
    """k2 and k1 sampled at wrapped grid offsets, ready for circular FFT
    convolution on the [2G, 2G] zero-padded grid."""
    two_g = 2 * grid
    ar = jnp.arange(two_g)
    off = jnp.where(ar < grid, ar, ar - two_g).astype(jnp.float32)
    # charge grids are laid out C[u, v] with u = y index, v = x index
    dy = (off * hy)[:, None]
    dx = (off * hx)[None, :]
    r2 = dx * dx + dy * dy
    k1 = 1.0 / (1.0 + r2)
    k2 = k1 * k1
    return k2, k1


def grid_coords(yp: jax.Array, valid: jax.Array, lo_x, lo_y, hx, hy,
                grid: int):
    """Continuous grid coordinates for points; pad/invalid rows park at the
    margin (zero charge keeps them inert)."""
    tx_all = (yp[:, 0] - lo_x) / hx + _MARGIN
    ty_all = (yp[:, 1] - lo_y) / hy + _MARGIN
    tx_all = jnp.where(valid, tx_all, jnp.float32(_MARGIN))
    ty_all = jnp.where(valid, ty_all, jnp.float32(_MARGIN))
    return tx_all, ty_all


def deposit_charges(yp: jax.Array, tx_all: jax.Array, ty_all: jax.Array,
                    valid: jax.Array, grid: int, chunk: int) -> jax.Array:
    """[3, G, G] charge grids (unit, x, y) via chunked matmul deposits.
    Row count must be a multiple of ``chunk``."""
    nchunks = yp.shape[0] // chunk
    chunk_ids = jnp.arange(nchunks)

    def deposit(cb):
        s = cb * chunk
        tx = jax.lax.dynamic_slice_in_dim(tx_all, s, chunk)
        ty = jax.lax.dynamic_slice_in_dim(ty_all, s, chunk)
        yc = jax.lax.dynamic_slice_in_dim(yp, s, chunk)
        msk = jax.lax.dynamic_slice_in_dim(valid, s, chunk)
        wx = _lagrange_rows(tx, grid)
        wy = _lagrange_rows(ty, grid)
        q = jnp.stack([jnp.where(msk, 1.0, 0.0),
                       jnp.where(msk, yc[:, 0], 0.0),
                       jnp.where(msk, yc[:, 1], 0.0)], axis=1)  # [c, 3]
        # rhs [c, 3G]: charge-scaled x-weights, interleaved by charge
        rhs = (q[:, :, None] * wx[:, None, :]).reshape(chunk, 3 * grid)
        return jnp.dot(wy.T, rhs, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)  # [G, 3G]

    charges = jnp.sum(jax.lax.map(deposit, chunk_ids), axis=0)
    return charges.reshape(grid, 3, grid).transpose(1, 0, 2)  # [3, G, G]


def field_matrix(charges: jax.Array, hx, hy, grid: int) -> jax.Array:
    """FFT-convolve [3, G, G] charges with the exact kernels sampled at
    grid offsets -> [G, 4G] field matrix (unit/yx/yy of k2, unit of k1)."""
    two_g = 2 * grid
    k2g, k1g = _kernel_grids(hx, hy, grid)
    cpadded = jnp.zeros((3, two_g, two_g), jnp.float32)
    cpadded = cpadded.at[:, :grid, :grid].set(charges)
    cf = jnp.fft.rfft2(cpadded)
    k2f = jnp.fft.rfft2(k2g)
    k1f = jnp.fft.rfft2(k1g)
    phi_k2 = jnp.fft.irfft2(cf * k2f[None], s=(two_g, two_g))[
        :, :grid, :grid]                       # [3, G, G]: unit, yx, yy
    phi_k1 = jnp.fft.irfft2(cf[0] * k1f, s=(two_g, two_g))[
        None, :grid, :grid]                    # [1, G, G]: unit
    fields = jnp.concatenate([phi_k2, phi_k1], axis=0)  # [4, G, G]
    return fields.transpose(1, 0, 2).reshape(grid, 4 * grid)


def interpolate_fields(v_mat: jax.Array, tx_all: jax.Array,
                       ty_all: jax.Array, grid: int,
                       chunk: int) -> jax.Array:
    """Sample the [G, 4G] field matrix back at the point positions ->
    [rows, 4] (phi0, phi_yx, phi_yy, phi_z)."""
    nchunks = tx_all.shape[0] // chunk

    def interpolate(cb):
        s = cb * chunk
        tx = jax.lax.dynamic_slice_in_dim(tx_all, s, chunk)
        ty = jax.lax.dynamic_slice_in_dim(ty_all, s, chunk)
        wx = _lagrange_rows(tx, grid)
        wy = _lagrange_rows(ty, grid)
        # fields are [q, u(y), v(x)]: contract the y axis with wy first,
        # then the x axis with wx
        t = jnp.dot(wy, v_mat, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)  # [c, 4G]
        t = t.reshape(chunk, 4, grid)
        return jnp.sum(t * wx[:, None, :], axis=2)        # [c, 4]

    return jax.lax.map(interpolate,
                       jnp.arange(nchunks)).reshape(tx_all.shape[0], 4)


@functools.partial(jax.jit, static_argnames=("grid", "chunk"))
def grid_repulsion(y: jax.Array, n_valid, grid: int, chunk: int = 0):
    """Approximate Student-t repulsion via kernel-interpolated grid
    convolution.  Returns (rep [Np, 2], Z) with the same semantics as the
    exact `_repulsive_forces` (models/tsne.py): rep_i = sum_j k2 (y_i-y_j),
    Z = sum_{i != j} k1.  Pad rows (>= n_valid) carry no charge and get
    zero force."""
    npad = y.shape[0]
    if chunk <= 0:
        chunk = max(min(npad, (1 << 24) // grid), 1024)
    cpad = _ceil_to(npad, chunk)
    yp = jnp.pad(y, ((0, cpad - npad), (0, 0)))

    row_ids = jnp.arange(cpad, dtype=jnp.int32)
    valid = row_ids < n_valid

    # bbox over valid rows; degenerate spans guarded
    big = jnp.float32(3.4e38)
    vx = jnp.where(valid, yp[:, 0], big)
    vy = jnp.where(valid, yp[:, 1], big)
    lo_x = jnp.min(vx)
    lo_y = jnp.min(vy)
    hi_x = jnp.max(jnp.where(valid, yp[:, 0], -big))
    hi_y = jnp.max(jnp.where(valid, yp[:, 1], -big))
    usable = jnp.float32(grid - 2 * _MARGIN - 1)
    hx = jnp.maximum((hi_x - lo_x) / usable, 1e-6)
    hy = jnp.maximum((hi_y - lo_y) / usable, 1e-6)

    tx_all, ty_all = grid_coords(yp, valid, lo_x, lo_y, hx, hy, grid)
    charges = deposit_charges(yp, tx_all, ty_all, valid, grid, chunk)
    v_mat = field_matrix(charges, hx, hy, grid)
    f = interpolate_fields(v_mat, tx_all, ty_all, grid, chunk)
    phi0 = f[:, 0]
    phi_yx = f[:, 1]
    phi_yy = f[:, 2]
    phi_z = f[:, 3]

    rep = jnp.stack([yp[:, 0] * phi0 - phi_yx,
                     yp[:, 1] * phi0 - phi_yy], axis=1)
    rep = jnp.where(valid[:, None], rep, 0.0)[:npad]
    z = jnp.sum(jnp.where(valid, phi_z, 0.0)) - n_valid.astype(jnp.float32)
    return rep, jnp.maximum(z, 1e-12)
