"""The t-SNE force passes against float64 numpy references: the tiled exact
repulsion (`_repulsive_forces`) and the fused dense-P pass
(`_dense_forces`), which replaced the hand-written kernels this module
first tested — plain XLA measured faster on the GPU (PERF.md)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sph_tpu.models.tsne import _dense_forces, _repulsive_forces


def _numpy_forces(y, p, n):
    """float64 (attr, rep, Z) over the first n rows of y [npad, 2]."""
    y = y[:n].astype(np.float64)
    diff = y[:, None, :] - y[None, :, :]
    w = 1.0 / (1.0 + (diff ** 2).sum(-1))
    np.fill_diagonal(w, 0.0)
    rep = ((w ** 2)[:, :, None] * diff).sum(1)
    attr = None if p is None else (
        (p[:n, :n].astype(np.float64) * w)[:, :, None] * diff).sum(1)
    return attr, rep, w.sum()


@pytest.mark.parametrize("n,npad", [(100, 256), (256, 256), (500, 512)])
def test_pallas_repulsion_matches_xla(n, npad):
    """Tiled exact repulsion vs float64 numpy."""
    rng = np.random.default_rng(0)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 5
    rep, z = _repulsive_forces(jnp.asarray(y), jnp.int32(n), min(128, npad))
    _, rep_ref, z_ref = _numpy_forces(y, None, n)
    assert np.isclose(float(z), z_ref, rtol=1e-5)
    scale = np.abs(rep_ref).max()
    assert np.allclose(np.asarray(rep)[:n], rep_ref,
                       atol=1e-4 * max(scale, 1.0))


def test_pallas_repulsion_pad_rows_zero():
    rng = np.random.default_rng(1)
    npad, n = 256, 100
    y = rng.standard_normal((npad, 2)).astype(np.float32)  # garbage pads
    rep, z = _repulsive_forces(jnp.asarray(y), jnp.int32(n), 128)
    assert np.all(np.asarray(rep)[n:] == 0)
    _, _, z_ref = _numpy_forces(y, None, n)
    assert np.isclose(float(z), z_ref, rtol=1e-5)


def _dense_case(n, npad, seed=2):
    rng = np.random.default_rng(seed)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 3
    p = np.zeros((npad, npad), np.float32)
    # sparse-ish symmetric P with zero diagonal
    sup = rng.random((n, n)) < 0.05
    p[:n, :n] = np.where(sup | sup.T, rng.random((n, n)), 0).astype(np.float32)
    p[:n, :n] = (p[:n, :n] + p[:n, :n].T) / 2
    np.fill_diagonal(p, 0.0)
    p /= max(p.sum(), 1e-12)
    return y, p


def _check_dense(attr, rep, z, y, p, n):
    attr_ref, rep_ref, z_ref = _numpy_forces(y, p, n)
    assert np.isclose(float(z), z_ref, rtol=1e-5)
    assert np.allclose(np.asarray(rep)[:n], rep_ref,
                       atol=1e-4 * max(np.abs(rep_ref).max(), 1.0))
    assert np.allclose(np.asarray(attr)[:n], attr_ref,
                       atol=1e-5 * max(np.abs(attr_ref).max(), 1.0))
    assert np.all(np.asarray(rep)[n:] == 0)
    assert np.all(np.asarray(attr)[n:] == 0)


@pytest.mark.parametrize("n,npad", [(100, 256), (256, 256)])
def test_pallas_forces_dense_matches_numpy(n, npad):
    """Fused dense-P pass vs float64 numpy, one row tile and two."""
    y, p = _dense_case(n, npad)
    for block in (npad, npad // 2):
        attr, rep, z = _dense_forces(jnp.asarray(y), jnp.asarray(p),
                                     jnp.int32(n), block)
        _check_dense(attr, rep, z, y, p, n)


@pytest.mark.gpu
def test_dense_forces_on_gpu(gpu_device):
    """The dense pass compiled for the card, at a level-1-like size."""
    n, npad = 2000, 2048
    y, p = _dense_case(n, npad, seed=3)
    with jax.default_device(gpu_device):
        attr, rep, z = _dense_forces(jnp.asarray(y), jnp.asarray(p),
                                     jnp.int32(n), npad)
    _check_dense(attr, rep, z, y, p, n)
