"""chip_smoke.py's phases at a tiny size on the CPU, with the GPU check
bypassed; the script itself runs only where JAX finds a GPU."""

import importlib.util
import os

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TINY = dict(rows=16, cols=16, channels=20, seed=7, k=9)


def test_device_phase_reports_cpu_when_not_required():
    dev = cs.phase_device(require_gpu=False)
    assert dev["platform"] == "cpu" and dev["count"] >= 1


def test_main_fails_without_gpu(capsys):
    with pytest.raises(cs.SmokeFailure):
        cs.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_kernel_phase_tiny():
    cs.phase_kernels(n_tsne=300, knn_scene=TINY, sample=32)


def test_tsne_reference_rows_matches_full_numpy():
    rng = np.random.default_rng(0)
    n = 40
    y = rng.standard_normal((n, 2))
    p = rng.random((n, n))
    rows = np.array([0, 7, 39])
    attr, rep, z = cs.tsne_reference_rows(y, p, rows)
    d = y[:, None, :] - y[None, :, :]
    w = 1.0 / (1.0 + (d * d).sum(-1))
    np.fill_diagonal(w, 0.0)
    assert np.isclose(z, w.sum())
    np.testing.assert_allclose(rep, ((w * w)[:, :, None] * d).sum(1)[rows])
    np.testing.assert_allclose(attr, ((p * w)[:, :, None] * d).sum(1)[rows])


def test_checker_fingerprint_levels():
    assert cs.checker_levels() == [64, 19, 2, 1]


def test_mid_scene_levels_match_fixture():
    """Phase B on the CPU: the child process's levels, the levels from
    its P with device merges, and this process's own device and host
    merges all give the CPU fixture."""
    cs.phase_levels()


def test_pipeline_phase_tiny():
    levels = cs.phase_pipeline(s=TINY, iters=100, anchor_kl=1e9)
    assert levels[0] == TINY["rows"] * TINY["cols"]


def test_pipeline_invariants_reject_a_bad_kl():
    with pytest.raises(cs.SmokeFailure, match="KL"):
        cs.phase_pipeline(s=TINY, iters=20, anchor_kl=1e-6)
