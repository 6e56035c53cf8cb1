#!/usr/bin/env python3
"""Smoke test of the pipeline on one NVIDIA GPU.

    python chip_smoke.py           # phases 0, A, B, C on one card
    python chip_smoke.py --multi   # the sharded paths on four cards

Phase 0  the device as JAX sees it, and the card's name and power limit.
Phase A  each device kernel of the main path at its real width against a
         plain float64 numpy reference: the dense-P t-SNE force pass, the
         tiled exact repulsion, the blocked kNN; memory_analysis() of the
         compiled t-SNE step.
Phase B  hierarchy levels: the 8x8 checker fingerprint, and a 64x64x200
         scene against its CPU-recorded fixture (tests/fixtures) with the
         CPU's P fed to this backend's walks and merges.
Phase C  the Pines configuration end to end through the public entry
         points (ComputeHierarchy -> level-1 ComputeEmbedding.compute_tsne,
         2000 iterations), cold then warm, with its invariants and the KL
         gate against the sklearn Barnes-Hut anchor (docs/anchors_pines.json).
--multi  sharded kNN, the sharded t-SNE step and the multi-scene
         hierarchy on a 4-device mesh, each against its single-device
         counterpart.

Any failed check raises and the process exits non-zero.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from sph_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from sph_tpu.utils.device import nvidia_smi_name_power  # noqa: E402

PINES = dict(rows=145, cols=145, channels=200, seed=7, k=91)
MID = dict(rows=64, cols=64, channels=200, seed=7, k=91)
LEVEL1_N = 5358          # about the Pines level-1 component count
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "levels_mid_scene.json")
ANCHOR = os.path.join(ROOT, "docs", "anchors_pines.json")


class SmokeFailure(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)
    log(f"  ok: {msg}")


# ---------------------------------------------------------------------------
# shared
# ---------------------------------------------------------------------------

def pines_settings(k: int, connect: bool = True, seed: int = 1) -> dict:
    """The reference's comparison_pines_embed.json settings (bench.py)."""
    from sph_tpu import (ComponentSim, ImageHierarchySettings,
                         ImportanceWeighting, LevelSimilaritiesSettings,
                         NearestNeighborsSettings, NormalizationScheme,
                         RandomWalkHandling, RandomWalkReduction,
                         RandomWalkSettings)
    return dict(
        ihs=ImageHierarchySettings(
            component_sim=ComponentSim.NEIGH_WALKS,
            merge_multiple=False, use_percentile=False, max_dist=0.0,
            min_num_comp=1, min_reduction=98.0, max_levels=10,
            rw_handling=RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
            norm_knn_distances=NormalizationScheme.TSNE),
        lss=LevelSimilaritiesSettings(
            component_sim=ComponentSim.NEIGH_WALKS, ks=[k],
            random_walk_pair_sims=True,
            normalize_prob_dist=NormalizationScheme.TSNE,
            compute_symmetric_prob_dist=NormalizationScheme.TSNE),
        rws=RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=ImportanceWeighting.NORMAL,
            random_seed=seed),
        nns=NearestNeighborsSettings(
            num_nearest_neighbors=k, symmetric_neighbors=connect,
            compute_connect_components=connect,
            neighbor_connect_components=connect))


def scene(rows: int, cols: int, channels: int, seed: int) -> np.ndarray:
    from sph_tpu import ImageStack, Scaler, scale
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(rows, cols, channels, seed=seed)
    return scale(ImageStack.from_array(img).data, Scaler.NONE)


def hierarchy(data: np.ndarray, rows: int, cols: int, k: int):
    from sph_tpu import ComputeHierarchy
    ch = ComputeHierarchy().init(data, rows, cols, **pines_settings(k))
    ch.compute()
    return ch


def tsne_reference_rows(y: np.ndarray, p: np.ndarray, rows: np.ndarray):
    """float64 attr/rep for `rows` and Z over all pairs (y [n, 2], p the
    dense [n, n] joint P)."""
    y = y.astype(np.float64)
    n = y.shape[0]
    d = y[rows, None, :] - y[None, :, :]
    w = 1.0 / (1.0 + (d * d).sum(-1))
    w[np.arange(rows.size), rows] = 0.0
    rep = ((w * w)[:, :, None] * d).sum(1)
    attr = ((p[rows].astype(np.float64) * w)[:, :, None] * d).sum(1)
    z = 0.0
    for b0 in range(0, n, 512):
        b = np.arange(b0, min(b0 + 512, n))
        wb = 1.0 / (1.0 + ((y[b, None, :] - y[None, :, :]) ** 2).sum(-1))
        wb[np.arange(b.size), b] = 0.0
        z += wb.sum()
    return attr, rep, z


def close_to(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| / max |ref|."""
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_device(count: int = 1, require_gpu: bool = True) -> dict:
    """Print the device as JAX reports it and the card's name and power
    limit; fail unless there are `count` GPUs."""
    import jax
    devs = jax.devices()
    d = devs[0]
    log(f"[phase 0] device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    smi = nvidia_smi_name_power()
    for line in (smi or "nvidia-smi: not available").splitlines():
        log(line)
    if require_gpu:
        check(d.platform == "gpu", f"platform is gpu (got {d.platform})")
        check(len(devs) == count, f"{count} device(s) present")
        check(smi is not None, "nvidia-smi reports the card")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# phase A: kernels at real widths
# ---------------------------------------------------------------------------

def phase_kernels(n_tsne: int = LEVEL1_N, knn_scene: dict = PINES,
                  sample: int = 128, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp
    from sph_tpu.models import tsne as T
    from sph_tpu.ops.knn import knn_bruteforce

    log(f"[phase A] kernels (t-SNE n={n_tsne}, kNN "
        f"{knn_scene['rows'] * knn_scene['cols']}x{knn_scene['channels']} "
        f"k={knn_scene['k']})")
    rng = np.random.default_rng(seed)
    n = n_tsne
    # a spread like a converged level-1 embedding, and a symmetric joint
    # P with the level's ~180 entries per row
    y = (rng.standard_normal((n, 2)) * 15.0).astype(np.float32)
    p = np.zeros((n, n), np.float32)
    cols = rng.integers(0, n, (n, 90))
    p[np.arange(n)[:, None], cols] = rng.random((n, 90))
    p = (p + p.T) / 2
    np.fill_diagonal(p, 0.0)
    p /= p.sum()
    rows = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    attr_ref, rep_ref, z_ref = tsne_reference_rows(y, p, rows)

    # dense-P pass: f32 elementwise work and row sums, no matrix products
    block, npad = T.dense_tiling(n)
    yp = np.zeros((npad, 2), np.float32)
    yp[:n] = y
    pp = np.zeros((npad, npad), np.float32)
    pp[:n, :n] = p
    attr, rep, z = jax.block_until_ready(T._dense_forces(
        jnp.asarray(yp), jnp.asarray(pp), jnp.int32(n), block))
    attr, rep = np.asarray(attr), np.asarray(rep)
    e = (close_to(attr[rows], attr_ref), close_to(rep[rows], rep_ref),
         abs(float(z) - z_ref) / z_ref)
    log(f"  dense pass n={n} npad={npad}: rel err attr {e[0]:.2e} "
        f"rep {e[1]:.2e} Z {e[2]:.2e} (f32 vs float64, tol 1e-4)")
    check(max(e) <= 1e-4, "dense-P force pass matches float64 reference")
    check(not attr[n:].any() and not rep[n:].any(), "dense pass pad rows 0")

    # tiled exact repulsion: HIGHEST-precision dots through the
    # |a|^2 + |b|^2 - 2ab expansion, which loses ~eps * |y|^2 in d^2
    rblock = 512
    npad_r = T._ceil_to(n, rblock)
    yr = np.zeros((npad_r, 2), np.float32)
    yr[:n] = y
    rep2, z2 = jax.block_until_ready(T._repulsive_forces(
        jnp.asarray(yr), jnp.int32(n), rblock))
    rep2 = np.asarray(rep2)
    e2 = (close_to(rep2[rows], rep_ref), abs(float(z2) - z_ref) / z_ref)
    log(f"  tiled repulsion npad={npad_r}: rel err rep {e2[0]:.2e} "
        f"Z {e2[1]:.2e} (f32 HIGHEST vs float64, tol 1e-3)")
    check(max(e2) <= 1e-3, "tiled repulsion matches float64 reference")
    check(not rep2[n:].any(), "tiled repulsion pad rows 0")

    # memory of the compiled t-SNE step (dense tier, 50 iterations)
    pvec = jnp.zeros((8,), jnp.float32)
    lowered = T.tsne_iterations.lower(
        jnp.asarray(yp), jnp.zeros_like(jnp.asarray(yp)),
        jnp.ones_like(jnp.asarray(yp)), jnp.int32(0),
        jnp.zeros((npad, 1), jnp.int32), jnp.zeros((npad, 1), jnp.float32),
        jnp.int32(n), pvec, iters=50, block=block,
        p_dense=jnp.asarray(pp))
    log(f"  t-SNE step memory_analysis: "
        f"{lowered.compile().memory_analysis()}")

    # blocked kNN vs float64 brute force.  The streaming pass scores with
    # |a|^2 + |b|^2 - 2 a.b (HIGHEST), whose f32 rounding bound is
    # (D + 2) u (|a|^2 + |b|^2), u = 2^-24 (Higham, Thm 3.1): ~1e-3
    # relative in d at Pines norms (|x|^2 ~ 240, d^2 ~ 0.1).  Candidates
    # are then re-ranked by exact differences, so the returned d^2 sit far
    # inside that bound; the check holds each to it, and index sets may
    # differ only by ties within it.
    s = knn_scene
    data = scene(s["rows"], s["cols"], s["channels"], s["seed"])
    k = s["k"]
    idx, dist = knn_bruteforce(data, k)
    qrows = np.sort(rng.choice(data.shape[0], size=min(sample * 2,
                                                       data.shape[0]),
                               replace=False))
    x = data.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[qrows, None] + sq[None, :] - 2.0 * x[qrows] @ x.T
    d2[np.arange(qrows.size), qrows] = 0.0
    d2 = np.maximum(d2, 0.0)
    tol = (x.shape[1] + 2) * 2.0 ** -24 * (sq[qrows, None] + sq[None, :])
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    ties, worst, worst_rel = 0, 0.0, 0.0
    for r, q in enumerate(qrows):
        kth = d2[r, order[r, -1]]
        # a differing index is admissible only as a boundary tie: its
        # float64 d^2 is within twice the bound of the k-th
        for j in set(idx[q].tolist()) ^ set(order[r].tolist()):
            if abs(d2[r, j] - kth) > 2.0 * tol[r, j]:
                raise SmokeFailure(f"kNN row {q}: index {j} is not a "
                                   "boundary tie")
            ties += 1
        got2 = dist[q].astype(np.float64) ** 2
        err = np.abs(got2 - d2[r, idx[q]])
        worst = max(worst, float((err / tol[r, idx[q]]).max()))
        nz = d2[r, idx[q]] > 0
        worst_rel = max(worst_rel, float(
            (np.abs(dist[q] - np.sqrt(d2[r, idx[q]]))[nz]
             / np.sqrt(d2[r, idx[q]][nz])).max(initial=0.0)))
    log(f"  kNN {data.shape[0]}x{data.shape[1]} k={k}: {qrows.size} rows, "
        f"{ties // 2} boundary-tie swaps, max d^2 error {worst:.3f} of the "
        f"f32 bound, max relative distance error {worst_rel:.2e}")
    check(worst <= 1.0, "kNN index sets and distances match float64 "
                        "within the f32 rounding bound")


# ---------------------------------------------------------------------------
# phase B: levels
# ---------------------------------------------------------------------------

def checker_levels() -> list:
    """The 8x8 checker fingerprint; [64, 19, 2, 1] on every backend."""
    from sph_tpu import (ComputeHierarchy, ImageHierarchySettings,
                         ImageStack, LevelSimilaritiesSettings,
                         NearestNeighborsSettings, RandomWalkSettings,
                         Scaler, scale)
    from sph_tpu.utils.testdata import create_checker_image
    img = create_checker_image(8, 8, channels=4, block=2, noise=0.02)
    data = scale(ImageStack.from_array(img).data, Scaler.STANDARD)
    ch = ComputeHierarchy().init(
        data, 8, 8, ihs=ImageHierarchySettings(),
        lss=LevelSimilaritiesSettings(ks=[8]),
        rws=RandomWalkSettings(num_random_walks=10, single_walk_length=5,
                               random_seed=1),
        nns=NearestNeighborsSettings(num_nearest_neighbors=8))
    ch.compute()
    return [int(c) for c in ch.image_hierarchy.hierarchy.num_components]


def mid_scene(s: dict = MID, device_merges: bool | None = None,
              pd=None):
    """(levels, ImageHierarchy) of the 64x64x200 scene.  device_merges
    forces the merge and symmetrize path (None: the backend's default,
    host on the CPU); pd replaces the data-level P this backend computes."""
    env = os.environ.get("SPH_DEVICE_RESTRUCT")
    if device_merges is not None:
        os.environ["SPH_DEVICE_RESTRUCT"] = "1" if device_merges else "0"
    try:
        from sph_tpu import ComputeHierarchy
        ch = ComputeHierarchy().init(
            scene(s["rows"], s["cols"], s["channels"], s["seed"]),
            s["rows"], s["cols"], **pines_settings(s["k"]))
        ch.compute_knn_graph()
        if pd is not None:
            ch.image_hierarchy.set_preparations(pd)
        ch.compute_image_hierarchy()
    finally:
        if env is None:
            os.environ.pop("SPH_DEVICE_RESTRUCT", None)
        else:
            os.environ["SPH_DEVICE_RESTRUCT"] = env
    ih = ch.image_hierarchy
    return [int(c) for c in ih.hierarchy.num_components], ih


def cpu_mid_scene(s: dict = MID):
    """(levels, data-level P) of the 64x64x200 scene as the CPU computes
    them, in a child process that sees only the CPU and so never opens
    the card."""
    from sph_tpu.ops.sparse import SparseRows
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"import chip_smoke; chip_smoke.print_cpu_mid_scene({s!r})")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         stdout=subprocess.PIPE, text=True, check=True,
                         timeout=900).stdout
    z = np.load(io.BytesIO(base64.b64decode(out.strip().splitlines()[-1])))
    return (z["levels"].tolist(),
            SparseRows(z["idx"], z["val"], s["rows"] * s["cols"]))


def print_cpu_mid_scene(s: dict) -> None:
    """Child side of cpu_mid_scene: the levels and P, base64 npz, as the
    last line of standard output."""
    import jax
    from sph_tpu.utils.logging import set_level
    set_level("WARNING")
    assert jax.default_backend() == "cpu"
    levels, ih = mid_scene(s)
    pd = ih.data_level_probdist
    buf = io.BytesIO()
    np.savez(buf, levels=np.asarray(levels), idx=np.asarray(pd.indices),
             val=np.asarray(pd.values))
    print(base64.b64encode(buf.getvalue()).decode(), flush=True)


def phase_levels() -> None:
    """The checker fingerprint; then the 64x64x200 scene against the
    CPU-recorded fixture.  This backend's own P differs from the CPU's in
    the last bits of exp/log, and the walk sampler turns that into a few
    different components (PERF.md), so the exact check feeds the CPU's P,
    computed in a child process, to this backend's walks and merges; its
    own P is held to the CPU's within 1e-5, and its device merges to its
    host merges exactly."""
    log("[phase B] hierarchy levels against the CPU-recorded fixture")
    got = checker_levels()
    check(got == [64, 19, 2, 1], f"8x8 checker levels {got}")
    with open(FIXTURE) as f:
        want = json.load(f)["levels"]
    cpu_levels, cpu_pd = cpu_mid_scene()
    check(cpu_levels == want, f"CPU child process: 64x64x200 levels "
                              f"{cpu_levels} == fixture {want}")
    fed, _ = mid_scene(device_merges=True, pd=cpu_pd)
    check(fed == want, f"from the CPU's P, this backend's walks and "
                       f"device merges give the fixture {fed}")
    dev, ih = mid_scene(device_merges=True)
    host, _ = mid_scene(device_merges=False)
    check(dev == host, f"own P: device merges {dev} == host merges {host}")
    pdiff = abs(_as_csr(ih.data_level_probdist) - _as_csr(cpu_pd)).max()
    check(pdiff <= 1e-5, f"own data-level P within {pdiff:.2e} of the "
                         f"CPU's (f32, tol 1e-5)")


# ---------------------------------------------------------------------------
# phase C: the Pines pipeline at full width
# ---------------------------------------------------------------------------

def pipeline_invariants(ch, ce, emb, anchor_kl) -> None:
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    check(all(b < a for a, b in zip(levels, levels[1:])),
          f"levels strictly decrease {levels}")
    for lv, par in enumerate(h.parents):
        par = np.asarray(par)
        ok = (par.shape[0] == levels[lv] and par.min() >= 0
              and np.bincount(par, minlength=levels[lv + 1]).min() >= 1
              and par.max() < levels[lv + 1])
        check(ok, f"parents of level {lv} partition it into "
                  f"{levels[lv + 1]} non-empty parents")
    pd = ch.level_similarities.get_prob_dist(1)
    rs = pd.row_sums()
    n = pd.num_rows
    # P = (P_row + P_row^T) / 2 with unit rows: the total is n and every
    # row keeps at least its own half
    check(abs(rs.sum() - n) <= 1e-3 * n and rs.min() >= 0.5 - 1e-3,
          f"level-1 P rows from unit rows (total {rs.sum():.4f} / {n}, "
          f"min row {rs.min():.4f})")
    check(emb.shape == (n, 2) and np.isfinite(emb).all(),
          f"embedding finite, shape {emb.shape}")
    check(ce.last_kl is not None and ce.last_kl <= 1.01 * anchor_kl,
          f"KL {ce.last_kl:.5f} <= 1.01 x sklearn-BH anchor {anchor_kl}")


def phase_pipeline(s: dict = PINES, iters: int = 2000,
                   anchor_kl: float | None = None) -> list:
    import jax
    from sph_tpu import ComputeEmbedding, ComputeEmbeddingSettings
    from sph_tpu.utils.compile_count import count_compiles

    log(f"[phase C] pipeline {s['rows']}x{s['cols']}x{s['channels']} "
        f"k={s['k']}, level-1 t-SNE {iters} iterations")
    if anchor_kl is None:
        with open(ANCHOR) as f:
            anchor_kl = json.load(f)["kl_under_p_sklearn_bh"]
    data = scene(s["rows"], s["cols"], s["channels"], s["seed"])
    runs = []
    for label in ("cold", "warm"):
        with count_compiles() as cc:
            t0 = time.perf_counter()
            ch = hierarchy(data, s["rows"], s["cols"], s["k"])
            t1 = time.perf_counter()
            es = ComputeEmbeddingSettings()
            es.tsne.num_iterations = iters
            ce = ComputeEmbedding(es)
            emb = ce.compute_tsne(ch.level_similarities.get_prob_dist(1),
                                  track_kl=True)
            t2 = time.perf_counter()
        levels = [int(c) for c in
                  ch.image_hierarchy.hierarchy.num_components]
        log(f"  {label}: hierarchy {t1 - t0:.3f} s, t-SNE {t2 - t1:.3f} s, "
            f"total {t2 - t0:.3f} s, compiles {cc.total}, levels {levels}, "
            f"KL {ce.last_kl:.5f} (smoke timing, not a benchmark)")
        runs.append(levels)
    check(runs[0] == runs[1], "cold and warm runs give the same levels")
    pipeline_invariants(ch, ce, emb, anchor_kl)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    for line in (nvidia_smi_name_power() or "nvidia-smi: n/a").splitlines():
        log(f"  card: {line}")
    return runs[1]


# ---------------------------------------------------------------------------
# --multi: the sharded paths on four cards
# ---------------------------------------------------------------------------

def phase_multi(n_dev: int = 4, s: dict = PINES, n_tsne: int = LEVEL1_N,
                steps: int = 5, scenes: int = 4) -> None:
    import jax.numpy as jnp
    from sph_tpu import ComputeHierarchy
    from sph_tpu.models.tsne import (TsneParameters, default_exaggeration,
                                     tsne_iterations)
    from sph_tpu.ops.knn import knn_bruteforce
    from sph_tpu.parallel.mesh import make_mesh, shard_rows
    from sph_tpu.parallel.sharded import (make_sharded_tsne_step,
                                          multi_scene_hierarchy, sharded_knn)

    mesh = make_mesh(n_dev)
    log(f"[multi] mesh {dict(mesh.shape)} over "
        f"{[str(d) for d in mesh.devices.flat]}")

    data = scene(s["rows"], s["cols"], s["channels"], s["seed"])
    k = s["k"]
    idx_s, dist_s = sharded_knn(data, k, mesh)
    idx_1, dist_1 = knn_bruteforce(data, k)
    same = np.mean([set(a) == set(b) for a, b in zip(idx_s, idx_1)])
    derr = float(np.abs(dist_s - dist_1).max())
    log(f"  sharded_knn {data.shape}: rows with identical index sets "
        f"{same:.6f}, max |dist diff| {derr:.2e}")
    check(same == 1.0 and derr <= 1e-4 * float(dist_1.max()),
          "sharded kNN equals single-device kNN")

    # t-SNE: a sparse level-1-sized P, a few steps each way
    rng = np.random.default_rng(0)
    n = n_tsne
    npad = ((n + 8 * n_dev - 1) // (8 * n_dev)) * (8 * n_dev)
    r = 128
    pi = np.full((npad, r), -1, np.int32)
    pv = np.zeros((npad, r), np.float32)
    pi[:n] = rng.integers(0, n, (n, r))
    pv[:n] = rng.random((n, r))
    pv /= pv.sum()
    params = TsneParameters()
    params.exaggeration_factor = default_exaggeration(n)
    pvec = jnp.asarray([params.eta, params.momentum, params.final_momentum,
                        params.mom_switching_iter,
                        params.exaggeration_factor,
                        params.remove_exaggeration_iter,
                        params.exponential_decay_iter,
                        params.minimum_gain], jnp.float32)
    y0 = np.zeros((npad, 2), np.float32)
    y0[:n] = rng.standard_normal((n, 2)) * 5
    ys = shard_rows(mesh, jnp.asarray(y0))
    vel = shard_rows(mesh, jnp.zeros((npad, 2), jnp.float32))
    gain = shard_rows(mesh, jnp.ones((npad, 2), jnp.float32))
    pis, pvs = shard_rows(mesh, jnp.asarray(pi)), shard_rows(
        mesh, jnp.asarray(pv))
    check(len(ys.sharding.device_set) == n_dev
          and len(pis.sharding.device_set) == n_dev,
          f"t-SNE state sharded over {n_dev} devices")
    step = make_sharded_tsne_step(mesh)
    for it in range(steps):
        ys, vel, gain = step(ys, vel, gain, pis, pvs, jnp.int32(n), pvec,
                             jnp.int32(it))
    y1, _, _, _ = tsne_iterations(
        jnp.asarray(y0), jnp.zeros((npad, 2), jnp.float32),
        jnp.ones((npad, 2), jnp.float32), jnp.int32(0), jnp.asarray(pi),
        jnp.asarray(pv), jnp.int32(n), pvec, iters=steps, block=npad // 8)
    err = close_to(np.asarray(ys), np.asarray(y1))
    log(f"  sharded t-SNE {steps} steps at n={n}: rel err {err:.2e} "
        f"(f32 HIGHEST both sides, tol 1e-4)")
    check(err <= 1e-4, "sharded t-SNE step equals tsne_iterations")

    # multi-scene hierarchy: the kNN of every scene in one program over
    # the mesh, then each scene's P, walks and levels; scene i walks with
    # seed base + i.  Each must equal a per-scene ComputeHierarchy.
    datas = np.stack([scene(s["rows"], s["cols"], s["channels"],
                            s["seed"] + i) for i in range(scenes)])
    st = pines_settings(k, connect=False)
    res = multi_scene_hierarchy(datas, s["rows"], s["cols"], k,
                                ihs=st["ihs"], rws=st["rws"], mesh=mesh)
    for i, (ih, _) in enumerate(res):
        serial = pines_settings(k, connect=False,
                                seed=st["rws"].random_seed + i)
        ch = ComputeHierarchy().init(datas[i], s["rows"], s["cols"],
                                     ihs=serial["ihs"], rws=serial["rws"],
                                     nns=serial["nns"])
        ch.compute_knn_graph()
        ch.compute_image_hierarchy()
        idx_m = np.asarray(ih._graph.indices)
        idx_s = np.asarray(ch.knn_stage.knn_graph.indices)
        same = np.mean([set(a) == set(b) for a, b in zip(idx_m, idx_s)])
        check(same == 1.0, f"scene {i}: batched kNN index sets equal "
                           "single-device")
        want = [int(c) for c in ch.image_hierarchy.hierarchy.num_components]
        got = [int(c) for c in ih.hierarchy.num_components]
        check(got == want, f"scene {i}: multi-scene levels {got} == "
                           f"single-device {want}")


def _as_csr(rows):
    import scipy.sparse as sp
    idx, val = np.asarray(rows.indices), np.asarray(rows.values)
    ok = idx >= 0
    r = np.broadcast_to(np.arange(idx.shape[0])[:, None], idx.shape)
    return sp.csr_matrix((val[ok].astype(np.float64), (r[ok], idx[ok])),
                         shape=(idx.shape[0], rows.num_cols))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four devices")
    args = ap.parse_args(argv)

    from sph_tpu.utils.logging import set_level
    set_level("WARNING")
    cache = enable_compile_cache()
    log(f"compile cache: {cache}")
    t0 = time.perf_counter()
    if args.multi:
        dev = phase_device(count=4)
        phase_multi()
    else:
        dev = phase_device()
        phase_kernels()
        phase_levels()
        phase_pipeline()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
