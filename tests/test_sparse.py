"""Sparse-row algebra tests (mirrors reference UtilsTests sections on sparse
matrix behavior, node merging, top-k deques, and the random-walk-similarity
benchmark variants' agreement)."""

import numpy as np
import pytest

from sph_tpu.ops.sparse import (SparseRows, _compact,
                                bhattacharyya_pairs,
                                merge_rows_by_parents,
                                merge_rows_min_by_parents, normalize_matrix,
                                normalize_rows, pairwise_similarities,
                                prune_values, remove_diagonal,
                                symmetrize_tsne, symmetrize_umap, topk_rows)


def make_rows(dense):
    return SparseRows.from_dense(np.asarray(dense, dtype=np.float32))


def test_roundtrip_dense():
    d = np.array([[0, 1, 0, 2], [3, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    sr = make_rows(d)
    assert np.allclose(sr.to_dense(), d)
    assert sr.nnz() == 3


def test_normalize_rows():
    sr = make_rows([[0, 2, 2], [1, 0, 0], [0, 0, 0]])
    n = normalize_rows(sr)
    dn = n.to_dense()
    assert np.allclose(dn[0], [0, 0.5, 0.5])
    assert np.allclose(dn[1], [1, 0, 0])


def test_normalize_matrix():
    sr = make_rows([[0, 2], [2, 0]])
    n = normalize_matrix(sr)
    assert np.isclose(n.to_dense().sum(), 1.0)


def test_remove_diagonal_keeps_single():
    sr = make_rows([[1, 2, 0], [0, 5, 0], [1, 0, 3]])
    out = remove_diagonal(sr, keep_single_entry=True)
    d = out.to_dense()
    assert d[0, 0] == 0 and d[0, 1] == 2
    assert d[1, 1] == 5          # single entry kept
    assert d[2, 2] == 0 and d[2, 0] == 1


def test_prune():
    sr = make_rows([[0.1, 0.5, 0.05]])
    out = prune_values(sr, 0.1)  # <= threshold removed
    d = out.to_dense()
    assert np.allclose(d, [[0, 0.5, 0]])


def test_topk_rows():
    sr = make_rows([[0.5, 0.1, 0.9, 0.3]])
    top = topk_rows(sr, 2, largest=True)
    d = top.to_dense()
    assert np.allclose(d, [[0.5, 0, 0.9, 0]])
    bot = topk_rows(sr, 2, largest=False)
    assert np.allclose(bot.to_dense(), [[0, 0.1, 0, 0.3]])


def test_merge_by_parents_unweighted():
    # 4 nodes -> 2 parents {0,1}->0, {2,3}->1
    dense = np.array([[0, 1, 2, 0],
                      [1, 0, 0, 3],
                      [2, 0, 0, 1],
                      [0, 3, 1, 0]], np.float32)
    sr = make_rows(dense)
    parents = np.array([0, 0, 1, 1])
    merged = merge_rows_by_parents(sr, parents, 2, weight_by_size=False)
    # expected: group-sum rows then columns
    exp = np.zeros((2, 2), np.float32)
    for i in range(4):
        for j in range(4):
            exp[parents[i], parents[j]] += dense[i, j]
    assert np.allclose(merged.to_dense(), exp)


def test_merge_by_parents_weighted():
    dense = np.array([[0, 1, 1, 0],      # nnz 2
                      [1, 0, 0, 0],      # nnz 1
                      [0, 0, 0, 2],      # nnz 1
                      [0, 0, 2, 0]], np.float32)
    sr = make_rows(dense)
    parents = np.array([0, 0, 1, 1])
    merged = merge_rows_by_parents(sr, parents, 2, weight_by_size=True)
    # row weights: r0=2, r1=1 -> parent0 weight 3; r2=1, r3=1 -> parent1 w 2
    exp = np.zeros((2, 2), np.float64)
    w = [2, 1, 1, 1]
    for i in range(4):
        for j in range(4):
            exp[parents[i], parents[j]] += dense[i, j] * w[i]
    exp[0] /= 3
    exp[1] /= 2
    assert np.allclose(merged.to_dense(), exp, atol=1e-6)


def test_merge_min_by_parents():
    dense = np.array([[0, 5, 2, 0],
                      [5, 0, 0, 3],
                      [2, 0, 0, 1],
                      [0, 3, 1, 0]], np.float32)
    sr = make_rows(dense)
    parents = np.array([0, 0, 1, 1])
    merged = merge_rows_min_by_parents(sr, parents, 2)
    d = merged.to_dense()
    assert d[0, 0] == 5          # min of nonzero intra-group (5)
    assert d[0, 1] == 2          # min(2, 3)
    assert d[1, 0] == 2
    assert d[1, 1] == 1


def test_bhattacharyya_pairs():
    p = make_rows([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.25, 0.25, 0.5]])
    bc = bhattacharyya_pairs(p, np.array([0, 0]), np.array([1, 2]))
    # BC(0,1) = sqrt(.5*.5) = .5
    assert np.isclose(bc[0], 0.5, atol=1e-6)
    exp = np.sqrt(0.5 * 0.25) + np.sqrt(0.5 * 0.25)
    assert np.isclose(bc[1], exp, atol=1e-6)


def test_pairwise_similarities_vs_naive():
    rng = np.random.default_rng(0)
    dense = rng.random((20, 20)).astype(np.float32)
    dense[dense < 0.5] = 0  # sparsify
    dense = dense / np.maximum(dense.sum(1, keepdims=True), 1e-9)
    sr = make_rows(dense)
    out = pairwise_similarities(sr, k=5, prune_val=1e-4, block=8)

    sq = np.sqrt(dense)
    bc = sq @ sq.T
    for i in range(20):
        d = np.where((bc[i] > 1e-4) & (np.arange(20) != i),
                     -np.log(np.maximum(bc[i], 1e-38)), np.inf)
        kk = min(5, np.isfinite(d).sum())
        sel = np.argsort(d)[:kk]
        vals = d[sel]
        vals = vals / vals.sum() if vals.sum() > 0 else vals
        got = out.to_dense()[i]
        exp = np.zeros(20, np.float32)
        exp[sel] = vals
        assert np.allclose(got, exp, atol=1e-4), i


def test_pairwise_similarities_width_cap(monkeypatch):
    """SPH_PAIRWISE_WIDTH caps wide walk rows before the blocked product
    (the uncapped [29k, 8192] working set runs to many GB);
    on structured walk-like rows the capped result is numerically the
    uncapped one."""
    from sph_tpu.ops.sparse import SparseRows

    n, w = 256, 96
    rng = np.random.default_rng(3)
    offs = np.arange(w) - w // 2
    idx = (np.arange(n)[:, None] + offs[None, :]) % n
    order = np.argsort(idx, axis=1)
    idx = np.take_along_axis(idx, order, 1).astype(np.int32)
    base = np.exp(-np.abs(offs) / 4.0)[None, :] * (0.5 + rng.random((n, w)))
    val = np.take_along_axis(base, order, 1).astype(np.float32)
    val /= val.sum(1, keepdims=True)

    monkeypatch.setenv("SPH_PAIRWISE_WIDTH", "0")
    ref = pairwise_similarities(SparseRows(idx, val, n), k=7, block=32)
    monkeypatch.setenv("SPH_PAIRWISE_WIDTH", "64")
    cap = pairwise_similarities(SparseRows(idx, val, n), k=7, block=32)
    assert cap.indices.shape[1] <= ref.indices.shape[1]
    np.testing.assert_allclose(cap.to_dense(), ref.to_dense(), atol=5e-3)


def test_symmetrize_tsne():
    sr = make_rows([[0, 0.6, 0.4], [0.2, 0, 0.8], [0, 0, 0]])
    s = symmetrize_tsne(sr).to_dense()
    assert np.isclose(s[0, 1], 0.4) and np.isclose(s[1, 0], 0.4)
    assert np.isclose(s[0, 2], 0.2) and np.isclose(s[2, 0], 0.2)
    assert np.allclose(s, s.T)


def test_symmetrize_wrev_cap_sheds_faintest(monkeypatch):
    """When SPH_SYM_WREV_MAX is smaller than a hub column's in-degree, the
    symmetrized hub row keeps the LARGEST reverse contributions (the flat
    restructuring sorts by (row, value desc)) and every non-hub row is
    exact."""
    from sph_tpu.ops.sparse import SparseRows

    n = 12
    # every row points at hub column 0 with distinct values; hub row itself
    # has a single forward entry
    idx = np.full((n, 2), -1, np.int32)
    val = np.zeros((n, 2), np.float32)
    idx[1:, 0] = 0
    val[1:, 0] = np.linspace(0.1, 1.0, n - 1).astype(np.float32)
    idx[0, 0] = 5
    val[0, 0] = 0.5

    def dev_rows():
        # device-resident input so symmetrize takes the device dispatch
        # (the scipy fallback has no width bound to exercise)
        import jax.numpy as jnp
        return SparseRows(jnp.asarray(idx), jnp.asarray(val), n)

    ref = symmetrize_tsne(dev_rows()).to_dense()

    monkeypatch.setenv("SPH_SYM_WREV_MAX", "4")
    capped = symmetrize_tsne(dev_rows()).to_dense()
    monkeypatch.delenv("SPH_SYM_WREV_MAX")

    # hub row 0: the 4 largest reverse values survive (plus the forward
    # edge to 5, which rides the forward lane and is never shed)
    kept = np.nonzero(capped[0])[0]
    assert len(kept) < len(np.nonzero(ref[0])[0])  # the cap really shed
    largest = set(np.argsort(-ref[0])[:len(kept)])
    assert set(kept) <= largest | {5}
    assert capped[0, 5] > 0
    # non-hub rows are bit-identical
    np.testing.assert_array_equal(capped[1:], ref[1:])


def test_symmetrize_zero_rows_device():
    """The device dispatch must handle an empty matrix (review finding:
    jnp.max over [0] counts raised before the row padding guaranteed a
    non-empty kernel shape)."""
    import jax.numpy as jnp
    from sph_tpu.ops.sparse import SparseRows

    empty = SparseRows(jnp.zeros((0, 4), jnp.int32) - 1,
                       jnp.zeros((0, 4), jnp.float32), 0)
    out = symmetrize_tsne(empty)
    assert out.num_rows == 0


def test_symmetrize_umap_gate_no_renorm(monkeypatch):
    """The memory-gate width cap must NOT renormalize UMAP fuzzy
    memberships (they are not row-normalized; t-SNE rows are).  With a cap
    wider than every row's nnz, the gated result equals the ungated one."""
    import jax.numpy as jnp
    from sph_tpu.ops.sparse import SparseRows

    n, w = 16, 8
    rng = np.random.default_rng(5)
    idx = np.sort(rng.integers(0, n, size=(n, w)), axis=1).astype(np.int32)
    dup = np.zeros_like(idx, dtype=bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    idx = np.where(dup, -1, idx)
    idx[:, -1] = -1  # keep every row's nnz strictly below the cap
    val = np.where(idx >= 0, rng.random((n, w), np.float32) * 0.9, 0)

    ref = symmetrize_umap(SparseRows(jnp.asarray(idx), jnp.asarray(val),
                                     n)).to_dense()
    monkeypatch.setenv("SPH_SYM_FLAT_BUDGET", "1")   # force the gate on
    monkeypatch.setenv("SPH_SYM_P_WIDTH_CAP", str(w - 1))
    gated = symmetrize_umap(SparseRows(jnp.asarray(idx), jnp.asarray(val),
                                       n)).to_dense()
    np.testing.assert_allclose(gated, ref, atol=1e-6)


def test_symmetrize_umap():
    sr = make_rows([[0, 0.6, 0], [0.2, 0, 0], [0, 0, 0]])
    s = symmetrize_umap(sr).to_dense()
    exp = 0.6 + 0.2 - 0.6 * 0.2
    assert np.isclose(s[0, 1], exp) and np.isclose(s[1, 0], exp)


def test_merge_width_cap_mega_component():
    """One mega merge-component must not blow the padded width: max_width
    keeps the largest values per row (the entries a value prune keeps)."""
    rng = np.random.default_rng(0)
    n, r = 5000, 16
    idx = np.sort(rng.integers(0, n, (n, r)).astype(np.int32), axis=1)
    # dedupe
    dup = np.zeros_like(idx, dtype=bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    idx = np.where(dup, -1, idx)
    val = np.where(idx >= 0, rng.random((n, r)).astype(np.float32), 0)
    sr = _compact(idx, val, n)

    # everything merges into component 0 except a few
    parents = np.zeros(n, dtype=np.int64)
    parents[:10] = np.arange(10)
    merged_cap = merge_rows_by_parents(sr, parents, 10, max_width=64)
    assert merged_cap.indices.shape[1] <= 64
    merged_full = merge_rows_by_parents(sr, parents, 10)
    # the capped result keeps the largest-value entries of the full merge
    full_row = {int(i): float(v) for i, v in
                zip(merged_full.indices[0], merged_full.values[0]) if i >= 0}
    top64 = sorted(full_row.values(), reverse=True)[:64]
    cap_vals = sorted((float(v) for i, v in
                       zip(merged_cap.indices[0], merged_cap.values[0])
                       if i >= 0), reverse=True)
    assert np.allclose(cap_vals, top64[:len(cap_vals)], rtol=1e-6)
    # ascending-index invariant preserved
    ci = merged_cap.indices[0]
    ci = ci[ci >= 0]
    assert np.all(np.diff(ci) > 0)


def test_merge_min_width_cap():
    rng = np.random.default_rng(1)
    n, r = 3000, 12
    idx = np.sort(rng.integers(0, n, (n, r)).astype(np.int32), axis=1)
    dup = np.zeros_like(idx, dtype=bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    idx = np.where(dup, -1, idx)
    val = np.where(idx >= 0,
                   rng.random((n, r)).astype(np.float32) + 0.01, 0)
    sr = _compact(idx, val, n)
    parents = np.zeros(n, dtype=np.int64)
    parents[:5] = np.arange(5)
    capped = merge_rows_min_by_parents(sr, parents, 5, max_width=32)
    full = merge_rows_min_by_parents(sr, parents, 5)
    assert capped.indices.shape[1] <= 32
    # smallest distances kept
    fvals = sorted(float(v) for i, v in
                   zip(full.indices[0], full.values[0]) if i >= 0)
    cvals = sorted(float(v) for i, v in
                   zip(capped.indices[0], capped.values[0]) if i >= 0)
    assert np.allclose(cvals, fvals[:len(cvals)], rtol=1e-6)
    ci = capped.indices[0]
    ci = ci[ci >= 0]
    assert np.all(np.diff(ci) > 0)
