"""Fixed-width sparse row algebra.

Reference: the Eigen `SparseVecSPH` / HDILib `MapMemEff` row types
(sph/utils/CommonDefinitions.hpp:86-105) and their algorithms in
sph/utils/SparseMatrixAlgorithms.cpp — row/matrix normalization, diagonal
removal, node merging by parents, pairwise Bhattacharyya similarities as
blocked sqrt(A)*sqrt(A)^T with per-row top-k (createSimilaritiesHDI,
:1173-1378).

Redesign: ragged sparse rows become fixed-width padded arrays
`indices [N, R] / values [N, R]` (pad index -1, pad value 0, rows sorted by
index).  Bulk numerics (the A*A^T similarity matmul) run as dense blocked
matmuls with streaming top-k — the direct analogue of the
reference's 1000-row blocked sparse multiply, but laid out for the systolic
array instead of CSR pointer chasing.  One-shot restructurings (merge by
parents) are vectorized host ops.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import Log

PAD = -1


class SparseRows:
    """Row-sparse matrix with fixed-width rows.

    indices: [N, R] int32, PAD (-1) padded, ascending within each row
    values:  [N, R] float32, 0 at pads
    num_cols: logical column count of the matrix

    Dual residency: the constructor accepts numpy OR jax arrays.  Device
    consumers call `.device()` (uploads once, cached); host consumers read
    `.indices` / `.values` (downloads once, cached).  A device-produced
    matrix that only feeds device ops never crosses the host boundary:
    every crossing costs a synchronization plus a transfer.
    """

    __slots__ = ("_idx_np", "_val_np", "_idx_dev", "_val_dev", "num_cols")

    def __init__(self, indices, values, num_cols: int):
        if isinstance(indices, jax.Array):
            self._idx_dev, self._idx_np = indices, None
        else:
            self._idx_np, self._idx_dev = np.asarray(indices), None
        if isinstance(values, jax.Array):
            self._val_dev, self._val_np = values, None
        else:
            self._val_np, self._val_dev = np.asarray(values), None
        self.num_cols = num_cols

    @property
    def indices(self) -> np.ndarray:
        if self._idx_np is None:
            self._idx_np = np.asarray(self._idx_dev)
        return self._idx_np

    @property
    def values(self) -> np.ndarray:
        if self._val_np is None:
            self._val_np = np.asarray(self._val_dev)
        return self._val_np

    @property
    def on_device(self) -> bool:
        """True when device copies exist (no upload needed)."""
        return self._idx_dev is not None and self._val_dev is not None

    @property
    def device_only(self) -> bool:
        """True when the host copies were never materialized; device-path
        dispatchers use this to avoid pointless download+reupload."""
        return (self._idx_dev is not None and self._idx_np is None
                and self._val_np is None)

    def device(self) -> Tuple[jax.Array, jax.Array]:
        """Device copies of (indices, values); uploaded once and cached."""
        if self._idx_dev is None:
            self._idx_dev = jnp.asarray(self._idx_np)
        if self._val_dev is None:
            self._val_dev = jnp.asarray(self._val_np)
        return self._idx_dev, self._val_dev

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1]

    @property
    def shape(self) -> tuple:
        src = self._idx_np if self._idx_np is not None else self._idx_dev
        return src.shape

    @property
    def mask(self) -> np.ndarray:
        return self.indices >= 0

    def nnz(self) -> int:
        if self.device_only:
            return int(np.asarray(_nnz_rows_dev(*self.device())).sum())
        return int((self.mask & (self.values != 0)).sum())

    def row_nnz(self) -> np.ndarray:
        if self.device_only:
            return np.asarray(_nnz_rows_dev(*self.device()))
        return (self.mask & (self.values != 0)).sum(axis=1)

    def row_sums(self) -> np.ndarray:
        if self.device_only:
            idx, val = self.device()
            return np.asarray(jnp.sum(jnp.where(idx >= 0, val, 0.0), axis=1))
        return np.where(self.mask, self.values, 0.0).sum(axis=1)

    def get(self, row: int, col: int) -> float:
        m = (self.indices[row] == col)
        return float(self.values[row][m].sum()) if m.any() else 0.0

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.num_rows, self.num_cols), dtype=np.float32)
        r = np.repeat(np.arange(self.num_rows), self.width)
        c = self.indices.ravel()
        v = self.values.ravel()
        ok = c >= 0
        np.add.at(out, (r[ok], c[ok]), v[ok])
        return out

    @classmethod
    def from_dense(cls, dense: np.ndarray, width: Optional[int] = None
                   ) -> "SparseRows":
        dense = np.asarray(dense, dtype=np.float32)
        n, c = dense.shape
        nnz = (dense != 0).sum(axis=1)
        w = int(nnz.max()) if width is None else width
        w = max(w, 1)
        indices = np.full((n, w), PAD, dtype=np.int32)
        values = np.zeros((n, w), dtype=np.float32)
        for i in range(n):
            cols = np.nonzero(dense[i])[0][:w]
            indices[i, :len(cols)] = cols
            values[i, :len(cols)] = dense[i, cols]
        return cls(indices, values, c)

    @classmethod
    def from_lists(cls, rows: list, num_cols: int,
                   width: Optional[int] = None) -> "SparseRows":
        """rows: list of {col: val} dicts or [(col, val)] lists."""
        norm_rows = []
        for r in rows:
            items = sorted(r.items()) if isinstance(r, dict) else sorted(r)
            norm_rows.append(items)
        w = width or max((len(r) for r in norm_rows), default=1)
        w = max(w, 1)
        n = len(norm_rows)
        indices = np.full((n, w), PAD, dtype=np.int32)
        values = np.zeros((n, w), dtype=np.float32)
        for i, items in enumerate(norm_rows):
            for j, (c, v) in enumerate(items[:w]):
                indices[i, j] = c
                values[i, j] = v
        return cls(indices, values, num_cols)

    def copy(self) -> "SparseRows":
        if self.device_only:
            # device arrays are immutable: sharing them is a safe copy
            idx, val = self.device()
            return SparseRows(idx, val, self.num_cols)
        return SparseRows(self.indices.copy(), self.values.copy(),
                          self.num_cols)


# ---------------------------------------------------------------------------
# normalization / cleanup (reference: SparseMatrixAlgorithms.cpp:617-718)
# ---------------------------------------------------------------------------
# Each op has a host (numpy) and a device (jit) body; the public function
# dispatches on residency so device-resident chains never round-trip.

@jax.jit
def _compact_dev(idx: jax.Array, val: jax.Array):
    # multi-operand lane sort: argsort + take_along_axis would lower to
    # per-element lane gathers (the slow path this avoids)
    big = jnp.int32(2**31 - 1)
    key = jnp.where(idx < 0, big, idx)
    _, oi, ov = jax.lax.sort((key, idx, val), num_keys=1, dimension=1,
                             is_stable=True)
    return oi, ov


@jax.jit
def _normalize_rows_dev(idx: jax.Array, val: jax.Array):
    s = jnp.sum(jnp.where(idx >= 0, val, 0.0), axis=1, keepdims=True)
    return val / jnp.where(s == 0, 1.0, s)


# Tiny fused utility programs.  Eager jnp expressions compile one XLA
# program PER OP per shape (a row_nnz was 4: >=, !=, &, reduce); each
# costs ~20-30 ms of compile and a dispatch.  These fused helpers are the
# single compile unit every call site shares (bench.py counts them:
# compiled_programs_hierarchy).

@jax.jit
def _nnz_rows_dev(idx: jax.Array, val: jax.Array) -> jax.Array:
    return jnp.sum((idx >= 0) & (val != 0), axis=1)


@functools.partial(jax.jit, static_argnames=("rpad", "wpad"))
def _pad_pair_dev(idx: jax.Array, val: jax.Array, rpad: int, wpad: int):
    n, w = idx.shape
    return (jnp.pad(idx, ((0, rpad - n), (0, wpad - w)),
                    constant_values=PAD),
            jnp.pad(val, ((0, rpad - n), (0, wpad - w)),
                    constant_values=0.0))


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _slice_pair_dev(idx: jax.Array, val: jax.Array, rows: int, cols: int):
    return idx[:rows, :cols], val[:rows, :cols]


@jax.jit
def _drop_zero_dev(idx: jax.Array, val: jax.Array):
    keep = val != 0
    return _compact_dev(jnp.where(keep, idx, PAD),
                        jnp.where(keep, val, 0.0))


@functools.partial(jax.jit, static_argnames=("keep_single",))
def _remove_diagonal_dev(idx: jax.Array, val: jax.Array, keep_single: bool):
    n, r = idx.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, r), 0)
    diag = idx == rows
    if keep_single:
        nnz = jnp.sum((idx >= 0) & (val != 0), axis=1, keepdims=True)
        diag = diag & (nnz > 1)
    val2 = jnp.where(diag, 0.0, val)
    idx2 = jnp.where(diag & (val2 == 0), PAD, idx)
    return _compact_dev(idx2, val2)


@jax.jit
def _prune_values_dev(idx: jax.Array, val: jax.Array, threshold: jax.Array):
    keep = val > threshold
    return _compact_dev(jnp.where(keep, idx, PAD),
                        jnp.where(keep, val, 0.0))


def normalize_rows(sr: SparseRows) -> SparseRows:
    """Each row sums to one (normalizeUnitSparseMatrix)."""
    if sr.device_only:
        idx, val = sr.device()
        return SparseRows(idx, _normalize_rows_dev(idx, val), sr.num_cols)
    s = sr.row_sums()
    s = np.where(s == 0, 1.0, s)
    return SparseRows(sr.indices, (sr.values / s[:, None]).astype(np.float32),
                      sr.num_cols)


def normalize_matrix(sr: SparseRows) -> SparseRows:
    """The whole matrix sums to one (normalizeSparseMatrix)."""
    if sr.device_only:
        idx, val = sr.device()
        s = jnp.sum(jnp.where(idx >= 0, val, 0.0))
        return SparseRows(idx, val / jnp.where(s == 0, 1.0, s), sr.num_cols)
    s = sr.row_sums().sum()
    if s == 0:
        return sr
    return SparseRows(sr.indices, (sr.values / s).astype(np.float32),
                      sr.num_cols)


def remove_diagonal(sr: SparseRows, keep_single_entry: bool = True
                    ) -> SparseRows:
    """Zero out self entries (removeDiagonalElements,
    SparseMatrixAlgorithms.cpp:704-718).  Rows whose only entry is the
    diagonal keep it when keep_single_entry."""
    if sr.device_only:
        idx, val = sr.device()
        oi, ov = _remove_diagonal_dev(idx, val, bool(keep_single_entry))
        return SparseRows(oi, ov, sr.num_cols)
    rows = np.arange(sr.num_rows)[:, None]
    diag = sr.indices == rows
    if keep_single_entry:
        nnz = sr.row_nnz()
        protect = (nnz <= 1)[:, None]
        diag = diag & ~protect
    values = np.where(diag, 0.0, sr.values).astype(np.float32)
    indices = np.where(diag & (values == 0), PAD, sr.indices)
    # keep pads at the end: re-sort by (pad?, index)
    return _compact(indices, values, sr.num_cols)


def prune_values(sr: SparseRows, threshold: float) -> SparseRows:
    """Remove entries with value <= threshold (doRandomWalks pruning)."""
    if sr.device_only:
        idx, val = sr.device()
        oi, ov = _prune_values_dev(idx, val, jnp.float32(threshold))
        return SparseRows(oi, ov, sr.num_cols)
    keep = sr.values > threshold
    indices = np.where(keep, sr.indices, PAD)
    values = np.where(keep, sr.values, 0.0).astype(np.float32)
    return _compact(indices, values, sr.num_cols)


def _compact(indices: np.ndarray, values: np.ndarray, num_cols: int
             ) -> SparseRows:
    """Push pads to the row ends, keep ascending index order."""
    key = np.where(indices < 0, np.iinfo(np.int32).max, indices)
    if key.shape[1] <= 1 or bool(np.all(key[:, 1:] >= key[:, :-1])):
        # already compact (ascending with pads at the end): one compare
        # pass instead of a [N, R] argsort + two gathers
        return SparseRows(indices, values, num_cols)
    order = np.argsort(key, axis=1, kind="stable")
    r = np.arange(indices.shape[0])[:, None]
    return SparseRows(indices[r, order], values[r, order], num_cols)


@functools.partial(jax.jit, static_argnames=("k", "largest"))
def _topk_rows_dev(idx: jax.Array, val: jax.Array, k: int, largest: bool):
    # value sort with payloads instead of top_k + take_along_axis (lane
    # gathers); slicing the first k lanes afterwards is free
    v = jnp.where(idx >= 0, val, -jnp.inf if largest else jnp.inf)
    key = -v if largest else v
    ks, ti, tv = jax.lax.sort((key, idx, val), num_keys=1, dimension=1,
                              is_stable=True)
    keep = jnp.isfinite(ks[:, :k])
    tv = jnp.where(keep, tv[:, :k], 0.0)
    ti = jnp.where(tv == 0, PAD, ti[:, :k])
    return _compact_dev(ti, tv)


def topk_rows(sr: SparseRows, k: int, largest: bool = True) -> SparseRows:
    """Per-row top-k by value, result sorted by column index (findTopK /
    findBottomK, SparseMatrixAlgorithms.cpp:720-776)."""
    if sr.device_only:
        idx, val = sr.device()
        kk = min(k, idx.shape[1])
        oi, ov = _topk_rows_dev(idx, val, kk, bool(largest))
        return SparseRows(oi, ov, sr.num_cols)
    v = np.where(sr.mask, sr.values, -np.inf if largest else np.inf)
    if largest:
        order = np.argsort(-v, axis=1, kind="stable")[:, :k]
    else:
        order = np.argsort(v, axis=1, kind="stable")[:, :k]
    r = np.arange(sr.num_rows)[:, None]
    idx = sr.indices[r, order]
    val = np.where(np.isfinite(v[r, order]), sr.values[r, order], 0.0)
    idx = np.where(val == 0, PAD, idx)
    return _compact(idx, val.astype(np.float32), sr.num_cols)


# ---------------------------------------------------------------------------
# merge by parents (reference: mergeNodesRandomWalks,
# SparseMatrixAlgorithms.cpp:292-441)
# ---------------------------------------------------------------------------

def merge_rows_by_parents(sr: SparseRows, parents: np.ndarray,
                          num_merged: int,
                          norm: bool = False,
                          weight_by_size: bool = True,
                          max_width: Optional[int] = None) -> SparseRows:
    """Sum child rows into parent rows, mapping columns through `parents` too.

    weight_by_size: each child row is weighted by its nnz before summing and
    the merged row divided by the summed weights (reference:
    mergeNodesRandomWalks rowWeights logic, :321-346).
    norm: row-normalize afterwards.
    """
    parents = np.asarray(parents, dtype=np.int64)
    assert parents.shape[0] == sr.num_rows

    from .device_merge import merge_by_parents_device, use_device_restruct
    if use_device_restruct():
        idx_d, val_d = sr.device()
        res = merge_by_parents_device(idx_d, val_d, parents,
                                      num_merged, weight_by_size, "sum",
                                      max_width)
        if res is not None:
            oi, ov, truncated = res
            if truncated:
                Log.info("merge_rows_by_parents[device]: truncated rows to "
                         "width %d (keeping largest values)", oi.shape[1])
            out = SparseRows(oi, ov, num_merged)
            return normalize_rows(out) if norm else out

    from .. import native
    merged = native.merge_sum(sr.indices, sr.values, parents, num_merged,
                              weight_by_size)
    if merged is not None:
        # single-pass C++: extract + key + stable radix + segment sums
        # (bit-identical f32 accumulation order to the numpy path below)
        out_rows, out_cols, sums = merged
    else:
        mask = sr.mask & (sr.values != 0)
        row_ids = np.broadcast_to(np.arange(sr.num_rows)[:, None],
                                  sr.indices.shape)[mask]
        col_ids = sr.indices[mask].astype(np.int64)
        # f32 accumulation like the reference's Eigen SparseVector<float>
        vals = sr.values[mask]

        row_w = sr.row_nnz().astype(np.float32) if weight_by_size else (
            np.ones(sr.num_rows, np.float32))
        vals = vals * row_w[row_ids]

        prow = parents[row_ids]
        pcol = parents[col_ids]
        key = prow * num_merged + pcol
        order = np.argsort(key, kind="stable")
        ks = key[order]
        vs = vals[order]
        first = np.ones(ks.size, dtype=bool)
        if ks.size:
            first[1:] = ks[1:] != ks[:-1]
        starts = np.nonzero(first)[0]
        uniq = ks[starts]
        # contiguous segmented sum (reduceat), not np.add.at: the buffered
        # ufunc scatter is ~20x slower at tens of millions of entries
        sums = (np.add.reduceat(vs, starts) if starts.size
                else np.empty(0, np.float32))

        out_rows = (uniq // num_merged).astype(np.int64)
        out_cols = (uniq % num_merged).astype(np.int32)

        merged_w = np.bincount(parents, weights=row_w,
                               minlength=num_merged).astype(np.float32)
        if weight_by_size:
            sums = sums / np.maximum(merged_w[out_rows], 1.0)

    # build fixed-width rows
    counts = np.bincount(out_rows, minlength=num_merged)
    width = int(counts.max()) if counts.size else 1
    if max_width is not None and width > max_width:
        Log.info("merge_rows_by_parents: truncating rows from width %d to %d "
                 "(keeping largest values)", width, max_width)
        width = max_width
    width = max(width, 1)

    # entries are already sorted by key == (row, col); place by within-row
    # rank.  Overfull rows keep their largest values.
    starts = np.zeros(num_merged + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(out_rows.size) - starts[out_rows]
    ok = slot < width
    if not np.all(ok):
        order = np.lexsort((-sums, out_rows))
        out_rows, out_cols, sums = (out_rows[order], out_cols[order],
                                    sums[order])
        slot = np.arange(out_rows.size) - starts[out_rows]
        ok = slot < width

    from .. import native
    truncated = not np.all(ok)
    packed = (None if truncated else
              native.pack_rows(out_rows, out_cols,
                               sums.astype(np.float32), num_merged, width))
    if packed is not None:
        indices, values = packed
        # entries were placed in ascending-column order per row with pads
        # at the end — already compact, skip the per-row re-sort
        out = SparseRows(indices, values, num_merged)
    else:
        indices = np.full((num_merged, width), PAD, dtype=np.int32)
        values = np.zeros((num_merged, width), dtype=np.float32)
        indices[out_rows[ok], slot[ok]] = out_cols[ok]
        values[out_rows[ok], slot[ok]] = sums[ok].astype(np.float32)
        out = (_compact(indices, values, num_merged) if truncated
               else SparseRows(indices, values, num_merged))
    if norm:
        out = normalize_rows(out)
    return out


def merge_rows_min_by_parents(sr: SparseRows, parents: np.ndarray,
                              num_merged: int,
                              max_width: Optional[int] = None) -> SparseRows:
    """Min-distance merge semantics (mergeNodesDataDistances /
    mergeGraphNodes, SparseMatrixAlgorithms.cpp:443-561): duplicate merged
    entries keep the smallest value."""
    parents = np.asarray(parents, dtype=np.int64)

    from .device_merge import merge_by_parents_device, use_device_restruct
    if use_device_restruct():
        idx_d, val_d = sr.device()
        res = merge_by_parents_device(idx_d, val_d, parents,
                                      num_merged, False, "min", max_width)
        if res is not None:
            oi, ov, truncated = res
            if truncated:
                Log.info("merge_rows_min_by_parents[device]: truncated rows "
                         "to width %d (keeping smallest)", oi.shape[1])
            return SparseRows(oi, ov, num_merged)

    from .. import native
    merged = native.merge_min(sr.indices, sr.values, parents, num_merged)
    if merged is not None:
        out_rows, out_cols, mins = merged
    else:
        mask = sr.mask & (sr.values != 0)
        row_ids = np.broadcast_to(np.arange(sr.num_rows)[:, None],
                                  sr.indices.shape)[mask]
        col_ids = sr.indices[mask].astype(np.int64)
        vals = sr.values[mask]

        key = parents[row_ids] * num_merged + parents[col_ids]
        order = np.argsort(key, kind="stable")
        ks, vs = key[order], vals[order]
        first = np.ones(ks.size, dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        starts = np.nonzero(first)[0]
        uniq = ks[starts]
        # segmented min via reduceat instead of np.minimum.at (buffered
        # ufunc scatter is ~20x slower at scale)
        mins = (np.minimum.reduceat(vs, starts) if starts.size
                else np.empty(0, np.float32))

        out_rows = (uniq // num_merged).astype(np.int64)
        out_cols = (uniq % num_merged).astype(np.int32)
    counts = np.bincount(out_rows, minlength=num_merged)
    width = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.zeros(num_merged + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(out_rows.size) - starts[out_rows]
    if max_width is not None and width > max_width:
        # same mega-component guard as merge_rows_by_parents; min-distance
        # semantics keep the SMALLEST values per row
        Log.info("merge_rows_min_by_parents: truncating rows from width %d "
                 "to %d (keeping smallest distances)", width, max_width)
        width = max_width
        order = np.lexsort((mins, out_rows))
        out_rows, out_cols, mins = (out_rows[order], out_cols[order],
                                    mins[order])
        slot = np.arange(out_rows.size) - starts[out_rows]
        keep = slot < width
        out_rows, out_cols, mins, slot = (out_rows[keep], out_cols[keep],
                                          mins[keep], slot[keep])
    indices = np.full((num_merged, width), PAD, dtype=np.int32)
    values = np.zeros((num_merged, width), dtype=np.float32)
    indices[out_rows, slot] = out_cols
    values[out_rows, slot] = mins.astype(np.float32)
    return _compact(indices, values, num_merged)


# ---------------------------------------------------------------------------
# Bhattacharyya pairwise similarities (reference: createSimilarities*,
# SparseMatrixAlgorithms.cpp:963-1488)
# ---------------------------------------------------------------------------

def bhattacharyya_pairs(sr: SparseRows, rows_a: np.ndarray,
                        rows_b: np.ndarray) -> np.ndarray:
    """BC(a, b) = sum_i sqrt(p_a[i] * p_b[i]) for given row pairs (reference:
    randomWalksBhattacharyya, Similarities.cpp:379-396).  Used for the
    merge-step NEIGH_WALKS distances where only (component, spatial neighbor)
    pairs are needed.  Shapes are bucketed so every level shares compiled
    programs."""
    from .bucketing import bucket_rows, bucket_width, pad_axis
    e = len(rows_a)
    idx_d, val_d = sr.device()
    w = bucket_width(sr.width)
    nb = bucket_rows(max(8, sr.num_rows))
    if (nb, w) != (sr.num_rows, sr.width):
        idx_d, val_d = _pad_pair_dev(idx_d, val_d, nb, w)
    r = w
    rows_a = np.asarray(rows_a, np.int32)
    rows_b = np.asarray(rows_b, np.int32)
    if e == 0:
        return np.empty(0, np.float32)
    # chunk the pair axis: the [E, R] row gathers are the peak buffer (wide
    # merged walk rows x hundreds of thousands of edges would be tens of GB)
    chunk = max(4096, (1 << 26) // max(r, 1))
    if e <= chunk:
        epad = bucket_rows(e)
        a = pad_axis(rows_a, 0, epad, 0)
        b = pad_axis(rows_b, 0, epad, 0)
        out = _bhattacharyya_pairs_device(idx_d, val_d, jnp.asarray(a),
                                          jnp.asarray(b))
        return np.asarray(out)[:e]
    out = np.empty(e, np.float32)
    for i0 in range(0, e, chunk):
        i1 = min(i0 + chunk, e)
        a = pad_axis(rows_a[i0:i1], 0, chunk, 0)
        b = pad_axis(rows_b[i0:i1], 0, chunk, 0)
        res = _bhattacharyya_pairs_device(idx_d, val_d, jnp.asarray(a),
                                          jnp.asarray(b))
        out[i0:i1] = np.asarray(res)[:i1 - i0]
    return out


@jax.jit
def _bhattacharyya_pairs_device(indices, values, rows_a, rows_b):
    """Sparse-sparse dot of sqrt values per pair via a lane-local sorted
    merge: concatenate both rows' (index, value) entries, sort along the
    lane axis, and multiply adjacent equal indices.

    The obvious vmapped binary search (searchsorted per entry) lowers to
    per-element gathers; this sort replaces them with one row-parallel
    pass (whether it still wins on the GPU: ROADMAP S4).  Source
    tagging rides the sign bit of the value — b-side values are negated,
    so a cross-source match is the only way to get a positive
    -v[i+1]*v[i] product (rows have unique indices, so equal-index runs
    have length <= 2 and are always cross-source).
    """
    ia = indices[rows_a]          # [E, R]
    va = jnp.sqrt(jnp.maximum(values[rows_a], 0.0))
    ib = indices[rows_b]
    vb = jnp.sqrt(jnp.maximum(values[rows_b], 0.0))

    big = jnp.int32(2**31 - 1)
    ia_s = jnp.where(ia < 0, big, ia)
    ib_s = jnp.where(ib < 0, big, ib)

    idx2 = jnp.concatenate([ia_s, ib_s], axis=1)          # [E, 2R]
    val2 = jnp.concatenate([va, -vb], axis=1)
    si, sv = jax.lax.sort((idx2, val2), num_keys=1, dimension=1,
                          is_stable=False)
    eq = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] < big)
    prod = jnp.where(eq, -sv[:, 1:] * sv[:, :-1], 0.0)
    return jnp.sum(jnp.maximum(prod, 0.0), axis=1)


@functools.partial(jax.jit, static_argnames=("k", "block", "sorted_scatter"))
def _pairwise_sim_device(indices, values, row_scale, n_valid, k: int,
                         block: int, prune_val: float,
                         sorted_scatter: bool = False):
    """Blocked dense sqrt(A) * sqrt(A)^T with streaming per-row bottom-k of
    -log(BC).  indices/values: [Np, R] padded rows; row_scale: [Np]
    multiplicative row weights (sqrt of component size or 1).

    Returns (top_idx [Np, k], top_dist [Np, k]) sorted ascending by distance.
    Matmul path: each [block, C] x [C, block] tile is one f32 matmul.

    sorted_scatter: emit the densify scatter with indices_are_sorted +
    an off-grid pad column (rows are ascending-column by construction) —
    the scatter is the kernel's dominant cost at scale (per-element
    minor-axis updates), and the sortedness hint lets XLA lower it
    without the general serialization.
    """
    npad, r = indices.shape
    c = npad  # square matrix: columns == rows domain (padded)
    num_blocks = npad // block

    # densify one block of rows: [block, C]
    def densify(b):
        idx = jax.lax.dynamic_slice_in_dim(indices, b * block, block)
        val = jax.lax.dynamic_slice_in_dim(values, b * block, block)
        scale = jax.lax.dynamic_slice_in_dim(row_scale, b * block, block)
        sq = jnp.sqrt(jnp.maximum(val, 0.0)) * scale[:, None]
        rows = jax.lax.broadcasted_iota(jnp.int32, (block, r), 0)
        if sorted_scatter:
            # pads route to strictly-increasing off-grid columns (c+lane)
            # so the per-row index sequence is truly sorted AND unique —
            # a merely non-decreasing sequence (all pads sharing column
            # c) makes the hint false, and a scatter lowered under a false
            # hint has silently produced zeros (an empty Salinas level-2 P)
            lane = jax.lax.broadcasted_iota(jnp.int32, (block, r), 1)
            safe_idx = jnp.where(idx < 0, c + lane, idx)
            dense = jnp.zeros((block, c + r), jnp.float32)
            dense = dense.at[rows, safe_idx].add(
                jnp.where(idx < 0, 0.0, sq),
                indices_are_sorted=True, unique_indices=True)
            return dense[:, :c]
        dense = jnp.zeros((block, c), jnp.float32)
        safe_idx = jnp.where(idx < 0, 0, idx)
        sq = jnp.where(idx < 0, 0.0, sq)
        return dense.at[rows, safe_idx].add(sq)

    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, block), 1)

    def row_block_fn(rb):
        rows_dense = densify(rb)
        row_ids = (jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0)
                   + rb * block)

        def col_step(carry, cb):
            top_d, top_i = carry
            cols_dense = densify(cb)
            bc = jnp.dot(rows_dense, cols_dense.T,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            ids = jnp.broadcast_to(col_ids + cb * block, bc.shape)
            # prune tiny coefficients, take -log
            valid = (bc > prune_val) & (ids != row_ids) & (ids < n_valid)
            dist = jnp.where(valid, -jnp.log(jnp.maximum(bc, 1e-38)), jnp.inf)
            merged_d = jnp.concatenate([top_d, dist], axis=1)
            merged_i = jnp.concatenate([top_i, ids], axis=1)
            # streaming bottom-k via value sort + slice (top_k + gather
            # would lower to per-element lane gathers)
            sd, si = jax.lax.sort((merged_d, merged_i), num_keys=1,
                                  dimension=1, is_stable=True)
            return (sd[:, :k], si[:, :k]), None

        init = (jnp.full((block, k), jnp.inf, jnp.float32),
                jnp.full((block, k), -1, jnp.int32))
        (top_d, top_i), _ = jax.lax.scan(col_step, init,
                                         jnp.arange(num_blocks))
        return top_d, top_i

    top_d, top_i = jax.lax.map(row_block_fn, jnp.arange(num_blocks))
    return top_i.reshape(npad, k), top_d.reshape(npad, k)


def pairwise_similarities(sr: SparseRows, k: int,
                          prune_val: float = 1e-4,
                          component_sizes: Optional[np.ndarray] = None,
                          block: int = 4096) -> SparseRows:
    """All-pairs Bhattacharyya distances with per-row bottom-k (reference:
    createSimilarities, SparseMatrixAlgorithms.cpp:963-995 — blocked
    sqrt(A)*sqrt(A)^T, prune, -log, keep the k smallest distances per row,
    sort them by column index and normalize the row to sum 1).

    component_sizes: optional per-row weights; rows are scaled by
    sqrt(size) before the product (:1200-1212).
    """
    n = sr.num_rows
    k = min(k, max(n - 1, 1))

    # Wide merged-walk rows (observed 4,971 at Salinas level 1) put a
    # ~[29k, 8192]-padded working set plus [block, C] densify scatters on
    # the device (same pathology as the 1M-row fused gathers).  Cap the
    # input rows to their top-W entries by value and
    # renormalize: rows are probability rows, so truncating the faint tail
    # rescales every Bhattacharyya coefficient by ~the kept mass — a
    # near-uniform additive shift of -log(BC) that preserves bottom-k
    # ranks.  Mirrors the reference's own walk pruning
    # (SparseMatrixAlgorithms.cpp:223-267) and the validated t-SNE P cap.
    import os
    cap = int(os.environ.get("SPH_PAIRWISE_WIDTH", "2048"))
    if cap > 0 and sr.width > cap:
        orig_width = sr.width
        capped = topk_rows(sr, cap)
        ci, cv = capped.device()
        sr = SparseRows(ci, _normalize_rows_dev(ci, cv), sr.num_cols)
        Log.info("pairwise_similarities: capped row width %d -> %d",
                 orig_width, sr.width)

    # row-bucketed block layout: the shrinking level loop otherwise
    # compiles this kernel once per exact component count (levels 401, 50,
    # 16, ... each seconds to compile); bucketing to canonical row counts
    # lets all small levels share one executable (padded rows produce
    # bc=0 -> pruned, and ids >= n_valid are masked, so results are
    # unchanged).  Large levels bucket to 4096-multiples: bounded waste,
    # and nearby dataset sizes reuse one compiled shape (cold-start bill).
    from .bucketing import bucket_rows, bucket_width, ceil_to
    nb = bucket_rows(max(8, n))
    block_eff = min(block, nb)
    npad = ceil_to(nb, block_eff)

    wpad = bucket_width(sr.width)
    idx_d, val_d = sr.device()
    if (npad, wpad) != (n, sr.width):
        idx_d, val_d = _pad_pair_dev(idx_d, val_d, npad, wpad)
    scale = np.ones(npad, dtype=np.float32)
    if component_sizes is not None:
        scale[:n] = np.sqrt(component_sizes.astype(np.float32))

    # bucket the top-k width: the raw per-level k (min(k, n-1)) compiled
    # this kernel once per level at the SAME input shape.  The kernel's
    # streaming bottom-kk is sorted ascending, so slicing its first k
    # columns afterwards returns the exact bottom-k.
    from .bucketing import bucket_k
    kk = min(bucket_k(k), npad)
    # perf knobs, A/B-able without code changes (see docs/performance.md
    # round-5 ls.probdist section): bigger blocks cut the number of
    # densify scatters quadratically; the sorted-scatter hint changes how
    # XLA lowers them
    block_eff = min(int(os.environ.get("SPH_PAIRWISE_BLOCK", block_eff)),
                    npad)
    npad2 = ceil_to(npad, block_eff)
    if npad2 != npad:
        idx_d, val_d = _pad_pair_dev(idx_d, val_d, npad2, wpad)
        scale = np.pad(scale, (0, npad2 - npad))
        npad = npad2
    sorted_scatter = os.environ.get("SPH_PAIRWISE_SORTED_SCATTER",
                                    "1") == "1"
    top_i, top_d = _pairwise_sim_device(
        idx_d, val_d, jnp.asarray(scale),
        jnp.int32(n), kk, block_eff, float(prune_val), sorted_scatter)
    if kk != k:
        top_i, top_d = _slice_pair_dev(top_i, top_d, top_i.shape[0], k)

    # drop +inf (fewer than k similar rows), sort by column index, normalize
    # — all on device; the result feeds device gaussian rows / symmetrize
    oi, ov = _pairwise_post_dev(top_i, top_d)
    return SparseRows(*_slice_pair_dev(oi, ov, n, oi.shape[1]), n)


@jax.jit
def _pairwise_post_dev(top_i: jax.Array, top_d: jax.Array):
    finite = jnp.isfinite(top_d)
    val = jnp.where(finite, top_d, 0.0)
    idx = jnp.where(finite, top_i, PAD)
    oi, ov = _compact_dev(idx, val)
    return oi, _normalize_rows_dev(oi, ov)


def drop_zero_entries(sr: SparseRows, shrink: bool = True) -> SparseRows:
    """Remove zero-valued entries, keeping ascending-column order (the final
    cleanup of computeProbDistOnLevel, LevelSimilarities.cpp:566-581).

    shrink=True also shrinks the stored width to the power-of-two cover of
    the widest surviving row: the Gaussian kernel zeroes most far entries
    of wide hub rows, and downstream symmetrize/t-SNE costs scale with the
    padded width.  On the device path the shrink costs a scalar
    device->host sync; callers that fetch row_nnz anyway pass
    shrink=False and call shrink_width with the host-side max."""
    if sr.device_only:
        oi, ov = _drop_zero_dev(*sr.device())
        out = SparseRows(oi, ov, sr.num_cols)
        if not shrink:
            return out
        need = int(_nnz_rows_dev(oi, ov).max())
        return shrink_width(out, need)
    keep = sr.values != 0
    idx = np.where(keep, sr.indices, PAD)
    val = np.where(keep, sr.values, 0.0).astype(np.float32)
    out = _compact(idx, val, sr.num_cols)
    if not shrink:
        return out
    need = int(out.row_nnz().max()) if out.num_rows else 1
    return shrink_width(out, need)


def shrink_width(sr: SparseRows, need: int) -> SparseRows:
    """Slice compact rows down to the power-of-two cover of `need` (the
    max surviving row nnz, supplied by the caller so no device sync is
    forced here)."""
    from .bucketing import bucket_width
    w = min(bucket_width(need), sr.width)
    if w >= sr.width:
        return sr
    if sr.device_only:
        idx, val = sr.device()
        return SparseRows(*_slice_pair_dev(idx, val, idx.shape[0], w),
                          sr.num_cols)
    return SparseRows(np.ascontiguousarray(sr.indices[:, :w]),
                      np.ascontiguousarray(sr.values[:, :w]), sr.num_cols)


def _run_starts_1d(rows: jax.Array) -> jax.Array:
    """For each element of a sorted [E] row array, the position where its
    run began (same helper as device_merge._run_starts)."""
    e = rows.shape[0]
    iota = jnp.arange(e, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), rows[1:] != rows[:-1]])
    return jax.lax.cummax(jnp.where(first, iota, jnp.int32(-1)))


@functools.partial(jax.jit, static_argnames=("width_rev", "mode"))
def _symmetrize_p_dev(indices: jax.Array, values: jax.Array,
                      width_rev: int, mode: str):
    """Device symmetrization of a square probability matrix on the union
    support: TSNE (p + p^T)/2 or UMAP fuzzy union p + p^T - p*p^T.

    Transpose-only restructuring: the forward direction is already
    row-grouped in the padded layout, so only the REVERSE direction goes
    through a global (target_row, col) sort + scatter — half the sort
    volume of flattening both directions.  Forward and reverse rows are
    then combined lane-wise (concat, per-row sort, adjacent-equal
    combine), which is cheap 2D lane work.

    width_rev is a GUESS (the dispatch retries on the rare overflow —
    probing the exact in-degree first cost 1.2 s of scatter-adds at
    Pines level-0 scale).  Returns (out_idx [N, r+width_rev], out_val,
    counts [N] union widths, rev_lost scalar i32 — entries dropped by an
    undersized width_rev).
    """
    n, r = indices.shape
    e = n * r
    sentinel = jnp.int32(n)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, r), 0)
    valid = (indices >= 0) & (values != 0.0)

    # reverse entries (target_row = col, col = source_row), globally sorted
    # by (target_row, value DESC): when width_rev overflows on extreme hub
    # columns, the kept slots are the LARGEST reverse values, so a bounded
    # width_rev degrades by shedding only the faintest tail (the slot
    # order within a row is irrelevant — the lane combine below re-sorts)
    rr = jnp.where(valid, indices, sentinel).reshape(-1)
    rc = jnp.where(valid, rows, 0).reshape(-1)
    rv = jnp.where(valid, values, 0.0).reshape(-1)
    r1, _, c1, v1 = jax.lax.sort((rr, -rv, rc, rv), num_keys=2,
                                 is_stable=True)

    iota = jnp.arange(e, dtype=jnp.int32)
    row_ok = r1 < sentinel
    slot = iota - _run_starts_1d(r1)
    rev_lost = jnp.sum((slot >= width_rev) & row_ok)
    slot_sc = jnp.where(row_ok, slot, jnp.int32(width_rev))
    rev_idx = jnp.full((n, width_rev), PAD, jnp.int32).at[
        r1, slot_sc].set(c1, mode="drop")
    rev_val = jnp.zeros((n, width_rev), jnp.float32).at[
        r1, slot_sc].set(v1, mode="drop")

    # lane-wise combine of forward and reverse rows
    big = jnp.int32(2**31 - 1)
    cat_i = jnp.concatenate([jnp.where(valid, indices, big),
                             jnp.where(rev_idx >= 0, rev_idx, big)], axis=1)
    cat_v = jnp.concatenate([jnp.where(valid, values, 0.0), rev_val],
                            axis=1)
    si, sv = jax.lax.sort((cat_i, cat_v), num_keys=1, dimension=1,
                          is_stable=True)
    start = jnp.concatenate(
        [jnp.ones((n, 1), bool), si[:, 1:] != si[:, :-1]], axis=1)
    nxt_same = jnp.concatenate(
        [si[:, 1:] == si[:, :-1], jnp.zeros((n, 1), bool)], axis=1)
    v_next = jnp.concatenate([sv[:, 1:], jnp.zeros((n, 1), jnp.float32)],
                             axis=1)
    pair_v = jnp.where(nxt_same, v_next, 0.0)
    if mode == "tsne":
        comb = (sv + pair_v) * 0.5
    else:
        comb = sv + pair_v - sv * pair_v
    keep = start & (si < big)
    out_v = jnp.where(keep, comb, 0.0)
    out_i = jnp.where(keep, si, PAD)
    counts = jnp.sum(keep, axis=1)
    # push dropped duplicates / pads to the row ends
    out_i, out_v = _compact_dev(out_i, out_v)
    return out_i, out_v, counts, rev_lost


def _symmetrize_p_device_dispatch(sr: SparseRows, mode: str) -> SparseRows:
    """Returns a device-resident SparseRows at a power-of-two width.

    The reverse-direction width starts from a generous guess (2x the
    forward width) and doubles on the rare overflow; the overflow flag
    and the final width are fetched in ONE device round trip (each scalar
    sync stalls the host, and the exact in-degree probe this replaces was
    a full scatter-add pass)."""
    from .bucketing import next_pow2
    import os

    # Memory gate for hub-padded giants: the flat-COO restructuring sorts
    # n*width elements and allocates [n, 2*width]-wide reverse/concat
    # buffers — at Salinas level 0 ([111k, 1024], mean nnz ~62, the rest
    # hub padding + Gaussian tails ~e^-40) that transient set exhausts the
    # 16 GB chip.  Rows are perplexity-normalized (effective support
    # ~3*perp <= 300), so top-256-by-value keeps essentially all mass.
    # Applied ONLY above the element budget: small inputs stay
    # bit-identical to the uncapped path.
    from ..utils.timer import phase
    budget = int(os.environ.get("SPH_SYM_FLAT_BUDGET", str(48 * 2**20)))
    wcap = int(os.environ.get("SPH_SYM_P_WIDTH_CAP", "256"))
    if 0 < wcap < sr.width and sr.num_rows * sr.width > budget:
        orig_w = sr.width
        with phase("sym.cap"):
            capped = topk_rows(sr, wcap)
            ci, cv = capped.device()
            # renormalize only t-SNE conditionals (rows sum to 1 by
            # construction); UMAP fuzzy memberships are NOT row-normalized
            # — dividing them by their row sum would shrink every
            # membership, not just shed the tail
            if mode == "tsne":
                cv = _normalize_rows_dev(ci, cv)
            sr = SparseRows(ci, cv, sr.num_cols)
        Log.info("symmetrize: capped row width %d -> %d (row budget)",
                 orig_w, sr.width)

    idx_d, val_d = sr.device()
    n = sr.num_rows
    # bucket the kernel shape so shrinking levels share executables
    # (padded rows have no valid forward entries and receive no reverse
    # entries — column ids are < num_cols <= n — so the combine leaves
    # them all-PAD and the final slice drops them).  Width buckets too:
    # raw max-nnz widths made every level a fresh compile of this, the
    # most expensive stage-3 program (7 variants at Pines before).
    from .bucketing import bucket_rows, bucket_width
    nb = bucket_rows(max(8, n))
    wb = bucket_width(sr.width)
    if (nb, wb) != (sr.num_rows, sr.width):
        idx_d, val_d = _pad_pair_dev(idx_d, val_d, nb, wb)
    # bound the reverse width: hub columns can have in-degree near n, and
    # the [n, wrev] reverse/concat buffers at that extent exhaust device
    # memory.
    # Beyond the cap the kernel keeps the top-wrev reverse entries by
    # value (see the (row, value-desc) flat sort) — only the faintest
    # tail of extreme hub rows is shed, mirroring the downstream P cap.
    wrev_env = int(os.environ.get("SPH_SYM_WREV_MAX", "1024"))
    if wrev_env <= 0:  # 0 disables the bound, like the sibling cap knobs
        wrev_env = 1 << 30
    wrev_max = min(wrev_env, next_pow2(nb))
    # start at the cap on SMALL buckets: every doubling retry recompiles
    # the kernel with a new static width (observed 3 same-input-shape
    # compiles at Pines level 1), and at <= 2048 rows the overshoot is
    # free.  Large levels keep the narrow 2x-forward-width start — the
    # kernel's lane sorts scale with r + wrev, and an always-at-cap
    # start measurably slowed the warm Pines level-0/1 symmetrize.
    if nb <= 2048 and nb * wrev_max <= (1 << 26):
        wrev = wrev_max
    else:
        wrev = max(min(next_pow2(max(2 * wb, 64)), wrev_max), 1)
    while True:
        with phase(f"sym.kernel.w{wrev}"):
            oi, ov, counts, rev_lost = _symmetrize_p_dev(idx_d, val_d,
                                                         wrev, mode)
            probe = np.asarray(jnp.stack([jnp.max(counts), rev_lost]))
        if int(probe[1]) == 0 or wrev >= min(n, wrev_max):
            if int(probe[1]) > 0:
                Log.info("symmetrize: wrev cap %d sheds %d faint reverse "
                         "entries of hub rows", wrev, int(probe[1]))
            break
        wrev = min(next_pow2(wrev * 2), next_pow2(nb), wrev_max)
    need = int(probe[0]) if n else 1
    w = min(bucket_width(need), oi.shape[1])
    return SparseRows(*_slice_pair_dev(oi, ov, n, w), sr.num_cols)


def symmetrize_tsne(sr: SparseRows) -> SparseRows:
    """p_sym = (p + p^T) / 2 on the union support (reference: symmetrizeTSNE,
    HDILibHelper.hpp:260-280)."""
    if sr.device_only and sr.num_cols == sr.num_rows:
        return _symmetrize_p_device_dispatch(sr, "tsne")
    m = _to_scipy(sr)
    s = (m + m.T) * 0.5
    return _from_scipy(s.tocsr(), sr.num_cols)


def symmetrize_umap(sr: SparseRows) -> SparseRows:
    """Fuzzy union p + p^T - p*p^T (elementwise; reference: symmetrizeUMAP,
    HDILibHelper.hpp:282-302)."""
    if sr.device_only and sr.num_cols == sr.num_rows:
        return _symmetrize_p_device_dispatch(sr, "umap")
    m = _to_scipy(sr)
    prod = m.multiply(m.T)
    s = m + m.T - prod
    return _from_scipy(s.tocsr(), sr.num_cols)


def _to_scipy(sr: SparseRows):
    import scipy.sparse as sp
    mask = sr.mask & (sr.values != 0)
    rows = np.broadcast_to(np.arange(sr.num_rows)[:, None],
                           sr.indices.shape)[mask]
    cols = sr.indices[mask]
    vals = sr.values[mask]
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(sr.num_rows, sr.num_cols)).tocsr()


def _from_scipy(m, num_cols: int) -> SparseRows:
    m = m.tocsr()
    m.eliminate_zeros()
    n = m.shape[0]
    counts = np.diff(m.indptr)
    width = max(int(counts.max()) if counts.size else 1, 1)
    indices = np.full((n, width), PAD, dtype=np.int32)
    values = np.zeros((n, width), dtype=np.float32)
    slot = np.arange(m.indices.size) - np.repeat(m.indptr[:-1], counts)
    row_ids = np.repeat(np.arange(n), counts)
    indices[row_ids, slot] = m.indices
    values[row_ids, slot] = m.data.astype(np.float32)
    return SparseRows(indices, values, num_cols)
