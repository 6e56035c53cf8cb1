"""The Hierarchy data structure.

Reference: sph/utils/Hierarchy.hpp:37-142 / Hierarchy.cpp — per level:
numComponents, parents, children, spatialNeighbors, pixelComponents,
mapFromLevelToPixel, randomWalks, notMergedNodes; `addLevel` performs
updateParentsAndChildren (:162-202), updateSpatialNeighbors (:204-227),
updateComponentMap (:229-248) and updateRandomWalks (:250-390).

Redesign: pointer-chasing child lists become flat label arrays —
`pixel_components[level]` maps every pixel to its component id, from which
children and represented-point lists are derived with argsort/bincount
(vectorized, no recursion).  Walk matrices are fixed-width SparseRows merged
with segment sums (ops/sparse.merge_rows_by_parents) instead of omp-locked
Eigen scatter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..settings import (ComponentSim, ImageHierarchySettings, NeighConnection,
                        NormType, RandomWalkHandling, RandomWalkSettings)
from ..utils.logging import Log
from ..ops.sparse import (SparseRows, merge_rows_by_parents,
                          merge_rows_min_by_parents, normalize_matrix,
                          normalize_rows, remove_diagonal)
from ..ops.walks import do_random_walks

# pixel-grid offsets (reference: sph/utils/ImageHelper.hpp:11-52)
_OFFSETS_FOUR = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)], dtype=np.int64)
_OFFSETS_EIGHT = np.array([(-1, -1), (-1, 0), (-1, 1), (0, -1),
                           (0, 1), (1, -1), (1, 0), (1, 1)], dtype=np.int64)


def pixel_neighbor_table(rows: int, cols: int,
                         connection: NeighConnection) -> np.ndarray:
    """[N, deg] table of pixel-grid neighbor ids, -1 where out of bounds
    (reference: pixelNeighborIDs, ImageHelper.cpp:8-28)."""
    offs = (_OFFSETS_FOUR if connection == NeighConnection.FOUR
            else _OFFSETS_EIGHT)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    rr = rr.ravel()
    cc = cc.ravel()
    out = np.full((rows * cols, len(offs)), -1, dtype=np.int64)
    for j, (dr, dc) in enumerate(offs):
        nr, nc = rr + dr, cc + dc
        ok = (nr >= 0) & (nr < rows) & (nc >= 0) & (nc < cols)
        out[ok, j] = nr[ok] * cols + nc[ok]
    return out


@dataclass
class HierarchySettings:
    """Reference: Hierarchy.hpp settings block (wired by
    ImageHierarchy::updateHierarchySettings, ImageHierarchy.cpp:98-111)."""

    num_rows: int = 0
    num_cols: int = 0
    neighbor_connection: NeighConnection = NeighConnection.FOUR
    component_sim: ComponentSim = ComponentSim.NEIGH_OVERLAP
    rw_norm_sim: NormType = NormType.ONEDIM
    rw_weight_merge_by_size: bool = True
    rw_handling: RandomWalkHandling = RandomWalkHandling.MERGE_RW_ONLY
    rw_remove_self_sim_after_merging: bool = True
    num_geodesic_samples: int = 0
    verbose: bool = False


class Hierarchy:
    """Host-side multi-level container; all per-level payloads are arrays."""

    def __init__(self, settings: Optional[HierarchySettings] = None):
        self.settings = settings or HierarchySettings()
        self.num_components: list[int] = []
        # parents[l]: [C_l] -> component id on level l+1
        self.parents: list[np.ndarray] = []
        # pixel_components[l]: [N] pixel -> component id on level l
        self.pixel_components: list[np.ndarray] = []
        # spatial_neighbors[l]: padded [C_{l+1}, D] adjacency (no self), -1 pad
        self.spatial_neighbors: list[np.ndarray] = []
        # random_walks[l]: SparseRows on level l's components
        self.random_walks: list[SparseRows] = []
        self.not_merged: list[np.ndarray] = []
        # merged data graphs for MERGE_DATA_NEW_WALKS (distances SparseRows)
        self.merged_data_graphs: list[SparseRows] = []
        self._pixel_neighbors: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    @property
    def num_levels(self) -> int:
        return len(self.num_components)

    def children_of(self, level: int) -> list[np.ndarray]:
        """children on `level` (groups of level-1 components); reference:
        Hierarchy::childrenOn."""
        assert level > 0
        par = self.parents[level - 1]
        order = np.argsort(par, kind="stable")
        counts = np.bincount(par, minlength=self.num_components[level])
        splits = np.cumsum(counts)[:-1]
        return np.split(order, splits)

    def represented_points(self, level: int) -> list[np.ndarray]:
        """mapFromLevelToPixel on `level` (reference: updateComponentMap) —
        per component, the data-level pixel ids it represents."""
        if level == 0:
            n = self.num_components[0]
            return [np.array([i]) for i in range(n)]
        labels = self.pixel_components[level]
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=self.num_components[level])
        splits = np.cumsum(counts)[:-1]
        return np.split(order, splits)

    def component_sizes(self, level: int) -> np.ndarray:
        return np.bincount(self.pixel_components[level],
                           minlength=self.num_components[level])

    def spatial_neighbors_of(self, level: int) -> np.ndarray:
        """Padded [C, D] spatial adjacency on `level` (no self edges).
        Level 0 is the raw pixel grid."""
        if level == 0:
            if self._pixel_neighbors is None:
                self._pixel_neighbors = pixel_neighbor_table(
                    self.settings.num_rows, self.settings.num_cols,
                    self.settings.neighbor_connection)
            return self._pixel_neighbors
        return self.spatial_neighbors[level - 1]

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def clear(self):
        self.__init__(self.settings)

    def init_first_level(self, num_points: int):
        """Reference: Hierarchy::initFirstLevel (:117-132)."""
        assert self.num_levels == 0
        self.num_components.append(num_points)
        self.pixel_components.append(np.arange(num_points, dtype=np.int64))

    def add_level(self, num_components_next: int,
                  component_labels_next: np.ndarray,
                  rws: RandomWalkSettings):
        """Reference: Hierarchy::addLevel (:134-160)."""
        assert self.num_levels > 0
        labels = np.asarray(component_labels_next, dtype=np.int64)
        assert labels.shape[0] == self.num_components[-1]

        # parents / children / pixel map (updateParentsAndChildren)
        self.parents.append(labels.copy())
        self.num_components.append(num_components_next)
        pix_next = labels[self.pixel_components[-1]]
        self.pixel_components.append(pix_next)

        child_counts = np.bincount(labels, minlength=num_components_next)
        self.not_merged.append(np.nonzero(child_counts == 1)[0])

        # spatial neighbors on the new level (updateSpatialNeighbors):
        # component pairs adjacent via any pixel-grid edge
        from ..utils.timer import phase
        with phase("h.spatial"):
            self._update_spatial_neighbors(num_components_next)

        # random walks on the new level (updateRandomWalks)
        if self.settings.component_sim in (
                ComponentSim.NEIGH_WALKS,
                ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP,
                ComponentSim.GEO_WALKS):
            with phase("h.merge_walks"):
                self._update_random_walks(num_components_next, labels, rws)

    def _update_spatial_neighbors(self, num_components_next: int):
        pix_next = self.pixel_components[-1]
        grid = self.spatial_neighbors_of(0)
        n, deg = grid.shape
        src = pix_next[np.repeat(np.arange(n), deg)]
        ok = grid.ravel() >= 0
        dst = pix_next[np.maximum(grid.ravel(), 0)]
        src, dst = src[ok], dst[ok]
        diff = src != dst
        src, dst = src[diff], dst[diff]
        key = np.unique(src * num_components_next + dst)
        urow = (key // num_components_next).astype(np.int64)
        ucol = (key % num_components_next).astype(np.int64)
        counts = np.bincount(urow, minlength=num_components_next)
        width = max(int(counts.max()) if counts.size else 1, 1)
        adj = np.full((num_components_next, width), -1, dtype=np.int64)
        starts = np.zeros(num_components_next + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(urow.size) - starts[urow]
        adj[urow, slot] = ucol
        self.spatial_neighbors.append(adj)

    def _update_random_walks(self, num_next: int, labels: np.ndarray,
                             rws: RandomWalkSettings):
        """Reference: Hierarchy::updateRandomWalks (:250-390)."""
        handling = self.settings.rw_handling

        if handling in (RandomWalkHandling.MERGE_RW_ONLY,
                        RandomWalkHandling.MERGE_RW_NEW_WALKS,
                        RandomWalkHandling.MERGE_RW_NEW_WALKS_AND_KNN):
            Log.info("Hierarchy::updateRandomWalks: merge current random "
                     "walk similarities")
            # cap the merged row width to a memory budget: one giant merge
            # component would otherwise force the whole padded [C, width]
            # matrix to its union nnz (the reference's true-sparse rows pay
            # only per-row nnz, Eigen SparseVector).  Truncation keeps the
            # largest values — the entries the downstream prune would drop
            # anyway.
            import os as _os
            budget = int(_os.environ.get("SPH_MERGE_WIDTH_BUDGET",
                                         str(2 ** 28)))
            cap = max(1024, budget // max(num_next, 1))
            from ..utils.timer import phase, phases_enabled
            if phases_enabled():
                src = self.random_walks[-1]
                cc = np.bincount(labels, minlength=num_next)
                Log.info("merge shapes: n=%d r=%d m=%d cmax=%d",
                         src.num_rows, src.width, num_next, int(cc.max()))
            with phase("h.merge_walks.merge"):
                merged = merge_rows_by_parents(
                    self.random_walks[-1], labels, num_next, norm=False,
                    weight_by_size=self.settings.rw_weight_merge_by_size,
                    max_width=cap)

            if (self.settings.rw_remove_self_sim_after_merging
                    and merged.num_rows > 1):
                if handling != RandomWalkHandling.MERGE_RW_ONLY:
                    merged = remove_diagonal(merged, keep_single_entry=True)
                else:
                    Log.warn_once(
                        "Hierarchy::updateRandomWalks: MERGE_RW_ONLY "
                        "ignores rw_remove_self_sim_after_merging")

            with phase("h.merge_walks.norm"):
                if self.settings.rw_norm_sim == NormType.ONEDIM:
                    merged = normalize_rows(merged)
                else:
                    merged = normalize_matrix(merged)
        elif handling == RandomWalkHandling.MERGE_DATA_NEW_WALKS:
            Log.info("Hierarchy::updateRandomWalks: merge knn nodes")
            import os as _os
            budget = int(_os.environ.get("SPH_MERGE_WIDTH_BUDGET",
                                         str(2 ** 28)))
            merged_graph = merge_rows_min_by_parents(
                self.merged_data_graphs[-1], labels, num_next,
                max_width=max(1024, budget // max(num_next, 1)))
            self.merged_data_graphs.append(merged_graph)
            # distances -> probability rows for the new walks; reference
            # uses normalizeKnnDistances on the merged graph with the
            # hierarchy's normMergedDataDistances (TSNE default)
            merged = _sparse_distance_rows_to_probs(merged_graph)
        else:
            raise ValueError(f"unhandled rw handling {handling}")

        if handling == RandomWalkHandling.MERGE_RW_ONLY:
            out = merged
        else:
            Log.info("Hierarchy::updateRandomWalks: new random walks")
            out = do_random_walks(merged, rws, self.settings.verbose)

        # preserve the self-similarity when the top level is a single node
        # (reference: :387-389)
        if out.num_rows == 1 and out.nnz() == 0:
            idx = np.full((1, out.width), -1, np.int32)
            val = np.zeros((1, out.width), np.float32)
            idx[0, 0] = 0
            val[0, 0] = 1.0
            out = SparseRows(idx, val, out.num_cols)
        self.random_walks.append(out)


def _sparse_distance_rows_to_probs(dist_rows: SparseRows) -> SparseRows:
    """Gaussian-normalize sparse distance rows into transition probabilities
    (reference: updateRandomWalks MERGE_DATA_NEW_WALKS path calling
    normalizeKnnDistances on the merged graph).  Fully device-resident:
    the merged graph arrives on device and the probability rows feed the
    device walk sampler without a host round trip."""
    import jax
    import jax.numpy as jnp
    from ..ops.distributions import gaussian_row_distributions

    idx_d, val_d = dist_rows.device()
    rows = jax.lax.broadcasted_iota(jnp.int32, idx_d.shape, 0)
    mask = (idx_d >= 0) & (idx_d != rows)
    p = gaussian_row_distributions(val_d, mask, jnp.float32(-1.0),
                                   ignore_first=False)
    return normalize_rows(SparseRows(idx_d, p, dist_rows.num_cols))
