"""LevelSimilarities — stage 3: per-level kNN + probability distributions.

Reference: sph/LevelSimilarities.cpp — auto k/perplexity schedule
(updateNumberOfNeighbors :83-115), per-level kNN in custom component metric
spaces (:191-442), probability distributions (:444-587: level 0 reuses the
ImageHierarchy data-level probdist; WALKS levels use pairwise random-walk
Bhattacharyya via createSimilarities or raw top-k walk rows; kNN-metric
levels use Gaussian-perplexity rows), and TSNE/UMAP symmetrization
(:589-623).

Redesign: hnswlib's HNSW over virtual ComponentID spaces becomes
exact blocked metric matrices + top-k (ops/component_knn) — at
per-level component counts the dense product outruns index construction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..settings import (ComponentSim, LevelSimilaritiesSettings,
                        NormalizationScheme, RandomWalkHandling)
from ..utils.logging import Log
from ..ops import component_knn
from ..ops.graph import KnnGraph, PaddedGraph
from ..ops.sparse import (SparseRows, _compact, drop_zero_entries,
                          normalize_rows, pairwise_similarities,
                          symmetrize_tsne, symmetrize_umap, topk_rows)
from .hierarchy import Hierarchy


def _approx_knn_threshold() -> int:
    """Component count above which the per-level kNN switches to the
    approximate IVF tier (exact below: the blocked O(C^2) matrices are
    faster than candidate generation at small C).  exact_knn=True in
    LevelSimilaritiesSettings forces exact at any size."""
    return int(os.environ.get("SPH_APPROX_KNN_THRESHOLD", "8192"))


@dataclass
class LevelSimilaritiesStats:
    """Reference: LevelSimilarities.hpp:26-31."""

    perplexities: list[float] = field(default_factory=list)
    ks: list[int] = field(default_factory=list)
    avg_num_neighbors: list[float] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"perplexities": self.perplexities, "ks": self.ks,
                "avgNumNeighbors": self.avg_num_neighbors}


class LevelSimilarities:
    """Stage-3 engine (reference: sph/LevelSimilarities.hpp:39)."""

    def __init__(self, hierarchy: Hierarchy,
                 data_knn_graph: KnnGraph | PaddedGraph,
                 data: np.ndarray,
                 lss: Optional[LevelSimilaritiesSettings] = None):
        self.hierarchy = hierarchy
        self._graph = data_knn_graph
        self._data = data
        self._lss = lss or LevelSimilaritiesSettings()
        self._image_hierarchy = None
        self.stats = LevelSimilaritiesStats()
        self.prob_dists: list[Optional[SparseRows]] = []
        self.distance_graphs: list[Optional[tuple]] = []
        self.perplexity_on_level: list[float] = []
        self._symmetric: NormalizationScheme = NormalizationScheme.NONE
        self.init_output()

    def set_image_hierarchy(self, ih):
        self._image_hierarchy = ih

    # ------------------------------------------------------------------

    def init_output(self):
        num_levels = self.hierarchy.num_levels
        self.prob_dists = [None] * num_levels
        self.distance_graphs = [None] * num_levels
        self.perplexity_on_level = [0.0] * num_levels
        self._symmetric = NormalizationScheme.NONE
        self.update_number_of_neighbors()

    def update_number_of_neighbors(self):
        """Reference: updateNumberOfNeighbors (:83-115)."""
        num_levels = self.hierarchy.num_levels
        if num_levels == 0 or not self._lss.ks:
            return
        ks = list(self._lss.ks[:1]) + [0] * (num_levels - 1)
        data_perp = (ks[0] - 1) / 3.0
        self.perplexity_on_level[0] = float(np.clip(data_perp, 10.0, 100.0))
        for level in range(1, num_levels):
            c = self.hierarchy.num_components[level]
            level_perp = float(np.clip(c / 100.0, 10.0, 100.0))
            level_perp = min(data_perp, level_perp)
            k = int(level_perp) * 3 + 1
            ks[level] = min(k, c)
            self.perplexity_on_level[level] = level_perp
        self._lss.ks = ks
        Log.info("LevelSimilarities: ks per level: %s", ks)

    # ------------------------------------------------------------------

    def compute(self, lss: Optional[LevelSimilaritiesSettings] = None):
        if lss is not None:
            self._lss = lss
        if len(self._lss.ks) <= 1:
            self.update_number_of_neighbors()

        num_levels = self.hierarchy.num_levels
        start, end = 0, num_levels
        if self._lss.level_to_compute >= 0:
            start = self._lss.level_to_compute
            end = start + 1

        from ..utils.timer import phase
        for level in range(start, end):
            Log.info("LevelSimilarities::compute: level %d", level)
            with phase("ls.knn"):
                self._compute_knn_on_level(level)
            with phase("ls.probdist"):
                self._compute_probdist_on_level(level)

        with phase("ls.symmetrize"):
            self.symmetrize_output(self._lss.compute_symmetric_prob_dist)

    # ------------------------------------------------------------------

    def _current_k(self, level: int) -> int:
        c = self.hierarchy.num_components[level]
        k = self._lss.ks[level]
        if k > c:
            Log.info("LevelSimilarities: fewer points (%d) than k (%d), "
                     "clamping", c, k)
            k = c
        return k

    def _compute_knn_on_level(self, level: int):
        """Reference: computeNearestNeighborOnLevel (:191-442)."""
        if level == 0:
            return
        cs = self._lss.component_sim
        k = self._current_k(level)
        rw_handling = self.hierarchy.settings.rw_handling

        c = self.hierarchy.num_components[level]
        # approximate tier above a size threshold (reference:
        # computeApproximateKnn, LevelSimilarities.cpp:254-334 — hnswlib
        # HNSW when exactKnn is false; here IVF cluster pruning on proxy
        # sketches + exact pair metrics on candidates, see
        # ops/component_knn.py).  Below the threshold the exact blocked
        # matrices outrun any index.
        use_approx = (not self._lss.exact_knn
                      and c > _approx_knn_threshold())

        if cs == ComponentSim.NEIGH_OVERLAP:
            unions = self._union_neighborhoods(level)
            if use_approx:
                from ..ops.similarities import neighbor_overlap_distance
                feats = component_knn.project_sparse_rows(unions, seed=level)
                ids, dists = component_knn.approx_pair_metric_knn(
                    lambda a, b: neighbor_overlap_distance(unions, a, b),
                    feats, k, seed=level)
            else:
                ids, dists = component_knn.knn_neighbor_overlap(unions, k)
        elif cs == ComponentSim.EUCLID_CENTROID:
            rep = self._rep_samples(level)
            if use_approx:
                from ..ops.similarities import hausdorff_point_set_distance
                mask = (rep >= 0)[:, :, None]
                pts = self._data[np.maximum(rep, 0)]
                feats = ((np.where(mask, pts, 0.0).sum(1)
                          / np.maximum(mask.sum(1), 1))
                         .astype(np.float32))
                ids, dists = component_knn.approx_pair_metric_knn(
                    lambda a, b: hausdorff_point_set_distance(
                        self._data, rep[a], rep[b]),
                    feats, k, seed=level)
            else:
                ids, dists = component_knn.knn_hausdorff(self._data, rep, k)
        elif cs in (ComponentSim.GEO_CENTROID,):
            from ..ops.shortest_path import geodesic_hausdorff_knn
            ids, dists = geodesic_hausdorff_knn(
                self._graph, self.hierarchy, level, k,
                self.hierarchy.settings.num_geodesic_samples,
                data=self._data)
        elif cs in (ComponentSim.NEIGH_WALKS, ComponentSim.GEO_WALKS,
                    ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP):
            if rw_handling == RandomWalkHandling.MERGE_RW_NEW_WALKS_AND_KNN:
                single = cs == ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP
                walks = self.hierarchy.random_walks[level]
                if use_approx:
                    from ..ops.similarities import (
                        walks_bhattacharyya_distance,
                        walks_single_overlap_distance)
                    pair = (walks_single_overlap_distance if single
                            else walks_bhattacharyya_distance)
                    feats = component_knn.project_sparse_rows(walks,
                                                              seed=level)
                    ids, dists = component_knn.approx_pair_metric_knn(
                        lambda a, b: pair(walks, a, b), feats, k,
                        seed=level)
                else:
                    ids, dists = component_knn.knn_walks(
                        walks, k, single_overlap=single)
            elif self._lss.force_compute_distances:
                self._use_walks_as_knn_distances(level)
                return
            else:
                return
        else:
            raise ValueError(f"unknown component sim {cs}")
        self.distance_graphs[level] = (ids, dists)

    def _use_walks_as_knn_distances(self, level: int):
        """Reference: useRandomWalksAsKnnDistances (:346-389) — ragged rows
        of (1 - walk value) sorted ascending."""
        walks = self.hierarchy.random_walks[level]
        vals = np.where(walks.mask & (walks.values != 0),
                        1.0 - walks.values, np.inf)
        order = np.argsort(vals, axis=1, kind="stable")
        r = np.arange(walks.num_rows)[:, None]
        dists = vals[r, order]
        ids = walks.indices[r, order]
        ids = np.where(np.isfinite(dists), ids, -1)
        dists = np.where(np.isfinite(dists), dists, np.inf)
        self.distance_graphs[level] = (ids.astype(np.int32),
                                       dists.astype(np.float32))

    def _union_neighborhoods(self, level: int):
        from ..ops.similarities import build_union_neighborhoods
        if isinstance(self._graph, KnnGraph):
            knn_idx = self._graph.indices
        else:
            knn_idx = np.where(self._graph.mask, self._graph.indices, -1)
        return build_union_neighborhoods(
            knn_idx, self.hierarchy.pixel_components[level],
            self.hierarchy.num_components[level])

    def _rep_samples(self, level: int) -> np.ndarray:
        from ..ops.similarities import sample_represented
        reps = self.hierarchy.represented_points(level)
        c = self.hierarchy.num_components[level]
        sizes = np.array([len(r) for r in reps])
        max_s = int(sizes.max())
        gs = self.hierarchy.settings.num_geodesic_samples
        if gs and gs > 0:
            max_s = min(max_s, gs)
        return sample_represented(reps, np.arange(c), max_s, seed=level)

    # ------------------------------------------------------------------

    def _compute_probdist_on_level(self, level: int):
        """Reference: computeProbDistOnLevel (:444-587)."""
        import jax.numpy as jnp
        from ..ops.distributions import (gaussian_row_distributions,
                                         smooth_knn_distributions)

        c = self.hierarchy.num_components[level]
        k = self._current_k(level)
        perp = self.perplexity_on_level[level]
        self.stats.perplexities.append(perp)
        self.stats.ks.append(k)
        cs = self._lss.component_sim
        rw_handling = self.hierarchy.settings.rw_handling

        if level == 0:
            if self._image_hierarchy is not None:
                Log.info("LevelSimilarities: using data-level probdist from "
                         "image hierarchy")
                # device view (jax arrays are immutable, so this is as safe
                # as a copy): keeps the zero-drop + symmetrize on device
                src = self._image_hierarchy.data_level_probdist
                pd = SparseRows(*src.device(), src.num_cols)
            else:
                pd = self._probdist_from_data_graph(perp)
        elif cs in (ComponentSim.NEIGH_WALKS, ComponentSim.GEO_WALKS,
                    ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP) and (
                rw_handling != RandomWalkHandling.MERGE_RW_NEW_WALKS_AND_KNN):
            pd = self._probdist_from_walks(level, k, perp)
        else:
            pd = self._probdist_from_knn(level, k, perp)

        # drop zero values (reference: :566-581); the row_nnz download the
        # stats need doubles as the width-shrink probe — one round trip
        pd = drop_zero_entries(pd, shrink=False)
        nnz = pd.row_nnz()
        # empty probability rows mean an upstream kernel silently produced
        # zeros (a lowering bug class that a CPU run cannot show — e.g. a
        # sorted-scatter hint broken by duplicate pad indices); fail loudly
        # here, at the stage
        # boundary, instead of as KL=0 embeddings downstream
        # (tiny levels CAN legitimately zero out — e.g. two components
        # whose walk rows share no support after pruning)
        if c > 32 and nnz.size and int(nnz.max()) == 0:
            raise RuntimeError(
                f"LevelSimilarities: level {level} probability rows are "
                f"all-zero ({c} components) — upstream kernel produced an "
                "empty distribution")
        from ..ops.sparse import shrink_width
        pd = shrink_width(pd, int(nnz.max()) if nnz.size else 1)
        self.prob_dists[level] = pd
        self.stats.avg_num_neighbors.append(float(nnz.mean()))

    def _probdist_from_data_graph(self, perp: float) -> SparseRows:
        """Reference: :528-538 — normalize the data kNN graph directly."""
        from ..ops.distributions import distance_rows_to_probabilities
        if isinstance(self._graph, KnnGraph):
            idx, dist = self._graph.indices, self._graph.distances
            mask = np.ones_like(idx, dtype=bool)
        else:
            idx, dist = self._graph.indices, self._graph.distances
            mask = self._graph.mask
            dist = np.where(mask, dist, 0.0)
        p = distance_rows_to_probabilities(
            dist, mask, self._lss.normalize_prob_dist, perplexity=perp,
            ignore_first=True)
        n = self.hierarchy.num_components[0]
        return SparseRows(np.where(mask, idx, -1).astype(np.int32),
                          np.asarray(p, np.float32), n)

    def _probdist_from_walks(self, level: int, k: int, perp: float
                             ) -> SparseRows:
        """Reference: useRandomWalks (:460-508)."""
        walks = self.hierarchy.random_walks[level]
        if self._lss.random_walk_pair_sims:
            Log.info("LevelSimilarities: pairwise random-walk distances "
                     "(createSimilarities)")
            sizes = None
            if self._lss.weight_transition_by_size:
                sizes = self.hierarchy.component_sizes(level)
            pd = pairwise_similarities(walks, k, prune_val=1e-4,
                                       component_sizes=sizes)
        else:
            Log.info("LevelSimilarities: top-%d walk rows as probdist", k)
            pd = normalize_rows(topk_rows(walks, k, largest=True))

        scheme = self._lss.normalize_prob_dist
        from ..ops.distributions import (gaussian_rows_bucketed,
                                         smooth_knn_rows_bucketed)
        if scheme == NormalizationScheme.TSNE:
            if pd.device_only:
                idx_d, val_d = pd.device()
                p = gaussian_rows_bucketed(val_d, None, perp,
                                           ignore_first=False,
                                           indices=idx_d)
                pd = SparseRows(idx_d, p, pd.num_cols)
            else:
                mask = pd.mask & (pd.values != 0)
                p = gaussian_rows_bucketed(pd.values, mask, perp,
                                           ignore_first=False)
                pd = SparseRows(pd.indices, p, pd.num_cols)
        elif scheme == NormalizationScheme.UMAP:
            if pd.device_only:
                idx_d, val_d = pd.device()
                p = smooth_knn_rows_bucketed(val_d, None, indices=idx_d)
                pd = SparseRows(idx_d, p, pd.num_cols)
            else:
                mask = pd.mask & (pd.values != 0)
                p = smooth_knn_rows_bucketed(pd.values, mask)
                pd = SparseRows(pd.indices, p, pd.num_cols)
        else:
            Log.warn("LevelSimilarities: normalize_prob_dist should be TSNE "
                     "or UMAP; skipping normalization")
        return pd

    def _probdist_from_knn(self, level: int, k: int, perp: float
                           ) -> SparseRows:
        """Reference: useKnnDistances (:510-515) — Gaussian rows over the
        per-level distance graph, ignore index 0 (self)."""
        if self.distance_graphs[level] is None:
            raise RuntimeError(
                f"level {level}: no distance graph computed for "
                f"{self._lss.component_sim}")
        ids, dists = self.distance_graphs[level]
        mask = ids >= 0
        from ..ops.distributions import gaussian_rows_bucketed
        p = gaussian_rows_bucketed(np.where(mask, dists, 0.0), mask, perp,
                                   ignore_first=True)
        c = self.hierarchy.num_components[level]
        return SparseRows(np.where(mask, ids, -1).astype(np.int32), p, c)

    # ------------------------------------------------------------------

    def symmetrize_output(self, method: NormalizationScheme):
        """Reference: symmetrizeOutput (:589-623)."""
        if method == NormalizationScheme.NONE:
            return
        if self._symmetric != NormalizationScheme.NONE:
            Log.info("LevelSimilarities: already symmetric")
            return
        if self._lss.normalize_prob_dist != method:
            Log.info("LevelSimilarities: probdist normalized with %s, "
                     "won't symmetrize for %s",
                     self._lss.normalize_prob_dist.value, method.value)
            return
        Log.info("LevelSimilarities::symmetrizeOutput: %s", method.value)
        for i, pd in enumerate(self.prob_dists):
            if pd is None:
                continue
            Log.info("symmetrizeOutput: level %d rows=%d width=%d",
                     i, pd.num_rows, pd.width)
            if method == NormalizationScheme.TSNE:
                self.prob_dists[i] = symmetrize_tsne(pd)
            elif method == NormalizationScheme.UMAP:
                self.prob_dists[i] = symmetrize_umap(pd)
        self._symmetric = method

    def get_prob_dist(self, level: int) -> SparseRows:
        pd = self.prob_dists[level]
        if pd is None:
            raise RuntimeError(f"prob dist for level {level} not computed")
        return pd

    def write_stats(self, file_name: str) -> bool:
        import json
        try:
            with open(file_name, "w") as f:
                json.dump(self.stats.to_dict(), f, indent=2)
            return True
        except OSError:
            return False
