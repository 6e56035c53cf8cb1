"""ImageHierarchy — stage 2: Borůvka-style agglomeration over the pixel grid.

Reference: sph/ImageHierarchy.cpp — computePreparations (:149-190),
computeBoruvkaHierarchy level loop (:409-591) with connectMostSimilarComponents
(:364-407), mergeMinBelow (:312-362) / mergeAllBelow (:261-310), percentile
thresholding via computeQuantile (:371-394), weak-CC labeling of the merge
graph, stagnation/min-comp/max-level stopping rules (:418-453), and the
7-policy adaptive random-walk-length schedule (:504-548).

Redesign: the per-level "distance graph" is an edge list over
(component, spatial neighbor) pairs; every similarity metric evaluates ALL
edges of a level in one batched device call (ops/similarities) instead of the
reference's per-edge virtual calls in an OpenMP loop.  The level loop itself
stays on the host — component counts shrink geometrically, and each iteration
dispatches a handful of device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..settings import (ComponentSim, ImageHierarchySettings,
                        NormalizationScheme, RandomWalkHandling,
                        RandomWalkReduction, RandomWalkSettings)
from ..utils.logging import Log
from ..ops import similarities as sims
from ..ops.graph import KnnGraph, PaddedGraph, edge_list_components
from ..ops.math import compute_quantile
from ..ops.sparse import SparseRows
from ..ops.walks import do_random_walks
from .hierarchy import Hierarchy, HierarchySettings

_FLOAT_MAX = np.float32(np.finfo(np.float32).max)


@dataclass
class ImageHierarchyStats:
    """Reference: ImageHierarchy.hpp:24-33."""

    zero_similarity_count: list[int] = field(default_factory=list)
    forced_merge_count: list[int] = field(default_factory=list)
    reduction_rates: list[float] = field(default_factory=list)
    rw_sparsities: list[float] = field(default_factory=list)
    merged_data_sparsities: list[float] = field(default_factory=list)
    num_components: list[int] = field(default_factory=list)
    not_merged_components: list[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "zeroSimilarityCount": self.zero_similarity_count,
            "forcedMergeCount": self.forced_merge_count,
            "reductionRates": self.reduction_rates,
            "rwSparsities": self.rw_sparsities,
            "mergedDataSparsities": self.merged_data_sparsities,
            "numComponents": self.num_components,
            "notMergedComponents": self.not_merged_components,
            "numLevels": len(self.num_components),
        }


class ImageHierarchy:
    """Stage-2 engine (reference: sph/ImageHierarchy.hpp:38)."""

    def __init__(self, data_knn_graph: KnnGraph | PaddedGraph,
                 data: np.ndarray, rows: int, cols: int,
                 graph_has_wcc: bool = False):
        self._graph = data_knn_graph
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        self._rows = rows
        self._cols = cols
        self._graph_has_wcc = graph_has_wcc
        assert self._data.shape[0] == rows * cols
        self._ihs = ImageHierarchySettings()
        self._rws = RandomWalkSettings()
        self.hierarchy = Hierarchy()
        self.stats = ImageHierarchyStats()
        self.data_level_probdist: Optional[SparseRows] = None
        self._rw_lengths: list[int] = []
        self.component_labels: Optional[np.ndarray] = None  # WCC of data knn

    # ------------------------------------------------------------------

    def set_settings(self, ihs: Optional[ImageHierarchySettings] = None,
                     rws: Optional[RandomWalkSettings] = None):
        if ihs is not None:
            self._ihs = ihs
        if rws is not None:
            self._rws = rws
            if self._rws.single_walk_length < (
                    self._rws.minimum_single_walk_length):
                Log.warn("ImageHierarchy: single_walk_length < minimum, "
                         "adjusting minimum")
                self._rws.minimum_single_walk_length = (
                    self._rws.single_walk_length)

    def compute(self, ihs: Optional[ImageHierarchySettings] = None,
                rws: Optional[RandomWalkSettings] = None):
        self.set_settings(ihs, rws)
        self.hierarchy = Hierarchy(HierarchySettings(
            num_rows=self._rows, num_cols=self._cols,
            neighbor_connection=self._ihs.neighbor_connection,
            component_sim=self._ihs.component_sim,
            rw_norm_sim=self._ihs.rw_norm_sim,
            rw_weight_merge_by_size=self._ihs.rw_weight_merge_by_size,
            rw_handling=self._ihs.rw_handling,
            rw_remove_self_sim_after_merging=(
                self._ihs.rw_remove_self_sim_after_merging),
            num_geodesic_samples=self._ihs.num_geodesic_samples,
            verbose=self._ihs.verbose))
        self.stats = ImageHierarchyStats()
        Log.info("ImageHierarchy::compute: %s similarity, %s threshold %s, "
                 "mergeMultiple=%s", self._ihs.component_sim.value,
                 "percentile" if self._ihs.use_percentile else "absolute",
                 self._ihs.max_dist, self._ihs.merge_multiple)
        from ..utils.timer import phase
        with phase("ih.preparations"):
            self._compute_preparations()
        self._compute_boruvka()

    # ------------------------------------------------------------------

    def set_preparations(self, data_level_probdist: SparseRows,
                         walks: Optional[SparseRows] = None):
        """Inject precomputed stage-1 preparations (data-level probdist and
        optionally the data-level random walks) so compute() skips the
        normalize + walk simulation: e.g. another backend's P, to check
        that the walks and merges downstream of it give the same levels
        (chip_smoke.py phase B)."""
        self._preset_probdist = data_level_probdist
        self._preset_walks = walks

    def _compute_preparations(self):
        """Reference: ImageHierarchy.cpp:149-190."""
        preset_pd = getattr(self, "_preset_probdist", None)
        if preset_pd is not None:
            self._prepare_from_preset(preset_pd)
            return
        Log.info("ImageHierarchy::computePreparations: normalize knn "
                 "distances with %s", self._ihs.norm_knn_distances.value)
        n = self._data.shape[0]
        if (isinstance(self._graph, PaddedGraph)
                and self._graph.device_only):
            # device-resident graph (symmetrized on device): normalize and
            # build the probdist without downloading the wide rows
            import jax.numpy as jnp
            idx_d, dist_d = self._graph.device()
            mask_d = idx_d >= 0
            dist_d = jnp.where(mask_d, dist_d, 0.0)
            probs = self._normalize_graph_rows(dist_d, mask_d)
            self.data_level_probdist = SparseRows(
                jnp.where(mask_d, idx_d, -1), probs, n)
            knn_idx, knn_dist, mask = idx_d, dist_d, mask_d
        else:
            if isinstance(self._graph, KnnGraph):
                knn_idx = self._graph.indices
                knn_dist = self._graph.distances
                mask = np.ones_like(knn_idx, dtype=bool)
            else:
                knn_idx = self._graph.indices
                knn_dist = np.where(self._graph.mask,
                                    self._graph.distances, 0.0)
                mask = self._graph.mask

            probs = self._normalize_graph_rows(knn_dist, mask)
            self.data_level_probdist = SparseRows(
                np.where(mask, knn_idx, -1).astype(np.int32),
                probs.astype(np.float32), n)

        self.hierarchy.clear()
        self.hierarchy.init_first_level(n)

        if self._ihs.component_sim in (ComponentSim.NEIGH_WALKS,
                                       ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP,
                                       ComponentSim.GEO_WALKS):
            Log.info("ImageHierarchy::computePreparations: random walks on "
                     "data level")
            self._rw_lengths = [self._rws.single_walk_length]
            walks = do_random_walks(self.data_level_probdist, self._rws,
                                    self._ihs.verbose)
            self.hierarchy.random_walks.append(walks)
            n2 = float(n) * n
            self.stats.rw_sparsities.append(1.0 - walks.nnz() / n2)
            if self._ihs.rw_handling == RandomWalkHandling.MERGE_DATA_NEW_WALKS:
                # keep data distances for later merging (reference: :177-178)
                import jax
                if isinstance(knn_idx, jax.Array):
                    import jax.numpy as jnp
                    dist_rows = SparseRows(
                        jnp.where(mask, knn_idx, -1),
                        jnp.where(mask, knn_dist, 0.0), n)
                else:
                    dist_rows = SparseRows(
                        np.where(mask, knn_idx, -1).astype(np.int32),
                        np.where(mask, knn_dist, 0.0).astype(np.float32), n)
                self.hierarchy.merged_data_graphs.append(dist_rows)

    def _prepare_from_preset(self, preset_pd: SparseRows):
        """Preparations from injected stage-1 outputs (set_preparations)."""
        n = self._data.shape[0]
        assert preset_pd.num_rows == n
        self.data_level_probdist = preset_pd
        self.hierarchy.clear()
        self.hierarchy.init_first_level(n)

        if self._ihs.component_sim in (
                ComponentSim.NEIGH_WALKS,
                ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP,
                ComponentSim.GEO_WALKS):
            self._rw_lengths = [self._rws.single_walk_length]
            walks = getattr(self, "_preset_walks", None)
            if walks is None:
                walks = do_random_walks(self.data_level_probdist,
                                        self._rws, self._ihs.verbose)
            self.hierarchy.random_walks.append(walks)
            n2 = float(n) * n
            self.stats.rw_sparsities.append(1.0 - walks.nnz() / n2)
            if (self._ihs.rw_handling
                    == RandomWalkHandling.MERGE_DATA_NEW_WALKS):
                if isinstance(self._graph, KnnGraph):
                    idx, dist = self._graph.indices, self._graph.distances
                    mask = np.ones_like(idx, dtype=bool)
                else:
                    idx = self._graph.indices
                    dist = np.where(self._graph.mask,
                                    self._graph.distances, 0.0)
                    mask = self._graph.mask
                self.hierarchy.merged_data_graphs.append(SparseRows(
                    np.where(mask, idx, -1).astype(np.int32),
                    np.where(mask, dist, 0.0).astype(np.float32), n))

    def _normalize_graph_rows(self, dist, mask):
        from ..ops.distributions import distance_rows_to_probabilities
        return distance_rows_to_probabilities(
            dist, mask, self._ihs.norm_knn_distances, perplexity=-1.0,
            ignore_first=True, umap_row_norm=True)

    # ------------------------------------------------------------------

    def _compute_boruvka(self):
        """Reference: computeBoruvkaHierarchy, ImageHierarchy.cpp:409-591."""
        num_trees = self._data.shape[0]
        Log.info("ImageHierarchy: %d trees on level 0 (pixel level)",
                 num_trees)
        min_num_comp = max(self._ihs.min_num_comp, 1)
        rng = np.random.default_rng(self._rws.random_seed + 7919)

        level = 0
        while num_trees > min_num_comp:
            if 0 <= self._ihs.max_levels <= level:
                Log.info("ImageHierarchy: reached max level %d, stopping",
                         level)
                break

            from ..utils.timer import phase
            c = self.hierarchy.num_components[level]
            with phase("ih.distances"):
                edges_src, edges_dst, edge_dist = (
                    self._compute_distances(level))

            thresh = float(_FLOAT_MAX)
            if self._ihs.max_dist > 0:
                thresh = self._ihs.max_dist
                if self._ihs.use_percentile:
                    q = compute_quantile(
                        edge_dist, self._ihs.max_dist,
                        ignore_vals=(0.0, -1.0, float(_FLOAT_MAX)))
                    if q < 0:
                        Log.warn("ImageHierarchy: percentile not found, "
                                 "using float max")
                        q = float(_FLOAT_MAX)
                    Log.info("ImageHierarchy: percentile %.3f -> threshold "
                             "%.6f", self._ihs.max_dist, q)
                    thresh = q

            with phase("ih.select"):
                merge_src, merge_dst, zero_cnt, forced_cnt = (
                    self._select_merges(c, edges_src, edges_dst, edge_dist,
                                        thresh, rng))
            self.stats.zero_similarity_count.append(zero_cnt)
            self.stats.forced_merge_count.append(forced_cnt)

            with phase("ih.components"):
                ncc, labels = edge_list_components(c, merge_src, merge_dst)
            reduction = 100.0 * ncc / self.hierarchy.num_components[-1]
            self.stats.reduction_rates.append(reduction)
            Log.info("ImageHierarchy: %d trees on next level %d "
                     "(reduction to %.2f%%)", ncc, level + 1, reduction)

            if self._reduction_stagnates():
                Log.info("ImageHierarchy: no significant reduction — "
                         "level not added, stopping")
                break

            self._adapt_walk_length(reduction)
            rws_next = RandomWalkSettings(**{**self._rws.__dict__})
            if self._rw_lengths:
                rws_next.single_walk_length = self._rw_lengths[-1]

            with phase("ih.add_level"):
                self.hierarchy.add_level(ncc, labels, rws_next)

            self.stats.not_merged_components.append(
                len(self.hierarchy.not_merged[-1]))
            if len(self.hierarchy.random_walks) > 1:
                w = self.hierarchy.random_walks[-1]
                self.stats.rw_sparsities.append(
                    1.0 - w.nnz() / float(ncc) ** 2)

            num_trees = ncc
            level += 1
            if num_trees <= min_num_comp:
                Log.info("ImageHierarchy: reached min number of components "
                         "(%d <= %d), stopping", num_trees, min_num_comp)

        self.stats.num_components = list(self.hierarchy.num_components)
        Log.info("ImageHierarchy: finished with %d levels (incl. data level)",
                 self.hierarchy.num_levels)

    def _reduction_stagnates(self) -> bool:
        """Reference: ImageHierarchy.cpp:418-424."""
        rr = self.stats.reduction_rates
        if rr[-1] == 100.0:
            return True
        return (len(rr) > 2 and rr[-1] > self._ihs.min_reduction
                and rr[-2] > self._ihs.min_reduction)

    def _adapt_walk_length(self, reduction_rate_pct: float):
        """Reference: ImageHierarchy.cpp:504-548 (7 policies)."""
        if self._ihs.component_sim not in (
                ComponentSim.NEIGH_WALKS,
                ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP,
                ComponentSim.GEO_WALKS):
            return
        if self._ihs.rw_handling == RandomWalkHandling.MERGE_RW_ONLY:
            return
        cur = self._rw_lengths[-1]
        pol = self._ihs.rw_reduction
        r = reduction_rate_pct / 100.0
        rate = {
            RandomWalkReduction.NONE: 1.0,
            RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION: r,
            RandomWalkReduction.PROPORTIONAL_DOUBLE: r * 2.0,
            RandomWalkReduction.PROPORTIONAL_HALF: r * 0.5,
            RandomWalkReduction.CONSTANT: 0.5,
            RandomWalkReduction.CONSTANT_LOW: 0.75,
            RandomWalkReduction.CONSTANT_HIGH: 0.25,
        }.get(pol, 1.0)
        rate = min(max(rate, 0.0), 1.0)
        nxt = int(rate * cur)
        nxt = min(max(nxt, self._rws.minimum_single_walk_length),
                  self._rw_lengths[0])
        self._rw_lengths.append(nxt)
        Log.info("ImageHierarchy: walk length %d -> %d (%s)", cur, nxt,
                 pol.value)

    # ------------------------------------------------------------------

    def _compute_distances(self, level: int):
        """Batched per-edge component distances (reference: computeDistances,
        ImageHierarchy.cpp:192-249, per-edge componentDistance calls).

        Returns (src [E], dst [E], dist [E]) over all spatial-neighbor pairs.
        """
        adj = self.hierarchy.spatial_neighbors_of(level)
        c, deg = adj.shape
        src = np.repeat(np.arange(c, dtype=np.int64), deg)
        dst = adj.ravel()
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        dist = self._component_distances(level, src, dst)
        return src, dst, dist.astype(np.float32)

    def _component_distances(self, level: int, a: np.ndarray, b: np.ndarray
                             ) -> np.ndarray:
        cs = self._ihs.component_sim
        if cs == ComponentSim.NEIGH_WALKS:
            return sims.walks_bhattacharyya_distance(
                self.hierarchy.random_walks[level], a, b)
        if cs == ComponentSim.NEIGH_WALKS_SINGLE_OVERLAP:
            return sims.walks_single_overlap_distance(
                self.hierarchy.random_walks[level], a, b)
        if cs == ComponentSim.NEIGH_OVERLAP:
            unions = self._union_neighborhoods(level)
            return sims.neighbor_overlap_distance(unions, a, b)
        if cs == ComponentSim.EUCLID_CENTROID:
            return self._hausdorff_distances(level, a, b)
        if cs in (ComponentSim.GEO_CENTROID, ComponentSim.GEO_WALKS):
            return self._geodesic_distances(level, a, b)
        raise ValueError(f"unknown component sim {cs}")

    def _union_neighborhoods(self, level: int):
        if isinstance(self._graph, KnnGraph):
            knn_idx = self._graph.indices
        else:
            knn_idx = np.where(self._graph.mask, self._graph.indices, -1)
        labels = self.hierarchy.pixel_components[level]
        key = (level, self.hierarchy.num_components[level])
        if getattr(self, "_union_cache_key", None) != key:
            self._union_cache = sims.build_union_neighborhoods(
                np.where(knn_idx >= 0, knn_idx, -1),
                labels, self.hierarchy.num_components[level])
            self._union_cache_key = key
        return self._union_cache

    def _hausdorff_distances(self, level: int, a: np.ndarray, b: np.ndarray
                             ) -> np.ndarray:
        reps = self.hierarchy.represented_points(level)
        sizes = np.array([len(r) for r in reps])
        gs = self._ihs.num_geodesic_samples or 0
        max_s = int(sizes.max())
        if gs > 0:
            max_s = min(max_s, gs)
        rep_a = sims.sample_represented(reps, a, max_s,
                                        seed=self._rws.random_seed + level)
        rep_b = sims.sample_represented(reps, b, max_s,
                                        seed=self._rws.random_seed + level + 1)
        return sims.hausdorff_point_set_distance(self._data, rep_a, rep_b)

    def _geodesic_distances(self, level: int, a: np.ndarray, b: np.ndarray
                            ) -> np.ndarray:
        from ..ops.shortest_path import (CONTRACT_THRESHOLD,
                                         geodesic_component_distances,
                                         sketch_geodesic_pairs)
        c = self.hierarchy.num_components[level]
        if level > 0 and c > CONTRACT_THRESHOLD:
            # pixel-level fields scale as C x N; large levels answer
            # pair geodesics from the bounded-hop pixel-graph sketch
            # (ops/geo_sketch.py) — rank-faithful unlike the former
            # component-graph contraction (Spearman 0.42 -> validated in
            # scripts/validate_geo_salinas.py)
            return sketch_geodesic_pairs(
                self._graph, self.hierarchy, self._data, level, a, b,
                num_samples=self._ihs.num_geodesic_samples,
                component_labels=self.component_labels,
                seed=self._rws.random_seed)
        return geodesic_component_distances(
            self._graph, self._data, self.hierarchy, level, a, b,
            num_samples=self._ihs.num_geodesic_samples,
            component_labels=self.component_labels,
            seed=self._rws.random_seed)

    # ------------------------------------------------------------------

    def _select_merges(self, c: int, src, dst, dist, thresh: float, rng):
        """Merge-edge selection (reference: mergeMinBelow :312-362 /
        mergeAllBelow :261-310).  Returns (merge_src, merge_dst,
        zero_sim_count, forced_merge_count)."""
        import scipy.sparse as sp

        # group edges by src; they arrive src-major from _compute_distances
        order = np.lexsort((dst, dist, src))
        src_s, dst_s, dist_s = src[order], dst[order], dist[order]

        below = dist_s < thresh
        if self._ihs.merge_multiple:
            msrc = src_s[below]
            mdst = dst_s[below]
            have = np.zeros(c, dtype=bool)
            have[msrc] = True
        else:
            # min edge per component among those below threshold
            first_idx = np.full(c, -1, dtype=np.int64)
            cand = np.nonzero(below)[0]
            # edges sorted by (src, dist): first below-threshold edge per src
            # is that src's minimum
            s_cand = src_s[cand]
            first_of_src = np.ones(len(cand), dtype=bool)
            first_of_src[1:] = s_cand[1:] != s_cand[:-1]
            sel = cand[first_of_src]
            first_idx[src_s[sel]] = sel
            have = first_idx >= 0
            msrc = src_s[first_idx[have]]
            mdst = dst_s[first_idx[have]]

        # reference counter semantics: mergeMinBelow only counts a component
        # when nothing beat FLT_MAX (i.e. thresh itself was FLT_MAX,
        # ImageHierarchy.cpp:343-351); mergeAllBelow counts any empty
        # candidate list (:289-291)
        unmerged = int(c - int(have.sum()))
        if self._ihs.merge_multiple or thresh >= float(_FLOAT_MAX):
            zero_cnt = unmerged
        else:
            zero_cnt = 0
        forced_cnt = 0
        if unmerged and self._ihs.is_always_merge:
            # forced random merge with a spatial neighbor (reference:
            # RandomMergeNeighbor, ImageHierarchy.cpp:251-259)
            adj = self.hierarchy.spatial_neighbors_of(
                len(self.hierarchy.parents))
            missing = np.nonzero(~have)[0]
            extra_src, extra_dst = [], []
            for comp in missing:
                neighs = adj[comp][adj[comp] >= 0]
                if len(neighs) == 0:
                    continue
                extra_src.append(comp)
                extra_dst.append(rng.choice(neighs))
                forced_cnt += 1
            if extra_src:
                msrc = np.concatenate([msrc, np.array(extra_src)])
                mdst = np.concatenate([mdst, np.array(extra_dst)])

        Log.info("ImageHierarchy: %d components with no similarity on "
                 "current level (%.2f%%)", zero_cnt, 100.0 * zero_cnt / c)
        return msrc.astype(np.int64), mdst.astype(np.int64), zero_cnt, (
            forced_cnt)

    # ------------------------------------------------------------------

    def write_stats(self, file_name: str) -> bool:
        """Reference: ImageHierarchy::writeStats (:607-630)."""
        import json
        try:
            with open(file_name, "w") as f:
                json.dump(self.stats.to_dict(), f, indent=2)
            return True
        except OSError:
            return False
