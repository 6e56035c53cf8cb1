"""Sparse-matrix and pipeline statistics.

Reference: sph/utils/Statistics.hpp:14-30 (`SparseMatrixStats`: sparsity,
nnz, average nnz, printed at every transformation via
printSparseMatrixStats) and the atomic counter blocks in ShortestPath.cpp
:18-35 / Similarities.cpp :70-81 printed at pipeline end
(ComputeHierarchy.cpp:236-240).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .logging import Log


@dataclass
class SparseMatrixStats:
    """Reference: Statistics.hpp:14-30."""

    non_zeros: int = 0
    total_entries: int = 0
    average_non_zeros: float = 0.0
    sparsity: float = 0.0

    @classmethod
    def of(cls, rows) -> "SparseMatrixStats":
        """Compute over a SparseRows / KnnGraph / PaddedGraph."""
        from ..ops.graph import KnnGraph, PaddedGraph
        from ..ops.sparse import SparseRows
        if isinstance(rows, SparseRows):
            nnz = rows.nnz()
            n, c = rows.num_rows, rows.num_cols
        elif isinstance(rows, KnnGraph):
            n = rows.num_points
            c = n
            nnz = n * rows.k
        elif isinstance(rows, PaddedGraph):
            n = rows.num_points
            c = n
            nnz = rows.num_edges()
        else:
            raise TypeError(type(rows))
        total = n * c
        return cls(nnz, total, nnz / max(n, 1),
                   1.0 - nnz / max(total, 1))


def print_sparse_matrix_stats(rows, name: str = ""):
    """Reference: printSparseMatrixStats (Statistics.hpp:23)."""
    s = SparseMatrixStats.of(rows)
    Log.info("%s: nnz %d of %d (avg %.2f per row, sparsity %.4f%%)",
             name or "sparse matrix", s.non_zeros, s.total_entries,
             s.average_non_zeros, 100.0 * s.sparsity)
    return s


@dataclass
class PipelineCounters:
    """Run counters (the analogue of the reference's atomic shortest-path /
    similarity-cache statistics; recomputation replaced caching on the
    device so the counters track kernel dispatches instead)."""

    knn_blocks: int = 0
    walk_batches: int = 0
    distance_edge_evals: int = 0
    sssp_fields: int = 0

    def report(self):
        Log.info("PipelineCounters: knn_blocks=%d walk_batches=%d "
                 "edge_evals=%d sssp_fields=%d", self.knn_blocks,
                 self.walk_batches, self.distance_edge_evals,
                 self.sssp_fields)


GLOBAL_COUNTERS = PipelineCounters()
