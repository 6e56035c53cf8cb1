"""Multi-chip execution: mesh helpers + sharded kNN / t-SNE / batching.

Reference has no distributed layer (SURVEY.md §2.4) — this package is the
Device replacement for its OpenMP shared-memory parallelism, scaling
over a `jax.sharding.Mesh` with XLA collectives instead of threads.
"""

from .mesh import make_mesh, replicate, shard_rows
from .sharded import (make_sharded_grid_tsne_step, make_sharded_tsne_step,
                      make_sharded_umap_epoch, multi_scene_tsne,
                      sharded_grid_tsne, sharded_knn, sharded_tsne,
                      sharded_umap)

__all__ = [
    "make_mesh", "replicate", "shard_rows",
    "make_sharded_grid_tsne_step", "make_sharded_tsne_step",
    "make_sharded_umap_epoch", "multi_scene_tsne", "sharded_grid_tsne",
    "sharded_knn", "sharded_tsne", "sharded_umap",
]
