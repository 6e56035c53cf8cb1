"""sph-tpu: a superpixel-hierarchy + embedding framework on the GPU.

A from-scratch JAX/XLA rebuild of the capabilities of alxvth/SPH
(superpixel hierarchies and t-SNE/UMAP embeddings for high-dimensional
images), keeping its four-stage public API:

    ImageStack -> ComputeHierarchy{NearestNeighbors -> ImageHierarchy ->
    LevelSimilarities} -> ComputeEmbedding{t-SNE | UMAP}

See SURVEY.md for the structural map of the reference implementation.
"""

from .data import ImageStack, scale
from .settings import (CacheSettings, ComponentSim, EmbeddingInit,
                       ImageHierarchySettings, ImportanceWeighting, KnnIndex,
                       KnnMetric, LevelSimilaritiesSettings,
                       NearestNeighborsSettings, NeighConnection,
                       NormalizationScheme, NormType, RandomWalkHandling,
                       RandomWalkReduction, RandomWalkSettings, Scaler)
from .models.compute_embedding import (ComputeEmbedding,
                                       ComputeEmbeddingSettings,
                                       average_position_of_children,
                                       broadcast_parent_positions,
                                       scale_embedding_to_one)
from .models.compute_hierarchy import ComputeHierarchy
from .models.hierarchy import Hierarchy
from .models.image_hierarchy import ImageHierarchy
from .models.level_similarities import LevelSimilarities
from .models.nearest_neighbors import NearestNeighbors
from .models.tsne import TsneComputation, TsneParameters
from .models.umap import UmapComputation, UmapParameters
from .ops.graph import KnnGraph, PaddedGraph
from .ops.sparse import SparseRows

__version__ = "0.1.0"

# opt-in compile-signature recording for the parallel AOT warmup
# (utils/warmup.py): active only when SPH_WARMUP_RECORD is set
import os as _os
if _os.environ.get("SPH_WARMUP_RECORD"):
    from .utils.warmup import maybe_enable_from_env as _warmup_rec
    _warmup_rec()
if _os.environ.get("SPH_WARMUP_REPLAY"):
    # parallel AOT warmup on import (fresh-pod cold-start path): compile
    # the manifest's program family across threads before first use
    from .utils.warmup import replay as _warmup_replay
    _warmup_replay(_os.environ["SPH_WARMUP_REPLAY"],
                   threads=int(_os.environ.get("SPH_WARMUP_THREADS", "12")))

__all__ = [
    "ImageStack", "scale",
    "ComputeHierarchy", "ComputeEmbedding", "ComputeEmbeddingSettings",
    "NearestNeighbors", "ImageHierarchy", "LevelSimilarities", "Hierarchy",
    "TsneComputation", "TsneParameters", "UmapComputation", "UmapParameters",
    "KnnGraph", "PaddedGraph", "SparseRows",
    "CacheSettings", "ComponentSim", "EmbeddingInit",
    "ImageHierarchySettings", "ImportanceWeighting", "KnnIndex", "KnnMetric",
    "LevelSimilaritiesSettings", "NearestNeighborsSettings",
    "NeighConnection", "NormalizationScheme", "NormType",
    "RandomWalkHandling", "RandomWalkReduction", "RandomWalkSettings",
    "Scaler", "scale_embedding_to_one", "average_position_of_children",
    "broadcast_parent_positions",
]
