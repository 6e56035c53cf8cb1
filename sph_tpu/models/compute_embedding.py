"""ComputeEmbedding — the embedding facade.

Reference: sph/ComputeEmbedding.hpp:37-81 / .cpp — dispatches a probability
distribution or a distance graph to t-SNE/UMAP, random disk init of radius
0.1 via polar sampling (:25-50), chunked t-SNE with progress (:85-129),
1-point short-circuit (:69-74).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from ..ops.math import random_disk_init
from ..ops.sparse import SparseRows
from ..utils.logging import Log
from .tsne import TsneComputation, TsneParameters
from .umap import UmapComputation, UmapParameters


@dataclass
class ComputeEmbeddingSettings:
    """Reference: ComputeEmbedding.hpp:25-29."""

    tsne: TsneParameters = field(default_factory=TsneParameters)
    umap: UmapParameters = field(default_factory=UmapParameters)
    init_radius: float = 0.1
    seed: int = 0


class ComputeEmbedding:
    """Reference: sph/ComputeEmbedding.hpp:37."""

    def __init__(self, settings: Optional[ComputeEmbeddingSettings] = None):
        self.settings = settings or ComputeEmbeddingSettings()
        self._init_embedding: Optional[np.ndarray] = None
        self.current_embedding: Optional[np.ndarray] = None
        self.last_kl: Optional[float] = None

    # ------------------------------------------------------------------

    def init_embedding(self, num_points: int,
                       embedding: Optional[np.ndarray] = None):
        """Random disk init r=0.1 (reference: :25-50) or a user-provided
        layout (e.g. previous-level average, PCA, spectral)."""
        if embedding is not None:
            assert embedding.shape == (num_points, 2)
            self._init_embedding = np.asarray(embedding, np.float32)
        else:
            self._init_embedding = random_disk_init(
                num_points, self.settings.init_radius, self.settings.seed)

    # ------------------------------------------------------------------

    def compute_tsne(self, inp: Union[SparseRows, tuple],
                     track_kl: bool = False) -> np.ndarray:
        """Reference: computeTSNE (:52-129).  `inp` is a symmetrized
        probability SparseRows or an (indices, distances) kNN graph tuple."""
        tsne = TsneComputation(self.settings.tsne)
        if isinstance(inp, SparseRows):
            tsne.set_probability_distribution(inp)
            n = inp.num_rows
        else:
            tsne.set_neighbor_graph(*inp)
            n = inp[0].shape[0]

        if n == 1:
            Log.info("ComputeEmbedding: only 1 point, not embedding")
            self.current_embedding = np.zeros((1, 2), np.float32)
            if track_kl:
                self.last_kl = 0.0
            return self.current_embedding
        if self._init_embedding is None or len(self._init_embedding) != n:
            self.init_embedding(n)
        tsne.set_initial_embedding(self._init_embedding)

        total = self.settings.tsne.num_iterations
        # run in chunks of 50 (reference uses 10 for UI progress; larger
        # chunks amortize dispatch)
        chunk = 50
        done = 0
        tsne.compute(min(chunk, total), verbose=False)
        done += min(chunk, total)
        while done < total:
            step = min(chunk, total - done)
            tsne.continue_gradient_descent(step, verbose=False)
            done += step
        self.current_embedding = tsne.embedding
        if track_kl:
            self.last_kl = tsne.kl_divergence()
            Log.info("t-SNE: final KL divergence %.6f", self.last_kl)
        self._init_embedding = None
        return self.current_embedding

    def compute_umap(self, inp: Union[SparseRows, tuple]) -> np.ndarray:
        """Reference: computeUMAP (:131-174)."""
        umap = UmapComputation(self.settings.umap)
        if isinstance(inp, SparseRows):
            umap.set_neighbor_matrix(inp)
            n = inp.num_rows
        else:
            umap.set_neighbor_graph(*inp)
            n = inp[0].shape[0]

        if n == 1:
            Log.info("ComputeEmbedding: only 1 point, not embedding")
            self.current_embedding = np.zeros((1, 2), np.float32)
            return self.current_embedding
        if self._init_embedding is not None and len(
                self._init_embedding) == n:
            umap.set_initial_embedding(self._init_embedding)
        umap.compute()
        self.current_embedding = umap.embedding
        self._init_embedding = None
        return self.current_embedding

    def get_embedding(self) -> np.ndarray:
        return self.current_embedding


def scale_embedding_to_one(emb: np.ndarray) -> np.ndarray:
    """Reference: utils/Embedding.cpp scaleEmbeddingToOne (:88)."""
    mx = np.abs(emb).max()
    return emb / mx if mx > 0 else emb


def average_position_of_children(emb_fine: np.ndarray,
                                 parents: np.ndarray,
                                 num_parents: Optional[int] = None
                                 ) -> np.ndarray:
    """Fine-to-coarse init: each coarse component starts at the mean of its
    children's embedded positions (reference:
    averageEmbeddingPositionOfChildren, utils/Embedding.cpp:131 — the eval
    driver seeds level L from level L-1's embedding)."""
    parents = np.asarray(parents)
    if num_parents is None:
        num_parents = int(parents.max()) + 1
    sums = np.zeros((num_parents, emb_fine.shape[1]), dtype=np.float64)
    np.add.at(sums, parents, emb_fine)
    counts = np.bincount(parents, minlength=num_parents)[:, None]
    return (sums / np.maximum(counts, 1)).astype(np.float32)


def broadcast_parent_positions(emb_coarse: np.ndarray,
                               parents: np.ndarray) -> np.ndarray:
    """Coarse-to-fine init: each fine component starts at its parent's
    position (the inverse warm start, used when embedding coarse levels
    first)."""
    return emb_coarse[parents]
