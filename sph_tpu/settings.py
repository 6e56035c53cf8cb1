"""Settings vocabulary for the sph-tpu pipeline.

Mirrors the reference's settings structs and enums (reference:
sph/utils/Settings.hpp:27-181) so that users of the C++ library find the same
knobs here.  All settings are plain dataclasses with JSON round-trip support
used by the stage cache for parameter validation (Settings.hpp:229-268).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Optional


class Scaler(enum.Enum):
    """Input data scalers (reference: sph/utils/Settings.hpp:27-32)."""

    NONE = "none"
    STANDARD = "standard"    # channel-wise z = (x - mean) / std
    UNIFORM = "uniform"      # channel-wise [0, 1]
    ROBUST = "robust"        # clamp to 95-percentile, global [0, 1]


class KnnIndex(enum.Enum):
    """kNN engine selection (reference: sph/utils/Settings.hpp:35-42).

    The exact engines are blocked matmul + streaming top-k; the
    approximate tiers subsample/cluster before the matmul.  BRUTE_FORCE and
    FLAT are identical here (the reference distinction is a FAISS memory
    detail).
    """

    BRUTE_FORCE = "brute_force"
    FLAT = "flat"
    IVF_FLAT = "ivf_flat"
    HNSW = "hnsw"            # mapped to IVF-style cluster pruning
    HNSWSQ = "hnswsq"        # + int8 quantized distances
    HNSW_IVFPQ = "hnsw_ivfpq"


class KnnMetric(enum.Enum):
    L2 = "l2"
    COSINE = "cosine"
    INNER_PRODUCT = "inner_product"


class ComponentSim(enum.Enum):
    """Component-pair similarity metrics (reference: Settings.hpp:50-57)."""

    NEIGH_OVERLAP = "neigh_overlap"
    GEO_CENTROID = "geo_centroid"
    NEIGH_WALKS = "neigh_walks"                       # Bhattacharyya
    NEIGH_WALKS_SINGLE_OVERLAP = "neigh_walks_single_overlap"
    GEO_WALKS = "geo_walks"
    EUCLID_CENTROID = "euclid_centroid"


class ImportanceWeighting(enum.Enum):
    """Random-walk step weighting (reference: Settings.hpp:59-65)."""

    CONSTANT = "constant"
    LINEAR = "linear"
    NORMAL = "normal"
    ONLYLAST = "onlylast"
    FIRST_VISIT = "first_visit"


class NormalizationScheme(enum.Enum):
    NONE = "none"
    TSNE = "tsne"      # Gaussian kernel with perplexity
    UMAP = "umap"      # exponential kernel (smooth-knn)
    LINEAR = "linear"  # 1 / (1 + d)


class RandomWalkHandling(enum.Enum):
    """How walk matrices evolve between levels (reference: Settings.hpp:74-79)."""

    MERGE_RW_ONLY = "merge_rw_only"
    MERGE_RW_NEW_WALKS = "merge_rw_new_walks"
    MERGE_RW_NEW_WALKS_AND_KNN = "merge_rw_new_walks_and_knn"
    MERGE_DATA_NEW_WALKS = "merge_data_new_walks"


class RandomWalkReduction(enum.Enum):
    """Adaptive walk-length schedule (reference: Settings.hpp:81-89,
    policies applied in ImageHierarchy.cpp:504-548)."""

    NONE = "none"
    PROPORTIONAL_COMPONENT_REDUCTION = "proportional_component_reduction"
    PROPORTIONAL_HALF = "proportional_half"
    PROPORTIONAL_DOUBLE = "proportional_double"
    CONSTANT = "constant"
    CONSTANT_LOW = "constant_low"
    CONSTANT_HIGH = "constant_high"


class NeighConnection(enum.Enum):
    FOUR = "four"
    EIGHT = "eight"


class EmbeddingInit(enum.Enum):
    RANDOM = "random"
    PCA = "pca"
    SPECTRAL = "spectral"


class NormType(enum.Enum):
    ONEDIM = "onedim"   # per-row sum-to-one
    TWODIM = "twodim"   # whole-matrix sum-to-one


@dataclass
class RandomWalkSettings:
    """Reference: sph/utils/Settings.hpp:91-103."""

    num_random_walks: int = 90
    single_walk_length: int = 15
    minimum_single_walk_length: int = 5
    prune_value: float = 0.0
    prune_steps: int = 0
    importance_weighting: ImportanceWeighting = ImportanceWeighting.CONSTANT
    normalize: bool = True
    remove_diagonal: bool = True
    random_seed: int = 1
    # kept for API parity; device walks are always deterministic given the seed
    parallel: bool = True
    # not in the reference: cap on stored non-zeros per walk row
    # (fixed-width sparse rows).  0 means "derive from walk budget"
    # (num_walks * walk_length).
    max_row_nnz: int = 0


@dataclass
class NearestNeighborsSettings:
    """Reference: sph/utils/Settings.hpp:134-143."""

    num_nearest_neighbors: int = 0
    knn_index: KnnIndex = KnnIndex.FLAT
    knn_metric: KnnMetric = KnnMetric.L2
    symmetric_neighbors: bool = False
    compute_connect_components: bool = False
    neighbor_connect_components: bool = False
    l2_squared: bool = False


@dataclass
class ImageHierarchySettings:
    """Reference: sph/utils/Settings.hpp:145-167."""

    component_sim: ComponentSim = ComponentSim.NEIGH_OVERLAP
    neighbor_connection: NeighConnection = NeighConnection.FOUR
    merge_multiple: bool = False
    use_percentile: bool = True
    max_dist: float = 0.0            # -1.0 => always merge (random fallback)
    min_num_comp: int = 1
    min_reduction: float = 99.99
    num_geodesic_samples: int = 0    # 0 == unlimited (reference: SIZE_MAX)
    max_levels: int = -1
    verbose: bool = False
    rw_handling: RandomWalkHandling = RandomWalkHandling.MERGE_RW_ONLY
    rw_reduction: RandomWalkReduction = (
        RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION)
    norm_knn_distances: NormalizationScheme = NormalizationScheme.TSNE
    rw_weight_merge_by_size: bool = True
    rw_norm_sim: NormType = NormType.ONEDIM
    rw_remove_self_sim_after_merging: bool = True

    @property
    def is_always_merge(self) -> bool:
        return self.max_dist == -1.0


@dataclass
class LevelSimilaritiesSettings:
    """Reference: sph/utils/Settings.hpp:169-181."""

    component_sim: ComponentSim = ComponentSim.NEIGH_OVERLAP
    ks: list[int] = field(default_factory=list)
    exact_knn: bool = False
    force_compute_distances: bool = False
    level_to_compute: int = -1      # -1 == all levels
    random_walk_pair_sims: bool = True
    weight_transition_by_size: bool = False
    normalize_prob_dist: NormalizationScheme = NormalizationScheme.TSNE
    compute_symmetric_prob_dist: NormalizationScheme = NormalizationScheme.TSNE


@dataclass
class CacheSettings:
    """Reference: sph/utils/Settings.hpp:126-132."""

    path: str = ""
    file_name: str = ""
    cache_active: bool = False
    ignore_subfolder: bool = False
    custom_subfolder: str = ""


# --------------------------------------------------------------------------
# JSON round trip (reference: Settings.cpp addToJson/readFromJson/checkEntry)
# --------------------------------------------------------------------------

def settings_to_dict(settings: Any) -> dict:
    """Serialize a settings dataclass to a JSON-compatible dict."""
    out: dict[str, Any] = {"__type__": type(settings).__name__}
    for f in dataclasses.fields(settings):
        v = getattr(settings, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        out[f.name] = v
    return out


_SETTINGS_TYPES = {}


def _register(cls):
    _SETTINGS_TYPES[cls.__name__] = cls
    return cls


for _cls in (RandomWalkSettings, NearestNeighborsSettings,
             ImageHierarchySettings, LevelSimilaritiesSettings, CacheSettings):
    _register(_cls)


def settings_from_dict(d: dict) -> Any:
    """Deserialize a dict produced by :func:`settings_to_dict`."""
    cls = _SETTINGS_TYPES[d["__type__"]]
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(f.type, str):
            ftype = f.type
        else:  # pragma: no cover - dataclasses stores str annotations here
            ftype = getattr(f.type, "__name__", str(f.type))
        # enum fields: resolve by annotation name
        ann = _ENUM_ANNOTATIONS.get(ftype)
        if ann is not None and isinstance(v, str):
            v = ann(v)
        kwargs[f.name] = v
    return cls(**kwargs)


_ENUM_ANNOTATIONS = {
    "Scaler": Scaler,
    "KnnIndex": KnnIndex,
    "KnnMetric": KnnMetric,
    "ComponentSim": ComponentSim,
    "ImportanceWeighting": ImportanceWeighting,
    "NormalizationScheme": NormalizationScheme,
    "RandomWalkHandling": RandomWalkHandling,
    "RandomWalkReduction": RandomWalkReduction,
    "NeighConnection": NeighConnection,
    "EmbeddingInit": EmbeddingInit,
    "NormType": NormType,
}


def settings_to_json(settings: Any) -> str:
    return json.dumps(settings_to_dict(settings), sort_keys=True, indent=2)


def settings_from_json(s: str) -> Any:
    return settings_from_dict(json.loads(s))


def settings_match(stored: dict, current: Any) -> bool:
    """Parameter check used by the stage cache (reference: checkEntry,
    Settings.hpp:249-268): every field of `current` must match `stored`."""
    cur = settings_to_dict(current)
    for k, v in cur.items():
        if k not in stored or stored[k] != v:
            return False
    return True
