"""Quickstart: build a superpixel hierarchy over a hyperspectral scene and
embed every level with t-SNE, rendering the results to PNG.

    python examples/quickstart.py [out_dir]

Mirrors the reference's README usage (ImageStack -> ComputeHierarchy ->
ComputeEmbedding) end to end.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    from sph_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np
    from sph_tpu import (ComputeEmbedding, ComputeEmbeddingSettings,
                         ComputeHierarchy, ComponentSim,
                         ImageHierarchySettings, ImageStack,
                         LevelSimilaritiesSettings, NearestNeighborsSettings,
                         RandomWalkSettings, Scaler, scale)
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    from sph_tpu import vis

    out_dir = sys.argv[1] if len(sys.argv) > 1 else "quickstart_out"
    os.makedirs(out_dir, exist_ok=True)

    # 1. load (here: synthesize) a hyperspectral image stack
    img = create_hyperspectral_scene(64, 64, channels=50, seed=3)
    stack = ImageStack.from_array(img, name="demo")
    data = scale(stack.data, Scaler.STANDARD)
    print(f"image: {stack.rows}x{stack.cols}x{stack.num_dimensions}")

    # 2. build the superpixel hierarchy
    k = 31
    ch = ComputeHierarchy().init(
        data, stack.rows, stack.cols,
        ihs=ImageHierarchySettings(component_sim=ComponentSim.NEIGH_WALKS,
                                   use_percentile=False),
        lss=LevelSimilaritiesSettings(
            component_sim=ComponentSim.NEIGH_WALKS, ks=[k]),
        rws=RandomWalkSettings(num_random_walks=30, single_walk_length=8,
                               random_seed=1),
        nns=NearestNeighborsSettings(num_nearest_neighbors=k,
                                     symmetric_neighbors=True,
                                     neighbor_connect_components=True,
                                     compute_connect_components=True),
    ).compute()

    h = ch.image_hierarchy.hierarchy
    print(f"hierarchy: {h.num_levels} levels, components per level: "
          f"{h.num_components}")
    vis.plot_hierarchy_levels(h, stack.rows, stack.cols, out_dir)

    # 3. embed each level with t-SNE (coarse-to-fine init)
    s = ComputeEmbeddingSettings()
    s.tsne.num_iterations = 500
    ce = ComputeEmbedding(s)
    prev = None
    for level in range(h.num_levels - 1, -1, -1):
        pd = ch.level_similarities.get_prob_dist(level)
        if prev is not None:
            from sph_tpu import (broadcast_parent_positions,
                                 scale_embedding_to_one)
            init = broadcast_parent_positions(prev, h.parents[level])
            ce.init_embedding(h.num_components[level],
                              scale_embedding_to_one(init))
        emb = ce.compute_tsne(pd, track_kl=True)
        prev = emb
        labels = h.pixel_components[level]
        # color each embedded component by its mean class signature proxy
        sizes = np.bincount(labels, minlength=h.num_components[level])
        vis.plot_embedding(emb, sizes,
                           os.path.join(out_dir, f"tsne_level_{level}.png"),
                           title=f"level {level} (KL {ce.last_kl:.3f})")
        print(f"level {level}: {h.num_components[level]} comps, "
              f"KL {ce.last_kl:.4f}")

    print(f"wrote plots to {out_dir}/")


if __name__ == "__main__":
    main()
