"""UMAP optimizer-parity anchor at Salinas level-1 scale (28k components).

VERDICT r3 item 4's quality leg: the 600-pt trustworthiness anchor
(docs/umap_anchor.json) stops far below the 28,373-component band where
the scatter-free rows tier operates.  This script reuses the level-1
similarity rows cached by scripts/anchor_kl.py (ANCHOR_SCENE=salinas) and
runs BOTH optimizers on identical memberships, (a, b), epochs, and init:

  - native umap_sequential — per-edge sequential updates, the semantics of
    the reference's umappp optimizer (EmbedUmap.cpp:233-269)
  - models/umap.py batched-epoch SGD (rows tier at this N)

Quality metric: graph-neighborhood preservation — for each row, the
fraction of its top-10 strongest membership neighbors found among the
embedding's 15 nearest neighbors (trustworthiness needs the original
high-dim component features, which the P cache does not carry; the
membership graph IS the structure both optimizers are asked to preserve).
Writes docs/umap_anchor_salinas.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

P_CACHE = "/tmp/anchor_salinas_p.npz"


def neighborhood_preservation(emb: np.ndarray, top_src: np.ndarray,
                              k_emb: int = 15) -> float:
    """Mean fraction of each row's graph neighbors (top_src, -1 padded)
    found among its k_emb nearest embedding neighbors."""
    from sph_tpu.ops.knn import knn_bruteforce
    eidx, _ = knn_bruteforce(np.ascontiguousarray(emb, np.float32),
                             k_emb + 1)
    eidx = eidx[:, 1:]                                    # drop self
    hits = 0
    total = 0
    for r in range(emb.shape[0]):
        want = top_src[r]
        want = want[want >= 0]
        if want.size == 0:
            continue
        hits += np.intersect1d(want, eidx[r]).size
        total += want.size
    return hits / max(total, 1)


def main():
    from sph_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from sph_tpu import native
    from sph_tpu.models.umap import (UmapComputation, UmapParameters,
                                     find_ab, make_epochs_per_sample)
    from sph_tpu.ops.sparse import SparseRows
    from sph_tpu.utils.logging import set_level

    set_level("WARNING")
    if native.get_lib() is None:
        print("native library unavailable", file=sys.stderr)
        sys.exit(1)
    if not os.path.exists(P_CACHE):
        print(f"run ANCHOR_SCENE=salinas scripts/anchor_kl.py first "
              f"(missing {P_CACHE})", file=sys.stderr)
        sys.exit(1)

    z = np.load(P_CACHE)
    m = SparseRows(z["indices"].astype(np.int32),
                   z["values"].astype(np.float32), int(z["num_cols"]))
    n = m.num_rows
    n_epochs = int(os.environ.get("ANCHOR_UMAP_EPOCHS", "500"))
    a, b = find_ab(1.0, 0.1)
    print(f"# level-1 memberships: n={n}, width={m.width}, "
          f"nnz={int(m.row_nnz().sum())}", flush=True)

    rng = np.random.default_rng(7)
    init = (rng.standard_normal((n, 2)) * 10.0).astype(np.float32)

    # top-10 strongest membership neighbors per row (the preservation
    # target, fixed before either optimizer runs)
    mask = m.mask & (m.values > 0)
    vals = np.where(mask, m.values, -np.inf)
    order = np.argsort(-vals, axis=1)[:, :10]
    top_src = np.take_along_axis(
        np.where(mask, m.indices, -1), order, axis=1).astype(np.int32)

    # sequential per-edge oracle (umappp semantics)
    src = np.broadcast_to(np.arange(n)[:, None],
                          m.indices.shape)[mask].astype(np.int32)
    dst = m.indices[mask].astype(np.int32)
    eps = make_epochs_per_sample(m.values[mask], n_epochs).astype(np.float32)
    t0 = time.perf_counter()
    emb_seq = native.umap_sequential(init, src, dst, eps, n_epochs,
                                     a, b, neg_rate=5, seed=42)
    seq_s = time.perf_counter() - t0
    assert np.all(np.isfinite(emb_seq))
    print(f"# sequential oracle: {seq_s:.1f}s", flush=True)

    # batched-epoch optimizer, identical memberships + init
    um = UmapComputation(UmapParameters(num_epochs=n_epochs, seed=123))
    um.set_memberships(m)                # m is already the symmetric union
    um.set_initial_embedding(init)
    t1 = time.perf_counter()
    um.compute()
    bat_s = time.perf_counter() - t1
    emb_bat = um.embedding
    assert np.all(np.isfinite(emb_bat))
    print(f"# batched ({um._tier} tier): {bat_s:.1f}s", flush=True)

    np_seq = neighborhood_preservation(emb_seq, top_src)
    np_bat = neighborhood_preservation(emb_bat, top_src)
    out = {
        "setup": (f"Salinas level-1 walk-similarity rows (n={n}, "
                  f"{n_epochs} epochs, identical memberships/(a,b)/init)"),
        "metric": "top-10 membership neighbors preserved in emb 15-NN",
        "sequential_per_edge_optimizer": {
            "preservation": round(np_seq, 4),
            "wall_s": round(seq_s, 1)},
        "batched_epoch_optimizer": {
            "tier": um._tier,
            "preservation": round(np_bat, 4),
            "wall_s": round(bat_s, 1)},
        "ratio_batched_over_sequential": round(np_bat / max(np_seq, 1e-9),
                                               4),
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "docs", "umap_anchor_salinas.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
