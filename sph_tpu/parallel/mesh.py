"""Device mesh helpers.

The reference has no distributed runtime (SURVEY.md §2.4 — its parallelism is
OpenMP/TBB shared memory).  The scaling axes added here:

* ``data`` — points/components sharded across chips (kNN rows, t-SNE rows)
* ``scene`` — independent images in a batched evaluation (BASELINE.json
  config #5: 16 hyperspectral stacks across the devices of a mesh)

Collectives are shard_map + psum/all_gather over one host's devices, which
are joined all to all, so the 1-D mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_rows(mesh: Mesh, x: jax.Array, axis_name: str = "data"
               ) -> jax.Array:
    """Place a [N, ...] array row-sharded over the mesh."""
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, x: jax.Array) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P()))
