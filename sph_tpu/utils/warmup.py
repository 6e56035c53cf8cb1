"""Parallel AOT warmup — shrink the truly-cold compile bill.

The reference is an AOT-compiled binary with zero JIT cost; a fresh
machine running this package pays one XLA compile per (program, shape),
and jit compiles them serially, in trace order, as the pipeline discovers
shapes.

This module makes the shape discovery a one-time, shippable artifact:

1. **Record** (``SPH_WARMUP_RECORD=<path>`` or :func:`enable_recording`):
   every package-level jitted function is wrapped in place; each call
   records (module, name, arg signature) once.  Signatures are shape
   metadata only — avals for arrays, literals for scalars/statics.
2. **Replay** (:func:`replay` / ``python -m sph_tpu.utils.warmup m.json``):
   re-import the functions and ``.lower(...).compile()`` every recorded
   signature across a thread pool.  Compiles land in the persistent
   cache, so the subsequent pipeline run deserializes instead of
   compiling.  How far compiles overlap across threads depends on the
   backend's compiler; whether replay pays on the GPU is not measured.

A manifest names the functions of one version of the package; none is
shipped, so record one against the code being deployed.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Optional

import numpy as np

from .logging import Log

_JIT_TYPES = ("PjitFunction", "JitWrapped")

_records: dict = {}
_lock = threading.Lock()
_recording = False
_record_path: Optional[str] = None


def _is_jitted(obj) -> bool:
    return type(obj).__name__ in _JIT_TYPES


def _spec_of(x) -> Optional[dict]:
    """JSON-able signature element: aval for arrays, literal for plain
    scalars; None = unrecordable (skip the whole call)."""
    import jax
    if isinstance(x, (jax.Array, np.ndarray)):
        a = jax.api_util.shaped_abstractify(x)
        return {"aval": [list(a.shape), str(a.dtype),
                         bool(getattr(a, "weak_type", False))]}
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return {"lit": x.item(), "np": str(np.asarray(x).dtype)}
    if isinstance(x, (bool, int, float, str)) or x is None:
        return {"lit": x}
    return None


def _build(spec: dict):
    import jax
    if "aval" in spec:
        shape, dtype, weak = spec["aval"]
        return jax.ShapeDtypeStruct(tuple(shape), np.dtype(dtype),
                                    weak_type=bool(weak))
    v = spec["lit"]
    if "np" in spec:
        return np.dtype(spec["np"]).type(v)
    return v


class _RecordingProxy:
    """Wraps a PjitFunction in place; records each distinct call
    signature once, then delegates."""

    def __init__(self, fn, module: str, name: str):
        self._fn = fn
        self._module = module
        self._name = name
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        try:
            a_specs = [_spec_of(a) for a in args]
            k_specs = {k: _spec_of(v) for k, v in sorted(kwargs.items())}
            if all(s is not None for s in a_specs) and \
                    all(s is not None for s in k_specs.values()):
                key = json.dumps([self._module, self._name, a_specs,
                                  k_specs], sort_keys=True, default=str)
                if key not in self._seen:
                    self._seen.add(key)
                    with _lock:
                        _records[key] = {"module": self._module,
                                         "name": self._name,
                                         "args": a_specs,
                                         "kwargs": k_specs}
                        if _record_path:
                            _flush_locked()
        except Exception:  # noqa: BLE001 — recording must never break a run
            pass
        return self._fn(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._fn, item)


def _flush_locked():
    tmp = _record_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"entries": list(_records.values())}, f, indent=0)
    os.replace(tmp, _record_path)


def enable_recording(path: Optional[str] = None):
    """Wrap every sph_tpu jitted function in place and record call
    signatures (to `path` incrementally when given)."""
    global _recording, _record_path
    if _recording:
        return
    _recording = True
    _record_path = path
    n = 0
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("sph_tpu") or mod is None:
            continue
        for attr, obj in list(vars(mod).items()):
            if _is_jitted(obj):
                setattr(mod, attr, _RecordingProxy(obj, mod_name, attr))
                n += 1
    Log.info("warmup: recording %d jitted functions%s", n,
             f" -> {path}" if path else "")


def maybe_enable_from_env():
    path = os.environ.get("SPH_WARMUP_RECORD")
    if path:
        # import the package modules so their jit objects exist to wrap
        _import_all()
        enable_recording(path)


def _import_all():
    import importlib
    for m in ("sph_tpu.ops.sparse", "sph_tpu.ops.distributions",
              "sph_tpu.ops.walks", "sph_tpu.ops.knn",
              "sph_tpu.ops.device_merge", "sph_tpu.ops.component_knn",
              "sph_tpu.ops.similarities", "sph_tpu.ops.graph",
              "sph_tpu.ops.shortest_path", "sph_tpu.ops.geo_sketch",
              "sph_tpu.ops.tsne_grid", "sph_tpu.ops.csr",
              "sph_tpu.ops.histogram", "sph_tpu.ops.math",
              "sph_tpu.models.tsne",
              "sph_tpu.models.umap", "sph_tpu.models.nearest_neighbors",
              "sph_tpu.models.hierarchy", "sph_tpu.models.image_hierarchy",
              "sph_tpu.models.level_similarities",
              "sph_tpu.models.compute_hierarchy",
              "sph_tpu.models.compute_embedding"):
        try:
            importlib.import_module(m)
        except Exception as exc:  # noqa: BLE001
            Log.warn("warmup: import %s failed: %s", m, exc)


def replay(path: str, threads: int = 8) -> dict:
    """Compile every manifest signature across a thread pool.  Returns
    {'compiled': n_ok, 'failed': n_fail, 'wall_s': s}."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    import importlib

    t0 = time.perf_counter()
    with open(path) as f:
        entries = json.load(f)["entries"]
    _import_all()

    # largest-first: compile time loosely tracks program size, and a big
    # program picked up LAST straggles alone at the end of the pool —
    # schedule by total aval bytes so the long compiles start first
    def _bytes(e):
        total = 0
        for s in list(e["args"]) + list(e["kwargs"].values()):
            if "aval" in s:
                shape, dtype, _ = s["aval"]
                n = 1
                for d in shape:
                    n *= int(d)
                total += n * np.dtype(dtype).itemsize
        return total

    entries = sorted(entries, key=_bytes, reverse=True)

    def one(e):
        try:
            mod = importlib.import_module(e["module"])
            fn = getattr(mod, e["name"])
            if isinstance(fn, _RecordingProxy):
                fn = fn._fn
            if not _is_jitted(fn):
                return False
            args = [_build(s) for s in e["args"]]
            kwargs = {k: _build(s) for k, s in e["kwargs"].items()}
            fn.lower(*args, **kwargs).compile()
            return True
        except Exception as exc:  # noqa: BLE001 — stale entries tolerated
            Log.debug("warmup: %s.%s skipped (%s)", e["module"], e["name"],
                      exc)
            return False

    with ThreadPoolExecutor(max_workers=threads) as ex:
        results = list(ex.map(one, entries))
    out = {"compiled": sum(results),
           "failed": len(results) - sum(results),
           "wall_s": round(time.perf_counter() - t0, 2)}
    Log.info("warmup: replayed %(compiled)d programs "
             "(%(failed)d stale) in %(wall_s).1f s", out)
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="parallel AOT warmup replay")
    p.add_argument("manifest")
    p.add_argument("--threads", type=int, default=8)
    a = p.parse_args(argv)
    print(json.dumps(replay(a.manifest, a.threads)))


if __name__ == "__main__":
    main()
