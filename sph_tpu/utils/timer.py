"""Timing helpers (reference: sph/utils/Timer.hpp — ScopedTimer RAII and the
`utils::timer` lambda wrapper).  On an accelerator, wall-clock timing must
block on device work, so `block=True` calls `jax.block_until_ready` on the
result."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Callable

from .logging import Log

# ---------------------------------------------------------------------------
# accumulating phase timers (enable with SPH_PHASE_TIMERS=1): host-side
# attribution of pipeline wall-clock — which stage/level phase the time goes
# to.  Device work dispatched asynchronously is charged to whichever phase
# blocks on it, so sums match end-to-end wall time.
# ---------------------------------------------------------------------------

_PHASES: dict[str, list] = {}


def phases_enabled() -> bool:
    return os.environ.get("SPH_PHASE_TIMERS") == "1"


@contextmanager
def phase(name: str):
    if not phases_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ent = _PHASES.setdefault(name, [0.0, 0])
        ent[0] += dt
        ent[1] += 1


def phase_report(reset: bool = True, min_s: float = 0.0) -> str:
    rows = sorted(_PHASES.items(), key=lambda kv: -kv[1][0])
    lines = [f"{tot:9.3f}s  x{cnt:<5d} {name}"
             for name, (tot, cnt) in rows if tot >= min_s]
    if reset:
        _PHASES.clear()
    return "\n".join(lines)


@contextmanager
def scoped_timer(name: str, verbose: bool = True):
    """RAII-style timer (reference: Timer.hpp:48-60)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if verbose:
            Log.info("%s took %.3f s", name, dt)


def timer(fn: Callable[[], Any], name: str = "", block: bool = True):
    """Time a callable, returning (result, seconds).

    With block=True the result is blocked on (`jax.block_until_ready`) so
    asynchronous dispatch does not fake the measurement.
    """
    t0 = time.perf_counter()
    result = fn()
    if block:
        try:
            import jax
            result = jax.block_until_ready(result)
        except Exception:
            pass
    dt = time.perf_counter() - t0
    if name:
        Log.info("%s took %.3f s", name, dt)
    return result, dt
