"""Profiling and debug-mode helpers.

Reference §5.1: ScopedTimer RAII timers + Catch2 BENCHMARK blocks — the JAX
equivalents are `jax.profiler` traces plus block_until_ready wall-clock
timing (utils/timer.py).

Reference §5.2: debug builds disable OpenMP entirely so serial execution is
the ground truth (CommonDefinitions.hpp:10-14); the JAX analogue is
`ground_truth_mode()` — op-by-op eager execution (jit disabled) to compare
against compiled results.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import jax

from .logging import Log


@contextlib.contextmanager
def trace(log_dir: str = "sph_trace",
          create_perfetto_link: bool = False):
    """Capture a jax.profiler trace around a region (view with
    tensorboard / xprof)."""
    os.makedirs(log_dir, exist_ok=True)
    Log.info("profiler: tracing to %s", log_dir)
    with jax.profiler.trace(log_dir,
                            create_perfetto_link=create_perfetto_link):
        yield log_dir


@contextlib.contextmanager
def ground_truth_mode():
    """Disable jit so every op runs eagerly — the serial ground truth the
    reference gets from its no-OpenMP debug builds.  Compiled-vs-eager
    comparisons catch fusion/layout bugs the way TSAN-less reference debug
    builds catch races."""
    with jax.disable_jit():
        yield


def annotate(name: str):
    """Named profiler region (shows up in the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> Optional[dict]:
    """Live device memory stats where the backend exposes them."""
    try:
        dev = jax.devices()[0]
        return dev.memory_stats()
    except Exception:
        return None
