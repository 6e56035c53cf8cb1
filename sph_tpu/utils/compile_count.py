"""Count XLA program compilations (VERDICT r2 weak #2: "100+ compiled
programs per hierarchy is itself a target — measure how many unique
shapes survive [bucketing]").

jax logs one "Finished XLA compilation of <name>" line per program load
when ``jax_log_compiles`` is on — both for genuine compiles and for
persistent-cache deserializations (the latter also log "Persistent
compilation cache hit"), so the count is the number of distinct
(program, shape) executables the workload touches regardless of cache
warmth.

Usage::

    with count_compiles() as cc:
        run_workload()
    print(cc.total, cc.persistent_hits, cc.by_name)
"""

from __future__ import annotations

import logging
import re
from collections import Counter
from contextlib import contextmanager

_FINISHED = re.compile(r"Finished XLA compilation of ([^ ]+) in")
_PERSISTENT_HIT = re.compile(r"Persistent compilation cache hit")


class CompileCounter(logging.Handler):
    def __init__(self) -> None:
        super().__init__()
        self.total = 0
        self.persistent_hits = 0
        self.by_name: Counter[str] = Counter()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 — never break the logging path
            return
        m = _FINISHED.search(msg)
        if m:
            self.total += 1
            # strip jit(...) wrapper and shape-dependent suffixes so by_name
            # groups recompilations of the same function
            name = m.group(1)
            if name.startswith("jit(") and name.endswith(")"):
                name = name[4:-1]
            self.by_name[name] += 1
        elif _PERSISTENT_HIT.search(msg):
            self.persistent_hits += 1

    def top(self, n: int = 8) -> dict:
        return dict(self.by_name.most_common(n))


@contextmanager
def count_compiles():
    """Enable jax_log_compiles and count per-program compile events for the
    duration of the block.  Restores the previous flag value on exit."""
    import jax

    prev = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", True)
    counter = CompileCounter()
    loggers = [logging.getLogger("jax._src.dispatch"),
               logging.getLogger("jax._src.compiler"),
               logging.getLogger("jax._src.interpreters.pxla")]
    prev_state = [(lg.level, lg.propagate) for lg in loggers]
    for lg in loggers:
        lg.addHandler(counter)
        # jax_log_compiles emits at WARNING; keep the lines out of stderr
        # (driver log hygiene) — only this handler sees them
        lg.propagate = False
        if lg.level > logging.WARNING or lg.level == logging.NOTSET:
            lg.setLevel(logging.WARNING)
    try:
        yield counter
    finally:
        for lg, (lvl, prop) in zip(loggers, prev_state):
            lg.removeHandler(counter)
            lg.setLevel(lvl)
            lg.propagate = prop
        jax.config.update("jax_log_compiles", prev)
