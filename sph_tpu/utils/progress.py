"""Console progress bar (reference: sph/utils/ProgressBar.hpp:15-62 —
mutex-safe console bar on every long loop).  On the device the long loops are
single device dispatches, so this is mostly used by the host-side level loop
and the eval grid."""

from __future__ import annotations

import sys
import threading
import time


class ProgressBar:
    def __init__(self, total: int, verbose: bool = True, width: int = 40):
        self.total = max(int(total), 1)
        self.count = 0
        self.verbose = verbose
        self.width = width
        self._lock = threading.Lock()
        self._start = time.perf_counter()
        self._last_draw = 0.0

    def update(self, n: int = 1):
        with self._lock:
            self.count += n
            self._draw()

    def update_by(self, n: int):
        self.update(n)

    def reset(self, total: int | None = None):
        with self._lock:
            if total is not None:
                self.total = max(int(total), 1)
            self.count = 0
            self._start = time.perf_counter()

    def _draw(self):
        if not self.verbose:
            return
        now = time.perf_counter()
        if now - self._last_draw < 0.1 and self.count < self.total:
            return
        self._last_draw = now
        frac = min(self.count / self.total, 1.0)
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        sys.stderr.write(f"\r[{bar}] {self.count}/{self.total} "
                         f"({100 * frac:5.1f}%)")
        sys.stderr.flush()

    def finish(self):
        if self.verbose:
            self.count = self.total
            self._draw()
            sys.stderr.write("\n")
            sys.stderr.flush()
