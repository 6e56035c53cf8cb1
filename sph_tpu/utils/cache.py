"""Staged checkpoint/memoization cache.

Reference: sph/utils/Cacheable.hpp:11-63 — each stage writes a versioned
parameter JSON plus LZ4-compressed binary payloads; `loadCache` validates
every parameter against current settings and refuses stale caches; a child
stage will not load its cache unless its parent stage's cache loaded
(`cacheDependencyIsValid`) — plus sph/utils/FileIO.hpp's chunked compressed
serialization.

Equivalent here: LZ4-compressed array archives (utils/fileio.py, backed by
the native block codec) keyed by stage name, with the same parameter-JSON
validation and parent-chain invalidation.  Legacy zlib/npz payloads from
older caches remain readable.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

from ..settings import settings_to_dict
from . import fileio
from .logging import Log

CACHE_VERSION = "1.0"


def _settings_payload(settings: Any) -> dict:
    if isinstance(settings, tuple):
        return {"__multi__": [settings_to_dict(s) for s in settings]}
    return settings_to_dict(settings)


class StageCache:
    """Per-run stage cache with dependency chaining."""

    def __init__(self, path: str, file_name: str = ""):
        self.path = path
        self.file_name = file_name
        os.makedirs(path, exist_ok=True)
        self._loaded_ok: dict[str, bool] = {}

    def _base(self, stage: str) -> str:
        name = f"{self.file_name}_{stage}" if self.file_name else stage
        return os.path.join(self.path, name)

    # ------------------------------------------------------------------

    def load(self, stage: str, settings: Any,
             depends_on: Optional[str] = None) -> Optional[dict]:
        """Load the stage payload if parameters match and the parent stage
        (if any) was itself loaded from cache (reference:
        cacheDependencyIsValid, Cacheable.hpp:46)."""
        if depends_on is not None and not self._loaded_ok.get(depends_on):
            Log.info("StageCache[%s]: dependency '%s' not loaded from "
                     "cache, refusing", stage, depends_on)
            self._loaded_ok[stage] = False
            return None

        base = self._base(stage)
        param_file = base + "_params.json"
        data_file = base + "_payload.sph4"
        if not os.path.exists(data_file):
            data_file = base + "_payload.npz"  # legacy archives
        if not (os.path.exists(param_file) and os.path.exists(data_file)):
            self._loaded_ok[stage] = False
            return None
        try:
            with open(param_file) as f:
                stored = json.load(f)
        except (OSError, json.JSONDecodeError):
            self._loaded_ok[stage] = False
            return None
        if stored.get("## VERSION ##") != CACHE_VERSION:
            Log.info("StageCache[%s]: version mismatch", stage)
            self._loaded_ok[stage] = False
            return None
        if stored.get("settings") != _settings_payload(settings):
            Log.info("StageCache[%s]: settings differ from cache, "
                     "recomputing", stage)
            self._loaded_ok[stage] = False
            return None
        try:
            if data_file.endswith(".sph4"):
                payload = fileio.read_dict(data_file)
            else:
                with np.load(data_file, allow_pickle=False) as z:
                    payload = {k: z[k] for k in z.files}
        except (OSError, ValueError) as e:
            Log.warn("StageCache[%s]: payload load failed (%s)", stage, e)
            self._loaded_ok[stage] = False
            return None
        Log.info("StageCache[%s]: loaded from %s", stage, data_file)
        self._loaded_ok[stage] = True
        return payload

    def write(self, stage: str, settings: Any, payload: dict,
              depends_on: Optional[str] = None) -> bool:
        base = self._base(stage)
        try:
            fileio.write_dict(base + "_payload.sph4", payload)
            with open(base + "_params.json", "w") as f:
                json.dump({"## VERSION ##": CACHE_VERSION,
                           "settings": _settings_payload(settings)}, f,
                          indent=2)
        except OSError as e:
            Log.warn("StageCache[%s]: write failed (%s)", stage, e)
            return False
        # a recomputed-and-written stage means its children's caches are
        # STALE: they must refuse to load (reference: cachingSuccess is set
        # only by loadCache, never by writeCache — Cacheable.hpp:46)
        self._loaded_ok[stage] = False
        Log.info("StageCache[%s]: wrote %s", stage, base + "_payload.sph4")
        return True
