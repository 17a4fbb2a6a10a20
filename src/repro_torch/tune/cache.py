"""Persistent tuning cache: pay the measurement cost once per machine.

Counterpart of ``repro.tune.cache``, with the same file format (schema
1), so the two packages may share one file: their keys never collide,
because the port's device kinds carry their own prefix (``torch-cuda:
<card name>``, ``torch-cpu``; the JAX package writes ``cpu:cpu``,
``tpu:...``).  One JSON file maps ``device_kind × kernel × shape-bucket ×
dtype`` to the winning operating point plus the sweep that chose it.
Shape buckets round every dimension up to a power of two, so an engine
whose prompt lengths wander within a bucket reuses one entry.

* **in-process**: entries live in a plain dict after first read; the
  tuner's ``tuned_expansion`` adds an ``lru_cache`` on top, so the
  engine's per-decompose resolution is a hash lookup;
* **on disk**: ``REPRO_TUNE_CACHE`` (env) or ``~/.cache/repro-tune/
  cache.json``.  Writes are atomic (``ioutil``) and merge on save, so
  concurrent processes at worst re-measure, never corrupt.  A missing or
  unreadable file is an empty cache, never an error.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

from ..ioutil import atomic_write_json

_SCHEMA = 1


def default_path() -> str:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-tune",
                        "cache.json")


def shape_bucket(shape: Sequence[int]) -> tuple:
    """Round every dim up to a power of two (1 stays 1)."""
    return tuple(1 << max(0, int(n) - 1).bit_length() for n in shape)


def entry_key(device_kind: str, kernel: str, shape: Sequence[int],
              dtype: Any) -> str:
    bucket = "x".join(str(n) for n in shape_bucket(shape))
    return f"{device_kind}/{kernel}/{bucket}/{dtype}"


class TuningCache:
    """Dict-like view over one cache file (lazy load, atomic save)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_path()
        self._entries: Optional[Dict[str, Dict[str, Any]]] = None

    # -- persistence -------------------------------------------------------
    def _load(self) -> Dict[str, Dict[str, Any]]:
        if self._entries is None:
            self._entries = self._read_file()
        return self._entries

    def _read_file(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(self.path) as fh:
                data = json.load(fh)
            if data.get("schema") != _SCHEMA:
                return {}
            entries = data.get("entries", {})
            return entries if isinstance(entries, dict) else {}
        except (OSError, ValueError, AttributeError):
            return {}

    def save(self) -> None:
        """Atomic merge-save: re-read the file and overlay our entries, so
        two processes tuning different kernels both land."""
        entries = dict(self._read_file())
        entries.update(self._load())
        atomic_write_json(self.path, {"schema": _SCHEMA, "entries": entries},
                          indent=1, sort_keys=True)

    # -- dict-ish API ------------------------------------------------------
    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self._load().get(key)

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        self._load()[key] = entry

    def __len__(self) -> int:
        return len(self._load())

    def keys(self):
        return self._load().keys()

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._load())


_DEFAULT: Optional[TuningCache] = None


def default_cache() -> TuningCache:
    """Process-wide cache instance bound to :func:`default_path`
    (re-resolved when the path changes, as tests point
    ``REPRO_TUNE_CACHE`` at a temporary file)."""
    global _DEFAULT
    path = default_path()
    if _DEFAULT is None or _DEFAULT.path != path:
        _DEFAULT = TuningCache(path)
    return _DEFAULT
