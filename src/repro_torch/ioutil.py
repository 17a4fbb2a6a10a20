"""Atomic file writes: the one way the port persists an artifact.

Counterpart of ``repro.ioutil``.  Every durable file the port writes
(the tuning cache, threshold tables, the Fig. 12 report, metrics and
trace exports) is staged in a temporary file in the destination's
directory (same file system, so the rename is atomic) and moved over the
final path with ``os.replace``.  A crash mid-write leaves the previous
file or the new one, never a truncated JSON; a failed write removes its
temporary file and raises.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp file + ``os.replace``)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".atomic-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, **dump_kw: Any) -> None:
    """``json.dumps(obj, **dump_kw)`` to ``path`` atomically.  The text is
    made before the file is opened, so an unserializable ``obj`` leaves
    nothing behind."""
    atomic_write_text(path, json.dumps(obj, **dump_kw))
