"""The benchmark's CPU tests import the port from ``src/`` of this
checkout (as ``run.py`` does)."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
