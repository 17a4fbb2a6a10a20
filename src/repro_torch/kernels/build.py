"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/<name>-<digest>.so csrc/<name>.cu

into ``build/`` beside this module (git-ignored), one ``nvcc`` per source,
all started together.  The sources have a plain C interface (no PyTorch
headers), so a build takes seconds; the result is loaded with ``ctypes``.
The file name carries a digest of the source and flags, so a stale
library is never loaded and an unchanged one is not rebuilt.  Only the
sources in the repository are compiled; nothing is fetched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use (B)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    the toolkit's default prefix."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch build from source at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source that has no current library, in parallel.
    Returns {kernel source stem: library path}.  Raises with the
    compiler's output when a build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, *extra, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {s.name}:\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {s.name}]\n{log}", flush=True)
        os.replace(tmp, out[s.stem])        # atomic: never a half library
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built at first
    use together with every other source)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(str(paths[name]))
            _LIBS[name] = lib
        return lib
