"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` (with the shared ``csrc/*.cuh`` headers) compiles on
its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/<name>-<digest>.so csrc/<name>.cu

into ``build/`` beside this module (git-ignored), one ``nvcc`` per source,
all started together.  The sources have a plain C interface (no PyTorch
headers), so a build takes seconds; the result is loaded with ``ctypes``.
The file name carries a digest of the source, headers and flags, so a stale
library is never loaded and an unchanged one is not rebuilt.  Only the
sources in the repository are compiled; nothing is fetched.

Each build is counted in the compile watch
(``obs.record_compile("nvcc", …)``: the sources built, and the wall
seconds of the whole parallel build) under the caller's phase.

:func:`tickets` hands out the counters of the kernels whose last CTA to
arrive combines the partials of a launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..obs import record_compile

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use (B)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_TICKETS: Dict[Tuple[object, str, int], "torch.Tensor"] = {}


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
    """The library of ``src``, named by a digest of the source, the shared
    headers of ``csrc/`` and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(FLAGS).encode())
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
    t0 = time.perf_counter()
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
    if len(todo) > len(errors):
        record_compile("nvcc", time.perf_counter() - t0,
                       n=len(todo) - len(errors))
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


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ticket_buffers() -> list:
    """Every ticket buffer handed out so far (a captured CUDA graph keeps
    them alive: :func:`tickets` may replace a buffer with a larger one,
    and the graph still writes the old one)."""
    return list(_TICKETS.values())


def tickets(device, n: int, owner: str):
    """At least ``n`` zeroed int32 ticket counters on ``device`` for the
    kernels of ``owner``, launched on the current stream.  A kernel
    resets each counter it uses before its launch ends, so launches that
    share a buffer must run one after another: one buffer per (device,
    owner, stream), so that launches on two streams — an async prefill
    on the prefill stream, decode on the current stream — never share
    counters (the serving engine checks this where it takes the prefill
    stream)."""
    import torch
    key = (device, owner, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t
