"""Atomic, versioned checkpoints of the training state.

Counterpart of ``repro.checkpoint`` with its on-disk format, so either
package restores the other's checkpoints: ``<dir>/step_N/`` holds one
``.npy`` per leaf (the leaf's name, key paths over SORTED dict keys
joined with ``/``, with ``/`` written ``__`` in the file name) and
``manifest.json`` (``step``, ``leaves``: name → file, shape, dtype name;
``num_leaves``).  bf16 leaves are stored as their uint16 bits under the
dtype name ``"bfloat16"`` — through ``tensor.view(torch.int16)`` both
ways, with no ``ml_dtypes`` (the GPU machine has none).

* Atomic: a save writes into a staging directory of its own
  (``mkdtemp``) and renames it to ``step_N``; a crash mid-save never
  leaves a partial ``step_N``, and of two writers of one step the first
  rename wins.
* ``AsyncCheckpointer`` copies the tree to host memory, then writes it
  on one background thread.  The copy is a real copy (``.cpu()`` of a
  CPU tensor, or ``.numpy()``, would share memory with the parameter,
  and the port's optimizer updates parameters in place).
* ``gc_old`` keeps the newest ``keep`` steps and sweeps staging
  directories abandoned by dead writers.
* Elastic restore: ``restore(..., mesh=, placements=)`` returns DTensors
  laid out on the CURRENT mesh (``distribute_tensor`` of each host leaf,
  every rank keeping its own shard of the copy it read, no collective),
  so a checkpoint saved on one mesh, or on none, restores onto any
  other, value for value (``runtime.driver.restore_for_mesh``).  A save
  of DTensor leaves writes each leaf's full tensor (``full_tensor()``,
  a collective: every rank saves, and the first rename wins).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .tree import named_leaves, tree_map, unflatten_like

Tree = Any

_MANIFEST = "manifest.json"
_STAGING_PREFIX = ".staging.tmp-"
# a staging dir untouched this long belongs to a dead writer, not a slow one
_STAGING_STALE_S = 3600.0

_TO_NAME = {torch.float32: "float32", torch.float64: "float64",
            torch.float16: "float16", torch.bfloat16: "bfloat16",
            torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
            torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_FROM_NAME = {v: k for k, v in _TO_NAME.items()}


def _to_savable(t: torch.Tensor):
    """(numpy array, dtype name) of a host tensor; bf16 as its uint16
    bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _TO_NAME[t.dtype]


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The tensor of a saved array (bf16 from its uint16 bits)."""
    arr = np.require(arr, requirements="C")      # keeps a 0-d shape
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype_name not in _FROM_NAME:
        raise ValueError(f"checkpoint dtype {dtype_name!r} is not supported "
                         f"by the port")
    return torch.from_numpy(arr)


def whole(t):
    """A DTensor's full tensor (an all-gather); any other tensor as it
    is."""
    full = getattr(t, "full_tensor", None)
    return full() if full is not None else t


def host_copy(tree: Tree) -> Tree:
    """A host copy of every tensor of ``tree``, sharing no memory with
    it."""
    return tree_map(lambda t: whole(t).detach().to("cpu", copy=True),
                    tree)


def save(tree: Tree, directory: str, step: int) -> str:
    """Synchronous atomic save of ``tree`` as ``directory/step_<step>``;
    returns that directory.  The staging directory is unique to the
    writer, so an abandoned writer racing a new save of the same step
    never touches the other's files; the first rename wins (both hold
    the same deterministic state), the other staging directory is
    dropped."""
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=_STAGING_PREFIX)
    try:
        return _save_into(tree, tmp, final, step)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _save_into(tree: Tree, tmp: str, final: str, step: int) -> str:
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    n = 0
    for name, leaf in named_leaves(tree):
        t = whole(leaf).detach().cpu()
        arr, dtype_name = _to_savable(t.contiguous())
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "shape": list(t.shape),
                                    "dtype": dtype_name}
        n += 1
    manifest["num_leaves"] = n
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    try:
        os.rename(tmp, final)      # atomicity boundary
    except OSError:
        # final exists: only a completed rename makes one, so a concurrent
        # writer of the same step won with the same payload; keep it
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.isdir(final):
            raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(template: Tree, directory: str, step: Optional[int] = None,
            device=None, *, mesh=None, placements: Optional[Tree] = None
            ) -> Tree:
    """Restore into the structure of ``template`` (shapes checked; each
    leaf cast to the template's dtype).  A leaf lands on ``device``, or
    on its template leaf's device (the host for a ``meta`` template).
    With ``mesh`` and ``placements`` (a tree of DTensor placement tuples
    of ``template``'s structure, e.g. from
    ``distributed.sharding.placements``), each leaf is a DTensor on
    ``mesh`` instead."""
    if (mesh is None) != (placements is None):
        raise ValueError("restore: mesh and placements go together")
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    restored = []
    for name, leaf in named_leaves(template):
        meta = manifest["leaves"][name]
        t = _from_saved(np.load(os.path.join(d, meta["file"])),
                        meta["dtype"])
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"template {tuple(leaf.shape)}")
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        restored.append(t.to(device=dev, dtype=leaf.dtype))
    out = unflatten_like(template, restored)
    if mesh is None:
        return out
    return tree_map(lambda t, pl: _distribute(t, mesh, pl), out,
                    placements)


def _distribute(t: torch.Tensor, mesh, placements) -> Any:
    """``t`` (every rank's same host copy) as a DTensor on ``mesh``: each
    rank keeps its own shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.to(mesh.device_type), mesh, list(placements),
                             src_data_rank=None)


def gc_old(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` steps, and staging directories
    untouched for an hour (their writer is dead: a live writer touches
    its directory with every file)."""
    if not os.path.isdir(directory):
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(directory)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
    # wall-clock time on purpose: compared with file modification times,
    # which are wall-clock (perf_counter has no epoch to compare against)
    now = time.time()  # dcomlint: disable=D2
    for d in os.listdir(directory):
        if not d.startswith(_STAGING_PREFIX):
            continue
        p = os.path.join(directory, d)
        try:
            stale = now - os.path.getmtime(p) > _STAGING_STALE_S
        except OSError:
            continue                        # renamed or removed under us
        if stale:
            shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """One background writer: ``save`` copies the tree to host memory
    (waiting for the previous write first), then returns while a thread
    writes it and collects old steps.  ``bytes_written`` counts the bytes
    of every checkpoint it wrote."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.bytes_written = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Tree, step: int) -> None:
        self.wait()
        snapshot = host_copy(tree)

        def work():
            try:
                save(snapshot, self.directory, step)
                self.bytes_written += tree_bytes(snapshot)
                gc_old(self.directory, self.keep)
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def tree_bytes(tree: Tree) -> int:
    """Bytes of the leaves' data, as a save writes them."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))
