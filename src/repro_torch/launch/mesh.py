"""Process group and device-mesh construction (counterpart of
``repro.launch.mesh``).

The port runs SPMD: one process per device, as ``torchrun`` launches
them, each holding its own shard of every sharded tensor.
:func:`init_distributed` starts the default process group once per
process:

* under ``torchrun`` (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` in the
  environment) from that environment (``env://``);
* given ``rank``, ``world_size`` and ``store_path``, through a
  ``FileStore`` at that path (the CPU tests' worlds);
* otherwise as a world of one, through a ``FileStore`` in a temporary
  directory: no network and no port.

The backend is NCCL for ``device="cuda"`` and gloo for ``"cpu"``; on the
card each rank binds its own GPU (``torch.cuda.set_device(LOCAL_RANK)``)
first, so ``"cuda"`` resolves to it (``platform.resolve_device``).  As
every entry point of the port, ``device="cuda"`` raises without a GPU.

:func:`make_host_mesh` builds the ``("data", "model")`` mesh over the
world, :func:`make_pod_mesh` the ``("pod", "data", "model")`` one, and
:func:`parse_mesh` is the serve CLI's ``--mesh``: ``"none"``/``""``/None
(no mesh), ``"host"`` (every rank on "data") or ``"DxM"``.  A shape
whose product is not the world size raises.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..platform import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device="cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     store_path: Optional[str] = None) -> int:
    """Start the default process group (a no-op when it is up); returns
    the world size."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if rank is None and "RANK" in env and "WORLD_SIZE" in env:
        local = int(env.get("LOCAL_RANK", env["RANK"]))
        if dev.type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(_backend(dev), init_method="env://")
        return dist.get_world_size()
    if rank is None:
        rank, world_size = 0, 1
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        store_path = os.path.join(tmp, "store")
    if store_path is None or world_size is None:
        raise ValueError("init_distributed: rank needs world_size and "
                         "store_path")
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(_backend(dev),
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)
    return world_size


def shutdown_distributed() -> None:
    """Destroy the default process group (and with it every group and
    communicator of the process), if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    world = init_distributed(dev)
    n = 1
    for d in shape:
        n *= d
    if n != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks but the "
            f"world has {world}; launch with torchrun --nproc-per-node {n}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """The ``(data, model)`` mesh over every rank of the world (starting
    a world of one when no group is up)."""
    return _mesh(device, (data, model), ("data", "model"))


def make_pod_mesh(pod: int, data: int, model: int = 1, device="cuda"):
    """The multi-pod ``(pod, data, model)`` mesh; DP runs over
    ("pod", "data")."""
    return _mesh(device, (pod, data, model), ("pod", "data", "model"))


def parse_mesh(spec, device="cuda"):
    """The serve CLI's ``--mesh`` → a DeviceMesh or None:

    * ``"none"``/``""``/``"off"``/None — no mesh (single-device serving);
    * ``"host"`` — every rank of the world on the "data" axis (DP
      serving; one process gives a 1x1 mesh);
    * ``"DxM"`` (e.g. ``4x1``) — an explicit (data, model) shape, whose
      product must be the world size.
    """
    if spec is None or spec in ("", "none", "off"):
        return None
    if spec == "host":
        return make_host_mesh(init_distributed(device), 1, device)
    try:
        data, model = (int(n) for n in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"--mesh must be 'none', 'host', or 'DxM' (got {spec!r})")
    return make_host_mesh(data, model, device)
