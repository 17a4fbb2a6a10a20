"""Backend registry of the decomposition pipeline.

Counterpart of ``repro.engine.backends``.  A backend decides HOW the
engine's kernels run; it is selected ONCE per engine
(``EngineConfig.backend``, resolved by ``DecomposeEngine``):

* ``cuda``      — every kernel wrapper dispatches on its tensors' device:
                  the hand-written CUDA kernel on the card, its plain
                  version on the host;
* ``reference`` — the plain PyTorch versions of every kernel on any
                  device (the route check, and the numerical oracle).

``EngineConfig(backend="auto")`` resolves through
``repro_torch.tune.resolve_backend`` (a measured per-machine winner from
``tune_backend``, else ``cuda`` on a card and ``reference`` on the
host).  Kernel sets are lru-cached in ``kernels.ops``, so a backend's
``make_kernels(f)`` returns the same functions every time.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class Backend:
    """One way of running the engine's kernels."""
    name: str
    make_kernels: Callable[[int], ops.KernelSet]     # expansion -> kernels


_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown decompose backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


for _name in ops.BACKENDS:
    register_backend(Backend(
        _name, lambda f, _n=_name: ops.make_kernels(_n, f)))
del _name
