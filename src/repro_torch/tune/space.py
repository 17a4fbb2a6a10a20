"""Declarative tunable spaces of the port's expansion kernels.

Counterpart of ``repro.tune.space``.  Every kernel that exposes an
operating point (the expansion factor ``f``, block sizes, backend choice)
REGISTERS its space here, next to its own definition (bottom of each
``repro_torch.kernels`` module), so the tuner never hard-codes knowledge
about a kernel.

A :class:`TunableSpace` is pure data: parameter names, choice grids and
the defaults.  Enumeration order is deterministic (``itertools.product``
over the declared order), which the tuner relies on for reproducible
tie-breaking.

This module is a leaf: no torch, no kernel imports — kernel modules
import IT at definition time without cycles.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Tuple


@dataclasses.dataclass(frozen=True)
class TunableParam:
    """One axis of a kernel's operating point."""
    name: str
    choices: Tuple[Any, ...]
    default: Any

    def __post_init__(self):
        if self.default not in self.choices:
            raise ValueError(
                f"default {self.default!r} of param {self.name!r} is not "
                f"among its choices {self.choices!r}")


@dataclasses.dataclass(frozen=True)
class TunableSpace:
    """The candidate grid of one kernel, declared where the kernel lives."""
    kernel: str
    params: Tuple[TunableParam, ...]

    def default(self) -> Dict[str, Any]:
        return {p.name: p.default for p in self.params}

    def candidates(self) -> Iterator[Dict[str, Any]]:
        names = [p.name for p in self.params]
        for combo in itertools.product(*(p.choices for p in self.params)):
            yield dict(zip(names, combo))

    def size(self) -> int:
        n = 1
        for p in self.params:
            n *= len(p.choices)
        return n

    def param(self, name: str) -> TunableParam:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"space {self.kernel!r} has no param {name!r}")


_REGISTRY: Dict[str, TunableSpace] = {}
_REVISIONS: Dict[str, int] = {}


def register_space(space: TunableSpace, revision: int = 0) -> TunableSpace:
    """Register ``space``.  ``revision`` counts changes of what a kernel's
    operating point means: the tuner reuses a cache entry only if it was
    made under the same revision."""
    _REGISTRY[space.kernel] = space
    _REVISIONS[space.kernel] = revision
    return space


def space_revision(kernel: str) -> int:
    get_space(kernel)
    return _REVISIONS[kernel]


def get_space(kernel: str) -> TunableSpace:
    # Kernel modules register on import; make sure they ran.
    if kernel not in _REGISTRY:
        _import_kernel_spaces()
    try:
        return _REGISTRY[kernel]
    except KeyError:
        raise KeyError(f"no tunable space registered for kernel "
                       f"{kernel!r}; registered: {sorted(_REGISTRY)}") \
            from None


def available_spaces() -> List[str]:
    _import_kernel_spaces()
    return sorted(_REGISTRY)


def _import_kernel_spaces() -> None:
    """Trigger the side-effect registrations in ``repro_torch.kernels``
    (lazy, to keep this module a leaf)."""
    from ..kernels import (dkv_attention, lanczos_reorth,  # noqa: F401
                           lowrank_matmul, matvec_expand)


# The f grid every expansion kernel shares: powers of two spanning both
# sides of the Fig. 12 U-curve (the matvec spaces extend it to 128).
EXPANSION_GRID = (1, 2, 4, 8, 16, 32)
BLOCK_GRID = (128, 256, 512)

# Fused serving decode: steps per launch.  Not a kernel — the serving
# loop registers here directly, as in the JAX package.  1 is one dispatch
# per token; long blocks amortize the host's dispatch but overshoot the
# fold and budget horizons (the engine then caps each block).
DECODE_BLOCK_GRID = (1, 2, 4, 8, 16, 32)
register_space(TunableSpace("decode_block", (
    TunableParam("block", DECODE_BLOCK_GRID, 8),
)))
