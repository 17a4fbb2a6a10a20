"""Per-layer decomposition policy (paper §6.2's configuration axes).

The port's own copy of ``repro.core.policy``: WHICH layers decompose, at
what RANK, with what OUTLIER fraction, input-only vs input+weight, and
whether outputs stay in preserved form.  ``to_json``/``from_json`` are
byte-compatible with the JAX package's, so a policy written by one
package is read by the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence

from .outlier import ThresholdTable


@dataclasses.dataclass(frozen=True)
class LayerPolicy:
    """Decomposition directive for one transformer layer."""
    decompose: bool = False
    rank: int = 10
    iters: Optional[int] = None          # Lanczos iterations (default: rank)
    outlier_frac: float = 0.03           # fraction of H channels extracted
    decompose_weights: bool = False      # input+weight mode (paper Table 3)
    weight_rank: int = 10
    preserve_output: bool = True         # paper §3.2 output-preserved compute
    expansion_factor: int = 8            # D-com kernel grid factor f

    @property
    def effective_iters(self) -> int:
        return self.rank if self.iters is None else self.iters


@dataclasses.dataclass
class DecompositionPolicy:
    """Whole-model policy: default + per-layer overrides + thresholds."""
    num_layers: int
    default: LayerPolicy = dataclasses.field(default_factory=LayerPolicy)
    overrides: Dict[int, LayerPolicy] = dataclasses.field(default_factory=dict)
    thresholds: ThresholdTable = dataclasses.field(
        default_factory=ThresholdTable)

    def layer(self, idx: int) -> LayerPolicy:
        return self.overrides.get(int(idx), self.default)

    def decomposed_layers(self) -> Sequence[int]:
        return [i for i in range(self.num_layers) if self.layer(i).decompose]

    # -- constructors matching the paper's experiment tables ---------------
    @classmethod
    def none(cls, num_layers: int) -> "DecompositionPolicy":
        return cls(num_layers=num_layers,
                   default=LayerPolicy(decompose=False))

    @classmethod
    def from_layer_list(cls, num_layers: int, layers: Sequence[int],
                        rank: int = 10, outlier_frac: float = 0.03,
                        decompose_weights: bool = False,
                        weight_rank: Optional[int] = None,
                        iters: Optional[int] = None,
                        expansion_factor: int = 8) -> "DecompositionPolicy":
        """Paper Table 2/3 row: e.g. layers=[10,15,20,25], rank=20."""
        on = LayerPolicy(decompose=True, rank=rank, iters=iters,
                         outlier_frac=outlier_frac,
                         decompose_weights=decompose_weights,
                         weight_rank=weight_rank or rank,
                         expansion_factor=expansion_factor)
        return cls(num_layers=num_layers,
                   default=LayerPolicy(decompose=False),
                   overrides={int(i): on for i in layers})

    @classmethod
    def all_layers(cls, num_layers: int, rank: int = 1,
                   outlier_frac: float = 0.065,
                   decompose_weights: bool = False) -> "DecompositionPolicy":
        """Paper's 'All Layers (Most aggressive)' row."""
        return cls(num_layers=num_layers,
                   default=LayerPolicy(decompose=True, rank=rank,
                                       outlier_frac=outlier_frac,
                                       decompose_weights=decompose_weights))

    def has_adjacent_decomposed(self) -> bool:
        """Adjacent decomposed layers hurt quality — flag them."""
        ls = sorted(self.decomposed_layers())
        return any(b - a == 1 for a, b in zip(ls, ls[1:]))

    # -- persistence --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "num_layers": self.num_layers,
            "default": dataclasses.asdict(self.default),
            "overrides": {str(k): dataclasses.asdict(v)
                          for k, v in self.overrides.items()},
            "thresholds": {"default": self.thresholds.default,
                           "table": {str(k): v for k, v in
                                     self.thresholds.thresholds.items()}},
        }, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DecompositionPolicy":
        d = json.loads(s)
        tt = ThresholdTable(
            thresholds={int(k): float(v)
                        for k, v in d["thresholds"]["table"].items()},
            default=float(d["thresholds"]["default"]))
        return cls(num_layers=int(d["num_layers"]),
                   default=LayerPolicy(**d["default"]),
                   overrides={int(k): LayerPolicy(**v)
                              for k, v in d["overrides"].items()},
                   thresholds=tt)


# The paper's Table 2 layer-choice configurations (Llama-2-7b, 32 layers).
PAPER_LAYER_CONFIGS = {
    "4layer": [10, 15, 20, 25],
    "6layer": [6, 10, 14, 18, 22, 26],
    "8layer": [7, 10, 13, 16, 19, 22, 25, 28],
    "10layer": [9, 10, 13, 14, 17, 18, 21, 22, 26, 27],
}
PAPER_BEST_CONFIG = ("10layer", 20)   # highlighted row: 0.78×, 70.15% acc
