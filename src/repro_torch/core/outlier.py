"""Channel-wise outlier extraction (paper §4, "multi-track decomposition").

Counterpart of ``repro.core.outlier``.  SVD minimizes squared error and
is hypersensitive to the few large activation entries, which live in a
small set of channels (columns of the [S, H] map); those channels are
extracted before decomposition and ride along as a dense track.

The per-channel statistics (count of |x| > T, max |x|) go through the
``outlier_stats`` kernel (``kernels.outlier_extract``): CUDA on the card,
its plain version on the host or under the engine's ``"reference"``
backend (the ``stats`` argument).  The top-C selection and the
gather/scatter touch only C ≈ 0.03·H channels and stay plain PyTorch.

Thresholds are calibrated offline per layer (:func:`calibrate_threshold`,
:class:`ThresholdTable`, whose JSON file either package reads).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.outlier_extract import outlier_stats
from .lowrank import LowRank, gather_channels, zero_channels

Stats = Callable[[torch.Tensor, float], Tuple[torch.Tensor, torch.Tensor]]


def channel_outlier_counts(x: torch.Tensor, threshold: float,
                           stats: Optional[Stats] = None) -> torch.Tensor:
    """Per-channel count of |x| > T over the token rows: [..., H] int32."""
    counts, _ = (stats or outlier_stats)(x, threshold)
    return counts.to(torch.int32)


def select_outlier_channels(x: torch.Tensor, threshold: float,
                            num_channels: int,
                            stats: Optional[Stats] = None) -> torch.Tensor:
    """Top-``num_channels`` channel indices by outlier count (ties broken
    by channel max |x|).  Returns sorted int64 indices [..., C].

    The score is the reference's, in float32 and in its order:
    ``counts + maxabs / (1 + max(maxabs))``, then top-k, then sort (tie
    order inside top-k may differ between frameworks; after the sort
    only the set matters)."""
    counts, maxabs = (stats or outlier_stats)(x, threshold)
    counts, maxabs = counts.float(), maxabs.float()
    score = counts + maxabs / (1.0 + maxabs.amax(-1, keepdim=True))
    _, idx = torch.topk(score, num_channels, dim=-1)
    return torch.sort(idx, dim=-1).values


def split_outliers(x: torch.Tensor, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x with the outlier channels zeroed, dense values [..., S, C])."""
    return zero_channels(x, idx), gather_channels(x, idx)


def extract(x: torch.Tensor, threshold: float, num_channels: int,
            stats: Optional[Stats] = None):
    """One-shot extraction: (x_base, outlier_vals, channel_idx)."""
    idx = select_outlier_channels(x, threshold, num_channels, stats)
    base, vals = split_outliers(x, idx)
    return base, vals, idx


def attach_dense_outliers(lr: LowRank, vals: torch.Tensor,
                          idx: torch.Tensor) -> LowRank:
    return LowRank(lr.u, lr.core, lr.vt, o_idx=idx, o_dense=vals)


# ---------------------------------------------------------------------------
# Offline calibration
# ---------------------------------------------------------------------------

def calibrate_threshold(samples: np.ndarray, target_channel_frac: float,
                        element_quantile: float = 0.999) -> float:
    """Pick T so that ≈ ``target_channel_frac`` of channels trip the
    detector: T is the (1 − frac) quantile of the channels' high
    |x| quantiles (the paper's offline statistical analysis)."""
    a = np.abs(np.asarray(samples, dtype=np.float32))
    a = a.reshape(-1, a.shape[-1])                      # [N·S, H]
    per_channel_tail = np.quantile(a, element_quantile, axis=0)   # [H]
    return float(np.quantile(per_channel_tail, 1.0 - target_channel_frac))


@dataclasses.dataclass
class ThresholdTable:
    """Per-layer outlier thresholds, built offline, consulted at runtime."""

    thresholds: Dict[int, float] = dataclasses.field(default_factory=dict)
    default: float = 6.0    # ~"6 sigma" style default for unit-scale acts

    def get(self, layer: int) -> float:
        return self.thresholds.get(int(layer), self.default)

    def set(self, layer: int, value: float) -> None:
        self.thresholds[int(layer)] = float(value)

    def calibrate_layer(self, layer: int, samples: np.ndarray,
                        target_channel_frac: float) -> float:
        t = calibrate_threshold(samples, target_channel_frac)
        self.set(layer, t)
        return t

    def save(self, path: str) -> None:
        """Atomic write (tmp file + ``os.replace``): a crash mid-write
        leaves the previous table or the new one, never a truncated
        JSON."""
        payload = {"default": self.default,
                   "thresholds": {str(k): v
                                  for k, v in self.thresholds.items()}}
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".thresholds-",
                                   suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str) -> "ThresholdTable":
        """Load a saved table; an unreadable or corrupt file degrades to
        the built-in defaults with a warning, as in the reference."""
        try:
            with open(path) as f:
                d = json.load(f)
            return cls(thresholds={int(k): float(v)
                                   for k, v in d["thresholds"].items()},
                       default=float(d.get("default", 6.0)))
        except (OSError, ValueError, KeyError, TypeError) as e:
            warnings.warn(f"ThresholdTable.load({path!r}): unreadable or "
                          f"corrupt table ({e!r}); falling back to defaults",
                          RuntimeWarning, stacklevel=2)
            return cls()


def measured_extraction_frac(x: torch.Tensor, threshold: float,
                             num_channels: int,
                             stats: Optional[Stats] = None) -> torch.Tensor:
    """Fraction of the total squared energy the selected channels hold."""
    idx = select_outlier_channels(x, threshold, num_channels, stats)
    vals = gather_channels(x, idx).float()
    num = (vals * vals).sum()
    den = (x.float() ** 2).sum()
    return num / torch.clamp(den, min=1e-12)
