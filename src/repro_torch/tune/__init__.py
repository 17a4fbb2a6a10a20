"""``repro_torch.tune`` — cost-model-guided autotuner of the port's
compute-expansion kernels (counterpart of ``repro.tune``).

* ``space``      — declarative tunable spaces, registered next to each
                   kernel in ``repro_torch.kernels``;
* ``cost_model`` — the H100 (and host) cost model of the U-curve:
                   max(non-increasing memory side, non-decreasing
                   compute side), unimodal in f;
* ``measure``    — warmup + median of per-call CUDA-event times;
* ``cache``      — persistent JSON keyed device kind × kernel ×
                   shape bucket × dtype (the JAX package's format);
* ``tuner``      — orchestration; ``tuned_expansion``, which answers
                   ``EngineConfig(expansion="auto")``, and
                   ``resolve_backend``/``tune_backend``, which answer
                   ``EngineConfig(backend="auto")``.
"""
from .cache import (TuningCache, default_cache, default_path, entry_key,
                    shape_bucket)
from .cost_model import (CPU, H100, DeviceModel, detect_device, device_kind,
                         predict, predict_curve)
from .measure import measure_candidate, timeit
from .space import (BLOCK_GRID, DECODE_BLOCK_GRID, EXPANSION_GRID,
                    TunableParam, TunableSpace, available_spaces, get_space,
                    register_space, space_revision)
from .tuner import (DEFAULT_PRUNE, TuneResult, candidates_for, pretune,
                    reset_stats, resolve_backend, stats, tune, tune_backend,
                    tuned_decode_block, tuned_expansion)

__all__ = [
    "BLOCK_GRID", "CPU", "DECODE_BLOCK_GRID", "DEFAULT_PRUNE",
    "DeviceModel", "EXPANSION_GRID", "H100", "TunableParam", "TunableSpace", "TuneResult", "TuningCache",
    "available_spaces", "candidates_for", "default_cache", "default_path",
    "detect_device", "device_kind", "entry_key", "get_space",
    "measure_candidate", "predict", "predict_curve", "pretune",
    "register_space", "reset_stats", "resolve_backend", "shape_bucket",
    "space_revision", "stats", "timeit", "tune", "tune_backend",
    "tuned_decode_block", "tuned_expansion",
]
