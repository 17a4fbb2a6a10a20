"""dcomlint for the port: the reference's static analyzer
(``repro.lint``) over ``repro_torch``.

======  ===================================  ============================
 id      name                                 invariant
======  ===================================  ============================
 D1      builtin-hash-or-id                   no ``hash()``/``id()`` into
                                              persisted keys, seeds, paths
 D2      wall-clock-interval                  ``perf_counter`` for
                                              intervals
 D3      non-atomic-write                     tmp + ``os.replace`` for
                                              every write
 F1      family-table-complete                family dispatch only via the
                                              ModelFns / ServingFamily
                                              registries
 J2      host-sync-hot-path                   no device sync in serving
 O1      obs-token-neutral                    obs imports no torch; no obs
                                              call in a captured body
 K1      kernel-launch-checked-and-counted    every ctypes launch checks
                                              its error and is counted
======  ===================================  ============================

The reference's J1 (donated-buffer reuse) and S1 (``shard_map`` specs)
have no counterpart: torch has neither donation nor ``shard_map``.  K1
stands in for P1 (Pallas launch sites).

Usage::

    python -m repro_torch.lint src/repro_torch chip_smoke.py \\
        [--json out.json] [--select IDS] [--list-rules]

Exit codes: 0 clean, 1 findings, 2 usage error.  Suppress one line with
``# dcomlint: disable=D2`` (with the reason beside it) or a whole file
with ``# dcomlint: disable-file=RULE``.
"""
from __future__ import annotations

from .core import (REGISTRY, SCHEMA, Finding, ModuleCtx, Rule, all_rules,
                   check_file, dump_report, iter_py_files,
                   parse_suppressions, register, render_human, report_json,
                   run_paths)
# importing the rule modules fills the registry
from . import rules_determinism  # noqa: F401
from . import rules_family       # noqa: F401
from . import rules_obs          # noqa: F401
from . import rules_torch        # noqa: F401

__all__ = [
    "REGISTRY", "SCHEMA", "Finding", "ModuleCtx", "Rule", "all_rules",
    "check_file", "dump_report", "iter_py_files", "parse_suppressions",
    "register", "render_human", "report_json", "run_paths",
]
