"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json`` (a model configuration
under a traffic mix) on the card it is started on:

    python3 dcom_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name the
manifest gives: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
``driver`` names a module of ``drivers/``), ``limits/<cell>.json`` and
``metrics/<metric>.py``.  The yardstick (traffic generation, the
arithmetic of peaks, operations and bytes, the trace reduction and the
plain float32 reference of ``reference/``) lives here; from the port the
benchmark takes only the system under test and its counters.  Nothing
here imports ``jax``, ``jaxlib`` or the JAX package ``repro``.
"""
