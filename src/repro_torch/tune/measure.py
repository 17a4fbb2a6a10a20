"""Measurement harness: warmup, then the median of per-call device times.

Counterpart of ``repro.tune.measure``.  The cost model ranks candidates;
this module times them on the real kernels with deterministic synthetic
inputs, through the same wrappers the engine calls.

* On a CUDA device each call is bracketed by CUDA events, after a short
  device-side delay (or the L2 flush) that keeps the card busy while the
  host enqueues the call, so the host's launch overhead is not timed as
  device time.  ``flush_l2`` overwrites a 256 MiB buffer before each
  timed call, so the operand is read from device memory, not the 50 MB
  L2, as on the main path.
* On the host (``device="cpu"``: the plain versions) it is a wall clock.
  A host time is a CPU measurement, never a device metric; the tuner
  keys it under the ``torch-cpu`` device kind.

The harness raises without a card unless ``device="cpu"`` is asked for.
Inputs are seeded numpy draws (``RandomState(0)`` for A, ``RandomState(1)``
for the vector); shapes past 2^20 elements repeat the first 2^20 draws on
the device (a matvec's time does not depend on its values), so even the
2 GiB Fig. 12 operand is made in milliseconds, anew for each candidate.
Kernel imports are lazy: kernel modules import ``tune.space`` at
definition time.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..platform import capture_stream, resolve_device, torch_dtype

DRAWS = 1 << 20                 # numpy draws per input; the rest repeats
FLUSH_BYTES = 256 * 2 ** 20     # > 5 × the H100's 50 MB L2
HIDE_CYCLES = 200_000           # ~0.1 ms of device delay before a call


def timeit(fn: Callable[[], Any], *, warmup: int = 2, reps: int = 5,
           device: Any = "cuda", flush_l2: bool = False) -> float:
    """Median seconds per call of ``fn`` after ``warmup`` calls — the true
    median (the two middle samples averaged for even ``reps``)."""
    dev = resolve_device(device)
    for _ in range(max(1, warmup)):
        fn()
    ts = []
    if dev.type == "cuda":
        flush = torch.empty(FLUSH_BYTES // 4, device=dev) if flush_l2 \
            else None
        torch.cuda.synchronize(dev)
        for _ in range(max(1, reps)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if flush is not None:
                flush.zero_()
            else:
                torch.cuda._sleep(HIDE_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    k = len(ts)
    return (ts[k // 2] + ts[(k - 1) // 2]) / 2.0


def _rand(seed: int, shape: Sequence[int], dtype: Any,
          device: torch.device) -> torch.Tensor:
    n = int(np.prod(shape))
    base = np.random.RandomState(seed).standard_normal(
        min(n, DRAWS)).astype(np.float32)
    t = torch.from_numpy(base).to(device)
    if n > DRAWS:
        t = t.repeat(-(-n // DRAWS))[:n]
    dt = torch_dtype(str(dtype).replace("torch.", ""))
    return t.reshape(tuple(shape)).to(dt).contiguous()


def _bench_lanczos_reorth(shape, dtype, cand, device) -> Callable[[], Any]:
    """One fused right re-orth step over A [B, S, H] against a k-column
    zero basis (k from a 4th dim, else 16) at the candidate's blocks
    along H, or the plain step under ``backend="reference"``.  The engine
    hands the kernel float32 A whatever the activation's dtype, so A is
    float32 here too."""
    from ..kernels import ops
    b, s, h, k = shape if len(shape) == 4 else (*shape, 16)
    a = _rand(0, (b, s, h), "float32", device)
    u = _rand(1, (b, s), "float32", device)
    vbuf = torch.zeros(b, h, k, device=device)
    hooks = ops.make_batched_hooks(int(cand["expansion"]),
                                   cand.get("backend", "cuda"))
    return lambda: hooks.right_step(a, u, vbuf)


def _bench_expand(name: str, block_key: str):
    def build(shape, dtype, cand, device) -> Callable[[], Any]:
        from ..kernels import matvec_expand as mv
        f, blk = int(cand["expansion"]), int(cand.get(block_key, 512))
        n_vec = shape[-1] if name == "matvec" else shape[-2]
        a = _rand(0, shape, dtype, device)
        x = _rand(1, (*shape[:-2], n_vec), dtype, device)
        fn = getattr(mv, name if len(shape) == 2 else f"{name}_batched")
        return lambda: fn(a, x, expansion=f, **{block_key: blk})
    return build


def _bench_lowrank_matmul(shape, dtype, cand, device) -> Callable[[], Any]:
    """One Eq. 6 GEMM Vᵀ [k, H] @ W [H, N] (shape (k, h, n), the
    reference's) at the candidate's (expansion, n_block)."""
    from ..kernels.lowrank_matmul import lowrank_matmul
    k, h, n = shape
    vt = _rand(0, (k, h), dtype, device)
    w = _rand(1, (h, n), dtype, device)
    f, nb = int(cand["expansion"]), int(cand.get("n_block", 512))
    return lambda: lowrank_matmul(vt, w, expansion=f, n_block=nb)


def _bench_dkv_attention(shape, dtype, cand, device) -> Callable[[], Any]:
    """One launch of the slab dkv statistics at the candidate's
    expansion: shape (g, t, r), the reference's one (batch, kv-head)
    slice, or (b, g, t, r), every slot at once as the port's kernel
    takes them; float32 inner, U in ``dtype``, t_valid = t."""
    from ..kernels.dkv_attention import dkv_attention_stats
    b, g, t, r = shape if len(shape) == 4 else (1, *shape)
    inner = _rand(0, (b, g, r), "float32", device)
    k_u = _rand(1, (b, t, r), dtype, device)
    v_u = _rand(2, (b, t, r), dtype, device)
    tv = torch.full((b,), t, dtype=torch.int32, device=device)
    f = int(cand["expansion"])
    return lambda: dkv_attention_stats(inner, k_u, v_u, tv, expansion=f)


DECODE_TOKENS = 32              # tokens one decode_block measurement runs


def _bench_decode_block(shape, dtype, cand, device) -> Callable[[], Any]:
    """Serving decode proxy, the same for every candidate: 32 tokens of
    a step that streams a [b, t, w] K/V working set (scores, softmax,
    weighted sum), cut into ceil(32 / k) blocks of k steps, each block
    read back like the engine's per-block sync.  On the card each block
    is the replay of one captured CUDA graph of k steps (captured here,
    after a warm-up, outside the timed calls); on the host it runs
    eagerly."""
    b, t, w = shape
    k = int(cand["block"])
    launches = -(-DECODE_TOKENS // k)
    kv = _rand(0, (b, t, w), dtype, device)
    q = _rand(1, (b, w), "float32", device)

    def block():
        x = q
        for _ in range(k):
            p = torch.softmax(torch.einsum("bw,btw->bt", x, kv.float()), -1)
            x = torch.einsum("bt,btw->bw", p, kv.float())
        return x

    if device.type == "cuda":
        side = capture_stream(device.index if device.index is not None
                              else torch.cuda.current_device())
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            block()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = block()

        def run():
            for _ in range(launches):
                graph.replay()
                out[0, 0].item()
        return run

    def run():
        for _ in range(launches):
            block()[0, 0].item()
    return run


_BENCH = {
    "decode_block": _bench_decode_block,
    "dkv_attention": _bench_dkv_attention,
    "lanczos_reorth": _bench_lanczos_reorth,
    "lowrank_matmul": _bench_lowrank_matmul,
    "matvec_expand": _bench_expand("matvec", "row_block"),
    "rmatvec_expand": _bench_expand("rmatvec", "col_block"),
}


def measure_candidate(kernel: str, shape: Sequence[int], dtype: Any,
                      cand: Mapping[str, Any], *, warmup: int = 2,
                      reps: int = 5, device: Any = "cuda",
                      flush_l2: bool = False) -> float:
    """Median seconds per launch of ``kernel`` at operating point ``cand``
    on deterministic synthetic inputs of ``shape``/``dtype``: ``warmup +
    reps`` calls of the kernel's wrapper."""
    try:
        builder = _BENCH[kernel]
    except KeyError:
        raise KeyError(f"no measurement harness for kernel {kernel!r}; "
                       f"known: {sorted(_BENCH)}") from None
    dev = resolve_device(device)
    fn = builder(tuple(int(d) for d in shape), dtype, dict(cand), dev)
    return timeit(fn, warmup=warmup, reps=reps, device=dev,
                  flush_l2=flush_l2)
