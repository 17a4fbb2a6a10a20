"""Analytic cost model of the compute-expansion U-curve on the port's devices.

Counterpart of ``repro.tune.cost_model``, re-derived for the H100 (the
JAX package's v5e constants are a TPU's and are not carried over).  It
predicts the seconds of one launch of a kernel at a candidate operating
point, per (shape, dtype, device):

* **memory side** (left of f*): both expansion kernels stream their
  operand once and are bound by bytes.  On the TPU the grid runs in
  order on one core and f alone sets the blocks in flight; here CTAs run
  in parallel on 132 SMs, and what engages bandwidth is the number of
  bytes in flight: ``batch × ceil(S / row_block) × f`` CTAs for matvec
  (``batch × ceil(H / col_block) × f`` for rmatvec), each keeping the
  stages of its shared-memory ring but one in flight (at most its tile),
  counted in units of 2 KB ("warps"); for the re-orth kernel a cluster
  of min(f, 16) CTAs per batch element, each with a ring of its own.
  The streaming time is ``bytes / (bw · min(warps, sat) / sat)`` — the
  batched Fig. 12 shape (512 CTAs at f = 1) is already saturated, the
  scalar one (8 CTAs) is not.  NON-INCREASING in f.
* **compute side** (right of f*): the streaming floor at full bandwidth
  plus everything that grows with f — the float32 partials written and
  read back (``8·B·f·n`` bytes for f > 1), the fixed cost of each CTA
  spread over the SMs, the per-split cost of the plain version's split
  loop (CPU), and the re-orth kernel's cluster combine (each CTA reads
  the f blocks' partials twice).  NON-DECREASING in f.

``predict`` returns ``max(memory, compute)`` — the max of a
non-increasing and a non-decreasing function, hence UNIMODAL along the
expansion grid, which is the contract the tuner's pruning relies on.
The model is a pruner, not an oracle: the tuner measures the survivors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

from ..launch.roofline import HBM_BW, PEAK_FLOPS_F32

#: dtype name (with or without the ``torch.`` prefix) → bytes; others 4
DTYPE_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2}

#: the unit of bytes in flight ("a warp"; ``sat_warps`` counts in it):
#: 32 lanes x 16 B x 4 loads
MATVEC_WARP_FLIGHT = 2048
#: the ring of a matvec or rmatvec CTA (``kStages``, ``kStageBytes`` of
#: csrc/matvec_expand.cu): all stages but the one being summed are in
#: flight
RING_STAGES = 3
RING_STAGE_BYTES = 32 * 1024
RMATVEC_MAX_ROWS = 256             # a TMA box has at most 256 rows


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Roofline denominators and the fitted costs of one device."""
    name: str
    peak_flops: float      # FLOP/s of the kernels' float32 arithmetic
    hbm_bw: float          # bytes/s of device memory
    sms: int               # streaming multiprocessors (CPU: 1)
    sat_warps: int         # warps in flight at bandwidth saturation
    cta_s: float           # fixed seconds per CTA (prologue, tail, launch)
    split_s: float         # seconds per split of the plain version's loop
    #: host seconds a fused decode block saves per step it absorbs: one
    #: eager decode step against one replay of its captured graph
    host_dispatch_s: float = 0.0


#: Fitted constants of the H100 model: :func:`fit_h100` on chip_smoke.py
#: phase 9's sweeps of the one-launch matvec (NVIDIA H100 80GB HBM3 at
#: 700 W; PERF.md): 1716.3 warps, 1.06e-6 s.
H100_SAT_WARPS = 1716      # warps in flight at bandwidth saturation
H100_CTA_S = 1.06e-6       # per-CTA cost, spread over the SMs

#: Host dispatch a captured decode block saves per step: chip_smoke.py
#: phase 4's ``dispatch:`` line, one eager decode step of full llama2-7b
#: on the decomposed cache (4 slots) against one replay of the same step
#: as a CUDA graph (NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
H100_HOST_DISPATCH_S = 30.047e-3

#: NVIDIA H100 SXM (data sheet, ``launch.roofline``): 3.35 TB/s HBM3,
#: 67 TFLOP/s float32 on the CUDA cores (both kernels compute in
#: float32), 132 SMs.
H100 = DeviceModel("h100", peak_flops=PEAK_FLOPS_F32, hbm_bw=HBM_BW,
                   sms=132, sat_warps=H100_SAT_WARPS, cta_s=H100_CTA_S,
                   split_s=0.0, host_dispatch_s=H100_HOST_DISPATCH_S)

#: ``device="cpu"`` runs of the plain versions: f engages no parallel
#: units (the memory side is flat); each split of the plain matvec pair
#: is one more eager product, so the model prefers small f there.  The
#: host replays no graphs: a fused block dispatches every step it runs,
#: so it saves nothing (``host_dispatch_s`` 0).
CPU = DeviceModel("cpu", peak_flops=5e10, hbm_bw=2e10, sms=1, sat_warps=1,
                  cta_s=0.0, split_s=2e-5)


def detect_device(device: Any = "cuda") -> DeviceModel:
    """The model of ``device``: the H100 model for a CUDA device, the CPU
    model for the host."""
    import torch
    return CPU if torch.device(device).type == "cpu" else H100


def device_kind(device: Any = "cuda") -> str:
    """Stable cache-key string of ``device``, prefixed so it never
    collides with the JAX package's keys in a shared cache file
    (``torch-cuda:NVIDIA H100 80GB HBM3``, ``torch-cpu``).  Raises
    without a card unless the host is asked for."""
    from ..platform import device_name, resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "torch-cpu"
    return f"torch-cuda:{device_name(dev)}"


def dtype_bytes(dtype: Any) -> int:
    return DTYPE_BYTES.get(str(dtype).replace("torch.", ""), 4)


# ---------------------------------------------------------------------------
# Per-kernel terms: (bytes streamed, flops, warps in flight, extra bytes,
# CTAs, splits), each a function of the candidate.
# ---------------------------------------------------------------------------

Terms = Tuple[float, float, float, float, float, float]


def matvec_flight(b: int, s: int, h: int, dtb: int, f: int,
                  row_block: int) -> Tuple[int, int]:
    """(CTAs, bytes one CTA keeps in flight) of a matvec launch over A
    [b, S, H]: its ring's 32 KB stages but one, at most the CTA's whole
    [row_block × split] tile."""
    from ..kernels.matvec_expand import split_len
    rb = max(1, min(row_block, s))
    tile = rb * min(split_len(h, f), h) * dtb
    return (b * -(-s // rb) * f,
            min((RING_STAGES - 1) * RING_STAGE_BYTES, tile))


def _terms_matvec_expand(shape, dtb, cand) -> Terms:
    """y = A·v over A [S, H] or [B, S, H]; the H reduction split f ways,
    ``row_block`` rows per CTA, one launch (the last CTA of a row block
    adds the partials).  Its warps in flight are the CTAs' bytes in
    flight over :data:`MATVEC_WARP_FLIGHT`."""
    from ..kernels.matvec_expand import split_len
    b, s, h = (1, *shape) if len(shape) == 2 else shape
    f = int(cand["expansion"])
    ctas, flight = matvec_flight(b, s, h, dtb, f,
                                 int(cand.get("row_block", 512)))
    bytes_ = b * s * h * dtb + b * h * dtb + b * s * 4
    extra = 8.0 * b * f * s if f > 1 else 0.0
    return (bytes_, 2.0 * b * s * h, ctas * flight / MATVEC_WARP_FLIGHT,
            extra, ctas, -(-h // split_len(h, f)))


def rmatvec_flight(s: int, h: int, dtb: int, f: int, col_block: int
                   ) -> Tuple[int, int]:
    """(CTAs per batch element, bytes one CTA keeps in flight) of an
    rmatvec launch over A [S, H]: its ring's stages but one, each of
    ``32 KB // row`` rows (1 to 256) of ``col_block`` columns, at most
    the CTA's whole [split × col_block] tile."""
    from ..kernels.matvec_expand import split_len
    cb = max(1, min(col_block, h))
    row = cb * dtb
    stage = min(RMATVEC_MAX_ROWS,
                max(1, RING_STAGE_BYTES // row)) * row
    tile = min(split_len(s, f), s) * row
    return -(-h // cb) * f, min((RING_STAGES - 1) * stage, tile)


def _terms_rmatvec_expand(shape, dtb, cand) -> Terms:
    """z = Aᵀ·u over A [S, H] or [B, S, H]; the S reduction split f ways,
    ``col_block`` columns per CTA, one launch (the last CTA of a column
    block adds the partials).  Its warps in flight are the CTAs' bytes in
    flight over :data:`MATVEC_WARP_FLIGHT`."""
    from ..kernels.matvec_expand import split_len
    b, s, h = (1, *shape) if len(shape) == 2 else shape
    f = int(cand["expansion"])
    ctas, flight = rmatvec_flight(s, h, dtb, f,
                                  int(cand.get("col_block", 512)))
    bytes_ = b * s * h * dtb + b * s * dtb + b * h * 4
    extra = 8.0 * b * f * h if f > 1 else 0.0
    return (bytes_, 2.0 * b * s * h, b * ctas * flight / MATVEC_WARP_FLIGHT,
            extra, b * ctas, -(-s // split_len(s, f)))


def reorth_flight(b: int, s: int, h: int, k: int, f: int
                  ) -> Tuple[int, int, int]:
    """(CTAs, bytes one CTA keeps in flight, reads of Q) of a right re-orth
    launch over A [b, S, H] at f blocks along H: a cluster of min(f, 16)
    CTAs per batch element, each keeping two ring stages of 32 KB in
    flight (at most its share of A); Q is read once where each CTA's Q
    rows fit in its shared memory, else once per CGS2 sweep (3x)."""
    from ..kernels.lanczos_reorth import cluster_ctas, q_in_smem
    c = cluster_ctas(f)
    flight = min(2 * RING_STAGE_BYTES, -(-4 * s * h // c))
    return b * c, flight, 1 if q_in_smem("right", s, h, k, f) else 3


def _terms_lanczos_reorth(shape, dtb, cand) -> Terms:
    """One fused right re-orth step over A [B, S, H] (float32 in the
    kernel) against a k-column basis (k from a 4th dim, else 16), at f
    blocks along H (:func:`reorth_flight`).  The bytes count A and Q
    once; where Q is read three times the two extra reads slow the
    memory side (its warps in flight count the bytes of A and Q once of
    every byte moved).  The cluster combine reads f blocks' k partials
    in each CTA, twice."""
    b, s, h, k = shape if len(shape) == 4 else (*shape, 16)
    f = int(cand["expansion"])
    ctas, flight, q_reads = reorth_flight(b, s, h, k, f)
    bytes_ = b * (4 * s * h + 4 * h * k + 4 * s + 4 * h)
    moved = bytes_ + (q_reads - 1) * b * 4 * h * k
    flops = b * (2 * s * h + 8 * h * k)
    extra = 8.0 * ctas * f * k
    return (bytes_, flops, ctas * flight / MATVEC_WARP_FLIGHT * bytes_
            / moved, extra, ctas, 0.0)


#: the Eq. 6 GEMM's ring (csrc/lowrank_matmul.cu): four stages of 64 rows
#: of a 128-column W tile, all but the one being multiplied in flight
LRMM_STAGES = 4
LRMM_STAGE_ROWS = 64
LRMM_TILE_COLS = 128


def lrmm_rows(m: int) -> Tuple[int, int]:
    """(rows of Vᵀ one CTA takes, M chunks) of the GEMM's plan: M padded to
    a multiple of 8 up to 32 rows a CTA, else 64."""
    nb = -(-m // 8)
    mt = 8 * (8 if nb > 4 else nb)
    return mt, -(-m // mt)


def _terms_lowrank_matmul(shape, dtb, cand) -> Terms:
    """Vᵀ [k, H] @ W [H, N] in one launch over (⌈N / n_block⌉ blocks of
    columns, f splits of H, M chunks) CTAs, each walking its n_block /
    128 tiles with a ring of four 64 × 128 stages of W, three of them
    (at most its whole split × 128 slice) in flight.  The bytes count
    W, Vᵀ and the output once; for f > 1 the float32 partials are
    written and read back once (through the cluster's shared memory up
    to 8 splits, through scratch past it).  bf16 multiplies on the
    tensor cores: its operations are counted at the float32 rate's
    equivalent (× 67 / 989)."""
    from ..kernels.lowrank_matmul import split_rows
    from ..launch.roofline import PEAK_FLOPS_BF16
    k, h, n = shape
    f = int(cand["expansion"])
    nb = max(LRMM_TILE_COLS, int(cand.get("n_block", 512)))
    mt, chunks = lrmm_rows(k)
    rows = split_rows(h, f)
    ctas = -(-n // nb) * f * chunks
    flight = min(LRMM_STAGES - 1, -(-rows // LRMM_STAGE_ROWS)) \
        * LRMM_STAGE_ROWS * LRMM_TILE_COLS * dtb
    bytes_ = dtb * (k * h + h * n + k * n)
    flops = 2.0 * chunks * mt * h * n
    if dtb == 2:
        flops *= PEAK_FLOPS_F32 / PEAK_FLOPS_BF16
    extra = 8.0 * f * chunks * mt * n if f > 1 else 0.0
    return (bytes_, flops, ctas * flight / MATVEC_WARP_FLIGHT, extra, ctas,
            -(-h // rows))


#: the dkv statistics' tile (csrc/dkv_attention.cu): 32 rows of U_k and
#: U_v a step, one CTA per 8 query heads of a slot
DKV_TILE_ROWS = 32
DKV_HEADS = 8


def _terms_dkv_attention(shape, dtb, cand) -> Terms:
    """Rank-space flash statistics over U_k, U_v [B, T, r] for G query
    heads (shape (g, t, r), or (b, g, t, r) for every slot of one
    launch): B × ⌈G / 8⌉ × f CTAs, each walking ⌈T / (32 f)⌉ tiles in
    series with one tile of U_k and U_v (at most its block) in flight.
    The bytes count U once per slot, inner and the outputs; for f > 1
    the merge writes and reads f partials of (r + 2) floats a head."""
    b, g, t, r = shape if len(shape) == 4 else (1, *shape)
    f = int(cand["expansion"])
    groups = -(-g // DKV_HEADS)
    ctas = b * groups * f
    rows = -(-t // f)
    flight = min(DKV_TILE_ROWS, rows) * 2 * r * dtb
    bytes_ = b * (2 * t * r * dtb + 4 * g * r + 4 * g * (r + 2))
    extra = 8.0 * b * groups * DKV_HEADS * f * (r + 2) if f > 1 else 0.0
    return (bytes_, 4.0 * b * g * t * r, ctas * flight / MATVEC_WARP_FLIGHT,
            extra, ctas, b * -(-t // rows))


KERNEL_TERMS: Dict[str, Callable[[Sequence[int], int, Mapping[str, Any]],
                                 Terms]] = {
    "dkv_attention": _terms_dkv_attention,
    "lanczos_reorth": _terms_lanczos_reorth,
    "lowrank_matmul": _terms_lowrank_matmul,
    "matvec_expand": _terms_matvec_expand,
    "rmatvec_expand": _terms_rmatvec_expand,
}


def reaches(kernel: str, shape: Sequence[int],
            cand: Mapping[str, Any]) -> bool:
    """Whether the card's kernel takes ``cand`` at ``shape``: the Eq. 6
    GEMM refuses splits of H shorter than one ring stage
    (``kernels.lowrank_matmul.reaches``); every other point is taken."""
    if kernel == "lowrank_matmul":
        from ..kernels.lowrank_matmul import reaches as lrmm_reaches
        return lrmm_reaches(int(shape[-2]), int(cand["expansion"]))
    return True


def _predict_decode_block(shape: Sequence[int], dtb: int,
                          cand: Mapping[str, Any],
                          dev: DeviceModel) -> float:
    """Per-TOKEN seconds of the fused serving decode at block length k,
    for shape (slots b, decode horizon t, kv row width w): ``t_step``,
    the roofline time of one step (the [b, t, w] K/V working set streamed
    once, 4·b·t·w operations), plus the host dispatch amortized over
    ``min(k, t)`` (a block cannot outrun the fold or budget horizon t),
    plus the steps past the horizon, which a captured block still runs.
    A 1e-9·k tie-break keeps the minimum unique.  Non-increasing
    amortization plus non-decreasing waste: unimodal in k."""
    b, t, w = shape
    k = int(cand["block"])
    if k < 1:
        raise ValueError(f"block must be >= 1, got {k}")
    t_step = max(2 * b * t * w * dtb / dev.hbm_bw,
                 4.0 * b * t * w / dev.peak_flops)
    k_eff = min(k, max(1, t))
    return t_step + dev.host_dispatch_s / k_eff \
        + t_step * (k - k_eff) / k + 1e-9 * k


def predict(kernel: str, shape: Sequence[int], dtype: Any,
            cand: Mapping[str, Any], device: DeviceModel = H100) -> float:
    """Predicted seconds for one launch of ``kernel`` at operating point
    ``cand`` — max(memory side, compute side), unimodal in f.  (For the
    ``decode_block`` pseudo kernel: seconds per token of the serving
    decode.)"""
    if kernel == "decode_block":
        return _predict_decode_block(tuple(int(d) for d in shape),
                                     dtype_bytes(dtype), cand, device)
    try:
        terms = KERNEL_TERMS[kernel]
    except KeyError:
        raise KeyError(f"no cost model for kernel {kernel!r}; "
                       f"known: {sorted(KERNEL_TERMS)}") from None
    f = int(cand["expansion"])
    if f < 1:
        raise ValueError(f"expansion must be >= 1, got {f}")
    bytes_, flops, warps, extra, ctas, splits = terms(
        tuple(int(d) for d in shape), dtype_bytes(dtype), cand)
    dev = device
    t_mem = bytes_ / (dev.hbm_bw * min(warps, dev.sat_warps)
                      / dev.sat_warps)
    t_comp = (bytes_ + extra) / dev.hbm_bw + flops / dev.peak_flops \
        + dev.cta_s * ctas / dev.sms + dev.split_s * splits
    return max(t_mem, t_comp)


def predict_curve(kernel: str, shape: Sequence[int], dtype: Any,
                  candidates: Sequence[Mapping[str, Any]],
                  device: DeviceModel = H100
                  ) -> Tuple[Tuple[Dict[str, Any], float], ...]:
    """(candidate, predicted_s) per candidate, in candidate order."""
    return tuple((dict(c), predict(kernel, shape, dtype, c, device))
                 for c in candidates)


def fit_h100(scalar: Mapping[int, float], scalar_shape: Sequence[int],
             batched: Mapping[int, float], batched_shape: Sequence[int],
             dtype_scalar: Any, dtype_batched: Any) -> Dict[str, float]:
    """Fit the H100 model's two constants to two measured f sweeps
    ({f: seconds}) of the matvec at 512 rows per CTA:

    * ``sat_warps`` from the scalar sweep's f = 1 point (the fewest
      bytes in flight): the rate per warp in flight it shows, against
      the data-sheet rate;
    * ``cta_s`` by least squares through the origin on the batched
      sweep, which is saturated at f = 1: t(f) − t(1) − partials(f)/bw
      = cta_s · (CTAs(f) − CTAs(1)) / SMs over f > 1 (clamped at 0; one
      launch at every f, so nothing else grows with f)."""
    terms = _terms_matvec_expand
    bw, sms = H100.hbm_bw, H100.sms
    cand = lambda f: {"expansion": f, "row_block": 512}  # noqa: E731
    b1, _, w1, *_ = terms(tuple(scalar_shape), dtype_bytes(dtype_scalar),
                          cand(1))
    per_warp = b1 / (scalar[1] * w1)
    t1 = batched[1]
    c1 = terms(tuple(batched_shape), dtype_bytes(dtype_batched), cand(1))[4]
    sxy = sxx = 0.0
    for f, t in sorted(batched.items()):
        if f == 1:
            continue
        _, _, _, extra, ctas, _ = terms(tuple(batched_shape),
                                        dtype_bytes(dtype_batched), cand(f))
        x = (ctas - c1) / sms
        sxy += x * (t - t1 - extra / bw)
        sxx += x * x
    return {"sat_warps": bw / per_warp,
            "cta_s": max(0.0, sxy / sxx) if sxx else 0.0,
            "per_warp_bytes_s": per_warp}
