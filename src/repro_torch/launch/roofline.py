"""Roofline helpers and the one home of the H100's constants.

Counterpart of ``repro.launch.roofline``, whose constants are another
chip's.  Every constant below is an NVIDIA H100 SXM5 data-sheet figure
(NVIDIA H100 Tensor Core GPU datasheet, SXM5 column), dense (no
sparsity), per GPU:

* :data:`PEAK_FLOPS_BF16` 989 TFLOP/s (BF16 Tensor Core);
* :data:`PEAK_FLOPS_F32` 67 TFLOP/s (FP32 on the CUDA cores: the port
  leaves TF32 off, so a float32 product runs there);
* :data:`HBM_BW` 3.35 TB/s (HBM3);
* :data:`NVLINK_BW` 450 GB/s per direction (NVLink 4: 900 GB/s
  bidirectional) to the other GPUs of an 8-GPU HGX node;
* :data:`IB_BW` 50 GB/s per direction across nodes (one ConnectX-7
  NDR InfiniBand port of 400 Gb/s per GPU, as a DGX H100 pairs them).

``chip_smoke.py``'s bounds and ``tune.cost_model.H100`` read them from
here.

Collectives.  ``distributed.sharding`` counts, per collective, the bytes
this rank SENT and the global ranks of the group it ran over
(``collective_counts(by_group=True)``).  :func:`collective_stats` turns
that into the reference's per-type ``{"bytes", "count"}``, whose bytes
are RESULT bytes: an all-gather's result is group size × sent, a
reduce-scatter's sent / group size, an all-reduce's, an all-to-all's and
a broadcast's what was sent.  A group of one rank moves nothing (its
collectives are copies): it adds to ``count`` only.  The reference's
ring convention (:data:`_RING_FACTOR`, relative to result bytes) then
prices them in :func:`roofline_terms`: each group's bytes at NVLink's
rate when every rank of the group lies in one 8-GPU node (rank // 8
equal; a ``DeviceMesh`` numbers its ranks row-major over the mesh's
shape, so the last axis is the innermost), and at InfiniBand's rate
otherwise.  On the reference's (16, 16) mesh both axes' groups span
nodes.

There is no HLO parsing and no depth extrapolation: the port's step is
a Python loop that the dry-run counts layer by layer
(``launch.dryrun``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

#: dense BF16 Tensor Core rate, FLOP/s (H100 SXM5 datasheet)
PEAK_FLOPS_BF16 = 989e12
#: FP32 rate of the CUDA cores, FLOP/s (H100 SXM5 datasheet)
PEAK_FLOPS_F32 = 67e12
#: the peak rate of each compute dtype's products
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}
#: HBM3 bandwidth, bytes/s (H100 SXM5 datasheet)
HBM_BW = 3.35e12
#: NVLink 4 bandwidth per direction per GPU within an 8-GPU node, bytes/s
NVLINK_BW = 450e9
#: InfiniBand NDR per GPU across nodes (400 Gb/s), bytes/s
IB_BW = 50e9
#: GPUs of one NVLink node (HGX / DGX H100)
NODE_GPUS = 8

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "broadcast")

# The reference's ring-schedule traffic per device relative to RESULT
# bytes: an all-reduce moves ~2x its payload, the others ~1x.
_RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}

# the port's op names (distributed.sharding) -> the reference's types
_OP_TYPE = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "broadcast": "broadcast"}


def within_node(ranks: Iterable[int]) -> bool:
    """Whether every rank of a group lies in one :data:`NODE_GPUS`-GPU
    node (consecutive global ranks fill a node)."""
    return len({int(r) // NODE_GPUS for r in ranks}) <= 1


def result_bytes(op: str, sent: int, group_size: int) -> float:
    """The result bytes of ``op`` (the port's name) from the bytes a rank
    sent over a group of ``group_size`` ranks."""
    if op == "all_gather":
        return float(sent) * group_size
    if op == "reduce_scatter":
        return float(sent) / group_size
    return float(sent)


def collective_stats(counts: Dict[str, Dict[tuple, tuple]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per reference type, ``{"bytes", "count", "ib_bytes"}`` from
    ``sharding.collective_counts(by_group=True)`` (``"op/what"`` →
    {global ranks of the group: (calls, bytes sent)}): ``bytes`` are
    result bytes over groups of more than one rank, ``ib_bytes`` the part
    over groups that span nodes."""
    stats = {k: {"bytes": 0.0, "count": 0, "ib_bytes": 0.0}
             for k in _COLLECTIVES}
    for key, groups in counts.items():
        op = key.split("/", 1)[0]
        st = stats[_OP_TYPE[op]]
        for ranks, (calls, sent) in groups.items():
            st["count"] += calls
            if len(ranks) < 2:
                continue
            b = result_bytes(op, sent, len(ranks))
            st["bytes"] += b
            if not within_node(ranks):
                st["ib_bytes"] += b
    return stats


def roofline_terms(flops_per_dev: Any, hbm_bytes_per_dev: float,
                   coll: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The three roofline terms in seconds, of per-device quantities.

    ``flops_per_dev`` is a number (charged at the BF16 peak, as the
    reference charges every FLOP) or ``{dtype name: FLOPs}``, each at
    :data:`PEAK_FLOPS` of its dtype (BF16's for a dtype not listed).
    ``coll`` is :func:`collective_stats`' form; a type without
    ``ib_bytes`` moves all its bytes over NVLink."""
    if isinstance(flops_per_dev, dict):
        compute_s = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS_BF16)
                        for dt, f in flops_per_dev.items())
    else:
        compute_s = flops_per_dev / PEAK_FLOPS_BF16
    coll_bytes = coll_s = 0.0
    for k, v in coll.items():
        ib = v.get("ib_bytes", 0.0)
        coll_bytes += v["bytes"] * _RING_FACTOR[k]
        coll_s += _RING_FACTOR[k] * ((v["bytes"] - ib) / NVLINK_BW
                                     + ib / IB_BW)
    return {"compute_s": compute_s,
            "memory_s": hbm_bytes_per_dev / HBM_BW,
            "collective_s": coll_s,
            "collective_bytes": coll_bytes}
