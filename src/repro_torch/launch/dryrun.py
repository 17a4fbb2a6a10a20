"""Dry-run of the (arch x shape x mesh) cells, shape only, on the host.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 placeholder XLA devices.  Here each cell runs ONE rank of
its mesh through the port's own step code, with no memory behind any
tensor:

1. a fake world (``torch.distributed``'s ``"fake"`` backend) of the
   mesh's size, this process being rank 0, and the ``DeviceMesh`` over
   it on ``"cpu"`` (the reference's production meshes: single (16, 16)
   ("data", "model"), multi (2, 16, 16) ("pod", "data", "model"));
2. under ``FakeTensorMode``, rank 0's blocks of ``api.abstract_params``
   (and of the optimizer state, the batch or the decode cache) by the
   port's sharding rules (``runtime.steps.shard_train_state``,
   ``distributed.sharding.shard_params``, ``api.shard_cache``);
3. one step from ``runtime.steps`` on them (``make_train_step(mesh=,
   zero1=)``, ``make_prefill_step``, ``make_decode_step``, or
   ``make_dkv_decode_step`` under ``decomposed_kv``), through the plain
   versions of the port's kernels (``backend="reference"``: the same
   arithmetic the kernels do), inside ``FlopCounterMode``, ``MemTracker``
   and :class:`Traffic`.

What a record holds, per device: ``flops_per_device`` (FlopCounterMode:
matmul-class ops, the forward, the backward and remat's recomputation;
elementwise ops are not counted), ``flops_by_dtype`` (the same FLOPs by
the dtype of the product), ``hbm_bytes_per_device`` (:class:`Traffic`:
each non-view aten op's operand and result bytes, the traffic of eager
execution with no fusion, so it over-counts what fused kernels move),
``collectives`` (``launch.roofline.collective_stats`` of the counted
collectives; ``collective_counts`` the counts themselves, as
``distributed.sharding.collective_counts`` gives them), ``roofline``
(``roofline_terms`` at the H100's constants)
and ``memory`` in place of XLA's ``memory_analysis``: the bytes of the
parameters, the optimizer state, the batch or the cache this rank holds
(``argument_bytes``, their sum) and the peak that ``MemTracker`` saw
during the step (``peak_bytes``; ``temp_bytes`` = peak − arguments).
``model_flops_*`` use the reference's formula (6·N·B·S for a training
step, 2·N·B·S for a prefill, 2·N·B for one decode token, N =
``api.active_param_count``).  Nothing is extrapolated: the step is a
Python loop over every layer, so every layer is counted.

A value the step reads back to the host that fake tensors cannot know
(``bool(weight != 1.0)`` in the DP step, a decomposed cache's valid rows)
is answered by :class:`Traffic`: 0, False or 0.0 (a uniform batch's
branch: equal token counts on every rank), or in a decomposed-KV decode
cell the frozen prefix length; ``host_reads`` counts them.

A cell the port refuses (``NotImplementedError`` from a step builder or
a step: none of the reference's 64 cells, nor any mesh the port's
distribution knows since its last refusals ran) is recorded with the
port's own error text.
Records go to ``results/dryrun_torch/`` through ``ioutil``'s atomic
write.

Flags: the reference's, where the port has the option.  ``--no-calibrate``,
``--donate`` and ``--score-bf16`` steer XLA only (its cost-analysis
extrapolation, buffer donation and its score dtype): they are refused
(:data:`REFUSED_FLAGS`).  ``--moe-shard-map`` runs the MoE blocks in
the reference's per-shard form (``cfg.moe_shard_map``: capacity and the
aux loss from each DP rank's tokens) in place of its default global
form (capacity from the whole step's tokens).  ``--attn-chunk`` and
``--ssd-chunk`` set ``models.layers.ATTN_CHUNK`` and
``models.mamba2.CHUNK`` for the run.

Importing this module initializes nothing; :func:`run_cell` refuses to
start when a process group is up, and destroys its fake group and
restores the collective counts before it returns.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k \
      --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, ArchConfig, ShapeSpec, all_archs, cells, \
    get_arch
from ..ioutil import atomic_write_json
from .roofline import collective_stats, roofline_terms

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: the reference's production meshes: (sizes, axis names)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

#: flags of the reference's CLI the port has no counterpart of, and why
REFUSED_FLAGS = {
    "--no-calibrate": "XLA's cost-analysis extrapolation (nothing is "
                      "extrapolated here)",
    "--donate": "XLA's buffer donation",
    "--score-bf16": "XLA's attention-score dtype",
}

#: the dense recent-token tail of a decomposed-KV decode cell (the
#: reference's ``decomposed_kv.TAIL``)
DK_TAIL = 128

_NO_TRAFFIC = ("empty.memory_format", "empty_strided.default",
               "new_empty.default", "new_empty_strided.default",
               "empty_like.default", "_local_scalar_dense.default",
               "lift_fresh.default", "detach.default")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Traffic(TorchDispatchMode):
    """Counts, per aten op that is not a view: the bytes of its tensor
    operands and results (``bytes``), and the FLOPs of FlopCounterMode's
    formulas by the dtype of the first operand (``flops``).  Answers a
    host read that fake tensors cannot (a data-dependent
    ``_local_scalar_dense``) with ``answer`` (0, False or 0.0 by the
    tensor's dtype, or the given int) and counts it (``host_reads``)."""

    def __init__(self, answer: int = 0):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.answer = answer
        self.bytes = 0
        self.flops: Dict[str, int] = collections.Counter()
        self.host_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException)
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            try:
                return func(*args, **kwargs)
            except DataDependentOutputException:
                self.host_reads += 1
                dt = args[0].dtype
                if dt == torch.bool:
                    return bool(self.answer)
                return float(self.answer) if dt.is_floating_point \
                    else int(self.answer)
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not func.is_view \
                and func._opname + "." + func._overloadname \
                not in _NO_TRAFFIC:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            first = next(t for t in tree_leaves(args)
                         if isinstance(t, torch.Tensor))
            self.flops[str(first.dtype).replace("torch.", "")] += \
                formula(*args, **kwargs, out_val=out)
        return out


@contextlib.contextmanager
def fake_world(sizes: Sequence[int], names: Sequence[str], rank: int = 0):
    """A ``DeviceMesh`` of ``sizes`` over a fake process group in which
    this process is ``rank``: collectives return results of the right
    shapes and move nothing.  Refuses to start when a process group is
    up; destroys its own on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry-run starts its own fake world; this "
                           "process already has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(sizes))
    try:
        yield init_device_mesh("cpu", tuple(sizes),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def _blank(t: torch.Tensor) -> torch.Tensor:
    """Zeros of ``t``'s shape and dtype on the host: fake under
    ``FakeTensorMode``, real outside it (a real world runs the same
    cell: zero tokens are valid ids and zero weights give finite
    losses)."""
    return torch.zeros(tuple(t.shape), dtype=t.dtype)


def _blank_tree(tree):
    from ..tree import tree_map
    return tree_map(_blank, tree)


def resolve_cfg(arch, *, remat: Optional[bool] = None,
                seq_parallel: bool = False,
                remat_policy: Optional[str] = None,
                capacity_factor: float = 0.0,
                moe_shard_map: bool = False) -> ArchConfig:
    """``arch`` (a name or a config) with the cell's overrides."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if seq_parallel:
        cfg = cfg.replace(seq_parallel=True)
    if moe_shard_map:
        cfg = cfg.replace(moe_shard_map=True)
    if remat_policy is not None:
        cfg = cfg.replace(remat_policy=remat_policy)
    if capacity_factor:
        cfg = cfg.replace(capacity_factor=capacity_factor)
    return cfg


def _rank_batch_bytes(batch, mesh) -> int:
    """Bytes of the rows of a GLOBAL training batch this rank trains on
    (``steps._dp_shard``'s rule)."""
    from ..distributed import sharding as sh
    from ..runtime import steps
    dp = sh.dp_size(mesh)
    if steps.seq_batch(tuple(batch["tokens"].shape), mesh):
        return sum(_bytes(v) // (dp if k in steps.SEQ_LEAVES else 1)
                   for k, v in batch.items())
    total = 0
    for v in batch.values():
        spec = sh.batch_spec(tuple(v.shape), mesh)
        split = spec and spec[0] is not None
        total += _bytes(v) // (dp if split else 1)
    return total


def build_cell(arch, shape, mesh, *, decomposed_kv: int = 0,
               remat: Optional[bool] = None, zero1: bool = True,
               microbatches: int = 1, seq_parallel: bool = False,
               remat_policy: Optional[str] = None,
               capacity_factor: float = 0.0, moe_shard_map: bool = False,
               optimizer=None):
    """(step, args, memory) of one cell on ``mesh``, called inside a
    ``FakeTensorMode`` (or, at a small size, in a real world): ``args``
    are this rank's blocks, zeros (the GLOBAL batch or prefill inputs,
    which the step slices itself), and ``memory`` the bytes of what the
    rank holds by category.  ``arch`` and ``shape`` are names or a
    config and a :class:`ShapeSpec`."""
    from ..distributed import sharding as sh
    from ..models import api
    from ..optim import make_optimizer
    from ..runtime import steps
    cfg = resolve_cfg(arch, remat=remat, seq_parallel=seq_parallel,
                      remat_policy=remat_policy,
                      capacity_factor=capacity_factor,
                      moe_shard_map=moe_shard_map)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mem = {"param_bytes": 0, "opt_state_bytes": 0, "batch_bytes": 0,
           "cache_bytes": 0}
    tp = steps._tp_mesh(mesh, cfg) is not None
    p_abs = api.abstract_params(cfg)

    if shape.kind == "train":
        opt = optimizer or make_optimizer(cfg)
        p_blk, o_blk = steps.shard_train_state(
            cfg, p_abs, opt.init(p_abs), mesh, zero1=zero1, optimizer=opt)
        params, opt_state = _blank_tree(p_blk), _blank_tree(o_blk)
        batch = _blank_tree(api.train_batch_specs(cfg, shape))
        mem.update(param_bytes=_bytes(params),
                   opt_state_bytes=_bytes(opt_state),
                   batch_bytes=_rank_batch_bytes(batch, mesh))
        step = steps.make_train_step(cfg, opt, microbatches=microbatches,
                                     backend="reference", mesh=mesh,
                                     zero1=zero1)
        return step, (params, opt_state, batch), mem

    params = _blank_tree(sh.shard_params(p_abs, mesh, cfg) if tp else p_abs)
    mem["param_bytes"] = _bytes(params)
    if shape.kind == "prefill":
        inputs = tuple(_blank(t) for t in api.prefill_input_specs(cfg, shape))
        dp = sh.dp_size(mesh)
        mem["batch_bytes"] = sum(
            _bytes(t) // (dp if t.shape[0] % dp == 0 else 1)
            for t in inputs)
        step = steps.make_prefill_step(cfg, mesh=mesh, backend="reference")
        return step, (params,) + inputs, mem

    b = shape.global_batch
    tok = torch.empty((b,), dtype=torch.int32, device="meta")
    tok = _blank(sh.local_block(tok, sh.token_sharding(mesh, b), mesh))
    if decomposed_kv:
        from ..models import decomposed_kv as DK
        if cfg.family != "dense":
            raise ValueError(f"decomposed KV runs the dense family, not "
                             f"{cfg.family!r}")
        frozen = shape.seq_len - DK_TAIL
        cache = DK.init_cache(cfg, b, frozen, decomposed_kv, tail=DK_TAIL,
                              device="meta")
        cache = _blank_tree(api.shard_cache(cfg, cache, mesh))
        mem["cache_bytes"] = _bytes(cache)
        dstep = steps.make_dkv_decode_step(cfg, mesh)
        frozen_len = torch.full(tuple(tok.shape), frozen, dtype=torch.int32)

        def step(params, token, cache, pos):
            return dstep(params, token, cache, pos, frozen_len)
        return step, (params, tok, cache, _blank(tok)), mem
    _, cache, _ = api.decode_input_specs(cfg, shape)
    cache = _blank_tree(api.shard_cache(cfg, cache, mesh))
    mem["cache_bytes"] = _bytes(cache)
    step = steps.make_decode_step(cfg, mesh, global_batch=b)
    return step, (params, tok, cache, _blank(tok)), mem


def model_flops(cfg, shape: ShapeSpec) -> float:
    """The reference's model FLOPs of one step of ``shape``."""
    from ..models import api
    n = api.active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@contextlib.contextmanager
def _module_knobs(attn_chunk: int = 0, ssd_chunk: int = 0):
    from ..models import layers, mamba2
    saved = layers.ATTN_CHUNK, mamba2.CHUNK
    try:
        if attn_chunk:
            layers.ATTN_CHUNK = attn_chunk
        if ssd_chunk:
            mamba2.CHUNK = ssd_chunk
        yield
    finally:
        layers.ATTN_CHUNK, mamba2.CHUNK = saved


def run_cell(arch, shape, multi_pod: bool = False, *,
             mesh_shape: Optional[Tuple[Sequence[int], Sequence[str]]] = None,
             attn_chunk: int = 0, ssd_chunk: int = 0, **kw) -> Dict[str, Any]:
    """One cell's record (module docstring): ``arch``/``shape`` are names
    or a config and a :class:`ShapeSpec`; the mesh is the reference's
    single or multi-pod one, or ``mesh_shape`` = (sizes, names).  A cell
    the port refuses (``NotImplementedError``) gives a record with
    ``"refused"``: the error text."""
    from ..distributed import sharding as sh
    mesh_name = "multi" if multi_pod else "single"
    sizes, names = MESHES[mesh_name]
    if mesh_shape is not None:
        sizes, names = mesh_shape
        mesh_name = "x".join(map(str, sizes))
    cfg = resolve_cfg(arch, **{k: kw[k] for k in (
        "remat", "seq_parallel", "remat_policy", "capacity_factor",
        "moe_shard_map") if k in kw})
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    options = dict(kw, attn_chunk=attn_chunk, ssd_chunk=ssd_chunk)
    options.pop("optimizer", None)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shp.name, "mesh": mesh_name,
        "mesh_shape": list(sizes), "chips": int(math.prod(sizes)),
        "kind": shp.kind,
        "options": {k: str(v) for k, v in options.items() if v}}
    saved = sh.snapshot()
    sh.reset_collective_counts()
    t0 = time.perf_counter()
    try:
        with fake_world(sizes, names) as mesh, _module_knobs(
                attn_chunk, ssd_chunk):
            sh.dp_group(mesh)     # a pod mesh's flattened group: made
            # here, as its construction reads the mesh's real tensor
            return _measure(rec, cfg, shp, mesh, kw, t0)
    finally:
        sh.reset_collective_counts()
        sh.add_collectives(saved)


def _measure(rec, cfg, shp, mesh, kw, t0) -> Dict[str, Any]:
    """run_cell's work inside the fake world: the step under the fake
    tensors and the counters, and the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from ..distributed import sharding as sh
    with FakeTensorMode(allow_non_fake_inputs=True):
        try:
            step, args, mem = build_cell(cfg, shp, mesh, **kw)
        except NotImplementedError as e:
            return dict(rec, refused=str(e))
        traffic = Traffic(shp.seq_len - DK_TAIL
                          if kw.get("decomposed_kv") else 0)
        tracker = MemTracker()
        tracker.track_external(*(t for t in tree_leaves(args)
                                 if isinstance(t, torch.Tensor)))
        flops = FlopCounterMode(display=False)
        try:
            with tracker, flops, traffic:
                step(*args)
        except NotImplementedError as e:
            return dict(rec, refused=str(e))
        peak = sum(d["Total"] for d in
                   tracker.get_tracker_snapshot("peak").values())
        counted = sh.collective_counts(by_group=True)
    run_s = time.perf_counter() - t0

    total_flops = int(flops.get_total_flops())
    if sum(traffic.flops.values()) != total_flops:
        raise AssertionError(f"FLOPs by dtype {dict(traffic.flops)} do "
                             f"not sum to FlopCounterMode's {total_flops}")
    coll = collective_stats(counted)
    terms = roofline_terms(dict(traffic.flops), float(traffic.bytes), coll)
    chips = rec["chips"]
    mf = model_flops(cfg, shp)
    # the batch's views are not tracked: what the rank holds of it is
    # added to the tracked peak
    mem["argument_bytes"] = sum(mem.values())
    mem["peak_bytes"] = int(peak) + mem["batch_bytes"]
    mem["temp_bytes"] = mem["peak_bytes"] - mem["argument_bytes"]
    rec.update({
        "run_s": round(run_s, 2),
        "flops_per_device": float(total_flops),
        "flops_by_dtype": {k: float(v) for k, v in traffic.flops.items()},
        "hbm_bytes_per_device": float(traffic.bytes),
        "host_reads": traffic.host_reads,
        "collectives": coll,
        "collective_counts": {k: [sum(c[0] for c in g.values()),
                                  sum(c[1] for c in g.values())]
                              for k, g in counted.items()},
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": (mf / chips / total_flops)
        if total_flops else None,
        "memory": mem,
    })
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    rec["dominant_term"] = dom
    rec["roofline_fraction"] = terms["compute_s"] / max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"], 1e-30)
    return rec


def save_record(rec: Dict[str, Any], tag: str = "",
                results_dir: str = RESULTS_DIR) -> str:
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json"
    path = os.path.join(results_dir, name)
    atomic_write_json(path, rec, indent=2)
    return path


def sweep(mesh: str = "single") -> List[Tuple[str, str, bool]]:
    """(arch, shape, multi_pod) of every cell of ``--all``: each arch but
    the paper's llama2-7b (benchmarked, not a cell), its ``cells``, each
    mesh of ``mesh`` (single, multi or both)."""
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[mesh]
    return [(name, shp, mp) for name, cfg in sorted(all_archs().items())
            if name != "llama2-7b" for shp in cells(cfg) for mp in meshes]


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, why in REFUSED_FLAGS.items():
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise SystemExit(f"dryrun: {flag} has no counterpart in the "
                             f"port: {why}")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--decomposed-kv", type=int, default=0)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--moe-shard-map", action="store_true",
                    help="MoE blocks in the per-shard form "
                         "(moe_ffn_shard_map's capacity and aux loss)")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    if args.all:
        todo = sweep(args.mesh)
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape, mp) for mp in
                {"single": [False], "multi": [True],
                 "both": [False, True]}[args.mesh]]
    kw: Dict[str, Any] = {}
    if args.no_remat:
        kw["remat"] = False
    if args.no_zero1:
        kw["zero1"] = False
    if args.microbatches != 1:
        kw["microbatches"] = args.microbatches
    if args.decomposed_kv:
        kw["decomposed_kv"] = args.decomposed_kv
    if args.seq_parallel:
        kw["seq_parallel"] = True
    if args.remat_policy:
        kw["remat_policy"] = args.remat_policy
    if args.capacity_factor:
        kw["capacity_factor"] = args.capacity_factor
    if args.moe_shard_map:
        kw["moe_shard_map"] = True
    failures, n_refused = [], 0
    for arch, shp, mp in todo:
        mtag = "multi" if mp else "single"
        out = os.path.join(args.results_dir,
                           f"{arch}_{shp}_{mtag}{args.tag}.json")
        if args.skip_existing and os.path.exists(out):
            print(f"[skip] {arch} x {shp} x {mtag}")
            continue
        print(f"[cell] {arch} x {shp} x {mtag} ...", flush=True)
        try:
            rec = run_cell(arch, shp, mp, attn_chunk=args.attn_chunk,
                           ssd_chunk=args.ssd_chunk, **kw)
            path = save_record(rec, args.tag, args.results_dir)
            if "refused" in rec:
                n_refused += 1
                print(f"  refused: {rec['refused']} -> "
                      f"{os.path.basename(path)}", flush=True)
                continue
            t = rec["roofline"]
            print(f"  ok  run={rec['run_s']}s compute={t['compute_s']:.3e}s "
                  f"memory={t['memory_s']:.3e}s "
                  f"coll={t['collective_s']:.3e}s "
                  f"dom={rec['dominant_term']} peak="
                  f"{rec['memory']['peak_bytes'] / 1e9:.2f}GB -> "
                  f"{os.path.basename(path)}", flush=True)
        except Exception:
            failures.append((arch, shp, mtag))
            print(f"  FAIL {arch} x {shp} x {mtag}\n"
                  f"{traceback.format_exc()}", flush=True)
    print(f"{len(todo)} cells: {len(todo) - n_refused - len(failures)} "
          f"ran, {n_refused} refused by the port, {len(failures)} failed")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
