"""Sharding rule tables: param / optimizer / batch / cache specs.

Counterpart of ``repro.distributed.sharding`` (its rules, copied: that
module imports JAX).  Mesh convention (``launch.mesh``): single pod
``("data", "model")``, multi-pod ``("pod", "data", "model")``, where
"pod" composes with "data" into the DP super-axis of every
data-parallel collective.

Strategy per family (the reference's):

* dense / vlm / audio — Megatron TP on "model": QKV/up column-parallel,
  O/down row-parallel, vocab-sharded embedding and head when divisible;
  DP over ("pod", "data"); ZeRO-1 optimizer-state sharding over DP;
* moe — experts over "model" (EP); ``expert_sharding="2d"`` also shards
  the expert FFN dim over "data" (EP x FSDP);
* ssm / hybrid — TP over d_inner / heads for the projections;
* decode caches — slots over DP; a batch-1 cache shards its time axis
  over "data" instead (``seq_shard``); KV heads over "model" when
  divisible, else head_dim, else replicated.

Every rule is divisibility-guarded: a dim that does not divide by its
axis size falls back to replication.

The rules read only axis names and sizes, so a mesh here is either a
``torch.distributed.device_mesh.DeviceMesh`` or a plain
:class:`MeshShape` (no process group: what the CPU tests of the rules
use).  A spec is a :class:`Spec`, one entry per tensor dim: an axis
name, a tuple of names (the DP super-axis), or None; :func:`placements`
turns it into the DTensor placements of a ``DeviceMesh``.  Leaf paths
are ``tree.named_leaves``' names, which are the reference's, so the
rules apply leaf for leaf.

The reference's ``constrain_cache`` has no counterpart: it pins GSPMD's
layout inside a jitted function.  The port runs SPMD, one process per
device, and its serving engine holds each rank's local slots outright
(``serving.Engine``), so there is no global layout to constrain.

The collective side is here too (``DeviceMesh`` only): :func:`dp_group`
(the process group of the ranks that share this rank's "model"
coordinate; one flattened group for ("pod", "data")), :func:`dp_size`,
:func:`dp_rank`, and the "model" group beside it (:func:`model_group`,
:func:`model_size`, :func:`model_rank`); the collectives
:func:`all_gather_into` / :func:`gather_dim` (any dim),
:func:`all_reduce`, :func:`reduce_scatter` (any dim), :func:`broadcast`,
:func:`broadcast_int` and :func:`all_true`, which every collective of
the port's serving, decomposition and train steps goes through and which
count what they issue (:func:`collective_counts`).  :func:`local_block`
cuts a rank's block of a whole tensor under a spec, :func:`gather_block`
puts the whole back together, and :func:`shard_params` applies the first
leaf by leaf by :func:`params_sharding`.  :func:`require_groups` refuses
a mesh that carries names and sizes only where collectives must run.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

from ..tree import named_leaves, rebuild

Tree = Any


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or processes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]


class Spec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated along that dim)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def _names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(_names(mesh), tuple(mesh.mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def dp_name(mesh):
    """The DP super-axis as a spec entry (a tuple iff multi-pod)."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def axis_size(mesh, name) -> int:
    axes = mesh_axes(mesh)
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= axes[n]
        return out
    return axes[name]


def _fits(dim: int, mesh, name) -> bool:
    return dim % axis_size(mesh, name) == 0


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

COL_PARALLEL = ("wq/w", "wk/w", "wv/w", "up/w", "gate/w", "in_proj/w",
                "lm_head/w")
ROW_PARALLEL = ("wo/w", "down/w", "out_proj/w")
COL_BIAS = ("wq/b", "wk/b", "wv/b", "up/b", "gate/b", "in_proj/b")


def param_spec(path_str: str, shape: Tuple[int, ...], mesh, cfg) -> Spec:
    """Spec of one parameter leaf (leading stack dims replicated)."""
    nd = len(shape)
    spec = [None] * nd
    if path_str.endswith("embed/w"):
        if _fits(shape[0], mesh, "model"):
            spec[0] = "model"
    elif any(path_str.endswith(s) for s in COL_PARALLEL):
        if _fits(shape[-1], mesh, "model"):
            spec[nd - 1] = "model"
    elif any(path_str.endswith(s) for s in ROW_PARALLEL):
        if _fits(shape[-2], mesh, "model"):
            spec[nd - 2] = "model"
    elif any(path_str.endswith(s) for s in COL_BIAS):
        if _fits(shape[-1], mesh, "model"):
            spec[nd - 1] = "model"
    elif path_str.endswith(("w_gate", "w_up")):      # [.., E, H, F]
        if _fits(shape[-3], mesh, "model"):
            spec[nd - 3] = "model"
        if getattr(cfg, "expert_sharding", "1d") == "2d" \
                and _fits(shape[-1], mesh, "data"):
            spec[nd - 1] = "data"
    elif path_str.endswith("w_down"):                # [.., E, F, H]
        if _fits(shape[-3], mesh, "model"):
            spec[nd - 3] = "model"
        if getattr(cfg, "expert_sharding", "1d") == "2d" \
                and _fits(shape[-2], mesh, "data"):
            spec[nd - 2] = "data"
    # conv_w / a_log / d / dt_bias / norms / router / gates: replicated
    return Spec(*spec)


def _map_named(fn, tree: Tree) -> Tree:
    return rebuild(tree, {name: fn(name, leaf)
                          for name, leaf in named_leaves(tree)})


def params_sharding(param_shapes: Tree, mesh, cfg) -> Tree:
    """A tree of :class:`Spec` over a parameter tree (tensors of any
    device, ``meta`` included)."""
    return _map_named(lambda name, leaf: param_spec(
        name, tuple(leaf.shape), mesh, cfg), param_shapes)


# ---------------------------------------------------------------------------
# Optimizer-state specs (ZeRO-1 over the DP super-axis)
# ---------------------------------------------------------------------------

def _zero1(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Add the DP axis to the first unsharded, divisible dim (ZeRO-1)."""
    dp = dp_axes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, (d, s) in enumerate(zip(shape, dims)):
        if s is None and d % axis_size(mesh, dp) == 0 and d > 1:
            dims[i] = dp if len(dp) > 1 else dp[0]
            break
    return Spec(*dims)


def opt_state_sharding(opt_shapes: Tree, mesh, cfg,
                       zero1: bool = True) -> Tree:
    """Specs of the optimizer state.  Its param-shaped subtrees (AdamW's
    m/v, Adafactor's factored vr/vc) have paths that END with the
    parameter's path, so the same suffix rules apply; ZeRO-1 then adds
    the DP axis."""
    def f(name, leaf):
        shape = tuple(leaf.shape)
        spec = param_spec(name, shape, mesh, cfg)
        if zero1 and len(shape) >= 1 and "step" not in name:
            spec = _zero1(spec, shape, mesh)
        return spec
    return _map_named(f, opt_shapes)


def names_twice(spec: Spec) -> bool:
    """Whether ``spec`` names a mesh axis more than once (the reference's
    ``_zero1`` of a leaf already sharded over "data"; JAX refuses it)."""
    names = [a for e in spec for a in (e if isinstance(e, tuple) else (e,))
             if a is not None]
    return len(names) != len(set(names))


def zero1_block_spec(path_str: str, shape: Tuple[int, ...], mesh,
                     cfg) -> Spec:
    """The block of an optimizer-state leaf that the port's ZeRO-1 train
    step keeps: ``opt_state_sharding``'s spec, except where that spec
    names "data" twice (a 2-D expert leaf, ROADMAP.md caveat C10): the
    step reads it as already split over DP and keeps the parameter's
    own block (its param spec)."""
    spec = param_spec(path_str, shape, mesh, cfg)
    z = _zero1(spec, shape, mesh) if len(shape) >= 1 \
        and "step" not in path_str else spec
    return spec if names_twice(z) else z


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """A train or prefill batch leaf: the leading batch dim over DP; a
    batch-1 leaf shards its second (sequence) dim instead."""
    dp = dp_axes(mesh)
    spec = [None] * len(shape)
    if shape and shape[0] % axis_size(mesh, dp) == 0:
        spec[0] = dp_name(mesh)
    elif len(shape) >= 2 and shape[0] == 1 \
            and shape[1] % axis_size(mesh, dp) == 0:
        spec[1] = dp_name(mesh)          # batch-1 long context: shard S
    return Spec(*spec)


def batch_sharding(batch_shapes: Tree, mesh) -> Tree:
    return _map_named(lambda name, leaf: batch_spec(tuple(leaf.shape), mesh),
                      batch_shapes)


def cache_pspec(path_str: str, shape: Tuple[int, ...], mesh,
                seq_shard: bool = True) -> Spec:
    """Spec of one decode-cache leaf, by its name (the last path part):

    * k/v  [..., B, T, kvh, hd] — B over DP (or T over "data" when
      B == 1), kvh over "model" (else hd, else replicated);
    * k_u/v_u [..., B, T, r] — B over DP (or T over "data" when B == 1);
      the time axis stays model-replicated;
    * k_vt/v_vt [..., B, r, kvw] — B over DP, kvw over "model";
    * conv [..., B, W, ch] — B over DP, ch over "model";
    * ssm [..., B, nh, hd, ds] — B over DP, nh over "model";
    * k_u_pages/v_u_pages [..., P, page, r] — replicated: pages are
      shared across slots by prefix reuse, so any slot may read any page;
    * k_pages/v_pages [..., TP, page, kvh, hd] — pages replicated, kvh
      over "model" (else hd), as k/v.

    ``seq_shard=False`` turns off the B == 1 time-axis branch (it belongs
    to global-batch-1 long-context decode caches, not to a serving
    engine's one-request prefill)."""
    dpn = dp_name(mesh)
    dp_sz = axis_size(mesh, dp_axes(mesh))
    data_sz = axis_size(mesh, "data")
    leaf_name = path_str.rsplit("/", 1)[-1]
    nd = len(shape)
    spec = [None] * nd
    if leaf_name in ("k", "v"):
        b_dim, t_dim, kvh_dim, hd_dim = nd - 4, nd - 3, nd - 2, nd - 1
        if shape[b_dim] % dp_sz == 0 and shape[b_dim] > 1:
            spec[b_dim] = dpn
        elif seq_shard and shape[b_dim] == 1 \
                and shape[t_dim] % data_sz == 0:
            spec[t_dim] = "data"     # sequence-sharded KV
        if _fits(shape[kvh_dim], mesh, "model") and shape[kvh_dim] > 1:
            spec[kvh_dim] = "model"
        elif _fits(shape[hd_dim], mesh, "model"):
            spec[hd_dim] = "model"
    elif leaf_name in ("k_u", "v_u"):      # [.., B, T, r]
        b_dim, t_dim = nd - 3, nd - 2
        if shape[b_dim] % dp_sz == 0 and shape[b_dim] > 1:
            spec[b_dim] = dpn
        elif seq_shard and shape[b_dim] == 1 \
                and shape[t_dim] % data_sz == 0:
            spec[t_dim] = "data"
    elif leaf_name in ("k_vt", "v_vt"):    # [.., B, r, kvw]
        b_dim, w_dim = nd - 3, nd - 1
        if shape[b_dim] % dp_sz == 0 and shape[b_dim] > 1:
            spec[b_dim] = dpn
        if _fits(shape[w_dim], mesh, "model"):
            spec[w_dim] = "model"
    elif leaf_name in ("k_u_pages", "v_u_pages"):   # [.., P, page, r]
        pass                     # pool pages replicated (shared via refs)
    elif leaf_name in ("k_pages", "v_pages"):   # [.., TP, page, kvh, hd]
        kvh_dim, hd_dim = nd - 2, nd - 1
        if _fits(shape[kvh_dim], mesh, "model") and shape[kvh_dim] > 1:
            spec[kvh_dim] = "model"
        elif _fits(shape[hd_dim], mesh, "model"):
            spec[hd_dim] = "model"
    elif leaf_name == "conv":
        b_dim, ch_dim = nd - 3, nd - 1
        if shape[b_dim] % dp_sz == 0 and shape[b_dim] > 1:
            spec[b_dim] = dpn
        if _fits(shape[ch_dim], mesh, "model"):
            spec[ch_dim] = "model"
    elif leaf_name == "ssm":
        b_dim, nh_dim = nd - 4, nd - 3
        if shape[b_dim] % dp_sz == 0 and shape[b_dim] > 1:
            spec[b_dim] = dpn
        if _fits(shape[nh_dim], mesh, "model"):
            spec[nh_dim] = "model"
    return Spec(*spec)


def cache_sharding(cache_shapes: Tree, mesh, cfg,
                   seq_shard: bool = True) -> Tree:
    """A tree of :class:`Spec` over a decode cache (rules:
    :func:`cache_pspec`)."""
    del cfg                              # rules are shape/name-driven
    return _map_named(lambda name, leaf: cache_pspec(
        name, tuple(leaf.shape), mesh, seq_shard=seq_shard), cache_shapes)


def token_sharding(mesh, batch: int) -> Spec:
    dp = dp_axes(mesh)
    if batch % axis_size(mesh, dp) == 0 and batch > 1:
        return Spec(dp_name(mesh))
    return Spec(None)


def replicated(mesh) -> Spec:
    return Spec()


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim d whose entry names it (a tuple
    entry shards d over each of its axes, major to minor, as JAX's
    ``P(("pod", "data"))`` does), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in _names(mesh))


# ---------------------------------------------------------------------------
# The DP super-axis as a process group (DeviceMesh only)
# ---------------------------------------------------------------------------

def dp_size(mesh) -> int:
    return axis_size(mesh, dp_axes(mesh))


def dp_group(mesh):
    """The process group of the DP super-axis through this rank: the
    mesh's "data" group, or ("pod", "data") flattened into one group.
    The first call on a pod mesh must be made by every rank (it creates
    the flattened group, a collective); the mesh keeps it, so later
    calls return the same group."""
    if "pod" in _names(mesh):
        return mesh["pod", "data"]._flatten().get_group()
    return mesh.get_group("data")


def dp_rank(mesh) -> int:
    """This rank's index along the DP super-axis (pod-major)."""
    import torch.distributed as dist
    return dist.get_rank(dp_group(mesh))


# Every collective of the port's serving, decomposition and train steps
# is issued by the helpers below, which count it: (op, what, global ranks
# of the group) → [calls, bytes this rank sent].  ``what`` names the
# caller's payload.
_COLLECTIVES: Dict[Tuple[str, str, Tuple[int, ...]], list] = {}


def _count(op: str, what: str, t, group) -> None:
    import torch.distributed as dist
    ranks = tuple(dist.get_process_group_ranks(
        dist.group.WORLD if group is None else group))
    c = _COLLECTIVES.setdefault((op, what, ranks), [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


def collective_counts(by_group: bool = False) -> Dict[str, Any]:
    """``"op/what"`` → (collectives issued, bytes this rank sent) since
    the last :func:`reset_collective_counts`; with ``by_group`` →
    {global ranks of the group: (issued, sent)} (what
    ``launch.roofline.collective_stats`` prices per link)."""
    out: Dict[str, Any] = {}
    for (op, what, ranks), (n, b) in sorted(_COLLECTIVES.items()):
        key = f"{op}/{what}"
        if by_group:
            out.setdefault(key, {})[ranks] = (n, b)
        else:
            n0, b0 = out.get(key, (0, 0))
            out[key] = (n0 + n, b0 + b)
    return out


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def take_collective_delta(before: Dict[tuple, list]
                          ) -> Dict[tuple, Tuple[int, int]]:
    """The collectives counted since ``before`` (a :func:`snapshot`),
    taken back out of the counts: what a CUDA graph's capture issued,
    which :func:`add_collectives` adds again on each replay."""
    delta = {}
    for k, (n, b) in _COLLECTIVES.items():
        n0, b0 = before.get(k, (0, 0))
        if n != n0:
            delta[k] = (n - n0, b - b0)
    _COLLECTIVES.clear()
    _COLLECTIVES.update({k: list(v) for k, v in before.items()})
    return delta


def snapshot() -> Dict[tuple, list]:
    """A copy of the collective counts (:func:`take_collective_delta`)."""
    return {k: list(v) for k, v in _COLLECTIVES.items()}


def add_collectives(delta) -> None:
    """Count ``delta`` (a :func:`take_collective_delta`) once more."""
    for k, (n, b) in delta.items():
        c = _COLLECTIVES.setdefault(k, [0, 0])
        c[0] += n
        c[1] += b


def all_gather_into(out, t, group, what: str) -> None:
    """``out`` ← the group's ``t`` concatenated along dim 0, in rank
    order (:func:`gather_dim` for any other dim)."""
    import torch.distributed as dist
    _count("all_gather", what, t, group)
    # torch 2.13 renames all_gather_into_tensor all_gather_single and
    # deprecates the old name; torch 2.11 has only the old name
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, t, group=group)


def all_to_all(out, t, out_rows, in_rows, group, what: str) -> None:
    """``out`` ← the rows (dim 0) the group's ranks send this rank, in
    rank order: each rank cuts its ``t`` into blocks of ``in_rows[k]``
    rows, block k for rank k, and this rank's ``out`` takes
    ``out_rows[j]`` rows from rank j (one counted all-to-all)."""
    import torch.distributed as dist
    _count("all_to_all", what, t, group)
    dist.all_to_all_single(out, t, list(out_rows), list(in_rows),
                           group=group)


def all_reduce(t, group, what: str, op: str = "sum") -> None:
    """``t`` ← its sum (or ``op``: "min", "max") over ``group``, in
    place."""
    import torch.distributed as dist
    _count("all_reduce", what, t, group)
    dist.all_reduce(t, op={"min": dist.ReduceOp.MIN,
                           "max": dist.ReduceOp.MAX}.get(
                               op, dist.ReduceOp.SUM), group=group)


def broadcast_int(v: int, group, device, what: str) -> int:
    """Rank 0's ``v`` on every rank of ``group``: a choice that reads a
    cache file or a timing must not differ between ranks, or their
    collectives would."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([int(v)], dtype=torch.int64, device=device)
    _count("broadcast", what, t, group)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return int(t.item())


def broadcast(t, group, src: int, what: str) -> None:
    """``t`` ← the ``t`` of the group's rank ``src`` (its index in the
    group), in place, on every rank of ``group``."""
    import torch.distributed as dist
    _count("broadcast", what, t, group)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)


def all_true(flags, group, device, what: str) -> list:
    """Per flag, whether it holds on every rank of ``group`` (one
    all-reduce MIN)."""
    import torch
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                     device=device)
    all_reduce(t, group, what, op="min")
    return [bool(v) for v in t.tolist()]


def model_size(mesh) -> int:
    """The size of the "model" axis (1 without a mesh)."""
    return 1 if mesh is None else mesh_axes(mesh).get("model", 1)


def model_group(mesh):
    """The process group of the "model" axis through this rank."""
    return mesh.get_group("model")


def model_rank(mesh) -> int:
    """This rank's index along the "model" axis."""
    return mesh.get_local_rank("model")


def coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's index along it} of a ``DeviceMesh``."""
    return {n: mesh.get_local_rank(n) for n in _names(mesh)}


def _entry_index(entry, mesh, where: Dict[str, int]) -> Tuple[int, int]:
    """(number of blocks, this rank's block) of a spec entry: a name, or
    a tuple of names whose blocks nest major to minor."""
    names = entry if isinstance(entry, tuple) else (entry,)
    n, i = 1, 0
    for name in names:
        size = axis_size(mesh, name)
        n, i = n * size, i * size + where[name]
    return n, i


def local_block(t, spec: Spec, mesh, where: Dict[str, int] = None):
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    view): along each named dim, block i of n equal blocks, i the rank's
    coordinate (``where``: {axis: index}, by default the mesh's own
    coordinates of this rank; a tuple entry nests its axes major to
    minor, as :func:`placements` does)."""
    where = coords(mesh) if where is None else where
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = _entry_index(entry, mesh, where)
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


def shard_params(params: Tree, mesh, cfg, where: Dict[str, int] = None
                 ) -> Tree:
    """Every leaf of the whole parameter tree ``params`` as this rank's
    block under :func:`params_sharding`: a copy of its own where the
    block is part of the leaf (so the whole tensors can be freed), the
    leaf itself where the block is all of it."""
    def one(name, leaf):
        blk = local_block(leaf, param_spec(name, tuple(leaf.shape), mesh,
                                           cfg), mesh, where)
        return leaf if blk.shape == leaf.shape else blk.clone()
    return _map_named(one, params)


def gather_dim(t, group, what: str, dim: int = 0):
    """The group's ``t`` concatenated along ``dim``, in rank order (one
    counted all-gather)."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    all_gather_into(out, src, group, what)
    return out.movedim(0, dim)


def reduce_scatter(t, group, what: str, dim: int = 0):
    """The group's sum of ``t``, this rank's block of it along ``dim``
    (one counted reduce-scatter)."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _count("reduce_scatter", what, src, group)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def axis_group(mesh, entry):
    """The process group of a spec entry: "model", "data" (the DP group
    on a single-pod mesh) or the DP super-axis."""
    if entry == "model":
        return model_group(mesh)
    if entry == "data" and "pod" in _names(mesh):
        return mesh.get_group("data")
    return dp_group(mesh)


def gather_block(t, spec: Spec, mesh, what: str):
    """The whole tensor of which ``t`` is this rank's :func:`local_block`
    under ``spec``: one all-gather per sharded dim."""
    for d, entry in enumerate(spec):
        if entry is not None and axis_size(mesh, entry) > 1:
            t = gather_dim(t, axis_group(mesh, entry), what, d)
    return t


def require_groups(mesh, what: str) -> None:
    """Refuse a mesh without process groups (a :class:`MeshShape`, or any
    object with axis names and sizes only) for ``what``, whose
    collectives run over the mesh's groups: it needs a ``DeviceMesh``
    (``launch.mesh``)."""
    if not hasattr(mesh, "get_group"):
        raise ValueError(
            f"{what} on {mesh!r}: a mesh of axis names and sizes has no "
            f"process group to run its collectives; pass a DeviceMesh "
            f"(launch.mesh.make_host_mesh)")
