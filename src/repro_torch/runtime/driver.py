"""Fault-tolerant training driver.

Counterpart of ``repro.runtime.driver``:

* checkpoint/restart: atomic saves every ``ckpt_every`` steps through the
  async checkpointer; on (re)start the driver restores the LATEST
  checkpoint and the data pipeline replays from the step after it (a
  batch is a pure function of its step, ``repro_torch.data``);
* failure injection: ``failure_hook(step)`` raising
  :class:`SimulatedFailure` exercises the restart path in-process;
* straggler watchdog: an EWMA of step wall times; a step slower than
  ``threshold × ewma`` is flagged and counted;
* elastic re-mesh: :func:`restore_for_mesh` re-shards any checkpoint onto
  a new mesh (``checkpoint.restore(mesh=, placements=)``); a step on a
  "model" axis larger than 1 or with ``zero1`` takes its result as it
  is (the
  DTensors' local blocks: ``params_sharding``'s and ZeRO-1's), a plain
  data-parallel step resumes from :func:`unshard` of it.  With ``mesh=``
  :func:`train_loop` trains on the mesh and saves the whole state
  (gathered from the blocks, written by rank 0), so a run saved on one
  mesh restarts on any other.

A step's wall time ends at the loss's read-back (one host read a step,
as in the reference).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from .. import checkpoint as ckpt
from ..configs import ArchConfig, ShapeSpec
from ..data import DataConfig, Prefetcher, SyntheticLM
from ..optim import make_optimizer
from ..platform import resolve_device
from ..tree import tree_map
from . import steps as steps_mod

Tree = Any


class SimulatedFailure(RuntimeError):
    """Raised by failure hooks to exercise checkpoint/restart."""


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags steps slower than ``threshold ×
    ewma`` (the step's own time enters the EWMA after the test)."""
    alpha: float = 0.1
    threshold: float = 2.5
    ewma: Optional[float] = None
    flagged: int = 0
    history: List[float] = dataclasses.field(default_factory=list)

    def observe(self, dt: float) -> bool:
        self.history.append(dt)
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged += 1
        return slow


@dataclasses.dataclass
class TrainLoopResult:
    step: int
    losses: List[float]
    restarts: int
    straggler_flags: int
    ckpt_bytes: int = 0              # bytes of every checkpoint written


def to_device(batch, device) -> dict:
    """A numpy batch as tensors on ``device``: integer arrays as int64
    (token ids index the embedding), float arrays as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def train_loop(cfg: ArchConfig, shape: ShapeSpec, *, total_steps: int,
               ckpt_dir: str, ckpt_every: int = 20, keep: int = 2,
               seed: int = 0, log_every: int = 10,
               failure_hook: Optional[Callable[[int], None]] = None,
               max_restarts: int = 3,
               print_fn: Callable[[str], None] = print,
               device=None, backend: str = "cuda", optimizer=None,
               init_params: Optional[Callable[[], Tree]] = None,
               mesh=None, zero1: bool = False) -> TrainLoopResult:
    """Run (or resume) training with checkpoint/restart until
    ``total_steps``.  The state starts from the latest checkpoint under
    ``ckpt_dir``, else from ``init_params()`` (default: the family's
    init from ``torch.Generator`` seeded ``seed`` on ``device``; a test
    passes the reference's weights) and ``optimizer.init`` (default:
    ``make_optimizer(cfg)``).  Every step's loss is appended, a replayed
    step's again; the final state is saved as the last step's
    checkpoint.  With ``mesh`` every rank runs the loop on its blocks
    (``steps.make_train_step(mesh=, zero1=)``), restores
    through :func:`restore_for_mesh` and saves synchronously
    (:func:`save_for_mesh`)."""
    dev = resolve_device(device)
    opt = optimizer or make_optimizer(cfg)
    train_step = steps_mod.make_train_step(
        cfg, opt, backend=backend, mesh=mesh, zero1=zero1)
    on = dict(zero1=zero1, optimizer=opt)
    sharded = mesh is not None and (
        zero1 or steps_mod._tp_mesh(mesh, cfg) is not None)

    def save_now(state, step):
        if mesh is None:
            ckpt.save(state, ckpt_dir, step)
            return ckpt.tree_bytes(state)
        return save_for_mesh(cfg, state, ckpt_dir, step, mesh, **on)
    restarts = 0
    losses: List[float] = []
    watchdog = StragglerWatchdog()
    written = 0
    saver = prefetch = None

    while True:
        try:
            # ---- (re)start: restore the latest checkpoint or init --------
            start = ckpt.latest_step(ckpt_dir)
            if start is not None and mesh is not None:
                state = restore_for_mesh(cfg, ckpt_dir, mesh, optimizer=opt)
                state = steps_mod.local_blocks(state) if sharded \
                    else unshard(state)
                params, opt_state = state["params"], state["opt"]
                start += 1
                print_fn(f"[driver] restored step {start - 1}; resuming")
            elif start is not None:
                t_params, t_opt = steps_mod.abstract_train_state(cfg, opt)
                state = ckpt.restore({"params": t_params, "opt": t_opt},
                                     ckpt_dir, device=dev)
                params, opt_state = state["params"], state["opt"]
                start += 1
                print_fn(f"[driver] restored step {start - 1}; resuming")
            elif init_params is not None:
                params = init_params()
                opt_state = opt.init(params)
                start = 0
            else:
                gen = torch.Generator(device=dev).manual_seed(seed)
                params, opt_state = steps_mod.init_train_state(cfg, gen, opt,
                                                               dev)
                start = 0
            if start == 0 and sharded:
                params, opt_state = steps_mod.shard_train_state(
                    cfg, params, opt_state, mesh, **on)

            source = SyntheticLM(cfg, shape, DataConfig(seed=seed))
            prefetch = Prefetcher(source, start_step=start)
            saver = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep)

            for step, batch in prefetch:
                if step >= total_steps:
                    prefetch.stop()
                    saver.wait()
                    written += saver.bytes_written
                    written += save_now({"params": params, "opt": opt_state},
                                        step - 1)
                    return TrainLoopResult(step, losses, restarts,
                                           watchdog.flagged, written)
                if failure_hook is not None:
                    failure_hook(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = train_step(
                    params, opt_state, to_device(batch, dev))
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                if watchdog.observe(dt):
                    print_fn(f"[watchdog] straggler step {step}: "
                             f"{dt:.2f}s vs ewma {watchdog.ewma:.2f}s")
                losses.append(loss)
                if step % log_every == 0:
                    print_fn(f"[train] step {step} loss {loss:.4f} "
                             f"({dt * 1e3:.0f} ms)")
                if step % ckpt_every == ckpt_every - 1 and mesh is not None:
                    written += save_now({"params": params, "opt": opt_state},
                                        step)
                elif step % ckpt_every == ckpt_every - 1:
                    saver.save({"params": params, "opt": opt_state}, step)

        except SimulatedFailure as e:
            restarts += 1
            print_fn(f"[driver] failure at restart #{restarts}: {e}")
            if prefetch is not None:
                prefetch.stop()
            # drain the in-flight async save BEFORE the restart reads the
            # checkpoint directory (its write errors are moot: restarting)
            if saver is not None:
                try:
                    saver.wait()
                except Exception as err:
                    print_fn(f"[driver] in-flight save dropped: {err}")
                written += saver.bytes_written
            if restarts > max_restarts:
                raise
            continue


def save_for_mesh(cfg: ArchConfig, state: Tree, ckpt_dir: str, step: int,
                  mesh, **on) -> int:
    """Save a train state held as blocks on ``mesh`` (``on``: the step's
    ``zero1`` and ``optimizer``) as whole leaves: every
    rank gathers, rank 0 writes, all wait for it.  Returns the bytes
    written (0 on the other ranks)."""
    import torch.distributed as dist
    if on.get("zero1") or steps_mod._tp_mesh(mesh, cfg) is not None:
        params, opt_state = steps_mod.whole_train_state(
            cfg, state["params"], state["opt"], mesh, **on)
    else:
        params, opt_state = state["params"], state["opt"]
    whole = {"params": params, "opt": opt_state}
    n = 0
    if dist.get_rank() == 0:
        ckpt.save(whole, ckpt_dir, step)
        n = ckpt.tree_bytes(whole)
    dist.barrier()
    return n


def restore_for_mesh(cfg: ArchConfig, ckpt_dir: str, mesh, *,
                     optimizer=None) -> Tree:
    """Elastic restore: the latest checkpoint of ``ckpt_dir`` RE-SHARDED
    for ``mesh`` — ``{"params", "opt"}`` of DTensors placed by
    ``params_sharding`` / ``opt_state_sharding`` (ZeRO-1 on; a leaf whose
    ZeRO-1 spec names "data" twice keeps its parameter's block,
    ``sharding.zero1_block_spec``; Adafactor's vr, vc and v their own).
    The mesh it was saved on (or none) does not matter: every leaf is rebuilt
    from its host copy (the reference's ``restore_for_mesh``).  A step
    on a "model" axis larger than 1 or with ``zero1`` takes this as it
    is (its leaves' local blocks); a plain data-parallel step, which
    holds whole state on every rank, resumes from :func:`unshard` of
    this."""
    from ..distributed import sharding as sh
    opt = optimizer or make_optimizer(cfg)
    params_abs, opt_abs = steps_mod.abstract_train_state(cfg, opt)
    template = {"params": params_abs, "opt": opt_abs}
    # the ZeRO-1 step's blocks: opt_state_sharding's, but a leaf whose
    # spec names "data" twice keeps the parameter's block (caveat C10)
    specs = {"params": sh.params_sharding(params_abs, mesh, cfg),
             "opt": sh._map_named(lambda n, t: sh.zero1_block_spec(
                 n, tuple(t.shape), mesh, cfg), opt_abs)}
    # mapped over the template: a Spec is a tuple, not a subtree
    placements = tree_map(lambda _, sp: sh.placements(sp, mesh), template,
                          specs)
    return ckpt.restore(template, ckpt_dir, mesh=mesh, placements=placements)


def unshard(tree: Tree) -> Tree:
    """Every DTensor leaf of ``tree`` as its full tensor on this rank (an
    all-gather where the leaf is sharded, as a ZeRO-1 moment is), any
    other leaf as it is: the state ``steps.make_train_step(mesh=)``
    takes, whole parameters and optimizer state on every rank."""
    return tree_map(ckpt.whole, tree)
