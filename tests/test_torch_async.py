"""Async admission of the port (DESIGN.md §12) against the JAX package.

The recipes of ``test_serving_async.py`` and the async gate of
``test_serving_conformance.py`` on the port, reduced llama2-7b in float32
with direct-SVD factorization (decomposed KV at rank 8, tail 4, page 4,
2 slots) on weights bridged from the JAX init:

* deterministic ready order gives the sync engine's tokens — and JAX's
  — slot and paged, single-step and fused (blocks 4 and 8), under
  staggered mid-decode arrivals across tail folds;
* ``"ready"`` order on the dense family gives the sync tokens, and on
  the paged decomposed cache finishes every request with every slot and
  page back;
* ``cancel_pending`` unwinds in-flight tickets (pages and prefix refs
  back, requests requeued in arrival order, dispatch counts taken back);
* the TTFT split (queue wait + prefill) sums to the TTFT;
* an engine dropped with tickets in flight frees its cache at once;
* the done-probe and splice-if-done of ``models.api``; the refusals; the
  serve CLI's async flags.

On the host a ticket's prefill has finished when dispatch returns, so it
is ready at once; the side stream and its events are exercised on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 10).
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

RANK, TAIL, PAGE, SLOTS, MAX_LEN, MAX_NEW = 8, 4, 4, 2, 64, 10
PROMPT_LENS = (12, 7, 15, 9)

_MODEL = {}


def _model():
    """(JAX cfg, JAX params, port cfg, port params), float32, cached."""
    if not _MODEL:
        jcfg = all_archs()["llama2-7b"].reduced().replace(dtype="float32")
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        tcfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
        _MODEL["m"] = (jcfg, jp, tcfg, tp)
    return _MODEL["m"]


def _prompts(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, ln, dtype=np.int32)
            for ln in (12, 7, 15, 9, 5, 13)[:n]]


def _staggered(eng, request_cls, prompts, max_new=MAX_NEW):
    """Request 0 first, request i at step 3i (the conformance gate's)."""
    eng.submit(request_cls(uid=0, prompt=prompts[0], max_new_tokens=max_new))
    arrivals = {3 * i: i for i in range(1, len(prompts))}
    done = []
    for step in range(300):
        if step in arrivals:
            i = arrivals[step]
            eng.submit(request_cls(uid=i, prompt=prompts[i],
                                   max_new_tokens=max_new))
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: list(r.out_tokens) for r in done}


def _up_front(eng, request_cls, prompts, max_new=MAX_NEW):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: list(r.out_tokens) for r in done}


def _dkv(**kw):
    return dict(kv_rank=RANK, kv_tail=TAIL, kv_page=PAGE, kv_exact=True,
                **kw)


def _port(dkv=True, paged=False, slots=SLOTS, max_len=MAX_LEN, **kw):
    _, _, tcfg, tp = _model()
    ekw = {k: kw.pop(k) for k in list(kw) if k in (
        "kv_prefix_cache", "kv_pool_pages", "decode_block")}
    de = DecomposeEngine(EngineConfig(**(_dkv(**ekw) if dkv else ekw)))
    return Engine(tcfg, tp, slots=slots, max_len=max_len, device="cpu",
                  paged=paged, decompose_engine=de, **kw)


_JAX = {}


def _jax_sync(paged, block):
    """The JAX sync engine's tokens under the staggered schedule (a
    fused engine admits at other rounds than a single-step one under it,
    so each block length has its own)."""
    if (paged, block) not in _JAX:
        jcfg, jp, _, _ = _model()
        eng = JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN,
                      decompose_kv_rank=RANK, dkv_tail=TAIL, paged=paged,
                      decompose_engine=JDecomposeEngine(
                          JEngineConfig(**_dkv(decode_block=block))))
        _JAX[paged, block] = _staggered(eng, JRequest, _prompts())
    return _JAX[paged, block]


# -- deterministic order: the sync engine's tokens, and JAX's -------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("block", [1, 4, 8])
def test_async_deterministic_matches_sync(paged, block):
    """Through the ticket machinery in deterministic order, slot and
    paged, single-step and fused: tokens equal the port's sync engine's
    and JAX's, across tail folds; a paged engine drains clean."""
    want = _jax_sync(paged, block)
    base = _staggered(_port(paged=paged, decode_block=block), Request,
                      _prompts())
    eng = _port(paged=paged, decode_block=block, prefill_async=True,
                ready_order="deterministic")
    det = _staggered(eng, Request, _prompts())
    assert det == base == want
    assert eng.prefill_async and eng.stats.tail_folds > 0
    assert not eng._pool and not eng._reserved.any()
    assert eng.stats.prefill_inflight_peak == 0
    if paged:
        pg = eng.pager
        assert pg.alloc.free_pages == pg.num_pages - 1
        assert pg.talloc.free_pages == pg.num_tail_pages - 1


# -- ready order ---------------------------------------------------------

def test_async_ready_dense_matches_sync():
    """Ready order on the dense family: rows never interact, so the
    tokens are the sync engine's (and JAX's) though tickets complete a
    step later."""
    jcfg, jp, _, _ = _model()
    want = _up_front(JEngine(jcfg, jp, slots=4, max_len=MAX_LEN), JRequest,
                     _prompts(2))
    eng = _port(dkv=False, slots=4, prefill_async=True, ready_order="ready")
    got = _up_front(eng, Request, _prompts(2))
    assert got == want
    assert eng.stats.prefill_inflight_peak >= 1


def test_async_ready_paged_finishes_and_conserves():
    """Ready order on the paged decomposed cache: every request finishes,
    the pool really held tickets, and every slot and page comes back;
    the dispatch log covers each request once."""
    eng = _port(paged=True, prefill_async=True, ready_order="ready")
    toks = _up_front(eng, Request, _prompts(6), max_new=5)
    assert all(len(v) >= 1 for v in toks.values())
    assert eng.stats.prefill_inflight_peak >= 1
    assert not eng._pool and not eng._reserved.any()
    pg = eng.pager
    assert pg.alloc.free_pages == pg.num_pages - 1
    assert pg.talloc.free_pages == pg.num_tail_pages - 1
    assert sorted(eng.admit_log) == list(range(6))


def test_cancel_pending_unwinds_tickets():
    """Cancelled tickets give back their slots, their pages and prefix
    refs (each once), their requests in arrival order and their dispatch
    counts; the requeued requests then complete."""
    eng = _port(paged=True, max_len=48, kv_prefix_cache=4,
                prefill_async=True, ready_order="ready")
    for i, p in enumerate(_prompts(2, seed=3)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    eng._admit()                          # dispatch only
    assert eng._pool and eng._reserved.any()
    assert eng.cancel_pending() == 2
    assert not eng._pool and not eng._reserved.any()
    assert [r.uid for r in eng.sched._q] == [0, 1]
    assert eng.stats.prefills == 0 and eng.admit_log == []
    pg = eng.pager
    assert all(not b for b in pg.bt_u + pg.bt_t)   # nothing installed
    pg.prefix.drop_all()
    assert pg.alloc.free_pages == pg.num_pages - 1
    assert pg.talloc.free_pages == pg.num_tail_pages - 1
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1]
    assert eng.stats.prefills == 2


def test_cancel_pending_without_requeue_drops_requests():
    eng = _port(dkv=False, prefill_async=True, ready_order="ready")
    for i, p in enumerate(_prompts(2)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    eng._admit()
    assert eng.cancel_pending(requeue=False) == 2
    assert not len(eng.sched) and not eng._occupied()
    assert eng.run() == []


def test_ttft_split_consistent():
    for kw in ({}, dict(prefill_async=True, ready_order="ready")):
        eng = _port(dkv=False, **kw)
        _up_front(eng, Request, _prompts(4))
        s = eng.stats
        assert len(s.ttft_queue_s) == len(s.ttft_compute_s) == len(s.ttft_s)
        for q, c, t in zip(s.ttft_queue_s, s.ttft_compute_s, s.ttft_s):
            assert q >= 0.0 and c >= 0.0
            assert abs((q + c) - t) < 1e-6
        # requests queued behind full slots waited
        assert max(s.ttft_queue_s) > 0.0


def test_dropped_engine_with_tickets_in_flight_frees_without_gc():
    """Tickets hold the family (and through it a weak proxy of the
    engine), never the engine itself: with the cyclic collector off,
    ``del eng`` with tickets in the pool frees the engine, its cache and
    the tickets' fresh rows at once."""
    gc.collect()
    gc.disable()
    try:
        eng = _port(prefill_async=True, ready_order="ready")
        for i, p in enumerate(_prompts(2)):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
        eng._admit()
        assert eng._pool
        closure = [c.cell_contents for t in eng._pool
                   for c in t.complete.__closure__]
        fresh = [v for v in closure if isinstance(v, dict)]
        leaves = [t for f in fresh for t in api.tree_leaves(f)]
        assert leaves
        refs = [weakref.ref(t) for t in leaves] + [weakref.ref(eng)]
        del eng, closure, fresh, leaves
        dead = [r() is None for r in refs]
    finally:
        gc.enable()
    assert all(dead), f"{dead.count(False)} of {len(dead)} still alive"


# -- api probe and splice; refusals; CLI ----------------------------------

def test_tree_ready_and_splice_on_ready():
    _, _, tcfg, _ = _model()
    assert api.tree_ready({"a": np.zeros(3), "b": 1.0, "c": torch.ones(2)})
    assert api.tree_ready(None)
    fns = api.model_fns(tcfg)
    old = fns.init_cache(tcfg, 4, 8)
    new = {k: v + 1 for k, v in fns.init_cache(tcfg, 2, 8).items()}
    out = api.splice_on_ready(tcfg, old, new, [1, 3])
    assert out is old
    assert bool((old["k"][:, [1, 3]] == 1).all())
    assert bool((old["k"][:, [0, 2]] == 0).all())


def test_async_refusals():
    with pytest.raises(ValueError, match="per slot"):
        _port(dkv=False, prefill_async=True, admission="gang")
    with pytest.raises(ValueError, match="ready_order"):
        _port(dkv=False, prefill_async=True, ready_order="fifo")
    with pytest.raises(ValueError, match="prefill_async"):
        EngineConfig(prefill_async="yes")
    # the engine config's flag is the default; the argument wins
    _, _, tcfg, tp = _model()
    eng = Engine(tcfg, tp, slots=2, max_len=MAX_LEN, device="cpu",
                 decompose_engine=DecomposeEngine(
                     EngineConfig(prefill_async=True)))
    assert eng.prefill_async and eng.prefill_stream is None
    assert not Engine(tcfg, tp, slots=2, max_len=MAX_LEN, device="cpu",
                      prefill_async=False, decompose_engine=DecomposeEngine(
                          EngineConfig(prefill_async=True))).prefill_async


@pytest.mark.parametrize("arch,extra", [
    ("olmoe-1b-7b", ["--decode-block", "4"]),
    ("zamba2-1.2b", []),
    ("llama2-7b", ["--decompose-kv-rank", "8", "--dkv-tail", "4",
                   "--paged", "--kv-page", "4"]),
])
def test_serve_cli_async_flags(capsys, arch, extra):
    """``--prefill-async --ready-order deterministic`` gives the sync
    run's tokens; the new archs serve ``--reduced`` on the host."""
    from repro_torch.launch import serve
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-new", "4", "--prompt-len", "12"] + extra
    serve.main(base)
    sync = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("req ")]
    serve.main(base + ["--prefill-async", "--ready-order", "deterministic"])
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("req ")] == sync
    assert "prefill_async=True ready_order=deterministic" in out
    assert "queue" in out and "inflight_peak=0" in out


def test_serve_cli_refuses_full_kimi():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "kimi-k2-1t-a32b", "--device", "cpu"])
