"""Paged decomposed-KV serving of the port against the JAX package.

Host page logic (``PageAllocator``, ``PrefixCache``) runs one operation
sequence on both packages; the paged cache functions take the same numpy
inputs on both (gathers and scatters bit for bit, decode / fold / suffix
prefill allclose); the paged statistics' plain version is held against
the Pallas paged kernel in interpret mode; and the engine recipes of
``test_serving_conformance.py`` (paged vs slot engine, prefix cache) run
on both packages with bridged weights in float32 (ROADMAP C: bf16 greedy
near-ties differ between the frameworks), Lanczos cases with JAX's start
vector injected.  Greedy tokens must be equal to JAX's AND to the port's
own slot engine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decomposed_kv as JDK, model_fns  # noqa: E402
from repro.serving import (Engine as JEngine, Request as JRequest,  # noqa: E402
                           paged as jpaged)
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.kernels import dkv_attention as dk  # noqa: E402
from repro_torch.models import decomposed_kv as DK  # noqa: E402
from repro_torch.serving import Engine, Request, paged as tpaged  # noqa: E402

MAX_LEN = 64
TOL = dict(rtol=1e-4, atol=1e-4)   # float32, reduction orders differ
LOGITS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def f32():
    jcfg = all_archs()["deepseek-7b"].reduced().replace(dtype="float32")
    params = model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    tcfg = get_arch("deepseek-7b").reduced().replace(dtype="float32")
    return jcfg, params, tcfg, tparams


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# Host page logic
# ---------------------------------------------------------------------------

def _host_ops(mod):
    """One operation sequence on a package's allocator + prefix cache;
    returns everything observable along the way."""
    log = []
    alloc = mod.PageAllocator(24)
    pc = mod.PrefixCache(2, 4, alloc)
    rng = np.random.RandomState(5)
    sys_p = rng.randint(1, 50, 12).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.randint(1, 50, 4)]).astype(
        np.int32) for _ in range(3)]
    other = rng.randint(1, 50, 16).astype(np.int32)
    short = [np.concatenate([np.zeros(12, np.int32),
                             rng.randint(1, 50, 4).astype(np.int32)])
             for _ in range(2)]

    def snap(tag):
        log.append((tag, alloc.free_pages, sorted(alloc.live_refs.items()),
                    len(pc), pc.hits, pc.misses, pc.evictions))

    def look(p, n_pad=0, max_suffix=8, record=True):
        got = pc.lookup(p, max_suffix, n_pad, record=record)
        log.append(("lookup", None if got is None
                    else (got[0].tokens.tolist(), got[1])))

    pages0 = alloc.alloc(4)
    log.append(("alloc", pages0))
    pc.insert(prompts[0], pages0, None, None, 6)
    snap("insert0")
    look(prompts[1])                        # hit on the system prompt
    look(prompts[0])                        # whole-prompt boundary
    look(other)                             # miss
    look(prompts[1], record=False)          # unrecorded
    look(prompts[1], max_suffix=2)          # suffix too long: miss
    pages1 = alloc.alloc(4)
    pc.insert(other, pages1, None, None, 6)
    alloc.ref(pages0[:2])
    snap("ref")
    pages2 = alloc.alloc(4)
    pc.insert(prompts[2], pages2, None, None, 6)   # capacity 2: evicts
    snap("evict")
    look(prompts[1])
    look(other)
    # two unrelated short prompts share only their 12 left-pad rows: a
    # boundary inside the padding must never match
    pages3 = alloc.alloc(4)
    pc.insert(short[0], pages3, None, None, 6, n_pad=12)
    look(short[1], n_pad=12)
    look(short[0], n_pad=12)
    snap("short")
    for ps in (pages0, pages1, pages2, pages3, pages0[:2]):
        alloc.release(ps)
    snap("release")
    assert alloc.alloc(40) is None
    with pytest.raises(ValueError):
        alloc.release([pages0[3]])
    pc.drop_all()
    snap("drop")
    return log


def test_page_allocator_and_prefix_cache_match_jax():
    got, want = _host_ops(tpaged), _host_ops(jpaged)
    assert got == want
    assert got[-1][1] == 23                 # every page back
    lookups = [e[1] for e in got if e[0] == "lookup"]
    assert lookups[-2] is None              # pad-only boundary: a miss


# ---------------------------------------------------------------------------
# Page gathers / scatters
# ---------------------------------------------------------------------------

def _pool(rng, nl, p, page, *rest):
    pool = rng.randn(nl, p, page, *rest).astype(np.float32)
    pool[:, 0] = 0.0                        # the sink
    return pool


def test_gather_scatter_write_prefix_pages_match_jax():
    rng = np.random.RandomState(2)
    nl, P, page, r = 2, 10, 4, 6
    pool = _pool(rng, nl, P, page, r)
    bt = np.array([[7, 2, 9], [4, 0, 0], [1, 3, 0]], np.int32)
    for rows in (None, 5, 12, 17):
        np.testing.assert_array_equal(
            DK.gather_pages(_t(pool), _t(bt), rows).numpy(),
            np.asarray(JDK.gather_pages(jnp.asarray(pool), jnp.asarray(bt),
                                        rows)))
    # scatter: fresh rows for the slots' own pages, zeros where the table
    # points at the sink (the reference's contract)
    rows = rng.randn(nl, 3, 10, r).astype(np.float32)
    rows[:, 1, 4:] = 0.0
    rows[:, 2, 8:] = 0.0
    got = DK.scatter_pages(_t(pool.copy()), _t(rows), _t(bt)).numpy()
    want = np.asarray(JDK.scatter_pages(jnp.asarray(pool), jnp.asarray(rows),
                                        jnp.asarray(bt)))
    np.testing.assert_array_equal(got, want)
    assert not got[:, 0].any()
    # write_prefix_pages: batch rows ``src`` of a fresh u at rank 4 < 6
    u = rng.randn(nl, 4, 11, 4).astype(np.float32)
    src = np.array([3, 1], np.int32)
    bt2 = np.array([[5, 6, 8], [2, 9, 1]], np.int32)
    got = DK.write_prefix_pages(_t(pool.copy()), _t(u), _t(bt2),
                                _t(src)).numpy()
    want = np.asarray(JDK.write_prefix_pages(
        jnp.asarray(pool), jnp.asarray(u), jnp.asarray(bt2),
        jnp.asarray(src)))
    np.testing.assert_array_equal(got, want)
    assert not got[:, 0].any()


# ---------------------------------------------------------------------------
# Paged statistics: plain version vs the Pallas paged kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perm_seed,t_valid,page", [
    (0, (32, 27, 9), 8), (1, (27, 9, 32), 8), (2, (9, 32, 0), 12)])
def test_paged_stats_plain_matches_pallas_paged(perm_seed, t_valid, page):
    """Per (slot, kv-head), the port's paged plain version == the Pallas
    paged kernel (interpret mode) on the slot's block-table row with its
    static t_valid: permuted page ids, a partial last page, t_valid 32,
    27, 9 (and 0), r = 12 read of r_pool = 16.  It is the port's slab
    plain version on the gathered rows, exactly."""
    rng = np.random.RandomState(50 + perm_seed)
    P, kvh, g, r_pool, r = 14, 2, 2, 16, 12
    n = -(-32 // page)
    b = len(t_valid)
    k_pool = rng.randn(P, page, r_pool).astype(np.float32)
    v_pool = rng.randn(P, page, r_pool).astype(np.float32)
    inner = rng.randn(b, kvh * g, r).astype(np.float32)
    ids = rng.permutation(np.arange(1, P))[:b * n].reshape(b, n)
    ids = ids.astype(np.int32)
    tv = np.array(t_valid, np.int32)
    a, m, l_ = dk.dkv_attention_stats_paged(
        _t(inner), _t(k_pool), _t(v_pool), _t(ids), _t(tv), r)
    for i in range(b):
        if tv[i] == 0:
            assert (a[i] == 0).all() and (l_[i] == 0).all()
            continue
        for kh in range(kvh):
            sl = slice(kh * g, (kh + 1) * g)
            aj, mj, lj = jops.dkv_attention_stats_paged(
                jnp.asarray(inner[i, sl]), jnp.asarray(k_pool[..., :r]),
                jnp.asarray(v_pool[..., :r]), jnp.asarray(ids[i]),
                t_valid=int(tv[i]), interpret=True)
            np.testing.assert_allclose(a[i, sl].numpy(), np.asarray(aj),
                                       **TOL)
            np.testing.assert_allclose(m[i, sl].numpy(),
                                       np.asarray(mj)[:, 0], **TOL)
            np.testing.assert_allclose(l_[i, sl].numpy(),
                                       np.asarray(lj)[:, 0], **TOL)
    slab = dk.dkv_attention_stats(
        _t(inner), dk.gather_rows(_t(k_pool), _t(ids), r),
        dk.gather_rows(_t(v_pool), _t(ids), r), _t(tv))
    for x, y in zip((a, m, l_), slab):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Paged decode, fold and suffix prefill
# ---------------------------------------------------------------------------

PAGE, TAIL, R_POOL = 4, 4, 8


def _paged_state(cfg, seed=4):
    """A random paged cache (sink zero) of 3 slots with block tables of 4,
    2 and 3 pages (table padding points at the sink), per-slot frozen
    lengths 13/7/10 and tails 0/2/3 rows deep; the slab mirror is
    t_need 13, r_need 6 (below the pool's rank 8)."""
    rng = np.random.RandomState(seed)
    nl, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    kvw = kvh * hd
    P, TP = 20, 8
    frozen = np.array([13, 7, 10], np.int32)
    pos = frozen + np.array([0, 2, 3], np.int32)
    bt_u = np.array([[9, 3, 14, 1], [6, 11, 0, 0], [2, 15, 8, 0]], np.int32)
    bt_t = np.array([[5], [2], [7]], np.int32)
    cache = {"k_u_pages": _pool(rng, nl, P, PAGE, R_POOL) * 0.3,
             "v_u_pages": _pool(rng, nl, P, PAGE, R_POOL),
             "k_vt": rng.randn(nl, 3, R_POOL, kvw).astype(np.float32) * 0.3,
             "v_vt": rng.randn(nl, 3, R_POOL, kvw).astype(np.float32) * 0.3,
             "tail": {"k_pages": _pool(rng, nl, TP, PAGE, kvh, hd),
                      "v_pages": _pool(rng, nl, TP, PAGE, kvh, hd)}}
    return cache, frozen, pos, bt_u, bt_t


def _to(tree, f):
    if isinstance(tree, dict):
        return {k: _to(v, f) for k, v in tree.items()}
    return f(tree)


def test_decode_step_paged_matches_jax_and_slab_step(f32):
    jcfg, jp, tcfg, tp = f32
    cache, frozen, pos, bt_u, bt_t = _paged_state(tcfg)
    tok = np.array([3, 17, 250], np.int32)
    geom = (13, 6, TAIL)
    want, wc = JDK.decode_step_dkv_paged(
        jp, jcfg, jnp.asarray(tok), _to(cache, jnp.asarray),
        jnp.asarray(pos), jnp.asarray(frozen), jnp.asarray(bt_u),
        jnp.asarray(bt_t), *geom)
    for route in ("kernel", "plain"):
        c = _to(cache, lambda x: torch.from_numpy(x.copy()))
        slab = DK._gathered_cache(c, _t(bt_u), _t(bt_t), *geom)
        got, gc = DK.decode_step_dkv_paged(
            tp, tcfg, _t(tok).long(), c, _t(pos), _t(frozen), _t(bt_u),
            _t(bt_t), *geom, attention=route)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
        for key in ("k_pages", "v_pages"):       # page 0 is the tail sink
            np.testing.assert_allclose(
                gc["tail"][key][:, 1:].numpy(),
                np.asarray(wc["tail"][key])[:, 1:], **LOGITS)
        # the slot engine's step on the gathered slab, same route
        ref, _ = DK.decode_step_dkv(tp, tcfg, _t(tok).long(), slab,
                                    _t(pos), _t(frozen), attention=route)
        assert torch.equal(got, ref), route


def test_compress_tail_paged_matches_jax(f32):
    """Slots 0 and 2 fold into fresh pages, slot 1 keeps its prefix: the
    folded factors reconstruct as JAX's; the old pages are untouched and
    the sink stays zero; folded tails are zero."""
    _, _, tcfg, _ = f32
    cache, frozen, pos, bt_u, bt_t = _paged_state(tcfg)
    fold = np.array([True, False, True])
    new_frozen = np.where(fold, pos, frozen).astype(np.int32)
    bt_new = np.array([[4, 10, 12, 13], [0, 0, 0, 0], [5, 7, 16, 17]],
                      np.int32)
    args = (8, frozen, fold, new_frozen, bt_u, bt_new, bt_t, 13, 6, TAIL)
    want = JDK.compress_tail_paged(
        _to(cache, jnp.asarray), tcfg, *(jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in args))
    old = _to(cache, lambda x: torch.from_numpy(x.copy()))
    got = DK.compress_tail_paged(
        _to(cache, lambda x: torch.from_numpy(x.copy())), tcfg,
        *(_t(a) if isinstance(a, np.ndarray) else a for a in args))
    r_fold = DK.fold_rank(8, 6, 13, TAIL)
    for key in ("k", "v"):
        u_g = DK.gather_pages(got[key + "_u_pages"], _t(bt_new), 16)
        u_w = np.asarray(JDK.gather_pages(want[key + "_u_pages"],
                                          jnp.asarray(bt_new), 16))
        for s in (0, 2):
            rec_g = u_g[:, s, :, :r_fold] @ got[key + "_vt"][:, s, :r_fold]
            rec_w = u_w[:, s, :, :r_fold] @ np.asarray(
                want[key + "_vt"])[:, s, :r_fold]
            np.testing.assert_allclose(rec_g.numpy(), rec_w, **TOL)
        torch.testing.assert_close(got[key + "_vt"][:, 1],
                                   old[key + "_vt"][:, 1])
        pool = got[key + "_u_pages"]
        assert not pool[:, 0].any()              # sink stays zero
        for pid in set(bt_u.ravel()) - {0}:      # copy-on-write
            assert torch.equal(pool[:, pid], old[key + "_u_pages"][:, pid])
        tails = DK.gather_pages(got["tail"][key + "_pages"], _t(bt_t))
        assert not tails[:, [0, 2]].any()
        assert torch.equal(tails[:, 1], DK.gather_pages(
            old["tail"][key + "_pages"], _t(bt_t))[:, 1])


def test_prefill_suffix_matches_jax(f32):
    jcfg, jp, tcfg, tp = f32
    rng = np.random.RandomState(9)
    nl, kvw = tcfg.num_layers, tcfg.kv_width
    b, s, L, r = 2, 5, 12, 6
    prefix = {"k_u": rng.randn(nl, b, L, r) * 0.3,
              "v_u": rng.randn(nl, b, L, r),
              "k_vt": rng.randn(nl, b, r, kvw) * 0.3,
              "v_vt": rng.randn(nl, b, r, kvw) * 0.3}
    prefix = {k: v.astype(np.float32) for k, v in prefix.items()}
    toks = rng.randint(0, tcfg.vocab, (b, s)).astype(np.int32)
    start = np.array([12, 8], np.int32)
    slen = np.array([5, 3], np.int32)
    want, wt = JDK.prefill_suffix_dkv(jp, jcfg, jnp.asarray(toks),
                                      _to(prefix, jnp.asarray),
                                      jnp.asarray(start), jnp.asarray(slen),
                                      8)
    got, gt = DK.prefill_suffix_dkv(tp, tcfg, _t(toks).long(),
                                    _to(prefix, torch.from_numpy), start,
                                    slen, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    for key in ("k", "v"):
        np.testing.assert_allclose(gt[key].numpy(), np.asarray(wt[key]),
                                   **LOGITS)
        assert not gt[key][:, 1, 3:].any()       # pad rows zeroed


# ---------------------------------------------------------------------------
# Engine recipes (test_serving_conformance.py), on both packages
# ---------------------------------------------------------------------------

Z0 = lambda h: np.asarray(_padded_z0(h, h))   # noqa: E731


def _engines(f32, *, slots, rank, tail, exact=False, prefix=0, pool=0,
             paged=True):
    """(JAX engine, port engine) at the same settings."""
    jcfg, jp, tcfg, tp = f32
    kw = dict(kv_rank=rank, kv_tail=tail, kv_page=4, kv_exact=exact,
              kv_prefix_cache=prefix, kv_pool_pages=pool)
    je = JEngine(jcfg, jp, slots=slots, max_len=MAX_LEN,
                 decompose_kv_rank=rank, dkv_tail=tail, dkv_exact=exact,
                 decompose_engine=JDecomposeEngine(JEngineConfig(**kw)),
                 paged=paged)
    te = Engine(tcfg, tp, slots=slots, max_len=MAX_LEN, device="cpu",
                decompose_engine=DecomposeEngine(EngineConfig(**kw), z0=Z0),
                paged=paged)
    return je, te


def _run(eng, req_cls, arrivals, max_new):
    """Submit ``arrivals`` {step: [(uid, prompt), ...]} and step until
    every request finished."""
    n = sum(len(v) for v in arrivals.values())
    done = []
    for step in range(300):
        for uid, p in arrivals.get(step, []):
            eng.submit(req_cls(uid=uid, prompt=p,
                               max_new_tokens=max_new(uid)))
        done.extend(eng.step())
        if len(done) == n and not any(eng.live):
            break
    assert sorted(r.uid for r in done) == list(range(n))
    return {r.uid: r.out_tokens for r in done}


def _pages_back(eng):
    pg = eng.pager
    assert pg.alloc.free_pages == pg.num_pages - 1
    assert pg.talloc.free_pages == pg.num_tail_pages - 1


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


def _slot_vs_paged(f32, arrivals, max_new, **kw):
    """Tokens of the JAX paged engine, the port's paged engine and the
    port's slot engine; returns the port's paged engine."""
    je, te = _engines(f32, **kw)
    want = _run(je, JRequest, arrivals, max_new)
    got = _run(te, Request, arrivals, max_new)
    _, slot = _engines(f32, paged=False, **kw)
    slot_toks = _run(slot, Request, arrivals, max_new)
    assert te.stats.tail_folds > 0
    assert got == want, f"port {got} != JAX {want}"
    assert got == slot_toks, f"paged {got} != slot {slot_toks}"
    _pages_back(te)
    _pages_back(je)
    return te


def test_paged_matches_slot_engine_staggered(f32):
    """Rank 8 (folds are real retruncations), staggered mid-decode
    admissions, 2 slots, Lanczos with the reference z0."""
    ps = _prompts(f32[0].vocab, (12, 7, 15))
    arrivals = {3 * i: [(i, p)] for i, p in enumerate(ps)}
    _slot_vs_paged(f32, arrivals, lambda u: 12, slots=2, rank=8, tail=4)


def test_paged_matches_slot_engine_batched(f32):
    """All requests in one admission, slots > len(queue)."""
    ps = _prompts(f32[0].vocab, (12, 7, 15))
    arrivals = {0: list(enumerate(ps))}
    _slot_vs_paged(f32, arrivals, lambda u: 12, slots=4, rank=8, tail=4)


def test_paged_matches_slot_engine_mixed_page_counts(f32):
    """Admissions from two buckets (4 vs 8 pages per slot): decode and
    folds read the sink through the shorter table's padding."""
    rng = np.random.RandomState(7)
    p0 = rng.randint(0, f32[0].vocab, 12, dtype=np.int32)
    p1 = rng.randint(0, f32[0].vocab, 20, dtype=np.int32)
    te = _slot_vs_paged(f32, {0: [(0, p0)], 3: [(1, p1)]},
                        lambda u: 20 if u == 0 else 8, slots=2, rank=8,
                        tail=4)
    assert te.stats.tail_folds >= 2


PREFIX = dict(rank=48, tail=8, exact=True)


def _shared_prompts(vocab, n=4):
    rng = np.random.RandomState(1)
    sys_p = rng.randint(0, vocab, 12, dtype=np.int32)
    return [np.concatenate([sys_p, rng.randint(0, vocab, 3,
                                               dtype=np.int32)])
            for _ in range(n)]


def _stats(eng):
    pc = eng.pager.prefix
    return (eng.stats.prefix_hits, eng.stats.prefix_misses,
            pc.hits, pc.misses, pc.evictions, len(pc))


def test_paged_prefix_cache_hit_miss_evict(f32):
    """A shared system prompt: later arrivals admit as hits; tokens equal
    with the cache on and off, and JAX's; capacity 1 forces LRU
    evictions; cached pages outlive their slots until ``drop_all``."""
    ps = _shared_prompts(f32[0].vocab)
    arrivals = {0: list(enumerate(ps))}
    new = lambda u: 8   # noqa: E731
    _, off_e = _engines(f32, slots=2, prefix=0, **PREFIX)
    off = _run(off_e, Request, arrivals, new)
    for cap in (8, 1):
        je, te = _engines(f32, slots=2, prefix=cap, **PREFIX)
        want = _run(je, JRequest, arrivals, new)
        got = _run(te, Request, arrivals, new)
        assert got == want == off
        assert _stats(te) == _stats(je)
        pg = te.pager
        if cap == 8:
            assert te.stats.prefix_hits >= 2 and te.stats.prefix_misses >= 1
            used = pg.num_pages - 1 - pg.alloc.free_pages
            assert used == sum(len(e.pages)
                               for e in pg.prefix._entries.values())
        else:
            assert pg.prefix.evictions >= 1 and len(pg.prefix) == 1
        pg.prefix.drop_all()
        je.pager.prefix.drop_all()
        _pages_back(te)


def test_paged_prefix_hit_skips_prefill_work(f32):
    """A full-page hit admits with tail-only work: no decompose_kv call,
    and the slot's prefix pages ARE the cached entry's (refcount ≥ 2)."""
    prompt = np.random.RandomState(1).randint(0, f32[0].vocab, 15,
                                              dtype=np.int32)
    je, te = _engines(f32, slots=2, prefix=4, **PREFIX)
    calls = []
    orig = te.dengine.decompose_kv

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    te.dengine.decompose_kv = counted
    toks = {}
    for eng, req in ((je, JRequest), (te, Request)):
        eng.submit(req(uid=0, prompt=prompt, max_new_tokens=4))
        eng.run()
        assert eng.stats.prefix_misses == 1
        eng.submit(req(uid=1, prompt=prompt.copy(), max_new_tokens=4))
        n_calls = len(calls)
        eng.step()                               # the hit lands
        assert eng.stats.prefix_hits == 1
        if eng is te:
            assert len(calls) == n_calls == 2    # K and V of the miss only
        slot = next(i for i, r in enumerate(eng.live) if r is not None)
        shared = list(eng.pager.bt_u[slot])
        refs = eng.pager.alloc.live_refs
        assert shared and all(refs[p] >= 2 for p in shared)
        toks[eng is te] = {r.uid: r.out_tokens for r in eng.run()}
    assert toks[True] == toks[False]


def test_paged_hit_survives_same_batch_eviction(f32):
    """One batch: a hit on the LRU entry plus a miss whose insertion
    evicts it (capacity 1); the hit holds its own page refs."""
    rng = np.random.RandomState(1)
    p1 = rng.randint(0, f32[0].vocab, 15, dtype=np.int32)
    p2 = rng.randint(0, f32[0].vocab, 15, dtype=np.int32)
    out = {}
    for eng_i, req_cls in zip(_engines(f32, slots=2, prefix=1, **PREFIX),
                              (JRequest, Request)):
        eng_i.submit(req_cls(uid=0, prompt=p1, max_new_tokens=4))
        eng_i.run()
        eng_i.submit(req_cls(uid=1, prompt=p1.copy(), max_new_tokens=6))
        eng_i.submit(req_cls(uid=2, prompt=p2, max_new_tokens=6))
        done = {r.uid: r.out_tokens for r in eng_i.run()}
        assert eng_i.stats.prefix_hits == 1
        assert eng_i.pager.prefix.evictions >= 1
        assert len(done[1]) == 6 and len(done[2]) == 6
        out[req_cls] = (done, _stats(eng_i))
        eng_i.pager.prefix.drop_all()
        _pages_back(eng_i)
    assert out[Request] == out[JRequest]


def test_paged_capacity_error_with_nothing_live(f32):
    """A prompt whose pages can never fit, with nothing live to free
    any: both packages raise instead of stalling forever."""
    prompt = np.arange(15, dtype=np.int32)
    for eng, req in zip(_engines(f32, slots=2, rank=8, tail=4, pool=3),
                        (JRequest, Request)):
        eng.submit(req(uid=0, prompt=prompt, max_new_tokens=4))
        with pytest.raises(RuntimeError, match="page capacity"):
            eng.run()
        assert eng.stats.stalls == 1
