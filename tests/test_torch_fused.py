"""The fused decode block and the serving-engine parity of the port,
against the JAX package.

The recipes of ``test_serving_conformance.py``'s fused-decode section
(reduced deepseek-7b, decomposed KV at rank 8, tail 4, page 4, 2 slots,
max_len 64, prompts of 12/7/15 tokens submitted up front, 12 new tokens)
and of its family section (reduced mamba2-780m) run on both packages with
the same bridged weights, in float32, with direct-SVD factorization: the
port's fused engine must give the JAX engine's tokens and counters, and
its own single-step engine's.  On the host the fused block runs eagerly
through the same static buffers and masks the card's CUDA graphs read
(``serving.graphs``).  Also here: ``run_decode_block`` against the
reference on a toy step, halted steps that change no state, stop tokens
and stop reasons, the scheduler's admission cap and cost hook
(hypothesis), gang admission and the serve CLI's new flags.
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
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.models import api as japi, model_fns as jmodel_fns  # noqa: E402
from repro.serving import (Engine as JEngine, Request as JRequest,  # noqa: E402
                           Scheduler as JScheduler, greedy_sampler)
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Engine, Request, Scheduler  # noqa: E402

RANK, TAIL, PAGE, SLOTS, MAX_LEN, MAX_NEW = 8, 4, 4, 2, 64, 12
PROMPT_LENS = (12, 7, 15)
FUSED_BLOCKS = (2, 3, 8, 32)
FAM_PROMPT_LENS, FAM_NEW, FAM_MAX_LEN = (7, 12, 19, 5), 12, 96

_MODELS = {}


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params), float32, cached."""
    if arch not in _MODELS:
        jcfg = all_archs()[arch].reduced().replace(dtype="float32")
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        tcfg = get_arch(arch).reduced().replace(dtype="float32")
        _MODELS[arch] = (jcfg, jp, tcfg, tp)
    return _MODELS[arch]


def _prompts(vocab, lens=PROMPT_LENS):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


def _run(eng, request_cls, prompts, max_new=MAX_NEW):
    """Every prompt up front; later requests admit as slots free."""
    for i, p in enumerate(prompts):
        eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r.out_tokens for r in done}, eng


def _dkv_kw(block, **extra):
    return dict(kv_rank=RANK, kv_tail=TAIL, kv_page=PAGE, kv_exact=True,
                decode_block=block, **extra)


def _jax_dkv(block, paged=False, eos=None, slots=SLOTS, **extra):
    jcfg, jp, _, _ = _models("deepseek-7b")
    eng = JEngine(jcfg, jp, slots=slots, max_len=MAX_LEN, eos_id=eos,
                  decompose_kv_rank=RANK, dkv_tail=TAIL, paged=paged,
                  decompose_engine=JDecomposeEngine(
                      JEngineConfig(**_dkv_kw(block, **extra))))
    return _run(eng, JRequest, _prompts(jcfg.vocab))


def _port_dkv(block, paged=False, eos=None, slots=SLOTS, backend="cuda",
              **extra):
    _, _, tcfg, tp = _models("deepseek-7b")
    eng = Engine(tcfg, tp, slots=slots, max_len=MAX_LEN, device="cpu",
                 eos_id=eos, paged=paged,
                 decompose_engine=DecomposeEngine(EngineConfig(
                     backend=backend, **_dkv_kw(block, **extra))))
    return _run(eng, Request, _prompts(tcfg.vocab))


def _counters(stats):
    return (stats.decode_steps, stats.blocks, stats.tail_folds,
            stats.stopped_eos, stats.stopped_budget, stats.tokens_out)


# ---------------------------------------------------------------------------
# run_decode_block
# ---------------------------------------------------------------------------

V = 11


def _toy_logits(tok, pos, acc):
    """One-hot logits of (3·tok + pos + acc) mod V: every state change
    shows in the tokens."""
    return (3 * tok + pos + acc) % V


@pytest.mark.parametrize("max_block,n", [(4, 0), (4, 1), (4, 3), (4, 4),
                                         (6, 6)])
@pytest.mark.parametrize("stops", [[[-1], [-1], [-1]],
                                   [[-1, -1], [5, -1], [-1, 2]],
                                   [[7, 1], [-1, -1], [3, -1]]])
def test_run_decode_block_matches_reference(max_block, n, stops):
    """A toy step whose logits depend on the token, the position and an
    accumulating cache: buf, steps, done and the final cache equal
    ``repro.models.api.run_decode_block``'s (a halted iteration of the
    fixed-length loop changes nothing)."""
    tok0 = np.array([1, 4, 9], np.int32)
    pos0 = np.array([3, 0, 7], np.int32)
    table = np.array(stops, np.int32)

    def jstep(t, c, p):
        v = _toy_logits(t, p, c["acc"])
        return jax.nn.one_hot(v, V), {"acc": c["acc"] + t + 1}

    jbuf, jsteps, jdone, jc = japi.run_decode_block(
        jstep, greedy_sampler, max_block, jnp.asarray(tok0),
        {"acc": jnp.zeros(3, jnp.int32)}, jnp.asarray(pos0), n,
        jnp.asarray(table), None, 0)

    def tstep(t, c, p, live):
        v = _toy_logits(t.long(), p.long(), c["acc"])
        c["acc"] = torch.where(live, c["acc"] + t.long() + 1, c["acc"])
        return torch.nn.functional.one_hot(v, V).float(), c

    buf, steps, done, c = api.run_decode_block(
        tstep, max_block, torch.from_numpy(tok0), {
            "acc": torch.zeros(3, dtype=torch.long)},
        torch.from_numpy(pos0), n, torch.from_numpy(table))
    assert buf.dtype == torch.int32 and buf.shape == (max_block, 3)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(steps) == int(jsteps)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(c["acc"].numpy(), np.asarray(jc["acc"]))


# ---------------------------------------------------------------------------
# Fused engine against the single-step engine and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_fused_decode_token_exact(paged):
    """Every block length gives the single-step engine's tokens and the
    JAX engine's, across tail folds and organic admissions (slots <
    requests), slot and paged; steps, blocks and folds equal JAX's."""
    want, j1 = _jax_dkv(1, paged)
    base, e1 = _port_dkv(1, paged)
    assert base == want and e1.stats.tail_folds > 0
    assert _counters(e1.stats) == _counters(j1.stats)
    for blk in FUSED_BLOCKS:
        got, eb = _port_dkv(blk, paged)
        _, jb = _jax_dkv(blk, paged)
        assert got == base, f"block={blk} diverged"
        assert _counters(eb.stats) == _counters(jb.stats), blk
        assert eb.stats.blocks < e1.stats.blocks
        assert eb.graphs.eager == eb.stats.blocks   # the host: no graphs
    if paged:                                # no page leak under fusion
        assert eb.pager.alloc.free_pages == eb.pager.num_pages - 1
        assert eb.pager.talloc.free_pages == eb.pager.num_tail_pages - 1


@pytest.mark.parametrize("paged", [False, True])
def test_fused_decode_eos_mid_block(paged):
    """A stop token sampled mid-block halts the block on the device, so
    the request finishes at the single-step engine's round with its
    tokens; ``stopped_eos`` and the steps equal JAX's.  The second eos
    stops request 1 one step before its slot's fold horizon, so the other
    slot's co-fold follows the stop at the next boundary."""
    probe, _ = _port_dkv(1, paged)
    for eos in (probe[0][len(probe[0]) // 2], probe[1][3]):
        want, j1 = _jax_dkv(1, paged, eos=eos)
        base, e1 = _port_dkv(1, paged, eos=eos)
        assert base == want and e1.stats.stopped_eos >= 1
        assert _counters(e1.stats) == _counters(j1.stats)
        for blk in (2, 3, 8):
            got, eb = _port_dkv(blk, paged, eos=eos)
            _, jb = _jax_dkv(blk, paged, eos=eos)
            assert got == base, f"block={blk} with eos {eos} diverged"
            assert _counters(eb.stats) == _counters(jb.stats), (blk, eos)


def test_fused_route_check_tokens_equal():
    """``backend="reference"`` (the plain attention route, run eagerly
    by design) gives the kernel route's fused tokens."""
    got, _ = _port_dkv(8)
    ref, eng = _port_dkv(8, backend="reference")
    assert ref == got and eng.graphs.captures == 0


def test_fused_decode_dense_family():
    """The dense KV cache through the fused loop: budget horizons only,
    no folds; tokens equal single-step and JAX's."""
    jcfg, jp, tcfg, tp = _models("deepseek-7b")
    prompts = _prompts(jcfg.vocab)
    want, _ = _run(JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN),
                   JRequest, prompts)
    for blk in (1, 4, 32):
        got, eb = _run(Engine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN,
                              device="cpu", decode_block=blk), Request,
                       prompts)
        _, jb = _run(JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN,
                             decode_block=blk), JRequest, prompts)
        assert got == want, f"dense block={blk} diverged"
        assert _counters(eb.stats) == _counters(jb.stats)


def test_fused_itl_and_blocks_accounting():
    """Under block decode every decode token gets one ITL sample (the
    block's wall time over its steps), tokens_out is exact, and blocks
    counts launches, not rounds."""
    _, eng = _port_dkv(8)
    s = eng.stats
    assert s.blocks < s.decode_steps
    assert len(s.itl_s) == s.tokens_out
    assert all(dt >= 0 for dt in s.itl_s)
    assert s.tokens_out == len(PROMPT_LENS) * (MAX_NEW - 1)
    assert s.stopped_budget == len(PROMPT_LENS) and s.stopped_eos == 0


def _fam_serve(eng, request_cls, prompts, stagger=True):
    """The family recipe: request 0 at step 0, request i at step 3i (or
    every request up front)."""
    if not stagger:
        return _run(eng, request_cls, prompts, FAM_NEW)
    done = []
    eng.submit(request_cls(uid=0, prompt=prompts[0], max_new_tokens=FAM_NEW))
    arrivals = {3 * i: i for i in range(1, len(prompts))}
    for step in range(300):
        if step in arrivals:
            i = arrivals[step]
            eng.submit(request_cls(uid=i, prompt=prompts[i],
                                   max_new_tokens=FAM_NEW))
        done.extend(eng.step())
        if len(done) == len(prompts) and not any(eng.live):
            break
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r.out_tokens for r in done}, eng


@pytest.mark.parametrize("eos_at", [None, 5])
def test_family_fused_block_matches_single_step(eos_at):
    """Mamba2 (reduced, float32): block-4 serving gives the single-step
    tokens and JAX's, with fewer launches — staggered, and with every
    request up front and an eos (request 0's 6th token) that halts a
    block mid-way while the other three decode on: a halted step that
    advanced their SSM states would change their later tokens."""
    jcfg, jp, tcfg, tp = _models("mamba2-780m")
    prompts = _prompts(jcfg.vocab, FAM_PROMPT_LENS)
    eos, stagger = None, eos_at is None
    if eos_at is not None:
        probe, _ = _fam_serve(Engine(tcfg, tp, slots=4, max_len=FAM_MAX_LEN,
                                     device="cpu"), Request, prompts,
                              stagger)
        eos = probe[0][eos_at]
    base, e1 = _fam_serve(Engine(tcfg, tp, slots=4, max_len=FAM_MAX_LEN,
                                 device="cpu", eos_id=eos), Request, prompts,
                          stagger)
    got, eb = _fam_serve(Engine(tcfg, tp, slots=4, max_len=FAM_MAX_LEN,
                                device="cpu", eos_id=eos, decode_block=4),
                         Request, prompts, stagger)
    want, jb = _fam_serve(JEngine(jcfg, jp, slots=4, max_len=FAM_MAX_LEN,
                                  eos_id=eos, decode_block=4), JRequest,
                          prompts, stagger)
    assert got == base == want
    assert eb.stats.blocks < e1.stats.blocks
    assert eb.stats.tokens_out == e1.stats.tokens_out
    assert _counters(eb.stats) == _counters(jb.stats)
    if eos is not None:
        assert eb.stats.stopped_eos >= 1


# ---------------------------------------------------------------------------
# A halted step changes nothing
# ---------------------------------------------------------------------------

def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.clone()


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("kind", ["dense", "ssm", "slab", "paged"])
def test_halted_steps_leave_the_cache_as_one_step_does(kind):
    """A block of 4 steps whose first step samples a stop token leaves
    every cache tensor bit-equal to one single step from the same state:
    the three halted iterations write nothing (their ``live`` is False)."""
    arch = "mamba2-780m" if kind == "ssm" else "deepseek-7b"
    _, _, tcfg, tp = _models(arch)
    kw = {}
    if kind in ("slab", "paged"):
        kw = dict(paged=kind == "paged", decompose_engine=DecomposeEngine(
            EngineConfig(**_dkv_kw(4))))
    eng = Engine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                 decode_block=4, **kw)
    for i, p in enumerate(_prompts(tcfg.vocab)[:SLOTS]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng._admit()
    state = (lambda: eng.pager.cache) if kind == "paged" else \
        (lambda: eng.cache)
    tok = eng._last_tokens()
    before = _snapshot(state())
    first = eng._sample_host(eng.family.decode(torch.from_numpy(tok).long()))
    one = _snapshot(state())
    # back to the state before, then a block that stops after step 1
    _restore(state(), before)
    stops = np.full((SLOTS, 1), -1, np.int32)
    stops[1, 0] = first[1]
    toks, steps = eng.family.decode_block(tok, 4, stops)
    assert steps == 1 and list(toks[0]) == list(first)
    assert _equal(_snapshot(state()), one)


def _restore(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _restore(dst[k], v)
        else:
            dst[k].copy_(v)


# ---------------------------------------------------------------------------
# Stop tokens, scheduler, gang
# ---------------------------------------------------------------------------

def _staggered(eng, request_cls, prompts, **req_kw):
    """``test_dkv_matches_dense_token_level``'s staggered arrivals."""
    eng.submit(request_cls(uid=0, prompt=prompts[0], max_new_tokens=MAX_NEW,
                           **req_kw))
    arrivals = {3 * i: i for i in range(1, len(prompts))}
    done = []
    for step in range(200):
        if step in arrivals:
            i = arrivals[step]
            eng.submit(request_cls(uid=i, prompt=prompts[i],
                                   max_new_tokens=MAX_NEW, **req_kw))
        done.extend(eng.step())
        if len(done) == len(prompts) and not any(eng.live):
            break
    return {r.uid: (r.out_tokens, r.t_done > 0) for r in done}, eng.stats


@pytest.mark.parametrize("where", ["engine", "request"])
def test_stop_tokens_and_reasons_equal_jax(where):
    """The dkv == dense recipe (rank 64, tail 4, 2 slots, staggered) with
    a stop token the float32 JAX run emits mid-stream — as the engine's
    ``eos_id`` or as a request's ``stop_tokens``: tokens, ``t_done`` and
    the stop reasons equal JAX's."""
    jcfg, jp, tcfg, tp = _models("deepseek-7b")
    prompts = _prompts(jcfg.vocab)
    kw = dict(max_len=MAX_LEN, decompose_kv_rank=64, dkv_tail=TAIL,
              dkv_exact=True)
    probe, _ = _staggered(JEngine(jcfg, jp, slots=2, **kw), JRequest,
                          prompts)
    eos = probe[1][0][5]
    ekw, rkw = ({"eos_id": eos}, {}) if where == "engine" \
        else ({}, {"stop_tokens": (eos,)})
    want, js = _staggered(JEngine(jcfg, jp, slots=2, **kw, **ekw), JRequest,
                          prompts, **rkw)
    eng = Engine(tcfg, tp, slots=2, max_len=MAX_LEN, device="cpu", **ekw,
                 decompose_engine=DecomposeEngine(EngineConfig(
                     kv_rank=64, kv_tail=TAIL, kv_exact=True)))
    got, ts = _staggered(eng, Request, prompts, **rkw)
    assert got == want
    assert js.stopped_eos >= 1
    assert (ts.stopped_eos, ts.stopped_budget, ts.decode_steps) == \
        (js.stopped_eos, js.stopped_budget, js.decode_steps)


_OPS = st.lists(st.one_of(
    st.tuples(st.just("submit"), st.integers(1, 70)),
    st.tuples(st.just("take"), st.integers(0, 5)),
    st.tuples(st.just("requeue"), st.just(0))), max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, bucket=st.sampled_from([1, 8, 16]),
       max_admit=st.integers(0, 3), extra=st.integers(0, 20))
def test_scheduler_batches_equal_jax(ops, bucket, max_admit, extra):
    """Over one sequence of submits, ``next_batch`` calls and requeues of
    the last batch, the port's ``Scheduler(bucket, max_admit, cost)``
    gives the reference's batches and queue (the cost hook adds a fixed
    ``extra`` to the prompt length, as modality families do)."""
    cost = lambda r: len(r.prompt) + extra            # noqa: E731
    js = JScheduler(bucket=bucket, max_admit=max_admit, cost=cost)
    ts = Scheduler(bucket=bucket, max_admit=max_admit, cost=cost)
    jlast, tlast, uid = [], [], 0
    for op, arg in ops:
        if op == "submit":
            p = np.zeros(arg, np.int32)
            js.submit(JRequest(uid=uid, prompt=p))
            ts.submit(Request(uid=uid, prompt=p))
            uid += 1
        elif op == "take":
            jlast, tlast = js.next_batch(arg), ts.next_batch(arg)
            assert [r.uid for r in jlast] == [r.uid for r in tlast]
            assert max_admit < 1 or len(tlast) <= max_admit
        else:
            js.requeue(jlast)
            ts.requeue(tlast)
            jlast, tlast = [], []
        assert [r.uid for r in js.pending] == [r.uid for r in ts.pending]


@pytest.mark.parametrize("kind", ["dense", "dkv"])
def test_gang_admission_tokens_equal_jax(kind):
    """``admission="gang"`` (whole-slot-batch prefill; dkv waits for
    every slot to free, dense splices into live slots), staggered: the
    tokens and admission counts equal the JAX engine's gang."""
    jcfg, jp, tcfg, tp = _models("deepseek-7b")
    prompts = _prompts(jcfg.vocab)
    jkw, tkw = {}, {}
    if kind == "dkv":
        jkw = dict(decompose_kv_rank=64, dkv_tail=TAIL, dkv_exact=True)
        tkw = dict(decompose_engine=DecomposeEngine(EngineConfig(
            kv_rank=64, kv_tail=TAIL, kv_exact=True)))
    want, js = _staggered(JEngine(jcfg, jp, slots=2, max_len=MAX_LEN,
                                  admission="gang", **jkw), JRequest,
                          prompts)
    got, ts = _staggered(Engine(tcfg, tp, slots=2, max_len=MAX_LEN,
                                device="cpu", admission="gang", **tkw),
                         Request, prompts)
    assert got == want
    assert (ts.prefill_batches, ts.decode_steps) == \
        (js.prefill_batches, js.decode_steps)


def test_engine_refuses_bad_admission_and_block():
    _, _, tcfg, _ = _models("deepseek-7b")
    with pytest.raises(ValueError, match="admission"):
        Engine(tcfg, None, slots=2, max_len=MAX_LEN, device="cpu",
               admission="batch")
    with pytest.raises(ValueError, match="per slot"):
        Engine(tcfg, None, slots=2, max_len=MAX_LEN, device="cpu",
               admission="gang", paged=True,
               decompose_engine=DecomposeEngine(EngineConfig(kv_rank=8)))
    for bad in (0, -2, 2.5, True, "fast"):
        with pytest.raises(ValueError, match="decode_block"):
            EngineConfig(decode_block=bad)
    assert EngineConfig(decode_block="auto").decode_block == "auto"
    # the dkv family caps a block at its tail (the fold cadence)
    eng = Engine(tcfg, None, slots=2, max_len=MAX_LEN, device="cpu",
                 decompose_engine=DecomposeEngine(EngineConfig(
                     kv_rank=8, kv_tail=TAIL, decode_block=32)))
    assert eng.decode_block == TAIL


def test_serve_cli_new_flags(capsys):
    """The serve CLI's parity flags on the host: eos, scheduler knobs,
    gang admission, fused blocks and the route."""
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                "--decompose-kv-rank", "8", "--dkv-tail", "4",
                "--requests", "3", "--slots", "2", "--max-new", "6",
                "--decode-block", "4", "--sched-bucket", "8",
                "--admit-every", "2", "--max-admit", "1",
                "--backend", "reference", "--eos-id", "100000"])
    out = capsys.readouterr().out
    assert "blocks=" in out and "decode_block=4" in out
    assert "stopped_eos=0 stopped_budget=3" in out
    assert "graphs: captures=0 replays=0 eager=" in out
    serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-new", "4",
                "--admission", "gang", "--decode-block", "auto"])
    out = capsys.readouterr().out
    assert "admission=gang" in out and "stopped_budget=3" in out
