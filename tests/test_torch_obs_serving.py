"""Observability of the port's serving engine against the JAX package's.

The reference's observability gates on the port (reduced llama2-7b in
float32 on weights bridged from the JAX init, decomposed KV at rank 8,
tail 4, page 4, 2 slots, staggered arrivals across tail folds):

* the token-neutral grid {slot, paged} × {sync, async deterministic} ×
  {block 1, 4} of ``test_observability_is_token_neutral``: tokens with
  ``Observability(trace=True)`` equal those without, and JAX's; the trace
  is valid, with every request's lifecycle spans;
* the engine's counters and histogram counts, and the paged snapshot's
  keys, equal the JAX engine's for the same traffic;
* the ``decompose_total``/``decompose_kv_total`` deltas of the two
  ``GLOBAL`` registries are equal label for label (``backend=
  "reference"`` on both sides, Lanczos factorization);
* the stats stay bounded (``test_engine_stats_memory_bounded``);
* the engine reads the device (``item``/``cpu``/``tolist``/``numpy``/
  ``synchronize``) exactly as often with obs on as off;
* a dropped engine with obs on frees its cache without a GC pass;
* the serve CLI's ``--metrics-out``/``--trace-out``/``--stats-every``.
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

import repro.obs as R  # noqa: E402
from repro.configs import all_archs  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge, obs as P  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.obs.registry import RESERVOIR_CAP  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

RANK, TAIL, PAGE, SLOTS, MAX_LEN, MAX_NEW = 8, 4, 4, 2, 64, 10
PROMPT_LENS = (12, 7, 15, 9)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params), float32."""
    jcfg = all_archs()["llama2-7b"].reduced().replace(dtype="float32")
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tcfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    return jcfg, jp, tcfg, tp


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 512, n, dtype=np.int32) for n in PROMPT_LENS]


def _staggered(eng, request_cls):
    """Request 0 first, request i at step 3i (the conformance gate's)."""
    prompts = _prompts()
    arrivals = {3 * i: i for i in range(len(prompts))}
    done = []
    for step in range(300):
        if step in arrivals:
            i = arrivals[step]
            eng.submit(request_cls(uid=i, prompt=prompts[i],
                                   max_new_tokens=MAX_NEW))
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: list(r.out_tokens) for r in done}


def _ecfg(mod, exact=True, **kw):
    return mod(kv_rank=RANK, kv_tail=TAIL, kv_page=PAGE, kv_exact=exact,
               **kw)


def _port(model, paged=False, block=1, sync=True, obs=None, **ekw):
    _, _, tcfg, tp = model
    return Engine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                  paged=paged, prefill_async=not sync,
                  ready_order="deterministic", obs=obs,
                  decompose_engine=DecomposeEngine(
                      _ecfg(EngineConfig, decode_block=block, **ekw)))


_RUNS = {}


def _baseline(model, paged, block):
    """(JAX sync engine, its tokens, the port's obs-off sync engine, its
    tokens) after the staggered traffic, once per (paged, block): async
    deterministic gives the sync engine's tokens in both packages
    (``tests/test_torch_async.py``)."""
    if (paged, block) not in _RUNS:
        jcfg, jp, _, _ = model
        jeng = JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN, paged=paged,
                       decompose_engine=JDecomposeEngine(
                           _ecfg(JEngineConfig, decode_block=block)))
        eng = _port(model, paged, block)
        _RUNS[paged, block] = (jeng, _staggered(jeng, JRequest), eng,
                               _staggered(eng, Request))
    return _RUNS[paged, block]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("block", [1, 4])
def test_observability_is_token_neutral(model, paged, sync, block):
    """Full observability (registry and span tracing) gives the tokens of
    the default engine, and JAX's, for {slot, paged} × {sync, async
    deterministic} × {single-step, fused}; the trace is valid and every
    request has its lifecycle spans."""
    _, want, _, base = _baseline(model, paged, block)
    obs = P.Observability(trace=True)
    eng = _port(model, paged, block, sync, obs=obs)
    got = _staggered(eng, Request)
    assert got == base == want
    spans = R.validate_trace(obs.tracer.to_json())
    assert spans == P.validate_trace(obs.tracer.to_json())
    assert spans >= 4 * len(PROMPT_LENS)
    names = {ev["name"] for ev in obs.tracer.events}
    expect = {"request", "queue", "prefill", "decode", "step", "admit",
              "fold", "decode-step" if block == 1 else "decode-block"}
    if not sync:
        expect |= {"splice", "ticket"}
    assert expect <= names, f"missing spans: {expect - names}"
    per_req = [sum(ev["name"] in ("request", "queue", "prefill", "decode")
                   and ev["tid"] == obs.tracer._tids[f"req/{i}"]
                   for ev in obs.tracer.events)
               for i in range(len(PROMPT_LENS))]
    assert per_req == [4] * len(PROMPT_LENS)
    assert eng.stats.registry is obs.registry
    assert not eng._req_spans                # every request span closed
    assert eng.stats.tail_folds > 0


def _values(reg, names):
    """{metric name: value or histogram count} of ``names`` in ``reg``."""
    out = {}
    for m in reg.metrics():
        if m.name in names:
            out[m.name] = m.count if hasattr(m, "count") else m.value
    return out


@pytest.mark.parametrize("paged,block", [(False, 1), (True, 4)])
def test_engine_counters_equal_reference(model, paged, block):
    """For the same traffic, every engine metric of the reference (the
    wall clock apart) has the same value, or histogram count, in the
    port's registry; the snapshot keys, the paged block's included,
    are the reference's."""
    jeng, _, eng, _ = _baseline(model, paged, block)
    names = {m.name for m in jeng.obs.registry.metrics()} \
        - {"serving_wall_seconds"}
    assert len(names) == 16
    assert _values(eng.obs.registry, names) == \
        _values(jeng.obs.registry, names)
    assert len(eng.stats.itl_s) == eng.stats.tokens_out
    snap, ref = P.engine_snapshot(eng), R.engine_snapshot(jeng)
    assert snap.keys() == ref.keys()
    if paged:
        assert snap["paged"] == ref["paged"]


def _decompose_counts(reg):
    return {(m.name, tuple(sorted(m.labels.items()))): m.value
            for m in reg.metrics()
            if m.name in ("decompose_total", "decompose_kv_total")}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _admit_only(eng, request_cls):
    """Every prompt with a budget of its first token: admissions of 2, 1
    and 1 requests (the prompts' buckets), no decode step."""
    for i, p in enumerate(_prompts()):
        eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=1))
    assert len(eng.run()) == len(PROMPT_LENS)


def test_decomposition_counters_equal_reference(model):
    """Lanczos factorization through ``backend="reference"`` in both
    packages (f 8): the ``decompose_total{bucket, backend, f, path}`` and
    ``decompose_kv_total{mode, bucket}`` deltas of the two GLOBAL
    registries are equal, label for label, with the reference run
    eagerly (under jit its counters bump once per trace)."""
    jcfg, jp, _, _ = model
    kw = dict(exact=False, backend="reference", expansion=8)
    before = _decompose_counts(R.GLOBAL)
    # the reference counts where its Python runs: inside jit that is once
    # per trace, so it runs eagerly here to count every call, as the port
    with jax.disable_jit():
        _admit_only(JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN,
                            decompose_engine=JDecomposeEngine(
                                _ecfg(JEngineConfig, **kw))), JRequest)
    want = _delta(_decompose_counts(R.GLOBAL), before)
    before = _decompose_counts(P.GLOBAL)
    _admit_only(_port(model, **kw), Request)
    got = _delta(_decompose_counts(P.GLOBAL), before)
    assert got == want
    assert {k[0] for k in got} == {"decompose_total", "decompose_kv_total"}


def test_engine_stats_memory_bounded(model):
    """Latency series keep O(1) streaming state and a capped reservoir;
    ``len(itl_s) == tokens_out`` holds through the histogram count."""
    eng = _port(model)
    _staggered(eng, Request)
    s = eng.stats
    assert len(s.itl_s) == s.tokens_out > 0
    assert len(s.ttft_s) == len(s.ttft_queue_s) == len(s.ttft_compute_s)
    for series in (s.itl_s, s.ttft_s):
        assert len(series.hist.recent) <= RESERVOIR_CAP
        assert series.hist.count == len(series)
    assert s.mean_itl_s == pytest.approx(s.itl_s.hist.sum
                                         / s.itl_s.hist.count)
    for i in range(4 * RESERVOIR_CAP):
        s.itl_s.append(1e-3 * (1 + i % 7))
    assert len(s.itl_s.hist.recent) == RESERVOIR_CAP
    assert len(s.itl_s) == s.tokens_out + 4 * RESERVOIR_CAP


READS = ("item", "cpu", "tolist", "numpy")


@pytest.mark.parametrize("paged,block,sync", [(False, 1, True),
                                              (True, 4, False)])
def test_obs_adds_no_host_read(model, monkeypatch, paged, block, sync):
    """The engine reads the device back exactly as often with full
    observability as without: counted at every ``Tensor.item``/``cpu``/
    ``tolist``/``numpy`` and ``torch.cuda.synchronize`` call."""
    counts = {}

    def counting(name, fn):
        def wrapper(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counting("synchronize", torch.cuda.synchronize))
    runs = []
    for obs in (None, P.Observability(trace=True)):
        counts.clear()
        toks = _staggered(_port(model, paged, block, sync, obs=obs), Request)
        runs.append((toks, dict(counts)))
    assert runs[0] == runs[1]
    assert runs[0][1].get("cpu", 0) > 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


@pytest.mark.parametrize("paged", [False, True])
def test_dropped_engine_with_obs_frees_its_cache_without_gc(model, paged):
    """With ``Observability(trace=True)`` (whose tracer outlives the
    engine here) ``del eng`` still frees the engine and every tensor of
    its cache at once, with the cyclic collector off."""
    obs = P.Observability(trace=True)
    gc.collect()
    gc.disable()
    try:
        eng = _port(model, paged, 4, sync=False, obs=obs)
        _staggered(eng, Request)
        leaves = list(_tensors(eng.cache))
        if paged:
            leaves += list(_tensors(eng.pager.cache))
        assert leaves
        refs = [weakref.ref(t) for t in leaves] + [weakref.ref(eng)]
        del eng, leaves
        dead = [r() is None for r in refs]
    finally:
        gc.enable()
    assert all(dead), f"{dead.count(False)} of {len(dead)} still alive"
    assert obs.tracer.events


def test_serve_cli_writes_metrics_and_trace(tmp_path, capsys):
    """``--metrics-out``, ``--trace-out`` and ``--stats-every``: the
    files are read by the reference's strict parser and trace validator;
    ``--backend auto`` resolves to ``reference`` on the host."""
    from repro_torch.launch import serve
    m, t = tmp_path / "x.prom", tmp_path / "t.json"
    serve.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu",
                "--decompose-kv-rank", "8", "--dkv-tail", "4",
                "--requests", "2", "--max-new", "4",
                "--metrics-out", str(m), "--trace-out", str(t),
                "--stats-every", "2", "--backend", "auto"])
    out = capsys.readouterr().out
    assert "step 2: pctl: ttft_ms p50/p95/p99=" in out
    assert "backend='reference'" in out
    got = R.parse_prometheus(m.read_text())
    assert got["repro_serving_tokens_out"][0][1] == 2 * 3
    assert "repro_decompose_kv_total" in got
    assert R.validate_trace(str(t)) >= 2 * 4
