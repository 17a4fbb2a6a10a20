"""``repro_torch.obs`` against ``repro.obs``: the port's metrics registry,
tracer, exposition and snapshot schema give the reference's numbers,
text and keys, and the obs package stays host-side (the counterpart of
the reference's lint rule O1, as a test).

* streaming histograms: the same numpy-seeded samples (zeros and
  negatives included) give exactly the reference's quantiles, count,
  sum, min and max; ``bucket_label`` agrees; the reservoir caps;
* Prometheus text: equal for the same registry contents, each parser
  reads the other's text, and the port's parser rejects the reference's
  malformed cases;
* traces: the reference's ``validate_trace`` accepts the port's, and the
  tracer cap and the phase stack behave as the reference's;
* ``stats_snapshot`` keys equal the reference's;
* the atomic writers (``ioutil`` and its three callers) leave the old
  file and no temporary file when a write fails;
* the compile watch's ``compile_stats`` shape;
* O1: no module of ``repro_torch/obs`` imports torch, and no obs call
  sits in a body a CUDA graph captures.
"""
import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import repro.obs as R  # noqa: E402
from repro.obs.registry import Histogram as RHistogram  # noqa: E402
from repro_torch import ioutil, obs as P  # noqa: E402
from repro_torch.obs.registry import Histogram as PHistogram  # noqa: E402

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
QS = (0.5, 0.95, 0.99)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _samples(kind: str) -> np.ndarray:
    rng = np.random.RandomState({"lognormal": 0, "mixed": 1, "ties": 2}[kind])
    if kind == "lognormal":
        return rng.lognormal(-3.0, 1.5, 3000)
    if kind == "mixed":             # zeros and negatives: the zero bucket
        xs = rng.normal(0.01, 0.02, 2000)
        xs[::17] = 0.0
        return xs
    return np.repeat(rng.uniform(1e-4, 1e-1, 20), 50)   # many equal values


@pytest.mark.parametrize("kind", ["lognormal", "mixed", "ties"])
def test_histogram_equals_reference_exactly(kind):
    """Same samples, same arithmetic: every quantile and the exact
    count/sum/min/max/mean are bit-equal to the reference's."""
    rh, ph = RHistogram("lat"), PHistogram("lat")
    for v in _samples(kind):
        rh.observe(float(v))
        ph.observe(float(v))
    for q in QS + (0.0, 0.001, 1.0):
        assert ph.quantile(q) == rh.quantile(q), q
    assert (ph.count, ph.sum, ph.min, ph.max, ph.mean) == \
        (rh.count, rh.sum, rh.min, rh.max, rh.mean)
    assert list(ph.recent) == list(rh.recent)


def test_empty_histogram_and_series_view():
    h = PHistogram("x")
    assert h.quantile(0.5) == RHistogram("x").quantile(0.5) == 0.0
    s = P.LatencySeries(h)
    s.append(0.5)
    s.extend([0.25, 1.0])
    assert len(s) == 3 and list(s) == [0.5, 0.25, 1.0] and s[1] == 0.25
    assert np.asarray(s).tolist() == [0.5, 0.25, 1.0]
    assert s.mean == pytest.approx(1.75 / 3)


@pytest.mark.parametrize("dims", [(3, 24, 96), (1, 1), (5,), (512, 4096)])
def test_bucket_label_equals_reference(dims):
    assert P.bucket_label(*dims) == R.bucket_label(*dims)


def test_reservoir_caps_at_512():
    assert P.RESERVOIR_CAP == R.registry.RESERVOIR_CAP == 512
    assert P.BUCKETS_PER_DECADE == R.BUCKETS_PER_DECADE
    h = PHistogram("x")
    for i in range(3 * P.RESERVOIR_CAP):
        h.observe(1e-3 * (1 + i % 5))
    assert len(h.recent) == P.RESERVOIR_CAP
    assert h.count == 3 * P.RESERVOIR_CAP


def test_registry_semantics_match_reference():
    """get-or-create identity, the kind clash, negative counter deltas and
    the gauge ratchet, as the reference's."""
    for mod in (R, P):
        reg = mod.MetricsRegistry()
        a = reg.counter("x_total", "help", mode="a")
        assert reg.counter("x_total", mode="a") is a
        a.add(5)
        a.add(-2)
        g = reg.gauge("peak")
        g.max(4)
        g.max(2)
        with pytest.raises(TypeError):
            reg.gauge("x_total", mode="a")
        assert (a.value, g.value, len(reg)) == (3, 4, 2)


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("reqs_total", "requests", mode="sync").inc(7)
    reg.counter("reqs_total", mode="async").inc(2)
    reg.gauge("inflight").set(3)
    h = reg.histogram("lat_seconds", "latency")
    for v in _samples("mixed")[:200]:
        h.observe(float(v))
    reg.counter("odd_total", label='a"b\\c').inc()
    return reg


def test_prometheus_text_equals_reference_and_cross_parses():
    text_p, text_r = P.to_prometheus(_fill(P)), R.to_prometheus(_fill(R))
    assert text_p == text_r
    assert R.parse_prometheus(text_p) == P.parse_prometheus(text_r)
    got = P.parse_prometheus(text_p)
    assert got["repro_reqs_total"] == [({"mode": "sync"}, 7.0),
                                       ({"mode": "async"}, 2.0)]
    assert {r[0]["quantile"] for r in got["repro_lat_seconds"]} == \
        {"0.5", "0.95", "0.99"}


@pytest.mark.parametrize("bad", ["not a metric line\n",
                                 'x{bad-label="1"} 2\n',
                                 'x{a="unterminated} 2\n'])
def test_port_parser_rejects_reference_malformed_cases(bad):
    with pytest.raises(ValueError):
        R.parse_prometheus(bad)
    with pytest.raises(ValueError):
        P.parse_prometheus(bad)


def test_writers_round_trip(tmp_path):
    reg = _fill(P)
    text = P.write_prometheus(str(tmp_path / "m.prom"), reg)
    assert (tmp_path / "m.prom").read_text() == text
    R.parse_prometheus(text)
    snap = P.write_json_snapshot(str(tmp_path / "m.json"), reg, P.GLOBAL)
    loaded = json.loads((tmp_path / "m.json").read_text())
    assert loaded == json.loads(json.dumps(snap))
    assert loaded["lat_seconds"][0]["count"] == 200
    assert loaded["lat_seconds"][0]["p99"] == \
        _fill(R).snapshot()["lat_seconds"][0]["p99"]
    assert sorted(os.listdir(tmp_path)) == ["m.json", "m.prom"]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _trace(mod, max_events=200_000):
    tr = mod.Tracer(enabled=True, max_events=max_events)
    with tr.span("step", "engine", {"round": 0}):
        req = tr.begin("request", "req/0", {"uid": 0})
        with tr.span("admit"):
            tr.instant("mark", args={"k": 1})
        req.end(tokens=3)
        req.end()                           # idempotent
    tr.begin("ticket", "tickets").annotate(n=1).end()
    return tr


def test_reference_validates_port_trace(tmp_path):
    tr = _trace(P)
    obj = tr.to_json()
    assert R.validate_trace(obj) == P.validate_trace(obj) == 4
    tr.export(str(tmp_path / "t.json"))
    assert R.validate_trace(str(tmp_path / "t.json")) == 4
    ref = _trace(R).to_json()
    assert [(e["name"], e["ph"], e["tid"]) for e in obj["traceEvents"]] == \
        [(e["name"], e["ph"], e["tid"]) for e in ref["traceEvents"]]
    assert P.Tracer(enabled=False).begin("x") is P.NULL_SPAN


def test_tracer_cap_and_phase_stack_match_reference():
    for mod in (R, P):
        tr = _trace(mod, max_events=3)
        assert (len(tr.events), tr.dropped) == (3, 2)
        assert mod.current_phase() == "other"
        with mod.phase_scope("decode"):
            with mod.phase_scope("fold"):
                assert mod.current_phase() == "fold"
            assert mod.current_phase() == "decode"
        assert mod.current_phase() == "other"


# ---------------------------------------------------------------------------
# snapshot schema
# ---------------------------------------------------------------------------

def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_stats_snapshot_keys_equal_reference():
    from repro.serving import EngineStats as REngineStats
    from repro_torch.serving import EngineStats as PEngineStats
    rs, ps = REngineStats(), PEngineStats()
    for s in (rs, ps):
        s.prefills += 2
        s.tokens_out += 5
        s.wall_s += 0.5
        s.itl_s.extend([0.01, 0.02, 0.0])
        s.ttft_s.append(0.1)
    rsnap, psnap = rs.snapshot(), ps.snapshot()
    assert _keys(psnap) == _keys(rsnap)
    assert psnap["schema"] == "repro.obs/v1"
    assert psnap == rsnap
    assert {m.name for m in ps.registry.metrics()} == \
        {m.name for m in rs.registry.metrics()}
    assert "prefill_s" not in psnap
    assert P.stats_snapshot(ps, wall_s=2.0)["tokens_per_s"] == 2.5


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------

def _write_cache(path, n):
    from repro_torch.tune.cache import TuningCache
    c = TuningCache(str(path))
    c.put(f"k{n}", {"n": n})
    c.save()


def _write_thresholds(path, n):
    from repro_torch.core.outlier import ThresholdTable
    ThresholdTable({0: float(n)}).save(str(path))


def _write_json(path, n):
    ioutil.atomic_write_json(str(path), {"n": n})


@pytest.mark.parametrize("writer", [_write_json, _write_cache,
                                    _write_thresholds])
def test_failed_write_keeps_the_old_file(tmp_path, monkeypatch, writer):
    """A write that fails at the rename raises, leaves the previous file
    as it was and no temporary file behind."""
    path = tmp_path / "out.json"
    writer(path, 1)
    before = path.read_text()

    def boom(src, dst):
        raise OSError("disk full")
    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        writer(path, 2)
    monkeypatch.undo()
    assert path.read_text() == before
    assert os.listdir(tmp_path) == ["out.json"]


def test_fig12_report_goes_through_ioutil():
    src = (PORT / "launch" / "fig12.py").read_text()
    assert "atomic_write_json" in src and "os.replace" not in src


# ---------------------------------------------------------------------------
# compile watch
# ---------------------------------------------------------------------------

def test_compile_stats_shape():
    reg = P.MetricsRegistry()
    with P.phase_scope("decode"):
        P.record_compile("cuda_graph", 0.5, registry=reg)
        P.record_compile("cuda_graph", 0.25, registry=reg)
    P.record_compile("nvcc", 2.0, n=7, registry=reg)
    assert P.compile_stats(reg) == {
        "decode": {"compiles": 2, "seconds": 0.75},
        "other": {"compiles": 7, "seconds": 2.0}}
    assert P.compile_stats(reg, kind="nvcc") == {
        "other": {"compiles": 7, "seconds": 2.0}}
    with pytest.raises(ValueError):
        P.record_compile("jit", 1.0, registry=reg)


# ---------------------------------------------------------------------------
# O1: obs stays host-side
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_obs_imports_no_torch():
    files = sorted((PORT / "obs").glob("*.py"))
    assert len(files) >= 6
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("torch", "jax", "repro"), \
                f"{path}: {mod}"


#: names that reach the obs layer from serving code
_OBS_NAMES = {"obs", "trace", "tracer", "stats", "phase_scope",
              "record_compile", "_OBS", "GLOBAL"}


def _obs_uses(node):
    return sorted({n.attr if isinstance(n, ast.Attribute) else n.id
                   for n in ast.walk(node)
                   if (isinstance(n, ast.Attribute) and n.attr in _OBS_NAMES)
                   or (isinstance(n, ast.Name) and n.id in _OBS_NAMES)})


def test_no_obs_call_in_captured_bodies():
    """What a CUDA graph captures runs Python once, at capture: an obs
    call there would count once and never on replay.  The captured code
    is ``models.api.run_decode_block`` and what it calls (the models, the
    kernels, the sampler), reached from the ``body`` closures of
    ``serving.families``: none of it may touch obs."""
    for sub in ("models", "kernels", "core"):
        for path in sorted((PORT / sub).glob("*.py")):
            if path.name == "build.py":
                continue            # checked below: nvcc builds, host-side
            for mod in _imports(path):
                assert "obs" not in mod.split("."), f"{path}: {mod}"
    build = ast.parse((PORT / "kernels" / "build.py").read_text())
    users = [n.name for n in ast.walk(build)
             if isinstance(n, ast.FunctionDef) and _obs_uses(n)]
    assert users == ["build_all"]           # before any launch or capture
    for mod in _imports(PORT / "sampling.py"):
        assert "obs" not in mod.split(".")
    tree = ast.parse((PORT / "serving" / "families.py").read_text())
    bodies = [n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name in ("body",
                                                               "step")]
    assert len(bodies) >= 4
    for fn in bodies:
        assert not _obs_uses(fn), (fn.name, fn.lineno, _obs_uses(fn))
    api = ast.parse((PORT / "models" / "api.py").read_text())
    run = next(n for n in ast.walk(api) if isinstance(n, ast.FunctionDef)
               and n.name == "run_decode_block")
    assert not _obs_uses(run)
