"""The port's autotuner (``repro_torch.tune``) against the JAX package's.

Spaces, grids and defaults where the meaning is shared, the cache's key
rules and file format (each package reads the other's file), the H100
and host cost models' unimodality as a hypothesis property, the tuner on
``device="cpu"`` (model mode, measured mode, the in-process lru,
pretune), ``EngineConfig(expansion="auto")`` bit-identical to the
pinned-f engine, ``backend="auto"`` (``resolve_backend``/
``tune_backend``) and the tuner's ``obs.GLOBAL`` counters, the serve
CLI's ``--expansion auto`` and the Fig. 12 entry point end to end on the
plain versions.  The cache is a temporary
file in every test (``REPRO_TUNE_CACHE``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.tune import cost_model  # noqa: E402

KERNELS = ("lanczos_reorth", "matvec_expand", "rmatvec_expand",
           "lowrank_matmul", "dkv_attention")


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    """Point the default cache at a fresh file; the lru is keyed on the
    cache path, so each test resolves from scratch."""
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    tune.reset_stats()
    return path


def _x(shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


# ---------------------------------------------------------------------------
# Spaces
# ---------------------------------------------------------------------------

def test_spaces_match_jax_where_the_meaning_is_shared():
    assert tune.EXPANSION_GRID == jtune.EXPANSION_GRID
    assert tune.BLOCK_GRID == jtune.BLOCK_GRID
    for kernel in ("matvec_expand", "lowrank_matmul", "dkv_attention"):
        assert dataclasses.astuple(tune.get_space(kernel)) == \
            dataclasses.astuple(jtune.get_space(kernel))
    assert set(tune.available_spaces()) == set(KERNELS) | {"decode_block"}
    assert tune.get_space("lowrank_matmul").default() == {"expansion": 8,
                                                          "n_block": 512}
    assert tune.get_space("dkv_attention").default() == {"expansion": 8}
    # the fused serving decode's block space is the reference's
    assert tune.DECODE_BLOCK_GRID == jtune.space.DECODE_BLOCK_GRID
    assert dataclasses.astuple(tune.get_space("decode_block")) == \
        dataclasses.astuple(jtune.get_space("decode_block"))
    # lanczos_reorth: the same f grid; f is blocks along N here, as in JAX
    lr = tune.get_space("lanczos_reorth")
    assert lr.param("expansion").choices == jtune.get_space(
        "lanczos_reorth").param("expansion").choices
    assert lr.default() == {"expansion": EngineConfig().expansion,
                            "backend": "cuda", "reorth": "cgs2"}
    assert lr.param("backend").choices == ("cuda", "reference")
    rmv = tune.get_space("rmatvec_expand")
    assert rmv.default() == {"expansion": 8, "col_block": 512}
    assert rmv.param("expansion").choices == (1, 2, 4, 8, 16, 32, 64, 128)
    c1 = list(tune.get_space("matvec_expand").candidates())
    assert c1 == list(tune.get_space("matvec_expand").candidates())
    assert len(c1) == tune.get_space("matvec_expand").size() == 24
    with pytest.raises(KeyError):
        tune.get_space("no-such-kernel")


def test_candidates_pin_params_and_keep_both_backends():
    cands = tune.candidates_for("lanczos_reorth", fix={"backend": "cuda"})
    assert [c["expansion"] for c in cands] == list(tune.EXPANSION_GRID)
    assert all(c["backend"] == "cuda" for c in cands)
    assert {c["backend"] for c in tune.candidates_for("lanczos_reorth")} \
        == {"cuda", "reference"}


# ---------------------------------------------------------------------------
# Cache: keys and the shared file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 33, 48), (1, 64), (32, 512, 4096),
                                   (5,), (4096, 4096), (64, 300, 1)])
def test_shape_bucket_and_entry_key_equal_jax(shape):
    assert tune.shape_bucket(shape) == jtune.shape_bucket(shape)
    for kind in ("torch-cpu", "torch-cuda:NVIDIA H100 80GB HBM3"):
        assert tune.entry_key(kind, "matvec_expand", shape, "bfloat16") \
            == jtune.entry_key(kind, "matvec_expand", shape, "bfloat16")


def test_cache_file_is_shared_both_ways_without_key_collisions(tmp_cache):
    res = tune.tune("matvec_expand", (16, 32), device="cpu",
                    fix={"row_block": 128}, persist=True)
    assert res.key.startswith("torch-cpu/")
    assert jtune.device_kind() != "torch-cpu"
    back = jtune.TuningCache(tmp_cache)
    assert back.get(res.key)["best"] == res.best
    back.put("cpu:cpu/matvec_expand/16x32/float32/-", {"v": 1})
    back.save()                              # merge-save keeps ours
    mine = tune.TuningCache(tmp_cache)
    assert mine.get("cpu:cpu/matvec_expand/16x32/float32/-") == {"v": 1}
    assert mine.get(res.key)["best"] == res.best
    with open(tmp_cache) as fh:
        assert json.load(fh)["schema"] == 1


@pytest.mark.parametrize("text", ["{not json", "[1, 2]",
                                  '{"schema": 2, "entries": {"k": 1}}',
                                  '{"schema": 1, "entries": [1]}'])
def test_cache_corruption_reads_as_empty(tmp_cache, text):
    with open(tmp_cache, "w") as fh:
        fh.write(text)
    c = tune.TuningCache(tmp_cache)
    assert c.get("k") is None and len(c) == 0
    c.put("k", {"v": 1})
    c.save()                                 # overwrites the bad file
    assert tune.TuningCache(tmp_cache).get("k") == {"v": 1}


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def _curve(kernel, shape, dtype, model):
    space = tune.get_space(kernel)
    names = [p.name for p in space.params]
    block = [n for n in names if n.endswith("block")]
    fix = {block[0]: 512} if block else (
        {"backend": "cuda"} if "backend" in names else None)
    return [t for _, t in tune.predict_curve(
        kernel, shape, dtype, tune.candidates_for(kernel, fix), model)]


def _unimodal(ts):
    i = ts.index(min(ts))
    return all(a >= b for a, b in zip(ts[:i], ts[1:i + 1])) and all(
        a <= b for a, b in zip(ts[i:], ts[i + 1:]))


@settings(max_examples=60, deadline=None)
@given(kernel=st.sampled_from(KERNELS),
       b=st.integers(1, 128), s=st.integers(1, 8192),
       h=st.integers(1, 8192), two_d=st.booleans(),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       model=st.sampled_from([tune.H100, tune.CPU]))
def test_cost_models_are_unimodal_along_the_grid(kernel, b, s, h, two_d,
                                                  dtype, model):
    if kernel == "lowrank_matmul":          # (k, H, N)
        shape = (b, s, h)
    elif kernel == "dkv_attention":         # (g, T, r) or (B, g, T, r)
        shape = (b, s, 1 + h % 256) if two_d else (
            1 + b % 8, b, s, 1 + h % 256)
    else:
        shape = (s, h) if two_d and kernel != "lanczos_reorth" \
            else (b, s, h)
    ts = _curve(kernel, shape, dtype, model)
    assert all(t > 0 for t in ts) and _unimodal(ts), ts


def test_h100_model_reads_ctas_in_flight_not_f():
    """The batched Fig. 12 shape already has 512 CTAs at f = 1: the model
    must not predict it starved there, while the scalar shape (8 CTAs)
    gains several-fold from expansion; the host model gains nothing."""
    for kernel in ("matvec_expand", "rmatvec_expand"):
        batched = _curve(kernel, (64, 4096, 4096), "bfloat16", tune.H100)
        scalar = _curve(kernel, (4096, 4096), "float32", tune.H100)
        assert batched[0] <= 1.05 * min(batched)
        assert scalar[0] >= 4 * min(scalar)
        host = _curve(kernel, (4096, 4096), "float32", tune.CPU)
        assert host[0] == min(host)
    with pytest.raises(KeyError):
        tune.predict("nope", (2, 2), "float32", {"expansion": 1})


@pytest.mark.parametrize("shape,dtype,f,block,ctas,flight", [
    ((4096, 4096), "float32", 8, 512, 64, 2 * 32768),   # phase 3's point
    ((64, 4096, 4096), "bfloat16", 8, 512, 64 * 64, 2 * 32768),
    ((4096, 4096), "float32", 1, 512, 8, 2 * 32768),
    ((4096, 4096), "float32", 1024, 8, 512 * 1024, 8 * 32),  # tile < stage
    ((300, 200), "float32", 1, 4096, 1, 2 * 32768),     # block clipped to S
    ((40, 200), "float32", 2, 4096, 2, 40 * 104 * 4),   # whole tile
])
def test_matvec_term_counts_ctas_and_bytes_in_flight(shape, dtype, f,
                                                     block, ctas, flight):
    """The matvec term follows its kernel: B x ceil(S / row_block) x f
    CTAs, each with its ring's 32 KB stages but one in flight or its
    whole tile when that is shorter, counted in units of 2 KB; one
    launch, the partials' traffic for f > 1."""
    from repro_torch.tune import cost_model as cm
    cand = {"expansion": f, "row_block": block}
    _, _, warps, extra, n_ctas, _ = cm._terms_matvec_expand(
        shape, cm.dtype_bytes(dtype), cand)
    assert n_ctas == ctas
    assert warps == ctas * flight / cm.MATVEC_WARP_FLIGHT
    b = shape[0] if len(shape) == 3 else 1
    assert extra == (8.0 * b * f * shape[-2] if f > 1 else 0.0)


@pytest.mark.parametrize("shape,dtype,f,block,ctas,flight", [
    ((4096, 4096), "float32", 8, 512, 64, 2 * 32768),   # phase 3's point
    ((64, 4096, 4096), "bfloat16", 8, 512, 64 * 64, 2 * 32768),
    ((4096, 4096), "float32", 1024, 8, 512 * 1024, 8 * 32),  # split < stage
    ((300, 200), "float32", 1, 4096, 1, 2 * 40 * 800),  # block clipped to H
])
def test_rmatvec_term_counts_ctas_and_bytes_in_flight(shape, dtype, f,
                                                      block, ctas, flight):
    """The rmatvec term follows its kernel: B x ceil(H / col_block) x f
    CTAs, each with its ring's stages but one in flight (32 KB of whole
    rows a stage) or its whole tile when that is shorter, counted in
    matvec warps (2 KB in flight each); one launch, no combine."""
    from repro_torch.tune import cost_model as cm
    cand = {"expansion": f, "col_block": block}
    _, _, warps, extra, n_ctas, _ = cm._terms_rmatvec_expand(
        shape, cm.dtype_bytes(dtype), cand)
    assert n_ctas == ctas
    assert warps == ctas * flight / cm.MATVEC_WARP_FLIGHT
    b = shape[0] if len(shape) == 3 else 1
    assert extra == (8.0 * b * f * shape[-1] if f > 1 else 0.0)


@pytest.mark.parametrize("b,s,h,k,f,q_once", [
    (1, 4096, 4096, 20, 16, True),     # phase 6's step: Q rows 20 KB a CTA
    (32, 512, 4096, 72, 16, True),     # phase 4's step: 72 KB a CTA
    (32, 512, 4096, 72, 8, False),     # 147 KB: Q read in every sweep
    (32, 512, 4096, 72, 32, True),     # two blocks a CTA
    (1, 4096, 4096, 20, 1, False),     # one CTA holds all of H
    (4, 64, 256, 8, 2, True),
])
def test_reorth_term_counts_cluster_ctas_and_q_once_where_it_fits(
        b, s, h, k, f, q_once):
    """The re-orth term follows the cluster kernel: B x min(f, 16) CTAs,
    two 32 KB ring stages in flight each (at most its share of A); the
    bytes count A and Q once, and where a CTA's Q rows do not fit in its
    shared memory the two re-reads slow the memory side; the combine
    reads the f blocks' k partials in every CTA, twice."""
    from repro_torch.kernels import lanczos_reorth as lr
    from repro_torch.tune import cost_model as cm
    bytes_, flops, warps, extra, ctas, splits = cm._terms_lanczos_reorth(
        (b, s, h, k), 4, {"expansion": f})
    assert ctas == b * min(f, 16) == b * lr.cluster_ctas(f)
    assert lr.q_in_smem("right", s, h, k, f) is q_once
    assert bytes_ == b * (4 * s * h + 4 * h * k + 4 * s + 4 * h)
    moved = bytes_ + (0 if q_once else 2 * b * 4 * h * k)
    flight = min(2 * cm.RING_STAGE_BYTES, -(-4 * s * h // min(f, 16)))
    assert warps == pytest.approx(ctas * flight / cm.MATVEC_WARP_FLIGHT
                                  * bytes_ / moved)
    assert extra == 8.0 * ctas * f * k and splits == 0.0


@pytest.mark.parametrize("shape,dtype,f,nb,ctas,stages", [
    ((20, 4096, 4096), "bfloat16", 8, 512, 8 * 8, 3),   # row 7's N 4096
    ((20, 4096, 11008), "bfloat16", 32, 128, 86 * 32, 2),
    ((20, 4096, 4096), "bfloat16", 1, 128, 32, 3),
    ((40, 256, 300), "float32", 2, 256, 2 * 2 * 1, 2),  # M 40: one chunk
    ((72, 4096, 128), "float32", 4, 128, 1 * 4 * 2, 3),  # two M chunks
])
def test_lowrank_term_counts_ctas_and_stages_in_flight(shape, dtype, f, nb,
                                                       ctas, stages):
    """The GEMM's term follows its kernel: ceil(N / n_block) x f x M
    chunks CTAs, each with three 64 x 128 stages of W in flight (fewer
    where its split is shorter), counted in 2 KB warps; the partials'
    traffic for f > 1 over M padded to the CTA's rows."""
    from repro_torch.tune import cost_model as cm
    k, h, n = shape
    dtb = cm.dtype_bytes(dtype)
    _, _, warps, extra, n_ctas, splits = cm._terms_lowrank_matmul(
        shape, dtb, {"expansion": f, "n_block": nb})
    assert n_ctas == ctas
    assert warps == ctas * stages * 64 * 128 * dtb / cm.MATVEC_WARP_FLIGHT
    mt, chunks = cm.lrmm_rows(k)
    assert extra == (8.0 * f * mt * chunks * n if f > 1 else 0.0)
    assert splits == -(-h // -(-h // f))


@pytest.mark.parametrize("shape,f,ctas,rows", [
    ((4, 32, 512, 64), 8, 4 * 4 * 8, 32),     # row 5's shape
    ((1, 32, 8192, 64), 1, 4, 32),            # row 5‴'s: one walking CTA
    ((4, 96, 16), 32, 1 * 1 * 32, 3),         # the reference's pretune
    ((2, 9, 40, 8), 2, 2 * 2 * 2, 20),
])
def test_dkv_term_counts_ctas_and_tile_in_flight(shape, f, ctas, rows):
    """The dkv term follows the walking kernel: B x ceil(G / 8) x f CTAs,
    each with one tile of U_k and U_v (32 rows, at most its block) in
    flight; the merge's f partials of (r + 2) floats a head for f > 1."""
    from repro_torch.tune import cost_model as cm
    b, g, t, r = shape if len(shape) == 4 else (1, *shape)
    _, _, warps, extra, n_ctas, _ = cm._terms_dkv_attention(shape, 2,
                                                            {"expansion": f})
    assert n_ctas == ctas
    assert warps == ctas * rows * 2 * r * 2 / cm.MATVEC_WARP_FLIGHT
    assert extra == (8.0 * b * -(-g // 8) * 8 * f * (r + 2) if f > 1
                     else 0.0)


# ---------------------------------------------------------------------------
# Tuner on the host
# ---------------------------------------------------------------------------

def test_model_mode_is_deterministic(tmp_cache):
    kw = dict(fix={"backend": "cuda"}, device="cpu")
    r1 = tune.tune("lanczos_reorth", (2, 48, 96), **kw)
    r2 = tune.tune("lanczos_reorth", (2, 48, 96), **kw)
    assert r1.best == r2.best and r1.source == "model"
    assert r2.source == "cache"                      # in-process hit
    r3 = tune.tune("lanczos_reorth", (2, 48, 96), force=True, **kw)
    assert r3.best == r1.best and r3.source == "model"
    assert tune.stats.answers == {"cache": 1, "model": 2, "measured": 0}


def test_measured_tune_on_cpu_persists_and_hits_cache(tmp_cache):
    kw = dict(shape=(16, 32), dtype="float32", fix={"row_block": 128},
              prune=2, reps=1, device="cpu")
    r1 = tune.tune("matvec_expand", measure_candidates=True, **kw)
    assert r1.source == "measured" and r1.measured_s > 0
    assert len(r1.table) == 2 and all(m is not None for _, _, m in r1.table)
    assert r1.shape == (16, 32)
    r2 = tune.tune("matvec_expand", measure_candidates=True,
                   cache=tune.TuningCache(tmp_cache), **kw)
    assert r2.source == "cache" and r2.best == r1.best


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("lowrank_matmul", (4, 256, 200), "bfloat16"),
    ("dkv_attention", (2, 4, 40, 8), "float32"),
])
def test_measured_tune_of_the_new_spaces_on_cpu(tmp_cache, kernel, shape,
                                                dtype):
    """A measured tune of each new space on the host times the plain
    versions at every candidate it keeps, persists the winner, and a
    second tune answers from the file."""
    r1 = tune.tune(kernel, shape, dtype, measure_candidates=True,
                   prune=None, reps=1, device="cpu")
    assert r1.source == "measured" and r1.measured_s > 0
    assert all(m is not None and m > 0 for _, _, m in r1.table)
    assert r1.best in [c for c, _, _ in r1.table]
    r2 = tune.tune(kernel, shape, dtype, measure_candidates=True,
                   cache=tune.TuningCache(tmp_cache), device="cpu")
    assert r2.source == "cache" and r2.best == r1.best
    assert r2.key.startswith(f"torch-cpu/{kernel}/")


def test_tuner_skips_splits_the_kernel_does_not_take(tmp_cache):
    """At H 256 (bucket 256, least H 129) the GEMM's kernel takes f 1 and
    2 only (splits of at least one 64-row stage): the tuner scores no
    other f; at H 4096 every f of the grid survives."""
    small = tune.tune("lowrank_matmul", (20, 256, 512), "bfloat16",
                      device="cpu")
    assert {c["expansion"] for c, _, _ in small.table} == {1, 2}
    big = tune.tune("lowrank_matmul", (20, 4096, 4096), "bfloat16",
                    device="cpu")
    assert {c["expansion"] for c, _, _ in big.table} == set(
        tune.EXPANSION_GRID)
    assert len(big.table) == tune.get_space("lowrank_matmul").size() == 18


def test_cache_entry_outside_its_own_space_is_ignored(tmp_cache):
    """A lanczos_reorth entry naming f = 64 (a matvec f, not a warp
    count) is not taken from the cache: the tuner answers again."""
    key = tune.entry_key("torch-cpu", "lanczos_reorth", (2, 48, 96),
                         "float32") + "/backend=cuda"
    c = tune.default_cache()
    c.put(key, {"kernel": "lanczos_reorth", "shape": [2, 64, 128],
                "dtype": "float32", "predicted_s": 1.0, "measured_s": 1.0,
                "best": {"expansion": 64, "backend": "cuda",
                         "reorth": "cgs2"}, "table": []})
    res = tune.tune("lanczos_reorth", (2, 48, 96), fix={"backend": "cuda"},
                    device="cpu")
    assert res.source == "model" and res.best["expansion"] in \
        tune.EXPANSION_GRID


def test_reorth_cache_entry_of_the_old_meaning_is_a_miss(tmp_cache):
    """An entry written before the cluster kernel (no revision: its f
    counted warps per CTA) is not reused, though its f lies in the grid;
    the new answer carries the space's revision and is reused."""
    key = tune.entry_key("torch-cpu", "lanczos_reorth", (2, 48, 96),
                         "float32") + "/backend=cuda"
    c = tune.default_cache()
    c.put(key, {"kernel": "lanczos_reorth", "shape": [2, 64, 128],
                "dtype": "float32", "predicted_s": 1.0, "measured_s": 1.0,
                "best": {"expansion": 32, "backend": "cuda",
                         "reorth": "cgs2"}, "table": []})
    kw = dict(fix={"backend": "cuda"}, device="cpu")
    res = tune.tune("lanczos_reorth", (2, 48, 96), **kw)
    assert res.source == "model"
    assert c.get(key)["revision"] == tune.space_revision(
        "lanczos_reorth") == 1
    assert tune.space_revision("matvec_expand") == 0
    again = tune.tune("lanczos_reorth", (2, 48, 96), **kw)
    assert again.source == "cache" and again.best == res.best


def test_tuned_expansion_is_an_in_process_lru(tmp_cache, tmp_path,
                                              monkeypatch):
    f1 = tune.tuned_expansion((2, 48, 96), backend="cuda", device="cpu")
    f2 = tune.tuned_expansion((2, 50, 100), backend="cuda", device="cpu")
    assert isinstance(f1, int) and f1 == f2      # one shape bucket
    assert (tune.stats.lru_lookups, tune.stats.lru_misses) == (2, 1)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "other.json"))
    tune.tuned_expansion((2, 48, 96), backend="cuda", device="cpu")
    assert tune.stats.lru_misses == 2            # keyed on the cache path


def test_pretune_warms_the_cache(tmp_cache):
    out = tune.pretune({"lanczos_reorth": [(2, 48, 96), (4, 48, 96)],
                        "matvec_expand": [(64, 128)],
                        "lowrank_matmul": [(20, 4096, 4096)]},
                       fix=None, device="cpu")
    # the reference's own pretune dict (tests/test_tune.py)
    out.update(tune.pretune({"dkv_attention": [(4, 96, 16)]},
                            device="cpu"))
    assert len(out) == 5
    for key, res in out.items():
        assert key.startswith("torch-cpu/") and "expansion" in res.best
        assert tune.default_cache().get(key) is not None


def test_entry_points_need_a_gpu_or_explicit_cpu(tmp_cache, monkeypatch):
    from repro_torch.launch import fig12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.tune("matvec_expand", (16, 32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.measure_candidate("matvec_expand", (16, 32), "float32",
                               {"expansion": 1})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig12.main(["--quick"])


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 64), t=st.integers(1, 4096),
       w=st.integers(1, 8192), dtype=st.sampled_from(["float32",
                                                     "bfloat16"]),
       model=st.sampled_from([tune.H100, tune.CPU]))
def test_decode_block_model_is_unimodal(b, t, w, dtype, model):
    """Per-token seconds of the fused decode over the block grid:
    unimodal, positive; on the host (no graphs: a block saves no
    dispatch) the best block is 1."""
    ts = [tune.predict("decode_block", (b, t, w), dtype, c, model)
          for c in tune.candidates_for("decode_block")]
    assert all(x > 0 for x in ts) and _unimodal(ts), ts
    if model is tune.CPU:
        assert ts.index(min(ts)) == 0


def test_decode_block_model_amortizes_the_host_dispatch(tmp_cache):
    """On the H100 model a long horizon takes the longest block and a
    horizon of 4 steps takes 4 (past it a block's steps are waste); the
    host model takes 1."""
    assert tune.tune("decode_block", (4, 512, 1024),
                     device="cpu").best == {"block": 1}
    curve = dict((c["block"], p) for c, p in tune.predict_curve(
        "decode_block", (4, 4, 1024), "float32",
        tune.candidates_for("decode_block"), tune.H100))
    assert min(curve, key=curve.get) == 4
    curve = dict((c["block"], p) for c, p in tune.predict_curve(
        "decode_block", (4, 512, 1024), "float32",
        tune.candidates_for("decode_block"), tune.H100))
    assert min(curve, key=curve.get) == 32


def test_tuned_decode_block_measured_on_cpu(tmp_cache):
    """The decode_block measurement harness times the proxy on the host
    and the measured winner persists; ``tuned_decode_block`` is an
    in-process lru over the cache."""
    res = tune.tune("decode_block", (2, 16, 32), measure_candidates=True,
                    prune=2, reps=1, device="cpu")
    assert res.source == "measured" and res.measured_s > 0
    k = tune.tuned_decode_block((2, 16, 32), device="cpu")
    assert k in tune.DECODE_BLOCK_GRID
    assert tune.tuned_decode_block((2, 16, 32), device="cpu") == k
    assert tune.stats.lru_misses == 1 and tune.stats.lru_lookups == 2


@pytest.mark.parametrize("kv_rank", [0, 8])
def test_auto_decode_block_token_equal_to_pinned(tmp_cache, kv_rank):
    """``Engine(decode_block="auto")`` resolves through the tuner and
    serves the tokens of the engine pinned at the resolved block (and of
    the single-step engine)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import model_fns
    from repro_torch.serving import Engine, Request
    cfg = get_arch("deepseek-7b").reduced().replace(dtype="float32")
    p = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (12, 7, 15)]

    def serve(block):
        eng = Engine(cfg, p, slots=2, max_len=64, device="cpu",
                     decode_block=block,
                     decompose_engine=DecomposeEngine(EngineConfig(
                         kv_rank=kv_rank, kv_tail=4, kv_exact=True)))
        for i, pr in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=pr, max_new_tokens=8))
        return {r.uid: r.out_tokens for r in eng.run()}, eng

    got, auto = serve("auto")
    assert auto.decode_block in tune.DECODE_BLOCK_GRID
    key = tune.entry_key("torch-cpu", "decode_block",
                         (2, 4 if kv_rank else 64, cfg.kv_width),
                         "float32") + "/-"
    assert tune.default_cache().get(key)["best"]["block"] == \
        auto.decode_block
    assert serve(auto.decode_block)[0] == got == serve(1)[0]


# ---------------------------------------------------------------------------
# Engine: expansion="auto"
# ---------------------------------------------------------------------------

def test_engine_config_rejects_bad_expansion():
    for bad in ("turbo", 0, 33, True, 8.0):
        with pytest.raises(ValueError):
            EngineConfig(expansion=bad)
    assert EngineConfig(expansion="auto").expansion == "auto"
    assert EngineConfig(expansion=32).expansion == 32


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_auto_engine_bit_identical_to_pinned_f(tmp_cache, backend):
    x = _x((2, 33, 48), seed=3)
    auto = DecomposeEngine(EngineConfig(backend=backend, expansion="auto"))
    assert repr(auto).count("expansion=auto") == 1
    f = auto.resolve_expansion(33, 48, batch=2, device="cpu")
    assert isinstance(f, int) and f in tune.EXPANSION_GRID
    fixed = DecomposeEngine(EngineConfig(backend=backend, expansion=f))
    la, lf = auto.decompose(x, 5), fixed.decompose(x, 5)
    for a, b in ((la.u, lf.u), (la.core, lf.core), (la.vt, lf.vt)):
        assert torch.equal(a, b)
    ua, va = auto.decompose_kv(x, 4)
    uf, vf = fixed.decompose_kv(x, 4)
    assert torch.equal(ua, uf) and torch.equal(va, vf)
    assert tune.stats.lru_lookups >= 2 and tune.stats.lru_misses == 1
    key = tune.entry_key("torch-cpu", "lanczos_reorth", (2, 33, 48),
                         "float32") + f"/backend={backend}"
    assert tune.default_cache().get(key)["best"]["expansion"] == f


# ---------------------------------------------------------------------------
# Engine: backend="auto", and the tuner's counters in obs.GLOBAL
# ---------------------------------------------------------------------------

def _global(name, **labels):
    from repro_torch.obs import GLOBAL
    return GLOBAL.counter(name, **labels).value


def test_tuner_counts_land_in_the_global_registry(tmp_cache):
    """``tune_resolutions_total{kernel, source}`` and the lru's
    ``tune_lru_lookups_total``/``tune_lru_misses_total`` move with
    :data:`tune.stats`."""
    base = (_global("tune_lru_lookups_total", kernel="lanczos_reorth"),
            _global("tune_lru_misses_total", kernel="lanczos_reorth"),
            _global("tune_resolutions_total", kernel="lanczos_reorth",
                    source="model"))
    for _ in range(3):
        tune.tuned_expansion((2, 40, 48), device="cpu")
    got = (_global("tune_lru_lookups_total", kernel="lanczos_reorth"),
           _global("tune_lru_misses_total", kernel="lanczos_reorth"),
           _global("tune_resolutions_total", kernel="lanczos_reorth",
                   source="model"))
    assert [g - b for g, b in zip(got, base)] == [3, 1, 1]
    assert (tune.stats.lru_lookups, tune.stats.lru_misses,
            tune.stats.answers["model"]) == (3, 1, 1)


def test_resolve_backend_on_the_host(tmp_cache):
    """No override: ``"reference"`` on the host, where the kernels cannot
    run; the registry names the two backends and ``"auto"``."""
    from repro_torch.engine import available_backends
    assert tune.resolve_backend(device="cpu") == "reference"
    assert tune.resolve_backend() == (
        "cuda" if torch.cuda.is_available() else "reference")
    assert available_backends() == ["cuda", "reference"]
    assert EngineConfig(backend="auto").backend == "auto"
    for bad in ("pallas", "triton", ""):
        with pytest.raises(ValueError):
            EngineConfig(backend=bad)


@pytest.mark.parametrize("stored,want", [("cuda", "cuda"),
                                         ("reference", "reference"),
                                         ("pallas", "reference")])
def test_resolve_backend_reads_the_cache_override(tmp_cache, stored, want):
    """A stored winner that names a registered backend is the answer; one
    that does not (here the JAX package's ``"pallas"``) is ignored."""
    c = tune.default_cache()
    c.put("torch-cpu/engine_backend", {"best": {"backend": stored}})
    assert tune.resolve_backend(device="cpu") == want
    engine = DecomposeEngine(EngineConfig(backend="auto"))
    if not torch.cuda.is_available():
        assert engine.resolved_backend == want


def test_tune_backend_measures_both_and_persists_the_winner(tmp_cache):
    res = tune.tune_backend((2, 32, 64), reps=2, device="cpu")
    assert res.key == "torch-cpu/engine_backend" and res.source == "measured"
    assert sorted(r[0]["backend"] for r in res.table) == ["cuda",
                                                          "reference"]
    assert res.measured_s == min(r[2] for r in res.table)
    assert tune.resolve_backend(device="cpu") == res.best["backend"]
    with open(tmp_cache) as fh:
        stored = json.load(fh)["entries"]["torch-cpu/engine_backend"]
    assert stored["best"] == res.best


def test_auto_backend_engine_bit_identical_to_reference(tmp_cache):
    """On the host ``backend="auto"`` is ``"reference"``: the same
    factors, and a serving engine on it gives the pinned engine's tokens
    (Lanczos factorization)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import model_fns
    from repro_torch.serving import Engine, Request
    auto = DecomposeEngine(EngineConfig(backend="auto"))
    ref = DecomposeEngine(EngineConfig(backend="reference"))
    assert auto.resolved_backend == "reference"
    assert "backend='reference'" in repr(auto)
    x = _x((2, 33, 48), seed=4)
    la, lr = auto.decompose(x, 5), ref.decompose(x, 5)
    for a, b in ((la.u, lr.u), (la.core, lr.core), (la.vt, lr.vt)):
        assert torch.equal(a, b)
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    p = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (12, 7, 15)]

    def serve(backend):
        eng = Engine(cfg, p, slots=2, max_len=64, device="cpu",
                     decompose_engine=DecomposeEngine(EngineConfig(
                         backend=backend, kv_rank=8, kv_tail=4)))
        for i, pr in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=pr, max_new_tokens=6))
        return {r.uid: r.out_tokens for r in eng.run()}

    assert serve("auto") == serve("reference")


def test_serve_cli_expansion_auto_prints_pretune(tmp_cache, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu",
                "--decompose-kv-rank", "8", "--dkv-tail", "4",
                "--requests", "2", "--slots", "4", "--max-new", "3",
                "--expansion", "auto"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("pretune[")]
    # admission batches 1, 2, 4 over 2 layers, prompt bucket 16, kvw 64
    assert [ln.split(", ")[1].split("/")[2] for ln in lines] == [
        "2x16x64", "4x16x64", "8x16x64"]
    assert all("(model, torch-cpu/lanczos_reorth/" in ln for ln in lines)
    assert "expansion=auto" in out
    serve.main(["--arch", "llama2-7b", "--reduced", "--device", "cpu",
                "--decompose-kv-rank", "8", "--dkv-tail", "4",
                "--requests", "1", "--max-new", "2", "--expansion", "auto",
                "--no-pretune"])
    assert "pretune[" not in capsys.readouterr().out


def test_fig12_cpu_quick_runs_the_ab_end_to_end(tmp_cache, tmp_path,
                                                capsys):
    from repro_torch.kernels import ops
    from repro_torch.launch import fig12
    out = tmp_path / "fig12.json"
    ops.reset_launch_counts()
    fig12.main(["--device", "cpu", "--quick", "--out", str(out)])
    data = json.loads(out.read_text())
    ab = data["ab"]
    assert data["model"]["f_star"] == 8
    assert sorted(int(f) for f in ab["swept_s"]) == [1, 2, 4, 8, 16, 32,
                                                     64, 128]
    assert len(ab["pruned_fs"]) == tune.DEFAULT_PRUNE
    assert ab["tuned_f"] in ab["pruned_fs"] and ab["tuned_vs_opt"] <= 1.05
    assert ab["device_kind"] == "torch-cpu" and ab["shape"] == [128, 256]
    assert ab["calls"] >= 8 * (2 + 3)
    text = capsys.readouterr().out
    assert "the paper's accelerator, not a measurement" in text
    assert "tuned/opt" in text
    # the host run takes the plain versions: no kernel launched
    assert all(v == 0 for v in ops.launch_counts().values())
    rmv = fig12.run_ab("rmatvec", (2, 64, 96), "bfloat16", reps=2,
                       device="cpu")
    assert rmv["kernel"] == "rmatvec_expand" and rmv["flush_l2"] is False
    assert cost_model.detect_device("cpu") is tune.CPU
