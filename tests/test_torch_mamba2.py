"""Mamba2 (ssm family) of the port against the JAX package, on the CPU.

Weights come from the JAX init of the reduced ``mamba2-780m`` config,
bridged through numpy; inputs are made with numpy.  Covered: the config
copy, the plain intra-chunk SSD term against the Pallas kernel (interpret
mode) and its oracle, ``ssd_apply`` in one and in two chunks, prefill and
three decode steps, and the serving recipe of
``test_serving_conformance.py``'s family section (prompts of 7/12/19/5
tokens, 12 new tokens, slots 4, max_len 96, arrivals every 3 steps).

Tolerances (float32): the SSD term 1e-4 relative and absolute, as
``tests/test_kernels.py``'s kernel test (the sums run in another order);
layer and model outputs 2e-5 relative and absolute (the same float32
arithmetic in another framework's reduction order).  Greedy tokens are
held EQUAL to JAX's in float32.  In bf16 the frameworks round at other
places (ROADMAP C), so the bf16 bar is the reference's own: staggered
serving gives each request's solo tokens.
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
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import mamba2 as JM, model_fns as jmodel_fns  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.kernels import ops, ssd_chunk as ssd  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

ARCH = "mamba2-780m"
KTOL = dict(rtol=1e-4, atol=1e-4)    # the SSD term (tests/test_kernels.py)
MTOL = dict(rtol=2e-5, atol=2e-5)    # layer / model outputs, float32
FAM_PROMPT_LENS = (7, 12, 19, 5)
FAM_NEW, MAX_LEN = 12, 96

_MODELS = {}


def _models(dtype):
    if dtype not in _MODELS:
        jcfg = all_archs()[ARCH].reduced().replace(dtype=dtype)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        tcfg = get_arch(ARCH).reduced().replace(dtype=dtype)
        _MODELS[dtype] = (jcfg, jp, tcfg, tp)
    return _MODELS[dtype]


def _np(t):
    return t.detach().float().numpy()


def test_port_config_matches_reference():
    """The port's mamba2-780m names the reference's shapes, full and
    reduced (head_dim None, ssm_state 16, ssm_head_dim 32 when reduced)."""
    ref, port = all_archs()[ARCH], get_arch(ARCH)
    for cfg_r, cfg_p in ((ref, port), (ref.reduced(), port.reduced())):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab", "dtype",
                  "norm_eps", "padded_vocab", "ssm_state", "ssm_expand",
                  "ssm_head_dim", "ssm_conv_width", "d_inner", "ssm_heads"):
            assert getattr(cfg_r, f) == getattr(cfg_p, f), (cfg_r.name, f)
    assert (port.d_inner, port.ssm_heads, port.padded_vocab) == \
        (3072, 48, 50304)
    assert port.reduced().head_dim is None
    assert get_arch("llama2-7b").reduced().head_dim == 32


def test_init_tree_matches_reference():
    """The port's init draws the reference's tree: same keys, shapes and
    dtypes, zero conv bias, A = -1, D = 1, dt_bias = 0."""
    jcfg, jp, tcfg, _ = _models("bfloat16")
    tp = M.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_leaves_with_path(
              bridge.to_numpy(tp))}
    assert len(jl) == len(tl)
    for path, a in jl:
        t = tl[jax.tree_util.keystr(path)]
        assert t.shape == a.shape, path
    assert tp["layers"]["ssd"]["a_log"].dtype == torch.float32
    assert tp["layers"]["ssd"]["conv_w"].dtype == torch.bfloat16
    assert torch.all(tp["layers"]["ssd"]["conv_b"] == 0)
    assert torch.all(tp["layers"]["ssd"]["d"] == 1)
    std = tp["layers"]["ssd"]["conv_w"].float().std().item()
    assert 0.08 < std < 0.12


def _ssd_inputs(g, q, nh, hd, seed=0, decay=0.05):
    rng = np.random.RandomState(seed)
    cb = (rng.randn(g, q, q) * 0.3).astype(np.float32)
    l = np.cumsum(-np.abs(rng.randn(g, q, nh)) * decay,
                  axis=1).astype(np.float32)
    dt = np.abs(rng.randn(g, q, nh)).astype(np.float32)
    x = rng.randn(g, q, nh, hd).astype(np.float32)
    return cb, l, dt, x


@pytest.mark.parametrize("q,nh,hd", [(16, 4, 8), (32, 8, 16), (64, 4, 32),
                                     (20, 4, 8)])
def test_ssd_chunk_plain_matches_pallas_and_oracle(q, nh, hd):
    """The plain SSD term equals the Pallas kernel (interpret mode) and
    ``ref.ssd_chunk_intra`` at ``tests/test_kernels.py``'s shapes and at
    Q = 20 (not a multiple of 16); on CPU tensors the wrapper IS the
    plain version and launches nothing."""
    arrs = _ssd_inputs(3, q, nh, hd)
    before = ssd.ssd_chunk_intra.launches
    got = ssd.ssd_chunk_intra(*map(torch.from_numpy, arrs))
    assert ssd.ssd_chunk_intra.launches == before
    assert got.dtype == torch.float32 and got.shape == (3, q, nh, hd)
    plain = ssd.ssd_chunk_intra_plain(*map(torch.from_numpy, arrs))
    assert torch.equal(got, plain)
    jin = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(_np(got), np.asarray(
        jops.ssd_chunk_intra(*jin, head_block=4)), **KTOL)
    np.testing.assert_allclose(_np(got), np.asarray(
        jref.ssd_chunk_intra(*jin)), **KTOL)


def test_ssd_chunk_plain_masks_before_the_exponent_overflows():
    """A steep decay makes exp(l_q - l_s) overflow above the diagonal;
    the masked entries are selected away, so y stays finite and equal to
    the oracle."""
    arrs = _ssd_inputs(2, 48, 3, 8, seed=1, decay=40.0)
    cb, l, dt, x = arrs
    with np.errstate(over="ignore"):
        assert np.exp(np.float32(l[0, 0, 0] - l[0, -1, 0])) == np.inf
    got = _np(ssd.ssd_chunk_intra(*map(torch.from_numpy, arrs)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jref.ssd_chunk_intra(
        *[jnp.asarray(a) for a in arrs])), **KTOL)


@pytest.mark.parametrize("g,q,want", [(8, 64, 3), (6, 64, 3), (2, 64, 1),
                                       (1, 304, 1), (64, 64, 4)])
def test_ssd_kernel_takes_blocks_of_heads_where_they_pay(g, q, want):
    """The CUDA kernel's heads per item at mamba2-780m's nh 48, hd 64 on
    132 SMs: a block of heads (one staging of cb for all of them) where the
    greedy schedule of items ends no later than with single heads, one head
    where the grid would run short of items (G 2) or an item's cb boxes do
    not fit the kernel's 4 ring slots (Q 304: 6 boxes)."""
    assert ssd.heads_per_item(g, q, 48, 64, 132) == want
    # a block of heads only while an item's cb boxes fit its slots
    assert ssd.heads_per_item(8, 256, 48, 64, 132, cb_slots=4) == 1
    assert ssd.heads_per_item(8, 128, 48, 64, 132, cb_slots=4) >= 1


@pytest.mark.parametrize("g,q,nh,ctas", [
    (32, 64, 48, 132), (8, 64, 48, 132), (2, 64, 48, 132),
    (1, 304, 48, 132), (64, 64, 7, 132), (16, 64, 1, 132), (1, 64, 48, 132),
    (3, 70, 5, 132), (1, 200, 3, 264), (32, 64, 48, 264)])
def test_ssd_bwd_plan_covers_each_tile_once_heaviest_first(g, q, nh, ctas):
    """The backward kernel's host plan: its items (in the order the CTAs
    take them) cover every (chunk, head, query tile i, key tile j ≤ i)
    exactly once, the heaviest (tile pairs × heads) first; the chosen block costs
    no more than any other (greedy schedule plus the last tile's
    combine); the scratch and ticket counts follow from it."""
    plan = ssd.bwd_plan(g, q, nh, ctas)
    nt = -(-q // 64)
    items = ssd.bwd_items(g, q, nh, plan.hb)
    assert len(items) == plan.items
    seen = {}
    for j, c, n0, hc in items:
        assert 1 <= hc <= plan.hb and n0 + hc <= nh
        for n in range(n0, n0 + hc):
            for i in range(j, nt):
                seen[(c, n, i, j)] = seen.get((c, n, i, j), 0) + 1
    want = {(c, n, i, j) for c in range(g) for n in range(nh)
            for i in range(nt) for j in range(i + 1)}
    assert set(seen) == want and set(seen.values()) == {1}
    weights = [(nt - j) * hc for j, _, _, hc in items]
    assert weights == sorted(weights, reverse=True)
    costs = {hb: ssd.bwd_cost(g, q, nh, hb, ctas)
             for hb in range(1, min(nh, 16) + 1)}
    assert costs[plan.hb] == min(costs.values())
    nhb = -(-nh // plan.hb)
    assert plan.dcb_work == g * nt * nt * nhb * 64 * 64
    assert plan.dl_work == (g * nh * nt * q if nt > 1 else 0)
    assert plan.tickets == 2 + g * nt * nt + g


def test_ssd_bwd_plan_at_the_training_shape():
    """mamba2-780m's train step (G 32 × Q 64, nh 48) on the H100's 132
    SMs, one CTA each: blocks of 12 heads, 128 items in one wave (12
    heads a CTA, the least any split gives), 4 dcb partials a chunk; a
    long chunk (G 1 × Q 304) takes blocks of 2 heads, halving the
    partials each of its 25 tiles adds."""
    plan = ssd.bwd_plan(32, 64, 48, 132)
    assert (plan.hb, plan.items) == (12, 128)
    assert plan.dcb_work == 32 * 4 * 64 * 64
    assert ssd.bwd_plan(1, 304, 48, 132).hb == 2


def test_kernel_sets_route_the_ssd_term():
    """``KernelSet.ssd_chunk_intra``: under "cuda" the differentiable
    entry (``SSDChunkIntra``, whose forward is the counted wrapper and
    whose backward is the counted backward wrapper), the plain version
    under "reference"."""
    assert ops.make_kernels("cuda").ssd_chunk_intra is \
        ssd.ssd_chunk_intra_diff
    assert ops.KERNELS["ssd_chunk_intra"] is ssd.ssd_chunk_intra
    assert ops.KERNELS["ssd_chunk_intra_bwd"] is ssd.ssd_chunk_intra_bwd
    assert ops.make_kernels("reference").ssd_chunk_intra is \
        ssd.ssd_chunk_intra_plain


@pytest.mark.parametrize("s", [16, 80, 128])
def test_ssd_apply_matches_jax(s):
    """One layer's SSD on layer 0's weights: S = 16 and 80 are one chunk
    (80 is not a multiple of 64), 128 two chunks with the inter-chunk
    scan."""
    jcfg, jp, tcfg, tp = _models("float32")
    x = np.random.RandomState(s).randn(2, s, jcfg.d_model).astype(
        np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssd"])
    want = np.asarray(JM.ssd_apply(jl, jnp.asarray(x), jcfg))
    tl = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["layers"]["ssd"].items()}
    got = _np(M.ssd_apply(tl, torch.from_numpy(x), tcfg))
    np.testing.assert_allclose(got, want, **MTOL)
    ref = _np(M.ssd_apply(tl, torch.from_numpy(x), tcfg,
                          ops.make_kernels("reference")))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("s", [24, 128])
def test_prefill_and_decode_match_jax(s):
    """Prefill logits and (conv, ssm) state, then three decode steps'
    logits and state, against the JAX model; the forward's last logits
    equal prefill's."""
    jcfg, jp, tcfg, tp = _models("float32")
    rng = np.random.RandomState(7)
    toks = rng.randint(0, jcfg.vocab, (2, s)).astype(np.int32)
    jlog, jst = JM.prefill(jp, jcfg, jnp.asarray(toks))
    tlog, tst = M.prefill(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MTOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tst[key]), np.asarray(jst[key]),
                                   **MTOL)
    fwd = M.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(fwd[:, -1]), _np(tlog), **MTOL)
    for i in range(3):
        tok = rng.randint(0, jcfg.vocab, (2,)).astype(np.int32)
        pos = np.full((2,), s + i, np.int32)
        jlog, jst = JM.decode_step(jp, jcfg, jnp.asarray(tok), jst,
                                   jnp.asarray(pos))
        tlog, tst = M.decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                  tst, torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MTOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tst[key]), np.asarray(jst[key]),
                                       **MTOL)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32)
            for n in FAM_PROMPT_LENS]


def _serve(eng, request_cls, prompts, stagger=True):
    """The family recipe: request 0 at step 0, request i at step 3i (or
    every request up front)."""
    done = []
    if not stagger:
        for i, p in enumerate(prompts):
            eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=FAM_NEW))
        done = eng.run()
    else:
        eng.submit(request_cls(uid=0, prompt=prompts[0],
                               max_new_tokens=FAM_NEW))
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
    return {r.uid: r.out_tokens for r in done}, eng.stats


def _engine(tcfg, tp, slots=4, backend="cuda"):
    return Engine(tcfg, tp, slots=slots, max_len=MAX_LEN, device="cpu",
                  decompose_engine=DecomposeEngine(EngineConfig(
                      backend=backend)))


def _solo(tcfg, tp, prompts):
    """Each request alone on a fresh single-slot engine."""
    return {i: _serve(_engine(tcfg, tp, slots=1), Request, [p],
                      stagger=False)[0][0] for i, p in enumerate(prompts)}


def test_serving_tokens_equal_jax_float32():
    """Staggered serving of reduced float32 mamba2-780m: the port's greedy
    tokens equal the JAX engine's, equal each request's solo tokens, and
    the ``backend="reference"`` route gives the same tokens."""
    jcfg, jp, tcfg, tp = _models("float32")
    prompts = _prompts(jcfg.vocab)
    want, _ = _serve(JEngine(jcfg, jp, slots=4, max_len=MAX_LEN), JRequest,
                     prompts)
    got, st = _serve(_engine(tcfg, tp), Request, prompts)
    assert st.prefill_batches >= 2          # admissions landed while live
    assert got == want
    assert _solo(tcfg, tp, prompts) == got
    ref, _ = _serve(_engine(tcfg, tp, backend="reference"), Request,
                    prompts)
    assert ref == got


def test_bf16_staggered_tokens_equal_solo():
    """The recipe in bf16 on the port alone: staggered admissions splice
    whole state rows without perturbing any sequence."""
    _, _, tcfg, tp = _models("bfloat16")
    prompts = _prompts(tcfg.vocab)
    got, st = _serve(_engine(tcfg, tp), Request, prompts)
    assert st.prefill_batches >= 2
    assert got == _solo(tcfg, tp, prompts)


def test_mamba2_engine_uses_state_slots():
    """The ssm family: O(1) state slots [L, slots, ...], no folds; paged
    serving and the decomposed KV cache are refused."""
    _, _, tcfg, tp = _models("float32")
    eng = _engine(tcfg, tp, slots=3)
    assert type(eng.family).__name__ == "Mamba2Serving"
    assert eng.cache["conv"].shape == (2, 3, 3, tcfg.d_inner + 32)
    assert eng.cache["ssm"].shape == (2, 3, 8, 32, 16)
    assert eng.cache["ssm"].dtype == torch.float32
    assert model_fns(tcfg).init is M.init
    with pytest.raises(ValueError, match="paged"):
        Engine(tcfg, tp, slots=2, max_len=MAX_LEN, device="cpu", paged=True)
    with pytest.raises(AssertionError, match="dense family"):
        Engine(tcfg, tp, slots=2, max_len=MAX_LEN, device="cpu",
               decompose_engine=DecomposeEngine(EngineConfig(kv_rank=8)))
    with pytest.raises(ValueError, match="not ported"):
        model_fns(tcfg.replace(family="retnet"))


def test_serve_cli_runs_mamba2(capsys):
    """``--arch mamba2-780m --reduced --device cpu`` serves through the
    Mamba2 family."""
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
                "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "family=Mamba2Serving" in out and "req 1:" in out
