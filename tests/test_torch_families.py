"""The MoE and hybrid families of the port against the JAX package.

Reduced configs (``olmoe-1b-7b``, ``kimi-k2-1t-a32b``: MoE, the latter
with a leading dense layer and a shared expert; ``zamba2-1.2b``: Mamba2
plus the shared attention block), float32, weights from the JAX init
bridged through numpy:

* ``moe_ffn`` allclose to JAX's (rtol 1e-5), with a capacity that binds
  (the dropped (token, expert) pairs are JAX's) and a router whose
  probabilities tie exactly (the lower expert index wins, as in
  ``jax.lax.top_k``);
* prefill logits and cache, then three decode steps, allclose to JAX's;
* ``cache_batch_axes`` equal to JAX's for every ported family;
* the reference's family gate on the port, tokens equal to JAX's sync
  engine: staggered == solo, fused block 4 == single step, async
  (deterministic) == sync, and fused + async (MoE at capacity factor
  8.0, where capacity never binds, as the reference pins it).
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
from repro.models import api as japi, model_fns as jmodel_fns  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILY_ARCHS = ("olmoe-1b-7b", "zamba2-1.2b", "kimi-k2-1t-a32b")
FAM_PROMPT_LENS, FAM_NEW, FAM_MAX_LEN = (7, 12, 19, 5), 12, 96

_MODELS = {}


def _models(arch, cf=None, **shape):
    """(JAX cfg, JAX params, port cfg, port params), float32, cached; MoE
    at capacity factor ``cf`` when given; ``shape`` overrides config
    fields of both (e.g. a hybrid with a tail of Mamba2 blocks)."""
    key = (arch, cf, tuple(sorted(shape.items())))
    if key not in _MODELS:
        jcfg = all_archs()[arch].reduced().replace(dtype="float32", **shape)
        tcfg = get_arch(arch).reduced().replace(dtype="float32", **shape)
        if cf is not None:
            jcfg, tcfg = (c.replace(capacity_factor=cf) for c in (jcfg, tcfg))
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _MODELS[key] = (jcfg, jp, tcfg, tp)
    return _MODELS[key]


def _close(t, j):
    np.testing.assert_allclose(bridge.to_numpy(t), np.asarray(j), **TOL)


def _tree_close(t, j):
    if isinstance(t, dict):
        assert t.keys() == j.keys()
        for k in t:
            _tree_close(t[k], j[k])
    else:
        _close(t, j)


def test_reduced_configs_follow_the_reference_rule():
    for arch in FAMILY_ARCHS + ("llama2-7b", "mamba2-780m"):
        j, t = all_archs()[arch].reduced(), get_arch(arch).reduced()
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab", "num_experts", "top_k",
                  "moe_d_ff", "n_shared_experts", "first_k_dense",
                  "capacity_factor", "ssm_state", "ssm_head_dim",
                  "attn_period", "resolved_head_dim"):
            assert getattr(t, f) == getattr(j, f), (arch, f)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _jax_route(p, x, cfg):
    """The reference's routing and rank arithmetic (moe_ffn's first
    half), for the dropped set."""
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1)
    probs = jax.nn.softmax(jnp.einsum("th,he->te", xf.astype(jnp.float32),
                                      p["router"]["w"].astype(jnp.float32)),
                           axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    slots_e = eidx.reshape(-1)
    order = jnp.argsort(slots_e)
    counts = jnp.bincount(slots_e, length=cfg.num_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    rank = (jnp.arange(slots_e.shape[0]) - starts[slots_e[order]])[
        jnp.argsort(order)]
    return np.asarray(eidx), np.asarray(rank)


@pytest.mark.parametrize("case", ["slack", "binding", "ties", "shared"])
def test_moe_ffn_matches_jax(case):
    """y and the aux loss allclose to ``repro.models.moe.moe_ffn``; the
    expert ids, ranks and so the dropped (token, expert) pairs equal."""
    arch = "kimi-k2-1t-a32b" if case == "shared" else "olmoe-1b-7b"
    cf = {"binding": 0.5, "slack": 8.0}.get(case)
    jcfg, jp, tcfg, tp = _models(arch, cf)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tl = {k: (v[0] if not isinstance(v, dict) else
              jax.tree_util.tree_map(lambda a: a[0], v))
          for k, v in tp["layers"]["moe"].items()}
    x = np.random.RandomState(1).randn(3, 7, jcfg.d_model).astype(
        np.float32)
    if case == "ties":
        # identical router columns in pairs: every probability ties with
        # its neighbour's, exactly
        w = np.asarray(jl["router"]["w"]).copy()
        w[:, 1::2] = w[:, 0::2]
        jl = dict(jl, router={"w": jnp.asarray(w)})
        tl = dict(tl, router={"w": torch.from_numpy(w)})
    jy, jaux = JMOE.moe_ffn(jl, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn(tl, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux, jaux)
    j_e, j_rank = _jax_route(jl, jnp.asarray(x), jcfg)
    _, t_e, t_rank, _ = moe.route(tl, torch.from_numpy(x).reshape(21, -1),
                                  tcfg)
    np.testing.assert_array_equal(t_e.numpy(), j_e)
    np.testing.assert_array_equal(t_rank.numpy(), j_rank)
    cap = moe.capacity(tcfg, 21)
    dropped = int((t_rank >= cap).sum())
    if case == "binding":
        assert dropped > 0                     # capacity really binds
    if case == "ties":
        # each token's top 2 is a tied pair, the lower index first
        e = t_e.numpy()
        assert (e[:, 0] % 2 == 0).all() and (e[:, 1] == e[:, 0] + 1).all()


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------

# zamba2 at 7 layers, a shared block every 3: 2 groups of 2 Mamba2
# blocks and a tail of 1, the layout of the full model (6 x 5 + 2)
HYBRID_TAIL = dict(num_layers=7, attn_period=3)


@pytest.mark.parametrize("arch,shape", [(a, {}) for a in FAMILY_ARCHS]
                         + [("zamba2-1.2b", HYBRID_TAIL)])
def test_prefill_and_decode_match_jax(arch, shape):
    """Prefill logits and the whole cache (K/V, conv/ssm state), then
    three decode steps' logits and cache, allclose to JAX's."""
    jcfg, jp, tcfg, tp = _models(arch, **shape)
    jf, tf = jmodel_fns(jcfg), api.model_fns(tcfg)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab, (2, 16),
                                            dtype=np.int32)
    jl, jc = jf.prefill(jp, jcfg, jnp.asarray(toks), 24)
    tl, tc = tf.prefill(tp, tcfg, torch.from_numpy(toks).long(), 24)
    _close(tl, jl)
    _tree_close(tc, jc)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = np.array([16, 16], np.int32)
    for _ in range(3):
        jl, jc = jf.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        tl, tc = tf.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos).long())
        _close(tl, jl)
        _tree_close(tc, jc)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["llama2-7b", "olmoe-1b-7b", "mamba2-780m",
                                  "zamba2-1.2b", "kimi-k2-1t-a32b"])
def test_cache_batch_axes_match_jax(arch):
    jcfg = all_archs()[arch].reduced()
    tcfg = get_arch(arch).reduced()
    if arch == "zamba2-1.2b":          # with the tail's leaves too
        jcfg, tcfg = (c.replace(**HYBRID_TAIL) for c in (jcfg, tcfg))
    want = jax.tree_util.tree_map(int, japi.cache_batch_axes(jcfg))
    assert api.cache_batch_axes(tcfg) == want


def test_splice_cache_writes_in_place_along_each_slot_axis():
    """Hybrid state (slot axis 2 for the grouped Mamba2 leaves, 1 for the
    shared block's K/V): rows land at the slots, other rows and the
    buffers' addresses stay."""
    _, _, tcfg, _ = _models("zamba2-1.2b")
    fns = api.model_fns(tcfg)
    old = fns.init_cache(tcfg, 4, 8)
    ptrs = [t.data_ptr() for t in api.tree_leaves(old)]
    new = api.tree_map(lambda t: t + 1, fns.init_cache(tcfg, 2, 8))
    out = api.splice_cache(tcfg, old, new, [3, 1])
    assert out is old and [t.data_ptr() for t in api.tree_leaves(old)] == ptrs
    axes = api.cache_batch_axes(tcfg)
    for leaf, ax in zip(api.tree_leaves(old), api.tree_leaves(axes)):
        rows = leaf.movedim(ax, 0)
        assert bool((rows[[1, 3]] == 1).all()) and \
            bool((rows[[0, 2]] == 0).all())


# ---------------------------------------------------------------------------
# the family gate (tests/test_serving_conformance.py's recipes)
# ---------------------------------------------------------------------------

def _prompts(vocab, lens=FAM_PROMPT_LENS):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


def _serve(eng, request_cls, prompts, stagger=True):
    """The reference gate's schedule: request 0 first, request i at step
    3i (or all up front)."""
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
    return {r.uid: r.out_tokens for r in done}, eng


@pytest.mark.parametrize("arch,shape", [(a, {}) for a in FAMILY_ARCHS]
                         + [("zamba2-1.2b", HYBRID_TAIL)])
def test_family_gate_tokens_equal_jax(arch, shape):
    """Staggered == solo, block 4 == single step (fewer blocks, same
    tokens out), async-deterministic == sync and fused + async == sync,
    each with tokens equal to the JAX engine's staggered run."""
    jcfg, jp, tcfg, tp = _models(arch, 8.0 if "moe" == get_arch(
        arch).family else None, **shape)
    prompts = _prompts(jcfg.vocab)
    want, _ = _serve(JEngine(jcfg, jp, slots=4, max_len=FAM_MAX_LEN),
                     JRequest, prompts)

    def port(**kw):
        return _serve(Engine(tcfg, tp, slots=4, max_len=FAM_MAX_LEN,
                             device="cpu", **kw), Request, prompts)

    base, e1 = port()
    assert base == want and e1.stats.prefill_batches >= 2
    for i, p in enumerate(prompts):
        solo, _ = _serve(Engine(tcfg, tp, slots=1, max_len=FAM_MAX_LEN,
                                device="cpu"), Request, [p], stagger=False)
        assert solo[0] == want[i], f"{arch} request {i}: solo diverged"
    fused, eb = port(decode_block=4)
    assert fused == want
    assert eb.stats.blocks < e1.stats.blocks
    assert eb.stats.tokens_out == e1.stats.tokens_out
    det, ed = port(prefill_async=True, ready_order="deterministic")
    assert det == want and not ed._pool and not ed._reserved.any()
    both, _ = port(decode_block=4, prefill_async=True,
                   ready_order="deterministic")
    assert both == want


def _drive(eng, prompts, arrivals):
    """Submit ``prompts[i]`` once the engine has run ``r`` decode rounds,
    for each ``r: i`` of ``arrivals``, cutting a fused engine's blocks at those rounds, so
    both engines admit at the same rounds (``chip_smoke.drive``)."""
    block, todo, done = eng.decode_block, sorted(arrivals.items()), []
    for _ in range(500):
        while todo and todo[0][0] <= eng._round:
            i = todo.pop(0)[1]
            eng.submit(Request(uid=i, prompt=prompts[i],
                               max_new_tokens=FAM_NEW))
        eng.decode_block = min(block, todo[0][0] - eng._round) if todo \
            else block
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    return {r.uid: r.out_tokens for r in done}


def test_moe_fused_equals_single_step_where_capacity_binds():
    """With one slot an expert at decode (capacity factor 1.0 here: 4
    slots · top 2 of 8 experts; full olmoe at its own 1.25 has the same,
    ceil(4 · 8 · 1.25 / 64) = 1), tokens that pick the same expert are
    dropped in slot order, dead slots' tokens included.  The fused block
    keeps a dead slot's token and position as the single-step engine has
    them, so block 4 gives the single-step tokens under staggered
    arrivals and finishes (not the solo runs': drops depend on the
    batch)."""
    _, _, tcfg, tp = _models("olmoe-1b-7b", 1.0)
    assert moe.capacity(tcfg, 4) == 1
    prompts = _prompts(tcfg.vocab)
    arrivals = {0: 0, 3: 1, 4: 2, 9: 3}
    one = _drive(Engine(tcfg, tp, slots=4, max_len=FAM_MAX_LEN,
                        device="cpu"), prompts, arrivals)
    four = _drive(Engine(tcfg, tp, slots=4, max_len=FAM_MAX_LEN,
                         device="cpu", decode_block=4), prompts, arrivals)
    assert four == one
