"""The dense family's other variants on the port against the JAX package:
``starcoder2-7b`` (layernorm and biased linears, an ungated GELU MLP),
``gemma-2b`` (GeGLU, MQA, head_dim 256 at full size, tied embeddings with
the √d scale) and ``granite-3-2b`` (SwiGLU, tied embeddings).

Reduced configs in float32; the JAX tree's biases and norm biases are
drawn non-zero with numpy from a seed before the bridge copies the tree
(the reference's init zeroes them, which would hide a missing bias add):

* the new layer pieces (``gelu``/``geglu``, ``layernorm``, the ungated
  ``mlp``) against ``repro.models.layers``: the activations bit-equal in
  bf16, the rest allclose;
* forward, prefill (logits and cache) and three decode steps, within
  1e-4 of max|logit|;
* ``decomposed_kv`` prefill (Lanczos) and decode on the slab (through a
  per-slot fold) and one paged decode step, within 1e-4 of max|logit|;
* ``models.decomposed.forward`` against the reference's forward (the
  same outlier channels at every decomposition, logits close);
* serving: the port's greedy tokens equal the JAX engine's, dense and
  decomposed-KV, single-step and fused (block 3), the latter also on the
  port's page pools; and in bf16 staggered == solo.
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
from repro.core import policy as jpol  # noqa: E402
from repro.engine import DecomposeEngine as JDEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import decomposed as JD  # noqa: E402
from repro.models import decomposed_kv as JDK  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import decomposed as D  # noqa: E402
from repro_torch.models import decomposed_kv as DK  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

VARIANTS = ("starcoder2-7b", "gemma-2b", "granite-3-2b")
REL = 1e-4          # logits: max |port − JAX| ≤ REL · max |JAX logit|
CLOSE = dict(rtol=1e-5, atol=1e-5)
_MODELS = {}


def perturb(tree, rng, bias_std=0.1):
    """numpy tree → the same tree with every bias (``b``), norm bias
    (``bias``) and cross gate (``gate_attn``/``gate_mlp``) redrawn from
    ``rng``: biases N(0, bias_std²), gates uniform in ±[0.4, 0.9]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng, bias_std)
        elif k in ("b", "bias"):
            out[k] = (rng.randn(*v.shape) * bias_std).astype(v.dtype)
        elif k in ("gate_attn", "gate_mlp"):
            g = rng.uniform(0.4, 0.9, v.shape) * rng.choice([-1, 1], v.shape)
            out[k] = np.asarray(g, v.dtype)
        else:
            out[k] = v
    return out


def bridged(arch, dtype="float32", seed=0):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced
    config, the JAX init with non-zero biases and gates, cached."""
    key = (arch, dtype, seed)
    if key not in _MODELS:
        jcfg = all_archs()[arch].reduced().replace(dtype=dtype)
        tcfg = get_arch(arch).reduced().replace(dtype=dtype)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        np_tree = perturb(jax.tree_util.tree_map(np.asarray, jp),
                          np.random.RandomState(seed))
        _MODELS[key] = (jcfg, jax.tree_util.tree_map(jnp.asarray, np_tree),
                        tcfg, bridge.to_torch(np_tree, "cpu"))
    return _MODELS[key]


def assert_logits(t, j, rel=REL):
    t, j = bridge.to_numpy(t), np.asarray(j)
    assert t.shape == j.shape
    gap, scale = np.abs(t - j).max(), np.abs(j).max()
    assert gap <= rel * scale, f"max |Δ| {gap:.3e} > {rel} · {scale:.3e}"


def tree_close(t, j, **tol):
    if isinstance(t, dict):
        assert t.keys() == j.keys()
        for k in t:
            tree_close(t[k], j[k], **tol)
    else:
        np.testing.assert_allclose(bridge.to_numpy(t), np.asarray(j),
                                   **(tol or CLOSE))


def _tokens(vocab, b=2, s=12, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s),
                                               dtype=np.int32)


# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------

def _pieces():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 64) * 2).astype(np.float32)
    norm = {"scale": (1 + 0.1 * rng.randn(64)).astype(np.float32),
            "bias": (0.1 * rng.randn(64)).astype(np.float32)}
    mlp = {k: {"w": (rng.randn(*s) * 0.2).astype(np.float32),
               "b": (rng.randn(s[1]) * 0.1).astype(np.float32)}
           for k, s in (("up", (64, 96)), ("down", (96, 64)),
                        ("gate", (64, 96)))}
    return x, norm, mlp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("piece", ["silu", "gelu", "geglu", "layernorm",
                                   "mlp_gelu_ungated", "mlp_geglu_gated"])
def test_layer_pieces_match_jax(piece, dtype):
    """Activations bit-equal to JAX's in bf16 (op by op, constants
    rounded as XLA rounds them) and within float32 round-off; layernorm
    (biased variance) and the MLPs with biases allclose."""
    x, norm, mlp = _pieces()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def j(a):
        return jax.tree_util.tree_map(lambda v: jnp.asarray(v, jdt), a)

    def t(a):
        return jax.tree_util.tree_map(
            lambda v: bridge.array_to_tensor(np.asarray(jnp.asarray(v, jdt)),
                                             "cpu"), a)
    if piece in ("silu", "gelu", "geglu"):
        want = JL.activation_fn(piece)(j(x))
        got = L._ACT[piece](t(x))
        assert got.dtype == tdt
        if dtype == "bfloat16":
            np.testing.assert_array_equal(bridge.to_numpy(got),
                                          np.asarray(want, np.float32))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        return
    if piece == "layernorm":
        want = JL.layernorm(j(norm), j(x))
        got = L.layernorm(t(norm), t(x))
        no_bias = L.layernorm({"scale": t(norm)["scale"]}, t(x))
        assert not torch.allclose(no_bias.float(), got.float())
    else:
        act = piece.split("_")[1]
        p = dict(mlp) if piece.endswith("_gated") else \
            {k: mlp[k] for k in ("up", "down")}
        want = JL.mlp(j(p), j(x), act)
        got = L.mlp(t(p), t(x), act)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(bridge.to_numpy(got),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# forward, prefill + decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", VARIANTS)
def test_forward_prefill_decode_match_jax(arch):
    """Forward logits, prefill logits and K/V, three decode steps'
    logits and cache: within 1e-4 of max|logit| (cache allclose)."""
    jcfg, jp, tcfg, tp = bridged(arch)
    toks = _tokens(jcfg.vocab)
    assert_logits(T.forward(tp, tcfg, torch.from_numpy(toks).long()),
                  JT.forward(jp, jcfg, jnp.asarray(toks)))
    lj, cj = JT.prefill(jp, jcfg, jnp.asarray(toks), 16)
    lt, ct = T.prefill(tp, tcfg, torch.from_numpy(toks).long(), 16)
    assert_logits(lt, lj)
    tree_close(ct, cj)
    pos = np.array([12, 12], np.int32)
    for step in range(3):
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
        lj, cj = JT.decode_step(jp, jcfg, jnp.asarray(tok), cj,
                                jnp.asarray(pos + step))
        lt, ct = T.decode_step(tp, tcfg, torch.from_numpy(tok).long(), ct,
                               torch.from_numpy(pos + step).long())
        assert_logits(lt, lj)
        tree_close(ct, cj)


def test_variant_trees_have_what_their_configs_ask():
    """Biases and norm biases with ``use_bias``; no ``gate`` when
    ungated; no ``lm_head`` when tied; and the bias terms matter (with
    them zeroed the logits move)."""
    for arch in VARIANTS:
        _, _, tcfg, tp = bridged(arch)
        lay = tp["layers"]
        assert ("b" in lay["attn"]["wq"]) == tcfg.use_bias
        assert ("bias" in lay["attn_norm"]) == tcfg.use_bias
        assert ("gate" in lay["mlp"]) == tcfg.gated_mlp
        assert ("lm_head" in tp) != tcfg.tie_embeddings
    _, _, tcfg, tp = bridged("starcoder2-7b")
    toks = torch.from_numpy(_tokens(tcfg.vocab)).long()

    def unbiased(tree):
        return {k: (unbiased(v) if isinstance(v, dict) else
                    (torch.zeros_like(v) if k in ("b", "bias") else v))
                for k, v in tree.items()}
    assert not torch.allclose(T.forward(tp, tcfg, toks),
                              T.forward(unbiased(tp), tcfg, toks), atol=1e-3)


# ---------------------------------------------------------------------------
# decomposed KV (slab and paged)
# ---------------------------------------------------------------------------

def _z0(h):
    return np.asarray(_padded_z0(h, h))


@pytest.mark.parametrize("arch", VARIANTS)
def test_dkv_prefill_and_decode_match_jax(arch):
    """prefill_dkv (Lanczos at rank 8 with JAX's start vector) and four
    slab decode steps across a per-slot fold, both attention routes:
    logits within 1e-4 of max|logit| at every step."""
    jcfg, jp, tcfg, tp = bridged(arch)
    toks = _tokens(jcfg.vocab, s=12, seed=2)
    rank, tail = 8, 4
    lj, cj = JDK.prefill_dkv(jp, jcfg, jnp.asarray(toks), rank, tail=tail,
                             engine=JDEngine(JConfig()))
    lt, ct = DK.prefill_dkv(tp, tcfg, torch.from_numpy(toks).long(), rank,
                            tail=tail, engine=DecomposeEngine(z0=_z0))
    assert_logits(lt, lj)
    pos = np.array([12, 12], np.int32)
    frozen = pos.copy()
    for step in range(4):
        if step == 2:                   # slot 0 folds, slot 1 keeps its tail
            fold = np.array([True, False])
            nf = np.where(fold, pos, frozen).astype(np.int32)
            cj = JDK.compress_tail(cj, jcfg, rank, frozen_len=frozen,
                                   fold=fold, new_frozen=nf)
            ct = DK.compress_tail(ct, tcfg, rank,
                                  frozen_len=torch.from_numpy(frozen),
                                  fold=torch.from_numpy(fold),
                                  new_frozen=torch.from_numpy(nf))
            frozen = nf
        tok = np.array([5 + step, 40 + step], np.int32)
        lj, cj = JDK.decode_step_dkv(jp, jcfg, jnp.asarray(tok), cj,
                                     jnp.asarray(pos), jnp.asarray(frozen))
        for route in ("kernel", "plain"):
            c = jax.tree_util.tree_map(lambda x: x.clone(), ct)
            lt, c = DK.decode_step_dkv(tp, tcfg, torch.from_numpy(tok).long(),
                                       c, torch.from_numpy(pos),
                                       torch.from_numpy(frozen),
                                       attention=route)
            assert_logits(lt, lj)
        ct = c
        pos = pos + 1


def _paged_state(cfg, rng):
    """A random paged cache of 2 slots (page 4, U pool rank 8, sink page 0
    all zero): frozen lengths 9 / 6, tails 2 / 1 rows deep."""
    nl, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def pool(*shape, s=1.0):
        a = (rng.randn(*shape) * s).astype(np.float32)
        a[:, 0] = 0
        return a
    cache = {"k_u_pages": pool(nl, 10, 4, 8, s=0.3),
             "v_u_pages": pool(nl, 10, 4, 8),
             "k_vt": (rng.randn(nl, 2, 8, kvh * hd) * 0.3).astype(
                 np.float32),
             "v_vt": (rng.randn(nl, 2, 8, kvh * hd) * 0.3).astype(
                 np.float32),
             "tail": {"k_pages": pool(nl, 4, 4, kvh, hd),
                      "v_pages": pool(nl, 4, 4, kvh, hd)}}
    frozen = np.array([9, 6], np.int32)
    return (cache, frozen, frozen + np.array([2, 1], np.int32),
            np.array([[3, 7, 5], [2, 9, 0]], np.int32),
            np.array([[1], [3]], np.int32))


def _map(tree, f):
    if isinstance(tree, dict):
        return {k: _map(v, f) for k, v in tree.items()}
    return f(tree)


@pytest.mark.parametrize("arch", VARIANTS)
def test_dkv_paged_decode_matches_jax(arch):
    """One paged decode step through the block tables, both routes:
    logits within 1e-4 of max|logit| and the tail pages allclose."""
    jcfg, jp, tcfg, tp = bridged(arch)
    cache, frozen, pos, bt_u, bt_t = _paged_state(tcfg,
                                                  np.random.RandomState(5))
    tok = np.array([3, 17], np.int32)
    geom = (9, 6, 4)
    lj, cj = JDK.decode_step_dkv_paged(
        jp, jcfg, jnp.asarray(tok), _map(cache, jnp.asarray),
        jnp.asarray(pos), jnp.asarray(frozen), jnp.asarray(bt_u),
        jnp.asarray(bt_t), *geom)
    for route in ("kernel", "plain"):
        lt, ct = DK.decode_step_dkv_paged(
            tp, tcfg, torch.from_numpy(tok).long(),
            _map(cache, lambda a: torch.from_numpy(a.copy())),
            torch.from_numpy(pos), torch.from_numpy(frozen),
            torch.from_numpy(bt_u), torch.from_numpy(bt_t), *geom,
            attention=route)
        assert_logits(lt, lj)
        for key in ("k_pages", "v_pages"):
            np.testing.assert_allclose(ct["tail"][key][:, 1:].numpy(),
                                       np.asarray(cj["tail"][key])[:, 1:],
                                       **CLOSE)


# ---------------------------------------------------------------------------
# the decomposed (activation) forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", VARIANTS)
def test_decomposed_forward_matches_reference(arch):
    """Both layers decomposed (rank 4, 3 % outliers; biases as one extra
    rank): the same outlier channels at every decomposition and logits
    within 1e-3 (the Lanczos round-off of test_torch_decomposed.py),
    against the reference's forward on its ``backend="reference"``
    engine."""
    jcfg, jp, tcfg, tp = bridged(arch)
    toks = _tokens(jcfg.vocab, s=32, seed=3)
    kw = dict(rank=4, outlier_frac=0.03)
    jpo = jpol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw)
    tpo = pol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw)
    jrt = JD.DecomposedRuntime(engine=JDEngine(JConfig(
        policy=jpo, backend="reference")))
    teng = DecomposeEngine(EngineConfig(policy=tpo), z0=_z0)
    logs = ([], [])
    for eng, log in ((jrt.engine, logs[0]), (teng, logs[1])):
        orig = eng.decompose_activation

        def rec(*a, _orig=orig, _log=log, **k):
            out = _orig(*a, **k)
            _log.append(np.asarray(out.o_idx))
            return out
        eng.decompose_activation = rec
    lj = JD.forward(jp, jcfg, jnp.asarray(toks), jrt)
    lt = D.forward(tp, tcfg, torch.from_numpy(toks).long(), teng)
    assert len(logs[0]) == len(logs[1]) == 4
    for a, b in zip(*logs):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

LENS, NEW, MAX_LEN = (12, 7, 15), 10, 64


def _prompts(vocab, lens=LENS):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


def serve(eng, request_cls, prompts, stagger=True):
    """Request 0 first, request i at step 3i (or all at once)."""
    done = []
    if not stagger:
        for i, p in enumerate(prompts):
            eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=NEW))
        done = eng.run()
    else:
        eng.submit(request_cls(uid=0, prompt=prompts[0], max_new_tokens=NEW))
        arrivals = {3 * i: i for i in range(1, len(prompts))}
        for step in range(300):
            if step in arrivals:
                i = arrivals[step]
                eng.submit(request_cls(uid=i, prompt=prompts[i],
                                       max_new_tokens=NEW))
            done.extend(eng.step())
            if len(done) == len(prompts) and not any(eng.live):
                break
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r.out_tokens for r in done}, eng


DKV = dict(decompose_kv_rank=64, dkv_tail=4, dkv_exact=True)


@pytest.mark.parametrize("kind", ["dense", "dkv"])
@pytest.mark.parametrize("arch", VARIANTS)
def test_serving_tokens_equal_jax(arch, kind):
    """Staggered serving on 2 slots: the port's greedy tokens equal the
    JAX engine's, single-step and fused (decode_block 3), and the port's
    paged decomposed-KV engine gives the same tokens; decomposed-KV tails
    fold."""
    jcfg, jp, tcfg, tp = bridged(arch)
    prompts = _prompts(jcfg.vocab)
    kw = {} if kind == "dense" else dict(DKV)
    want, _ = serve(JEngine(jcfg, jp, slots=2, max_len=MAX_LEN, **kw),
                    JRequest, prompts)
    runs = [(1, False), (3, False)] + ([(3, True)] if kind == "dkv" else [])
    for block, paged in runs:
        tkw = dict(kw, paged=True, decompose_engine=DecomposeEngine(
            EngineConfig(kv_page=4))) if paged else kw
        got, eng = serve(Engine(tcfg, tp, slots=2, max_len=MAX_LEN,
                                device="cpu", decode_block=block, **tkw),
                         Request, prompts)
        assert got == want, (arch, kind, block, paged)
        if kind != "dense":
            assert eng.stats.tail_folds > 0
        if block > 1:
            assert eng.stats.blocks < eng.stats.decode_steps


@pytest.mark.parametrize("arch", VARIANTS)
def test_bf16_staggered_equals_solo(arch):
    """bf16 weights: each request's tokens in the staggered 2-slot run
    equal its solo run's (rows never interact)."""
    _, _, tcfg, tp = bridged(arch, "bfloat16")
    prompts = _prompts(tcfg.vocab)
    both, _ = serve(Engine(tcfg, tp, slots=2, max_len=MAX_LEN,
                           device="cpu"), Request, prompts)
    for i, p in enumerate(prompts):
        solo, _ = serve(Engine(tcfg, tp, slots=1, max_len=MAX_LEN,
                               device="cpu"), Request, [p], stagger=False)
        assert solo[0] == both[i], (arch, i)
