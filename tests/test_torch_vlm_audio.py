"""The VLM (``llama-3.2-vision-11b``) and audio encoder-decoder
(``seamless-m4t-medium``) families of the port against the JAX package.

Reduced configs in float32 with the JAX init bridged through numpy, its
biases, norm biases and the VLM's cross gates redrawn non-zero with
numpy from a seed (the reference's zero gates close the cross block,
and its zero biases hide a missing bias add), and the image embeddings
and frames random:

* forward, prefill (logits and both caches) and three decode steps
  within 1e-4 of max|logit|; the cross path and the encoder input move
  the logits;
* ``prefill_inputs``, ``cache_batch_axes`` (the VLM's self K/V has its
  slot axis at 2) and an in-place splice;
* serving: greedy tokens equal the JAX engine's (whose image embeddings
  and frames are zeros, as the port's are), single-step and fused
  (decode_block 3), async deterministic too; bf16 staggered == solo;
  the admission cost counts the image tokens / frames; decomposed KV is
  refused for both families.
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
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import api, encdec, vlm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")
REL = 1e-4
CLOSE = dict(rtol=1e-5, atol=1e-5)
_MODELS = {}


def perturb(tree, rng):
    """Biases and norm biases N(0, 0.1²), cross gates uniform in
    ±[0.4, 0.9], every other leaf kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k in ("b", "bias"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(v.dtype)
        elif k in ("gate_attn", "gate_mlp"):
            g = rng.uniform(0.4, 0.9, v.shape) * rng.choice([-1, 1], v.shape)
            out[k] = np.asarray(g, v.dtype)
        else:
            out[k] = v
    return out


def bridged(arch, dtype="float32"):
    if (arch, dtype) not in _MODELS:
        jcfg = all_archs()[arch].reduced().replace(dtype=dtype)
        tcfg = get_arch(arch).reduced().replace(dtype=dtype)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tree = perturb(jax.tree_util.tree_map(np.asarray, jp),
                       np.random.RandomState(0))
        _MODELS[arch, dtype] = (jcfg,
                                jax.tree_util.tree_map(jnp.asarray, tree),
                                tcfg, bridge.to_torch(tree, "cpu"))
    return _MODELS[arch, dtype]


def assert_logits(t, j):
    t, j = bridge.to_numpy(t), np.asarray(j)
    assert t.shape == j.shape
    gap, scale = np.abs(t - j).max(), np.abs(j).max()
    assert gap <= REL * scale, f"max |Δ| {gap:.3e} > {REL} · {scale:.3e}"


def tree_close(t, j):
    if isinstance(t, dict):
        assert t.keys() == j.keys()
        for k in t:
            tree_close(t[k], j[k])
    else:
        np.testing.assert_allclose(bridge.to_numpy(t), np.asarray(j),
                                   **CLOSE)


def _inputs(cfg, b=2, s=10, seed=1):
    """(tokens, the family's extra input: image embeddings or frames),
    random, as numpy."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (b, s), dtype=np.int32)
    m = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
    extra = rng.randn(b, m, cfg.d_model).astype(np.float32)
    return toks, extra


def _args(cfg, toks, extra, to):
    """Positional prefill/forward inputs in the family's order."""
    t, e = to(toks), to(extra)
    return (t, e) if cfg.family == "vlm" else (e, t)


J = jnp.asarray


def T(a):
    t = torch.from_numpy(a)
    return t.long() if a.dtype == np.int32 else t


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, jp, tcfg, tp = bridged(arch)
    jm = vlm if tcfg.family == "vlm" else encdec
    jf = jmodel_fns(jcfg)
    toks, extra = _inputs(jcfg)
    assert_logits(jm.forward(tp, tcfg, *_args(tcfg, toks, extra, T)),
                  jf.forward(jp, jcfg, *_args(jcfg, toks, extra, J)))
    lj, cj = jf.prefill(jp, jcfg, *_args(jcfg, toks, extra, J), 16)
    lt, ct = api.model_fns(tcfg).prefill(tp, tcfg,
                                         *_args(tcfg, toks, extra, T), 16)
    assert_logits(lt, lj)
    tree_close(ct, cj)
    pos = np.array([10, 10], np.int32)
    for step in range(3):
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
        lj, cj = jf.decode_step(jp, jcfg, J(tok), cj, J(pos + step))
        lt, ct = api.model_fns(tcfg).decode_step(tp, tcfg, T(tok), ct,
                                                 T(pos + step))
        assert_logits(lt, lj)
        tree_close(ct, cj)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_path_and_extra_input_move_the_logits(arch):
    """The cross path is live: other image embeddings / frames change the
    logits, and so (VLM) does closing the gates."""
    _, _, tcfg, tp = bridged(arch)
    jm = vlm if tcfg.family == "vlm" else encdec
    toks, extra = _inputs(tcfg)
    base = jm.forward(tp, tcfg, *_args(tcfg, toks, extra, T))
    other = jm.forward(tp, tcfg, *_args(tcfg, toks, 2 * extra + 1, T))
    assert not torch.allclose(base, other, atol=1e-3)
    if tcfg.family == "vlm":
        shut = dict(tp, cross=dict(tp["cross"],
                                   gate_attn=torch.zeros_like(
                                       tp["cross"]["gate_attn"]),
                                   gate_mlp=torch.zeros_like(
                                       tp["cross"]["gate_mlp"])))
        closed = jm.forward(tp | shut, tcfg, *_args(tcfg, toks, extra, T))
        assert not torch.allclose(base, closed, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_inputs_and_batch_axes_match_jax(arch):
    """``prefill_inputs`` names the reference's shapes (the audio frames
    FIRST, ``num_audio_frames`` rows unless ``mem_len`` says otherwise);
    ``cache_batch_axes`` equals JAX's."""
    jcfg, tcfg = all_archs()[arch].reduced(), get_arch(arch).reduced()
    jf, tf = jmodel_fns(jcfg), api.model_fns(tcfg)
    for mem_len in (None, 7):
        want = jf.prefill_inputs(jcfg, jnp.zeros((3, 5), jnp.int32),
                                 jnp.zeros, mem_len)
        got = tf.prefill_inputs(tcfg, torch.zeros(3, 5, dtype=torch.long),
                                lambda s, d: torch.zeros(s, dtype=d), mem_len)
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    assert tf.batch_extras(tcfg, 2, 9, lambda s, d: s) == \
        jf.batch_extras(jcfg, 2, 9, lambda s, d: s)
    want = jax.tree_util.tree_map(int, japi.cache_batch_axes(jcfg))
    assert api.cache_batch_axes(tcfg) == want


def test_vlm_splice_writes_in_place_along_slot_axis_2():
    _, _, tcfg, _ = bridged("llama-3.2-vision-11b")
    fns = api.model_fns(tcfg)
    old = fns.init_cache(tcfg, 4, 8)
    ptrs = [t.data_ptr() for t in api.tree_leaves(old)]
    new = api.tree_map(lambda t: t + 1, fns.init_cache(tcfg, 2, 8))
    assert api.splice_cache(tcfg, old, new, [3, 1]) is old
    assert [t.data_ptr() for t in api.tree_leaves(old)] == ptrs
    for leaf, ax in zip(api.tree_leaves(old),
                        api.tree_leaves(api.cache_batch_axes(tcfg))):
        rows = leaf.movedim(ax, 0)
        assert bool((rows[[1, 3]] == 1).all())
        assert bool((rows[[0, 2]] == 0).all())
    assert api.cache_batch_axes(tcfg)["self"]["k"] == 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

LENS, NEW, MAX_LEN = (12, 7, 15), 10, 48


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in LENS]


def serve(eng, request_cls, prompts, stagger=True):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_tokens_equal_jax(arch):
    """Staggered on 2 slots: tokens equal the JAX engine's single-step,
    fused (decode_block 3, fewer blocks) and async deterministic."""
    jcfg, jp, tcfg, tp = bridged(arch)
    prompts = _prompts(jcfg.vocab)
    want, _ = serve(JEngine(jcfg, jp, slots=2, max_len=MAX_LEN), JRequest,
                    prompts)
    for kw in ({}, {"decode_block": 3},
               {"prefill_async": True, "ready_order": "deterministic"}):
        got, eng = serve(Engine(tcfg, tp, slots=2, max_len=MAX_LEN,
                                device="cpu", **kw), Request, prompts)
        assert got == want, (arch, kw)
        assert eng.stats.prefill_batches >= 2
        if kw.get("decode_block"):
            assert eng.stats.blocks < eng.stats.decode_steps


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_staggered_equals_solo_and_admission_cost(arch):
    _, _, tcfg, tp = bridged(arch, "bfloat16")
    prompts = _prompts(tcfg.vocab)
    both, eng = serve(Engine(tcfg, tp, slots=2, max_len=MAX_LEN,
                             device="cpu"), Request, prompts)
    for i, p in enumerate(prompts):
        solo, _ = serve(Engine(tcfg, tp, slots=1, max_len=MAX_LEN,
                               device="cpu"), Request, [p], stagger=False)
        assert solo[0] == both[i], (arch, i)
    extra = tcfg.num_image_tokens or tcfg.num_audio_frames
    assert type(eng.family).__name__ == \
        {"vlm": "VLMServing", "audio": "AudioServing"}[tcfg.family]
    req = Request(uid=9, prompt=prompts[0])
    assert eng.family.prefill_cost(req) == len(prompts[0]) + extra
    assert eng.sched.cost(req) == len(prompts[0]) + extra
    with pytest.raises(AssertionError, match="dense family only"):
        Engine(tcfg, tp, slots=2, max_len=MAX_LEN, device="cpu",
               decompose_kv_rank=8)
