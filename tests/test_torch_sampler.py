"""The keyed sampler and the rest of ``Engine``'s signature.

``categorical_sampler`` draws with Gumbel-max over a counter-based hash
of (key, row, token id), keyed ``fold_in(fold_in(prng_key(seed),
stream), round)``.  It cannot draw JAX's tokens (``jax.random`` is not
replayable here), so its bars are the reference's property and the
distribution:

* fused blocks (1, 3, 8) give the single-step engine's tokens, dense and
  decomposed-KV (slab and paged), arrivals cut at the same rounds;
* the same seed gives the same tokens, another seed other tokens; async
  deterministic gives sync's tokens;
* a fixed-seed chi-square test of 20 000 draws at fixed logits against
  softmax(logits / T), over rows and over rounds;
* host and device derive the same keys (ints and int64 tensors).

Also: ``greedy_sampler`` keeps the reference's ``(logits, k)`` contract,
and the ``decompose_kv_rank``/``dkv_tail``/``dkv_exact`` knobs resolve
with the reference's precedence (an explicit 0 disables decomposed KV).
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
from repro.engine import DecomposeEngine as JDEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import greedy_sampler as jgreedy  # noqa: E402
from repro_torch import bridge, sampling  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import (Engine, Request,  # noqa: E402
                                 categorical_sampler, greedy_sampler)

LENS, NEW, MAX_LEN = (12, 7, 15, 9), 12, 64
ARRIVALS = {0: [0, 1], 3: [2], 6: [3]}
_MODELS = {}


def _models():
    if not _MODELS:
        jcfg = all_archs()["llama2-7b"].reduced().replace(dtype="float32")
        tcfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        _MODELS["f32"] = (jcfg, jp, tcfg, bridge.to_torch(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _MODELS["f32"]


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in LENS]


def drive(eng, prompts, arrivals=ARRIVALS):
    """Submit ``prompts[i]`` for each i of ``arrivals[r]`` once the engine
    has run r decode rounds, cutting a fused engine's blocks at those
    rounds (so every engine admits at the same rounds)."""
    block, rounds, done = eng.decode_block, sorted(arrivals), []
    n = sum(len(v) for v in arrivals.values())
    for _ in range(500):
        while rounds and rounds[0] <= eng._round:
            for i in arrivals[rounds.pop(0)]:
                eng.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=NEW))
        eng.decode_block = min(block, rounds[0] - eng._round) if rounds \
            else block
        done.extend(eng.step())
        if len(done) == n and not eng._occupied():
            break
    assert sorted(r.uid for r in done) == list(range(n))
    return {r.uid: r.out_tokens for r in done}


KINDS = {"dense": {},
         "dkv": dict(decompose_kv_rank=8, dkv_tail=4),
         "dkv-paged": dict(paged=True, decompose_engine=DecomposeEngine(
             EngineConfig(kv_rank=8, kv_tail=4, kv_page=4)))}


def _engine(kind, block=1, seed=0, temperature=1.0, **kw):
    _, _, tcfg, tp = _models()
    return Engine(tcfg, tp, slots=4, max_len=MAX_LEN, device="cpu",
                  decode_block=block, sample_seed=seed,
                  sampler=categorical_sampler(temperature),
                  **KINDS[kind], **kw)


_SINGLE = {}


def _single(kind, seed=0):
    if (kind, seed) not in _SINGLE:
        _SINGLE[kind, seed] = drive(_engine(kind, seed=seed),
                                    _prompts(_models()[2].vocab))
    return _SINGLE[kind, seed]


@pytest.mark.parametrize("block", [1, 3, 8])
@pytest.mark.parametrize("kind", list(KINDS))
def test_fused_keyed_tokens_equal_single_step(kind, block):
    eng = _engine(kind, block)
    got = drive(eng, _prompts(eng.cfg.vocab))
    assert got == _single(kind)
    if block > 1:
        assert eng.stats.blocks < eng.stats.decode_steps


@pytest.mark.parametrize("kind", ["dense", "dkv"])
def test_seed_decides_the_tokens(kind):
    """Seed 0 twice: the same tokens; seed 1: other tokens; and the
    draws are not greedy's."""
    prompts = _prompts(_models()[2].vocab)
    again = drive(_engine(kind, 3), prompts)
    assert again == _single(kind)
    assert _single(kind, seed=1) != _single(kind)
    greedy = drive(Engine(_models()[2], _models()[3], slots=4,
                          max_len=MAX_LEN, device="cpu", **KINDS[kind]),
                   prompts)
    assert greedy != _single(kind)


@pytest.mark.parametrize("block", [1, 3])
def test_async_deterministic_keyed_tokens_equal_sync(block):
    """Admission's first tokens come from stream 1 at the dispatch
    round, so async deterministic order replays sync's draws."""
    eng = _engine("dkv", block, prefill_async=True,
                  ready_order="deterministic")
    assert drive(eng, _prompts(eng.cfg.vocab)) == _single("dkv")


def test_tiny_temperature_is_greedy():
    _, _, tcfg, tp = _models()
    prompts = _prompts(tcfg.vocab)
    greedy = drive(Engine(tcfg, tp, slots=4, max_len=MAX_LEN, device="cpu"),
                   prompts)
    assert drive(_engine("dense", 3, temperature=1e-9), prompts) == greedy


# ---------------------------------------------------------------------------
# the draw itself
# ---------------------------------------------------------------------------

LOGITS = np.array([2.0, 1.0, 0.5, 0.0, -1.0, -2.0, 0.3, 1.5], np.float32)
CHI2_P001_DF7 = 24.322        # the 0.1 % point of chi-square with 7 df


def _chi2(draws, temperature):
    p = np.exp(LOGITS / temperature)
    p /= p.sum()
    counts = np.bincount(draws, minlength=len(LOGITS))
    want = p * len(draws)
    return float(((counts - want) ** 2 / want).sum())


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_draws_follow_softmax_chi_square(temperature):
    """20 000 draws at fixed logits, seed 0: over rows of one key and
    over rounds of one row, each within the chi-square test's 0.1 %
    point against softmax(logits / T)."""
    sample = categorical_sampler(temperature)
    key = sampling.fold_in(sampling.prng_key(0), 0)
    rows = sample(torch.from_numpy(np.tile(LOGITS, (20000, 1))), 1, key)
    assert rows.dtype == torch.int32
    assert _chi2(rows.numpy(), temperature) < CHI2_P001_DF7
    lg = torch.from_numpy(np.tile(LOGITS, (4, 1)))
    rounds = np.concatenate([
        sample(lg, 1, sampling.fold_in(key, r)).numpy() for r in range(5000)])
    assert _chi2(rounds, temperature) < CHI2_P001_DF7


def test_keys_are_the_same_on_host_and_device_form():
    """The hash gives the same keys from Python ints and int64 tensors,
    and the noise is a pure function of (key, row, token id)."""
    k = sampling.fold_in(sampling.prng_key(7), 1)
    for r in (0, 5, 2 ** 31 - 1):
        t = sampling.fold_in(torch.tensor(k), torch.tensor(r))
        assert int(t) == sampling.fold_in(k, r) < 2 ** 32
    g1 = sampling.gumbel(k, (3, 50), "cpu")
    g2 = sampling.gumbel(torch.tensor(k), (5, 50), "cpu")
    assert torch.equal(g1, g2[:3]) and torch.isfinite(g2).all()
    assert not torch.equal(g1, sampling.gumbel(k + 1, (3, 50), "cpu"))
    # the extreme hash values give finite noise (u strictly inside (0, 1))
    ext = sampling.uniform(torch.tensor([0, 2 ** 32 - 1]))
    assert 0 < float(ext[0]) and float(ext[1]) < 1
    assert torch.isfinite(-torch.log(-torch.log(ext))).all()
    # padded vocab rows masked at -1e30 are never drawn
    lg = torch.full((64, 16), -1e30)
    lg[:, :3] = 0.0
    assert int(categorical_sampler()(lg, 1, k).max()) < 3


def test_run_decode_block_keys_each_step_by_its_round():
    """A keyed sampler inside the fixed-length loop draws step i with
    ``fold_in(key, round0 + i)``: blocks of 3 from rounds 5 and 8 equal
    six single draws from round 5."""
    sample = categorical_sampler(1.0)
    key = sampling.fold_in(sampling.prng_key(3), 0)
    v = 40
    w = torch.randn(v, v, generator=torch.Generator().manual_seed(0))

    def step(t, c, p, live):
        return w[t] + p[:, None].float(), c
    tok, pos = torch.tensor([1, 2]), torch.tensor([0, 4])
    stops = torch.full((2, 1), -1, dtype=torch.int32)
    singles = []
    t, p = tok, pos
    for r in range(5, 11):
        nxt = sample(step(t, None, p, None)[0], 1,
                     sampling.fold_in(key, r)).long()
        singles.append(nxt)
        t, p = nxt, p + 1
    buf, steps, _, _ = api.run_decode_block(
        step, 3, tok, None, pos, 3, stops, sampler=sample,
        key=torch.tensor(key), round0=torch.tensor(5))
    buf2, _, _, _ = api.run_decode_block(
        step, 3, buf[-1].long(), None, pos + 3, 3, stops, sampler=sample,
        key=key, round0=8)
    assert int(steps) == 3
    assert torch.equal(torch.cat([buf, buf2]).long(), torch.stack(singles))


def test_greedy_sampler_keeps_the_reference_contract():
    lg = np.random.RandomState(0).randn(5, 33).astype(np.float32)
    got = greedy_sampler(torch.from_numpy(lg), 1)
    assert got.dtype == torch.int32 and got.shape == (5,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgreedy(jnp.asarray(lg), 1)))
    assert not getattr(greedy_sampler, "takes_key", False)
    assert categorical_sampler(0.5).takes_key


# ---------------------------------------------------------------------------
# the knob overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine_kw,knobs", [
    (None, {}),
    (None, dict(decompose_kv_rank=6, dkv_tail=3, dkv_exact=True)),
    (dict(kv_rank=8, kv_tail=4), {}),
    (dict(kv_rank=8, kv_tail=4), dict(decompose_kv_rank=0)),
    (dict(kv_rank=8, kv_tail=4, kv_exact=True),
     dict(decompose_kv_rank=5, dkv_tail=2, dkv_exact=False)),
])
def test_kv_knob_precedence_matches_reference(engine_kw, knobs):
    """An explicit knob wins (an explicit rank 0 disables decomposed KV
    even when the engine config sets a rank), None inherits the engine
    config's, and without an engine rank 0 and tail 16 — as the JAX
    engine resolves them."""
    jcfg, jp, tcfg, tp = _models()
    jkw = dict(knobs)
    tkw = dict(knobs)
    if engine_kw is not None:
        jkw["decompose_engine"] = JDEngine(JConfig(**engine_kw))
        tkw["decompose_engine"] = DecomposeEngine(EngineConfig(**engine_kw))
    je = JEngine(jcfg, jp, slots=2, max_len=32, **jkw)
    te = Engine(tcfg, tp, slots=2, max_len=32, device="cpu", **tkw)
    assert (te.dkv_rank, te.dkv_tail, te.dkv_exact) == \
        (je.dkv_rank, je.dkv_tail, je.dkv_exact)
    assert type(te.family).__name__ == type(je.family).__name__
