"""Serving conformance of the port against the JAX package.

The recipe of ``test_serving_conformance.py::
test_dkv_matches_dense_token_level`` (reduced deepseek-7b, rank 64,
tail 4, max_len 64, 12 new tokens, prompts of 12/7/15 tokens, staggered
arrivals, 2 and 4 slots) runs on both packages with the same bridged
weights; greedy tokens must be EQUAL and tails must fold.  A Lanczos
case (no direct SVD) runs with JAX's start vector injected.

The cross-package bar runs in float32.  In bf16 the two frameworks
round differently (XLA's float32 rsqrt and reduction orders differ from
PyTorch's by an ulp, which moves a bf16 rounding, which flips a greedy
argmax at a near-tie — ROADMAP C), so the bf16 recipe holds the port to
the reference's own bar instead: decomposed-KV tokens == dense tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import model_fns  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

RANK, TAIL, MAX_LEN, MAX_NEW = 64, 4, 64, 12
PROMPT_LENS = (12, 7, 15)


def _models(dtype):
    jcfg = all_archs()["deepseek-7b"].reduced().replace(dtype=dtype)
    params = model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    tcfg = get_arch("deepseek-7b").reduced().replace(dtype=dtype)
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in PROMPT_LENS]


def _serve(eng, request_cls, prompts, stagger):
    done = []
    if not stagger:
        for i, p in enumerate(prompts):
            eng.submit(request_cls(uid=i, prompt=p, max_new_tokens=MAX_NEW))
        done = eng.run()
    else:
        eng.submit(request_cls(uid=0, prompt=prompts[0],
                               max_new_tokens=MAX_NEW))
        arrivals = {3 * i: i for i in range(1, len(prompts))}
        for step in range(200):
            if step in arrivals:
                i = arrivals[step]
                eng.submit(request_cls(uid=i, prompt=prompts[i],
                                       max_new_tokens=MAX_NEW))
            done.extend(eng.step())
            if len(done) == len(prompts) and not any(eng.live):
                break
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r.out_tokens for r in done}, eng.stats


JDKV = dict(max_len=MAX_LEN, decompose_kv_rank=RANK, dkv_tail=TAIL,
            dkv_exact=True)


def _dkv_engine(tcfg, tp, slots, exact=True, z0=None, backend="cuda"):
    """The port's engine at the recipe's settings (direct SVD unless
    ``exact`` is False)."""
    ecfg = EngineConfig(kv_rank=RANK, kv_tail=TAIL, kv_exact=exact,
                        backend=backend)
    return Engine(tcfg, tp, slots=slots, max_len=MAX_LEN, device="cpu",
                  decompose_engine=DecomposeEngine(ecfg, z0=z0))


@pytest.mark.parametrize("stagger,slots", [(False, 2), (True, 2), (True, 4)])
def test_dkv_serving_tokens_equal_jax(f32, stagger, slots):
    jcfg, jp, tcfg, tp = f32
    prompts = _prompts(jcfg.vocab)
    want, _ = _serve(JEngine(jcfg, jp, slots=slots, **JDKV), JRequest,
                     prompts, stagger)
    got, st = _serve(_dkv_engine(tcfg, tp, slots), Request, prompts,
                     stagger)
    assert st.tail_folds > 0
    if stagger:
        assert st.prefill_batches >= 2
    assert got == want


def test_dense_serving_tokens_equal_jax(f32):
    jcfg, jp, tcfg, tp = f32
    prompts = _prompts(jcfg.vocab)
    want, _ = _serve(JEngine(jcfg, jp, slots=2, max_len=MAX_LEN), JRequest,
                     prompts, True)
    got, _ = _serve(Engine(tcfg, tp, slots=2, max_len=MAX_LEN,
                           device="cpu"), Request, prompts, True)
    assert got == want


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_lanczos_dkv_serving_tokens_equal_jax(f32, backend):
    """Lanczos factorization (not direct SVD) with JAX's start vector;
    under ``backend="reference"`` decode takes the plain
    ``_lowrank_attention`` route and the tokens are the same."""
    jcfg, jp, tcfg, tp = f32
    prompts = _prompts(jcfg.vocab)
    want, _ = _serve(JEngine(jcfg, jp, slots=2, max_len=MAX_LEN,
                             decompose_kv_rank=RANK, dkv_tail=TAIL),
                     JRequest, prompts, True)
    eng = _dkv_engine(tcfg, tp, 2, exact=False,
                      z0=lambda h: np.asarray(_padded_z0(h, h)),
                      backend=backend)
    got, st = _serve(eng, Request, prompts, True)
    assert st.tail_folds > 0
    assert got == want


@pytest.mark.parametrize("stagger,slots", [(False, 2), (True, 4)])
def test_bf16_dkv_serving_tokens_equal_dense(stagger, slots):
    """The recipe in its own dtype (bf16), on the port alone: decomposed-
    KV greedy tokens == dense greedy tokens across tail folds."""
    _, _, tcfg, tp = _models("bfloat16")
    prompts = _prompts(tcfg.vocab)
    dense, _ = _serve(Engine(tcfg, tp, slots=slots, max_len=MAX_LEN,
                             device="cpu"), Request, prompts, stagger)
    dkv, st = _serve(_dkv_engine(tcfg, tp, slots), Request, prompts,
                     stagger)
    assert st.tail_folds > 0
    assert dkv == dense


def test_engine_reads_dkv_settings_from_engine_config():
    """The decompose engine's EngineConfig is the one source of the
    decomposed-KV rank, tail and factorization; without one the engine
    serves dense KV."""
    tcfg = get_arch("deepseek-7b").reduced().replace(dtype="float32")
    dense = Engine(tcfg, None, slots=2, max_len=MAX_LEN, device="cpu")
    assert dense.dkv_rank == 0
    assert type(dense.family).__name__ == "DenseKVServing"
    eng = _dkv_engine(tcfg, None, 2, exact=False)
    assert (eng.dkv_rank, eng.dkv_tail, eng.dkv_exact) == (RANK, TAIL, False)
    assert type(eng.family).__name__ == "TransformerDKVServing"
