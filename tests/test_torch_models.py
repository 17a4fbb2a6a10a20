"""Dense transformer and decomposed-KV model functions of the port
against the JAX package, with the JAX weights bridged through numpy.

float32 configs carry the tight bars (the algorithm); one bf16 case
checks the storage type with a bar set by bf16 rounding (8-bit
mantissa, rounded at different places by the two frameworks).
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
from repro.engine import DecomposeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import decomposed_kv as JDK  # noqa: E402
from repro.models import model_fns  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import decomposed_kv as DK  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)


def _models(dtype):
    jcfg = all_archs()["deepseek-7b"].reduced().replace(dtype=dtype)
    tcfg = get_arch("deepseek-7b").reduced().replace(dtype=dtype)
    params = model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def f32_models():
    return _models("float32")


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s),
                                               dtype=np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def test_prefill_and_decode_match_jax(f32_models):
    jcfg, jp, tcfg, tp = f32_models
    toks = _tokens(0, 2, 11, jcfg.vocab)
    lj, cj = JT.prefill(jp, jcfg, jnp.asarray(toks), 16)
    lt, ct = T.prefill(tp, tcfg, torch.from_numpy(toks).long(), 16)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(ct[k]), np.asarray(cj[k]), **F32)
    pos = np.array([11, 11], np.int32)
    for step, tok in enumerate(([3, 9], [17, 4])):
        lj, cj = JT.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), cj,
                                jnp.asarray(pos + step))
        lt, ct = T.decode_step(tp, tcfg, torch.tensor(tok), ct,
                               torch.from_numpy(pos + step).long())
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **F32)


def _dkv_decode_chain(jcfg, jp, tcfg, tp, rank, exact, steps=6):
    """Prefill + decode steps (crossing one per-slot fold) on both
    packages; yields (step, torch logits, jax logits)."""
    toks = _tokens(1, 2, 12, jcfg.vocab)
    tail = 4
    jeng = JEngine(JConfig())
    teng = DecomposeEngine(EngineConfig(), z0=lambda h: np.asarray(
        _padded_z0(h, h)))
    lj, cj = JDK.prefill_dkv(jp, jcfg, jnp.asarray(toks), rank, tail=tail,
                             exact=exact, engine=jeng)
    lt, ct = DK.prefill_dkv(tp, tcfg, torch.from_numpy(toks).long(), rank,
                            tail=tail, exact=exact, engine=teng)
    yield -1, lt, lj
    pos = np.array([12, 12], np.int32)
    frozen = np.array([12, 12], np.int32)
    for step in range(steps):
        if step == 3:          # slot 0 folds, slot 1 keeps its tail
            fold = np.array([True, False])
            nf = np.where(fold, pos, frozen).astype(np.int32)
            cj = JDK.compress_tail(cj, jcfg, rank, frozen_len=frozen,
                                   fold=fold, new_frozen=nf)
            ct = DK.compress_tail(ct, tcfg, rank,
                                  frozen_len=torch.from_numpy(frozen),
                                  fold=torch.from_numpy(fold),
                                  new_frozen=torch.from_numpy(nf))
            frozen = nf
        tok = [5 + step, 40 + step]
        lj, cj = JDK.decode_step_dkv(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                     cj, jnp.asarray(pos),
                                     jnp.asarray(frozen))
        lt, ct = DK.decode_step_dkv(tp, tcfg, torch.tensor(tok), ct,
                                    torch.from_numpy(pos),
                                    torch.from_numpy(frozen))
        yield step, lt, lj
        pos = pos + 1


def test_dkv_decode_logits_match_jax_exact(f32_models):
    """Direct-SVD factorization: per-step logits across a per-slot fold."""
    for step, lt, lj in _dkv_decode_chain(*f32_models, rank=64, exact=True):
        np.testing.assert_allclose(_np(lt), np.asarray(lj), **F32,
                                   err_msg=f"step {step}")


def test_dkv_decode_logits_match_jax_lanczos(f32_models):
    """Lanczos factorization with JAX's start vector, at a truncating
    rank (the approximation the paper serves)."""
    for step, lt, lj in _dkv_decode_chain(*f32_models, rank=8, exact=False):
        np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=1e-3,
                                   atol=1e-3, err_msg=f"step {step}")


def test_dkv_kernel_route_equals_plain_route(f32_models):
    """The kernel route (stats + merge) == the plain joint softmax."""
    _, _, tcfg, tp = f32_models
    toks = torch.from_numpy(_tokens(2, 2, 10, tcfg.vocab)).long()
    _, c = DK.prefill_dkv(tp, tcfg, toks, 6, tail=4)
    pos = torch.tensor([10, 10], dtype=torch.int32)
    frozen = torch.tensor([10, 7], dtype=torch.int32)
    tok = torch.tensor([1, 2])
    lk, _ = DK.decode_step_dkv(tp, tcfg, tok, c, pos, frozen)
    lp, _ = DK.decode_step_dkv(tp, tcfg, tok, c, pos, frozen,
                               attention="plain")
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-5)


def test_bf16_prefill_and_dkv_decode_close_to_jax():
    """bf16 storage: logits within 0.1 abs (logits are O(1); bf16 keeps
    ~3 significant digits per rounding and the frameworks round at
    different places)."""
    jcfg, jp, tcfg, tp = _models("bfloat16")
    for step, lt, lj in _dkv_decode_chain(jcfg, jp, tcfg, tp, rank=64,
                                          exact=True, steps=2):
        a, b = _np(lt), np.asarray(lj.astype(jnp.float32))
        np.testing.assert_allclose(a[:, :jcfg.vocab], b[:, :jcfg.vocab],
                                   atol=0.1, err_msg=f"step {step}")
