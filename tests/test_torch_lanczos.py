"""Batched Lanczos and the decomposition engine of the port against the
JAX package, on the same numpy inputs and the same start vector.

Singular vectors are defined up to sign, so the tests compare singular
values and reconstructions, on synthetic low-rank matrices (a Gaussian
matrix has a flat spectrum and no meaningful rank-k truncation).
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

from repro.core import lanczos as jlz  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.engine import DecomposeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine.engine import _padded_z0  # noqa: E402
from repro_torch.core import lanczos as lz  # noqa: E402
from repro_torch.core import lowrank as lr  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

HOOKS = ops.make_batched_hooks()     # host tensors: the plain versions


def _lowrank_batch(seed, b, s, h, rank, noise=1e-3):
    """[b, s, h] matrices of rank ``rank`` with a decaying spectrum plus a
    little noise."""
    rng = np.random.RandomState(seed)
    out = np.empty((b, s, h), np.float32)
    for i in range(b):
        u = np.linalg.qr(rng.randn(s, rank))[0]
        v = np.linalg.qr(rng.randn(h, rank))[0]
        sv = 10.0 * 0.7 ** np.arange(rank)
        out[i] = (u * sv) @ v.T + noise * rng.randn(s, h)
    return out


def _jax_z0(h):
    return np.asarray(_padded_z0(h, h))


@pytest.mark.parametrize("b,s,h,rank,iters", [(1, 24, 40, 4, 8),
                                              (3, 33, 21, 5, 9),
                                              (4, 16, 64, 6, 6)])
def test_decompose_matches_jax(b, s, h, rank, iters):
    """Same z0 → same singular values and reconstructions (float32), for
    B 1..4 and shapes that divide nothing."""
    x = _lowrank_batch(b + s, b, s, h, rank + 2)
    z0 = _jax_z0(h)
    want = jlz.decompose(jnp.asarray(x), rank, iters=iters,
                         z0=jnp.asarray(z0))
    got = lz.decompose(torch.from_numpy(x), rank, iters,
                       z0=torch.from_numpy(z0), hooks=HOOKS)
    np.testing.assert_allclose(got.core.numpy(), np.asarray(want.core),
                               rtol=1e-4, atol=1e-4)
    rec_w = np.asarray(jnp.einsum("bsk,bkh->bsh", want.scaled_u(), want.vt))
    np.testing.assert_allclose(got.reconstruct().numpy(), rec_w,
                               rtol=1e-3, atol=1e-3)


def test_decompose_bf16_input_matches_jax():
    """bf16 input: float32 inside, factors back in bf16 (tolerance of the
    bf16 output rounding)."""
    x = _lowrank_batch(7, 2, 32, 48, 6)
    xb = jnp.asarray(x, jnp.bfloat16)
    z0 = _jax_z0(48)
    want = jlz.decompose(xb, 4, iters=8, z0=jnp.asarray(z0))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = lz.decompose(xt, 4, 8, z0=torch.from_numpy(z0), hooks=HOOKS)
    assert got.u.dtype == torch.bfloat16
    np.testing.assert_allclose(got.core.float().numpy(),
                               np.asarray(want.core.astype(jnp.float32)),
                               rtol=2e-2)


def test_decompose_kv_matches_jax_engine():
    """decompose_kv (Lanczos) with the JAX engine's start vector, and the
    exact SVD route, against ``repro.engine.DecomposeEngine``."""
    x = _lowrank_batch(11, 3, 20, 32, 5)
    jeng = JEngine(JConfig())
    teng = DecomposeEngine(EngineConfig(), z0=_jax_z0)
    for exact in (False, True):
        su_j, vt_j = jeng.decompose_kv(jnp.asarray(x), 6, exact=exact)
        su_t, vt_t = teng.decompose_kv(torch.from_numpy(x), 6, exact=exact)
        assert tuple(su_t.shape) == su_j.shape
        assert tuple(vt_t.shape) == vt_j.shape
        rec_j = np.asarray(jnp.einsum("bsk,bkh->bsh", su_j, vt_j))
        np.testing.assert_allclose((su_t @ vt_t).numpy(), rec_j,
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(
            torch.linalg.vector_norm(su_t, dim=1).numpy(),
            np.linalg.norm(np.asarray(su_j), axis=1), rtol=1e-4, atol=1e-4)
    # the rank caps at min(T, kvw)
    su, vt = teng.decompose_kv(torch.from_numpy(x[:, :4]), 64)
    assert su.shape[-1] == 4 and vt.shape[1] == 4


def test_retruncate_matches_jax():
    rng = np.random.RandomState(5)
    u = rng.randn(2, 12, 7).astype(np.float32)
    vt = rng.randn(2, 7, 9).astype(np.float32)
    core = np.ones((2, 7), np.float32)
    want = jlr.retruncate(jlr.LowRank(jnp.asarray(u), jnp.asarray(core),
                                      jnp.asarray(vt)), 4)
    got = lr.retruncate(lr.LowRank(torch.from_numpy(u),
                                   torch.from_numpy(core),
                                   torch.from_numpy(vt)), 4)
    np.testing.assert_allclose(got.core.numpy(), np.asarray(want.core),
                               rtol=1e-4, atol=1e-4)
    rec = np.asarray(jnp.einsum("bsk,bkh->bsh", want.scaled_u(), want.vt))
    np.testing.assert_allclose(got.reconstruct().numpy(), rec, rtol=1e-4,
                               atol=1e-4)


def test_default_start_vector_is_seeded_numpy():
    eng = DecomposeEngine()
    z = eng.start_vector(16, torch.device("cpu"))
    np.testing.assert_array_equal(
        z.numpy(), np.random.RandomState(0).standard_normal(16)
        .astype(np.float32))
    assert jax.devices()[0].platform == "cpu"
