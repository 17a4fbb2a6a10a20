"""Kernel modules of the port against the JAX package.

On the host the wrappers run their plain PyTorch versions; those are
held against the Pallas kernels (interpret mode) and the ``kernels/ref``
oracles on the same numpy inputs.  The CUDA kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lanczos as jlz  # noqa: E402
from repro.kernels import dkv_attention as jdk, ref as jref  # noqa: E402
from repro.models import decomposed_kv as JDK  # noqa: E402
from repro_torch.kernels import dkv_attention as dk  # noqa: E402
from repro_torch.kernels import lanczos_reorth as lr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F = 8                         # the JAX kernels' expansion factor
TOL = dict(rtol=1e-4, atol=1e-4)   # float32, reduction orders differ


def _basis(rng, b, n, k, filled):
    q = np.zeros((b, n, k), np.float32)
    for i in range(b):
        q[i, :, :filled] = np.linalg.qr(rng.randn(n, filled))[0]
    return q


def _pad(x, axis, mult):
    pad = (-x.shape[axis]) % mult
    w = [(0, 0)] * x.ndim
    w[axis] = (0, pad)
    return np.pad(x, w)


@pytest.mark.parametrize("b,s,h,k", [(1, 16, 24, 6), (3, 21, 40, 9),
                                     (4, 32, 64, 12)])
def test_reorth_plain_matches_jax_steps_and_ref(b, s, h, k):
    """Plain re-orth pair == the JAX package's batched Lanczos steps
    (``DEFAULT_BATCHED_HOOKS``, what its Pallas kernels are tested
    against) == ``kernels/ref``, for B 1..4 and S, H that do not divide
    f.  The Pallas kernels themselves do not trace under jax 0.9
    (``pl.store`` is gone; ROADMAP C), so they are not called here."""
    rng = np.random.RandomState(b * 100 + s)
    a = rng.randn(b, s, h).astype(np.float32)
    u = rng.randn(b, s).astype(np.float32)
    v = rng.randn(b, h).astype(np.float32)
    vb = _basis(rng, b, h, k, k // 2)
    ub = _basis(rng, b, s, k, k // 2)

    z_t, zn_t = lr.reorth_right_batched(torch.from_numpy(a),
                                        torch.from_numpy(u),
                                        torch.from_numpy(vb))
    w_t, wn_t = lr.reorth_left_batched(torch.from_numpy(a),
                                       torch.from_numpy(v),
                                       torch.from_numpy(ub))
    hooks = jlz.DEFAULT_BATCHED_HOOKS
    z_j = hooks.right_step(jnp.asarray(a), jnp.asarray(u), jnp.asarray(vb))
    w_j = hooks.left_step(jnp.asarray(a), jnp.asarray(v), jnp.asarray(ub))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **TOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **TOL)
    for i in range(b):
        zr, znr = jref.reorth_right(a[i], u[i], vb[i])
        wr, wnr = jref.reorth_left(a[i], v[i], ub[i])
        np.testing.assert_allclose(z_t[i].numpy(), np.asarray(zr), **TOL)
        np.testing.assert_allclose(w_t[i].numpy(), np.asarray(wr), **TOL)
        np.testing.assert_allclose(zn_t[i].item(), float(znr), rtol=1e-4)
        np.testing.assert_allclose(wn_t[i].item(), float(wnr), rtol=1e-4)


def test_hooks_and_counters_on_host():
    """The hook factory returns the step outputs, and host calls never
    count as kernel launches."""
    ops.reset_launch_counts()
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(2, 5, 7).astype(np.float32))
    hooks = ops.make_batched_hooks(8)
    z = hooks.right_step(a, torch.ones(2, 5), torch.zeros(2, 7, 3))
    torch.testing.assert_close(z, torch.einsum("bsh,bs->bh", a,
                                               torch.ones(2, 5)))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _dkv_inputs(seed, b=3, kvh=2, g=2, t=13, r=6):
    rng = np.random.RandomState(seed)
    inner = rng.randn(b, kvh * g, r).astype(np.float32)
    k_u = rng.randn(b, t, r).astype(np.float32)
    v_u = rng.randn(b, t, r).astype(np.float32)
    return inner, k_u, v_u


def test_dkv_stats_plain_matches_pallas_per_slot_t_valid():
    """Plain stats over all heads of every slot == the JAX Pallas kernel
    run per (slot, kv-head) with that slot's static t_valid."""
    inner, k_u, v_u = _dkv_inputs(1)
    b, nh, r = inner.shape
    kvh, g = 2, nh // 2
    tv = np.array([13, 5, 9], np.int32)
    a, m, l_ = dk.dkv_attention_stats(torch.from_numpy(inner),
                                      torch.from_numpy(k_u),
                                      torch.from_numpy(v_u),
                                      torch.from_numpy(tv))
    for i in range(b):
        for kh in range(kvh):
            sl = slice(kh * g, (kh + 1) * g)
            kp = _pad(k_u[i], 0, F)
            vp = _pad(v_u[i], 0, F)
            aj, mj, lj = jdk.dkv_attention_stats(
                inner[i, sl], kp, vp, expansion=F, interpret=True,
                t_valid=int(tv[i]))
            np.testing.assert_allclose(a[i, sl].numpy(), np.asarray(aj),
                                       **TOL)
            np.testing.assert_allclose(m[i, sl].numpy(),
                                       np.asarray(mj)[:, 0], **TOL)
            np.testing.assert_allclose(l_[i, sl].numpy(),
                                       np.asarray(lj)[:, 0], **TOL)
    # full-length slot against the oracle too
    ar, mr, lr_ = jref.dkv_attention_stats(inner[0], k_u[0], v_u[0])
    np.testing.assert_allclose(a[0].numpy(), np.asarray(ar), **TOL)
    np.testing.assert_allclose(l_[0].numpy(), np.asarray(lr_)[:, 0], **TOL)


class _Cfg:
    num_heads, num_kv_heads, resolved_head_dim = 4, 2, 8


def test_dkv_stats_and_merge_match_jax_lowrank_attention():
    """Prefix stats + exact-tail merge (the port's decode route) == JAX's
    joint-softmax ``_lowrank_attention`` with per-slot frozen_len."""
    from repro_torch.models import decomposed_kv as DK
    cfg = _Cfg()
    rng = np.random.RandomState(3)
    b, t, r, tl = 3, 10, 5, 4
    kvw = cfg.num_kv_heads * cfg.resolved_head_dim
    q = rng.randn(b, 1, cfg.num_heads, cfg.resolved_head_dim).astype(
        np.float32)
    c = {"k_u": rng.randn(b, t, r), "k_vt": rng.randn(b, r, kvw),
         "v_u": rng.randn(b, t, r), "v_vt": rng.randn(b, r, kvw)}
    c = {k: v.astype(np.float32) for k, v in c.items()}
    tail = {k: rng.randn(b, tl, 2, 8).astype(np.float32) for k in "kv"}
    frozen = np.array([10, 6, 3], np.int32)
    pos = frozen + np.array([0, 2, 3], np.int32)
    want = JDK._lowrank_attention(jnp.asarray(q), c, tail, jnp.asarray(pos),
                                  jnp.asarray(frozen), cfg)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    for route in (DK._factored_attention, DK._lowrank_attention):
        got = route(torch.from_numpy(q), tt(c), tt(tail),
                    torch.from_numpy(pos), torch.from_numpy(frozen), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Eq. 6 GEMM and outlier statistics (the activation path's kernels)
# ---------------------------------------------------------------------------

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import lowrank_matmul as lrmm  # noqa: E402
from repro_torch.kernels import outlier_extract as oe  # noqa: E402


@pytest.mark.parametrize("k,h,n", [(1, 100, 100), (20, 100, 256),
                                   (21, 96, 100), (20, 64, 256)])
def test_lowrank_matmul_plain_matches_pallas_and_ref(k, h, n):
    """Plain Vᵀ @ W == the JAX Pallas kernel (interpret mode; H = 100 does
    not divide f = 8, N = 100 is not a multiple of its 128 block) ==
    ``kernels/ref.py``, in float32; a batched Vᵀ [B, k, H] equals the
    per-element products."""
    rng = np.random.RandomState(k * 1000 + h + n)
    vt = rng.randn(3, k, h).astype(np.float32)
    w = rng.randn(h, n).astype(np.float32)
    got = lrmm.lowrank_matmul(torch.from_numpy(vt), torch.from_numpy(w))
    assert got.shape == (3, k, n) and got.dtype == torch.float32
    for i in range(3):
        want = jops.lowrank_matmul(vt[i], w, expansion=F, interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(jref.lowrank_matmul(vt[i], w)),
                                   **TOL)


def test_lowrank_matmul_plain_returns_vt_dtype():
    """bf16 in, bf16 out: the float32 product rounded once, as the
    reference einsum returns it."""
    rng = np.random.RandomState(5)
    vt = torch.from_numpy(rng.randn(20, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(64, 48).astype(np.float32)).bfloat16()
    got = lrmm.lowrank_matmul(vt, w)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, (vt.float() @ w.float()).bfloat16(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("s,h,t", [(64, 96, 1.5), (32, 512, 2.0)])
def test_outlier_stats_plain_matches_pallas(s, h, t):
    """Counts and max |x| == the JAX Pallas kernel (interpret mode; S
    divisible by f, as it asserts), exactly: both are exact."""
    rng = np.random.RandomState(s + h)
    x = rng.randn(2, s, h).astype(np.float32)
    x[:, :, 7] *= 10.0
    cnt, mx = oe.outlier_stats(torch.from_numpy(x), t)
    assert cnt.shape == mx.shape == (2, h)
    for i in range(2):
        cj, mj = jops.outlier_stats(x[i], t, expansion=F, interpret=True)
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(cj))
        np.testing.assert_array_equal(mx[i].numpy(), np.asarray(mj))
    assert cnt[:, 7].min() > 0


@pytest.mark.parametrize("s,h", [(13, 37), (1, 5), (50, 130)])
def test_outlier_stats_plain_matches_ref_ragged(s, h):
    """Ragged S and H (the CUDA kernel masks them) against the oracle."""
    rng = np.random.RandomState(s * h)
    x = (rng.randn(s, h) * 3).astype(np.float32)
    cnt, mx = oe.outlier_stats(torch.from_numpy(x), 2.5)
    cr, mr = jref.outlier_stats(x, 2.5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mr))


def test_reorth_scalar_pair_is_batched_at_b1():
    """``reorth_right``/``reorth_left`` (one A [S, H]) == the batched
    plain versions at B = 1 == ``kernels/ref.py``."""
    rng = np.random.RandomState(9)
    s, h, k = 19, 27, 6
    a = rng.randn(s, h).astype(np.float32)
    u, v = rng.randn(s).astype(np.float32), rng.randn(h).astype(np.float32)
    vb, ub = _basis(rng, 1, h, k, 3)[0], _basis(rng, 1, s, k, 3)[0]
    t = torch.from_numpy
    z, zn = lr.reorth_right(t(a), t(u), t(vb))
    w, wn = lr.reorth_left(t(a), t(v), t(ub))
    zb, znb = lr.reorth_right_batched_plain(t(a)[None], t(u)[None],
                                            t(vb)[None])
    wb, wnb = lr.reorth_left_batched_plain(t(a)[None], t(v)[None],
                                           t(ub)[None])
    torch.testing.assert_close(z, zb[0], rtol=0, atol=0)
    torch.testing.assert_close(w, wb[0], rtol=0, atol=0)
    assert zn.item() == znb[0].item() and wn.item() == wnb[0].item()
    np.testing.assert_allclose(z.numpy(), np.asarray(jref.reorth_right(
        a, u, vb)[0]), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jref.reorth_left(
        a, v, ub)[0]), **TOL)


def test_reference_backend_runs_plain_versions():
    """``make_kernels("reference")`` hands out the plain versions; the
    default set dispatches through the counted wrappers."""
    ref_set = ops.make_kernels("reference")
    assert ref_set.lowrank_matmul is lrmm.lowrank_matmul_plain
    assert ref_set.outlier_stats is oe.outlier_stats_plain
    cuda_set = ops.make_kernels("cuda")
    assert cuda_set.lowrank_matmul is ops.KERNELS["lowrank_matmul"]
    assert cuda_set.outlier_stats is ops.KERNELS["outlier_stats"]
    with pytest.raises(ValueError, match="backend"):
        ops.make_kernels("pallas")
