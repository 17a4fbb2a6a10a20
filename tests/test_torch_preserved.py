"""LowRank algebra and the preserved-form products (paper §3.2, Eq. 6/7)
of the port against the JAX package, on the same numpy factors.

float32 throughout; products reduce in different orders, hence
rtol/atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lowrank as jlr  # noqa: E402
from repro.core import preserved as jpr  # noqa: E402
from repro_torch.core import lowrank as lr  # noqa: E402
from repro_torch.core import preserved as pr  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, H, K, C = 2, 12, 16, 3, 2


def _factors(seed, batched_idx=True, diag=True):
    rng = np.random.RandomState(seed)
    f = dict(u=rng.randn(B, S, K), vt=rng.randn(B, K, H),
             core=rng.rand(B, K) + 0.5 if diag else rng.randn(B, K, K))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    if batched_idx:
        idx = np.stack([np.sort(rng.choice(H, C, replace=False))
                        for _ in range(B)])
    else:
        idx = np.sort(rng.choice(H, C, replace=False))
    f["o_idx"] = idx.astype(np.int64)
    f["o_dense"] = rng.randn(B, S, C).astype(np.float32)
    return f


def _pair(f, outliers=True):
    """The same LowRank in both packages."""
    keys = ("u", "core", "vt") + (("o_idx", "o_dense") if outliers else ())
    j = jlr.LowRank(**{k: jnp.asarray(f[k].astype(np.int32) if k == "o_idx"
                                      else f[k]) for k in keys})
    t = lr.LowRank(**{k: torch.from_numpy(f[k]) for k in keys})
    return j, t


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("batched_idx", [True, False])
def test_reconstruct_and_channel_helpers(batched_idx):
    f = _factors(0, batched_idx)
    j, t = _pair(f)
    _close(t.reconstruct(), j.reconstruct())
    x = np.random.RandomState(1).randn(B, S, H).astype(np.float32)
    xi = jnp.asarray(f["o_idx"].astype(np.int32))
    ti = torch.from_numpy(f["o_idx"])
    _close(lr.gather_channels(torch.from_numpy(x), ti),
           jlr.gather_channels(jnp.asarray(x), xi))
    _close(lr.zero_channels(torch.from_numpy(x), ti),
           jlr.zero_channels(jnp.asarray(x), xi))
    _close(lr.relative_error(t, torch.from_numpy(x)),
           jlr.relative_error(j, jnp.asarray(x)))
    assert t.has_outliers and t.hidden == H and t.rank == K
    assert not t.without_outliers().has_outliers
    bf = t.astype(torch.bfloat16)
    assert bf.u.dtype == torch.bfloat16 and bf.o_idx.dtype == torch.int64


@pytest.mark.parametrize("diag", [True, False])
def test_add_bias_rank_rank_concat_retruncate(diag):
    f = _factors(2, diag=diag)
    j, t = _pair(f)
    bias = np.random.RandomState(3).randn(H).astype(np.float32)
    _close(lr.add_bias_rank(t, torch.from_numpy(bias)).reconstruct(),
           jlr.add_bias_rank(j, jnp.asarray(bias)).reconstruct())
    j2, t2 = _pair(_factors(4, diag=diag), outliers=False)
    _close(lr.rank_concat(t, t2).reconstruct(),
           jlr.rank_concat(j, j2).reconstruct())
    # retruncate carries the outlier track through untouched
    rt = lr.retruncate(t, K)
    assert rt.o_dense is t.o_dense and rt.o_idx is t.o_idx
    _close(rt.reconstruct(), jlr.retruncate(j, K).reconstruct())


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("batched_idx", [True, False])
def test_eq6_with_outlier_track_and_bias(with_bias, batched_idx):
    """Vᵀ* = Vᵀ W with the dense outlier track turned into (vals, W[idx])
    and the bias as one extra rank; then a second Eq. 6 product pushes W
    through the factored track (the chain case)."""
    f = _factors(5, batched_idx)
    j, t = _pair(f)
    rng = np.random.RandomState(6)
    w = rng.randn(H, 10).astype(np.float32)
    w2 = rng.randn(10, 7).astype(np.float32)
    bias = rng.randn(10).astype(np.float32) if with_bias else None
    yj = jpr.lowrank_matmul(j, jnp.asarray(w),
                            bias=None if bias is None else jnp.asarray(bias))
    yt = pr.lowrank_matmul(t, torch.from_numpy(w),
                           bias=None if bias is None else torch.from_numpy(
                               bias))
    _close(yt.vt, yj.vt)
    _close(yt.o_vt, yj.o_vt)
    _close(yt.reconstruct(), yj.reconstruct())
    _close(yt.reconstruct(),
           np.einsum("bsh,hn->bsn", np.asarray(j.reconstruct()), w)
           + (0 if bias is None else bias))
    _close(pr.lowrank_matmul(yt, torch.from_numpy(w2)).reconstruct(),
           jpr.lowrank_matmul(yj, jnp.asarray(w2)).reconstruct())


def test_eq7_input_weight_chain():
    """Σ* = Σ_I (Vᵀ_I U_W Σ_W): the dense outlier track lands on U_W's
    rows; a second Eq. 7 product covers the factored track."""
    f = _factors(7)
    j, t = _pair(f)
    rng = np.random.RandomState(8)
    w = rng.randn(H, 20).astype(np.float32)
    wj = jpr.decompose_weight(jnp.asarray(w), 6)
    wt = pr.decompose_weight(torch.from_numpy(w), 6)
    _close(wt.reconstruct(), wj.reconstruct())
    yj = jpr.lowrank_x_lowrank_weight(j, wj)
    yt = pr.lowrank_x_lowrank_weight(t, wt)
    assert not yt.core_is_diag
    _close(yt.reconstruct(), yj.reconstruct())
    w2 = rng.randn(20, 9).astype(np.float32)
    wj2 = jpr.decompose_weight(jnp.asarray(w2), 5)
    wt2 = pr.decompose_weight(torch.from_numpy(w2), 5)
    _close(pr.lowrank_x_lowrank_weight(yt, wt2).reconstruct(),
           jpr.lowrank_x_lowrank_weight(yj, wj2).reconstruct())


@pytest.mark.parametrize("outliers", [True, False])
def test_preserved_qk_and_pv_gqa(outliers):
    """Scores and P·V through the factors with nh = 4, kvh = 2 (GQA)."""
    nh, kvh, dh = 4, 2, 4
    rng = np.random.RandomState(9)
    f = _factors(10)
    j, t = _pair(f, outliers)
    wq = rng.randn(H, nh * dh).astype(np.float32)
    wk = rng.randn(H, kvh * dh).astype(np.float32)
    qj, kj = (jpr.lowrank_matmul(j, jnp.asarray(w)) for w in (wq, wk))
    qt, kt = (pr.lowrank_matmul(t, torch.from_numpy(w)) for w in (wq, wk))
    scj = jpr.preserved_qk_scores(qj, kj, nh, dh ** -0.5, kvh)
    sct = pr.preserved_qk_scores(qt, kt, nh, dh ** -0.5, kvh)
    assert sct.shape == (B, nh, S, S)
    _close(sct, scj)
    p = np.asarray(jnp.exp(scj - scj.max(-1, keepdims=True)))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    _close(pr.preserved_pv(torch.from_numpy(p), kt, nh, kvh),
           jpr.preserved_pv(jnp.asarray(p), kj, nh, kvh))


def test_flop_helpers_equal_jax():
    dims = (4096, 20, 4096, 11008)
    assert pr.plan_chain(dims) == jpr.plan_chain(dims)
    assert pr.chain_flops(dims, [1, 0]) == jpr.chain_flops(dims, [1, 0])
    args = (4096, 4096, 11008, 20, 20, 64, 64)
    assert pr.compute_reduction_ratio_input_weight(*args) == \
        jpr.compute_reduction_ratio_input_weight(*args)
    assert pr.activation_compression_ratio(4096, 4096, 20, 20) == \
        jpr.activation_compression_ratio(4096, 4096, 20, 20)
    assert pr.weight_compression_ratio(4096, 11008, 64, 64) == \
        jpr.weight_compression_ratio(4096, 11008, 64, 64)
    assert pr.weight_rank_break_even(4096, 11008) == \
        jpr.weight_rank_break_even(4096, 11008)
    assert pr.compute_reduction_ratio_input_only(4096, 20) == \
        jpr.compute_reduction_ratio_input_only(4096, 20)
