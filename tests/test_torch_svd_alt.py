"""Fig. 2's SVD contenders and the scalar Lanczos of the port against
``repro.core.svd_alt`` and ``repro.core.lanczos``, on the same matrices
(synthetic low rank plus noise, made with numpy) and the reference's own
start matrices (``jax.random.normal(PRNGKey(0/1/2))`` passed in).

Tolerances: singular values within 1e-4 relative, reconstruction errors
within 1e-5 (float32 round-off of two LAPACKs and two matmul orders);
singular vectors are compared through the reconstructions (their signs
are free).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lanczos as jlz  # noqa: E402
from repro.core import svd_alt as jalt  # noqa: E402
from repro_torch.core import lanczos as lz  # noqa: E402
from repro_torch.core import svd_alt as alt  # noqa: E402
from repro_torch.kernels.ops import make_batched_hooks  # noqa: E402

S_REL = 1e-4
ERR = 1e-5
SHAPES = [(96, 64, 8), (160, 120, 12)]      # (S, H, true rank)


def _mat(s, h, r, seed=0):
    """A rank-r matrix plus 1 % noise (a Gaussian matrix's flat spectrum
    would make every truncation error ~1)."""
    g = np.random.RandomState(seed)
    a = g.standard_normal((s, r)) @ g.standard_normal((r, h))
    return (a + 0.01 * g.standard_normal((s, h))).astype(np.float32)


def _normal(key, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(key), shape,
                                      jnp.float32))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(np.asarray(b)))), 1e-30))


def _check(a, port, ref):
    """Singular values within S_REL and reconstruction errors within ERR
    of the reference's, and the rank-k products equal."""
    tu, ts, tvt = (x.numpy() for x in port)
    ju, js, jvt = (np.asarray(x) for x in ref)
    assert _rel(ts, js) < S_REL
    e_t = float(alt.reconstruction_error(torch.from_numpy(a), *port))
    e_j = float(jalt.reconstruction_error(jnp.asarray(a), *ref))
    assert abs(e_t - e_j) < ERR
    assert _rel((tu * ts) @ tvt, (ju * js) @ jvt) < 1e-4


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("rank", [1, 4, 8])
@pytest.mark.parametrize("which", ["oracle", "qr_iteration", "randomized"])
def test_contenders_match_reference(which, rank, shape):
    s, h, r = shape
    a = _mat(s, h, r)
    ta = torch.from_numpy(a)
    if which == "oracle":
        port, ref = alt.oracle_svd(ta, rank), jalt.oracle_svd(a, rank)
    elif which == "qr_iteration":
        v0 = torch.from_numpy(_normal(1, (h, rank)))
        port = alt.qr_iteration_svd(ta, rank, iters=12, v0=v0)
        ref = jalt.qr_iteration_svd(jnp.asarray(a), rank, iters=12)
    else:
        k = min(rank + 4, min(s, h))
        omega = torch.from_numpy(_normal(2, (h, k)))
        port = alt.randomized_svd(ta, rank, omega=omega)
        ref = jalt.randomized_svd(jnp.asarray(a), rank)
    _check(a, port, ref)


def test_start_matrices_from_a_generator():
    """Without a start matrix the contenders draw it from the generator
    (same seed, same result); with neither they refuse."""
    a = torch.from_numpy(_mat(64, 48, 4))
    runs = [alt.randomized_svd(a, 4, generator=torch.Generator()
                               .manual_seed(3)) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    with pytest.raises(ValueError, match="Generator"):
        alt.qr_iteration_svd(a, 4)
    with pytest.raises(ValueError, match="shape"):
        alt.qr_iteration_svd(a, 4, v0=torch.zeros(48, 5))


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scalar_lanczos_matches_reference(shape, backend):
    """lanczos_bidiag (alpha, beta and U·B·Vᵀ), bidiag_to_svd and
    lanczos_svd against the reference's, z0 its default (PRNGKey(0));
    on CPU tensors both backends run the plain re-orth steps."""
    s, h, r = shape
    a = _mat(s, h, r)
    rank, iters = r, r + 6
    z0 = _normal(0, (h,))
    hooks = make_batched_hooks(backend=backend)
    ta, tz = torch.from_numpy(a), torch.from_numpy(z0)

    res = lz.lanczos_bidiag(ta, iters, tz, hooks)
    jres = jlz.lanczos_bidiag(jnp.asarray(a), iters)
    assert res.u.shape == (s, iters) and res.v.shape == (h, iters)
    assert _rel(res.alpha.numpy(), np.asarray(jres.alpha)) < S_REL
    assert _rel(res.beta.numpy(), np.asarray(jres.beta)) < S_REL

    def ubv(u, al, be, v):
        b = np.diag(np.asarray(al)) + np.diag(np.asarray(be), 1)
        return np.asarray(u) @ b @ np.asarray(v).T
    assert _rel(ubv(res.u, res.alpha, res.beta, res.v),
                ubv(jres.u, jres.alpha, jres.beta, jres.v)) < 1e-4

    _check(a, lz.bidiag_to_svd(res, rank), jlz.bidiag_to_svd(jres, rank))
    _check(a, lz.lanczos_svd(ta, rank, iters, z0=tz, hooks=hooks),
           jlz.lanczos_svd(jnp.asarray(a), rank, iters))
    with pytest.raises(ValueError, match="iterations"):
        lz.lanczos_svd(ta, rank, rank - 1, z0=tz, hooks=hooks)


@pytest.mark.parametrize("pad", [(0, 4), (8, 12)], ids=["H+4", "S+8,H+12"])
def test_zero_padding_changes_no_singular_value(pad):
    """A zero-padded matrix with the start vector zero-extended (the
    reference engine's padding) gives the same singular values: the pad
    components stay zero through every re-orth step."""
    s, h = 96, 64
    a = _mat(s, h, 8)
    ps, ph = pad
    ap = np.zeros((s + ps, h + ph), np.float32)
    ap[:s, :h] = a
    z0 = _normal(0, (h,))
    hooks = make_batched_hooks()
    _, sv, _ = lz.lanczos_svd(torch.from_numpy(a), 8, 14,
                              z0=torch.from_numpy(z0), hooks=hooks)
    u, svp, vt = lz.lanczos_svd(
        torch.from_numpy(ap), 8, 14,
        z0=torch.from_numpy(np.pad(z0, (0, ph))), hooks=hooks)
    assert _rel(svp.numpy(), sv.numpy()) < 1e-6
    assert float(u[s:].abs().sum()) == 0.0
    assert float(vt[:, h:].abs().sum()) == 0.0


# --- mirrors of tests/test_svd_alt.py -----------------------------------

def test_all_algorithms_reach_oracle_error():
    a = torch.from_numpy(_mat(96, 64, 8))
    g = torch.Generator().manual_seed(0)
    eo = float(alt.reconstruction_error(a, *alt.oracle_svd(a, 8)))
    for fn in (lambda: alt.qr_iteration_svd(a, 8, iters=12, generator=g),
               lambda: alt.randomized_svd(a, 8, generator=g),
               lambda: lz.lanczos_svd(a, 8, 14, z0=torch.ones(64),
                                      hooks=make_batched_hooks())):
        e = float(alt.reconstruction_error(a, *fn()))
        assert e < eo + 0.02


def test_lanczos_fastest_at_small_rank_flopwise():
    """The paper's Fig. 2 argument, counted: the matmul FLOPs one more
    Lanczos step adds (two matvecs and their CGS2 re-orths) against one
    more subspace iteration (two [S, H]·[H, r] products), at S = H = 4096
    and r = 10, from shape-only runs of the port's own functions."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    s, h, r = 4096, 4096, 10
    hooks = make_batched_hooks(backend="reference")

    def flops(fn):
        with FakeTensorMode():
            a = torch.empty(s, h)
            with FlopCounterMode(display=False) as fc:
                fn(a)
        return fc.get_total_flops()

    def lanczos(k):
        return flops(lambda a: lz.lanczos_svd(a, r, k, z0=torch.ones(h),
                                              hooks=hooks))

    def qr(k):
        return flops(lambda a: alt.qr_iteration_svd(
            a, r, iters=k, v0=torch.ones(h, r)))
    lanczos_iter = lanczos(r + 1) - lanczos(r)
    qr_iter = qr(2) - qr(1)
    assert qr_iter == 2 * (2 * s * h * r)
    assert lanczos_iter * 1.5 < qr_iter
