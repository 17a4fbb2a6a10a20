"""The operating-point knobs of the port's Eq. 6 GEMM and dkv statistics
against the JAX package's Pallas kernels (interpret mode).

``lowrank_matmul(vt, w, expansion=f, n_block=nb)`` and
``dkv_attention_stats(..., expansion=f)`` on CPU tensors run their plain
versions at the knob: the f splits of H (f time blocks of each slot's
valid rows) computed apart and combined in order, as the TPU kernels'
grids do.  Calls without knobs stay the functions they were before the
knobs, bit for bit.  Inputs are seeded numpy draws.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import dkv_attention as dk  # noqa: E402
from repro_torch.kernels import lowrank_matmul as lm  # noqa: E402

TOL = 1e-5


def _draw(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# lowrank_matmul (expansion, n_block)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,h,n", [(5, 256, 200), (20, 320, 384)])
@pytest.mark.parametrize("f", [1, 8, 32])
@pytest.mark.parametrize("nb", [128, 512])
def test_lowrank_matmul_knobs_match_pallas(k, h, n, f, nb):
    """Vᵀ @ W at (f, n_block) against the reference's kernel at the same
    point (N 200 is not a multiple of 128; at H 320 the port's splits of
    f 8 and 32 are 40 and 16 rows, the reference's 40 and 10), float32,
    within 1e-5 of the largest entry."""
    vt, w = _draw(k * h, k, h), _draw(h * n, h, n)
    ref = np.asarray(jops.lowrank_matmul(jnp.asarray(vt), jnp.asarray(w),
                                         expansion=f, n_block=nb,
                                         interpret=True))
    got = lm.lowrank_matmul(torch.from_numpy(vt), torch.from_numpy(w),
                            expansion=f, n_block=nb)
    assert got.dtype == torch.float32 and got.shape == (k, n)
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_lowrank_matmul_splits_add_in_order():
    """With f the plain version adds the f float32 split products in
    split order (ceil(H / f) rows rounded up to 8 each, the last one
    short) and rounds once; n_block leaves the arithmetic alone."""
    vt = torch.from_numpy(_draw(1, 2, 3, 100)).bfloat16()
    w = torch.from_numpy(_draw(2, 100, 40)).bfloat16()
    want = torch.zeros(2, 3, 40)
    for lo in range(0, 100, 40):                 # f = 3: 40, 40, 20 rows
        want = want + vt[..., lo:lo + 40].float() @ w[lo:lo + 40].float()
    got = lm.lowrank_matmul(vt, w, expansion=3)
    assert torch.equal(got, want.bfloat16())
    assert torch.equal(lm.lowrank_matmul(vt, w, expansion=3, n_block=256),
                       got)
    assert [lm.split_rows(100, f) for f in (1, 3, 32)] == [104, 40, 8]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowrank_matmul_without_knobs_is_unchanged(dtype):
    """No knobs: the plain product of before the knobs, bit for bit."""
    dt = getattr(torch, dtype)
    vt = torch.from_numpy(_draw(3, 2, 7, 96)).to(dt)
    w = torch.from_numpy(_draw(4, 96, 130)).to(dt)
    want = (vt.float() @ w.float()).to(dt)
    assert torch.equal(lm.lowrank_matmul(vt, w), want)
    assert torch.equal(lm.lowrank_matmul_plain(vt, w), want)


def test_lowrank_matmul_knob_reach_and_refusals():
    """The card's kernel takes splits of at least one 64-row stage (and
    f = 1 at any H); bad knobs raise on every device."""
    assert lm.reaches(4096, 32) and lm.reaches(64, 1) and lm.reaches(10, None)
    assert not lm.reaches(256, 8) and not lm.reaches(1800, 33)
    vt, w = torch.zeros(2, 64), torch.zeros(64, 128)
    for kw in (dict(expansion=0), dict(expansion=2.5), dict(n_block=100),
               dict(n_block=0)):
        with pytest.raises(ValueError):
            lm.lowrank_matmul(vt, w, **kw)


# ---------------------------------------------------------------------------
# dkv_attention_stats (expansion)
# ---------------------------------------------------------------------------

B, G, T, R = 3, 6, 100, 16
T_VALID = (100, 77, 3)          # T 100 is not a multiple of 8 or 32


def _dkv_inputs():
    return (_draw(10, B, G, R, scale=0.5), _draw(11, B, T, R),
            _draw(12, B, T, R))


@pytest.mark.parametrize("f", [1, 8, 32])
def test_dkv_stats_expansion_matches_pallas(f):
    """Every slot's (a, m, l) at f time blocks against the reference's
    kernel on the slot's first t_valid rows at the same f (its blocks of
    ceil(t_valid / f) rows are the port's), within 1e-5."""
    inner, ku, vu = _dkv_inputs()
    tv = torch.tensor(T_VALID, dtype=torch.int32)
    a, m, l_ = dk.dkv_attention_stats(torch.from_numpy(inner),
                                      torch.from_numpy(ku),
                                      torch.from_numpy(vu), tv, expansion=f)
    for i, n in enumerate(T_VALID):
        ra, rm, rl = (np.asarray(x) for x in jops.dkv_attention_stats(
            jnp.asarray(inner[i]), jnp.asarray(ku[i, :n]),
            jnp.asarray(vu[i, :n]), expansion=f, interpret=True))
        assert np.abs(a[i].numpy() - ra).max() <= TOL * np.abs(ra).max()
        assert np.abs(m[i].numpy() - rm[:, 0]).max() <= TOL * np.abs(
            rm).max()
        assert np.abs(l_[i].numpy() - rl[:, 0]).max() <= TOL * np.abs(
            rl).max()


@pytest.mark.parametrize("f", [None, 1, 8, 32])
def test_dkv_stats_ignore_rows_past_t_valid(f):
    """Rows at or past t_valid never enter: U padded with other rows
    gives the same bits at every f, and t_valid 0 gives (0, -1e30, 0)."""
    inner, ku, vu = (torch.from_numpy(x) for x in _dkv_inputs())
    tv = torch.tensor((77, 0, 3), dtype=torch.int32)
    pad = torch.from_numpy(_draw(13, B, 28, R))
    got = dk.dkv_attention_stats(inner, ku, vu, tv, expansion=f)
    padded = dk.dkv_attention_stats(inner, torch.cat([ku, pad], 1),
                                    torch.cat([vu, pad], 1), tv,
                                    expansion=f)
    assert all(torch.equal(x, y) for x, y in zip(got, padded))
    a, m, l_ = got
    assert (a[1] == 0).all() and (m[1] == dk.NEG).all() and (l_[1] == 0).all()


def _parent_plain(inner, k_u, v_u, t_valid):
    """The plain statistics as they were before the knob."""
    b, g, r = inner.shape
    a = torch.zeros(b, g, r)
    m = torch.full((b, g), dk.NEG)
    l_ = torch.zeros(b, g)
    for i, n in enumerate(t_valid.clamp(0, k_u.shape[1]).tolist()):
        if n == 0:
            continue
        s = inner[i].float() @ k_u[i, :n].float().T
        m[i] = s.amax(-1)
        p = torch.exp(s - m[i][:, None])
        a[i] = p @ v_u[i, :n].float()
        l_[i] = p.sum(-1)
    return a, m, l_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkv_stats_without_knob_are_unchanged(dtype):
    inner, ku, vu = (torch.from_numpy(x) for x in _dkv_inputs())
    ku, vu = ku.to(getattr(torch, dtype)), vu.to(getattr(torch, dtype))
    tv = torch.tensor(T_VALID, dtype=torch.int32)
    want = _parent_plain(inner, ku, vu, tv)
    for got in (dk.dkv_attention_stats(inner, ku, vu, tv),
                dk.dkv_attention_stats_plain(inner, ku, vu, tv)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_dkv_block_rows_and_refusals():
    assert [dk.block_rows(77, f) for f in (1, 8, 32, 100)] == [77, 10, 3, 1]
    assert dk.block_rows(0, 8) == 1
    inner, ku, vu = (torch.from_numpy(x) for x in _dkv_inputs())
    tv = torch.tensor(T_VALID, dtype=torch.int32)
    for f in (0, -1, 1.5):
        with pytest.raises(ValueError):
            dk.dkv_attention_stats(inner, ku, vu, tv, expansion=f)
