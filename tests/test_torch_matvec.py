"""The expanded matvec pair of the port against the JAX package.

On the host the four wrappers run their plain PyTorch versions (each
split of the reduced axis a float32 product, the partials added in
block order).  They are held against the Pallas kernels of
``repro.kernels.matvec_expand`` through ``repro.kernels.ops`` (interpret
mode) and against the ``kernels/ref`` oracles, on the same numpy
inputs: f from 1 to 128, float32 and bf16, ragged S and H, B = 1 and 3.
The tolerance is the JAX kernel tests' own (rtol 1e-5, atol 1e-3).  The
CUDA kernel is held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import matvec_expand as mv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FS = (1, 2, 4, 8, 64, 128)
TOL = dict(rtol=1e-5, atol=1e-3)
S, H = 300, 200                  # ragged: neither divides 8 · f


def _inputs(shape, vec_len, dtype, seed):
    """A and the vector from one seeded numpy draw, rounded to ``dtype``
    once, so both packages read the same values."""
    rng = np.random.RandomState(seed)
    a = rng.randn(*shape).astype(np.float32)
    x = rng.randn(*shape[:-2], vec_len).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        x = x.astype(ml_dtypes.bfloat16)
    return a, x


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("op", ["matvec", "rmatvec"])
def test_scalar_plain_matches_pallas_and_ref(op, f, dtype):
    a, x = _inputs((S, H), H if op == "matvec" else S, dtype, f)
    got = getattr(mv, op)(_torch(a), _torch(x), expansion=f).numpy()
    pallas = np.asarray(getattr(jops, op)(jnp.asarray(a), jnp.asarray(x),
                                          expansion=f))
    oracle = np.asarray(getattr(jref, op)(jnp.asarray(a), jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == pallas.shape
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("op", ["matvec", "rmatvec"])
def test_batched_plain_matches_pallas_and_ref(op, f, dtype, b):
    a, x = _inputs((b, S, H), H if op == "matvec" else S, dtype, 10 * f + b)
    name = f"{op}_batched"
    got = getattr(mv, name)(_torch(a), _torch(x), expansion=f).numpy()
    pallas = np.asarray(getattr(jops, name)(jnp.asarray(a), jnp.asarray(x),
                                            expansion=f))
    np.testing.assert_allclose(got, pallas, **TOL)
    for i in range(b):
        oracle = np.asarray(getattr(jref, op)(jnp.asarray(a[i]),
                                              jnp.asarray(x[i])))
        np.testing.assert_allclose(got[i], oracle, **TOL)


def test_plain_block_order_and_split_rule():
    """The plain version adds one float32 partial per split in block
    order — the kernel's split rule (n/f rounded up to 8 elements), so
    at f = 1 it is one product, and the block sizes change nothing."""
    assert [mv.split_len(200, f) for f in FS] == [200, 104, 56, 32, 8, 8]
    assert mv.split_len(4096, 128) == 32
    a = torch.randn(2, 37, 50, generator=torch.Generator().manual_seed(0))
    v = torch.randn(2, 50, generator=torch.Generator().manual_seed(1))
    want = torch.zeros(2, 37)
    for lo in range(0, 50, 16):                       # f = 4: splits of 16
        want = want + torch.einsum("bsh,bh->bs", a[..., lo:lo + 16],
                                   v[:, lo:lo + 16])
    got = mv.matvec_batched(a, v, expansion=4, row_block=128)
    assert torch.equal(got, want)
    assert torch.equal(got, mv.matvec_batched(a, v, expansion=4,
                                              row_block=7))
    one = mv.matvec_batched(a, v, expansion=1)
    assert torch.equal(one, torch.zeros(2, 37) + torch.einsum(
        "bsh,bh->bs", a, v))


def test_wrappers_on_host_count_no_launch_and_are_registered():
    ops.reset_launch_counts()
    a = torch.randn(3, 16, 24)
    mv.matvec(a[0], torch.randn(24))
    mv.rmatvec(a[0], torch.randn(16))
    mv.matvec_batched(a, torch.randn(3, 24))
    mv.rmatvec_batched(a, torch.randn(3, 16))
    counts = ops.launch_counts()
    for name in ("matvec", "rmatvec", "matvec_batched", "rmatvec_batched"):
        assert name in ops.KERNELS and counts[name] == 0
    with pytest.raises(ValueError, match="expansion"):
        mv.matvec(a[0], torch.randn(24), expansion=0)
    with pytest.raises(ValueError, match="expansion"):
        mv.rmatvec_batched(a, torch.randn(3, 16), expansion=2.5)
