"""The CUDA kernels of the port against their plain versions, on the card.

Every test takes the ``cuda`` fixture, which skips without a GPU (the
kernels compile with nvcc and run only on the card).  This file imports
torch alone, so it also runs on the GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import dkv_attention as dk  # noqa: E402
from repro_torch.kernels import lanczos_reorth as lr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decomposed_kv as DK  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)   # float32, reduction orders differ


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("side", ["right", "left"])
def test_reorth_kernel_matches_plain(cuda, side):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s, h, k = 5, 37, 203, 19           # ragged on purpose
    a = torch.randn(b, s, h, generator=g, device=cuda)
    n, m = (h, s) if side == "right" else (s, h)
    x = torch.randn(b, m, generator=g, device=cuda)
    q = torch.linalg.qr(torch.randn(b, n, k, generator=g,
                                    device=cuda))[0].contiguous()
    kern = getattr(lr, f"reorth_{side}_batched")
    plain = getattr(lr, f"reorth_{side}_batched_plain")
    before = kern.launches
    for f in (1, 8, 32):
        z, nz = kern(a, x, q, expansion=f)
        zp, nzp = plain(a, x, q)
        torch.testing.assert_close(z, zp, **TOL)
        torch.testing.assert_close(nz, nzp, **TOL)
    assert kern.launches == before + 3
    with pytest.raises(ValueError, match="contiguous"):
        kern(a, x, q.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkv_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    b, nh, t, r = 3, 6, 77, 10
    inner = torch.randn(b, nh, r, generator=g, device=cuda)
    k_u = torch.randn(b, t, r, generator=g, device=cuda).to(dt)
    v_u = torch.randn(b, t, r, generator=g, device=cuda).to(dt)
    tv = torch.tensor([77, 31, 0], dtype=torch.int32, device=cuda)
    got = dk.dkv_attention_stats(inner, k_u, v_u, tv)
    want = dk.dkv_attention_stats_plain(inner, k_u, v_u, tv)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **TOL)


def test_decode_routes_agree_on_card(cuda):
    """Reduced float32 llama2: a decomposed-KV prefill (Lanczos through the
    re-orth kernels) and one decode step through the dkv kernel give the
    logits of the plain ``_lowrank_attention`` route."""
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    p = T.init(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 20), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    ops.reset_launch_counts()
    _, cache = DK.prefill_dkv(p, cfg, toks, 16, tail=4)
    pos = torch.tensor([20, 20], dtype=torch.int32, device=cuda)
    frozen = torch.tensor([20, 13], dtype=torch.int32, device=cuda)
    tok = torch.tensor([3, 5], device=cuda)
    lk, _ = DK.decode_step_dkv(p, cfg, tok, cache, pos, frozen)
    lp, _ = DK.decode_step_dkv(p, cfg, tok, cache, pos, frozen,
                               attention="plain")
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
    assert all(v > 0 for v in ops.launch_counts().values())
