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
from repro_torch.kernels import lowrank_matmul as lrmm  # noqa: E402
from repro_torch.kernels import outlier_extract as oe  # noqa: E402
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
    logits of the plain ``_lowrank_attention`` route; each kernel of that
    path launched (the activation path's kernels are not on it)."""
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
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("reorth_right_batched",
                                       "reorth_left_batched",
                                       "dkv_attention_stats")), counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,h,n", [(1, 20, 4096, 256), (2, 21, 100, 100),
                                     (1, 1, 64, 32000), (3, 13, 777, 301)])
def test_lowrank_matmul_kernel_matches_plain(cuda, dtype, b, k, h, n):
    """Eq. 6 GEMM: k = 1, 20, 21 (M = B·k up to 63, so two M chunks),
    ragged H and N, N = 32000 (a vocab).  float32: the sums differ only
    in order (1e-4 relative to the largest output); bf16: the float32
    results round to bf16 once, so at most one bf16 ulp apart."""
    g = torch.Generator(device=cuda).manual_seed(b * k + h + n)
    dt = getattr(torch, dtype)
    vt = torch.randn(b, k, h, generator=g, device=cuda).to(dt)
    w = (torch.randn(h, n, generator=g, device=cuda) * h ** -0.5).to(dt)
    before = lrmm.lowrank_matmul.launches
    got = lrmm.lowrank_matmul(vt, w)
    want = lrmm.lowrank_matmul_plain(vt, w)
    assert got.dtype == dt and got.shape == (b, k, n)
    assert lrmm.lowrank_matmul.launches == before + 1
    scale = want.float().abs().max().item()
    tol = 1e-4 * scale if dtype == "float32" else 2 ** -7 * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)
    again = lrmm.lowrank_matmul(vt, w)
    assert torch.equal(got, again)             # fixed-order combine
    with pytest.raises(ValueError, match="both"):
        lrmm.lowrank_matmul(vt.float(), w.bfloat16())


@pytest.mark.parametrize("b,s,h", [(1, 4096, 512), (2, 37, 203),
                                   (3, 1000, 96)])
def test_outlier_stats_kernel_matches_plain(cuda, b, s, h):
    """Counts and max |x| are exact on both routes, so they are equal."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    x = torch.randn(b, s, h, generator=g, device=cuda) * 1.5
    x[:, :, 3] *= 4.0
    before = oe.outlier_stats.launches
    cnt, mx = oe.outlier_stats(x, 3.0)
    cp, mp = oe.outlier_stats_plain(x, 3.0)
    assert oe.outlier_stats.launches == before + 1
    assert torch.equal(cnt, cp) and torch.equal(mx, mp)
    assert cnt[:, 3].min().item() > 0
    with pytest.raises(ValueError, match="float32"):
        oe.outlier_stats(x.bfloat16(), 3.0)


def test_decomposed_forward_routes_agree_on_card(cuda):
    """Reduced float32 llama2, layers [0, 1] decomposed at rank 8 with 3 %
    outliers: the forward through the kernels and through their plain
    versions (``backend="reference"``) pick the same outlier channels and
    give logits within 1e-3 relative L2; the kernel route launches each
    activation-path kernel its expected number of times."""
    from repro_torch.core.policy import DecompositionPolicy
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.runtime import steps
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    p = T.init(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    pol = DecompositionPolicy.from_layer_list(2, [0, 1], rank=8,
                                              outlier_frac=0.03)
    logs, outs = {}, {}
    for backend in ("cuda", "reference"):
        eng = DecomposeEngine(EngineConfig(policy=pol, backend=backend))
        orig, logs[backend] = eng.decompose_activation, []

        def rec(*a, _o=orig, _l=logs[backend], **kw):
            lr_ = _o(*a, **kw)
            _l.append(lr_.o_idx)
            return lr_
        eng.decompose_activation = rec
        ops.reset_launch_counts()
        outs[backend] = steps.make_decomposed_forward_step(cfg, eng)(p, toks)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if backend == "cuda":
            assert counts == {"reorth_right_batched": 4 * 7,
                              "reorth_left_batched": 4 * 8,
                              "dkv_attention_stats": 0,
                              "lowrank_matmul": 2 * 5,
                              "outlier_stats": 4}, counts
        else:
            assert all(v == 0 for v in counts.values()), counts
    for a, b in zip(logs["cuda"], logs["reference"]):
        assert torch.equal(a, b)
    lk, lp = outs["cuda"], outs["reference"]
    assert ((lk - lp).norm() / lp.norm()).item() <= 1e-3
