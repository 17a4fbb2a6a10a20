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
from repro_torch.kernels import matvec_expand as mv  # noqa: E402
from repro_torch.kernels import outlier_extract as oe  # noqa: E402
from repro_torch.kernels import ssd_chunk as ssd  # noqa: E402
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


REORTH_FS = (1, 2, 8, 16, 32)


def _reorth_inputs(cuda, side, b, s, h, k, filled, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn(b, s, h, generator=g, device=cuda)
    n, m = (h, s) if side == "right" else (s, h)
    x = torch.randn(b, m, generator=g, device=cuda)
    x = x / x.norm(dim=-1, keepdim=True)
    q = torch.zeros(b, n, k, device=cuda)
    q[..., :filled] = torch.linalg.qr(
        torch.randn(b, n, filled, generator=g, device=cuda))[0]
    return a, x, q


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("b,s,h,k,filled", [
    (5, 37, 203, 19, 19),         # ragged; H % 4 != 0: element copies
    (3, 7, 256, 5, 5),            # left: S = 7 < f, empty blocks
    (2, 515, 1028, 1, 1),         # k = 1; TMA boxes ragged at S and H
    (2, 300, 1000, 72, 36),       # phase 4's k, half filled; N % f != 0
    (2, 260, 520, 256, 256),      # the kernel's largest k
    (1, 4096, 4096, 20, 10),      # phase 6's B = 1 step
    (128, 24, 64, 8, 8),          # more clusters than the card holds
])
def test_reorth_kernel_matches_plain(cuda, side, b, s, h, k, filled):
    """The cluster kernel against its plain version at every f of
    REORTH_FS (min(f, 16) CTAs an element, two blocks a CTA at f = 32);
    reruns bit-identical; one launch counted per call."""
    a, x, q = _reorth_inputs(cuda, side, b, s, h, k, filled)
    kern = getattr(lr, f"reorth_{side}_batched")
    plain = getattr(lr, f"reorth_{side}_batched_plain")
    zp, nzp = plain(a, x, q)
    for f in REORTH_FS:
        before = kern.launches
        z, nz = kern(a, x, q, expansion=f)
        z2, nz2 = kern(a, x, q, expansion=f)
        assert kern.launches == before + 2
        torch.testing.assert_close(z, zp, **TOL)
        torch.testing.assert_close(nz, nzp, **TOL)
        assert torch.equal(z, z2) and torch.equal(nz, nz2), f
    if b == 1:                     # the scalar wrappers are B = 1 calls
        one = getattr(lr, f"reorth_{side}")
        z1, n1 = one(a[0], x[0], q[0], expansion=16)
        assert torch.equal(z1, kern(a, x, q, expansion=16)[0][0])
    with pytest.raises(ValueError, match="contiguous"):
        kern(a, x, torch.zeros(b, 2 * q.shape[1], k, device=cuda)[:, ::2])


@pytest.mark.parametrize("f", [1, 16, 32])
@pytest.mark.parametrize("side", ["right", "left"])
def test_reorth_call_is_one_launch(cuda, side, f):
    """At any f one call is one device kernel: the cluster combines its
    blocks' partials through distributed shared memory in the launch."""
    a, x, q = _reorth_inputs(cuda, side, 3, 300, 520, 24, 12)
    kern = getattr(lr, f"reorth_{side}_batched")
    kernels = _device_kernels(lambda: kern(a, x, q, expansion=f))
    assert len(kernels) == 1 and f"reorth_{side}_kernel" in kernels[0], \
        kernels


def test_reorth_kernel_refuses_what_it_does_not_take(cuda):
    a, x, q = _reorth_inputs(cuda, "right", 2, 40, 64, 4, 4)
    for f in (0, 33):
        with pytest.raises(ValueError, match="blocks"):
            lr.reorth_right_batched(a, x, q, expansion=f)
    with pytest.raises(ValueError, match="basis columns"):
        lr.reorth_right_batched(a, x, torch.zeros(2, 64, 257, device=cuda))
    lib = lr._lib()                # the wrapper's Q rule is the kernel's
    for side, s, h, k in (("right", 4096, 4096, 20), ("left", 4096, 4096, 20),
                          ("right", 512, 4096, 72), ("left", 512, 4096, 72),
                          ("left", 7, 203, 19), ("right", 37, 203, 256)):
        for f in REORTH_FS:
            assert lr.q_in_smem(side, s, h, k, f) == bool(
                lib.dcom_reorth_q_in_smem(0 if side == "right" else 1, s, h,
                                          k, f)), (side, s, h, k, f)


@pytest.mark.parametrize("s,h,rank", [(4096, 468, 10), (515, 470, 20),
                                      (1024, 1024, 50)])
def test_scalar_lanczos_svd_kernel_route_equals_reference(cuda, s, h, rank):
    """``core.lanczos.lanczos_svd`` through the B = 1 re-orth kernels
    equals the same call through the plain versions (Fig. 2's width 468,
    a ragged width, iters rank + 6): singular values within 1e-4
    relative, reconstructions within 1e-4 of their largest entry, and
    exactly iters left and iters − 1 right launches."""
    from repro_torch.core import lanczos as lz
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(s, rank, generator=g, device=cuda) @ torch.randn(
        rank, h, generator=g, device=cuda)
    a = a + 0.01 * torch.randn(s, h, generator=g, device=cuda)
    z0 = torch.randn(h, generator=g, device=cuda)
    k = rank + 6
    left, right = (lr.reorth_left_batched.launches,
                   lr.reorth_right_batched.launches)
    out = lz.lanczos_svd(a, rank, k, z0=z0,
                         hooks=ops.make_batched_hooks(backend="cuda"))
    assert lr.reorth_left_batched.launches - left == k
    assert lr.reorth_right_batched.launches - right == k - 1
    ref = lz.lanczos_svd(a, rank, k, z0=z0,
                         hooks=ops.make_batched_hooks(backend="reference"))
    torch.testing.assert_close(out[1], ref[1], rtol=1e-4,
                               atol=1e-4 * float(ref[1].max()))
    rec = (out[0] * out[1]) @ out[2]
    want = (ref[0] * ref[1]) @ ref[2]
    assert float((rec - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches (after a
    warm-up call, so one-time allocations are not counted)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nh,t,r,t_valid", [
    (3, 6, 77, 10, (77, 31, 0)),          # G < one head group, T ragged
    (4, 32, 512, 64, (512, 384, 304, 128)),   # phase 4's decode shape
    (2, 12, 100, 40, (64, 96)),           # on chunk boundaries; G 8 + 4
    (2, 8, 1000, 16, (1000, 33)),         # 32 chunks: two merge rounds
    (1, 9, 40, 24, (0,)),                 # t_valid 0 alone
])
def test_dkv_kernel_matches_plain(cuda, dtype, b, nh, t, r, t_valid):
    """The chunked dkv kernel against the plain version: t_valid 0 (a = 0,
    m = -1e30, l = 0), t_valid ending mid-chunk and on a chunk boundary,
    T not a multiple of the 32-row chunk, G not a multiple of the 8-head
    group, phase 4's G 32 / r 64 with its four slots, more chunks than one
    merge round holds; 16-byte rows (r 40, 24, 64, 16 in bf16) and element
    loads (r 10).  Reruns are bit-identical, and a call is one launch."""
    g = torch.Generator(device=cuda).manual_seed(t + r)
    dt = getattr(torch, dtype)
    inner = torch.randn(b, nh, r, generator=g, device=cuda)
    k_u = torch.randn(b, t, r, generator=g, device=cuda).to(dt)
    v_u = torch.randn(b, t, r, generator=g, device=cuda).to(dt)
    tv = torch.tensor(t_valid, dtype=torch.int32, device=cuda)
    before = dk.dkv_attention_stats.launches
    got = dk.dkv_attention_stats(inner, k_u, v_u, tv)
    assert dk.dkv_attention_stats.launches == before + 1
    want = dk.dkv_attention_stats_plain(inner, k_u, v_u, tv)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **TOL)
    for x, y in zip(got, dk.dkv_attention_stats(inner, k_u, v_u, tv)):
        assert torch.equal(x, y)
    kernels = _device_kernels(
        lambda: dk.dkv_attention_stats(inner, k_u, v_u, tv))
    assert len(kernels) == 1 and "dkv_stats_kernel" in kernels[0], kernels


@pytest.mark.parametrize("page", [16, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_dkv_kernel_equals_slab_kernel(cuda, dtype, page):
    """The paged kernel reads U through the block table and is BIT-EQUAL
    to the slab kernel on the gathered rows at equal r: permuted page ids,
    a page size that does not divide the 32-row tile (12), a partial last
    page, t_valid 0, r = 40 of r_pool = 48, and a slab longer than the
    table's n·page rows (its extra rows lie past every t_valid)."""
    g = torch.Generator(device=cuda).manual_seed(page)
    dt = getattr(torch, dtype)
    b, nh, r_pool, r, n, P = 4, 8, 48, 40, 9, 64
    k_pool = torch.randn(P, page, r_pool, generator=g, device=cuda).to(dt)
    v_pool = torch.randn(P, page, r_pool, generator=g, device=cuda).to(dt)
    k_pool[0] = 0
    v_pool[0] = 0
    ids = (torch.randperm(P - 1, generator=g, device=cuda)[:b * n] + 1)
    bt = ids.reshape(b, n).to(torch.int32).contiguous()
    bt[3, 5:] = 0                       # table padding reads the sink
    tv = torch.tensor([n * page, n * page - 5, 0, 5 * page - 3],
                      dtype=torch.int32, device=cuda)
    inner = torch.randn(b, nh, r, generator=g, device=cuda)
    before = dk.dkv_attention_stats_paged.launches
    got = dk.dkv_attention_stats_paged(inner, k_pool, v_pool, bt, tv, r)
    assert dk.dkv_attention_stats_paged.launches == before + 1
    ku = dk.gather_rows(k_pool, bt, r).contiguous()
    vu = dk.gather_rows(v_pool, bt, r).contiguous()
    for t_slab in (n * page, n * page + 20):
        pad = t_slab - n * page
        slab = dk.dkv_attention_stats(
            inner, torch.nn.functional.pad(ku, (0, 0, 0, pad)),
            torch.nn.functional.pad(vu, (0, 0, 0, pad)), tv)
        for x, y in zip(got, slab):
            assert torch.equal(x, y)
    want = dk.dkv_attention_stats_paged_plain(inner, k_pool, v_pool, bt,
                                              tv, r)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **TOL)
    with pytest.raises(ValueError, match="r_pool"):
        dk.dkv_attention_stats_paged(
            torch.randn(b, nh, r_pool + 8, device=cuda), k_pool, v_pool, bt,
            tv, r_pool + 8)


def test_paged_engine_matches_slot_engine_on_card(cuda):
    """Reduced float32 llama2: the paged engine's greedy tokens equal the
    slot engine's through the kernels (paged decode launches only the
    paged dkv kernel), and a prefix hit admits with no re-orth launch."""
    import numpy as np
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine, Request
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    p = T.init(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    sys_p = rng.randint(0, cfg.vocab, 28, dtype=np.int32)
    prompts = [np.concatenate([sys_p, rng.randint(0, cfg.vocab, 4,
                                                  dtype=np.int32)])
               for _ in range(3)]

    def serve(paged, prefix=0):
        ecfg = EngineConfig(kv_rank=16, kv_tail=8, kv_page=4,
                            kv_prefix_cache=prefix)
        eng = Engine(cfg, p, slots=2, max_len=96, device=cuda, paged=paged,
                     decompose_engine=DecomposeEngine(ecfg))
        ops.reset_launch_counts()
        done = []
        for step in range(300):
            if step < len(prompts):
                eng.submit(Request(uid=step, prompt=prompts[step],
                                   max_new_tokens=12))
            done.extend(eng.step())
            if len(done) == len(prompts) and not any(eng.live):
                break
        return {r.uid: r.out_tokens for r in done}, eng, ops.launch_counts()

    slot, _, c_slot = serve(False)
    paged, eng, c_paged = serve(True)
    assert eng.stats.tail_folds > 0
    assert paged == slot
    assert c_slot["dkv_attention_stats"] > 0
    assert c_paged["dkv_attention_stats_paged"] > 0
    assert c_paged["dkv_attention_stats"] == 0
    # prefix cache on: the first request misses, the others hit
    _, eng, counts = serve(True, prefix=4)
    assert (eng.stats.prefix_misses, eng.stats.prefix_hits) == (1, 2)
    reorth = counts["reorth_right_batched"] + counts["reorth_left_batched"]
    assert reorth == c_paged["reorth_right_batched"] // 3 \
        + c_paged["reorth_left_batched"] // 3


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
                                     (1, 1, 64, 32000), (3, 13, 777, 301),
                                     (1, 64, 512, 384), (5, 13, 256, 200),
                                     (2, 20, 40, 1000), (1, 20, 2048, 136)])
def test_lowrank_matmul_kernel_matches_plain(cuda, dtype, b, k, h, n):
    """Eq. 6 GEMM: k = 1, 20, 21 (M = B·k up to 63), M = 64 (one full M
    chunk) and 65 (a second chunk of one row), ragged H and N, H = 40
    (shorter than one 64-row ring stage), N = 200 and 136 (not multiples
    of the 128-column tile), H split 8 ways (a full cluster: N = 256 and
    136 give 2 tiles), N = 32000 (a vocab).  float32: the sums differ
    only in order (1e-4 relative to the largest output); bf16: the
    float32 results round to bf16 once, so at most one bf16 ulp apart."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h", [(1, 4096, 512), (2, 37, 203),
                                   (3, 1000, 96), (1, 4096, 4096)])
def test_outlier_stats_kernel_matches_plain(cuda, b, s, h, dtype):
    """Counts and max |x| are exact on both routes, so they are equal, for
    float32 and bf16 input (H 203: masked scalar loads; [1, 4096, 4096]:
    phase 6's shape, S split over CTAs)."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    x = (torch.randn(b, s, h, generator=g, device=cuda) * 1.5).to(
        getattr(torch, dtype))
    x[:, :, 3] *= 4.0
    before = oe.outlier_stats.launches
    cnt, mx = oe.outlier_stats(x, 3.0)
    cp, mp = oe.outlier_stats_plain(x, 3.0)
    assert oe.outlier_stats.launches == before + 1
    assert cnt.dtype == mx.dtype == torch.float32
    assert torch.equal(cnt, cp) and torch.equal(mx, mp)
    assert cnt[:, 3].min().item() > 0
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        oe.outlier_stats(x.half(), 3.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_outlier_stats_second_call_is_not_stale(cuda, dtype):
    """A second call on other inputs with smaller maxima and fewer
    outliers gives its own statistics: no partial or ticket of the first
    call survives into it (the S splits combine inside each launch)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    dt = getattr(torch, dtype)
    x1 = (torch.randn(2, 4096, 1024, generator=g, device=cuda) * 4).to(dt)
    x2 = (torch.randn(2, 4096, 1024, generator=g, device=cuda) * 0.5).to(dt)
    c1, m1 = oe.outlier_stats(x1, 3.0)
    c2, m2 = oe.outlier_stats(x2, 3.0)
    for (c, m), x in (((c1, m1), x1), ((c2, m2), x2)):
        cp, mp = oe.outlier_stats_plain(x, 3.0)
        assert torch.equal(c, cp) and torch.equal(m, mp)
    assert (m2 < m1).all() and c2.sum() < c1.sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_outlier_stats_call_is_one_launch(cuda, dtype):
    """One call is one device kernel: no memset before it, no combine
    after it."""
    x = torch.randn(1, 4096, 4096, device=cuda).to(getattr(torch, dtype))
    names = _device_kernels(lambda: oe.outlier_stats(x, 3.0))
    assert len(names) == 1 and "outlier_stats_kernel" in names[0], names


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
                              "dkv_attention_stats_paged": 0,
                              "lowrank_matmul": 2 * 5,
                              "outlier_stats": 4,
                              "ssd_chunk_intra": 0,
                              "ssd_chunk_intra_bwd": 0, "matvec": 0,
                              "rmatvec": 0, "matvec_batched": 0,
                              "rmatvec_batched": 0}, counts
        else:
            assert all(v == 0 for v in counts.values()), counts
    for a, b in zip(logs["cuda"], logs["reference"]):
        assert torch.equal(a, b)
    lk, lp = outs["cuda"], outs["reference"]
    assert ((lk - lp).norm() / lp.norm()).item() <= 1e-3


@pytest.mark.parametrize("g,q,nh,hd", [(3, 16, 6, 64), (8, 64, 6, 64),
                                       (2, 80, 5, 32), (1, 304, 6, 96),
                                       (1, 1008, 6, 64), (2, 70, 5, 30),
                                       (8, 64, 48, 64), (6, 64, 48, 64),
                                       (2, 64, 48, 64), (1, 304, 48, 64)])
def test_ssd_chunk_kernel_matches_plain(cuda, g, q, nh, hd):
    """Intra-chunk SSD term: Q = 16, 64, 80, 304 (one bucketed prompt)
    and 1008 (many 64-row query tiles), nh not a multiple of 4, hd 32,
    64 and 96 (a ragged second column slice), Q 70 / hd 30 (rows of cb
    and x not whole 16-byte units), and phase 8's four full-width shapes
    (mamba2-780m: nh 48, hd 64; G 8, 6, 2 at Q 64, which take blocks of
    heads, and G 1 at Q 304).  float32 sums in another order: 1e-4
    relative and absolute, as the JAX kernel test, and 1e-4 of max|y|
    (chip_smoke.py's bound); reruns bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(q + hd)
    cb = torch.randn(g, q, q, generator=gen, device=cuda) * 0.3
    da = -torch.randn(g, q, nh, generator=gen, device=cuda).abs() * 0.05
    l = torch.cumsum(da, dim=1)
    dt = torch.randn(g, q, nh, generator=gen, device=cuda).abs()
    x = torch.randn(g, q, nh, hd, generator=gen, device=cuda)
    before = ssd.ssd_chunk_intra.launches
    got = ssd.ssd_chunk_intra(cb, l, dt, x)
    want = ssd.ssd_chunk_intra_plain(cb, l, dt, x)
    assert ssd.ssd_chunk_intra.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(got, ssd.ssd_chunk_intra(cb, l, dt, x))
    # a steep decay overflows exp(l_q - l_s) above the diagonal: masked
    steep = torch.cumsum(da * 800, dim=1)
    got = ssd.ssd_chunk_intra(cb, steep, dt, x)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, ssd.ssd_chunk_intra_plain(cb, steep, dt, x), **TOL)
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_chunk_intra(cb, l, dt, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_chunk_intra(cb.transpose(1, 2), l, dt, x)


def test_ssd_chunk_call_is_one_launch(cuda):
    """One call at phase 8's G 8 × Q 64 is one device kernel."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    cb = torch.randn(8, 64, 64, generator=gen, device=cuda)
    l = torch.cumsum(-torch.rand(8, 64, 48, generator=gen, device=cuda),
                     dim=1)
    dt = torch.rand(8, 64, 48, generator=gen, device=cuda)
    x = torch.randn(8, 64, 48, 64, generator=gen, device=cuda)
    names = _device_kernels(lambda: ssd.ssd_chunk_intra(cb, l, dt, x))
    assert len(names) == 1 and "ssd_chunk_intra_kernel" in names[0], names


def _ssd_bwd_inputs(cuda, g, q, nh, hd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cb = torch.randn(g, q, q, generator=gen, device=cuda) * 0.3
    l = torch.cumsum(-torch.randn(g, q, nh, generator=gen,
                                  device=cuda).abs() * 0.05, dim=1)
    dt = torch.randn(g, q, nh, generator=gen, device=cuda).abs()
    x = torch.randn(g, q, nh, hd, generator=gen, device=cuda)
    dy = torch.randn(g, q, nh, hd, generator=gen, device=cuda)
    return cb, l, dt, x, dy


@pytest.mark.parametrize("g,q,nh,hd", [(8, 64, 48, 64), (6, 64, 48, 64),
                                       (2, 64, 48, 64), (1, 304, 48, 64),
                                       (32, 64, 48, 64), (3, 70, 5, 30),
                                       (2, 128, 8, 32), (1, 200, 3, 128)])
def test_ssd_chunk_bwd_kernel_matches_plain(cuda, g, q, nh, hd):
    """The backward kernel of the intra-chunk term against its plain
    version: chip_smoke.py phase 3's shapes (phase 8's four prefill
    shapes and the training shape G 32 × Q 64, nh 48, hd 64), a ragged
    Q 70 / hd 30 with nh 5, the reduced config's hd 32 over two query
    tiles, hd 128 over four.  Tolerance: 1e-4 · max|grad| per output
    (float32 sums in another order; chip_smoke.py's bound); reruns
    bit-identical (dcb sums the heads without atomics); a steep decay,
    whose exp overflows above the diagonal, stays finite."""
    cb, l, dt, x, dy = _ssd_bwd_inputs(cuda, g, q, nh, hd, q + hd)
    before = ssd.ssd_chunk_intra_bwd.launches
    got = ssd.ssd_chunk_intra_bwd(cb, l, dt, x, dy)
    assert ssd.ssd_chunk_intra_bwd.launches == before + 1
    want = ssd.ssd_chunk_intra_bwd_plain(cb, l, dt, x, dy)
    for name, a, b in zip(("dcb", "dl", "ddt", "dx"), got, want):
        assert a.shape == b.shape, name
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)
    again = ssd.ssd_chunk_intra_bwd(cb, l, dt, x, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    steep = l * 800
    got = ssd.ssd_chunk_intra_bwd(cb, steep, dt, x, dy)
    want = ssd.ssd_chunk_intra_bwd_plain(cb, steep, dt, x, dy)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-30


def _assert_bwd_matches(got, cb, l, dt, x, dy):
    want = ssd.ssd_chunk_intra_bwd_plain(cb, l, dt, x, dy)
    for name, a, b in zip(("dcb", "dl", "ddt", "dx"), got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


def _bwd_g_with_remainder(cuda, q, nh):
    """A G whose plan on this card, at Q ``q``, takes blocks of heads that
    do not divide ``nh`` (a remainder block per chunk)."""
    ctas = ssd.bwd_ctas(cuda.index or 0, 64)
    for g in (64, 48, 40, 96, 128, 1, 2):
        if nh % ssd.bwd_plan(g, q, nh, ctas).hb:
            return g
    raise AssertionError(f"no G gives a remainder block at Q {q}, nh {nh} "
                         f"on {ctas} CTAs")


@pytest.mark.parametrize("case", ["nh7_remainder", "nh1", "g1_q64",
                                  "g1_q128_nh1", "q304_nh47_remainder"])
def test_ssd_chunk_bwd_schedule_edges(cuda, case):
    """The backward's schedule at its edges against the plain version
    (1e-4 · max|grad| per output), reruns bit-identical: nh 7 at a G
    whose plan takes blocks of heads with a remainder block, nh 1 (one
    item per chunk), G 1 × Q 64 (a grid far smaller than the SM count),
    nh 1 over two query tiles (one CTA's items hold every dl and dcb
    partial of the chunk), and nh 47 over five query tiles, whose plan
    takes blocks of heads with a remainder."""
    g, q, nh = {"nh7_remainder": (None, 64, 7), "nh1": (16, 64, 1),
                "g1_q64": (1, 64, 48), "g1_q128_nh1": (1, 128, 1),
                "q304_nh47_remainder": (None, 304, 47)}[case]
    if g is None:
        g = _bwd_g_with_remainder(cuda, q, nh)
    ins = _ssd_bwd_inputs(cuda, g, q, nh, 64, g + nh)
    before = ssd.ssd_chunk_intra_bwd.launches
    got = ssd.ssd_chunk_intra_bwd(*ins)
    assert ssd.ssd_chunk_intra_bwd.launches == before + 1
    _assert_bwd_matches(got, *ins)
    again = ssd.ssd_chunk_intra_bwd(*ins)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_chunk_bwd_unaligned_dy(cuda):
    """dy as autograd may hand it over: a contiguous view whose address is
    not 16-byte aligned (copied to an aligned buffer for TMA)."""
    cb, l, dt, x, dy = _ssd_bwd_inputs(cuda, 8, 64, 48, 64, 3)
    flat = torch.empty(dy.numel() + 1, device=cuda)
    dyu = flat[1:].view_as(dy)
    dyu.copy_(dy)
    assert dyu.is_contiguous() and dyu.data_ptr() % 16 != 0
    got = ssd.ssd_chunk_intra_bwd(cb, l, dt, x, dyu)
    _assert_bwd_matches(got, cb, l, dt, x, dy)
    want = ssd.ssd_chunk_intra_bwd(cb, l, dt, x, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_chunk_bwd_tickets_reset_between_shapes(cuda):
    """Two shapes back to back and then the first again, bit-equal to its
    first call: every ticket (items, CTA exits, tiles, chunks) is reset
    by the launch that used it."""
    a = _ssd_bwd_inputs(cuda, 32, 64, 48, 64, 1)
    b = _ssd_bwd_inputs(cuda, 1, 304, 48, 64, 2)
    first = ssd.ssd_chunk_intra_bwd(*a)
    other = ssd.ssd_chunk_intra_bwd(*b)
    again = ssd.ssd_chunk_intra_bwd(*a)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _assert_bwd_matches(other, *b)


def test_ssd_chunk_bwd_on_second_stream(cuda):
    """A call on a second CUDA stream (its own ticket counters) gives the
    default stream's result bit for bit."""
    ins = _ssd_bwd_inputs(cuda, 8, 64, 48, 64, 4)
    want = ssd.ssd_chunk_intra_bwd(*ins)
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = ssd.ssd_chunk_intra_bwd(*ins)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_chunk_bwd_call_is_one_launch(cuda):
    """One call at the training shape (G 32 × Q 64, nh 48, hd 64) and at
    G 1 × Q 304 is one device kernel: dcb and dl are combined in the same
    launch."""
    for g, q in ((32, 64), (1, 304)):
        ins = _ssd_bwd_inputs(cuda, g, q, 48, 64, 5)
        names = _device_kernels(lambda: ssd.ssd_chunk_intra_bwd(*ins))
        assert len(names) == 1 and "ssd_chunk_intra_bwd_kernel" in names[0], \
            names


def test_ssd_bare_launch_with_grad_raises(cuda):
    """A bare launch of the forward kernel whose inputs require a gradient
    raises under grad mode (its output would carry none); under
    ``no_grad`` it runs, and the differentiable entry gives the plain
    version's gradients through the backward kernel."""
    cb, l, dt, x, dy = _ssd_bwd_inputs(cuda, 4, 64, 6, 64, 0)
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="ssd_chunk_intra_diff"):
        ssd.ssd_chunk_intra(cb, l, dt, xg)
    with torch.no_grad():
        ssd.ssd_chunk_intra(cb, l, dt, xg)
    ins = [t.clone().requires_grad_() for t in (cb, l, dt, x)]
    before = ssd.ssd_chunk_intra_bwd.launches
    y = ops.make_kernels("cuda").ssd_chunk_intra(*ins)
    got = torch.autograd.grad(y, ins, dy)
    assert ssd.ssd_chunk_intra_bwd.launches == before + 1
    ref = [t.clone().requires_grad_() for t in (cb, l, dt, x)]
    want = torch.autograd.grad(ssd.ssd_chunk_intra_plain(*ref), ref, dy)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_mamba2_train_step_routes_agree_on_card(cuda):
    """Three train steps of reduced float32 mamba2-780m (batch 2 × 128,
    two chunks; AdamW at base_lr 1e-2, warmup 1) through the kernel route
    and through ``backend="reference"`` from the same weights: each
    step's loss within 1e-5 relative and the gradient norm within 1e-4
    (the backward kernel sums in another order than autograd), each
    step launching the forward kernel twice a layer (remat "full":
    forward and recompute) and the backward once a layer; the reference
    route launches nothing."""
    from repro_torch import optim
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import to_device
    from repro_torch.configs import ShapeSpec
    from repro_torch.tree import tree_map
    cfg = get_arch("mamba2-780m").reduced().replace(
        dtype="float32", remat=True, remat_policy="full")
    p0 = steps.init_train_state(cfg, torch.Generator(device=cuda)
                                .manual_seed(0), device=cuda)[0]
    src = SyntheticLM(cfg, ShapeSpec("t", 128, 2, "train"), DataConfig())
    runs = {}
    for backend in ("cuda", "reference"):
        p = tree_map(lambda t: t.clone(), p0)
        opt = optim.make_optimizer(cfg, base_lr=1e-2, warmup=1)
        step = steps.make_train_step(cfg, opt, backend=backend)
        st = opt.init(p)
        out = []
        for i in range(3):
            ops.reset_launch_counts()
            p, st, m = step(p, st, to_device(src.batch_at(i), cuda))
            out.append((m["loss"].item(), m["grad_norm"].item(),
                        ops.launch_counts()))
        runs[backend] = out
    for (lk, gk, ck), (lr_, gr, cr) in zip(runs["cuda"], runs["reference"]):
        assert abs(lk - lr_) <= 1e-5 * abs(lr_)
        assert abs(gk - gr) <= 1e-4 * gr
        assert ck["ssd_chunk_intra"] == 2 * cfg.num_layers
        assert ck["ssd_chunk_intra_bwd"] == cfg.num_layers
        assert sum(cr.values()) == 0


def test_async_checkpoint_snapshots_cuda_tensors(cuda, tmp_path):
    """An async save of CUDA tensors, then an in-place update of them:
    the checkpoint holds the values from before the update (bf16 bits
    too)."""
    from repro_torch import checkpoint as ckpt
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(256, 512, generator=gen, device=cuda),
            "b": torch.randn(64, generator=gen, device=cuda).bfloat16(),
            "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    before = {k: v.clone() for k, v in tree.items()}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=1)
    saver.save(tree, 0)
    for v in tree.values():
        v.add_(1)
    saver.wait()
    back = ckpt.restore(before, str(tmp_path))
    for k, v in before.items():
        assert back[k].device == v.device and torch.equal(back[k], v), k


def test_mamba2_engine_on_card(cuda):
    """Reduced float32 mamba2-780m served on the card with staggered
    arrivals: each request's solo tokens, the ``backend="reference"``
    route's tokens, and the SSD kernel launched once per layer per
    prefill (and never under "reference")."""
    import numpy as np
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models import mamba2 as M
    from repro_torch.serving import Engine, Request
    cfg = get_arch("mamba2-780m").reduced().replace(dtype="float32")
    p = M.init(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (7, 12, 19, 5, 70)]

    def serve(slots, todo, backend="cuda"):
        eng = Engine(cfg, p, slots=slots, max_len=96, device=cuda,
                     decompose_engine=DecomposeEngine(EngineConfig(
                         backend=backend)))
        ops.reset_launch_counts()
        done = []
        for step in range(300):
            if step % 3 == 0 and step // 3 < len(todo):
                i = todo[step // 3]
                eng.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=12))
            done.extend(eng.step())
            if len(done) == len(todo) and not any(eng.live):
                break
        return {r.uid: r.out_tokens for r in done}, eng.stats, \
            ops.launch_counts()

    got, st, counts = serve(4, list(range(len(prompts))))
    assert st.prefill_batches >= 2
    assert counts["ssd_chunk_intra"] == cfg.num_layers * st.prefill_batches
    assert all(v == 0 for k, v in counts.items() if k != "ssd_chunk_intra")
    for i in range(len(prompts)):
        assert serve(1, [i])[0][i] == got[i], i
    ref, _, counts = serve(4, list(range(len(prompts))), "reference")
    assert ref == got
    assert all(v == 0 for v in counts.values()), counts


MV_FS = (1, 2, 4, 8, 16, 32, 64, 128)     # the matvec spaces' f grid


@pytest.mark.parametrize("dtype,vdtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32")])
@pytest.mark.parametrize("b,s,h,block", [(3, 300, 200, 512),
                                         (1, 37, 1030, 128),
                                         (2, 513, 96, 64),
                                         (1, 64, 4096, 512),
                                         (2, 2000, 64, 8),
                                         (2, 40, 4102, 16)])
def test_matvec_kernels_match_plain_every_f(cuda, dtype, vdtype, b, s, h,
                                            block):
    """The four expanded matvec wrappers against their plain versions at
    every f of the grid and f = 1024, ragged S and H (H = 1030 takes the
    2/4-byte loads, the others the 16-byte path), a block that does not
    divide the output, and splits shorter than one rmatvec ring stage
    (f = 1024 gives 8-row splits; 8 columns a block give 512- or
    1024-row stages), H = 4102 (element copies, splits wider than one
    2048-column matvec panel at f = 1 and 2); reruns bit-identical; each
    call counts one launch of its own wrapper.  float32 sums in another order: 1e-5 relative,
    1e-4 absolute (|y| ~ sqrt(n))."""
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    dt, vdt = getattr(torch, dtype), getattr(torch, vdtype)
    a = torch.randn(b, s, h, generator=gen, device=cuda).to(dt)
    v = torch.randn(b, h, generator=gen, device=cuda).to(vdt)
    u = torch.randn(b, s, generator=gen, device=cuda).to(vdt)
    tol = dict(rtol=1e-5, atol=1e-4)
    for f in MV_FS + (1024,):
        before = {k: ops.KERNELS[k].launches for k in
                  ("matvec", "rmatvec", "matvec_batched", "rmatvec_batched")}
        y = mv.matvec_batched(a, v, expansion=f, row_block=block)
        z = mv.rmatvec_batched(a, u, expansion=f, col_block=block)
        torch.testing.assert_close(y, mv.matvec_batched_plain(
            a, v, expansion=f), **tol)
        torch.testing.assert_close(z, mv.rmatvec_batched_plain(
            a, u, expansion=f), **tol)
        assert torch.equal(y, mv.matvec_batched(a, v, expansion=f,
                                                row_block=block))
        assert torch.equal(z, mv.rmatvec_batched(a, u, expansion=f,
                                                 col_block=block))
        y0 = mv.matvec(a[0], v[0], expansion=f, row_block=block)
        z0 = mv.rmatvec(a[0], u[0], expansion=f, col_block=block)
        assert torch.equal(y0, y[0]) and torch.equal(z0, z[0])
        after = {k: ops.KERNELS[k].launches for k in before}
        assert {k: after[k] - before[k] for k in before} == {
            "matvec": 1, "rmatvec": 1, "matvec_batched": 2,
            "rmatvec_batched": 2}
        assert y.dtype == z.dtype == torch.float32


@pytest.mark.parametrize("f", [1, 8, 1024])
@pytest.mark.parametrize("name", ["matvec_batched", "rmatvec_batched"])
def test_matvec_call_is_one_launch(cuda, name, f):
    """At any f one call is one device kernel: the f partials are added
    by the last CTA of each block in the same launch (no combine
    launch)."""
    a = torch.randn(2, 300, 520, device=cuda)
    x = torch.randn(2, 520 if name == "matvec_batched" else 300,
                    device=cuda)
    kernels = _device_kernels(lambda: getattr(mv, name)(a, x, expansion=f))
    assert len(kernels) == 1 and name.split("_")[0] + "_kernel" in \
        kernels[0], kernels


def test_matvec_kernels_refuse_what_they_do_not_take(cuda):
    a = torch.randn(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mv.matvec_batched(a.transpose(1, 2), torch.randn(2, 8, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mv.matvec_batched(a.half(), torch.randn(2, 16, device=cuda).half())
    with pytest.raises(ValueError, match="do not match"):
        mv.rmatvec_batched(a, torch.randn(2, 16, device=cuda))
    with pytest.raises(ValueError, match="expansion"):
        mv.matvec(a[0], torch.randn(16, device=cuda), expansion=0)
    with pytest.raises(ValueError, match="block"):
        mv.rmatvec(a[0], torch.randn(8, device=cuda), col_block=8192)


def test_measured_tune_on_card_hits_cache(cuda, tmp_path, monkeypatch):
    """A measured tune of the matvec space on the card keys its entry
    under the card's own device kind, persists it, and a second tune
    (a fresh cache object over the same file) answers from the cache;
    an ``expansion="auto"`` engine on the card decomposes bit-identically
    to the engine pinned at its resolved f."""
    from repro_torch import tune
    from repro_torch.engine import DecomposeEngine, EngineConfig
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    kw = dict(shape=(512, 1024), dtype="float32", fix={"row_block": 128},
              prune=3, reps=2, device=cuda)
    r1 = tune.tune("matvec_expand", measure_candidates=True, **kw)
    assert r1.source == "measured" and r1.measured_s > 0
    assert r1.key.startswith("torch-cuda:")
    r2 = tune.tune("matvec_expand", measure_candidates=True,
                   cache=tune.TuningCache(path), **kw)
    assert r2.source == "cache" and r2.best == r1.best
    x = torch.randn(3, 40, 96, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    auto = DecomposeEngine(EngineConfig(expansion="auto"))
    f = auto.resolve_expansion(40, 96, 3, "float32", cuda)
    pinned = DecomposeEngine(EngineConfig(expansion=f))
    la, lp = auto.decompose(x, 6), pinned.decompose(x, 6)
    for p, q in ((la.u, lp.u), (la.core, lp.core), (la.vt, lp.vt)):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# The operating-point knobs of the Eq. 6 GEMM and the dkv statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,k,h,n", [(1, 20, 4096, 1000),
                                     (1, 20, 4160, 4096),
                                     (2, 13, 3000, 300)])
@pytest.mark.parametrize("f", [1, 8, 16, 32])
@pytest.mark.parametrize("nb", [128, 512])
def test_lowrank_matmul_knobs_match_plain(cuda, dtype, b, k, h, n, f, nb):
    """The GEMM at (expansion, n_block) against its plain version at the
    same point: splits combined in the cluster (f <= 8) and by the last
    CTA of a tile (f 16, 32); splits of 136 and 96 rows whose last stage
    holds the next split's rows (H 4160 and 3000 at f 32; H 3000 in bf16
    by element copies, its N 300 not a whole 16-byte row); a CTA walking
    four tiles of which the last is partial (N 1000 at n_block 512).  The tolerances of the unknobbed
    test; reruns bit-identical; one launch."""
    g = torch.Generator(device=cuda).manual_seed(b * k + h + n + f)
    dt = getattr(torch, dtype)
    vt = torch.randn(b, k, h, generator=g, device=cuda).to(dt)
    w = (torch.randn(h, n, generator=g, device=cuda) * h ** -0.5).to(dt)
    before = lrmm.lowrank_matmul.launches
    got = lrmm.lowrank_matmul(vt, w, expansion=f, n_block=nb)
    assert lrmm.lowrank_matmul.launches == before + 1
    want = lrmm.lowrank_matmul_plain(vt, w, expansion=f, n_block=nb)
    assert got.dtype == dt and got.shape == (b, k, n)
    scale = want.float().abs().max().item()
    tol = 1e-4 * scale if dtype == "float32" else 2 ** -7 * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)
    assert torch.equal(got, lrmm.lowrank_matmul(vt, w, expansion=f,
                                                n_block=nb))
    kernels = _device_kernels(
        lambda: lrmm.lowrank_matmul(vt, w, expansion=f, n_block=nb))
    assert len(kernels) == 1 and "lrmm_kernel" in kernels[0], kernels


def test_lowrank_matmul_refuses_splits_shorter_than_a_stage(cuda):
    """f 8 over H 256 makes 32-row splits: the wrapper raises naming the
    shape, launches nothing and does not run the plain version; f 1 at
    H 40 is one split of all of H and runs."""
    vt = torch.randn(1, 20, 256, device=cuda)
    w = torch.randn(256, 512, device=cuda)
    before = lrmm.lowrank_matmul.launches
    with pytest.raises(ValueError, match="H=256"):
        lrmm.lowrank_matmul(vt, w, expansion=8)
    assert lrmm.lowrank_matmul.launches == before
    vt, w = torch.randn(3, 40, device=cuda), torch.randn(40, 300, device=cuda)
    got = lrmm.lowrank_matmul(vt, w, expansion=1, n_block=256)
    torch.testing.assert_close(got, lrmm.lowrank_matmul_plain(vt, w), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nh,t,r,t_valid", [
    (3, 6, 77, 10, (77, 31, 0)),
    (4, 32, 512, 64, (512, 384, 304, 128)),   # phase 4's decode shape
    (1, 32, 8192, 64, (8192,)),               # batch 1 over 8192 rows
    (2, 12, 1000, 40, (1000, 33)),
])
@pytest.mark.parametrize("f", [1, 2, 8, 32])
def test_dkv_kernel_expansion_matches_plain(cuda, dtype, b, nh, t, r,
                                            t_valid, f):
    """The dkv kernel at f time blocks (each walked in 32-row tiles with
    the online-softmax update, merged in block order) against the plain
    version at the same f; f 1 writes directly, t_valid 0 and 31 rows
    over 32 blocks (fewer blocks than f hold rows); reruns and U padded
    past T bit-identical; one launch."""
    g = torch.Generator(device=cuda).manual_seed(t + r + f)
    dt = getattr(torch, dtype)
    inner = torch.randn(b, nh, r, generator=g, device=cuda) * 0.5
    k_u = torch.randn(b, t, r, generator=g, device=cuda).to(dt)
    v_u = torch.randn(b, t, r, generator=g, device=cuda).to(dt)
    tv = torch.tensor(t_valid, dtype=torch.int32, device=cuda)
    before = dk.dkv_attention_stats.launches
    got = dk.dkv_attention_stats(inner, k_u, v_u, tv, expansion=f)
    assert dk.dkv_attention_stats.launches == before + 1
    want = dk.dkv_attention_stats_plain(inner, k_u, v_u, tv, expansion=f)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **TOL)
    for x, y in zip(got, dk.dkv_attention_stats(inner, k_u, v_u, tv,
                                                expansion=f)):
        assert torch.equal(x, y)
    pad = lambda u: torch.cat([u, torch.randn(  # noqa: E731
        b, 40, r, device=cuda, generator=g).to(dt)], 1).contiguous()
    for x, y in zip(got, dk.dkv_attention_stats(inner, pad(k_u), pad(v_u),
                                                tv, expansion=f)):
        assert torch.equal(x, y)
    kernels = _device_kernels(
        lambda: dk.dkv_attention_stats(inner, k_u, v_u, tv, expansion=f))
    assert len(kernels) == 1 and "dkv_stats_kernel" in kernels[0], kernels


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("lowrank_matmul", (20, 1024, 2048), "bfloat16"),
    ("dkv_attention", (4, 32, 512, 64), "bfloat16"),
])
def test_measured_tune_of_knob_spaces_on_card(cuda, tmp_path, monkeypatch,
                                              kernel, shape, dtype):
    """A measured tune of each knob space on the card launches the kernel
    7 times a candidate, keys its entry under the card's device kind, and
    a second tune answers from the cache file."""
    from repro_torch import tune
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    fn = lrmm.lowrank_matmul if kernel == "lowrank_matmul" \
        else dk.dkv_attention_stats
    before = fn.launches
    r1 = tune.tune(kernel, shape, dtype, measure_candidates=True, prune=None,
                   device=cuda)
    assert fn.launches - before == 7 * len(r1.table)
    assert r1.source == "measured" and r1.key.startswith("torch-cuda:")
    r2 = tune.tune(kernel, shape, dtype, measure_candidates=True,
                   cache=tune.TuningCache(path), device=cuda)
    assert r2.source == "cache" and r2.best == r1.best


# ---------------------------------------------------------------------------
# Fused decode blocks replayed as CUDA graphs
# ---------------------------------------------------------------------------

FUSED_ARCH = {"slab": "llama2-7b", "paged": "llama2-7b", "dense": "llama2-7b",
              "ssm": "mamba2-780m"}


def _fused_serve(cuda, kind, dtype, block, params=None, eos=None):
    """Reduced ``FUSED_ARCH[kind]`` in ``dtype``, 2 slots, prompts of
    12/7/15/30 tokens up front, 12 new tokens each (dkv: rank 16, tail 8,
    page 4).  Returns (tokens, engine, launch counts, params)."""
    import numpy as np
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models.api import model_fns
    from repro_torch.serving import Engine, Request
    cfg = get_arch(FUSED_ARCH[kind]).reduced().replace(dtype=dtype)
    if params is None:
        params = model_fns(cfg).init(
            cfg, torch.Generator(device=cuda).manual_seed(0))
    kv = kind in ("slab", "paged")
    ecfg = EngineConfig(kv_rank=16 if kv else 0, kv_tail=8, kv_page=4,
                        decode_block=block)
    eng = Engine(cfg, params, slots=2, max_len=96, device=cuda,
                 paged=kind == "paged", eos_id=eos,
                 decompose_engine=DecomposeEngine(ecfg))
    rng = np.random.RandomState(0)
    for i, n in enumerate((12, 7, 15, 30)):
        eng.submit(Request(uid=i, prompt=rng.randint(0, cfg.vocab, n,
                                                     dtype=np.int32),
                           max_new_tokens=12))
    ops.reset_launch_counts()
    done = eng.run()
    torch.cuda.synchronize()
    return {r.uid: r.out_tokens for r in done}, eng, ops.launch_counts(), \
        params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["slab", "paged", "dense", "ssm"])
def test_graph_blocks_token_equal_single_step(cuda, kind, dtype):
    """Blocks of 4 replayed as CUDA graphs give the single-step engine's
    tokens for every family, in float32 and bf16 (the kernel route is
    bit-equal at the graphs' padded rows); nothing decodes eagerly; the
    kernel launches of the replays equal the single-step run's."""
    base, e1, c1, p = _fused_serve(cuda, kind, dtype, 1)
    got, eb, cb, _ = _fused_serve(cuda, kind, dtype, 4, p)
    assert got == base
    g = eb.graphs
    assert g.eager == 0 and g.replays == eb.stats.blocks > 0
    assert g.captures <= g.replays and eb.stats.blocks < e1.stats.blocks
    for name, n in c1.items():
        assert cb[name] - g.warmup_launches.get(name, 0) == n, name
    if kind in ("slab", "paged"):
        assert e1.stats.tail_folds > 0 and sum(c1.values()) > 0
    # a stop token mid-block halts the replay on the device
    eos = base[0][5]
    b_eos, e_eos, _, _ = _fused_serve(cuda, kind, dtype, 1, p, eos=eos)
    g_eos, f_eos, _, _ = _fused_serve(cuda, kind, dtype, 4, p, eos=eos)
    assert g_eos == b_eos and f_eos.stats.stopped_eos == \
        e_eos.stats.stopped_eos >= 1


def test_graph_same_key_replays_without_capture(cuda):
    """A block whose key was captured replays without a new capture; the
    reference route runs its blocks eagerly (its plain statistics read
    ``t_valid`` on the host), with the same tokens."""
    got, eng, _, p = _fused_serve(cuda, "slab", "float32", 4)
    caps, reps = eng.graphs.captures, eng.graphs.replays
    assert reps > caps >= 1
    tok = eng._last_tokens()
    stops = eng._stop_table()
    eng.family.decode_block(tok, 4, stops)
    eng.family.decode_block(tok, 4, stops)
    assert eng.graphs.captures in (caps, caps + 1)
    caps2 = eng.graphs.captures
    eng.family.decode_block(tok, 4, stops)
    assert eng.graphs.captures == caps2
    assert eng.graphs.replays == reps + 3
    # dropping every graph drops their pool; the next capture takes anew
    eng.graphs.clear()
    eng.family.decode_block(tok, 4, stops)
    assert eng.graphs.captures == caps2 + 1
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine, Request
    import numpy as np
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    ref = Engine(cfg, p, slots=2, max_len=96, device=cuda,
                 decompose_engine=DecomposeEngine(EngineConfig(
                     kv_rank=16, kv_tail=8, decode_block=4,
                     backend="reference")))
    rng = np.random.RandomState(0)
    for i, n in enumerate((12, 7, 15, 30)):
        ref.submit(Request(uid=i, prompt=rng.randint(0, cfg.vocab, n,
                                                     dtype=np.int32),
                           max_new_tokens=12))
    done = ref.run()
    assert {r.uid: r.out_tokens for r in done} == got
    assert ref.graphs.captures == 0 and ref.graphs.eager > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkv_kernel_bit_equal_at_padded_rows(cuda, dtype):
    """The slab dkv kernel over U padded to a multiple of 128 rows (the
    graphs' static buffers, stale data past the exact rows) is bit-equal
    to the kernel over the exact rows: it reads rows below t_valid."""
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = getattr(torch, dtype)
    b, nh, t, r = 4, 32, 529, 64
    inner = torch.randn(b, nh, r, device=cuda, generator=g)
    ku = torch.randn(b, t, r, device=cuda, generator=g).to(dt)
    vu = torch.randn(b, t, r, device=cuda, generator=g).to(dt)
    tv = torch.tensor([529, 512, 0, 33], dtype=torch.int32, device=cuda)
    pad = lambda u: torch.cat([u, torch.randn(  # noqa: E731
        b, 640 - t, r, device=cuda, generator=g).to(dt)], 1).contiguous()
    for x, y in zip(dk.dkv_attention_stats(inner, ku, vu, tv),
                    dk.dkv_attention_stats(inner, pad(ku), pad(vu), tv)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_dropped_engine_frees_its_graphs_without_gc(cuda, kind):
    """``del eng`` frees the engine, its graphs (and with them their
    memory pool), their static input buffers and the cache the graphs
    read at once, with the cyclic collector off."""
    import gc
    import weakref
    _, _, _, p = _fused_serve(cuda, kind, "float32", 1)
    gc.collect()
    gc.disable()
    try:
        _, eng, _, _ = _fused_serve(cuda, kind, "float32", 4, p)
        ents = list(eng.graphs._lru.values())
        assert ents and eng.graphs.captures > 0
        cache = eng.pager.cache if kind == "paged" else eng.cache
        held = [eng, eng.graphs] + [e.graph for e in ents] \
            + [e.flat for e in ents] + [cache["k_vt"], cache["tail"]["v" if
                                         kind == "slab" else "v_pages"]]
        refs = [weakref.ref(x) for x in held]
        del eng, ents, cache, held
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# Async admission on the prefill stream; the MoE and hybrid families
# ---------------------------------------------------------------------------

ASYNC_ARCH = {"slab": "llama2-7b", "paged": "llama2-7b", "dense": "llama2-7b",
              "hybrid": "zamba2-1.2b", "moe": "olmoe-1b-7b"}
ASYNC_ARRIVALS = {0: [0, 1], 3: [2], 6: [3]}     # chip_smoke's phase 4


def _async_engine(cuda, kind, dtype, block, params=None, **kw):
    """Reduced ``ASYNC_ARCH[kind]`` in ``dtype`` on the card, 4 slots,
    max_len 96 (dkv: rank 16, tail 8, page 4).  Returns (engine,
    params)."""
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models.api import model_fns
    from repro_torch.serving import Engine
    cfg = get_arch(ASYNC_ARCH[kind]).reduced().replace(dtype=dtype)
    if params is None:
        params = model_fns(cfg).init(
            cfg, torch.Generator(device=cuda).manual_seed(0))
    kv = kind in ("slab", "paged")
    ecfg = EngineConfig(kv_rank=16 if kv else 0, kv_tail=8, kv_page=4,
                        decode_block=block)
    return Engine(cfg, params, slots=4, max_len=96, device=cuda,
                  paged=kind == "paged",
                  decompose_engine=DecomposeEngine(ecfg), **kw), params


def _async_drive(eng, arrivals=ASYNC_ARRIVALS, max_new=12):
    """Prompts of 24/17/30/9 tokens, request i submitted once the engine
    has run the rounds ``arrivals`` gives it, a fused engine's blocks cut
    at those rounds (``chip_smoke.drive``)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, eng.cfg.vocab, n, dtype=np.int32)
               for n in (24, 17, 30, 9)]
    block, rounds, done = eng.decode_block, sorted(arrivals), []
    for _ in range(500):
        while rounds and rounds[0] <= eng._round:
            for i in arrivals[rounds.pop(0)]:
                eng.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=max_new))
        eng.decode_block = min(block, rounds[0] - eng._round) if rounds \
            else block
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    torch.cuda.synchronize()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    return {r.uid: r.out_tokens for r in done}


@pytest.mark.parametrize("kind", ["dense", "hybrid", "moe"])
def test_ticket_waits_for_its_prefill_stream(cuda, kind):
    """A ticket is not ready while its prefill, on the prefill stream, is
    held back by a device sleep, and becomes ready once it ran; the
    current stream never waited for it (decode could go on).  These
    families' prefills read nothing back to the host (the decomposed-KV
    prefill does: its bidiagonal SVD checks cuSOLVER's status, so its
    dispatch returns only after most of its device work)."""
    import numpy as np
    from repro_torch.serving import Request
    eng, _ = _async_engine(cuda, kind, "float32", 1, prefill_async=True,
                           ready_order="ready")
    assert eng.prefill_stream is not None
    assert eng.prefill_stream != torch.cuda.current_stream(cuda)
    # a first request loads every kernel the prefill runs (a kernel's
    # first launch may wait for the device while its module loads)
    eng.submit(Request(uid=-1, prompt=np.arange(1, 20, dtype=np.int32),
                       max_new_tokens=2))
    eng.run()
    prefill = eng.family._prefill

    def held(toks):
        torch.cuda._sleep(500_000_000)        # ~0.25 s of device time
        return prefill(toks)

    eng.family._prefill = held
    eng.submit(Request(uid=0, prompt=np.arange(1, 20, dtype=np.int32),
                       max_new_tokens=4))
    torch.cuda.synchronize()
    eng._admit()
    (ticket,) = eng._pool
    assert not ticket.ready()
    assert torch.cuda.current_stream(cuda).query()   # decode was free
    torch.cuda.synchronize()
    assert ticket.ready()
    del eng.family._prefill             # back to the method
    done = eng.run()
    assert [r.uid for r in done] == [0] and not eng._occupied()


@pytest.mark.parametrize("kind", ["slab", "paged", "hybrid", "moe"])
def test_fused_async_tokens_equal_sync_single_step(cuda, kind):
    """Fused blocks of 4 (replayed graphs) with async admission on the
    prefill stream, deterministic and (where rows never interact) ready
    order, give the sync single-step engine's tokens; every block is a
    replay; a paged engine gets every page back."""
    base_eng, p = _async_engine(cuda, kind, "float32", 1)
    base = _async_drive(base_eng)
    orders = ("deterministic",) if kind == "moe" else ("deterministic",
                                                      "ready")
    for order in orders:
        eng, _ = _async_engine(cuda, kind, "float32", 4, p,
                               prefill_async=True, ready_order=order)
        got = _async_drive(eng)
        if order == "deterministic" or kind not in ("slab", "paged"):
            assert got == base, order
        g = eng.graphs
        assert g.eager == 0 and g.replays == eng.stats.blocks > 0
        if kind == "paged":
            pg = eng.pager
            assert pg.alloc.free_pages == pg.num_pages - 1
            assert pg.talloc.free_pages == pg.num_tail_pages - 1


@pytest.mark.parametrize("kind", ["hybrid", "moe"])
def test_new_families_replay_graphs(cuda, kind):
    """Reduced MoE and hybrid serving in bf16: blocks of 4 replay captured
    graphs (none eager) with the single-step tokens; the hybrid prefill
    launches the SSD kernel once per Mamba2 block, decode never."""
    base_eng, p = _async_engine(cuda, kind, "bfloat16", 1)
    ops.reset_launch_counts()
    base = _async_drive(base_eng)
    launches = ops.launch_counts()
    eng, _ = _async_engine(cuda, kind, "bfloat16", 4, p)
    assert _async_drive(eng) == base
    assert eng.graphs.eager == 0 and eng.graphs.replays == eng.stats.blocks
    cfg = base_eng.cfg
    want = cfg.num_layers - cfg.num_layers // cfg.attn_period \
        if kind == "hybrid" else 0
    assert launches["ssd_chunk_intra"] == \
        want * base_eng.stats.prefill_batches
    assert sum(launches.values()) == launches["ssd_chunk_intra"]


def test_dropped_async_engine_frees_its_memory_without_gc(cuda):
    """An engine dropped with tickets in flight on the prefill stream
    frees its cache and the tickets' fresh rows at once, with the cyclic
    collector off."""
    import gc
    import numpy as np
    from repro_torch.serving import Request
    p = _async_engine(cuda, "slab", "float32", 1)[1]

    def start():
        eng = _async_engine(cuda, "slab", "float32", 4, p,
                            prefill_async=True, ready_order="ready")[0]
        rng = np.random.RandomState(0)
        for i in range(4):
            eng.submit(Request(uid=i, prompt=rng.randint(
                0, 512, 20, dtype=np.int32), max_new_tokens=4))
        eng._admit()
        assert eng._pool
        return eng

    start().run()                  # the process's lasting buffers
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        eng = start()
        del eng
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    assert after <= before, (before, after)


def test_moe_ffn_under_capture_equals_eager(cuda):
    """One MoE FFN at decode's shape captured into a CUDA graph and
    replayed gives the eager call's output bit for bit (routing, sorts,
    the capacity scatter and the expert products all run on the
    device, with no host read)."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.api import model_fns
    cfg = get_arch("olmoe-1b-7b").reduced()
    p = model_fns(cfg).init(cfg, torch.Generator(device=cuda).manual_seed(0))
    lp = L.layer_params(p["layers"], 0)["moe"]
    x = torch.randn(4, 1, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    want, _ = moe.moe_ffn(lp, x, cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_ffn(lp, x, cfg)                     # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = moe.moe_ffn(lp, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The dense variants' kernel shapes, the VLM and audio families, the keyed
# draw under capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("b,s,h", [(18, 512, 256),     # gemma-2b's kv_width
                                   (40, 512, 512)])    # granite-3-2b's
def test_reorth_kernel_at_variant_kv_widths(cuda, side, b, s, h):
    """The re-orth pair at a variant's decomposed-KV prefill of one
    512-token prompt (B = layers, H = kv_width; k = 72 half filled, as
    rank 64 fills it): against the plain version at the default f and at
    f 32, reruns bit-identical."""
    a, x, q = _reorth_inputs(cuda, side, b, s, h, 72, 36)
    kern = getattr(lr, f"reorth_{side}_batched")
    zp, nzp = getattr(lr, f"reorth_{side}_batched_plain")(a, x, q)
    for f in (lr.DEFAULT_EXPANSION, 32):
        z, nz = kern(a, x, q, expansion=f)
        torch.testing.assert_close(z, zp, **TOL)
        torch.testing.assert_close(nz, nzp, **TOL)
        assert torch.equal(z, kern(a, x, q, expansion=f)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,t_valid", [(36, (1024, 700, 513, 128)),
                                        (8, (512, 384, 304, 128))])
def test_dkv_kernel_at_variant_heads(cuda, dtype, nh, t_valid):
    """dkv_attention_stats at starcoder2-7b's 36 query heads (four groups
    of 8 and a partial group of 4) and gemma-2b's 8, r 64, four slots:
    against the plain version, reruns bit-identical."""
    t, r = max(t_valid), 64
    g = torch.Generator(device=cuda).manual_seed(nh)
    dt = getattr(torch, dtype)
    inner = torch.randn(4, nh, r, generator=g, device=cuda)
    k_u = torch.randn(4, t, r, generator=g, device=cuda).to(dt)
    v_u = torch.randn(4, t, r, generator=g, device=cuda).to(dt)
    tv = torch.tensor(t_valid, dtype=torch.int32, device=cuda)
    got = dk.dkv_attention_stats(inner, k_u, v_u, tv)
    for x, y in zip(got, dk.dkv_attention_stats_plain(inner, k_u, v_u, tv)):
        torch.testing.assert_close(x, y, **TOL)
    for x, y in zip(got, dk.dkv_attention_stats(inner, k_u, v_u, tv)):
        assert torch.equal(x, y)


def _nonzero_biases(tree, gen):
    """Every bias, norm bias and cross gate of ``tree`` redrawn N(0, 0.1²)
    (gates 0.5 ± 0.1) in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _nonzero_biases(v, gen)
        elif k in ("b", "bias", "gate_attn", "gate_mlp"):
            v.copy_(torch.randn(v.shape, generator=gen, device=v.device) * 0.1
                    + (0.5 if k.startswith("gate") else 0.0))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium", "starcoder2-7b",
                                  "gemma-2b"])
def test_new_models_on_card_match_host(cuda, arch):
    """Reduced float32 models with non-zero biases and gates: prefill
    (random image embeddings / frames) and three decode steps on the card
    against the same model on the host, and the serving engine's tokens
    (single-step and fused blocks of 3, replayed) equal to the host's."""
    import numpy as np
    from repro_torch.models import api
    from repro_torch.serving import Engine, Request
    cfg = get_arch(arch).reduced().replace(dtype="float32")
    fns = api.model_fns(cfg)
    host = fns.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    _nonzero_biases(host, torch.Generator().manual_seed(1))
    dev = api.tree_map(lambda t: t.to(cuda), host)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 10))).long()

    def extra(shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    args = fns.prefill_inputs(cfg, toks, extra)
    lh, ch = fns.prefill(host, cfg, *args, 16)
    lg, cg = fns.prefill(dev, cfg, *(a.to(cuda) for a in args), 16)
    torch.testing.assert_close(lg.cpu(), lh, **TOL)
    pos = torch.tensor([10, 10])
    for step in range(3):
        tok = lh.argmax(-1)
        lh, ch = fns.decode_step(host, cfg, tok, ch, pos + step)
        lg, cg = fns.decode_step(dev, cfg, tok.to(cuda), cg,
                                 (pos + step).to(cuda))
        torch.testing.assert_close(lg.cpu(), lh, **TOL)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (12, 7, 15)]

    def serve(params, device, block):
        eng = Engine(cfg, params, slots=2, max_len=48, device=device,
                     decode_block=block)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=10))
        return {r.uid: r.out_tokens for r in eng.run()}, eng
    want, _ = serve(host, "cpu", 1)
    assert serve(dev, cuda, 1)[0] == want
    got, eng = serve(dev, cuda, 3)
    assert got == want and eng.graphs.eager == 0 and eng.graphs.replays > 0


@pytest.mark.parametrize("kind", ["dense", "slab"])
def test_keyed_draw_replayed_equals_eager(cuda, kind):
    """Categorical sampling: blocks of 4 replayed as CUDA graphs (the
    round index in the graph's feed) give the single-step engine's
    tokens, and the host engine's; the captured draw equals the eager
    one."""
    import numpy as np
    from repro_torch import sampling
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models.api import model_fns
    from repro_torch.serving import Engine, Request, categorical_sampler
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    host = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    from repro_torch.models.api import tree_map
    dev = tree_map(lambda t: t.to(cuda), host)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (12, 7, 15, 30)]

    def serve(params, device, block):
        ecfg = EngineConfig(kv_rank=16 if kind == "slab" else 0, kv_tail=8,
                            decode_block=block)
        eng = Engine(cfg, params, slots=2, max_len=96, device=device,
                     decompose_engine=DecomposeEngine(ecfg),
                     sampler=categorical_sampler(0.8), sample_seed=5)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=12))
        return {r.uid: r.out_tokens for r in eng.run()}, eng
    one, _ = serve(dev, cuda, 1)
    four, eng = serve(dev, cuda, 4)
    assert four == one and eng.graphs.replays > eng.graphs.captures >= 1
    assert eng.graphs.eager == 0
    if kind == "dense":       # no Lanczos: the host draws the same tokens
        assert serve(host, "cpu", 1)[0] == one
    # the draw itself, captured with its key in a device buffer
    logits = torch.randn(4, 1000, device=cuda)
    key = torch.zeros((), dtype=torch.int64, device=cuda)
    sample = categorical_sampler(1.0)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        sample(logits, 1, key)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sample(logits, 1, key)
    for r in (0, 7, 123456):
        k = sampling.fold_in(sampling.prng_key(2), r)
        key.fill_(k)
        graph.replay()
        assert torch.equal(out, sample(logits, 1, k))


# ---------------------------------------------------------------------------
# Observability and backend="auto" on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_obs_token_neutral_with_graphs_replaying(cuda, kind):
    """``Observability(trace=True)`` on an async engine (prefills on the
    prefill stream, deterministic order) whose blocks of 4 replay CUDA
    graphs: the tokens, launch counts, captures and blocks of the
    obs-off engine, nothing eager; a valid trace with ticket, splice and
    decode-block spans; the compile watch holds both engines' captures
    under ``decode``, and the exported graph counters are the runner's."""
    from repro_torch.obs import (Observability, compile_stats,
                                 parse_prometheus, to_prometheus,
                                 validate_trace)

    def captures():
        return compile_stats(kind="cuda_graph").get(
            "decode", {"compiles": 0})["compiles"]

    base = captures()
    runs, params = [], None
    for obs in (None, Observability(trace=True)):
        eng, params = _async_engine(cuda, kind, "float32", 4, params,
                                    prefill_async=True,
                                    ready_order="deterministic", obs=obs)
        ops.reset_launch_counts()
        runs.append((eng, _async_drive(eng), ops.launch_counts()))
    (e0, t0, l0), (e1, t1, l1) = runs
    assert t1 == t0 and l1 == l0
    for e in (e0, e1):
        assert e.graphs.eager == 0 and e.graphs.replays == e.stats.blocks > 0
    assert (e1.graphs.captures, e1.stats.blocks) == \
        (e0.graphs.captures, e0.stats.blocks)
    obs = e1.obs
    assert validate_trace(obs.tracer.to_json()) >= 16
    assert {"ticket", "splice", "decode-block", "fold"} <= {
        ev["name"] for ev in obs.tracer.events}
    assert captures() - base == e0.graphs.captures + e1.graphs.captures
    parsed = parse_prometheus(to_prometheus(obs.registry))
    assert parsed["repro_serving_graph_replays"][0][1] == e1.graphs.replays
    assert parsed["repro_serving_graph_captures"][0][1] == e1.graphs.captures


def test_tune_backend_on_card(cuda, tmp_path, monkeypatch):
    """``tune_backend`` measures both backends on the card and stores the
    winner under the card's device kind; ``resolve_backend`` and an
    ``EngineConfig(backend="auto")`` engine take it; without a stored
    winner the card resolves to ``"cuda"``."""
    from repro_torch import tune
    from repro_torch.engine import DecomposeEngine, EngineConfig
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "empty.json"))
    assert tune.resolve_backend() == "cuda"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "cache.json"))
    res = tune.tune_backend((4, 256, 512), reps=3, device=cuda)
    assert res.key.startswith("torch-cuda:")
    assert res.key.endswith("/engine_backend")
    assert sorted(r[0]["backend"] for r in res.table) == ["cuda",
                                                          "reference"]
    assert all(r[2] > 0 for r in res.table)
    assert tune.resolve_backend() == res.best["backend"]
    assert DecomposeEngine(EngineConfig(backend="auto")).resolved_backend \
        == res.best["backend"]


# ---------------------------------------------------------------------------
# Slot-sharded serving across two cards (NCCL)
# ---------------------------------------------------------------------------

_NCCL_WORKER = '''
import os, pickle, sys
import numpy as np
import torch
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from repro_torch.configs import get_arch
from repro_torch.engine import DecomposeEngine, EngineConfig
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.launch import mesh as M
from repro_torch.models.api import model_fns
from repro_torch.serving import Engine, Request
M.init_distributed("cuda", rank=rank, world_size=world, store_path=store)
mesh = M.make_host_mesh(world, 1, "cuda")
cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
params = model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
rng = np.random.RandomState(0)
prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
           for n in (12, 7, 15, 9, 14)]

def serve(m, block, paged, eos=None):
    ec = EngineConfig(kv_rank=8, kv_tail=4, kv_page=4, mesh=m)
    eng = Engine(cfg, params, slots=8, max_len=64, device="cuda",
                 decompose_engine=DecomposeEngine(ec), decode_block=block,
                 paged=paged, eos_id=eos)
    done = []
    for step in range(300):
        if step % 3 == 0 and step // 3 < len(prompts):
            i = step // 3
            eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=12))
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    return ({r.uid: r.out_tokens for r in done}, eng.stats.tail_folds,
            eng.shard.n)

res = {(b, p): (serve(mesh, b, p), serve(None, b, p))
       for b in (1, 4) for p in (False, True)}
eos = res[(1, False)][1][0][0][5]     # request 0's 6th token stops it
res["eos"] = (serve(mesh, 4, False, eos), serve(None, 4, False, eos))
pickle.dump(res, open(os.path.join(out, f"r{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more: the NCCL serving "
                    "test runs one rank a card")
    return min(torch.cuda.device_count(), 4)


def test_nccl_slot_sharded_serving_tokens(cards, tmp_path):
    """One rank a card (2 to 4), a (ranks, 1) mesh: float32
    decomposed-KV serving of 8 slots (staggered admissions, tail folds;
    slab and paged; single-step and fused blocks of 4; a stop token
    under fused blocks) gives every rank the tokens of the no-mesh
    engine, each rank holding 8 / ranks slots."""
    import os
    import pickle
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_WORKER, str(r),
                               str(cards), store, str(tmp_path)], env=env)
             for r in range(cards)]
    assert [p.wait(timeout=900) for p in procs] == [0] * cards
    for r in range(cards):
        with open(tmp_path / f"r{r}.pkl", "rb") as f:
            res = pickle.load(f)
        for case, ((meshed, folds, n), (plain, _, _)) in res.items():
            assert meshed == plain, (r, case)
            assert folds > 0 or case == "eos", (r, case)
            assert n == (8 // cards if 8 % cards == 0 else 8), (r, case)


_NCCL_TP_WORKER = '''
import os, pickle, sys
import numpy as np
import torch
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from repro_torch import optim
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.engine import DecomposeEngine, EngineConfig
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.launch import mesh as M
from repro_torch.models.api import model_fns
from repro_torch.runtime import steps
from repro_torch.runtime.driver import to_device
from repro_torch.serving import Engine, Request
M.init_distributed("cuda", rank=rank, world_size=world, store_path=store)
m14 = M.make_host_mesh(1, 4, "cuda")
m22 = M.make_host_mesh(2, 2, "cuda")
res = {}

# (1, 4): full-width llama2-7b decomposed KV, float32, tensor-parallel
cfg = get_arch("llama2-7b").replace(dtype="float32")
params = model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
rng = np.random.RandomState(0)
prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
           for n in (128, 96, 64, 48)]

def serve(mesh, block, paged=False):
    ec = EngineConfig(kv_rank=32, kv_tail=8, kv_page=16, mesh=mesh)
    eng = Engine(cfg, params, slots=4, max_len=256, device="cuda",
                 decompose_engine=DecomposeEngine(ec), decode_block=block,
                 paged=paged)
    reset_launch_counts()
    done = []
    for step in range(400):
        if step % 3 == 0 and step // 3 < len(prompts):
            i = step // 3
            eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=16))
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    return ({r.uid: r.out_tokens for r in done}, eng.stats.tail_folds,
            tuple(eng.params["layers"]["attn"]["wq"]["w"].shape),
            eng.stats.decode_tok_s, eng.graphs.replays, launch_counts())

sh.reset_collective_counts()
res["serve"] = (serve(m14, 1), sh.collective_counts())
try:
    res["fused"] = serve(m14, 4)
except RuntimeError as e:
    res["fused"] = str(e)
res["paged"] = serve(m14, 1, paged=True)
res["serve_plain"] = serve(None, 1)
res["fused_plain"] = serve(None, 4)
res["paged_plain"] = serve(None, 1, paged=True)
del params
torch.cuda.empty_cache()

# (2, 2): two TP + ZeRO-1 steps of full-width granite-3-2b, float32
gcfg = get_arch("granite-3-2b").replace(dtype="float32")
src = SyntheticLM(gcfg, ShapeSpec("t", 128, 4, "train"), DataConfig(seed=0))
batches = [to_device(src.batch_at(i), "cuda") for i in range(2)]
for tag, mesh in (("plain", None), ("zero1", m22)):
    p = model_fns(gcfg).init(gcfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
    opt = optim.make_optimizer(gcfg, warmup=1)
    st = opt.init(p)
    kw = {}
    if mesh is not None:
        kw = dict(zero1=True)
        p, st = steps.shard_train_state(gcfg, p, st, mesh, optimizer=opt,
                                        **kw)
    fn = steps.make_train_step(gcfg, opt, mesh=mesh, **kw)
    losses = []
    for b in batches:
        p, st, m = fn(p, st, b)
        losses.append(m["loss"].item())
    res["train_" + tag] = (losses, tuple(st["m"]["embed"]["w"].shape),
                           torch.cuda.max_memory_allocated() / 2 ** 30)
    torch.cuda.reset_peak_memory_stats()
    del p, st
    torch.cuda.empty_cache()
pickle.dump(res, open(os.path.join(out, f"tp{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


def test_nccl_tensor_parallel_serving_and_zero1_steps(cards, tmp_path):
    """Four ranks, one a card.  (1, 4): full-width llama2-7b (float32)
    decomposed-KV serving on the model axis, each rank a quarter of the
    weights: tokens equal the no-mesh engine's, slab and paged
    single-step (the paged run's launches of the paged dkv kernel equal
    no mesh's, the slab's of the slab kernel too); fused blocks of 4
    either equal too or raise naming the capture of the collectives.
    (2, 2): two TP + ZeRO-1 steps of full-width granite-3-2b (float32):
    losses within 1e-5 of the no-mesh steps, each rank holding a
    [V / 2, H / 2] block of the embedding's first moment."""
    import os
    import pickle
    import subprocess
    import sys
    if cards < 4:
        pytest.skip("needs four CUDA devices: a (1, 4) and a (2, 2) mesh")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_TP_WORKER,
                               str(r), "4", store, str(tmp_path)], env=env)
             for r in range(4)]
    assert [p.wait(timeout=1500) for p in procs] == [0] * 4
    from repro_torch.configs import get_arch
    cfg = get_arch("llama2-7b")
    gcfg = get_arch("granite-3-2b")
    for r in range(4):
        with open(tmp_path / f"tp{r}.pkl", "rb") as f:
            res = pickle.load(f)
        (toks, folds, wq, tok_s, _, launches), counts = res["serve"]
        assert toks == res["serve_plain"][0], r
        paged, plain_paged = res["paged"], res["paged_plain"]
        assert paged[0] == plain_paged[0] and paged[1] > 0, r
        for got, want, k in ((launches, res["serve_plain"][5],
                              "dkv_attention_stats"),
                             (paged[5], plain_paged[5],
                              "dkv_attention_stats_paged")):
            assert got[k] == want[k] > 0, (r, k, got[k], want[k])
        assert folds > 0 and wq == (cfg.num_layers, cfg.d_model,
                                    cfg.d_model // 4)
        assert counts["all_reduce/tp_out"][0] > 0
        fused = res["fused"]
        if isinstance(fused, str):
            assert "captured as a CUDA graph" in fused, fused
        else:
            assert fused[0] == res["fused_plain"][0], r
        plain, _, peak_plain = res["train_plain"]
        got, m_embed, peak = res["train_zero1"]
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, plain))
        assert m_embed == (gcfg.padded_vocab // 2, gcfg.d_model // 2)
        if r == 0:
            fused = res["fused"]
            print(f"\nnccl tp: (1, 4) decode tok/s {tok_s:.2f} vs no mesh "
                  f"{res['serve_plain'][3]:.2f}; fused blocks of 4: "
                  + (fused if isinstance(fused, str) else
                     f"captured, {fused[4]} replays, tok/s {fused[3]:.2f} "
                     f"vs no mesh {res['fused_plain'][3]:.2f}")
                  + f"; paged decode tok/s {paged[3]:.2f} vs no mesh "
                  f"{plain_paged[3]:.2f}, paged dkv launches "
                  f"{paged[5]['dkv_attention_stats_paged']}"
                  + f"; collectives of the run {counts}; (2, 2) ZeRO-1 "
                  f"losses {got} vs no mesh {plain}, peak GiB {peak:.2f} "
                  f"vs {peak_plain:.2f}")


# ---------------------------------------------------------------------------
# The "model" axis of the ssm, hybrid, vlm and audio families (four cards)
# ---------------------------------------------------------------------------

#: full width, depth cut: zamba2-1.2b keeps one group of 5 Mamba2 blocks
#: and its shared attention block, the VLM one self group and a cross block
TP_FAMILY_CUTS = {
    "mamba2-780m": dict(num_layers=4),
    "zamba2-1.2b": dict(num_layers=6),
    "llama-3.2-vision-11b": dict(num_layers=5),
    "seamless-m4t-medium": dict(num_layers=4, enc_layers=2),
}

_NCCL_TP_FAMILIES_WORKER = '''
import os, pickle, sys
import numpy as np
import torch
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from repro_torch import optim
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.engine import DecomposeEngine, EngineConfig
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.launch import mesh as M
from repro_torch.models.api import model_fns
from repro_torch.runtime import steps
from repro_torch.runtime.driver import to_device
from repro_torch.serving import Engine, Request
M.init_distributed("cuda", rank=rank, world_size=world, store_path=store)
m14 = M.make_host_mesh(1, 4, "cuda")
res = {}

def init(cfg):
    return model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda")

# (1, 4): each family at full width (depth cut), float32, tensor-parallel
for arch, cut in CUTS.items():
    cfg = get_arch(arch).replace(dtype="float32", **cut)
    params = init(cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (128, 96, 64, 48)]

    def serve(mesh, block):
        eng = Engine(cfg, params, slots=4, max_len=256, device="cuda",
                     decompose_engine=DecomposeEngine(EngineConfig(
                         mesh=mesh)), decode_block=block)
        reset_launch_counts()
        sh.reset_collective_counts()
        done = []
        for step in range(400):
            if step % 3 == 0 and step // 3 < len(prompts):
                i = step // 3
                eng.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=16))
            done.extend(eng.step())
            if len(done) == len(prompts) and not eng._occupied():
                break
        return ({r.uid: r.out_tokens for r in done},
                launch_counts()["ssd_chunk_intra"], eng.stats.decode_tok_s,
                eng.graphs.replays, sh.collective_counts())

    res[arch] = {}
    for tag, mesh, block in (("tp", m14, 1), ("plain", None, 1),
                             ("tp_fused", m14, 4), ("plain_fused", None, 4)):
        try:
            res[arch][tag] = serve(mesh, block)
        except RuntimeError as e:
            if tag != "tp_fused":
                raise
            res[arch][tag] = str(e)
    del params
    torch.cuda.empty_cache()

# (1, 4): two TP + ZeRO-1 steps of mamba2-780m (depth 4, float32): both
# SSD kernels at 12 heads a rank
cfg = get_arch("mamba2-780m").replace(dtype="float32", num_layers=4)
src = SyntheticLM(cfg, ShapeSpec("t", 256, 4, "train"), DataConfig(seed=0))
batches = [to_device(src.batch_at(i), "cuda") for i in range(2)]
for tag, mesh in (("plain", None), ("zero1", m14)):
    p = init(cfg)
    opt = optim.make_optimizer(cfg, warmup=1)
    st = opt.init(p)
    kw = {}
    if mesh is not None:
        kw = dict(zero1=True)
        p, st = steps.shard_train_state(cfg, p, st, mesh, optimizer=opt,
                                        **kw)
    fn = steps.make_train_step(cfg, opt, mesh=mesh, **kw)
    losses = []
    reset_launch_counts()
    for b in batches:
        p, st, m = fn(p, st, b)
        losses.append(m["loss"].item())
    res["train_" + tag] = (losses, launch_counts()["ssd_chunk_intra_bwd"],
                           tuple(p["layers"]["ssd"]["in_proj"]["w"].shape))
    del p, st
    torch.cuda.empty_cache()
pickle.dump(res, open(os.path.join(out, f"fam{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


def test_nccl_tensor_parallel_families(cards, tmp_path):
    """Four ranks, one a card, on a (1, 4) mesh.  mamba2-780m,
    zamba2-1.2b, llama-3.2-vision-11b and seamless-m4t-medium at full
    width (depth cut by ``TP_FAMILY_CUTS``), float32, served
    tensor-parallel (a rank: 12 or 16 SSD heads, a quarter of the
    attention heads): tokens and the SSD kernel's launches equal the
    no-mesh engine's, model-axis collectives issued; fused blocks of 4
    either equal the no-mesh fused tokens or raise naming the capture of
    the collectives.  Two TP + ZeRO-1 steps of mamba2-780m (depth 4):
    losses within 1e-5 of the no-mesh steps, the SSD backward launched as
    often, each rank a quarter of in_proj's columns."""
    import os
    import pickle
    import subprocess
    import sys
    if cards < 4:
        pytest.skip("needs four CUDA devices: a (1, 4) mesh")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    store = str(tmp_path / "store")
    src = f"CUTS = {TP_FAMILY_CUTS!r}\n" + _NCCL_TP_FAMILIES_WORKER
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), "4",
                               store, str(tmp_path)], env=env)
             for r in range(4)]
    assert [p.wait(timeout=1500) for p in procs] == [0] * 4
    from repro_torch.configs import get_arch
    mcfg = get_arch("mamba2-780m")
    cols = 2 * mcfg.d_inner + 2 * mcfg.ssm_state + mcfg.ssm_heads
    lines = []
    for r in range(4):
        with open(tmp_path / f"fam{r}.pkl", "rb") as f:
            res = pickle.load(f)
        for arch in TP_FAMILY_CUTS:
            got, want = res[arch]["tp"], res[arch]["plain"]
            assert got[0] == want[0], (r, arch)
            assert got[1] == want[1], (r, arch, got[1], want[1])
            if get_arch(arch).family in ("ssm", "hybrid"):
                assert got[1] > 0, (r, arch)
            assert got[4].get("all_gather/logits", (0, 0))[0] > 0, got[4]
            fused = res[arch]["tp_fused"]
            if isinstance(fused, str):
                assert "captured as a CUDA graph" in fused, fused
            else:
                assert fused[0] == res[arch]["plain_fused"][0], (r, arch)
            if r == 0:
                lines.append(
                    f"{arch}: (1, 4) decode tok/s {got[2]:.2f} vs no mesh "
                    f"{want[2]:.2f}, ssd launches {got[1]}; fused 4: "
                    + (fused if isinstance(fused, str) else
                       f"{fused[3]} replays, tok/s {fused[2]:.2f} vs "
                       f"{res[arch]['plain_fused'][2]:.2f}"))
        plain, bwd_plain, _ = res["train_plain"]
        got, bwd, w = res["train_zero1"]
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, plain))
        assert bwd == bwd_plain > 0
        assert w == (4, mcfg.d_model, cols // 4)
        if r == 0:
            lines.append(f"mamba2-780m (1, 4) ZeRO-1 losses {got} vs no "
                         f"mesh {plain}; SSD backward launches {bwd}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().replace("\n", " | ")
    print(f"\nnccl tp families ({smi}): " + "; ".join(lines))


# ---------------------------------------------------------------------------
# The rest of the "model" axis on four cards: batch-1 sequence sharding,
# Megatron-SP, ZeRO-1 of Adafactor and of kimi-k2's 2-D experts
# ---------------------------------------------------------------------------

#: the four-card cells (the worker reads them; ``reduced`` cuts widths for
#: a rehearsal on the host, the card runs them as they are)
SEQ_CELLS = dict(
    reduced=False, dev="cuda",
    long_t=524_288, long_t_f32=131_072, long_steps=4,  # (a) zamba2-1.2b
    dkv_t=32_768, dkv_rank=64, dkv_tail=16, dkv_steps=8,   # (b) llama2-7b
    seq_s=8192, layers=4, train_steps=3,               # (c)
    prefill_s=32_768, prefill_extra=4096,              # (c) zamba2-1.2b
    sp_batch=4, sp_seq=512,                            # (d)
    kimi_layers=2, kimi_steps=2, kimi_batch=2, kimi_seq=256)   # (e)

_NCCL_SEQ_WORKER = '''
import os, pickle, sys, time
import numpy as np
import torch
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from repro_torch import optim
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.launch import mesh as M
from repro_torch.models import api, decomposed_kv as DK, hybrid
from repro_torch.models.api import model_fns
from repro_torch.runtime import steps
from repro_torch.runtime.driver import to_device
from repro_torch.tree import named_leaves
C = CELLS
dev = C["dev"]
M.init_distributed(dev, rank=rank, world_size=world, store_path=store)
m41 = M.make_host_mesh(4, 1, dev)
m14 = M.make_host_mesh(1, 4, dev)
m22 = M.make_host_mesh(2, 2, dev)
res = {}

def arch(name, **over):
    cfg = get_arch(name)
    if C["reduced"]:
        cfg = cfg.reduced()
    return cfg.replace(**over)

def init(cfg, seed=0):
    return model_fns(cfg).init(cfg, torch.Generator(device=dev)
                               .manual_seed(seed), device=dev)

def sync():
    if dev == "cuda":
        torch.cuda.synchronize()

def greedy(step, params, cache, pos0, n, *extra, feed=None):
    """n greedy steps from token 1, or fed ``feed``'s tokens (another
    run's greedy choices: the logits of both then read the same inputs
    at every step, whatever near-tie a bf16 argmax breaks otherwise)."""
    tok = torch.ones(1, dtype=torch.long, device=dev)
    logits, toks, colls, ms = [], [], None, []
    for i in range(n):
        sh.reset_collective_counts()
        pos = torch.full((1,), pos0 + i, dtype=torch.long, device=dev)
        sync()
        t0 = time.perf_counter()
        lg, cache = step(params, tok, cache, pos, *extra)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        colls = sh.collective_counts()
        toks.append(int(lg.argmax(-1).item()))
        tok = torch.tensor([toks[-1] if feed is None else feed[i]],
                           device=dev)
        logits.append(lg.float().cpu().numpy())
    return logits, toks, colls, ms

def roll_rows(kv, n):
    """Roll rows [0, n) of every K/V leaf [A, 1, T, kvh, d] in place, one
    application at a time (a function: no view of a cache outlives it)."""
    for leaf in kv.values():
        for j in range(leaf.shape[0]):
            rows = leaf[j, :, :n]
            rows.copy_(torch.roll(rows, n // 3, dims=1))

# (a) zamba2-1.2b, long_500k decode: (4, 1) against the same decode whole,
# bf16 at long_t rows, then float32 at long_t_f32
res["a"] = {}
for dtype, t in (("bfloat16", C["long_t"]), ("float32", C["long_t_f32"])):
    cfg = arch("zamba2-1.2b", dtype=dtype)
    params = init(cfg)
    cache = hybrid.init_state(cfg, 1, t, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, leaf in named_leaves(cache):
        leaf.normal_(generator=gen)
        if not name.startswith("attn"):
            leaf.mul_(0.1)
    block = api.shard_cache(cfg, cache, m41)
    # the Mamba2 states have no time axis: the block is the leaf itself,
    # which the one-card run updates in place; the mesh run takes a copy
    block = {k: {n: v.clone() if v is cache[k][n] else v
                 for n, v in d.items()} for k, d in block.items()}
    keep = {k: {n: v.clone() for n, v in d.items()}
            for k, d in cache.items() if k != "attn"}
    pos0 = t - C["long_steps"]
    want = greedy(steps.make_decode_step(cfg), params, cache, pos0,
                  C["long_steps"])
    got = greedy(steps.make_decode_step(cfg, m41), params, block, pos0,
                 C["long_steps"], feed=want[1])
    # the one-card run again over the cache's rows [0, pos0) rolled (every
    # one valid at every step: the same softmax in another float32 sum
    # order), fed the same tokens: how far a sum order moves the logits
    kshape = tuple(block["attn"]["k"].shape)
    del block
    for k, d in keep.items():
        for n, v in d.items():
            cache[k][n].copy_(v)
    roll_rows(cache["attn"], pos0)
    plain = greedy(steps.make_decode_step(cfg), params, cache, pos0,
                   C["long_steps"], feed=want[1])
    res["a"][dtype] = (got, want, kshape, hybrid._layout(cfg)[0], t, plain)
    del cache, params, keep

# (b) llama2-7b decomposed KV at B = 1: (4, 1) against one card, bf16
# and float32
res["b"] = {}
for dtype in ("bfloat16", "float32"):
    cfg = arch("llama2-7b", dtype=dtype)
    params = init(cfg)
    r, t = C["dkv_rank"], C["dkv_t"]
    cache = DK.init_cache(cfg, 1, t, r, tail=C["dkv_tail"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for k in ("k_u", "v_u"):
        cache[k].normal_(generator=gen)
    for k in ("k_vt", "v_vt"):
        cache[k].normal_(generator=gen).mul_(r ** -0.5)
    frozen = torch.tensor([t], dtype=torch.int32, device=dev)
    block = api.shard_cache(cfg, cache, m41)
    tail0 = {k: v.clone() for k, v in cache["tail"].items()}
    out_b = {}
    for tag, mesh, c in (("one", None, cache), ("mesh", m41, block)):
        reset_launch_counts()
        g = greedy(steps.make_dkv_decode_step(cfg, mesh), params, c, t,
                   C["dkv_steps"], frozen,
                   feed=out_b["one"][1] if out_b else None)
        out_b[tag] = g + (launch_counts()["dkv_attention_stats"],)
    # the one-card plain route (the reference's joint softmax) on the same
    # cache and tokens: how far another float32 sum order moves the logits
    cache["tail"] = tail0
    plain = lambda p_, t_, c_, ps, fr: DK.decode_step_dkv(  # noqa: E731
        p_, cfg, t_, c_, ps, fr, attention="plain")
    out_b["plain"] = greedy(plain, params, cache, t, C["dkv_steps"], frozen,
                            feed=out_b["one"][1])
    res["b"][dtype] = (out_b, tuple(block["k_u"].shape),
                       tuple(block["tail"]["k"].shape))
    del cache, block, params
    if dev == "cuda":
        torch.cuda.empty_cache()

# (c) batch-1 prefill and three AdamW steps at S = seq_s, float32, on
# (4, 1) against one card
def batches(cfg, shape, n):
    src = SyntheticLM(cfg, shape, DataConfig(seed=0))
    return [to_device(src.batch_at(i), dev) for i in range(n)]

def train(cfg, mesh, bs, zero1=False, tp=False, **kw):
    p = init(cfg)
    opt = optim.make_optimizer(cfg, warmup=1)
    st = opt.init(p)
    if tp or zero1:
        p, st = steps.shard_train_state(cfg, p, st, mesh, zero1=zero1,
                                        optimizer=opt)
    fn = steps.make_train_step(cfg, opt, mesh=mesh, zero1=zero1, **kw)
    losses, ms = [], []
    reset_launch_counts()
    sh.reset_collective_counts()
    for b in bs:
        sync()
        t0 = time.perf_counter()
        p, st, m = fn(p, st, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, {k: v for k, v in launch_counts().items() if v}, \\
        sh.collective_counts()

res["c"] = {}
for name in ("mamba2-780m", "granite-3-2b"):
    cfg = arch(name, num_layers=C["layers"], dtype="float32")
    bs = batches(cfg, ShapeSpec("t", C["seq_s"], 1, "train"),
                 C["train_steps"])
    params = init(cfg)
    pre = {}
    for tag, mesh in (("mesh", m41), ("one", None)):
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        lg, _ = steps.make_prefill_step(cfg, mesh)(params, bs[0]["tokens"])
        sync()
        pre[tag] = (lg.cpu().numpy(), time.perf_counter() - t0,
                    {k: v for k, v in launch_counts().items() if v})
    del params
    res["c"][name] = (pre, train(cfg, m41, bs), train(cfg, None, bs))

# (d) Megatron-SP on (1, 4): granite-3-2b depth cut, float32, with SP
# against the same TP steps without it
cfg = arch("granite-3-2b", num_layers=C["layers"], dtype="float32")
bs = batches(cfg, ShapeSpec("t", C["sp_seq"], C["sp_batch"], "train"),
             C["train_steps"])
res["d"] = (train(cfg.replace(seq_parallel=True), m14, bs, zero1=True),
            train(cfg, m14, bs, zero1=True))

# (e) kimi-k2 at full width, depth kimi_layers, on (2, 2): Adafactor steps
# with ZeRO-1 against the same steps without it, in float32 (the tree is
# drawn whole in bf16 and the rank's blocks cast: the float32 tree does not
# fit a card whole; a bf16 step's last bits reach the routing of the next)
from repro_torch.tree import tree_map
cfg = arch("kimi-k2-1t-a32b", num_layers=C["kimi_layers"])
f32 = cfg.replace(dtype="float32")
bs = batches(f32, ShapeSpec("t", C["kimi_seq"], C["kimi_batch"], "train"),
             C["kimi_steps"])

def kimi(zero1):
    opt = optim.make_optimizer(f32, warmup=1)
    whole = init(cfg)
    p, st = steps.shard_train_state(f32, whole, opt.init(whole), m22,
                                    zero1=zero1, optimizer=opt)
    del whole
    p = tree_map(lambda t: t.float(), p)
    fn = steps.make_train_step(f32, opt, mesh=m22, zero1=zero1)
    losses, ms = [], []
    for b in bs:
        sync()
        t0 = time.perf_counter()
        p, st, m = fn(p, st, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, {k: tuple(v.shape) for k, v in named_leaves(st)}

if dev == "cuda":
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
z = kimi(True)
mem = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else 0
if dev == "cuda":
    torch.cuda.empty_cache()
res["e"] = (z, kimi(False), mem)

# (c), run last (its allocations would leave (e) too little room):
# zamba2-1.2b at full depth, float32, a batch-1 prefill of prefill_s
# tokens on (4, 1) against one card, into a cache of the prompt's length
# (each rank keeps its rows) and of prefill_extra rows more (the rows
# moved to their blocks by one all-to-all a leaf and layer); each run's
# peak device memory above what was allocated before it
if dev == "cuda":
    torch.cuda.empty_cache()
cfg = arch("zamba2-1.2b", dtype="float32")
params = init(cfg)
tok = torch.randint(0, cfg.vocab, (1, C["prefill_s"]),
                    generator=torch.Generator().manual_seed(5)).to(dev)
res["c_prefill"] = {}
for max_len in (None, C["prefill_s"] + C["prefill_extra"]):
    pre = {}
    for tag, mesh in (("mesh", m41), ("one", None)):
        sh.reset_collective_counts()
        sync()
        base = torch.cuda.memory_allocated() if dev == "cuda" else 0
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lg, cache = steps.make_prefill_step(cfg, mesh)(params, tok,
                                                       max_len=max_len)
        sync()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30 \
            if dev == "cuda" else 0.0
        pre[tag] = (lg, cache, time.perf_counter() - t0, peak,
                    sh.collective_counts())
    lg_m, c_m = pre["mesh"][:2]
    lg_o, c_o = pre["one"][:2]
    n = c_m["attn"]["k"].shape[2]
    crel = max(float((c_m["attn"][k] - c_o["attn"][k][:, :, rank * n:
                                                      (rank + 1) * n])
                     .abs().max() / c_o["attn"][k].abs().max())
               for k in ("k", "v"))
    res["c_prefill"][max_len] = (
        float((lg_m - lg_o).abs().max() / lg_o.abs().max()), crel,
        {k: v[2:] for k, v in pre.items()}, tuple(c_m["attn"]["k"].shape))
    del pre, lg_m, c_m, lg_o, c_o, cache, lg
del params
if dev == "cuda":
    torch.cuda.empty_cache()
pickle.dump(res, open(os.path.join(out, f"seq{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


def _seq_worker_results(cells, tmp_path, timeout):
    """Run the four-rank worker of the sequence-sharding cells; every
    rank's results."""
    import os
    import pickle
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    store = str(tmp_path / "store")
    src = f"CELLS = {cells!r}\n" + _NCCL_SEQ_WORKER
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), "4",
                               store, str(tmp_path)], env=env)
             for r in range(4)]
    assert [p.wait(timeout=timeout) for p in procs] == [0] * 4
    out = []
    for r in range(4):
        with open(tmp_path / f"seq{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _logit_rel(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / np.abs(b).max())


def _held_in_bf16(mesh, one, plain, tag):
    """A bf16 decode on the mesh against the same decode on one card,
    both fed the one-card run's tokens: at every step its logits lie
    within 1.5x the largest distance that another float32 sum order on
    one card (``plain``) moved them in the same run, and where its
    greedy token differs, the one-card logits rate the two tokens within
    that bound (a near-tie).  A wrong merge moves the logits by O(1)."""
    import numpy as np
    bound = 1.5 * max(_logit_rel(a, b) for a, b in zip(plain[0], one[0]))
    for i, (a, b) in enumerate(zip(mesh[0], one[0])):
        assert _logit_rel(a, b) <= bound, (tag, i, _logit_rel(a, b), bound)
        tm, to = mesh[1][i], one[1][i]
        gap = float(np.take(b, to, -1).max() - np.take(b, tm, -1).max())
        assert tm == to or gap <= bound * float(np.abs(b).max()), \
            (tag, i, tm, to, gap)


def check_seq_cells(out, cells):
    """The four-card cells' checks on every rank.  Tolerances (logits
    relative to the largest, the mesh run fed the one-card run's greedy
    tokens): decode in float32, tokens equal and logits within 1e-4 at
    every step; in bf16, :func:`_held_in_bf16` (within 1.5x of another
    sum order's distance on one card, a differing token only at a
    near-tie).  Prefill logits and caches, and losses, within 1e-5."""
    for rank, res in enumerate(out):
        for dtype, (got, want, kshape, n_attn, t, plain) in res["a"].items():
            assert kshape[2] == t // 4
            rels = [_logit_rel(a, b) for a, b in zip(got[0], want[0])]
            if dtype == "float32":
                assert got[1] == want[1] and max(rels) <= 1e-4, rels
            else:
                _held_in_bf16(got, want, plain, ("a", rank))
            assert got[2].get("all_gather/attn_stats", (0, 0))[0] == n_attn
            assert got[2].get("all_reduce/attn_out", (0, 0))[0] == n_attn
        for dtype, (runs, ushape, tshape) in res["b"].items():
            assert ushape[2] == cells["dkv_t"] // 4
            assert tshape[2] == cells["dkv_tail"] // 4
            rels = [_logit_rel(a, b) for a, b in zip(runs["mesh"][0],
                                                     runs["one"][0])]
            if dtype == "float32":
                assert runs["mesh"][1] == runs["one"][1], runs
                assert max(rels) <= 1e-4, rels
            else:
                _held_in_bf16(runs["mesh"], runs["one"], runs["plain"],
                              ("b", rank))
            assert runs["mesh"][4] == runs["one"][4]
            assert runs["one"][4] > 0 or cells["dev"] != "cuda"
        for name, (pre, meshed, one) in res["c"].items():
            assert _logit_rel(pre["mesh"][0], pre["one"][0]) <= 1e-5, name
            assert pre["mesh"][2] == pre["one"][2], (name, pre)
            assert all(abs(a - b) <= 1e-5 * abs(b)
                       for a, b in zip(meshed[0], one[0])), (name, meshed,
                                                             one)
            assert meshed[2] == one[2], (name, meshed[2], one[2])
        for max_len, (rel, crel, runs, kshape) in res["c_prefill"].items():
            t = max_len or cells["prefill_s"]
            assert kshape[2] == t // 4 and rel <= 1e-5 and crel <= 1e-5, (
                max_len, rel, crel)
            moved = [k for k in runs["mesh"][2] if k.startswith("all_to_all")]
            assert bool(moved) == (max_len is not None), runs["mesh"][2]
        sp, plain = res["d"]
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(sp[0],
                                                                plain[0]))
        assert "reduce_scatter/sp_tp_out" in sp[3]
        assert not {"all_reduce/tp_out", "all_reduce/tp_in_grad"} & set(
            sp[3])
        z, nz = res["e"][0][0], res["e"][1][0]
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(z, nz))


def seq_summary(out, cells):
    """One line per four-card cell, rank 0's numbers."""
    res, lines = out[0], []
    for dtype, (got, want, _, _, t, plain) in res["a"].items():
        rels = [_logit_rel(a, b) for a, b in zip(got[0], want[0])]
        prel = [_logit_rel(a, b) for a, b in zip(plain[0], want[0])]
        mb = sum(v[1] for k, v in got[2].items()) / 1e6
        lines.append(
            f"(a) zamba2-1.2b {dtype} T {t} B 1 (4, 1): logits rel by "
            f"step {[f'{x:.2e}' for x in rels]} (one card over its rows "
            f"rolled: {[f'{x:.2e}' for x in prel]}), greedy tokens "
            f"{got[1]} vs one card {want[1]}, step ms "
            f"{[round(v, 1) for v in got[3]]} vs "
            f"{[round(v, 1) for v in want[3]]}; one step's collectives "
            f"{got[2]} "
            f"({mb:.3f} MB sent a rank)")
    for dtype, (runs, _, _) in res["b"].items():
        rels = [_logit_rel(a, b) for a, b in zip(runs["mesh"][0],
                                                 runs["one"][0])]
        plain = [_logit_rel(a, b) for a, b in zip(runs["plain"][0],
                                                  runs["one"][0])]
        lines.append(
            f"(b) llama2-7b dkv {dtype} T {cells['dkv_t']} (4, 1): "
            f"logits rel by step {[f'{x:.2e}' for x in rels]} (one card's "
            f"plain route: {[f'{x:.2e}' for x in plain]}), greedy "
            f"tokens {runs['mesh'][1]} vs {runs['one'][1]}, dkv "
            f"launches {runs['mesh'][4]} vs {runs['one'][4]}, step ms "
            f"{[round(v, 1) for v in runs['mesh'][3]]} vs "
            f"{[round(v, 1) for v in runs['one'][3]]}")
    for name, (pre, meshed, one) in res["c"].items():
        lines.append(
            f"(c) {name} S {cells['seq_s']} B 1 (4, 1): prefill s "
            f"{pre['mesh'][1]:.3f} vs {pre['one'][1]:.3f}, launches "
            f"{pre['mesh'][2]}; losses {meshed[0]} vs {one[0]}, step "
            f"ms {[round(v, 1) for v in meshed[1]]} vs "
            f"{[round(v, 1) for v in one[1]]}, launches {meshed[2]}")
    for max_len, (rel, crel, runs, kshape) in res["c_prefill"].items():
        lines.append(
            f"(c) zamba2-1.2b float32 prefill S {cells['prefill_s']} into "
            f"T {max_len or cells['prefill_s']} (4, 1): logits rel "
            f"{rel:.2e}, cache rel {crel:.2e}, K block {kshape}; s "
            f"{runs['mesh'][0]:.3f} vs {runs['one'][0]:.3f}; peak GiB "
            f"above the weights {runs['mesh'][1]:.2f} a rank vs "
            f"{runs['one'][1]:.2f} on one card; mesh collectives "
            f"{runs['mesh'][2]}")
    sp, plain = res["d"]
    lines.append(f"(d) granite-3-2b SP (1, 4): losses {sp[0]} vs no SP "
                 f"{plain[0]}, step ms {[round(v, 1) for v in sp[1]]} "
                 f"vs {[round(v, 1) for v in plain[1]]}")
    (z, zl), nz = res["e"][0][:2], res["e"][1][0]
    lines.append(f"(e) kimi-k2 depth {cells['kimi_layers']} (2, 2) "
                 f"Adafactor: ZeRO-1 losses {z} vs {nz}, step ms "
                 f"{[round(v, 1) for v in zl]}, peak "
                 f"{res['e'][2]:.1f} GiB")
    return lines


def test_nccl_seq_sharding_sp_and_adafactor_zero1(cards, tmp_path):
    """Four ranks, one a card: (a) zamba2-1.2b long_500k decode on (4, 1)
    (each rank a quarter of every K/V time axis), (b) llama2-7b
    decomposed-KV decode at B = 1 (8,192 prefix rows a rank), (c)
    mamba2-780m and granite-3-2b (depth 4, float32) batch-1 prefill and
    three AdamW steps at S = 8192, (d) Megatron-SP on (1, 4), (e)
    kimi-k2-1t-a32b at full width, depth 2, Adafactor with and without
    ZeRO-1 on (2, 2) — each against the same work on one card or without
    the feature (``check_seq_cells``'s tolerances)."""
    if cards < 4:
        pytest.skip("needs four CUDA devices")
    import subprocess
    from repro_torch.kernels import build
    build.build_all()
    out = _seq_worker_results(SEQ_CELLS, tmp_path, timeout=2400)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().replace("\n", " | ")
    print(f"\nnccl seq ({smi}): " + "; ".join(seq_summary(out, SEQ_CELLS)))
    check_seq_cells(out, SEQ_CELLS)


# ---------------------------------------------------------------------------
# MoE over the DP axis and a head split on "model" (four cards)
# ---------------------------------------------------------------------------

MOE_DP_LAYERS = 4            # olmoe-1b-7b's depth for the float32 steps

_NCCL_MOE_DP_WORKER = '''
import os, pickle, sys
import numpy as np
import torch
rank, world, store, out, layers = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4],
                                   int(sys.argv[5]))
from repro_torch import optim
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.engine import DecomposeEngine, EngineConfig
from repro_torch.launch import mesh as M
from repro_torch.models.api import model_fns
from repro_torch.runtime import steps
from repro_torch.runtime.driver import to_device
from repro_torch.serving import Engine, Request
M.init_distributed("cuda", rank=rank, world_size=world, store_path=store)
m41 = M.make_host_mesh(4, 1, "cuda")
m14 = M.make_host_mesh(1, 4, "cuda")
res = {}

def init(cfg):
    return model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda")

# (4, 1): olmoe-1b-7b at full width, depth cut, float32 (bf16 rounds
# each rank's rows apart from the whole batch's), two AdamW steps of
# 8 x 512
tcfg = get_arch("olmoe-1b-7b").replace(num_layers=layers, dtype="float32")
src = SyntheticLM(tcfg, ShapeSpec("t", 512, 8, "train"), DataConfig(seed=0))
batches = [to_device(src.batch_at(i), "cuda") for i in range(2)]
for tag, mesh, shard_map in (("plain", None, False), ("global", m41, False),
                             ("shard_map", m41, True)):
    cfg = tcfg.replace(moe_shard_map=shard_map)
    p = init(cfg)
    opt = optim.make_optimizer(cfg, warmup=1)
    st = opt.init(p)
    fn = steps.make_train_step(cfg, opt, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for b in batches:
        p, st, m = fn(p, st, b)
        losses.append(m["loss"].item())
    res["train_" + tag] = (losses,
                           torch.cuda.max_memory_allocated() / 2 ** 30)
    del p, st, fn
    torch.cuda.empty_cache()

# (4, 1): full olmoe-1b-7b serving in float32 (greedy tokens are exact
# only where no rank's rows round apart), one slot a card
cfg = get_arch("olmoe-1b-7b").replace(dtype="float32")
params = init(cfg)
rng = np.random.RandomState(0)
prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
           for n in (128, 96, 64, 48)]

def serve(c, p, mesh, block=1, slots=4, max_new=16, **kw):
    eng = Engine(c, p, slots=slots, max_len=256, device="cuda",
                 decompose_engine=DecomposeEngine(EngineConfig(mesh=mesh,
                                                               **kw)),
                 decode_block=block)
    done = []
    for step in range(400):
        if step % 3 == 0 and step // 3 < len(prompts):
            i = step // 3
            eng.submit(Request(uid=i, prompt=prompts[i] % c.vocab,
                               max_new_tokens=max_new))
        done.extend(eng.step())
        if len(done) == len(prompts) and not eng._occupied():
            break
    return {r.uid: r.out_tokens for r in done}, eng.shard.n

sh.reset_collective_counts()
res["moe_serve"] = serve(cfg, params, m41)
res["moe_serve_counts"] = sh.collective_counts()
res["moe_serve_fused"] = serve(cfg, params, m41, block=4)
res["moe_serve_plain"] = serve(cfg, params, None)
res["moe_serve_fused_plain"] = serve(cfg, params, None, block=4)
del params
torch.cuda.empty_cache()

# (1, 4): a reduced float32 dense config of 6 query heads (hd 32, one kv
# head): each rank's column block cuts a head
dcfg = get_arch("granite-3-2b").reduced().replace(
    dtype="float32", num_heads=6, num_kv_heads=1, head_dim=32)
dp_ = init(dcfg)
res["split"] = serve(dcfg, dp_, m14)
res["split_dkv"] = serve(dcfg, dp_, m14, kv_rank=8, kv_tail=4)
res["split_plain"] = serve(dcfg, dp_, None)
res["split_dkv_plain"] = serve(dcfg, dp_, None, kv_rank=8, kv_tail=4)
pickle.dump(res, open(os.path.join(out, f"moe{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


def test_nccl_moe_dp_and_head_split(cards, tmp_path):
    """Four ranks, one a card.  (4, 1): olmoe-1b-7b at full width (depth
    cut to MOE_DP_LAYERS, float32) trains two AdamW steps with its batch
    split over DP in the reference's global form: losses within 1e-5
    relative of one card's whole-batch steps, each card's peak beside
    one card's (the per-shard form's too); full float32 olmoe-1b-7b
    serves slot-sharded (one slot a card, single-step and fused blocks
    of 4) with the no-mesh engine's tokens.  (1, 4): a reduced dense config of
    6 query heads, whose column blocks cut heads, serves (dense and
    decomposed KV) with the no-mesh engine's tokens."""
    import os
    import pickle
    import subprocess
    import sys
    import numpy as np
    if cards < 4:
        pytest.skip("needs four CUDA devices: a (4, 1) and a (1, 4) mesh")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_MOE_DP_WORKER,
                               str(r), "4", store, str(tmp_path),
                               str(MOE_DP_LAYERS)], env=env)
             for r in range(4)]
    assert [p.wait(timeout=1500) for p in procs] == [0] * 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().replace("\n", " | ")
    for r in range(4):
        with open(tmp_path / f"moe{r}.pkl", "rb") as f:
            res = pickle.load(f)
        plain, peak_plain = res["train_plain"]
        got, peak = res["train_global"]
        sm, peak_sm = res["train_shard_map"]
        same = {tag: res[tag][0] == res[tag + "_plain"][0]
                for tag in ("moe_serve", "moe_serve_fused", "split",
                            "split_dkv")}
        if r == 0:
            print(f"\nnccl moe_dp ({smi}): olmoe-1b-7b float32 depth "
                  f"{MOE_DP_LAYERS} (4, 1) global-form losses {got} vs "
                  f"one card's whole batch {plain}; peak GiB a card "
                  f"{peak:.2f} (per-shard form {peak_sm:.2f}, losses "
                  f"{sm}) vs one card {peak_plain:.2f}; tokens equal to "
                  f"no mesh: {same}")
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, plain))
        assert all(np.isfinite(sm))
        assert res["moe_serve"][1] == 1 and all(same.values()), (r, same)
        assert res["moe_serve_counts"]["all_gather/moe_counts"][0] > 0


# ---------------------------------------------------------------------------
# A decomposed-KV prefill of a sequence-sharded prompt (four cards)
# ---------------------------------------------------------------------------

SEQ_DKV_CELL = dict(seq=32_768, layers=4, rank=64, tail=16, steps=8)

_NCCL_SEQ_DKV_WORKER = '''
import os, pickle, sys, time
import numpy as np
import torch
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models.api import model_fns
from repro_torch.runtime import steps
M.init_distributed("cuda", rank=rank, world_size=world, store_path=store)
m41 = M.make_host_mesh(4, 1, "cuda")
s, r = CELL["seq"], CELL["rank"]
cfg = get_arch("llama2-7b").replace(num_layers=CELL["layers"])
params = model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
tok = torch.randint(0, cfg.vocab, (1, s),
                    generator=torch.Generator().manual_seed(6)).cuda()
frozen = torch.tensor([s], dtype=torch.int32, device="cuda")
res = {"dp_rank": sh.dp_rank(m41)}
# NCCL sets its communicator up at a group's first collective: outside
# the timed prefills
sh.all_reduce(torch.zeros(1, device="cuda"), sh.dp_group(m41), "warmup")
for tag, mesh in (("one", None), ("mesh", m41)):
    ops.reset_launch_counts()
    sh.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = steps.make_dkv_prefill_step(cfg, r, tail=CELL["tail"],
                                            mesh=mesh)(params, tok)
    torch.cuda.synchronize()
    n = ops.launch_counts()
    got = dict(ms=(time.perf_counter() - t0) * 1e3,
               right=n["reorth_right_batched"], left=n["reorth_left_batched"],
               coll=sh.collective_counts(),
               **{k: cache[k].float().cpu().numpy() for k in ("k_u", "v_u")})
    dec = steps.make_dkv_decode_step(cfg, mesh)
    feed = res["one"]["fed"] if tag == "mesh" else None
    logits, fed, own = [], [], []
    nxt = int(lg.argmax(-1).item()) if feed is None else feed[0]
    for i in range(CELL["steps"]):
        fed.append(nxt)
        o, cache = dec(params, torch.full((1,), nxt, dtype=torch.long,
                                          device="cuda"), cache,
                       torch.full((1,), s + i, dtype=torch.long,
                                  device="cuda"), frozen)
        logits.append(o.float().cpu().numpy())
        own.append(int(o.argmax(-1).item()))
        nxt = feed[i + 1] if feed is not None and i + 1 < CELL["steps"] \\
            else own[-1]
    got.update(dec=logits, fed=fed, own=own)
    res[tag] = got
    del cache, lg
    torch.cuda.empty_cache()
pickle.dump(res, open(os.path.join(out, f"dkv{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


def test_nccl_seq_dkv_prefill(cards, tmp_path):
    """Four ranks, one a card, on (4, 1): full-width llama2-7b (depth 4,
    bf16) prefills one 32,768-token prompt, 8,192 tokens a rank, into a
    decomposed KV cache (rank 64, tail 16): the time blocks become layer
    blocks by an all-to-all, each rank decomposes its one layer's whole
    K and V through the batched re-orth kernels, U·Σ returns to the
    rank's time block.  Against the same prefill with no mesh on each
    card, whose one batched decomposition holds all 4 layers: as many
    re-orth launches; the singular values (U·Σ's column norms over the
    whole prompt, reassembled from the ranks' blocks) within 1e-4
    relative, and the rank's U·Σ block the rows of the one-card U·Σ
    within 1e-2 of its largest entry (a batch of 1 against one of 4:
    the library reductions around the re-orth kernels, norms, products
    and the small SVD, sum in another order, Lanczos's trailing
    directions carry it, and the factors are bf16: 1.59e-5 measured on
    the singular values on four H100s); eight decode steps (the mesh run fed the
    one-card run's tokens) with logits within 2e-2 relative (the K/V
    rows themselves come from products of 8,192 rows against 32,768
    and from the other factors, in bf16: 1.21e-2 measured on four
    H100s), a differing
    greedy token only where the one-card logits rate the two within
    that bar (a near-tie).  Every number is printed before the
    checks."""
    if cards < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import pickle
    import subprocess
    import sys
    import numpy as np
    from repro_torch.kernels import build
    build.build_all()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    src = f"CELL = {SEQ_DKV_CELL!r}\n" + _NCCL_SEQ_DKV_WORKER
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), "4",
                               str(tmp_path / "store"), str(tmp_path)],
                              env=env) for r in range(4)]
    assert [p.wait(timeout=1200) for p in procs] == [0] * 4
    out = []
    for r in range(4):
        with open(tmp_path / f"dkv{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    s, n = SEQ_DKV_CELL["seq"], SEQ_DKV_CELL["seq"] // 4
    one = out[0]["one"]
    sv_rel, rows = {}, {}
    for key in ("k_u", "v_u"):
        blocks = {res["dp_rank"]: res["mesh"][key] for res in out}
        whole = np.concatenate([blocks[i] for i in range(4)], axis=2)
        assert whole.shape[2] == s
        want = np.linalg.norm(one[key], axis=2)
        sv_rel[key] = float(np.abs(np.linalg.norm(whole, axis=2) - want)
                            .max() / np.abs(want).max())
        rows[key] = max(_logit_rel(blocks[i],
                                   one[key][:, :, i * n:(i + 1) * n])
                        for i in range(4))
    dec = [max(_logit_rel(a, b) for a, b in zip(res["mesh"]["dec"],
                                                res["one"]["dec"]))
           for res in out]
    # where the mesh run's greedy token differs, the one-card logits'
    # gap between the two tokens, relative to their largest
    gaps = [float((np.take(b, to, -1).max() - np.take(b, tm, -1).max())
                  / np.abs(b).max())
            for tm, to, b in zip(out[0]["mesh"]["own"], out[0]["one"]["own"],
                                 out[0]["one"]["dec"]) if tm != to]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().replace("\n", " | ")
    m, o = out[0]["mesh"], out[0]["one"]
    print(f"\nnccl seq dkv ({smi}): llama2-7b depth "
          f"{SEQ_DKV_CELL['layers']} bf16, {s} tokens on (4, 1): singular "
          f"values rel {sv_rel}, rank rows rel {rows}; re-orth launches "
          f"right/left {[(r['mesh']['right'], r['mesh']['left']) for r in out]}"
          f" a rank vs {o['right']}/{o['left']} on one card; prefill ms "
          f"{[round(r['mesh']['ms'], 1) for r in out]} vs {o['ms']:.1f}; "
          f"decode logits rel by rank {dec}, greedy tokens {m['own']} vs "
          f"{o['own']} (one-card gaps where they differ {gaps}); "
          f"collectives {m['coll']}")
    for key in ("k_u", "v_u"):
        assert sv_rel[key] <= 1e-4 and rows[key] <= 1e-2, (key, sv_rel,
                                                           rows)
    for res, d in zip(out, dec):
        mr, orr = res["mesh"], res["one"]
        got = (mr["right"], mr["left"], orr["right"], orr["left"])
        assert got[:2] == got[2:] and min(got) > 0, got
        assert "all_to_all/dkv_k_rows" in mr["coll"], mr["coll"]
        assert d <= 2e-2, dec
    assert all(g <= 2e-2 for g in gaps), gaps


# ---------------------------------------------------------------------------
# The last refusals of the distribution: the activation forward on
# "model" with SP, Mamba2 where M does not divide d_inner (four cards)
# ---------------------------------------------------------------------------

DIST_REST_ACT_SEQ = 4096
DIST_REST_ZAMBA = dict(batch=2, prompt=512, steps=8)

_NCCL_DIST_REST_WORKER = '''
import os, pickle, sys, time
import numpy as np
import torch
rank, world, store, out, part = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch.configs import get_arch
from repro_torch.core.outlier import ThresholdTable
from repro_torch.core.policy import (PAPER_BEST_CONFIG, PAPER_LAYER_CONFIGS,
                                     DecompositionPolicy)
from repro_torch.distributed import sharding as sh
from repro_torch.engine import DecomposeEngine, EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models.api import model_fns
from repro_torch.runtime import steps
from repro_torch.tree import tree_map
M.init_distributed("cuda", rank=rank, world_size=world, store_path=store)
res = {}


def run(tag, fn):
    """fn's result, its launches and collectives, and the ms of a second
    call (the first one sets up cuBLAS, NCCL and the kernels' loads)."""
    ops.reset_launch_counts()
    sh.reset_collective_counts()
    got = fn()
    torch.cuda.synchronize()
    res[tag] = dict(launches=ops.launch_counts(),
                    coll={k: v[0] for k, v in sh.collective_counts().items()})
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    res[tag]["ms"] = (time.perf_counter() - t0) * 1e3
    return got


if part == "act":
    # phase 6's decomposed forward on (1, 4) with SP against one card
    mesh = M.make_host_mesh(1, world, "cuda")
    cfg = get_arch("llama2-7b")
    params = model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0), device="cuda")
    name, rk = PAPER_BEST_CONFIG
    policy = DecompositionPolicy.from_layer_list(
        cfg.num_layers, PAPER_LAYER_CONFIGS[name], rank=rk,
        outlier_frac=0.03)
    policy.thresholds = ThresholdTable(default=3.0)
    eng = DecomposeEngine(EngineConfig(policy=policy))
    log = []
    orig = eng.decompose_activation

    def rec(*a, **k):
        lr = orig(*a, **k)
        log.append(lr.o_idx.cpu().numpy())
        return lr
    eng.decompose_activation = rec
    tok = torch.randint(0, cfg.vocab, (1, SEQ),
                        generator=torch.Generator().manual_seed(0)).cuda()
    sh.all_reduce(torch.zeros(1, device="cuda"), sh.model_group(mesh),
                  "warmup")
    # bf16 (the main path), then float32 weights and forward (phase 6
    # (e)'s route check: rounding keeps the inputs together)
    for dt in ("bf16", "f32"):
        if dt == "f32":
            params = tree_map(lambda t: t.float(), params)
            cfg = cfg.replace(dtype="float32")
        log.clear()
        one = run(dt + "_one", lambda: steps.make_decomposed_forward_step(
            cfg, eng)(params, tok).float())
        res[dt + "_one"]["idx"] = log[:20]
        log.clear()
        sp = cfg.replace(seq_parallel=True)
        blocks = sh.shard_params(params, mesh, sp)
        got = run(dt + "_mesh", lambda: steps.make_decomposed_forward_step(
            sp, eng, mesh)(blocks, tok).float())
        res[dt + "_mesh"]["idx"] = log[:20]
        res[dt + "_rel"] = float((got - one).norm() / one.norm())
        res[dt + "_argmax"] = float((got.argmax(-1) == one.argmax(-1))
                                    .float().mean())
        del blocks, one, got
        torch.cuda.empty_cache()
else:
    # zamba2-1.2b at full width on (1, 3): 3 does not divide d_inner 4096
    mesh = M.make_host_mesh(1, world, "cuda")
    cfg = get_arch("zamba2-1.2b")
    params = model_fns(cfg).init(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0), device="cuda")
    b, s, n = Z["batch"], Z["prompt"], Z["steps"]
    tok = torch.randint(0, cfg.vocab, (b, s),
                        generator=torch.Generator().manual_seed(1)).cuda()
    sh.all_reduce(torch.zeros(1, device="cuda"), sh.model_group(mesh),
                  "warmup")
    for tag, m in (("one", None), ("mesh", mesh)):
        p = params if m is None else sh.shard_params(params, m, cfg)

        def serve():
            lg, cache = steps.make_prefill_step(cfg, m)(p, tok,
                                                        max_len=s + n)
            dec = steps.make_decode_step(cfg, m)
            toks = [lg.argmax(-1)]
            for i in range(n):
                pos = torch.full((b,), s + i, dtype=torch.long,
                                 device="cuda")
                lg, cache = dec(p, toks[-1], cache, pos)
                toks.append(lg.argmax(-1))
            return torch.stack(toks, 1).cpu().numpy()
        res[tag + "_tokens"] = run(tag, serve)
pickle.dump(res, open(os.path.join(out, f"{part}{rank}.pkl"), "wb"))
M.shutdown_distributed()
'''


def _dist_rest_world(part, n, tmp_path):
    import os
    import pickle
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    src = (f"SEQ = {DIST_REST_ACT_SEQ}\nZ = {DIST_REST_ZAMBA!r}\n"
           + _NCCL_DIST_REST_WORKER)
    d = tmp_path / part
    d.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), str(n),
                               str(d / "store"), str(d), part], env=env)
             for r in range(n)]
    assert [p.wait(timeout=1500) for p in procs] == [0] * n
    out = []
    for r in range(n):
        with open(d / f"{part}{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_nccl_dist_rest(cards, tmp_path):
    """Four cards, one rank a card.  (a) Phase 6's decomposed forward
    (full llama2-7b, [1, 4096], the paper's 10 layers at rank 20, 3 %
    outliers) through ``make_decomposed_forward_step(mesh=)`` on (1, 4)
    with ``seq_parallel``, against the same forward on one card: every
    model rank picks the same outlier channels at all 20 decompositions
    (each decomposes the same residual), the kernels launch as often as
    on one card (each rank projects onto its column blocks: 50
    ``lowrank_matmul``, 20 ``outlier_stats``, 380 / 400 re-orth).  In
    float32 (phase 6 (e)'s check: rounding keeps the two runs' inputs
    together) the 20 outlier sets equal one card's and the logits are
    within 1e-3 relative L2.  In bf16 the TP partial sums round in
    another order and the decomposed layers carry it: the logits read
    2.10e-2 from one card's on four H100s, over phase 6's 2e-2 route bar
    (kernel against plain on one card), so bf16 is held to 5e-2 and to
    equal launches and outlier sets across the model ranks.
    (b) zamba2-1.2b at full width on (1, 3) (3 divides neither d_inner
    4096 nor the attention's dims: every rank runs every head) prefills
    two 512-token prompts and decodes 8 greedy tokens: the tokens of one
    card, as many SSD launches, no all-reduce of ``out_proj`` or of the
    gated norm.  Every number is printed before the checks."""
    import subprocess
    if cards < 4:
        pytest.skip("needs four CUDA devices: a (1, 4) and a (1, 3) mesh")
    from repro_torch.kernels import build
    build.build_all()
    act = _dist_rest_world("act", 4, tmp_path)
    zam = _dist_rest_world("zamba", 3, tmp_path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().replace("\n", " | ")
    a0, z0 = act[0], zam[0]
    keep = ("lowrank_matmul", "outlier_stats", "reorth_right_batched",
            "reorth_left_batched", "ssd_chunk_intra")
    same = [sum((a == b).all() for a, b in zip(a0["f32_mesh"]["idx"],
                                               a0["f32_one"]["idx"]))]
    print(f"\nnccl dist_rest ({smi}): (a) llama2-7b activation forward "
          f"(1, 4) SP vs one card: bf16 logits rel L2 "
          f"{[r['bf16_rel'] for r in act]}, argmax agreement "
          f"{[r['bf16_argmax'] for r in act]}, ms "
          f"{a0['bf16_mesh']['ms']:.1f} vs {a0['bf16_one']['ms']:.1f}; "
          f"float32 rel L2 {[r['f32_rel'] for r in act]}, argmax "
          f"{[r['f32_argmax'] for r in act]}, outlier sets equal to one "
          f"card's {same}/20, ms {a0['f32_mesh']['ms']:.1f} vs "
          f"{a0['f32_one']['ms']:.1f}; launches "
          f"{ {k: a0['bf16_mesh']['launches'][k] for k in keep} } vs "
          f"{ {k: a0['bf16_one']['launches'][k] for k in keep} }, "
          f"collectives {a0['bf16_mesh']['coll']}; (b) zamba2-1.2b (1, 3): "
          f"tokens equal "
          f"{[bool((r['mesh_tokens'] == r['one_tokens']).all()) for r in zam]}"
          f", ms {z0['mesh']['ms']:.1f} vs {z0['one']['ms']:.1f}, SSD "
          f"launches {z0['mesh']['launches']['ssd_chunk_intra']} vs "
          f"{z0['one']['launches']['ssd_chunk_intra']}, collectives "
          f"{z0['mesh']['coll']}")
    for r in act:
        for dt in ("bf16", "f32"):
            assert r[dt + "_mesh"]["launches"] == r[dt + "_one"]["launches"]
            assert len(r[dt + "_mesh"]["idx"]) == 20
            for a, b in zip(r[dt + "_mesh"]["idx"], a0[dt + "_mesh"]["idx"]):
                assert (a == b).all()
            assert r[dt + "_mesh"]["coll"]["all_gather/sp_whole"] == 10
        assert r["bf16_rel"] <= 5e-2, r["bf16_rel"]
        assert r["f32_rel"] <= 1e-3, r["f32_rel"]
        for a, b in zip(r["f32_mesh"]["idx"], r["f32_one"]["idx"]):
            assert (a == b).all()
    for r in zam:
        assert (r["mesh_tokens"] == r["one_tokens"]).all()
        assert r["mesh"]["launches"] == r["one"]["launches"]
        assert not {"all_reduce/tp_out", "all_reduce/gated_norm"} & set(
            r["mesh"]["coll"]), r["mesh"]["coll"]
