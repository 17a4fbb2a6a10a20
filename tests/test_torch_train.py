"""The training path of the port against the JAX package, on the CPU.

Reduced configs in float32, weights from the JAX init bridged through
numpy (biases, norm biases and the VLM's cross gates redrawn non-zero in
both trees, so every parameter carries a gradient); batches from the
reference's ``SyntheticLM``:

* each family's ``loss_fn`` value and per-leaf gradients against
  ``jax.value_and_grad`` (``llama2-7b``, ``mamba2-780m``, ``olmoe-1b-7b``
  with a binding capacity, ``zamba2-1.2b``, ``llama-3.2-vision-11b``,
  ``seamless-m4t-medium``), with remat off, "full" and "dots" (the
  port's checkpointing must not change a value: the reference's
  ``jax.checkpoint`` does not);
* the cosine schedule, the global clip, and the AdamW and Adafactor
  updates Δp on the same gradients (at ``base_lr`` 1e-2 and warmup 1,
  three steps: at the default warmup a step moves p by ~3e-6 and any
  update would pass);
* ``make_train_step`` at microbatches 1 and 2 for three steps;
* PowerSGD given the reference's initial Q;
* the SSD backward's four formulas against ``jax.vjp`` of the
  reference's intra-chunk term, and the differentiable kernel-set entry
  on the host.

Tolerances (float32, the same arithmetic in another framework's
reduction order): losses 1e-5 relative; a gradient leaf within 1e-4 of
its largest entry, with a floor of 1e-7 of the largest gradient of the
model (a leaf whose exact gradient is 0, as a cross-attention K bias,
holds rounding noise only); Δp 1e-4 of its largest entry on the same
gradients; after three train steps on gradients each package computes,
Δp 1e-3 in relative L2 norm per leaf (Adam divides m by √v: where two
steps' gradients of an element nearly cancel in m, that element's move
follows the rounding, up to 0.8 % of the largest move at these shapes,
while a leaf's L2 distance stays ≤ 6e-5); PowerSGD 1e-4
of the largest entry (a QR in both); the SSD backward 1e-4 relative
(``tests/test_kernels.py``'s bound for the forward term).
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

from repro import optim as joptim  # noqa: E402
from repro.configs import all_archs  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.kernels import ops, ssd_chunk as ssd  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.driver import to_device  # noqa: E402
from repro_torch.tree import named_leaves, tree_map  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-7
DP_REL = 1e-4
STEP_DP_L2 = 1e-3

# arch -> (sequence length, extra config fields of both packages)
ARCHS = {"llama2-7b": (32, {}),
         "mamba2-780m": (128, {}),          # two chunks of 64
         "olmoe-1b-7b": (32, {"capacity_factor": 1.0}),
         "zamba2-1.2b": (128, {}),
         "llama-3.2-vision-11b": (32, {}),
         "seamless-m4t-medium": (32, {})}
BIAS_KEYS = ("b", "bias", "gate_attn", "gate_mlp")

_CACHE = {}


def _redraw(tree, rng):
    """Biases, norm biases and cross gates of a numpy tree redrawn
    N(0, 0.1²) (they init to 0: a zero gate closes the cross path)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
        elif k in BIAS_KEYS:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def _own(np_tree):
    """A torch copy of a numpy tree that shares no memory with it (the
    bridge's tensors alias their arrays, a JAX array's among them, and
    the port's optimizer updates in place)."""
    return tree_map(lambda t: t.clone(), bridge.to_torch(np_tree, "cpu"))


def _np_copy(t_tree):
    return tree_map(lambda a: np.array(a, copy=True), bridge.to_numpy(t_tree))


def _batch(jcfg, s, b=2, step=0):
    return JSynth(jcfg, JShape("t", s, b, "train"), JData(seed=0)).batch_at(
        step)


def _reference(arch):
    """(JAX cfg, numpy params, batch, JAX loss, numpy grads), cached."""
    if arch not in _CACHE:
        s, extra = ARCHS[arch]
        jcfg = all_archs()[arch].reduced().replace(dtype="float32", **extra)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        npp = _redraw(jax.tree_util.tree_map(np.asarray, jp),
                      np.random.RandomState(1))
        batch = _batch(jcfg, s)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel_fns(jcfg).loss_fn(p, jcfg, jb)))(
                jax.tree_util.tree_map(jnp.asarray, npp))
        _CACHE[arch] = (jcfg, npp, batch, float(loss),
                        jax.tree_util.tree_map(np.asarray, grads))
    return _CACHE[arch]


def _assert_grads_close(got, want):
    """Per leaf: |Δ| ≤ 1e-4 · max|g_leaf| + 1e-7 · max|g| (the model's)."""
    want = dict(named_leaves(want))
    got = dict(named_leaves(got))
    assert sorted(got) == sorted(want)
    top = max(np.abs(v).max() for v in want.values())
    for name, w in want.items():
        g = bridge.to_numpy(got[name])
        tol = GRAD_REL * np.abs(w).max() + GRAD_FLOOR * top
        err = np.abs(g - w).max()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_jax(arch, remat, monkeypatch):
    """loss_fn and every gradient leaf equal JAX's, with remat off, full
    and dots (olmoe's capacity binds: some (token, expert) pairs drop)."""
    jcfg, npp, batch, jloss, jgrads = _reference(arch)
    s, extra = ARCHS[arch]
    tcfg = get_arch(arch).reduced().replace(
        dtype="float32", remat=remat != "off",
        remat_policy="full" if remat == "off" else remat, **extra)
    dropped = []
    route = tmoe.route

    def counting_route(p, xf, cfg):
        out = route(p, xf, cfg)
        dropped.append(int((out[2] >= tmoe.capacity(cfg, xf.shape[0]))
                           .sum()))
        return out
    monkeypatch.setattr(tmoe, "route", counting_route)
    fns = model_fns(tcfg)
    loss, grads = steps.value_and_grad(
        lambda p, b: fns.loss_fn(p, tcfg, b), bridge.to_torch(npp, "cpu"),
        to_device(batch, "cpu"))
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
    _assert_grads_close(grads, jgrads)
    if arch == "olmoe-1b-7b":
        assert sum(dropped) > 0


def test_ckpt_dots_saves_only_products():
    """The "dots" policy keeps the outputs of mm / bmm / addmm and
    recomputes the rest; "full" keeps none; remat off is the function
    itself."""
    from repro_torch.models import layers as L
    cfg = get_arch("llama2-7b").reduced()
    fn = lambda a, b: torch.relu(a @ b) * 2  # noqa: E731
    assert L.ckpt(fn, cfg) is fn
    a = torch.randn(4, 8, requires_grad=True)
    b = torch.randn(8, 3, requires_grad=True)
    for pol in ("full", "dots"):
        out = L.ckpt(fn, cfg.replace(remat=True, remat_policy=pol))(a, b)
        ga = torch.autograd.grad(out.sum(), a)[0]
        want = torch.autograd.grad(fn(a, b).sum(), a)[0]
        assert torch.equal(ga, want)
    with pytest.raises(ValueError, match="remat_policy"):
        L.ckpt(fn, cfg.replace(remat=True, remat_policy="every"))
    policy = L._dots_policy
    from torch.utils.checkpoint import CheckpointPolicy
    assert policy(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.relu.default) == \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_cross_entropy_matches_jax():
    """float32 logsumexp, the label logit by a masked sum, -1 ignored."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 7, 50).astype(np.float32) * 3
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = L.cross_entropy(torch.from_numpy(logits),
                          torch.from_numpy(labels).long()).item()
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    all_masked = np.full((3, 7), -1, np.int32)
    assert L.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(all_masked)).item() == 0.0


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def test_cosine_schedule_and_clip_match_jax():
    jl = joptim.cosine_schedule(1e-2, 10, 100)
    tl = optim.cosine_schedule(1e-2, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jl(jnp.asarray(step, jnp.int32)))
        got = tl(torch.tensor(step, dtype=torch.int32)).item()
        assert abs(got - want) <= 1e-7 * max(abs(want), 1e-3), step
    rng = np.random.RandomState(2)
    g = {"a": rng.randn(5, 4).astype(np.float32),
         "b": {"c": rng.randn(7).astype(np.float32) * 3}}
    for max_norm in (0.5, 100.0):
        jg, jn = joptim.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tg, tn = optim.clip_by_global_norm(bridge.to_torch(g, "cpu"),
                                           max_norm)
        assert abs(tn.item() - float(jn)) <= 1e-6 * float(jn)
        for (_, a), (_, b) in zip(named_leaves(tg), named_leaves(
                jax.tree_util.tree_map(np.asarray, jg))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    bf = {"w": torch.randn(3, 3).bfloat16()}
    assert optim.clip_by_global_norm(bf, 0.1)[0]["w"].dtype == torch.bfloat16


def _updates(arch, which, n_steps=3):
    """(JAX Δp trees, port Δp trees, JAX states, port states) of n_steps
    updates on the same random gradients, base_lr 1e-2, warmup 1."""
    jcfg = all_archs()[arch].reduced().replace(dtype="float32")
    jp = jax.tree_util.tree_map(
        np.asarray, jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg))
    jopt = joptim.make_optimizer(jcfg, base_lr=1e-2, warmup=1)
    tcfg = get_arch(arch).reduced().replace(dtype="float32")
    topt = optim.make_optimizer(tcfg, base_lr=1e-2, warmup=1)
    assert type(topt).__name__ == which == type(jopt).__name__
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    tparams = _own(jp)
    tstate = topt.init(tparams)
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n_steps):
        g = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * 0.01).astype(np.float32), jp)
        before = jax.tree_util.tree_map(np.asarray, jparams)
        jparams, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        tbefore = _np_copy(tparams)
        tparams, tstate = topt.update(bridge.to_torch(g, "cpu"), tstate,
                                      tparams)
        jd = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                    jparams, before)
        td = jax.tree_util.tree_map(lambda a, b: a - b,
                                    bridge.to_numpy(tparams), tbefore)
        out.append((jd, td))
    return out, jstate, tstate


def _assert_dp_close(jd, td, l2=None):
    """Per leaf: max |Δp − Δp_jax| ≤ 1e-4 · max |Δp_jax|, or with ``l2``
    the relative L2 distance of the two Δp within ``l2``."""
    for (name, a), (_, b) in zip(named_leaves(jd), named_leaves(td)):
        assert np.abs(a).max() > 1e-5, name          # the step moved p
        if l2 is None:
            assert np.abs(a - b).max() <= DP_REL * np.abs(a).max(), name
        else:
            assert np.linalg.norm(a - b) <= l2 * np.linalg.norm(a), name


def test_adamw_update_matches_jax():
    """Three AdamW steps on llama2-7b reduced: each Δp equals JAX's; m, v
    and the step equal too (the port updates them in place)."""
    deltas, jstate, tstate = _updates("llama2-7b", "AdamW")
    for jd, td in deltas:
        _assert_dp_close(jd, td)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for key in ("m", "v"):
        for (n, a), (_, b) in zip(named_leaves(jax.tree_util.tree_map(
                np.asarray, jstate[key])), named_leaves(tstate[key])):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                       atol=1e-6 * np.abs(a).max() + 1e-30)


def test_adamw_in_place_slices_equal_whole(monkeypatch):
    """The in-place update in slices of CHUNK elements gives the values of
    one whole-leaf pass."""
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    p0 = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    g = tree_map(lambda t: torch.randn(t.shape, generator=gen), p0)
    outs = []
    for chunk in (1 << 24, 1000):
        monkeypatch.setattr(optim, "CHUNK", chunk)
        p = tree_map(lambda t: t.clone(), p0)
        opt = optim.make_optimizer(cfg, base_lr=1e-2, warmup=1)
        st = opt.init(p)
        for _ in range(2):
            p, st = opt.update(g, st, p)
        outs.append(p)
    for (_, a), (_, b) in zip(named_leaves(outs[0]), named_leaves(outs[1])):
        assert torch.equal(a, b)


def test_adafactor_update_matches_jax():
    """Three Adafactor steps on kimi-k2-1t-a32b reduced (its optimizer):
    each Δp equals JAX's; the factored state keeps the reference's
    names (fac/<path>/vr|vc, or /v for a vector)."""
    deltas, jstate, tstate = _updates("kimi-k2-1t-a32b", "Adafactor")
    for jd, td in deltas:
        _assert_dp_close(jd, td)
    jnames = [n for n, _ in named_leaves(jax.tree_util.tree_map(
        np.asarray, jstate))]
    tnames = [n for n, _ in named_leaves(tstate)]
    assert jnames == tnames
    assert any(n.endswith("/vr") for n in tnames)
    assert any(n.endswith("/v") for n in tnames)
    for (n, a), (_, b) in zip(named_leaves(jax.tree_util.tree_map(
            np.asarray, jstate)), named_leaves(tstate)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-6 * np.abs(a).max() + 1e-30)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """Three steps of make_train_step on llama2-7b reduced (batch 4 × 16,
    AdamW at base_lr 1e-2, warmup 1): every step's loss and gradient norm
    equal JAX's, and so do the parameters' total moves (Δp)."""
    jcfg = all_archs()["llama2-7b"].reduced().replace(dtype="float32")
    tcfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, jp)
    jopt = joptim.make_optimizer(jcfg, base_lr=1e-2, warmup=1)
    topt = optim.make_optimizer(tcfg, base_lr=1e-2, warmup=1)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt,
                                           microbatches=microbatches))
    tstep = steps.make_train_step(tcfg, topt, microbatches=microbatches,
                                  backend="cuda")
    jstate = jopt.init(jp)
    tp = _own(p0)
    tstate = topt.init(tp)
    for step in range(3):
        batch = _batch(jcfg, 16, b=4, step=step)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        tp, tstate, tm = tstep(tp, tstate, to_device(batch, "cpu"))
        assert abs(tm["loss"].item() - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"])
    jd = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, jp, p0)
    td = jax.tree_util.tree_map(lambda a, b: a - b, bridge.to_numpy(tp), p0)
    _assert_dp_close(jd, td, l2=STEP_DP_L2)


def test_eval_step_and_abstract_state():
    """eval_step's loss is loss_fn's, with no graph; the abstract state
    is on the meta device with the real state's shapes and dtypes."""
    cfg = get_arch("mamba2-780m").reduced()
    params, opt_state = steps.init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    jcfg = all_archs()["mamba2-780m"].reduced()
    batch = to_device(_batch(jcfg, 64), "cpu")
    out = steps.make_eval_step(cfg)(params, batch)["loss"]
    assert not out.requires_grad
    assert out.item() == model_fns(cfg).loss_fn(params, cfg, batch).item()
    ap, ao = steps.abstract_train_state(cfg)
    real = dict(named_leaves({"p": params, "o": opt_state}))
    abstract = dict(named_leaves({"p": ap, "o": ao}))
    assert sorted(real) == sorted(abstract)
    for name, t in abstract.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (real[name].shape, real[name].dtype)


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------

def test_powersgd_matches_jax_given_its_q():
    """Two compress/decompress rounds on llama2-7b reduced's shapes, the
    port given the reference's initial Q: the round trips, the error
    memories and the new Q equal JAX's; the ratio too; without explicit
    Q the port draws a process-invariant one."""
    cfg = jcomp.PowerSGDConfig(rank=4, min_elems=4096, seed=17)
    tcfg = comp.PowerSGDConfig(rank=4, min_elems=4096, seed=17)
    jcfg = all_archs()["llama2-7b"].reduced().replace(dtype="float32")
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jst = jcomp.init_state(jp, cfg)
    qs = jax.tree_util.tree_map(
        lambda s: None if s["q"] is None else np.asarray(s["q"]), jst,
        is_leaf=lambda x: isinstance(x, dict) and "q" in x)
    tp = _own(jax.tree_util.tree_map(np.asarray, jp))
    tst = comp.init_state(tp, tcfg, q=qs)
    rng = np.random.RandomState(4)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32), jp)
        jout, jst = jcomp.compress_decompress(
            jax.tree_util.tree_map(jnp.asarray, g), jst, cfg)
        tout, tst = comp.compress_decompress(bridge.to_torch(g, "cpu"), tst,
                                             tcfg)
        for want, got in ((jout, tout), (jst, tst)):
            want = dict(named_leaves(jax.tree_util.tree_map(np.asarray,
                                                            want)))
            got = dict(named_leaves(got))
            assert sorted(want) == sorted(got)
            for name, w in want.items():
                err = np.abs(got[name].numpy() - w).max()
                assert err <= 1e-4 * np.abs(w).max(), name
    assert comp.compression_ratio(tp, tcfg) == pytest.approx(
        jcomp.compression_ratio(jp, cfg), rel=1e-12)
    a, b = comp.init_state(tp, tcfg), comp.init_state(tp, tcfg)
    assert torch.equal(a["layers"]["mlp"]["up"]["w"]["q"],
                       b["layers"]["mlp"]["up"]["w"]["q"])
    assert a["final_norm"]["scale"]["q"] is None          # 1-D: dense
    assert comp._path_seed("layers/mlp/up/w") == 822392563


def test_powersgd_as_grad_transform():
    """PowerSGD wired in as the train step's grad_transform: the step
    runs on compressed gradients (and is not the plain step)."""
    cfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    jcfg = all_archs()["llama2-7b"].reduced()
    p0 = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    pc = comp.PowerSGDConfig(rank=1, min_elems=4096)
    state = {"st": comp.init_state(p0, pc)}

    def transform(grads):
        out, state["st"] = comp.compress_decompress(grads, state["st"], pc)
        return out
    batch = to_device(_batch(jcfg, 16, b=2), "cpu")
    norms = []
    for gt in (None, transform):
        p = tree_map(lambda t: t.clone(), p0)
        opt = optim.make_optimizer(cfg, base_lr=1e-2, warmup=1)
        step = steps.make_train_step(cfg, opt, grad_transform=gt)
        _, _, m = step(p, opt.init(p), batch)
        norms.append(m["grad_norm"].item())
    assert np.isfinite(norms).all() and norms[1] < norms[0]


# ---------------------------------------------------------------------------
# The SSD backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,q,nh,hd", [(2, 16, 3, 8), (1, 70, 2, 4),
                                       (2, 64, 4, 32)])
def test_ssd_backward_matches_jax_vjp(g, q, nh, hd):
    """ssd_chunk_intra_bwd_plain's (dcb, dl, ddt, dx) equal jax.vjp of the
    reference's intra-chunk term; the "cuda" set's differentiable entry
    gives the same on the host (its backward dispatches to the plain
    formulas there, and launches nothing)."""
    rng = np.random.RandomState(q)
    cb = (rng.randn(g, q, q) * 0.3).astype(np.float32)
    l = np.cumsum(-np.abs(rng.randn(g, q, nh)) * 0.05, axis=1).astype(
        np.float32)
    dt = np.abs(rng.randn(g, q, nh)).astype(np.float32)
    x = rng.randn(g, q, nh, hd).astype(np.float32)
    dy = rng.randn(g, q, nh, hd).astype(np.float32)
    _, vjp = jax.vjp(jref.ssd_chunk_intra, *map(jnp.asarray, (cb, l, dt, x)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(a) for a in (cb, l, dt, x)]
    got = ssd.ssd_chunk_intra_bwd_plain(*t, torch.from_numpy(dy))
    for name, a, b in zip(("dcb", "dl", "ddt", "dx"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)
    ins = [a.clone().requires_grad_() for a in t]
    before = ops.launch_counts()
    y = ops.make_kernels("cuda").ssd_chunk_intra(*ins)
    fn_grads = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    assert ops.launch_counts() == before
    for a, b in zip(fn_grads, got):
        assert torch.equal(a, b)


def _weak_train(cfg, powersgd: bool):
    """Two train steps (and a PowerSGD round trip) in a frame that ends:
    weak references to a parameter, a moment and a gradient."""
    import weakref
    params = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    opt = optim.make_optimizer(cfg, warmup=1)
    kept = {}

    def keep(grads):
        kept["g"] = grads
        return grads
    step = steps.make_train_step(cfg, opt, grad_transform=keep)
    state = opt.init(params)
    batch = to_device(_batch(all_archs()["mamba2-780m"].reduced(), 64),
                      "cpu")
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    if powersgd:
        pc = comp.PowerSGDConfig(rank=2, min_elems=1000)
        comp.compress_decompress(kept["g"], comp.init_state(kept["g"], pc),
                                 pc)
    return [weakref.ref(t) for t in (params["embed"]["w"],
                                     state["m"]["embed"]["w"],
                                     kept["g"]["embed"]["w"])]


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_training_frees_its_tensors_without_gc(remat):
    """Once a training frame ends, its parameters, optimizer state and
    gradients are freed at once, with the cyclic garbage collector off:
    no reference cycle of the port's holds them (a recursive closure
    over a tree did), and torch's lazy first checkpoint call, whose
    garbage cycles hold the frames on its stack, runs on a thread of its
    own (``layers._warm_checkpoint``)."""
    import gc
    cfg = get_arch("mamba2-780m").reduced().replace(
        remat=remat != "off", remat_policy="full" if remat == "off"
        else remat)
    gc.collect()
    gc.disable()
    try:
        for powersgd in (False, True):
            refs = _weak_train(cfg, powersgd)
            assert [r() is None for r in refs] == [True] * 3, powersgd
    finally:
        gc.enable()
