"""The "model" axis of the ssm, hybrid, vlm and audio families: the port
against the reference.

Reduced float32 ``mamba2-780m``, ``zamba2-1.2b``, ``llama-3.2-vision-11b``
and ``seamless-m4t-medium`` with the reference's init bridged through
numpy, their biases, norm biases, cross gates and Mamba2's A, D, dt bias
and conv bias redrawn with numpy from a seed (the reference's zero gates
close the VLM's cross block; its constant A, D and dt bias make every
head alike in them).  One gloo world of 4 processes, spawned once for the
module (the workers import torch and the port only,
``torch.set_num_threads(1)``), runs each config on the meshes (1, 4) and
(2, 2) while the references run in this process:

* serving, slab, fused blocks of 4 and async ``"deterministic"``: every
  rank's greedy tokens equal the port's no-mesh engine's and the
  reference's 1-device ``repro.serving.Engine``'s; the caches hold the
  rank's blocks of ``cache_pspec``;
* three TP + ZeRO-1 AdamW steps against ``repro.runtime.steps.
  make_train_step`` on the whole batch: losses and grad norms within
  1e-5 relative, each leaf's Δp within 1e-3 relative L2 (the bars of
  ``tests/test_torch_tp.py``), but for a leaf whose exact gradient is 0
  (the audio decoder's cross-attention K bias), whose gradient must be
  rounding noise;
* the gradient under tensor parallelism: every leaf the rule replicates
  (Mamba2's conv taps and bias, A, D, dt bias and gated-norm scale among
  them) is bit-equal across each model group and within 1e-5 relative
  L2 of the no-mesh gradient; a gated norm whose all-reduce had an
  identity backward would miss the other ranks' terms in every gradient
  upstream of it;
* ``mamba2-780m`` trained on (2, 2) with TP and ZeRO-1, saved, restored
  onto (4, 1) by ``restore_for_mesh``, resumed: the uninterrupted run's
  losses;
* every rank's counted collectives equal.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels.ops import make_kernels  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.runtime import driver, steps  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves, rebuild  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2-780m", "zamba2-1.2b", "llama-3.2-vision-11b",
         "seamless-m4t-medium")
MESHES = ("14", "22")
SERVE_MODES = ("slab", "fused", "async")
WORLD = 4
SLOTS, MAX_LEN, MAX_NEW = 4, 64, 10
PROMPT_LENS = (12, 7, 15)            # the reference conformance test's
TRAIN = ShapeSpec("t", 16, 4, "train")
TRAIN_STEPS = 3
# leaves whose exact gradient is 0 (see the train-step test)
ZERO_GRAD = ("xattn/wk/b",)
# Mamba2's replicated leaves that a rank reads in part
SSM_SHARED = ("conv_w", "conv_b", "a_log", "d", "dt_bias", "ssd/norm/scale")

_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    from repro_torch.launch import mesh as M
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh, tp as TP
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels.ops import make_kernels
    from repro_torch.models.api import model_fns
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import driver, steps
    from repro_torch.serving import Engine, Request
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"14": M.make_host_mesh(1, 4, "cpu"),
              "22": M.make_host_mesh(2, 2, "cpu"),
              "41": M.make_host_mesh(4, 1, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    out = {}

    def tree(arch):                     # a copy: AdamW updates in place
        return rebuild(IN["template"][arch],
                       {n: torch.from_numpy(v.copy())
                        for n, v in IN["params"][arch].items()})

    def run(eng, arrivals):
        n = sum(len(v) for v in arrivals.values())
        done = []
        for step in range(300):
            for uid, p in arrivals.get(step, []):
                eng.submit(Request(uid=uid, prompt=p,
                                   max_new_tokens=IN["max_new"]))
            done.extend(eng.step())
            if len(done) == n and not eng._occupied():
                break
        return {r.uid: r.out_tokens for r in done}

    def batch_at(src, s):
        return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
                else torch.from_numpy(v) for k, v in src.batch_at(s).items()}

    modes = {"slab": {}, "fused": {"decode_block": 4},
             "async": {"prefill_async": True,
                       "ready_order": "deterministic"}}
    for arch in IN["archs"]:
        cfg = get_arch(arch).reduced().replace(dtype="float32")
        params = tree(arch)
        for mt in IN["meshes"]:
            for tag in IN["modes"]:
                eng = Engine(cfg, params, slots=IN["slots"],
                             max_len=IN["max_len"], device="cpu",
                             decompose_engine=DecomposeEngine(EngineConfig(
                                 mesh=meshes[mt])), **modes[tag])
                out[f"serve_{arch}_{mt}_{tag}"] = run(eng, IN["staggered"])
                if tag == "slab":
                    out[f"cache_{arch}_{mt}"] = {
                        n: tuple(t.shape) for n, t in
                        named_leaves(eng.cache)}
                del eng
        del params

        src = SyntheticLM(cfg, IN["train_shape"], DataConfig())
        fns = model_fns(cfg)
        kern = make_kernels("reference")
        for mt in IN["meshes"]:
            mesh = meshes[mt]
            opt = make_optimizer(cfg, warmup=1)
            p = tree(arch)
            p, o = steps.shard_train_state(cfg, p, opt.init(p), mesh,
                                           zero1=True, optimizer=opt)
            fn = steps.make_train_step(cfg, opt, mesh=mesh,
                                       backend="reference", zero1=True)
            losses, norms = [], []
            for s in range(IN["train_steps"]):
                p, o, met = fn(p, o, batch_at(src, s))
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            wp, _ = steps.whole_train_state(cfg, p, o, mesh, zero1=True,
                                            optimizer=opt)
            out[f"train_{arch}_{mt}"] = (
                losses, norms, {n: v.numpy() for n, v in named_leaves(wp)})
            del p, o, wp
            # the gradient of the whole batch under tensor parallelism:
            # the leaves the rule replicates
            p = sh.shard_params(tree(arch), mesh, cfg)
            with TP.use(mesh):
                loss, g = steps.value_and_grad(
                    lambda q, b: fns.loss_fn(q, cfg, b, kern), p,
                    batch_at(src, 0))
            whole = IN["params"][arch]
            out[f"grad_{arch}_{mt}"] = (float(loss), {
                n: v.numpy() for n, v in named_leaves(g)
                if "model" not in sh.param_spec(n, whole[n].shape, mesh,
                                                cfg)})

    # ---- elastic: (2, 2) TP + ZeRO-1, saved, resumed on (4, 1) -----------
    ecfg = get_arch("mamba2-780m").reduced().replace(dtype="float32")
    ck = os.path.join(d, "elastic")
    kw = dict(ckpt_dir=ck, ckpt_every=1000, device="cpu",
              backend="reference", print_fn=lambda *a: None,
              optimizer=make_optimizer(ecfg, warmup=1))
    first = driver.train_loop(ecfg, IN["train_shape"], total_steps=2,
                              mesh=meshes["22"], zero1=True, **kw)
    st = driver.restore_for_mesh(ecfg, ck, meshes["41"],
                                 optimizer=kw["optimizer"])
    out["elastic_dtensor"] = all(hasattr(t, "to_local")
                                 for _, t in named_leaves(st))
    rest = driver.train_loop(ecfg, IN["train_shape"], total_steps=4,
                             mesh=meshes["41"], zero1=True, **kw)
    out["elastic"] = (first.losses, rest.losses)
    out["collectives"] = sh.collective_counts()

    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


def perturb(tree, rng):
    """Biases and norm biases N(0, 0.1²), cross gates uniform in
    ±[0.4, 0.9], Mamba2's A (log) + N(0, 0.3²), D 1 + N(0, 0.1²), dt bias
    N(0, 0.3²) and conv bias N(0, 0.1²); every other leaf kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k in ("b", "bias", "conv_b"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(v.dtype)
        elif k in ("gate_attn", "gate_mlp"):
            g = rng.uniform(0.4, 0.9, v.shape) * rng.choice([-1, 1], v.shape)
            out[k] = np.asarray(g, v.dtype)
        elif k in ("a_log", "dt_bias"):
            out[k] = (v + rng.randn(*v.shape) * 0.3).astype(v.dtype)
        elif k == "d":
            out[k] = (v + rng.randn(*v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference cfg, reference params, port cfg, port params),
    the reference's float32 init perturbed, the port's a copy of it."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = all_archs()[arch].reduced().replace(dtype="float32")
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tree = perturb(jax.tree_util.tree_map(np.asarray, jp),
                       np.random.RandomState(i))
        out[arch] = (jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                     get_arch(arch).reduced().replace(dtype="float32"),
                     bridge.to_torch(tree, "cpu"))
    return out


@pytest.fixture(scope="module")
def world_inputs(models, tmp_path_factory):
    """The workers' inputs, and the four workers started on them."""
    d = str(tmp_path_factory.mktemp("tpfamilies"))
    prompts = _prompts(512, PROMPT_LENS, 0)
    IN = {"archs": ARCHS, "meshes": MESHES, "modes": SERVE_MODES,
          "staggered": {3 * i: [(i, p)] for i, p in enumerate(prompts)},
          "slots": SLOTS, "max_len": MAX_LEN, "max_new": MAX_NEW,
          "train_shape": TRAIN, "train_steps": TRAIN_STEPS,
          "template": {a: models[a][3] for a in ARCHS},
          "params": {a: {n: v.numpy().copy() for n, v in
                         named_leaves(models[a][3])} for a in ARCHS}}
    with open(os.path.join(d, "in.pkl"), "wb") as f:
        pickle.dump(IN, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    store = os.path.join(d, "store")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                               str(WORLD), store, d], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    yield IN, procs, d
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _run(eng, req_cls, arrivals, max_new=MAX_NEW):
    n = sum(len(v) for v in arrivals.values())
    done = []
    for step in range(300):
        for uid, p in arrivals.get(step, []):
            eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=max_new))
        done.extend(eng.step())
        if len(done) == n and not any(eng.live) and not len(eng.sched):
            break
    assert sorted(r.uid for r in done) == list(range(n))
    return {r.uid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def serve_reference(world_inputs, models):
    """Per arch: the port's no-mesh tokens for each serving mode and the
    reference 1-device engine's."""
    IN = world_inputs[0]
    kw = {"slab": {}, "fused": {"decode_block": 4},
          "async": {"prefill_async": True, "ready_order": "deterministic"}}
    out = {}
    for arch in ARCHS:
        jcfg, jp, tcfg, tp = models[arch]
        want = {tag: _run(Engine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN,
                                 device="cpu", **kw[tag]), Request,
                          IN["staggered"]) for tag in SERVE_MODES}
        want["reference"] = _run(JEngine(jcfg, jp, slots=SLOTS,
                                         max_len=MAX_LEN), JRequest,
                                 IN["staggered"])
        out[arch] = want
    return out


def _batch(cfg, s):
    from repro_torch.data import DataConfig, SyntheticLM
    b = SyntheticLM(cfg, TRAIN, DataConfig()).batch_at(s)
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def train_reference(world_inputs, models):
    """Per arch: the reference's ``make_train_step`` on the whole batch,
    three steps from the bridged parameters (losses, grad norms, final
    parameters), and the port's no-mesh gradient of step 0's batch."""
    from repro.configs.base import ShapeSpec as JShape
    from repro.data import DataConfig as JData, SyntheticLM as JSynth
    out = {}
    for arch in ARCHS:
        jcfg, _, tcfg, tp = models[arch]
        jp = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                    bridge.to_numpy(tp))
        opt = jmake_optimizer(jcfg, warmup=1)
        st = opt.init(jp)
        fn = jax.jit(jsteps.make_train_step(jcfg, opt))
        src = JSynth(jcfg, JShape("t", TRAIN.seq_len, TRAIN.global_batch,
                                  "train"), JData())
        losses, norms = [], []
        for s in range(TRAIN_STEPS):
            jp, st, m = fn(jp, st, src.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        kern = make_kernels("reference")
        fns = model_fns(tcfg)
        loss, g = steps.value_and_grad(
            lambda q, b: fns.loss_fn(q, tcfg, b, kern), tp, _batch(tcfg, 0))
        out[arch] = (losses, norms,
                     {jsh._path_str(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(jp)[0]},
                     float(loss), {n: v.numpy() for n, v in named_leaves(g)})
    return out


@pytest.fixture(scope="module")
def resume_reference(world_inputs):
    """The uninterrupted run of the world's elastic case, no mesh."""
    import tempfile
    from repro_torch.optim import make_optimizer
    cfg = get_arch("mamba2-780m").reduced().replace(dtype="float32")
    with tempfile.TemporaryDirectory() as ck:
        return driver.train_loop(cfg, TRAIN, total_steps=4, ckpt_dir=ck,
                                 ckpt_every=1000, device="cpu",
                                 backend="reference",
                                 print_fn=lambda *a: None,
                                 optimizer=make_optimizer(cfg, warmup=1)
                                 ).losses


@pytest.fixture(scope="module")
def world(world_inputs, serve_reference, train_reference, resume_reference):
    """Every rank's results of the worker script.  The workers started
    with ``world_inputs``; the references (this fixture's other
    arguments) are computed in this process while they run."""
    IN, procs, d = world_inputs
    logs = [p.communicate(timeout=900)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return IN, out


def _groups(mt):
    """The model groups of a mesh's ranks (rank-major (data, model))."""
    return {"14": [[0, 1, 2, 3]], "22": [[0, 1], [2, 3]]}[mt]


def _model_size(mt):
    return {"14": 4, "22": 2}[mt]


@pytest.mark.parametrize("mt", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_serving_equals_no_mesh_and_reference(world, models,
                                                        serve_reference,
                                                        arch, mt):
    """Slab, fused blocks of 4 and async deterministic on the model axis:
    every rank's tokens are the no-mesh engine's and the reference's;
    each cache leaf is the rank's block of ``cache_pspec``."""
    _, out = world
    want = serve_reference[arch]
    for tag in SERVE_MODES:
        assert want[tag] == want["reference"], tag
    tcfg = models[arch][2]
    m = _model_size(mt)
    mesh = sh.MeshShape(("data", "model"), (WORLD // m, m))
    whole = model_fns(tcfg).init_cache(tcfg, SLOTS, MAX_LEN, device="meta")
    specs = {n: sh.cache_pspec(n, tuple(v.shape), mesh, seq_shard=False)
             for n, v in named_leaves(whole)}
    for res in out:
        for tag in SERVE_MODES:
            got = {u: list(t) for u, t in
                   res[f"serve_{arch}_{mt}_{tag}"].items()}
            assert got == want["reference"], tag
        for name, leaf in named_leaves(whole):
            blk = tuple(n // sh.axis_size(mesh, e) if e is not None else n
                        for n, e in zip(leaf.shape, specs[name]))
            assert res[f"cache_{arch}_{mt}"][name] == blk, name
        assert any("model" in s for s in specs.values())


@pytest.mark.parametrize("mt", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_zero1_train_steps_match_reference(world, models,
                                                     train_reference, arch,
                                                     mt):
    """Three TP + ZeRO-1 AdamW steps against the reference's
    ``make_train_step`` on the whole batch: losses and grad norms within
    1e-5 relative, each leaf's Δp within 1e-3 relative L2."""
    _, out = world
    losses, norms, params = train_reference[arch][:3]
    grad = train_reference[arch][4]
    p0 = {n: v.numpy() for n, v in named_leaves(models[arch][3])}
    # leaves whose exact gradient is 0 (a cross-attention K bias: without
    # RoPE it adds q·b to every score of a row, which the softmax
    # cancels) hold rounding noise, which Adam scales to a full step of
    # either sign in each package alike: their Δp is not compared, their
    # gradient must be noise
    top = max(np.abs(g).max() for g in grad.values())
    noise = {n for n in params if n.endswith(ZERO_GRAD)}
    for name in noise:
        assert np.abs(grad[name]).max() <= 1e-6 * top, name
    for res in out:
        got_l, got_n, got_p = res[f"train_{arch}_{mt}"]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        np.testing.assert_allclose(got_n, norms, rtol=1e-5)
        assert got_p.keys() == params.keys()
        for name, want in params.items():
            if name in noise:
                continue
            d_ref = want - p0[name]
            d_got = got_p[name] - p0[name]
            err = np.linalg.norm(d_got - d_ref) / max(
                np.linalg.norm(d_ref), 1e-30)
            assert err < 1e-3, (name, err)


@pytest.mark.parametrize("mt", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_replicated_gradients(world, train_reference, arch, mt):
    """The gradient of the whole batch under tensor parallelism: each
    leaf the rule replicates is bit-equal across every model group and
    within 1e-5 relative L2 of the no-mesh gradient (Mamba2's leaves that
    a rank reads in part among them, the gated norm's scale too)."""
    _, out = world
    want_loss, want = train_reference[arch][3:]
    names = set(out[0][f"grad_{arch}_{mt}"][1])
    if get_arch(arch).family in ("ssm", "hybrid"):
        assert {n for n in names if n.endswith(SSM_SHARED)} >= {
            n for n in want if n.endswith(SSM_SHARED)}
    for group in _groups(mt):
        ref = out[group[0]][f"grad_{arch}_{mt}"]
        for r in group[1:]:
            loss, g = out[r][f"grad_{arch}_{mt}"]
            assert loss == ref[0]
            for n in names:
                np.testing.assert_array_equal(g[n], ref[1][n], err_msg=n)
    for res in out:
        loss, g = res[f"grad_{arch}_{mt}"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for n in names:
            err = np.linalg.norm(g[n] - want[n]) / max(
                np.linalg.norm(want[n]), 1e-30)
            assert err < 1e-5, (n, err)


def test_mamba2_tp_zero1_restore_for_mesh_resumes(world, resume_reference):
    """mamba2-780m on (2, 2) with TP and ZeRO-1, two steps, saved whole;
    restored onto (4, 1) by ``restore_for_mesh`` (DTensors, fed to the
    step as they are), two more steps: the uninterrupted run's losses."""
    _, out = world
    for r in out:
        first, rest = r["elastic"]
        assert r["elastic_dtensor"]
        assert len(first) == 2 and len(rest) == 2
        np.testing.assert_allclose(first + rest, resume_reference,
                                   rtol=1e-5)


def test_every_rank_issued_the_same_collectives(world):
    _, out = world
    counts = out[0]["collectives"]
    assert all(res["collectives"] == counts for res in out)
    assert {"all_gather/in_proj", "all_reduce/gated_norm",
            "all_reduce/gated_norm_grad", "all_reduce/ssm_rep_grad",
            "all_gather/conv_cache", "all_gather/xk_cols",
            "all_gather/xk_cache", "all_reduce/tp_out",
            "all_gather/logits", "reduce_scatter/in_proj_grad",
            "all_gather/params"} <= set(counts), sorted(counts)
