"""The "model" axis of distribution: the port against the reference.

* The rules: ``sharding.shard_params`` gives every rank, on (2, 2) and
  (1, 4), the block of each leaf of every dense, moe, ssm, hybrid, vlm
  and audio reduced tree that ``repro.distributed.sharding.param_spec``
  names on an ``AbstractMesh`` of the same shape.  No process group.
  (The ssm, hybrid, vlm and audio families on the model axis run in
  ``tests/test_torch_tp_families.py``.)
* One gloo world of 4 processes, spawned once for the module (the
  workers import torch and the port only, ``torch.set_num_threads(1)``),
  on (1, 4), (2, 2), (4, 1) and the pod mesh (2, 2, 1):

  - float32 ``deepseek-7b`` decomposed-KV serving, slab and paged, on the
    reference conformance test's staggered schedule (plus fused blocks of
    4 and async admission on (2, 2)): tokens equal to the port's no-mesh
    engine and the reference's 1-device ``JEngine``; U bit-equal across
    each model group; the factors' kv width sharded;
  - float32 ``gemma-2b`` (one kv head: the head_dim gather) greedy tokens
    equal to the reference's; ``olmoe-1b-7b`` serving equal to no mesh;
  - ``moe_ffn_shard_map`` "1d" and "2d" with drops: on each data shard
    the reference's ``moe_ffn`` of that shard; drop-free, ``moe_ffn`` of
    the whole batch;
  - three TP + ZeRO-1 train steps of float32 ``granite-3-2b`` and
    ``deepseek-7b`` on (2, 2), (1, 4) and the pod mesh against
    ``repro.runtime.steps.make_train_step`` on the whole batch (losses
    1e-5 relative, Δp 1e-3 relative L2, the global norm over the shards
    equal to the reference's), each DP rank holding only its
    ``opt_state_sharding`` block of m and v; two expert-parallel steps of
    ``olmoe-1b-7b`` against the port's single-process steps;
  - the elastic case of ``tests/test_runtime.py``: ``train_loop`` on
    (2, 2) with TP and ZeRO-1 saves, ``restore_for_mesh`` onto (4, 1)
    resumes with no ``unshard``, against the uninterrupted run (rtol
    2e-2, the reference's bar);
  - every rank's counted collectives equal.
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
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.runtime import driver, steps  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# (a) the rules, without a process group
# ---------------------------------------------------------------------------

RULE_ARCHS = ("llama2-7b", "gemma-2b", "granite-3-2b", "starcoder2-7b",
              "olmoe-1b-7b", "kimi-k2-1t-a32b", "mamba2-780m", "zamba2-1.2b",
              "llama-3.2-vision-11b", "seamless-m4t-medium")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", RULE_ARCHS)
def test_shard_params_blocks_match_reference_specs(arch, shape):
    names = ("data", "model")
    amesh = AbstractMesh(shape, names)
    pmesh = sh.MeshShape(names, shape)
    jcfg = all_archs()[arch].reduced().replace(dtype="float32")
    tcfg = get_arch(arch).reduced().replace(dtype="float32")
    for two_d in ((False, True) if tcfg.num_experts else (False,)):
        if two_d:
            jcfg = jcfg.replace(expert_sharding="2d")
            tcfg = tcfg.replace(expert_sharding="2d")
        params = model_fns(tcfg).init(tcfg, torch.Generator().manual_seed(0),
                                      "cpu")
        whole = dict(named_leaves(params))
        sharded_any = False
        for d in range(shape[0]):
            for m in range(shape[1]):
                where = {"data": d, "model": m}
                got = dict(named_leaves(sh.shard_params(params, pmesh, tcfg,
                                                        where)))
                for name, leaf in whole.items():
                    spec = tuple(jsh.param_spec(name, tuple(leaf.shape),
                                                amesh, jcfg))
                    want = leaf.numpy()
                    for dim, entry in enumerate(spec):
                        if entry is None:
                            continue
                        n = shape[names.index(entry)]
                        i = where[entry]
                        size = want.shape[dim] // n
                        want = np.take(want, range(i * size, (i + 1) * size),
                                       axis=dim)
                        sharded_any = True
                    np.testing.assert_array_equal(got[name].numpy(), want,
                                                  err_msg=name)
        assert sharded_any


@pytest.mark.parametrize("geom, m, want", [
    # (nh, kvh, hd), M → (nh_l, kvh_l, aligned, kv_sharded, cache dim)
    ((4, 2, 32), 2, (2, 1, True, True, -2)),     # whole kv heads
    ((4, 2, 32), 4, (1, 1, False, True, -1)),    # the rule splits hd
    ((8, 1, 256), 4, (2, 1, False, True, -1)),   # gemma-2b: one kv head
    ((4, 1, 6), 4, (1, 1, False, False, None)),  # wq/wo sharded, wk/wv not
    ((4, 2, 32), None, (4, 2, True, False, None)),   # no model axis
    # the rule splits a head (M divides nh·hd, not nh): each rank runs
    # the heads its column block touches
    ((6, 1, 32), 4, (2, 1, False, True, -1)),
    ((8, 1, 256), 16, (1, 1, False, True, -1)),  # gemma-2b at M = 16
    ((36, 4, 128), 16, (3, 1, False, True, -1)),  # starcoder2-7b
])
def test_head_layout_follows_the_rules(geom, m, want):
    """A rank's heads, and where its K/V come from, under the reference's
    rule (``param_spec``: wq/wo and wk/wv shard their heads' dims when M
    divides them; ``cache_pspec``: kv heads, else head_dim); where the
    column block cuts a head, the heads it touches."""
    from repro_torch.distributed import tp as TP
    nh, kvh, hd = geom
    cfg = get_arch("granite-3-2b").reduced().replace(
        num_heads=nh, num_kv_heads=kvh, head_dim=hd)
    for r in range(m or 1):
        lay = TP.head_layout(cfg, None if m is None
                             else TP.TP(None, None, m, r))
        assert (lay.nh_l, lay.kvh_l, lay.aligned, lay.kv_sharded,
                lay.cache) == want
        if lay.split:
            assert lay.q0 == r * (nh * hd // m) // hd
        else:
            assert lay.q0 == r * lay.nh_l
        assert lay.k0 == lay.q0 // (nh // kvh)


# ---------------------------------------------------------------------------
# (b) one gloo world of 4
# ---------------------------------------------------------------------------

WORLD = 4
RANK, TAIL, SLOTS, MAX_LEN, MAX_NEW = 8, 4, 8, 64, 10
PROMPT_LENS = (12, 7, 15)            # the reference conformance test's
TRAIN = ShapeSpec("t", 16, 4, "train")
TRAIN_STEPS = 3
# the world's TP + ZeRO-1 train cases: tag → (arch, config overrides,
# meshes).  "granite-kv-replicated" has 4 query heads of 6 dims and one
# kv head: at M = 4 the rule shards wq/wo (24 columns) but replicates
# wk/wv (6), which only the rank's own query head reads
TRAIN_CASES = {
    "granite-3-2b": ("granite-3-2b", {}, ("22", "14", "pod")),
    "deepseek-7b": ("deepseek-7b", {}, ("22",)),
    "olmoe-1b-7b": ("olmoe-1b-7b", {}, ("22",)),
    "granite-kv-replicated": ("granite-3-2b", dict(num_heads=4,
                                                   num_kv_heads=1,
                                                   head_dim=6), ("14",)),
}

_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models import moe
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import driver, steps
    from repro_torch.serving import Engine, Request
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"14": M.make_host_mesh(1, 4, "cpu"),
              "22": M.make_host_mesh(2, 2, "cpu"),
              "41": M.make_host_mesh(4, 1, "cpu"),
              "pod": M.make_pod_mesh(2, 2, 1, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    Z0 = lambda h: IN["z0"][h]
    out = {}

    def tree(tag):                      # a copy: AdamW updates in place
        return rebuild(IN[tag + "_template"],
                       {n: torch.from_numpy(v.copy())
                        for n, v in IN[tag].items()})

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

    # ---- decomposed-KV serving (deepseek-7b) and dense gemma-2b ----------
    dcfg = get_arch("deepseek-7b").reduced().replace(dtype="float32")
    dp_ = tree("dkv")
    stag = IN["staggered"]
    for mt in ("14", "22"):
        mesh = meshes[mt]
        cases = [("slab", {}), ("paged", {"paged": True})]
        if mt == "22":
            cases += [("fused", {"decode_block": 4}),
                      ("async", {"prefill_async": True,
                                 "ready_order": "deterministic"})]
        for tag, kw in cases:
            ec = EngineConfig(kv_rank=IN["rank"], kv_tail=IN["tail"],
                              kv_page=4, mesh=mesh)
            eng = Engine(dcfg, dp_, slots=IN["slots"], max_len=64,
                         device="cpu",
                         decompose_engine=DecomposeEngine(ec, z0=Z0), **kw)
            out[f"dkv_{mt}_{tag}"] = run(eng, stag)
            out[f"dkv_{mt}_{tag}_folds"] = eng.stats.tail_folds
            c = eng.cache if eng.pager is None else eng.pager.cache
            u = c["k_u_pages"] if "k_u_pages" in c else c["k_u"]
            out[f"dkv_{mt}_{tag}_u"] = (u.numpy().copy(),
                                        c["v_u_pages" if "k_u_pages" in c
                                          else "v_u"].numpy().copy())
            out[f"dkv_{mt}_{tag}_vt"] = tuple(c["k_vt"].shape)
            del eng
    gcfg = get_arch("gemma-2b").reduced().replace(dtype="float32")
    gp = tree("gemma")
    for mt in ("14", "22"):
        eng = Engine(gcfg, gp, slots=4, max_len=64, device="cpu",
                     decompose_engine=DecomposeEngine(EngineConfig(
                         mesh=meshes[mt])))
        out[f"gemma_{mt}"] = run(eng, stag)
        out[f"gemma_{mt}_k"] = tuple(eng.cache["k"].shape)
        del eng
    ocfg = get_arch("olmoe-1b-7b").reduced().replace(dtype="float32")
    op = tree("olmoe")
    for mt in ("14", "22"):
        eng = Engine(ocfg, op, slots=4, max_len=64, device="cpu",
                     decompose_engine=DecomposeEngine(EngineConfig(
                         mesh=meshes[mt])))
        out[f"olmoe_{mt}"] = run(eng, stag)
        del eng

    # ---- moe_ffn_shard_map on the rank's data shard ----------------------
    x = torch.from_numpy(IN["moe_x"])
    for mt in ("14", "22"):
        mesh = meshes[mt]
        dpn, i = sh.dp_size(mesh), sh.dp_rank(mesh)
        xs = x[i * x.shape[0] // dpn:(i + 1) * x.shape[0] // dpn]
        for kind, cf in (("1d", None), ("2d", None), ("1d", 8.0)):
            cfg = ocfg.replace(expert_sharding=kind)
            if cf is not None:
                cfg = cfg.replace(capacity_factor=cf)
            full = {k: torch.from_numpy(IN["moe_p"][k])
                    for k in ("w_gate", "w_up", "w_down")}
            full["router"] = {"w": torch.from_numpy(IN["moe_p"]["router_w"])}
            lp = sh.shard_params({"layers": {"moe": full}}, mesh,
                                 cfg)["layers"]["moe"]
            y, aux = moe.moe_ffn_shard_map(lp, xs, cfg, mesh)
            out[f"moe_{mt}_{kind}_{cf}"] = (i, y.numpy(), float(aux),
                                            tuple(lp["w_up"].shape))

    # ---- TP + ZeRO-1 train steps -----------------------------------------
    def batch_at(src, s):
        return {k: torch.from_numpy(v).long()
                for k, v in src.batch_at(s).items()}

    for tag, (arch, over, mts) in IN["train_cases"].items():
        cfg = get_arch(arch).reduced().replace(dtype="float32", **over)
        src = SyntheticLM(cfg, IN["train_shape"], DataConfig())
        for mt in mts:
            mesh = meshes[mt]
            opt = make_optimizer(cfg, warmup=1)
            p = tree("train_" + tag)
            p, o = steps.shard_train_state(cfg, p, opt.init(p), mesh,
                                           zero1=True, optimizer=opt)
            fn = steps.make_train_step(cfg, opt, mesh=mesh,
                                       backend="reference", zero1=True)
            losses, norms = [], []
            for s in range(IN["train_steps"]):
                p, o, met = fn(p, o, batch_at(src, s))
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            m_shapes = {n: tuple(t.shape) for n, t in named_leaves(o["m"])}
            wp, _ = steps.whole_train_state(cfg, p, o, mesh, zero1=True,
                                            optimizer=opt)
            out[f"train_{tag}_{mt}"] = (
                losses, norms, m_shapes,
                {n: v.numpy() for n, v in named_leaves(wp)})

    # ---- elastic: (2, 2) TP + ZeRO-1, saved, resumed on (4, 1) -----------
    ecfg = get_arch("granite-3-2b").reduced().replace(dtype="float32")
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


def _bridged(arch, key=0):
    """(reference cfg, reference params, port cfg, port params) of a
    float32 reduced config: the reference's init, and the port's copy."""
    jcfg = all_archs()[arch].reduced().replace(dtype="float32")
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(key), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, get_arch(arch).reduced().replace(dtype="float32"), tp


@pytest.fixture(scope="module")
def models():
    return {a: _bridged(a) for a in ("deepseek-7b", "gemma-2b",
                                     "olmoe-1b-7b")}


def _train_init(tag):
    arch, over, _ = TRAIN_CASES[tag]
    tcfg = get_arch(arch).reduced().replace(dtype="float32", **over)
    p0, _ = steps.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    return p0


@pytest.fixture(scope="module")
def world_inputs(models, tmp_path_factory):
    """The workers' inputs, and the four workers started on them."""
    d = str(tmp_path_factory.mktemp("tpworld"))
    tcfg = models["deepseek-7b"][2]
    prompts = _prompts(tcfg.vocab, PROMPT_LENS, 0)
    ocfg, op = models["olmoe-1b-7b"][2], models["olmoe-1b-7b"][3]
    moe = op["layers"]["moe"]
    IN = {"z0": {h: np.asarray(_padded_z0(h, h)) for h in (tcfg.kv_width,)},
          "staggered": {3 * i: [(i, p)] for i, p in enumerate(prompts)},
          "rank": RANK, "tail": TAIL, "slots": SLOTS, "max_new": MAX_NEW,
          "moe_x": np.random.RandomState(5).randn(4, 8, ocfg.d_model)
          .astype(np.float32),
          "train_shape": TRAIN, "train_steps": TRAIN_STEPS,
          "train_cases": TRAIN_CASES}
    IN["moe_p"] = {k: moe[k][0].numpy().copy()
                   for k in ("w_gate", "w_up", "w_down")}
    IN["moe_p"]["router_w"] = moe["router"]["w"][0].numpy().copy()
    for tag, arch in (("dkv", "deepseek-7b"), ("gemma", "gemma-2b"),
                      ("olmoe", "olmoe-1b-7b")):
        tp = models[arch][3]
        IN[tag + "_template"] = tp
        IN[tag] = {n: v.numpy().copy() for n, v in named_leaves(tp)}
    for tag in TRAIN_CASES:
        p0 = _train_init(tag)
        IN[f"train_{tag}_template"] = p0
        IN[f"train_{tag}"] = {n: v.numpy().copy()
                              for n, v in named_leaves(p0)}
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


@pytest.fixture(scope="module")
def world(world_inputs, dkv_reference, reference_train, no_mesh_moe):
    """Every rank's results of the worker script.  The workers started
    with ``world_inputs``; the references (this fixture's other
    arguments) are computed in this process while they run."""
    IN, procs, d = world_inputs
    logs = [p.communicate(timeout=600)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return IN, out


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


def _groups(mt):
    """The model groups of a mesh's ranks (rank-major (data, model))."""
    return {"14": [[0, 1, 2, 3]], "22": [[0, 1], [2, 3]]}[mt]


@pytest.fixture(scope="module")
def dkv_reference(world_inputs, models):
    """The no-mesh tokens of the world's dkv recipes (the port's engine,
    slab, paged and fused blocks of 4) and the reference 1-device
    engine's; and the reference's dense gemma-2b and olmoe-1b-7b
    tokens."""
    IN = world_inputs[0]
    jcfg, jp, tcfg, tp = models["deepseek-7b"]
    z0 = lambda h: IN["z0"][h]              # noqa: E731
    want = {}
    for tag, kw in (("slab", {}), ("paged", {"paged": True}),
                    ("fused", {"decode_block": 4})):
        eng = Engine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                     decompose_engine=DecomposeEngine(EngineConfig(
                         kv_rank=RANK, kv_tail=TAIL, kv_page=4), z0=z0), **kw)
        want[tag] = _run(eng, Request, IN["staggered"])
        assert eng.stats.tail_folds > 0
    jeng = JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN,
                   decompose_kv_rank=RANK, dkv_tail=TAIL,
                   decompose_engine=JDecomposeEngine(JEngineConfig(
                       kv_rank=RANK, kv_tail=TAIL)))
    want["reference"] = _run(jeng, JRequest, IN["staggered"])
    for tag, arch in (("gemma", "gemma-2b"), ("olmoe", "olmoe-1b-7b")):
        jc, jw = models[arch][:2]
        want[tag] = _run(JEngine(jc, jw, slots=4, max_len=MAX_LEN),
                         JRequest, IN["staggered"])
    return want


@pytest.fixture(scope="module")
def no_mesh_moe(world_inputs, models):
    """The port's no-mesh olmoe-1b-7b tokens on the staggered schedule,
    and three single-process train steps (losses, parameters)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import make_optimizer
    IN = world_inputs[0]
    _, _, tcfg, tp = models["olmoe-1b-7b"]
    eng = Engine(tcfg, tp, slots=4, max_len=MAX_LEN, device="cpu")
    toks = _run(eng, Request, IN["staggered"])
    opt = make_optimizer(tcfg, warmup=1)
    p = _train_init("olmoe-1b-7b")
    st = opt.init(p)
    fn = steps.make_train_step(tcfg, opt, backend="reference")
    src = SyntheticLM(tcfg, TRAIN, DataConfig())
    losses = []
    for s in range(TRAIN_STEPS):
        b = {k: torch.from_numpy(v).long() for k, v in src.batch_at(s).items()}
        p, st, m = fn(p, st, b)
        losses.append(float(m["loss"]))
    return toks, losses, {n: v.numpy() for n, v in named_leaves(p)}


@pytest.mark.parametrize("mt", ["14", "22"])
def test_tp_dkv_serving_equals_no_mesh_and_reference(world, models,
                                                     dkv_reference, mt):
    IN, out = world
    tcfg = models["deepseek-7b"][2]
    want = dkv_reference
    assert want["slab"] == want["paged"] == want["reference"]
    tags = ("slab", "paged") + (("fused", "async") if mt == "22" else ())
    for res in out:
        for tag in tags:
            got = {u: list(t) for u, t in res[f"dkv_{mt}_{tag}"].items()}
            assert got == want["fused" if tag == "fused" else "slab"], tag
            assert res[f"dkv_{mt}_{tag}_folds"] > 0
        # the factors' kv width is the rank's block
        assert res[f"dkv_{mt}_slab_vt"][-1] == tcfg.kv_width // (
            4 if mt == "14" else 2)
    # a rank's factors are bit-equal across its model group
    for group in _groups(mt):
        for tag in tags:
            ref = out[group[0]][f"dkv_{mt}_{tag}_u"]
            for r in group[1:]:
                for a, b in zip(ref, out[r][f"dkv_{mt}_{tag}_u"]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mt", ["14", "22"])
def test_tp_dense_gemma_head_dim_gather_equals_reference(world, models,
                                                        dkv_reference, mt):
    """gemma-2b has one kv head: the rule splits its head_dim over "model"
    and every rank gathers K/V before attention."""
    _, out = world
    tcfg = models["gemma-2b"][2]
    want = dkv_reference["gemma"]
    m = 4 if mt == "14" else 2
    for res in out:
        assert {u: list(t) for u, t in res[f"gemma_{mt}"].items()} == want
        assert res[f"gemma_{mt}_k"][-2:] == (1, tcfg.resolved_head_dim // m)


@pytest.mark.parametrize("mt", ["14", "22"])
def test_tp_moe_serving_equals_no_mesh(world, no_mesh_moe, dkv_reference,
                                       mt):
    """olmoe-1b-7b, expert-parallel on the model axis: every rank's tokens
    equal the reference's 1-device engine's and the port's no-mesh
    engine's."""
    _, out = world
    want = dkv_reference["olmoe"]
    assert no_mesh_moe[0] == want
    for res in out:
        assert {u: list(t) for u, t in res[f"olmoe_{mt}"].items()} == want


@pytest.mark.parametrize("case", ["1d_None", "2d_None", "1d_8.0"])
@pytest.mark.parametrize("mt", ["14", "22"])
def test_moe_ffn_shard_map_is_the_references_per_data_shard(world, models,
                                                            mt, case):
    """With drops (the default capacity factor): on each data shard, the
    reference's ``moe_ffn`` of that shard; drop-free (capacity factor 8),
    also ``moe_ffn`` of the whole batch."""
    IN, out = world
    jcfg = models["olmoe-1b-7b"][0]
    kind, cf = case.split("_")
    cfg = jcfg.replace(expert_sharding=kind)
    if cf != "None":
        cfg = cfg.replace(capacity_factor=float(cf))
    mp = IN["moe_p"]
    jp = {"w_gate": jnp.asarray(mp["w_gate"]), "w_up": jnp.asarray(mp["w_up"]),
          "w_down": jnp.asarray(mp["w_down"]),
          "router": {"w": jnp.asarray(mp["router_w"])}}
    x = IN["moe_x"]
    dp = 1 if mt == "14" else 2
    n = x.shape[0] // dp
    drops = 0
    for res in out:
        i, y, aux, w_up = res[f"moe_{mt}_{kind}_{cf}"]
        xs = x[i * n:(i + 1) * n]
        jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(xs), cfg)
        np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-5, atol=1e-5)
        m = 4 // dp
        f = jcfg.moe_d_ff // (dp if kind == "2d" else 1)
        assert w_up == (jcfg.num_experts // m, jcfg.d_model, f)
        t = xs.shape[0] * xs.shape[1]
        cap = int(np.ceil(t * cfg.top_k * cfg.capacity_factor
                          / cfg.num_experts))
        probs = jax.nn.softmax(jnp.asarray(xs.reshape(t, -1))
                               @ jp["router"]["w"], axis=-1)
        _, eidx = jax.lax.top_k(probs, cfg.top_k)
        drops += int(np.maximum(np.bincount(np.asarray(eidx).ravel(),
                                            minlength=cfg.num_experts)
                                - cap, 0).sum())
        if cf != "None":
            jy_all, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
            np.testing.assert_allclose(y, np.asarray(jy_all)[i * n:
                                                             (i + 1) * n],
                                       rtol=1e-5, atol=1e-5)
    assert (drops > 0) == (cf == "None")


@pytest.fixture(scope="module")
def reference_train():
    """The reference's ``make_train_step`` on the whole batch, three steps
    from the port's initial parameters: per train case (losses, grad
    norms, final parameters)."""
    from repro.configs.base import ShapeSpec as JShape
    from repro.data import DataConfig as JData, SyntheticLM as JSynth
    out = {}
    for tag, (arch, over, _) in TRAIN_CASES.items():
        jcfg = all_archs()[arch].reduced().replace(dtype="float32", **over)
        p0 = _train_init(tag)
        jp = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                    bridge.to_numpy(p0))
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
        out[tag] = (losses, norms, {jsh._path_str(p): np.asarray(v) for
                                     p, v in jax.tree_util.
                                     tree_flatten_with_path(jp)[0]},
                     {n: v.numpy() for n, v in named_leaves(p0)})
    return out


@pytest.mark.parametrize("case", ["granite-3-2b/22", "granite-3-2b/14",
                                  "granite-3-2b/pod", "deepseek-7b/22",
                                  "olmoe-1b-7b/22",
                                  "granite-kv-replicated/14"])
def test_tp_zero1_train_steps_match_reference(world, reference_train, case):
    """TP + ZeRO-1 steps against the reference's ``make_train_step`` on
    the whole batch: dense, decomposed-KV's deepseek, expert-parallel
    olmoe-1b-7b (the batch whole on every DP rank), and sharded query
    heads over replicated K/V projections (their gradient summed over
    "model", so the copies stay equal)."""
    tag, mt = case.split("/")
    _, out = world
    losses, norms, params, p0 = reference_train[tag]
    arch, over, _ = TRAIN_CASES[tag]
    cfg = get_arch(arch).reduced().replace(**over)
    m = {"22": 2, "14": 4, "pod": 1}[mt]
    dp = 4 // m
    for res in out:
        got_l, got_n, m_shapes, got_p = res[f"train_{tag}_{mt}"]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        np.testing.assert_allclose(got_n, norms, rtol=1e-5)
        for name, want in params.items():
            d_ref = want - p0[name]
            d_got = got_p[name] - p0[name]
            err = np.linalg.norm(d_got - d_ref) / max(
                np.linalg.norm(d_ref), 1e-30)
            assert err < 1e-3, (name, err)
        # ZeRO-1: the rank holds its opt_state_sharding block of m
        mesh = sh.MeshShape(("pod", "data", "model") if mt == "pod"
                            else ("data", "model"),
                            (2, 2, 1) if mt == "pod" else (dp, m))
        for name, shape in m_shapes.items():
            whole = params[name].shape
            spec = sh._zero1(sh.param_spec(name, whole, mesh, cfg), whole,
                             mesh)
            want = tuple(d // sh.axis_size(mesh, e) if e is not None else d
                         for d, e in zip(whole, spec))
            assert shape == want, (name, shape, want)
        assert any(s != params[n].shape for n, s in m_shapes.items())


def test_tp_moe_train_steps_match_single_process(world, no_mesh_moe):
    """Expert-parallel steps of olmoe-1b-7b (the batch whole on every DP
    rank, so capacity is the global step's) against the port's
    single-process steps."""
    _, out = world
    _, losses, params = no_mesh_moe
    for res in out:
        got_l, _, _, got_p = res["train_olmoe-1b-7b_22"]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        for name, v in params.items():
            np.testing.assert_allclose(got_p[name], v, rtol=1e-3, atol=1e-6)


def test_elastic_tp_zero1_restore_for_mesh_resumes(world, tmp_path):
    """(2, 2) with TP and ZeRO-1, two steps, saved whole; restored onto
    (4, 1) by ``restore_for_mesh`` (DTensors, fed to the step as they
    are), two more steps: the uninterrupted run's losses within the
    reference's rtol 2e-2 (here they agree to float error)."""
    from repro_torch.optim import make_optimizer
    _, out = world
    cfg = get_arch("granite-3-2b").reduced().replace(dtype="float32")
    res = driver.train_loop(cfg, TRAIN, total_steps=4,
                            ckpt_dir=str(tmp_path), ckpt_every=1000,
                            device="cpu", backend="reference",
                            print_fn=lambda *a: None,
                            optimizer=make_optimizer(cfg, warmup=1))
    for r in out:
        first, rest = r["elastic"]
        assert r["elastic_dtensor"]
        assert len(first) == 2 and len(rest) == 2
        np.testing.assert_allclose(first + rest, res.losses, rtol=2e-2)
        np.testing.assert_allclose(first + rest, res.losses, rtol=1e-5)


def test_every_rank_issued_the_same_collectives(world):
    _, out = world
    counts = out[0]["collectives"]
    assert all(res["collectives"] == counts for res in out)
    assert {"all_reduce/tp_out", "all_reduce/embed", "all_gather/logits",
            "all_gather/k_cols", "all_gather/prefill_kv",
            "all_reduce/moe_combine", "reduce_scatter/grads",
            "all_gather/params", "all_reduce/grad_norm",
            "all_reduce/lse_sum", "all_reduce/tp_in_grad",
            "all_gather/checkpoint"} <= set(counts), sorted(counts)
