"""A "model" axis that splits a head: the port against the reference.

The reference's rule (``param_spec``) column-shards ``wq`` and row-shards
``wo`` whenever M divides nh·hd, also where M does not divide nh: a
rank's block then cuts a head.  The port's rank gathers q over "model",
runs every head its block touches and keeps its columns of their output
(``distributed.tp.HeadLayout.split``); Mamba2 runs the SSD heads its
``out_proj`` row block touches (``SSMLayout.split``).

* The layouts, without a process group: the touched heads, the column
  window, the kv heads each query head reads, the state heads.
* One gloo world of 4 processes, spawned once for the module (the
  workers import torch and the port only, ``torch.set_num_threads(1)``),
  on (1, 4) and (2, 2), while the references run in this process, on
  three reduced float32 configs: "mqa6" (6 query heads of 32 dims, one
  kv head), "gqa10" (10 query heads of 16 over 5 kv heads: at M = 4 a
  block touches 3 heads that read 2 kv heads unevenly, and at M = 2
  whole blocks of 5 heads do) and "ssm6" (Mamba2 with 6 SSD heads):

  - three tensor-parallel AdamW steps against the reference's
    ``make_train_step`` on the whole batch (losses within 1e-5
    relative, each leaf's Δp within 1e-3 relative L2);
  - greedy serving on the reference conformance test's staggered
    schedule: slab serving of each config, and the decomposed-KV slab
    and paged engines of "gqa10", token-equal to the reference's
    one-device engine.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa
from repro.distributed import sharding as jsh  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TRAIN = ShapeSpec("t", 16, 4, "train")
TRAIN_STEPS = 3
RANK, TAIL, SLOTS, MAX_LEN, MAX_NEW = 8, 4, 4, 64, 10
PROMPT_LENS = (12, 7, 15)            # the reference conformance test's
# tag → (arch, config overrides, meshes)
CASES = {
    "mqa6": ("granite-3-2b", dict(num_heads=6, num_kv_heads=1,
                                  head_dim=32), ("14",)),
    "gqa10": ("granite-3-2b", dict(num_heads=10, num_kv_heads=5,
                                   head_dim=16), ("14", "22")),
    "ssm6": ("mamba2-780m", dict(d_model=96), ("14",)),
}


def _cfgs(tag):
    arch, over, _ = CASES[tag]
    return (all_archs()[arch].reduced().replace(dtype="float32", **over),
            get_arch(arch).reduced().replace(dtype="float32", **over))


@pytest.mark.parametrize("geom, m, want", [
    # (nh, kvh, hd), M → per rank (q0, nh_l, k0, kvh_l, kv_index, o0, ow)
    ((6, 1, 32), 4, [(0, 2, 0, 1, None, 0, 48), (1, 2, 0, 1, None, 16, 48),
                     (3, 2, 0, 1, None, 0, 48), (4, 2, 0, 1, None, 16, 48)]),
    ((10, 5, 16), 4, [(0, 3, 0, 2, (0, 0, 1), 0, 40),
                      (2, 3, 1, 2, (0, 0, 1), 8, 40),
                      (5, 3, 2, 2, (0, 1, 1), 0, 40),
                      (7, 3, 3, 2, (0, 1, 1), 8, 40)]),
    ((10, 5, 16), 2, [(0, 5, 0, 3, (0, 0, 1, 1, 2), 0, 80),
                      (5, 5, 2, 3, (0, 1, 1, 2, 2), 0, 80)]),
    ((8, 1, 256), 16, [(r // 2, 1, 0, 1, None, 128 * (r % 2), 128)
                       for r in range(16)]),          # gemma-2b
])
def test_head_layout_splits_heads(geom, m, want):
    """The touched query heads, the kv heads they read (per query head
    where a block reads them unevenly) and the rank's column window of
    their output, which tile nh·hd once over the ranks."""
    nh, kvh, hd = geom
    cfg = get_arch("granite-3-2b").reduced().replace(
        num_heads=nh, num_kv_heads=kvh, head_dim=hd)
    cols = []
    for r in range(m):
        lay = TP.head_layout(cfg, TP.TP(None, None, m, r))
        assert (lay.q0, lay.nh_l, lay.k0, lay.kvh_l, lay.kv_index, lay.o0,
                lay.ow) == want[r]
        assert lay.split == (nh % m != 0) and not lay.aligned
        cols.append((lay.q0 * hd + lay.o0, lay.ow))
    assert cols == [(r * nh * hd // m, nh * hd // m) for r in range(m)]


def test_starcoder2_layout_at_the_references_model_axis():
    """starcoder2-7b at M = 16: 288 columns a rank, 2.25 heads of a group
    of 9; the cache is sharded on head_dim (4 kv heads)."""
    cfg = get_arch("starcoder2-7b")
    for r in range(16):
        lay = TP.head_layout(cfg, TP.TP(None, None, 16, r))
        assert lay.split and lay.cache == -1 and lay.ow == 288
        assert lay.nh_l == 3 and lay.q0 * 128 + lay.o0 == r * 288


@pytest.mark.parametrize("d_model", [96, 80, 128])
def test_ssm_layout_splits_heads(d_model):
    """Mamba2 with 6, 5 and 8 SSD heads of 32 at M = 4: each rank runs
    the heads its out_proj row block touches (its own block of heads
    when M divides them), and the rows tile d_inner once."""
    cfg = get_arch("mamba2-780m").reduced().replace(d_model=d_model)
    hd, di, m = cfg.ssm_head_dim, cfg.d_inner, 4
    rows = []
    for r in range(m):
        lay = TP.ssm_layout(cfg, TP.TP(None, None, m, r))
        assert lay.split == (cfg.ssm_heads % m != 0)
        assert lay.h0 == lay.x0 // hd
        assert lay.h0 * hd <= lay.x0 and \
            lay.x0 + lay.di_l <= (lay.h0 + lay.nh_l) * hd
        assert (lay.xc0, lay.xcw) == (lay.h0 * hd, lay.nh_l * hd)
        rows.append((lay.x0, lay.di_l))
    assert rows == [(r * di // m, di // m) for r in range(m)]


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
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import steps
    from repro_torch.serving import Engine, Request
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"14": M.make_host_mesh(1, 4, "cpu"),
              "22": M.make_host_mesh(2, 2, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
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
        return {r.uid: list(r.out_tokens) for r in done}

    for tag, (arch, over, mts) in IN["cases"].items():
        cfg = get_arch(arch).reduced().replace(dtype="float32", **over)
        src = SyntheticLM(cfg, IN["train_shape"], DataConfig())
        for mt in mts:
            mesh = meshes[mt]
            opt = make_optimizer(cfg, warmup=1)
            p = tree(tag)
            p, o = steps.shard_train_state(cfg, p, opt.init(p), mesh,
                                           optimizer=opt)
            fn = steps.make_train_step(cfg, opt, mesh=mesh,
                                       backend="reference")
            losses = []
            for s in range(IN["train_steps"]):
                b = {k: torch.from_numpy(v).long()
                     for k, v in src.batch_at(s).items()}
                p, o, met = fn(p, o, b)
                losses.append(float(met["loss"]))
            wp, _ = steps.whole_train_state(cfg, p, o, mesh, optimizer=opt)
            out[f"train_{tag}_{mt}"] = (losses, {n: v.numpy() for n, v in
                                                 named_leaves(wp)})
            recipes = [("slab", {}, 0)]
            if tag == "gqa10":
                recipes += [("dkv", {}, IN["rank"]),
                            ("paged", {"paged": True}, IN["rank"])]
            for name, kw, r in recipes:
                ec = EngineConfig(kv_rank=r, kv_tail=IN["tail"], kv_page=4,
                                  mesh=mesh)
                z0 = IN["z0"][tag]
                eng = Engine(cfg, tree(tag), slots=IN["slots"],
                             max_len=IN["max_len"], device="cpu",
                             decompose_engine=DecomposeEngine(
                                 ec, z0=lambda h: z0), **kw)
                out[f"serve_{tag}_{mt}_{name}"] = run(eng, IN["staggered"])
                out[f"folds_{tag}_{mt}_{name}"] = eng.stats.tail_folds
                del eng
    out["collectives"] = sh.collective_counts()
    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


@pytest.fixture(scope="module")
def models():
    """tag → (reference cfg, reference params, port cfg, port params):
    the reference's float32 init, and the port's copy."""
    out = {}
    for tag in CASES:
        jcfg, tcfg = _cfgs(tag)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out[tag] = (jcfg, jp, tcfg, tp)
    return out


@pytest.fixture(scope="module")
def world_inputs(models, tmp_path_factory):
    """The workers' inputs, and the four workers started on them."""
    d = str(tmp_path_factory.mktemp("splitworld"))
    prompts = _prompts(models["mqa6"][2].vocab, PROMPT_LENS, 0)
    IN = {"staggered": {3 * i: [(i, p)] for i, p in enumerate(prompts)},
          "rank": RANK, "tail": TAIL, "slots": SLOTS, "max_len": MAX_LEN,
          "max_new": MAX_NEW, "train_shape": TRAIN,
          "train_steps": TRAIN_STEPS, "cases": CASES, "z0": {}}
    for tag, (_, _, tcfg, tp) in models.items():
        IN[tag + "_template"] = tp
        IN[tag] = {n: v.numpy().copy() for n, v in named_leaves(tp)}
        if tcfg.family == "dense":
            w = tcfg.kv_width
            IN["z0"][tag] = np.asarray(_padded_z0(w, w))
        else:
            IN["z0"][tag] = None
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


def _run(eng, arrivals):
    n = sum(len(v) for v in arrivals.values())
    done = []
    for step in range(300):
        for uid, p in arrivals.get(step, []):
            eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
        done.extend(eng.step())
        if len(done) == n and not any(eng.live) and not len(eng.sched):
            break
    assert sorted(r.uid for r in done) == list(range(n))
    return {r.uid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def reference(world_inputs, models):
    """The reference's three whole-batch train steps from the same
    parameters (losses, final parameters by path) and its one-device
    engine's tokens (slab, and decomposed KV for "gqa10"), computed
    while the workers run."""
    IN = world_inputs[0]
    out = {}
    for tag, (jcfg, jp, _, _) in models.items():
        p = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), jp)
        opt = jmake_optimizer(jcfg, warmup=1)
        st = opt.init(p)
        fn = jax.jit(jsteps.make_train_step(jcfg, opt))
        src = JSynth(jcfg, JShape("t", TRAIN.seq_len, TRAIN.global_batch,
                                  "train"), JData())
        losses = []
        for s in range(TRAIN_STEPS):
            p, st, m = fn(p, st, src.batch_at(s))
            losses.append(float(m["loss"]))
        out["train_" + tag] = (losses, {
            jsh._path_str(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]})
        out["serve_" + tag + "_slab"] = _run(
            JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN),
            IN["staggered"])
        if tag == "gqa10":
            out["serve_gqa10_dkv"] = _run(JEngine(
                jcfg, jp, slots=SLOTS, max_len=MAX_LEN,
                decompose_kv_rank=RANK, dkv_tail=TAIL,
                decompose_engine=JDecomposeEngine(JEngineConfig(
                    kv_rank=RANK, kv_tail=TAIL))), IN["staggered"])
    return out


@pytest.fixture(scope="module")
def world(world_inputs, reference):
    IN, procs, d = world_inputs
    logs = [p.communicate(timeout=900)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return IN, out


TRAIN_CELLS = [f"{t}/{m}" for t, (_, _, ms) in CASES.items() for m in ms]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_split_head_train_steps_match_reference(world, models, reference,
                                                cell):
    tag, mt = cell.split("/")
    _, out = world
    losses, params = reference["train_" + tag]
    p0 = {n: v.numpy() for n, v in named_leaves(models[tag][3])}
    for res in out:
        got_l, got_p = res[f"train_{tag}_{mt}"]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        for name, want in params.items():
            d_ref = want - p0[name]
            d_got = got_p[name] - p0[name]
            err = np.linalg.norm(d_got - d_ref) / max(
                np.linalg.norm(d_ref), 1e-30)
            assert err < 1e-3, (name, err)


SERVE_CELLS = [f"{t}/{m}/slab" for t, (_, _, ms) in CASES.items()
               for m in ms] + ["gqa10/14/dkv", "gqa10/14/paged",
                               "gqa10/22/dkv", "gqa10/22/paged"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_split_head_serving_equals_reference(world, reference, cell):
    """Every rank's greedy tokens equal the reference's one-device
    engine's (the decomposed-KV engines fold their tails)."""
    tag, mt, name = cell.split("/")
    _, out = world
    want = reference[f"serve_{tag}_{'slab' if name == 'slab' else 'dkv'}"]
    for res in out:
        assert res[f"serve_{tag}_{mt}_{name}"] == want
        if name != "slab":
            assert res[f"folds_{tag}_{mt}_{name}"] > 0


def test_split_heads_gather_q_and_every_rank_issued_the_same(world):
    _, out = world
    counts = out[0]["collectives"]
    assert all(res["collectives"] == counts for res in out)
    assert {"all_gather/q_cols", "reduce_scatter/q_cols_grad",
            "all_reduce/gated_norm"} <= set(counts), sorted(counts)
