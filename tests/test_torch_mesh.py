"""The "data" axis of distribution: the port against the reference.

* The sharding rules (``repro_torch.distributed.sharding``) equal
  ``repro.distributed.sharding``'s leaf for leaf on the abstract meshes
  (16, 16), (2, 16, 16) with "pod", and (2, 4): every family's reduced
  parameter and optimizer trees (moe with ``expert_sharding`` "1d" and
  "2d"), batch leaves, every family's decode cache and the slab and
  paged decomposed-KV caches (``seq_shard`` on and off), and the token
  specs; ``placements`` gets a case per rule branch.  No process group.
* One gloo world of 4 processes, spawned once for the module (the
  workers import torch and the port only: this process has JAX
  initialized), runs on meshes (4, 1), (2, 2) and the pod mesh
  (2, 2, 1): the DP-sharded decomposition against the unsharded call and
  the reference's ``DecomposeEngine`` (a batch that divides and one that
  does not); float32 ``deepseek-7b``
  decomposed-KV serving at rank 8, tail 4 and 8 slots on the reference
  conformance test's staggered schedule, slab and paged (page 4), and
  the 8-at-once batched admission, whose tokens must equal the port's
  no-mesh engine and the reference's 1-device engine, with tail folds
  and every page back on every rank; float32 ``mamba2-780m`` staggered
  against the port's and the reference's 1-device engines;
  async ``"deterministic"`` equal to sync and ``"ready"`` finishing
  everything; ``restore_for_mesh`` of a checkpoint saved without a mesh
  onto (4, 1) and (2, 2); three DP train steps of float32
  ``granite-3-2b`` at global batch 4, plain and with PowerSGD (the
  reference's Q), against the port's single-process step on the whole
  batch (1e-5 relative) and the reference's ``make_train_step`` on it,
  PowerSGD's first synced round trip against the reference's
  ``compress_decompress`` of the whole-batch gradient; DP steps resumed
  from ``restore_for_mesh`` through ``driver.unshard``; an expert
  config's DP steps on the whole batch; every rank's counted
  collectives equal; and the ssm family on a "model" axis > 1: its
  (2, 2) engine and train step build and give the no-mesh tokens and
  loss (tensor parallelism; ``tests/test_torch_tp_families.py`` holds
  it against the reference).  A "model" axis without a process group is
  refused before any collective.
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
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge, checkpoint  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import decomposed_kv as DK  # noqa: E402
from repro_torch.models.api import SlotShard, model_fns  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import driver, steps  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# (a) the rules, on abstract meshes
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
ARCHS = ("llama2-7b", "mamba2-780m", "olmoe-1b-7b", "kimi-k2-1t-a32b",
         "zamba2-1.2b", "llama-3.2-vision-11b", "seamless-m4t-medium")


def _meshes(key):
    sizes, names = MESHES[key]
    return AbstractMesh(sizes, names), sh.MeshShape(names, sizes)


def _ref_named(tree):
    return {jsh._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_named(spec_tree, template):
    """name → Spec (a Spec is a tuple: walk the template's structure)."""
    out = {}
    for name, _ in named_leaves(template):
        node = spec_tree
        for part in name.split("/"):
            node = node[part]
        out[name] = node
    return out


def _specs_of(named_sharding_tree):
    return {k: tuple(v.spec) for k, v in
            _ref_named(named_sharding_tree).items()}


@pytest.fixture(scope="module")
def trees():
    """Per arch: (reference cfg, port cfg, reference params and optimizer
    shapes, port params and optimizer state on the meta device)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = all_archs()[arch].reduced(), get_arch(arch).reduced()
        jp = jax.eval_shape(lambda k: jmodel_fns(jcfg).init(k, jcfg),
                            jax.random.PRNGKey(0))
        jo = jax.eval_shape(jmake_optimizer(jcfg).init, jp)
        tp = model_fns(tcfg).init(tcfg, torch.Generator(), device="meta")
        to = make_optimizer(tcfg).init(tp)
        out[arch] = (jcfg, tcfg, jp, jo, tp, to)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(trees, arch, mesh):
    jcfg, tcfg, jp, jo, tp, to = trees[arch]
    assert tcfg.expert_sharding == jcfg.expert_sharding
    amesh, pmesh = _meshes(mesh)
    want = _specs_of(jsh.params_sharding(jp, amesh, jcfg))
    got_p = _port_named(sh.params_sharding(tp, pmesh, tcfg), tp)
    assert got_p == want
    for zero1 in (True, False):
        want = _specs_of(jsh.opt_state_sharding(jo, amesh, jcfg,
                                                zero1=zero1))
        got = _port_named(sh.opt_state_sharding(to, pmesh, tcfg,
                                                zero1=zero1), to)
        assert got == want, zero1
    # the trees were not trivially replicated everywhere
    if mesh == "2x4":
        assert any(any(e is not None for e in s) for s in got_p.values())


def _cache_trees(tcfg):
    """(name, tree) of the decode caches a serving engine of ``tcfg``
    builds: the family's, and for dense configs the slab and paged
    decomposed-KV caches; at 16 slots and at 1."""
    out = []
    for b in (16, 1):
        out.append((f"family/{b}", model_fns(tcfg).init_cache(
            tcfg, b, 64, device="meta")))
        if tcfg.family == "dense":
            out.append((f"dkv/{b}", DK.init_cache(tcfg, b, 32, 8, tail=16,
                                                  device="meta")))
            out.append((f"paged/{b}", DK.init_paged_cache(
                tcfg, b, 33, 16, 8, 17, device="meta")))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    tcfg = get_arch(arch).reduced()
    amesh, pmesh = _meshes(mesh)
    names = set()
    for tag, cache in _cache_trees(tcfg):
        for seq in (True, False):
            got = _port_named(sh.cache_sharding(cache, pmesh, tcfg,
                                                seq_shard=seq), cache)
            for name, leaf in named_leaves(cache):
                shape = tuple(leaf.shape)
                want = tuple(jsh.cache_pspec(name, shape, amesh,
                                             seq_shard=seq))
                assert tuple(got[name]) == want, (tag, name, shape, seq)
                assert tuple(sh.cache_pspec(name, shape, pmesh, seq)) \
                    == want
                names.add(name.rsplit("/", 1)[-1])
    if tcfg.family == "dense":
        assert {"k", "v", "k_u", "v_u", "k_vt", "v_vt", "k_u_pages",
                "v_u_pages", "k_pages", "v_pages"} <= names
    if tcfg.family in ("ssm", "hybrid"):
        assert {"conv", "ssm"} <= names


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_token_specs_match_reference(mesh):
    amesh, pmesh = _meshes(mesh)
    shapes = {"tokens": (32, 16), "labels": (1, 64), "odd": (3, 5),
              "frames": (64, 32, 8), "scalar": (7,), "one": (1, 3)}
    jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    tb = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    want = _specs_of(jsh.batch_sharding(jb, amesh))
    assert _port_named(sh.batch_sharding(tb, pmesh), tb) == want
    for b in (1, 2, 7, 16, 32, 64):
        assert tuple(sh.token_sharding(pmesh, b)) == tuple(
            jsh.token_sharding(amesh, b).spec)
    assert tuple(sh.replicated(pmesh)) == tuple(jsh.replicated(amesh).spec)
    assert sh.dp_name(pmesh) == jsh.dp_name(amesh)
    assert sh.dp_axes(pmesh) == jsh.dp_axes(amesh)


def test_placements_per_rule_branch():
    from torch.distributed.tensor import Replicate, Shard
    dm = sh.MeshShape(("data", "model"), (2, 4))
    pod = sh.MeshShape(("pod", "data", "model"), (2, 2, 2))
    R = Replicate()
    cases = [
        (sh.Spec(), dm, (R, R)),                               # replicated
        (sh.Spec("model", None), dm, (R, Shard(0))),           # embed rows
        (sh.Spec(None, None, "model"), dm, (R, Shard(2))),     # column
        (sh.Spec(None, "model", None), dm, (R, Shard(1))),     # row
        (sh.Spec(None, "model", None, "data"), dm,
         (Shard(3), Shard(1))),                                # 2-D expert
        (sh.Spec("data", None), dm, (Shard(0), R)),            # batch / ZeRO
        (sh.Spec(None, "data", "model"), dm,
         (Shard(1), Shard(2))),                                # seq-sharded
        (sh.Spec(("pod", "data"), None, "model"), pod,
         (Shard(0), Shard(0), Shard(2))),                      # DP super-axis
        (sh.Spec(None, ("pod", "data")), pod, (Shard(1), Shard(1), R)),
    ]
    for spec, mesh, want in cases:
        assert sh.placements(spec, mesh) == want, spec
    # the rules' own outputs: a ZeRO-1 moment and a slot-sharded cache leaf
    m = torch.empty(2, 64, 128, device="meta")
    spec = sh.opt_state_sharding({"m": {"layers": {"up": {"w": m}}}},
                                 dm, get_arch("llama2-7b").reduced())
    assert sh.placements(spec["m"]["layers"]["up"]["w"], dm) == \
        (Shard(0), Shard(2))
    kv = sh.cache_pspec("tail/k", (2, 8, 4, 2, 32), dm, seq_shard=False)
    assert sh.placements(kv, dm) == (Shard(1), Shard(4))   # kvh 2: hd
    u = sh.cache_pspec("k_u", (2, 1, 8, 8), dm, seq_shard=True)
    assert sh.placements(u, dm) == (Shard(2), R)           # batch 1: T


def test_slot_shard_arithmetic():
    """Without a mesh every slot is held; the reference's batch rule
    (dp divides and slots > 1) decides the block a rank holds."""
    s = SlotShard(8)
    assert (s.first, s.n, s.sharded) == (0, 8, False)
    a = np.arange(8)
    assert s.take(a) is a
    assert s.pairs([5, 2]) == ([5, 2], [0, 1])


class _FakeMesh:
    """Names and sizes of a mesh, without a process group."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = names
        self.mesh = np.zeros(sizes)


def test_model_axis_refused_without_a_group():
    """Every family runs a "model" axis > 1, over the mesh's process
    groups: a mesh of names and sizes without them (here the ssm
    family's, M = 2) is refused by serving and by the train step before
    any collective, naming the missing process group; a mesh without a
    "data" axis is refused by ``EngineConfig``."""
    cfg = get_arch("mamba2-780m").reduced().replace(dtype="float32")
    params = model_fns(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    mesh = _FakeMesh(("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="no process group"):
        Engine(cfg, params, slots=2, max_len=32, device="cpu",
               decompose_engine=DecomposeEngine(EngineConfig(mesh=mesh)))
    with pytest.raises(ValueError, match="no process group"):
        steps.make_train_step(cfg, mesh=mesh, backend="reference")
    with pytest.raises(ValueError, match="data"):
        EngineConfig(mesh=_FakeMesh(("x", "y"), (1, 1)))


# ---------------------------------------------------------------------------
# (b) one gloo world of 4
# ---------------------------------------------------------------------------

WORLD = 4
RANK, TAIL, SLOTS, MAX_LEN, MAX_NEW = 8, 4, 8, 64, 12
MESH_PROMPT_LENS = (12, 7, 15)       # the reference conformance test's
PSGD = dict(rank=2, min_elems=4096)

_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    from repro_torch.launch import mesh as M
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import compression as comp, sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models.api import model_fns
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import driver, steps
    from repro_torch.serving import Engine, Request
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    m41 = M.make_host_mesh(4, 1, "cpu")
    m22 = M.make_host_mesh(2, 2, "cpu")
    pod = M.make_pod_mesh(2, 2, 1, "cpu")
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    Z0 = lambda h: IN["z0"][h]
    out = {"host": tuple(M.parse_mesh("host", "cpu").mesh.shape),
           "dp": [sh.dp_rank(m) for m in (m41, pod)]}
    try:
        M.parse_mesh("3x1", "cpu")
    except ValueError as e:
        out["bad_mesh"] = str(e)

    for tag, mesh in (("41", m41), ("pod", pod)):
        de = DecomposeEngine(EngineConfig(mesh=mesh), z0=Z0)
        for b in (8, 6):
            lr = de.decompose(torch.from_numpy(IN["x"][:b]), 4, iters=8)
            out[f"dec_{tag}_{b}"] = (lr.u.numpy(), lr.core.numpy(),
                                     lr.vt.numpy())

    tcfg = get_arch("deepseek-7b").reduced().replace(dtype="float32")
    params = rebuild(IN["template"], {n: torch.from_numpy(v)
                                      for n, v in IN["dense"].items()})

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

    def dkv(mesh=m41, **kw):
        ec = EngineConfig(kv_rank=IN["rank"], kv_tail=IN["tail"], kv_page=4,
                          mesh=mesh)
        return Engine(tcfg, params, slots=IN["slots"], max_len=64,
                      device="cpu",
                      decompose_engine=DecomposeEngine(ec, z0=Z0), **kw)

    stag = IN["staggered"]
    for tag, kw in (("slab", {}), ("paged", {"paged": True}),
                    ("async_det", {"prefill_async": True,
                                   "ready_order": "deterministic"}),
                    ("async_ready", {"prefill_async": True,
                                     "ready_order": "ready"})):
        eng = dkv(**kw)
        out[tag] = run(eng, stag)
        out[tag + "_folds"] = eng.stats.tail_folds
        out[tag + "_shard"] = (eng.shard.first, eng.shard.n)
        if eng.pager is not None:
            pg = eng.pager
            out["paged_back"] = (pg.alloc.free_pages, pg.num_pages - 1,
                                 pg.talloc.free_pages,
                                 pg.num_tail_pages - 1)
            out["paged_local"] = tuple(pg.cache["k_vt"].shape)
        else:
            out[tag + "_local"] = tuple(eng.cache["k_u"].shape)
    out["batched"] = run(dkv(), {0: list(enumerate(IN["many"]))})

    # fused blocks of 4 with a stop token: a rank whose slots sample no
    # stop runs past the block's end and undoes it
    from repro_torch.serving import families as F
    undo = F.TransformerDKVServing.undo_overrun
    undone = []

    def counting(self, steps, ran):
        undone.append(ran - steps)
        return undo(self, steps, ran)
    F.TransformerDKVServing.undo_overrun = counting
    eos = out["slab"][0][5]
    for tag, kw in (("eos_slab", {}), ("eos_paged", {"paged": True})):
        eng = dkv(decode_block=4, eos_id=eos, **kw)
        out[tag] = run(eng, stag)
        out[tag + "_stopped"] = eng.stats.stopped_eos
    out["undone"] = sum(undone)
    out["eos"] = eos
    from repro_torch.sampling import categorical_sampler
    out["keyed"] = run(dkv(decode_block=4,
                           sampler=categorical_sampler(0.8),
                           sample_seed=3), stag)

    mcfg = get_arch("mamba2-780m").reduced().replace(dtype="float32")
    mp = rebuild(IN["mamba_template"], {n: torch.from_numpy(v)
                                        for n, v in IN["mamba"].items()})
    eng = Engine(mcfg, mp, slots=IN["slots"], max_len=64, device="cpu",
                 decompose_engine=DecomposeEngine(EngineConfig(mesh=m41)))
    out["mamba2"] = run(eng, stag)
    out["mamba2_local"] = tuple(eng.cache["ssm"].shape)
    del eng
    # its state cannot be rewound: fused blocks with a stop token run one
    # step at a time on the mesh (the stop: request 0's fourth token)
    def mamba(**kw):
        return Engine(mcfg, mp, slots=IN["slots"], max_len=64, device="cpu",
                      decompose_engine=DecomposeEngine(EngineConfig(
                          mesh=m41)), **kw)
    meos = run(mamba(), {0: list(enumerate(IN["many"]))})[0][3]
    eng = mamba(decode_block=4, eos_id=meos)
    out["mamba2_eos"] = run(eng, {0: list(enumerate(IN["many"]))})
    out["mamba2_eos_blocks"] = (eng.stats.blocks, eng.stats.decode_steps)
    out["meos"] = meos
    del eng

    # the ssm family on the model axis: a (2, 2) engine and train step
    eng = Engine(mcfg, mp, slots=IN["slots"], max_len=64, device="cpu",
                 decompose_engine=DecomposeEngine(EngineConfig(mesh=m22)))
    out["model_serve"] = run(eng, stag)
    out["model_serve_ssm"] = tuple(eng.cache["ssm"].shape)
    del eng
    mopt = make_optimizer(mcfg, warmup=1)
    mp22 = rebuild(IN["mamba_template"], {n: torch.from_numpy(v.copy())
                                          for n, v in IN["mamba"].items()})
    mp22, mo22 = steps.shard_train_state(mcfg, mp22, mopt.init(mp22), m22,
                                         optimizer=mopt)
    fn = steps.make_train_step(mcfg, mopt, mesh=m22, backend="reference")
    msrc = SyntheticLM(mcfg, ShapeSpec("t", 16, 4, "train"), DataConfig())
    _, _, met = fn(mp22, mo22, {k: torch.from_numpy(v).long()
                                for k, v in msrc.batch_at(0).items()})
    out["model_train"] = (float(met["loss"]),
                          tuple(mp22["layers"]["ssd"]["in_proj"]["w"].shape))
    del mp22, mo22

    for tag, mesh in (("41", m41), ("22", m22)):
        st = driver.restore_for_mesh(IN["ckpt_cfg"], IN["ckpt_dir"], mesh)
        out["restore_" + tag] = {
            n: (leaf.full_tensor().float().numpy(),
                tuple(leaf.placements), tuple(leaf.to_local().shape))
            for n, leaf in named_leaves(st)}

    gcfg = get_arch("granite-3-2b").reduced().replace(dtype="float32")
    src = SyntheticLM(gcfg, ShapeSpec("t", 16, 4, "train"), DataConfig())

    class Recording(comp.PowerSGD):
        first = None

        def __call__(self, grads):
            got = super().__call__(grads)
            if self.first is None:
                self.first = {n: g.clone().numpy()
                              for n, g in named_leaves(got)}
            return got

    def batch_at(s, src=src):
        return {k: torch.from_numpy(v).long()
                for k, v in src.batch_at(s).items()}

    def train(cfg, p, o, tr, first, last, tag):
        fn = steps.make_train_step(cfg, grad_transform=tr, mesh=m41,
                                   backend="reference")
        losses = []
        for s in range(first, last):
            p, o, met = fn(p, o, batch_at(s))
            losses.append(float(met["loss"]))
        out["train_" + tag] = (losses, {n: v.clone().numpy()
                                        for n, v in named_leaves(p)})
        return p, o

    for tag in ("plain", "powersgd"):
        p, o = steps.init_train_state(gcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        tr = Recording(p, comp.PowerSGDConfig(**IN["psgd"]),
                       group=sh.dp_group(m41), q=IN["psgd_q"]) \
            if tag == "powersgd" else None
        train(gcfg, p, o, tr, 0, 3, tag)
        if tr is not None:
            out["psgd_first"] = tr.first

    # one DP step, a checkpoint, restore_for_mesh, two more steps
    import torch.distributed as dist
    p, o = steps.init_train_state(gcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    p, o = train(gcfg, p, o, None, 0, 1, "first")
    ck = os.path.join(d, "resume")
    if rank == 0:
        from repro_torch import checkpoint
        checkpoint.save({"params": p, "opt": o}, ck, 1)
    dist.barrier()
    st = driver.unshard(driver.restore_for_mesh(gcfg, ck, m41))
    out["resumed_plain"] = all(type(t) is torch.Tensor
                               for _, t in named_leaves(st))
    train(gcfg, st["params"], st["opt"], None, 1, 3, "resumed")

    # experts: the whole batch on every rank (capacity binds at cf 1)
    ecfg = get_arch("olmoe-1b-7b").reduced().replace(dtype="float32",
                                                     capacity_factor=1.0)
    esrc = SyntheticLM(ecfg, ShapeSpec("t", 16, 4, "train"), DataConfig())
    p, o = steps.init_train_state(ecfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    fn = steps.make_train_step(ecfg, mesh=m41, backend="reference")
    losses = []
    for s in range(2):
        p, o, met = fn(p, o, batch_at(s, esrc))
        losses.append(float(met["loss"]))
    out["train_moe"] = (losses, {n: v.numpy() for n, v in named_leaves(p)})
    out["collectives"] = sh.collective_counts()

    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


@pytest.fixture(scope="module")
def f32():
    jcfg = all_archs()["deepseek-7b"].reduced().replace(dtype="float32")
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tcfg = get_arch("deepseek-7b").reduced().replace(dtype="float32")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def mamba():
    """float32 reduced mamba2-780m: the reference's init, and the port's
    copy of it."""
    jcfg = all_archs()["mamba2-780m"].reduced().replace(dtype="float32")
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tcfg = get_arch("mamba2-780m").reduced().replace(dtype="float32")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def granite():
    """float32 reduced granite-3-2b for the DP train steps: (port cfg,
    reference cfg, the port's initial params, the reference's copy of
    them, the reference's PowerSGD state on them, and its Q as numpy)."""
    tcfg = get_arch("granite-3-2b").reduced().replace(dtype="float32")
    jcfg = all_archs()["granite-3-2b"].reduced().replace(dtype="float32")
    p0, _ = steps.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    jp = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                bridge.to_numpy(p0))
    jst = jcomp.init_state(jp, jcomp.PowerSGDConfig(**PSGD))
    qs = jax.tree_util.tree_map(
        lambda s: None if s["q"] is None else np.asarray(s["q"]), jst,
        is_leaf=lambda x: isinstance(x, dict) and "q" in x)
    return tcfg, jcfg, p0, jp, jst, qs


@pytest.fixture(scope="module")
def world(f32, mamba, granite, tmp_path_factory):
    """Every rank's results of the worker script (started at once; the
    caller's references are computed meanwhile by the tests)."""
    d = str(tmp_path_factory.mktemp("world4"))
    jcfg, _, tcfg, tp = f32
    ccfg = get_arch("llama2-7b").reduced()
    ps, os_ = steps.init_train_state(ccfg, torch.Generator().manual_seed(5),
                                     device="cpu")
    ckdir = os.path.join(d, "ck")
    checkpoint.save({"params": ps, "opt": os_}, ckdir, 0)
    vocab = jcfg.vocab
    prompts = _prompts(vocab, MESH_PROMPT_LENS, 0)
    IN = {"z0": {h: np.asarray(_padded_z0(h, h)) for h in (tcfg.kv_width,
                                                            40)},
          "template": tp,
          "dense": {n: v.numpy().copy() for n, v in named_leaves(tp)},
          "staggered": {3 * i: [(i, p)] for i, p in enumerate(prompts)},
          "many": _prompts(vocab, (12,) * SLOTS, 1),
          "x": np.random.RandomState(3).randn(8, 24, 40).astype(np.float32),
          "ckpt_cfg": ccfg, "ckpt_dir": ckdir, "rank": RANK, "tail": TAIL,
          "slots": SLOTS, "max_new": MAX_NEW, "psgd": PSGD,
          "psgd_q": granite[5], "mamba_template": mamba[3],
          "mamba": {n: v.numpy().copy() for n, v in named_leaves(mamba[3])}}
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
    logs = [p.communicate(timeout=600)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return IN, out, ps, os_


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
    return {r.uid: r.out_tokens for r in done}


def _port_dkv(f32, IN, **kw):
    _, _, tcfg, tp = f32
    ec = EngineConfig(kv_rank=RANK, kv_tail=TAIL, kv_page=4)
    return Engine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                  decompose_engine=DecomposeEngine(
                      ec, z0=lambda h: IN["z0"][h]), **kw)


def _jax_dkv(f32, **kw):
    jcfg, jp, _, _ = f32
    return JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN,
                   decompose_kv_rank=RANK, dkv_tail=TAIL,
                   decompose_engine=JDecomposeEngine(JEngineConfig(
                       kv_rank=RANK, kv_tail=TAIL, kv_page=4)), **kw)


def test_world_meshes(world):
    _, out, _, _ = world
    for r, res in enumerate(out):
        assert res["host"] == (WORLD, 1)
        assert res["dp"] == [r, r]            # pod-major DP ranks
        assert "4 ranks" in res["bad_mesh"] or "world" in res["bad_mesh"]


def test_every_rank_issued_the_same_collectives(world):
    """The counted collectives (every one the port issues goes through
    ``distributed.sharding``'s helpers) pair up: each rank issued the
    same number of each kind with the same payload, and every kind the
    worker's paths use was issued."""
    _, out, _, _ = world
    counts = out[0]["collectives"]
    assert all(res["collectives"] == counts for res in out)
    assert {"all_gather/tokens", "all_gather/factors", "all_reduce/ready",
            "all_reduce/grads", "all_reduce/powersgd_p",
            "all_reduce/powersgd_q", "all_reduce/loss",
            "all_reduce/token_count"} <= set(counts)
    assert all(n > 0 and b > 0 for n, b in counts.values())


def test_decompose_sharded_matches_unsharded(world):
    """(4, 1) and the pod mesh (2, 2, 1), a batch of 8 (two elements a
    rank) and of 6 (does not divide: replication)."""
    IN, out, _, _ = world
    de = DecomposeEngine(EngineConfig(), z0=lambda h: IN["z0"][h])
    jde = JDecomposeEngine(JEngineConfig())
    for b in (8, 6):
        lr = de.decompose(torch.from_numpy(IN["x"][:b]), 4, iters=8)
        want = (lr.u.numpy(), lr.core.numpy(), lr.vt.numpy())
        jlr = jde.decompose(jnp.asarray(IN["x"][:b]), 4, iters=8)
        ref = tuple(np.asarray(a) for a in (jlr.u, jlr.core, jlr.vt))
        for res in out:
            for tag in ("41", "pod"):
                for got, w, r in zip(res[f"dec_{tag}_{b}"], want, ref):
                    np.testing.assert_allclose(got, w, rtol=1e-5,
                                               atol=1e-6)
                    # the reference's engine, same z0 (its default)
                    np.testing.assert_allclose(got, r, rtol=1e-4,
                                               atol=1e-4)


@pytest.mark.parametrize("case", ["slab", "paged", "batched"])
def test_sharded_dkv_tokens_equal_no_mesh_and_reference(world, f32, case):
    IN, out, _, _ = world
    arrivals = IN["staggered"] if case != "batched" else \
        {0: list(enumerate(IN["many"]))}
    paged = case == "paged"
    want = _run(_port_dkv(f32, IN, paged=paged), Request, arrivals)
    ref = _run(_jax_dkv(f32, paged=paged), JRequest, arrivals)
    assert want == ref
    for r, res in enumerate(out):
        assert res[case] == want, (r, res[case], want)
    if case != "batched":
        assert all(res[case + "_folds"] > 0 for res in out)
    if case == "slab":
        # two slots a rank: the slab's slot axis is the rank's block
        for r, res in enumerate(out):
            assert res["slab_shard"] == (2 * r, 2)
            assert res["slab_local"][1] == SLOTS // WORLD
    if paged:
        for res in out:
            free, total, tfree, ttotal = res["paged_back"]
            assert (free, tfree) == (total, ttotal)
            assert res["paged_local"][1] == SLOTS // WORLD


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_sharded_fused_blocks_with_a_stop_token(world, f32, paged):
    """Fused blocks of 4 and an eos: a rank whose slots sampled no stop
    ran past the block's end and zeroed the tail rows it wrote; tokens
    equal the no-mesh fused engine's."""
    IN, out, _, _ = world
    eos = out[0]["eos"]
    eng = _port_dkv(f32, IN, paged=paged, decode_block=4, eos_id=eos)
    want = _run(eng, Request, IN["staggered"])
    tag = "eos_paged" if paged else "eos_slab"
    for res in out:
        assert res[tag] == want
        assert res[tag + "_stopped"] == eng.stats.stopped_eos > 0
    assert sum(res["undone"] for res in out) > 0


def test_sharded_keyed_sampler_draws_the_global_rows(world, f32):
    """A keyed sampler on a rank's slots draws what the whole-batch
    engine draws for them (``row0``), in fused blocks."""
    from repro_torch.sampling import categorical_sampler
    IN, out, _, _ = world
    want = _run(_port_dkv(f32, IN, decode_block=4,
                          sampler=categorical_sampler(0.8), sample_seed=3),
                Request, IN["staggered"])
    for res in out:
        assert res["keyed"] == want
    logits = torch.randn(8, 50, generator=torch.Generator().manual_seed(1))
    sample = categorical_sampler(1.0)
    whole = sample(logits, 1, 12345)
    for r in range(4):
        part = sample(logits[2 * r:2 * r + 2], 1, 12345, row0=2 * r)
        assert torch.equal(part, whole[2 * r:2 * r + 2])


def test_sharded_mamba2_stop_token_runs_single_steps(world, mamba):
    IN, out, _, _ = world
    _, _, mcfg, mp = mamba
    eng = Engine(mcfg, mp, slots=SLOTS, max_len=MAX_LEN, device="cpu",
                 decode_block=4, eos_id=out[0]["meos"])
    want = _run(eng, Request, {0: list(enumerate(IN["many"]))})
    assert eng.stats.stopped_eos > 0
    for res in out:
        assert res["mamba2_eos"] == want
        blocks, steps = res["mamba2_eos_blocks"]
        assert blocks == steps            # one step a block on the mesh


def test_sharded_async_orders(world, f32):
    IN, out, _, _ = world
    want = _run(_port_dkv(f32, IN), Request, IN["staggered"])
    for res in out:
        assert res["async_det"] == want
        assert sorted(res["async_ready"]) == [0, 1, 2]
        assert all(len(t) == MAX_NEW for t in res["async_ready"].values())


def test_sharded_mamba2_tokens_equal_no_mesh(world, mamba):
    IN, out, _, _ = world
    jcfg, jp, mcfg, mp = mamba
    want = _run(Engine(mcfg, mp, slots=SLOTS, max_len=MAX_LEN,
                       device="cpu"), Request, IN["staggered"])
    ref = _run(JEngine(jcfg, jp, slots=SLOTS, max_len=MAX_LEN), JRequest,
               IN["staggered"])
    assert want == ref
    for res in out:
        assert res["mamba2"] == want
        assert res["mamba2_local"][1] == SLOTS // WORLD


def test_model_axis_refused_in_the_world(world, mamba):
    """The ssm family on (2, 2), tensor-parallel: the engine gives the
    no-mesh engine's tokens with each rank holding its heads of the ssm
    state, and a train step the no-mesh step's loss (1e-5 relative) with
    each rank holding its column block of in_proj."""
    from repro_torch.tree import tree_map
    IN, out, _, _ = world
    _, _, mcfg, mp = mamba
    want = _run(Engine(mcfg, mp, slots=SLOTS, max_len=MAX_LEN,
                       device="cpu"), Request, IN["staggered"])
    p = tree_map(lambda v: v.clone(), mp)        # AdamW updates in place
    opt = make_optimizer(mcfg, warmup=1)
    src = SyntheticLM(mcfg, ShapeSpec("t", 16, 4, "train"), DataConfig())
    _, _, met = steps.make_train_step(mcfg, opt, backend="reference")(
        p, opt.init(p), {k: torch.from_numpy(v).long()
                         for k, v in src.batch_at(0).items()})
    cols = 2 * mcfg.d_inner + 2 * mcfg.ssm_state + mcfg.ssm_heads
    for res in out:
        assert res["model_serve"] == want
        assert res["model_serve_ssm"][1:3] == (SLOTS // 2,
                                               mcfg.ssm_heads // 2)
        loss, w_shape = res["model_train"]
        np.testing.assert_allclose(loss, float(met["loss"]), rtol=1e-5)
        assert w_shape == (mcfg.num_layers, mcfg.d_model, cols // 2)


@pytest.mark.parametrize("mesh", ["41", "22"])
def test_restore_for_mesh(world, mesh):
    """A checkpoint saved without a mesh restores onto (4, 1) and (2, 2):
    every leaf equal, placed by the rules."""
    IN, out, ps, os_ = world
    ccfg = IN["ckpt_cfg"]
    names = sh.MeshShape(("data", "model"),
                         (4, 1) if mesh == "41" else (2, 2))
    saved = {"params": ps, "opt": os_}
    specs = {"params": sh.params_sharding(ps, names, ccfg),
             "opt": sh.opt_state_sharding(os_, names, ccfg)}
    specs = _port_named(specs, saved)
    sharded = 0
    for res in out:
        got = res["restore_" + mesh]
        assert set(got) == set(specs)
        for name, leaf in named_leaves(saved):
            full, placements, local = got[name]
            np.testing.assert_array_equal(full, leaf.float().numpy())
            assert placements == sh.placements(specs[name], names), name
            sharded += local != tuple(leaf.shape)
    assert sharded > 0


def _port_batch(cfg, n_steps):
    src = SyntheticLM(cfg, ShapeSpec("t", 16, 4, "train"), DataConfig())
    return [{k: torch.from_numpy(v).long()
             for k, v in src.batch_at(i).items()} for i in range(n_steps)]


def _train_ref(tcfg, transform=None, n_steps=3):
    """The port's single-process steps on the whole batch."""
    p, o = steps.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    fn = steps.make_train_step(tcfg, grad_transform=transform,
                               backend="reference")
    losses = []
    for batch in _port_batch(tcfg, n_steps):
        p, o, met = fn(p, o, batch)
        losses.append(float(met["loss"]))
    return losses, p


def _assert_rel(got_l, got_p, losses, params, rel=1e-5):
    np.testing.assert_allclose(got_l, losses, rtol=rel)
    for name, v in named_leaves(params):
        w = v.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(got_p[name] - w).max()) <= rel * scale, name


@pytest.mark.parametrize("tag", ["plain", "powersgd"])
def test_dp_train_steps_match_single_process(world, granite, tag):
    """Three DP steps at global batch 4 on (4, 1) == the single-process
    steps on the whole batch, within 1e-5 relative (PowerSGD given the
    reference's Q on both sides)."""
    _, out, _, _ = world
    gcfg, _, p0, _, _, qs = granite
    tr = comp.PowerSGD(p0, comp.PowerSGDConfig(**PSGD), q=qs) \
        if tag == "powersgd" else None
    losses, params = _train_ref(gcfg, tr)
    for res in out:
        _assert_rel(*res["train_" + tag], losses, params)
    assert out[0]["train_" + tag][0] == out[3]["train_" + tag][0]


@pytest.mark.parametrize("tag", ["plain", "powersgd"])
def test_dp_train_steps_match_reference(world, granite, tag):
    """The same DP steps against the reference's ``make_train_step`` on
    the whole batch (its GSPMD step's math), from the same parameters,
    with the reference's PowerSGD round trip as its ``grad_transform``:
    every loss within 1e-5 relative and every leaf's total move Δp
    within 1e-3 relative L2 (``test_torch_train``'s bars against JAX)."""
    _, out, _, _ = world
    gcfg, jcfg, p0, jp, jst, _ = granite
    pcfg = jcomp.PowerSGDConfig(**PSGD)
    jopt = jmake_optimizer(jcfg)

    def step(params, opt_state, pstate, batch):
        box = {"st": pstate}

        def transform(g):
            g, box["st"] = jcomp.compress_decompress(g, pstate, pcfg)
            return g
        fn = jsteps.make_train_step(
            jcfg, jopt, grad_transform=transform if tag == "powersgd"
            else None)
        params, opt_state, met = fn(params, opt_state, batch)
        return params, opt_state, box["st"], met
    step = jax.jit(step)
    params, opt_state, pstate = jp, jopt.init(jp), jst
    losses = []
    batches = _port_batch(gcfg, 3)
    for s in range(3):
        batch = JSynth(jcfg, JShape("t", 16, 4, "train"), JData()).batch_at(s)
        assert all(np.array_equal(batch[k], batches[s][k].numpy())
                   for k in batch)
        params, opt_state, pstate, met = step(
            params, opt_state, pstate,
            {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(met["loss"]))
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, params)))
    start = dict(named_leaves(bridge.to_numpy(p0)))
    for res in out:
        got_l, got_p = res["train_" + tag]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        for name, w in want.items():
            jd, td = w - start[name], got_p[name] - start[name]
            assert np.linalg.norm(td - jd) <= 1e-3 * np.linalg.norm(jd), \
                name


def test_dp_step_resumes_from_restore_for_mesh(world):
    """One DP step, a checkpoint, ``restore_for_mesh`` onto (4, 1) (its
    ZeRO-1 moments sharded over "data"), ``driver.unshard``, two more DP
    steps: the losses and parameters of the uninterrupted three steps,
    bit for bit."""
    _, out, _, _ = world
    for res in out:
        assert res["resumed_plain"]
        losses, params = res["train_plain"]
        first, resumed = res["train_first"], res["train_resumed"]
        assert first[0] + resumed[0] == losses
        for name, w in params.items():
            np.testing.assert_array_equal(resumed[1][name], w, err_msg=name)


def test_dp_train_step_keeps_an_expert_batch_whole(world):
    """olmoe-1b-7b with binding capacity (cf 1): every rank trains on the
    whole batch, so its capacity and balance loss are the global step's,
    and two DP steps equal the single-process steps within 1e-5."""
    _, out, _, _ = world
    ecfg = get_arch("olmoe-1b-7b").reduced().replace(dtype="float32",
                                                     capacity_factor=1.0)
    losses, params = _train_ref(ecfg, n_steps=2)
    for res in out:
        _assert_rel(*res["train_moe"], losses, params)


def test_dp_powersgd_round_trip_is_the_references_of_the_mean(world,
                                                             granite):
    """The first synced PowerSGD round trip (P and Q' all-reduced) equals
    the reference's ``compress_decompress`` of the whole-batch gradient,
    given the same Q."""
    _, out, _, _ = world
    gcfg, _, p, _, jst, _ = granite
    fns = model_fns(gcfg)
    batch = _port_batch(gcfg, 1)[0]
    _, grads = steps.value_and_grad(
        lambda pp, b: fns.loss_fn(pp, gcfg, b, None), p, batch)
    jgrads = bridge_tree(grads, lambda t: jnp.asarray(t.numpy()))
    jout, _ = jcomp.compress_decompress(jgrads, jst,
                                        jcomp.PowerSGDConfig(**PSGD))
    compressed = 0
    for res in out:
        for name, got in res["psgd_first"].items():
            want = np.asarray(_get(jout, name))
            scale = max(float(np.abs(want).max()), 1e-12)
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, name
            compressed += _get(jst, name)["q"] is not None
    assert compressed > 0


def bridge_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: bridge_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _get(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree
