"""MoE over the DP axis: the port against the reference.

A data-parallel step splits an MoE batch over the DP group like any
other (``runtime.steps``), and a slot-sharded engine decodes its block
of the slots (``serving.families.MoEServing``).  The MoE blocks then run
one of the reference's two forms over the split (``models.moe``,
``distributed.tokens``): by default its GSPMD ``moe_ffn``, whose
capacity, rank in expert and auxiliary loss are the whole batch's; with
``cfg.moe_shard_map`` its ``moe_ffn_shard_map``, whose capacity and aux
loss are each shard's.

One gloo world of 4 processes, spawned once for the module (the workers
import torch and the port only, ``torch.set_num_threads(1)``), while the
references run in this process, on reduced float32 ``olmoe-1b-7b`` at
its capacity factor 1.25 (drops happen in both forms: checked here on
the port's own router):

- three AdamW steps on (4, 1) and (2, 2) in each form: the default form
  against ``repro.runtime.steps.make_train_step`` on the whole batch,
  the per-shard form against the same step with ``SHARD_MAP_MESH`` set
  (a subprocess with 4 forced host devices, as
  ``tests/test_moe_shard_map.py`` runs the reference): losses within
  1e-5 relative, each leaf's Δp within 1e-3 relative L2.  Both steps
  take AdamW with eps 1e-6 (:data:`EPS`): at the default 1e-8 a few
  embedding and wv elements whose gradients lie within a few eps of
  zero (2e-8 against a row median of 1e-2) move by a noise-decided
  fraction of a step, and such a leaf read up to 2.1e-3 while every
  other leaf stayed below 1.4e-4 (at 1e-6: 6.3e-5 at most);
- slot-sharded serving, single-step on (4, 1) and (2, 2) token-equal to
  the reference's one-device engine, fused blocks of 4 on (2, 2)
  token-equal to the port's one-device fused engine (a fused block
  admits at other rounds, and capacity couples the slots);
- batch 1 on (4, 1): two train steps with the sequence's blocks split
  over DP, and a prefill into a cache whose time axis is sharded, then
  greedy decode steps, against the reference's unsharded steps.
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
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import AdamW as JAdamW, cosine_schedule as jcosine  # noqa
from repro.runtime import steps as jsteps  # noqa: E402
from repro.serving import Engine as JEngine, Request as JRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ARCH = "olmoe-1b-7b"
CF = 1.25
TRAIN = ShapeSpec("t", 16, 4, "train")
TRAIN_STEPS = 3
B1_TRAIN = ShapeSpec("t", 16, 1, "train")
B1_STEPS = 2
PROMPT, MAX_LEN, DECODE = 16, 32, 4
SLOTS, MAX_NEW = 4, 10
PROMPT_LENS = (12, 7, 15)            # the reference conformance test's
MESHES = ("41", "22")
FORMS = ("global", "shard_map")
# AdamW's eps in both packages' steps (the default is 1e-8): a gradient
# element within a few eps of zero moves by a fraction of a step that its
# float-order noise decides, and a split batch sums in another order
EPS = 1e-6


def _cfgs(**over):
    return (all_archs()[ARCH].reduced().replace(dtype="float32",
                                                capacity_factor=CF, **over),
            get_arch(ARCH).reduced().replace(dtype="float32",
                                             capacity_factor=CF, **over))


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
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import steps
    from repro_torch.serving import Engine, Request
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"41": M.make_host_mesh(4, 1, "cpu"),
              "22": M.make_host_mesh(2, 2, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    out = {}
    base = get_arch(IN["arch"]).reduced().replace(
        dtype="float32", capacity_factor=IN["cf"])

    def tree():                         # a copy: AdamW updates in place
        return rebuild(IN["template"], {n: torch.from_numpy(v.copy())
                                        for n, v in IN["params"].items()})

    def t(x):
        return torch.from_numpy(np.asarray(x))

    def train(cfg, shape, mesh, n):
        opt = AdamW(lr=cosine_schedule(3e-4, 1, 10_000), eps=IN["eps"])
        p = tree()
        p, o = steps.shard_train_state(cfg, p, opt.init(p), mesh,
                                       optimizer=opt)
        fn = steps.make_train_step(cfg, opt, mesh=mesh, backend="reference")
        src = SyntheticLM(cfg, shape, DataConfig())
        losses = []
        for s in range(n):
            b = {k: torch.from_numpy(v).long()
                 for k, v in src.batch_at(s).items()}
            p, o, met = fn(p, o, b)
            losses.append(float(met["loss"]))
        wp, _ = steps.whole_train_state(cfg, p, o, mesh, optimizer=opt)
        return losses, {n_: v.numpy() for n_, v in named_leaves(wp)}

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

    for form in IN["forms"]:
        cfg = base.replace(moe_shard_map=form == "shard_map")
        for mt in IN["meshes"]:
            out[f"train_{form}_{mt}"] = train(cfg, IN["train_shape"],
                                              meshes[mt], IN["train_steps"])
    for mt, kw in (("41", {}), ("22", {}), ("22", {"decode_block": 4})):
        eng = Engine(base, tree(), slots=IN["slots"], max_len=64,
                     device="cpu", decompose_engine=DecomposeEngine(
                         EngineConfig(mesh=meshes[mt])), **kw)
        out[f"serve_{mt}_{len(kw)}"] = (run(eng, IN["staggered"]),
                                        eng.shard.n)
        del eng

    # batch 1 on (4, 1): the sequence's blocks split over DP
    m41 = meshes["41"]
    out["b1_train"] = train(base, IN["b1_shape"], m41, IN["b1_steps"])
    lg, cache = steps.make_prefill_step(base, m41, backend="reference")(
        tree(), t(IN["prompt"]).long(), max_len=IN["max_len"])
    dec = steps.make_decode_step(base, m41)
    logits = [lg.numpy().copy()]
    for tok, pos in IN["dec_feed"]:
        lg, cache = dec(tree(), t(tok).long(), cache, t(pos).long())
        logits.append(lg.numpy().copy())
    out["b1_chain"] = (logits, tuple(cache["moe"]["k"].shape))
    out["collectives"] = sh.collective_counts()
    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')

# the reference's per-shard step: SHARD_MAP_MESH on 4 forced host devices
_SHARD_MAP_REF = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import all_archs
    from repro.configs.base import ShapeSpec
    from repro.data import DataConfig, SyntheticLM
    from repro.distributed import sharding as jsh
    from repro.models import moe as M
    from repro.optim import AdamW, cosine_schedule
    from repro.runtime import steps
    d = sys.argv[1]
    IN = pickle.load(open(os.path.join(d, "ref_in.pkl"), "rb"))
    cfg = all_archs()[IN["arch"]].reduced().replace(
        dtype="float32", capacity_factor=IN["cf"])
    out = {}
    for mt, shape in (("41", (4, 1)), ("22", (2, 2))):
        M.SHARD_MAP_MESH = jax.make_mesh(
            shape, ("data", "model"),
            axis_types=(jax.sharding.AxisType.Auto,) * 2)
        p = jax.tree_util.tree_map(jnp.asarray, IN["params"])
        opt = AdamW(lr=cosine_schedule(3e-4, 1, 10_000), eps=IN["eps"])
        st = opt.init(p)
        fn = jax.jit(steps.make_train_step(cfg, opt))
        src = SyntheticLM(cfg, ShapeSpec("t", *IN["shape"], "train"),
                          DataConfig())
        losses = []
        for s in range(IN["steps"]):
            p, st, m = fn(p, st, src.batch_at(s))
            losses.append(float(m["loss"]))
        out[mt] = (losses, {jsh._path_str(k): np.asarray(v) for k, v in
                            jax.tree_util.tree_flatten_with_path(p)[0]})
    pickle.dump(out, open(os.path.join(d, "ref_out.pkl"), "wb"))
''')


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n, dtype=np.int32) for n in lens]


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params): the
    reference's float32 init, and the port's copy."""
    jcfg, tcfg = _cfgs()
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def decode_reference(model):
    """The reference's batch-1 prefill of PROMPT tokens into a cache of
    MAX_LEN rows, then DECODE greedy steps: (prompt, fed (token, pos)
    pairs, each step's logits)."""
    jcfg, jp = model[:2]
    tok = np.random.RandomState(7).randint(0, jcfg.vocab, (1, PROMPT),
                                           dtype=np.int32)
    lg, cache = jsteps.make_prefill_step(jcfg)(jp, jnp.asarray(tok), MAX_LEN)
    dec = jax.jit(jsteps.make_decode_step(jcfg))
    feed, logits = [], [np.asarray(lg)]
    nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    for i in range(DECODE):
        pos = np.full((1,), PROMPT + i, np.int32)
        feed.append((nxt, pos))
        lg, cache = dec(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
        logits.append(np.asarray(lg))
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    return tok, feed, logits


@pytest.fixture(scope="module")
def world_inputs(model, decode_reference, tmp_path_factory):
    """The workers' inputs, the four workers and the reference's
    per-shard subprocess started on them."""
    d = str(tmp_path_factory.mktemp("dpmoeworld"))
    tcfg, tp = model[2:]
    prompts = _prompts(tcfg.vocab, PROMPT_LENS, 0)
    params = {n: v.numpy().copy() for n, v in named_leaves(tp)}
    IN = {"arch": ARCH, "cf": CF, "template": tp, "params": params,
          "forms": FORMS, "meshes": MESHES, "train_shape": TRAIN,
          "train_steps": TRAIN_STEPS, "b1_shape": B1_TRAIN,
          "b1_steps": B1_STEPS, "slots": SLOTS, "max_new": MAX_NEW,
          "staggered": {3 * i: [(i, p)] for i, p in enumerate(prompts)},
          "prompt": decode_reference[0], "max_len": MAX_LEN,
          "dec_feed": decode_reference[1], "eps": EPS}
    with open(os.path.join(d, "in.pkl"), "wb") as f:
        pickle.dump(IN, f)
    with open(os.path.join(d, "ref_in.pkl"), "wb") as f:
        pickle.dump({"arch": ARCH, "cf": CF, "steps": TRAIN_STEPS, "eps": EPS,
                     "shape": (TRAIN.seq_len, TRAIN.global_batch),
                     "params": bridge.to_numpy(tp)}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    store = os.path.join(d, "store")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                               str(WORLD), store, d], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    ref = subprocess.Popen([sys.executable, "-c", _SHARD_MAP_REF, d],
                           env=dict(env, JAX_PLATFORMS="cpu"), cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield IN, procs + [ref], d
    for p in procs + [ref]:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jtrain(jcfg, jp, shape, n):
    """The reference's unsharded train step ``n`` times: (losses, final
    params by path)."""
    p = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), jp)
    opt = JAdamW(lr=jcosine(3e-4, 1, 10_000), eps=EPS)
    st = opt.init(p)
    fn = jax.jit(jsteps.make_train_step(jcfg, opt))
    src = JSynth(jcfg, JShape("t", shape.seq_len, shape.global_batch,
                              "train"), JData())
    losses = []
    for s in range(n):
        p, st, m = fn(p, st, src.batch_at(s))
        losses.append(float(m["loss"]))
    return losses, {jsh._path_str(k): np.asarray(v) for k, v in
                    jax.tree_util.tree_flatten_with_path(p)[0]}


def _jrun(eng, req_cls, arrivals):
    n = sum(len(v) for v in arrivals.values())
    done = []
    for step in range(300):
        for uid, p in arrivals.get(step, []):
            eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
        done.extend(eng.step())
        if len(done) == n and not any(eng.live) and not len(eng.sched):
            break
    assert sorted(r.uid for r in done) == list(range(n))
    return {r.uid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def reference(world_inputs, model):
    """The reference's whole-batch steps (the global form's reference),
    its batch-1 steps and its one-device engine's tokens, computed
    while the workers run."""
    IN = world_inputs[0]
    jcfg, jp, tcfg, tp = model
    fused = Engine(tcfg, tp, slots=SLOTS, max_len=64, device="cpu",
                   decode_block=4)
    return {"global": _jtrain(jcfg, jp, TRAIN, TRAIN_STEPS),
            "b1": _jtrain(jcfg, jp, B1_TRAIN, B1_STEPS),
            "serve": _jrun(JEngine(jcfg, jp, slots=SLOTS, max_len=64),
                           JRequest, IN["staggered"]),
            "serve_fused": _jrun(fused, Request, IN["staggered"])}


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
    with open(os.path.join(d, "ref_out.pkl"), "rb") as f:
        shard_map_ref = pickle.load(f)
    return IN, out, shard_map_ref


def _check_train(got, want, p0):
    got_l, got_p = got
    losses, params = want
    np.testing.assert_allclose(got_l, losses, rtol=1e-5)
    for name, v in params.items():
        d_ref = v - p0[name]
        d_got = got_p[name] - p0[name]
        err = np.linalg.norm(d_got - d_ref) / max(np.linalg.norm(d_ref),
                                                  1e-30)
        assert err < 1e-3, (name, err)


@pytest.mark.parametrize("mt", MESHES)
@pytest.mark.parametrize("form", FORMS)
def test_dp_moe_train_steps_match_reference(world, reference, model, form,
                                            mt):
    """The split batch's steps equal the reference's form: the global
    form its whole-batch step, the per-shard form its
    ``moe_ffn_shard_map`` step on the same mesh shape."""
    _, out, shard_map_ref = world
    want = reference["global"] if form == "global" else shard_map_ref[mt]
    p0 = {n: v.numpy() for n, v in named_leaves(model[3])}
    for res in out:
        _check_train(res[f"train_{form}_{mt}"], want, p0)


def test_the_forms_differ_and_drops_happen(world, reference, model):
    """Capacity binds in both forms (the port's router on the first
    step's batch, whole and per shard), so the two forms' losses
    differ."""
    _, out, shard_map_ref = world
    tcfg, tp = model[2:]
    batch = {k: torch.from_numpy(v).long() for k, v in
             SyntheticLM(tcfg, TRAIN, DataConfig()).batch_at(0).items()}
    drops = []
    route = tmoe.route

    def counting(p, xf, cfg):
        out_ = route(p, xf, cfg)
        drops.append(int((out_[2] >= tmoe.capacity(cfg, xf.shape[0]))
                         .sum()))
        return out_
    tmoe.route = counting
    try:
        with torch.no_grad():
            model_fns(tcfg).loss_fn(tp, tcfg, batch)
            whole = sum(drops)
            for i in range(WORLD):
                model_fns(tcfg).loss_fn(tp, tcfg, {
                    k: v[i:i + 1] for k, v in batch.items()})
    finally:
        tmoe.route = route
    assert whole > 0 and sum(drops) - whole > 0
    assert abs(reference["global"][0][0] - shard_map_ref["41"][0][0]) > 1e-4


@pytest.mark.parametrize("cell", ["41_0", "22_0", "22_1"])
def test_slot_sharded_moe_serving_equals_reference(world, reference, cell):
    """Each rank decodes its block of the slots: every rank's tokens
    equal the reference's one-device engine's (fused blocks of 4 in
    "22_1": the port's one-device fused engine's)."""
    _, out, _ = world
    dp = 4 if cell.startswith("41") else 2
    want = reference["serve_fused" if cell == "22_1" else "serve"]
    for res in out:
        toks, n = res["serve_" + cell]
        assert n == SLOTS // dp
        assert toks == want


def test_batch1_moe_train_steps_match_reference(world, reference, model):
    _, out, _ = world
    p0 = {n: v.numpy() for n, v in named_leaves(model[3])}
    for res in out:
        _check_train(res["b1_train"], reference["b1"], p0)


def test_batch1_moe_prefill_and_decode_match_reference(world,
                                                       decode_reference):
    """A batch-1 prompt's blocks prefilled over (4, 1) into a cache whose
    time axis is sharded (each rank MAX_LEN / 4 rows), then greedy
    decode steps that route the one token on every rank: logits within
    1e-4 relative of the reference's."""
    _, out, _ = world
    want = decode_reference[2]
    for res in out:
        logits, kshape = res["b1_chain"]
        assert kshape[2] == MAX_LEN // WORLD
        for a, b in zip(logits, want):
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
            assert (a.argmax(-1) == b.argmax(-1)).all()


def test_every_rank_issued_the_same_collectives(world):
    _, out, _ = world
    counts = out[0]["collectives"]
    assert all(res["collectives"] == counts for res in out)
    assert {"all_gather/moe_counts", "all_reduce/moe_route",
            "all_reduce/moe_route_grad", "all_reduce/aux",
            "all_reduce/aux_grad"} <= set(counts), sorted(counts)
