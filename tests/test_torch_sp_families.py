"""Megatron-SP wherever the reference applies it, and with batch-1
sequence sharding on the same step: the port against the reference.

The reference's ``_sp`` constrains the residual at the start of every
``transformer.block``: the dense blocks, moe's leading dense layers, the
vlm's self-attention blocks and hybrid's shared attention block.  One
gloo world of 4 processes, spawned once for the module (the workers
import torch and the port only, ``torch.set_num_threads(1)``), trains
reduced float32 configs with ``seq_parallel=True``:

* ``olmoe-1b-7b`` with a leading dense layer (as kimi-k2 has),
  ``zamba2-1.2b`` and ``llama-3.2-vision-11b`` on (1, 4);
* ``granite-3-2b`` at batch 1 on (2, 2): the sequence split over "data",
  each rank's block again over "model";

two AdamW steps each against the reference's unsharded step with
``seq_parallel=True`` (losses and grad norms within 1e-5 relative, each
leaf's Δp within 1e-3 relative L2, the bars of
``tests/test_torch_seq.py::test_megatron_sp_matches_reference``), and a
prefill on the same mesh whose logits are the reference's (1e-5
relative) and whose counted SP collectives are those of exactly the
blocks the reference sends through ``transformer.block``: two
all-gathers along S (the attention's and the MLP's inputs) and two
reduce-scatters (their outputs) per such block, one ``sp_whole``
all-gather where the residual leaves them for a block the reference
does not constrain.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 2
PROMPT = 32
#: tag → (arch, config overrides, mesh, train (seq_len, batch), SP blocks,
#: sp_whole gathers of one prefill)
CASES = {
    "olmoe": ("olmoe-1b-7b", dict(first_k_dense=1), "1x4", (16, 2), 1, 1),
    "zamba2": ("zamba2-1.2b", {}, "1x4", (16, 2), 2, 2),
    "vlm": ("llama-3.2-vision-11b", {}, "1x4", (16, 2), 2, 2),
    "granite_seq": ("granite-3-2b", {}, "2x2", (32, 1), 2, 0),
}

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
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import steps
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"1x4": M.make_host_mesh(1, 4, "cpu"),
              "2x2": M.make_host_mesh(2, 2, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    out = {}

    def tree(tag):                      # a copy: AdamW updates in place
        return rebuild(IN[tag + "_template"],
                       {n: torch.from_numpy(v.copy())
                        for n, v in IN[tag].items()})

    for tag, (arch, over, mname, (s, b), _, _) in IN["cases"].items():
        cfg = get_arch(arch).reduced().replace(dtype="float32",
                                               seq_parallel=True, **over)
        mesh = meshes[mname]
        # a prefill: its logits and its SP collectives
        ins = [torch.from_numpy(x) for x in IN["inputs_" + tag]]
        ins[0] = ins[0].long()
        sh.reset_collective_counts()
        lg, _ = steps.make_prefill_step(cfg, mesh, backend="reference")(
            sh.shard_params(tree(tag), mesh, cfg), *ins)
        pre = (lg.numpy().copy(), sh.collective_counts())
        # AdamW steps
        opt = make_optimizer(cfg, warmup=1)
        p = tree(tag)
        o = opt.init(p)
        p, o = steps.shard_train_state(cfg, p, o, mesh, optimizer=opt)
        fn = steps.make_train_step(cfg, opt, mesh=mesh, backend="reference")
        src = SyntheticLM(cfg, ShapeSpec("t", s, b, "train"), DataConfig())
        losses, norms = [], []
        sh.reset_collective_counts()
        for i in range(IN["steps"]):
            batch = {k: torch.from_numpy(v) for k, v in
                     src.batch_at(i).items()}
            batch = {k: v.long() if k in ("tokens", "labels") else v
                     for k, v in batch.items()}
            p, o, m = fn(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = sh.collective_counts()
        p, o = steps.whole_train_state(cfg, p, o, mesh, optimizer=opt)
        out[tag] = dict(pre=pre, losses=losses, norms=norms, counts=counts,
                        params={n: v.numpy() for n, v in named_leaves(p)})
    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


def _jcfg(tag):
    arch, over = CASES[tag][:2]
    return all_archs()[arch].reduced().replace(dtype="float32",
                                                seq_parallel=True, **over)


def _inputs(cfg, seed):
    """Numpy prefill inputs of one batch-1 prompt (tokens, and the vlm's
    image embeddings)."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (1, PROMPT)).astype(np.int32)
    if cfg.family == "vlm":
        img = rng.randn(1, cfg.num_image_tokens, cfg.d_model)
        return (tok, (0.5 * img).astype(np.float32))
    return (tok,)


def _mesh_ctx():
    return jax.set_mesh(jax.make_mesh(
        (1, 1), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2))


@pytest.fixture(scope="module")
def models():
    out = {}
    for tag in CASES:
        jcfg = _jcfg(tag)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out[tag] = (jcfg, jp, tp)
    return out


@pytest.fixture(scope="module")
def world_procs(models, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spworld"))
    IN = {"cases": CASES, "steps": STEPS}
    for i, (tag, (jcfg, _, tp)) in enumerate(models.items()):
        IN[tag + "_template"] = tp
        IN[tag] = {n: v.numpy().copy() for n, v in named_leaves(tp)}
        IN["inputs_" + tag] = _inputs(jcfg, 20 + i)
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
def reference(models, world_procs):
    """Per case, run while the world works: the reference's prefill
    logits and its unsharded train steps with ``seq_parallel=True`` on a
    one-device mesh (losses, grad norms, final params by path)."""
    IN = world_procs[0]
    out = {}
    for tag, (jcfg, jp, tp) in models.items():
        s, b = CASES[tag][3]
        with _mesh_ctx():
            lg = np.asarray(jsteps.make_prefill_step(jcfg)(
                jp, *[jnp.asarray(x) for x in IN["inputs_" + tag]])[0])
            jp2 = jax.tree_util.tree_map(
                lambda a: jnp.array(a, copy=True), bridge.to_numpy(tp))
            opt = jmake_optimizer(jcfg, warmup=1)
            st = opt.init(jp2)
            fn = jax.jit(jsteps.make_train_step(jcfg, opt))
            src = JSynth(jcfg, JShape("t", s, b, "train"), JData())
            losses, norms = [], []
            for i in range(STEPS):
                jp2, st, m = fn(jp2, st, src.batch_at(i))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[tag] = (lg, losses, norms,
                    {jsh._path_str(p): np.asarray(v) for p, v in
                     jax.tree_util.tree_flatten_with_path(jp2)[0]})
    return out


@pytest.fixture(scope="module")
def world(world_procs, reference):
    _, procs, d = world_procs
    logs = [p.communicate(timeout=900)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("tag", list(CASES))
def test_sp_train_steps_match_reference(world, reference, models, tag):
    p0 = {n: v.numpy() for n, v in named_leaves(models[tag][2])}
    _, jl, jn, jparams = reference[tag]
    for res in world:
        r = res[tag]
        for a, b in zip(r["losses"] + r["norms"], jl + jn):
            assert abs(a - b) <= 1e-5 * abs(b), (tag, r["losses"], jl,
                                                 r["norms"], jn)
        for name, v in r["params"].items():
            dp_t, dp_j = v - p0[name], jparams[name] - p0[name]
            den = np.linalg.norm(dp_j)
            assert np.linalg.norm(dp_t - dp_j) <= 1e-3 * max(den, 1e-12), \
                (tag, name)


@pytest.mark.parametrize("tag", list(CASES))
def test_sp_prefill_logits_match_reference(world, reference, tag):
    for res in world:
        assert _rel(res[tag]["pre"][0], reference[tag][0]) < 1e-5, tag


@pytest.mark.parametrize("tag", list(CASES))
def test_sp_collectives_are_those_of_the_constrained_blocks(world, tag):
    """A prefill's SP collectives: per block the reference sends through
    ``transformer.block``, two all-gathers and two reduce-scatters along
    S; one ``sp_whole`` all-gather per such block run before a block it
    does not constrain; the embedding's reduce-scatter where the first
    block is such a block; in the dense family no all-reduce of the
    activations (the other families' unconstrained blocks keep theirs).
    The train
    steps' counts hold the backward's duals.  Every rank issued the
    same."""
    arch, _, _, _, blocks, whole = CASES[tag]
    counts = [res[tag]["pre"][1] for res in world]
    c = {k: v[0] for k, v in counts[0].items()}
    assert all({k: v[0] for k, v in x.items()} == c for x in counts[1:])
    sp = {k: n for k, n in c.items() if "/sp_" in k}
    want = {"all_gather/sp_tp_in": 2 * blocks,
            "reduce_scatter/sp_tp_out": 2 * blocks}
    if whole:
        want["all_gather/sp_whole"] = whole
    if tag != "zamba2":                 # the first block is a dense one
        want["reduce_scatter/sp_embed"] = 1
    if tag == "granite_seq":            # the dense prefill's last hidden
        want["all_gather/sp_hidden"] = 1
    assert sp == want, (tag, sorted(c.items()))
    if tag == "granite_seq":            # every block is constrained
        assert not {"all_reduce/tp_out", "all_reduce/embed"} & set(c), c
    train = {k for k in world[0][tag]["counts"] if "/sp_" in k}
    assert {"reduce_scatter/sp_tp_in_grad",
            "all_gather/sp_tp_out_grad"} <= train, (tag, sorted(train))
    if tag in ("zamba2", "vlm"):        # split again after a group
        assert "all_gather/sp_split_grad" in train, sorted(train)
