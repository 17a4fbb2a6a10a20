"""The rest of the "model" axis: the port against the reference.

* The step builders and their shape inputs (no process group):
  ``runtime.steps.make_prefill_step`` / ``make_decode_step`` against
  ``repro.runtime.steps``' on the same bridged float32 weights and numpy
  inputs, for every family; ``models.api.train_batch_specs`` /
  ``prefill_input_specs`` / ``decode_input_specs`` / ``make_fake_batch``
  against ``repro.models.api``'s shapes and dtypes;
  ``make_dkv_prefill_step`` against the reference's.
* Caveat C10 pinned: the reference's ``_zero1`` names "data" twice for
  kimi-k2's 2-D expert leaves, and the port's rule gives the same spec.
* One gloo world of 4 processes, spawned once for the module (the
  workers import torch and the port only, ``torch.set_num_threads(1)``),
  while the references run in this process:

  - (2) batch-1 decode with every time axis sharded over "data" on
    (4, 1): dense ``llama2-7b`` and the hybrid ``zamba2-1.2b`` from the
    reference's prefill cache, decomposed-KV ``llama2-7b`` from the
    reference's factors (the tail sharded too), six greedy steps against
    the reference's unsharded decode (logits within 1e-4, float32
    tokens equal);
  - (3) batch-1 prefill of the dense, ssm and hybrid families sharded
    along the sequence (logits 1e-5 relative, then decode from the
    sharded cache), and three batch-1 AdamW steps (losses 1e-5
    relative, each leaf's Δp 1e-3 relative L2) against the reference's
    unsharded step;
  - (4) Megatron-SP on (1, 4): three steps of ``granite-3-2b`` against
    the reference with ``seq_parallel=True`` on one device; the
    activation collectives are all-gathers and reduce-scatters, none an
    all-reduce;
  - (5) ``kimi-k2-1t-a32b`` reduced (2-D experts) with Adafactor ZeRO-1
    on (2, 2) against the reference's unsharded Adafactor step; AdamW
    ZeRO-1 keeps the 2-D leaves' moments in the parameter's own blocks
    (C10); ``restore_for_mesh`` of the Adafactor state resumes equal to
    the uninterrupted run;
  - the vlm and audio families at batch 1, sequence-sharded on (4, 1)
    (their image embeddings or frames a second sequence, split where 4
    divides it): prefill, decode and one step's loss against the
    reference's unsharded ones;
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
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa
from repro.distributed import sharding as jsh  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import decomposed_kv as JDK  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.engine import DecomposeEngine  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY_ARCHS = ("llama2-7b", "olmoe-1b-7b", "mamba2-780m", "zamba2-1.2b",
                "llama-3.2-vision-11b", "seamless-m4t-medium")
WORLD = 4
PROMPT, MAX_LEN, DECODE = 32, 48, 6     # batch-1 prompt, cache, steps
SEQ_ARCHS = ("llama2-7b", "mamba2-780m", "zamba2-1.2b")
SEQ_TRAIN = ShapeSpec("t", 64, 1, "train")
SP_TRAIN = ShapeSpec("t", 16, 2, "train")
KIMI_TRAIN = ShapeSpec("t", 16, 2, "train")
MOE_TRAIN = ShapeSpec("t", 16, 1, "train")
TRAIN_STEPS = 3
DKV_RANK, DKV_TAIL = 8, 8


def _bridged(arch, **over):
    """(reference cfg, reference params, port cfg, port params) of a
    float32 reduced config: the reference's init, and the port's copy."""
    jcfg = all_archs()[arch].reduced().replace(dtype="float32", **over)
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, get_arch(arch).reduced().replace(dtype="float32",
                                                      **over), tp


def _inputs(cfg, b, s, seed=0):
    """Numpy prefill inputs of ``cfg``'s family (tokens, and image
    embeddings or encoder frames) from ``seed``."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        img = rng.randn(b, cfg.num_image_tokens, cfg.d_model)
        return (tok, (0.5 * img).astype(np.float32))
    if cfg.family == "audio":
        fr = rng.randn(b, cfg.num_audio_frames, cfg.d_model)
        return ((0.5 * fr).astype(np.float32), tok)
    return (tok,)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


# ---------------------------------------------------------------------------
# (1) the step builders and the shape inputs, no process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_input_specs_match_reference(arch):
    jcfg = all_archs()[arch].reduced()
    tcfg = get_arch(arch).reduced()
    for kind, (s, b) in (("train", (16, 4)), ("prefill", (16, 2)),
                         ("decode", (24, 2))):
        jshape, tshape = JShape("x", s, b, kind), ShapeSpec("x", s, b, kind)

        def sig(tree, is_j):
            leaves = jax.tree_util.tree_leaves(tree) if is_j else \
                [v for v in api.tree_leaves(tree)]
            return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                    for x in leaves]
        if kind == "train":
            got = api.train_batch_specs(tcfg, tshape)
            want = japi.train_batch_specs(jcfg, jshape)
            assert sorted(got) == sorted(want)
            for k in want:
                assert sig([got[k]], False) == sig([want[k]], True), k
            fake = api.make_fake_batch(tcfg, tshape)
            assert {k: tuple(v.shape) for k, v in fake.items()} == {
                k: tuple(v.shape) for k, v in got.items()}
            assert all(v.device.type == "cpu" for v in fake.values())
            tok = fake["tokens"]
            assert tok.dtype == torch.int32 and 0 <= int(tok.min()) \
                and int(tok.max()) < tcfg.vocab
        elif kind == "prefill":
            assert sig(list(api.prefill_input_specs(tcfg, tshape)), False) \
                == sig(japi.prefill_input_specs(jcfg, jshape), True)
        else:
            tok, cache, pos = api.decode_input_specs(tcfg, tshape)
            jtok, jcache, jpos = japi.decode_input_specs(jcfg, jshape)
            assert sig([tok, pos], False) == sig([jtok, jpos], True)
            jnamed = {jsh._path_str(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(jcache)[0]}
            got = {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for n, v in named_leaves(cache)}
            assert got == {n: (tuple(v.shape), str(v.dtype))
                           for n, v in jnamed.items()}
            assert all(v.device.type == "meta" for _, v in
                       named_leaves(cache))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_step_builders_match_reference(arch):
    """make_prefill_step, then three greedy make_decode_step steps, on the
    reference's bridged weights: logits within 1e-4 (float32), the same
    tokens."""
    jcfg, jp, tcfg, tp = _bridged(arch)
    ins = _inputs(tcfg, 1, 12, seed=3)
    jpre = jsteps.make_prefill_step(jcfg)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    jl, jc = jpre(jp, *[jnp.asarray(x) for x in ins], 20)
    tl, tc = steps.make_prefill_step(tcfg, backend="reference")(
        tp, *[torch.from_numpy(x) for x in ins], max_len=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tdec = steps.make_decode_step(tcfg)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(3):
        pos = np.full((1,), 12 + i, np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = tdec(tp, torch.from_numpy(tok).long(), tc,
                      torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        assert tl.numpy().argmax(-1).tolist() == \
            np.asarray(jl).argmax(-1).tolist()
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_dkv_prefill_step_matches_reference():
    jcfg, jp, tcfg, tp = _bridged("llama2-7b")
    tok = _inputs(tcfg, 2, 16, seed=4)[0]
    z0 = np.asarray(_padded_z0(tcfg.kv_width, tcfg.kv_width))
    jl, jc = jsteps.make_dkv_prefill_step(
        jcfg, DKV_RANK, tail=4, engine=JDecomposeEngine(JEngineConfig()))(
            jp, jnp.asarray(tok))
    tl, tc = steps.make_dkv_prefill_step(
        tcfg, DKV_RANK, tail=4, engine=DecomposeEngine(z0=lambda h: z0))(
            tp, torch.from_numpy(tok).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for k in ("k", "v"):
        got = torch.einsum("lbtr,lbrw->lbtw", tc[k + "_u"], tc[k + "_vt"])
        want = np.einsum("lbtr,lbrw->lbtw", np.asarray(jc[k + "_u"]),
                         np.asarray(jc[k + "_vt"]))
        assert _rel(got.numpy(), want) < 1e-4, k
    assert tuple(tc["tail"]["k"].shape) == tuple(jc["tail"]["k"].shape)


def test_c10_zero1_spec_names_data_twice():
    """The reference's ``_zero1`` gives kimi-k2's 2-D expert leaves a spec
    naming "data" twice (JAX's NamedSharding refuses it: the reference
    cannot place this state), and the port's rule gives the same; the
    port's ZeRO-1 step keeps those leaves' state in the parameter's own
    block (``zero1_block_spec``; the world test checks the shapes)."""
    names = ("data", "model")
    amesh = AbstractMesh((2, 2), names)
    pmesh = sh.MeshShape(names, (2, 2))
    jcfg = all_archs()["kimi-k2-1t-a32b"]
    tcfg = get_arch("kimi-k2-1t-a32b")
    shapes = {"layers/moe/w_gate": (60, 384, 7168, 2048),
              "layers/moe/w_up": (60, 384, 7168, 2048),
              "layers/moe/w_down": (60, 384, 2048, 7168)}
    for name, shape in shapes.items():
        jspec = jsh.param_spec(name, shape, amesh, jcfg)
        jz = tuple(jsh._zero1(jspec, shape, amesh))
        assert list(jz).count("data") == 2, (name, jz)
        tspec = sh.param_spec(name, shape, pmesh, tcfg)
        assert tuple(sh._zero1(tspec, shape, pmesh)) == jz
        assert sh.names_twice(sh._zero1(tspec, shape, pmesh))
        assert tuple(sh.zero1_block_spec("m/" + name, shape, pmesh, tcfg)) \
            == tuple(tspec)


@pytest.mark.parametrize("over, seq", [
    (dict(), 14),                    # S % M != 0
    (dict(num_heads=4, num_kv_heads=1, head_dim=6), 16),   # wk/wv whole
])
def test_seq_parallel_refuses_what_it_does_not_run(over, seq):
    """A sequence M does not divide and a kv projection the rule
    replicates, once refused, run Megatron-SP: ``sp_on`` holds (the
    gloo world of ``tests/test_torch_dist_rest.py`` holds both against
    the reference)."""
    cfg = get_arch("granite-3-2b").reduced().replace(seq_parallel=True,
                                                     **over)
    assert not TP.sp_on(cfg, seq)              # no model axis: off
    prev = TP._CURRENT[0]
    TP._CURRENT[0] = TP.TP(None, None, 4, 0)
    try:
        assert TP.sp_on(cfg, seq) == seq
        assert TP.sp_rows(seq) == -(-seq // 4)
        assert TP.sp_on(cfg.replace(**{k: getattr(
            get_arch("granite-3-2b").reduced(), k) for k in over}), 16)
        assert not TP.sp_on(cfg.replace(seq_parallel=False), 16)
    finally:
        TP._CURRENT[0] = prev


# ---------------------------------------------------------------------------
# the gloo world of 4
# ---------------------------------------------------------------------------

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
    from repro_torch.models import api
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import driver, steps
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    m41 = M.make_host_mesh(4, 1, "cpu")
    m14 = M.make_host_mesh(1, 4, "cpu")
    m22 = M.make_host_mesh(2, 2, "cpu")
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    out = {}

    def tree(tag):                      # a copy: AdamW updates in place
        return rebuild(IN[tag + "_template"],
                       {n: torch.from_numpy(v.copy())
                        for n, v in IN[tag].items()})

    def cfg_of(arch, **over):
        return get_arch(arch).reduced().replace(dtype="float32", **over)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    # ---- (2) decode of a batch-1 cache sharded over "data" ---------------
    for arch in ("llama2-7b", "zamba2-1.2b"):
        cfg = cfg_of(arch)
        p = tree(arch)
        cache = api.shard_cache(cfg, rebuild(
            IN["cache_template_" + arch],
            {n: t(v).clone() for n, v in IN["cache_" + arch].items()}), m41)
        out["dec_block_" + arch] = {n: tuple(v.shape) for n, v in
                                    named_leaves(cache)}
        dec = steps.make_decode_step(cfg, m41)
        logits = []
        for tok, pos in IN["dec_feed_" + arch]:
            lg, cache = dec(p, t(tok).long(), cache, t(pos).long())
            logits.append(lg.numpy().copy())
        out["dec_" + arch] = logits

    cfg = cfg_of("llama2-7b")
    p = tree("llama2-7b")
    cache = api.shard_cache(cfg, rebuild(
        IN["dkv_template"], {n: t(v).clone() for n, v in IN["dkv"].items()}),
        m41)
    out["dkv_block"] = {n: tuple(v.shape) for n, v in named_leaves(cache)}
    dec = steps.make_dkv_decode_step(cfg, m41)
    logits = []
    for tok, pos in IN["dkv_feed"]:
        lg, cache = dec(p, t(tok).long(), cache, t(pos).long(),
                        torch.tensor([IN["prompt"]], dtype=torch.int32))
        logits.append(lg.numpy().copy())
    out["dkv"] = logits

    # ---- (3) batch-1 prefill sharded along the sequence, then decode -----
    for arch in IN["seq_archs"]:
        cfg = cfg_of(arch)
        p = tree(arch)
        pre = steps.make_prefill_step(cfg, m41, backend="reference")
        lg, cache = pre(p, t(IN["prompt_tokens"]).long(),
                        max_len=IN["max_len"])
        dec = steps.make_decode_step(cfg, m41)
        logits = [lg.numpy().copy()]
        for tok, pos in IN["dec_feed_" + arch]:
            lg, cache = dec(p, t(tok).long(), cache, t(pos).long())
            logits.append(lg.numpy().copy())
        out["chain_" + arch] = logits

    # a cache of the prompt's length: each rank keeps its own K/V rows
    for arch in ("llama2-7b", "zamba2-1.2b"):
        cfg = cfg_of(arch)
        sh.reset_collective_counts()
        lg, cache = steps.make_prefill_step(cfg, m41, backend="reference")(
            tree(arch), t(IN["prompt_tokens"]).long())
        kv = cache["attn"] if arch == "zamba2-1.2b" else cache
        out["own_rows_" + arch] = (lg.numpy().copy(), kv["k"].numpy().copy(),
                                   kv["v"].numpy().copy(),
                                   sh.collective_counts())

    # a batch of 4 prompts on (4, 1): each rank prefills its row
    cfg = cfg_of("llama2-7b")
    lg, cache = steps.make_prefill_step(cfg, m41, backend="reference")(
        tree("llama2-7b"), t(IN["batch_tokens"]).long())
    out["prefill_rows"] = (lg.numpy().copy(), tuple(cache["k"].shape))

    def batches(cfg, shape, n):
        src = SyntheticLM(cfg, shape, DataConfig())
        return [{k: torch.from_numpy(v).long() if k in ("tokens", "labels")
                 else torch.from_numpy(v)
                 for k, v in src.batch_at(s).items()} for s in range(n)]

    def train(cfg, tag, shape, mesh, zero1, n, opt=None):
        opt = opt or make_optimizer(cfg, warmup=1)
        p = tree(tag)
        o = opt.init(p)
        on = zero1 or sh.model_size(mesh) > 1
        if on:
            p, o = steps.shard_train_state(cfg, p, o, mesh, zero1=zero1,
                                           optimizer=opt)
        fn = steps.make_train_step(cfg, opt, mesh=mesh, backend="reference",
                                   zero1=zero1)
        losses, norms = [], []
        sh.reset_collective_counts()
        for b in batches(cfg, shape, n):
            p, o, m = fn(p, o, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = sh.collective_counts()
        blocks = {k: tuple(v.shape) for k, v in named_leaves(o)}
        pblocks = {k: tuple(v.shape) for k, v in named_leaves(p)}
        if on:
            p, o = steps.whole_train_state(cfg, p, o, mesh, zero1=zero1,
                                           optimizer=opt)
        return (losses, norms, {n_: v.numpy() for n_, v in
                                named_leaves(p)}, blocks, pblocks, counts)

    for arch in IN["seq_archs"]:
        out["train_" + arch] = train(cfg_of(arch), arch, IN["seq_train"],
                                     m41, False, IN["train_steps"])

    # the moe family at batch 1 where the rules keep S whole (D = 1):
    # the batch path, tensor-parallel on (1, 4)
    cfg = cfg_of("olmoe-1b-7b")
    lg, _ = steps.make_prefill_step(cfg, m14, backend="reference")(
        sh.shard_params(tree("olmoe-1b-7b"), m14, cfg),
        t(IN["prompt_tokens"]).long())
    out["moe_b1"] = (lg.numpy().copy(), train(
        cfg, "olmoe-1b-7b", IN["moe_train"], m14, False, 1)[0])

    # ---- (4) Megatron-SP on (1, 4) ----------------------------------------
    out["sp"] = train(cfg_of("granite-3-2b", seq_parallel=True),
                      "granite-3-2b", IN["sp_train"], m14, True,
                      IN["train_steps"])

    # ---- (5) kimi-k2 2-D experts: Adafactor ZeRO-1, AdamW's C10 blocks ----
    kcfg = cfg_of("kimi-k2-1t-a32b")
    out["kimi_adafactor"] = train(kcfg, "kimi-k2-1t-a32b", IN["kimi_train"],
                                  m22, True, 2)
    acfg = kcfg.replace(optimizer="adamw")
    out["kimi_adamw"] = train(acfg, "kimi-k2-1t-a32b", IN["kimi_train"],
                              m22, True, 2)
    ck = os.path.join(d, "kimi_ck")
    kw = dict(device="cpu", backend="reference", print_fn=lambda *a: None,
              mesh=m22, zero1=True, ckpt_every=1000,
              init_params=lambda: tree("kimi-k2-1t-a32b"))
    opt = make_optimizer(kcfg, warmup=1)
    first = driver.train_loop(kcfg, IN["kimi_train"], total_steps=2,
                              ckpt_dir=ck, optimizer=opt, **kw)
    st = driver.restore_for_mesh(kcfg, ck, m22, optimizer=opt)
    out["kimi_restored_blocks"] = {
        n: tuple(v.to_local().shape) for n, v in named_leaves(st["opt"])
        if n != "step"}
    rest = driver.train_loop(kcfg, IN["kimi_train"], total_steps=4,
                             ckpt_dir=ck, optimizer=opt, **kw)
    whole = driver.train_loop(kcfg, IN["kimi_train"], total_steps=4,
                              ckpt_dir=os.path.join(d, "kimi_ck2"),
                              optimizer=make_optimizer(kcfg, warmup=1),
                              **kw)
    out["kimi_resume"] = (first.losses, rest.losses, whole.losses)

    # ---- the vlm and audio families at batch 1, sequence-sharded ----------
    for tag, arch, over in IN["modal_cases"]:
        cfg = cfg_of(arch, **over)
        p = tree(arch)
        ins = [t(x) for x in IN["modal_inputs_" + tag]]
        k = 1 if cfg.family == "audio" else 0
        ins[k] = ins[k].long()
        lg, cache = steps.make_prefill_step(cfg, m41, backend="reference")(
            p, *ins, max_len=IN["max_len"])
        shapes = {n: tuple(v.shape) for n, v in named_leaves(cache)}
        dec = steps.make_decode_step(cfg, m41)
        logits = [lg.numpy().copy()]
        for tok, pos in IN["modal_feed_" + tag]:
            lg, cache = dec(p, t(tok).long(), cache, t(pos).long())
            logits.append(lg.numpy().copy())
        out["modal_" + tag] = (logits, shapes, train(
            cfg, arch, IN["modal_train"], m41, False, 1)[0])
    out["collectives"] = sh.collective_counts()
    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _np_tree(tree):
    return {n: v.numpy().copy() for n, v in named_leaves(tree)}


def _jnp_of(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                  bridge.to_numpy(tree))


@pytest.fixture(scope="module")
def models():
    out = {a: _bridged(a) for a in SEQ_ARCHS + ("granite-3-2b",
                                                "kimi-k2-1t-a32b",
                                                "olmoe-1b-7b",
                                                "llama-3.2-vision-11b",
                                                "seamless-m4t-medium")}
    return out


@pytest.fixture(scope="module")
def decode_reference(models):
    """The reference's batch-1 prefill of PROMPT tokens into a cache of
    MAX_LEN rows, then DECODE greedy steps: (prefill logits, its cache,
    the fed (token, pos) pairs, each step's logits) per arch, and the
    decomposed-KV decode from the reference's factors."""
    tok = _inputs(models["llama2-7b"][2], 1, PROMPT, seed=7)[0]
    batch = _inputs(models["llama2-7b"][2], WORLD, 16, seed=8)[0]
    jcfg, jp = models["llama2-7b"][:2]
    out = {"tokens": tok, "batch": (batch, np.asarray(
        jsteps.make_prefill_step(jcfg)(jp, jnp.asarray(batch))[0]))}
    for arch in SEQ_ARCHS:
        jcfg, jp = models[arch][:2]
        lg, cache = jsteps.make_prefill_step(jcfg)(jp, jnp.asarray(tok),
                                                   MAX_LEN)
        cache0 = jax.tree_util.tree_map(np.asarray, cache)
        dec = jax.jit(jsteps.make_decode_step(jcfg))
        feed, logits = [], [np.asarray(lg)]
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        for i in range(DECODE):
            pos = np.full((1,), PROMPT + i, np.int32)
            feed.append((nxt, pos))
            lg, cache = dec(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
            logits.append(np.asarray(lg))
            nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        out[arch] = (cache0, feed, logits)
    # decomposed KV: the reference's prefill_dkv (rank 8, tail 8), then
    # its joint-softmax decode with frozen_len = PROMPT
    jcfg, jp = models["llama2-7b"][:2]
    lg, cache = JDK.prefill_dkv(jp, jcfg, jnp.asarray(tok), DKV_RANK,
                                tail=DKV_TAIL,
                                engine=JDecomposeEngine(JEngineConfig()))
    cache0 = jax.tree_util.tree_map(np.asarray, cache)
    step = jax.jit(lambda p, t, c, ps: JDK.decode_step_dkv(
        p, jcfg, t, c, ps, frozen_len=PROMPT))
    feed, logits = [], []
    nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    for i in range(DECODE):
        pos = np.full((1,), PROMPT + i, np.int32)
        feed.append((nxt, pos))
        lg, cache = step(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
        logits.append(np.asarray(lg))
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    out["dkv"] = (cache0, feed, logits)
    return out


#: the vlm and audio families at batch 1 on (4, 1): (tag, arch, config
#: overrides); 18 image tokens are a memory the group does not divide
MODAL_CASES = (("vlm16", "llama-3.2-vision-11b", {}),
               ("vlm18", "llama-3.2-vision-11b", dict(num_image_tokens=18)),
               ("audio", "seamless-m4t-medium", {}))
MODAL_TRAIN = ShapeSpec("t", 16, 1, "train")


def _modal_cfgs(models, tag):
    arch, over = next((a, o) for t, a, o in MODAL_CASES if t == tag)
    jcfg, jp, tcfg, tp = models[arch]
    return jcfg.replace(**over), jp, tcfg.replace(**over), tp


@pytest.fixture(scope="module")
def modal_reference(models):
    """Per batch-1 vlm/audio case: the prompt's inputs, the reference's
    prefill of PROMPT tokens into MAX_LEN rows and DECODE greedy steps
    (the fed (token, pos) pairs, every logits)."""
    out = {}
    for i, (tag, _, _) in enumerate(MODAL_CASES):
        jcfg, jp, tcfg, _ = _modal_cfgs(models, tag)
        ins = _inputs(tcfg, 1, PROMPT, seed=30 + i)
        lg, cache = jsteps.make_prefill_step(jcfg)(
            jp, *[jnp.asarray(x) for x in ins], MAX_LEN)
        dec = jax.jit(jsteps.make_decode_step(jcfg))
        feed, logits = [], [np.asarray(lg)]
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        for j in range(DECODE):
            pos = np.full((1,), PROMPT + j, np.int32)
            feed.append((nxt, pos))
            lg, cache = dec(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
            logits.append(np.asarray(lg))
            nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        out[tag] = (ins, feed, logits)
    return out


@pytest.fixture(scope="module")
def world_inputs(models, decode_reference, modal_reference,
                 tmp_path_factory):
    """The workers' inputs, and the four workers started on them."""
    d = str(tmp_path_factory.mktemp("seqworld"))
    ref = decode_reference
    IN = {"prompt": PROMPT, "max_len": MAX_LEN, "seq_archs": SEQ_ARCHS,
          "prompt_tokens": ref["tokens"], "seq_train": SEQ_TRAIN,
          "batch_tokens": ref["batch"][0],
          "sp_train": SP_TRAIN, "kimi_train": KIMI_TRAIN,
          "moe_train": MOE_TRAIN, "train_steps": TRAIN_STEPS}
    for arch, (_, _, _, tp) in models.items():
        IN[arch + "_template"] = tp
        IN[arch] = _np_tree(tp)
    for arch in SEQ_ARCHS:
        cache0, feed, _ = ref[arch]
        tc = bridge.to_torch(cache0, "cpu")
        IN["cache_template_" + arch] = tc
        IN["cache_" + arch] = _np_tree(tc)
        IN["dec_feed_" + arch] = feed
    cache0, feed, _ = ref["dkv"]
    tc = bridge.to_torch(cache0, "cpu")
    IN["dkv_template"], IN["dkv"], IN["dkv_feed"] = tc, _np_tree(tc), feed
    IN["modal_cases"], IN["modal_train"] = MODAL_CASES, MODAL_TRAIN
    for tag, (ins, feed, _) in modal_reference.items():
        IN["modal_inputs_" + tag], IN["modal_feed_" + tag] = ins, feed
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


def _jtrain(jcfg, p0, shape, n, mesh_ctx=False):
    """The reference's unsharded train step ``n`` times from the port's
    parameters ``p0`` on the reference's synthetic batches: (losses, grad
    norms, final params by path)."""
    jp = _jnp_of(p0)
    opt = jmake_optimizer(jcfg, warmup=1)
    st = opt.init(jp)
    fn = jax.jit(jsteps.make_train_step(jcfg, opt))
    src = JSynth(jcfg, JShape("t", shape.seq_len, shape.global_batch,
                              "train"), JData())
    losses, norms = [], []
    ctx = jax.set_mesh(jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,)
        * 2)) if mesh_ctx else None
    if ctx is not None:
        ctx.__enter__()
    try:
        for s in range(n):
            jp, st, m = fn(jp, st, src.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return losses, norms, {jsh._path_str(p): np.asarray(v) for p, v in
                           jax.tree_util.tree_flatten_with_path(jp)[0]}


@pytest.fixture(scope="module")
def train_reference(world_inputs, models):
    """Per train case: the reference's unsharded steps from the port's
    initial parameters (run while the world works)."""
    out = {}
    for arch in SEQ_ARCHS:
        out[arch] = _jtrain(models[arch][0], models[arch][3], SEQ_TRAIN,
                            TRAIN_STEPS)
    out["sp"] = _jtrain(models["granite-3-2b"][0].replace(seq_parallel=True),
                        models["granite-3-2b"][3], SP_TRAIN, TRAIN_STEPS,
                        mesh_ctx=True)
    kc = models["kimi-k2-1t-a32b"][0]
    out["kimi_adafactor"] = _jtrain(kc, models["kimi-k2-1t-a32b"][3],
                                    KIMI_TRAIN, 2)
    out["kimi_adamw"] = _jtrain(kc.replace(optimizer="adamw"),
                                models["kimi-k2-1t-a32b"][3], KIMI_TRAIN, 2)
    out["moe_b1"] = _jtrain(models["olmoe-1b-7b"][0],
                            models["olmoe-1b-7b"][3], MOE_TRAIN, 1)
    for tag, _, _ in MODAL_CASES:
        jcfg, _, _, tp = _modal_cfgs(models, tag)
        out["modal_" + tag] = _jtrain(jcfg, tp, MODAL_TRAIN, 1)
    return out


@pytest.fixture(scope="module")
def world(world_inputs, train_reference):
    IN, procs, d = world_inputs
    logs = [p.communicate(timeout=900)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return IN, out


@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-1.2b"])
def test_seq_sharded_decode_matches_reference(world, decode_reference,
                                              arch):
    """Every K/V cache's time axis a quarter a rank; six greedy steps from
    the reference's prefill cache: each step's logits within 1e-4 of the
    reference's unsharded decode, greedy tokens equal."""
    _, out = world
    want = decode_reference[arch][2][1:]
    for res in out:
        for k, shape in res["dec_block_" + arch].items():
            if k.rsplit("/", 1)[-1] in ("k", "v"):
                assert shape[-3] == MAX_LEN // WORLD, (k, shape)
        for got, w in zip(res["dec_" + arch], want):
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
            assert got.argmax(-1).tolist() == w.argmax(-1).tolist()


def test_seq_sharded_dkv_decode_matches_reference(world, decode_reference):
    """Decomposed KV at batch 1: each rank holds 8 of the 32 prefix rows
    and 2 of the 8 tail rows; ``dkv_attention_stats`` (its plain version
    here) runs on the rank's rows, the statistics merge over "data", the
    gathered tail merges once; six steps against the reference's
    joint-softmax decode."""
    _, out = world
    want = decode_reference["dkv"][2]
    for res in out:
        blocks = res["dkv_block"]
        assert blocks["k_u"][2] == PROMPT // WORLD
        assert blocks["tail/k"][2] == DKV_TAIL // WORLD
        for got, w in zip(res["dkv"], want):
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
            assert got.argmax(-1).tolist() == w.argmax(-1).tolist()


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_sharded_prefill_then_decode_matches_reference(
        world, decode_reference, arch):
    """A 32-token prompt, 8 tokens a rank: the prefill's last logits within
    1e-5 relative of the reference's, then six decode steps from the
    rank's block of the cache it emitted."""
    _, out = world
    want = decode_reference[arch][2]
    for res in out:
        got = res["chain_" + arch]
        assert _rel(got[0], want[0]) < 1e-5
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            assert g.argmax(-1).tolist() == w.argmax(-1).tolist()


@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-1.2b"])
def test_seq_sharded_prefill_keeps_its_own_rows(world, decode_reference,
                                                arch):
    """A prefill into a cache of the prompt's length: each rank's block of
    T is its own 8 rows of K/V, with no collective to place them (the
    reference's cache rows, 1e-5 relative), and the last logits the
    reference's."""
    _, out = world
    cache0, _, want = decode_reference[arch]
    kv = cache0["attn"] if arch == "zamba2-1.2b" else cache0
    n = PROMPT // WORLD
    for r, res in enumerate(out):
        lg, k, v, counts = res["own_rows_" + arch]
        assert _rel(lg, want[0]) < 1e-5
        for got, whole in ((k, kv["k"]), (v, kv["v"])):
            assert got.shape[2] == n
            assert _rel(got, whole[:, :, r * n:(r + 1) * n]) < 1e-5
        assert not [c for c in counts if "prefill_" in c], counts


def test_batch1_moe_where_the_rules_keep_the_sequence(
        world, train_reference, decode_reference, models):
    """olmoe-1b-7b at batch 1 on (1, 4): D = 1 keeps S whole (a one-rank
    DP group), so the prefill and the train step run under the model
    axis alone, the prefill's logits and the step's loss the
    reference's."""
    _, out = world
    jcfg, jp = models["olmoe-1b-7b"][:2]
    want = np.asarray(jsteps.make_prefill_step(jcfg)(
        jp, jnp.asarray(decode_reference["tokens"]))[0])
    jloss = train_reference["moe_b1"][0][0]
    for res in out:
        lg, losses = res["moe_b1"]
        assert _rel(lg, want) < 1e-4
        assert abs(losses[0] - jloss) <= 1e-5 * abs(jloss), (losses, jloss)


def _check_train(res, ref, p0, zero_ok=()):
    losses, norms, params = res[:3]
    jl, jn, jparams = ref
    for a, b in zip(losses + norms, jl + jn):
        assert abs(a - b) <= 1e-5 * abs(b), (losses, jl, norms, jn)
    for name, v in params.items():
        dp_t = v - p0[name]
        dp_j = jparams[name] - p0[name]
        den = np.linalg.norm(dp_j)
        if den == 0 and name in zero_ok:
            continue
        assert np.linalg.norm(dp_t - dp_j) <= 1e-3 * max(den, 1e-12), name


def test_prefill_step_on_a_mesh_runs_the_ranks_rows(world,
                                                    decode_reference):
    """A batch of 4 prompts on (4, 1): the batch rule gives each rank one
    row; its logits are the reference's row, its cache that row's."""
    _, out = world
    want = decode_reference["batch"][1]
    for r, res in enumerate(out):
        lg, kshape = res["prefill_rows"]
        np.testing.assert_allclose(lg, want[r:r + 1], rtol=1e-4, atol=1e-4)
        assert kshape[1] == 1


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_sharded_train_steps_match_reference(world, train_reference,
                                                 models, arch):
    """Three AdamW steps on a batch of one 64-token sequence, 16 tokens a
    rank on (4, 1), against the reference's unsharded step."""
    _, out = world
    p0 = _np_tree(models[arch][3])
    for res in out:
        _check_train(res["train_" + arch], train_reference[arch], p0)
    counts = out[0]["train_" + arch][5]
    assert counts.get("all_gather/k_rows" if arch != "mamba2-780m" else
                      "all_gather/ssd_state", (0, 0))[0] > 0, counts
    if arch != "llama2-7b":
        assert counts["all_gather/conv_halo"][0] > 0
        assert counts["reduce_scatter/ssd_state_grad"][0] > 0


def test_megatron_sp_matches_reference(world, train_reference, models):
    """Megatron-SP on (1, 4) with ZeRO-1: three steps of reduced
    granite-3-2b against the reference with ``seq_parallel=True`` on one
    device; between the TP products the activations move by all-gathers
    and reduce-scatters only (the remaining all-reduces are the loss's
    statistics, the replicated norms' gradients, the clip and the
    logged loss)."""
    _, out = world
    p0 = _np_tree(models["granite-3-2b"][3])
    for res in out:
        _check_train(res["sp"], train_reference["sp"], p0)
        counts = res["sp"][5]
        acts = {k for k in counts if "sp_tp" in k or "sp_embed" in k}
        assert acts == {"all_gather/sp_tp_in", "reduce_scatter/sp_tp_out",
                        "reduce_scatter/sp_embed",
                        "reduce_scatter/sp_tp_in_grad",
                        "all_gather/sp_tp_out_grad",
                        "all_gather/sp_embed_grad"}, sorted(counts)
        assert not {"all_reduce/tp_out", "all_reduce/tp_in_grad",
                    "all_reduce/embed"} & set(counts), sorted(counts)


def test_kimi_adafactor_zero1_matches_reference(world, train_reference,
                                                models):
    """kimi-k2 reduced (2-D experts: w_gate/w_up/w_down's F over "data")
    with Adafactor ZeRO-1 on (2, 2): two steps against the reference's
    unsharded Adafactor step; vr, vc and v in ``opt_state_sharding``'s
    blocks."""
    _, out = world
    tcfg = models["kimi-k2-1t-a32b"][2]
    p0 = _np_tree(models["kimi-k2-1t-a32b"][3])
    mesh = sh.MeshShape(("data", "model"), (2, 2))
    whole = dict(named_leaves(steps.abstract_train_state(tcfg)[1]))
    for res in out:
        _check_train(res["kimi_adafactor"], train_reference["kimi_adafactor"],
                     p0)
        for name, shape in res["kimi_adafactor"][3].items():
            if name == "step":
                continue
            spec = sh._zero1(sh.param_spec(name, tuple(whole[name].shape),
                                           mesh, tcfg),
                             tuple(whole[name].shape), mesh)
            want = [n // (2 if e is not None else 1) for n, e in
                    zip(whole[name].shape, spec)]
            assert list(shape) == want, (name, shape, spec)


def test_c10_adamw_moments_keep_the_parameter_blocks(world, train_reference,
                                                     models):
    """AdamW ZeRO-1 of kimi-k2's 2-D expert leaves on (2, 2): their m and v
    are the parameter's own blocks (no second split over "data"), the
    other leaves' the ZeRO-1 blocks; two steps equal the reference's
    unsharded AdamW."""
    _, out = world
    p0 = _np_tree(models["kimi-k2-1t-a32b"][3])
    for res in out:
        _check_train(res["kimi_adamw"], train_reference["kimi_adamw"], p0)
        blocks, pblocks = res["kimi_adamw"][3], res["kimi_adamw"][4]
        for leaf in ("w_gate", "w_up", "w_down"):
            name = "layers/moe/" + leaf
            assert blocks["m/" + name] == pblocks[name]
            assert blocks["v/" + name] == pblocks[name]
        assert blocks["m/embed/w"] != pblocks["embed/w"]


def test_kimi_adafactor_resume_equals_uninterrupted(world):
    """Two Adafactor ZeRO-1 steps on (2, 2) saved (``save_for_mesh``),
    ``restore_for_mesh``'d (its DTensors' local blocks are the step's:
    vr/vc/v by the rules), two more: the uninterrupted run's losses."""
    _, out = world
    for res in out:
        first, rest, whole = res["kimi_resume"]
        assert len(rest) == 2 and len(whole) == 4
        for a, b in zip(first + rest, whole):
            assert abs(a - b) <= 1e-6 * abs(b), (first, rest, whole)
        assert res["kimi_restored_blocks"] == {
            k: v for k, v in res["kimi_adafactor"][3].items() if k != "step"}


@pytest.mark.parametrize("tag", [c[0] for c in MODAL_CASES])
def test_batch1_families_without_sequence_sharding_raise(
        world, modal_reference, train_reference, tag):
    """The vlm and audio families at batch 1 on (4, 1), which the port
    once refused, now run sequence-sharded: the prompt's 32 tokens 8 a
    rank, the image embeddings or frames a second sequence (split where
    4 divides them: 16 image tokens, 32 frames; 18 image tokens stay
    whole).  The prefill's last logits within 1e-5 relative of the
    reference's unsharded prefill; six greedy decode steps from the
    cache it emitted (its self and split cross rows the rank's block
    over "data") with the reference's tokens and logits within 1e-4; one
    AdamW step's loss (16 tokens, 4 a rank) within 1e-5 relative."""
    _, out = world
    _, _, want = modal_reference[tag]
    jloss = train_reference["modal_" + tag][0][0]
    n_img = {"vlm16": 16, "vlm18": 18, "audio": 32}[tag]
    for res in out:
        logits, shapes, losses = res["modal_" + tag]
        assert _rel(logits[0], want[0]) < 1e-5
        for g, w in zip(logits[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            assert g.argmax(-1).tolist() == w.argmax(-1).tolist()
        assert shapes["self/k"][-3] == MAX_LEN // WORLD
        assert shapes["cross/k"][-3] == (n_img // WORLD if n_img % WORLD == 0
                                         else n_img)
        assert abs(losses[0] - jloss) <= 1e-5 * abs(jloss), (losses, jloss)


def test_every_rank_issued_the_same_collectives(world):
    _, out = world
    ops = [{k: v[0] for k, v in res["collectives"].items()} for res in out]
    assert all(o == ops[0] for o in ops[1:])
