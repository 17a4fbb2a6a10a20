"""The last refusals of the port's distribution, now run: the port on a
gloo world of 4 against the reference run unsharded on the same numpy
inputs.

One world of 4 processes, spawned once for the module (the workers
import torch and the port only, ``torch.set_num_threads(1)``,
``OMP_NUM_THREADS=1``), while the references run in this process:

* the paper's activation-decomposition forward on a mesh
  (``runtime.steps.make_decomposed_forward_step(mesh=)`` and the quality
  step): reduced llama2-7b in float32, three layers with layers 0 and 2
  decomposed at rank 4 with 3 % outliers, in both attention modes and in
  Table 3 mode (the whole weights' factors, Vᵀ cut to the rank's
  columns), on (1, 4) (the K/V columns gathered: 2 kv heads on 4 ranks)
  and (2, 2) (each DP rank decomposes its row of the batch), Megatron-SP
  off and on, batch 2 × 32 tokens: every decomposition's outlier
  channels EQUAL the reference's for the rank's rows, the logits within
  ``tests/test_torch_decomposed.py``'s ``LOGITS`` bar (1e-3), the KL over
  the whole batch within 1e-3 relative;
* Megatron-SP over a length the "model" axis does not divide (30 tokens
  on 4 ranks: 8 rows a rank, the last block padded) and with products
  whose weights the rule replicates (one 6-dim kv head; 3 query heads,
  one kv head and an MLP of 250 on 4 ranks), reduced granite-3-2b on
  (1, 4): two AdamW steps (losses and grad norms within 1e-5 relative,
  each leaf's Δp within 1e-3 relative L2) and a prefill (logits within
  1e-5 relative), the bars of ``tests/test_torch_seq.py::
  test_megatron_sp_matches_reference``; the SP collectives counted;
* a batch-1 sequence of 30 tokens on (4, 1), which the DP group does not
  divide: it runs whole on every rank (no sequence collective), the
  prefill's cache whole at the prompt's length and the rules' block of
  a 48-row cache, six decode steps from that block, two train steps; a
  50-row cache (whole by the rules) decoded whole (``cache_len``), as
  are the reference's decomposed-KV factors of the 30-token prompt and
  the vlm's 50-row self cache beside its split 16-row cross cache;
* Mamba2 where M does not divide d_inner (the rule replicates
  ``out_proj``): mamba2-780m reduced with d_model 63, head dim 9 and
  state 17 (d_inner 126, 14 heads: in_proj's columns and the conv cache
  still sharded) and zamba2-1.2b reduced with d_model 63 and head dim 6
  (21 heads, in_proj replicated) on (1, 4): the prefill's logits
  (1e-5), three decode steps (1e-4, greedy tokens equal) and two train
  steps, with no all-reduce of ``out_proj`` or the gated norm;
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
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa
from repro.distributed import sharding as jsh  # noqa: E402
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import decomposed_kv as JDK  # noqa: E402
from repro.models import decomposed as JD  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LOGITS = dict(rtol=1e-3, atol=1e-3)
#: the decomposed forward: tag → (attn_mode, Table 3 mode)
DEC_MODES = {"dense": ("dense", False), "preserved": ("preserved", False),
             "weights": ("dense", True)}
DEC_MESHES = ("1x4", "2x2")
DEC_LAYERS, DEC_ON = 3, [0, 2]
#: the model configs: tag → (arch, overrides)
MODELS = {
    "llama": ("llama2-7b", dict(num_layers=DEC_LAYERS)),
    "sp_uneven": ("granite-3-2b", {}),
    "sp_kv_rep": ("granite-3-2b", dict(num_heads=4, num_kv_heads=1,
                                       head_dim=6)),
    "sp_q_mlp_rep": ("granite-3-2b", dict(num_heads=3, num_kv_heads=1,
                                          head_dim=6, d_ff=250)),
    "seq30": ("llama2-7b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "mamba2": ("mamba2-780m", dict(d_model=63, ssm_head_dim=9,
                                   ssm_state=17)),
    "zamba2": ("zamba2-1.2b", dict(d_model=63, ssm_head_dim=6)),
}
#: Megatron-SP cases on (1, 4): tag → sequence length (batch 2)
SP_CASES = {"sp_uneven": 30, "sp_kv_rep": 32, "sp_q_mlp_rep": 30}
SSM_CASES = ("mamba2", "zamba2")
SEQ30, SEQ_MAX, DECODE = 30, 48, 6
WHOLE_MAX, WHOLE_DECODE, DKV_RANK, DKV_TAIL = 50, 3, 8, 8
SSM_PROMPT, SSM_MAX, SSM_DECODE = 32, 40, 3
STEPS = 2

_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    from repro_torch.launch import mesh as M
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.core import policy as pol
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models import decomposed as D
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import steps
    from repro_torch.tree import named_leaves, rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"1x4": M.make_host_mesh(1, 4, "cpu"),
              "2x2": M.make_host_mesh(2, 2, "cpu"),
              "4x1": M.make_host_mesh(4, 1, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    out = {}

    def tree(tag):                      # a copy: AdamW updates in place
        return rebuild(IN[tag + "_template"],
                       {n: torch.from_numpy(v.copy())
                        for n, v in IN[tag].items()})

    def cfg_of(tag, **kw):
        arch, over = IN["models"][tag]
        return get_arch(arch).reduced().replace(dtype="float32", **over,
                                                **kw)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    def train(cfg, tag, shape, mesh):
        opt = make_optimizer(cfg, warmup=1)
        p = tree(tag)
        o = opt.init(p)
        if sh.model_size(mesh) > 1:
            p, o = steps.shard_train_state(cfg, p, o, mesh, optimizer=opt)
        fn = steps.make_train_step(cfg, opt, mesh=mesh, backend="reference")
        src = SyntheticLM(cfg, shape, DataConfig())
        losses, norms = [], []
        sh.reset_collective_counts()
        for i in range(IN["steps"]):
            batch = {k: torch.from_numpy(v).long() for k, v in
                     src.batch_at(i).items()}
            p, o, m = fn(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = sh.collective_counts()
        if sh.model_size(mesh) > 1:
            p, o = steps.whole_train_state(cfg, p, o, mesh, optimizer=opt)
        return dict(losses=losses, norms=norms, counts=counts,
                    params={n: v.numpy() for n, v in named_leaves(p)})

    def decode(cfg, p, cache, feed, mesh):
        dec = steps.make_decode_step(cfg, mesh)
        logits = []
        for tok, pos in feed:
            lg, cache = dec(p, t(tok).long(), cache, t(pos).long())
            logits.append(lg.numpy().copy())
        return logits

    # ---- the activation-decomposition forward on a mesh ------------------
    z0 = IN["z0"]
    whole = tree("llama")
    toks = t(IN["dec_tokens"]).long()
    for mode, (attn, weights) in IN["dec_modes"].items():
        kw = dict(rank=4, outlier_frac=0.03)
        if weights:
            kw.update(decompose_weights=True, weight_rank=32)
        policy = pol.DecompositionPolicy.from_layer_list(
            IN["dec_layers"], IN["dec_on"], **kw)
        for mname in IN["dec_meshes"]:
            mesh = meshes[mname]
            for sp in (False, True):
                cfg = cfg_of("llama", seq_parallel=sp)
                eng = DecomposeEngine(EngineConfig(policy=policy,
                                                   attn_mode=attn),
                                      z0=lambda w: z0)
                log = []
                orig = eng.decompose_activation

                def rec(*a, **k):
                    lr = orig(*a, **k)
                    log.append(lr.o_idx.numpy().copy())
                    return lr
                eng.decompose_activation = rec
                fac = D.decompose_layer_weights(whole, cfg, policy) \\
                    if weights else None
                p = sh.shard_params(whole, mesh, cfg)
                sh.reset_collective_counts()
                lg = steps.make_decomposed_forward_step(cfg, eng, mesh)(
                    p, toks, fac)
                counts = sh.collective_counts()
                idx = list(log)
                kl = steps.make_decomposed_quality_step(cfg, eng, mesh)(
                    p, toks, fac)
                out[("dec", mode, mname, sp)] = (lg.numpy().copy(),
                                                 float(kl), idx, counts)

    # ---- Megatron-SP: an uneven sequence and replicated products ---------
    m14 = meshes["1x4"]
    for tag, s in IN["sp_cases"].items():
        cfg = cfg_of(tag, seq_parallel=True)
        sh.reset_collective_counts()
        lg, cache = steps.make_prefill_step(cfg, m14, backend="reference")(
            sh.shard_params(tree(tag), m14, cfg), t(IN["sp_tokens_" + tag]
                                                    ).long())
        pre = (lg.numpy().copy(), sh.collective_counts())
        out[tag] = dict(pre=pre, **train(cfg, tag, ShapeSpec("t", s, 2,
                                                             "train"), m14))

    # ---- a batch-1 sequence the DP group does not divide -----------------
    m41 = meshes["4x1"]
    cfg = cfg_of("seq30")
    pre = steps.make_prefill_step(cfg, m41, backend="reference")
    sh.reset_collective_counts()
    lg, cache = pre(tree("seq30"), t(IN["seq30_tokens"]).long())
    whole_pre = (lg.numpy().copy(), tuple(cache["k"].shape),
                 sh.collective_counts())
    lg48, cache = pre(tree("seq30"), t(IN["seq30_tokens"]).long(),
                      max_len=IN["seq_max"])
    out["seq30"] = dict(
        whole=whole_pre, pre48=(lg48.numpy().copy(),
                                tuple(cache["k"].shape)),
        dec=decode(cfg, tree("seq30"), cache, IN["seq30_feed"], m41),
        **train(cfg, "seq30", ShapeSpec("t", IN["seq30_len"], 1, "train"),
                m41))
    # caches whose time axis "data" does not divide: decoded whole
    wm = IN["whole_max"]
    for tag in ("seq30", "vlm"):
        cfg = cfg_of(tag)
        ins = [t(x) for x in IN["whole_inputs_" + tag]]
        ins[0] = ins[0].long()
        lg, cache = steps.make_prefill_step(cfg, m41, backend="reference")(
            tree(tag), *ins, max_len=wm)
        shapes = {n: tuple(v.shape) for n, v in named_leaves(cache)}
        dec = steps.make_decode_step(cfg, m41, cache_len=wm)
        logits = [lg.numpy().copy()]
        sh.reset_collective_counts()
        for tok, pos in IN["whole_feed_" + tag]:
            lg, cache = dec(tree(tag), t(tok).long(), cache, t(pos).long())
            logits.append(lg.numpy().copy())
        out["whole_" + tag] = (logits, shapes, sh.collective_counts())
    cfg = cfg_of("seq30")
    cache = rebuild(IN["dkv_template"], {n: t(v).clone() for n, v in
                                         IN["dkv_cache"].items()})
    dec = steps.make_dkv_decode_step(cfg, m41, cache_len=IN["seq30_len"])
    logits = []
    frozen = torch.tensor([IN["seq30_len"]], dtype=torch.int32)
    for tok, pos in IN["dkv_feed"]:
        lg, cache = dec(tree("seq30"), t(tok).long(), cache, t(pos).long(),
                        frozen)
        logits.append(lg.numpy().copy())
    out["whole_dkv"] = logits

    # ---- Mamba2 where M does not divide d_inner --------------------------
    for tag in IN["ssm_cases"]:
        cfg = cfg_of(tag)
        p = sh.shard_params(tree(tag), m14, cfg)
        sh.reset_collective_counts()
        lg, cache = steps.make_prefill_step(cfg, m14, backend="reference")(
            p, t(IN["ssm_tokens"]).long(), max_len=IN["ssm_max"])
        counts = sh.collective_counts()
        shapes = {n: tuple(v.shape) for n, v in named_leaves(cache)}
        dec = decode(cfg, p, cache, IN["ssm_feed_" + tag], m14)
        out[tag] = dict(pre=(lg.numpy().copy(), counts, shapes), dec=dec,
                        **train(cfg, tag, ShapeSpec("t", IN["ssm_prompt"], 2,
                                                    "train"), m14))
    out["collectives"] = sh.collective_counts()
    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


def _jcfg(tag):
    arch, over = MODELS[tag]
    return all_archs()[arch].reduced().replace(dtype="float32", **over)


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _jpolicy(weights):
    kw = dict(rank=4, outlier_frac=0.03)
    if weights:
        kw.update(decompose_weights=True, weight_rank=32)
    return jpol.DecompositionPolicy.from_layer_list(DEC_LAYERS, DEC_ON, **kw)


def _greedy(jcfg, jp, tokens, max_len, n, extra=()):
    """The reference's prefill of ``tokens`` (and ``extra`` inputs, the
    vlm's image embeddings) into ``max_len`` rows, then ``n`` greedy
    decode steps: (prefill logits, the fed (token, pos) pairs, each
    step's logits)."""
    lg, cache = jsteps.make_prefill_step(jcfg)(
        jp, jnp.asarray(tokens), *map(jnp.asarray, extra), max_len)
    dec = jax.jit(jsteps.make_decode_step(jcfg))
    b, s = tokens.shape
    feed, logits = [], []
    first = np.asarray(lg)
    nxt = first.argmax(-1).astype(np.int32)
    for i in range(n):
        pos = np.full((b,), s + i, np.int32)
        feed.append((nxt, pos))
        lg, cache = dec(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
        logits.append(np.asarray(lg))
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    return first, feed, logits


@pytest.fixture(scope="module")
def models():
    out = {}
    for tag in MODELS:
        jcfg = _jcfg(tag)
        jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out[tag] = (jcfg, jp, tp)
    return out


@pytest.fixture(scope="module")
def inputs(models):
    """The workers' token inputs and the reference's decode feeds (those
    need the reference's greedy tokens before the world starts)."""
    IN = {"models": MODELS, "steps": STEPS, "dec_modes": DEC_MODES,
          "dec_meshes": DEC_MESHES, "dec_layers": DEC_LAYERS,
          "dec_on": DEC_ON, "sp_cases": SP_CASES, "ssm_cases": SSM_CASES,
          "seq_max": SEQ_MAX, "seq30_len": SEQ30, "ssm_max": SSM_MAX,
          "ssm_prompt": SSM_PROMPT,
          "z0": np.asarray(_padded_z0(128, 128))}
    IN["dec_tokens"] = _tokens(models["llama"][0], 2, 32, 0)
    for i, (tag, s) in enumerate(SP_CASES.items()):
        IN["sp_tokens_" + tag] = _tokens(models[tag][0], 2, s, 10 + i)
    jcfg, jp, _ = models["seq30"]
    IN["seq30_tokens"] = _tokens(jcfg, 1, SEQ30, 20)
    ref = {"seq30": _greedy(jcfg, jp, IN["seq30_tokens"], SEQ_MAX, DECODE)}
    IN["seq30_feed"] = ref["seq30"][1]
    img = (0.5 * np.random.RandomState(21).randn(
        1, models["vlm"][0].num_image_tokens, models["vlm"][0].d_model)
    ).astype(np.float32)
    for tag, extra in (("seq30", ()), ("vlm", (img,))):
        jcfg, jp, _ = models[tag]
        ins = (IN["seq30_tokens"],) + extra
        ref["whole_" + tag] = _greedy(jcfg, jp, ins[0], WHOLE_MAX,
                                      WHOLE_DECODE, extra)
        IN["whole_inputs_" + tag] = ins
        IN["whole_feed_" + tag] = ref["whole_" + tag][1]
    IN["whole_max"] = WHOLE_MAX
    # the reference's decomposed KV of the 30-token prompt, then its
    # joint-softmax decode (frozen_len = 30)
    jcfg, jp, _ = models["seq30"]
    lg, cache = JDK.prefill_dkv(jp, jcfg, jnp.asarray(IN["seq30_tokens"]),
                                DKV_RANK, tail=DKV_TAIL,
                                engine=JDecomposeEngine(JEngineConfig()))
    tc = bridge.to_torch(jax.tree_util.tree_map(np.asarray, cache), "cpu")
    IN["dkv_template"] = tc
    IN["dkv_cache"] = {n: v.numpy().copy() for n, v in named_leaves(tc)}
    step = jax.jit(lambda p, t_, c, ps: JDK.decode_step_dkv(
        p, jcfg, t_, c, ps, frozen_len=SEQ30))
    feed, logits = [], []
    nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    for i in range(WHOLE_DECODE):
        pos = np.full((1,), SEQ30 + i, np.int32)
        feed.append((nxt, pos))
        lg, cache = step(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
        logits.append(np.asarray(lg))
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
    IN["dkv_feed"], ref["whole_dkv"] = feed, logits
    IN["ssm_tokens"] = _tokens(models["mamba2"][0], 2, SSM_PROMPT, 30)
    for tag in SSM_CASES:
        jcfg, jp, _ = models[tag]
        ref[tag] = _greedy(jcfg, jp, IN["ssm_tokens"], SSM_MAX, SSM_DECODE)
        IN["ssm_feed_" + tag] = ref[tag][1]
    for tag, (_, _, tp) in models.items():
        IN[tag + "_template"] = tp
        IN[tag] = {n: v.numpy().copy() for n, v in named_leaves(tp)}
    return IN, ref


@pytest.fixture(scope="module")
def world_procs(inputs, tmp_path_factory):
    IN = inputs[0]
    d = str(tmp_path_factory.mktemp("restworld"))
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
    yield procs, d
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jtrain(jcfg, tp, shape):
    """The reference's unsharded AdamW steps from the port's initial
    parameters on the reference's synthetic batches: (losses, grad
    norms, final params by path)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                bridge.to_numpy(tp))
    opt = jmake_optimizer(jcfg, warmup=1)
    st = opt.init(jp)
    fn = jax.jit(jsteps.make_train_step(jcfg, opt))
    src = JSynth(jcfg, JShape("t", *shape, "train"), JData())
    losses, norms = [], []
    for i in range(STEPS):
        jp, st, m = fn(jp, st, src.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {jsh._path_str(p): np.asarray(v) for p, v in
                           jax.tree_util.tree_flatten_with_path(jp)[0]}


@pytest.fixture(scope="module")
def reference(models, inputs, world_procs):
    """The reference's results, computed while the world works."""
    IN, ref = inputs
    out = dict(ref)
    jcfg, jp, _ = models["llama"]
    toks = jnp.asarray(IN["dec_tokens"])
    for mode, (attn, weights) in DEC_MODES.items():
        jpo = _jpolicy(weights)
        jrt = JD.DecomposedRuntime(policy=jpo, attn_mode=attn)
        log = []
        orig = jrt.engine.decompose_activation

        def rec(*a, **kw):
            lr = orig(*a, **kw)
            log.append(np.asarray(lr.o_idx))
            return lr
        jrt.engine.decompose_activation = rec
        fac = JD.decompose_layer_weights(jp, jcfg, jpo) if weights else None
        lg = np.asarray(JD.forward(jp, jcfg, toks, jrt, fac))
        idx = list(log)
        kl = float(JD.logit_kl(jp, jcfg, toks, jrt, fac))
        out[("dec", mode)] = (lg, kl, idx)
    for tag, s in SP_CASES.items():
        jcfg, jp, tp = models[tag]
        lg = np.asarray(jsteps.make_prefill_step(jcfg)(
            jp, jnp.asarray(IN["sp_tokens_" + tag]))[0])
        out[tag] = (lg,) + _jtrain(jcfg, tp, (s, 2))
    jcfg, jp, tp = models["seq30"]
    lg, cache = jsteps.make_prefill_step(jcfg)(
        jp, jnp.asarray(IN["seq30_tokens"]))
    out["seq30_whole"] = (np.asarray(lg), np.asarray(cache["k"]).shape)
    out["seq30_train"] = _jtrain(jcfg, tp, (SEQ30, 1))
    for tag in SSM_CASES:
        jcfg, _, tp = models[tag]
        out[tag + "_train"] = _jtrain(jcfg, tp, (SSM_PROMPT, 2))
    return out


@pytest.fixture(scope="module")
def world(world_procs, reference):
    procs, d = world_procs
    logs = [p.communicate(timeout=900)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rows(r, mname, b):
    """The batch rows rank ``r`` of a world of 4 runs on ``mname``: its DP
    block of ``b`` rows."""
    dp = int(mname.split("x")[0])
    n = b // dp
    i = r // (WORLD // dp)
    return slice(i * n, (i + 1) * n)


def _check_train(res, ref, p0):
    jl, jn, jparams = ref
    for a, b in zip(res["losses"] + res["norms"], jl + jn):
        assert abs(a - b) <= 1e-5 * abs(b), (res["losses"], jl,
                                             res["norms"], jn)
    for name, v in res["params"].items():
        dp_t, dp_j = v - p0[name], jparams[name] - p0[name]
        den = np.linalg.norm(dp_j)
        assert np.linalg.norm(dp_t - dp_j) <= 1e-3 * max(den, 1e-12), name


def _p0(models, tag):
    return {n: v.numpy() for n, v in named_leaves(models[tag][2])}


@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("mname", DEC_MESHES)
@pytest.mark.parametrize("mode", list(DEC_MODES))
def test_decomposed_forward_on_a_mesh_matches_reference(world, reference,
                                                        mode, mname, sp):
    """The paper's forward tensor-parallel on ``mname``: each rank's
    outlier channel sets equal the reference's for its rows at every one
    of the 4 decompositions, its rows' logits within ``LOGITS``, the
    batch's KL within 1e-3 relative."""
    lg_j, kl_j, idx_j = reference[("dec", mode)]
    assert len(idx_j) == 2 * len(DEC_ON)
    for r, res in enumerate(world):
        lg, kl, idx, _ = res[("dec", mode, mname, sp)]
        rows = _rows(r, mname, lg_j.shape[0])
        assert len(idx) == len(idx_j)
        for a, b in zip(idx, idx_j):
            np.testing.assert_array_equal(a, b[rows])
        np.testing.assert_allclose(lg, lg_j[rows], **LOGITS)
        np.testing.assert_allclose(kl, kl_j, rtol=1e-3)


@pytest.mark.parametrize("mname", DEC_MESHES)
def test_decomposed_forward_collectives(world, mname):
    """The decomposed forward's collectives: on (1, 4) the K/V columns
    gathered (2 kv heads on 4 ranks: the dense mode's reconstructions,
    the preserved mode's factor columns) and the row-parallel outputs
    all-reduced; under SP one ``sp_whole`` gather per decomposed block;
    on (2, 2) no factor all-gather over DP (each rank decomposes its own
    row, ``local``)."""
    for mode in DEC_MODES:
        off = world[0][("dec", mode, mname, False)][3]
        on = world[0][("dec", mode, mname, True)][3]
        assert "all_gather/factors" not in off
        assert "all_reduce/tp_out" in off
        assert "all_gather/sp_whole" not in off
        assert on["all_gather/sp_whole"][0] == len(DEC_ON)
        assert "reduce_scatter/sp_tp_out" in on
        kv = "k_vt" if mode == "preserved" else "k_cols"
        assert (("all_gather/" + kv) in off) == (mname == "1x4"), \
            (mode, sorted(off))


@pytest.mark.parametrize("tag", list(SP_CASES))
def test_sp_where_the_axis_does_not_divide_matches_reference(
        world, reference, models, tag):
    """Megatron-SP on (1, 4) over 30 tokens (8 rows a rank, the last
    block padded) and with replicated products: prefill logits within
    1e-5 relative, two AdamW steps at ``test_megatron_sp_matches_
    reference``'s bars; the prefill ran SP (its all-gathers and
    reduce-scatters along S), the replicated products on the residual
    gathered whole (``sp_whole``)."""
    lg_j = reference[tag][0]
    p0 = _p0(models, tag)
    for res in world:
        assert _rel(res[tag]["pre"][0], lg_j) < 1e-5, tag
        _check_train(res[tag], reference[tag][1:], p0)
        counts = res[tag]["pre"][1]
        assert "all_gather/sp_tp_in" in counts or tag == "sp_q_mlp_rep"
        assert "reduce_scatter/sp_embed" in counts, sorted(counts)
        if tag != "sp_uneven":
            assert "all_gather/sp_whole" in counts, sorted(counts)
        if tag == "sp_q_mlp_rep":         # nothing row-parallel left
            assert "reduce_scatter/sp_tp_out" not in counts
            assert "all_gather/sp_split_grad" in res[tag]["counts"]
        else:
            assert "reduce_scatter/sp_tp_out" in counts, sorted(counts)


def test_batch1_sequence_the_group_does_not_divide(world, reference,
                                                  models):
    """30 tokens on (4, 1): the prompt runs whole on every rank (no
    sequence collective); the prefill's logits within 1e-5 relative, its
    cache whole at 30 rows and the rules' 12-row block of a 48-row
    cache; six decode steps from that block (1e-4, greedy tokens equal);
    two train steps against the reference's."""
    want_lg, want_shape = reference["seq30_whole"]
    first, _, steps_lg = reference["seq30"]
    p0 = _p0(models, "seq30")
    for res in world:
        r = res["seq30"]
        lg, kshape, counts = r["whole"]
        assert _rel(lg, want_lg) < 1e-5
        assert kshape == want_shape
        assert not any("k_rows" in k or "last_hidden" in k for k in counts)
        assert _rel(r["pre48"][0], first) < 1e-5
        assert r["pre48"][1][2] == SEQ_MAX // WORLD
        for g, w in zip(r["dec"], steps_lg):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            assert g.argmax(-1).tolist() == w.argmax(-1).tolist()
        _check_train(r, reference["seq30_train"], p0)


@pytest.mark.parametrize("tag", ["seq30", "vlm", "dkv"])
def test_batch1_cache_the_group_does_not_divide_decodes_whole(
        world, reference, tag):
    """A 50-row batch-1 cache on (4, 1) (whole on every rank by the
    rules) decoded whole with ``cache_len``: the prefill's logits within
    1e-5 relative, three steps within 1e-4 and the greedy tokens of the
    reference; the vlm's 16-row cross cache (split by the rules) is
    gathered for each step and kept as the rank's block.  The reference's
    decomposed-KV factors of the 30-token prompt decode whole the
    same."""
    if tag == "dkv":
        got, want = [res["whole_dkv"] for res in world], \
            reference["whole_dkv"]
    else:
        first, _, steps_lg = reference["whole_" + tag]
        want = [first] + steps_lg
        got = []
        for res in world:
            logits, shapes, counts = res["whole_" + tag]
            self_k = shapes["self/k" if tag == "vlm" else "k"]
            assert self_k[-3] == WHOLE_MAX, shapes
            if tag == "vlm":
                assert shapes["cross/k"][-3] == 16 // WORLD
                assert counts["all_gather/xk_whole"][0] == WHOLE_DECODE
            assert _rel(logits[0], first) < 1e-5
            got.append(logits[1:])
        want = want[1:]
    for g_r in got:
        for g, w in zip(g_r, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            assert g.argmax(-1).tolist() == w.argmax(-1).tolist()


@pytest.mark.parametrize("tag", SSM_CASES)
def test_mamba2_where_m_does_not_divide_d_inner(world, reference, models,
                                                tag):
    """Every rank runs every head: the prefill's logits within 1e-5
    relative, three decode steps (1e-4, greedy tokens equal), two train
    steps at the SP bars; the whole ``ssm`` state on every rank, no
    all-reduce of ``out_proj`` or of the gated norm."""
    cfg = models[tag][0]
    assert cfg.d_inner % WORLD and cfg.ssm_heads % WORLD
    first, _, steps_lg = reference[tag]
    p0 = _p0(models, tag)
    for res in world:
        r = res[tag]
        lg, counts, shapes = r["pre"]
        assert _rel(lg, first) < 1e-5
        for g, w in zip(r["dec"], steps_lg):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            assert g.argmax(-1).tolist() == w.argmax(-1).tolist()
        _check_train(r, reference[tag + "_train"], p0)
        ssm = next(v for k, v in shapes.items() if k.endswith("ssm"))
        assert ssm[-3] == cfg.ssm_heads
        assert not {"all_reduce/tp_out", "all_reduce/gated_norm"} & set(
            counts) or tag == "zamba2", sorted(counts)
        assert "all_reduce/gated_norm" not in counts
        assert "all_reduce/gated_norm_grad" not in r["counts"]


def test_every_rank_issued_the_same_collectives(world):
    ops = [{k: v[0] for k, v in res["collectives"].items()}
           for res in world]
    assert all(o == ops[0] for o in ops[1:])
