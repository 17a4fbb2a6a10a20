"""The port's tools and sizes against the reference's: ``configs``'
SHAPES / all_archs / cells, ``models.api``'s abstract_params,
param_count, active_param_count and decomposed_fns, the H100 roofline
(``launch.roofline``), the shape-only dry-run (``launch.dryrun``) and its
report (``launch.report``).

The dry-run cells here are reduced configs on small fake meshes.  Their
collective counts are held against a real gloo world of 4 running the
same cells (one world, spawned by the ``world`` fixture, as
``tests/test_torch_tp.py`` does; the workers import no JAX).
Tolerances: decomposed_fns as ``tests/test_torch_decomposed.py`` (1e-3
on logits, 1e-4 relative on KL, reconstructions 1e-4 of their largest
entry); every count and every byte exactly.
"""
import json
import os
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
from jax.sharding import AbstractMesh  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.engine import DecomposeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS = dict(rtol=1e-3, atol=1e-3)
ARCHS = sorted(configs.all_archs())
#: reduced cells whose collectives the fake world must reproduce
WORLD_CELLS = (("granite-3-2b", "train"), ("granite-3-2b", "prefill"),
               ("granite-3-2b", "decode"), ("granite-3-2b", "dkv"),
               ("olmoe-1b-7b", "train"), ("mamba2-780m", "train"))
DKV_RANK = 8
WORLD_MESHES = {"14": (1, 4), "41": (4, 1)}


def _shape(kind):
    """The reduced cells' shapes ("dkv": a decode over a decomposed KV
    cache of rank DKV_RANK)."""
    return {"train": configs.ShapeSpec("t", 32, 8, "train"),
            "prefill": configs.ShapeSpec("p", 32, 8, "prefill"),
            "decode": configs.ShapeSpec("d", 32, 8, "decode"),
            "dkv": configs.ShapeSpec("d", 160, 8, "decode")}[kind]


def _z0(h):
    return np.asarray(_padded_z0(h, h))


# --- configs, abstract parameters, counts --------------------------------

def test_shapes_archs_and_cells_match_reference():
    ref = jconfigs.SHAPES
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in configs.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in ref.items()}
    assert configs.SHAPES["decode_32k"].is_decode
    assert sorted(configs.all_archs()) == sorted(jconfigs.all_archs())
    for name, cfg in configs.all_archs().items():
        assert configs.cells(cfg) == jconfigs.cells(jconfigs.get_arch(name))
        assert cfg.sub_quadratic == jconfigs.get_arch(name).sub_quadratic


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_counts_match_reference(arch):
    """Leaf names, shapes and dtypes of the meta tree equal the
    reference's ``jax.eval_shape`` tree; the counts are equal integers;
    nothing is allocated (every leaf on ``meta``)."""
    cfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
    got = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in named_leaves(api.abstract_params(cfg))}
    assert all(t.device.type == "meta"
               for _, t in named_leaves(api.abstract_params(cfg)))
    want = {jsh._path_str(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(
                japi.abstract_params(jcfg))[0]}
    assert got == want
    assert api.param_count(cfg) == japi.param_count(jcfg)
    assert api.active_param_count(cfg) == japi.active_param_count(jcfg)


@pytest.fixture(scope="module")
def llama():
    jcfg = jconfigs.get_arch("llama2-7b").reduced().replace(dtype="float32")
    tcfg = configs.get_arch("llama2-7b").reduced().replace(dtype="float32")
    jp = japi.model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 24),
                                            dtype=np.int32)
    return jcfg, jp, tcfg, tp, toks


def _recon(cache):
    """Each factored K and V (U·Vᵀ per layer and slot) and the tails."""
    out = {k: np.einsum("lbtr,lbrw->lbtw", np.asarray(cache[k + "_u"]),
                        np.asarray(cache[k + "_vt"])) for k in ("k", "v")}
    out.update({"tail_" + k: np.asarray(v)
                for k, v in cache["tail"].items()})
    return out


def _close(a, b, tol=1e-4):
    for k in b:
        scale = max(float(np.max(np.abs(b[k]))), 1e-30)
        assert float(np.max(np.abs(a[k] - b[k]))) <= tol * scale, k


def test_decomposed_fns_match_reference(llama):
    """forward / logit_kl under a 2-layer policy; prefill_dkv, one
    decode_step_dkv and the uniform compress_tail at the engine's rank
    and tail: logits, KL and the caches' reconstructions."""
    jcfg, jp, tcfg, tp, toks = llama
    kw = dict(rank=4, outlier_frac=0.03)
    jpo = jpol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw)
    tpo = pol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw)
    jf = japi.decomposed_fns(jcfg, JEngine(JConfig(policy=jpo, kv_rank=6,
                                                   kv_tail=4)))
    tf = api.decomposed_fns(tcfg, DecomposeEngine(
        EngineConfig(policy=tpo, kv_rank=6, kv_tail=4), z0=_z0))
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    np.testing.assert_allclose(tf.forward(tp, tt).numpy(),
                               np.asarray(jf.forward(jp, jt)), **LOGITS)
    np.testing.assert_allclose(float(tf.logit_kl(tp, tt)),
                               float(jf.logit_kl(jp, jt)), rtol=1e-4)

    jl, jc = jf.prefill_dkv(jp, jt)
    tl, tc = tf.prefill_dkv(tp, tt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    _close(_recon(tc), _recon(jc))
    s = toks.shape[1]
    tok = np.array([3, 7], np.int32)
    pos = np.full(2, s, np.int32)
    jl, jc = jf.decode_step_dkv(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                                s)
    tl, tc = tf.decode_step_dkv(tp, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos), s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    _close(_recon(tf.compress_tail(tc)), _recon(jf.compress_tail(jc)))
    assert tf.splice_dkv is not None and tf.engine.config.kv_rank == 6
    with pytest.raises(ValueError, match="dense"):
        api.decomposed_fns(configs.get_arch("mamba2-780m"), tf.engine)
    with pytest.raises(ValueError, match="policy"):
        api.decomposed_fns(tcfg, DecomposeEngine()).forward(tp, tt)


# --- the H100 roofline -----------------------------------------------------

def test_roofline_terms_math():
    """The reference's test with the H100's constants: one second of
    each term, an all-reduce at 2x; a type's InfiniBand part at IB's
    rate; FLOPs by dtype at their own peaks."""
    coll = {k: {"bytes": 0, "count": 0} for k in roofline._RING_FACTOR}
    coll["all-reduce"]["bytes"] = 450e9
    t = roofline.roofline_terms(989e12, 3.35e12, coll)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["collective_bytes"] == pytest.approx(900e9)
    coll["all-reduce"]["ib_bytes"] = 50e9
    coll["all-gather"].update(bytes=50e9, ib_bytes=50e9)
    t = roofline.roofline_terms({"bfloat16": 989e12, "float32": 67e12}, 0,
                                coll)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(2 * (400e9 / 450e9 + 1) + 1)
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert (roofline.HBM_BW, roofline.NVLINK_BW, roofline.IB_BW) == \
        (3.35e12, 450e9, 50e9)


def test_collective_stats_convert_sent_to_result_bytes():
    """Per op: an all-gather's result is group size x sent, a
    reduce-scatter's sent / group size, the others' what was sent; a
    one-rank group counts and moves nothing; a group spanning 8-GPU
    nodes goes to ``ib_bytes``."""
    node, span, one = (0, 1, 2, 3), (0, 8), (5,)
    counts = {"all_gather/params": {node: (2, 100), span: (1, 10)},
              "reduce_scatter/grads": {node: (3, 400)},
              "all_reduce/loss": {node: (1, 4), one: (7, 28)},
              "all_to_all/rows": {span: (1, 64)},
              "broadcast/expansion": {node: (1, 8)}}
    st = roofline.collective_stats(counts)
    assert st["all-gather"] == {"bytes": 4 * 100 + 2 * 10, "count": 3,
                                "ib_bytes": 20}
    assert st["reduce-scatter"] == {"bytes": 100, "count": 3,
                                    "ib_bytes": 0}
    assert st["all-reduce"] == {"bytes": 4, "count": 8, "ib_bytes": 0}
    assert st["all-to-all"] == {"bytes": 64, "count": 1, "ib_bytes": 64}
    assert st["broadcast"]["bytes"] == 8
    assert roofline.within_node(range(8)) and \
        not roofline.within_node(range(4, 12))


def test_cost_model_predicts_as_before():
    """The tuner's H100 model reads the roofline's constants and predicts
    exactly what it did with its own copies."""
    from repro_torch.tune import cost_model as cm
    assert (cm.H100.peak_flops, cm.H100.hbm_bw) == (67e12, 3.35e12)
    cases = {("matvec_expand", (4096, 4096), "float32", 8):
             2.113528196110357e-05,
             ("matvec_expand", (64, 4096, 4096), "bfloat16", 32):
             0.0008251623828783355,
             ("rmatvec_expand", (4096, 4096), "float32", 4):
             3.3586474029850745e-05,
             ("lanczos_reorth", (32, 512, 4096, 64), "float32", 16):
             9.86907227933062e-05,
             ("lanczos_reorth", (1, 4096, 4096, 26), "float32", 8):
             0.00013519826149253732}
    for (k, shape, dt, f), want in cases.items():
        assert cm.predict(k, shape, dt, {"expansion": f}) == want
    assert cm.predict("decode_block", (4, 1024, 4096), "bfloat16",
                      {"block": 8}) == 0.0037759154967164183


# --- the dry-run --------------------------------------------------------------

def _cell(arch, kind, sizes, **cfg_kw):
    cfg = configs.get_arch(arch).reduced().replace(**cfg_kw)
    names = ("data", "model") if len(sizes) == 2 else \
        ("pod", "data", "model")
    return dryrun.run_cell(cfg, _shape(kind), mesh_shape=(sizes, names),
                           decomposed_kv=DKV_RANK if kind == "dkv" else 0)


def test_sweep_is_the_reference_cell_list():
    """``--all --mesh both``: every reference arch but llama2-7b, its
    cells, both meshes (not run here)."""
    want = [(n, s, mp) for n, c in sorted(jconfigs.all_archs().items())
            if n != "llama2-7b" for s in jconfigs.cells(c)
            for mp in (False, True)]
    assert dryrun.sweep("both") == want
    assert dryrun.MESHES == {"single": ((16, 16), ("data", "model")),
                             "multi": ((2, 16, 16),
                                       ("pod", "data", "model"))}


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch,sizes", [
    ("granite-3-2b", (2, 2)), ("olmoe-1b-7b", (1, 4)),
    ("mamba2-780m", (2, 2)), ("granite-3-2b", (2, 2, 2))],
    ids=["dense-22", "moe-14", "ssm-22", "dense-pod"])
def test_parameter_bytes_follow_reference_rules(arch, sizes, kind):
    """Rank 0's parameter bytes equal the blocks of the reference's rule
    (``param_spec`` on an ``AbstractMesh``); the record holds the
    reference's keys; the process's distributed state and collective
    counts are as before the run."""
    import torch.distributed as dist
    sh.reset_collective_counts()
    before = dist.is_initialized()
    rec = _cell(arch, kind, sizes)
    assert dist.is_initialized() == before and sh.collective_counts() == {}
    names = ("data", "model") if len(sizes) == 2 else \
        ("pod", "data", "model")
    amesh = AbstractMesh(sizes, names)
    jcfg = jconfigs.get_arch(arch).reduced()
    want = 0
    for p, x in jax.tree_util.tree_flatten_with_path(
            japi.abstract_params(jcfg))[0]:
        spec = jsh.param_spec(jsh._path_str(p), tuple(x.shape), amesh, jcfg)
        n = int(np.prod(x.shape)) * x.dtype.itemsize
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n //= dict(zip(names, sizes))[a]
        want += n
    assert rec["memory"]["param_bytes"] == want
    for key in ("flops_per_device", "hbm_bytes_per_device", "collectives",
                "roofline", "model_flops_global", "model_flops_per_device",
                "useful_flops_ratio", "dominant_term", "roofline_fraction",
                "chips", "kind", "options", "memory"):
        assert key in rec, key
    assert rec["chips"] == int(np.prod(sizes)) and rec["kind"] == kind
    m = rec["memory"]
    assert m["peak_bytes"] >= m["argument_bytes"] > m["param_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    assert sum(rec["flops_by_dtype"].values()) == rec["flops_per_device"]


@pytest.mark.parametrize("arch,depths", [
    ("granite-3-2b", (1, 2, 3)), ("mamba2-780m", (1, 2, 3)),
    ("olmoe-1b-7b", (2, 3, 4))], ids=["dense", "ssm", "moe"])
def test_flops_are_linear_in_depth(arch, depths):
    """The Python loop counts every layer: f(3) − f(2) == f(2) − f(1)
    (olmoe's first layer is dense: depths 2..4), for a training step on
    a (2, 2) mesh; the model FLOPs follow the reference's formula."""
    recs = [_cell(arch, "train", (2, 2), num_layers=n) for n in depths]
    f = [r["flops_per_device"] for r in recs]
    assert f[2] - f[1] == f[1] - f[0] > 0
    cfg = configs.get_arch(arch).reduced().replace(num_layers=depths[0])
    assert recs[0]["model_flops_global"] == \
        6 * api.active_param_count(cfg) * 8 * 32


@pytest.mark.parametrize("case", ["mamba2_runs", "refusal_recorded"])
def test_refused_cells_are_recorded(case, monkeypatch):
    """Mamba2 on a "model" axis that does not divide d_inner (the rule
    replicates ``out_proj``), once refused, runs: the (1, 3) decode cell
    has a record, every rank runs every head, and ``out_proj`` and the
    gated norm issue no all-reduce.  A cell the port refuses
    (``NotImplementedError``, here a patched step builder) still gives
    its own error text, and the process's state is as before."""
    import torch.distributed as dist
    from repro_torch.runtime import steps as tsteps
    cfg = configs.get_arch("mamba2-780m").reduced()
    assert cfg.d_inner % 3
    if case == "refusal_recorded":
        def refuse(*a, **kw):
            raise NotImplementedError("not run here (ROADMAP.md A1)")
        monkeypatch.setattr(tsteps, "make_decode_step", refuse)
    rec = dryrun.run_cell(cfg, configs.ShapeSpec("l", 64, 1, "decode"),
                          mesh_shape=((1, 3), ("data", "model")))
    assert not dist.is_initialized()
    if case == "refusal_recorded":
        assert "A1" in rec["refused"] and "flops_per_device" not in rec
        return
    assert "refused" not in rec and rec["flops_per_device"] > 0
    counts = rec["collective_counts"]
    assert "all_gather/in_proj" in counts, sorted(counts)
    assert not {"all_reduce/tp_out", "all_reduce/gated_norm"} & set(counts)


def test_seq_parallel_cell_records_sp_collectives_beyond_dense():
    """A reduced kimi-k2 cell (a leading dense layer, then MoE layers) with
    ``seq_parallel`` on (2, 2): its record carries the Megatron-SP
    collectives of the dense block (the all-gathers and reduce-scatters
    along S, the residual gathered whole before the MoE blocks), where
    the port once ran it without them."""
    rec = _cell("kimi-k2-1t-a32b", "train", (2, 2), seq_parallel=True)
    assert "refused" not in rec and rec["flops_per_device"] > 0
    counts = rec["collective_counts"]
    for k in ("all_gather/sp_tp_in", "reduce_scatter/sp_tp_out",
              "reduce_scatter/sp_embed", "all_gather/sp_whole",
              "reduce_scatter/sp_tp_in_grad", "all_gather/sp_tp_out_grad"):
        assert counts.get(k, [0])[0] > 0, (k, sorted(counts))
    plain = _cell("kimi-k2-1t-a32b", "train", (2, 2))
    assert not [k for k in plain["collective_counts"] if "/sp_" in k]


def test_cli_refuses_xla_only_flags(tmp_path, capsys):
    for flag in ("--no-calibrate", "--donate", "--score-bf16"):
        with pytest.raises(SystemExit, match=flag):
            dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", flag])


def test_moe_shard_map_cell_holds_less_than_the_global_form():
    """``--moe-shard-map`` (``run_cell(moe_shard_map=True)``) runs the MoE
    blocks per shard: on (4, 1) each rank's dispatch buffers hold its own
    tokens' capacity, not the whole step's, so the cell's per-device
    peak and FLOPs fall below the default (global) form's; the batch-1
    moe cells run, refusing nothing."""
    glob = _cell("olmoe-1b-7b", "train", (4, 1))
    per = dryrun.run_cell(configs.get_arch("olmoe-1b-7b").reduced(),
                          _shape("train"),
                          mesh_shape=((4, 1), ("data", "model")),
                          moe_shard_map=True)
    assert per["options"] == {"moe_shard_map": "True"}
    assert per["memory"]["peak_bytes"] < glob["memory"]["peak_bytes"]
    assert per["flops_per_device"] < glob["flops_per_device"]
    assert per["memory"]["argument_bytes"] == \
        glob["memory"]["argument_bytes"]
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.run_cell(configs.get_arch("olmoe-1b-7b").reduced(),
                              configs.ShapeSpec("b", 64, 1, kind),
                              mesh_shape=((4, 1), ("data", "model")))
        assert "refused" not in rec and rec["flops_per_device"] > 0


_WORKER = textwrap.dedent('''
    import json, sys
    import torch
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, mesh as M
    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    CELLS, MESHES, SHAPES, RANK = json.loads(sys.argv[5])
    res = {}
    for tag, (d, m) in MESHES.items():
        mesh = M.make_host_mesh(d, m, "cpu")
        for arch, kind in CELLS:
            cfg = get_arch(arch).reduced()
            step, args, _ = dryrun.build_cell(
                cfg, ShapeSpec(*SHAPES[kind]), mesh,
                decomposed_kv=RANK if kind == "dkv" else 0)
            sh.reset_collective_counts()
            step(*args)
            res[f"{tag}/{arch}/{kind}"] = {
                k: list(v) for k, v in sh.collective_counts().items()}
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(res, fh)
    M.shutdown_distributed()
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's collective counts of every WORLD_CELLS cell on each mesh
    of WORLD_MESHES, from one real gloo world of 4."""
    d = str(tmp_path_factory.mktemp("toolsworld"))
    out = os.path.join(d, "rank0.json")
    shapes = {k: [s.name, s.seq_len, s.global_batch, s.kind]
              for k, s in ((k, _shape(k)) for k in ("train", "prefill",
                                                     "decode", "dkv"))}
    arg = json.dumps([WORLD_CELLS, WORLD_MESHES, shapes, DKV_RANK])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4",
                               os.path.join(d, "store"), out, arg], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(4)]
    logs = [p.communicate(timeout=600)[0].decode()[-3000:] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    with open(out) as fh:
        return json.load(fh)


@pytest.mark.parametrize("tag", sorted(WORLD_MESHES))
@pytest.mark.parametrize("arch,kind", WORLD_CELLS,
                         ids=[f"{a}-{k}" for a, k in WORLD_CELLS])
def test_fake_world_collectives_equal_gloo_world(world, tag, arch, kind):
    """The fake world's counted collectives (calls and bytes sent, per
    op and payload) equal a real gloo world's running the same step."""
    rec = _cell(arch, kind, WORLD_MESHES[tag])
    assert rec["collective_counts"] == world[f"{tag}/{arch}/{kind}"]
    # a DP-only serving step keeps its rows: no collective at all
    assert bool(rec["collective_counts"]) == (kind == "train"
                                              or tag == "14")


# --- the report -------------------------------------------------------------

def _record(arch, shape, mesh, kind, dom):
    terms = {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5,
             "collective_bytes": 3e9}
    terms[dom] = 4.0
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256,
            "kind": kind, "run_s": 1.5, "flops_per_device": 1e15,
            "hbm_bytes_per_device": 2e12, "roofline": terms,
            "dominant_term": dom, "roofline_fraction": 0.25,
            "useful_flops_ratio": 0.5,
            "memory": {"argument_bytes": int(4e9), "temp_bytes": int(6e9),
                       "peak_bytes": int(10e9)}}


def test_report_tables_have_the_reference_columns(tmp_path):
    """Two records give the reference's columns (XLA's compile seconds,
    argument and temp sizes named by their counterparts) and rows; a
    refused cell is listed apart; ``load`` reads the untagged files."""
    recs = [_record("a", "train_4k", "single", "train", "collective_s"),
            _record("b", "decode_32k", "single", "decode", "memory_s")]
    dry = report.dryrun_table(recs).splitlines()
    roof = report.roofline_table(recs, "single").splitlines()
    jdry = jreport.dryrun_table([]).splitlines()
    jroof = jreport.roofline_table([], "single").splitlines()
    assert roof[:2] == jroof[:2]
    assert len(dry[0].split("|")) == len(jdry[0].split("|"))
    assert dry[0].replace("run s", "compile s") == jdry[0]
    assert len(dry) == len(roof) == 4
    assert "| a | train_4k | 1.00e+00 | 2.00e+00 | 4.00e+00 | collective |" \
        in roof[2] and "10.0 GB" in roof[2]
    assert "| 4.00 | 6.00 |" in dry[2]
    refused = dict(recs[0], arch="c", refused="no (ROADMAP.md A1)")
    for r in recs + [refused]:
        dryrun.save_record(r, results_dir=str(tmp_path))
    loaded = report.load(results_dir=str(tmp_path))
    assert [r["arch"] for r in loaded] == ["a", "b", "c"]
    assert "| c | train_4k | single | no (ROADMAP.md A1) |" in \
        report.refused_table(loaded)
    assert "| c |" not in report.dryrun_table(loaded)
    assert not any("MXU" in v or "ICI" in v
                   for v in report.FIX_NOTES.values())


def test_new_modules_are_in_the_no_jax_walk():
    """The bridge test's walk of the port (no jax, no repro) reaches the
    modules of this slice."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from test_torch_bridge import _port_files
    finally:
        sys.path.pop(0)
    names = {os.path.relpath(f, REPO) for f in _port_files()}
    for m in ("core/svd_alt.py", "launch/roofline.py", "launch/dryrun.py",
              "launch/report.py"):
        assert os.path.join("src", "repro_torch", m) in names
