"""A decomposed-KV prefill of a batch-1 prompt sharded over the DP group,
the port against the reference.

One gloo world of 4 processes, spawned once for the module (the workers
import torch and the port only, ``torch.set_num_threads(1)``), runs
``runtime.steps.make_dkv_prefill_step(..., mesh=)`` on a 32-token prompt
of reduced float32 ``llama2-7b`` at (4, 1) and (2, 2), with L = 4 layers
(D divides L: the time blocks become layer blocks by an all-to-all, each
rank decomposes its layers' whole K/V, a second all-to-all returns U·Σ
to its time block, Vᵀ is all-gathered) and L = 3 (it does not: every
rank gathers the whole K/V and decomposes every layer), then four
greedy ``make_dkv_decode_step`` steps from the cache it emitted.  The
reference's unsharded ``prefill_dkv`` and ``decode_step_dkv`` run in this
process on the same bridged weights and the same start vector:

* the prefill's last logits within 1e-5 relative;
* the singular values (U·Σ's column norms over the whole prompt) within
  1e-5 relative, and U·Vᵀ within 1e-4 of the largest entry;
* the rank's U·Σ rows the port's unsharded U·Σ's block (1e-5 of the
  largest entry);
* four greedy decode steps: the reference's tokens, logits within 1e-4;
* the collectives each rank counted: the all-to-alls and the Vᵀ
  all-gather where D divides L, the rows' all-gather where it does not.
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
from repro.engine import (DecomposeEngine as JDecomposeEngine,  # noqa: E402
                          EngineConfig as JEngineConfig)
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import decomposed_kv as JDK  # noqa: E402
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ARCH = "llama2-7b"
PROMPT, RANK, TAIL, STEPS = 32, 8, 8, 4
LAYERS = (4, 3)                    # D divides L at (4, 1) and (2, 2); not
MESHES = ("4x1", "2x2")
CASES = [(m, n) for m in MESHES for n in LAYERS]
IDS = [f"{m}-L{n}" for m, n in CASES]

_WORKER = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    from repro_torch.launch import mesh as M
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine
    from repro_torch.runtime import steps
    from repro_torch.tree import rebuild

    M.init_distributed("cpu", rank=rank, world_size=world, store_path=store)
    meshes = {"4x1": M.make_host_mesh(4, 1, "cpu"),
              "2x2": M.make_host_mesh(2, 2, "cpu")}
    IN = pickle.load(open(os.path.join(d, "in.pkl"), "rb"))
    z0 = IN["z0"]
    tok = torch.from_numpy(IN["tokens"]).long()
    out = {}
    for layers in IN["layers"]:
        cfg = get_arch(IN["arch"]).reduced().replace(dtype="float32",
                                                     num_layers=layers)
        whole = rebuild(IN["tmpl", layers],
                        {n: torch.from_numpy(v.copy())
                         for n, v in IN["params", layers].items()})
        eng = DecomposeEngine(z0=lambda h: z0)
        # the unsharded prefill, for the rank's rows of its U
        _, one = steps.make_dkv_prefill_step(cfg, IN["rank"],
                                             tail=IN["tail"], engine=eng)(
            whole, tok)
        for name, mesh in meshes.items():
            p = sh.shard_params(whole, mesh, cfg) \\
                if sh.model_size(mesh) > 1 else whole
            sh.reset_collective_counts()
            lg, cache = steps.make_dkv_prefill_step(
                cfg, IN["rank"], tail=IN["tail"], engine=eng, mesh=mesh)(
                    p, tok)
            counts = sh.collective_counts()
            blocks = {k: cache[k].clone() for k in ("k_u", "v_u")}
            dec = steps.make_dkv_decode_step(cfg, mesh)
            frozen = torch.tensor([IN["prompt"]], dtype=torch.int32)
            logits = []
            for t, pos in IN["feed", layers]:
                out_l, cache = dec(p, torch.from_numpy(t).long(), cache,
                                   torch.from_numpy(pos).long(), frozen)
                logits.append(out_l.numpy().copy())
            out[name, layers] = dict(
                logits=lg.numpy().copy(), counts=counts,
                dp_rank=sh.dp_rank(mesh),
                k_vt=cache["k_vt"].numpy().copy(),
                v_vt=cache["v_vt"].numpy().copy(),
                tail_rows=tuple(cache["tail"]["k"].shape),
                decode=logits,
                **{k: v.numpy().copy() for k, v in blocks.items()},
                **{"one_" + k: one[k].numpy().copy()
                   for k in ("k_u", "v_u")})
    pickle.dump(out, open(os.path.join(d, f"rank{rank}.pkl"), "wb"))
    M.shutdown_distributed()
''')


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


def _bridged(layers):
    jcfg = all_archs()[ARCH].reduced().replace(dtype="float32",
                                                num_layers=layers)
    jp = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return {n: _bridged(n) for n in LAYERS}


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(11).randint(0, 512, (1, PROMPT)).astype(
        np.int32)


@pytest.fixture(scope="module")
def reference(models, tokens):
    """Per depth: the reference's unsharded prefill_dkv (logits, factors)
    and its decode_step_dkv greedy steps (the fed (token, pos) pairs and
    each step's logits)."""
    out = {}
    for n, (jcfg, jp, _) in models.items():
        lg, cache = JDK.prefill_dkv(jp, jcfg, jnp.asarray(tokens), RANK,
                                    tail=TAIL,
                                    engine=JDecomposeEngine(JEngineConfig()))
        c0 = jax.tree_util.tree_map(np.asarray, cache)
        step = jax.jit(lambda p, t, c, ps, cfg=jcfg: JDK.decode_step_dkv(
            p, cfg, t, c, ps, frozen_len=PROMPT))
        feed, logits = [], []
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        for i in range(STEPS):
            pos = np.full((1,), PROMPT + i, np.int32)
            feed.append((nxt, pos))
            lgs, cache = step(jp, jnp.asarray(nxt), cache, jnp.asarray(pos))
            logits.append(np.asarray(lgs))
            nxt = np.asarray(lgs).argmax(-1).astype(np.int32)
        out[n] = (np.asarray(lg), c0, feed, logits)
    return out


@pytest.fixture(scope="module")
def world(models, tokens, reference, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seqdkv"))
    kvw = models[LAYERS[0]][0].num_kv_heads * \
        models[LAYERS[0]][0].resolved_head_dim
    IN = {"arch": ARCH, "layers": LAYERS, "prompt": PROMPT, "rank": RANK,
          "tail": TAIL, "tokens": tokens,
          "z0": np.asarray(_padded_z0(kvw, kvw))}
    for n, (_, _, tp) in models.items():
        IN["tmpl", n] = tp
        IN["params", n] = {k: v.numpy().copy() for k, v in named_leaves(tp)}
        IN["feed", n] = reference[n][2]
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
    try:
        logs = [p.communicate(timeout=600)[0].decode()[-3000:]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _whole_u(world, case, key):
    """U·Σ [L, 1, S, r] from the DP ranks' row blocks (model rank 0's)."""
    blocks = {}
    for res in world:
        blocks.setdefault(res[case]["dp_rank"], res[case][key])
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=2)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_dkv_prefill_logits_match_reference(world, reference, case):
    want = reference[case[1]][0]
    for res in world:
        assert _rel(res[case]["logits"], want) < 1e-5


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_dkv_singular_values_match_reference(world, reference, case):
    """U·Σ's columns over the whole prompt: their norms are the singular
    values, per layer."""
    ref = reference[case[1]][1]
    for key in ("k_u", "v_u"):
        got = np.linalg.norm(_whole_u(world, case, key), axis=2)
        want = np.linalg.norm(ref[key], axis=2)
        assert _rel(got, want) < 1e-5, key


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_dkv_reconstruction_matches_reference(world, reference, case):
    """U·Vᵀ of the reassembled factors within 1e-4 of the largest entry
    (Vᵀ whole over "model" from the model ranks' column blocks)."""
    ref = reference[case[1]][1]
    for k in ("k", "v"):
        vts = {}
        for res in world:
            vts.setdefault(res[case]["dp_rank"], []).append(
                res[case][k + "_vt"])
        vt = np.concatenate(vts[0], axis=-1)      # model ranks in order
        got = np.einsum("lbtr,lbrw->lbtw", _whole_u(world, case, k + "_u"),
                        vt)
        want = np.einsum("lbtr,lbrw->lbtw", ref[k + "_u"], ref[k + "_vt"])
        assert _rel(got, want) < 1e-4, k


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_dkv_rank_rows_are_the_whole_block(world, case):
    """Each rank's U·Σ rows [L, 1, S/D, r] are its block of the port's
    unsharded prefill's U·Σ, and its tail the rank's block of the tail's
    rows.  On (4, 1) with D not dividing L every rank decomposes the
    same whole K/V as the unsharded call: bit-equal.  Elsewhere the
    factors are the same up to the host's float sum order (a batch of
    L/D layers sums its batched products in another order than a batch
    of L: 4.4e-5 of the largest entry at L = 4 on (4, 1), on the host's
    CPU; on (2, 2) the
    K/V come from row-parallel sums over "model"), so within 1e-4 of the
    largest entry (a wrong block is O(1) off)."""
    mesh, layers = case
    d = 4 if mesh == "4x1" else 2
    for res in world:
        r = res[case]
        n = PROMPT // d
        i = r["dp_rank"]
        for key in ("k_u", "v_u"):
            assert r[key].shape[2] == n
            want = r["one_" + key][:, :, i * n:(i + 1) * n]
            if layers % d and mesh == "4x1":
                np.testing.assert_array_equal(r[key], want)
            else:
                assert _rel(r[key], want) < 1e-4, key
        assert r["tail_rows"][2] == TAIL * n // PROMPT


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_dkv_decode_matches_reference(world, reference, case):
    """Four greedy steps of ``make_dkv_decode_step`` on the same mesh from
    the cache the sharded prefill emitted: the reference's tokens, each
    step's logits within 1e-4."""
    want = reference[case[1]][3]
    for res in world:
        for got, w in zip(res[case]["decode"], want):
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
            assert got.argmax(-1).tolist() == w.argmax(-1).tolist()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_dkv_collectives(world, case):
    """Where D divides L: one all-to-all of the rows and one of U·Σ per K
    and per V, one all-gather of Vᵀ each, and no gather of the rows;
    where it does not: the rows all-gathered, no all-to-all.  Every rank
    issued the same."""
    mesh, layers = case
    d = 4 if mesh == "4x1" else 2
    counts = [{k: v[0] for k, v in res[case]["counts"].items()
               if "dkv_" in k} for res in world]
    assert all(c == counts[0] for c in counts[1:])
    if layers % d == 0:
        want = {f"{op}/dkv_{k}_{what}": 1 for k in ("k", "v")
                for op, what in (("all_to_all", "rows"), ("all_to_all", "u"),
                                 ("all_gather", "vt"))}
    else:
        want = {f"all_gather/dkv_{k}_rows": 1 for k in ("k", "v")}
    assert counts[0] == want, counts[0]
