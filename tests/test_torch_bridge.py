"""Port scaffolding: the numpy bridge, the device rule, the import guard."""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import all_archs  # noqa: E402
from repro.models import model_fns  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.platform import resolve_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_bridge_round_trip_bf16_tree():
    """A reduced deepseek-7b JAX tree (bf16) crosses to torch and back
    exactly; bf16 leaves stay bf16 on the torch side."""
    cfg = all_archs()["deepseek-7b"].reduced()
    params = model_fns(cfg).init(jax.random.PRNGKey(0), cfg)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    t_tree = bridge.to_torch(np_tree, "cpu")
    back = bridge.to_numpy(t_tree)
    n = 0
    for (path, a), (_, t), (_, b) in zip(_leaves(np_tree), _leaves(t_tree),
                                         _leaves(back)):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16, path
        assert tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(b, a.astype(np.float32), err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(params))


def test_port_config_matches_reference():
    """The port's own config copy names the same shapes as repro's."""
    for name in ("llama2-7b", "deepseek-7b"):
        ref, port = all_archs()[name], get_arch(name)
        for cfg_r, cfg_p in ((ref, port), (ref.reduced(), port.reduced())):
            for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab", "activation",
                      "rope_theta", "dtype", "norm_eps", "padded_vocab",
                      "resolved_head_dim"):
                assert getattr(cfg_r, f) == getattr(cfg_p, f), (name, f)
            # what the port's dense model hard-wires
            assert cfg_r.gated_mlp and not cfg_r.use_bias \
                and not cfg_r.tie_embeddings and cfg_r.family == "dense"


NEW_ARCHS = ("starcoder2-7b", "gemma-2b", "granite-3-2b",
             "llama-3.2-vision-11b", "seamless-m4t-medium")
FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "d_ff", "vocab", "activation", "gated_mlp", "use_bias",
          "tie_embeddings", "rope_theta", "dtype", "norm_eps",
          "cross_attn_period", "num_image_tokens", "enc_layers",
          "num_audio_frames", "dec_layers", "is_encdec", "padded_vocab",
          "resolved_head_dim")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_reference(arch):
    """The five configs of the dense variants, the VLM and the audio
    family carry the reference's fields, full and reduced."""
    ref, port = all_archs()[arch], get_arch(arch)
    for cfg_r, cfg_p in ((ref, port), (ref.reduced(), port.reduced())):
        for f in FIELDS:
            assert getattr(cfg_r, f) == getattr(cfg_p, f), (arch, f)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_jax_trees_of_new_configs_match_port_init(arch):
    """The JAX init tree of each reduced config (the VLM's ``self``
    [groups, spg, …], its ``cross`` with 0-d float32 gates per group;
    the encoder-decoder's ``enc``, ``enc_norm`` and ``dec``; no
    ``lm_head`` when tied, no ``gate`` when ungated) crosses the bridge
    with the port's own ``init`` key set, shapes and dtypes."""
    from repro_torch.models import api
    jcfg, tcfg = all_archs()[arch].reduced(), get_arch(arch).reduced()
    jtree = bridge.to_torch(jax.tree_util.tree_map(
        np.asarray, model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)),
        "cpu")
    ttree = api.model_fns(tcfg).init(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(jtree)}
    got = {p: (tuple(t.shape), t.dtype) for p, t in _leaves(ttree)}
    assert got == want
    assert ("/lm_head/w" in got) != tcfg.tie_embeddings
    if tcfg.family == "vlm":
        groups = tcfg.num_layers // tcfg.cross_attn_period
        assert got["/cross/gate_attn"] == ((groups,), torch.float32)
        assert got["/self/attn/wq/w"][0][:2] == (groups,
                                                 tcfg.cross_attn_period - 1)


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_no_repro():
    """No file of the port (nor chip_smoke.py) imports jax, jaxlib or the
    top-level ``repro`` package."""
    banned = ("jax", "jaxlib", "repro")
    files = list(_port_files())
    assert len(files) > 15
    assert any(os.path.join("repro_torch", "lint", "") in f for f in files)
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, f"{path}: import {m}"


def test_entry_points_need_a_gpu_or_explicit_cpu(monkeypatch):
    """Without a GPU an entry point raises unless device='cpu' is asked."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama2-7b", "--reduced"])
    assert resolve_device("cpu").type == "cpu"
