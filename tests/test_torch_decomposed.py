"""The decomposed (activation) forward of the port against
``repro.models.decomposed``: engine, block, forward, KL and the step
factories, on reduced llama2-7b in float32 with the JAX weights bridged
through numpy and the JAX Lanczos start vector passed in.

Tolerances: one decomposition agrees at float32 round-off (1e-4); the
whole forward carries that round-off through Lanczos and two layers, and
input+weight mode adds two LAPACKs' weight SVDs (max logit difference
2.3e-4 there, 2e-5 without), hence 1e-3 on logits and 1e-4 relative on
KL.  Outlier index sets must be EQUAL.
"""
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
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.engine import DecomposeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine.engine import _padded_z0  # noqa: E402
from repro.models import decomposed as JD  # noqa: E402
from repro.models import make_fake_batch, model_fns  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.engine import DecomposeEngine, EngineConfig  # noqa: E402
from repro_torch.models import decomposed as D  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

ONE = dict(rtol=1e-4, atol=1e-4)
LOGITS = dict(rtol=1e-3, atol=1e-3)


def _z0(h):
    return np.asarray(_padded_z0(h, h))


@pytest.fixture(scope="module")
def models():
    jcfg = all_archs()["llama2-7b"].reduced().replace(dtype="float32")
    tcfg = get_arch("llama2-7b").reduced().replace(dtype="float32")
    jp = model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 32),
                                            dtype=np.int32)
    return jcfg, jp, tcfg, tp, toks


def _record(engine, log):
    """Wrap ``engine.decompose_activation`` to log each call's indices."""
    orig = engine.decompose_activation

    def rec(*a, **kw):
        out = orig(*a, **kw)
        log.append(np.asarray(out.o_idx))
        return out
    engine.decompose_activation = rec


def _policies(**kw):
    return (jpol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw),
            pol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw))


def test_decompose_activation_matches_jax_engine():
    """Outlier indices equal; singular values, the outlier values and the
    reconstruction allclose; the factors are cast back to x's dtype."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 128).astype(np.float32)
    x[0, :, 5] += 9.0 * (rng.rand(32) < 0.5)
    x[1, :, 77] -= 9.0 * (rng.rand(32) < 0.5)
    jlp = jpol.LayerPolicy(decompose=True, rank=6, iters=10,
                           outlier_frac=0.03)
    tlp = pol.LayerPolicy(decompose=True, rank=6, iters=10,
                          outlier_frac=0.03)
    jl = JEngine(JConfig()).decompose_activation(jnp.asarray(x), lp=jlp,
                                                 threshold=3.0)
    tl = DecomposeEngine(z0=_z0).decompose_activation(torch.from_numpy(x),
                                                      lp=tlp, threshold=3.0)
    assert tl.o_idx.shape == (2, 4)             # round(0.03 · 128) = 4
    np.testing.assert_array_equal(tl.o_idx.numpy(), np.asarray(jl.o_idx))
    assert 5 in tl.o_idx[0].tolist() and 77 in tl.o_idx[1].tolist()
    np.testing.assert_allclose(tl.core.numpy(), np.asarray(jl.core), **ONE)
    np.testing.assert_allclose(tl.o_dense.numpy(), np.asarray(jl.o_dense),
                               **ONE)
    np.testing.assert_allclose(tl.reconstruct().numpy(),
                               np.asarray(jl.reconstruct()), **ONE)
    bf = DecomposeEngine(z0=_z0).decompose_activation(
        torch.from_numpy(x).bfloat16(), lp=tlp, threshold=3.0)
    assert bf.u.dtype == bf.o_dense.dtype == torch.bfloat16


@pytest.mark.parametrize("mode,weights", [("dense", False),
                                          ("preserved", False),
                                          ("dense", True)])
def test_forward_and_kl_match_jax(models, mode, weights):
    """Layers [0, 1] at rank 4 with 3 % outliers, in both attention modes
    and in input+weight mode: the same outlier channels at every
    decomposition, logits and KL(dense ‖ decomposed) close."""
    jcfg, jp, tcfg, tp, toks = models
    kw = dict(rank=4, outlier_frac=0.03)
    if weights:
        kw.update(decompose_weights=True, weight_rank=32)
    jpo, tpo = _policies(**kw)
    jrt = JD.DecomposedRuntime(policy=jpo, attn_mode=mode)
    teng = DecomposeEngine(EngineConfig(policy=tpo, attn_mode=mode), z0=_z0)
    jfac = JD.decompose_layer_weights(jp, jcfg, jpo) if weights else None
    tfac = D.decompose_layer_weights(tp, tcfg, tpo) if weights else None
    jlog, tlog = [], []
    _record(jrt.engine, jlog)
    _record(teng, tlog)
    lj = JD.forward(jp, jcfg, jnp.asarray(toks), jrt, jfac)
    lt = D.forward(tp, tcfg, torch.from_numpy(toks).long(), teng, tfac)
    assert len(tlog) == len(jlog) == 4
    for a, b in zip(tlog, jlog):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    kj = float(JD.logit_kl(jp, jcfg, jnp.asarray(toks), jrt, jfac))
    kt = float(D.logit_kl(tp, tcfg, torch.from_numpy(toks).long(), teng,
                          tfac))
    assert kt > 0
    np.testing.assert_allclose(kt, kj, rtol=1e-4)


def test_design_orderings_on_the_port(models):
    """DESIGN §7 on the port alone: KL falls as the rank rises, and at
    rank 4 outlier extraction lowers KL — on the tokens of the reference's
    own ordering tests (``tests/test_decomposed.py``): with random weights
    there are no real outlier channels, so the second ordering is a
    property of the data, not of every draw."""
    jcfg, _, tcfg, tp, _ = models
    batch = make_fake_batch(jcfg, ShapeSpec("smoke", 32, 2, "train"))
    t = torch.from_numpy(np.asarray(batch["tokens"])).long()

    def kl(**kw):
        tpo = pol.DecompositionPolicy.from_layer_list(2, [0, 1], **kw)
        q = steps.make_decomposed_quality_step(
            tcfg, EngineConfig(policy=tpo))
        return float(q(tp, t))

    kls = [kl(rank=r, outlier_frac=0.03, iters=min(r + 16, 48))
           for r in (2, 8, 32)]
    assert kls[0] > kls[1] > kls[2]
    assert kl(rank=4, outlier_frac=0.10) < kl(rank=4, outlier_frac=0.0)


def test_steps_and_backends(models):
    """The step factories resolve one engine with a policy; the
    ``"reference"`` backend gives the same logits as ``"cuda"`` on the
    host (both run the plain versions there)."""
    _, _, tcfg, tp, toks = models
    t = torch.from_numpy(toks).long()
    _, tpo = _policies(rank=4, outlier_frac=0.03)
    with pytest.raises(ValueError, match="DecompositionPolicy"):
        steps.make_decomposed_forward_step(tcfg, EngineConfig())
    outs = [steps.make_decomposed_forward_step(tcfg, DecomposeEngine(
        EngineConfig(policy=tpo, backend=b), z0=_z0))(tp, t)
        for b in ("cuda", "reference")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="attn_mode"):
        EngineConfig(attn_mode="factored")
    with pytest.raises(ValueError, match="backend"):
        EngineConfig(backend="pallas")
    cfg = EngineConfig(policy=tpo)
    assert cfg.layer(0).decompose and cfg.threshold(0) == 6.0
    assert not EngineConfig().layer(0).decompose
    assert cfg.with_policy(None).policy is None
