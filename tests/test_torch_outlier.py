"""Outlier extraction, thresholds and the decomposition policy of the port
against the JAX package, on the same numpy inputs.

Index sets must be EQUAL (the statistics are exact and the score is the
reference's float32 expression); values compare at float32 round-off.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import outlier as jol  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro_torch.core import outlier as ol  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.core.lowrank import gather_channels  # noqa: E402


def _spiky(seed, b=2, s=48, h=96, n_spiky=5, scale=8.0):
    """Gaussian activations with ``n_spiky`` planted outlier channels per
    prompt (different channels in each prompt)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h).astype(np.float32)
    planted = []
    for i in range(b):
        ch = rng.choice(h, n_spiky, replace=False)
        rows = rng.rand(s, n_spiky) < 0.3
        x[i][:, ch] += np.where(rows, scale, 0.0).astype(np.float32)
        planted.append(set(ch.tolist()))
    return x, planted


@pytest.mark.parametrize("num_c", [3, 5, 9])
def test_select_outlier_channels_equals_jax(num_c):
    x, planted = _spiky(num_c)
    got = ol.select_outlier_channels(torch.from_numpy(x), 3.0, num_c)
    want = np.asarray(jol.select_outlier_channels(
        jnp.asarray(x), jnp.asarray(3.0, jnp.float32), num_c))
    assert got.dtype == torch.int64 and got.shape == (2, num_c)
    for i in range(2):
        assert set(got[i].tolist()) == set(want[i].tolist())
        assert got[i].tolist() == sorted(got[i].tolist())
        if num_c >= 5:
            assert planted[i] <= set(got[i].tolist())
    cnt = ol.channel_outlier_counts(torch.from_numpy(x), 3.0)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(
        jol.channel_outlier_counts(jnp.asarray(x), jnp.asarray(3.0))))


def test_extract_and_split_equal_jax():
    """(base, vals, idx) of one-shot extraction equal the reference's; the
    base keeps no outlier energy and base + scatter(vals) == x."""
    x, _ = _spiky(11, b=1, s=40, h=64)
    x2 = x[0]
    base, vals, idx = ol.extract(torch.from_numpy(x2), 3.0, 4)
    jb, jv, ji = jol.extract(jnp.asarray(x2), jnp.asarray(3.0), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(base.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert float(gather_channels(base, idx).abs().max()) == 0.0
    rebuilt = base.numpy().copy()
    rebuilt[:, idx.numpy()] += vals.numpy()
    np.testing.assert_array_equal(rebuilt, x2)


def test_measured_extraction_frac_matches_jax():
    x, _ = _spiky(12, b=1)
    got = ol.measured_extraction_frac(torch.from_numpy(x[0]), 3.0, 5)
    want = jol.measured_extraction_frac(jnp.asarray(x[0]), 3.0, 5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_engine_selects_on_bf16_as_on_its_float32_copy():
    """``DecomposeEngine.decompose_activation`` hands the statistics the
    activation in its own dtype: on a bf16 activation it selects the same
    channels as on its float32 copy and as the reference's
    ``select_outlier_channels`` on those float32 values (|x| of a bf16
    value is exact in float32)."""
    from repro_torch.core.policy import LayerPolicy
    from repro_torch.engine import DecomposeEngine
    x, planted = _spiky(21, b=2, s=40, h=128, n_spiky=4)
    xb = torch.from_numpy(x).bfloat16()
    lp = LayerPolicy(decompose=True, rank=4, iters=8, outlier_frac=0.03)
    num_c = round(0.03 * 128)
    eng = DecomposeEngine()
    got = eng.decompose_activation(xb, lp=lp, threshold=3.0)
    copy = eng.decompose_activation(xb.float(), lp=lp, threshold=3.0)
    want = np.asarray(jol.select_outlier_channels(
        jnp.asarray(xb.float().numpy()), jnp.asarray(3.0, jnp.float32),
        num_c))
    assert got.o_idx.shape == (2, num_c)
    assert torch.equal(got.o_idx, copy.o_idx)
    np.testing.assert_array_equal(got.o_idx.numpy(), want)
    for i in range(2):
        assert planted[i] <= set(got.o_idx[i].tolist())
    assert got.o_dense.dtype == torch.bfloat16


def test_calibrate_threshold_equals_jax():
    rng = np.random.RandomState(0)
    samples = rng.randn(4, 128, 256).astype(np.float32)
    samples[:, :, :8] *= 20.0
    for frac in (8 / 256, 0.05):
        assert ol.calibrate_threshold(samples, frac) == \
            jol.calibrate_threshold(samples, frac)


def test_threshold_table_crosses_packages(tmp_path):
    """A table one package saves, the other loads (both directions)."""
    jt = jol.ThresholdTable(default=5.5)
    jt.set(3, 4.5)
    jt.set(10, 2.25)
    jt.save(str(tmp_path / "jax.json"))
    tt = ol.ThresholdTable.load(str(tmp_path / "jax.json"))
    assert tt.get(3) == 4.5 and tt.get(10) == 2.25 and tt.get(0) == 5.5
    tt.set(7, 1.75)
    tt.save(str(tmp_path / "torch.json"))
    back = jol.ThresholdTable.load(str(tmp_path / "torch.json"))
    assert back.thresholds == {3: 4.5, 10: 2.25, 7: 1.75}
    assert back.default == 5.5
    with open(tmp_path / "torch.json") as f1, \
            open(tmp_path / "jax.json") as f2:
        assert json.load(f1)["default"] == json.load(f2)["default"]
    (tmp_path / "bad.json").write_text("{not json")
    with pytest.warns(RuntimeWarning):
        assert ol.ThresholdTable.load(str(tmp_path / "bad.json")).get(0) \
            == 6.0


@pytest.mark.parametrize("which", ["paper", "custom"])
def test_policy_json_is_byte_compatible(which):
    """The JAX policy's ``to_json()`` read by the port re-serializes to the
    same string, and the port's policy reads back into JAX the same."""
    if which == "paper":
        name, rank = jpol.PAPER_BEST_CONFIG
        jp = jpol.DecompositionPolicy.from_layer_list(
            32, jpol.PAPER_LAYER_CONFIGS[name], rank=rank, outlier_frac=0.03)
    else:
        jp = jpol.DecompositionPolicy.from_layer_list(
            4, [0, 2], rank=4, outlier_frac=0.05, decompose_weights=True,
            weight_rank=8, iters=12, expansion_factor=4)
        jp.thresholds.set(2, 3.5)
    s = jp.to_json()
    tp = pol.DecompositionPolicy.from_json(s)
    assert tp.to_json() == s
    assert tp.decomposed_layers() == list(jp.decomposed_layers())
    assert jpol.DecompositionPolicy.from_json(tp.to_json()).to_json() == s
    assert pol.PAPER_LAYER_CONFIGS == jpol.PAPER_LAYER_CONFIGS
    assert pol.PAPER_BEST_CONFIG == jpol.PAPER_BEST_CONFIG
