"""The generator: the same seed gives the same inputs; every seed the
same sizes in another order; lengths at their distribution's quantiles;
in-flight requests part-way through outputs the stream drew."""
import math

import numpy as np
import pytest

from dcom_bench import bench, traffic as TR

BATCH = bench.load_json(bench.HERE / "traffic/dkv-batch.json")
SEED = 2**31 + 12345           # past 32 signed bits, as the driver's are


PLAIN = {k: v for k, v in BATCH.items() if k != "in_flight"}
LOGNORMAL = {"dist": "lognormal", "median": 512, "sigma": 0.8, "lo": 128,
             "hi": 2048}


@pytest.mark.parametrize("mix", [PLAIN, BATCH], ids=["plain", "in-flight"])
def test_same_seed_same_requests(mix):
    a, b = TR.Requests(mix, 1000, SEED), TR.Requests(mix, 1000, SEED)
    for i in range(40):
        assert a.prompt_len(i) == b.prompt_len(i)
        assert a.output_len(i) == b.output_len(i)
        assert np.array_equal(a.prompt(i), b.prompt(i))
    p = TR.Requests(mix, 1000, SEED).prompt(0)
    assert p.dtype == np.int32 and p.min() >= 1 and p.max() < 1000


@pytest.mark.parametrize("mix", [PLAIN], ids=["plain"])
def test_seeds_reorder_the_same_sizes(mix):
    n = int(mix.get("pool", TR.DEFAULT_POOL))
    a, b = TR.Requests(mix, 1000, 1), TR.Requests(mix, 1000, 2)
    la = sorted(a.prompt_len(i) for i in range(n))
    lb = sorted(b.prompt_len(i) for i in range(n))
    assert la == lb
    assert sorted(a.output_len(i) for i in range(n)) == \
        sorted(b.output_len(i) for i in range(n))
    assert [a.prompt_len(i) for i in range(n)] != \
        [b.prompt_len(i) for i in range(n)]


def test_in_flight_requests_are_one_set_in_the_seeds_order():
    """The first ``in_flight`` requests: the distributions' quantiles,
    each with a share (k + ½)/n of its output already served (rounded
    down to a multiple of the step) moved into its prompt; every seed
    holds the same requests in another order, so its window opens on
    the same work; every admission length plus budget stays within the
    cache; the stream proper follows them."""
    fl = BATCH["in_flight"]
    n, step = fl["requests"], fl["step"]
    sets, orders = [], []
    for seed in (SEED, 3):
        a, p = TR.Requests(BATCH, 1000, seed), TR.Requests(PLAIN, 1000, seed)
        got = []
        for i in range(n):
            s = a.served(i)
            base, out = a.prompt_len(i) - s, a.output_len(i) + s
            assert s % step == 0 and a.output_len(i) >= 1
            # its share of its output, rounded down to the step
            assert a.shares[i] - step / out < s / out <= a.shares[i]
            plen = -(-a.prompt_len(i) // step) * step
            assert plen + a.output_len(i) <= BATCH["max_len"]
            got.append((a.prompt_len(i), a.output_len(i)))
            assert base in TR.quantiles(BATCH["prompt"], n)
            assert out in TR.quantiles(BATCH["output"], n)
        assert sorted(got)[0] != sorted(got)[-1]
        assert np.allclose(np.sort(a.shares), (np.arange(n) + 0.5) / n)
        for j in range(5):
            assert a.served(n + j) == 0
            assert (a.prompt_len(n + j), a.output_len(n + j)) == \
                (p.prompt_len(j), p.output_len(j))
        sets.append(sorted(got))
        orders.append(got)
    assert sets[0] == sets[1] and orders[0] != orders[1]


def test_lognormal_quantiles():
    spec = LOGNORMAL
    v = TR.quantiles(spec, 512)
    assert v.min() >= spec["lo"] and v.max() <= spec["hi"]
    assert abs(np.median(v) - spec["median"]) <= 2
    # the 84th percentile of a lognormal sits at median·e^sigma
    want = spec["median"] * math.exp(spec["sigma"])
    assert abs(np.quantile(v, 0.8413) - want) / want < 0.02


def test_uniform_quantiles():
    spec = BATCH["prompt"]
    v = TR.quantiles(spec, 512)
    assert spec["lo"] <= v.min() <= spec["lo"] + 2
    assert spec["hi"] - 2 <= v.max() <= spec["hi"]
    assert abs(v.mean() - (spec["lo"] + spec["hi"]) / 2) < 2


def test_forward_tokens():
    a = TR.forward_tokens(102400, SEED, 1, 4096, 2)
    assert a.shape == (2, 1, 4096) and a.min() >= 1 and a.max() < 102400
    assert np.array_equal(a, TR.forward_tokens(102400, SEED, 1, 4096, 2))
    assert not np.array_equal(a[0], a[1])
