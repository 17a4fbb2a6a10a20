"""The yardstick's arithmetic against values worked by hand for
deepseek-7b, and the trace reduction and readers on synthetic input."""
import types

import numpy as np
import pytest

from dcom_bench import bench, roofline as RF, trace as T

DS = bench.arch_of(bench.load_json(bench.HERE / "configs/deepseek-7b.json"))
SC = bench.arch_of(bench.load_json(bench.HERE / "configs/starcoder2-7b.json"))


def test_matmul_params_deepseek():
    # per layer: wq, wo 4096·4096 each, wk, wv 4096·4096 each (32 kv
    # heads), gate/up/down 3·4096·11008 = 135,266,304 → 202,375,168;
    # 30 layers + the head 4096·102,400
    assert RF.matmul_params(DS) == 30 * 202_375_168 + 419_430_400


def test_prompt_flops_deepseek_4k():
    dense = 2 * 6_490_685_440 * 4096              # 53.17 TFLOP
    attn = 30 * 2 * 4096 * 4097 * 32 * 128        # 4.12 TFLOP
    assert RF.prompt_flops(DS, 4096) == dense + attn
    assert 57.2e12 < dense + attn < 57.4e12


def test_reorth_bounds_match_the_kernel_table():
    # A [1, 4096, 4096] float32 read once: 67.1 MB over 3.35 TB/s
    assert RF.reorth_bound_s("right", 1, 4096, 4096, 20) * 1e3 == \
        pytest.approx(0.0201, abs=5e-5)
    assert RF.reorth_bound_s("left", 1, 4096, 4096, 20) * 1e3 == \
        pytest.approx(0.0201, abs=5e-5)
    b, f = RF.reorth("left", 1, 4096, 4096, 20)
    assert b == 4 * (4096 * 4096 + 4096 + 4096 * 20 + 4096 + 1)
    assert f == 2 * 4096 * 4096 + 8 * 4096 * 20 + 2 * 4096


def test_lowrank_matmul_bounds_match_the_kernel_table():
    assert RF.lowrank_matmul_bound_s(20, 4096, 4096) * 1e3 == \
        pytest.approx(0.0101, abs=5e-5)
    assert RF.lowrank_matmul_bound_s(20, 4096, 11008) * 1e3 == \
        pytest.approx(0.0271, abs=5e-5)
    assert list(RF.projection_widths(DS)) == [4096, 4096, 4096, 11008,
                                               11008]
    assert list(RF.projection_widths(SC)) == [4608, 512, 512, 18432]


def test_mfu_of_a_805_ms_forward():
    f = RF.prompt_flops(DS, 4096)
    assert RF.mfu_pct(f, 0.805) == pytest.approx(100 * f / 0.805 / 989e12)
    assert 7.1 < RF.mfu_pct(f, 0.805) < 7.3


def test_union_and_gaps():
    s = np.array([0, 5, 20], np.int64)
    e = np.array([10, 15, 30], np.int64)
    assert T.union_ns(s, e) == 25
    assert T.gaps(s, e, 0, 40) == [(15, 20), (30, 40)]
    assert T.union_ns(np.array([3, 0]), np.array([4, 10])) == 10


def test_reduce_events_names_gaps_and_clips_to_the_window():
    ev = [(T.MARK, False, 100, 101), (T.MARK, False, 1100, 1101),
          ("step", False, 100, 1100), ("aten::item", False, 600, 900),
          ("void (anonymous namespace)::lrmm_kernel<8>(int)", True, 50, 300),
          ("ampere_sgemm_128x64_nn", True, 300, 500),
          ("ampere_sgemm_128x64_nn", True, 950, 1000)]
    r = T.reduce_events(ev)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["busy_s"] == pytest.approx((200 + 200 + 50) * 1e-9)
    assert r["kernels"]["lrmm_kernel"] == [1, pytest.approx(200e-9)]
    assert r["kernels"]["ampere_sgemm_128x64_nn"][0] == 2
    assert r["idle_gaps"][0] == ["step>aten::item", pytest.approx(450e-9)]
    assert r["device_ops"][0][0] == "ampere_sgemm_128x64_nn"


def _cell(name):
    m = bench.load_manifest()
    w = next(w for w in m["workloads"] if w["name"] == name)
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    return types.SimpleNamespace(
        arch=bench.arch_of(bench.load_json(bench.ROOT / conf["file"])),
        traffic=bench.load_json(bench.HERE / f"traffic/{w['traffic']}.json"))


def test_roofline_readers_on_a_synthetic_trace():
    cell = _cell("deepseek-7b.actdec-4k")
    left, right = RF.reorth_bound_s("left", 1, 4096, 4096, 20), \
        RF.reorth_bound_s("right", 1, 4096, 4096, 20)
    # 400 left and 380 right launches a forward, each at 4x its bound
    win = {"trace": {"kernels": {
        "reorth_left_kernel": [400, 400 * 4 * left],
        "reorth_right_kernel": [380, 380 * 4 * right],
        "lrmm_kernel": [50, 50 * 2e-5]}, "busy_s": 0.6, "window_s": 0.8}}
    assert bench.reader("reorth_roofline.actdec")(cell, win) == \
        pytest.approx(25.0)
    per_fwd = 10 * sum(RF.lowrank_matmul_bound_s(20, 4096, n)
                       for n in (4096, 4096, 4096, 11008, 11008))
    assert bench.reader("lowrank_matmul_roofline.actdec")(cell, win) == \
        pytest.approx(100 * per_fwd / (50 * 2e-5))
    assert bench.reader("device_idle.actdec")(cell, win) == \
        pytest.approx(25.0)
    assert bench.reader("reorth_roofline.actdec")(cell, {"trace": None}) \
        is None


def test_serving_readers():
    cell = _cell("starcoder2-7b.dkv-batch")
    win = {"delta": {"prefill_s": 3.0, "prefill_batches": 12,
                     "decode_s": 30.0, "decode_steps": 1500},
           "flops": 2e15, "window_s": 40.0}
    assert bench.reader("admission_ms.batch")(cell, win) == 250.0
    assert bench.reader("decode_step_ms.batch")(cell, win) == 20.0
    assert bench.reader("mfu.batch")(cell, win) == \
        pytest.approx(100 * 2e15 / 40 / 989e12)
    none = {"delta": dict(win["delta"], prefill_batches=0)}
    assert bench.reader("admission_ms.batch")(cell, none) is None
