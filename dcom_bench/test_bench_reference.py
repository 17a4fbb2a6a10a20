"""The plain reference against the port at reduced sizes on the host, the
control coming out as not correct, and a run with the timed path broken
coming out as not correct.

At float32 the port and the reference compute the same mathematics
(outlier channels, Lanczos factors, KV factors and their folds), so they
agree to rounding; the bf16 port and the float8 control then differ
from the reference by their precision.
"""
import numpy as np
import pytest
import torch

from dcom_bench import bench, harness
from dcom_bench.drivers import _serve as S
from dcom_bench.drivers import forward as F
from dcom_bench.reference import lanczos as LZ
from dcom_bench.trace import TraceWindow

DENSE = {"num_layers": 3, "d_model": 128, "num_heads": 4, "num_kv_heads": 4,
         "d_ff": 256, "vocab": 512}
VARIANT = dict(DENSE, num_kv_heads=2, use_bias=True, gated_mlp=False,
               activation="gelu")
ACTDEC = {"prompt_len": 64, "prompts": 2, "warmup_calls": 1,
          "policy": {"layers": [1], "rank": 8, "outlier_frac": 0.03,
                     "threshold": 3.0}}
SERVE = {"slots": 4, "max_len": 96, "pool": 8,
         "prompt": {"dist": "uniform", "lo": 20, "hi": 48},
         "output": {"dist": "uniform", "lo": 8, "hi": 48},
         "in_flight": {"requests": 4, "step": 8},
         "engine": {"backend": "cuda", "kv_rank": 8, "kv_tail": 4,
                    "kv_iters_extra": 2, "decode_block": 2,
                    "sched_bucket": 8},
         "check": {"requests": 4}}
BATCH = "starcoder2-7b.dkv-batch"


class Steps(TraceWindow):
    """A window that stays open for at least ``n`` units of work (forward
    calls or engine steps: the driver opens a host range around each), an
    untraced trace window whose traced part lasts that long, so a test's
    work does not depend on how fast the host runs."""

    def __init__(self, n: int = 40):
        super().__init__(False)
        self.left = n

    def range(self, name):
        self.left -= 1
        return super().range(name)

    def active(self):
        return self.left > 0


@pytest.fixture
def steps(monkeypatch):
    """``harness.measure`` with :class:`Steps` windows."""
    monkeypatch.setattr(harness, "TraceWindow",
                        lambda *a, **k: Steps())


def _forward(cell, arch, seed=7):
    c = bench.load_cell(cell, seed, "cpu",
                        overrides={"arch": arch, "traffic": ACTDEC})
    st = F.setup(c)
    win = F.window(st, 0.0, Steps(3))
    F.release(st)
    return st, win


@pytest.mark.parametrize("cell,arch", [
    ("deepseek-7b.actdec-4k", dict(DENSE, dtype="float32")),
    ("starcoder2-7b.actdec-4k", dict(VARIANT, dtype="float32"))],
    ids=["dense", "bias-gqa-gelu"])
def test_actdec_reference_matches_the_port_in_float32(cell, arch):
    st, win = _forward(cell, arch)
    got = F.check(st, win)
    assert got["logits_rel_l2"] < 1e-4
    assert got["top1_gap"] < 1e-4


def test_actdec_control_reads_far_above_the_port():
    """The float8 control in the program's place, at a size a test run
    holds: each number reads over 3x the bf16 port's (the limits, set on
    the card at the cell's size, lie between the two; control.py reads
    them there)."""
    st, win = _forward("deepseek-7b.actdec-4k", DENSE)
    prog, ctl = F.check(st, win), F.check(st, win, fp8=True)
    for n in ("logits_rel_l2", "top1_gap"):
        assert ctl[n] > 3 * prog[n], (n, prog[n], ctl[n])


def _serve(cell, arch, traffic, sampler=None, seed=11, n=40):
    c = bench.load_cell(cell, seed, "cpu",
                        overrides={"arch": arch, "traffic": traffic})
    st = S.setup(c, sampler)
    drv = bench.driver(c.kind)
    win = drv.window(st, 0.0, Steps(n))
    S.release(st)
    return st, win


@pytest.mark.parametrize("arch", [dict(VARIANT, dtype="float32"),
                                  dict(DENSE, dtype="float32")],
                         ids=["bias-gqa-gelu", "dense"])
def test_dkv_reference_matches_the_port_in_float32(arch):
    st, win = _serve(BATCH, arch, SERVE)
    # the window opened on a full engine and refilled the slots it freed
    assert win["facts"]["live_at_open"] == SERVE["slots"]
    assert win["facts"]["completed"] > 0 and win["facts"]["admitted"] > 0
    picks = S.sample(st)
    assert len(picks) == SERVE["check"]["requests"]
    assert len({p["slot"] for p in picks}) == len(picks)
    assert any(p["folds"] for p in picks)
    assert sum(len(p["req"].out_tokens) for p in picks) >= 30
    got = S.check(st, win)
    assert got["served_gap"] < 1e-4
    assert got["schedule_errors"] == 0 and got["unsampled"] == 0


def test_dkv_control_reads_far_above_the_port():
    """As the forward's: the float8 control's mean served-token gap, the
    number the cell's limit is set on, over 3x the bf16 port's at a size
    a test run holds (the tiny one above is too shallow for the gap to
    part them)."""
    arch = dict(VARIANT, num_layers=6, d_model=256, num_heads=8, d_ff=512,
                vocab=2048)
    traffic = dict(SERVE, max_len=320,
                   prompt={"dist": "uniform", "lo": 100, "hi": 200},
                   output={"dist": "uniform", "lo": 40, "hi": 100},
                   engine=dict(SERVE["engine"], kv_rank=16, kv_tail=8,
                               kv_iters_extra=4, decode_block=4,
                               sched_bucket=16),
                   in_flight={"requests": 4, "step": 16},
                   check={"requests": 3})
    st, win = _serve(BATCH, arch, traffic, seed=1, n=60)
    prog, ctl = S.check(st, win), S.check(st, win, fp8=True)
    assert prog["unsampled"] == 0
    assert ctl["served_gap_mean"] > 3 * prog["served_gap_mean"]


def _altered(logits, k=1):
    """Greedy, but every token the model would emit with id ≡ 3 (mod 7)
    comes out as the next id: a token altered where it is produced."""
    t = torch.argmax(logits, -1)
    return torch.where(t % 7 == 3, (t + 1) % logits.shape[-1], t).to(
        torch.int32)


@pytest.mark.parametrize("arch", [dict(VARIANT, dtype="float32"),
                                  dict(DENSE, dtype="float32")],
                         ids=["bias-gqa-gelu", "dense"])
def test_a_run_with_tokens_altered_is_not_correct(arch, steps):
    """The whole run but the look for a card, with the port's sampler
    altering tokens as it produces them."""
    over = {"arch": arch, "traffic": SERVE}
    out, checks, _ = harness.measure(BATCH, 11, 1.5, False, device="cpu",
                                     overrides=over, sampler=_altered)
    assert not out["correct"]
    assert dict((n, v > lim) for n, v, lim in checks)["served_gap_mean"]
    ok, _, _ = harness.measure(BATCH, 11, 1.5, False, device="cpu",
                               overrides=over)
    assert ok["correct"]
    assert ok["window"]["live_at_open"] == SERVE["slots"]


def test_a_run_with_an_answer_altered_is_not_correct(monkeypatch, steps):
    """The forward's logits altered where the head produces them."""
    from repro_torch.models import transformer as T
    head = T.logits_head

    def altered(*a, **k):
        out = head(*a, **k)
        return out + 0.5 * (out.roll(1, dims=-1) - out)
    monkeypatch.setattr(T, "logits_head", altered)
    cell = "deepseek-7b.actdec-4k"
    over = {"arch": dict(DENSE, dtype="float32"), "traffic": ACTDEC}
    out, _, _ = harness.measure(cell, 5, 0.3, False, device="cpu",
                                overrides=over)
    assert not out["correct"]
    monkeypatch.setattr(T, "logits_head", head)
    out, _, _ = harness.measure(cell, 5, 0.3, False, device="cpu",
                                overrides=over)
    assert out["correct"]


def test_a_planted_fault_runs_in_the_program_alone():
    """control.py's ``--faults``: the program runs the fault's policy
    (rank 4 of the cell's 8), the check's reference the cell's; the
    fault reads far above the program (the limits' third reading)."""
    from dcom_bench import control
    c = bench.load_cell("deepseek-7b.actdec-4k", 7, "cpu", overrides={
        "arch": dict(DENSE, dtype="float32"), "traffic": ACTDEC})
    bad = control.faulty(c, {"policy": {"rank": 4}})
    assert bad.traffic["policy"] == dict(ACTDEC["policy"], rank=4)
    assert c.traffic["policy"] == ACTDEC["policy"]
    got = {}
    for who, cell in (("program", c), ("fault", bad)):
        st = F.setup(cell)
        win = F.window(st, 0.0, Steps(2))
        F.release(st)
        assert st.engine is None
        st.cell = c
        got[who] = F.check(st, win)
    assert got["program"]["logits_rel_l2"] < 1e-4
    assert got["fault"]["logits_rel_l2"] > 100 * max(
        got["program"]["logits_rel_l2"], 1e-6)


def test_lanczos_reference_is_the_truncated_svd_at_full_steps():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 40, 24, generator=g) @ torch.diag(
        torch.logspace(0, -3, 24))
    us, vt = LZ.svd(a, 5, 24)
    u, s, v = torch.linalg.svd(a, full_matrices=False)
    want = (u[..., :5] * s[:, None, :5]) @ v[:, :5]
    assert torch.allclose(us @ vt, want, atol=1e-4)
    # zero rows below do not change the factors of the rows above
    pad = torch.cat([a, torch.zeros(2, 9, 24)], dim=1)
    us2, vt2 = LZ.svd(pad, 5, 12)
    us1, vt1 = LZ.svd(a, 5, 12)
    assert torch.allclose(us2[:, :40] @ vt2, us1 @ vt1, atol=1e-4)
    assert np.allclose(us2[:, 40:].numpy(), 0.0)
