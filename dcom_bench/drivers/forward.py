"""Back-to-back forward calls of the activation-decomposition forward.

The mix names the batch, the prompt length, how many distinct prompts
the calls cycle through, the decomposition policy (layers, rank,
Lanczos steps, outlier share and threshold) and the decompose engine's
options.  The window calls the port's
``runtime.steps.make_decomposed_forward_step`` until ``seconds`` have
passed, then synchronizes: ``forward_ms`` is the window over the calls.
Every call's top token per position is kept on the device, and the
last logits of each prompt whole, for the check.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from .. import roofline as RF
from .. import traffic as TR
from .. import weights as W
from ..reference import actdec as REF
from ..reference.precision import Cast, no_tf32


def _policy(cell):
    pol = cell.traffic["policy"]
    return dict(rank=int(pol["rank"]),
                iters=int(pol.get("iters") or pol["rank"]),
                outlier_frac=float(pol["outlier_frac"]),
                threshold=float(pol["threshold"]),
                layers=[int(i) for i in pol["layers"]])


def setup(cell):
    from repro_torch.core.outlier import ThresholdTable
    from repro_torch.core.policy import DecompositionPolicy
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.runtime.steps import make_decomposed_forward_step
    cfg, tr = cell.arch, cell.traffic
    dev = torch.device(cell.device)
    params = W.make_params(cfg, cell.seed, dev, tr.get("weights"))
    toks = torch.as_tensor(TR.forward_tokens(
        cfg.vocab, cell.seed, int(tr["batch"]), int(tr["prompt_len"]),
        int(tr["prompts"])), device=dev)
    p = _policy(cell)
    policy = DecompositionPolicy.from_layer_list(
        cfg.num_layers, p["layers"], rank=p["rank"], iters=p["iters"],
        outlier_frac=p["outlier_frac"])
    policy.thresholds = ThresholdTable(default=p["threshold"])
    engine = DecomposeEngine(EngineConfig(policy=policy,
                                          **tr.get("engine", {})))
    fwd = make_decomposed_forward_step(cfg, engine)
    st = SimpleNamespace(cell=cell, cfg=cfg, params=params, toks=toks,
                         pol=p, engine=engine, fwd=fwd, last={}, tops=[],
                         order=[])
    for _ in range(int(tr.get("warmup_calls", 2))):
        fwd(params, toks[0])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st


def window(st, seconds: float, tw) -> dict:
    cfg, n_p = st.cfg, st.toks.shape[0]
    calls = 0
    t0 = time.perf_counter()
    tw.begin(t0)
    while True:
        i = calls % n_p
        with tw.range("forward"):
            logits = st.fwd(st.params, st.toks[i])
        st.tops.append(logits[..., :cfg.vocab].argmax(-1))
        st.order.append(i)
        st.last[i] = logits
        calls += 1
        if time.perf_counter() - t0 >= seconds and not tw.active():
            break
        tw.poll()
    if st.toks.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    tw.finish()
    win_s = t1 - t0
    flops = RF.prompt_flops(cfg, int(st.toks.shape[2])) * int(
        st.toks.shape[1])
    return {"window_s": win_s, "attempted": calls, "failed": 0,
            "calls": calls, "flops": flops * calls,
            "e2e": {"forward_ms": 1e3 * win_s / calls}}


def release(st) -> None:
    st.fwd = st.engine = None
    gc.collect()
    if st.toks.device.type == "cuda":
        torch.cuda.empty_cache()


def _gap(ref: torch.Tensor, idx: torch.Tensor) -> float:
    """The widest gap by which the chosen tokens' reference logits lie
    below the reference's best, over positions."""
    best = ref.max(-1).values
    got = ref.gather(-1, idx.long()[..., None])[..., 0]
    return float((best - got).max())


def check(st, win: dict, fp8: bool = False) -> dict:
    """``logits_rel_l2``: ‖program − reference‖ / ‖reference‖ over the
    whole logits of each prompt's last call (the largest); ``top1_gap``:
    over every call of the window and every position, the widest gap of
    the program's top token below the reference's best.  With ``fp8``
    the control (the reference in float8) stands in the program's
    place.  The reference takes the policy of ``st.cell`` (the cell's,
    also where a planted fault ran the program on another)."""
    no_tf32()
    cfg = st.cfg
    rel, gap = 0.0, 0.0
    pol = _policy(st.cell)
    layers = pol["layers"]
    for i, b in ((i, b) for i in sorted(st.last)
                 for b in range(st.toks.shape[1])):
        toks = st.toks[i, b]
        ref = REF.forward(st.params, cfg, toks, layers, pol, Cast())
        if fp8:
            got = REF.forward(st.params, cfg, toks, layers, pol,
                              Cast(fp8=True))
            idx_all = [got.argmax(-1)]
        else:
            got = st.last[i][b, :, :cfg.vocab].float()
            idx_all = [ix[b] for ix, o in zip(st.tops, st.order)
                       if o == i]
        rel = max(rel, float(torch.linalg.vector_norm(got - ref)
                             / torch.linalg.vector_norm(ref)))
        for ix in idx_all:
            gap = max(gap, _gap(ref, ix))
        del ref, got
    return {"logits_rel_l2": rel, "top1_gap": gap}
