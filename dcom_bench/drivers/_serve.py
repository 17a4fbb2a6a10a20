"""What the serving drivers share: the engine, its warm-up, the step
loop with the harness's own stamps, and the check against the plain
reference.

The engine is the port's ``serving.Engine`` (decomposed KV when the mix
gives ``kv_rank``), built from the mix's ``engine`` options (the
decompose engine's ``EngineConfig`` fields) with greedy sampling and no
stop token, so every request runs to its budget.  Set-up warms up the
cell's shapes, then admits the stream's in-flight requests, so the
window opens on a full engine.  The harness stamps a request when
``Engine.step()`` returns: its first token, and its end.  Before each
step it reads the engine's host state (live slots, positions, frozen
lengths) and, by the engine's documented fold rule (a slot whose tail
is full folds, and with it every live slot at least half full),
records where each request folds; after the step it checks that rule
against the frozen lengths the engine reports.  The reference replays
those folds.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .. import roofline as RF
from .. import traffic as TR
from .. import weights as W
from ..reference import dkv as REF
from ..reference.precision import Cast, no_tf32
from ..trace import TraceWindow

COUNTERS = ("prefill_s", "prefill_batches", "prefills", "decode_s",
            "decode_steps", "tokens_out")


def make_engine(cell, params, sampler=None):
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine
    tr = cell.traffic
    ecfg = EngineConfig(**tr["engine"])
    return Engine(cell.arch, params, slots=int(tr["slots"]),
                  max_len=int(tr["max_len"]),
                  decompose_engine=DecomposeEngine(ecfg),
                  device=torch.device(cell.device), sampler=sampler)


def plen_of(cell, n: int) -> int:
    """The admission length of an n-token prompt: n rounded up to the
    scheduler's bucket, or n where that reaches the cache's end."""
    b = int(cell.traffic["engine"].get("sched_bucket", 16))
    p = -(-max(n, 1) // b) * b
    return n if p >= int(cell.traffic["max_len"]) else p


class Loop:
    """The step loop and its records (set-up's and the window's)."""

    def __init__(self, eng):
        self.eng = eng
        self.recs: Dict[int, dict] = {}
        self.active: Dict[int, object] = {}
        self.delivered = 0
        self.schedule_errors: List[str] = []

    def submit(self, req, now: float) -> None:
        req.t_submit = now
        self.recs[req.uid] = {"n_prompt": len(req.prompt), "first": None,
                              "done": None, "folds": [], "plen": None,
                              "slot": None, "req": req}
        self.active[req.uid] = req
        self.eng.submit(req)

    def has_work(self) -> bool:
        return len(self.eng.queue) > 0 or any(
            r is not None for r in self.eng.live)

    def step(self, tw) -> float:
        eng = self.eng
        tail = eng.dkv_tail if eng.dkv_rank > 0 else 0
        live = [(i, r.uid, int(eng.pos[i]), int(eng.frozen_len[i]))
                for i, r in enumerate(eng.live) if r is not None]
        folds = {}
        if tail and live:
            occ = {uid: p - f for _, uid, p, f in live}
            if any(o >= tail for o in occ.values()):
                folds = {uid: p for _, uid, p, f in live
                         if occ[uid] >= max(1, tail // 2)}
        with tw.range("step"):
            finished = eng.step()
        now = time.perf_counter()
        for uid, p in folds.items():
            self.recs[uid]["folds"].append(p)
        if tail:
            for i, uid, p, f in live:
                r = eng.live[i]
                if r is not None and r.uid == uid:
                    want = folds.get(uid, f)
                    if int(eng.frozen_len[i]) != want:
                        self.schedule_errors.append(
                            f"uid {uid}: frozen {int(eng.frozen_len[i])}, "
                            f"rule {want}")
        for i, r in enumerate(eng.live):
            if r is not None and self.recs[r.uid]["plen"] is None:
                self.recs[r.uid]["plen"] = int(eng.pos[i]) - (
                    len(r.out_tokens) - 1)
                self.recs[r.uid]["slot"] = i
        for uid, r in list(self.active.items()):
            rec = self.recs[uid]
            n = len(r.out_tokens)
            if n and rec["first"] is None:
                rec["first"] = now
            self.delivered += n - rec.get("seen", 0)
            rec["seen"] = n
        for r in finished:
            self.recs[r.uid]["done"] = now
            self.active.pop(r.uid, None)
        return now


def counters(eng) -> Dict[str, float]:
    out = {k: float(getattr(eng.stats, k)) for k in COUNTERS}
    out["captures"] = float(eng.graphs.captures) \
        if getattr(eng, "graphs", None) is not None else 0.0
    return out


def setup(cell, sampler=None):
    cfg, tr = cell.arch, cell.traffic
    dev = torch.device(cell.device)
    params = W.make_params(cfg, cell.seed, dev, tr.get("weights"))
    st = SimpleNamespace(cell=cell, cfg=cfg, params=params, eng=None,
                         loop=None, next=0,
                         reqs=TR.Requests(tr, cfg.vocab, cell.seed))
    st.eng = make_engine(cell, params, sampler)
    t = time.perf_counter()
    warm_up(st)
    t1 = time.perf_counter()
    fill(st)
    st.phases = {"warm_up_s": t1 - t, "fill_s": time.perf_counter() - t1}
    return st


def _drain(eng) -> None:
    while len(eng.queue) or any(r is not None for r in eng.live):
        eng.step()


def warm_up(st) -> None:
    """The shapes the window reaches, before it.  First one request to
    the cache's end (a prompt of ``max_len`` − ``tail`` + 1 tokens,
    admitted at its exact length): the padded slab the captured blocks
    read takes its largest size now, so it is never reallocated, nor its
    graphs captured again, in the window.  Then, at that size, one
    request alone for each block length k up to ``decode_block`` (the
    mix's median prompt; budget k + 1: the prefill's token, then one
    block of k), so every block the window can run has its graph.
    Admissions and folds at the cell's load are warmed by :func:`fill`."""
    from repro_torch.serving import Request
    cell, eng = st.cell, st.eng
    tr = cell.traffic
    g = TR.rng(cell.seed, 3)
    max_len = int(tr["max_len"])
    tail = max(eng.dkv_tail, 2)
    plen = max_len - tail + 1
    blk = int(tr["engine"].get("decode_block", 1))
    mid = int(TR.quantiles(tr["prompt"], 1)[0])
    for uid, n, out in [(-1, plen, max(tail - 2, 1))] + [
            (-2 - k, mid, k + 1) for k in range(1, blk + 1)]:
        eng.submit(Request(uid=uid, prompt=g.integers(
            1, cell.arch.vocab, n).astype(np.int32), max_new_tokens=out))
        _drain(eng)
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()


def fill(st) -> None:
    """Admit the stream's in-flight requests (``traffic.Requests``), each
    into a slot of its own, through the harness's loop, which records
    their folds from here on: the window opens on the engine a steady
    backlog keeps full."""
    from repro_torch.serving import Request
    st.loop = loop = Loop(st.eng)
    now = time.perf_counter()
    for i in range(st.reqs.in_flight):
        loop.submit(Request(uid=i, prompt=st.reqs.prompt(i),
                            max_new_tokens=st.reqs.output_len(i)), now)
    st.next = st.reqs.in_flight
    off = TraceWindow(False)
    while len(st.eng.queue):
        loop.step(off)
    if torch.device(st.cell.device).type == "cuda":
        torch.cuda.synchronize()


def run_window(st, seconds: float, tw, feed) -> dict:
    """Step the engine for ``seconds``; ``feed(st, loop, now)`` submits
    what is due before each step.  Returns the window's raw records."""
    loop = st.loop
    loop.delivered = 0
    live0 = sum(r is not None for r in st.eng.live)
    c0 = counters(st.eng)
    t0 = time.perf_counter()
    tw.begin(t0)
    end = t0 + seconds
    now = t0
    while now < end or tw.active():
        feed(st, loop, now)
        if not loop.has_work():
            break
        now = loop.step(tw)
        tw.poll()
    tw.finish()
    c1 = counters(st.eng)
    return {"t0": t0, "t1": now, "window_s": now - t0, "live0": live0,
            "delta": {k: c1[k] - c0[k] for k in c0},
            "recs": loop.recs, "delivered": loop.delivered,
            "schedule_errors": list(loop.schedule_errors)}


def summarize(st, raw: dict) -> dict:
    """The quantities the serving drivers and readers share; ``facts``
    (printed with the result) says what the window held: live slots at
    its start, requests admitted and completed in it, and the graphs
    captured in it."""
    cfg = st.cfg
    t0 = raw["t0"]
    recs = list(raw["recs"].values())
    served = [r for r in recs if r["first"] is not None
              and (r["done"] is None or r["done"] >= t0)]
    done = [r for r in recs if r["done"] is not None and r["done"] >= t0]
    d = raw["delta"]
    admitted = [r for r in recs if r["req"].t_dispatch
                and r["req"].t_dispatch >= t0]
    flops = sum(RF.prompt_flops(cfg, r["n_prompt"]) for r in admitted) \
        + RF.decode_flops(cfg, d["tokens_out"])
    return {"window_s": raw["window_s"], "attempted": len(served),
            "failed": 0, "delivered": raw["delivered"],
            "completed": len(done), "delta": d, "flops": flops,
            "schedule_errors": raw["schedule_errors"],
            "facts": {"live_at_open": raw["live0"],
                      "admitted": int(d["prefills"]),
                      "completed": len(done),
                      "captures": int(d["captures"])}}


def release(st) -> None:
    st.eng = None
    if st.loop is not None:
        st.loop.eng = None
    gc.collect()
    if torch.device(st.cell.device).type == "cuda":
        torch.cuda.empty_cache()


def sample(st) -> List[dict]:
    """The requests the check reads, one a slot: of those served a second
    token (finished, or still decoding when the window closed: their
    tokens so far) and seen live after a step, the one with the most served tokens, then, over the
    other slots in an order drawn from the seed, one request of each
    (drawn from the seed too), until ``check.requests`` requests."""
    want_n = int(st.cell.traffic.get("check", {}).get("requests", 8))
    cand = sorted((r for r in st.loop.recs.values()
                   if len(r["req"].out_tokens) > 1
                   and r["slot"] is not None),
                  key=lambda r: r["req"].uid)
    if not cand:
        return []
    longest = max(cand, key=lambda r: len(r["req"].out_tokens))
    by_slot: Dict[int, list] = {}
    for r in cand:
        if r["slot"] != longest["slot"]:
            by_slot.setdefault(r["slot"], []).append(r)
    g = TR.rng(st.cell.seed, 2)
    out = [longest]
    for s in g.permutation(sorted(by_slot)):
        if len(out) >= want_n:
            break
        rs = by_slot[int(s)]
        out.append(rs[int(g.integers(len(rs)))])
    return out


def check(st, win: dict, fp8: bool = False) -> dict:
    """``served_gap`` and ``served_gap_mean``: over the sampled requests'
    served tokens, the widest and the mean gap by which a served token's
    reference logit lies below the reference's best at its position
    (with ``fp8``, the float8 control's top tokens in place of the served
    ones; the widest swings from seed to seed by its nature, the mean is
    the steady one); ``schedule_errors``: steps whose folds broke the
    engine's documented rule, and requests whose admission length broke
    the bucket rule (0 when none); ``unsampled``: 1 when fewer than
    ``check.requests`` slots were served a second token."""
    no_tf32()
    cfg, tr = st.cfg, st.cell.traffic
    picks = sample(st)
    reqs = []
    for r in picks:
        req = r["req"]
        plen = plen_of(st.cell, len(req.prompt))
        toks = np.zeros(plen + len(req.out_tokens) - 1, np.int64)
        toks[plen - len(req.prompt):plen] = req.prompt
        toks[plen:] = req.out_tokens[:-1]
        reqs.append({"tokens": toks, "plen": plen, "folds": r["folds"],
                     "served": np.asarray(req.out_tokens, np.int64),
                     "observed_plen": r["plen"]})
    bad_plen = sum(1 for q in reqs if q["observed_plen"] != q["plen"])
    e = tr["engine"]
    args = (int(e["kv_rank"]), int(e["kv_tail"]),
            int(e.get("kv_iters_extra", 8)))
    gaps = []
    if reqs:
        refs = REF.serve(st.params, cfg, reqs, *args, Cast())
        ctl = REF.serve(st.params, cfg, reqs, *args, Cast(fp8=True)) \
            if fp8 else None
        for j, (q, ref) in enumerate(zip(reqs, refs)):
            idx = ctl[j].argmax(-1) if fp8 else torch.as_tensor(
                q["served"], device=ref.device)
            best = ref.max(-1).values
            gaps.append(best - ref.gather(-1, idx[:, None])[:, 0])
    gap = torch.cat(gaps) if gaps else torch.zeros(1)
    want_n = int(tr.get("check", {}).get("requests", 8))
    return {"served_gap": float(gap.max()),
            "served_gap_mean": float(gap.mean()),
            "schedule_errors": float(len(win["schedule_errors"])
                                     + bad_plen),
            "unsampled": float(len(reqs) < want_n)}
