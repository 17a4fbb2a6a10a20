"""Offline batches: a queue that never empties.

Set-up leaves the engine full: the stream's in-flight requests hold the
slots, each part-way through its output.  Before every engine step the
queue is topped up to the slot count from the mix's seeded stream, so
every slot the engine frees is refilled at once.  ``output_tok_s`` is
every token delivered in the window (first tokens and decode tokens)
over the window.
"""
from __future__ import annotations

from . import _serve as S

setup = S.setup
release = S.release
check = S.check


def _feed(st, loop, now: float) -> None:
    from repro_torch.serving import Request
    depth = int(st.cell.traffic["slots"])
    while len(loop.eng.queue) < depth:
        i = st.next
        loop.submit(Request(uid=i, prompt=st.reqs.prompt(i),
                            max_new_tokens=st.reqs.output_len(i)), now)
        st.next += 1


def window(st, seconds: float, tw) -> dict:
    raw = S.run_window(st, seconds, tw, _feed)
    win = S.summarize(st, raw)
    win["e2e"] = {"output_tok_s": win["delivered"] / win["window_s"]}
    return win
