"""The fused re-orth kernels' share of their roofline (%): the sum of
each traced launch's least time over the device time the launches took.
Launches are the B = 1 Lanczos steps of the activation decomposition at
A [batch, S, H] (S the prompt length, H d_model) with a basis of
``iters`` columns: the count of each side is read from the trace, the
shape from the mix (there is no early exit, so every launch has it)."""
from dcom_bench import roofline as RF

KERNELS = {"right": "reorth_right_kernel", "left": "reorth_left_kernel"}


def read(cell, win):
    t = win.get("trace")
    if not t:
        return None
    tr = cell.traffic
    b, s, h = int(tr["batch"]), int(tr["prompt_len"]), cell.arch.d_model
    k = int(tr["policy"].get("iters") or tr["policy"]["rank"])
    bound = took = 0.0
    for side, name in KERNELS.items():
        n, sec = t["kernels"].get(name, (0, 0.0))
        bound += n * RF.reorth_bound_s(side, b, s, h, k)
        took += sec
    return RF.share_pct(bound, took) if took > 0 else None
