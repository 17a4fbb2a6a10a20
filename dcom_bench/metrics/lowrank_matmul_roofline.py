"""``lowrank_matmul``'s share of its roofline (%): each traced launch's
least time (Vᵀ [rank, H] @ W [H, N] in bf16; N in launch order Q, K, V,
up, gate of every decomposed block) summed, over the device time the
launches took."""
from dcom_bench import roofline as RF


def read(cell, win):
    t = win.get("trace")
    if not t:
        return None
    n, took = t["kernels"].get("lrmm_kernel", (0, 0.0))
    if not n or took <= 0:
        return None
    k, h = int(cell.traffic["policy"]["rank"]), cell.arch.d_model
    pattern = [RF.lowrank_matmul_bound_s(k, h, w)
               for w in RF.projection_widths(cell.arch)]
    return RF.share_pct(RF.per_launch_pattern(n, pattern), took)
