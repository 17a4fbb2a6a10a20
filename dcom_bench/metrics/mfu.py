"""The whole step's share of the card's bf16 peak (%): the dense
model's FLOPs for the work the window delivered (prompt tokens: 2 per
parameter and token plus causal attention; decode tokens: 2 per
parameter), over the window's seconds × 989 TFLOP/s.  The count is the
same whatever implements the model."""
from dcom_bench.roofline import mfu_pct


def read(cell, win):
    if not win.get("flops") or not win.get("window_s"):
        return None
    return mfu_pct(win["flops"], win["window_s"])
