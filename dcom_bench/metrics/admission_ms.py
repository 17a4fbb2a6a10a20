"""Host time of one admission batch (ms): the window's growth of the
engine's ``prefill_s`` (forward prefill, KV factorization, splice and
the first-token readback) over its growth of ``prefill_batches``."""


def read(cell, win):
    d = win.get("delta")
    if not d or not d["prefill_batches"]:
        return None
    return 1e3 * d["prefill_s"] / d["prefill_batches"]
