"""Host time of one decode round (ms): the window's growth of the
engine's ``decode_s`` (decode launches and tail folds, each ending in a
token readback) over its growth of ``decode_steps``."""


def read(cell, win):
    d = win.get("delta")
    if not d or not d["decode_steps"]:
        return None
    return 1e3 * d["decode_s"] / d["decode_steps"]
