"""Driver kinds: one module per way of offering work to the port.

Each module has ``setup(cell) -> state`` (weights, the program's
objects, warm-up of the cell's shapes: all set-up), ``window(state,
seconds, trace) -> dict`` (the measured window), ``release(state)``
(frees the program's state, keeps what the check reads) and
``check(state, win, fp8=False) -> dict`` ({number: value} of the
comparison with the plain reference; ``fp8`` runs the control in the
program's place).  A window's dict holds ``window_s``, ``e2e`` (the
end-to-end quantities the driver can give), ``attempted``, ``failed``
and whatever its per-layer readers read.
"""
