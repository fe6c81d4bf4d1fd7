"""solves_per_s: instances solved to tolerance in the window's sweeps, over
the window's wall time (a failed instance counts as no solve)."""


def read(r):
    return r.solved / r.window_s if r.mode == "sweep" else None
