"""ipm_iter_ms.sweep: the window's wall time over the lockstep IPM
iterations its sweeps ran (the solver's ``outer_iterations``)."""


def read(r):
    it = r.counters.get("outer_iterations", 0)
    return 1e3 * r.window_s / it if r.mode == "sweep" and it else None
