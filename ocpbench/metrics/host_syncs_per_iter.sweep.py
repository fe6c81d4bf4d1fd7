"""host_syncs_per_iter.sweep: the solver's host synchronizations over its
lockstep IPM iterations, in the window."""


def read(r):
    it = r.counters.get("outer_iterations", 0)
    return r.counters["host_syncs"] / it if r.mode == "sweep" and it else None
