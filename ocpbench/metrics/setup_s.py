"""setup_s: seconds from the start of the process to the first timed call
(imports, the card's start, kernel builds where the checkout has none, the
problem, the solver, the pool and the warm-up call)."""


def read(r):
    return r.setup_s
