"""The hyper-sensitive problem of Rao and Mease (2000), as the plain
reference states it: min 1/2 int_0^5000 (x^2 + u^2) dt with dx/dt = -x^3 + u,
x(0) = 1.5, x(5000) = 1. Published optimum J* = 1.33080711."""

NX, NU = 1, 1
TF = 5000.0


def dynamics(x, u):
    return -x ** 3 + u


def lagrange(x, u):
    return 0.5 * (x[..., 0] ** 2 + u[..., 0] ** 2)


mayer = None

BOUNDS = {
    "x": ([-50.0], [50.0]),
    "u": ([-50.0], [50.0]),
    "x0": ([1.5], [1.5]),
    "xf": ([1.0], [1.0]),
    "t0": (0.0, 0.0),
    "tf": (TF, TF),
    "duration": (0.0, float("inf")),
}
