"""The Bryson-Denham problem (Bryson, Denham and Dreyfus 1963), as the
plain reference states it: min x3(1) with dx1/dt = x2, dx2/dt = u,
dx3/dt = u^2 / 2, x(0) = (0, 1, 0), x1(1) = 0, x2(1) = -1, and the state
bound x1 <= l = 1/9. Published optimum J* = 4 / (9 l) = 4."""

import math

import torch

NX, NU = 3, 1
L = 1.0 / 9.0


def dynamics(x, u):
    return torch.stack([x[..., 1], u[..., 0], 0.5 * u[..., 0] ** 2], dim=-1)


lagrange = None


def mayer(x0, xf, t0, tf):
    return xf[..., 2]


BOUNDS = {
    "x": ([0.0, -10.0, 0.0], [L, 10.0, math.inf]),
    "u": ([-math.inf], [math.inf]),
    "x0": ([0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
    "xf": ([0.0, -1.0, 0.0], [0.0, -1.0, math.inf]),
    "t0": (0.0, 0.0),
    "tf": (1.0, 1.0),
    "duration": (0.0, math.inf),
}
