"""Legendre-Gauss-Radau points and the operators built on them, worked out
from their definitions in NumPy, for the benchmark's plain reference.

The N collocation points of one segment are the roots of P_{N-1} + P_N on
[-1, 1) (the first is -1); the state is carried on those points and on +1.
The differentiation matrix maps the state at the N + 1 support points to its
derivative at the N collocation points; its last N columns, inverted, are
the integration matrix of the same points.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre


def points_weights(n: int):
    """The n LGR points (ascending, the first -1) and their quadrature weights."""
    if n == 1:
        return np.array([-1.0]), np.array([2.0])
    c = np.zeros(n + 1)
    c[n - 1] = c[n] = 1.0
    x = np.sort(np.real(legendre.legroots(c)))
    x[0] = -1.0
    dc = legendre.legder(c)
    for _ in range(3):                       # Newton polish of the interior roots
        x[1:] -= legendre.legval(x[1:], c) / legendre.legval(x[1:], dc)
    p = legendre.legval(x, np.eye(n)[n - 1])  # P_{n-1} at the points
    w = (1.0 - x) / (n * n * p * p)
    w[0] = 2.0 / (n * n)
    return x, w


def bary_weights(s: np.ndarray) -> np.ndarray:
    diff = s[:, None] - s[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def diff_matrix(s: np.ndarray) -> np.ndarray:
    """(len(s) - 1, len(s)): derivative, at every support point but the
    last, of the polynomial through the values at the support points ``s``."""
    b = bary_weights(s)
    diff = s[:, None] - s[None, :]
    np.fill_diagonal(diff, 1.0)
    D = (b[None, :] / b[:, None]) / diff
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return D[:-1]


def interp_matrix(s: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(len(x), len(s)): values at ``x`` of the polynomial through the
    values at the support points ``s`` (barycentric form)."""
    b = bary_weights(s)
    x = np.asarray(x, float)
    d = x[:, None] - s[None, :]
    exact = d == 0.0
    d = np.where(exact, 1.0, d)
    M = b[None, :] / d
    M /= M.sum(axis=1, keepdims=True)
    hit = exact.any(axis=1)
    M[hit] = exact[hit].astype(float)
    return M


def segment(n: int):
    """One segment of n collocation points on [-1, 1]: (points, weights,
    support points, D (n, n + 1))."""
    x, w = points_weights(n)
    s = np.append(x, 1.0)
    return x, w, s, diff_matrix(s)


def integration_matrix(n: int) -> np.ndarray:
    """(n, n): the state at the last n support points of an n-point segment,
    less the state at -1, from the derivative at the n collocation points."""
    return np.linalg.inv(segment(n)[3][:, 1:])
