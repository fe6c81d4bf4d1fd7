"""Interpolation operators: barycentric Lagrange and natural cubic splines.

Counterparts of the reference's ``BarLagrangeInterp``
(``Lpopc/src/Core/LpSolutionError.cpp:10-52``) and the cubic
spline pair ``spline_second_derivative`` / ``spline_interpolation``
(``LpGuessChecker.cpp:208-294``). Both run on the host, between solves
(error estimation, mesh refinement, warm starts), never on the device hot
path: interpolation from a fixed support grid to fixed targets is a dense
matrix (``interpolation_matrix``); the cubic spline uses a vectorized
tridiagonal solve.
"""

from __future__ import annotations

import numpy as np

from .lgr import barycentric_weights


def interpolation_matrix(support: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Dense (T, S) barycentric Lagrange interpolation matrix.

    ``values_at_targets = M @ values_at_support``. Exact pass-through rows are
    produced when a target coincides with a support point.
    """
    support = np.asarray(support, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    bw = barycentric_weights(support)
    diff = targets[:, None] - support[None, :]
    exact_rows, exact_cols = np.nonzero(np.abs(diff) < 1e-14)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = bw[None, :] / diff
        M = ratio / np.sum(ratio, axis=1, keepdims=True)
    for r, c in zip(exact_rows, exact_cols):
        M[r, :] = 0.0
        M[r, c] = 1.0
    return M


def barycentric_interpolate(
    support: np.ndarray, values: np.ndarray, targets: np.ndarray
) -> np.ndarray:
    """Interpolate ``values`` (S,) or (S, k) sampled at ``support`` to ``targets``."""
    return interpolation_matrix(support, targets) @ np.asarray(values)


def _solve_tridiagonal(lower, diag, upper, rhs):
    """Thomas algorithm; rhs may be (n,) or (n, k)."""
    n = diag.shape[0]
    diag = diag.astype(np.float64).copy()
    rhs = np.asarray(rhs, dtype=np.float64).copy()
    for i in range(1, n):
        m = lower[i - 1] / diag[i - 1]
        diag[i] -= m * upper[i - 1]
        rhs[i] -= m * rhs[i - 1]
    out = np.empty_like(rhs)
    out[n - 1] = rhs[n - 1] / diag[n - 1]
    for i in range(n - 2, -1, -1):
        out[i] = (rhs[i] - upper[i] * out[i + 1]) / diag[i]
    return out


def cubic_spline_interpolate(
    x: np.ndarray, y: np.ndarray, targets: np.ndarray
) -> np.ndarray:
    """Natural cubic spline through (x, y), evaluated at ``targets``.

    ``y`` may be (n,) or (n, k); evaluation clamps to the end intervals
    (linear extrapolation via the end cubics), matching the behavior the
    reference relies on when warm-starting a refined mesh.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    n = x.shape[0]
    if n == 1:
        out = np.repeat(y, targets.shape[0], axis=0)
        return out[:, 0] if squeeze else out
    if n == 2:
        t = (targets - x[0]) / (x[1] - x[0])
        out = y[0][None, :] + t[:, None] * (y[1] - y[0])[None, :]
        return out[:, 0] if squeeze else out
    h = np.diff(x)
    # Natural spline: second derivatives M solve a tridiagonal system.
    rhs = 6.0 * ((y[2:] - y[1:-1]) / h[1:, None] - (y[1:-1] - y[:-2]) / h[:-1, None])
    diag = 2.0 * (h[:-1] + h[1:])
    M = np.zeros_like(y)
    M[1:-1] = _solve_tridiagonal(h[1:-1], diag, h[1:-1], rhs)
    idx = np.clip(np.searchsorted(x, targets, side="right") - 1, 0, n - 2)
    x0, x1 = x[idx], x[idx + 1]
    hi = (x1 - x0)[:, None]
    t0 = (x1 - targets)[:, None]
    t1 = (targets - x0)[:, None]
    out = (
        M[idx] * t0**3 / (6 * hi)
        + M[idx + 1] * t1**3 / (6 * hi)
        + (y[idx] / hi - M[idx] * hi / 6) * t0
        + (y[idx + 1] / hi - M[idx + 1] * hi / 6) * t1
    )
    return out[:, 0] if squeeze else out
