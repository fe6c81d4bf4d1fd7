"""Differentiable tabulated-data lookups for use INSIDE problem functions.

Trajectory work needs tabulated data in the dynamics: atmosphere models,
thrust decks T(h, M), aero coefficients. A Newton interior-point method wants
C2 data (kinked derivatives give zero curvature almost everywhere and
chattering steps at the breakpoints), so the tables here are splines:

* :class:`Spline1D` is the natural cubic spline (C2); :class:`Spline2D` is
  its tensor product (bicubic through the value grid). Both are exact on
  (bi)linear data and O(h⁴) on smooth data.
* The coefficients are fitted once on the host (numpy tridiagonal solves)
  and held as float64 tensors. Second derivatives of a natural spline are a
  LINEAR map of the values (``M = S y``, S = T⁻¹ B), so the 2-D table is
  four precomputable corner arrays (values, d²/dx², d²/dy², d⁴/dx²dy²).
* Evaluation is branch-free: the cell index is a comparison sum
  (``sum(x >= knots[1:-1])``, clamped), the coefficients come from a gather
  with that index tensor (``index_select``), and the rest is elementwise
  polynomial arithmetic. So a table works inside ``torch.func.vmap``, ``jacfwd`` and
  ``hessian`` as the model functions are lifted in ``core/structured.py``,
  and on a tensor of any shape (elementwise).
* The coefficients follow the argument: a call copies them to ``x``'s
  device and dtype once, cached per (device, dtype), so one table serves
  the CPU and the GPU.
* Outside the knot range, evaluation continues the END cubic (C2 at the
  boundary, polynomial extrapolation), so intermediate IPM iterates cannot
  produce NaNs; keep state bounds within the tabulated range for fidelity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def _second_derivative_operator(x: np.ndarray) -> np.ndarray:
    """Dense (n, n) operator S with ``M = S @ y`` the natural-spline second
    derivatives at the knots (linear in the values)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n < 3:
        return np.zeros((n, n))
    h = np.diff(x)
    T = np.zeros((n - 2, n - 2))
    B = np.zeros((n - 2, n))
    for i in range(n - 2):
        T[i, i] = 2.0 * (h[i] + h[i + 1])
        if i > 0:
            T[i, i - 1] = h[i]
        if i < n - 3:
            T[i, i + 1] = h[i + 1]
        B[i, i] = 6.0 / h[i]
        B[i, i + 1] = -6.0 / h[i] - 6.0 / h[i + 1]
        B[i, i + 2] = 6.0 / h[i + 1]
    S = np.zeros((n, n))
    S[1:-1, :] = np.linalg.solve(T, B)
    return S


def _cell_index(knots: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Branch-free interval index in [0, n-2] of every entry of ``x``
    (comparison reduction; an int64 tensor of ``x``'s shape)."""
    if knots.shape[0] > 2:
        idx = (x.unsqueeze(-1) >= knots[1:-1]).sum(-1)
    else:
        idx = torch.zeros_like(x, dtype=torch.int64)
    return idx.clamp(0, knots.shape[0] - 2)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` for a 1-D ``arr`` as an ``index_select``: indexing with a
    0-d index tensor reads it on the host under ``vmap`` of ``hessian``,
    ``index_select`` has a batching rule."""
    return arr.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _eval_weights(knots, idx, x):
    """The four 1-D spline weights: f = a0 y[i] + a1 y[i+1] + b0 M[i] + b1 M[i+1]."""
    x0 = _take(knots, idx)
    x1 = _take(knots, idx + 1)
    h = x1 - x0
    t0 = (x1 - x) / h
    t1 = (x - x0) / h
    a0, a1 = t0, t1
    b0 = h * h * t0 * (t0 * t0 - 1.0) / 6.0
    b1 = h * h * t1 * (t1 * t1 - 1.0) / 6.0
    return a0, a1, b0, b1


def _as_float(x) -> torch.Tensor:
    """A table argument as a floating tensor (python numbers and integer
    tensors become float64, as the JAX package's x64 arrays are)."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=torch.float64)
    return x if x.is_floating_point() else x.to(torch.float64)


class _Coefficients:
    """The float64 host coefficients of a table and their copies per
    (device, dtype)."""

    def _on(self, like: torch.Tensor) -> tuple:
        key = (str(like.device), like.dtype)
        got = self._copies.get(key)
        if got is None:
            got = tuple(a.to(device=like.device, dtype=like.dtype) for a in self._arrays())
            self._copies[key] = got
        return got


@dataclass(frozen=True)
class Spline1D(_Coefficients):
    """Natural cubic spline through ``(xs, ys)``; call with a tensor of any
    shape (elementwise)."""

    xs: torch.Tensor
    ys: torch.Tensor
    ms: torch.Tensor  # second derivatives at the knots
    _copies: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def fit(cls, xs, ys) -> "Spline1D":
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if xs.ndim != 1 or xs.shape != ys.shape:
            raise ValueError(f"1-D knots/values shape mismatch: {xs.shape} vs {ys.shape}")
        if xs.shape[0] < 2:
            raise ValueError("need at least 2 knots")
        if not np.all(np.diff(xs) > 0):
            raise ValueError("knots must be strictly increasing")
        ms = _second_derivative_operator(xs) @ ys
        return cls(*(torch.as_tensor(a) for a in (xs, ys, ms)))

    def _arrays(self):
        return self.xs, self.ys, self.ms

    def __call__(self, x):
        x = _as_float(x)
        xs, ys, ms = self._on(x)
        i = _cell_index(xs, x)
        a0, a1, b0, b1 = _eval_weights(xs, i, x)
        return (a0 * _take(ys, i) + a1 * _take(ys, i + 1)
                + b0 * _take(ms, i) + b1 * _take(ms, i + 1))


@dataclass(frozen=True)
class Spline2D(_Coefficients):
    """Tensor-product natural bicubic spline through ``Z[i, j] = f(xs[i], ys[j])``;
    call with two tensors of one shape (elementwise)."""

    xs: torch.Tensor
    ys: torch.Tensor
    z: torch.Tensor     # (nx, ny) values
    mx: torch.Tensor    # d2/dx2
    my: torch.Tensor    # d2/dy2
    mxy: torch.Tensor   # d4/dx2dy2
    _copies: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def fit(cls, xs, ys, z) -> "Spline2D":
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        if z.shape != (xs.shape[0], ys.shape[0]):
            raise ValueError(
                f"value grid {z.shape} does not match knots "
                f"({xs.shape[0]}, {ys.shape[0]})"
            )
        if not (np.all(np.diff(xs) > 0) and np.all(np.diff(ys) > 0)):
            raise ValueError("knots must be strictly increasing")
        Sx = _second_derivative_operator(xs)
        Sy = _second_derivative_operator(ys)
        mx = Sx @ z
        my = z @ Sy.T
        mxy = Sx @ my
        return cls(*(torch.as_tensor(a) for a in (xs, ys, z, mx, my, mxy)))

    def _arrays(self):
        return self.xs, self.ys, self.z, self.mx, self.my, self.mxy

    def __call__(self, x, y):
        x, y = _as_float(x), _as_float(y)
        xs, ys, z, mx, my, mxy = self._on(x)
        i = _cell_index(xs, x)
        j = _cell_index(ys, y)
        ax0, ax1, bx0, bx1 = _eval_weights(xs, i, x)
        ay0, ay1, by0, by1 = _eval_weights(ys, j, y)
        ny = ys.shape[0]
        # corners by one flat gather each: (i, j), (i, j+1), (i+1, j), (i+1, j+1)
        k00 = i * ny + j
        corners = (k00, k00 + 1, k00 + ny, k00 + ny + 1)

        def blend(arr, wx0, wx1, wy0, wy1):
            flat = arr.reshape(-1)
            c00, c01, c10, c11 = (_take(flat, k) for k in corners)
            return wx0 * (wy0 * c00 + wy1 * c01) + wx1 * (wy0 * c10 + wy1 * c11)

        return (
            blend(z, ax0, ax1, ay0, ay1)
            + blend(my, ax0, ax1, by0, by1)
            + blend(mx, bx0, bx1, ay0, ay1)
            + blend(mxy, bx0, bx1, by0, by1)
        )
