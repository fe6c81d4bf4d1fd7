"""Automatic problem scaling.

The reference ships Betts-style autoscaling (``LpSacleOCP.cpp``) that samples
random points to estimate Jacobian row norms; it is off by default and
documented as "by no means fullproof". Here scaling is on by default (the
survey flags good scaling as a primary robustness lever for the IP solver) and
uses the deterministic IPOPT-style *gradient-based* scaling: the objective and
every constraint row are scaled so their gradients at the initial point have
∞-norm at most ``g_max``:

    s_f = min(1, g_max / ||∇f(z0)||∞),   s_ci = min(1, g_max / ||∇c_i(z0)||∞)

plus optional Betts bounds-based variable scaling
(``scale = 1/(hi - lo)``, reference ``LpSacleOCP.cpp:343-371``) exposed as
``variable_scaling=True`` for problems with wildly different state magnitudes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.func import grad, jacfwd

from ..utils.device import resolve_device
from .problem import INF


@dataclass(frozen=True)
class ScaledNLP:
    objective: Callable
    constraints: Callable
    zl: np.ndarray
    zu: np.ndarray
    cl: np.ndarray
    cu: np.ndarray
    z0: np.ndarray
    obj_scale: float
    con_scale: np.ndarray   # (m,)
    var_scale: np.ndarray   # (n,)
    device: object = None
    dtype: object = torch.float64

    def unscale_z(self, z):
        return np.asarray(z) / self.var_scale

    def unscale_lam(self, lam):
        """Multipliers of the original problem from scaled-problem duals.

        Original stationarity: ∇f + Jᵀλ = ...; scaled: s_f S_v⁻¹∇f + S_v⁻¹Jᵀ S_c λ̃
        ⇒ λ = S_c λ̃ / s_f.
        """
        return np.asarray(lam) * self.con_scale / self.obj_scale

    def unscale_objective(self, obj):
        return float(obj) / self.obj_scale

    def bound_dual_scale(self) -> np.ndarray:
        """Row scale taking scaled-space bound duals on [z; s] to original
        space: stationarity in scaled space is s_f V⁻¹∇f + V⁻¹Jᵀ S_c λ̃ − z̃_L
        + z̃_U = 0 (z rows; S_c rows for slacks), so z_L = V z̃_L / s_f and
        z_L^(s) = S_c z̃_L^(s) / s_f."""
        return np.concatenate([self.var_scale, self.con_scale]) / self.obj_scale

    def unscale_bound_duals(self, zd):
        return np.asarray(zd) * self.bound_dual_scale()

    def rescale_bound_duals(self, zd_orig):
        return np.asarray(zd_orig) / self.bound_dual_scale()

    def wrap_structured(self, jac_raw, hess_raw):
        """Scaled-space (jac_fn, hess_fn) from raw structured assemblers.

        With x = z_s / v: J_s = S_c J(x) V⁻¹ and
        ∇²_{z_s}[s_f f + λᵀ S_c c] = V⁻¹ H(x, S_c λ; σ=s_f) V⁻¹.
        """
        v = torch.as_tensor(self.var_scale, device=self.device, dtype=self.dtype)
        sc = torch.as_tensor(self.con_scale, device=self.device, dtype=self.dtype)
        sf = self.obj_scale

        def jac_s(z_s):
            return (sc[:, None] * jac_raw(z_s / v)) / v[None, :]

        def hess_s(z_s, lam):
            H = hess_raw(z_s / v, sc * lam, sf)
            return H / (v[:, None] * v[None, :])

        return jac_s, hess_s

    def rebind(self, objective: Callable, constraints: Callable, dtype) -> "ScaledNLP":
        """The same scaling (these host scale vectors, not a new sampling)
        applied to ``objective``/``constraints`` — the same NLP transcribed
        in ``dtype`` — with callables and structured wrappers in ``dtype``.
        The two-stage batch solver binds its float32 stage this way, since
        :func:`scale_nlp` at float32 would sample different scales."""
        obj_s, con_s = _scaled_callables(objective, constraints, self.obj_scale,
                                         self.con_scale, self.var_scale, self.device, dtype)
        return dataclasses.replace(self, objective=obj_s, constraints=con_s, dtype=dtype)


def _scaled_callables(objective, constraints, sf, sc, v, device, dtype):
    """``sf·f(z_s / v)`` and ``sc·c(z_s / v)`` with the scale vectors on
    ``device`` in ``dtype``."""
    sc_j = torch.as_tensor(np.asarray(sc), device=device, dtype=dtype)
    v_j = torch.as_tensor(np.asarray(v), device=device, dtype=dtype)

    def obj_s(zs):
        return sf * objective(zs / v_j)

    def con_s(zs):
        return sc_j * constraints(zs / v_j)

    return obj_s, con_s


def scale_nlp(
    objective: Callable,
    constraints: Callable,
    zl: np.ndarray,
    zu: np.ndarray,
    cl: np.ndarray,
    cu: np.ndarray,
    z0: np.ndarray,
    g_max: float = 1.0,
    enabled: bool = True,
    variable_scaling: bool = False,
    jac_fn: Callable = None,
    samples: int = 0,
    sample_radius: float = 0.25,
    seed: int = 0,
    *,
    device=None,
    dtype=torch.float64,
) -> ScaledNLP:
    """``jac_fn(z) -> (m, n)`` overrides the global ``torch.func.jacfwd`` used
    for the row norms with the structure-exploiting per-node assembly
    (:mod:`.structured`) — same values, far cheaper on big meshes (no
    n-direction forward sweep through the whole transcription).

    ``objective``/``constraints`` are single-instance torch functions whose
    constants live on ``device`` (``None`` means ``"cuda"``); the scale
    vectors are host numpy, the returned scaled callables run on ``device``.

    ``samples > 0`` averages the gradient/row norms over that many random
    points around z0 in addition to z0 itself — the reference's
    random-sample row-norm estimate (``LpSacleOCP.cpp:138-341``, 90 samples
    uniform in the bounds; here a bounded cloud of relative radius
    ``sample_radius`` around the guess, which keeps samples in the region
    the solve actually visits). Guards against a pathological z0 producing
    pathological scales; 0 (default) scales at z0 only."""
    device = resolve_device(device)
    n = z0.shape[0]
    m = cl.shape[0]
    if not enabled:
        return ScaledNLP(
            objective=objective, constraints=constraints,
            zl=zl, zu=zu, cl=cl, cu=cu, z0=z0,
            obj_scale=1.0, con_scale=np.ones(m), var_scale=np.ones(n),
            device=device, dtype=dtype,
        )
    v = np.ones(n)
    if variable_scaling:
        span = np.where(
            (zu < INF) & (zl > -INF) & (zu - zl > 1e-12), zu - zl, 1.0
        )
        v = 1.0 / span
    to_dev = lambda a: torch.as_tensor(np.asarray(a), device=device, dtype=dtype)
    to_np = lambda t: t.detach().cpu().numpy()
    _grad = grad(objective)
    _jac = None
    if m > 0:
        _jac = jac_fn if jac_fn is not None else jacfwd(constraints)
    pts = [to_dev(z0)]
    if samples > 0:
        rng = np.random.default_rng(seed)
        scale_ref = np.maximum(1.0, np.abs(z0))
        lo = np.where(zl > -INF, zl, -np.inf)
        hi = np.where(zu < INF, zu, np.inf)
        for _ in range(samples):
            p = z0 + sample_radius * scale_ref * rng.uniform(-1, 1, n)
            pts.append(to_dev(np.clip(p, lo, hi)))
    g0 = np.mean([np.abs(to_np(_grad(p))) for p in pts], axis=0)
    if m == 0:
        J0 = np.zeros((0, n))
    else:
        J0 = np.mean([np.abs(to_np(_jac(p))) for p in pts], axis=0)
    # gradients w.r.t. scaled variables pick up a 1/v factor
    g_inf = np.max(np.abs(g0 / v)) if n else 0.0
    sf = float(min(1.0, g_max / g_inf)) if g_inf > 0 else 1.0
    row_inf = np.max(np.abs(J0 / v[None, :]), axis=1) if m > 0 else np.zeros(0)
    sc = np.where(row_inf > 0, np.minimum(1.0, g_max / np.maximum(row_inf, 1e-300)), 1.0)
    obj_s, con_s = _scaled_callables(objective, constraints, sf, sc, v, device, dtype)

    def sb(b, scale):
        return np.where(np.abs(b) < INF, b * scale, b)

    return ScaledNLP(
        objective=obj_s, constraints=con_s,
        zl=sb(zl, v), zu=sb(zu, v),
        cl=sb(cl, sc), cu=sb(cu, sc),
        z0=z0 * v,
        obj_scale=sf, con_scale=sc, var_scale=v,
        device=device, dtype=dtype,
    )
