"""Problem validation: shapes, finiteness, and derivative checks.

Parity with the reference's validation layers: ``LpSizeChecker`` (shape
agreement), ``LpGuessChecker`` validation half, and ``LpANDeriveChecker``
(user-derivative vs finite-difference comparison, ``LpANDeriveChecker.cpp``).
With exact AD the *framework's* derivatives need no checking; what remains
useful is checking the **user's functions**: output shapes, finiteness at
sample points inside the bounds, and — when a user attaches a custom
``torch.autograd.Function`` (its ``backward``/``jvp``) to their dynamics —
that those rules agree with numerical differentiation.

Counterpart of the JAX package's ``core/check.py``, which calls
``jax.test_util.check_grads(order=1, modes=["fwd"], atol=1e-3, rtol=1e-3)``.
Here ``torch.autograd.gradcheck`` runs in float64 with the same tolerances,
forward-mode AD checked (the transcription differentiates the user's
functions with ``jacfwd``) and reverse mode too (``jacrev`` below float64).
The sample points are drawn as the JAX package draws them, so both packages
check the same points and raise the same messages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .problem import INF, Problem


class ProblemCheckError(ValueError):
    pass


def _sample_between(lo, hi, rng):
    lo = np.where(lo <= -INF, -1.0, lo)
    hi = np.where(hi >= INF, 1.0, hi)
    hi = np.where(hi <= lo, lo + 1.0, hi)
    return lo + rng.uniform(0.3, 0.7, size=lo.shape) * (hi - lo)


def check_problem(problem: Problem, derivative_check: bool = True, seed: int = 0, *,
                  device=None) -> None:
    """Validate every user function's output shape/finiteness (and optionally
    its derivatives via ``gradcheck``) at sampled interior points, in float64
    on ``device`` (``None`` means ``"cuda"``, and raises without one).

    Raises :class:`ProblemCheckError` with a per-phase message on failure.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    def sample(bounds):
        return tensor(_sample_between(*map(np.asarray, bounds), rng))

    ends = []
    for p, ph in enumerate(problem.phases):
        x = sample(ph.x_bounds)
        u = sample(ph.u_bounds)
        q = sample(ph.q_bounds)
        t0 = 0.5 * (max(ph.t0_bounds[0], -1e3) + min(ph.t0_bounds[1], 1e3))
        tf = 0.5 * (max(ph.tf_bounds[0], -1e3) + min(ph.tf_bounds[1], 1e3))
        if tf <= t0:
            tf = t0 + 1.0
        t = tensor(0.5 * (t0 + tf))

        def _check(name, fn, args, want_shape):
            try:
                out = torch.as_tensor(fn(*args)).detach().cpu().numpy()
            except Exception as e:
                raise ProblemCheckError(f"phase {p}: {name} raised {e!r}") from e
            if out.shape != want_shape:
                raise ProblemCheckError(
                    f"phase {p}: {name} returned shape {out.shape}, expected {want_shape}"
                )
            if not np.all(np.isfinite(out)):
                raise ProblemCheckError(
                    f"phase {p}: {name} returned non-finite values at an interior sample"
                )
            if derivative_check:
                leaves = tuple(a.detach().clone().requires_grad_(True) for a in args)
                try:
                    torch.autograd.gradcheck(
                        fn, leaves, atol=1e-3, rtol=1e-3, check_forward_ad=True)
                except Exception as e:
                    raise ProblemCheckError(
                        f"phase {p}: {name} fails the derivative check "
                        f"(custom rules inconsistent or non-differentiable): {e}"
                    ) from e

        _check("dynamics", ph.dynamics, (x, u, t, q), (ph.nx,))
        if ph.path is not None:
            _check("path", ph.path, (x, u, t, q), (ph.npath,))
        if ph.lagrange is not None:
            _check("lagrange", lambda *a: torch.reshape(torch.as_tensor(ph.lagrange(*a)), ()),
                   (x, u, t, q), ())
        x0 = sample(ph.x0_bounds)
        xf = sample(ph.xf_bounds)
        if ph.mayer is not None:
            _check("mayer", lambda *a: torch.reshape(torch.as_tensor(ph.mayer(*a)), ()),
                   (x0, tensor(t0), xf, tensor(tf), q), ())
        if ph.event is not None:
            _check("event", ph.event,
                   (x0, tensor(t0), xf, tensor(tf), q), (ph.nevent,))
        ends.append((xf, q))
    for i, link in enumerate(problem.linkages):
        xf_l, q_l = ends[link.left]
        ph_r = problem.phases[link.right]
        x0_r = sample(ph_r.x0_bounds)
        q_r = sample(ph_r.q_bounds)
        try:
            out = torch.as_tensor(link.fn(xf_l, q_l, x0_r, q_r)).detach().cpu().numpy()
        except Exception as e:
            raise ProblemCheckError(f"linkage {i}: raised {e!r}") from e
        if out.shape != (link.nlink,):
            raise ProblemCheckError(
                f"linkage {i}: returned shape {out.shape}, expected {(link.nlink,)}"
            )
