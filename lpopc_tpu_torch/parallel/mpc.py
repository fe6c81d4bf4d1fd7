"""Receding-horizon (MPC) controller over the batched IPM solver.

No counterpart exists in the reference (single offline solves only): a
fixed-mesh batch solver is reused every control step with the measured state
pinned into the initial-state bounds and the previous solution as warm
start, over a single instance or a whole batch of plants in lockstep.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..core.ipm import IPMOptions
from ..core.problem import Problem
from ..core.solve import SolveOptions
from .batch import BatchSolver, make_batch_solver


@dataclass
class MPCController:
    """Receding-horizon controller.

    ``step(x0)`` takes the measured state(s) (nx,) or (B, nx) of phase 0 and
    returns (u0, info): the first control(s) and solver diagnostics. The
    horizon is the problem's time window; states with pinned x0 bounds are
    overwritten by the measurement. The solver runs on ``device`` (``None``
    means ``"cuda"``, and raises without one) in ``dtype``.
    """

    problem: Problem
    options: SolveOptions = None
    batch: int = 1
    warm_mu: float = 1e-2
    # Sample time for the horizon-shift warm start: the previous solution is
    # advanced by dt along the horizon before re-solving (the standard MPC
    # shift — without it the warm start is one sample stale everywhere).
    # None disables.
    shift_dt: Optional[float] = None
    # Real-time-iteration mode: run EXACTLY this many IPM iterations per
    # step (Diehl RTI; status MAX_ITER is expected and accepted). Bounded,
    # deterministic per-step latency; the controller tracks optimality
    # across steps instead of within one.
    rti_iters: Optional[int] = None
    # Carry z_L/z_U bound duals between steps (IPOPT-style warm start; mu
    # restarts at the carried complementarity instead of warm_mu).
    warm_bound_duals: bool = True
    device: object = None
    dtype: object = torch.float64

    def __post_init__(self):
        opts = self.options or SolveOptions()
        if opts.ipm is None:
            opts = replace(opts, ipm=IPMOptions(
                tol=opts.tol, max_iter=opts.max_iterations, mu_init=self.warm_mu))
        if self.rti_iters is not None:
            opts = replace(opts, ipm=replace(opts.ipm, max_iter=int(self.rti_iters)))
        self.bs: BatchSolver = make_batch_solver(
            self.problem, opts, device=self.device, dtype=self.dtype)
        self.device = self.bs.device
        # the collocation grids of every phase, on the host once (_shift)
        self._taus = [(np.asarray(ops.tau_state, dtype=np.float64),
                       np.asarray(ops.tau, dtype=np.float64)) for ops in self.bs.nlp.ops]
        self._z_prev = None
        self._lam_prev = None
        self._zld_prev = None
        self._zud_prev = None
        self._last_res = None
        self.solve_times = []

    def _shift(self, z: np.ndarray) -> np.ndarray:
        """Advance the warm start by ``shift_dt`` along the horizon: states
        and controls are re-interpolated at tau + dtau (linear in tau; the
        tail holds the last value). Per-phase, host-side, O(N) — negligible
        next to a device solve."""
        z = np.array(z)
        if self.shift_dt is None:
            return z
        vs = self.bs.scaled.var_scale
        for pl, (tau_state, tau_col) in zip(self.bs.nlp.layout.phases, self._taus):
            t0i, tfi = pl.t0_index, pl.tf_index
            # t0/tf are decision variables (scaled); horizon length per batch
            horizon = z[:, tfi] / vs[tfi] - z[:, t0i] / vs[t0i]
            for b in range(z.shape[0]):
                h = max(float(horizon[b]), 1e-12)
                dtau = 2.0 * self.shift_dt / h
                xs = z[b, pl.x_slice].reshape(pl.npts, pl.nx)
                z[b, pl.x_slice] = np.stack([
                    np.interp(tau_state + dtau, tau_state, xs[:, i])
                    for i in range(pl.nx)
                ], axis=1).reshape(-1)
                if pl.nu:
                    us = z[b, pl.u_slice].reshape(pl.N, pl.nu)
                    z[b, pl.u_slice] = np.stack([
                        np.interp(tau_col + dtau, tau_col, us[:, i])
                        for i in range(pl.nu)
                    ], axis=1).reshape(-1)
        return z

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=self.dtype)

    def step(self, x0):
        x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
        B = x0.shape[0]
        pl = self.bs.nlp.layout.phases[0]
        sl = slice(pl.var_offset, pl.var_offset + pl.nx)
        vs = self.bs.scaled.var_scale[sl]
        # the measurement replaces the PINNED initial-state bounds; the
        # nominal is those bounds' value (not the guess, which need not match)
        pinned = (self.bs.scaled.zu[sl] - self.bs.scaled.zl[sl]) < 1e-12
        nominal_x0 = np.where(pinned, self.bs.scaled.zl[sl] / vs, 0.0)
        deltas = np.where(pinned[None, :], x0 - nominal_x0[None, :], 0.0)
        z0, zl, zu, cl, cu = self.bs.perturb_x0(B, 0, deltas)
        warm = self._z_prev is not None and self._z_prev.shape[0] == B
        if warm:
            z0 = self._shift(self._z_prev)
            # re-pin only the measured (pinned) initial states in the warm start
            z0[:, sl] = np.where(pinned[None, :], zl[:, sl], z0[:, sl])
        lam0 = (
            self._lam_prev
            if self._lam_prev is not None and self._lam_prev.shape[0] == B
            else np.zeros((B, self.bs.m))
        )
        kw = {}
        if warm and self.warm_bound_duals and self._zld_prev is not None:
            kw = {"zl_d": self._tensor(self._zld_prev), "zu_d": self._tensor(self._zud_prev)}
        args = [self._tensor(a) for a in (z0, zl, zu, cl, cu, lam0)]
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        res = self.bs.run(*args, **kw)
        if cuda:
            # the solve's last kernels are done before the clock is read
            torch.cuda.synchronize(self.device)
        self.solve_times.append(time.perf_counter() - t0)
        host = lambda t: t.detach().cpu().numpy()
        self._z_prev = host(res.z)
        self._lam_prev = host(res.lam)
        self._zld_prev = host(res.zl_dual)
        self._zud_prev = host(res.zu_dual)
        self._last_res = res
        u_off = pl.var_offset + pl.npts * pl.nx
        u0 = self._z_prev[:, u_off : u_off + pl.nu] / \
            self.bs.scaled.var_scale[u_off : u_off + pl.nu][None, :]
        info = {
            "status": host(res.status),
            "iterations": host(res.iterations),
            "objective": host(res.objective) / self.bs.scaled.obj_scale,
            "kkt_error": host(res.kkt_error),  # scaled-problem residual
        }
        return (u0[0] if x0.shape[0] == 1 and self.batch == 1 else u0), info

    def value_gradient(self, phase: int = 0):
        """dV/dx0 at the last measured state (batch, nx): the value-function
        gradient from the converged duals (``BatchSolver.x0_sensitivities``)
        — the sensitivity of the optimal cost to the measurement, free with
        every step."""
        if self._last_res is None:
            raise RuntimeError("no step taken yet")
        return self.bs.x0_sensitivities(self._last_res, phase=phase)

    def percentile_ms(self, q=50):
        times = self.solve_times[1:] or self.solve_times  # drop the first step
        return float(np.percentile(np.array(times) * 1e3, q)) if times else float("nan")
