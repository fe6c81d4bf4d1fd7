"""The solve loop: transcribe -> scale -> IP solve -> hp-refine loop.

Counterpart of the reference's ``LpopcAlgorithm::SolveOptimalControlProblem``
(``Lpopc/src/Core/LpLpopcAlgorithm.cpp:17-47``): set/validate
the first mesh, solve the transcribed NLP, convert back to trajectories,
estimate the discretization error, and hp-refine until the tolerance or the
grid cap is hit, warm-starting each mesh from the previous solution.

The outer loop is host-side Python (mesh changes imply new shapes); each
inner solve is one run of the batched interior-point solver of
:mod:`.ipm` at a batch of one, on the device the caller names
(``device=None`` means ``"cuda"``). With ``IPMOptions(lane_kkt=True)`` every
factorization and KKT solve of every grid goes through the hand-written
kernels of :mod:`..ops.batched_linalg`.

Solvers are built per grid: torch has no compile step, so the JAX package's
per-signature solver caches have nothing to save here. Shape bucketing
(``mesh_bucketing="on"``, the default) is kept because it decides the
sequence of meshes: with it the solver takes the mesh fractions and scale
vectors as a runtime ``aux`` input, as the JAX package's does.

From ``block_kkt_threshold`` variables on under ``block_kkt="auto"`` (or
always under ``"on"``) a grid takes the segment-block + border-Schur
factorization of :mod:`.block_kkt`: assembled straight from the per-node
blocks by :mod:`.kkt_blocks` (``block_assembly="direct"``, the default: no
dense J, H or K, and the dense Hessian assembler is not built), or gathered
out of the dense K (``"dense"``). Such a grid launches neither kernel of
:mod:`..ops.batched_linalg`, as in the JAX package.

``report_file`` writes the combined report of :mod:`..utils.report` after
the hp loop, and ``checkpoint_dir`` one :mod:`..utils.checkpoint` file per
grid, in the JAX package's layout.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.trace import traced
from .ipm import FAILED, MAX_ITER, RUNNING, SOLVED, IPMOptions, build_solver  # noqa: F401
from .postprocess import Solution, extract_solution, warm_start_problem
from .problem import Problem
from .refine import estimate_errors, ph_refine_phase
from .scaling import scale_nlp
from .transcribe import transcribe

log = logging.getLogger("lpopc_tpu_torch")

# final solve status (extends the reference's ocpstatus enum,
# LpLpopcAlgorithm.hpp:33-40)
OCP_SOLVED = 1
OCP_REACH_MAX_GRID = 5
OCP_NLP_FAILED = 3
OCP_NLP_MAX_ITER = 2


@dataclass(frozen=True)
class SolveOptions:
    """User-facing knobs, mirroring the reference's registered options
    (``doc/LpopcDoc.tex:1203-1267``): Ipopt-tol -> ``tol``,
    mesh-refine-methods -> ``mesh_method``, max-grid-num, desired-relative-
    error, Nmax/Nmin, R -> ``curvature_ratio``, auto-scale -> ``auto_scale``.
    """

    tol: float = 1e-8
    max_iterations: int = 300
    auto_scale: bool = True
    variable_scaling: bool = False
    # >0: average scaling row norms over this many random points around the
    # guess (the reference's 90-random-sample Betts autoscale variant,
    # LpSacleOCP.cpp:138-341); 0 scales at the guess only.
    scale_samples: int = 0
    structured_derivatives: bool = True
    # "exact" (default): per-node AD Lagrangian Hessians. "gauss-newton":
    # drop all constraint-curvature terms (lam' * d2c) — the reference's
    # hessian-approximation escape hatch (LpNLPSolver.cpp:31-44) for
    # dynamics with expensive or indefinite-far-from-solution second
    # derivatives; linear local convergence, more IPM iterations, each
    # cheaper and PSD-safe. Requires structured_derivatives. Suitable when
    # the OBJECTIVE carries curvature (Lagrange / tracking costs, e.g.
    # vanderpol converges to the exact optimum); on Mayer-only minimum-time
    # problems the GN Hessian is ~zero and the method degenerates to a slow
    # first-order crawl (honest MAX_ITER status) — keep "exact" there.
    hessian_approximation: str = "exact"
    # Condensed-KKT factorization: "auto" switches from dense Cholesky to the
    # segment-block + border-Schur factorization (core/block_kkt.py) once the
    # NLP is big enough for the O(n^3) dense factor to dominate; "on"/"off"
    # force it. The auto threshold is in NLP variables.
    block_kkt: str = "auto"            # "auto" | "on" | "off"
    block_kkt_threshold: int = 700
    # How the engaged block factorization gets its blocks: "direct" assembles
    # per-segment (A, B, C) straight from the per-node derivative blocks —
    # fully matrix-free, O(S·b²) memory, no dense J/H/K (core/kkt_blocks.py);
    # "dense" keeps the round-1 behavior (dense K materialized, blocks
    # gathered out of it) for A/B comparison.
    block_assembly: str = "direct"     # "direct" | "dense"
    # Shape-bucketed recompile-free hp refinement: meshes are rounded up to a
    # uniform per-phase degree bucket and power-of-two segment count
    # (refine.bucket_mesh), and the solver takes the mesh FRACTIONS as
    # runtime inputs — so the whole refinement loop reuses a handful of
    # solver shapes. Kept for option parity with the JAX package (the
    # bucketing fixes the grid sequence); "off" restores per-grid shapes.
    mesh_bucketing: str = "on"         # "on" | "off"
    mesh_method: str = "ph"            # "ph" | "hp-liu" | "none"
    # Adaptive per-grid NLP tolerance: coarse grids are solved only ~100x
    # tighter than their measured discretization error (there is no point
    # driving the NLP to 1e-8 under a 1e-3 mesh); the final mesh is always
    # re-polished at the full tolerance. The loosened tolerance is a runtime
    # input of the solver.
    grid_tol_schedule: str = "off"     # "off" | "adaptive"
    max_grid_num: int = 10
    desired_relative_error: float = 1e-6
    # Inter-node path/bound violation tolerance. None (default) keeps the
    # violation estimator measurement-only (reported on the Solution);
    # a value makes it DRIVE refinement: convergence additionally requires
    # max violation <= this, and state-converged segments violating a bound
    # between collocation points get an h-point at the measured peak
    # (refine.violation_knots/insert_knots). Beyond-reference: the reference
    # neither measures nor controls inter-node excursions (LpopcDoc.tex:1139).
    path_violation_tol: float = None
    n_min: int = 4
    n_max: int = 16
    curvature_ratio: float = 1.2
    mu_init: float = 1e-1
    # Barrier update rule (reference runs IPOPT's mu_strategy=adaptive,
    # LpNLPSolver.cpp:28): "auto" (centrality-guarded Mehrotra, default),
    # "monotone" Fiacco-McCormick, "adaptive" LOQO-centrality, "probing",
    # or "mehrotra" (see IPMOptions.mu_strategy).
    mu_strategy: str = "auto"
    verbose: bool = False
    checkpoint_dir: str = None     # save per-grid state for resume (utils.checkpoint)
    # Per-grid IPM iteration trace files grid-<k>-ipm-out.txt (the
    # reference's grid-<k>Ipopt-out.txt, LpNLPSolver.cpp:24-29).
    iteration_log_dir: str = None
    # Combined solve report (per-grid NLP table + refinement history +
    # final verdict; utils/report.py) written after solve().
    report_file: str = None
    ipm: IPMOptions = None

    def ipm_options(self) -> IPMOptions:
        base = self.ipm if self.ipm is not None else IPMOptions(
            tol=self.tol, max_iter=self.max_iterations, mu_init=self.mu_init,
            mu_strategy=self.mu_strategy,
        )
        if self.iteration_log_dir and not base.record_history:
            base = replace(base, record_history=True)
        return base


def describe_problem(problem: Problem, options: SolveOptions = None) -> str:
    """Problem-size/options summary (the reference prints this at solve start,
    ``LpopcAlgorithm::OutputProblemInfo``, ``LpLpopcAlgorithm.cpp:264-345``)."""
    from .transcribe import make_layout

    lay = make_layout(problem)
    lines = [f"problem '{problem.name}': {len(problem.phases)} phase(s), "
             f"{len(problem.linkages)} linkage(s), {lay.nvar} variables, "
             f"{lay.ncon} constraints"]
    for i, (ph, pl) in enumerate(zip(problem.phases, lay.phases)):
        lines.append(
            f"  phase {i + 1}: nx={ph.nx} nu={ph.nu} nq={ph.nq} "
            f"npath={ph.npath} nevent={ph.nevent} "
            f"segments={len(ph.mesh_degrees)} N={pl.N}"
        )
    if options is not None:
        lines.append(
            f"  options: tol={options.tol} mesh={options.mesh_method} "
            f"max_grid={options.max_grid_num} "
            f"mesh_tol={options.desired_relative_error} "
            f"Nmin/Nmax={options.n_min}/{options.n_max} "
            f"auto_scale={options.auto_scale}"
        )
    return "\n".join(lines)


def _mesh_signature(problem: Problem):
    return tuple(
        (tuple(ph.mesh_degrees), tuple(ph.mesh_fractions)) for ph in problem.phases
    )


def _warm_duals(prev_sol: Solution, problem: Problem, nlp) -> np.ndarray:
    """Interpolate the previous grid's duals onto the new mesh.

    Defect multipliers are tied to the mesh through the Radau transformation
    ``λ_k = -costate(τ_k) w_k`` (see postprocess.py); the *costate* is the
    smooth mesh-independent object, so it is what gets interpolated. Event /
    linkage / linear-row duals are mesh-independent and copied.
    """
    from ..ops.interp import cubic_spline_interpolate

    lam0 = np.zeros(nlp.layout.ncon)
    for ph, pl, op, psol in zip(
        problem.phases, nlp.layout.phases, nlp.ops, prev_sol.phases
    ):
        t0, tf = psol.t0, psol.tf
        half = (tf - t0) / 2.0
        t_col_new = (np.asarray(op.tau) + 1.0) * half + t0
        w_new = np.asarray(op.w)
        cs = cubic_spline_interpolate(psol.t_col, psol.costate, t_col_new)
        cs = np.clip(cs, psol.costate.min(axis=0), psol.costate.max(axis=0))
        lam0[pl.con_offset : pl.con_offset + pl.N * pl.nx] = (
            -cs * w_new[:, None]
        ).reshape(-1)
        if ph.npath > 0:
            pm = cubic_spline_interpolate(
                psol.t_col, psol.path_multipliers, t_col_new
            )
            poff = pl.con_offset + pl.N * pl.nx
            lam0[poff : poff + pl.N * ph.npath] = (
                -pm * (tf - t0) * w_new[:, None] / 2.0
            ).reshape(-1)
    # events/linkages/linear rows: copy via the stored phase block tails
    prev_off = 0
    for ph, pl, psol in zip(problem.phases, nlp.layout.phases, prev_sol.phases):
        N_prev = psol.t_col.shape[0]
        prev_block = N_prev * (ph.nx + ph.npath)
        if ph.nevent > 0:
            eoff_new = pl.con_offset + pl.N * (ph.nx + ph.npath)
            lam0[eoff_new : eoff_new + ph.nevent] = prev_sol.lam[
                prev_off + prev_block : prev_off + prev_block + ph.nevent
            ]
        prev_off += prev_block + ph.nevent
    tail = prev_sol.lam.shape[0] - prev_off
    if tail > 0:
        lam0[nlp.layout.ncon - tail :] = prev_sol.lam[prev_off:]
    return lam0


def _warm_bound_duals(prev_sol: Solution, problem: Problem, nlp):
    """Interpolate the previous grid's bound duals on [z; s] onto the new mesh
    (IPOPT-style warm start carries z_L/z_U, not just the equality duals).

    Node-attached components (state/control bound duals, defect/path slack
    duals) interpolate over time like their primal counterparts; endpoint /
    event / linkage / linear components copy. Returns (zl0, zu0) in ORIGINAL
    problem space, or (None, None) when the previous solution has no duals.
    """
    from ..ops.interp import cubic_spline_interpolate

    if prev_sol.zl_dual is None or prev_sol.zu_dual is None:
        return None, None
    n_new, m_new = nlp.layout.nvar, nlp.layout.ncon
    outs = (np.zeros(n_new + m_new), np.zeros(n_new + m_new))
    prevs = (np.asarray(prev_sol.zl_dual), np.asarray(prev_sol.zu_dual))
    n_prev = prev_sol.z.shape[0]

    def interp(t_prev, vals_prev, t_new):
        v = cubic_spline_interpolate(t_prev, vals_prev, t_new)
        # duals are nonnegative; clamp spline overshoot into the data range
        return np.clip(v, 0.0, np.maximum(vals_prev.max(axis=0), 0.0))

    # ----- z-part -----
    prev_off = 0
    for ph, pl, op, psol in zip(
        problem.phases, nlp.layout.phases, nlp.ops, prev_sol.phases
    ):
        npts_prev = psol.t_state.shape[0]
        N_prev = npts_prev - 1
        nx, nu, nq = pl.nx, pl.nu, pl.nq
        half = (psol.tf - psol.t0) / 2.0
        t_state_new = (np.asarray(op.tau_state) + 1.0) * half + psol.t0
        t_col_new = (np.asarray(op.tau) + 1.0) * half + psol.t0
        for prev, out in zip(prevs, outs):
            if nx:
                Xd = prev[prev_off : prev_off + npts_prev * nx].reshape(npts_prev, nx)
                out[pl.x_slice] = interp(psol.t_state, Xd, t_state_new).reshape(-1)
            if nu:
                uoff = prev_off + npts_prev * nx
                Ud = prev[uoff : uoff + N_prev * nu].reshape(N_prev, nu)
                out[pl.u_slice] = interp(psol.t_col, Ud, t_col_new).reshape(-1)
            toff = prev_off + npts_prev * nx + N_prev * nu
            out[pl.t0_index] = prev[toff]
            out[pl.tf_index] = prev[toff + 1]
            if nq:
                out[pl.q_slice] = prev[toff + 2 : toff + 2 + nq]
        prev_off += npts_prev * nx + N_prev * nu + 2 + nq
    # ----- s-part (constraint-row slack duals; same row layout as lam) -----
    prev_off = n_prev
    for ph, pl, op, psol in zip(
        problem.phases, nlp.layout.phases, nlp.ops, prev_sol.phases
    ):
        N_prev = psol.t_state.shape[0] - 1
        half = (psol.tf - psol.t0) / 2.0
        t_col_new = (np.asarray(op.tau) + 1.0) * half + psol.t0
        for prev, out in zip(prevs, outs):
            soff = n_new + pl.con_offset
            if pl.nx:
                Dd = prev[prev_off : prev_off + N_prev * pl.nx].reshape(N_prev, pl.nx)
                out[soff : soff + pl.N * pl.nx] = interp(
                    psol.t_col, Dd, t_col_new
                ).reshape(-1)
            if ph.npath:
                poff_prev = prev_off + N_prev * pl.nx
                Pd = prev[poff_prev : poff_prev + N_prev * ph.npath].reshape(
                    N_prev, ph.npath
                )
                poff_new = soff + pl.N * pl.nx
                out[poff_new : poff_new + pl.N * ph.npath] = interp(
                    psol.t_col, Pd, t_col_new
                ).reshape(-1)
            if ph.nevent:
                eoff_prev = prev_off + N_prev * (pl.nx + ph.npath)
                eoff_new = soff + pl.N * (pl.nx + ph.npath)
                out[eoff_new : eoff_new + ph.nevent] = prev[
                    eoff_prev : eoff_prev + ph.nevent
                ]
        prev_off += N_prev * (pl.nx + ph.npath) + ph.nevent
    # linkage + linear rows: copy the tail verbatim
    tail = (n_prev + prev_sol.lam.shape[0]) - prev_off
    if tail > 0:
        for prev, out in zip(prevs, outs):
            out[n_new + m_new - tail :] = prev[prev.shape[0] - tail :]
    return outs


def _write_iteration_log(path_dir: str, grid: int, res, nlp) -> None:
    """Per-grid iteration trace file (the reference writes
    ``grid-<k>Ipopt-out.txt`` per mesh, ``LpNLPSolver.cpp:24-29``). ``res``
    holds one instance's result fields as numpy (history included)."""
    os.makedirs(path_dir, exist_ok=True)
    hist = res["history"]
    iters = int(res["iterations"])
    path = os.path.join(path_dir, f"grid-{grid}-ipm-out.txt")
    with open(path, "w") as f:
        f.write(
            f"# lpopc_tpu_torch IPM trace: n={nlp.n} m={nlp.m} "
            f"status={int(res['status'])} iterations={iters} "
            f"objective={float(res['objective']):.16g} "
            f"kkt_error={float(res['kkt_error']):.3e}\n"
        )
        f.write(
            f"{'iter':>4} {'kkt':>12} {'mu':>10} {'theta':>12} {'alpha':>10} "
            f"{'alpha_max':>10} {'delta_w':>10} {'ls':>3} {'lin_err':>10} "
            f"{'dphi':>11} {'step_inf':>10}\n"
        )
        if hist is None:
            return
        h = hist
        for i in range(min(iters, h["kkt"].shape[0])):
            f.write(
                f"{i:>4} {h['kkt'][i]:>12.4e} {h['mu'][i]:>10.2e} "
                f"{h['theta'][i]:>12.4e} {h['alpha'][i]:>10.2e} "
                f"{h['alpha_max'][i]:>10.2e} {h['delta_w'][i]:>10.2e} "
                f"{int(h['ls_iters'][i]):>3} {h['lin_err'][i]:>10.2e} "
                f"{h['dphi'][i]:>11.3e} {h['step_inf'][i]:>10.2e}\n"
            )


def _block_engaged(nlp, options: SolveOptions) -> bool:
    if options.block_kkt == "off":
        return False
    if options.block_kkt == "auto" and nlp.n < options.block_kkt_threshold:
        return False
    return True


def _kkt_factorizer(nlp, options: SolveOptions):
    """Build the block-KKT factorizer triple when enabled/beneficial."""
    if not _block_engaged(nlp, options):
        return None
    from .block_kkt import make_block_factorizer, make_block_spec

    spec = make_block_spec(nlp.layout, nlp.ops)
    if spec is None:
        return None
    return make_block_factorizer(spec)


def _kkt_structured(problem: Problem, nlp, options: SolveOptions):
    """Mesh/scale-parametric StructuredKKT (matrix-free direct block
    assembly) when the block path engages with block_assembly="direct";
    callers bind mesh + scales via kkt_blocks.bind_structured_kkt."""
    if not _block_engaged(nlp, options):
        return None
    if options.block_assembly != "direct" or not options.structured_derivatives:
        return None
    from .block_kkt import make_block_spec
    from .kkt_blocks import make_structured_kkt

    spec = make_block_spec(nlp.layout, nlp.ops)
    if spec is None:
        return None
    return make_structured_kkt(
        problem, nlp.layout, spec,
        gauss_newton=(options.hessian_approximation == "gauss-newton"),
    )


def _bind_fixed_mesh(sk, nlp, scaled, device, dtype):
    """The structured KKT bound to ``nlp``'s own mesh and the scaling."""
    from .kkt_blocks import bind_structured_kkt
    from .transcribe import const_mesh

    return bind_structured_kkt(
        sk, const_mesh(nlp.ops, device=device, dtype=dtype), scaled.obj_scale,
        scaled.con_scale, 1.0 / scaled.var_scale,
    )


def _structured(problem: Problem, nlp, options: SolveOptions, device, dtype,
                hessian: bool = True):
    """Fixed-mesh structured (jac, hess) assemblers, or (None, None); with
    ``hessian=False`` only the Jacobian (what scaling needs)."""
    if not options.structured_derivatives:
        return None, None
    from .structured import make_structured_hessian, make_structured_jacobian

    jac = make_structured_jacobian(problem, nlp.layout, nlp.ops, device=device, dtype=dtype)
    if not hessian:
        return jac, None
    hess = make_structured_hessian(
        problem, nlp.layout, nlp.ops,
        gauss_newton=(options.hessian_approximation == "gauss-newton"),
        device=device, dtype=dtype,
    )
    return jac, hess


def _scale(nlp, options: SolveOptions, jac_fn, device, dtype):
    return scale_nlp(
        nlp.objective, nlp.constraints,
        nlp.zl, nlp.zu, nlp.cl, nlp.cu, nlp.z0,
        enabled=options.auto_scale,
        variable_scaling=options.variable_scaling,
        jac_fn=jac_fn,
        samples=options.scale_samples,
        device=device, dtype=dtype,
    )


def _build_rt_solver(problem: Problem, nlp, options: SolveOptions):
    """An aux-taking IPM solver: mesh fractions + scale vectors are runtime
    inputs, so one solver serves every mesh with this degree signature."""
    from ..ops.lgr import materialize_phase_ops
    from .transcribe import make_constraints_mesh, make_objective_mesh

    layout = nlp.layout
    degree_sigs = tuple(tuple(ph.mesh_degrees) for ph in problem.phases)
    obj_m = make_objective_mesh(problem, layout)
    con_m = make_constraints_mesh(problem, layout)
    # the operators of the fractions last seen: a solve passes one aux, so
    # they are materialized once per solve, not once per function call (the
    # held reference keeps the identity test sound)
    last = [None, None]

    def _mesh(aux):
        if last[0] is not aux["fracs"]:
            last[0] = aux["fracs"]
            last[1] = tuple(
                materialize_phase_ops(deg, fr)
                for deg, fr in zip(degree_sigs, aux["fracs"])
            )
        return last[1]

    # runtime-scaled wrappers (same algebra as scaling.scale_nlp /
    # ScaledNLP.wrap_structured, with the scale vectors coming from aux)
    def obj_aux(z, aux):
        return aux["sf"] * obj_m(z / aux["v"], _mesh(aux))

    def con_aux(z, aux):
        return aux["sc"] * con_m(z / aux["v"], _mesh(aux))

    sk = _kkt_structured(problem, nlp, options)
    jac_aux = hess_aux = sk_factory = kkt_fact = None
    if sk is not None:
        # the IPM runs on the per-node blocks alone: no dense assembler
        from .kkt_blocks import bind_structured_kkt

        def sk_factory(aux):
            return bind_structured_kkt(sk, _mesh(aux), aux["sf"], aux["sc"], 1.0 / aux["v"])
    else:
        kkt_fact = _kkt_factorizer(nlp, options)
    if sk is None and options.structured_derivatives:
        from .structured import (
            make_structured_hessian_mesh,
            make_structured_jacobian_mesh,
        )

        jac_m = make_structured_jacobian_mesh(problem, layout)
        hess_m = make_structured_hessian_mesh(
            problem, layout,
            gauss_newton=(options.hessian_approximation == "gauss-newton"),
        )

        def jac_aux(z, aux):
            v = aux["v"]
            return (aux["sc"][:, None] * jac_m(z / v, _mesh(aux))) / v[None, :]

        def hess_aux(z, lam, aux):
            v = aux["v"]
            H = hess_m(z / v, aux["sc"] * lam, _mesh(aux), aux["sf"])
            return H / (v[:, None] * v[None, :])

    return build_solver(
        obj_aux, con_aux, nlp.n, nlp.m, options.ipm_options(),
        jac_fn=jac_aux, hess_fn=hess_aux,
        kkt_factorizer=kkt_fact, structured_kkt=sk_factory, takes_aux=True,
    )


def _run_and_extract(problem, nlp, scaled, solver, options, prev_sol, grid,
                     nlp_tol, aux, device, dtype) -> Solution:
    """One IPM run at a batch of one (warm duals from ``prev_sol``), the
    result unscaled into a :class:`Solution`."""
    row = lambda a: torch.as_tensor(np.asarray(a), device=device, dtype=dtype)[None, :]
    kw = {}
    if prev_sol is not None:
        # scaled-problem duals: lambda_scaled = lambda * s_f / S_c
        lam_raw = _warm_duals(prev_sol, problem, nlp)
        lam0 = row(lam_raw * scaled.obj_scale / scaled.con_scale)
        zl0_raw, zu0_raw = _warm_bound_duals(prev_sol, problem, nlp)
        if zl0_raw is not None:
            kw["zl_d_init"] = row(scaled.rescale_bound_duals(zl0_raw))
            kw["zu_d_init"] = row(scaled.rescale_bound_duals(zu0_raw))
    else:
        lam0 = torch.zeros((1, nlp.m), device=device, dtype=dtype)
    kw["tol"] = float(nlp_tol if nlp_tol is not None else options.ipm_options().tol)
    t_start = time.perf_counter()
    res = solver(
        row(nlp.z0 * scaled.var_scale), row(scaled.zl), row(scaled.zu),
        row(scaled.cl), row(scaled.cu), lam0, aux=aux, **kw,
    )
    out = {k: v[0].detach().cpu().numpy() for k, v in res._asdict().items()
           if k != "history"}
    wall = time.perf_counter() - t_start
    z = scaled.unscale_z(out["z"])
    lam = scaled.unscale_lam(out["lam"])
    obj = scaled.unscale_objective(out["objective"])
    if options.verbose:
        log.info(
            "NLP solve: n=%d m=%d status=%d iters=%d obj=%.8g kkt=%.2e wall=%.2fs",
            nlp.n, nlp.m, int(out["status"]), int(out["iterations"]), obj,
            float(out["kkt_error"]), wall,
        )
    if options.iteration_log_dir and res.history is not None:
        out["history"] = {k: v[0].cpu().numpy() for k, v in res.history.items()}
        _write_iteration_log(options.iteration_log_dir, grid, out, nlp)
    sol = extract_solution(
        problem, nlp.layout, nlp.ops, z, lam, obj,
        int(out["status"]), float(out["kkt_error"]), int(out["iterations"]),
        zl_dual=scaled.unscale_bound_duals(out["zl_dual"]),
        zu_dual=scaled.unscale_bound_duals(out["zu_dual"]),
        device=device, dtype=dtype,
    )
    sol.wall_s, sol.nlp_n, sol.nlp_m = wall, nlp.n, nlp.m
    sol.host_syncs = solver.host_syncs
    return sol


def _solve_on_mesh_rt(
    problem: Problem, options: SolveOptions, prev_sol: Solution = None,
    grid: int = 1, nlp_tol: float = None, *, device, dtype,
) -> Solution:
    """Runtime-mesh counterpart of :func:`solve_on_mesh`."""
    nlp = transcribe(problem, device=device, dtype=dtype)
    jac_scale = None
    if options.structured_derivatives:
        from .structured import make_structured_jacobian

        jac_scale = make_structured_jacobian(
            problem, nlp.layout, nlp.ops, device=device, dtype=dtype)
    scaled = _scale(nlp, options, jac_scale, device, dtype)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device, dtype=dtype)
    aux = {
        "fracs": tuple(t(ph.mesh_fractions) for ph in problem.phases),
        "sf": t(scaled.obj_scale),
        "sc": t(scaled.con_scale),
        "v": t(scaled.var_scale),
    }
    return _run_and_extract(problem, nlp, scaled, _build_rt_solver(problem, nlp, options),
                            options, prev_sol, grid, nlp_tol, aux, device, dtype)


@traced
def solve_on_mesh(
    problem: Problem, options: SolveOptions, prev_sol: Solution = None,
    grid: int = 1, nlp_tol: float = None, *, device=None, dtype=torch.float64,
) -> Solution:
    """Single fixed-mesh solve: transcription + scaling + one IPM run, on
    ``device`` (``None`` means ``"cuda"``, and raises without one)."""
    device = resolve_device(device)
    if options.mesh_bucketing == "on":
        return _solve_on_mesh_rt(
            problem, options, prev_sol=prev_sol, grid=grid, nlp_tol=nlp_tol,
            device=device, dtype=dtype,
        )
    nlp = transcribe(problem, device=device, dtype=dtype)
    sk = _kkt_structured(problem, nlp, options)
    jac_raw, hess_raw = _structured(problem, nlp, options, device, dtype,
                                    hessian=sk is None)
    scaled = _scale(nlp, options, jac_raw, device, dtype)
    jac_fn = hess_fn = bound_sk = kkt_fact = None
    if sk is not None:
        bound_sk = _bind_fixed_mesh(sk, nlp, scaled, device, dtype)
    else:
        if jac_raw is not None:
            jac_fn, hess_fn = scaled.wrap_structured(jac_raw, hess_raw)
        kkt_fact = _kkt_factorizer(nlp, options)
    solver = build_solver(
        scaled.objective, scaled.constraints, nlp.n, nlp.m,
        options.ipm_options(), jac_fn=jac_fn, hess_fn=hess_fn,
        kkt_factorizer=kkt_fact, structured_kkt=bound_sk,
    )
    return _run_and_extract(problem, nlp, scaled, solver, options, prev_sol, grid,
                            nlp_tol, None, device, dtype)


@traced
def solve(problem: Problem, options: SolveOptions = SolveOptions(), *,
          device=None, dtype=torch.float64) -> Solution:
    """Full hp-adaptive solve (the reference's outer refinement loop), on
    ``device`` (``None`` means ``"cuda"``, and raises without one)."""
    device = resolve_device(device)
    sol = _solve_hp(problem, options, device=device, dtype=dtype)
    if options.report_file:
        from ..utils.report import write_report

        write_report(sol, options.report_file, problem=problem, options=options)
    return sol


def _solve_hp(problem: Problem, options: SolveOptions, *, device, dtype) -> Solution:
    from .options import validate

    options = validate(options)
    on = dict(device=device, dtype=dtype)
    if options.verbose:
        log.info("%s", describe_problem(problem, options))
    if options.mesh_bucketing == "on":
        from .refine import bucket_mesh

        problem = problem.with_meshes([
            bucket_mesh(tuple(ph.mesh_degrees), tuple(ph.mesh_fractions),
                        options.n_max)
            for ph in problem.phases
        ])
    mesh_history = [_mesh_signature(problem)]
    error_history = []
    grid_stats = []

    def _record(s, grid, note=""):
        """One row per NLP solve."""
        grid_stats.append({
            "grid": grid, "n": s.nlp_n, "m": s.nlp_m, "status": int(s.status),
            "iterations": int(s.iterations), "kkt_error": float(s.kkt_error),
            "objective": float(s.objective), "wall_s": float(s.wall_s),
            "host_syncs": int(s.host_syncs),
            "mesh": _mesh_signature(problem), "max_error": None, "note": note,
        })

    sol = None
    prev_sol = None
    refiner_state = None
    original_phases = problem.phases
    full_tol = options.ipm_options().tol
    adaptive_tol = (
        options.grid_tol_schedule == "adaptive"
        and options.mesh_method != "none" and options.max_grid_num > 1
    )
    prev_max_err = None

    def _grid_tol():
        if not adaptive_tol:
            return None
        if prev_max_err is None:
            return max(full_tol, 1e-5)
        # Cap by a fraction of the mesh tolerance as well: the loosened tol is
        # keyed to the PREVIOUS grid's mesh error, which is typically orders of
        # magnitude above the refined mesh's — without the cap the NLP residual
        # can dominate estimate_errors on a near-converged mesh and drive
        # over-refinement.
        return max(full_tol, min(1e-5, 0.01 * prev_max_err,
                                 0.1 * options.desired_relative_error))

    def _polish(sol, grid):
        """Final-mesh re-solve at the FULL tolerance (warm-started, same
        mesh) when the adaptive schedule solved it loosely."""
        if not adaptive_tol or sol.kkt_error <= full_tol:
            return sol
        wp = warm_start_problem(problem, sol)
        polished = solve_on_mesh(wp, options, prev_sol=sol, grid=grid, **on)
        _record(polished, grid, note="polish")
        if polished.status == SOLVED:
            # carry the hp-loop metadata onto the fresh Solution
            polished.grids = sol.grids
            polished.mesh_history = sol.mesh_history
            polished.error_history = sol.error_history
            polished.max_relative_error = sol.max_relative_error
            polished.path_violation = sol.path_violation
            polished.grid_stats = grid_stats
            return polished
        log.warning(
            "final full-tolerance polish failed (status %d); returning the "
            "loose-tolerance solution (kkt_error %.2e > tol %.0e) with "
            "polish_failed=True", polished.status, sol.kkt_error, full_tol,
        )
        sol.polish_failed = True
        return sol

    for grid in range(max(1, options.max_grid_num)):
        sol = solve_on_mesh(
            problem, options, prev_sol=prev_sol, grid=grid + 1,
            nlp_tol=_grid_tol(), **on,
        )
        _record(sol, grid + 1)
        if sol.status != SOLVED and grid > 0:
            # Warm start led the NLP astray (local blowup / divergence): retry
            # this mesh cold from the user's original guess before giving up.
            if options.verbose:
                log.warning("grid %d: warm-started NLP failed (status %d); cold restart",
                            grid + 1, sol.status)
            cold = replace(
                problem,
                phases=tuple(
                    replace(ph, guess_t=og.guess_t, guess_x=og.guess_x,
                            guess_u=og.guess_u, guess_q=og.guess_q)
                    for ph, og in zip(problem.phases, original_phases)
                ),
            )
            cold_sol = solve_on_mesh(
                cold, options, grid=grid + 1, nlp_tol=_grid_tol(), **on,
            )
            _record(cold_sol, grid + 1, note="cold-restart")
            if cold_sol.status == SOLVED or cold_sol.kkt_error < sol.kkt_error:
                sol = cold_sol
        sol.grids = grid + 1
        sol.mesh_history = list(mesh_history)
        sol.grid_stats = grid_stats
        if options.checkpoint_dir:
            from ..utils.checkpoint import save_checkpoint

            save_checkpoint(sol, problem, options.checkpoint_dir, grid + 1)
        if sol.status != SOLVED and prev_sol is not None:
            # Keep the last converged grid rather than refining garbage
            # (the reference aborts with an exception here; we return the
            # best solution, reference LpLpopcAlgorithm.cpp:49-84).
            if options.verbose:
                log.warning("grid %d: NLP failed after cold restart; "
                            "returning previous grid's solution", grid + 1)
            return prev_sol
        if sol.status == FAILED:
            sol.status = OCP_NLP_FAILED
            return sol
        if options.mesh_method == "none" or options.max_grid_num <= 1:
            return sol
        errs = estimate_errors(problem, sol, **on)
        prev_max_err = max((float(np.max(e)) if e.size else 0.0) for e in errs)
        error_history.append([e.copy() for e in errs])
        sol.error_history = error_history
        max_err = max((float(np.max(e)) if e.size else 0.0) for e in errs)
        sol.max_relative_error = max_err
        from .refine import estimate_path_violations

        pv_tol = options.path_violation_tol
        vp = estimate_path_violations(problem, sol, with_peaks=True, **on)
        viols = [v for v, _ in vp]
        peaks = [p for _, p in vp]
        sol.path_violation = max(
            (float(np.max(v)) if v.size else 0.0) for v in viols
        )
        pv_bad = pv_tol is not None and sol.path_violation > pv_tol
        if sol.path_violation > options.desired_relative_error and (
            pv_tol is None and options.verbose
        ):
            log.warning(
                "grid %d: inter-node path/bound violation %.3e (measured "
                "only; set path_violation_tol to drive refinement with it)",
                grid + 1, sol.path_violation,
            )
        if grid_stats:
            grid_stats[-1]["max_error"] = max_err
            grid_stats[-1]["path_violation"] = sol.path_violation
        if options.verbose:
            log.info(
                "grid %d: max relative error %.3e (tol %.1e), mesh %s",
                grid + 1, max_err, options.desired_relative_error,
                [len(ph.mesh_degrees) for ph in problem.phases],
            )
        if max_err <= options.desired_relative_error and not pv_bad:
            return _polish(sol, grid + 1)
        if grid == options.max_grid_num - 1:
            if pv_bad:
                log.warning(
                    "max_grid_num reached with inter-node violation %.3e "
                    "still above path_violation_tol %.1e", sol.path_violation,
                    pv_tol,
                )
            sol = _polish(sol, grid + 1)
            sol.status = OCP_REACH_MAX_GRID
            return sol
        # refine each phase's mesh
        new_meshes = []
        if options.mesh_method == "hp-liu":
            from .refine_liu import LiuState, liu_refine_phase

            if refiner_state is None:
                refiner_state = [LiuState() for _ in problem.phases]
            for i, (ph, psol, e) in enumerate(
                zip(problem.phases, sol.phases, errs)
            ):
                d, f, _ = liu_refine_phase(
                    ph, psol, e, refiner_state[i],
                    tol=options.desired_relative_error,
                    n_min=options.n_min, n_max=options.n_max,
                    curvature_ratio=options.curvature_ratio,
                    bucket_aware=(options.mesh_bucketing == "on"),
                )
                new_meshes.append((d, f))
        else:
            for ph, e in zip(problem.phases, errs):
                d, f, _ = ph_refine_phase(
                    tuple(ph.mesh_degrees), tuple(ph.mesh_fractions), e,
                    options.desired_relative_error, options.n_min, options.n_max,
                )
                new_meshes.append((d, f))
        if pv_tol is not None:
            # Close the loop on measured inter-node violations: h-points at
            # the violation peaks of segments the state-error refiners left
            # alone (err <= tol), inserted into the refined mesh.
            from .refine import insert_knots, violation_knots

            any_knot = False
            for i in range(len(problem.phases)):
                knots = violation_knots(
                    errs[i], viols[i], peaks[i],
                    options.desired_relative_error, pv_tol,
                )
                if knots:
                    d, f, ch = insert_knots(*new_meshes[i], knots)
                    new_meshes[i] = (d, f)
                    any_knot = any_knot or ch
            if pv_bad and not any_knot:
                # The violation the user asked to control got no knot this
                # grid: either its peaks ride existing points at minimum
                # separation, or every violating segment still has state
                # error above tol (the state refiners own it this grid).
                # Say so — silence here reads as "under control".
                log.warning(
                    "grid %d: inter-node violation %.3e > path_violation_tol"
                    " %.1e with no violation-driven knot this grid (%s)",
                    grid + 1, sol.path_violation, pv_tol,
                    "peaks ride existing mesh points"
                    if max_err <= options.desired_relative_error
                    else "violating segments still state-error-refining",
                )
                if max_err <= options.desired_relative_error:
                    # state-converged AND un-actionable: further grids
                    # cannot reduce the violation; return honestly
                    return _polish(sol, grid + 1)
        if options.mesh_bucketing == "on":
            from .refine import bucket_mesh

            new_meshes = [
                bucket_mesh(d, f, options.n_max) for d, f in new_meshes
            ]
        problem = warm_start_problem(problem, sol)
        problem = problem.with_meshes(new_meshes)
        mesh_history.append(_mesh_signature(problem))
        prev_sol = sol
    return sol
