"""Solve options of the top-level solve loop.

The JAX package's ``core/solve.py`` holds the whole solve loop (transcribe ->
scale -> IP solve -> hp-refine loop). Of it the port carries, so far, only
what the batched sweep needs: the user-facing :class:`SolveOptions` (same
fields, same defaults) and the rule that decides whether the block-KKT
factorization would engage. The hp-adaptive single-problem ``solve`` is a
later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .ipm import IPMOptions


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


def _block_engaged(nlp, options: SolveOptions) -> bool:
    if options.block_kkt == "off":
        return False
    if options.block_kkt == "auto" and nlp.n < options.block_kkt_threshold:
        return False
    return True
