"""Registered-option metadata and validation.

Typed counterpart of the reference's IPOPT-style option registry
(``Lpopc/src/Common/LpOption.hpp:414-534``,
``LpOptionList.hpp:16-90``; the user-facing knob list is documented in
``doc/LpopcDoc.tex:1203-1267``). Instead of a string-map with runtime lookup,
options live in the typed dataclasses :class:`SolveOptions` / ``IPMOptions``;
this module carries the registry metadata (reference name, bounds, docs) and
a validator, and can build options from reference-style string key/values for
drop-in familiarity.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

from .ipm import IPMOptions
from .solve import SolveOptions


@dataclass(frozen=True)
class OptionSpec:
    name: str                 # lpopc_tpu_torch field name
    reference_name: str       # the reference's registered option string
    otype: type
    default: Any
    lower: Optional[float] = None
    upper: Optional[float] = None
    choices: Optional[tuple] = None
    doc: str = ""


REGISTRY: tuple[OptionSpec, ...] = (
    OptionSpec("tol", "Ipopt-tol", float, 1e-8, 0.0, 1.0,
               doc="NLP convergence tolerance (reference default 1e-6)"),
    OptionSpec("max_iterations", "max-iterations", int, 300, 1, 100000,
               doc="interior-point iteration cap per mesh"),
    OptionSpec("auto_scale", "auto-scale", bool, True,
               doc="automatic gradient-based problem scaling (reference: Betts autoscale, off by default; here on)"),
    OptionSpec("variable_scaling", "variable-scale", bool, False,
               doc="Betts bounds-based variable scaling"),
    OptionSpec("scale_samples", "scale-samples", int, 0, 0, 1000,
               doc="random sample count for scaling row norms (reference uses 90, LpSacleOCP.cpp; 0 = scale at the guess)"),
    OptionSpec("mesh_method", "mesh-refine-methods", str, "ph",
               choices=("ph", "hp-liu", "none"),
               doc="hp refinement strategy (reference: ph | hp-Liu)"),
    OptionSpec("max_grid_num", "max-grid-num", int, 10, 1, 1000,
               doc="refinement iteration cap (reference default 10)"),
    OptionSpec("desired_relative_error", "desired-relative-error", float, 1e-6, 0.0, 1.0,
               doc="mesh tolerance (reference default 1e-6)"),
    OptionSpec("path_violation_tol", "path-violation-tol", float, None, 0.0, 1.0,
               doc="inter-node path/bound violation tolerance; None measures "
                   "only, a value drives knot insertion at violation peaks "
                   "(beyond-reference: LpopcDoc.tex:1139 never measures it)"),
    OptionSpec("n_min", "Nmin", int, 4, 2, 64,
               doc="minimum collocation points per segment (reference default 4)"),
    OptionSpec("n_max", "Nmax", int, 16, 3, 64,
               doc="maximum collocation points per segment (reference default 16)"),
    OptionSpec("curvature_ratio", "R", float, 1.2, 1.0, 100.0,
               doc="hp-Liu smoothness threshold (reference default 1.2)"),
    OptionSpec("mu_init", "mu-init", float, 1e-1, 0.0, 10.0,
               doc="initial barrier parameter"),
    OptionSpec("mu_strategy", "mu-strategy", str, "auto",
               choices=("auto", "monotone", "adaptive", "probing", "mehrotra"),
               doc="barrier update rule (reference runs IPOPT mu_strategy="
                   "adaptive; 'auto' (default) is the Mehrotra oracle behind "
                   "a centrality guard that falls back to monotone when the "
                   "line search backtracks, 'probing' the plain Mehrotra "
                   "affine-scaling mu-oracle, 'adaptive' the LOQO rule)"),
    OptionSpec("iteration_log_dir", "output-file-dir", str, None,
               doc="write per-grid IPM iteration traces grid-<k>-ipm-out.txt "
                   "(reference: grid-<k>Ipopt-out.txt)"),
    OptionSpec("report_file", "report-file", str, None,
               doc="write the combined solve report (per-grid NLP table + "
                   "refinement history + final verdict, utils/report.py) "
                   "after solve()"),
    OptionSpec("block_kkt", "block-kkt", str, "auto",
               choices=("auto", "on", "off"),
               doc="segment-block + border-Schur KKT factorization (core/block_kkt.py)"),
    OptionSpec("block_kkt_threshold", "block-kkt-threshold", int, 700, 1, 10**9,
               doc="NLP size above which block-kkt=auto engages"),
    OptionSpec("mesh_bucketing", "mesh-bucketing", str, "on",
               choices=("on", "off"),
               doc="shape-bucketed recompile-free hp refinement (runtime-mesh solver); default on since round 2"),
    OptionSpec("block_assembly", "block-assembly", str, "direct",
               choices=("direct", "dense"),
               doc="matrix-free per-segment KKT assembly vs dense-then-gather"),
    OptionSpec("grid_tol_schedule", "grid-tol-schedule", str, "off",
               choices=("off", "adaptive"),
               doc="per-grid NLP tolerance: coarse grids solved ~100x tighter "
                   "than their measured mesh error, final mesh polished at "
                   "the full tolerance (traced tol -> no extra compiles)"),
    OptionSpec("hessian_approximation", "hessian-approximation", str, "exact",
               choices=("exact", "gauss-newton"),
               doc="exact per-node AD Lagrangian Hessian, or gauss-newton "
                   "(drop constraint curvature; the reference's "
                   "hessian-approximation=limited-memory niche: cheap/PSD "
                   "Hessian when exact second derivatives are costly)"),
    OptionSpec("verbose", "print-level", bool, False, doc="per-grid logging"),
)

_BY_REF = {s.reference_name: s for s in REGISTRY}
_BY_NAME = {s.name: s for s in REGISTRY}

# Reference options made obsolete by exact AD (the FD / analytic-derivative /
# derivative-checker machinery, doc/LpopcDoc.tex:1203-1267). Accepted and
# ignored with a log message so reference configurations port unchanged;
# the capability they configured is strictly subsumed (torch.func grad/jacfwd/
# hessian are exact; core/check.py validates user functions).
_OBSOLETE = {
    "first-derive": "derivatives are exact AD (no FD/analytic switch needed)",
    "finite-difference-tol": "no finite differencing is performed",
    "analytic-derive-check": "use lpopc_tpu_torch.core.check.check_problem",
    "analytic-derive-check-tol": "use lpopc_tpu_torch.core.check.check_problem",
}


class OptionError(ValueError):
    """Typed option failure (the reference's LpException counterpart)."""


def validate(options: SolveOptions) -> SolveOptions:
    """Range/choice-check every registered knob; raises OptionError."""
    for spec in REGISTRY:
        val = getattr(options, spec.name)
        if spec.choices is not None and val not in spec.choices:
            raise OptionError(
                f"option {spec.name} ({spec.reference_name}): {val!r} not in {spec.choices}"
            )
        if spec.otype in (int, float) and val is not None:
            if spec.lower is not None and val < spec.lower:
                raise OptionError(
                    f"option {spec.name} ({spec.reference_name}): {val} < {spec.lower}"
                )
            if spec.upper is not None and val > spec.upper:
                raise OptionError(
                    f"option {spec.name} ({spec.reference_name}): {val} > {spec.upper}"
                )
    if options.n_min > options.n_max:
        raise OptionError("Nmin must be <= Nmax")
    if (options.hessian_approximation == "gauss-newton"
            and not options.structured_derivatives):
        raise OptionError(
            "hessian-approximation=gauss-newton requires "
            "structured_derivatives=True (the global-AD fallback always "
            "differentiates the full Lagrangian)")
    return options


def from_reference_strings(pairs: dict) -> SolveOptions:
    """Build SolveOptions from reference-style option names, e.g.
    ``{"Ipopt-tol": 1e-6, "mesh-refine-methods": "hp-Liu", "max-grid-num": 20}``.
    """
    import logging

    kwargs = {}
    for key, value in pairs.items():
        if key in _OBSOLETE or key.lower() in _OBSOLETE:
            logging.getLogger("lpopc_tpu_torch").info(
                "option %r is obsolete here: %s", key,
                _OBSOLETE.get(key, _OBSOLETE.get(key.lower())),
            )
            continue
        norm = key if key in _BY_REF else key.lower()
        spec = _BY_REF.get(norm) or _BY_REF.get(
            {"hp-liu": "mesh-refine-methods"}.get(norm, "")
        )
        if spec is None:
            raise OptionError(f"unknown option {key!r}; known: {sorted(_BY_REF)}")
        if spec.name == "mesh_method" and isinstance(value, str):
            value = value.lower()
        if spec.name == "hessian_approximation" and value == "limited-memory":
            # the reference's quasi-Newton mode; our curvature-free analogue
            value = "gauss-newton"
        kwargs[spec.name] = spec.otype(value)
    return validate(SolveOptions(**kwargs))


def describe() -> str:
    """Human-readable option table (the reference prints its registry at
    startup; ``LpLpopcAlgorithm::OutputProblemInfo``)."""
    lines = [f"{'option':24} {'reference name':26} {'default':>10}  doc"]
    for s in REGISTRY:
        lines.append(f"{s.name:24} {s.reference_name:26} {s.default!r:>10}  {s.doc}")
    return "\n".join(lines)
