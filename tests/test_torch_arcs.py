"""Port parity: singular-arc detection, the automatic decomposition and the
automatic singular-arc solves (core/arcs.py, core/decompose.py,
goddard.solve_auto, tumor.solve_auto).

* The detection cases of ``tests/test_goddard.py`` through both packages:
  the same arcs, field by field.
* ``switching_function`` and ``control_affinity`` on one shared solution
  (made from a seed, no solve), for Goddard and the tumor problem, to 1e-12.
* ``_endpoint_dependency`` on the JAX tests' cases, and
  ``decompose_by_arcs`` on a shared solution and arcs: the same phases
  (bounds, mesh, guesses to 1e-14, Mayer and event placement), and the same
  ``ValueError`` for a Mayer that couples both endpoints.
* ``solve_auto`` against the JAX package's runs pinned in
  ``scripts/jax_singular_pins.json`` (``scripts/jax_singular_pins.py``; the
  JAX compiles take minutes): arcs, every solve's status, grids and per-grid
  iterations, and objectives to 1e-8. By default at degrees (4,) * 4 with
  the two-rung ladder (cases ``*_reduced``); the full-width goldens are
  ``slow`` (cases ``goddard_auto``, ``tumor_auto``,
  ``tumor_auto_decompose``; several minutes each here).
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core import arcs as ref_arcs
from lpopc_tpu.core import decompose as ref_dec
from lpopc_tpu.models import goddard as ref_goddard
from lpopc_tpu.models import tumor as ref_tumor
from lpopc_tpu_torch.core import arcs as port_arcs
from lpopc_tpu_torch.core import decompose as port_dec
from lpopc_tpu_torch.core import solve as solve_mod
from lpopc_tpu_torch.models import goddard, tumor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "scripts", "jax_singular_pins.json"), encoding="utf-8") as _f:
    PINS = json.load(_f)
REL_TOL = 1e-12
OBJECTIVE_RTOL = 1e-8
REDUCED = dict(degrees=(4,) * 4, eps_schedule=(1e-2, 1e-3))
# Where rounding decides the count (ROADMAP Queue 3 entry 5): the reduced
# Goddard decomposition's solve (the workflow's second) — the JAX package
# itself takes 33 to 200 iterations, ending SOLVED or at the iteration limit,
# at three different optima, when the decomposed problem's guess is scaled
# by 1 + 1e-15·U(-1, 1) (scripts/jax_singular_pins.py case
# goddard_decomposed_jitter). Per case, solve index -> (least count, most
# count, statuses) over those copies and the pinned run.
_JIT = PINS["goddard_decomposed_jitter"]
_RED = PINS["goddard_auto_reduced"]["solves"][1]
ROUNDING_SPREAD_AUTO = {"goddard_auto_reduced": {1: (
    min(_JIT["iterations"] + [_RED["per_grid"][0][2]]),
    max(_JIT["iterations"] + [_RED["per_grid"][0][2]]),
    set(_JIT["status"]) | {_RED["status"]})}}


# the detection cases of tests/test_goddard.py::test_arc_detection_units:
# (u, keyword arguments, affinity to promote with or None)
_T = np.linspace(0.0, 1.0, 40)
DETECTION = {
    "ringing": (np.concatenate([np.full(10, 3.5), 1.5 + 0.5 * (-1.0) ** np.arange(20),
                                np.zeros(10)]), {}, None),
    "smooth": (np.concatenate([np.full(10, 3.5), np.linspace(2.0, 1.0, 20), np.zeros(10)]),
               {}, None),
    "smooth_affine": (np.concatenate([np.full(10, 3.5), np.linspace(2.0, 1.0, 20),
                                      np.zeros(10)]), {}, 0.0),
    "smooth_not_affine": (np.concatenate([np.full(10, 3.5), np.linspace(2.0, 1.0, 20),
                                          np.zeros(10)]), {}, 1.0),
    "blip_at_switch": (np.concatenate([np.full(19, 3.5), [1.7], np.zeros(20)]),
                       dict(min_nodes=2), None),
    "blip_at_t0": (np.concatenate([[3.5], np.linspace(2.0, 1.0, 19), np.zeros(20)]),
                   dict(min_nodes=2), None),
    "switching_function": (np.concatenate([np.full(10, 3.5), np.linspace(2.0, 1.0, 20),
                                           np.zeros(10)]),
                           dict(hu=np.concatenate([np.ones(10), 1e-3 * np.ones(20),
                                                   -np.ones(10)])), None),
}


def _arc_fields(arcs):
    return [dataclasses.astuple(a) for a in arcs]


def _same_arcs(got, want):
    assert len(got) == len(want)
    for g, w in zip(_arc_fields(got), _arc_fields(want)):
        assert g[:6] == w[:6]
        assert (np.isnan(g[6]) and np.isnan(w[6])) or g[6] == w[6]


@pytest.mark.parametrize("case", sorted(DETECTION))
def test_detection_matches_reference(case):
    u, kw, affinity = DETECTION[case]
    want = ref_arcs.detect_control_arcs(_T, u, 0.0, 3.5, **kw)
    got = port_arcs.detect_control_arcs(_T, u, 0.0, 3.5, **kw)
    if affinity is not None:
        ref_arcs.promote_interior_if_affine(want, affinity)
        port_arcs.promote_interior_if_affine(got, affinity)
    _same_arcs(got, want)
    assert port_arcs.has_singular_arc(got) == ref_arcs.has_singular_arc(want)
    assert port_arcs.describe_arcs(got) == ref_arcs.describe_arcs(want)


def _shared_solution(model, N=24):
    """A solution-shaped namespace made from seed 0 around the model's guess
    (no solve): states on the N+1 state points, controls and costates on the
    N collocation points, inside the bounds."""
    rng = np.random.default_rng(0)
    ph = (ref_goddard.make_problem(regularization=0.0) if model == "goddard"
          else ref_tumor.make_problem()).phases[0]
    t0, tf = float(ph.guess_t[0]), float(ph.guess_t[-1])
    t_state = np.linspace(t0, tf, N + 1)
    t_col = t_state[:-1] + 0.3 * (t_state[1] - t_state[0])
    x = np.stack([np.interp(t_state, ph.guess_t, ph.guess_x[:, j]) for j in range(ph.nx)], 1)
    x = x * (1.0 + 1e-3 * rng.uniform(-1, 1, x.shape))
    lo, hi = float(ph.u_bounds[0][0]), float(ph.u_bounds[1][0])
    u = lo + (hi - lo) * rng.uniform(0, 1, (N, 1))
    return types.SimpleNamespace(
        t_state=t_state, x=x, t_col=t_col, u=u, t0=t0, tf=tf, q=np.zeros(0),
        costate=rng.standard_normal((N, ph.nx)))


PHASES = {
    # name -> (model, JAX phase, port phase)
    "goddard": ("goddard", lambda: ref_goddard.make_problem(regularization=0.0).phases[0],
                lambda: goddard.make_problem(regularization=0.0).phases[0]),
    "goddard_regularized": ("goddard",
                            lambda: ref_goddard.make_problem(regularization=1e-2).phases[0],
                            lambda: goddard.make_problem(regularization=1e-2).phases[0]),
    "tumor": ("tumor", lambda: ref_tumor.make_problem().phases[0],
              lambda: tumor.make_problem().phases[0]),
    "tumor_regularized": ("tumor", lambda: ref_tumor.make_problem_regularized(1e-2).phases[0],
                          lambda: tumor.make_problem_regularized(1e-2).phases[0]),
}


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.max(np.abs(want)) if want.size else 0.0
    return float(np.max(np.abs(got - want)) / (scale if scale > 0 else 1.0)) if want.size else 0.0


@pytest.mark.parametrize("name", sorted(PHASES))
def test_switching_function_and_affinity_match_reference(name):
    model, ref_ph, port_ph = PHASES[name]
    psol = _shared_solution(model)
    if name.endswith("regularized"):
        psol.q = np.array([1e-2]) if model == "tumor" else np.zeros(0)
    hu_ref = ref_arcs.switching_function(ref_ph(), psol)
    hu = port_arcs.switching_function(port_ph(), psol, device="cpu")
    assert _rel(hu, hu_ref) <= REL_TOL
    a_ref = ref_arcs.control_affinity(ref_ph(), psol)
    a = port_arcs.control_affinity(port_ph(), psol, device="cpu")
    assert abs(a - a_ref) <= REL_TOL * max(abs(a_ref), 1e-300) or a == a_ref
    if name in ("goddard", "tumor"):
        assert a < 1e-12          # both problems are control-affine
    else:
        assert a > 1e-6           # the eps·u² term is not


def _sample(pkg):
    if pkg == "jax":
        return (jnp.ones(3), jnp.asarray(0.0), jnp.ones(3) * 2.0, jnp.asarray(1.0), jnp.zeros(0))
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return (f(np.ones(3)), f(0.0), f(np.ones(3) * 2.0), f(1.0), f(np.zeros(0)))


# tests/test_goddard.py's endpoint-dependency cases, in each package's arrays
ENDPOINT = {
    "final": (lambda x0, t0, xf, tf, q: -xf[0] + tf, lambda x0, t0, xf, tf, q: -xf[0] + tf,
              (False, True)),
    "initial": (lambda x0, t0, xf, tf, q: jnp.array([x0[1], t0]),
                lambda x0, t0, xf, tf, q: torch.stack([x0[1], t0]), (True, False)),
    "both": (lambda x0, t0, xf, tf, q: xf[0] - x0[0], lambda x0, t0, xf, tf, q: xf[0] - x0[0],
             (True, True)),
    "no_cancellation": (lambda x0, t0, xf, tf, q: jnp.array([xf[0], -xf[0]]),
                        lambda x0, t0, xf, tf, q: torch.stack([xf[0], -xf[0]]), (False, True)),
}


@pytest.mark.parametrize("case", sorted(ENDPOINT))
def test_endpoint_dependency_matches_reference(case):
    ref_fn, port_fn, want = ENDPOINT[case]
    assert ref_dec._endpoint_dependency(ref_fn, 3, 0, _sample("jax")) == want
    assert port_dec._endpoint_dependency(port_fn, 3, 0, _sample("port")) == want


def _goddard_arcs(psol):
    """Bang–singular–bang arcs on the shared solution's nodes."""
    N = psol.u.shape[0]
    t = psol.t_col
    cuts = [(0, N // 4 - 1, "upper"), (N // 4, 2 * N // 3 - 1, "singular"),
            (2 * N // 3, N - 1, "lower")]
    return [dict(kind=k, t_start=float(t[a]), t_end=float(t[b]), k_start=a, k_end=b,
                 oscillations=5 if k == "singular" else 0) for a, b, k in cuts]


def _with_event(ph, event):
    return dataclasses.replace(ph, nevent=1, event=event,
                               event_bounds=(np.array([-1.0]), np.array([1.0])))


DECOMPOSE = {
    # name -> (JAX problem, port problem)
    "goddard": (lambda: ref_goddard.make_problem(regularization=0.0),
                lambda: goddard.make_problem(regularization=0.0)),
    "goddard_final_event": (
        lambda: dataclasses.replace(ref_goddard.make_problem(regularization=0.0), phases=(
            _with_event(ref_goddard.make_problem(regularization=0.0).phases[0],
                        lambda x0, t0, xf, tf, q: jnp.array([xf[1]])),)),
        lambda: dataclasses.replace(goddard.make_problem(regularization=0.0), phases=(
            _with_event(goddard.make_problem(regularization=0.0).phases[0],
                        lambda x0, t0, xf, tf, q: xf[1:2]),))),
    "goddard_initial_event": (
        lambda: dataclasses.replace(ref_goddard.make_problem(regularization=0.0), phases=(
            _with_event(ref_goddard.make_problem(regularization=0.0).phases[0],
                        lambda x0, t0, xf, tf, q: jnp.array([x0[1] + t0])),)),
        lambda: dataclasses.replace(goddard.make_problem(regularization=0.0), phases=(
            _with_event(goddard.make_problem(regularization=0.0).phases[0],
                        lambda x0, t0, xf, tf, q: (x0[1] + t0).reshape(1)),))),
}
_PHASE_ARRAYS = ("x0_bounds", "xf_bounds", "x_bounds", "u_bounds", "t0_bounds", "tf_bounds",
                 "duration_bounds", "event_bounds", "path_bounds", "guess_t", "guess_x",
                 "guess_u")


@pytest.mark.parametrize("case", sorted(DECOMPOSE))
def test_decompose_matches_reference(case):
    ref_make, port_make = DECOMPOSE[case]
    psol = _shared_solution("goddard")
    arcs = _goddard_arcs(psol)
    want = ref_dec.decompose_by_arcs(ref_make(), psol, [ref_arcs.Arc(**a) for a in arcs])
    got = port_dec.decompose_by_arcs(port_make(), psol, [port_arcs.Arc(**a) for a in arcs],
                                     device="cpu")
    assert len(got.phases) == len(want.phases) == 3
    assert [(l.left, l.right, l.nlink) for l in got.linkages] == \
        [(l.left, l.right, l.nlink) for l in want.linkages]
    for g, w in zip(got.phases, want.phases):
        assert (g.nx, g.nu, g.nq, g.npath, g.nevent, g.name) == \
            (w.nx, w.nu, w.nq, w.npath, w.nevent, w.name)
        assert (g.mesh_degrees, g.mesh_fractions) == (w.mesh_degrees, w.mesh_fractions)
        for field in _PHASE_ARRAYS:
            gv, wv = getattr(g, field), getattr(w, field)
            if wv is None:
                assert gv is None, field
                continue
            for a, b in zip(gv if isinstance(wv, tuple) else (gv,),
                            wv if isinstance(wv, tuple) else (wv,)):
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                           rtol=0, atol=1e-14, err_msg=field)
        # Mayer and event placement, and the confined regularizer
        assert (g.mayer is None) == (w.mayer is None)
        assert (g.event is None) == (w.event is None)
        assert (g.lagrange is None) == (w.lagrange is None)
    # the linkage and the singular phase's regularizer evaluate alike
    x = np.array([1.01, 0.05, 0.8])
    u = np.array([1.2])
    assert abs(float(got.phases[1].lagrange(torch.as_tensor(x), torch.as_tensor(u), 0.1, None))
               - float(want.phases[1].lagrange(jnp.asarray(x), jnp.asarray(u), 0.1, None))) \
        <= 1e-18
    link = got.linkages[0].fn(torch.as_tensor(x), None, torch.as_tensor(2 * x), None)
    np.testing.assert_allclose(link.numpy(), x, rtol=0, atol=0)


def test_decompose_rejects_endpoint_coupled_mayer():
    psol = _shared_solution("goddard")
    arcs = _goddard_arcs(psol)[:2]
    msgs = []
    for dec, arcs_mod, p in (
            (ref_dec, ref_arcs, ref_goddard.make_problem(regularization=0.0)),
            (port_dec, port_arcs, goddard.make_problem(regularization=0.0))):
        p = dataclasses.replace(p, phases=(dataclasses.replace(
            p.phases[0], mayer=lambda x0, t0, xf, tf, q: xf[0] - x0[0]),))
        kw = {"device": "cpu"} if dec is port_dec else {}
        with pytest.raises(ValueError, match="both endpoints") as e:
            dec.decompose_by_arcs(p, psol, [arcs_mod.Arc(**a) for a in arcs], **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _run_auto(model, **kw):
    """``model.solve_auto(**kw)`` on the CPU with every solve recorded as the
    pins record it."""
    solves, real = [], solve_mod.solve

    def recorded(problem, options=solve_mod.SolveOptions(), **on):
        sol = real(problem, options, **on)
        solves.append({"phases": len(problem.phases), "status": int(sol.status),
                       "grids": sol.grids, "objective": float(sol.objective),
                       "per_grid": [[g["n"], g["m"], g["iterations"]] for g in sol.grid_stats]})
        return sol

    solve_mod.solve = recorded
    try:
        sol = model.solve_auto(device="cpu", **kw)
    finally:
        solve_mod.solve = real
    return sol, solves


def _check_auto(case, sol, solves):
    pin = PINS[case]
    got_arcs = [{"kind": a.kind, "k_start": a.k_start, "k_end": a.k_end} for a in sol.arcs]
    assert got_arcs == [{k: a[k] for k in ("kind", "k_start", "k_end")} for a in pin["arcs"]]
    for a, w in zip(sol.arcs, pin["arcs"]):
        assert a.oscillations == w["oscillations"]
        assert abs(a.t_start - w["t_start"]) <= 1e-9 and abs(a.t_end - w["t_end"]) <= 1e-9
    spread = ROUNDING_SPREAD_AUTO.get(case, {})
    assert len(solves) == len(pin["solves"])
    for i, (g, w) in enumerate(zip(solves, pin["solves"])):
        assert (g["phases"], g["grids"]) == (w["phases"], w["grids"])
        assert [pg[:2] for pg in g["per_grid"]] == [pg[:2] for pg in w["per_grid"]]
        if i in spread:
            lo, hi, statuses = spread[i]
            assert g["status"] in statuses and lo <= g["per_grid"][0][2] <= hi, (i, g)
            continue
        assert g["status"] == w["status"], (i, g, w)
        assert [pg[2] for pg in g["per_grid"]] == [pg[2] for pg in w["per_grid"]], (i, g, w)
        if w["status"] == 1:      # an iterate cut by the iteration limit is no answer
            assert abs(g["objective"] - w["objective"]) <= OBJECTIVE_RTOL * abs(w["objective"])
    assert sol.status == pin["status"] and len(sol.phases) == pin["phases"]
    if len(solves) - 1 not in spread:
        assert abs(sol.objective - pin["objective"]) <= OBJECTIVE_RTOL * abs(pin["objective"])


AUTO = {
    # pin case -> (model, keyword arguments)
    "goddard_auto_reduced": (goddard, REDUCED),
    "tumor_auto_reduced": (tumor, REDUCED),
    "tumor_auto_decompose_reduced": (tumor, dict(method="decompose", **REDUCED)),
}


@pytest.mark.parametrize("case", sorted(AUTO))
def test_solve_auto_reduced_matches_reference(case):
    model, kw = AUTO[case]
    sol, solves = _run_auto(model, **kw)
    _check_auto(case, sol, solves)


@pytest.mark.slow
def test_goddard_solve_auto_golden():
    sol, solves = _run_auto(goddard)
    _check_auto("goddard_auto", sol, solves)
    assert sol.solved
    assert abs(-sol.objective - goddard.PUBLISHED_HF) < 1e-4
    assert [a.kind for a in sol.arcs] == ["upper", "singular", "lower"]


@pytest.mark.slow
@pytest.mark.parametrize("method", ["continuation", "decompose"])
def test_tumor_solve_auto_golden(method):
    case = "tumor_auto" if method == "continuation" else "tumor_auto_decompose"
    sol, solves = _run_auto(tumor, method=method)
    _check_auto(case, sol, solves)
    assert sol.solved
    p_tf = sol.objective * tumor.SCALE
    if method == "continuation":
        assert abs(p_tf - 1954.4) < 2.0
        kinds = [a.kind for a in sol.arcs]
        assert kinds[0] == "upper" and "singular" in kinds
        y_f = sol.phases[0].x[-1, 2]
        assert 0.9 < y_f <= 1.0 + 1e-9
    else:
        assert abs(p_tf - 1951.8) < 3.0
        assert p_tf < 1954.6


def test_tumor_module_exports_solve():
    """``tests/test_tumor.py`` solves rung 0 through ``tumor._solve``; the
    port's module exports it too."""
    assert tumor._solve is solve_mod.solve
