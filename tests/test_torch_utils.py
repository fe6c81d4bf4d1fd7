"""Port parity of the utilities: result files, checkpoints, the solve
report, plotting, problem checks and the profiler trace.

The same moonlander solve (degrees (4, 4), ``mesh_method="none"``, as
``tests/test_aux.py`` runs it) goes through both packages with
``report_file`` and ``checkpoint_dir`` set; their files are compared: the
result files to 1e-8, the report line for line (numbers to 1e-8, timings
masked), and each package's checkpoint resumed in the other, which must give
the same meshes and guesses, exactly. The port alone then runs
``tests/test_options.py``'s two-grid solve (ph refinement forced to a second
grid; the JAX package's compiles of it take ~30 s here) for one checkpoint
per grid, and ``tests/test_aux.py``'s report of a full hp solve.
"""

import glob
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpopc_tpu.core.check import ProblemCheckError as RefProblemCheckError
from lpopc_tpu.core.check import check_problem as ref_check
from lpopc_tpu.core.problem import Phase as RefPhase
from lpopc_tpu.core.problem import Problem as RefProblem
from lpopc_tpu.core.solve import SolveOptions as RefSolveOptions
from lpopc_tpu.core.solve import solve as ref_solve
from lpopc_tpu.models import moonlander as ref_moonlander
from lpopc_tpu.utils import checkpoint as ref_checkpoint
from lpopc_tpu.utils.report import format_report as ref_format_report
from lpopc_tpu.utils.resultfiles import save_results as ref_save_results
from lpopc_tpu_torch.core.check import ProblemCheckError, check_problem
from lpopc_tpu_torch.core.options import _OBSOLETE
from lpopc_tpu_torch.core.problem import Phase, Problem
from lpopc_tpu_torch.core.solve import SolveOptions, solve
from lpopc_tpu_torch.models import moonlander
from lpopc_tpu_torch.utils import checkpoint
from lpopc_tpu_torch.utils.plot import plot_solution
from lpopc_tpu_torch.utils.report import format_report, write_report
from lpopc_tpu_torch.utils.resultfiles import save_results
from lpopc_tpu_torch.utils.trace import device_profile, scope

TOL = 1e-8
SOLVE = dict(mesh_method="none")
TWO_GRIDS = dict(mesh_method="ph", max_grid_num=2, desired_relative_error=1e-9)
PORT_MODELS = sorted(
    m[:-3] for m in os.listdir(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "lpopc_tpu_torch", "models"))
    if m.endswith(".py") and m != "__init__.py")


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """Both packages' solves, each writing its report and checkpoints."""
    base = tmp_path_factory.mktemp("utils")
    out = {}
    for pkg, run, make, options in (
            ("jax", ref_solve, ref_moonlander.make_problem, RefSolveOptions),
            ("port", lambda p, o: solve(p, o, device="cpu"), moonlander.make_problem,
             SolveOptions)):
        d = base / pkg
        sol = run(make(degrees=(4, 4)), options(
            **SOLVE, report_file=str(d / "report.txt"), checkpoint_dir=str(d / "ckpt")))
        out[pkg] = (sol, d)
    return out


def _same_number(a, b):
    return abs(a - b) <= TOL * max(1.0, abs(b))


def test_solves_agree(solved):
    (ref, _), (sol, _) = solved["jax"], solved["port"]
    assert (sol.status, sol.grids, sol.mesh_history) == (ref.status, ref.grids, ref.mesh_history)
    assert [r["iterations"] for r in sol.grid_stats] == [r["iterations"]
                                                           for r in ref.grid_stats]
    assert _same_number(sol.objective, ref.objective)


def test_save_results_matches_jax(solved, tmp_path):
    ref_paths = ref_save_results(solved["jax"][0], str(tmp_path / "jax"))
    paths = save_results(solved["port"][0], str(tmp_path / "port"))
    names = [os.path.basename(p) for p in paths]
    assert names == [os.path.basename(p) for p in ref_paths]
    for want in ("time1.dat", "state1.dat", "control1.dat", "costate1.dat",
                 "Hamiltonian1.dat", "parameter1.dat", "summary.txt"):
        assert want in names
    for name in names:
        if name.endswith(".dat"):
            got, want = np.loadtxt(tmp_path / "port" / name), np.loadtxt(tmp_path / "jax" / name)
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)
    _same_text(tmp_path / "port" / "summary.txt", tmp_path / "jax" / "summary.txt")


_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _same_lines(got_lines, want_lines):
    """Line for line: the text between numbers equal, the numbers to TOL."""
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        for a, b in zip(_NUM.findall(g), _NUM.findall(w)):
            assert _same_number(float(a), float(b)), (g, w)


def _same_text(got_path, want_path):
    _same_lines(open(got_path).read().splitlines(), open(want_path).read().splitlines())


_ROW = re.compile(r"^\s+\d+\s+\d+\s+\d+\s+[A-Z_]+\s+\d+\s+\S+\s+\S+\s+(\S+)")


def _mask_timings(text):
    """The report's lines with the wall-clock fields replaced by 'T' (and a
    solve row's spacing, which the wall's width moves, collapsed)."""
    lines = []
    for line in text.splitlines():
        m = _ROW.match(line)
        if m:
            line = " ".join((line[:m.start(1)] + "T" + line[m.end(1):]).split())
        lines.append(re.sub(r"IPM iterations, \S+ s$", "IPM iterations, T s", line))
    return lines


def test_report_matches_jax_line_for_line(solved):
    (ref, dref), (sol, d) = solved["jax"], solved["port"]
    got = _mask_timings(open(d / "report.txt").read())
    want = _mask_timings(open(dref / "report.txt").read())
    assert "NLP solves (hp loop):" in got and "mesh refinement history:" in got
    assert any(line.startswith("phase 1:") for line in got)
    _same_lines(got, want)
    # and rendered standalone, without problem and options
    _same_lines(_mask_timings(format_report(sol)), _mask_timings(ref_format_report(ref)))


def test_write_report_makes_its_directory(solved, tmp_path):
    path = write_report(solved["port"][0], str(tmp_path / "a" / "b" / "r.txt"))
    assert open(path).read() == format_report(solved["port"][0])


@pytest.fixture(scope="module")
def two_grids(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_grids")
    sol = solve(moonlander.make_problem(degrees=(4, 4)),
                SolveOptions(**TWO_GRIDS, checkpoint_dir=str(d)), device="cpu")
    return sol, d


def test_solve_writes_one_checkpoint_per_grid(two_grids):
    sol, d = two_grids
    ckpts = sorted(glob.glob(str(d / "grid_*.npz")))
    assert sol.grids == 2
    assert [os.path.basename(p) for p in ckpts] == ["grid_001.npz", "grid_002.npz"]
    data, meta = checkpoint.load_checkpoint(ckpts[-1])
    # written before the loop marks the grid cap (status 5) on the Solution
    assert meta["grid"] == sol.grids and meta["status"] == sol.grid_stats[-1]["status"]
    assert meta["meshes"] == [{"degrees": list(d_), "fractions": list(f)}
                              for d_, f in sol.mesh_history[-1]]
    np.testing.assert_array_equal(data["z"], sol.z)


def test_report_of_a_full_hp_solve(tmp_path):
    """tests/test_aux.py's combined report: brachistochrone (6, 6) under the
    default options."""
    from lpopc_tpu_torch.models import brachistochrone

    rf = tmp_path / "solve-report.txt"
    sol = solve(brachistochrone.make_problem(degrees=(6, 6)),
                SolveOptions(report_file=str(rf)), device="cpu")
    assert sol.solved and sol.grid_stats
    row = sol.grid_stats[0]
    assert row["grid"] == 1 and row["n"] > 0 and row["m"] > 0 and row["status"] == 1
    assert any(r["max_error"] is not None for r in sol.grid_stats)
    txt = rf.read_text()
    for want in ("NLP solves (hp loop):", "SOLVED", "phase 1:", "mesh refinement history:"):
        assert want in txt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_in_the_other_package(solved, writer):
    """The .npz layout and meta are the JAX package's: a checkpoint written
    by either package resumes in both to the same meshes and guesses."""
    ckpt = str(solved[writer][1] / "ckpt")
    port, grid = checkpoint.resume_problem(moonlander.make_problem(degrees=(4, 4)), ckpt)
    ref, ref_grid = ref_checkpoint.resume_problem(
        ref_moonlander.make_problem(degrees=(4, 4)), ckpt)
    assert grid == ref_grid == solved[writer][0].grids
    for ph, rph in zip(port.phases, ref.phases):
        assert tuple(ph.mesh_degrees) == tuple(rph.mesh_degrees)
        assert tuple(ph.mesh_fractions) == tuple(rph.mesh_fractions)
        for k in ("guess_t", "guess_x", "guess_u", "guess_q"):
            a, b = getattr(ph, k), getattr(rph, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)


def test_resumed_solve_converges(two_grids):
    sol, d = two_grids
    prob2, grid = checkpoint.resume_problem(moonlander.make_problem(degrees=(4, 4)), str(d))
    assert grid == sol.grids
    assert tuple(prob2.phases[0].mesh_degrees) == sol.mesh_history[-1][0][0]
    sol2 = solve(prob2, SolveOptions(mesh_method="none"), device="cpu")
    assert sol2.solved
    assert abs(sol2.objective - sol.objective) < 1e-6


def test_resume_without_checkpoint(tmp_path):
    prob = moonlander.make_problem()
    prob2, grid = checkpoint.resume_problem(prob, str(tmp_path))
    assert grid == 0 and prob2 is prob
    assert checkpoint.latest_checkpoint(str(tmp_path)) is None


def test_plot_solution_agg(solved, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figs = plot_solution(solved["port"][0], path=str(tmp_path / "sol.png"))
    try:
        assert len(figs) == 1 and os.path.getsize(tmp_path / "sol.png") > 0
        assert [ax.get_ylabel() for ax in figs[0].axes] == ["states", "controls", "costates"]
    finally:
        for f in figs:
            plt.close(f)


# ------------------------------------------------------------- check_problem


@pytest.mark.parametrize("model", PORT_MODELS)
def test_check_problem_passes_on_every_model(model):
    import importlib

    mod = importlib.import_module(f"lpopc_tpu_torch.models.{model}")
    check_problem(mod.make_problem(), device="cpu")


class _WrongDerivative(torch.autograd.Function):
    """sin with the derivative claimed as 2 cos (both modes)."""

    @staticmethod
    def forward(x):
        return torch.sin(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.x = inputs[0]

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 2.0 * torch.cos(x) * g

    @staticmethod
    def jvp(ctx, t):
        return 2.0 * torch.cos(ctx.x) * t


@jax.custom_jvp
def _ref_wrong(x):
    return jnp.sin(x)


@_ref_wrong.defjvp
def _ref_wrong_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    return jnp.sin(x), 2.0 * jnp.cos(x) * t


def _broken(kind, port: bool):
    """A one-phase problem whose dynamics has one defect, in either package."""
    np_, cat = (torch, lambda xs: torch.stack(xs)) if port else (jnp, jnp.stack)
    if kind == "shape":
        dyn = lambda x, u, t, q: cat([x[1], u[0], x[0]])
    elif kind == "nan":
        dyn = lambda x, u, t, q: cat([x[1], np_.sqrt(-1.0 - x[0] ** 2)])
    else:
        wrong = _WrongDerivative.apply if port else _ref_wrong
        dyn = lambda x, u, t, q: cat([wrong(x[1]), u[0]])
    P, Pr = (Phase, Problem) if port else (RefPhase, RefProblem)
    ph = P(nx=2, nu=1, dynamics=dyn, lagrange=lambda x, u, t, q: 0.5 * u[0] ** 2,
           x0_bounds=(np.zeros(2), np.zeros(2)), xf_bounds=(np.ones(2), np.ones(2)),
           x_bounds=(np.full(2, -5.0), np.full(2, 5.0)), u_bounds=(-3.0, 3.0),
           t0_bounds=(0.0, 0.0), tf_bounds=(1.0, 1.0), mesh_degrees=(4,),
           mesh_fractions=(-1.0, 1.0))
    return Pr(phases=(ph,))


@pytest.mark.parametrize("kind", ["shape", "nan", "derivative"])
def test_check_problem_raises_jax_message(kind):
    with pytest.raises(ProblemCheckError) as got:
        check_problem(_broken(kind, port=True), device="cpu")
    with pytest.raises(RefProblemCheckError) as want:
        ref_check(_broken(kind, port=False))
    if kind == "derivative":
        head = ("phase 0: dynamics fails the derivative check "
                "(custom rules inconsistent or non-differentiable): ")
        assert str(got.value).startswith(head) and str(want.value).startswith(head)
    else:
        assert str(got.value) == str(want.value)
    # without the derivative check the custom rule goes unnoticed, as in JAX
    if kind == "derivative":
        check_problem(_broken(kind, port=True), derivative_check=False, device="cpu")


def test_obsolete_options_point_at_check_problem():
    for name in ("analytic-derive-check", "analytic-derive-check-tol"):
        assert _OBSOLETE[name] == "use lpopc_tpu_torch.core.check.check_problem"


# ------------------------------------------------------------ device_profile


def test_device_profile_traces_a_scope_on_the_cpu(tmp_path):
    with device_profile(str(tmp_path / "prof"), device="cpu") as prof:
        with scope("lpopc_span_under_test"):
            torch.ones(8, 8, dtype=torch.float64) @ torch.ones(8, 8, dtype=torch.float64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "lpopc_span_under_test" in names
    assert any("lpopc_span_under_test" == e.key for e in prof.key_averages())
