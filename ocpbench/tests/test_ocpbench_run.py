"""A whole run of a cell, on the CPU at a tiny size (the program's plain
kernels): the window, the metrics, and the comparison that decides
``correct``, which the port passes, and which its float32 path (the
control) and each fault the cells can have fail."""

import numpy as np
import pytest
import torch

import lpopc_tpu_torch.core.solve as solve_mod
import lpopc_tpu_torch.parallel.batch as batch_mod
from ocpbench import judge, run, spec

SEED = 2 ** 31 + 77

HYPER_SMALL = '''"""The hyper-sensitive problem at tf = 20 (a test's configuration)."""
NX, NU = 1, 1


def dynamics(x, u):
    return -x ** 3 + u


def lagrange(x, u):
    return 0.5 * (x[..., 0] ** 2 + u[..., 0] ** 2)


mayer = None
BOUNDS = {"x": ([-50.0], [50.0]), "u": ([-50.0], [50.0]), "x0": ([1.5], [1.5]),
          "xf": ([1.0], [1.0]), "t0": (0.0, 0.0), "tf": (20.0, 20.0),
          "duration": (0.0, float("inf"))}
'''


OWN_TRANSCRIPTION = '''

from ocpbench.reference import ocp

USED = []


class Transcription(ocp.Transcription):
    """The configuration's own transcription, as a problem of several phases
    would bring it."""

    def __init__(self, problem, mesh):
        USED.append(mesh)
        super().__init__(problem, mesh)
'''

LOCKSTEP = '''"""A mode added as a file: the sweep, counting its calls."""
from ocpbench.modes import sweep

CALLS = []
numbers = sweep.numbers


class Program(sweep.Program):
    def run(self, args):
        CALLS.append(len(CALLS))
        return super().run(args)
'''


@pytest.fixture
def sweep_cell(bench_root):
    bench_root.add_cell("bryson.tiny", "bryson-denham", "tiny_boundary_speeds",
                        like="bryson.sweep512", batch=8, pool=2, trace_calls=1)
    return spec.resolve("bryson.tiny", bench_root.path)


@pytest.fixture
def hp_cell(bench_root):
    cfg = bench_root.read_json("configs/hypersensitive-tf5000.json")
    bench_root.add_config("hyper-small", "hypersensitive-tf5000", HYPER_SMALL, args={"tf": 20.0},
                          solve_options={**cfg["solve_options"], "max_grid_num": 4})
    bench_root.add_cell("hyper.tiny", "hyper-small", "tiny_hp", like="hyper.hp_ph",
                        mesh={"degrees": [16, 16], "fractions": None}, pool=2)
    return spec.resolve("hyper.tiny", bench_root.path)


def decide(cell, **kw):
    result, per_instance, values = run.run_cell(cell, SEED, 0.2, False, device="cpu", **kw)
    correct, checks = judge.decide(cell, values)
    return correct, checks, result


def test_sweep_run_is_correct_and_reports_its_metrics(sweep_cell):
    correct, checks, result = decide(sweep_cell)
    assert correct, checks
    assert result["failed"] == 0 and result["attempted"] % 8 == 0
    assert set(result["metrics"]) == {"solves_per_s", "setup_s"}
    assert result["metrics"]["solves_per_s"]["value"] > 0
    assert list(checks) == list(sweep_cell.limits)
    traced, _, values = run.run_cell(sweep_cell, SEED, 0.2, True, device="cpu")
    assert judge.decide(sweep_cell, values)[0]
    # no device on the CPU: the readers of device numbers find nothing to read
    assert {"ipm_iter_ms.sweep", "host_syncs_per_iter.sweep"} <= set(traced["metrics"])
    assert "lane_cholesky_roofline" not in traced["metrics"]
    assert traced["device"]["window_s"] > 0


def test_mode_and_reference_added_as_files_are_used(bench_root):
    with open(bench_root.file("reference/bryson-denham.py")) as f:
        source = f.read()
    bench_root.add_config("bryson-own", "bryson-denham", source + OWN_TRANSCRIPTION)
    with open(bench_root.file("modes/lockstep.py"), "w") as f:
        f.write(LOCKSTEP)
    bench_root.add_cell("bryson.own", "bryson-own", "tiny_lockstep", like="bryson.sweep512",
                        mode="lockstep", batch=8, pool=2)
    cell = spec.resolve("bryson.own", bench_root.path)
    correct, checks, _ = decide(cell)
    assert correct, checks
    assert cell.mode.CALLS and cell.reference.USED


def test_sweep_control_in_float32_is_not_correct(sweep_cell):
    correct, checks, _ = decide(sweep_cell, dtype=torch.float32)
    assert not correct, checks


def _solver_fault(kind, build):
    """A ``build_solver`` whose solver breaks the timed path as ``kind`` says."""
    def broken(*args, **kw):
        real = build(*args, **kw)

        def solve(z0, zl, zu, cl, cu, lam0=None, **more):
            B = z0.shape[0]
            if kind == "half_batch":
                h = max(B // 2, 1)
                res = real(z0[:h], zl[:h], zu[:h], cl[:h], cu[:h],
                           lam0=None if lam0 is None else lam0[:h], **more)
                take = torch.arange(B) % h
                return type(res)(*(None if f is None or isinstance(f, dict) else f[take]
                                   for f in res))
            res = real(z0, zl, zu, cl, cu, lam0=lam0, **more)
            lam = torch.zeros_like(res.lam) if lam0 is None else lam0
            return res._replace(z=z0.clone(), lam=lam,
                                status=torch.ones_like(res.status))

        solve.host_syncs = solve.outer_iterations = 0
        return solve

    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_sweep_faults_are_not_correct(sweep_cell, monkeypatch, fault):
    kw = {}
    if fault == "altered":
        def inspect(prog):
            real = prog.run

            def altered(args):
                res, ok = real(args)
                z = res.z.clone()
                z[3, 4] += 1e-3          # one state of one instance
                return res._replace(z=z), ok

            prog.run = altered
        kw["inspect"] = inspect
    else:
        monkeypatch.setattr(batch_mod, "build_solver",
                            _solver_fault(fault, batch_mod.build_solver))
    correct, checks, _ = decide(sweep_cell, **kw)
    assert not correct, checks


def test_hp_run_is_correct(hp_cell):
    correct, checks, result = decide(hp_cell)
    assert correct, checks
    assert set(result["metrics"]) == {"hp_solve_s", "setup_s"}
    assert set(checks) == {"unsolved", "primal", "dual", "objective", "mesh_error"}
    traced, _, _ = run.run_cell(hp_cell, SEED, 0.2, True, device="cpu")
    assert {"hp_outside_ipm_s", "hp_dense_ipm_s", "hp_block_ipm_s",
            "device_idle_pct.hp"} <= set(traced["metrics"])


def test_hp_control_in_float32_is_not_correct(hp_cell):
    correct, checks, _ = decide(hp_cell, dtype=torch.float32)
    assert not correct, checks


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_hp_faults_are_not_correct(hp_cell, monkeypatch, fault):
    kw = {}
    if fault == "altered":
        def inspect(prog):
            real = prog.run

            def altered(problem):
                sol, ok = real(problem)
                sol.z = np.array(sol.z)
                sol.z[len(sol.z) // 3] += 1e-3
                return sol, ok

            prog.run = altered
        kw["inspect"] = inspect
    else:
        monkeypatch.setattr(solve_mod, "build_solver",
                            _solver_fault(fault, solve_mod.build_solver))
    correct, checks, _ = decide(hp_cell, **kw)
    assert not correct, checks
