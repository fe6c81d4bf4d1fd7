#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It

1. ``device``       names the card (torch and ``nvidia-smi``);
2. ``build``        compiles ``lpopc_tpu_torch/csrc/*.cu`` with ``nvcc``;
3. ``kernels``      holds both hand-written kernels (batched Cholesky K1,
                    batched Cholesky-solve K2) against their plain PyTorch
                    versions on the card, in both variants (shared and
                    global memory), asserts which variant ran at each shape,
                    checks the NaN contracts and that K2's global variant
                    gives bitwise identical x on repeated calls, and times
                    kernel, plain version and the one-call library
                    equivalent with CUDA events, beside the launch floor of
                    the card and K2's time against the batch;
4. ``sweep_lane``   solves the 512-instance brachistochrone sweep through the
                    kernels (``lane_kkt=True``) and checks the objectives;
5. ``sweep_apply``  the same sweep on the library-matmul route
                    (``lane_kkt=False``), for comparison;
6. ``sweep_lane_large`` a 64-instance sweep at degrees (24, 24) (n = 197),
                    through both kernels' shared variants;
7. ``hp_solve``     the single-problem hp-adaptive solve of the hypersensitive
                    problem at tf = 5000 (the reference's own executable
                    configuration), once with ph and once with hp-Liu
                    refinement, every grid through both kernels
                    (``lane_kkt=True``, ``block_kkt="off"``); the grids grow
                    to n = 4099, so both kernels' global variants run. It
                    checks the grid count, the mesh history, the objective
                    and the mesh error against the JAX package's run;
8. ``hp_solve_block`` the ph solve again under the default ``block_kkt="auto"``:
                    grids 4-6 (n = 1027-4099) take the segment-block KKT
                    path (``core/block_kkt.py``, ``core/kkt_blocks.py``) and
                    launch neither kernel, grids 1-3 the kernels as before;
                    the JAX package's grids, meshes, iterations and objective,
                    and no (n, n) allocation in a block grid's IPM run;
9. ``sweep_block``  a 64-instance sweep at degrees (16,) * 11 (n = 709), which
                    "auto" puts on the block path, under both block
                    assemblies: no kernel launch, the JAX package's
                    objectives and per-instance iterations (where rounding
                    decides the count, within the JAX package's own spread);
10. ``block_factor`` times the block factorization at ph's grid 6 shapes and
                    at sweep_block's, against ``cholesky_ex`` +
                    ``cholesky_solve`` on the same blocks;
11. ``sweep_launch`` the JAX package's ``bench.py::bench_launch(batch=32)``:
                    32 payload instances of the 4-phase GTO ascent (n = 546),
                    through both kernels' global variants at B = 32;
12. ``sweep_boostbrake`` ``bench.py::bench_boostbrake(batch=256)``: 256
                    instances of the 2-phase boost-brake problem (n = 58),
                    through the shared variants; both sweeps hold every
                    instance's status, iterations and objective to the JAX
                    package's (within its own spread where rounding decides),
                    each with one warm-up and one timed run;
13. ``solve_multiphase`` single-problem solves on the kernel route: the
                    4-phase launch (mesh fixed), the boost-brake hp solve
                    (per-phase refinement) and the tabulated climb
                    (``Spline1D`` and ``Spline2D`` in the dynamics), each
                    against the JAX package's grids, meshes, iterations and
                    objective and against its golden;
14. ``solve_singular`` the automatic singular-arc solves on the kernel route:
                    ``goddard.solve_auto()`` (decompose), ``tumor.solve_auto()``
                    (continuation, four rungs) and ``tumor.solve_auto(method=
                    "decompose")``, each solve of each workflow against the
                    JAX package's arcs, phases, status, grids, per-grid
                    iterations and objective, and the goldens;
15. ``sensitivities`` the 512-instance sweep of ``sweep_lane`` through
                    ``DifferentiableSolver`` (``core/diff.py``): the gradient of
                    the summed objective in the bounds by the IFT adjoint,
                    against the dual envelope sensitivities at every instance
                    and central differences of the solver at 4;
16. ``sweep_two_stage`` the same sweep with ``two_stage=True`` (stage 1 in
                    float32, K1 and K2 in f32; stage 2 in f64): every
                    instance solved to ``sweep_lane``'s objectives;
17. ``mpc``         ``bench.py::bench_mpc`` as written there (B = 1), then 64
                    plants in one controller on the kernel route, 30 steps
                    each, per step against the JAX package's statuses,
                    iterations and u0; the value gradient against finite
                    differences;
18. ``utils``       the utilities: ``hp_solve``'s ph run writes its report
                    and checkpoints (``report_file``, ``checkpoint_dir``):
                    one checkpoint a grid, ``resume_problem`` back on the
                    last grid's mesh, the report naming the JAX package's
                    grid count, ``save_results``' file family read back;
                    ``check_problem`` on every model; a ``device_profile``
                    trace of one warm IPM iteration of the 512-instance
                    sweep, which must name both kernels among its CUDA
                    kernels;
19. ``scale_out``   the scale-out solvers at world size 1 on NCCL
                    (``parallel/distributed.py::initialize`` on a TCP
                    rendezvous at 127.0.0.1): the 512-instance sweep through
                    ``make_batch_solver(mesh=default_mesh())`` and
                    ``make_distributed_batch_solver(...).run_local`` and
                    with ``donate=True``, each bitwise equal to
                    ``sweep_lane``'s result;
                    ``make_segment_solver`` on the hp solve's last grid
                    (resumed from its checkpoint: n = 4099, 128 segments,
                    the block path) and ``make_hybrid_batch_solver`` on a
                    (1, 1) ``("dp", "seg")`` mesh at 4 perturbed instances of
                    it, each bitwise equal to the unsharded block solve;

and prints one JSON line per phase, then a ``{"kernels": [...]}`` summary, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device": ...}``.
Any failure raises: the exit code is then nonzero and no result line is
printed. Without a CUDA device it exits at once with an error.
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import pkgutil
import re
import socket
from dataclasses import replace
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available (torch.cuda.is_available() is False)")

from lpopc_tpu_torch import models as models_pkg
from lpopc_tpu_torch.core import solve as solve_mod
from lpopc_tpu_torch.core.check import check_problem
from lpopc_tpu_torch.core.block_kkt import factor_from_blocks, make_block_spec
from lpopc_tpu_torch.core.diff import DifferentiableSolver
from lpopc_tpu_torch.core.ipm import MAX_ITER, SOLVED, IPMOptions
from lpopc_tpu_torch.core.kkt_blocks import bind_structured_kkt, make_structured_kkt
from lpopc_tpu_torch.core.problem import Phase, Problem
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.core.structured import make_structured_jacobian
from lpopc_tpu_torch.core.transcribe import const_mesh, transcribe
from lpopc_tpu_torch.models import (boostbrake, brachistochrone, climb, goddard, hypersensitive,
                                    launch, tumor)
from lpopc_tpu_torch.ops import batched_linalg as bl
from lpopc_tpu_torch.parallel import distributed
from lpopc_tpu_torch.parallel.batch import default_mesh, make_batch_solver
from lpopc_tpu_torch.parallel.hybrid import hybrid_mesh, make_hybrid_batch_solver
from lpopc_tpu_torch.parallel.mpc import MPCController
from lpopc_tpu_torch.parallel.segment import make_segment_solver, segment_mesh
from lpopc_tpu_torch.utils import build, checkpoint
from lpopc_tpu_torch.utils.resultfiles import save_results
from lpopc_tpu_torch.utils.trace import device_profile

DEVICE = torch.device("cuda", 0)

# The sweep of the JAX package's bench.py: degrees (6, 6) (n = 53, m = 37),
# 512 instances, terminal target perturbed by 0.2 * U(-1, 1) * var_scale, seed 0.
DEGREES = (6, 6)
BATCH = 512
SEED = 0
# Objectives of the first 8 instances of that sweep, computed with the JAX
# package (lpopc_tpu, CPU, x64, lane_kkt=True in interpret mode; 13 iterations
# each). obj_scale is 1.0 for this model, so these are final times.
REFERENCE_OBJECTIVES = (
    0.8199081764046097, 0.7775134388029006, 0.8438688680288589, 0.8279257292394469,
    0.8293333348876281, 0.826610449430012, 0.8297690805844111, 0.8239430186642959,
)
# The same sweep at degrees (24, 24) (n = 197, m = 145), 64 instances: the
# first 4 objectives, from the JAX package (CPU, x64, lane_kkt=False; 15, 15,
# 13, 13 iterations). The first 4 perturbations are those of a batch of 4.
DEGREES_LARGE = (24, 24)
BATCH_LARGE = 64
REFERENCE_OBJECTIVES_LARGE = (
    0.8199081764044944, 0.7775134388029132, 0.8438688680217514, 0.8279257292302437,
)
# What the counted run of each lane sweep takes (the JAX package's iteration
# counts; one K1 launch per regularization round, five K2 launches per
# iteration; one host sync per loop condition).
EXPECT_LANE = {"iters_p50": 13, "first_iterations": [13] * 8,
               "launches": {"lane_cholesky": 13, "lane_cho_solve": 65}, "host_syncs": 40}
EXPECT_LANE_LARGE = {"iters_p50": 13, "first_iterations": [15, 15, 13, 13],
                     "launches": {"lane_cholesky": 48, "lane_cho_solve": 240}}
OBJECTIVE_TOL = 1e-7
ANALYTIC_TOL = 1e-7     # unperturbed target against the cycloid's final time

# hp_solve: hypersensitive.make_problem(tf=5000.0) under these options, with
# mesh_method "ph" and "hp-liu". The reference numbers come from the JAX
# package (lpopc_tpu, CPU, x64) under the same options with lane_kkt=False:
# grid count, objective, final mesh error, per-grid n, m and IPM iterations,
# and every grid's mesh as (degree, segments, fractions) — after the first
# mesh every degree is the bucket degree.
HP_OPTIONS = dict(tol=1e-8, max_grid_num=20, desired_relative_error=1e-6, n_max=16,
                  block_kkt="off")
HP_GOLDEN_J = 1.33080711      # Rao 2000, the reference's published optimum
HP_GOLDEN_RTOL = 2e-6
HP_OBJECTIVE_RTOL = 1e-8      # against the JAX package's objective
HP_FRACTION_TOL = 1e-12
HP_REFERENCE = {
    "ph": {
        "grids": 6, "objective": 1.3308069003439473,
        "max_relative_error": 2.715304718403644e-07,
        "n": [43, 67, 515, 1027, 2051, 4099],
        "m": [21, 33, 257, 513, 1025, 2049],
        "iterations": [8, 2, 8, 5, 3, 3],
        "mesh_history": [
            (20, 1, (
                -1.0, 1.0,)),
            (4, 8, (
                -1.0, -0.7142857142857143, -0.4285714285714286, -0.1428571428571429,
                0.1428571428571428, 0.2857142857142857, 0.4285714285714286, 0.7142857142857142,
                1.0,)),
            (16, 16, (
                -1.0, -0.9428571428571428, -0.8857142857142857, -0.8285714285714285,
                -0.7714285714285715, -0.7142857142857143, -0.5714285714285714,
                -0.4285714285714286, -0.28571428571428575, -0.1428571428571429,
                -5.551115123125783e-17, 0.1428571428571428, 0.2857142857142857,
                0.4285714285714286, 0.7142857142857142, 0.8571428571428571, 1.0,)),
            (16, 32, (
                -1.0, -0.9904761904761905, -0.9809523809523809, -0.9714285714285714,
                -0.9619047619047619, -0.9523809523809523, -0.9428571428571428,
                -0.9314285714285714, -0.9199999999999999, -0.9085714285714286,
                -0.8971428571428571, -0.8857142857142857, -0.8285714285714285,
                -0.7714285714285715, -0.7142857142857143, -0.6428571428571428,
                -0.5714285714285714, -0.4285714285714286, -0.28571428571428575,
                -0.1428571428571429, -5.551115123125783e-17, 0.1428571428571428,
                0.21428571428571425, 0.2857142857142857, 0.4285714285714286,
                0.5714285714285714, 0.7142857142857142, 0.8571428571428571, 0.8857142857142857,
                0.9142857142857143, 0.9428571428571428, 0.9714285714285714, 1.0,)),
            (16, 64, (
                -1.0, -0.9980952380952381, -0.9961904761904762, -0.9942857142857143,
                -0.9923809523809524, -0.9904761904761905, -0.9809523809523809,
                -0.9714285714285714, -0.9619047619047619, -0.9523809523809523,
                -0.9428571428571428, -0.9314285714285714, -0.9199999999999999,
                -0.9085714285714286, -0.8971428571428571, -0.8857142857142857,
                -0.8285714285714285, -0.7714285714285715, -0.7142857142857143,
                -0.6785714285714286, -0.6428571428571428, -0.6071428571428571,
                -0.5714285714285714, -0.5357142857142857, -0.5, -0.4285714285714286,
                -0.3571428571428572, -0.3214285714285715, -0.28571428571428575,
                -0.25000000000000006, -0.21428571428571433, -0.1785714285714286,
                -0.1428571428571429, -0.10714285714285719, -0.07142857142857148,
                -0.03571428571428577, -5.551115123125783e-17, 0.03571428571428566,
                0.07142857142857137, 0.10714285714285708, 0.1428571428571428,
                0.17857142857142852, 0.21428571428571425, 0.24999999999999997,
                0.2857142857142857, 0.3214285714285714, 0.35714285714285715,
                0.3928571428571429, 0.4285714285714286, 0.5, 0.5714285714285714,
                0.6428571428571428, 0.7142857142857142, 0.7857142857142856, 0.8214285714285714,
                0.8571428571428571, 0.8857142857142857, 0.9142857142857143, 0.9428571428571428,
                0.9714285714285714, 0.9771428571428571, 0.9828571428571429, 0.9885714285714285,
                0.9942857142857143, 1.0,)),
            (16, 128, (
                -1.0, -0.9996190476190476, -0.9992380952380953, -0.9988571428571429,
                -0.9984761904761905, -0.9980952380952381, -0.9961904761904762,
                -0.9942857142857143, -0.9923809523809524, -0.9904761904761905,
                -0.9809523809523809, -0.9714285714285714, -0.9619047619047619,
                -0.9523809523809523, -0.9428571428571428, -0.9314285714285714,
                -0.9199999999999999, -0.9085714285714286, -0.8971428571428571,
                -0.8857142857142857, -0.8714285714285714, -0.8571428571428571,
                -0.8428571428571427, -0.8285714285714285, -0.8, -0.7714285714285715,
                -0.7428571428571429, -0.7142857142857143, -0.6964285714285714,
                -0.6785714285714286, -0.6607142857142857, -0.6428571428571428, -0.625,
                -0.6071428571428571, -0.5892857142857142, -0.5714285714285714,
                -0.5535714285714286, -0.5357142857142857, -0.5178571428571428, -0.5,
                -0.48214285714285715, -0.4642857142857143, -0.44642857142857145,
                -0.4285714285714286, -0.41071428571428575, -0.3928571428571429,
                -0.37500000000000006, -0.3571428571428572, -0.33928571428571436,
                -0.3214285714285715, -0.3035714285714286, -0.28571428571428575,
                -0.2678571428571429, -0.25000000000000006, -0.2321428571428572,
                -0.21428571428571433, -0.19642857142857145, -0.1785714285714286,
                -0.16071428571428575, -0.1428571428571429, -0.12500000000000006,
                -0.10714285714285719, -0.08928571428571433, -0.07142857142857148,
                -0.053571428571428624, -0.03571428571428577, -0.01785714285714291,
                -5.551115123125783e-17, 0.0178571428571428, 0.03571428571428566,
                0.05357142857142851, 0.07142857142857137, 0.08928571428571422,
                0.10714285714285708, 0.12499999999999994, 0.1428571428571428,
                0.16071428571428564, 0.17857142857142852, 0.1964285714285714,
                0.21428571428571425, 0.2321428571428571, 0.24999999999999997,
                0.26785714285714285, 0.2857142857142857, 0.30357142857142855,
                0.3214285714285714, 0.3392857142857143, 0.35714285714285715, 0.375,
                0.3928571428571429, 0.41071428571428575, 0.4285714285714286,
                0.44642857142857145, 0.4642857142857143, 0.48214285714285715, 0.5,
                0.5178571428571428, 0.5357142857142857, 0.5535714285714286, 0.5714285714285714,
                0.5892857142857142, 0.6071428571428571, 0.625, 0.6428571428571428,
                0.6607142857142856, 0.6785714285714285, 0.6964285714285714, 0.7142857142857142,
                0.732142857142857, 0.7499999999999999, 0.7678571428571428, 0.7857142857142856,
                0.8035714285714285, 0.8214285714285714, 0.8392857142857142, 0.8571428571428571,
                0.8857142857142857, 0.9142857142857143, 0.9428571428571428, 0.9714285714285714,
                0.9771428571428571, 0.9828571428571429, 0.9885714285714285, 0.9942857142857143,
                0.9954285714285714, 0.9965714285714286, 0.9977142857142858, 0.9988571428571429,
                1.0,)),
        ],
    },
    "hp-liu": {
        "grids": 9, "objective": 1.330806904843104,
        "max_relative_error": 3.4850518177975686e-07,
        "n": [43, 131, 515, 515, 515, 515, 515, 515, 515],
        "m": [21, 65, 257, 257, 257, 257, 257, 257, 257],
        "iterations": [8, 5, 8, 7, 4, 4, 3, 2, 2],
        "mesh_history": [
            (20, 1, (
                -1.0, 1.0,)),
            (16, 4, (
                -1.0, -0.33333333333333337, 0.33333333333333326, 0.6666666666666666, 1.0,)),
            (16, 16, (
                -1.0, -0.8888888888888888, -0.7777777777777778, -0.6666666666666667,
                -0.5555555555555556, -0.44444444444444453, -0.33333333333333337,
                -0.1666666666666667, -5.551115123125783e-17, 0.1666666666666666,
                0.33333333333333326, 0.41666666666666663, 0.49999999999999994,
                0.6666666666666666, 0.8333333333333333, 0.9166666666666666, 1.0,)),
            (16, 16, (
                -1.0, -0.9629629629629629, -0.9259259259259259, -0.8888888888888888,
                -0.8333333333333333, -0.7777777777777778, -0.5555555555555556,
                -0.33333333333333337, -0.1666666666666667, -5.551115123125783e-17,
                0.33333333333333326, 0.49999999999999994, 0.8333333333333333,
                0.9166666666666666, 0.9444444444444444, 0.9722222222222222, 1.0,)),
            (16, 16, (
                -1.0, -0.9876543209876543, -0.9753086419753086, -0.9629629629629629,
                -0.9259259259259259, -0.8333333333333333, -0.5555555555555556,
                -0.36111111111111116, -0.1666666666666667, 0.08333333333333327,
                0.33333333333333326, 0.5833333333333333, 0.8333333333333333,
                0.9444444444444444, 0.9722222222222222, 0.9861111111111112, 1.0,)),
            (16, 16, (
                -1.0, -0.9958847736625515, -0.9917695473251028, -0.9876543209876543,
                -0.9753086419753086, -0.9259259259259259, -0.5555555555555556,
                -0.36111111111111116, -0.1666666666666667, 0.08333333333333327,
                0.33333333333333326, 0.5833333333333333, 0.8333333333333333,
                0.9722222222222222, 0.9861111111111112, 0.9930555555555556, 1.0,)),
            (16, 16, (
                -1.0, -0.9979423868312758, -0.9958847736625515, -0.9917695473251028,
                -0.9876543209876543, -0.9259259259259259, -0.6435185185185186,
                -0.36111111111111116, -0.13888888888888895, 0.08333333333333327,
                0.33333333333333326, 0.5833333333333333, 0.9722222222222222,
                0.9861111111111112, 0.9930555555555556, 0.9965277777777778, 1.0,)),
            (16, 16, (
                -1.0, -0.9989711934156379, -0.9979423868312758, -0.9958847736625515,
                -0.9917695473251028, -0.9259259259259259, -0.6435185185185186,
                -0.36111111111111116, -0.13888888888888895, 0.08333333333333327,
                0.33333333333333326, 0.5833333333333333, 0.9861111111111112,
                0.9930555555555556, 0.9965277777777778, 0.9982638888888888, 1.0,)),
            (16, 16, (
                -1.0, -0.9994855967078189, -0.9989711934156379, -0.9979423868312758,
                -0.9958847736625515, -0.9259259259259259, -0.6435185185185186,
                -0.36111111111111116, -0.13888888888888895, 0.08333333333333327,
                0.33333333333333326, 0.5833333333333333, 0.9930555555555556,
                0.9965277777777778, 0.9982638888888888, 0.9991319444444444, 1.0,)),
        ],
    },
}

# hp_solve_block: the ph solve of hp_solve under the default block_kkt="auto"
# (HP_OPTIONS without block_kkt). The JAX package (lpopc_tpu, CPU, x64,
# lane_kkt=False; scripts/jax_block_pins.py hp_auto) takes the same 6 grids,
# meshes, (n, m) and iterations under "auto" as under "off"; its objective
# and mesh error under "auto":
HP_BLOCK_OPTIONS = {k: v for k, v in HP_OPTIONS.items() if k != "block_kkt"}
HP_BLOCK_REFERENCE = dict(HP_REFERENCE["ph"], objective=1.330806900343947,
                          max_relative_error=2.7153047215122684e-07)
BLOCK_THRESHOLD = SolveOptions().block_kkt_threshold

# sweep_block: the sweep at degrees (16,) * 11 (N = 176, n = 709, m = 529:
# "auto" takes the block path), 64 instances perturbed as above, seed 0. The
# JAX package's per-instance iterations (CPU, x64, lane_kkt=False, which the
# block path overrides; scripts/jax_block_pins.py sweep_direct, sweep_dense)
# under block_assembly "direct" (the default, which this phase runs) and
# "dense", and its objectives ("direct").
DEGREES_BLOCK = (16,) * 11
BATCH_BLOCK = 64
REFERENCE_ITERATIONS_BLOCK = (
    11, 12, 23, 12, 13, 12, 12, 12, 11, 13, 11, 13, 11, 14, 13, 11,
    13, 11, 13, 11, 11, 11, 13, 13, 12, 11, 12, 12, 13, 12, 11, 13,
    13, 12, 12, 13, 13, 13, 13, 11, 11, 15, 13, 13, 12, 18, 13, 15,
    13, 12, 11, 16, 12, 13, 12, 12, 12, 11, 12, 12, 13, 11, 11, 11,
)
REFERENCE_ITERATIONS_BLOCK_DENSE = (
    11, 12, 20, 12, 13, 12, 12, 12, 11, 13, 11, 13, 11, 14, 13, 11,
    13, 11, 13, 11, 11, 11, 13, 13, 12, 11, 12, 12, 13, 12, 11, 13,
    13, 12, 12, 13, 13, 13, 13, 11, 11, 15, 13, 13, 12, 16, 13, 15,
    13, 12, 11, 16, 12, 13, 12, 12, 12, 11, 12, 12, 13, 11, 11, 11,
)
REFERENCE_OBJECTIVES_BLOCK = (
    0.819908175668475, 0.7775134386471361, 0.8438688678780694, 0.8279257284933823,
    0.8293333345508759, 0.8266104492286958, 0.8297690804018144, 0.8239430185246179,
    0.8389531358331863, 0.8028392211251169, 0.7793183052049958, 0.8297659514302349,
    0.8208656977440398, 0.8557521188234657, 0.8307078479486517, 0.8254060440685754,
    0.8011120397984065, 0.8138703927429869, 0.8249890500860833, 0.8398792339924165,
    0.8169291355899836, 0.8186464741408419, 0.8198047526513598, 0.8036487448620543,
    0.8014299780200679, 0.8286737591592116, 0.8313786834953646, 0.7988516308176647,
    0.820667525390413, 0.7901608205370304, 0.80411117824394, 0.7947762451182989,
    0.8089677391347289, 0.8107624289295539, 0.799712097926027, 0.8338800402572847,
    0.8241556560916962, 0.8147972832603447, 0.8350491734564235, 0.8426033183053429,
    0.8317607851918808, 0.8248570425696021, 0.8171121129724165, 0.8385745896561068,
    0.8002034662210474, 0.8515346288134235, 0.7985967602297571, 0.8543406463682558,
    0.8089165247667417, 0.8462561606930881, 0.8094718402668998, 0.8434703041153849,
    0.8037283878528103, 0.8236740584112445, 0.7961877012573202, 0.8140295050757328,
    0.8205653230131568, 0.8320834956847691, 0.8348851666397474, 0.829238410393176,
    0.8056567122165145, 0.8455177159531911, 0.7961422663831411, 0.8347765234771718,
)
# Where rounding decides the count (ROADMAP Queue 3, entry 3): the instances
# whose count the JAX package itself changes when their starting point is
# scaled by 1 + 1e-15·U(-1, 1) (scripts/jax_block_pins.py sweep_jitter: each
# instance 8 times in one batch, copy 0 as it is), with the least and the
# most iterations it takes there and in the runs above. Every other instance
# must take the JAX package's count exactly.
ROUNDING_SPREAD_BLOCK = {
    "direct": {2: (17, 23), 41: (15, 19), 45: (16, 27), 51: (15, 17)},
    "dense": {2: (20, 31), 41: (15, 19), 45: (16, 25), 51: (15, 17)},
}

# sweep_launch: bench.py::bench_launch(batch=32) as written there —
# launch.make_problem() at its default mesh (degrees (5, 5, 5, 7), segments
# (2, 2, 2, 3): n = 546, m = 441), IPMOptions(tol=1e-8, max_iter=60), phase
# 1's pinned initial mass shifted by 0.01·U(-1, 1)·var_scale, seed 0. The
# JAX package's per-instance results (scripts/jax_multiphase_pins.py
# launch_sweep; CPU, x64, lane_kkt=False): status (1 solved, 2 iteration
# limit, 3 failed), iterations, objective.
BATCH_LAUNCH = 32
LAUNCH_SWEEP_REFERENCE = {
    "n": 546, "m": 441,
    "status": [
        1, 1, 1, 1, 2, 2, 1, 3, 1, 2, 2, 1, 2, 1, 3, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 1, 2, 2,
        2, 1, 2, 1,
    ],
    "iterations": [
        13, 11, 15, 14, 60, 60, 11, 49, 23, 60, 60, 14, 60, 19, 50, 15, 60, 17, 10, 12, 18,
        20, 60, 13, 17, 11, 60, 60, 60, 11, 60, 12,
    ],
    "objective": [
        -0.02532618999281206, -0.024244604020024898, -0.023341386326812544,
        -0.023235065341629044, -0.025607305914452615, -0.025646147013516873,
        -0.025254929933664114, -0.02551249720119725, -0.0250962037140438,
        -0.025645995189136815, -0.025609234343004078, -0.02317427749590362,
        -0.025633133725069056, -0.023309449912124195, -0.025512742234251796,
        -0.023893446744477086, -0.02563544798869648, -0.025090499629182958,
        -0.024350117581863708, -0.024751998577879936, -0.023286583108568206,
        -0.02368967114489746, -0.025401604966783578, -0.02534946411233322,
        -0.02527583365308734, -0.02463009868958195, -0.10538468043448417,
        -0.025637060537679137, -0.025433701024952557, -0.025356823629555054,
        -0.025439619382171846, -0.02464678931255311,
    ],
}

# sweep_boostbrake: bench.py::bench_boostbrake(batch=256) as written there —
# boostbrake.make_problem(degrees=(8,)) (n = 58, m = 38), IPMOptions(tol=1e-8,
# max_iter=80), phase 2's pinned terminal distance lowered by 0.1·U(0, 1)·zl,
# seed 0 (scripts/jax_multiphase_pins.py boostbrake_sweep).
BATCH_BOOSTBRAKE = 256
BOOSTBRAKE_SWEEP_REFERENCE = {
    "n": 58, "m": 38,
    "status": [
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
        1, 1, 1, 1,
    ],
    "iterations": [
        21, 14, 19, 18, 19, 19, 22, 35, 22, 24, 38, 19, 22, 18, 24, 14, 20, 19, 16, 27, 18,
        17, 20, 15, 16, 22, 18, 18, 14, 20, 20, 24, 17, 20, 23, 17, 25, 20, 23, 18, 22, 25,
        19, 20, 36, 21, 14, 35, 14, 21, 16, 14, 26, 17, 19, 18, 27, 20, 14, 19, 16, 14, 15,
        19, 15, 28, 14, 24, 25, 17, 18, 42, 23, 19, 16, 19, 30, 25, 19, 27, 23, 22, 20, 25,
        26, 17, 17, 24, 17, 21, 23, 17, 23, 25, 21, 17, 18, 17, 28, 17, 35, 14, 24, 20, 17,
        22, 17, 24, 19, 14, 25, 18, 32, 18, 25, 15, 32, 26, 32, 18, 20, 29, 17, 18, 14, 14,
        26, 14, 17, 27, 19, 24, 26, 23, 27, 20, 29, 17, 21, 25, 20, 17, 19, 18, 16, 18, 20,
        17, 20, 17, 20, 25, 14, 15, 22, 27, 26, 22, 20, 17, 28, 16, 27, 19, 27, 17, 14, 20,
        23, 23, 20, 21, 16, 16, 19, 21, 17, 17, 25, 18, 33, 14, 15, 19, 23, 15, 25, 18, 17,
        21, 14, 23, 23, 15, 18, 23, 20, 24, 28, 26, 16, 14, 16, 14, 17, 19, 20, 26, 29, 39,
        14, 22, 28, 18, 14, 24, 22, 27, 25, 20, 26, 22, 22, 25, 29, 21, 20, 15, 18, 17, 17,
        29, 18, 18, 16, 17, 14, 18, 26, 19, 21, 17, 24, 25, 25, 25, 20, 37, 14, 16, 21, 36,
        18, 23, 27, 26,
    ],
    "objective": [
        4.352053163795501, 4.419768661974976, 4.461607829807911, 4.477033338728878,
        4.318964548792372, 4.300549775917438, 4.358131120578318, 4.334734353315309,
        4.369417130175938, 4.295879597505543, 4.318476873357429, 4.479513529365756,
        4.310621496561403, 4.46293542960316, 4.335129994314372, 4.437300399163084,
        4.309954260144014, 4.3698184330822, 4.414731394163489, 4.391761927067745,
        4.463881338230662, 4.446595758906949, 4.345764927044329, 4.3501440477240365,
        4.356501308506633, 4.398932926275883, 4.284030182569034, 4.287584411753146,
        4.342973903822067, 4.349533449149445, 4.342430120501688, 4.397969993182692,
        4.4446416422344095, 4.3362373059725146, 4.372803942294067, 4.41238461857191,
        4.380115995103794, 4.304541091861317, 4.296075400601446, 4.4036810522855445,
        4.364236772264346, 4.410258859693674, 4.360427438812519, 4.407323524710517,
        4.397474512431172, 4.304391870008007, 4.427951967843357, 4.35504718029776,
        4.453861412195313, 4.315305128629294, 4.323900573344455, 4.425730944730138,
        4.307007070220203, 4.458443727239502, 4.407651967631409, 4.441895654518667,
        4.387091884381906, 4.32258736791335, 4.4273183770325035, 4.459621452598823,
        4.395097885619479, 4.4331550863279645, 4.452646956836916, 4.363025335116943,
        4.414493906445123, 4.345508631068975, 4.432973161933975, 4.294966077796164,
        4.402339902869285, 4.449987958078451, 4.353518239103575, 4.297812513221349,
        4.388928040751109, 4.292162895796235, 4.377516554899717, 4.391294136292785,
        4.355601499342556, 4.2844340209752945, 4.293238683820604, 4.384877937135651,
        4.329429525592564, 4.377973943814747, 4.372070618757293, 4.324147907136933,
        4.393663426165558, 4.333798010581745, 4.338177738934412, 4.2964528603248535,
        4.448284518932786, 4.334824730522529, 4.297334726190781, 4.289620662471998,
        4.466325291432158, 4.309440714577773, 4.2875157512779785, 4.291663675443044,
        4.442169854711628, 4.289150436847362, 4.304456149485225, 4.3172456114997955,
        4.381620416823785, 4.427003639331161, 4.321113685888602, 4.298075230824475,
        4.420857937037719, 4.37028699669016, 4.388066441408914, 4.296651175539183,
        4.4616910138507535, 4.3342631914699945, 4.3562650214003416, 4.463873131575773,
        4.3370883297011895, 4.477129768351897, 4.329387743480653, 4.375136466766775,
        4.297015113796476, 4.4570913329292186, 4.3136653921127, 4.456981972412669,
        4.406151856503371, 4.3903606670659325, 4.289976161524179, 4.366388443416463,
        4.422181781688476, 4.4253113040277885, 4.304800904488123, 4.428186154003144,
        4.446546723320557, 4.416386241449073, 4.361523924952266, 4.367475362375567,
        4.319636363865636, 4.366289966599148, 4.416369732600805, 4.3935634098431695,
        4.318048763643675, 4.354003419176015, 4.29130774852572, 4.401552295542929,
        4.368174324173568, 4.3604973711900294, 4.312346221777118, 4.442765131964256,
        4.394737808516079, 4.3010811098858195, 4.46123154788375, 4.317182818288242,
        4.393105789616079, 4.315841883496233, 4.478215866135879, 4.402351641410345,
        4.454831742347902, 4.349130895750505, 4.419028020246928, 4.339769325908528,
        4.294217991242593, 4.445716003997379, 4.309651350164508, 4.458282483553845,
        4.399466611080653, 4.390457279664683, 4.379558940804916, 4.288419009999315,
        4.326475015290752, 4.412637634128224, 4.419759534189116, 4.30996538033684,
        4.306519010276703, 4.375516329938201, 4.406154465930832, 4.284468252421135,
        4.411342423655868, 4.436021243478715, 4.306748250036173, 4.319566932587485,
        4.346276343433141, 4.291434309659706, 4.297659828993374, 4.331211971092819,
        4.30999722766021, 4.424315575344006, 4.443529654228039, 4.345870128275288,
        4.33752597800443, 4.438859027887939, 4.396750994115674, 4.301024724361471,
        4.366118275052835, 4.362971854309449, 4.433950469114289, 4.3726801994640025,
        4.373159545024753, 4.452974590104861, 4.286946185911576, 4.3642617134840185,
        4.467813904788263, 4.3266220270159845, 4.287648031222951, 4.360826961078818,
        4.410658938158401, 4.435151690435259, 4.345409179478642, 4.433773089120704,
        4.363092314141388, 4.358525012003939, 4.290670014333583, 4.455978140456532,
        4.3775023108050926, 4.331992076069916, 4.437015655443294, 4.398126962304593,
        4.4576649796985155, 4.335413031649814, 4.453185082522631, 4.396836534594626,
        4.307568404208863, 4.382616095318165, 4.300148696029023, 4.327889114602286,
        4.299635228404857, 4.445610134864138, 4.455744465156428, 4.456327300813619,
        4.308453003417421, 4.352592697768551, 4.378131315419799, 4.43949464126718,
        4.345183463770966, 4.410963259729849, 4.338227053900387, 4.385244651135014,
        4.376115440205861, 4.323416734626147, 4.452287726399575, 4.362893297891659,
        4.433387030454296, 4.319933398232195, 4.379559589681545, 4.2856568194553475,
        4.435979371585668, 4.290556376556645, 4.321721287774123, 4.381385337022895,
        4.3193406805713614, 4.3584114904494164, 4.3486626785699825, 4.299945596596007,
        4.457237502595257, 4.314862056064756, 4.399274911378525, 4.409586444352151,
        4.285065317714533, 4.325013606764258, 4.380595560114498, 4.3921964737126515,
    ],
}

# Where rounding decides the count (ROADMAP Queue 3): the instances whose
# status or count the JAX package itself changes when their starting point
# is scaled by 1 + 1e-15·U(-1, 1) (scripts/jax_multiphase_pins.py
# launch_jitter: each instance 8 times in one batch, copy 0 as it is;
# boostbrake_jitter: 32 times, and boostbrake_jitter_focus: each instance
# whose count moves there 256 times), with the least and the most
# iterations it takes there and in the sweep above, the statuses it ends
# in, and the least and the most objective of its solved copies (None if
# none solved). Every other instance must take the JAX package's status and
# count exactly; objectives are held where both packages solved.
ROUNDING_SPREAD_MULTIPHASE = {
    "sweep_launch": {
        8: (23, 24, (1,), (-0.02509620371406947, -0.025096203713793903)),
        13: (18, 19, (1,), (-0.023309449913313136, -0.023309449912124195)),
        14: (47, 56, (3,), None),
    },
    "sweep_boostbrake": {
        4: (18, 21, (1,), (4.318964548724405, 4.318964563238453)),
        7: (34, 45, (1,), (4.3347343522269774, 4.334734353315683)),
        10: (31, 44, (1,), (4.318476872655734, 4.318476878071719)),
        71: (37, 72, (1,), (4.297385961315723, 4.297812527983784)),
        72: (22, 23, (1,), (4.388928040751106, 4.38892805501115)),
        89: (20, 37, (1,), (4.334824730129038, 4.334824733984487)),
        90: (22, 24, (1,), (4.297334726190777, 4.297334730696626)),
        112: (24, 39, (1,), (4.336662918644391, 4.337088343156954)),
        178: (23, 42, (1,), (4.297659828612901, 4.297659839372773)),
        180: (31, 53, (1,), (4.309997214374465, 4.310423420492781)),
        188: (17, 18, (1,), (4.366118243337115, 4.3661182754850865)),
        223: (24, 25, (1,), (4.456327300813617, 4.456327319118359)),
        231: (28, 36, (1,), (4.38482070937679, 4.385244663576282)),
        242: (24, 27, (1,), (4.321721287445954, 4.321721301898434)),
        245: (21, 38, (1,), (4.358411490022792, 4.358836246900434)),
    },
}
MULTIPHASE_OBJECTIVE_RTOL = 1e-7

# solve_multiphase: the JAX package's single-problem solves (CPU, x64,
# lane_kkt=False; scripts/jax_multiphase_pins.py launch_solve,
# boostbrake_hp, climb_tab): grids, per grid (n, m, iterations), each grid's
# per-phase mesh (degrees, fractions) and the objective. The launch's one
# grid is bucketed to degree 8 (n = 836), past BLOCK_THRESHOLD.
BB_FRACTIONS = (-1.0, -0.8, -0.6, -0.39999999999999997, -0.19999999999999996,
                0.19999999999999996, 0.4, 0.6000000000000001, 1.0)
MULTIPHASE_SOLVE_REFERENCE = {
    "launch": {
        "grids": 1, "objective": -0.02497798103570176, "per_grid": [(836, 673, 13)],
        "mesh_history": [[
            [[8, 8], [-1.0, 0.0, 1.0]], [[8, 8], [-1.0, 0.0, 1.0]], [[8, 8], [-1.0, 0.0, 1.0]],
            [[8, 8, 8, 8], [-1.0, -0.33333333333333337, 0.33333333333333326,
                            0.6666666666666666, 1.0]]]]},
    "boostbrake": {
        "grids": 5, "objective": 4.46860665426804,
        "per_grid": [(58, 38, 18), (82, 54, 21), (130, 86, 5), (226, 150, 8), (418, 278, 9)],
        "mesh_history": [
            [[[8], [-1.0, 1.0]], [[8], [-1.0, 1.0]]],
            [[[16], [-1.0, 1.0]], [[8], [-1.0, 1.0]]],
            [[[4] * 8, BB_FRACTIONS], [[8], [-1.0, 1.0]]],
            [[[8] * 8, BB_FRACTIONS], [[8], [-1.0, 1.0]]],
            [[[16] * 8, BB_FRACTIONS], [[8], [-1.0, 1.0]]],
        ]},
    "climb": {
        "grids": 1, "objective": 67.7503385191713, "per_grid": [(133, 97, 13)],
        "mesh_history": [[[[8, 8, 8, 8], [-1.0, -0.5, 0.0, 0.5, 1.0]]]]},
}
MULTIPHASE_SOLVE_RTOL = 1e-8
LAUNCH_GOLDEN_KG = 7529.71                       # tests/test_examples.py
BB_GOLDEN_J, BB_GOLDEN_Q = 4.4686059, 2.6933582834  # tests/test_boostbrake.py's oracle
CLIMB_GOLDEN = 67.7506                           # tests/test_climb.py

# The JAX package's results the last four phases hold (CPU, x64; printed by
# scripts/jax_singular_pins.py, which names each case's inputs): the
# automatic singular-arc solves (goddard_auto, tumor_auto,
# tumor_auto_decompose: arcs, each solve's phases, status, grids, per-grid
# (n, m, iterations) and objective), the MPC runs (mpc_bench: bench.py's
# controller at B = 1; mpc_batch: 64 plants; mpc_round3: the value gradient
# and its finite difference) and the two-stage batch of 16 (two_stage_b16).
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                       "jax_singular_pins.json"), encoding="utf-8") as _pins:
    SINGULAR_PINS = json.load(_pins)
SINGULAR_SOLVES = {
    # pin case -> (model, keyword arguments beside device and the options)
    "goddard_auto": (goddard, {}),
    "tumor_auto": (tumor, {}),
    "tumor_auto_decompose": (tumor, dict(method="decompose")),
}
SINGULAR_RTOL = 1e-8
TWO_STAGE_STAGE1_MAX_ITER = 40                  # make_batch_solver's stage1_max_iter
# Where rounding decides a solve's count (ROADMAP Queue 3 entry 6): per
# case, the solve's index in the workflow -> the least and the most count the
# JAX package takes when that solve's start is scaled by 1 + 1e-15·U(-1, 1)
# (and in the pinned run), and the statuses it ends in. Both tumor workflows
# start with the same rung (scripts/jax_singular_pins.py tumor_rung0_jitter:
# 72-74 iterations, objectives 1.4e-8 apart). Every other solve must take
# JAX's count exactly.
_RUNG0 = SINGULAR_PINS["tumor_rung0_jitter"]
_RUNG0_SPREAD = (min(_RUNG0["iterations"]), max(_RUNG0["iterations"]), set(_RUNG0["status"]))
ROUNDING_SPREAD_SINGULAR = {"tumor_auto": {0: _RUNG0_SPREAD},
                            "tumor_auto_decompose": {0: _RUNG0_SPREAD}}
GODDARD_GOLDEN_TOL = 1e-4                       # tests/test_goddard.py
TUMOR_GOLDEN = {"tumor_auto": (1954.4, 2.0), "tumor_auto_decompose": (1951.8, 3.0)}
# sensitivities: tests/test_diff.py's tolerances
ENVELOPE_RTOL, ENVELOPE_ATOL = 1e-5, 1e-7
FD_EPS, FD_RTOL, FD_ATOL, FD_INSTANCES = 1e-6, 2e-4, 1e-8, 4
# mpc: bench.py::bench_mpc's plant and loop; the batched controller's plants
MPC_STEPS, MPC_DT, MPC_BATCH = 30, 0.02, 64
MPC_U0_TOL = 1e-8
MPC_FD_H, MPC_FD_RTOL = 1e-5, 5e-3              # tests/test_round3.py

# Peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM; 67 TFLOP/s in
# float64 on the tensor cores (K1's trailing update runs there; outside them
# float64 has half that) and 67 TFLOP/s in float32 outside them (TF32 is
# not float32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}

# event_ms: cycles per ms of a GPU sleep (at least the H100's boost clock,
# so a sleep lasts at least as long as asked), and the longest sleep
SLEEP_CYCLES_PER_MS = 2.0e6
MAX_SLEEP_MS = 50.0

F64, F32 = torch.float64, torch.float32
# (B, n, dtype) -> the variants of (K1, K2) that must run there. K1 is
# shared up to n = 239 (f64) / 339 (f32), K2 up to 240 / 256; K1 works in
# panels of 32 columns, so the small-batch shapes put a panel edge at each
# side of n = 1, 32, 64 and of each split.
KERNEL_SHAPES = {
    (512, 53, F64): ("shared", "shared"),
    (130, 16, F64): ("shared", "shared"),
    (64, 24, F32): ("shared", "shared"),
    (64, 197, F64): ("shared", "shared"),
    (64, 197, F32): ("shared", "shared"),
    (8, 700, F64): ("global", "global"),
    (16, 360, F32): ("global", "global"),
    (512, 300, F64): ("global", "global"),    # K1's panel-step grid spans several waves
    (3, 1, F64): ("shared", "shared"),
    (3, 31, F64): ("shared", "shared"),
    (3, 32, F64): ("shared", "shared"),
    (3, 33, F64): ("shared", "shared"),
    (3, 64, F64): ("shared", "shared"),
    (3, 65, F64): ("shared", "shared"),
    (3, 239, F64): ("shared", "shared"),
    (3, 240, F64): ("global", "shared"),
    (3, 241, F64): ("global", "global"),
    (3, 256, F64): ("global", "global"),
    (3, 339, F32): ("shared", "global"),
    (3, 340, F32): ("global", "global"),
    (1, 241, F64): ("global", "global"),      # one system: panel edges past the split
    (1, 300, F64): ("global", "global"),
    (1, 513, F64): ("global", "global"),
}
# every (1, n) the hp solve launches, with the variant its n selects
HP_N = sorted(set(HP_REFERENCE["ph"]["n"]) | set(HP_REFERENCE["hp-liu"]["n"]))
# every (1, n) the multi-phase solves launch (grids below the block path's
# threshold), and the multi-phase sweeps' shapes
SOLVE_N = sorted({g[0] for ref in MULTIPHASE_SOLVE_REFERENCE.values() for g in ref["per_grid"]
                  if g[0] < BLOCK_THRESHOLD})
KERNEL_SHAPES.update({(1, n, F64): (bl.variant("lane_cholesky", n, 8),
                                    bl.variant("lane_cho_solve", n, 8))
                      for n in sorted(set(HP_N) | set(SOLVE_N))})
KERNEL_SHAPES.update({(BATCH_LAUNCH, LAUNCH_SWEEP_REFERENCE["n"], F64): ("global", "global"),
                      (BATCH_BOOSTBRAKE, BOOSTBRAKE_SWEEP_REFERENCE["n"], F64):
                          ("shared", "shared")})
# the singular-arc solves' every (1, n), the two-stage sweep's f32 stage and
# the batched controller's (n = 28)
SINGULAR_N = sorted({g[0] for case in SINGULAR_SOLVES for sv in SINGULAR_PINS[case]["solves"]
                     for g in sv["per_grid"]})
MPC_N = 28
KERNEL_SHAPES.update({(1, n, F64): (bl.variant("lane_cholesky", n, 8),
                                    bl.variant("lane_cho_solve", n, 8)) for n in SINGULAR_N})
KERNEL_SHAPES.update({(512, 53, F32): ("shared", "shared"),
                      (MPC_BATCH, MPC_N, F64): ("shared", "shared")})
MAIN_SHAPE = (512, 53, F64)                   # the sweep's
TIMED_SHAPES = (MAIN_SHAPE, (64, 197, F64), (8, 700, F64), (1, 515, F64), (1, 2051, F64),
                (1, 4099, F64), (512, 300, F64), (BATCH_LAUNCH, 546, F64),
                (BATCH_BOOSTBRAKE, 58, F64), (512, 53, F32), (MPC_BATCH, MPC_N, F64),
                *((1, n, F64) for n in SINGULAR_N))
REL_TOL = {F64: 1e-10, F32: 5e-3}
# K2's global variant sums each tile's terms in a fixed order, whatever the
# order in which other blocks publish: REPEATS calls at each of these shapes
# must give bitwise identical x (one system over the card; several waves of
# blocks; f32).
REPEAT_SHAPES = ((1, 4099, F64), (512, 300, F64), (16, 360, F32))
REPEATS = 50


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_summary(log: str):
    """One line per kernel of ``nvcc -Xptxas -v``'s output: its short name
    and template arguments, registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d((?:lane|cholesky)_\w+?)I([df])(?:Li(\d+)E)?", m.group(1))
            name = (f"{k.group(1)}<{'f64' if k.group(2) == 'd' else 'f32'}"
                    f"{',' + k.group(3) if k.group(3) else ''}>") if k else m.group(1)
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def event_ms(fn, warmup: int = 5, reps: int = 30, batches: int = 3) -> float:
    """Device time of one ``fn()`` in milliseconds: CUDA events around
    ``reps`` calls divided by ``reps``, the median of ``batches`` batches,
    after warm-up. A GPU sleep queued first keeps the device busy while the
    host enqueues the batch, so the calls run back to back and the host's
    own time per call (Python, ctypes, allocation) is not counted, unless
    the batch's host time passes MAX_SLEEP_MS, as for host-paced code such
    as the plain versions. The inputs (a few MB) stay in the L2 cache
    between calls, as they are for the solver, which factors a matrix it
    has just assembled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_cycles = int(min(2.0 * host_ms * reps, MAX_SLEEP_MS) * SLEEP_CYCLES_PER_MS)
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def spd_batch(B: int, n: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    K = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    b = rng.standard_normal((B, n))
    return (torch.as_tensor(K, device=DEVICE, dtype=dtype),
            torch.as_tensor(b, device=DEVICE, dtype=dtype))


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs difference over max abs of ``ref`` (absolute where ref is 0)."""
    diff, scale = float((x - ref).abs().max()), float(ref.abs().max())
    return diff / scale if scale > 0 else diff


def bound_time(bytes_moved: float, flops: float, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def variant_launched(w) -> str:
    """The variant of wrapper ``w`` that launched since its counts were zeroed."""
    if w.launches != 1:
        raise AssertionError(f"expected one launch, counted {w.launches}")
    return "shared" if w.launches_shared == 1 else "global"


def kernel_times(K, b, L_plain, x, x_plain, L):
    """Kernel, plain and library times and the bound of K1 and K2 at one shape."""
    B, n, _ = K.shape
    dtype, esz = K.dtype, K.element_size()
    # the plain versions take n steps of several launches each
    plain_reps = (dict(warmup=0, reps=1, batches=1) if n > 1000
                  else dict(warmup=1, reps=5) if n > 100 else dict(warmup=2, reps=20))
    # Bytes each function must move: K is symmetric and L lower triangular,
    # so B*n*(n+1)/2 entries of either are read; K1 writes the full (B, n, n)
    # factor (zeros above the diagonal), K2 reads b and writes x.
    tri = B * n * (n + 1) // 2
    k1_bound, k1_by = bound_time((tri + B * n * n) * esz, B * n ** 3 / 3.0, dtype)
    k2_bound, k2_by = bound_time((tri + 2 * B * n) * esz, 2.0 * B * n * n, dtype)
    bcol = b.unsqueeze(-1)
    return {
        "lane_cholesky": {
            "max_abs_err": float((L - L_plain).abs().max()),
            "ms": event_ms(lambda: bl.lane_cholesky(K)),
            "plain_ms": event_ms(lambda: bl.lane_cholesky_plain(K), **plain_reps),
            # cholesky_ex: torch.linalg.cholesky waits for the host to check
            # `info` after every call, which would time the round trip
            "library_ms": event_ms(lambda: torch.linalg.cholesky_ex(K, check_errors=False)),
            "bound_ms": k1_bound, "bound_by": k1_by,
        },
        "lane_cho_solve": {
            "max_abs_err": float((x - x_plain).abs().max()),
            "ms": event_ms(lambda: bl.lane_cho_solve(L_plain, b)),
            "plain_ms": event_ms(lambda: bl.lane_cho_solve_plain(L_plain, b), **plain_reps),
            "library_ms": event_ms(lambda: torch.cholesky_solve(bcol, L_plain)),
            "bound_ms": k2_bound, "bound_by": k2_by,
        },
    }


def check_nan_contracts():
    """K1: a non-PD matrix gives a NaN diagonal from its bad pivot on, with
    no exception, in both variants. K2: a zero diagonal in one system gives
    a non-finite x there, in both variants. The other systems of the batch
    stay finite."""
    for n in (53, 300):                  # K1 shared, K1 global
        K, _ = spd_batch(8, n, F64, seed=7)
        K[3] = -K[3]
        L = bl.lane_cholesky(K)
        torch.cuda.synchronize()
        d = torch.diagonal(L, dim1=1, dim2=2)
        if not bool(torch.isnan(d[3]).all()):
            raise AssertionError(f"lane_cholesky n={n}: non-PD input did not give a NaN diagonal")
        if not bool(torch.isfinite(d[[0, 1, 2, 4, 5, 6, 7]]).all()):
            raise AssertionError(f"lane_cholesky n={n}: NaN leaked into other matrices")
    for n in (53, 700):                  # K2 shared, K2 global
        K, b = spd_batch(8, n, F64, seed=8)
        L = bl.lane_cholesky_plain(K)
        L[5, n // 2, n // 2] = 0.0
        x = bl.lane_cho_solve(L, b)
        torch.cuda.synchronize()
        if bool(torch.isfinite(x[5]).all()):
            raise AssertionError(f"lane_cho_solve n={n}: a zero diagonal gave a finite x")
        if not bool(torch.isfinite(x[[0, 1, 2, 3, 4, 6, 7]]).all()):
            raise AssertionError(f"lane_cho_solve n={n}: non-finite x leaked into other systems")
    # one system over the card: the blocks after the bad pivot still finish
    L, b = random_factor(1, 4099, seed=9)
    L[0, 2049, 2049] = 0.0
    x = bl.lane_cho_solve(L, b)
    torch.cuda.synchronize()
    if bool(torch.isfinite(x).all()):
        raise AssertionError("lane_cho_solve (1, 4099): a zero diagonal gave a finite x")


def check_repeatable():
    """K2's global variant, REPEATS calls on the same inputs at each of
    REPEAT_SHAPES: every x bitwise equal to the first. Returns the calls
    made per shape."""
    out = {}
    for B, n, dtype in REPEAT_SHAPES:
        L, b = random_factor(B, n, seed=11)
        L, b = L.to(dtype), b.to(dtype)
        bl.reset_launches()
        first = bl.lane_cho_solve(L, b)
        differ = sum(int(not torch.equal(bl.lane_cho_solve(L, b), first))
                     for _ in range(REPEATS - 1))
        if bl.lane_cho_solve.launches_global != REPEATS:
            raise AssertionError(f"({B}, {n}, {dtype}) did not run K2's global variant")
        if differ:
            raise AssertionError(f"lane_cho_solve ({B}, {n}, {dtype}): {differ} of "
                                 f"{REPEATS - 1} repeated calls differ from the first")
        out[f"{B}x{n}_{str(dtype).replace('torch.', '')}"] = REPEATS
    return out


def random_factor(B: int, n: int, seed: int):
    """A well-conditioned random lower-triangular batch and right-hand side,
    made on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    L = torch.tril(torch.rand((B, n, n), generator=g, device=DEVICE, dtype=F64) - 0.5,
                   diagonal=-1) / n
    L.diagonal(dim1=1, dim2=2).add_(2.0)
    return L, torch.rand((B, n), generator=g, device=DEVICE, dtype=F64)


def solve_batch_scan():
    """K2's time against the batch at n = 53 and 197 (f64): where one system
    takes as long as a full wave, the time is the latency of one warp's
    dependent steps, not bandwidth."""
    out = {}
    for n in (53, 197):
        for B in (1, 132, 512, 2048):
            L, b = random_factor(B, n, seed=10)
            out[f"n{n}_B{B}"] = event_ms(lambda: bl.lane_cho_solve(L, b))
    return out


def phase_kernels():
    """K1 and K2 against their plain versions on the card, at every shape of
    KERNEL_SHAPES; returns the measurements at TIMED_SHAPES."""
    checks = []
    timed = {}
    for (B, n, dtype), (want_k1, want_k2) in KERNEL_SHAPES.items():
        K, b = spd_batch(B, n, dtype, seed=B * 1000 + n)
        bl.reset_launches()
        L = bl.lane_cholesky(K)
        got_k1 = variant_launched(bl.lane_cholesky)
        L_plain = bl.lane_cholesky_plain(K)
        x = bl.lane_cho_solve(L_plain, b)
        got_k2 = variant_launched(bl.lane_cho_solve)
        x_plain = bl.lane_cho_solve_plain(L_plain, b)
        torch.cuda.synchronize()
        if (got_k1, got_k2) != (want_k1, want_k2):
            raise AssertionError(f"at {(B, n, dtype)} the variants {(got_k1, got_k2)} ran, "
                                 f"expected {(want_k1, want_k2)}")
        tol = REL_TOL[dtype]
        e1, e2 = rel_err(L, L_plain), rel_err(x, x_plain)
        if not (e1 <= tol and e2 <= tol):
            raise AssertionError(
                f"kernel disagrees with its plain version at {(B, n, dtype)}: "
                f"cholesky rel err {e1}, cho_solve rel err {e2}, tolerance {tol}")
        if float(torch.triu(L, diagonal=1).abs().max()) != 0.0:
            raise AssertionError("lane_cholesky left the upper triangle nonzero")
        # a broadcast (stride-0) factor gives what the materialized batch gives
        xb = bl.lane_cho_solve(L_plain[0], b)
        xb_ref = bl.lane_cho_solve_plain(L_plain[:1].expand(B, -1, -1).contiguous(), b)
        e3 = rel_err(xb, xb_ref)
        if not e3 <= tol:
            raise AssertionError(f"broadcast-L solve disagrees: rel err {e3}")
        checks.append({"B": B, "n": n, "dtype": str(dtype).replace("torch.", ""),
                       "variants": [got_k1, got_k2],
                       "cholesky_rel_err": e1, "cho_solve_rel_err": e2,
                       "broadcast_rel_err": e3, "rel_tol": tol})
        if (B, n, dtype) in TIMED_SHAPES:
            timed[(B, n, dtype)] = kernel_times(K, b, L_plain, x, x_plain, L)
    check_nan_contracts()
    repeated = check_repeatable()
    one = torch.zeros(1, device=DEVICE)
    launch_floor = event_ms(lambda: one.add_(1))
    emit("kernels", kernels=["lane_cholesky", "lane_cho_solve"], checks=checks,
         nan_contracts=True, bitwise_repeatable_calls=repeated, launch_floor_ms=launch_floor,
         cho_solve_ms_by_batch=solve_batch_scan(),
         timed={f"{B}x{n}_{str(dt).replace('torch.', '')}": v
                for (B, n, dt), v in timed.items()})
    return timed, launch_floor


def sweep_inputs(bs, batch: int):
    rng = np.random.default_rng(SEED)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    # perturb the terminal target (xf, yf) per instance: the pinned xf rows
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    xf_rows = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs.scaled.var_scale[xf_rows][None, :]
    zl[:, xf_rows] += pert
    zu[:, xf_rows] += pert
    return tuple(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                 for a in (z0, zl, zu, cl, cu))


def solvers_of(bs):
    """The IPM solves a batch solver runs: one, or two under two_stage."""
    return [sv for sv in (bs.stage1_solver, bs.solver) if sv is not None]


def reset_counters(bs):
    bl.reset_launches()
    for sv in solvers_of(bs):
        sv.host_syncs = 0
        sv.outer_iterations = 0


def counted_runs(bs, args, timed: int = 3):
    """One warm-up run of a batch solver, then ``timed`` timed runs; every
    count is zeroed just before the last, the counted run. Returns its
    result, the timed walls, the warm-up's wall, its launches (total and per
    variant), host syncs and outer iterations."""
    def run_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bs.run(*args)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    _, warm_s = run_once()                            # warm-up (first-use costs)
    walls = []
    for rep in range(timed):
        if rep == timed - 1:
            reset_counters(bs)
        res, wall = run_once()
        walls.append(wall)
    launches = {k: getattr(bl, k).launches for k in ("lane_cholesky", "lane_cho_solve")}
    by_variant = {k: {v: getattr(getattr(bl, k), f"launches_{v}") for v in ("shared", "global")}
                  for k in launches}
    return (res, walls, warm_s, launches, by_variant,
            sum(sv.host_syncs for sv in solvers_of(bs)),
            sum(sv.outer_iterations for sv in solvers_of(bs)))


# each sweep's objectives, median iterations and solves/s, by phase name
SWEEP_RESULTS = {}


def phase_sweep(name: str, lane_kkt: bool, degrees=DEGREES, batch=BATCH,
                reference=REFERENCE_OBJECTIVES, expect=None, block_iterations=None):
    """One sweep, its counted run and its checks: on the lane route both
    kernels must run their shared variants only, and ``expect`` maps fields
    of the phase's line (iters_p50, first_iterations, launches, host_syncs)
    to the values they must take. With ``block_iterations`` (the JAX
    package's per-instance counts under its two block assemblies, "direct"
    and "dense") the sweep must take the block path, and is also run once
    with block_assembly="dense": no kernel launch in either, every instance
    solved to the JAX objectives in both, and each instance's count under
    each assembly equal to the JAX package's, apart from the instances of
    ``ROUNDING_SPREAD_BLOCK``, whose count must lie within the JAX package's
    own spread there."""
    problem = brachistochrone.make_problem(degrees=degrees)
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=lane_kkt))
    bs = make_batch_solver(problem, options)          # device=None: the GPU
    args = sweep_inputs(bs, batch)
    res, walls, warm_s, launches, by_variant, host_syncs, outer = counted_runs(bs, args)

    status = res.status.cpu().numpy()
    objective = res.objective.cpu().numpy()
    iterations = res.iterations.cpu().numpy()
    solved_frac = float(np.mean(status == SOLVED))
    if res.z.shape != (batch, bs.n) or not np.all(np.isfinite(objective)):
        raise AssertionError(f"{name}: result has a wrong shape or non-finite objectives")
    if solved_frac != 1.0:
        raise AssertionError(f"{name}: solved_frac {solved_frac} != 1.0")
    nref = len(reference)
    obj_err = float(np.max(np.abs(objective[:nref] - np.asarray(reference))))
    if not obj_err <= OBJECTIVE_TOL:
        raise AssertionError(
            f"{name}: first {nref} objectives differ from the reference by {obj_err}")
    rounding_decides = {}
    if block_iterations is not None:
        if launches["lane_cholesky"] or launches["lane_cho_solve"]:
            raise AssertionError(f"{name}: the block path launched a kernel: {launches}")
        bl.reset_launches()
        res_dense = make_batch_solver(problem, replace(options, block_assembly="dense")).run(*args)
        if bl.lane_cholesky.launches or bl.lane_cho_solve.launches:
            raise AssertionError(f"{name}: the dense block assembly launched a kernel")
        dense_err = float(np.max(np.abs(res_dense.objective.cpu().numpy()[:nref]
                                        - np.asarray(reference))))
        if not (bool((res_dense.status == SOLVED).all()) and dense_err <= OBJECTIVE_TOL):
            raise AssertionError(f"{name}: block_assembly='dense' did not solve every "
                                 f"instance to the reference (objective error {dense_err})")
        port = {"direct": iterations.tolist(), "dense": res_dense.iterations.cpu().tolist()}
        for assembly, want in zip(("direct", "dense"), block_iterations):
            spread, got = ROUNDING_SPREAD_BLOCK[assembly], port[assembly]
            off = [(i, got[i], want[i]) for i in range(batch)
                   if not (spread[i][0] <= got[i] <= spread[i][1] if i in spread
                           else got[i] == want[i])]
            if off:
                raise AssertionError(f"{name} ({assembly}): (instance, iterations, JAX's) "
                                     f"differ: {off}")
        rounding_decides = {
            f"{assembly}_{i}": {"port": port[assembly][i], "jax": want[i],
                                "jax_spread": ROUNDING_SPREAD_BLOCK[assembly][i]}
            for assembly, want in zip(("direct", "dense"), block_iterations)
            for i in ROUNDING_SPREAD_BLOCK[assembly]}
    elif lane_kkt:
        for k in ("lane_cholesky", "lane_cho_solve"):
            if not (by_variant[k]["shared"] > 0 and by_variant[k]["shared"] == launches[k]):
                raise AssertionError(
                    f"{name}: {k} did not run (only) its shared variant: {by_variant[k]}")
    if not lane_kkt and (launches["lane_cholesky"] or launches["lane_cho_solve"]):
        raise AssertionError(f"{name}: the library-matmul route launched a kernel: {launches}")

    # the unperturbed target as a batch of one, against the cycloid
    res1 = bs.run(*(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                    for a in bs.nominal_inputs(1)))
    tf = float(res1.objective[0]) / bs.scaled.obj_scale
    tf_err = abs(tf - brachistochrone.analytic_tf())
    if int(res1.status[0]) != SOLVED or not tf_err <= ANALYTIC_TOL:
        raise AssertionError(
            f"{name}: nominal solve status {int(res1.status[0])}, tf {tf}, "
            f"differs from the analytic optimum by {tf_err}")

    got = {"iters_p50": int(np.median(iterations)),
           "first_iterations": iterations[:nref].tolist(), "launches": launches,
           "host_syncs": host_syncs}
    for key, want in (expect or {}).items():
        if got[key] != want:
            raise AssertionError(f"{name}: {key} is {got[key]}, expected {want}")

    wall = statistics.median(walls)
    SWEEP_RESULTS[name] = {"objective": objective, "iters_p50": float(np.median(iterations)),
                           "solves_per_s": batch * solved_frac / wall,
                           "problem": problem, "options": options, "args": args, "res": res}
    emit(name, lane_kkt=lane_kkt, batch=batch, n=bs.n, m=bs.m,
         solved_frac=solved_frac, wall_s=wall, wall_s_runs=walls, warmup_s=warm_s,
         solves_per_s=batch * solved_frac / wall,
         iters_p50=int(np.median(iterations)), iters_max=int(iterations.max()),
         outer_iterations=outer, launches=launches, launches_by_variant=by_variant,
         launches_per_solve={k: v / batch for k, v in launches.items()},
         host_syncs=host_syncs, host_syncs_per_iteration=host_syncs / max(outer, 1),
         first_objectives_max_err=obj_err, objectives_compared=nref,
         first_iterations=iterations[:nref].tolist(),
         nominal_tf=tf, nominal_tf_err=tf_err, nominal_iterations=int(res1.iterations[0]),
         **({} if block_iterations is None else {
             "block_path": True, "iterations_equal_jax": {
                 assembly: int(np.sum(np.asarray(port[assembly]) == np.asarray(want)))
                 for assembly, want in zip(("direct", "dense"), block_iterations)},
             "rounding_decides": rounding_decides}))
    return launches, by_variant


def launch_inputs(bs, batch: int):
    """bench.py::bench_launch's perturbation: phase 1's pinned initial mass
    shifted by 0.01·U(-1, 1)·var_scale per instance, seed 0."""
    rng = np.random.default_rng(SEED)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    mrow = bs.nlp.layout.phases[0].var_offset + 6
    d = 0.01 * rng.uniform(-1, 1, batch) * bs.scaled.var_scale[mrow]
    zl[:, mrow] += d
    zu[:, mrow] += d
    return z0, zl, zu, cl, cu


def boostbrake_inputs(bs, batch: int):
    """bench.py::bench_boostbrake's perturbation: phase 2's pinned terminal
    distance lowered by 0.1·U(0, 1)·zl per instance, seed 0."""
    rng = np.random.default_rng(SEED)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[1]
    srow = pl.var_offset + (pl.npts - 1) * pl.nx
    d = -0.1 * rng.uniform(0.0, 1.0, batch) * bs.scaled.zl[srow]
    zl[:, srow] += d
    zu[:, srow] += d
    return z0, zl, zu, cl, cu


MULTIPHASE_SWEEPS = {
    # name -> (problem, IPM options, perturbation, batch, JAX reference, variant)
    "sweep_launch": (lambda: launch.make_problem(), dict(tol=1e-8, max_iter=60),
                     launch_inputs, BATCH_LAUNCH, LAUNCH_SWEEP_REFERENCE, "global"),
    "sweep_boostbrake": (lambda: boostbrake.make_problem(degrees=(8,)),
                         dict(tol=1e-8, max_iter=80), boostbrake_inputs, BATCH_BOOSTBRAKE,
                         BOOSTBRAKE_SWEEP_REFERENCE, "shared"),
}


def phase_multiphase_sweep(name: str):
    """A bench.py multi-phase sweep as written there, through the kernels
    (lane_kkt=True): every instance's status and iteration count equal to
    the JAX package's (within its own spread where rounding decides,
    ROUNDING_SPREAD_MULTIPHASE), objectives within MULTIPHASE_OBJECTIVE_RTOL,
    and both kernels launched in the one variant that n selects."""
    make, ipm, inputs, batch, ref, want = MULTIPHASE_SWEEPS[name]
    bs = make_batch_solver(make(), SolveOptions(ipm=IPMOptions(**ipm, lane_kkt=True)))
    if (bs.n, bs.m) != (ref["n"], ref["m"]):
        raise AssertionError(f"{name}: (n, m) = {(bs.n, bs.m)}, JAX's {(ref['n'], ref['m'])}")
    args = tuple(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                 for a in inputs(bs, batch))
    # one warm-up and one timed run (the script's longest sweeps); the
    # per-instance checks hold the timed run
    res, walls, warm_s, launches, by_variant, host_syncs, outer = counted_runs(bs, args, 1)
    status = res.status.cpu().numpy()
    iterations = res.iterations.cpu().tolist()
    objective = res.objective.cpu().numpy()
    if res.z.shape != (batch, bs.n) or not np.all(np.isfinite(objective)):
        raise AssertionError(f"{name}: result has a wrong shape or non-finite objectives")
    spread = ROUNDING_SPREAD_MULTIPHASE[name]

    tol = MULTIPHASE_OBJECTIVE_RTOL

    def within(i):
        if i in spread:
            lo, hi, statuses, _ = spread[i]
            return lo <= iterations[i] <= hi and int(status[i]) in statuses
        return iterations[i] == ref["iterations"][i] and int(status[i]) == ref["status"][i]

    off = [(i, int(status[i]), iterations[i], ref["status"][i], ref["iterations"][i])
           for i in range(batch) if not within(i)]
    if off:
        raise AssertionError(f"{name}: (instance, status, iterations, JAX's status, "
                             f"JAX's iterations) differ: {off}")
    # objectives where both solved (an unsolved iterate is not an answer):
    # JAX's, or within the objectives JAX's solved copies reach where
    # rounding decides
    want_obj = np.asarray(ref["objective"])
    rel = np.abs(objective - want_obj) / np.abs(want_obj)
    both = (status == SOLVED) & (np.asarray(ref["status"]) == SOLVED)
    for i in spread:
        lo, hi = spread[i][3] or (want_obj[i], want_obj[i])
        rel[i] = 0.0 if lo - tol * abs(lo) <= objective[i] <= hi + tol * abs(hi) else np.inf
    obj_rel = float(np.max(rel[both]))
    if not obj_rel <= tol:
        bad = [(int(i), float(objective[i]), float(want_obj[i]))
               for i in np.nonzero(both & ~(rel <= tol))[0]]
        raise AssertionError(f"{name}: (instance, objective, JAX's) differ: {bad}")
    for k in launches:
        if not (by_variant[k][want] > 0 and by_variant[k][want] == launches[k]):
            raise AssertionError(f"{name}: {k} did not run (only) its {want} variant: "
                                 f"{by_variant[k]}")
    wall = statistics.median(walls)
    solved_frac = float(np.mean(status == SOLVED))
    emit(name, lane_kkt=True, batch=batch, n=bs.n, m=bs.m, solved_frac=solved_frac,
         jax_solved_frac=float(np.mean(np.asarray(ref["status"]) == SOLVED)),
         wall_s=wall, wall_s_runs=walls, warmup_s=warm_s,
         solves_per_s=batch * solved_frac / wall,
         iters_p50=float(np.median(iterations)), iters_max=max(iterations),
         outer_iterations=outer, launches=launches, launches_by_variant=by_variant,
         host_syncs=host_syncs, host_syncs_per_iteration=host_syncs / max(outer, 1),
         objective_max_rel_err_vs_jax=obj_rel,
         iterations_equal_jax=sum(int(a == b) for a, b in zip(iterations, ref["iterations"])),
         objectives_compared=int(both.sum()),
         rounding_decides={str(i): {"port": [int(status[i]), iterations[i]],
                                    "jax": [ref["status"][i], ref["iterations"][i]],
                                    "jax_spread": spread[i]} for i in spread})
    return by_variant


def lane_options(options: SolveOptions) -> SolveOptions:
    """``options`` with the IPM it resolves to on the kernel route."""
    return replace(options, ipm=replace(options.ipm_options(), lane_kkt=True))


MULTIPHASE_SOLVES = {
    # name -> (problem, options as in the JAX package's tests)
    "launch": (lambda: launch.make_problem(),
               SolveOptions(mesh_method="none", max_iterations=400)),
    "boostbrake": (lambda: boostbrake.make_problem(),
                   SolveOptions(ipm=IPMOptions(tol=1e-9, max_iter=300), max_grid_num=6)),
    "climb": (lambda: climb.make_problem(tabulated=True), SolveOptions(mesh_method="none")),
}


def golden_checks(name: str, sol) -> dict:
    """The goldens of tests/test_examples.py (launch), tests/test_boostbrake.py
    and tests/test_climb.py."""
    if name == "launch":
        mass, tf = launch.final_mass_kg(sol), float(sol.phases[3].tf * launch.TU)
        drops = [float(sol.phases[i].x[-1, 6] - sol.phases[i + 1].x[0, 6]) for i in range(3)]
        if not (abs(mass - LAUNCH_GOLDEN_KG) < 1.0 and 900.0 < tf < 950.0
                and all(d > -1e-9 for d in drops)):
            raise AssertionError(f"launch: final mass {mass} kg, tf {tf} s, drops {drops}")
        return {"final_mass_kg": mass, "tf_s": tf, "mass_drops": drops}
    if name == "boostbrake":
        q = [float(p.q[0]) for p in sol.phases]
        if not (abs(sol.objective - BB_GOLDEN_J) < 1e-5 and abs(q[0] - BB_GOLDEN_Q) < 1e-4
                and abs(q[0] - q[1]) < 1e-4):
            raise AssertionError(f"boostbrake: J {sol.objective!r}, q {q}")
        return {"golden_abs_err": abs(sol.objective - BB_GOLDEN_J), "q": q}
    if not abs(sol.objective - CLIMB_GOLDEN) < 5e-3:
        raise AssertionError(f"climb: objective {sol.objective!r} against {CLIMB_GOLDEN}")
    return {"golden_abs_err": abs(sol.objective - CLIMB_GOLDEN)}


def phase_solve_multiphase():
    """One single-problem solve of each of MULTIPHASE_SOLVES on the kernel
    route (lane_kkt=True under the default block_kkt="auto": a grid at
    n >= BLOCK_THRESHOLD takes the block path, as the launch's one grid,
    bucketed to n = 836, does), each with the counts zeroed just before it:
    the JAX package's grids, meshes, per-grid (n, m, iterations) and
    objective, the goldens, and each kernel launched in exactly the variants
    its grids' n select."""
    out, by_case = {}, {}
    for name, (make, options) in MULTIPHASE_SOLVES.items():
        ref = MULTIPHASE_SOLVE_REFERENCE[name]
        problem = make()
        bl.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_mod.solve(problem, lane_options(options))     # device=None: the GPU
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_variant = {k: {"shared": w.launches_shared, "global": w.launches_global}
                      for k, w in WRAPPERS.items()}
        if sol.status != SOLVED or sol.grids != ref["grids"]:
            raise AssertionError(f"solve_multiphase[{name}]: status {sol.status}, "
                                 f"{sol.grids} grids; JAX's {ref['grids']}")
        per_grid = [(g["n"], g["m"], g["iterations"]) for g in sol.grid_stats]
        if per_grid != [tuple(g) for g in ref["per_grid"]]:
            raise AssertionError(f"solve_multiphase[{name}]: per grid (n, m, iterations) "
                                 f"{per_grid}, JAX's {ref['per_grid']}")
        for g, (grid, want) in enumerate(zip(sol.mesh_history, ref["mesh_history"]), 1):
            for (deg, fr), (rdeg, rfr) in zip(grid, want):
                if tuple(deg) != tuple(rdeg) or len(fr) != len(rfr) or max(
                        abs(a - b) for a, b in zip(fr, rfr)) > HP_FRACTION_TOL:
                    raise AssertionError(f"solve_multiphase[{name}]: grid {g} mesh "
                                         f"{deg}, {fr} differs from JAX's {rdeg}, {rfr}")
        obj_rel = abs(sol.objective - ref["objective"]) / abs(ref["objective"])
        if not obj_rel <= MULTIPHASE_SOLVE_RTOL:
            raise AssertionError(f"solve_multiphase[{name}]: objective {sol.objective!r}, "
                                 f"{obj_rel} relative to JAX's")
        for k, by in by_variant.items():
            # grids at n >= BLOCK_THRESHOLD take the block path: no launch
            want = {bl.variant(k, n, 8) for n, _, _ in per_grid if n < BLOCK_THRESHOLD}
            if {v for v, c in by.items() if c} != want:
                raise AssertionError(f"solve_multiphase[{name}]: {k} launched {by}, "
                                     f"the grids' n select {sorted(want)}")
        out[name] = {"wall_s": wall, "grids": sol.grids, "per_grid": per_grid,
                     "objective": sol.objective, "objective_rel_err_vs_jax": obj_rel,
                     "host_syncs": sol.host_syncs, "launches_by_variant": by_variant,
                     "ipm_wall_s": [g["wall_s"] for g in sol.grid_stats],
                     **golden_checks(name, sol)}
        by_case[name] = by_variant
    emit("solve_multiphase", lane_kkt=True, **out)
    return by_case


WRAPPERS = {"lane_cholesky": bl.lane_cholesky, "lane_cho_solve": bl.lane_cho_solve}


# each hp_solve's Solution and the report / checkpoint paths it wrote (ph)
HP_SOLUTIONS = {}


def hp_solve(method: str, block: bool = False, off_grids=None, outputs=None):
    """One hp-adaptive solve of the reference configuration, with its
    counted launches, walls and peak device memory per grid, checked against
    the JAX package's run. ``block``: the default block_kkt="auto", where
    grids with n >= BLOCK_THRESHOLD take the block path and must launch
    neither kernel nor allocate an (n, n) matrix in their IPM run;
    ``off_grids``: the per-grid lines of the block_kkt="off" run of the same
    call, printed beside these. ``outputs``: ``report_file`` and
    ``checkpoint_dir`` for the solve (phase ``utils`` reads them)."""
    ref = HP_BLOCK_REFERENCE if block else HP_REFERENCE[method]
    per_grid = []
    real, real_run = solve_mod.solve_on_mesh, solve_mod._run_and_extract

    def counted(*args, **kw):
        # launches of this grid's solve: the counts before and after it
        before = {k: (w.launches_shared, w.launches_global) for k, w in WRAPPERS.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sol = real(*args, **kw)
        torch.cuda.synchronize()
        per_grid[-1].update({
            "wall_s": time.perf_counter() - t0,
            "launches": {k: {"shared": w.launches_shared - before[k][0],
                             "global": w.launches_global - before[k][1]}
                         for k, w in WRAPPERS.items()}})
        return sol

    def ipm_memory(*args, **kw):
        # the IPM run and extraction of this grid: the peak it adds on top of
        # what the grid holds when it starts (transcription, scaling, mesh)
        torch.cuda.synchronize()
        grid_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sol = real_run(*args, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        per_grid.append({"peak_mb": max(grid_peak, peak) / 2 ** 20,
                         "ipm_added_peak_mb": (peak - base) / 2 ** 20})
        return sol

    options = SolveOptions(mesh_method=method, ipm=IPMOptions(tol=1e-8, max_iter=300,
                                                              lane_kkt=True),
                           **(HP_BLOCK_OPTIONS if block else HP_OPTIONS), **(outputs or {}))
    problem = hypersensitive.make_problem(tf=5000.0)
    solve_mod.solve_on_mesh, solve_mod._run_and_extract = counted, ipm_memory
    try:
        bl.reset_launches()                          # the counted run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_mod.solve(problem, options)       # device=None: the GPU
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        solve_mod.solve_on_mesh, solve_mod._run_and_extract = real, real_run
    launches = {k: {"shared": w.launches_shared, "global": w.launches_global}
                for k, w in WRAPPERS.items()}

    name = f"hp_solve{'_block' if block else ''}[{method}]"
    HP_SOLUTIONS[name] = (sol, options)
    if sol.status != 1:
        raise AssertionError(f"{name}: status {sol.status}, expected 1 (solved)")
    if sol.grids != ref["grids"] or len(sol.grid_stats) != ref["grids"]:
        raise AssertionError(f"{name}: {sol.grids} grids and {len(sol.grid_stats)} NLP "
                             f"solves, the JAX package took {ref['grids']}")
    for g, (((deg, fr),), (rdeg, rcount, rfr)) in enumerate(
            zip(sol.mesh_history, ref["mesh_history"]), start=1):
        if tuple(deg) != (rdeg,) * rcount or len(fr) != len(rfr):
            raise AssertionError(f"{name}: grid {g} mesh degrees {deg} differ from the "
                                 f"JAX package's ({rdeg},) * {rcount}")
        ferr = max(abs(a - b) for a, b in zip(fr, rfr))
        if not ferr <= HP_FRACTION_TOL:
            raise AssertionError(f"{name}: grid {g} mesh fractions differ by {ferr}")
    obj_rel = abs(sol.objective - ref["objective"]) / abs(ref["objective"])
    golden_rel = abs(sol.objective - HP_GOLDEN_J) / HP_GOLDEN_J
    if not (obj_rel <= HP_OBJECTIVE_RTOL and golden_rel <= HP_GOLDEN_RTOL):
        raise AssertionError(f"{name}: objective {sol.objective!r}: {obj_rel} relative to "
                             f"the JAX package's, {golden_rel} to the golden {HP_GOLDEN_J}")
    if not sol.max_relative_error <= HP_OPTIONS["desired_relative_error"]:
        raise AssertionError(f"{name}: max relative error {sol.max_relative_error}")
    grids = []
    for g, (st, pg) in enumerate(zip(sol.grid_stats, per_grid)):
        n = st["n"]
        if (n, st["m"]) != (ref["n"][g], ref["m"][g]):
            raise AssertionError(f"{name}: grid {g + 1} (n, m) = {(n, st['m'])}, "
                                 f"the JAX package's ({ref['n'][g]}, {ref['m'][g]})")
        if block and st["iterations"] != ref["iterations"][g]:
            raise AssertionError(f"{name}: grid {g + 1} took {st['iterations']} iterations, "
                                 f"the JAX package {ref['iterations'][g]}")
        on_blocks = block and n >= BLOCK_THRESHOLD
        for k, by in pg["launches"].items():
            if on_blocks:
                if sum(by.values()):
                    raise AssertionError(f"{name}: grid {g + 1} (n = {n}) is a block grid "
                                         f"and launched {k} {by}")
                continue
            want = bl.variant(k, n, 8)
            if by[want] == 0 or sum(by.values()) != by[want]:
                raise AssertionError(f"{name}: grid {g + 1} (n = {n}) launched {k} "
                                     f"{by}, expected only its {want} variant")
        dense_mb = n * n * 8 / 2 ** 20
        if on_blocks and not pg["ipm_added_peak_mb"] < dense_mb:
            raise AssertionError(f"{name}: grid {g + 1}'s IPM run added "
                                 f"{pg['ipm_added_peak_mb']} MiB, one (n, n) f64 is {dense_mb}")
        row = {"grid": g + 1, "n": n, "m": st["m"], "block": on_blocks,
               "iterations": st["iterations"], "jax_iterations": ref["iterations"][g],
               "launches": pg["launches"], "host_syncs": st["host_syncs"],
               "ipm_wall_s": st["wall_s"], "wall_s": pg["wall_s"],
               "peak_mb": pg["peak_mb"], "ipm_added_peak_mb": pg["ipm_added_peak_mb"]}
        if off_grids is not None:
            row["off"] = {k: off_grids[g][k] for k in ("ipm_wall_s", "wall_s", "peak_mb")}
        grids.append(row)
    dense_ns = [n for n in ref["n"] if not (block and n >= BLOCK_THRESHOLD)]
    for k, by in launches.items():
        need = ("shared", "global") if any(n >= 241 for n in dense_ns) else ("shared",)
        if any(by[v] == 0 for v in need):
            raise AssertionError(f"{name}: {k} launches {by}, every variant of {need} must run")
    emit("hp_solve_block" if block else "hp_solve", method=method,
         block_kkt="auto" if block else "off", status=sol.status, grids=sol.grids,
         objective=sol.objective, objective_rel_err_vs_jax=obj_rel,
         objective_rel_err_vs_golden=golden_rel, max_relative_error=sol.max_relative_error,
         jax_max_relative_error=ref["max_relative_error"], mesh_history_matches=True,
         iterations_match=[g["iterations"] for g in grids] == ref["iterations"],
         wall_s=wall, launches=launches, per_grid=grids)
    return launches, grids


def block_factor_inputs(kind: str, device=DEVICE, draws=None):
    """A bound structured KKT, its spec, and the point where it is
    assembled: ph's grid 6 (B = 1) or sweep_block's problem (B = 64), scaled
    as the solver scales it, at the first guess (with a seeded spread over
    the batch), zero multipliers, seeded positive ``d`` and ``wdiag``, and,
    as in the IPM, 1e20 on the diagonal of the fixed variables (so K is
    SPD), with a right-hand side: the blocks the IPM factors are scaled.
    ``draws``: the random draws of another call, so that the same inputs can
    be built on another device."""
    if kind == "hp_grid6":
        _, count, fr = HP_REFERENCE["ph"]["mesh_history"][-1]
        problem, batch = hypersensitive.make_problem(
            tf=5000.0, degrees=(16,) * count, fractions=fr), 1
    else:
        problem, batch = brachistochrone.make_problem(degrees=DEGREES_BLOCK), BATCH_BLOCK
    nlp = transcribe(problem, device=device)
    spec = make_block_spec(nlp.layout, nlp.ops)
    sk = make_structured_kkt(problem, nlp.layout, spec)
    scaled = solve_mod._scale(nlp, SolveOptions(), make_structured_jacobian(
        problem, nlp.layout, nlp.ops, device=device), device, F64)
    bound = bind_structured_kkt(sk, const_mesh(nlp.ops, device=device), scaled.obj_scale,
                                scaled.con_scale, 1.0 / scaled.var_scale)
    if draws is None:
        g = torch.Generator(device=device).manual_seed(12)
        draws = [torch.rand(shape, generator=g, device=device, dtype=F64)
                 for shape in ((batch, nlp.n), (batch, nlp.n), (batch, nlp.m), (batch, nlp.n))]
    u_z, u_w, u_d, r = (t.to(device) for t in draws)
    z = torch.as_tensor(scaled.z0, device=device, dtype=F64) * (1.0 + 0.01 * u_z)
    jb = bound.jac_blocks(z)
    hb = bound.hess_blocks(z, torch.zeros((batch, nlp.m), device=device, dtype=F64))
    fixed = torch.as_tensor(nlp.zu - nlp.zl <= 1e-14, device=device)
    wdiag = torch.where(fixed, 1e20, 1.0 + u_w)
    return spec, bound, jb, hb, 1.0 + u_d, wdiag, r, draws


def library_block_factor(A, B, C):
    """The block factorization on torch's library calls: ``cholesky_ex`` of
    the blocks and of the Schur complement, ``cholesky_solve`` for A⁻¹Bᵀ."""
    L, _ = torch.linalg.cholesky_ex(A, check_errors=False)
    W = torch.cholesky_solve(B.transpose(-1, -2), L)
    Ls, _ = torch.linalg.cholesky_ex(C - torch.einsum("zsnb,zsbm->znm", B, W),
                                     check_errors=False)
    return L, W, Ls


def library_block_solve(F, B, r_int, r_b):
    """The interior (B, S, b) and border (B, nb) parts of K⁻¹ r from
    ``library_block_factor``'s (L, W, Ls)."""
    L, W, Ls = F
    y = torch.cholesky_solve(r_int.unsqueeze(-1), L).squeeze(-1)
    rhs = r_b - torch.einsum("zsnb,zsb->zn", B, y)
    xb = torch.cholesky_solve(rhs.unsqueeze(-1), Ls).squeeze(-1)
    return y - torch.einsum("zsbn,zn->zsb", W, xb), xb


def phase_block_factor():
    """The block path's factorization timed on the card at ph's grid 6
    shapes and at sweep_block's: the direct assembly, factor_from_blocks
    (``ops/blocked_chol.py``: plain torch, as in the JAX package), one whole
    ``factorize`` (assembly + factor_from_blocks) and the block solve,
    against ``cholesky_ex`` + ``cholesky_solve`` on the same blocks. Device
    ms of back-to-back calls; a host-paced call counts the host's time (see
    ``event_ms``), so ``factorize_host_ms`` gives one synchronized call's
    wall too."""
    out = {}
    for kind in ("hp_grid6", "sweep_block"):
        spec, bound, jb, hb, d, wdiag, r, draws = block_factor_inputs(kind)
        A, Bm, C = bound.assemble(jb, hb, d, wdiag)
        F = factor_from_blocks(A, Bm, C)
        if not bool(bound.factor_ok(F).all()):
            raise AssertionError(f"block_factor[{kind}]: the factorization failed")
        x = bound.fsolve(F, r)
        Kx = bound.hv(hb, x) + wdiag * x + bound.jtv(jb, d * bound.jv(jb, x))
        resid = float((Kx - r).abs().max() / r.abs().max())
        # the same inputs through the CPU's ops: the GPU's scatters, gathers
        # and batched products give the same blocks, matvecs and solve
        _, bound_c, jb_c, hb_c, d_c, wdiag_c, r_c, _ = block_factor_inputs(
            kind, torch.device("cpu"), draws)
        got = {"A": A, "B": Bm, "C": C, "jv": bound.jv(jb, x),
               "jtv": bound.jtv(jb, d), "hv": bound.hv(hb, x), "x": x}
        x_c = x.cpu()
        want = dict(zip("ABC", bound_c.assemble(jb_c, hb_c, d_c, wdiag_c)))
        want.update(jv=bound_c.jv(jb_c, x_c), jtv=bound_c.jtv(jb_c, d_c),
                    hv=bound_c.hv(hb_c, x_c), x=bound_c.fsolve(
                        factor_from_blocks(want["A"], want["B"], want["C"]), r_c))
        vs_cpu = {k: rel_err(got[k].cpu(), want[k]) for k in got}
        if not (max(v for k, v in vs_cpu.items() if k != "x") <= 1e-12 and vs_cpu["x"] <= 1e-9):
            raise AssertionError(f"block_factor[{kind}]: the card and the CPU differ: {vs_cpu}")
        # the library route on the same blocks gives the same x
        ii = torch.as_tensor(spec.interior_idx.astype(np.int64), device=DEVICE)
        mask = torch.as_tensor(spec.interior_mask, device=DEVICE)
        bi = torch.as_tensor(spec.border_idx.astype(np.int64), device=DEVICE)
        r_int = torch.where(mask, r[:, ii], torch.zeros((), dtype=F64, device=DEVICE))
        Fl = library_block_factor(A, Bm, C)
        xi, xb = library_block_solve(Fl, Bm, r_int, r[:, bi])
        x_lib = torch.zeros_like(x)
        x_lib[:, bi] = xb
        x_lib[:, ii[mask]] = xi[:, mask]
        lib_diff = rel_err(x_lib, x)
        if not (resid <= 1e-8 and lib_diff <= 1e-8):
            raise AssertionError(f"block_factor[{kind}]: residual {resid}, against the "
                                 f"library route {lib_diff}")
        Z, S, b, _ = A.shape
        nb = C.shape[-1]
        # factor_from_blocks: A, B, C read once; L, Ainv (S b²), W (S b nb),
        # Ls, Sinv (nb²) written once; Cholesky + triangular inverse + A⁻¹ of
        # each block, W = A⁻¹Bᵀ, the Schur product, the same three on the
        # Schur complement
        moved = (A.numel() + Bm.numel() + C.numel() + 2 * A.numel() + Bm.numel()
                 + 2 * C.numel()) * A.element_size()
        flops = Z * (S * (b ** 3 / 3 + b ** 3 / 3 + b ** 3 + 2 * b * b * nb + 2 * b * nb * nb)
                     + nb ** 3 / 3 + nb ** 3 / 3 + nb ** 3)
        f_bound, f_by = bound_time(moved, flops, F64)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bound.factorize(jb, hb, d, wdiag)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        timing = dict(warmup=2, reps=10)
        out[kind] = {
            "B": Z, "S": S, "b": b, "nb": nb, "block_solve_residual": resid,
            "library_route_rel_diff": lib_diff, "rel_diff_vs_cpu": vs_cpu,
            "assemble_ms": event_ms(lambda: bound.assemble(jb, hb, d, wdiag), **timing),
            "factor_from_blocks_ms": event_ms(lambda: factor_from_blocks(A, Bm, C), **timing),
            "library_factor_ms": event_ms(lambda: library_block_factor(A, Bm, C), **timing),
            "factor_bound_ms": f_bound, "factor_bound_by": f_by,
            "factorize_ms": event_ms(lambda: bound.factorize(jb, hb, d, wdiag), **timing),
            "factorize_host_ms": statistics.median(host),
            "block_solve_ms": event_ms(lambda: bound.fsolve(F, r), **timing),
            "library_solve_ms": event_ms(
                lambda: library_block_solve(Fl, Bm, r_int, r[:, bi]), **timing),
        }
    emit("block_factor", **out)
    return out


def launch_counts():
    """Every launch count of both wrappers: per variant and per element type."""
    return {k: {v: getattr(w, f"launches_{v}") for v in ("shared", "global", "f64", "f32")}
            for k, w in WRAPPERS.items()}


def by_variant_now():
    return {k: {v: c[v] for v in ("shared", "global")} for k, c in launch_counts().items()}


def phase_solve_singular():
    """The automatic singular-arc solves on the kernel route (the models'
    own auto_options, and Goddard's three_phase_options for its decomposed
    problem, with lane_kkt=True), each with the counts zeroed just before
    it: the JAX package's arcs (kinds and node ranges), and for every solve
    of the workflow its phases, status, grids, per-grid (n, m, iterations)
    and, where JAX's solved, objective; the final objective and the goldens;
    each kernel launched in exactly the variants its grids' n select."""
    out, by_case = {}, {}
    real = solve_mod.solve
    for case, (model, kw) in SINGULAR_SOLVES.items():
        pin = SINGULAR_PINS[case]
        solves = []

        def recorded(problem, options=SolveOptions(), **on):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = real(problem, options, **on)
            torch.cuda.synchronize()
            after = launch_counts()
            solves.append({
                "phases": len(problem.phases), "status": int(sol.status), "grids": sol.grids,
                "objective": float(sol.objective),
                "per_grid": [[g["n"], g["m"], g["iterations"]] for g in sol.grid_stats],
                "wall_s": time.perf_counter() - t0,
                "launches": {k: {v: after[k][v] - before[k][v] for v in ("shared", "global")}
                             for k in after}})
            return sol

        extra = ({"decomposed_options": lane_options(goddard.three_phase_options())}
                 if model is goddard else {})
        solve_mod.solve = recorded
        try:
            bl.reset_launches()                       # the counted run starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = model.solve_auto(options=lane_options(model.auto_options()), **extra, **kw)
            torch.cuda.synchronize()                  # device=None: the GPU
            wall = time.perf_counter() - t0
        finally:
            solve_mod.solve = real
        by_variant = by_variant_now()
        arcs = [[a.kind, a.k_start, a.k_end] for a in sol.arcs]
        want_arcs = [[a["kind"], a["k_start"], a["k_end"]] for a in pin["arcs"]]
        off = [] if arcs == want_arcs else [f"arcs {arcs}, JAX's {want_arcs}"]
        if len(solves) != len(pin["solves"]):
            off.append(f"{len(solves)} solves, JAX's {len(pin['solves'])}")
        spread = ROUNDING_SPREAD_SINGULAR.get(case, {})
        for i, (g, w) in enumerate(zip(solves, pin["solves"])):
            g["objective_rel_err_vs_jax"] = abs(g["objective"] - w["objective"]) / abs(
                w["objective"])
            if (g["phases"], g["grids"]) != (w["phases"], w["grids"]) or [
                    pg[:2] for pg in g["per_grid"]] != [pg[:2] for pg in w["per_grid"]]:
                off.append(f"solve {i + 1}: (phases, grids, per grid (n, m, iterations)) "
                           f"{(g['phases'], g['grids'], g['per_grid'])}, JAX's "
                           f"{(w['phases'], w['grids'], w['per_grid'])}")
            elif i in spread:
                lo, hi, statuses = spread[i]
                if not (g["status"] in statuses and lo <= g["per_grid"][0][2] <= hi):
                    off.append(f"solve {i + 1}: status {g['status']}, "
                               f"{g['per_grid'][0][2]} iterations, outside JAX's spread "
                               f"{spread[i]}")
            elif (g["status"], g["per_grid"]) != (w["status"], w["per_grid"]):
                off.append(f"solve {i + 1}: (status, per grid (n, m, iterations)) "
                           f"{(g['status'], g['per_grid'])}, JAX's "
                           f"{(w['status'], w['per_grid'])}")
            # an iterate cut by the iteration limit is no answer
            elif w["status"] == SOLVED and not g["objective_rel_err_vs_jax"] <= SINGULAR_RTOL:
                off.append(f"solve {i + 1}: objective {g['objective']!r}, "
                           f"JAX's {w['objective']!r}")
        obj_rel = abs(sol.objective - pin["objective"]) / abs(pin["objective"])
        if not (sol.status == pin["status"] == SOLVED and obj_rel <= SINGULAR_RTOL):
            off.append(f"final status {sol.status}, objective {sol.objective!r} "
                       f"({obj_rel} relative to JAX's)")
        if model is goddard:
            golden = -sol.objective
            if not (abs(golden - goddard.PUBLISHED_HF) < GODDARD_GOLDEN_TOL
                    and [a.kind for a in sol.arcs] == ["upper", "singular", "lower"]):
                off.append(f"h(tf) {golden!r}, arcs {arcs}")
        else:
            golden = sol.objective * tumor.SCALE
            want, tol = TUMOR_GOLDEN[case]
            if not abs(golden - want) < tol:
                off.append(f"p(tf) {golden!r}, golden {want} ± {tol}")
        for k, by in by_variant.items():
            want = {bl.variant(k, g[0], 8) for sv in solves for g in sv["per_grid"]}
            if {v for v, c in by.items() if c} != want:
                off.append(f"{k} launched {by}, the grids' n select {sorted(want)}")
        out[case] = {"wall_s": wall, "arcs": arcs, "status": sol.status,
                     "objective": sol.objective, "objective_rel_err_vs_jax": obj_rel,
                     "golden": golden, "launches_by_variant": by_variant, "solves": solves,
                     "rounding_decides": {str(i + 1): {"port": solves[i]["per_grid"][0][2],
                                                       "jax": pin["solves"][i]["per_grid"][0][2],
                                                       "jax_spread": list(spread[i][:2])}
                                          for i in spread if i < len(solves)},
                     "differences": off}
        by_case[case] = by_variant
    # every workflow's line first, so that one run shows every difference
    emit("solve_singular", lane_kkt=True, **out)
    off = {case: o["differences"] for case, o in out.items() if o["differences"]}
    if off:
        raise AssertionError(f"solve_singular: {off}")
    return by_case


def phase_sensitivities():
    """sweep_lane's 512 instances through DifferentiableSolver: a solve, the
    counted forward through the autograd Function (the counts zeroed just
    before it), and the backward (the IFT adjoint: one batched KKT-adjoint
    solve) with its wall and the peak memory it adds. The gradient of the
    summed objective in zl + zu must give the dual envelope sensitivities
    (x0_sensitivities) on the pinned initial states at every instance, and
    central differences of the solver on the terminal-target pins at the
    first FD_INSTANCES."""
    problem = brachistochrone.make_problem(degrees=DEGREES)
    bs = make_batch_solver(problem, SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60,
                                                                lane_kkt=True)))
    dsol = DifferentiableSolver(bs)
    z0, zl, zu, cl, cu = sweep_inputs(bs, BATCH)
    res = bs.run(z0, zl, zu, cl, cu)                  # warm-up, and the status
    if not bool((res.status == SOLVED).all()):
        raise AssertionError("sensitivities: not every instance solved")
    zl_g, zu_g = zl.clone().requires_grad_(), zu.clone().requires_grad_()
    reset_counters(bs)                                # the counted run starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, s, lam, obj = dsol(z0, zl_g, zu_g, cl, cu)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    by_variant, outer = by_variant_now(), bs.solver.outer_iterations
    forward_rel = float(((obj.detach() - res.objective).abs() / res.objective.abs()).max())
    if not forward_rel <= 1e-10:
        raise AssertionError(f"sensitivities: the autograd forward's objectives differ from "
                             f"the solve's by {forward_rel} relative")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    g_zl, g_zu = torch.autograd.grad(obj.sum(), (zl_g, zu_g))
    torch.cuda.synchronize()
    backward_s = time.perf_counter() - t0
    backward_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    g = (g_zl + g_zu).cpu().numpy()
    if not np.all(np.isfinite(g)):
        raise AssertionError("sensitivities: a non-finite gradient")

    # gate 1: the envelope, in unscaled units, at every instance
    pl = bs.nlp.layout.phases[0]
    sl = slice(pl.var_offset, pl.var_offset + pl.nx)
    dual = bs.x0_sensitivities(res)
    if not np.all(np.isfinite(dual)):
        raise AssertionError("sensitivities: an initial state is not pinned")
    g_unscaled = g[:, sl] * bs.scaled.var_scale[sl][None, :] / float(bs.scaled.obj_scale)
    env_excess = float(np.max(np.abs(g_unscaled - dual)
                              - (ENVELOPE_ATOL + ENVELOPE_RTOL * np.abs(dual))))
    if not env_excess <= 0.0:
        raise AssertionError(f"sensitivities: the gradient misses the envelope "
                             f"sensitivities by {env_excess} past rtol {ENVELOPE_RTOL}, "
                             f"atol {ENVELOPE_ATOL}")

    # gate 2: central differences of the solver on the terminal-target pins
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    rows = range(first, first + 2)
    k, nfd = len(rows), FD_INSTANCES
    rep = [np.repeat(a[:nfd].cpu().numpy(), 2 * k, axis=0) for a in (z0, zl, zu, cl, cu)]
    for b in range(nfd):
        for j, r in enumerate(rows):
            for sgn, sign in enumerate((1.0, -1.0)):
                for a in rep[:3]:
                    a[(b * k + j) * 2 + sgn, r] += sign * FD_EPS
    res_fd = bs.run(*rep)
    if not bool((res_fd.status == SOLVED).all()):
        raise AssertionError("sensitivities: a finite-difference solve did not converge")
    o = res_fd.objective.cpu().numpy().reshape(nfd, k, 2)
    fd = (o[..., 0] - o[..., 1]) / (2 * FD_EPS)
    g_rows = g[:nfd, first:first + 2]
    fd_excess = float(np.max(np.abs(g_rows - fd) - (FD_ATOL + FD_RTOL * np.abs(fd))))
    if not fd_excess <= 0.0:
        raise AssertionError(f"sensitivities: gradient {g_rows.tolist()} against central "
                             f"differences {fd.tolist()}")
    for kk, by in by_variant.items():
        if not (by["shared"] > 0 and by["global"] == 0):
            raise AssertionError(f"sensitivities: {kk} launched {by}, expected shared only")
    emit("sensitivities", batch=BATCH, n=bs.n, m=bs.m, adjoint_size=bs.n + 2 * bs.m,
         forward_wall_s=forward_s, backward_wall_s=backward_s,
         backward_added_peak_mb=backward_mb, outer_iterations=outer,
         forward_vs_solve_max_rel=forward_rel,
         launches_by_variant=by_variant,
         envelope_max_abs_err=float(np.max(np.abs(g_unscaled - dual))),
         envelope_rtol=ENVELOPE_RTOL, envelope_atol=ENVELOPE_ATOL,
         fd_instances=nfd, fd_eps=FD_EPS, fd_max_abs_err=float(np.max(np.abs(g_rows - fd))),
         fd_rtol=FD_RTOL, gradient_first=g_rows[0].tolist(), fd_first=fd[0].tolist())
    return by_variant


def phase_sweep_two_stage():
    """sweep_lane's sweep with two_stage=True on the kernel route: stage 1
    in float32 (K1 and K2 in f32), stage 2 in f64 from stage 1's point. At
    least the JAX package's solved fraction of the same sweep (510 of 512:
    in float32 rounding decides where the cascade ends, ROADMAP Queue 3
    entry 7), every unsolved instance at the cascade's iteration limit as
    JAX's are, every solved one at sweep_lane's objective (1e-7 relative),
    the first 8 solved at the JAX package's; median total iterations below
    4x sweep_lane's; both kernels launched in both element types, in their
    shared variants."""
    problem = brachistochrone.make_problem(degrees=DEGREES)
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=True))
    bs = make_batch_solver(problem, options, two_stage=True)       # device=None: the GPU
    args = sweep_inputs(bs, BATCH)
    # one timed run after the warm-up, within the script's time limit
    res, walls, warm_s, launches, by_variant, host_syncs, outer = counted_runs(bs, args, 1)
    by_dtype = {k: {v: c[v] for v in ("f32", "f64")} for k, c in launch_counts().items()}
    stage_outer = [sv.outer_iterations for sv in solvers_of(bs)]
    status = res.status.cpu().numpy()
    objective = res.objective.cpu().numpy()
    iterations = res.iterations.cpu().numpy()
    lane = SWEEP_RESULTS["sweep_lane"]
    solved_frac = float(np.mean(status == SOLVED))
    jax = SINGULAR_PINS["two_stage_b512"]["two_stage"]
    jax_solved_frac = float(np.mean(np.asarray(jax["status"]) == SOLVED))
    unsolved = [(int(i), int(status[i]), int(iterations[i]))
                for i in np.nonzero(status != SOLVED)[0]]
    at_limit = bs.ipm_options.max_iter + TWO_STAGE_STAGE1_MAX_ITER
    if (res.z.dtype != torch.float64 or solved_frac < jax_solved_frac
            or any((st, its) != (MAX_ITER, at_limit) for _, st, its in unsolved)):
        raise AssertionError(f"sweep_two_stage: solved_frac {solved_frac} (JAX's "
                             f"{jax_solved_frac}), z {res.z.dtype}; (instance, status, "
                             f"iterations) unsolved {unsolved}")
    solved = status == SOLVED
    rel = np.abs(objective - lane["objective"]) / np.abs(lane["objective"])
    rel_lane = float(np.max(rel[solved]))
    ref = np.asarray(REFERENCE_OBJECTIVES)
    rel_ref = float(np.max((np.abs(objective[:len(ref)] - ref) / np.abs(ref))[solved[:len(ref)]]))
    if not (rel_lane <= OBJECTIVE_TOL and rel_ref <= OBJECTIVE_TOL and all(solved[:len(ref)])):
        raise AssertionError(f"sweep_two_stage: objectives {rel_lane} from sweep_lane's, "
                             f"{rel_ref} from the JAX package's")
    p50 = float(np.median(iterations))
    if not p50 < 4.0 * lane["iters_p50"]:
        raise AssertionError(f"sweep_two_stage: median iterations {p50}, sweep_lane's "
                             f"{lane['iters_p50']}")
    for k in WRAPPERS:
        if not (by_dtype[k]["f32"] > 0 and by_dtype[k]["f64"] > 0
                and by_variant[k]["global"] == 0):
            raise AssertionError(f"sweep_two_stage: {k} launched {by_variant[k]}, "
                                 f"{by_dtype[k]}; expected shared, in f32 and f64")
    wall = statistics.median(walls)
    emit("sweep_two_stage", lane_kkt=True, batch=BATCH, n=bs.n, m=bs.m,
         solved_frac=solved_frac, wall_s=wall, wall_s_runs=walls, warmup_s=warm_s,
         solves_per_s=BATCH * solved_frac / wall, sweep_lane_solves_per_s=lane["solves_per_s"],
         iters_p50=p50, iters_max=int(iterations.max()), sweep_lane_iters_p50=lane["iters_p50"],
         outer_iterations_by_stage=stage_outer, launches=launches,
         launches_by_variant=by_variant, launches_by_dtype=by_dtype, host_syncs=host_syncs,
         objective_max_rel_err_vs_sweep_lane=rel_lane,
         first_objectives_max_rel_err_vs_jax=rel_ref, jax_solved_frac=jax_solved_frac,
         unsolved=unsolved, jax_unsolved=[
             (i, st, its) for i, (st, its) in enumerate(zip(jax["status"], jax["iterations"]))
             if st != SOLVED])
    return by_variant, by_dtype


def double_integrator():
    """bench.py::bench_mpc's plant (and tests/test_round3.py's)."""
    return Problem(phases=(Phase(
        nx=2, nu=1,
        dynamics=lambda x, u, t, q: torch.stack([x[1], u[0]]),
        lagrange=lambda x, u, t, q: 0.5 * u[0] ** 2 + x[0] ** 2,
        x0_bounds=(np.array([1.0, 0.0]), np.array([1.0, 0.0])),
        xf_bounds=(np.zeros(2), np.zeros(2)),
        x_bounds=(np.full(2, -10.0), np.full(2, 10.0)),
        u_bounds=(-50.0, 50.0), t0_bounds=(0.0, 0.0), tf_bounds=(1.0, 1.0),
        mesh_degrees=(8,), mesh_fractions=(-1.0, 1.0),
    ),))


def mpc_loop(ctrl, x, steps, name):
    """bench_mpc's closed loop (x += dt·(x1, u0)) for one plant or a batch;
    every step's statuses, iterations and u0 against the JAX package's
    (SINGULAR_PINS[name])."""
    pin = SINGULAR_PINS[name]
    x = np.array(x, dtype=np.float64)
    u0_err, iterations = 0.0, []
    for step in range(steps):
        u0, info = ctrl.step(x)
        u0 = np.asarray(u0, dtype=np.float64)
        status, its = info["status"].tolist(), info["iterations"].tolist()
        if status != pin["status"][step] or its != pin["iterations"][step]:
            raise AssertionError(f"mpc[{name}] step {step}: (status, iterations) "
                                 f"{(status, its)}, JAX's "
                                 f"{(pin['status'][step], pin['iterations'][step])}")
        u0_err = max(u0_err, float(np.max(np.abs(u0.reshape(-1) - pin["u0"][step]))))
        iterations.append(its)
        x = (x + MPC_DT * np.array([x[1], float(u0[0])]) if x.ndim == 1
             else x + MPC_DT * np.stack([x[:, 1], u0[:, 0]], axis=1))
    if not u0_err <= MPC_U0_TOL:
        raise AssertionError(f"mpc[{name}]: u0 differs from JAX's by {u0_err}")
    return u0_err, iterations


def phase_mpc():
    """bench.py::bench_mpc as written there (B = 1, its own options: the
    library route), then MPC_BATCH plants in one controller on the kernel
    route (the counts zeroed just before it), MPC_STEPS steps each, every
    step against the JAX package's; then tests/test_round3.py's value
    gradient against a fresh controller's finite difference."""
    ctrl = MPCController(double_integrator(), SolveOptions(tol=1e-6), shift_dt=MPC_DT)
    bl.reset_launches()
    err1, its1 = mpc_loop(ctrl, [1.0, 0.0], MPC_STEPS, "mpc_bench")
    bench_launches = by_variant_now()

    opts = SolveOptions(tol=1e-6, ipm=IPMOptions(
        tol=1e-6, max_iter=SolveOptions().max_iterations, mu_init=1e-2, lane_kkt=True))
    x0 = np.array([1.0, 0.0]) + 0.1 * np.random.default_rng(SEED).uniform(-1, 1, (MPC_BATCH, 2))
    ctrl64 = MPCController(double_integrator(), opts, batch=MPC_BATCH, shift_dt=MPC_DT)
    bl.reset_launches()                               # the counted run starts here
    err64, its64 = mpc_loop(ctrl64, x0, MPC_STEPS, "mpc_batch")
    by_variant = by_variant_now()
    for k, by in by_variant.items():
        if not (by["shared"] > 0 and by["global"] == 0):
            raise AssertionError(f"mpc: {k} launched {by}, expected shared only")
    vg = ctrl64.value_gradient()
    vg_err = float(np.max(np.abs(vg - np.asarray(SINGULAR_PINS["mpc_batch"]["value_gradient"]))))
    if not vg_err <= 1e-8 * max(1.0, float(np.max(np.abs(vg)))):
        raise AssertionError(f"mpc: the batch's value gradient differs from JAX's by {vg_err}")

    want = SINGULAR_PINS["mpc_round3"]["value_gradient"]
    c1 = MPCController(double_integrator(), SolveOptions(tol=1e-8))
    _, info = c1.step(np.array([1.0, 0.0]))
    g = c1.value_gradient()
    _, info_h = MPCController(double_integrator(), SolveOptions(tol=1e-8)).step(
        np.array([1.0 + MPC_FD_H, 0.0]))
    fd = (float(info_h["objective"][0]) - float(info["objective"][0])) / MPC_FD_H
    if not (abs(g[0, 0] - fd) < MPC_FD_RTOL * max(1.0, abs(fd))
            and float(np.max(np.abs(g - np.asarray(want["gradient"])))) <= 1e-8):
        raise AssertionError(f"mpc: value gradient {g.tolist()}, finite difference {fd}, "
                             f"JAX's {want['gradient']}")
    emit("mpc", bench={"batch": 1, "steps": MPC_STEPS, "lane_kkt": False,
                       "mpc_p50_solve_ms": ctrl.percentile_ms(50),
                       "p90_ms": ctrl.percentile_ms(90), "u0_max_abs_err_vs_jax": err1,
                       "iterations": [i[0] for i in its1], "launches": bench_launches},
         batch={"batch": MPC_BATCH, "n": ctrl64.bs.n, "m": ctrl64.bs.m, "steps": MPC_STEPS,
                "lane_kkt": True, "mpc_p50_solve_ms": ctrl64.percentile_ms(50),
                "p90_ms": ctrl64.percentile_ms(90), "u0_max_abs_err_vs_jax": err64,
                "iterations_max_by_step": [max(i) for i in its64],
                "value_gradient_max_abs_err_vs_jax": vg_err, "launches_by_variant": by_variant},
         value_gradient=g[0].tolist(), value_gradient_fd=fd)
    return by_variant


# phase utils: the hp_solve[ph] run writes its report and checkpoints here
RESULT_FILES = sorted([f"{k}1.dat" for k in ("time", "state", "control", "parameter",
                                             "costate", "Hamiltonian")] + ["summary.txt"])
# the names the profiler must find among the CUDA kernels of one iteration
PROFILE_KERNELS = ("lane_cholesky_kernel", "lane_cho_solve_kernel")


def hp_outputs(tmp: str) -> dict:
    return {"report_file": os.path.join(tmp, "hp_report.txt"),
            "checkpoint_dir": os.path.join(tmp, "hp_checkpoints")}


def phase_utils(tmp: str):
    """The utilities on the card: hp_solve[ph]'s report and checkpoints (one
    a grid; the resumed problem on the last grid's mesh; the report names
    the JAX package's grid count), its result files, ``check_problem`` on
    every model, and a ``device_profile`` trace of one warm IPM iteration of
    the 512-instance sweep that names both kernels among its CUDA kernels.
    Returns the profiled iteration's launches per variant and the problem
    resumed on the last grid (phase scale_out solves it)."""
    sol, options = HP_SOLUTIONS["hp_solve[ph]"]
    ref = HP_REFERENCE["ph"]
    t0 = time.perf_counter()
    ckpts = sorted(glob.glob(os.path.join(options.checkpoint_dir, "grid_*.npz")))
    if len(ckpts) != sol.grids:
        raise AssertionError(f"utils: {len(ckpts)} checkpoints for {sol.grids} grids")
    resumed, grid = checkpoint.resume_problem(hypersensitive.make_problem(tf=5000.0),
                                              options.checkpoint_dir)
    ph = resumed.phases[0]
    if grid != sol.grids or ((tuple(ph.mesh_degrees), tuple(ph.mesh_fractions)),) != \
            sol.mesh_history[-1]:
        raise AssertionError(f"utils: resumed grid {grid} on a mesh other than grid "
                             f"{sol.grids}'s")
    with open(options.report_file) as f:
        report = f.read()
    grids_line = re.search(r"^grids\s+(\d+)$", report, re.M)
    if grids_line is None or int(grids_line.group(1)) != ref["grids"]:
        raise AssertionError(f"utils: the report does not name JAX's {ref['grids']} grids")
    paths = save_results(sol, os.path.join(tmp, "results"))
    if sorted(os.path.basename(p) for p in paths) != RESULT_FILES:
        raise AssertionError(f"utils: result files {paths}")
    x = np.loadtxt(os.path.join(tmp, "results", "state1.dat")).reshape(-1, 1)
    if not np.array_equal(x, sol.phases[0].x):
        raise AssertionError("utils: state1.dat does not read back as the solution's states")
    files_s = time.perf_counter() - t0

    checked = {}
    for mod in pkgutil.iter_modules(models_pkg.__path__):
        t1 = time.perf_counter()
        model = importlib.import_module(f"lpopc_tpu_torch.models.{mod.name}")
        check_problem(model.make_problem())           # device=None: the GPU
        checked[mod.name] = time.perf_counter() - t1

    sweep = SWEEP_RESULTS["sweep_lane"]
    options1 = replace(sweep["options"], ipm=replace(sweep["options"].ipm, max_iter=1))
    bs1 = make_batch_solver(sweep["problem"], options1)
    bs1.run(*sweep["args"])                           # warm-up
    torch.cuda.synchronize()
    bl.reset_launches()
    t1 = time.perf_counter()
    with device_profile(os.path.join(tmp, "profile")) as prof:
        bs1.run(*sweep["args"])
    profiled_s = time.perf_counter() - t1
    by_variant = by_variant_now()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    found = {k: sorted(n for n in names if k in n) for k in PROFILE_KERNELS}
    if not all(found.values()):
        raise AssertionError(f"utils: the trace names no {[k for k, v in found.items() if not v]}"
                             f" among its {len(names)} CUDA kernel names")
    if not all(sum(by.values()) for by in by_variant.values()):
        raise AssertionError(f"utils: the profiled iteration launched {by_variant}")
    span_us = (max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels))
    busy_us = sum(e.get("dur", 0) for e in kernels)
    emit("utils", grids=sol.grids, checkpoints=len(ckpts), resumed_grid=grid,
         resumed_mesh=[int(ph.mesh_degrees[0]), len(ph.mesh_degrees)],
         report_grids=int(grids_line.group(1)), result_files=len(paths), files_s=files_s,
         check_problem_s=checked, profile_wall_s=profiled_s,
         profile_trace_mb=os.path.getsize(prof.trace_path) / 2 ** 20,
         profile_kernel_launches=len(kernels), profile_kernel_names=len(names),
         profile_kernel_ms=busy_us / 1e3, profile_kernel_span_ms=span_us / 1e3,
         profile_device_busy=busy_us / span_us, profile_kernels_found=found,
         launches_by_variant=by_variant)
    return by_variant, resumed


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def same_bits(name: str, got, want):
    """Every result field of ``got`` bitwise equal to ``want``'s."""
    for k in ("status", "iterations", "objective", "z", "lam"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"scale_out {name}: {k} differs from the unsharded run")


def timed_run(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hybrid_inputs(bs, batch: int):
    """tests/test_hybrid.py's perturbation: the pinned initial state moved by
    0.05·i·var_scale (i = 0..batch-1)."""
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    sl = slice(pl.var_offset, pl.var_offset + 1)
    d = 0.05 * np.arange(batch)[:, None] * bs.scaled.var_scale[sl][None, :]
    for a in (z0, zl, zu):
        a[:, sl] += d
    return tuple(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                 for a in (z0, zl, zu, cl, cu))


SCALE_OUT_OPTIONS = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=300, soc=False),
                                 mesh_method="none", block_kkt="on")
HYBRID_BATCH = 4


def phase_scale_out(resumed):
    """The scale-out solvers at world size 1 on NCCL: the 512-instance sweep
    through ``make_batch_solver(mesh=default_mesh())``, through
    ``make_distributed_batch_solver(...).run_local`` and with
    ``donate=True`` (the result in z0's storage), bitwise equal to
    sweep_lane's result; ``make_segment_solver`` on hp_solve's last grid
    (resumed from its checkpoint: n = 4099, 128 segments, the block path),
    bitwise equal to the unsharded block solve of the same problem; and
    ``make_hybrid_batch_solver`` on a (1, 1) mesh at 4 perturbed instances
    of that grid, bitwise equal to the unsharded batch. Returns each path's
    launches per variant."""
    distributed.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0)   # NCCL on cuda:0
    by_path, out = {}, {}
    try:
        sweep = SWEEP_RESULTS["sweep_lane"]
        problem, options, args = sweep["problem"], sweep["options"], sweep["args"]
        for name, make in (
                ("mesh", lambda: make_batch_solver(problem, options, mesh=default_mesh()).run),
                ("distributed", lambda: distributed.make_distributed_batch_solver(
                    problem, options).run_local),
                ("donate", lambda: make_batch_solver(problem, options, donate=True).run)):
            run = make()
            z0 = args[0].clone()                      # donated: holds the result after
            bl.reset_launches()
            res, wall = timed_run(lambda: run(z0, *args[1:]))
            by_path[name] = by_variant_now()
            same_bits(name, res, sweep["res"])
            if name == "donate" and res.z.data_ptr() != z0.data_ptr():
                raise AssertionError("scale_out donate: the result's z is not z0's storage")
            out[f"{name}_wall_s"] = wall

        plain_bs = make_batch_solver(resumed, SCALE_OUT_OPTIONS)
        one = tuple(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                    for a in plain_bs.nominal_inputs(1))
        plain, plain_s = timed_run(lambda: plain_bs.run(*one))
        again, _ = timed_run(lambda: plain_bs.run(*one))
        out["unsharded_block_repeatable"] = all(
            torch.equal(getattr(plain, k), getattr(again, k)) for k in ("z", "lam", "iterations"))
        seg_run = make_segment_solver(resumed, SCALE_OUT_OPTIONS, mesh=segment_mesh())
        bl.reset_launches()
        seg, seg_s = timed_run(seg_run)
        by_path["segment"] = by_variant_now()
        same_bits("segment", type(seg)(*(None if f is None else f[None] for f in seg)), plain)
        if int(seg.status) != SOLVED:
            raise AssertionError(f"scale_out segment: status {int(seg.status)}")
        obj_rel = abs(float(seg.objective) / plain_bs.scaled.obj_scale - HP_REFERENCE["ph"][
            "objective"]) / HP_REFERENCE["ph"]["objective"]
        if not obj_rel <= HP_OBJECTIVE_RTOL:
            raise AssertionError(f"scale_out segment: objective {obj_rel} from JAX's hp solve")

        hb = make_hybrid_batch_solver(resumed, SCALE_OUT_OPTIONS, mesh=hybrid_mesh(1, 1))
        hargs = hybrid_inputs(hb, HYBRID_BATCH)
        hplain, hplain_s = timed_run(lambda: plain_bs.run(*hargs))
        bl.reset_launches()
        hyb, hyb_s = timed_run(lambda: hb.run(*hargs))
        by_path["hybrid"] = by_variant_now()
        same_bits("hybrid", hyb, hplain)
        if not bool((hyb.status == SOLVED).all()):
            raise AssertionError(f"scale_out hybrid: status {hyb.status.tolist()}")
        for name in ("segment", "hybrid"):
            if any(sum(by.values()) for by in by_path[name].values()):
                raise AssertionError(f"scale_out {name}: the block path launched "
                                     f"{by_path[name]}")
    finally:
        torch.distributed.destroy_process_group()
    emit("scale_out", world_size=1, backend="nccl", sweep_batch=BATCH,
         sweep_bitwise_equal_sweep_lane=True, segment_n=plain_bs.n,
         segment_segments=len(resumed.phases[0].mesh_degrees),
         segment_iterations=int(seg.iterations), segment_objective_rel_err_vs_jax=obj_rel,
         segment_bitwise_equal_unsharded=True, segment_wall_s=seg_s,
         unsharded_block_wall_s=plain_s, hybrid_batch=HYBRID_BATCH,
         hybrid_iterations=hyb.iterations.tolist(), hybrid_bitwise_equal_unsharded=True,
         hybrid_wall_s=hyb_s, unsharded_hybrid_inputs_wall_s=hplain_s,
         launches_by_path=by_path, **out)
    return by_path


def main():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    log = build.build("batched_linalg", extra_flags=("-Xptxas", "-v"))
    bl._library()                                      # load and bind
    emit("build", seconds=time.perf_counter() - t0, library=build.library_path("batched_linalg"),
         ptxas=ptxas_summary(log))

    timed, launch_floor = phase_kernels()
    launches, by_variant = phase_sweep("sweep_lane", lane_kkt=True, expect=EXPECT_LANE)
    phase_sweep("sweep_apply", lane_kkt=False)
    _, by_variant_large = phase_sweep(
        "sweep_lane_large", lane_kkt=True, degrees=DEGREES_LARGE, batch=BATCH_LARGE,
        reference=REFERENCE_OBJECTIVES_LARGE, expect=EXPECT_LANE_LARGE)
    tmp = tempfile.TemporaryDirectory()   # report, checkpoints, result files, trace
    hp, hp_grids = {}, {}
    for method in ("ph", "hp-liu"):
        hp[method], hp_grids[method] = hp_solve(
            method, outputs=hp_outputs(tmp.name) if method == "ph" else None)
    hp["block_ph"], _ = hp_solve("ph", block=True, off_grids=hp_grids["ph"])
    _, by_variant_block = phase_sweep(
        "sweep_block", lane_kkt=True, degrees=DEGREES_BLOCK, batch=BATCH_BLOCK,
        reference=REFERENCE_OBJECTIVES_BLOCK,
        block_iterations=(REFERENCE_ITERATIONS_BLOCK, REFERENCE_ITERATIONS_BLOCK_DENSE))
    phase_block_factor()
    by_variant_launch = phase_multiphase_sweep("sweep_launch")
    by_variant_bb = phase_multiphase_sweep("sweep_boostbrake")
    by_variant_solves = phase_solve_multiphase()
    by_variant_singular = phase_solve_singular()
    by_variant_sens = phase_sensitivities()
    by_variant_two_stage, by_dtype_two_stage = phase_sweep_two_stage()
    by_variant_mpc = phase_mpc()
    by_variant_utils, resumed = phase_utils(tmp.name)
    by_path_scale_out = phase_scale_out(resumed)
    tmp.cleanup()

    source = "lpopc_tpu_torch/csrc/batched_linalg.cu"
    replaces = {"lane_cholesky": "lpopc_tpu/ops/batched_linalg.py:128",
                "lane_cho_solve": "lpopc_tpu/ops/batched_linalg.py:193"}
    paths = {k: {"sweep_lane": by_variant[k], "sweep_lane_large": by_variant_large[k],
                 **{f"hp_solve_{m}": hp[m][k] for m in hp},
                 "sweep_block": by_variant_block[k], "sweep_launch": by_variant_launch[k],
                 "sweep_boostbrake": by_variant_bb[k],
                 **{f"solve_multiphase_{c}": by_variant_solves[c][k] for c in by_variant_solves},
                 **{f"solve_singular_{c}": by_variant_singular[c][k]
                    for c in by_variant_singular},
                 "sensitivities": by_variant_sens[k], "sweep_two_stage": by_variant_two_stage[k],
                 "mpc_batch": by_variant_mpc[k], "utils_profiled_iteration": by_variant_utils[k],
                 **{f"scale_out_{p}": by[k] for p, by in by_path_scale_out.items()}}
             for k in WRAPPERS}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source, "replaces": replaces[k],
         # every path's counted run together (each path with the counts
         # zeroed just before it), launches_by_variant path by path
         "launches": sum(sum(by.values()) for by in paths[k].values()),
         **timed[MAIN_SHAPE][k], "launches_by_variant": paths[k],
         "launches_by_dtype": {"sweep_two_stage": by_dtype_two_stage[k]},
         "launch_floor_ms": launch_floor,
         "at_shapes": [{"B": B, "n": n, "dtype": str(dt).replace("torch.", ""), **timed[
             (B, n, dt)][k]} for (B, n, dt) in TIMED_SHAPES if (B, n, dt) != MAIN_SHAPE]}
        for k in ("lane_cholesky", "lane_cho_solve")
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
