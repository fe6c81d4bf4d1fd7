"""Instance-axis batching of IPM solves.

The reference C++ library is strictly single-process/single-thread; its
throughput story is 1/wall-clock. The scale-out here is an *instance axis*:
hundreds to thousands of perturbed problem instances (different initial
states, targets, pinned parameters) solve in lockstep on one GPU.

Because the IPM takes its bounds as runtime inputs, a perturbed-instance sweep
is pure data parallelism: every instance shares the solver; per-instance
``status`` keeps diverged instances from poisoning the batch. The solver
itself carries the batch dimension (see :mod:`..core.ipm`), so this module
only transcribes, scales and binds.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, e.g. from
:func:`default_mesh`) the instance axis is split over the mesh's ranks: one
rank drives one GPU, and a mesh of n ranks is n processes, each of which
calls ``run`` with the same global inputs. Each rank solves its contiguous
slice of the instances with no collective during the solve, and one
``all_gather`` per result field then gives every rank the full result — what
the JAX package's globally sharded ``run`` returns. In the JAX package the
sharded ``while_loop`` runs until every instance of the global batch is done;
here each rank stops when its own slice is, which changes nothing per
instance, since a frozen instance keeps its result.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad, vjp, vmap

from ..core.ipm import IPMOptions, build_solver
from ..core.problem import Problem
from ..core.scaling import scale_nlp
from ..core.solve import SolveOptions, _bind_fixed_mesh, _kkt_factorizer, _kkt_structured
from ..core.transcribe import transcribe
from ..utils.device import device_mesh, resolve_device


@dataclass
class BatchSolver:
    """A batched solver for one problem family on a fixed mesh.

    ``run(z0, zl, zu, cl, cu)`` takes arrays (tensors, or numpy arrays that
    are moved to the solver's device) with a leading batch axis and returns
    the batched :class:`IPMResult`. Use :meth:`nominal_inputs` to get
    broadcast-ready nominal arrays to perturb.
    """

    problem: Problem
    nlp: object
    scaled: object
    run: Callable
    n: int
    m: int
    ipm_options: IPMOptions = None   # the RESOLVED options the solver runs
    device: object = None
    dtype: object = torch.float64
    solver: Callable = None          # the bound core.ipm solve (carries host_syncs)
    stage1_solver: Callable = None   # two_stage: the float32 stage's solve, else None
    # the same solve of this rank's own instances, with no collective (what
    # ``run`` calls on its slice under ``mesh=``; ``run`` itself otherwise)
    run_local: Callable = None

    def nominal_inputs(self, batch: int):
        s = self.scaled
        tile = lambda a: np.broadcast_to(np.asarray(a), (batch,) + np.asarray(a).shape).copy()
        return (tile(s.z0), tile(s.zl), tile(s.zu), tile(s.cl), tile(s.cu))

    def _pin_sensitivities(self, res, rows: slice):
        """dJ*/d(b) per instance for PINNED variables in ``rows`` — the
        envelope theorem: the optimum moves by ∂L/∂z_i db when an equality
        pin shifts, and for a fixed variable that multiplier is the reduced
        gradient (∇f + Jᵀλ)_i at the solution (the IPM masks fixed rows out
        of the bound-dual system entirely). One vmapped AD evaluation of the
        UNSCALED NLP functions on the solver's device per call — no extra
        solves. NaN where the variable is not pinned. ``res`` is any object
        with batched ``z`` and ``lam`` (tensors or arrays, scaled space)."""
        if not hasattr(self, "_sens_fn"):
            obj, con = self.nlp.objective, self.nlp.constraints

            def reduced_grad(z, lam):
                _, vjp_c = vjp(con, z)
                return grad(obj)(z) + vjp_c(lam)[0]

            self._sens_fn = vmap(reduced_grad)
        def t(a):
            return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                                   device=self.device, dtype=self.dtype)

        z_raw = t(res.z) / t(self.scaled.var_scale)[None, :]
        lam_raw = t(res.lam) * t(self.scaled.con_scale / self.scaled.obj_scale)[None, :]
        sens = self._sens_fn(z_raw, lam_raw).detach().cpu().numpy()[:, rows]
        pinned = (self.nlp.zu[rows] - self.nlp.zl[rows]) < 1e-12
        return np.where(pinned[None, :], sens, np.nan)

    def x0_sensitivities(self, res, phase: int = 0):
        """(batch, nx) objective sensitivities dJ*/dx0 for pinned initial
        states — the MPC/value-function gradient, read off the duals."""
        pl = self.nlp.layout.phases[phase]
        return self._pin_sensitivities(
            res, slice(pl.var_offset, pl.var_offset + pl.nx)
        )

    def q_sensitivities(self, res, phase: int = 0):
        """(batch, nq) design sensitivities dJ*/dq for pinned static
        parameters (design variables frozen by equal bounds)."""
        pl = self.nlp.layout.phases[phase]
        return self._pin_sensitivities(res, pl.q_slice)

    def perturb_x0(self, batch: int, phase: int, deltas: np.ndarray):
        """Nominal inputs with the phase-``phase`` initial state shifted by
        ``deltas`` (batch, nx) — the canonical MPC/perturbation sweep input.

        Only states with equal lower/upper bounds (pinned x0) are shifted.
        """
        z0, zl, zu, cl, cu = self.nominal_inputs(batch)
        pl = self.nlp.layout.phases[phase]
        nx = pl.nx
        var_scale = self.scaled.var_scale[pl.var_offset : pl.var_offset + nx]
        d = np.asarray(deltas) * var_scale[None, :]
        sl = slice(pl.var_offset, pl.var_offset + nx)
        pinned = (zu[:, sl] - zl[:, sl]) < 1e-12
        zl[:, sl] = np.where(pinned, zl[:, sl] + d, zl[:, sl])
        zu[:, sl] = np.where(pinned, zu[:, sl] + d, zu[:, sl])
        # only shift the warm start where the bounds actually moved
        z0[:, sl] = np.where(pinned, z0[:, sl] + d, z0[:, sl])
        return z0, zl, zu, cl, cu


def make_batch_solver(
    problem: Problem,
    options: SolveOptions = SolveOptions(),
    mesh=None,
    donate: bool = False,
    two_stage: bool = False,
    stage1_tol: float = 1e-3,
    stage1_max_iter: int = 40,
    *,
    device=None,
    dtype=torch.float64,
) -> BatchSolver:
    """Build the batched IPM solver of ``problem`` on its current mesh.

    ``device=None`` means ``"cuda"``: without a CUDA device this raises, it
    never carries on on the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels (the tests do).

    ``two_stage=True`` runs each instance through a **mixed-precision
    cascade**: stage 1 is the SAME interior-point method run entirely in
    float32 down to ``stage1_tol`` (at most ``stage1_max_iter``
    iterations, ``factor_dtype="f32"``); stage 2 re-runs the ``dtype``
    solver warm-started from stage 1's primal/dual point (z, λ, z_L/z_U, and
    μ from the carried complementarity) for the last Newton iterations to
    the full tolerance; ``iterations`` is the sum of both. The f32 stage
    cannot run the endgame itself: near the solution the condensed K's
    condition number grows like O(1/μ) past f32's ~1/eps ≈ 1.7e7, and the
    factorization-divergence inertia test (correctly) rejects every step.
    Both stages share one scaling, computed once in ``dtype`` (stage 1's
    functions are the same transcription in float32 under the same scale
    vectors). The JAX package has the cascade because f64 is emulated on a
    TPU; whether it pays where f64 is native is a measurement, not a
    default.

    ``mesh`` (a ``DeviceMesh`` of any axis names) splits the instance axis
    over all its ranks, in mesh order (module docstring): the batch must
    divide the number of ranks, every rank passes the same global inputs
    and gets the whole result, and warm bound duals raise ``ValueError``,
    as in the JAX package.

    ``donate=True`` is the JAX package's ``donate_argnums=(0,)``: ``run``
    may write its result into ``z0``'s storage, and the caller must not
    read ``z0`` afterwards. Here the result's ``z`` IS ``z0`` (the same
    storage, holding the solution; the solver's own buffer is freed), so
    ``z0`` must be a tensor on the solver's device in its dtype with the
    result's shape; anything else raises ``ValueError``.
    """
    from ..core.options import validate

    device = resolve_device(device)
    options = validate(options)
    nlp = transcribe(problem, device=device, dtype=dtype)
    scaled = scale_nlp(
        nlp.objective, nlp.constraints, nlp.zl, nlp.zu, nlp.cl, nlp.cu, nlp.z0,
        enabled=options.auto_scale, variable_scaling=options.variable_scaling,
        samples=options.scale_samples, device=device, dtype=dtype,
    )
    # the block path (n >= block_kkt_threshold under "auto", or "on") runs on
    # the per-node blocks alone: the dense assemblers are then not built
    sk = _kkt_structured(problem, nlp, options)

    def bind(nlp_d, scaled_d, dt):
        """(jac_fn, hess_fn, kkt_factorizer, structured_kkt) in ``dt``."""
        if sk is not None:
            return None, None, None, _bind_fixed_mesh(sk, nlp_d, scaled_d, device, dt)
        jac_fn = hess_fn = None
        if getattr(options, "structured_derivatives", True):
            from ..core.structured import make_structured_hessian, make_structured_jacobian

            jac_fn, hess_fn = scaled_d.wrap_structured(
                make_structured_jacobian(
                    problem, nlp_d.layout, nlp_d.ops, device=device, dtype=dt),
                make_structured_hessian(
                    problem, nlp_d.layout, nlp_d.ops,
                    gauss_newton=(options.hessian_approximation == "gauss-newton"),
                    device=device, dtype=dt,
                ),
            )
        return jac_fn, hess_fn, _kkt_factorizer(nlp_d, options), None

    def build(scaled_d, ipm, derivs):
        jac_fn, hess_fn, kkt_fact, bound_sk = derivs
        return build_solver(
            scaled_d.objective, scaled_d.constraints, nlp.n, nlp.m, ipm,
            jac_fn=jac_fn, hess_fn=hess_fn,
            kkt_factorizer=kkt_fact, structured_kkt=bound_sk,
        )

    ipm_base = options.ipm_options()
    if ipm_base.soc is None:
        # Lockstep sweep surface: every instance-iteration pays the
        # second-order-correction cost while the filter accepts first trials
        # essentially always — resolve the surface default OFF here. Pass
        # IPMOptions(soc=True) to force it for hard sweeps.
        ipm_base = replace(ipm_base, soc=False)

    def to_dev(a, dt=dtype):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dt)
        return torch.as_tensor(np.asarray(a), device=device, dtype=dt)

    stage1 = None
    if two_stage:
        f32 = torch.float32
        nlp32 = transcribe(problem, device=device, dtype=f32)
        scaled32 = scaled.rebind(nlp32.objective, nlp32.constraints, f32)
        stage1 = build(scaled32, replace(
            ipm_base, tol=stage1_tol, max_iter=stage1_max_iter,
            factor_dtype="f32", record_history=False,
        ), bind(nlp32, scaled32, f32))
        solver = build(scaled, replace(ipm_base, kappa_1=1e-8), bind(nlp, scaled, dtype))

        def run(z0, zl, zu, cl, cu, lam0=None, zl_d=None, zu_d=None):
            if zl_d is not None:
                raise ValueError("warm bound duals are not supported with two_stage")
            args = [to_dev(a) for a in (z0, zl, zu, cl, cu)]
            r1 = stage1(*(to_dev(a, f32) for a in args), lam0=to_dev(lam0, f32))
            r2 = solver(
                to_dev(r1.z), *args[1:], lam0=to_dev(r1.lam),
                zl_d_init=to_dev(r1.zl_dual), zu_d_init=to_dev(r1.zu_dual),
            )
            return r2._replace(iterations=r1.iterations + r2.iterations)
    else:
        solver = build(scaled, ipm_base, bind(nlp, scaled, dtype))

        def run(z0, zl, zu, cl, cu, lam0=None, zl_d=None, zu_d=None):
            # warm-dual variant (receding-horizon re-solves): zl_d/zu_d carry
            # the bound duals of the previous solve; the IPM then starts mu at
            # the carried complementarity instead of mu_init.
            return solver(
                to_dev(z0), to_dev(zl), to_dev(zu), to_dev(cl), to_dev(cu),
                lam0=to_dev(lam0), zl_d_init=to_dev(zl_d), zu_d_init=to_dev(zu_d),
            )

    run_local = run
    if mesh is not None:
        run = _instance_sharded(run_local, mesh)
    if donate:
        run, run_local = _donating(run, device, dtype), _donating(run_local, device, dtype)
    return BatchSolver(
        problem=problem, nlp=nlp, scaled=scaled, run=run, n=nlp.n, m=nlp.m,
        ipm_options=ipm_base, device=device, dtype=dtype, solver=solver,
        stage1_solver=stage1, run_local=run_local,
    )


def _gather_rows(t, group, size):
    """``t`` of every rank of ``group``, concatenated along the instance axis."""
    if isinstance(t, dict):
        return {k: _gather_rows(v, group, size) for k, v in t.items()}
    if t is None:
        return None
    send = t.contiguous()
    if send.dtype == torch.bool:    # not every backend gathers bool
        send = send.to(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts).to(t.dtype)


def _instance_sharded(run_local, mesh):
    """``run`` over the global batch: this rank's contiguous slice through
    ``run_local``, then one ``all_gather`` per result field over the mesh's
    ranks (in mesh order)."""
    ranks = mesh.mesh.flatten().tolist()
    group = None if ranks == list(range(dist.get_world_size())) else dist.new_group(ranks)
    pos, size = ranks.index(dist.get_rank()), len(ranks)

    def run(z0, zl, zu, cl, cu, lam0=None, zl_d=None, zu_d=None):
        if zl_d is not None:
            raise ValueError("warm bound duals are not supported with two_stage/mesh")
        batch = z0.shape[0]
        if batch % size:
            raise ValueError(f"the batch of {batch} instances does not divide the mesh's "
                             f"{size} ranks")
        rows = slice(pos * batch // size, (pos + 1) * batch // size)
        res = run_local(*(a[rows] for a in (z0, zl, zu, cl, cu)),
                        lam0=None if lam0 is None else lam0[rows])
        return type(res)(*(_gather_rows(f, group, size) for f in res))

    return run


def _donating(run, device, dtype):
    """``run`` with its result's ``z`` written into ``z0``'s storage."""
    def donated(z0, *args, **kw):
        if not (isinstance(z0, torch.Tensor) and z0.to(device=device, dtype=dtype) is z0):
            raise ValueError("donate=True needs z0 as a tensor on the solver's device "
                             f"({device}) in its dtype ({dtype})")
        res = run(z0, *args, **kw)
        if res.z.shape != z0.shape:
            raise ValueError(f"donate=True: z0 {tuple(z0.shape)} cannot hold the result "
                             f"{tuple(res.z.shape)}")
        z0.copy_(res.z)
        return res._replace(z=z0)

    return donated


def default_mesh(axis_name: str = "dp", devices=None, *, device=None):
    """1-D ``DeviceMesh`` named ``axis_name`` over the ranks ``devices``
    (default: every rank of the default process group). ``device`` (``None``
    means ``"cuda"``, and raises without one) picks the mesh's device type."""
    device = resolve_device(device)   # before any process-group call
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    return device_mesh(device, ranks, (axis_name,))


def instance_grid_mesh(n_dp: int, n_sp: int, devices=None, *, device=None):
    """2D mesh for large sweeps: the instance grid is split over both axes
    (``("dp", "sp")``, the first ``n_dp * n_sp`` ranks of ``devices``)."""
    device = resolve_device(device)   # before any process-group call
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    grid = np.asarray(ranks[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return device_mesh(device, grid.tolist(), ("dp", "sp"))
