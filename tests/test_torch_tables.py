"""Port parity: data tables (``ops/tables.py``), against the JAX package's.

The same seeded knots, values and points go through ``lpopc_tpu.ops.tables``
and ``lpopc_tpu_torch.ops.tables``: values, first derivatives
(``torch.func.jacfwd`` against ``jax.grad``) and second derivatives
(``torch.func.hessian`` against ``jax.hessian``), each under ``vmap`` as the
model functions are lifted in ``core/structured.py``, inside and outside the
knot range, to 1e-13 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, vmap

from lpopc_tpu.ops import tables as ref_tables
from lpopc_tpu_torch.ops import tables as port_tables
from lpopc_tpu_torch.utils.convert import spline_from_reference

REL_TOL = 1e-13
# knot counts: the 2-knot table (one cell, zero curvature), the 3-knot one
# (one interior knot), and a many-knot one on uneven knots
KNOTS = (2, 3, 9)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def knots(n, seed, lo=0.0, hi=5.0):
    rng = np.random.default_rng(seed)
    return np.sort(np.concatenate([[lo, hi], rng.uniform(lo, hi, n - 2)]))


def tables_1d(n):
    xs = knots(n, seed=n)
    ys = np.sin(xs) + 0.1 * xs ** 2
    return ref_tables.Spline1D.fit(xs, ys), port_tables.Spline1D.fit(xs, ys), xs


def tables_2d(n):
    xs, ys = knots(n, seed=n), knots(max(n - 1, 2), seed=100 + n, lo=-1.0, hi=1.0)
    z = np.cos(xs)[:, None] * np.exp(ys)[None, :] + 0.3 * xs[:, None] * ys[None, :] ** 2
    return ref_tables.Spline2D.fit(xs, ys, z), port_tables.Spline2D.fit(xs, ys, z), (xs, ys)


def points(lo, hi, count, seed):
    """Seeded points over the knot range and a margin of 20 % on each side
    (the end cubics' continuation), plus the knots' ends themselves."""
    rng = np.random.default_rng(seed)
    span = hi - lo
    return np.concatenate([rng.uniform(lo - 0.2 * span, hi + 0.2 * span, count), [lo, hi]])


# each case: a scalar function of a 2-vector through the tables, so that
# grad and hessian have cross terms (a 1-D table of a product, a 2-D table)
def cases(n):
    r1, p1, xs = tables_1d(n)
    r2, p2, (gx, gy) = tables_2d(n)
    pts = np.stack([points(xs[0], xs[-1], 24, seed=n),
                    points(gy[0], gy[-1], 24, seed=n + 1)], axis=1)
    ref_f = {"1d": lambda v: r1(v[0] * (1.0 + 0.1 * v[1])),
             "2d": lambda v: r2(v[0], v[1]) * (1.0 + r1(v[0]))}
    port_f = {"1d": lambda v: p1(v[0] * (1.0 + 0.1 * v[1])),
              "2d": lambda v: p2(v[0], v[1]) * (1.0 + p1(v[0]))}
    return ref_f, port_f, pts


@pytest.mark.parametrize("order", ["value", "gradient", "hessian"])
@pytest.mark.parametrize("dim", ["1d", "2d"])
@pytest.mark.parametrize("n", KNOTS)
def test_matches_reference_under_vmap(n, dim, order):
    ref_f, port_f, pts = cases(n)
    rf, pf = ref_f[dim], port_f[dim]
    ref_op = {"value": rf, "gradient": jax.grad(rf), "hessian": jax.hessian(rf)}[order]
    port_op = {"value": pf, "gradient": jacfwd(pf), "hessian": hessian(pf)}[order]
    want = np.asarray(jax.jit(jax.vmap(ref_op))(jnp.asarray(pts)))
    got = vmap(port_op)(torch.as_tensor(pts)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("n", KNOTS)
def test_array_call_matches_reference(n):
    """A call with an array evaluates elementwise and keeps the shape."""
    r1, p1, xs = tables_1d(n)
    r2, p2, (gx, gy) = tables_2d(n)
    x = points(xs[0], xs[-1], 12, seed=7).reshape(2, 7)
    y = points(gy[0], gy[-1], 12, seed=8).reshape(2, 7)
    got1 = p1(torch.as_tensor(x))
    got2 = p2(torch.as_tensor(x), torch.as_tensor(y))
    assert got1.shape == got2.shape == x.shape
    assert rel_err(got1.numpy(), r1(jnp.asarray(x))) <= REL_TOL
    assert rel_err(got2.numpy(), r2(jnp.asarray(x), jnp.asarray(y))) <= REL_TOL


BAD_FITS = {
    "1d_shape": ("Spline1D", ([0.0, 1.0, 2.0], [0.0, 1.0])),
    "1d_2d_knots": ("Spline1D", (np.zeros((2, 2)), np.zeros((2, 2)))),
    "1d_one_knot": ("Spline1D", ([0.0], [1.0])),
    "1d_not_increasing": ("Spline1D", ([0.0, 2.0, 1.0], [0.0, 1.0, 2.0])),
    "1d_repeated_knot": ("Spline1D", ([0.0, 1.0, 1.0], [0.0, 1.0, 2.0])),
    "2d_grid_shape": ("Spline2D", ([0.0, 1.0, 2.0], [0.0, 1.0], np.zeros((2, 3)))),
    "2d_x_not_increasing": ("Spline2D", ([0.0, 2.0, 1.0], [0.0, 1.0], np.zeros((3, 2)))),
    "2d_y_not_increasing": ("Spline2D", ([0.0, 1.0], [1.0, 0.0], np.zeros((2, 2)))),
}


@pytest.mark.parametrize("case", sorted(BAD_FITS))
def test_validation_errors_match_reference(case):
    cls, args = BAD_FITS[case]
    with pytest.raises(ValueError) as ref_err:
        getattr(ref_tables, cls).fit(*args)
    with pytest.raises(ValueError) as port_err:
        getattr(port_tables, cls).fit(*args)
    assert str(port_err.value) == str(ref_err.value)


def test_exact_on_linear_and_bilinear_data():
    xs = knots(7, seed=3)
    ys = knots(5, seed=4, lo=-2.0, hi=3.0)
    p1 = port_tables.Spline1D.fit(xs, 2.5 * xs - 1.0)
    p2 = port_tables.Spline2D.fit(xs, ys, 1.0 + 2.0 * xs[:, None] - 0.5 * ys[None, :]
                                  + 0.25 * xs[:, None] * ys[None, :])
    x = torch.as_tensor(points(xs[0], xs[-1], 40, seed=5))
    y = torch.as_tensor(points(ys[0], ys[-1], 40, seed=6))
    np.testing.assert_allclose(p1(x).numpy(), (2.5 * x - 1.0).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(p2(x, y).numpy(), (1.0 + 2.0 * x - 0.5 * y + 0.25 * x * y).numpy(),
                               rtol=0, atol=1e-12)
    # and the second derivatives vanish (a natural spline of a line is the line)
    assert float(p1.ms.abs().max()) < 1e-12 and float(p2.mxy.abs().max()) < 1e-12


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_spline_from_reference_equals_the_ports_fit(dim):
    ref, port, _ = (tables_1d if dim == "1d" else tables_2d)(9)
    carried = spline_from_reference(ref)
    assert type(carried) is type(port)
    names = ("xs", "ys", "ms") if dim == "1d" else ("xs", "ys", "z", "mx", "my", "mxy")
    for name in names:
        got, want = getattr(carried, name), getattr(port, name)
        assert got.dtype == torch.float64
        assert rel_err(got.numpy(), want.numpy()) <= REL_TOL, name
    x = torch.as_tensor(points(0.0, 5.0, 16, seed=9))
    y = torch.as_tensor(points(-1.0, 1.0, 16, seed=10))
    args = (x,) if dim == "1d" else (x, y)
    assert rel_err(carried(*args).numpy(), port(*args).numpy()) <= REL_TOL


def test_coefficients_follow_the_argument_dtype_and_scalars():
    """A float32 argument gets float32 coefficients (cached per device and
    dtype); python numbers and integer tensors evaluate in float64."""
    _, p1, xs = tables_1d(9)
    x64 = torch.as_tensor(points(xs[0], xs[-1], 8, seed=11))
    got32 = p1(x64.to(torch.float32))
    assert got32.dtype == torch.float32
    assert rel_err(got32.double().numpy(), p1(x64).numpy()) < 1e-5
    assert p1(2).dtype == torch.float64 and p1(torch.tensor(2)).dtype == torch.float64
    assert float(p1(2.0)) == float(p1(torch.tensor(2)))
    assert {k[1] for k in p1._copies} == {torch.float32, torch.float64}
