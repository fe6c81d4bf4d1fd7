"""Port parity: LGR collocation operators (lpopc_tpu_torch.ops.lgr vs lpopc_tpu.ops.lgr).

Both are host numpy in extended precision; they must agree to 1e-14."""

import numpy as np
import pytest

from lpopc_tpu.ops import lgr as ref
from lpopc_tpu_torch.ops import lgr as port

TOL = 1e-14  # same algorithm, same long-double backend: rounding only


@pytest.mark.parametrize("n", range(2, 17))
def test_nodes_weights_match(n):
    x_r, w_r = ref.lgr_nodes_weights(n)
    x_p, w_p = port.lgr_nodes_weights(n)
    np.testing.assert_allclose(x_p, x_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(w_p, w_r, rtol=0, atol=TOL)
    assert x_p[0] == -1.0 and abs(w_p.sum() - 2.0) < 1e-13


@pytest.mark.parametrize("n", range(2, 17))
def test_segment_matrices_match(n):
    for a_p, a_r in zip(port.segment_matrices(n), ref.segment_matrices(n)):
        # D entries grow like n^2: compare relative to the largest entry
        scale = max(1.0, np.abs(a_r).max())
        np.testing.assert_allclose(a_p, a_r, rtol=0, atol=TOL * scale)


def test_composite_segment_ops_match():
    degrees, fractions = (3, 6, 4), (-1.0, -0.2, 0.5, 1.0)
    p = port.make_segment_ops(degrees, fractions)
    r = ref.make_segment_ops(degrees, fractions)
    for name in ("tau", "tau_state", "w", "D"):
        np.testing.assert_allclose(getattr(p, name), getattr(r, name), rtol=0, atol=1e-13)
    assert p.seg_starts == r.seg_starts
    assert port.uniform_mesh(3, 5) == ref.uniform_mesh(3, 5)
    np.testing.assert_allclose(
        port.barycentric_weights(np.array([-1.0, 0.1, 0.7])),
        ref.barycentric_weights(np.array([-1.0, 0.1, 0.7])), rtol=1e-15)


def test_native_library_builds_outside_the_reference_package():
    port.lgr_nodes_weights(5)
    assert port._build_dir().replace("\\", "/").endswith("lpopc_tpu_torch/build")
