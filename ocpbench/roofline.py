"""Peaks of the card and the work of the program's two kernels: the frozen
copy of ``chip_smoke.py``'s ``bound_time`` and its byte and operation counts.

Peaks of one H100 SXM (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM;
67 TFLOP/s in float64 on the tensor cores (K1's trailing update runs there
on ``mma.sync`` f64) and 67 TFLOP/s in float32 outside them. K1 factors
a batch (B, n, n) of symmetric matrices: it reads one triangle and writes
the whole factor, n^3/3 multiply-adds a matrix. K2 solves L L^T x = b: it
reads one triangle, b and x, 2 n^2 operations a system.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 67e12, 4: 67e12}       # by element size in bytes

# the program's kernel names, as the device trace shows them
KERNELS = {
    "lane_cholesky": ("lane_cholesky_kernel", "cholesky_copy_lower_kernel",
                      "cholesky_panel_kernel", "cholesky_syrk_kernel"),
    "lane_cho_solve": ("lane_cho_solve_kernel", "lane_cho_solve_global_kernel"),
}


def bound_s(bytes_moved: float, flops: float, elem_size: int):
    """The least time the card could take, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[elem_size]
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def work(kernel: str, B: int, n: int, elem_size: int):
    """(bytes, operations) of one call of ``kernel`` on a batch (B, n)."""
    tri = B * n * (n + 1) // 2
    if kernel == "lane_cholesky":
        return (tri + B * n * n) * elem_size, B * n ** 3 / 3.0
    if kernel == "lane_cho_solve":
        return (tri + 2 * B * n) * elem_size, 2.0 * B * n * n
    raise KeyError(kernel)


def is_kernel(kernel: str, name: str) -> bool:
    """Whether the device trace's ``name`` is one of ``kernel``'s kernels."""
    return any(k in name for k in KERNELS[kernel])


def share(r, kernel: str):
    """``kernel``'s share of its roofline, in %, over a traced run's calls
    (``None`` where the trace holds none of its kernels)."""
    p = r.profile
    if p is None or r.mode != "sweep":
        return None
    calls = p.counters.get(kernel, 0)
    t = p.kernel_seconds(lambda name: is_kernel(kernel, name))
    if not calls or t <= 0:
        return None
    least, _ = bound_s(*work(kernel, r.batch, r.n, r.elem_size), r.elem_size)
    return 100.0 * calls * least / t
