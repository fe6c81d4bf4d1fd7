"""lane_cholesky_roofline: K1's share of its roofline in the traced calls:
its calls times the least time one call of (batch, n) could take, over the
device time of K1's kernels."""

from ocpbench import roofline


def read(r):
    return roofline.share(r, "lane_cholesky")
