"""lane_cho_solve_roofline: K2's share of its roofline in the traced calls,
as for K1."""

from ocpbench import roofline


def read(r):
    return roofline.share(r, "lane_cho_solve")
