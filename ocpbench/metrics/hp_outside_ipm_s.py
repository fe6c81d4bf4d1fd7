"""hp_outside_ipm_s: per hp solve in the window, its wall time less the
IPM runs of its grids (``grid_stats[*].wall_s``): transcription, scaling,
derivative tables, error estimates and refinement."""


def read(r):
    if r.mode != "hp" or not r.answers:
        return None
    return sum(s["wall_s"] - sum(g["wall_s"] for g in s["grid_stats"])
               for s in r.answers) / len(r.answers)
