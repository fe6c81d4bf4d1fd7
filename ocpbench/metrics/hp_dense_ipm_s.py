"""hp_dense_ipm_s: per hp solve in the window, the IPM wall time of its
grids below the block-KKT threshold (the dense route, K1 and K2)."""


def read(r):
    if r.mode != "hp" or not r.answers:
        return None
    return sum(g["wall_s"] for s in r.answers for g in s["grid_stats"]
               if g["n"] < r.block_threshold) / len(r.answers)
