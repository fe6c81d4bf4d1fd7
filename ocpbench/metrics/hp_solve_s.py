"""hp_solve_s: the window's wall time over the hp-adaptive solves it
completed to the mesh tolerance (a solve that stopped short of it counts
in ``failed``, and as none here)."""


def read(r):
    return r.window_s / r.solved if r.mode == "hp" and r.solved else None
