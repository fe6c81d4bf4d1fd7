"""device_idle_pct.sweep: the share of the traced sweeps' wall time in
which no operation ran on the device."""


def read(r):
    p = r.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s) if r.mode == "sweep" and p else None
