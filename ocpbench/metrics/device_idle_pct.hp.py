"""device_idle_pct.hp: the share of the traced hp solve's wall time in
which no operation ran on the device."""


def read(r):
    p = r.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s) if r.mode == "hp" and p else None
