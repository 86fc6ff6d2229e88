"""device.idle_pct: the share (%) of the traced window in which no
operation ran on the card, from the union of the profiler's device
intervals."""


def read(run):
    p = run.profile
    if p is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / run.window_s)
