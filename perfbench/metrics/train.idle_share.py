"""Share of the traced window in which no operation ran on the card, in %
(1 minus the union of the profiled device intervals over the window)."""


def read(run):
    p = run.profile
    return None if p.window_s <= 0 or p.busy_s <= 0 else 100.0 * (1.0 - p.busy_s / p.window_s)
