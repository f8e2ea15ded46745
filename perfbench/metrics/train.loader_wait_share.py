"""Share of the window in which the step waited for the harness's feed
thread to make its batch, in %: it stays near 0 while the traffic generator
never sets the pace."""


def read(run):
    return 100.0 * run.loader_wait_s / run.window_s if run.window_s > 0 else None
