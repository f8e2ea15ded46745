"""Host ms a batch to enqueue ``MickeyRelativePose.estimate``, no
synchronisation in it: the solver's eager launches."""

SPANS = {"solver": "model:estimate"}


def read(run):
    ms = run.host_ms("solver")
    return None if ms is None or not run.batches else ms / run.batches
