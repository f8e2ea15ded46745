"""CUDA-event ms a batch around ``MickeyRelativePose.estimate`` (draws,
minimal solves, K3, refinements)."""

SPANS = {"solver": "model:estimate"}


def read(run):
    ms = run.device_ms("solver")
    return None if ms is None or not run.batches else ms / run.batches
