"""CUDA-event ms a batch around ``MickeyRelativePose.match_feats`` (K2a,
K2b and the top-P glue)."""

SPANS = {"matcher": "model:match_feats"}


def read(run):
    ms = run.device_ms("matcher")
    return None if ms is None or not run.batches else ms / run.batches
