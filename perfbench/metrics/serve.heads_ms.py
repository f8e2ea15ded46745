"""CUDA-event ms a batch around ``nn.extractor.heads_apply`` (the four
heads: fp32 convs and linear attention)."""

SPANS = {"heads": "mickey_tpu_torch.models.relative_pose:heads_apply"}


def read(run):
    ms = run.device_ms("heads")
    return None if ms is None or not run.batches else ms / run.batches
