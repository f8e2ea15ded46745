"""CUDA-event ms a batch around ``nn.extractor.backbone_features`` (the
DINOv2 pass of the queries and of each new keyframe, K1)."""

SPANS = {"backbone": "mickey_tpu_torch.models.relative_pose:backbone_features"}


def read(run):
    ms = run.device_ms("backbone")
    return None if ms is None or not run.batches else ms / run.batches
