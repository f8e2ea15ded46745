"""K1's share of its roofline, in %: the least time of the function at each
profiled launch's shape (bf16 products at 989 TFLOP/s against its bytes at
3.35 TB/s) over the profiled device time of its kernel."""

import re

from perfbench.harness import bounds

SPANS = {"k1": "mickey_tpu_torch.nn.dinov2:flash_attention_packed"}
KERNEL = re.compile(r"(^|\W)flash_kernel(\W|$)")


def read(run):
    calls = [c for c in run.spans.get("k1", []) if c.profiled]
    t = sum(s for name, s in run.profile.kernels.items() if KERNEL.search(name))
    if not calls or t <= 0:
        return None
    least = sum(bounds.attention_s(c.args[0][0], c.args[1], 2 if c.args[0][1].itemsize == 2 else 4) for c in calls)
    return 100.0 * least / t
