"""K2b's share of its roofline, in %: the least time of ``pair_topk``'s
function at each profiled launch's shape (one correlation at fp32 accuracy,
165 TFLOP/s, against its bytes) over the profiled device time of its
kernels (the sweep, and the fold and merge where it runs in column chunks)."""

import re

from perfbench.harness import bounds

SPANS = {"k2b": "mickey_tpu_torch.ops.fused_matcher:pair_topk"}
KERNEL = re.compile(r"(^|\W)topk_(combine_|merge_)?kernel(\W|$)")


def read(run):
    calls = [c for c in run.spans.get("k2b", []) if c.profiled]
    t = sum(s for name, s in run.profile.kernels.items() if KERNEL.search(name))
    if not calls or t <= 0:
        return None
    # pair_topk(dsc0, dsc1, scr0, scr1, lse_col, inv_temp, alpha, row_topl, split)
    least = sum(bounds.pair_topk_s(c.args[0][0], c.args[1][0], c.args[7], c.args[0][1].itemsize) for c in calls)
    return 100.0 * least / t
