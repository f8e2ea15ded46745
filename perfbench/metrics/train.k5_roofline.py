"""K5's share of its roofline, in %: the least time of the dual softmax's
backward (both launches: the correlation for the row and column sums, then
the three products of the gradients, all at fp32 accuracy, 165 TFLOP/s,
against their bytes) at each profiled backward's shape, over the profiled
device time of its kernels (``corr_bwd_kernel``, its transposed copy's
prep and its column fold)."""

import re

from perfbench.harness import bounds

SPANS = {"k5": "mickey_tpu_torch.ops.fused_matcher:dual_softmax_bwd_sums"}
KERNEL = re.compile(r"(^|\W)(corr_bwd_kernel|split_desc_t_kernel|col_partials_kernel)(\W|$)")


def read(run):
    calls = [c for c in run.spans.get("k5", []) if c.profiled]
    t = sum(s for name, s in run.profile.kernels.items() if KERNEL.search(name))
    if not calls or t <= 0:
        return None
    # dual_softmax_bwd_sums(dsc0, dsc1, g, lse_row, lse_col, inv_temp, split)
    return 100.0 * sum(bounds.dual_softmax_bwd_s(c.args[0][0], c.args[1][0]) for c in calls) / t
