"""The yardstick's arithmetic: published peaks of one H100 SXM and the least
time the card could take for a kernel's function or a whole step, from
shapes alone.

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): bf16 products at
989 TFLOP/s; products held to fp32 accuracy at 165 TFLOP/s, a third of
TF32's 495 (three TF32 passes, or six bf16 ones, are the least that reach
fp32, whatever implements them); other fp32 work at 67 TFLOP/s; memory at
3.35 TB/s. A bound is the larger of operations over their peak and bytes
over the memory rate, each input byte read once and each output byte
written once (``chip_smoke.py``'s ``kernel_bounds``, restated at these
rates: three TF32 passes at 495 are one pass at 165).
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_FP32_ACCURATE = 495e12 / 3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


def attention_s(qkv_shape, heads: int, itemsize: int, peak: float = PEAK_BF16) -> float:
    """K1's function on a packed (images, seq, 3C) qkv: QK^T and PV, 4 S^2 D
    flops a head, against qkv read and the (images, seq, C) output written."""
    imgs, seq, c3 = qkv_shape
    d = c3 // 3 // heads
    return bound_s(4.0 * imgs * heads * seq * seq * d, (imgs * seq * c3 + imgs * seq * heads * d) * itemsize, peak)


def pair_topk_s(dsc0_shape, dsc1_shape, topl: int, itemsize: int = 4) -> float:
    """K2b's function: one correlation (2 B M N C) at fp32 accuracy, against
    the descriptors, both keypoint scores and lse_col read, and the (B, L, M)
    values and indices, the row statistics and lse_row written."""
    b, m, c = dsc0_shape
    n = dsc1_shape[1]
    nbytes = (b * m * c + b * n * c) * itemsize + (b * m + 2 * b * n + 2 * b * topl * m + 4 * b * m) * 4
    return bound_s(2.0 * b * m * n * c, nbytes, PEAK_FP32_ACCURATE)


def dual_softmax_bwd_s(dsc0_shape, dsc1_shape) -> float:
    """K5's function, both launches: the correlation recomputed once for the
    sums and the three products of the gradients (s, dS dsc1, dS^T dsc0),
    all at fp32 accuracy, against the descriptors, G (B, M, N), both
    logsumexps read, r, c, dd0, dd1 written."""
    b, m, c = dsc0_shape
    n = dsc1_shape[1]
    nbytes = (2 * (b * m * c + b * n * c) + b * m * n + 4 * b * m + 4 * b * n) * 4
    return bound_s(4 * 2.0 * b * m * n * c, nbytes, PEAK_FP32_ACCURATE)


# -- whole-step operations ---------------------------------------------------------


def vit_flops(tokens: int, width: int, depth: int, ffn_hidden: int, swiglu: bool, patch: int = 14) -> float:
    """One image through the ViT: patch embedding, and per block the qkv,
    attention, projection and feed-forward products (2 flops a multiply-add)."""
    s, c = tokens, width
    ffn = (6.0 if swiglu else 4.0) * s * c * ffn_hidden
    block = 2.0 * s * c * 3 * c + 4.0 * s * s * c + 2.0 * s * c * c + ffn
    return 2.0 * (s - 1) * patch * patch * 3 * c + depth * block


def heads_flops(hw: int, cin: int, block_dims, last_dim: int) -> float:
    """One image's four heads: each head's four residual blocks (two 3x3
    convs, a 1x1 shortcut where the width changes), its three linear-attention
    layers at block_dims[2], and the kp heads' 1x1 output convs."""
    total = 0.0
    for last, out_ch in ((block_dims[3], 1), (block_dims[3], 2), (block_dims[3], 1), (last_dim, 0)):
        dims = [cin] + list(block_dims[:3]) + [last]
        for a, b in zip(dims[:-1], dims[1:]):
            total += 2.0 * hw * 9 * (a * b + b * b) + (2.0 * hw * a * b if a != b else 0.0)
        d = block_dims[2]
        # q, k, v, merge (4 d^2), mlp_fc1 (4 d^2), mlp_fc2 (2 d^2); K^T V and Q (K^T V) over 8 heads
        total += 3 * (2.0 * hw * 10 * d * d + 2 * 2.0 * hw * d * (d // 8))
        total += 2.0 * hw * last * out_ch
    return total


def matcher_flops(m: int, n: int, c: int) -> float:
    """One pair's correlation: the product the dual softmax needs once."""
    return 2.0 * m * n * c


def solver_flops(it: int, n_ransac: int, samples: int) -> float:
    """One pair's hypothesis scoring: ~30 fp32 operations a (hypothesis,
    sample) term; the minimal solves and refinements are lower order."""
    return 30.0 * it * n_ransac * samples


def serve_least_s(cfg, images: int, pairs: int, hw: int, vit) -> float:
    """Least seconds for ``images`` extractions (backbone and heads) and
    ``pairs`` matches and solves, each part at its peak. ``vit``: (width,
    depth, ffn hidden, swiglu)."""
    mk, pc = cfg["MICKEY"], cfg["PROCRUSTES"]
    width, depth, hidden, swiglu = vit
    backbone = vit_flops(hw + 1, width, depth, hidden, swiglu) / PEAK_BF16
    heads = heads_flops(hw, mk["DINOV2"]["CHANNEL_DIM"], mk["KP_HEADS"]["BLOCKS_DIM"],
                        mk["DSC_HEAD"]["LAST_DIM"]) / PEAK_FP32_ACCURATE
    match = matcher_flops(hw, hw, mk["DSC_HEAD"]["LAST_DIM"]) / PEAK_FP32_ACCURATE
    solve = solver_flops(pc["IT_MATCHES"], pc["IT_RANSAC"], pc["NUM_SAMPLED_MATCHES"]) / PEAK_FP32
    return images * (backbone + heads) + pairs * (match + solve)


def train_least_s(cfg, pairs: int, hw: int, vit) -> float:
    """Least seconds for one training step of ``pairs`` pairs: the frozen
    backbone's forward over 2 * pairs images, the heads' forward and
    backward (three times the forward's products), the correlation and the
    two products of its backward, and the loss's hypothesis scoring (its
    minimal solves and refinements are lower order)."""
    mk, gh = cfg["MICKEY"], cfg["LOSS_CLASS"]["GENERATE_HYPOTHESES"]
    width, depth, hidden, swiglu = vit
    backbone = 2 * pairs * vit_flops(hw + 1, width, depth, hidden, swiglu) / PEAK_BF16
    heads = 3 * 2 * pairs * heads_flops(hw, mk["DINOV2"]["CHANNEL_DIM"], mk["KP_HEADS"]["BLOCKS_DIM"],
                                        mk["DSC_HEAD"]["LAST_DIM"]) / PEAK_FP32_ACCURATE
    match = 3 * pairs * matcher_flops(hw, hw, mk["DSC_HEAD"]["LAST_DIM"]) / PEAK_FP32_ACCURATE
    samples = cfg["LOSS_CLASS"]["SAMPLER"]["NUM_SAMPLES_MATCHES"]
    loss = pairs * solver_flops(gh["IT_MATCHES"], gh["IT_RANSAC"], samples) / PEAK_FP32
    return backbone + heads + match + loss
