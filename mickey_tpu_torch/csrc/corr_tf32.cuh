// The matcher's correlation engine: s = X_own X_oth^T * inv_temp on the
// tensor cores, with a logsumexp along the other axis kept in registers. Two
// operand modes (CorrTf32, CorrBf16 below) share everything but the product:
//  - fp32 descriptors at fp32 accuracy, 3xTF32 wgmma on a TF32 split;
//  - bf16 descriptors (cfg.TPU.MATCHER_BF16; the JAX package's bf16 branch of
//    _corr_block, mickey_tpu/ops/fused_matcher.py:57-64), one bf16 wgmma
//    pass with fp32 accumulation, exact for bf16 operands.
// Three forward kernels run on it, in either mode:
//   K2a col_lse (fused_topk.cu): own = dsc1, other = dsc0; per column j the
//       partial (max, sum) of a chunk of dsc0's rows, combined in a fixed
//       order by a second small launch;
//   K4 pair_softmax (dual_softmax.cu): own = dsc0, other = dsc1; sweep 1
//       gives lse_row with the dustbin, sweep 2 recomputes S and writes
//       P = exp(2 s - lse_row - lse_col);
//   K2b pair_topk (fused_topk.cu, topk_kernel): K4's sweeps on K2a's
//       prepared descriptors, sweep 2 keeping each row's top-L instead of
//       writing P.
// The gradient kernels K5 and K6 (dual_softmax.cu, corr_bwd_kernel) run the
// fp32 mode's correlation (issue_corr) and add a second product, dd_own +=
// dS X_oth, with dS as the register A operand (issue_dd) and X_oth^T from a
// transposed copy the prep kernel split_desc_t_kernel writes. Training is
// fp32 in the JAX package too: the bf16 mode has no backward.
//
// Numerics, fp32 mode: every descriptor value x is split once into TF32 hi
// (x truncated) and lo = cvt.rna(x - hi) (split_desc), and a product is three
// passes over the 128 channels, lo*hi, hi*lo and hi*hi, in short
// accumulator chains summed in registers (issue_corr). What is dropped
// (lo*lo, the split's residuals) is ~2^-20 of each term; one TF32 pass alone
// would leave ~1e-3 of logit error at 1/T = 10. bf16 mode: a product of two
// bf16 values is exact in fp32, so one pass of 8 k16 slices is the fp32
// product of the rounded descriptors up to the order of the sums (no split,
// and no special rule for infinities: inf x finite is what fp32 gives). The
// logsumexps run in the exp2 domain (u = s log2 e) with an online max; a
// running max that is infinite is shifted by 0, as torch.logsumexp does, so
// +inf entries give +inf and NaN propagates through the sums.
//
// What bounds it on the H100: fp32 mode, 3 x 2 M N C flops a product
// against reading the descriptors (and, for K4, writing P: 4 M N bytes), so
// operations, at 495 TFLOP/s TF32 (the FFMA bodies this replaces were capped
// by 67 TFLOP/s fp32). bf16 mode: 2 M N C flops at 989 TFLOP/s, a sixth of
// the fp32 mode's tensor time; K4 is then bound by the bytes of P. Design:
//  - a prep kernel lays each descriptor set out once per launch, not once
//    per CTA (each other tile is read by ~M / 64 CTAs), in scratch as
//    [row][128] (channels past C zero): fp32 mode, split into hi and lo, a
//    512-byte row is four 128-byte swizzle rows of 32 values; bf16 mode, a
//    256-byte row is two swizzle rows of 64 values. A tile is loaded through
//    5-D tensor maps (ops/fused_matcher.py::corr_geometry) and lies in
//    shared memory as blocks of 128-byte rows; a k-slice (k8 of TF32, k16 of
//    bf16: 32 bytes either way) is 32 bytes into one block;
//  - one warpgroup owns 64 own rows; their tile (hi and lo, 64 KB; bf16 16
//    KB) stays in shared memory as the A operand of m64n64 wgmma (in
//    registers the fp32 split would take 128 a thread); both operands are
//    [row][c], K-major, so nothing is transposed. The fp32 passes run in
//    independent chains, interleaved slice by slice (one chain of 48 wgmma:
//    K4 0.318 ms; three chains: 0.272, on an H100 SXM at 700 W; PERF.md);
//  - the other set's 64-row tiles come by TMA into a 2-stage mbarrier ring;
//    TMA zero-fills rows past the end, which are then masked to -inf
//    explicitly (a zero score would count);
//  - in the accumulator layout a row lives in 4 neighbouring lanes: the row
//    max takes two shuffles, the sum is a per-thread share until the end;
//    K4 loads a tile's lse_col while its products run and writes P from the
//    accumulator layout, 8 bytes a thread;
//  - fp32 mode: 197 KB of shared memory, one CTA an SM; K2a splits the other
//    axis into chunks so that its few own tiles still fill the card. The bf16
//    mode keeps that grid and those chunks; its 50 KB of shared memory and
//    fewer accumulator registers leave room for more CTAs an SM, which a
//    later change may take.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int CORR_BM = 64;      // own rows per CTA: one warpgroup's wgmma M
constexpr int CORR_BN = 64;      // other rows per ring stage: the wgmma N
constexpr int CORR_C = 128;      // channels in scratch (descriptors of C <= 128 zero-padded)
constexpr int CORR_SPAN = 32;    // fp32 values in one 128-byte swizzle row
constexpr int CORR_STAGES = 2;
constexpr int CORR_NT = 128;     // one warpgroup
constexpr uint32_t CORR_A_PART = CORR_BM * CORR_C * 4;      // own hi or lo
constexpr uint32_t CORR_B_PART = CORR_BN * CORR_C * 4;      // other hi or lo
constexpr uint32_t CORR_A_BLOCK = CORR_BM * CORR_SPAN * 4;  // one 32-channel block of an own tile
constexpr uint32_t CORR_B_BLOCK = CORR_BN * CORR_SPAN * 4;
constexpr uint32_t CORR_STAGE = 2 * CORR_B_PART;
constexpr uint32_t CORR_T_BLOCK = CORR_C * CORR_SPAN * 4;  // 32 other rows of every channel of an X_oth^T tile
constexpr uint32_t CORR_T_PART = CORR_C * CORR_BN * 4;     // an X_oth^T tile, hi or lo
constexpr float CORR_LOG2E = 1.4426950408889634f;
constexpr float CORR_LN2 = 0.6931471805599453f;
// bf16 mode: a [row][128] bf16 row is two 128-byte swizzle rows of 64 values
constexpr int CORR_SPAN_BF16 = 64;
constexpr uint32_t CORR_TILE_BF16 = CORR_BM * CORR_C * 2;          // an own or other tile
constexpr uint32_t CORR_BLOCK_BF16 = CORR_BM * CORR_SPAN_BF16 * 2;  // one 64-channel block of it
static_assert(CORR_BM == CORR_BN, "own and other tiles of one size");

// Timing ablations for `chip_smoke.py --matcher` (wrong results, never in
// the library the port loads): MK_ABLATE_EXP replaces every ex2 by a
// multiply; MK_ABLATE_LOADS computes on the first ring fill and neither
// waits for nor issues another load; MK_ABLATE_1XTF32 runs only the hi*hi
// pass.
#ifdef MK_ABLATE_LOADS
constexpr bool CORR_ABLATE_LOADS = true;
#else
constexpr bool CORR_ABLATE_LOADS = false;
#endif
#ifdef MK_ABLATE_1XTF32
constexpr bool CORR_ONE_PASS = true;
#else
constexpr bool CORR_ONE_PASS = false;
#endif

__device__ __forceinline__ float corr_ex2(float x) {
#ifdef MK_ABLATE_EXP
  return x * 0.5f;
#endif
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The split of a descriptor value: hi = x truncated to TF32 (low 13 bits
// cleared), lo = cvt.rna(x - hi), so x, hi and lo share one sign. lo = 0
// where hi is not finite (inf - inf would be NaN); lo = 2^-126 with x's sign
// where x is a nonzero TF32 value, not 0. Against an infinite value of the
// other set every pass is then an infinity of the fp32 product's sign: a lo
// of the other sign would give inf - inf, a lo of 0 would give 0 * inf, both
// NaN where the fp32 product is +-inf. Against a finite value the 2^-126
// adds nothing an fp32 sum keeps.
__device__ __forceinline__ void split_desc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  const float h = __uint_as_float(hi), r = x - h;
  if (!isfinite(h)) {
    lo = 0u;
  } else if (r == 0.f && h != 0.f) {
    lo = __float_as_uint(copysignf(0x1p-126f, h));
  } else {
    lo = tf32(r);
  }
}

// Rows of x0 (r0 rows, blockIdx.y = 0) or x1 (r1 rows, blockIdx.y = 1), C
// channels each, into scratch [x0 hi | x0 lo | x1 hi | x1 lo], each
// (rows, 128); one thread per 4 channels of a row.
__global__ void __launch_bounds__(256)
split_desc_kernel(const float* __restrict__ x0, const float* __restrict__ x1, float* __restrict__ scratch, int r0,
                  int r1, int C) {
  const bool second = blockIdx.y == 1;
  const float* x = second ? x1 : x0;
  const long long rows = second ? r1 : r0;
  float* hi = scratch + (second ? 2LL * r0 * CORR_C : 0LL);
  float* lo = hi + rows * CORR_C;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = e / (CORR_C / 4);
  const int c0 = static_cast<int>(e % (CORR_C / 4)) * 4;
  if (row >= rows) return;
  float v[4];
  if (C == CORR_C && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4 f = *reinterpret_cast<const float4*>(x + row * CORR_C + c0);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c0 + k < C ? x[row * C + c0 + k] : 0.f;
  }
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) split_desc(v[k], h[k], l[k]);
  *reinterpret_cast<uint4*>(hi + row * CORR_C + c0) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + row * CORR_C + c0) = make_uint4(l[0], l[1], l[2], l[3]);
}

// d (64 x 64 fp32) = or += A (64 x 8 tf32) B^T (64 x 8), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// k8 slice kk of a tile of 32-channel blocks `block` bytes apart: its block
// kk / 4, 32 bytes a slice into the 128-byte rows.
__device__ __forceinline__ uint64_t corr_desc(uint32_t tile, uint32_t block, int kk) {
  return smem_desc(tile + (kk / 4) * block) + 2 * (kk % 4);
}

// The correlation of an own tile (a_hi, a_lo) and an other tile (b_hi, b_lo)
// (raw dot products, 64 x 64) in 1 + kHi accumulator chains: x = lo*hi +
// hi*lo over the 16 k8 slices, h[q] = hi*hi over slices q 16 / kHi onwards.
// The tensor cores' fp32 sums truncate, so every step of a chain shrinks |s|
// a little (a bias, not noise, which exp(2 s) doubles at 1/T = 10); chains of
// 4 steps (kHi = 4) keep it at a quarter of one chain's, and their sum is
// rounded to nearest in registers (corr_sum). x's terms are ~2^-10 of s, so
// its 32 steps do not matter. Slices are interleaved across the chains, so a
// wgmma rarely waits for the one before it (the h chains take their slices
// in turn, so kHi sets the bias, not the overlap). Issues and commits; the
// caller waits.
template <int kHi>
__device__ __forceinline__ void issue_corr(float (&x)[32], float (&h)[kHi][32], uint32_t a_hi, uint32_t a_lo,
                                           uint32_t b_hi, uint32_t b_lo) {
  constexpr int kPer = CORR_C / 8 / kHi;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CORR_C / 8; ++kk) {
    const uint64_t ah = corr_desc(a_hi, CORR_A_BLOCK, kk), bh = corr_desc(b_hi, CORR_B_BLOCK, kk);
    if (!CORR_ONE_PASS) wgmma_ss_n64(x, corr_desc(a_lo, CORR_A_BLOCK, kk), bh, kk != 0);
    wgmma_ss_n64(h[kk / kPer], ah, bh, kk % kPer != 0);
    if (!CORR_ONE_PASS) wgmma_ss_n64(x, ah, corr_desc(b_lo, CORR_B_BLOCK, kk), 1);
  }
  wgmma_commit();
}

// s = x + (the h chains summed pairwise: (h0 + h1) + (h2 + h3)), after the
// products are waited for
template <int kHi>
__device__ __forceinline__ void corr_sum(float (&s)[32], float (&x)[32], float (&h)[kHi][32]) {
  static_assert(kHi == 1 || kHi == 2 || kHi == 4, "pairwise sum of 1, 2 or 4 chains");
  fence_regs(x);
#pragma unroll
  for (int q = 0; q < kHi; ++q) fence_regs(h[q]);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (kHi == 4) {
      s[i] = (h[0][i] + h[1][i]) + (h[2][i] + h[3][i]);
    } else if constexpr (kHi == 2) {
      s[i] = h[0][i] + h[1][i];
    } else {
      s[i] = h[0][i];
    }
    if (!CORR_ONE_PASS) s[i] += x[i];
  }
}

// d (64 x 128 fp32) = or += A (64 x 8 tf32, 4 fragment registers) B^T (128 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// The gradient's product of one other tile, d (64 x 128, a fresh chain) =
// dS X_oth, dS (64 own x 64 other rows) split into TF32 hi / lo fragments in
// registers (fragment k-slice kk holds other rows 8 kk .. 8 kk + 7, k-index
// t4 the row 8 kk + 2 t4 and t4 + 4 the row 8 kk + 2 t4 + 1: the
// accumulator's columns), X_oth^T (t_hi, t_lo: 128 channel rows of 64 other
// rows, two blocks of 32, permuted alike within each 8) from shared memory.
// lo*hi, hi*lo, hi*hi a slice. Issues and commits; the caller waits and adds
// d into its running sum in registers (the tensor cores' sums truncate).
__device__ __forceinline__ void issue_dd(float (&d)[64], const uint32_t (&ah)[32], const uint32_t (&al)[32],
                                         uint32_t t_hi, uint32_t t_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CORR_BN / 8; ++kk) {
    const uint32_t* h = &ah[4 * kk];
    const uint32_t* l = &al[4 * kk];
    const uint64_t th = corr_desc(t_hi, CORR_T_BLOCK, kk);
    if (!CORR_ONE_PASS) {
      wgmma_rs_n128(d, l[0], l[1], l[2], l[3], th, kk != 0);
      wgmma_rs_n128(d, h[0], h[1], h[2], h[3], corr_desc(t_lo, CORR_T_BLOCK, kk), 1);
    }
    wgmma_rs_n128(d, h[0], h[1], h[2], h[3], th, CORR_ONE_PASS ? kk != 0 : 1);
  }
  wgmma_commit();
}

// Position p of each 8 rows of an X^T tile holds row 2 p (p < 4) or
// 2 (p - 4) + 1: the accumulator columns {2 t4, 2 t4 + 1} of a thread are its
// A fragment's k-indices {t4, t4 + 4}, so dS goes from the one to the other
// with no shuffle.
__device__ __forceinline__ int corr_t_row(int p) {
  const int w = p & 7;
  return (p & ~7) + (w < 4 ? 2 * w : 2 * (w - 4) + 1);
}

// The gradient kernels' transposed copies: rows of x0 (r0 rows, blockIdx.z =
// 0) or x1 (r1, blockIdx.z = 1), C channels each, split as split_desc_kernel
// does, into scratch [x0^T hi | x0^T lo | x1^T hi | x1^T lo], each (B, 128,
// rows padded to 64) with channels past C and rows past the end zero and
// each 8 rows permuted (corr_t_row). One block per 64 rows of one image
// (blockIdx.x, blockIdx.y), through a shared-memory transpose.
__global__ void __launch_bounds__(256)
split_desc_t_kernel(const float* __restrict__ x0, const float* __restrict__ x1, float* __restrict__ scratch, int r0,
                    int r1, int C) {
  __shared__ float xs[CORR_BN][CORR_C + 1];
  const bool second = blockIdx.z == 1;
  const float* x = second ? x1 : x0;
  const int rows = second ? r1 : r0;
  const long long pad0 = (r0 + CORR_BN - 1) / CORR_BN * CORR_BN, pad1 = (r1 + CORR_BN - 1) / CORR_BN * CORR_BN;
  const long long pad = second ? pad1 : pad0;
  const int row0 = blockIdx.x * CORR_BN, b = blockIdx.y;
  if (row0 >= pad) return;
  float* hi = scratch + (second ? 2LL * gridDim.y * pad0 * CORR_C : 0LL);
  float* lo = hi + static_cast<long long>(gridDim.y) * pad * CORR_C;
  const float* xb = x + static_cast<long long>(b) * rows * C;
  for (int e = threadIdx.x; e < CORR_BN * CORR_C; e += blockDim.x) {
    const int r = e / CORR_C, c = e % CORR_C;
    xs[r][c] = row0 + r < rows && c < C ? xb[static_cast<long long>(row0 + r) * C + c] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < CORR_C * CORR_BN; e += blockDim.x) {
    const int c = e / CORR_BN, p = e % CORR_BN;
    uint32_t h, l;
    split_desc(xs[corr_t_row(p)][c], h, l);
    const long long at = (static_cast<long long>(b) * CORR_C + c) * pad + row0 + p;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

struct CorrMaps {
  CUtensorMap own_hi, own_lo, oth_hi, oth_lo;  // the bf16 mode reads only the hi maps
};

// bf16 mode's prep: rows of x0 (r0 rows, blockIdx.y = 0) or x1 (r1 rows,
// blockIdx.y = 1), C bf16 channels each, copied bit for bit into scratch
// [x0 | x1], each (rows, 128) with channels past C zero; one thread per 8
// channels of a row.
__global__ void __launch_bounds__(256)
pad_desc_bf16_kernel(const uint16_t* __restrict__ x0, const uint16_t* __restrict__ x1, uint16_t* __restrict__ scratch,
                     int r0, int r1, int C) {
  const bool second = blockIdx.y == 1;
  const uint16_t* x = second ? x1 : x0;
  const long long rows = second ? r1 : r0;
  uint16_t* out = scratch + (second ? static_cast<long long>(r0) * CORR_C : 0LL);
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = e / (CORR_C / 8);
  const int c0 = static_cast<int>(e % (CORR_C / 8)) * 8;
  if (row >= rows) return;
  uint4 v;
  if (C == CORR_C && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    v = *reinterpret_cast<const uint4*>(x + row * CORR_C + c0);
  } else {
    uint16_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = c0 + k < C ? x[row * C + c0 + k] : 0;
    v = make_uint4(h[0] | (uint32_t(h[1]) << 16), h[2] | (uint32_t(h[3]) << 16), h[4] | (uint32_t(h[5]) << 16),
                   h[6] | (uint32_t(h[7]) << 16));
  }
  *reinterpret_cast<uint4*>(out + row * CORR_C + c0) = v;
}

// d (64 x 64 fp32) = or += A (64 x 16 bf16) B^T (64 x 16), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The geometry a C entry receives (ops/fused_matcher.py::corr_geometry):
// the own map then the other map, each dims (5), byte strides (4), box (5),
// innermost first: dims (span, rows, 128 / span, 1, B), box (span, box_rows,
// 128 / span, 1, 1), box_rows 64 either way; span 32 fp32 values or 64 bf16.
inline bool corr_geometry_ok(const long long* g, int B, int rows, int box_rows, int span = CORR_SPAN) {
  return g[0] == span && g[1] == rows && g[2] == CORR_C / span && g[3] == 1 && g[4] == B && g[9] == span &&
         g[10] == box_rows && g[11] == CORR_C / span && g[12] == 1 && g[13] == 1;
}

// Floats of the split descriptors in scratch: [d0 hi | d0 lo | d1 hi | d1 lo],
// each (B rows, 128). K2a's partials follow them.
inline long long corr_split_floats(int B, int M, int N) {
  return 2LL * (static_cast<long long>(B) * M + static_cast<long long>(B) * N) * CORR_C;
}

// The prep kernel: d0 (B, M, C) and d1 (B, N, C) split into scratch
// (corr_split_floats). Returns 0 or a cudaError_t.
inline int corr_split(const float* d0, const float* d1, float* scratch, int B, int M, int N, int C, cudaStream_t st) {
  const long long rows0 = static_cast<long long>(B) * M, rows1 = static_cast<long long>(B) * N;
  const long long most = rows0 > rows1 ? rows0 : rows1;
  split_desc_kernel<<<dim3(static_cast<unsigned>((most * (CORR_C / 4) + 255) / 256), 2), 256, 0, st>>>(
      d0, d1, scratch, static_cast<int>(rows0), static_cast<int>(rows1), C);
  return static_cast<int>(cudaGetLastError());
}

// The hi and lo maps of one split set (`part` floats apart) from its 14-entry geometry.
inline int encode_pair(CUtensorMap* hi, CUtensorMap* lo, const float* split, long long part, const long long* geom) {
  int rc = encode_map(hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, split, geom, geom + 5, geom + 9);
  if (rc == 0) rc = encode_map(lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, split + part, geom, geom + 5, geom + 9);
  return rc;
}

// The operand modes of the forward kernels (corr_fwd_kernel, fused_topk.cu's
// topk_kernel): the bytes of a 64-row tile in shared memory, the span of
// their tensor maps, the prep into scratch, the maps, the TMA load of a
// tile, and the product of an own and an other tile in accumulator chains
// x, h (issue, then sum once the products are waited for). Everything else
// in those kernels is one code for both.
struct CorrTf32 {
  static constexpr uint32_t kTile = 2 * CORR_A_PART;  // hi then lo
  static constexpr int kSpan = CORR_SPAN;
  // the descriptors' split in scratch: corr_split_floats, set 1 after set 0
  static long long scratch_floats(int B, int M, int N) { return corr_split_floats(B, M, N); }
  static int prep(const void* d0, const void* d1, float* scratch, int B, int M, int N, int C, cudaStream_t st) {
    return corr_split(static_cast<const float*>(d0), static_cast<const float*>(d1), scratch, B, M, N, C, st);
  }
  // the maps of set 0 (B M rows) or set 1 (B N rows) of the scratch
  static int encode(CUtensorMap* hi, CUtensorMap* lo, float* scratch, int set, int B, int M, int N,
                    const long long* geom) {
    const long long rows = static_cast<long long>(B) * (set ? N : M);
    return encode_pair(hi, lo, scratch + (set ? corr_split_floats(B, M, 0) : 0LL), rows * CORR_C, geom);
  }
  static __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* hi, const CUtensorMap* lo, uint32_t bar,
                                              int row, int b) {
    mbar_expect_tx(bar, kTile);
    tma_load5(dst, hi, bar, row, 0, 0, b);
    tma_load5(dst + kTile / 2, lo, bar, row, 0, 0, b);
  }
  static __device__ __forceinline__ void issue(float (&x)[32], float (&h)[4][32], uint32_t own, uint32_t oth) {
    issue_corr<4>(x, h, own, own + CORR_A_PART, oth, oth + CORR_B_PART);
  }
  static __device__ __forceinline__ void sum(float (&s)[32], float (&x)[32], float (&h)[4][32]) {
    corr_sum<4>(s, x, h);
  }
};

// bf16 mode: one pass, 8 k16 slices in two interleaved chains of 4 (h[0]
// the even slices, h[1] the odd; x and h[2..3] unused), so a chain is as
// long as the fp32 mode's hi*hi chains and its truncating sums bias s no
// more; the two are added in registers.
struct CorrBf16 {
  static constexpr uint32_t kTile = CORR_TILE_BF16;
  static constexpr int kSpan = CORR_SPAN_BF16;
  // [d0 | d1] as bf16 (B rows, 128), in floats
  static long long scratch_floats(int B, int M, int N) {
    return (static_cast<long long>(B) * M + static_cast<long long>(B) * N) * CORR_C / 2;
  }
  static int prep(const void* d0, const void* d1, float* scratch, int B, int M, int N, int C, cudaStream_t st) {
    const long long rows0 = static_cast<long long>(B) * M, rows1 = static_cast<long long>(B) * N;
    const long long most = rows0 > rows1 ? rows0 : rows1;
    pad_desc_bf16_kernel<<<dim3(static_cast<unsigned>((most * (CORR_C / 8) + 255) / 256), 2), 256, 0, st>>>(
        static_cast<const uint16_t*>(d0), static_cast<const uint16_t*>(d1), reinterpret_cast<uint16_t*>(scratch),
        static_cast<int>(rows0), static_cast<int>(rows1), C);
    return static_cast<int>(cudaGetLastError());
  }
  static int encode(CUtensorMap* hi, CUtensorMap*, float* scratch, int set, int B, int M, int N,
                    const long long* geom) {
    const uint16_t* at =
        reinterpret_cast<const uint16_t*>(scratch) + (set ? static_cast<long long>(B) * M * CORR_C : 0LL);
    return encode_map(hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, at, geom, geom + 5, geom + 9);
  }
  static __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* hi, const CUtensorMap*, uint32_t bar,
                                              int row, int b) {
    mbar_expect_tx(bar, kTile);
    tma_load5(dst, hi, bar, row, 0, 0, b);
  }
  static __device__ __forceinline__ void issue(float (&)[32], float (&h)[4][32], uint32_t own, uint32_t oth) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CORR_C / 16; ++kk)
      wgmma_ss_n64_bf16(h[kk & 1], corr_desc(own, CORR_BLOCK_BF16, kk), corr_desc(oth, CORR_BLOCK_BF16, kk), kk >= 2);
    wgmma_commit();
  }
  static __device__ __forceinline__ void sum(float (&s)[32], float (&)[32], float (&h)[4][32]) {
    fence_regs(h[0]);
    fence_regs(h[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = h[0][i] + h[1][i];
  }
};

// Shared memory of a forward kernel in mode Op: the own tile, the ring, the
// mbarriers, 1024 bytes of alignment slack.
template <class Op>
constexpr size_t corr_smem() {
  return 1024 + (1 + CORR_STAGES) * Op::kTile + 8 * (CORR_STAGES + 1);
}
static_assert(corr_smem<CorrTf32>() <= 232448, "one CTA an SM");

// The shift of an online logsumexp in the exp2 domain: the running max, or
// 0 where it is infinite (as torch.logsumexp), so exp2(u - shift) is never
// exp2(inf - inf).
__device__ __forceinline__ float corr_shift(float m) { return isinf(m) ? 0.f : m; }

// One tile of an online logsumexp along the other axis (K2a's sweep, the
// first sweep of K4 and K2b), in the accumulator layout below: s (raw dot
// products) scaled in place to u = s c, its columns from `valid` on (a
// ragged last tile) set to -inf; the running max m and this thread's share
// l of sum exp2(u - shift) of rows g (m0, l0) and g + 8 (m1, l1) updated.
__device__ __forceinline__ void corr_lse_tile(float (&s)[32], float c, int valid, int t4, float& m0, float& m1,
                                              float& l0, float& l1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = __fmul_rn(s[i], c);  // rounded here whatever else reads u: K4's and K2b's lse_row agree bitwise
    if (valid < CORR_BN && 8 * (i >> 2) + 2 * t4 + (i & 1) >= valid) s[i] = -INFINITY;  // ragged last tile
    if (i & 2) {
      mx1 = fmaxf(mx1, s[i]);
    } else {
      mx0 = fmaxf(mx0, s[i]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float sh0 = corr_shift(mn0), sh1 = corr_shift(mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & 2) {
      sum1 += corr_ex2(s[i] - sh1);
    } else {
      sum0 += corr_ex2(s[i] - sh0);
    }
  }
  // a share that has seen no finite u is 0 (or NaN, which stays NaN)
  l0 = l0 * (m0 == -INFINITY ? 0.f : corr_ex2(corr_shift(m0) - sh0)) + sum0;
  l1 = l1 * (m1 == -INFINITY ? 0.f : corr_ex2(corr_shift(m1) - sh1)) + sum1;
  m0 = mn0;
  m1 = mn1;
}

// The row logsumexps after the last tile, the dustbin folded in as the TPU
// kernel does (alpha2 = alpha log2 e): the shares l summed over the row's
// four lanes, then ln(sum exp(s) + exp(alpha)) of rows g (.x) and g + 8 (.y).
// A row of -inf scores only (sum 0) adds 0, not 0 * exp2(-alpha2), which is
// NaN without a dustbin (alpha2 = -1e30 log2 e): its lse_row is alpha.
__device__ __forceinline__ float2 corr_lse_row(float m0, float m1, float l0, float l1, float alpha2) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float rm0 = fmaxf(m0, alpha2), rm1 = fmaxf(m1, alpha2);
  const float a0 = l0 == 0.f ? 0.f : l0 * exp2f(corr_shift(m0) - rm0);
  const float a1 = l1 == 0.f ? 0.f : l1 * exp2f(corr_shift(m1) - rm1);
  return make_float2((log2f(a0 + exp2f(alpha2 - rm0)) + rm0) * CORR_LN2,
                     (log2f(a1 + exp2f(alpha2 - rm1)) + rm1) * CORR_LN2);
}

// Thread (warp w, lane 4 g + t4) holds accumulator columns 8 j + 2 t4 + {0, 1}
// of rows 16 w + g (registers 4 j, 4 j + 1) and 16 w + g + 8 (4 j + 2,
// 4 j + 3). One CTA owns 64 rows (blockIdx.x) of one image (blockIdx.z).
//   !kPair (K2a): the other rows of chunk blockIdx.y (tiles_per_chunk tiles
//     of 64): part[(b chunks + chunk) n_own + row] = (shift, sum of
//     exp2(u - shift)), u = s log2 e;
//   kPair (K4): all other rows twice: lse_row[b n_own + row] with the
//     dustbin (alpha2 = alpha log2 e) after the first sweep, then
//     out[b][row][col] = exp(2 s - lse_row - lse_col[b][col]).
// Op: the operand mode (CorrTf32, CorrBf16).
template <bool kPair, class Op>
__global__ void __launch_bounds__(CORR_NT, 1)
corr_fwd_kernel(const __grid_constant__ CorrMaps maps, int n_own, int n_oth, int tiles_per_chunk, float c,
                float2* __restrict__ part, const float* __restrict__ lse_col, float* __restrict__ out,
                float* __restrict__ lse_row, float alpha2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t own = base, ring = base + Op::kTile;
  const uint32_t bar0 = ring + CORR_STAGES * Op::kTile, a_bar = bar0 + 8 * CORR_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * CORR_BM, b = blockIdx.z;
  const int all_tiles = (n_oth + CORR_BN - 1) / CORR_BN;
  const int first = kPair ? 0 : blockIdx.y * tiles_per_chunk;
  const int nt = kPair ? all_tiles : min(tiles_per_chunk, all_tiles - first);
  const int total = kPair ? 2 * nt : nt;

  auto load_stage = [&](int t) {
    Op::load(ring + (t % CORR_STAGES) * Op::kTile, &maps.oth_hi, &maps.oth_lo, bar0 + 8 * (t % CORR_STAGES),
             (first + t % nt) * CORR_BN, b);
  };
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st <= CORR_STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    Op::load(own, &maps.own_hi, &maps.own_lo, a_bar, o0, b);
    for (int t = 0; t < CORR_STAGES && t < total; ++t) load_stage(t);
  }
  mbar_wait(a_bar, 0);

  float m0 = -INFINITY, m1 = -INFINITY;  // running max of u, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of sum exp2(u - shift)
  float ar0 = 0.f, ar1 = 0.f;            // K4 sweep 2: -lse_row log2 e of rows g, g + 8
  const int r0 = o0 + 16 * warp + g, r1 = r0 + 8;
  float s[32];
  float x[32], h[4][32];
  const float* lc = lse_col + static_cast<long long>(b) * n_oth;

  for (int t = 0; t < total; ++t) {
    const int st = t % CORR_STAGES;
    if (!CORR_ABLATE_LOADS || t < CORR_STAGES) mbar_wait(bar0 + 8 * st, (t / CORR_STAGES) & 1);
    Op::issue(x, h, own, ring + st * Op::kTile);
    const int j0 = (first + t % nt) * CORR_BN;  // the other row of accumulator column 0
    float bc[16];  // K4's writes: -lse_col log2 e of this thread's columns, loaded under the products
    if (kPair && t >= nt) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = j0 + 8 * (j >> 1) + 2 * t4 + (j & 1);
        bc[j] = col < n_oth ? -lc[col] * CORR_LOG2E : 0.f;
      }
    }
    wgmma_wait();
    Op::sum(s, x, h);

    if (!kPair || t < nt) {
      corr_lse_tile(s, c, n_oth - j0, t4, m0, m1, l0, l1);
      if (kPair && t == nt - 1) {  // lse_row, the dustbin folded in as the TPU kernel does
        const float2 lse = corr_lse_row(m0, m1, l0, l1, alpha2);
        if (t4 == 0 && r0 < n_own) lse_row[static_cast<long long>(b) * n_own + r0] = lse.x;
        if (t4 == 0 && r1 < n_own) lse_row[static_cast<long long>(b) * n_own + r1] = lse.y;
        ar0 = -lse.x * CORR_LOG2E;
        ar1 = -lse.y * CORR_LOG2E;
      }
    } else {
      // P = exp2(2 u - (lse_row + lse_col) log2 e); float2 stores where rows
      // start 8-byte aligned (n_oth even), else scalar
      const float c2 = 2.f * c;
      float* o_r0 = out + (static_cast<long long>(b) * n_own + r0) * n_oth;
      float* o_r1 = o_r0 + 8LL * n_oth;
      const bool pairs = (n_oth & 1) == 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j0 + 8 * j + 2 * t4;
        if (col >= n_oth) continue;
        const bool second = col + 1 < n_oth;
        const float bc0 = bc[2 * j], bc1 = bc[2 * j + 1];
        const float p00 = corr_ex2(fmaf(s[4 * j], c2, ar0) + bc0), p01 = corr_ex2(fmaf(s[4 * j + 1], c2, ar0) + bc1);
        const float p10 = corr_ex2(fmaf(s[4 * j + 2], c2, ar1) + bc0), p11 = corr_ex2(fmaf(s[4 * j + 3], c2, ar1) + bc1);
        if (pairs) {
          if (r0 < n_own) *reinterpret_cast<float2*>(o_r0 + col) = make_float2(p00, p01);
          if (r1 < n_own) *reinterpret_cast<float2*>(o_r1 + col) = make_float2(p10, p11);
        } else {
          if (r0 < n_own) {
            o_r0[col] = p00;
            if (second) o_r0[col + 1] = p01;
          }
          if (r1 < n_own) {
            o_r1[col] = p10;
            if (second) o_r1[col + 1] = p11;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && !CORR_ABLATE_LOADS && t + CORR_STAGES < total) load_stage(t + CORR_STAGES);
  }

  if (!kPair) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    float2* p = part + (static_cast<long long>(b) * gridDim.y + blockIdx.y) * n_own;
    if (t4 == 0 && r0 < n_own) p[r0] = make_float2(corr_shift(m0), l0);
    if (t4 == 0 && r1 < n_own) p[r1] = make_float2(corr_shift(m1), l1);
  }
}

// geom of an X^T map (ops/fused_matcher.py::corr_t_geometry): dims (32, 128,
// pad / 32, 1, B), box (32, 128, 2, 1, 1), pad the rows padded to 64.
inline bool corr_t_geometry_ok(const long long* g, int B, int rows) {
  const long long pad = (rows + CORR_BN - 1) / CORR_BN * CORR_BN;
  return g[0] == CORR_SPAN && g[1] == CORR_C && g[2] * CORR_SPAN == pad && g[3] == 1 && g[4] == B &&
         g[9] == CORR_SPAN && g[10] == CORR_C && g[11] == CORR_BN / CORR_SPAN && g[12] == 1 && g[13] == 1;
}

// The engine on descriptors d0 (B, M, C) and d1 (B, N, C), fp32 or bf16 as
// Op: the prep kernel into scratch (Op::scratch_floats), then
// corr_fwd_kernel<kPair, Op> with own = d1 (!kPair) or d0 (kPair) over
// `chunks` chunks of the other rows, each the same whole number of 64-row
// tiles and none empty (ops/fused_matcher.py::col_lse_chunks; 1 for kPair).
// Returns 0, a cudaError_t, or ERR_ENCODE + the encoder's CUresult.
template <bool kPair, class Op>
int corr_launch(const void* d0, const void* d1, float* scratch, const long long* geom, int B, int M, int N, int C,
                int chunks, float inv_temp, float alpha, float2* part, const float* lse_col, float* out,
                float* lse_row, cudaStream_t st) {
  const int n_own = kPair ? M : N, n_oth = kPair ? N : M;
  const int tiles = (n_oth + CORR_BN - 1) / CORR_BN, per = chunks < 1 ? 0 : (tiles + chunks - 1) / chunks;
  if (B < 1 || M < 1 || N < 1 || C < 1 || C > CORR_C || chunks < 1 || (kPair && chunks != 1) ||
      (chunks - 1) * per >= tiles || !corr_geometry_ok(geom, B, n_own, CORR_BM, Op::kSpan) ||
      !corr_geometry_ok(geom + 14, B, n_oth, CORR_BN, Op::kSpan))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = Op::prep(d0, d1, scratch, B, M, N, C, st);
  if (rc != 0) return rc;
  CorrMaps maps = {};
  rc = Op::encode(&maps.own_hi, &maps.own_lo, scratch, kPair ? 0 : 1, B, M, N, geom);
  if (rc == 0) rc = Op::encode(&maps.oth_hi, &maps.oth_lo, scratch, kPair ? 1 : 0, B, M, N, geom + 14);
  if (rc != 0) return rc;
  // per launch: the attribute belongs to the current device
  constexpr size_t smem = corr_smem<Op>();
  const cudaError_t e = cudaFuncSetAttribute(corr_fwd_kernel<kPair, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  corr_fwd_kernel<kPair, Op><<<dim3((n_own + CORR_BM - 1) / CORR_BM, chunks, B), CORR_NT, smem, st>>>(
      maps, n_own, n_oth, per, inv_temp * CORR_LOG2E, part, lse_col, out, lse_row, alpha * CORR_LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
