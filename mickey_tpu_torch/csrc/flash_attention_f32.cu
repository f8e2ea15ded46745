// Flash attention on fp32 operands for the DINOv2 backbone (forward only):
// K1f, three entries on one kernel body.
//
// Replaces, on the card:
//   K1 at MICKEY.DINOV2.FLOAT16=False: mickey_tpu/ops/flash_attention.py
//       flash_attention_packed (_flash_packed_kernel + _online_softmax_attend)
//       on fp32 qkv -> mk_flash_attention_packed_f32: head-major packed
//       (B, S, 3C) in, head-concat (B, S, C) out;
//   K1b at FLOAT16=False: flash_attention (_flash_kernel) on fp32
//       (B, H, S, D) views with any strides over (B, H, S) and unit stride
//       over D -> mk_flash_attention_f32;
//   K1-old: tools/bench_backbone_profile.py kern(old=True) (old_packed_kernel),
//       packed bf16 qkv upcast to fp32, fp32-accurate products, bf16 out, keys
//       at or past seq_len masked -> mk_flash_attention_packed_upcast_bf16.
//
// Numerics follow _online_softmax_attend with fp32 operands: products at
// fp32 accuracy, the 1/sqrt(D) scale applied to the fp32 scores, keys
// >= seq_len at -1e30, fp32 running max / sum / accumulator, probabilities
// kept at fp32 accuracy for the PV product, the output acc / max(l, 1e-30)
// stored in the output type. The products run on the tensor cores as
// 3xTF32: every fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna, round to nearest), and a product is
// lo*hi + hi*lo + hi*hi into one fp32 accumulator, small terms first (as
// CUTLASS's OpMultiplyAddFastF32). What is dropped, lo*lo and the split's
// residuals, is ~2^-21 of each term; one TF32 product alone keeps 10 mantissa
// bits and would miss the 1e-5 parity this mode exists for. bf16 operands
// (K1-old) are exact in TF32: Q, K and V have no lo part, so the score
// product is one pass and the PV product two (P is split).
// exp(x) is exp2(x log2 e) with scale * log2(e) folded into one FMA a score.
//
// What bounds it on the H100: 4 S^2 D flops a head in three TF32 passes,
// against ~S * 4D * 4 bytes moved: operations, at 495 TFLOP/s TF32 (the FFMA
// body this replaces was capped by the 67 TFLOP/s fp32 FMA rate). Beside the
// products, the S^2 exponentials and the split of P (two cvt a probability).
//
// What the design does about it:
//  - a prep kernel (split_kv_kernel) splits K and V once per (image, head),
//    not once per query tile (each K / V tile is read by ~S / 64 CTAs): it
//    reads the packed or strided layout and writes into scratch K hi and lo
//    as [key][d], and V^T hi and lo as [d][key], keys padded with zeros to a
//    multiple of 64. wgmma takes .tf32 operands only K-major, so V has to be
//    transposed for the PV product's B operand; TMA does not transpose 32-bit
//    data. Within every 8 keys the prep kernel also permutes V^T's columns
//    (position p holds key 2p for p < 4, 2(p - 4) + 1 for p >= 4): the score
//    accumulator gives a thread keys {2t, 2t + 1} of each 8-key slice, the
//    tf32 A fragment wants k-indices {t, t + 4}, and a sum over keys does
//    not care about their order, so P goes from the accumulator to the A
//    operand of the PV product with no shuffle;
//  - one warpgroup owns 64 query rows; its Q fragment is loaded from the
//    caller's layout once and split in registers (hi, lo: 64 registers), the
//    register A operand of the score product S = Q K^T (m64n32k8, K from
//    shared memory); P is the register A operand of P V (m64n64k8, V^T
//    from shared memory), so neither product reads A from shared memory;
//  - each tile's P V goes into a fresh accumulator and is added to O in
//    registers (O = alpha O + P V, round to nearest): the tensor cores' fp32
//    sums are not rounded to nearest, and chaining all ~3 S / 8 products of
//    a row into O put the output 1.7e-5 of max|out| off at S = 1939 (1.9e-6
//    a tile at a time; PERF.md, PR 6);
//  - the softmax stays in registers: in the wgmma accumulator layout a row
//    lives in 4 neighbouring lanes (row max: two shuffles; the row sum is a
//    per-thread share until the end);
//  - K / V^T tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle,
//    one mbarrier a stage) into a ring of STAGES stages, issued STAGES tiles
//    ahead. A 128-byte swizzle row holds 32 fp32 values, so a tile is loaded
//    through 5-D tensor maps that split the minor dim as (32, n)
//    (ops/flash_attention.py::map_geometry) and lies in shared memory as n
//    swizzled blocks of 128-byte rows;
//  - ~97 KB of shared memory a CTA and 189 registers a thread (no spills)
//    keep 2 CTAs on an SM, so one CTA's softmax runs under the other's
//    products.

#include <cuda_bf16.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// The caller's layouts: where image b, head h of q, k, v and the output start
// (element offsets b * x_b + h * x_h from each base) and the element stride
// between their consecutive sequence rows (x_s); the D = 64 values of a row
// are contiguous and K / V rows start 16-byte aligned. The packed entries
// fill it for the head-major (B, S, 3C) qkv and the head-concat (B, S, C)
// output, the strided entry from the (B, H, S, D) views' strides.
template <typename In, typename Out>
struct AttnLayout {
  const In* q;
  const In* k;
  const In* v;
  Out* o;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

constexpr int D = 64;          // head dim (ViT-S/B/L all use 64)
constexpr int BQ = 64;         // queries per CTA: one warpgroup's wgmma M
constexpr int BK = 32;         // keys per tile: the score product's wgmma N, one 128-byte swizzle row of V^T
constexpr int STAGES = 3;
constexpr int NT = 128;        // one warpgroup
constexpr int KEY_PAD = 64;    // scratch keys are padded to a multiple of this (the prep kernel's chunk)
constexpr int SPAN = 32;       // fp32 values in one 128-byte swizzle row
constexpr uint32_t TILE_BYTES = BK * D * 4;      // one operand tile: K hi, K lo, V^T hi or V^T lo
constexpr uint32_t K_BLOCK = BK * SPAN * 4;      // a K tile's 32-wide d block: BK rows of 128 bytes
constexpr uint32_t STAGE_BYTES = 4 * TILE_BYTES;
constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * STAGES;  // aligned tiles, one barrier a stage
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
static_assert(2 * (SMEM_BYTES + 1024) <= 228 * 1024, "two CTAs an SM");

// Timing ablations for `chip_smoke.py --attention-f32` (wrong results, never
// in the library the port loads): MK_ABLATE_EXP replaces every ex2 by a
// multiply; MK_ABLATE_LOADS computes on the first ring fill and neither
// waits for nor issues another load; MK_ABLATE_SOFTMAX leaves the products
// alone (P is the raw scores); MK_ABLATE_1XTF32 runs only the hi*hi pass of
// each product; MK_ABLATE_PREP launches no prep kernel (stale scratch).
#ifdef MK_ABLATE_LOADS
constexpr bool ABLATE_LOADS = true;
#else
constexpr bool ABLATE_LOADS = false;
#endif
#ifdef MK_ABLATE_1XTF32
constexpr bool ONE_PASS = true;
#else
constexpr bool ONE_PASS = false;
#endif

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values (fp32 bit patterns)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float ex2(float x) {
#ifdef MK_ABLATE_EXP
  return x * 0.5f;
#endif
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes of one row, as fp32 values
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load16(const bf16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// d (64 x 32 fp32) = or += A (64 x 8 tf32, 4 fragment registers) B^T (32 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) = or += A (64 x 8 tf32, 4 fragment registers) B^T (64 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// s (64 x 32) = Q K^T over eight k8 slices of d: slice kk lies in the tile's
// 32-wide d block kk / 4, 32 bytes a slice into its 128-byte rows. With a lo
// part: lo*hi, hi*lo, hi*hi a slice. Issues and commits; the caller waits.
template <bool kSplit>
__device__ __forceinline__ void issue_scores(float (&s)[16], const uint32_t (&qh)[32], const uint32_t (&ql)[32],
                                             uint32_t k_hi, uint32_t k_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t off = (kk / 4) * K_BLOCK;
    const uint64_t step = 2 * (kk % 4);
    const uint64_t dh = smem_desc(k_hi + off) + step;
    const uint32_t *h = &qh[4 * kk], *l = &ql[4 * kk];
    if (kSplit && !ONE_PASS) {
      wgmma_n32(s, l[0], l[1], l[2], l[3], dh, kk != 0);
      wgmma_n32(s, h[0], h[1], h[2], h[3], smem_desc(k_lo + off) + step, 1);
      wgmma_n32(s, h[0], h[1], h[2], h[3], dh, 1);
    } else {
      wgmma_n32(s, h[0], h[1], h[2], h[3], dh, kk != 0);
    }
  }
  wgmma_commit();
}

// pv (64 x 64) = this tile's P V over four k8 slices of keys, 32 bytes a
// slice into the V^T tile's 128-byte rows. P's lo part always exists; V's
// only with kSplit. Issues and commits; the caller waits. A fresh accumulator
// a tile: the tensor cores' fp32 sums are not rounded to nearest (their error
// grows with the chain of accumulating products), so the caller adds each
// tile's 12 products into O in registers.
template <bool kSplit>
__device__ __forceinline__ void issue_pv(float (&pv)[32], const uint32_t (&ph)[16], const uint32_t (&pl)[16],
                                         uint32_t v_hi, uint32_t v_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint64_t step = 2 * kk;
    const uint64_t dh = smem_desc(v_hi) + step;
    const uint32_t *h = &ph[4 * kk], *l = &pl[4 * kk];
    if (!ONE_PASS) {
      wgmma_n64(pv, l[0], l[1], l[2], l[3], dh, kk != 0);
      if (kSplit) wgmma_n64(pv, h[0], h[1], h[2], h[3], smem_desc(v_lo) + step, 1);
    }
    wgmma_n64(pv, h[0], h[1], h[2], h[3], dh, ONE_PASS ? kk != 0 : 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c1, int c2, int h,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1), "r"(c2), "r"(h), "r"(b)
      : "memory");
}

struct Maps {
  CUtensorMap k_hi, k_lo, v_hi, v_lo;
};

// Tile t into the stage at `stage`: K rows [t BK, t BK + BK) (both d blocks)
// and V^T's key block t (all 64 d rows), hi and (kSplit) lo.
template <bool kSplit>
__device__ __forceinline__ void load_stage(const Maps& m, uint32_t bar, uint32_t stage, int t, int h, int b) {
  mbar_expect_tx(bar, (kSplit ? 4 : 2) * TILE_BYTES);
  tma_load5(stage, &m.k_hi, bar, t * BK, 0, h, b);
  tma_load5(stage + 2 * TILE_BYTES, &m.v_hi, bar, 0, t, h, b);
  if (kSplit) {
    tma_load5(stage + TILE_BYTES, &m.k_lo, bar, t * BK, 0, h, b);
    tma_load5(stage + 3 * TILE_BYTES, &m.v_lo, bar, 0, t, h, b);
  }
}

// One CTA = one warpgroup = 64 query rows of one (image, head). Each tile:
// wait for its stage, S = Q K^T, the online softmax in registers, P split,
// the tile's P V, O = alpha O + P V in registers, then one block barrier
// frees the stage for tile t + STAGES.
// Thread (warp w, lane 4 g + t4) holds score / output columns 8 j + 2 t4 +
// {0, 1} of rows 16 w + g (registers 4 j, 4 j + 1) and 16 w + g + 8
// (4 j + 2, 4 j + 3), and Q / P fragment registers 4 kk + {0, 1, 2, 3} =
// (row g, k t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4) of k-slice kk.
template <typename In, typename Out, bool kSplit>
__global__ void __launch_bounds__(NT, 2)
flash_tf32_kernel(const __grid_constant__ Maps maps, const AttnLayout<In, Out> L, int S, int seq_len, float c) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + STAGES * STAGE_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nkt = (seq_len + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < STAGES && st < nkt; ++st) load_stage<kSplit>(maps, bar0 + 8 * st, base + st * STAGE_BYTES, st, h, b);

  // Q's fragment straight from the caller's layout (rows past S are zero), split once
  uint32_t qh[32], ql[32];
  {
    const In* qb = L.q + b * L.q_b + h * L.q_h;
    const int r0 = q0 + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + ((i & 1) ? 8 : 0), col = 8 * (i >> 2) + t4 + ((i & 2) ? 4 : 0);
      const float x = row < S ? to_float(qb[static_cast<long long>(row) * L.q_s + col]) : 0.f;
      split(x, qh[i], ql[i]);
    }
  }

  float m0 = NEG_INF, m1 = NEG_INF;  // running max of the raw scores, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums
  float s[16], o[32], pv[32];
  uint32_t ph[16], pl[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    const int st = t % STAGES;
    const uint32_t stage = base + st * STAGE_BYTES;
    if (!ABLATE_LOADS || t < STAGES) mbar_wait(bar0 + 8 * st, (t / STAGES) & 1);
    issue_scores<kSplit>(s, qh, ql, stage, stage + TILE_BYTES);
    wgmma_wait();
    fence_regs(s);

    float alpha0 = 1.f, alpha1 = 1.f;
#ifdef MK_ABLATE_SOFTMAX
#pragma unroll
    for (int i = 0; i < 16; ++i) split(s[i], ph[i], pl[i]);
#else
    const int valid = seq_len - t * BK;
    if (valid < BK) {  // only the last tile can hold keys at or past seq_len
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) >= valid) s[i] = NEG_INF;
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
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
    alpha0 = ex2((m0 - mn0) * c);
    alpha1 = ex2((m1 - mn1) * c);
    const float mc0 = mn0 * c, mc1 = mn1 * c;
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    // P enters the A fragment as (p0, p2, p1, p3) of each group of four:
    // key 2 t4 is k-index t4, key 2 t4 + 1 is t4 + 4 (V^T is permuted alike)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = ex2(fmaf(s[i], c, (i & 2) ? -mc1 : -mc0));
      if (i & 2) {
        sum1 += p;
      } else {
        sum0 += p;
      }
      const int a = (i & ~3) | ((i & 1) << 1) | ((i & 2) >> 1);
      split(p, ph[a], pl[a]);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#endif
    issue_pv<kSplit>(pv, ph, pl, stage + 2 * TILE_BYTES, stage + 3 * TILE_BYTES);
    wgmma_wait();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], (i & 2) ? alpha1 : alpha0, pv[i]);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && !ABLATE_LOADS && t + STAGES < nkt) load_stage<kSplit>(maps, bar0 + 8 * st, stage, t + STAGES, h, b);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  Out* const ob = L.o + b * L.o_b + h * L.o_h;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r0 < S) store2(ob + static_cast<long long>(r0) * L.o_s + col, o[4 * j] / den0, o[4 * j + 1] / den0);
    if (r1 < S) store2(ob + static_cast<long long>(r1) * L.o_s + col, o[4 * j + 2] / den1, o[4 * j + 3] / den1);
  }
}

// Position p of each 8 V^T columns holds key 2p (p < 4) or 2(p - 4) + 1:
// the keys of a thread's score registers {4 kk + 0, 4 kk + 1} land at its
// A-fragment k-indices {t4, t4 + 4}.
__device__ __forceinline__ int permuted_key(int p) {
  const int w = p & 7;
  return (p & ~7) + (w < 4 ? 2 * w : 2 * (w - 4) + 1);
}

// The prep kernel: one block per 64 keys of one (image, head). K rows
// [key0, key0 + 64) into K hi / lo ([key][d]); V's into V^T hi / lo
// ([d][permuted key]) through a shared-memory transpose; keys >= S zero.
template <typename In, bool kSplit>
__global__ void __launch_bounds__(256)
split_kv_kernel(const AttnLayout<In, float> L, float* k_hi, float* k_lo, float* v_hi, float* v_lo, int S, int s_kv) {
  __shared__ float vs[KEY_PAD][D + 1];
  constexpr int V = 16 / sizeof(In), PER_ROW = D / V;
  const int key0 = blockIdx.x * KEY_PAD, h = blockIdx.y, b = blockIdx.z;
  const long long head = static_cast<long long>(b) * gridDim.y + h;
  const In* kb = L.k + b * L.k_b + h * L.k_h;
  const In* vb = L.v + b * L.v_b + h * L.v_h;
  for (int i = threadIdx.x; i < KEY_PAD * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW, col = (i % PER_ROW) * V, key = key0 + r;
    float xk[V], xv[V];
    if (key < S) {
      load16(kb + static_cast<long long>(key) * L.k_s + col, xk);
      load16(vb + static_cast<long long>(key) * L.v_s + col, xv);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) xk[e] = xv[e] = 0.f;
    }
    const long long at = (head * s_kv + key) * D + col;
#pragma unroll
    for (int e = 0; e < V; e += 4) {  // 16-byte stores
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(xk[e + j], hi[j], lo[j]);
        vs[r][col + e + j] = xv[e + j];
      }
      *reinterpret_cast<uint4*>(k_hi + at + e) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if (kSplit) *reinterpret_cast<uint4*>(k_lo + at + e) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * KEY_PAD; i += blockDim.x) {
    const int d = i / KEY_PAD, p = i % KEY_PAD;
    uint32_t hi, lo;
    split(vs[permuted_key(p)][d], hi, lo);
    const long long at = (head * D + d) * s_kv + key0 + p;
    v_hi[at] = __uint_as_float(hi);
    if (kSplit) v_lo[at] = __uint_as_float(lo);
  }
}

// geom: K's map then V^T's, each dims (5), byte strides (4), box (5),
// innermost first (ops/flash_attention.py::map_geometry): K (32, s_kv, 2, H,
// B), box (32, 32, 2, 1, 1); V^T (32, 64, s_kv / 32, H, B), box (32, 64,
// 1, 1, 1). scratch: K hi, [K lo,] V^T hi, [V^T lo,] each B H s_kv 64
// floats.
template <typename In, typename Out, bool kSplit>
int launch(const AttnLayout<In, Out>& L, float* scratch, const long long* geom, int B, int H, int S, int seq_len,
           float scale, void* stream) {
  const long long *kd = geom, *kst = geom + 5, *kbox = geom + 9, *vd = geom + 14, *vst = geom + 19, *vbox = geom + 23;
  const long long s_kv = kd[1];
  if (kd[0] != SPAN || kd[2] != D / SPAN || kd[3] != H || kd[4] != B || kbox[0] != SPAN || kbox[1] != BK ||
      kbox[2] != D / SPAN || vd[0] != SPAN || vd[1] != D || vd[2] * SPAN != s_kv || vbox[1] != D ||
      vbox[2] != 1 || s_kv % KEY_PAD || s_kv < seq_len || seq_len < 1 || seq_len > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * H * s_kv * D;
  float* k_hi = scratch;
  float* k_lo = kSplit ? k_hi + n : nullptr;
  float* v_hi = k_hi + (kSplit ? 2 : 1) * n;
  float* v_lo = kSplit ? v_hi + n : nullptr;
  Maps maps;
  int rc = encode_map(&maps.k_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, k_hi, kd, kst, kbox);
  if (rc == 0) rc = encode_map(&maps.v_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, v_hi, vd, vst, vbox);
  maps.k_lo = maps.k_hi;
  maps.v_lo = maps.v_hi;
  if (kSplit && rc == 0) rc = encode_map(&maps.k_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, k_lo, kd, kst, kbox);
  if (kSplit && rc == 0) rc = encode_map(&maps.v_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, v_lo, vd, vst, vbox);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#ifndef MK_ABLATE_PREP
  const AttnLayout<In, float> P{L.q, L.k, L.v, nullptr, L.q_b, L.q_h, L.q_s, L.k_b, L.k_h, L.k_s, L.v_b, L.v_h, L.v_s,
                                0, 0, 0};
  split_kv_kernel<In, kSplit><<<dim3(s_kv / KEY_PAD, H, B), 256, 0, st>>>(P, k_hi, k_lo, v_hi, v_lo, S, s_kv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
#endif
  // per launch: the attribute belongs to the current device
  e = cudaFuncSetAttribute(flash_tf32_kernel<In, Out, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float log2e = 1.4426950408889634f;
  flash_tf32_kernel<In, Out, kSplit><<<dim3((S + BQ - 1) / BQ, H, B), NT, SMEM_BYTES, st>>>(maps, L, S, seq_len,
                                                                                           scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

// qkv (B, S, 3 H D) packed head-major -> out (B, S, H D)
template <typename In, typename Out, bool kSplit>
int launch_packed(const void* qkv, void* out, float* scratch, const long long* geom, int B, int S, int H, int seq_len,
                  float scale, void* stream) {
  const In* x = static_cast<const In*>(qkv);
  const long long C = static_cast<long long>(H) * D, row = 3 * C;
  const AttnLayout<In, Out> L{x, x + D, x + 2 * D, static_cast<Out*>(out),
                              S * row, 3 * D, row, S * row, 3 * D, row, S * row, 3 * D, row,
                              S * C, D, C};
  return launch<In, Out, kSplit>(L, scratch, geom, B, H, S, seq_len, scale, stream);
}

}  // namespace

// Every entry returns 0, a cudaError_t, or 100000 + the CUresult of the
// tensor-map encoder. `scratch` and `geom`: see launch().

// K1 at fp32: qkv (B, S, 3 H D) fp32 packed head-major -> out (B, S, H D) fp32.
extern "C" int mk_flash_attention_packed_f32(const void* qkv, void* out, void* scratch, const long long* geom, int B,
                                             int S, int H, float scale, void* stream) {
  return launch_packed<float, float, true>(qkv, out, static_cast<float*>(scratch), geom, B, S, H, S, scale, stream);
}

// K1-old: qkv (B, S, 3 H D) bf16 packed head-major (exact in TF32: no lo
// parts but P's) -> out (B, S, H D) bf16; keys at positions >= seq_len masked.
extern "C" int mk_flash_attention_packed_upcast_bf16(const void* qkv, void* out, void* scratch, const long long* geom,
                                                     int B, int S, int H, int seq_len, float scale, void* stream) {
  return launch_packed<bf16, bf16, false>(qkv, out, static_cast<float*>(scratch), geom, B, S, H, seq_len, scale,
                                          stream);
}

// K1b at fp32: q, k, v (B, H, S, D) fp32 with element strides
// {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s} -> out (B, H, S, D) fp32
// contiguous; keys at positions >= seq_len masked.
extern "C" int mk_flash_attention_f32(const void* q, const void* k, const void* v, void* out, const long long* strides,
                                      void* scratch, const long long* geom, int B, int H, int S, int seq_len,
                                      float scale, void* stream) {
  const long long* st = strides;
  const AttnLayout<float, float> L{static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(out),
                                   st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                                   static_cast<long long>(H) * S * D, static_cast<long long>(S) * D, D};
  return launch<float, float, true>(L, static_cast<float*>(scratch), geom, B, H, S, seq_len, scale, stream);
}
