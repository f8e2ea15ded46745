// Flash attention for the DINOv2 backbone (forward only, bf16), on two layouts.
//
// Replaces mickey_tpu/ops/flash_attention.py's two Pallas kernels:
//   K1  flash_attention_packed (_flash_packed_kernel + _online_softmax_attend):
//       non-causal softmax(q k^T / sqrt(D)) v read straight from the qkv
//       linear output, whose minor dim is packed head-major as (H, 3, D), and
//       written head-concat as (B, S, H*D) for the proj linear;
//   K1b flash_attention (_flash_kernel): the same math on q, k, v of shape
//       (B, H, S, D) with any 16-byte-multiple strides over (B, H, S) and unit
//       stride over D (the permuted views of the qkv linear output need no
//       copy), written as a contiguous (B, H, S, D).
// Both go through one entry, mk_flash_attention_bf16, and one kernel body:
// q, k and v are each described by a 4-D tensor map (D, S, H, B) built from the
// caller's byte strides, so the packed layout is just another set of strides;
// only the output strides differ. Keys at positions >= seq_len are masked, so
// the 1939-token ViT-L sequence needs no padding. The fp32-operand
// counterparts (MICKEY.DINOV2.FLOAT16=False, and the tools' K1-old) are in
// flash_attention_f32.cu.
//
// Numerics follow the TPU kernel: bf16 operands, products on the tensor
// cores with fp32 accumulation, the 1/sqrt(D) scale applied to the fp32
// scores, fp32 running max / sum / accumulator, probabilities rounded to bf16
// before the PV product, 1 / max(l, 1e-30) at the end. exp(x) is computed as
// exp2(x log2 e) with scale * log2(e) folded into one FMA per score.
//
// What bounds it on the H100: at S = 1939, D = 64 the two products are
// 4 S^2 D flops per head against ~S * 4D * 2 bytes moved, far above the
// card's ~295 flop/byte balance point: operations, not bytes. Beside the
// tensor cores the S^2 exponentials bind: one ex2 per score at 16 per clock
// and SM takes as long as the 128 tensor-core FMAs per score at peak, so the
// softmax must run while products do. (Timing ablations, PERF.md: the two
// products alone take 0.7 of the kernel's time, the exponentials and the
// loads about 0.05 each.)
//
// What the design does about it:
//  - both products are wgmma instructions issued by one warpgroup that owns
//    64 query rows: S = Q K^T as m64n128k16 with Q and K read from shared
//    memory through 128-byte-swizzled descriptors (D = 64 bf16 is one swizzle
//    row), O += P V as m64n64k16 with P as the A operand from registers and V
//    as an MN-major B operand (its tile is [key][d]: the contraction runs
//    over rows, k-slices advance by 16 rows);
//  - the scores never leave registers: in the wgmma accumulator layout a row
//    lives in 4 neighbouring lanes, so the row max is two shuffles, the row
//    sum stays a per-thread partial until the end, and the fp32 accumulator
//    of m64n128k16 converted to bf16 pairs is the A fragment of the next
//    product's k16 slices. O stays in 32 fp32 registers for the whole loop;
//  - the loop is software-pipelined: with P of tile t in registers it issues
//    the score product of tile t + 1, then O += P V of tile t, waits for the
//    scores only and runs tile t + 1's softmax while the PV product is still
//    on the tensor cores. P alternates between two register arrays: a copy,
//    or a branch around a product, makes ptxas serialize the products
//    (C7513 / C7514), so the steps are unrolled by two and the last PV product
//    is peeled off;
//  - K and V tiles arrive by TMA (cp.async.bulk.tensor, SWIZZLE_128B) in two
//    rings of STAGES tiles, completion on an mbarrier per tile: at the end of
//    step t one block barrier frees K tile t + 1's stage and V tile t's, and
//    thread 0 issues K tile t + 3 and V tile t + 2, a whole step before
//    either is used. Rows past S come back zero-filled from the tensor map's
//    bounds (S is a dimension of its own) and tiles past seq_len are never
//    loaded; the mask compare runs on the last tile only;
//  - 73 KB of shared memory and <= 168 registers a thread keep 3 CTAs on an
//    SM, so one CTA's softmax also runs under another's products;
//  - the output is staged through the Q tile (free by then) with an XOR
//    swizzle and written as 16 bytes a thread, whole 128-byte rows a time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;        // head dim (ViT-S/B/L all use 64): one 128-byte swizzle row
constexpr int BQ = 64;       // queries per CTA: one warpgroup's wgmma M
constexpr int BK = 128;      // keys per tile: the score product's wgmma N
constexpr int STAGES = 2;    // K/V tiles in the ring
constexpr int NT = 128;      // one warpgroup
constexpr int BOX_ROWS = 64; // rows of one TMA box; Q is one box, a K or V tile two
constexpr uint32_t BOX_BYTES = BOX_ROWS * D * sizeof(bf16);
constexpr uint32_t KV_BYTES = BK * D * sizeof(bf16);
constexpr uint32_t BAR_OFFSET = BOX_BYTES + 2 * STAGES * KV_BYTES;  // Q, the K ring, the V ring
// tiles, then the barriers (Q's and one per K and V stage), plus room to align
// the tiles to the swizzle's 1024-byte period
constexpr size_t SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 2 * STAGES);
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr int ERR_ENCODE = 100000; // added to a CUresult of the tensor-map encoder

// Timing ablations for `chip_smoke.py --attention` (wrong results, never in
// the library the port loads): MK_ABLATE_EXP replaces every ex2 by a
// multiply; MK_ABLATE_LOADS computes on the first ring fill and neither
// waits for nor issues another load; MK_ABLATE_SOFTMAX leaves the two
// products alone (P is the raw scores' bf16 rounding).
#ifdef MK_ABLATE_LOADS
constexpr bool ABLATE_LOADS = true;
#else
constexpr bool ABLATE_LOADS = false;
#endif

struct OutLayout {
  bf16* o;
  long long o_b, o_h, o_s;  // element strides over image, head, row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One (64, BOX_ROWS, 1, 1) box of a (D, S, H, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Rows [row, row + BK) of K or V into one stage at `dst` as two boxes, both
// completing on `bar`.
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t bar, uint32_t dst, int row, int h, int b) {
  mbar_expect_tx(bar, KV_BYTES);
  tma_load(dst, map, bar, row, h, b);
  tma_load(dst + BOX_BYTES, map, bar, row + BOX_ROWS, h, b);
}

// Shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO); the leading offset
// is not used at this width. Serves the K-major Q and K tiles and the
// MN-major V tile alike.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128 fp32) = or += A (64 x 16, K-major) B^T (128 x 16, K-major), both from shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// o (64 x 64 fp32) += A (64 x 16 bf16, this thread's 4 fragment registers)
// B (16 x 64, MN-major in shared memory: the trans-b flag set).
__device__ __forceinline__ void wgmma_pv(float (&o)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]),
        "+f"(o[4]), "+f"(o[5]), "+f"(o[6]), "+f"(o[7]),
        "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]),
        "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]),
        "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]),
        "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),
        "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]),
        "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
#ifdef MK_ABLATE_EXP
  return x * 0.5f;
#endif
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_wait_older() { asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory"); }

// s (64 x BK) = Q K^T: four k16 slices, 32 bytes apart inside the swizzled
// rows. Issues and commits; the caller waits.
__device__ __forceinline__ void issue_scores(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_qk(s, desc_q + 2 * kk, desc_k + 2 * kk, kk != 0);
  wgmma_commit();
}

// o += P V: eight k16 slices of V's [key][d] tile, 16 rows (2048 bytes) apart.
// Issues and commits; the caller waits.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32], uint64_t desc_v) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], desc_v + kk * (16 * D * 2 >> 4));
  wgmma_commit();
}

// One tile's online softmax in registers, in the exp2 domain. In the wgmma
// accumulator layout thread (warp w, lane 4 g + cq) holds, for every 8-column
// group j, columns 8 j + 2 cq + {0, 1} of rows 16 w + g (registers 4 j,
// 4 j + 1) and 16 w + g + 8 (registers 4 j + 2, 4 j + 3): a row's max is two
// shuffles away, its sum stays a per-thread share. Columns from `valid` on are
// masked. Updates the running maxima (of the raw scores) and sums, returns
// the factors that rescale what was accumulated before, and p = 2^(s c - m c)
// rounded to bf16 pairs: registers 8 kk .. 8 kk + 7 of the fp32 accumulator
// become the A fragment (4 x bf16x2) of P's k16 slice kk.
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&p)[32], float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1, float c, int valid, int cq) {
#ifdef MK_ABLATE_SOFTMAX
  alpha0 = alpha1 = 1.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  return;
#endif
  if (valid < BK) {  // only the last tile can hold keys at or past seq_len
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i >> 2) + 2 * cq + (i & 1) >= valid) s[i] = NEG_INF;
  }
  // four independent chains a row, for the max as for the sum below: a
  // single chain of 32 dependent operations leaves the warp waiting on latency
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i >> 2][i & 3] = NEG_INF;
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
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
  float sum[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i >> 2][i & 3] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float mc = (j & 1) ? mc1 : mc0;
    const float e0 = ex2(fmaf(s[2 * j], c, -mc)), e1 = ex2(fmaf(s[2 * j + 1], c, -mc));
    sum[j & 1][(j >> 1) & 3] += e0 + e1;
    p[j] = pack_bf16(e0, e1);
  }
  l0 = alpha0 * l0 + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
  l1 = alpha1 * l1 + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
}

// One CTA = one warpgroup = 64 query rows of one (image, head). The loop is
// software-pipelined: with P of tile t in registers, it issues the score
// product of tile t + 1 and then O += P V of tile t, waits for the scores
// only, and runs tile t + 1's softmax while the PV product is still on the
// tensor cores; O is rescaled once that product has landed.
__global__ void __launch_bounds__(NT, 3)
flash_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const OutLayout L, int S, int seq_len, float c) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // the Q tile, generic address
  const uint32_t sQ = base, sK = base + BOX_BYTES, sV = sK + STAGES * KV_BYTES;
  const uint32_t bar_q = base + BAR_OFFSET, bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, cq = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nkt = (seq_len + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < 2 * STAGES; ++st) mbar_init(bar_k + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // Q and both rings' first fill
    mbar_expect_tx(bar_q, BOX_BYTES);
    tma_load(sQ, &map_q, bar_q, q0, h, b);
    for (int st = 0; st < STAGES && st < nkt; ++st) {
      load_tile(&map_k, bar_k + 8 * st, sK + st * KV_BYTES, st * BK, h, b);
      load_tile(&map_v, bar_v + 8 * st, sV + st * KV_BYTES, st * BK, h, b);
    }
  }

  float m0 = NEG_INF, m1 = NEG_INF;  // running max of the raw scores, rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums
  float alpha0, alpha1;
  float s[64], o[32];
  uint32_t p[32], p_next[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  // tile 0's scores and softmax; its K stage then takes tile STAGES
  const uint64_t desc_q = smem_desc(sQ);
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  issue_scores(s, desc_q, smem_desc(sK));
  wgmma_wait();
  fence_regs(s);
  __syncthreads();
  if (tid == 0 && !ABLATE_LOADS && STAGES < nkt) load_tile(&map_k, bar_k, sK, STAGES * BK, h, b);
  softmax_tile(s, p, m0, m1, l0, l1, alpha0, alpha1, c, seq_len, cq);  // O is still zero: nothing to rescale

  // One pipelined step: P of tile t is in `pc`; tile t + 1's goes to `pn`,
  // which no product in flight reads (the step before waited for its own).
  auto step = [&](int t, const uint32_t (&pc)[32], uint32_t (&pn)[32]) {
    const int st = t % STAGES, nx = (t + 1) % STAGES;
    if (!ABLATE_LOADS || t + 1 < STAGES) mbar_wait(bar_k + 8 * nx, ((t + 1) / STAGES) & 1);
    issue_scores(s, desc_q, smem_desc(sK + nx * KV_BYTES));
    if (!ABLATE_LOADS || t < STAGES) mbar_wait(bar_v + 8 * st, (t / STAGES) & 1);
    issue_pv(o, pc, smem_desc(sV + st * KV_BYTES));
    wgmma_wait_older();  // the scores are in; the PV product may still run
    fence_regs(s);
    softmax_tile(s, pn, m0, m1, l0, l1, alpha0, alpha1, c, seq_len - (t + 1) * BK, cq);
    wgmma_wait();
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
    // Every warp is done with K tile t + 1 and V tile t: their stages take
    // tiles t + 1 + STAGES and t + STAGES, a whole tile's time before use.
    __syncthreads();
    if (tid == 0 && !ABLATE_LOADS) {
      if (t + 1 + STAGES < nkt) load_tile(&map_k, bar_k + 8 * nx, sK + nx * KV_BYTES, (t + 1 + STAGES) * BK, h, b);
      if (t + STAGES < nkt) load_tile(&map_v, bar_v + 8 * st, sV + st * KV_BYTES, (t + STAGES) * BK, h, b);
    }
  };
  // the last tile's PV product
  auto last = [&](const uint32_t (&pc)[32]) {
    const int t = nkt - 1, st = t % STAGES;
    if (!ABLATE_LOADS || t < STAGES) mbar_wait(bar_v + 8 * st, (t / STAGES) & 1);
    issue_pv(o, pc, smem_desc(sV + st * KV_BYTES));
    wgmma_wait();
    fence_regs(o);
  };
  int t = 0;
  for (; t + 2 < nkt; t += 2) {  // two steps a turn: P alternates between the two arrays, never copied
    step(t, p, p_next);
    step(t + 1, p_next, p);
  }
  if (t + 1 < nkt) {
    step(t, p, p_next);
    last(p_next);
  } else {
    last(p);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);

  // Stage this warp's 16 rows through the Q tile (no product reads it any
  // more: a block barrier followed every warp's last score product).
  // 16-byte chunk j of row r sits at chunk j ^ (r & 7), so neither the 4-byte
  // writes nor the 16-byte reads conflict.
  {
    unsigned char* row0 = smem + (16 * warp + g) * (D * 2);
    unsigned char* row1 = row0 + 8 * (D * 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = ((j ^ g) << 4) + 4 * cq;
      *reinterpret_cast<uint32_t*>(row0 + off) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(row1 + off) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  __syncwarp();
  bf16* const dst = L.o + b * L.o_b + h * L.o_h;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = 16 * warp + 4 * it + (lane >> 3), ch = lane & 7;
    if (q0 + r < S) {
      const uint4 v = *reinterpret_cast<const uint4*>(smem + r * (D * 2) + ((ch ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(dst + (q0 + r) * L.o_s + ch * 8) = v;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda (which the CUDA runtime has
// loaded by the time a tensor lives on the card), so the library links
// against nothing but cudart and libdl.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bf16 (D, S, H, B) map with byte strides (row, head, image), 128-byte
// swizzle, zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, const long long* dims, const long long* strides, const long long* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_ENCODE;
  cuuint64_t gdim[4], gstr[3];
  cuuint32_t bx[4], estr[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) gstr[i] = static_cast<cuuint64_t>(strides[i]);
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim, gstr, bx, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

}  // namespace

// K1 and K1b: q, k, v (B, H, S, D) bf16 views -> out, keys at positions
// >= seq_len masked. geom holds, innermost first, what the tensor maps encode
// (ops/flash_attention.py::map_geometry): dims (D, S, H, B); q's, k's
// and v's byte strides over (S, H, B); the box (D, 64, 1, 1); then out's
// element strides over (B, H, S): (S C, D, C) for K1's head-concat
// (B, S, C), (H S D, S D, D) for K1b's (B, H, S, D). Returns 0, a cudaError_t,
// or 100000 + the CUresult of the tensor-map encoder.
extern "C" int mk_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                       const long long* geom, int seq_len, float scale, void* stream) {
  const long long *dims = geom, *box = geom + 13, *ost = geom + 17;
  if (dims[0] != D || box[0] != D || box[1] != BOX_ROWS || box[2] != 1 || box[3] != 1 || seq_len < 1 ||
      seq_len > dims[1])
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v;
  int rc = encode(&map_q, q, dims, geom + 4, box);
  if (rc == 0) rc = encode(&map_k, k, dims, geom + 7, box);
  if (rc == 0) rc = encode(&map_v, v, dims, geom + 10, box);
  if (rc != 0) return rc;
  // per launch: the attribute belongs to the current device
  const cudaError_t opted =
      cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int S = static_cast<int>(dims[1]);
  const OutLayout L{static_cast<bf16*>(out), ost[0], ost[1], ost[2]};
  const dim3 grid((S + BQ - 1) / BQ, static_cast<unsigned>(dims[2]), static_cast<unsigned>(dims[3]));
  const float log2e = 1.4426950408889634f;
  flash_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(map_q, map_k, map_v, L, S, seq_len,
                                                                             scale * log2e);
  return static_cast<int>(cudaGetLastError());
}
