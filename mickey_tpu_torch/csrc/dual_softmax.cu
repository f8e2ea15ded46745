// Differentiable dense dual-softmax: the training matcher's forward pass and
// its analytic backward, with the (B, M, N) couplings never materialized.
//
// Replaces mickey_tpu/ops/fused_matcher.py's Pallas kernels of
// fused_dual_softmax / fused_dual_softmax_vjp:
//   K4  _pair_softmax_kernel (:107) -> mk_pair_softmax_f32 (mk_pair_softmax_bf16
//       on the bf16 descriptors of cfg.TPU.MATCHER_BF16, the engine's bf16
//       mode: one bf16 wgmma pass, as _corr_block's bf16 branch): with
//       s = dsc0 dsc1^T / T, per row i the dustbin-augmented
//       lse_row_i = log(sum_j exp(s_ij) + exp(alpha)), and the dense output
//       P_ij = exp(s_ij - lse_row_i) exp(s_ij - lse_col_j). Its first pass
//       (_col_stats_kernel :82, lse_col) is col_lse in fused_topk.cu.
//   K5  _bwd_sums_kernel (:234)  -> mk_dual_softmax_bwd_sums_f32:
//       r = rowsum(G o P), c = colsum(G o P) for the upstream cotangent G;
//       _bwd_grads_kernel (:256) -> mk_dual_softmax_bwd_grads_f32:
//       dS = 2 P o G - A c - B r with A = exp(s - lse_col), B = exp(s - lse_row),
//       dd0 = dS dsc1 / T and dd1 = dS^T dsc0 / T.
// and fused_topk_scores_train's backward:
//   K6  _lse_bwd_kernel (:665) -> mk_lse_bwd_f32: the VJP of the two
//       logsumexps alone, for cotangents gr (B, M) and gc (B, N):
//       dS = gr exp(s - lse_row) + gc exp(s - lse_col), dd0 and dd1 as in K5.
//       It reads no (B, M, N) tensor at all: that is the point of the fused
//       top-K training route.
// The reference computes the correlation at Precision.HIGHEST (1/T = 10
// turns TF32 truncation into ~0.04 logit error), and K5's and K6's dS
// products at HIGHEST too. All of them run at fp32 accuracy as 3xTF32 wgmma
// on the correlation engine of corr_tf32.cuh (its design and bound are
// there). K4: a CTA owns 64 rows of dsc0 and sweeps dsc1 twice, the online
// row logsumexp first, then the writes of P. K5 and K6: corr_bwd_kernel.
//
// What bounds K5 and K6 on the H100: the correlation and, for the gradients,
// the two dS products, 3 x 2 B M N C flops (23.1 GFLOP at B = 8, M = N =
// 1938, C = 128), each three TF32 passes at 495 TFLOP/s (0.14 ms), against
// one read of the (B, M, N) cotangent G (120 MB at 3.35 TB/s, 0.036 ms; K6
// reads no (B, M, N) tensor: that is the point of the fused top-K training
// route). So operations, on the tensor cores. Design of corr_bwd_kernel, one
// warpgroup a CTA that owns 64 rows of one axis and sweeps the other in
// 64-row tiles, so a per-row sum never leaves the CTA:
//   * s is recomputed for each tile on the engine (issue_corr) from the
//     descriptors split once into scratch, the own rows' hi / lo resident in
//     shared memory, the other tile's by TMA;
//   * bwd_sums (K5's first body): G o exp(2 s - lse_row - lse_col) in the
//     accumulator layout; the row sums stay in registers, the column sums of
//     a tile are reduced over each warp's 16 rows by shuffles (a
//     reduce-scatter) and written as per-16-row partials that a second small
//     launch adds in order (col_partials_kernel), as K2a combines its
//     chunks. The TPU kernel
//     carried the column sums across its sequential grid; here CTAs run in
//     no order and there are no float atomics, so two launches give
//     bitwise-equal results;
//   * bwd_grads (K5's second body) and lse_bwd (K6): one template, two
//     launches with the axes swapped (dd0 owns dsc0's rows, dd1 dsc1's). dS
//     is formed in registers from s (the dense mode reads the G tile, K6
//     needs none), split into TF32 hi / lo as the descriptors are
//     (split_desc: hi truncated, so +-inf descriptors give +-inf products
//     where fp32 does), and is the register A operand of dd_own += dS X_oth
//     (m64n128k8, issue_dd). .tf32 wgmma takes only K-major operands and the
//     sum runs over the other rows, so X_oth comes a second time as X_oth^T
//     ([c][row], 256-byte rows: two blocks of 32 rows), written once by the
//     prep kernel split_desc_t_kernel with each 8 rows permuted so the
//     accumulator's columns are the A fragment's k-indices;
//   * each tile's dS X_oth goes into a fresh accumulator that is added to
//     dd in registers (the tensor cores' fp32 sums truncate: one chain over
//     all 1938 rows would bias dd); s takes two hi*hi chains, not the
//     forward's four, which leaves room for dd (64 registers), the fresh
//     accumulator (64) and dS hi / lo (64);
//   * shared memory: own hi / lo 64 KB, one stage of the other tile in each
//     layout (64 + 64 KB; two stages do not fit in 227 KB), and two tiles of
//     G (32 KB). Each buffer is refilled as soon as the warps are done with
//     it: the [row][c] tile after the correlation, so it loads under the dS
//     product; X_oth^T after the dS product, so it loads under the next
//     correlation;
//   * G's rows (4 N bytes, 7752 at N = 1938) are not 16-byte aligned, so no
//     TMA: each thread copies the G elements of its own accumulator
//     positions with cp.async (8 bytes where a pair of columns is contiguous
//     and aligned, else 4) into slots of its own, two tiles ahead, and reads
//     them with no barrier.

#include <cuda_runtime.h>
#include <math.h>

#include "corr_tf32.cuh"

namespace {

enum BwdMode : int { BWD_SUMS = 0, BWD_DENSE = 1, BWD_LSE = 2 };

constexpr uint32_t BWD_G_TILE = 16 * CORR_NT * 8;  // G slots of a tile: 16 float2 a thread
constexpr int BWD_WARP_ROWS = 16;                   // bwd_sums: rows of a column partial (one warp's)

template <int kMode>
struct Bwd {
  static constexpr bool kGrads = kMode != BWD_SUMS;
  static constexpr bool kReadsG = kMode != BWD_LSE;
  static constexpr int kStages = kGrads ? 1 : 2;  // ring of the other tiles in the [row][c] layout
  static constexpr int kHi = kGrads ? 2 : 4;      // hi*hi chains of the correlation
  static constexpr uint32_t kTBytes = kGrads ? 2 * CORR_T_PART : 0;
  static constexpr uint32_t kGBytes = kReadsG ? 2 * BWD_G_TILE : 0;
  static constexpr size_t kSmem = 1024 + 2 * CORR_A_PART + kStages * CORR_STAGE + kTBytes + kGBytes + 8 * (kStages + 2);
};
static_assert(Bwd<BWD_SUMS>::kSmem <= 232448 && Bwd<BWD_DENSE>::kSmem <= 232448, "one CTA an SM");

struct BwdMaps {
  CUtensorMap own_hi, own_lo, oth_hi, oth_lo, t_hi, t_lo;
};

// One launch's operands. The owned axis is dsc0's rows (bwd_sums; dd0) or
// dsc1's (dd1); "other" is the axis swept.
struct BwdArgs {
  int n_own, n_oth, C;
  float c;         // inv_temp log2 e
  float inv_temp;
  const float* g;  // G element (own o, other t) of image b at g[b n_own n_oth + o g_so + t g_st]
  long long g_so, g_st;
  const float* lse_own;
  const float* lse_oth;
  const float* w_own;  // the gradients: r, c (K5) or gr, gc (K6) of each axis
  const float* w_oth;
  float* dd;     // the gradients: (B, n_own, C)
  float* r;      // bwd_sums: (B, n_own)
  float* cpart;  // bwd_sums: (B, n_own / 16 rounded up, n_oth), the column sums of each 16 own rows
};

// Thread (warp w, lane 4 g + t4) holds accumulator columns 8 j + 2 t4 + {0, 1}
// of rows 16 w + g (registers 4 j, 4 j + 1) and 16 w + g + 8 (4 j + 2,
// 4 j + 3). One CTA owns 64 rows (blockIdx.x) of one image (blockIdx.z) and
// sweeps all other rows; with u = s log2 e, P_own = exp(s - lse_oth)
// (softmax along the owned axis) and P_oth = exp(s - lse_own):
//   BWD_SUMS: gp = G P_own P_oth; r[b][own] = its row sums, cpart[b][own /
//     16][other] its column sums over each 16 rows;
//   BWD_DENSE (K5): dS = 2 P_own P_oth G - P_own w_oth - P_oth w_own;
//   BWD_LSE (K6): dS = w_own P_oth + w_oth P_own;
//   the gradients: dd[b][own] = sum over the other rows of dS X_oth / T.
template <int kMode>
__global__ void __launch_bounds__(CORR_NT, 1)
corr_bwd_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using K = Bwd<kMode>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_hi = base, a_lo = base + CORR_A_PART, ring = base + 2 * CORR_A_PART;
  const uint32_t t_hi = ring + K::kStages * CORR_STAGE, t_lo = t_hi + CORR_T_PART;
  const uint32_t slots = t_hi + K::kTBytes;
  const uint32_t bar0 = slots + K::kGBytes, t_bar = bar0 + 8 * K::kStages, a_bar = t_bar + 8;
  const float2* gs = reinterpret_cast<const float2*>(smem_raw + (slots - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * CORR_BM, b = blockIdx.z;
  const int nt = (a.n_oth + CORR_BN - 1) / CORR_BN;
  const int r0 = o0 + 16 * warp + g, r1 = r0 + 8;
  const float* gb = K::kReadsG ? a.g + static_cast<long long>(b) * a.n_own * a.n_oth : nullptr;
  const bool pairs = a.g_st == 1 && (a.n_oth & 1) == 0;  // a thread's two columns: 8 aligned bytes of G

  auto load_stage = [&](int t) {
    const uint32_t bar = bar0 + 8 * (t % K::kStages), stage = ring + (t % K::kStages) * CORR_STAGE;
    mbar_expect_tx(bar, CORR_STAGE);
    tma_load5(stage, &maps.oth_hi, bar, t * CORR_BN, 0, 0, b);
    tma_load5(stage + CORR_B_PART, &maps.oth_lo, bar, t * CORR_BN, 0, 0, b);
  };
  auto load_t = [&](int t) {  // both 32-row blocks of tile t, all 128 channel rows
    mbar_expect_tx(t_bar, 2 * CORR_T_PART);
    tma_load5(t_hi, &maps.t_hi, t_bar, 0, 2 * t, 0, b);
    tma_load5(t_lo, &maps.t_lo, t_bar, 0, 2 * t, 0, b);
  };
  // G of this thread's accumulator positions in tile t into its slots of
  // buffer t % 2: pair p (registers 2 p, 2 p + 1) at slot p CORR_NT + tid;
  // zero outside G. One group of copies a tile, empty past the last tile.
  auto stage_g = [&](int t) {
    const int j0 = t * CORR_BN;
#pragma unroll
    for (int p = 0; p < 16 && t < nt; ++p) {
      const int row = (p & 1) ? r1 : r0, col = j0 + 8 * (p >> 1) + 2 * t4;
      const uint32_t dst = slots + (t & 1) * BWD_G_TILE + (p * CORR_NT + tid) * 8;
      const float* at = gb + static_cast<long long>(row) * a.g_so;
      if (pairs) {
        const bool ok = row < a.n_own && col < a.n_oth;
        cp_async<8>(dst, ok ? at + col : gb, ok ? 8 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row < a.n_own && col + e < a.n_oth;
          cp_async<4>(dst + 4 * e, ok ? at + static_cast<long long>(col + e) * a.g_st : gb, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < K::kStages + 2; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(a_bar, 2 * CORR_A_PART);
    tma_load5(a_hi, &maps.own_hi, a_bar, o0, 0, 0, b);
    tma_load5(a_lo, &maps.own_lo, a_bar, o0, 0, 0, b);
    for (int t = 0; t < K::kStages && t < nt; ++t) load_stage(t);
    if (K::kGrads) load_t(0);
  }
  if constexpr (K::kReadsG) {
    stage_g(0);
    stage_g(1);
  }

  // -lse_own log2 e and w_own of rows r0, r1
  const float* lo_b = a.lse_own + static_cast<long long>(b) * a.n_own;
  const float ao0 = r0 < a.n_own ? -lo_b[r0] * CORR_LOG2E : 0.f, ao1 = r1 < a.n_own ? -lo_b[r1] * CORR_LOG2E : 0.f;
  float wo0 = 0.f, wo1 = 0.f;
  if constexpr (K::kGrads) {
    const float* wb = a.w_own + static_cast<long long>(b) * a.n_own;
    wo0 = r0 < a.n_own ? wb[r0] : 0.f;
    wo1 = r1 < a.n_own ? wb[r1] : 0.f;
  }
  const float* lt = a.lse_oth + static_cast<long long>(b) * a.n_oth;
  const float* wt = K::kGrads ? a.w_oth + static_cast<long long>(b) * a.n_oth : nullptr;
  const int wblocks = (a.n_own + BWD_WARP_ROWS - 1) / BWD_WARP_ROWS;
  float* cp = K::kGrads ? nullptr : a.cpart + (static_cast<long long>(b) * wblocks + o0 / BWD_WARP_ROWS + warp) * a.n_oth;
  mbar_wait(a_bar, 0);

  float dd[K::kGrads ? 64 : 1];  // the gradients: this thread's share of dd (64 x 128)
  float rs0 = 0.f, rs1 = 0.f;    // bwd_sums: this thread's share of the row sums of rows r0, r1
  if constexpr (K::kGrads) {
#pragma unroll
    for (int i = 0; i < 64; ++i) dd[i] = 0.f;
  }
  float s[32], x[32], h[K::kHi][32];

  for (int t = 0; t < nt; ++t) {
    const int st = t % K::kStages;
    const uint32_t stage = ring + st * CORR_STAGE;
    if (!CORR_ABLATE_LOADS || t < K::kStages) mbar_wait(bar0 + 8 * st, (t / K::kStages) & 1);
    issue_corr(x, h, a_hi, a_lo, stage, stage + CORR_B_PART);
    const int j0 = t * CORR_BN;  // the other row of accumulator column 0
    // -lse_oth log2 e and w_oth of this thread's 16 columns (index 2 j + e:
    // column 8 j + 2 t4 + e), loaded under the products
    float bo[16], wc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int col = j0 + 8 * (k >> 1) + 2 * t4 + (k & 1);
      bo[k] = col < a.n_oth ? -lt[col] * CORR_LOG2E : 0.f;
      if constexpr (K::kGrads) wc[k] = col < a.n_oth ? wt[col] : 0.f;
    }
    wgmma_wait();
    corr_sum(s, x, h);
    if constexpr (K::kReadsG) cp_async_wait<1>();  // this thread's G of tile t (tile t + 1's may be in flight)
    __syncthreads();                               // every warp is done with this stage
    if (tid == 0 && !CORR_ABLATE_LOADS && t + K::kStages < nt) load_stage(t + K::kStages);

    const float2* gt = gs + (t & 1) * (BWD_G_TILE / 8);
    if constexpr (!K::kGrads) {
      const float c2 = 2.f * a.c;
      float v[16];  // column sums of the thread's two rows, index as bo
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k = 2 * (i >> 2) + (i & 1);
        const float2 gv = gt[(i >> 1) * CORR_NT + tid];
        const float p = corr_ex2(fmaf(s[i], c2, (i & 2) ? ao1 : ao0) + bo[k]);
        const bool in = ((i & 2) ? r1 : r0) < a.n_own && j0 + 8 * (i >> 2) + 2 * t4 + (i & 1) < a.n_oth;
        const float gp = in ? ((i & 1) ? gv.y : gv.x) * p : 0.f;
        if (i & 2) {
          rs1 += gp;
        } else {
          rs0 += gp;
        }
        v[k] += gp;
      }
      // over the warp's 16 rows (lanes of equal t4), a reduce-scatter: lane
      // (g, t4) ends with the columns of index 2 g + {0, 1}
      float v8[8], v4[4], v2[2];
      const bool u2 = g & 4, u1 = g & 2, u0 = g & 1;
#pragma unroll
      for (int k = 0; k < 8; ++k) v8[k] = (u2 ? v[k + 8] : v[k]) + __shfl_xor_sync(0xffffffffu, u2 ? v[k] : v[k + 8], 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) v4[k] = (u1 ? v8[k + 4] : v8[k]) + __shfl_xor_sync(0xffffffffu, u1 ? v8[k] : v8[k + 4], 8);
#pragma unroll
      for (int k = 0; k < 2; ++k) v2[k] = (u0 ? v4[k + 2] : v4[k]) + __shfl_xor_sync(0xffffffffu, u0 ? v4[k] : v4[k + 2], 4);
      const int col = j0 + 8 * g + 2 * t4;
      if (o0 + BWD_WARP_ROWS * warp < a.n_own && col < a.n_oth) {
        cp[col] = v2[0];
        if (col + 1 < a.n_oth) cp[col + 1] = v2[1];
      }
      // after the shuffles, which need this tile's G values read
      if (!CORR_ABLATE_LOADS) stage_g(t + 2);
    } else {
      uint32_t ah[32], al[32];  // dS, A fragment order
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k = 2 * (i >> 2) + (i & 1);
        const float pa = corr_ex2(fmaf(s[i], a.c, bo[k]));                // P_own
        const float pb = corr_ex2(fmaf(s[i], a.c, (i & 2) ? ao1 : ao0));  // P_oth
        const float wo = (i & 2) ? wo1 : wo0;
        float ds;
        if constexpr (kMode == BWD_DENSE) {
          const float2 gv = gt[(i >> 1) * CORR_NT + tid];
          ds = 2.f * (pa * pb) * ((i & 1) ? gv.y : gv.x) - pa * wc[k] - pb * wo;
        } else {
          ds = wo * pb + wc[k] * pa;
        }
        if (j0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= a.n_oth) ds = 0.f;  // X_oth^T is zero there; 0 * NaN is not
        split_desc(ds, ah[(i & ~3) | ((i & 1) << 1) | ((i & 2) >> 1)], al[(i & ~3) | ((i & 1) << 1) | ((i & 2) >> 1)]);
      }
      if (!CORR_ABLATE_LOADS || t == 0) mbar_wait(t_bar, t & 1);
      float part[64];
      issue_dd(part, ah, al, t_hi, t_lo);
      // after the issue, which needs this tile's G values read
      if constexpr (K::kReadsG) {
        if (!CORR_ABLATE_LOADS) stage_g(t + 2);
      }
      wgmma_wait();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) dd[i] += part[i];
      __syncthreads();  // every warp is done with X_oth^T
      if (tid == 0 && !CORR_ABLATE_LOADS && t + 1 < nt) load_t(t + 1);
    }
  }

  if constexpr (!K::kGrads) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    float* rb = a.r + static_cast<long long>(b) * a.n_own;
    if (t4 == 0 && r0 < a.n_own) rb[r0] = rs0;
    if (t4 == 0 && r1 < a.n_own) rb[r1] = rs1;
  } else {
    // dd / T from the accumulator layout (m64n128: channels 8 j + 2 t4 + {0, 1}),
    // float2 where rows start 8-byte aligned (C even), else scalar
    float* d_r0 = a.dd + (static_cast<long long>(b) * a.n_own + r0) * a.C;
    float* d_r1 = d_r0 + 8LL * a.C;
    const bool two = (a.C & 1) == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ch = 8 * j + 2 * t4;
      if (ch >= a.C) continue;
      const float v00 = dd[4 * j] * a.inv_temp, v01 = dd[4 * j + 1] * a.inv_temp;
      const float v10 = dd[4 * j + 2] * a.inv_temp, v11 = dd[4 * j + 3] * a.inv_temp;
      if (two) {
        if (r0 < a.n_own) *reinterpret_cast<float2*>(d_r0 + ch) = make_float2(v00, v01);
        if (r1 < a.n_own) *reinterpret_cast<float2*>(d_r1 + ch) = make_float2(v10, v11);
      } else {
        const bool second = ch + 1 < a.C;
        if (r0 < a.n_own) {
          d_r0[ch] = v00;
          if (second) d_r0[ch + 1] = v01;
        }
        if (r1 < a.n_own) {
          d_r1[ch] = v10;
          if (second) d_r1[ch + 1] = v11;
        }
      }
    }
  }
}

// c[b, j] = sum of the partials cpart[b, :, j] (MT of them), in order.
__global__ void col_partials_kernel(const float* __restrict__ cpart, float* __restrict__ c, int B, int MT, int N) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * N) return;
  const int b = e / N, j = e % N;
  const float* p = cpart + static_cast<long long>(b) * MT * N + j;
  float tot = 0.f;
  for (int t = 0; t < MT; ++t) tot += p[static_cast<long long>(t) * N];
  c[e] = tot;
}

template <int kMode>
int bwd_run(const BwdMaps& maps, const BwdArgs& args, int B, cudaStream_t st) {
  // per launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(corr_bwd_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Bwd<kMode>::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  corr_bwd_kernel<kMode><<<dim3((args.n_own + CORR_BM - 1) / CORR_BM, 1, B), CORR_NT, Bwd<kMode>::kSmem, st>>>(
      maps, args);
  return static_cast<int>(cudaGetLastError());
}

// The prep of the backward kernels: with `do_split`, dsc0 and dsc1 split
// into `split` [row][128] (corr_split_floats; without, it holds their split
// already: the forward's); with `xt`, their X^T copies into it. MK_ABLATE_PREP
// (a timing build of `chip_smoke.py --matcher-bwd`) leaves both as they are.
int bwd_prep(const float* d0, const float* d1, float* split, float* xt, int B, int M, int N, int C, int do_split,
             cudaStream_t st) {
#ifdef MK_ABLATE_PREP
  return 0;
#endif
  if (do_split) {
    const int rc = corr_split(d0, d1, split, B, M, N, C, st);
    if (rc != 0) return rc;
  }
  if (xt == nullptr) return 0;
  const int most_rows = M > N ? M : N;
  split_desc_t_kernel<<<dim3((most_rows + CORR_BN - 1) / CORR_BN, B, 2), 256, 0, st>>>(d0, d1, xt, M, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of bwd_sums' column partials: one per 16 rows of dsc0.
extern "C" int mk_dual_softmax_row_blocks(int M) { return (M + BWD_WARP_ROWS - 1) / BWD_WARP_ROWS; }

// d0 (B, M, C), d1 (B, N, C) fp32, C <= 128, lse_col (B, N) -> out (B, M, N),
// lse_row (B, M). scratch: 2 (B M + B N) 128 floats (corr_launch); geom: the
// maps of dsc0's split (own) then dsc1's.
extern "C" int mk_pair_softmax_f32(const void* d0, const void* d1, const void* lse_col, void* out,
                                   void* lse_row, void* scratch, const long long* geom, int B, int M,
                                   int N, int C, float inv_temp, float alpha, void* stream) {
  return corr_launch<true, CorrTf32>(d0, d1, static_cast<float*>(scratch), geom, B, M, N, C, 1, inv_temp, alpha,
                                     nullptr, static_cast<const float*>(lse_col), static_cast<float*>(out),
                                     static_cast<float*>(lse_row), static_cast<cudaStream_t>(stream));
}

// mk_pair_softmax_f32 on bf16 descriptors (the engine's bf16 mode): scratch
// (B M + B N) 64 floats for their [row][128] bf16 copy; geom the bf16 maps.
// out and lse_row stay fp32.
extern "C" int mk_pair_softmax_bf16(const void* d0, const void* d1, const void* lse_col, void* out,
                                    void* lse_row, void* scratch, const long long* geom, int B, int M,
                                    int N, int C, float inv_temp, float alpha, void* stream) {
  return corr_launch<true, CorrBf16>(d0, d1, static_cast<float*>(scratch), geom, B, M, N, C, 1, inv_temp, alpha,
                                     nullptr, static_cast<const float*>(lse_col), static_cast<float*>(out),
                                     static_cast<float*>(lse_row), static_cast<cudaStream_t>(stream));
}

// r (B, M), c (B, N) = the row and column sums of G o P, G (B, M, N).
// cpart: (B, mk_dual_softmax_row_blocks(M), N) floats; split:
// corr_split_floats(B, M, N), written with do_split, else holding the
// split of these descriptors; geom: the maps of dsc0's split then dsc1's
// (corr_geometry, 14 each).
extern "C" int mk_dual_softmax_bwd_sums_f32(const void* d0, const void* d1, const void* g, const void* lse_row,
                                            const void* lse_col, void* r, void* c, void* cpart, void* split,
                                            const long long* geom, int B, int M, int N, int C, float inv_temp,
                                            int do_split, void* stream) {
  if (B < 1 || M < 1 || N < 1 || C < 1 || C > CORR_C || !corr_geometry_ok(geom, B, M, CORR_BM) ||
      !corr_geometry_ok(geom + 14, B, N, CORR_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(split);
  int rc = bwd_prep(static_cast<const float*>(d0), static_cast<const float*>(d1), sc, nullptr, B, M, N, C, do_split,
                    st);
  BwdMaps maps = {};
  if (rc == 0) rc = encode_pair(&maps.own_hi, &maps.own_lo, sc, static_cast<long long>(B) * M * CORR_C, geom);
  if (rc == 0)
    rc = encode_pair(&maps.oth_hi, &maps.oth_lo, sc + corr_split_floats(B, M, 0),
                     static_cast<long long>(B) * N * CORR_C, geom + 14);
  if (rc != 0) return rc;
  BwdArgs args = {};
  args.n_own = M;
  args.n_oth = N;
  args.C = C;
  args.c = inv_temp * CORR_LOG2E;
  args.inv_temp = inv_temp;
  args.g = static_cast<const float*>(g);
  args.g_so = N;
  args.g_st = 1;
  args.lse_own = static_cast<const float*>(lse_row);
  args.lse_oth = static_cast<const float*>(lse_col);
  args.r = static_cast<float*>(r);
  args.cpart = static_cast<float*>(cpart);
  rc = bwd_run<BWD_SUMS>(maps, args, B, st);
  if (rc != 0) return rc;
  col_partials_kernel<<<(B * N + 255) / 256, 256, 0, st>>>(static_cast<const float*>(cpart), static_cast<float*>(c),
                                                            B, (M + BWD_WARP_ROWS - 1) / BWD_WARP_ROWS, N);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// dd0 (B, M, C) and dd1 (B, N, C) of one gradient mode: the prep, then two
// launches, rows of dsc0 owned (dd0), then rows of dsc1 owned (dd1). w_row,
// w_col: r, c (K5) or gr, gc (K6). split: as for bwd_sums; xt: 2 (B Mp + B
// Np) 128 floats, Mp and Np the rows padded to 64; geom: the maps of dsc0's
// and dsc1's split (corr_geometry), then of their X^T copies
// (corr_t_geometry), 14 each.
template <int kMode>
int grads_both_sides(const void* d0, const void* d1, const void* g, const void* lse_row, const void* lse_col,
                     const void* w_row, const void* w_col, void* dd0, void* dd1, void* split, void* xt,
                     const long long* geom, int B, int M, int N, int C, float inv_temp, int do_split, void* stream) {
  if (split == nullptr || xt == nullptr || B < 1 || M < 1 || N < 1 || C < 1 || C > CORR_C ||
      !corr_geometry_ok(geom, B, M, CORR_BM) || !corr_geometry_ok(geom + 14, B, N, CORR_BN) ||
      !corr_t_geometry_ok(geom + 28, B, M) || !corr_t_geometry_ok(geom + 42, B, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* D0 = static_cast<const float*>(d0);
  const float* D1 = static_cast<const float*>(d1);
  float* sc = static_cast<float*>(split);
  float* x0t = static_cast<float*>(xt);
  int rc = bwd_prep(D0, D1, sc, x0t, B, M, N, C, do_split, st);
  if (rc != 0) return rc;
  const long long p0 = static_cast<long long>(B) * M * CORR_C, p1 = static_cast<long long>(B) * N * CORR_C;
  const long long pad0 = (M + CORR_BN - 1) / CORR_BN * CORR_BN, pad1 = (N + CORR_BN - 1) / CORR_BN * CORR_BN;
  const long long t0 = static_cast<long long>(B) * pad0 * CORR_C, t1 = static_cast<long long>(B) * pad1 * CORR_C;
  float* s0 = sc;
  float* s1 = sc + 2 * p0;
  float* x1t = x0t + 2 * t0;
  BwdMaps side0 = {}, side1 = {};
  rc = encode_pair(&side0.own_hi, &side0.own_lo, s0, p0, geom);
  if (rc == 0) rc = encode_pair(&side0.oth_hi, &side0.oth_lo, s1, p1, geom + 14);
  if (rc == 0) rc = encode_pair(&side0.t_hi, &side0.t_lo, x1t, t1, geom + 42);
  if (rc == 0) rc = encode_pair(&side1.own_hi, &side1.own_lo, s1, p1, geom + 14);
  if (rc == 0) rc = encode_pair(&side1.oth_hi, &side1.oth_lo, s0, p0, geom);
  if (rc == 0) rc = encode_pair(&side1.t_hi, &side1.t_lo, x0t, t0, geom + 28);
  if (rc != 0) return rc;
  BwdArgs a0 = {};
  a0.n_own = M;
  a0.n_oth = N;
  a0.C = C;
  a0.c = inv_temp * CORR_LOG2E;
  a0.inv_temp = inv_temp;
  a0.g = static_cast<const float*>(g);
  a0.g_so = N;
  a0.g_st = 1;
  a0.lse_own = static_cast<const float*>(lse_row);
  a0.lse_oth = static_cast<const float*>(lse_col);
  a0.w_own = static_cast<const float*>(w_row);
  a0.w_oth = static_cast<const float*>(w_col);
  a0.dd = static_cast<float*>(dd0);
  BwdArgs a1 = a0;
  a1.n_own = N;
  a1.n_oth = M;
  a1.g_so = 1;
  a1.g_st = N;
  a1.lse_own = a0.lse_oth;
  a1.lse_oth = a0.lse_own;
  a1.w_own = a0.w_oth;
  a1.w_oth = a0.w_own;
  a1.dd = static_cast<float*>(dd1);
  rc = bwd_run<kMode>(side0, a0, B, st);
  if (rc == 0) rc = bwd_run<kMode>(side1, a1, B, st);
  return rc;
}

}  // namespace

// dd0 = dS dsc1 / T, dd1 = dS^T dsc0 / T, dS = 2 P o G - A c - B r; r, c from
// mk_dual_softmax_bwd_sums_f32. split, xt, geom, do_split: see grads_both_sides.
extern "C" int mk_dual_softmax_bwd_grads_f32(const void* d0, const void* d1, const void* g, const void* lse_row,
                                             const void* lse_col, const void* r, const void* c, void* dd0, void* dd1,
                                             void* split, void* xt, const long long* geom, int B, int M, int N, int C,
                                             float inv_temp, int do_split, void* stream) {
  return grads_both_sides<BWD_DENSE>(d0, d1, g, lse_row, lse_col, r, c, dd0, dd1, split, xt, geom, B, M, N, C,
                                     inv_temp, do_split, stream);
}

// gr (B, M), gc (B, N): the cotangents of lse_row and lse_col.
extern "C" int mk_lse_bwd_f32(const void* d0, const void* d1, const void* gr, const void* gc, const void* lse_row,
                              const void* lse_col, void* dd0, void* dd1, void* split, void* xt, const long long* geom,
                              int B, int M, int N, int C, float inv_temp, int do_split, void* stream) {
  return grads_both_sides<BWD_LSE>(d0, d1, nullptr, lse_row, lse_col, gr, gc, dd0, dd1, split, xt, geom, B, M, N, C,
                                   inv_temp, do_split, stream);
}
