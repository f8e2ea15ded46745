// Differentiable dense dual-softmax: the training matcher's forward pass and
// its analytic backward, with the (B, M, N) couplings never materialized.
//
// Replaces mickey_tpu/ops/fused_matcher.py's Pallas kernels of
// fused_dual_softmax / fused_dual_softmax_vjp:
//   K4  _pair_softmax_kernel (:107) -> mk_pair_softmax_f32: with
//       s = dsc0 dsc1^T / T, per row i the dustbin-augmented
//       lse_row_i = log(sum_j exp(s_ij) + exp(alpha)), and the dense output
//       P_ij = exp(s_ij - lse_row_i) exp(s_ij - lse_col_j). Its first pass
//       (_col_stats_kernel :82, lse_col) is col_lse in fused_topk.cu.
//   K5  _bwd_sums_kernel (:234)  -> mk_dual_softmax_bwd_sums_f32:
//       r = rowsum(G o P), c = colsum(G o P) for the upstream cotangent G;
//       _bwd_grads_kernel (:256) -> mk_dual_softmax_bwd_grads_f32:
//       dS = 2 P o G - A c - B r with A = exp(s - lse_col), B = exp(s - lse_row),
//       dd0 = dS dsc1 / T and dd1 = dS^T dsc0 / T.
// All arithmetic is fp32 FMA on the CUDA cores, never TF32: the reference
// computes the correlation at Precision.HIGHEST and 1/T = 10 turns TF32
// truncation into ~0.04 logit error.
//
// What bounds them on the H100: the recomputed correlation (2 B M N C flops per
// pass; 7.7 GFLOP at B = 8, M = N = 1938, C = 128) against 67 TFLOP/s of fp32,
// next to one pass over the (B, M, N) matrix (P written, or G read: 120 MB at
// 3.35 TB/s). So all three are bound by operations. Design:
//   * one register-tiled fp32 GEMM tile (64 x 64 per CTA of 256 threads, a
//     4 x 4 micro tile per thread, operands k-major in shared memory, the
//     whole descriptor depth C <= 128 staged at once) shared by every kernel;
//   * a CTA owns 64 rows of one axis and loops over the other axis in 64-wide
//     tiles, so a per-row reduction never leaves the CTA. The TPU kernels
//     carried column sums across a sequential grid in a revisited block; here
//     CTAs run in no order, so a reduction across row blocks is either a
//     second launch that owns the other axis (dd1) or per-row-block partials
//     summed in a fixed order by a second pass (c). No float atomics: results
//     are the same from run to run.
//   * K4 sweeps the other axis twice: online row max / sum-exp first, then
//     the writes. K5's grads kernel forms the dS tile in shared memory and
//     multiplies it with the already staged descriptor tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // rows of the owned axis per CTA
constexpr int BN = 64;        // rows of the other axis per tile
constexpr int NT = 256;       // 16 x 16 threads, a 4 x 4 micro tile each
constexpr int LDA = BM + 4;   // k-major stride of a staged descriptor tile (16-byte rows)
constexpr int LDT = BN + 1;   // stride of a G / dS tile
constexpr int CMAX = 128;     // largest descriptor depth
constexpr int CQ = CMAX / 16; // descriptor channels per thread in the dd product

static_assert(BM == BN, "one staging routine serves both operands");

// Rows [r0, r0 + 64) of X (rows x C, row-major) into S[k * LDA + r], k-major;
// rows past `rows` are zero.
__device__ __forceinline__ void stage_kmajor(const float* __restrict__ X, int r0, int rows, int C,
                                             float* __restrict__ S) {
  for (int e = threadIdx.x; e < BM * C; e += NT) {
    const int r = e / C, k = e % C;
    S[k * LDA + r] = (r0 + r < rows) ? X[(size_t)(r0 + r) * C + k] : 0.f;
  }
}

// acc[a][b] = sum_k As[k][ty*4 + a] * Bs[k][tx*4 + b]
__device__ __forceinline__ void tile_dot(const float* __restrict__ As, const float* __restrict__ Bs,
                                         int C, float acc[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k = 0; k < C; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(As + k * LDA + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(Bs + k * LDA + tx * 4);
    const float x[4] = {av.x, av.y, av.z, av.w};
    const float y[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// Sum over the 16 threads that share a row (lanes of one half-warp).
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
pair_softmax_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
                    const float* __restrict__ lse_col, float* __restrict__ out,
                    float* __restrict__ lse_row, int M, int N, int C, float inv_temp, float alpha) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;
  float* Bs = sm + C * LDA;
  const int b = blockIdx.y, i0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* D0 = d0 + (size_t)b * M * C;
  const float* D1 = d1 + (size_t)b * N * C;
  const float* LC = lse_col + (size_t)b * N;

  stage_kmajor(D0, i0, M, C, As);
  float mx[4], sx[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) mx[a] = -INFINITY, sx[a] = 0.f;

  // sweep 1: online row max / sum-exp over this thread's columns
  float acc[4][4];
  for (int j0 = 0; j0 < N; j0 += BN) {
    __syncthreads();
    stage_kmajor(D1, j0, N, C, Bs);
    __syncthreads();
    tile_dot(As, Bs, C, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + tx * 4 + c >= N) continue;
        const float v = acc[a][c] * inv_temp;
        if (v > mx[a]) {
          sx[a] = sx[a] * expf(mx[a] - v) + 1.f;
          mx[a] = v;
        } else {
          sx[a] += expf(v - mx[a]);
        }
      }
  }
  float lse[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    for (int o = 8; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[a], o);
      const float os = __shfl_xor_sync(0xffffffffu, sx[a], o);
      const float nm = fmaxf(mx[a], om);
      const float mine = mx[a] == -INFINITY ? 0.f : sx[a] * expf(mx[a] - nm);
      const float theirs = om == -INFINITY ? 0.f : os * expf(om - nm);
      sx[a] = mine + theirs;
      mx[a] = nm;
    }
    // the dustbin column, as the TPU kernel folds it: max(row max, alpha)
    const float rm = fmaxf(mx[a], alpha);
    lse[a] = logf(sx[a] * expf(mx[a] - rm) + expf(alpha - rm)) + rm;
    const int i = i0 + ty * 4 + a;
    if (tx == 0 && i < M) lse_row[(size_t)b * M + i] = lse[a];
  }

  // sweep 2: the dense output
  for (int j0 = 0; j0 < N; j0 += BN) {
    __syncthreads();
    stage_kmajor(D1, j0, N, C, Bs);
    __syncthreads();
    tile_dot(As, Bs, C, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      if (i >= M) continue;
      float* orow = out + ((size_t)b * M + i) * N;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx * 4 + c;
        if (j >= N) continue;
        const float v = acc[a][c] * inv_temp;
        orow[j] = expf(v - lse[a]) * expf(v - LC[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
bwd_sums_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
                const float* __restrict__ g, const float* __restrict__ lse_row,
                const float* __restrict__ lse_col, float* __restrict__ r,
                float* __restrict__ cpart, int M, int N, int C, float inv_temp) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;
  float* Bs = sm + C * LDA;
  float* Gs = Bs + C * LDA;           // BM x LDT
  __shared__ float red[NT / 32][BN];  // column partials of the 8 warps
  const int b = blockIdx.y, i0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* D0 = d0 + (size_t)b * M * C;
  const float* D1 = d1 + (size_t)b * N * C;
  const float* Gb = g + (size_t)b * M * N;
  const float* LC = lse_col + (size_t)b * N;
  float* CP = cpart + ((size_t)b * gridDim.x + blockIdx.x) * N;

  stage_kmajor(D0, i0, M, C, As);
  float lr[4], rs[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    lr[a] = i < M ? lse_row[(size_t)b * M + i] : 0.f;
    rs[a] = 0.f;
  }

  float acc[4][4];
  for (int j0 = 0; j0 < N; j0 += BN) {
    __syncthreads();
    stage_kmajor(D1, j0, N, C, Bs);
    for (int e = threadIdx.x; e < BM * BN; e += NT) {
      const int oo = e / BN, tt = e % BN, i = i0 + oo, j = j0 + tt;
      Gs[oo * LDT + tt] = (i < M && j < N) ? Gb[(size_t)i * N + j] : 0.f;
    }
    __syncthreads();
    tile_dot(As, Bs, C, acc);
    float cp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + ty * 4 + a, j = j0 + tx * 4 + c;
        if (i >= M || j >= N) continue;
        const float v = acc[a][c] * inv_temp;
        const float gp = Gs[(ty * 4 + a) * LDT + tx * 4 + c] * expf(2.f * v - lr[a] - LC[j]);
        rs[a] += gp;
        cp[c] += gp;
      }
    // column partials over this CTA's 64 rows, in a fixed order
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cp[c] += __shfl_xor_sync(0xffffffffu, cp[c], 16);
      if (lane < 16) red[warp][tx * 4 + c] = cp[c];
    }
    __syncthreads();
    if (threadIdx.x < BN && j0 + threadIdx.x < N) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) tot += red[w][threadIdx.x];
      CP[j0 + threadIdx.x] = tot;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float v = row_sum16(rs[a]);
    const int i = i0 + ty * 4 + a;
    if (tx == 0 && i < M) r[(size_t)b * M + i] = v;
  }
}

// c[b, j] = sum over row blocks of cpart[b, :, j], in order.
__global__ void col_partials_kernel(const float* __restrict__ cpart, float* __restrict__ c,
                                    int B, int MT, int N) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * N) return;
  const int b = e / N, j = e % N;
  const float* p = cpart + (size_t)b * MT * N + j;
  float tot = 0.f;
  for (int t = 0; t < MT; ++t) tot += p[(size_t)t * N];
  c[e] = tot;
}

// One side of the gradient: the CTA owns 64 rows of the `own` axis (dsc0's for
// dd0, dsc1's for dd1) and loops over the other axis. G element (own o,
// other t) sits at g[o * g_so + t * g_st]; lse / sums come per axis.
//   dS = 2 exp(s - lse_own) exp(s - lse_oth) G - exp(s - lse_oth) sum_oth
//        - exp(s - lse_own) sum_own
//   dd[o] = sum_t dS[o, t] Xt[t] / T
__global__ void __launch_bounds__(NT)
bwd_grads_kernel(const float* __restrict__ xo, const float* __restrict__ xt,
                 const float* __restrict__ g, long long g_so, long long g_st,
                 const float* __restrict__ lse_own, const float* __restrict__ lse_oth,
                 const float* __restrict__ sum_own, const float* __restrict__ sum_oth,
                 float* __restrict__ dd, int n_own, int n_oth, int C, float inv_temp) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;
  float* Bs = sm + C * LDA;
  float* Ds = Bs + C * LDA;  // BM x LDT: G, then dS in place
  const int b = blockIdx.y, o0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* XO = xo + (size_t)b * n_own * C;
  const float* XT = xt + (size_t)b * n_oth * C;
  const float* Gb = g + (size_t)b * n_own * n_oth;
  const float* LT = lse_oth + (size_t)b * n_oth;
  const float* ST = sum_oth + (size_t)b * n_oth;

  stage_kmajor(XO, o0, n_own, C, As);
  float lo[4], so[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty * 4 + a;
    lo[a] = o < n_own ? lse_own[(size_t)b * n_own + o] : 0.f;
    so[a] = o < n_own ? sum_own[(size_t)b * n_own + o] : 0.f;
  }
  float out[4][CQ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < CQ; ++q) out[a][q] = 0.f;

  float acc[4][4];
  for (int t0 = 0; t0 < n_oth; t0 += BN) {
    __syncthreads();
    stage_kmajor(XT, t0, n_oth, C, Bs);
    for (int e = threadIdx.x; e < BM * BN; e += NT) {
      // neighbouring threads on neighbouring addresses of G
      const int oo = g_st == 1 ? e / BN : e % BM;
      const int tt = g_st == 1 ? e % BN : e / BM;
      const int o = o0 + oo, t = t0 + tt;
      Ds[oo * LDT + tt] = (o < n_own && t < n_oth) ? Gb[o * g_so + t * g_st] : 0.f;
    }
    __syncthreads();
    tile_dot(As, Bs, C, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = o0 + ty * 4 + a, t = t0 + tx * 4 + c;
        float* slot = Ds + (ty * 4 + a) * LDT + tx * 4 + c;
        if (o >= n_own || t >= n_oth) {
          *slot = 0.f;
          continue;
        }
        const float v = acc[a][c] * inv_temp;
        const float pa = expf(v - LT[t]);   // softmax along the owned axis
        const float pb = expf(v - lo[a]);   // softmax along the other axis
        *slot = 2.f * (pa * pb) * *slot - pa * ST[t] - pb * so[a];
      }
    __syncthreads();
    for (int tt = 0; tt < BN; ++tt) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = Ds[(ty * 4 + a) * LDT + tt];
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int k = tx + 16 * q;
        if (k >= C) break;
        const float x = Bs[k * LDA + tt];
#pragma unroll
        for (int a = 0; a < 4; ++a) out[a][q] = fmaf(ds[a], x, out[a][q]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty * 4 + a;
    if (o >= n_own) continue;
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int k = tx + 16 * q;
      if (k < C) dd[((size_t)b * n_own + o) * C + k] = out[a][q] * inv_temp;
    }
  }
}

size_t operand_bytes(int C) { return (size_t)2 * C * LDA * sizeof(float); }
size_t tile_bytes() { return (size_t)BM * LDT * sizeof(float); }

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int mk_dual_softmax_row_blocks(int M) { return (M + BM - 1) / BM; }

extern "C" int mk_pair_softmax_f32(const void* d0, const void* d1, const void* lse_col, void* out,
                                   void* lse_row, int B, int M, int N, int C, float inv_temp,
                                   float alpha, void* stream) {
  if (C < 1 || C > CMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = operand_bytes(C);
  int e = set_smem((const void*)pair_softmax_kernel, smem);
  if (e) return e;
  pair_softmax_kernel<<<dim3((M + BM - 1) / BM, B), NT, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(d0), static_cast<const float*>(d1),
      static_cast<const float*>(lse_col), static_cast<float*>(out), static_cast<float*>(lse_row),
      M, N, C, inv_temp, alpha);
  return (int)cudaGetLastError();
}

// cpart: scratch of (B, mk_dual_softmax_row_blocks(M), N) floats.
extern "C" int mk_dual_softmax_bwd_sums_f32(const void* d0, const void* d1, const void* g,
                                            const void* lse_row, const void* lse_col, void* r,
                                            void* c, void* cpart, int B, int M, int N, int C,
                                            float inv_temp, void* stream) {
  if (C < 1 || C > CMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = operand_bytes(C) + tile_bytes();
  int e = set_smem((const void*)bwd_sums_kernel, smem);
  if (e) return e;
  const int MT = (M + BM - 1) / BM;
  cudaStream_t s = (cudaStream_t)stream;
  bwd_sums_kernel<<<dim3(MT, B), NT, smem, s>>>(
      static_cast<const float*>(d0), static_cast<const float*>(d1), static_cast<const float*>(g),
      static_cast<const float*>(lse_row), static_cast<const float*>(lse_col),
      static_cast<float*>(r), static_cast<float*>(cpart), M, N, C, inv_temp);
  e = (int)cudaGetLastError();
  if (e) return e;
  col_partials_kernel<<<(B * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(cpart),
                                                          static_cast<float*>(c), B, MT, N);
  return (int)cudaGetLastError();
}

// Two launches: rows of dsc0 owned (dd0), then rows of dsc1 owned (dd1).
extern "C" int mk_dual_softmax_bwd_grads_f32(const void* d0, const void* d1, const void* g,
                                             const void* lse_row, const void* lse_col,
                                             const void* r, const void* c, void* dd0, void* dd1,
                                             int B, int M, int N, int C, float inv_temp,
                                             void* stream) {
  if (C < 1 || C > CMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = operand_bytes(C) + tile_bytes();
  int e = set_smem((const void*)bwd_grads_kernel, smem);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* D0 = static_cast<const float*>(d0);
  const float* D1 = static_cast<const float*>(d1);
  const float* G = static_cast<const float*>(g);
  const float* LR = static_cast<const float*>(lse_row);
  const float* LC = static_cast<const float*>(lse_col);
  const float* R = static_cast<const float*>(r);
  const float* Cs = static_cast<const float*>(c);
  bwd_grads_kernel<<<dim3((M + BM - 1) / BM, B), NT, smem, s>>>(
      D0, D1, G, (long long)N, 1LL, LR, LC, R, Cs, static_cast<float*>(dd0), M, N, C, inv_temp);
  e = (int)cudaGetLastError();
  if (e) return e;
  bwd_grads_kernel<<<dim3((N + BM - 1) / BM, B), NT, smem, s>>>(
      D1, D0, G, 1LL, (long long)N, LC, LR, Cs, R, static_cast<float*>(dd1), N, M, C, inv_temp);
  return (int)cudaGetLastError();
}
