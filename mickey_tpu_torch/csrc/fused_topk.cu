// Fused matcher -> top-K: the dual-softmax match matrix never reaches
// device memory.
//
// Replaces mickey_tpu/ops/fused_matcher.py::fused_topk_scores, i.e. its two
// Pallas kernels driven by _topk_candidates:
//   K2a  _col_stats_kernel  -> mk_col_lse_f32: per column j of the
//        correlation s = dsc0 dsc1^T / T, lse_col_j = logsumexp_i s_ij,
//        folded with the dustbin logit alpha by a closed-form logaddexp
//        (the TPU kernel's glue at _topk_candidates:546-547 moves in here);
//   K2b  _pair_topk_kernel  -> mk_pair_topk_f32: per row i, lse_row_i
//        including alpha, the final score
//        f_ij = exp(s_ij - lse_row_i) exp(s_ij - lse_col_j) scr0_i scr1_j,
//        the row's top-L (value, flat index i*N + j) by L rounds of
//        max / first index / mask, and the row's validity partials
//        (mass, non-finite count, minimum).
// The reference computes the correlation at Precision.HIGHEST (1/T = 10
// turns TF32 truncation into ~0.04 logit error). K2a runs it at fp32
// accuracy as 3xTF32 wgmma on the correlation engine of corr_tf32.cuh
// (its design and bound are there): each CTA owns 64 columns (dsc1 rows)
// and sweeps one chunk of dsc0's rows; col_lse_combine_kernel folds the
// chunks' (max, sum) partials in a fixed order and adds alpha, so no float
// atomics and two launches agree bitwise. K2b is plain fp32 FMA on the CUDA
// cores.
//
// What bounds K2b on the H100: it recomputes the B x M x N x C correlation
// (~0.5 GFMA per pair at M = N = 1938, C = 128) in fp32 on the CUDA cores;
// the device memory traffic is only the descriptors and the (B, L, M) table.
// K2b gives each warp one row: the row's N scores live in shared memory, so
// the softmax, the final scores and all L selection rounds touch device
// memory once. CTAs of 8 warps share each staged chunk of dsc1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "corr_tf32.cuh"

namespace {

constexpr int WR = 8;       // K2b: rows (warps) per CTA
constexpr int CJ = 64;      // K2b: dsc1 rows per staged chunk

__device__ __forceinline__ float logaddexp(float x, float y) {
  // jnp.logaddexp: amax + log1p(exp(-|x - y|)), NaN-propagating
  float d = x - y;
  if (isnan(d)) return x + y;
  return fmaxf(x, y) + log1pf(expf(-fabsf(d)));
}

// lse_col[b, j] = logaddexp(logsumexp of column j, alpha) from the engine's
// partials part[b, chunk, j] = (shift, sum of exp2(u - shift)), u = s log2 e,
// summed over the chunks in order.
__global__ void col_lse_combine_kernel(const float2* __restrict__ part, float* __restrict__ lse_col, int B,
                                       int chunks, int N, float alpha) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * N) return;
  const int b = e / N, j = e % N;
  const float2* p = part + static_cast<long long>(b) * chunks * N + j;
  float top = -INFINITY;
  for (int k = 0; k < chunks; ++k) top = fmaxf(top, p[static_cast<long long>(k) * N].x);
  float tot = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float2 v = p[static_cast<long long>(k) * N];
    tot += v.y * exp2f(v.x - top);
  }
  lse_col[e] = logaddexp((log2f(tot) + top) * CORR_LN2, alpha);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(WR * 32)
pair_topk_kernel(const float* __restrict__ d0, const float* __restrict__ d1,
                 const float* __restrict__ scr0, const float* __restrict__ scr1,
                 const float* __restrict__ lse_col, float* __restrict__ vals,
                 int* __restrict__ idxs, float* __restrict__ stats, float* __restrict__ lse_row,
                 int M, int N, int C, int L, float inv_temp, float alpha) {
  extern __shared__ float sm[];
  float* d1s = sm;                    // CJ x (C + 1) chunk of dsc1
  float* d0r = d1s + CJ * (C + 1);    // WR x C: each warp's dsc0 row
  float* srow = d0r + WR * C;         // WR x N: each warp's scores

  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WR + warp;
  const bool active = i < M;
  const float* D1 = d1 + (size_t)b * N * C;
  float* s = srow + (size_t)warp * N;

  for (int k = lane; k < C; k += 32)
    d0r[warp * C + k] = active ? d0[((size_t)b * M + i) * C + k] : 0.f;

  for (int j0 = 0; j0 < N; j0 += CJ) {
    __syncthreads();
    for (int e = threadIdx.x; e < CJ * C; e += WR * 32) {
      int jj = e / C, k = e % C, j = j0 + jj;
      d1s[jj * (C + 1) + k] = j < N ? D1[(size_t)j * C + k] : 0.f;
    }
    __syncthreads();
    for (int jj = lane; jj < CJ && j0 + jj < N; jj += 32) {
      float acc = 0.f;
      for (int k = 0; k < C; ++k) acc = fmaf(d0r[warp * C + k], d1s[jj * (C + 1) + k], acc);
      s[j0 + jj] = acc * inv_temp;
    }
  }
  if (!active) return;  // no block-wide barrier below
  __syncwarp();

  // row logsumexp including the dustbin column
  float mx = alpha;
  for (int j = lane; j < N; j += 32) mx = fmaxf(mx, s[j]);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) sum += expf(s[j] - mx);
  sum = warp_sum(sum) + expf(alpha - mx);
  const float lse = logf(sum) + mx;

  // final scores (in place) and validity partials
  const float sc0 = scr0[(size_t)b * M + i];
  const float* LC = lse_col + (size_t)b * N;
  const float* S1 = scr1 + (size_t)b * N;
  float mass = 0.f, nonfinite = 0.f, mn = INFINITY;
  for (int j = lane; j < N; j += 32) {
    float f = expf(s[j] - lse) * expf(s[j] - LC[j]);
    f = f * sc0 * S1[j];
    s[j] = f;
    mass += f;
    if (!isfinite(f)) nonfinite += 1.f;
    mn = fminf(mn, f);
  }
  mass = warp_sum(mass);
  nonfinite = warp_sum(nonfinite);
  for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  if (lane == 0) {
    float* st = stats + ((size_t)b * M + i) * 3;
    st[0] = mass;
    st[1] = nonfinite;
    st[2] = mn;
    lse_row[(size_t)b * M + i] = lse;
  }
  __syncwarp();

  // top-L: L rounds of (max, first index attaining it, mask with -inf).
  // A NaN anywhere in the row makes the round's max NaN, as jnp.max does;
  // then no entry equals it and the index clamps to N - 1.
  for (int l = 0; l < L; ++l) {
    float best = -INFINITY;
    int bj = INT32_MAX;
    bool nan = false;
    for (int j = lane; j < N; j += 32) {
      float v = s[j];
      nan |= isnan(v);
      if (v > best || (v == best && j < bj)) {
        best = v;
        bj = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      float ob = __shfl_xor_sync(0xffffffffu, best, o);
      int oj = __shfl_xor_sync(0xffffffffu, bj, o);
      if (ob > best || (ob == best && oj < bj)) {
        best = ob;
        bj = oj;
      }
    }
    nan = __any_sync(0xffffffffu, nan);
    if (nan) bj = N - 1;
    bj = min(bj, N - 1);
    if (lane == 0) {
      size_t o = ((size_t)b * L + l) * M + i;
      vals[o] = nan ? NAN : fmaxf(best, 0.f);
      idxs[o] = i * N + bj;
      s[bj] = -INFINITY;
    }
    __syncwarp();
  }
}

}  // namespace

// d0 (B, M, C), d1 (B, N, C) fp32, C <= 128 -> lse_col (B, N). scratch:
// corr_split_floats(B, M, N) floats of split descriptors (corr_launch), then
// the partials, B x chunks x N float2; chunks: how many chunks of dsc0's rows
// (ops/fused_matcher.py::col_lse_chunks); geom: the maps of dsc1's split
// (own) then dsc0's.
extern "C" int mk_col_lse_f32(const void* d0, const void* d1, void* lse_col, void* scratch, const long long* geom,
                              int B, int M, int N, int C, int chunks, float inv_temp, float alpha, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(static_cast<float*>(scratch) + corr_split_floats(B, M, N));
  int rc = corr_launch<false>(static_cast<const float*>(d0), static_cast<const float*>(d1),
                              static_cast<float*>(scratch), geom, B, M, N, C, chunks, inv_temp, alpha, part, nullptr,
                              nullptr, nullptr, st);
  if (rc != 0) return rc;
  col_lse_combine_kernel<<<(B * N + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(lse_col), B, chunks, N,
                                                                alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" size_t mk_pair_topk_smem_bytes(int N, int C) {
  return (size_t)(CJ * (C + 1) + WR * C + WR * N) * sizeof(float);
}

extern "C" int mk_pair_topk_f32(const void* d0, const void* d1, const void* scr0,
                                const void* scr1, const void* lse_col, void* vals, void* idxs,
                                void* stats, void* lse_row, int B, int M, int N, int C, int L,
                                float inv_temp, float alpha, void* stream) {
  size_t smem = mk_pair_topk_smem_bytes(N, C);
  cudaError_t e = cudaFuncSetAttribute(pair_topk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + WR - 1) / WR, B);
  pair_topk_kernel<<<grid, WR * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(d0), static_cast<const float*>(d1),
      static_cast<const float*>(scr0), static_cast<const float*>(scr1),
      static_cast<const float*>(lse_col), static_cast<float*>(vals), static_cast<int*>(idxs),
      static_cast<float*>(stats), static_cast<float*>(lse_row), M, N, C, L, inv_temp, alpha);
  return (int)cudaGetLastError();
}
