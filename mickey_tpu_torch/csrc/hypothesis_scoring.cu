// RANSAC hypothesis scoring: soft inlier count of every candidate pose.
//
// Replaces mickey_tpu/ops/hypothesis_scoring.py::fused_hypothesis_scores
// (_scoring_kernel): for each (point set e, hypothesis r)
//   out[e, r] = sum_s sigmoid((5/th) (th - sqrt(|R_r X_s + t_r - Y_s|^2 + 1e-6)))
// with the term's arithmetic and order of the TPU kernel (t + R_i0 x0 +
// R_i1 x1 + R_i2 x2; sqrtf; 1 / (1 + expf(-beta (th - dist)))).
//
// The solver scores a whole solve in one launch: e runs over the it outer
// draws times the B pairs (20 x 2 point sets of 2048 samples, 100
// hypotheses each: 8.2 M terms), where one launch per draw (0.4 M terms,
// ~0.035 ms a launch on an H100) left the card waiting on the host.
//
// What bounds it on the H100: per term ~30 fp32 operations and three
// special-function ones (the square root, the exponential and the
// reciprocal of IEEE sqrtf, expf and the division, each one MUFU operation
// plus fp32 fix-ups) at 16 a clock on each SM; device memory holds only the
// 48 KB point sets of each e, the poses and the (E, R) output. So
// operations: the SFU and the fp32 pipes about equally. Design:
//  - a CTA owns one point set e and 8 of its hypotheses; its 256 threads
//    stage e's X and Y (24 B a sample) into shared memory once by cp.async
//    (16-byte copies where aligned), 2048 samples at a time, so no
//    hypothesis re-reads them from L2;
//  - a warp scores 4 hypotheses (their poses in registers) over a quarter of
//    the samples, each lane every 128th sample: one sample's six loads serve
//    four terms, and lane l reads words 3 l + c, conflict-free; four
//    independent sums a thread. 520 CTAs of 8 warps at a solve's shape: 16
//    or 32 hypotheses a CTA (fewer CTAs, less staging) took 0.029 and 0.042
//    ms against 0.023 on an H100 SXM at 700 W;
//  - the sum over the samples has a fixed order (each lane's samples in
//    turn, a shuffle tree over the lanes, the four quarters in order), so
//    two launches agree bitwise; no atomics.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int K3_WARPS = 8;
constexpr int K3_HW = 4;                       // hypotheses a warp
constexpr int K3_QUADS = 2;                    // warps with distinct hypotheses
constexpr int K3_SPLIT = K3_WARPS / K3_QUADS;  // warps sharing them, each a share of the samples
constexpr int K3_HG = K3_QUADS * K3_HW;        // hypotheses a CTA
constexpr int K3_CHUNK = 2048;                 // samples staged at a time
constexpr size_t K3_SMEM = 2 * 3 * K3_CHUNK * sizeof(float);

// Timing ablations for `chip_smoke.py --scoring` (wrong results, never in the
// library the port loads): MK_ABLATE_SFU replaces the square root, the
// exponential and the reciprocal by one multiply-add; MK_FAST_INTRINSICS
// takes sqrt.approx, __expf and __fdividef; MK_ABLATE_SCORING stages the
// samples and scores none.
__device__ __forceinline__ float soft_term(float d2, float th, float beta) {
#if defined(MK_ABLATE_SFU)
  return fmaf(d2, -beta, th);
#elif defined(MK_FAST_INTRINSICS)
  float dist;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(dist) : "f"(d2 + 1e-6f));
  return __fdividef(1.f, 1.f + __expf(-beta * (th - dist)));
#else
  const float dist = sqrtf(d2 + 1e-6f);
  return 1.f / (1.f + expf(-beta * (th - dist)));
#endif
}

// `n` floats from global `src` into shared memory at `dst`, by every thread
// of the block; 16-byte copies where both ends allow.
__device__ __forceinline__ void stage(uint32_t dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) cp_async<16>(dst + 16 * k, src + 4 * k, 16);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) cp_async<4>(dst + 4 * k, src + k, 4);
  }
}

__global__ void __launch_bounds__(K3_WARPS * 32)
hypothesis_kernel(const float* __restrict__ X, const float* __restrict__ Y, const float* __restrict__ R9,
                  const float* __restrict__ t3, float* __restrict__ out, int S, int nR, float th) {
  extern __shared__ float xy[];  // X then Y of this chunk, [sample][3] each
  __shared__ float part[K3_SPLIT][K3_HG];
  const int e = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = warp % K3_QUADS, share = warp / K3_QUADS;
  const int g0 = blockIdx.x * K3_HG, h0 = g0 + quad * K3_HW;
  float R[K3_HW][9], t[K3_HW][3], acc[K3_HW];
#pragma unroll
  for (int k = 0; k < K3_HW; ++k) {
    const bool ok = h0 + k < nR;
    const float* Rm = R9 + (static_cast<long long>(e) * nR + h0 + k) * 9;
    const float* tv = t3 + (static_cast<long long>(e) * nR + h0 + k) * 3;
#pragma unroll
    for (int c = 0; c < 9; ++c) R[k][c] = ok ? Rm[c] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) t[k][c] = ok ? tv[c] : 0.f;
    acc[k] = 0.f;
  }
  const float beta = 5.f / th;
  const float* Xe = X + static_cast<long long>(e) * S * 3;
  const float* Ye = Y + static_cast<long long>(e) * S * 3;
  const float* xs = xy;
  const float* ys = xy + 3 * K3_CHUNK;

  for (int c0 = 0; c0 < S; c0 += K3_CHUNK) {
    const int cs = min(K3_CHUNK, S - c0);
    __syncthreads();  // every warp is done with the last chunk
    stage(smem_u32(xs), Xe + 3LL * c0, 3 * cs);
    stage(smem_u32(ys), Ye + 3LL * c0, 3 * cs);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#ifdef MK_ABLATE_SCORING
    continue;
#endif
    if (h0 >= nR) continue;  // warp-uniform: this warp has no hypothesis
    for (int s = share * 32 + lane; s < cs; s += K3_SPLIT * 32) {
      const float x0 = xs[3 * s], x1 = xs[3 * s + 1], x2 = xs[3 * s + 2];
      const float y0 = ys[3 * s], y1 = ys[3 * s + 1], y2 = ys[3 * s + 2];
#pragma unroll
      for (int k = 0; k < K3_HW; ++k) {
        float d2 = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float c = t[k][i];
          c = c + R[k][3 * i] * x0;
          c = c + R[k][3 * i + 1] * x1;
          c = c + R[k][3 * i + 2] * x2;
          const float d = c - (i == 0 ? y0 : i == 1 ? y1 : y2);
          d2 = d2 + d * d;
        }
        acc[k] += soft_term(d2, th, beta);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K3_HW; ++k) {
    for (int o = 16; o > 0; o >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    if (lane == 0) part[share][quad * K3_HW + k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < K3_HG && g0 + threadIdx.x < nR) {
    float tot = part[0][threadIdx.x];
    for (int p = 1; p < K3_SPLIT; ++p) tot += part[p][threadIdx.x];
    out[static_cast<long long>(e) * nR + g0 + threadIdx.x] = tot;
  }
}

}  // namespace

// X, Y (E, S, 3), R9 (E, nR, 9), t3 (E, nR, 3) fp32 -> out (E, nR).
extern "C" int mk_hypothesis_scores_f32(const void* X, const void* Y, const void* R9,
                                        const void* t3, void* out, int E, int S, int nR, float th,
                                        void* stream) {
  if (E < 1 || S < 1 || nR < 1) return static_cast<int>(cudaErrorInvalidValue);
  // per launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(hypothesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(K3_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((nR + K3_HG - 1) / K3_HG, E);
  hypothesis_kernel<<<grid, K3_WARPS * 32, K3_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(Y), static_cast<const float*>(R9),
      static_cast<const float*>(t3), static_cast<float*>(out), S, nR, th);
  return static_cast<int>(cudaGetLastError());
}
