// The 3 x 3 SVD of the solver's covariances, one thread a matrix.
//
// It replaces no TPU kernel. The JAX package's SVD
// (mickey_tpu/geometry/kabsch.py::_svd3x3_primal) is plain jnp code, and XLA
// fuses its six Jacobi sweeps into one program; eager PyTorch runs the same
// code (geometry/kabsch.py::svd3x3_plain, its plain version) as ~830
// elementwise launches a call, and the solver calls it five times a served
// batch (the minimal sets, then each of 4 refinements) and five times a
// training step, so the card waited on the host's launches.
//
// It reproduces svd3x3_plain op for op, in fp32: the same 6 sweeps of
// rotations (0,1), (0,2), (1,2) with the same skip predicate and its 1e-30
// guard, the descending sorting network, u0 and u1 with the eps clamps, the
// rank-1 completion by the least-aligned axis, u2 as a normalized cross
// product and the flip of V's third column. Each product, sum and
// difference is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nvcc
// contracts none of them into an FMA, as the plain version's separate
// launches never fuse), divisions and square roots are IEEE, clamps pass NaN
// through as torch.clamp does, and a comparison with NaN is false as in
// torch.where's conditions. Two forms follow PyTorch's own kernels on the
// card, as read on an H100 with torch 2.11: a sum over three values adds
// (x0 + x2) + x1 (its reduction splits a row over two threads), and
// torch.linalg.cross forms a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)). So the
// outputs are the plain version's bit for bit, and zero, rank-1 and rank-2
// matrices, reflections, NaN and infinities come out as it gives them.
//
// What bounds it on the H100: the launch. A matrix is 36 B in and 84 B out
// (U, S, V): 120 B, 1.9 MB for the 16000 minimal sets of a served batch, or
// 0.6 us at 3.35 TB/s; its work is ~1.3 kFLOP, 21 MFLOP a batch, 0.31 us
// at 67 TFLOP/s. The plain version's launches cost far more than either.
// Design: one launch a call; a thread keeps A's three columns and V's in
// registers (all indices are compile-time, so nothing spills to local
// memory) and writes U, S and V once; nothing goes to shared memory and
// nothing stays in device memory between sweeps. Blocks of 128 threads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SVD_THREADS = 128;
constexpr int SVD_SWEEPS = 6;  // geometry/kabsch.py::_JACOBI_SWEEPS

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (a * b).sum(-1), and torch.linalg.norm's sum of squares: (x0 + x2) + x1
__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return add(add(mul(a[0], b[0]), mul(a[2], b[2])), mul(a[1], b[1]));
}

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

// torch.linalg.cross(a, b): the first product of each component fused
__device__ __forceinline__ void cross3(const float (&a)[3], const float (&b)[3], float (&out)[3]) {
  out[0] = __fmaf_rn(a[1], b[2], -mul(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -mul(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -mul(a[1], b[0]));
}

// v / clamp(||v||, lo), the norm summed as dot3 sums
__device__ __forceinline__ void normalize(float (&v)[3], float lo) {
  const float n = clamp_min(__fsqrt_rn(dot3(v, v)), lo);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = __fdiv_rn(v[i], n);
}

// geometry/kabsch.py::_jacobi_rotate: orthogonalize columns P, Q of A
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(float (&A)[3][3], float (&V)[3][3]) {
  const float alpha = dot3(A[P], A[P]);
  const float beta = dot3(A[Q], A[Q]);
  const float gamma = dot3(A[P], A[Q]);
  const bool skip = fabsf(gamma) <= add(mul(1e-7f, __fsqrt_rn(mul(alpha, beta))), 1e-30f);
  const float zeta = __fdiv_rn(sub(beta, alpha), mul(2.f, skip ? 1.f : gamma));
  const float t = __fdiv_rn(zeta >= 0.f ? 1.f : -1.f, add(fabsf(zeta), __fsqrt_rn(add(1.f, mul(zeta, zeta)))));
  float c = rsqrtf(add(1.f, mul(t, t)));  // torch.rsqrt's own call
  float s = mul(c, t);
  if (skip) {
    c = 1.f;
    s = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ap = A[P][i], aq = A[Q][i];
    A[P][i] = sub(mul(c, ap), mul(s, aq));
    A[Q][i] = add(mul(s, ap), mul(c, aq));
    const float vp = V[P][i], vq = V[Q][i];
    V[P][i] = sub(mul(c, vp), mul(s, vq));
    V[Q][i] = add(mul(s, vp), mul(c, vq));
  }
}

// one step of the sorting network: columns I, J swap where S[I] < S[J]
template <int I, int J>
__device__ __forceinline__ void order(float (&S)[3], float (&A)[3][3], float (&V)[3][3]) {
  if (S[I] < S[J]) {
    float x = S[I];
    S[I] = S[J];
    S[J] = x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x = A[I][k];
      A[I][k] = A[J][k];
      A[J][k] = x;
      x = V[I][k];
      V[I][k] = V[J][k];
      V[J][k] = x;
    }
  }
}

// H (n, 3, 3) row-major -> U (n, 3, 3) = [u0 u1 u2] as columns, S (n, 3)
// descending, V (n, 3, 3) as columns: H ~= U diag(S) V^T
__global__ void __launch_bounds__(SVD_THREADS)
svd3x3_kernel(const float* __restrict__ H, float* __restrict__ U, float* __restrict__ S,
              float* __restrict__ V, long long n) {
  const long long m = static_cast<long long>(blockIdx.x) * SVD_THREADS + threadIdx.x;
  if (m >= n) return;
  const float* h = H + 9 * m;
  float A[3][3], W[3][3];  // columns: A[j][i] = H[i][j]; W is V, started at the identity
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[j][i] = h[3 * i + j];
      W[j][i] = i == j ? 1.f : 0.f;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < SVD_SWEEPS; ++sweep) {
    jacobi_rotate<0, 1>(A, W);
    jacobi_rotate<0, 2>(A, W);
    jacobi_rotate<1, 2>(A, W);
  }
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) s[j] = __fsqrt_rn(dot3(A[j], A[j]));
  order<0, 1>(s, A, W);
  order<0, 2>(s, A, W);
  order<1, 2>(s, A, W);

  constexpr float eps = 1e-12f;
  float u0[3], u1[3], u2[3];
  const float d0 = clamp_min(s[0], eps), d1 = clamp_min(s[1], eps);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u0[i] = __fdiv_rn(A[0][i], d0);
    u1[i] = __fdiv_rn(A[1][i], d1);
  }
  if (s[1] <= mul(eps, clamp_min(s[0], 1.f))) {  // rank <= 1: a unit vector orthogonal to u0
    const float x = fabsf(u0[0]), y = fabsf(u0[1]), z = fabsf(u0[2]);
    const bool use_x = x <= y && x <= z;
    const bool use_y = !use_x && y <= z;
    const float e[3] = {use_x ? 1.f : 0.f, use_y ? 1.f : 0.f, use_x || use_y ? 0.f : 1.f};
    cross3(u0, e, u1);
    normalize(u1, 1e-20f);
  }
  cross3(u0, u1, u2);
  normalize(u2, eps);
  if (dot3(u2, A[2]) < 0.f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) W[2][i] = -W[2][i];
  }
  float* u = U + 9 * m;
  float* v = V + 9 * m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[3 * i] = u0[i];
    u[3 * i + 1] = u1[i];
    u[3 * i + 2] = u2[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[3 * i + k] = W[k][i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) S[3 * m + k] = s[k];
}

}  // namespace

// H (n, 3, 3) fp32 -> U (n, 3, 3), S (n, 3), V (n, 3, 3); n = 0 launches nothing.
extern "C" int mk_svd3x3_f32(const float* H, float* U, float* S, float* V, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + SVD_THREADS - 1) / SVD_THREADS;
  svd3x3_kernel<<<static_cast<unsigned>(blocks), SVD_THREADS, 0, stream>>>(H, U, S, V, n);
  return static_cast<int>(cudaGetLastError());
}
