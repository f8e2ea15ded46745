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
//       packed bf16 qkv upcast to fp32 at load, fp32 products, bf16 out, keys
//       at or past seq_len masked -> mk_flash_attention_packed_upcast_bf16.
//
// Numerics follow _online_softmax_attend with fp32 operands: both products
// in IEEE fp32 FFMA (no TF32, no tensor cores: TF32 rounds operands to 10
// mantissa bits, which would break the 1e-5 parity this mode exists for),
// the 1/sqrt(D) scale applied to the fp32 scores, keys >= seq_len at -1e30,
// fp32 running max / sum / accumulator, the probabilities kept in fp32 for
// the PV product (the bf16 K1 rounds them to bf16), the output
// acc / max(l, 1e-30) stored in the input type.
//
// What bounds it on the H100: 4 S^2 D flops per (image, head) against about
// S * 4D * 4 bytes moved, so it is compute bound, at the card's 67 TFLOP/s
// fp32 FMA rate. The design keeps the S x S scores out of device memory (one
// 64 x 64 tile in shared memory at a time) and runs both products as a
// register-tiled SIMT product: one CTA of 256 threads per (image, head,
// 64-query tile), 64-key tiles; each thread owns a 4 x 4 micro-tile of the
// scores and then of the output, and reads float4 fragments of the
// transposed Q, K and P tiles and of the V tile (two 16-byte shared loads per
// 16 FFMA). The 16 threads that share a row are 16 neighbouring lanes of one
// warp, so row max and row sum are shuffle reductions. The ragged last tiles
// are bounds-checked (zero-filled rows, masked keys, masked stores), never
// padded. Shared memory: four 64 x 68 fp32 tiles, 68 KB, above the 48 KB
// default, so the launcher opts in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_layout.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;     // head dim (ViT-S/B/L all use 64)
constexpr int BQ = 64;    // queries per CTA
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int LD = 68;    // fp32 smem row stride: float4-aligned; rows 4 apart land 16 banks apart
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr size_t SMEM_BYTES = 4 * 64 * LD * sizeof(float);  // Qt, Kt, V, Pt

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + 64) of one 64-wide head slice into shared memory as fp32,
// transposed (dst[c * LD + r]) or not (dst[r * LD + c]); rows >= S are
// zero-filled. Transposed, neighbouring threads take neighbouring rows, so
// their column-major stores fall in distinct banks.
template <bool kTranspose, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int S, long long row_stride) {
  constexpr int V = 16 / sizeof(T), PER_ROW = D / V;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = kTranspose ? i % 64 : i / PER_ROW;
    const int c = (kTranspose ? i / 64 : i % PER_ROW) * V;
    const int row = r0 + r;
    float x[V];
    if (row < S) {
      load16(src + (long long)row * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (kTranspose) {
        dst[(c + e) * LD + r] = x[e];
      } else {
        dst[r * LD + c + e] = x[e];
      }
    }
  }
}

template <typename In, typename Out>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const AttnLayout<In, Out> L, int S, int seq_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;          // [d][query]
  float* Kt = Qt + D * LD;   // [d][key]
  float* Vs = Kt + D * LD;   // [key][d]
  float* Pt = Vs + BK * LD;  // [key][query]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const In* qb = L.q + b * L.q_b + h * L.q_h;
  const In* kb = L.k + b * L.k_b + h * L.k_h;
  const In* vb = L.v + b * L.v_b + h * L.v_h;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int r0 = ty * 4;  // this thread's 4 query rows
  const int c0 = tx * 4;  // and its 4 key columns of S, then 4 d columns of O

  load_tile<true>(Qt, qb, q0, S, L.q_s);

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P no longer in use (and Q loaded)
    load_tile<true>(Kt, kb, k0, S, L.k_s);
    load_tile<false>(Vs, vb, k0, S, L.v_s);
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 micro-tile, fp32 FFMA
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(Qt + d * LD + r0);
      const float4 b4 = *reinterpret_cast<const float4*>(Kt + d * LD + c0);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, bk[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax over each row's 64 columns, shared by 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = s[i][j] * scale;
        if (k0 + c0 + j >= seq_len) v = NEG_INF;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }

    // P^T into shared memory (fp32): key column c0 + j holds this thread's 4 rows
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (c0 + j) * LD + r0) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V for this thread's 4 rows x 4 d columns
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + kk * LD + r0);
      const float4 v4 = *reinterpret_cast<const float4*>(Vs + kk * LD + c0);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
    }
  }

  Out* ob = L.o + b * L.o_b + h * L.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + r0 + i;
    if (q < S) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j) store(ob + (long long)q * L.o_s + c0 + j, o[i][j] / den);
    }
  }
}

template <typename In, typename Out>
int launch(const AttnLayout<In, Out>& L, int B, int H, int S, int seq_len, float scale, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<In, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_f32_kernel<In, Out><<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(L, S, seq_len, scale);
  return (int)cudaGetLastError();
}

// qkv (B, S, 3 H D) packed head-major -> out (B, S, H D), in the input type
template <typename T>
int launch_packed(const void* qkv, void* out, int B, int S, int H, int seq_len, float scale, void* stream) {
  const T* x = static_cast<const T*>(qkv);
  const long long C = (long long)H * D, row = 3 * C;
  const AttnLayout<T, T> L{x, x + D, x + 2 * D, static_cast<T*>(out),
                           S * row, 3 * D, row, S * row, 3 * D, row, S * row, 3 * D, row,
                           S * C, D, C};
  return launch(L, B, H, S, seq_len, scale, stream);
}

}  // namespace

// K1 at fp32: qkv (B, S, 3 H D) fp32 packed head-major -> out (B, S, H D) fp32.
extern "C" int mk_flash_attention_packed_f32(const void* qkv, void* out, int B, int S, int H,
                                             float scale, void* stream) {
  return launch_packed<float>(qkv, out, B, S, H, S, scale, stream);
}

// K1-old: qkv (B, S, 3 H D) bf16 packed head-major, upcast at load, fp32
// math -> out (B, S, H D) bf16; keys at positions >= seq_len masked.
extern "C" int mk_flash_attention_packed_upcast_bf16(const void* qkv, void* out, int B, int S, int H,
                                                     int seq_len, float scale, void* stream) {
  return launch_packed<bf16>(qkv, out, B, S, H, seq_len, scale, stream);
}

// K1b at fp32: q, k, v (B, H, S, D) fp32 with element strides
// {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s} -> out (B, H, S, D) fp32
// contiguous; keys at positions >= seq_len masked.
extern "C" int mk_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H, int S, int seq_len,
                                      float scale, void* stream) {
  const long long* st = strides;
  const AttnLayout<float, float> L{static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(out),
                                   st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                                   (long long)H * S * D, (long long)S * D, D};
  return launch(L, B, H, S, seq_len, scale, stream);
}
