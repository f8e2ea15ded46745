// Flash attention for the DINOv2 backbone (forward only), on two layouts.
//
// Replaces mickey_tpu/ops/flash_attention.py's two Pallas kernels:
//   K1  flash_attention_packed (_flash_packed_kernel + _online_softmax_attend)
//       -> mk_flash_attention_packed_bf16: non-causal softmax(q k^T / sqrt(D)) v
//       read straight from the qkv linear output, whose minor dim is packed
//       head-major as (H, 3, D), and written head-concat as (B, S, H*D) for the
//       proj linear;
//   K1b flash_attention (_flash_kernel) -> mk_flash_attention_bf16: the same
//       math on q, k, v of shape (B, H, S, D) with any strides over (B, H, S)
//       and unit stride over D (the permuted views of the qkv linear output
//       need no copy), written as a contiguous (B, H, S, D).
// Keys at positions >= seq_len are masked, so the 1939-token ViT-L sequence
// needs no padding. Both entries run one kernel body; only the addressing
// (`Layout`, attention_layout.cuh) differs. The fp32-operand counterparts
// (MICKEY.DINOV2.FLOAT16=False, and the tools' K1-old) are in
// flash_attention_f32.cu.
//
// Numerics follow the TPU kernel: bf16 operands, products on the tensor
// cores with fp32 accumulation, the 1/sqrt(D) scale applied to the fp32
// scores, fp32 running max / sum / accumulator, probabilities rounded to bf16
// before the PV product.
//
// What bounds it on the H100: at S = 1939, D = 64 the two products are
// 4 S^2 D flops per head against ~S * 3D * 2 bytes read, far above the
// card's ~295 flop/byte balance point, so it is compute bound. The design
// keeps the S x S scores out of device memory (one 64 x 64 tile in shared
// memory at a time) and runs both products through WMMA bf16 tensor-core
// tiles. This first version is deliberately simple: one CTA of 4 warps per
// (image, head, 64-query tile), synchronous tile loads, no TMA / wgmma
// pipeline; each warp owns 16 query rows end to end, so only the K/V tile
// swap needs a block-wide barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "attention_layout.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;         // head dim (ViT-S/B/L all use 64)
constexpr int BQ = 64;        // queries per CTA
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // 4 warps, 16 query rows each
constexpr int LDH = D + 8;    // bf16 smem row stride (multiple of 8 for wmma)
constexpr int LDS = BK + 4;   // fp32 smem row stride (multiple of 4 for wmma)
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

constexpr size_t SMEM_BYTES = 4 * BQ * LDH * sizeof(bf16) + BQ * LDS * sizeof(float);

typedef AttnLayout<bf16, bf16> Layout;  // attention_layout.cuh

// Copy rows [r0, r0 + 64) of one 64-wide head slice into shared memory,
// 16 bytes per thread-step; rows >= S are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int S,
                                          long long row_stride) {
  for (int i = threadIdx.x; i < 64 * 8; i += NT) {
    int r = i >> 3, c8 = (i & 7) * 8;
    int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) v = *reinterpret_cast<const uint4*>(src + (long long)row * row_stride + c8);
    *reinterpret_cast<uint4*>(dst + r * LDH + c8) = v;
  }
}

__global__ void __launch_bounds__(NT)
flash_kernel(const Layout L, int S, int seq_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  bf16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDH);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = L.q + b * L.q_b + h * L.q_h;
  const bf16* kb = L.k + b * L.k_b + h * L.k_h;
  const bf16* vb = L.v + b * L.v_b + h * L.v_h;
  const int warp = threadIdx.x >> 5;
  const int r = threadIdx.x >> 1;          // this thread's query row in the tile
  const int c0 = (threadIdx.x & 1) * 32;   // and its half of the columns

  load_tile(Qs, qb, q0, S, L.q_s);

  float m = NEG_INF, l = 0.f;
  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // previous tile's K/V no longer in use (and Q loaded)
    load_tile(Ks, kb, k0, S, L.k_s);
    load_tile(Vs, vb, k0, S, L.v_s);
    __syncthreads();

    // S_tile = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDH + kk * 16, LDH);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, Ks + n * 16 * LDH + kk * 16, LDH);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's 32 columns; the row's two threads are
    // lanes 2r and 2r+1 of the same warp
    float s[32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v = Ss[r * LDS + c0 + j] * scale;
      if (k0 + c0 + j >= seq_len) v = NEG_INF;
      s[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float p = expf(s[j] - m_new);
      psum += p;
      Ps[r * LDH + c0 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] *= alpha;
    __syncwarp();

    // PV for this warp's 16 rows, staged through the (now free) score tile
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * LDH + kk * 16, LDH);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, Vs + kk * 16 * LDH + n * 16, LDH);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] += Ss[r * LDS + c0 + j];
  }

  const int q = q0 + r;
  if (q < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* dst = L.o + b * L.o_b + h * L.o_h + q * L.o_s + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(o[j + e] * inv);
      *reinterpret_cast<uint4*>(dst + j) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

int launch(const Layout& L, int B, int H, int S, int seq_len, float scale, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(L, S, seq_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: qkv (B, S, 3 H D) packed head-major -> out (B, S, H D).
extern "C" int mk_flash_attention_packed_bf16(const void* qkv, void* out, int B, int S, int H,
                                              float scale, void* stream) {
  const bf16* x = static_cast<const bf16*>(qkv);
  const long long C = (long long)H * D, row = 3 * C;
  const Layout L{x, x + D, x + 2 * D, static_cast<bf16*>(out),
                 S * row, 3 * D, row, S * row, 3 * D, row, S * row, 3 * D, row,
                 S * C, D, C};
  return launch(L, B, H, S, S, scale, stream);
}

// K1b: q, k, v (B, H, S, D) with element strides
// {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s} -> out (B, H, S, D) contiguous;
// keys at positions >= seq_len masked.
extern "C" int mk_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                       const long long* strides, int B, int H, int S,
                                       int seq_len, float scale, void* stream) {
  const long long* st = strides;
  const Layout L{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(out),
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                 (long long)H * S * D, (long long)S * D, D};
  return launch(L, B, H, S, seq_len, scale, stream);
}
