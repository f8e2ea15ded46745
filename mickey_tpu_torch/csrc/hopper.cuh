// Hopper building blocks shared by the attention kernels
// (flash_attention_packed.cu, bf16; flash_attention_f32.cu, fp32 operands),
// the matcher's correlation engine (corr_tf32.cuh) and the hypothesis
// scoring (hypothesis_scoring.cu): mbarriers, the shared-memory matrix
// descriptor of a 128-byte-swizzled tile, the wgmma fence / commit / wait,
// the conversion to TF32 (cvt.rna), the 5-D TMA load, the 4-, 8- and 16-byte
// cp.async, and the tensor-map encoder looked up in libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int ERR_ENCODE = 100000;  // added to a CUresult of the tensor-map encoder

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

// Shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO); the leading offset
// is not used at this width. A k-slice 32 bytes into the rows is the same
// descriptor plus 2 (16-byte units).
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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One TMA box of a 5-D map (innermost coordinate 0) into shared memory at
// `dst`, completing on the mbarrier at `bar`.
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c1, int c2, int h,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1), "r"(c2), "r"(h), "r"(b)
      : "memory");
}

// `bytes` (4, 8 or 16, kBytes) from `src` into shared memory at `dst`, the
// rest of the kBytes zero-filled (bytes = 0: no read, all zero), asynchronously;
// cp_async_commit closes this thread's group of copies, cp_async_wait<n>
// waits until at most n of its groups are in flight.
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, uint32_t bytes) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async.ca of 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src), "n"(kBytes), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int kGroups>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kGroups) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda (which the CUDA runtime has
// loaded by the time a tensor lives on the card), so the library links
// against nothing but cudart and libdl.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map of `rank` dims (innermost first) with rank - 1 byte strides, the
// 128-byte swizzle and zero fill out of bounds. Returns 0 or ERR_ENCODE plus
// the encoder's CUresult.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr, const long long* dims,
                      const long long* strides, const long long* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_ENCODE;
  cuuint64_t gdim[5], gstr[4];
  cuuint32_t bx[5], estr[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i + 1 < rank; ++i) gstr[i] = static_cast<cuuint64_t>(strides[i]);
  CUresult r = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), gdim, gstr, bx, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

}  // namespace
