// Hopper building blocks shared by the two attention kernels
// (flash_attention_packed.cu, bf16; flash_attention_f32.cu, fp32 operands):
// mbarriers, the shared-memory matrix descriptor of a 128-byte-swizzled
// tile, the wgmma fence / commit / wait, and the tensor-map encoder looked up
// in libcuda.

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
