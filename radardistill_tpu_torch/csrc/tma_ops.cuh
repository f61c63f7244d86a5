// Inline-PTX wrappers for Hopper's asynchronous copies (sm_90a): mbarriers,
// TMA tile loads (cp.async.bulk.tensor), the proxy fences, register
// reallocation between warpgroups (setmaxnreg) and wgmma.wait_group with a
// depth. The host side encodes a CUtensorMap through the CUDA runtime's
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialized barriers visible to the async proxy (TMA's
// complete_tx); follow it with a barrier among all threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also announces `bytes` of transactions (the TMA copies
// that will complete on this barrier)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// waits until the phase of the given parity has completed (a fresh barrier
// counts its phase of parity 1 as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  asm volatile(
      "{\n.reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni LAB_DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA tile loads: the box at the given element coordinates (innermost first;
// negative and past-the-end coordinates read zeros) into shared memory at
// `dst`, completing `bytes` (the whole box) on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// every thread of the warpgroup executes these, with the same count
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// waits until at most N committed groups of wgmma are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime resolves it; null where the
// installed CUDA has none
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled map in the given swizzle over a tensor of `rank` dimensions,
// innermost first: dims in elements, strides in bytes of dimensions 1 ..
// rank - 1, box in elements (box[0] * element size the swizzle's width, 128
// or 64 bytes). Out-of-bounds elements of a box read as zero.
inline cudaError_t encode_swizzled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                   const void* base, const cuuint64_t* dims,
                                   const cuuint64_t* strides, const cuuint32_t* box,
                                   CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
                        ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t encode_sw128(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                const void* base, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_swizzled(map, type, rank, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace rdt
