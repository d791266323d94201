// The TMA ring's pieces shared by the ring-fed kernels (through
// ring_tiles.cuh: bin_topk.cu, bin_topk_int8.cu, bin_topk_pipelined.cu and
// windowed_scores.cu): mbarriers, their bounded wait, the 2-D tile copy
// (`cp.async.bulk.tensor.2d`) and the tensor map of a row-major array of
// 128-byte multiples in the 128-byte swizzle, built on the host through
// `cuTensorMapEncodeTiled`, which the CUDA runtime looks up in the driver
// (no -lcuda). A ring's stages go back to the producer through empty
// mbarriers; a consumer that read a stage with generic-proxy loads
// (ldmatrix) issues `fence_proxy_async_shared` before it arrives, or the
// refill, an async-proxy write, may overtake its reads.

#pragma once

#include <cuda.h>

#include "mma_tiles.cuh"

namespace tiles {
namespace {  // the header's internal namespace, reopened

// A wait that has not completed after this many cycles (about 10 s at the
// H100's clock) traps instead of hanging the card.
constexpr long long HANG_CYCLES = 1ll << 34;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory before its
// later async-proxy ones (and, through the barrier that follows, before the
// TMA writes that other threads start after it).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until the phase of `bar` with this parity has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > HANG_CYCLES) {
      __trap();
    }
  }
}

// The box of `map` at (byte x, row y) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(entry);
    }
  }
  return fn;
}

// A map of `rows` x `row_bytes` bytes at `base` in boxes of `box_rows` rows x
// 128 bytes, 128-byte swizzle; rows outside the map read as zeros.
bool encode_rows(CUtensorMap* map, const void* base, int rows, int row_bytes, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)STAGE_BYTES, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace tiles
