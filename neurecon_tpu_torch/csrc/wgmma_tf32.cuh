// Hopper's asynchronous machinery for a warp-specialised TF32 pipeline:
// mbarriers, TMA loads of a weight block into a shared-memory ring, the
// matrix descriptor of such a block, and the warpgroup product
// `wgmma.mma_async` m64n128k8 with A from registers and B from shared
// memory. Used by the narrow tile of the sdf-only forward (sdf_forward.cu);
// the mma.sync products of surface_mma.cuh are untouched by it.
//
// The weight block. A layer's W [N][K] of the pack (ops/surface_pack.py),
// K-major, is the B operand TF32 wgmma requires (TF32 takes no transpose).
// One 3-d tensor map a layer covers both TF32 planes: dims {K, N, 2}, the
// small plane `plane` floats past the big; a box {SW / 4, 128, 2} is SW / 32
// k-steps of 128 output columns in both planes, each plane's [128][SW / 4]
// in the SW-byte swizzle, which is the canonical K-major swizzled layout of
// a wgmma B operand (8-row core groups 8 SW bytes apart; the k-step j of a
// row lies 32 j bytes on, the descriptor's start address 2 j on). Rows past
// N, for a layer narrower than the box, and k past K read as zeros.
//
// The fragments (PTX ISA, wgmma register fragments for .tf32): warp w of the
// warpgroup holds rows 16 w .. 16 w + 15 of the 64; lane (g, t) = (lane / 4,
// lane % 4) holds A's (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of a
// k-step, and of the m64n128 accumulator element 4 j + e at row g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA) and
// to the other threads after the block's barrier.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory writes before later reads and
// writes of the async proxy (wgmma's operand reads, TMA's stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also expects `bytes` of transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A phase that never
// completes (a fault in the pipeline's bookkeeping) traps after ~2^31 tries
// (seconds), so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_test(bar, parity);)
    if (++n == 0x80000000u) __trap();
}

// TMA: the box of `map` at coordinates (c0, c1, c2) into shared memory at
// `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The descriptor of a K-major TF32 block at `tile` (aligned to its swizzle
// pattern, 8 x SW bytes) in the SW-byte swizzle (32, 64 or 128): start
// address >> 4, leading offset 1 (unused: a k-step's 32 bytes lie in one
// swizzled row), stride 8 SW bytes between 8-row groups, and the layout code
// (3 SWIZZLE_32B, 2 SWIZZLE_64B, 1 SWIZZLE_128B). A k-step j of a row holds
// lies 32 j bytes on: its descriptor is this one plus 2 j.
template <int SW>
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  static_assert(SW == 32 || SW == 64 || SW == 128, "a 32, 64 or 128-byte swizzle");
  constexpr uint64_t layout = SW == 32 ? 3 : SW == 64 ? 2 : 1;
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * SW >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulator's registers at this point of the program, so that no
// read or write of them is moved across the wgmma issue or its wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B on a 64 x 128 x 8 TF32 tile: A the warpgroup's fragment `a`, B
// the K-major block described by `desc`; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Registers a thread of the warpgroup may hold from here on (setmaxnreg;
// the block's total is fixed at launch, so what one warpgroup gives back
// another may take).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host side

// cuTensorMapEncodeTiled of the driver, found through the runtime (the
// library links no libcuda); null when the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one layer's W [N][K] in both TF32 planes (`big` its
// block in the big plane; the small plane `plane` floats on): boxes of SW / 4
// k (SW / 32 k-steps) x 128 columns x 2 planes, SW-byte swizzle; rows past N
// read as zeros. Returns false on failure.
template <int SW>
inline bool weight_map(CUtensorMap* map, const float* big, size_t plane, int K, int N) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(float), (cuuint64_t)plane * sizeof(float)};
  const cuuint32_t box[3] = {SW / 4, 128, 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = SW == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_128B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(big), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace ntt
