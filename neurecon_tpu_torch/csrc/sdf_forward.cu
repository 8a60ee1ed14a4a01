// Surface-MLP sdf-only forward — one CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel `_make_kernel` of neurecon_tpu/ops/fused_mlp.py
// (entry `fused_sdf_forward`): for each point, the positional encoding, the D
// hidden layers (Softplus beta=100, the skip input [h, emb] / sqrt(2)) and the
// final layer's sdf row alone. It serves every gradient-free sdf query: the
// mesh grids, both ray casters, the eval tools.
//
// What bounds it: arithmetic. At the flagship widths a point costs 0.92 MFLOP
// (459,008 multiply-adds) against 12 bytes in and 4 bytes out.
//
// Design. The forward half of the forward+nablas kernel (nablas_forward.cu)
// without anything kept for a reverse sweep: a persistent grid of 256-thread
// blocks walks 16-point tiles; each tile is encoded (`embed_tile`), pushed
// through the hidden layers (`hidden_forward` with no slope buffer), and
// reduced to its sdf row (`sdf_row_tile`), all in shared memory
// (surface_mlp.cuh; ~69 KB a block, three blocks an SM). Weights stay in the
// port's unpadded [out, in] packing and stream from L2 through the routine's
// double-buffered stage, each weight used for 16 FMAs. The TPU kernel's
// 128-lane padding and split skip matrix are not needed: the skip layer is one
// product over [h, emb] / sqrt(2), the same function up to fp32 rounding. The
// last tile may be ragged; its missing points are encoded as zeros and not
// written. Larger tiles (no slopes to keep, so 64 points per weight fetch fit
// in shared memory) and tensor cores are later work.
#include "surface_mlp.cuh"

namespace ntt {

__global__ void __launch_bounds__(THREADS, 3)
sdf_forward_kernel(Mlp m, const float* __restrict__ x, int M,
                   float* __restrict__ sdf) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4][TILE]; row 3 holds the sdf
  float* emb = xs + 4 * TILE;                   // [in_ch][TILE]
  float* bufA = emb + m.in_ch * TILE;           // [wmax][TILE]
  float* bufB = bufA + m.wmax * TILE;           // [wmax][TILE]
  float* stage = bufB + m.wmax * TILE;          // STAGE_FLOATS
  float* tile_sdf = xs + 3 * TILE;
  const int tiles = (M + TILE - 1) / TILE;
  for (int T = blockIdx.x; T < tiles; T += gridDim.x) {
    const long p0 = (long)T * TILE;
    for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
      const int c = idx / TILE, p = idx % TILE;
      xs[idx] = (p0 + p < M) ? x[(p0 + p) * 3 + c] : 0.f;
    }
    __syncthreads();
    embed_tile(m, xs, emb);
    __syncthreads();
    const float* h = hidden_forward(m, emb, bufA, bufB, nullptr, stage);
    sdf_row_tile(m, h, tile_sdf);
    __syncthreads();
    for (int p = threadIdx.x; p < TILE; p += blockDim.x)
      if (p0 + p < M) sdf[p0 + p] = tile_sdf[p];
    __syncthreads();  // the next tile overwrites shared memory
  }
}

}  // namespace ntt

extern "C" size_t ntt_sdf_forward_smem_bytes(int in_ch, int wmax) {
  return ntt::mlp_smem_floats(in_ch, wmax) * sizeof(float);
}

// Blocks of the kernel resident on the current card at once (the persistent
// grid's size before it is capped at one block per tile); also sets the
// kernel's shared-memory attributes. The wrapper calls it once per (card,
// in_ch, wmax) and keeps the answer. Returns a negative cudaError_t on failure.
extern "C" int ntt_sdf_forward_resident(int in_ch, int wmax) {
  const size_t smem = ntt_sdf_forward_smem_bytes(in_ch, wmax);
  cudaError_t err = cudaFuncSetAttribute(
      ntt::sdf_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ntt::sdf_forward_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ntt::sdf_forward_kernel, ntt::THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// x [M,3] -> sdf [M]; fp32, contiguous, on the device; `blocks` at most
// ntt_sdf_forward_resident's count. Returns the cudaError_t of the launch.
extern "C" int ntt_sdf_forward(const void* x, int M, const void* params,
                               const void* meta, int n_layers, int in_ch,
                               int multires, int wmax, void* sdf, int blocks,
                               void* stream) {
  if (M <= 0) return 0;
  const size_t smem = ntt_sdf_forward_smem_bytes(in_ch, wmax);
  ntt::Mlp m{static_cast<const float*>(params), static_cast<const int*>(meta),
             n_layers, in_ch, multires, wmax};
  ntt::sdf_forward_kernel<<<blocks, ntt::THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const float*>(x), M, static_cast<float*>(sdf));
  return (int)cudaGetLastError();
}
