// Surface-MLP sdf-only forward — one CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel `_make_kernel` of neurecon_tpu/ops/fused_mlp.py
// (entry `fused_sdf_forward`): for each point, the positional encoding, the D
// hidden layers (Softplus beta=100, the skip input [h, emb] / sqrt(2)) and the
// final layer's sdf row alone. It serves every gradient-free sdf query: the
// mesh grids, both ray casters, the VolSDF sampler, the eval tools.
//
// What bounds it. At the flagship widths a point costs 459,008 multiply-adds
// against 12 bytes in and 4 bytes out. The hidden layers run as split-fp32
// tensor-core products (surface_mma.cuh): three TF32 MMAs per multiply-add,
// so 3 x 0.92 MFLOP of TF32 work a point, 5.8 ms per 2^20 points at the
// card's 495 TFLOP/s (dense TF32; mma.sync reaches a fraction of it). The
// weights' TF32 parts (3.7 MB at the flagship widths) stream from L2 once
// per tile of P = 128 points: 30 GB of L2 reads per 2^20 points, a few ms
// at L2's rate. So the bound is the tensor cores' operations, and the
// kernel's time over it is mma.sync's rate, the CUDA-core work around the
// MMAs (the activations' split, one flush a k-step) and the Softplus
// epilogues, which the one block an SM does not overlap with the MMAs.
//
// Design. A persistent grid of 512-thread blocks, one per SM, walks tiles of
// 128 points. A tile is encoded (`embed_tile`), pushed through the hidden
// layers in place in one activation buffer (each product's accumulators
// stay in registers until its closing barrier, then its Softplus epilogue
// overwrites the input; a skip layer appends the encoding to h and divides
// by sqrt(2)), and reduced to its sdf row on the CUDA cores in fp32,
// one thread per point. Shared memory (floats, flagship widths): xs [4][128]
// (row 3 the sdf), the encoding [40][136], the activations [256][136] and
// the weight stage [2][2][16][264]: 230,656 bytes, one block an SM. The last
// tile may be ragged; its missing points are encoded as zeros and not
// written.
#include "surface_mma.cuh"

namespace ntt {

constexpr int SDF_TILE = 128;  // points per tile
constexpr int SDF_KC = 16;     // weight rows per staged chunk
constexpr int SDF_NBUF = 2;    // staged chunks: one computed, one in flight
constexpr int SDF_STAGE = tc::stage_floats(SDF_KC, SDF_NBUF, true);
constexpr int SDF_THREADS = tc::Tile<SDF_TILE>::THREADS;

__global__ void __launch_bounds__(SDF_THREADS, 1)
sdf_forward_kernel(tc::Mlp m, const float* __restrict__ x, int M,
                   float* __restrict__ sdf) {
  constexpr int P = SDF_TILE, LDV = tc::Tile<P>::LDV;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4][P]; row 3 holds the sdf
  float* emb = xs + 4 * P;                      // [c_pad][LDV]
  float* buf = emb + m.c_pad * LDV;             // [rows][LDV]
  float* stage = buf + m.rows * LDV;            // SDF_STAGE
  float* tile_sdf = xs + 3 * P;
  const int D = m.n_layers - 1;
  const int tiles = (M + P - 1) / P;
  for (int T = blockIdx.x; T < tiles; T += gridDim.x) {
    const long p0 = (long)T * P;
    for (int idx = threadIdx.x; idx < 3 * P; idx += blockDim.x) {
      const int c = idx / P, p = idx % P;
      xs[idx] = (p0 + p < M) ? x[(p0 + p) * 3 + c] : 0.f;
    }
    __syncthreads();
    tc::embed_tile<P>(m, xs, emb);
    __syncthreads();
    for (int l = 0; l < D; ++l) {
      const tc::Layer L = tc::layer_of(m, l);
      if (L.skip) tc::skip_input<P>(m, L, emb, buf);
      float acc[tc::Tile<P>::MT][8][4];
      tc::product<P, SDF_KC, SDF_NBUF, true>(L.wT, m.plane, L.K, L.N, l == 0 ? emb : buf, stage,
                                       acc);
      tc::softplus_out<P>(L, acc, buf, nullptr);
      __syncthreads();
    }
    // the sdf row: sum_k h[k][p] W_D[0][k] + b_D[0] (W_D's row 0 is the
    // first K floats of its [N][K] block; padded rows are zero on both sides)
    const tc::Layer LD = tc::layer_of(m, D);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int k = 0; k < LD.K; k += 4) {
        s0 += buf[k * LDV + p] * __ldg(LD.w + k);
        s1 += buf[(k + 1) * LDV + p] * __ldg(LD.w + k + 1);
        s2 += buf[(k + 2) * LDV + p] * __ldg(LD.w + k + 2);
        s3 += buf[(k + 3) * LDV + p] * __ldg(LD.w + k + 3);
      }
      tile_sdf[p] = ((s0 + s1) + (s2 + s3)) + __ldg(LD.b);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      if (p0 + p < M) sdf[p0 + p] = tile_sdf[p];
    __syncthreads();  // the next tile overwrites shared memory
  }
}

}  // namespace ntt

extern "C" size_t ntt_sdf_forward_smem_bytes(int c_pad, int rows) {
  constexpr int P = ntt::SDF_TILE, LDV = ntt::tc::Tile<P>::LDV;
  return ((size_t)4 * P + (size_t)(c_pad + rows) * LDV + ntt::SDF_STAGE) *
         sizeof(float);
}

// Blocks of the kernel resident on the current card at once (the persistent
// grid's size before it is capped at one block per tile). Sets the kernel's
// dynamic shared-memory cap to the card's opt-in maximum (so it never needs
// raising for a larger shape) and asks the occupancy of this shape's use.
// The wrapper calls it once per (card, c_pad, rows) and keeps the answer.
// Returns a negative cudaError_t on failure, and 0 when a block does not fit.
extern "C" int ntt_sdf_forward_resident(int c_pad, int rows) {
  const size_t smem = ntt_sdf_forward_smem_bytes(c_pad, rows);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > (size_t)optin) return 0;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ntt::sdf_forward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ntt::sdf_forward_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ntt::sdf_forward_kernel, ntt::SDF_THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// x [M,3] -> sdf [M]; fp32, contiguous, on the device; `params` (three
// planes of `plane` floats) and `meta` the pack of ops/surface_pack.py;
// `blocks` at most ntt_sdf_forward_resident's count. Returns the cudaError_t of the launch.
extern "C" int ntt_sdf_forward(const void* x, int M, const void* params,
                               long long plane, const void* meta, int n_layers,
                               int in_ch, int c_pad, int rows, void* sdf,
                               int blocks, void* stream) {
  if (M <= 0) return 0;
  const size_t smem = ntt_sdf_forward_smem_bytes(c_pad, rows);
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  ntt::sdf_forward_kernel<<<blocks, ntt::SDF_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const float*>(x), M, static_cast<float*>(sdf));
  return (int)cudaGetLastError();
}
