// Surface-MLP sdf-only forward — one CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel `_make_kernel` of neurecon_tpu/ops/fused_mlp.py
// (entry `fused_sdf_forward`): for each point, the positional encoding, the D
// hidden layers (Softplus beta=100 or the SIREN sine sin(30 a), the skip
// input [h, emb] / sqrt(2)) and the final layer's sdf row alone. It serves every gradient-free sdf query: the
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
// MMAs (the activations' split, one flush a k-step) and the activation
// epilogues (Softplus: two expf and a log1pf; sine: one sinf, whose range
// reduction is dearer at |30 a| of tens of radians), which the one block an
// SM does not overlap with the MMAs. At the SIREN widths (D=5, W=256, no
// encoding) a point costs 263,168 multiply-adds and 1,280 sines.
//
// Design. A persistent grid of 512-thread blocks, one per SM, walks tiles of
// 128 points. A tile is encoded (`embed_tile`), pushed through the hidden
// layers in place in one activation buffer (each product's accumulators
// stay in registers until its closing barrier, then its activation epilogue
// overwrites the input; a skip layer appends the encoding to h and divides
// by sqrt(2)), and reduced to its sdf row on the CUDA cores in fp32,
// one thread per point. Shared memory (floats, flagship widths): xs [4][128]
// (row 3 the sdf), the encoding [40][136], the activations [256][136] and
// the weight stage [2][2][16][264]: 230,656 bytes, one block an SM. The last
// tile may be ragged; its missing points are encoded as zeros and not
// written. A surface wider than 256 (up to 512) runs the wide tile
// (surface_mma.cuh): 64 points, 8 column groups, the fp32 weight stage
// [2][16][520] split in registers; at W = 512, xs [4][64], the encoding
// [40][72], the activations [512][72] and the stage: 226,560 bytes. A
// surface wider than 512 (up to 1024) runs the cluster tile
// (surface_mma.cuh): a pair of those blocks on one 64-point tile, each
// holding half of every layer's rows (W = 1024: the activations [512][72]
// a block, 226,560 bytes), both walking the same tiles; each block sums the
// sdf row over both halves and block 0 writes it.
#include "surface_mma.cuh"

namespace ntt {

// The tile (tc::Narrow, tc::Wide or tc::Cluster) and its weight stage: both
// TF32 parts on the narrow tile, the fp32 plane on the wide ones, where
// shared memory is short.
template <class TL>
struct Sdf {
  static constexpr int KC = 16;    // weight rows per staged chunk
  static constexpr int NBUF = 2;   // staged chunks: one computed, one in flight
  static constexpr bool PRESPLIT = TL::CG == 4;
  static constexpr int STAGE = tc::stage_floats<TL>(KC, NBUF, PRESPLIT);
};

template <class TL, int ACT>
__global__ void __launch_bounds__(TL::THREADS, 1)
sdf_forward_kernel(tc::Mlp m, const float* __restrict__ x, int M,
                   float* __restrict__ sdf) {
  constexpr int P = TL::P, LDV = TL::LDV;
  using S = Sdf<TL>;
  const tc::Part<TL> pt(m.rows);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4][P]; row 3 holds the sdf
  float* emb = xs + 4 * P;                      // [c_pad][LDV]
  float* buf = emb + m.c_pad * LDV;             // [rows][LDV] (a pair: its half)
  float* stage = buf + tc::held_rows<TL>(m.rows) * LDV;  // S::STAGE
  float* tile_sdf = xs + 3 * P;
  const int D = m.n_layers - 1;
  const int tiles = (M + P - 1) / P;
  for (int T = pt.slot(); T < tiles; T += pt.slots()) {
    const long p0 = (long)T * P;
    for (int idx = threadIdx.x; idx < 3 * P; idx += blockDim.x) {
      const int c = idx / P, p = idx % P;
      xs[idx] = (p0 + p < M) ? x[(p0 + p) * 3 + c] : 0.f;
    }
    __syncthreads();
    tc::embed_tile<TL>(m, xs, emb);
    __syncthreads();
    for (int l = 0; l < D; ++l) {
      const tc::Layer L = tc::layer_of(m, l);
      if (L.skip) tc::skip_input<TL>(m, L, emb, buf, pt);
      tc::Acc<TL> acc;
      tc::product<TL, S::KC, S::NBUF, S::PRESPLIT>(L.wT + pt.lo(), m.plane, L.K,
                                                  pt.cols(L.N), L.N,
                                                  l == 0 ? pt.local(emb) : pt.src(buf),
                                                  stage, acc);
      pt.meet();
      tc::activation_out<TL, ACT>(L, acc, buf, nullptr, pt);
      pt.sync();
    }
    // the sdf row, in fp32 on the CUDA cores
    const tc::Layer LD = tc::layer_of(m, D);
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      tile_sdf[p] = tc::final_row<TL>(LD, 0, pt.src(buf), p);
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      if (p0 + p < M && pt.lead()) sdf[p0 + p] = tile_sdf[p];
    pt.sync();  // the next tile overwrites shared memory (a pair's, once both have read it)
  }
}

}  // namespace ntt

namespace {

template <class TL>
size_t smem_bytes(int c_pad, int rows) {
  return ((size_t)4 * TL::P + (size_t)(c_pad + ntt::tc::held_rows<TL>(rows)) * TL::LDV +
          ntt::Sdf<TL>::STAGE) *
         sizeof(float);
}

template <class TL>
int resident(int c_pad, int rows) {
  const size_t smem = smem_bytes<TL>(c_pad, rows);
  int dev = 0, sms = 0, blocks = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > (size_t)optin) return 0;
  bool first = true;
  for (auto kernel : {ntt::sdf_forward_kernel<TL, ntt::ACT_SOFTPLUS>,
                      ntt::sdf_forward_kernel<TL, ntt::ACT_SINE>}) {
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (err == cudaSuccess) err = ntt::tc::resident<TL>(kernel, smem, optin, sms, &n);
    blocks = first || n < blocks ? n : blocks;
    first = false;
  }
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

template <class TL>
int launch(const ntt::tc::Mlp& m, int act, const float* x, int M, float* sdf, int blocks,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<TL>(m.c_pad, m.rows);
  auto kernel = act == ntt::ACT_SINE ? ntt::sdf_forward_kernel<TL, ntt::ACT_SINE>
                                     : ntt::sdf_forward_kernel<TL, ntt::ACT_SOFTPLUS>;
  return (int)ntt::tc::launch<TL>(kernel, blocks, smem, stream, m, x, M, sdf);
}

}  // namespace

// Shared memory of a block, in bytes; `tile` picks the tile (0 tc::Narrow,
// 1 tc::Wide, 2 tc::Cluster), as ops/surface_pack.py records it.
extern "C" size_t ntt_sdf_forward_smem_bytes(int c_pad, int rows, int tile) {
  return ntt::tc::by_tile(tile, [&](auto t) { return smem_bytes<decltype(t)>(c_pad, rows); });
}

// Blocks of the kernel resident on the current card at once (the persistent
// grid's size before it is capped at one block, or one pair, per tile; for
// the cluster tile twice the pairs). Sets the kernel's dynamic shared-memory
// cap to the card's opt-in maximum (so it never needs raising for a larger
// shape) and asks the occupancy of this shape's use. The wrapper calls it
// once per (card, c_pad, rows, tile) and keeps the answer. Returns a
// negative cudaError_t on failure, and 0 when a block (or a pair) does not
// fit.
extern "C" int ntt_sdf_forward_resident(int c_pad, int rows, int tile) {
  return ntt::tc::by_tile(tile, [&](auto t) { return resident<decltype(t)>(c_pad, rows); });
}

// x [M,3] -> sdf [M]; fp32, contiguous, on the device; `params` (three
// planes of `plane` floats) and `meta` the pack of ops/surface_pack.py;
// `act` the hidden layers' activation (ACT_SOFTPLUS or ACT_SINE); `tile`
// the tile; `blocks` at most ntt_sdf_forward_resident's count (even for the
// cluster tile). Returns the cudaError_t of the launch.
extern "C" int ntt_sdf_forward(const void* x, int M, const void* params,
                               long long plane, const void* meta, int n_layers,
                               int in_ch, int c_pad, int rows, int act, int tile, void* sdf,
                               int blocks, void* stream) {
  if (M <= 0) return 0;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  if (tile < 0 || tile > 2 || (tile == 2 && blocks % 2)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* out = static_cast<float*>(sdf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ntt::tc::by_tile(tile, [&](auto t) {
    return launch<decltype(t)>(m, act, xp, M, out, blocks, st);
  });
}
