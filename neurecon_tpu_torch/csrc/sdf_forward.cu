// Surface-MLP sdf-only forward — CUDA kernels for sm_90a.
//
// Replaces the Pallas kernel `_make_kernel` of neurecon_tpu/ops/fused_mlp.py
// (entry `fused_sdf_forward`): for each point, the positional encoding, the D
// hidden layers (Softplus beta=100 or the SIREN sine sin(30 a), the skip
// input [h, emb] / sqrt(2)) and the final layer's sdf row alone. It serves every gradient-free sdf query: the
// mesh grids, both ray casters, the VolSDF sampler, the eval tools.
//
// What bounds it. At the flagship widths a point costs 459,008 multiply-adds
// against 12 bytes in and 4 bytes out. The hidden layers run as split-fp32
// tensor-core products: three TF32 products per multiply-add (small terms
// first, small x small dropped, fp32 sums; surface_mma.cuh's note on
// precision), so 3 x 0.92 MFLOP of TF32 work a point, 5.8 ms per 2^20 points
// at the card's 495 TFLOP/s (dense TF32). Beside the products: the
// activations' split in registers, the promotion of each group of products
// into the fp32 sums, and the activation epilogues (Softplus: two expf and a
// log1pf; sine: one sinf, whose range reduction is dearer at |30 a| of tens
// of radians), ~5 ms of special-function work a VolSDF step. At the SIREN
// widths (D=5, W=256, no encoding) a point costs 263,168 multiply-adds and
// 1,280 sines.
//
// The narrow tile (padded hidden widths up to 256, final-layer rows up to
// 264): the warp-specialised TMA + wgmma pipeline of narrow_tile.cuh (its
// note has the design: one 384-thread block an SM on 64-point tiles, a
// producer warpgroup streaming every layer's W [N][K] by TMA through a ring
// of two 64 KB stages, two consumer warpgroups of 128 columns each, the
// split-fp32 wgmma products promoted into fp32 sums every 4 k-steps).
// Kernel 4 streams the hidden layers' W alone; the ring alone took ~9 ms
// per 2^20 points, which with the products and the epilogue is most of the
// kernel's time. The epilogue is straight-line code (softplus100), so that a
// thread's 64 activations interleave. Shared memory (flagship widths): the
// ring 2 x 64 KB, the activations [256][72], the encoding [40][72], xs
// [3][64]: 218,144 bytes with the alignment slack. The sdf row runs on the
// CUDA cores in fp32, two lanes a point. The last tile may be ragged; its
// missing points are encoded as zeros and not written.
//
// A surface wider than 256 (up to 512) runs the wide tile (surface_mma.cuh's
// mma.sync products): 64 points, 8 column groups, the fp32 weight stage
// [2][16][520] split in registers; at W = 512, xs [4][64], the encoding
// [40][72], the activations [512][72] and the stage: 226,560 bytes. A
// surface wider than 512 (up to 1024) runs the cluster tile
// (surface_mma.cuh): a pair of those blocks on one 64-point tile, each
// holding half of every layer's rows (W = 1024: the activations [512][72]
// a block, 226,560 bytes), both walking the same tiles; each block sums the
// sdf row over both halves and block 0 writes it.
#include <algorithm>

#include "narrow_tile.cuh"
#include "surface_mma.cuh"

namespace ntt {

// ---- the narrow tile: the wgmma pipeline

// One tensor map per hidden layer (wg::weight_map), passed by value.
struct SdfMaps {
  CUtensorMap w[narrow::MAXD];
};

template <int ACT>
__global__ void __launch_bounds__(narrow::THREADS, 1)
sdf_forward_kernel_narrow(const __grid_constant__ SdfMaps maps, tc::Mlp m,
                          const float* __restrict__ x, int M, float* __restrict__ sdf,
                          int stages) {
  using namespace narrow;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  float* act = ring + stages * STAGE;  // [rows][LDV]
  float* emb = act + m.rows * LDV;     // [c_pad][LDV]
  float* xs = emb + m.c_pad * LDV;     // [3][P]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + 3 * P);  // full[stages], empty[stages]
  const int D = m.n_layers - 1;
  const int n_tiles = (M + P - 1) / P;
  Ring rg = ring_start(ring, bars, stages);

  if (threadIdx.x < 128) {  // the producer warpgroup
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    for (int T = blockIdx.x; T < n_tiles; T += gridDim.x)
      for (int l = 0; l < D; ++l) {
        const int* r = m.meta + l * tc::META;
        produce(rg, &maps.w[l], __ldg(r + 0) / 8, __ldg(r + 1) > NC ? 2 : 1);
      }
    return;
  }

  // a consumer warpgroup: columns [128 half, + 128) of every layer for the
  // tile's 64 points, 16 a warp (a warp of each warpgroup on the same points)
  wg::regs_inc<CONSUMER_REGS>();
  const int half = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pw = (threadIdx.x / 32 % 4) * 16;  // the warp's first point in the tile
  const int p = pw + g;                        // the thread's points p and p + 8
  float sum[64];
  for (int T = blockIdx.x; T < n_tiles; T += gridDim.x) {
    const long p0 = (long)T * P;
    if (half == 0) narrow_embed(m, x, p0, M, pw, lane, xs, emb);
    consumers_sync();  // the encoding is written; the last tile's sdf row is read
    narrow_hidden<ACT, false>(m, rg, act, emb, sum, half, pw, p, t, lane, nullptr);
    if (half == 0) {
      // the sdf row, in fp32 on the CUDA cores
      const tc::Layer LD = tc::layer_of(m, D);
      const int q = pw + (lane & 15);
      const float s = narrow_row(act, LD.w, LD.K, q, lane);
      if (lane < 16 && p0 + q < M) sdf[p0 + q] = s + __ldg(LD.b);
    }
  }
}

// ---- the wide and cluster tiles: surface_mma.cuh's products

// The tile (tc::Wide or tc::Cluster) and its weight stage: the fp32 plane,
// split in registers (shared memory is short beside the wide buffers).
template <class TL>
struct Sdf {
  static constexpr int KC = 16;    // weight rows per staged chunk
  static constexpr int NBUF = 2;   // staged chunks: one computed, one in flight
  static constexpr bool PRESPLIT = false;
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

using ntt::narrow::optin_bytes;

int narrow_launch(const ntt::tc::Mlp& m, const int* host_meta, int act, const float* x, int M,
                  float* sdf, int blocks, cudaStream_t stream) {
  using namespace ntt::narrow;
  ntt::SdfMaps maps;
  int stages = 0;
  // a tensor map a hidden layer, of its W [N][K] (record: K, N, .., offset of W)
  auto make = [&](ntt::SdfMaps* mp, int D) {
    for (int l = 0; l < D; ++l) {
      const int* r = host_meta + l * ntt::tc::META;
      if (!ntt::wg::weight_map<SW>(&mp->w[l], m.params + m.plane + r[5], m.plane, r[0], r[1]))
        return false;
    }
    return true;
  };
  if (const int err = plan(m, host_meta, &maps, &stages, make)) return err;
  auto kernel = act == ntt::ACT_SINE ? ntt::sdf_forward_kernel_narrow<ntt::ACT_SINE>
                                     : ntt::sdf_forward_kernel_narrow<ntt::ACT_SOFTPLUS>;
  kernel<<<blocks, THREADS, bytes(m.c_pad, m.rows, stages), stream>>>(maps, m, x, M, sdf, stages);
  return (int)cudaGetLastError();
}

template <class TL>
size_t smem_bytes(int c_pad, int rows) {
  return ((size_t)4 * TL::P + (size_t)(c_pad + ntt::tc::held_rows<TL>(rows)) * TL::LDV +
          ntt::Sdf<TL>::STAGE) *
         sizeof(float);
}

template <class TL>
int resident(int c_pad, int rows) {
  const size_t smem = smem_bytes<TL>(c_pad, rows);
  int sms = 0, blocks = 0, optin = 0;
  cudaError_t err = (cudaError_t)optin_bytes(&optin, &sms);
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

// f(T{}) for the wide (1) or cluster (2) tile.
template <class F>
auto by_wide_tile(int tile, F&& f) {
  return tile == 2 ? f(ntt::tc::Cluster{}) : f(ntt::tc::Wide{});
}

}  // namespace

// Shared memory of a block, in bytes; `tile` picks the tile (0 the narrow
// wgmma pipeline, 1 tc::Wide, 2 tc::Cluster), as ops/surface_pack.py records
// it. The narrow tile's is at the ring stages the current card fits.
extern "C" size_t ntt_sdf_forward_smem_bytes(int c_pad, int rows, int tile) {
  if (tile == 0) {
    int optin = 0, sms = 0;
    if (optin_bytes(&optin, &sms)) return 0;
    return ntt::narrow::bytes(c_pad, rows, ntt::narrow::stages_for(c_pad, rows, optin));
  }
  return by_wide_tile(tile, [&](auto t) { return smem_bytes<decltype(t)>(c_pad, rows); });
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
  if (tile == 0)
    return ntt::narrow::resident(c_pad, rows, ntt::sdf_forward_kernel_narrow<ntt::ACT_SOFTPLUS>,
                                 ntt::sdf_forward_kernel_narrow<ntt::ACT_SINE>);
  return by_wide_tile(tile, [&](auto t) { return resident<decltype(t)>(c_pad, rows); });
}

// x [M,3] -> sdf [M]; fp32, contiguous, on the device; `params` (three
// planes of `plane` floats) and `meta` the pack of ops/surface_pack.py, and
// `host_meta` its records in host memory (the narrow tile's tensor maps are
// made from them, once a pack); `act` the hidden layers' activation
// (ACT_SOFTPLUS or ACT_SINE); `tile` the tile; `blocks` at most
// ntt_sdf_forward_resident's count (even for the cluster tile), capped here
// at one block (or one pair) per 64-point tile. Returns the cudaError_t of
// the launch: cudaErrorInvalidValue for a narrow surface of more than
// narrow::MAXD hidden layers.
extern "C" int ntt_sdf_forward(const void* x, int M, const void* params,
                               long long plane, const void* meta, const void* host_meta,
                               int n_layers, int in_ch, int c_pad, int rows, int act, int tile,
                               void* sdf, int blocks, void* stream) {
  if (M <= 0) return 0;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  if (tile < 0 || tile > 2 || (tile == 2 && blocks % 2)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* out = static_cast<float*>(sdf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(ntt::narrow::P == ntt::tc::Wide::P, "one tile of points for every kernel 4");
  const long tiles = (M + (long)ntt::narrow::P - 1) / ntt::narrow::P;
  blocks = (int)std::min<long>(blocks, tiles * (tile == 2 ? ntt::tc::Cluster::CL : 1));
  if (tile == 0)
    return narrow_launch(m, static_cast<const int*>(host_meta), act, xp, M, out, blocks, st);
  return by_wide_tile(tile, [&](auto t) {
    return launch<decltype(t)>(m, act, xp, M, out, blocks, st);
  });
}
