// Surface-MLP forward + input gradient (nablas) — one CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel `_make_nablas_kernel` of
// neurecon_tpu/ops/fused_nablas.py (entry `fused_forward_with_nablas`).
// For each point: sdf, the geometry features (final-layer rows 1..), and
// d sdf / dx by the reverse sweep g <- (g * phi'(a_l)) W_l (skip split by
// 1/sqrt(2)) ending in the positional-encoding pullback. phi is
// Softplus(beta = 100), phi' = sigmoid(100 a), or the SIREN sine sin(30 a),
// phi' = 30 cos(30 a) (a launch argument that picks one of two template
// instantiations).
//
// What bounds it. At the flagship widths a point costs 983,296 multiply-adds
// (the hidden layers twice, forward and sweep, and the final layer's 257
// rows) against 12 bytes in and 1,040 bytes out. Every layer product runs as
// a split-fp32 tensor-core product (surface_mma.cuh: three TF32 MMAs a
// multiply-add), so the bound is the tensor cores' operations, 12.4 ms per
// 1,044,480 points at the card's 495 TFLOP/s; the outputs (1.09 GB there)
// take 0.3 ms of HBM time.
//
// Design: the forward and the nablas sweep of the eikonal backward's tile
// pass (nablas_backward.cu phases 1-2), with kernel 4's pre-split weight
// stage. A persistent grid of 512-thread blocks, one per SM, walks tiles of
// 128 points. A tile is encoded, pushed through the hidden layers in place
// in one activation buffer (the slope s_l = phi'(a_l) of every layer kept),
// and then through the final layer: its first 256 outputs as one product,
// whose accumulators go straight to sdf (output 0) and h (outputs 1..255),
// and any output past 256 (the flagship's 257th row, h's last column) on
// the CUDA cores in fp32 from h_D. The sweep starts from W_D's sdf row,
// multiplies by s_l and runs the reverse product through W_l (the pack's
// [N][K] block, so no product transposes), splitting off the encoding's
// rows at the skip and at layer 0 into g_e, which reuses the encoding's
// buffer; the pullback through d e / d x runs on the CUDA cores. Shared
// memory (floats, flagship widths): xs [4][128], the encoding, then g_e,
// [40][136], the activations [256][136] and the weight stage, both TF32
// parts, [2][2][16][264]: 230,656 bytes, as kernel 4. The slopes (D x 256 x
// 128 floats, 1 MB a tile) do not fit beside them: they go to a
// device-memory scratch of the block's own (138 MB for the grid), written
// once by the forward and read once by the sweep, ~17 GB of traffic per
// 1,044,480 points (~5 ms at HBM's rate, less what L2 keeps); recomputing
// them would cost a second forward pass (about half the kernel's products).
// The last tile may be ragged: its missing points are encoded as zeros and
// not written. A surface wider than 256 (up to 512 hidden columns and
// final-layer rows) runs the wide tile (surface_mma.cuh): 64 points, 8
// column groups, every final-layer row in the product, the fp32 weight
// stage [2][16][520] split in registers: 226,560 bytes at W = 512, and a
// slope scratch of D x 512 x 64 floats a block. A surface wider than 512
// (up to 1024) runs the cluster tile (surface_mma.cuh): a pair of those
// blocks on one 64-point tile, each holding half of every layer's rows
// (W = 1024: [512][72] a block, 226,560 bytes), with one slope scratch of D
// x rows x 64 floats a pair, each block writing and reading its own rows.
// The final layer's product takes rows [0, 512) in block 0 and the rest
// (up to 1024) in block 1; at W_geo 256 its 257 rows sit whole in block 0,
// and block 1 waits at the next barrier. The encoding's gradient g_e is the
// two blocks' sum: block 0 reads block 1's through distributed shared
// memory in the pullback and writes the tile's sdf, nablas and h rows from
// the rows each block computes.
#include "surface_mma.cuh"

namespace ntt {

// The tile (tc::Narrow, tc::Wide or tc::Cluster) and its weight stage: both
// TF32 parts on the narrow tile, the fp32 plane on the wide ones, where
// shared memory is short.
template <class TL>
struct Nf {
  static constexpr int KC = 16;    // weight rows per staged chunk
  static constexpr int NBUF = 2;   // staged chunks: one computed, one in flight
  static constexpr bool PRESPLIT = TL::CG == 4;
  static constexpr int STAGE = tc::stage_floats<TL>(KC, NBUF, PRESPLIT);
};

template <class TL, int ACT>
__global__ void __launch_bounds__(TL::THREADS, 1)
nablas_forward_kernel(tc::Mlp m, const float* __restrict__ x, int M,
                      float* __restrict__ sdf, float* __restrict__ nablas,
                      float* __restrict__ hgeo, int geo_dim, float* slopes) {
  constexpr int P = TL::P, LDV = TL::LDV, NF_THREADS = TL::THREADS;
  using S = Nf<TL>;
  const tc::Part<TL> pt(m.rows);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4][P]
  float* emb = xs + 4 * P;                      // [c_pad][LDV] encoding, then g_e
  float* buf = emb + m.c_pad * LDV;             // [rows][LDV] (a pair: its half)
  float* stage = buf + tc::held_rows<TL>(m.rows) * LDV;  // S::STAGE
  float* ge = emb;
  const int D = m.n_layers - 1, C = m.in_ch, multires = (C - 3) / 6;
  float* deriv = slopes + (size_t)pt.slot() * D * m.rows * P;  // [D][rows][P]
  const tc::Layer LD = tc::layer_of(m, D);
  const int n0 = min(LD.N, TL::NMAX * TL::CL);  // final-layer outputs the products take
  const int tiles = (M + P - 1) / P;
  for (int T = pt.slot(); T < tiles; T += pt.slots()) {
    const long p0 = (long)T * P;
    for (int idx = threadIdx.x; idx < 3 * P; idx += NF_THREADS) {
      const int c = idx / P, p = idx % P;
      xs[idx] = (p0 + p < M) ? x[(p0 + p) * 3 + c] : 0.f;
    }
    __syncthreads();
    tc::embed_tile<TL>(m, xs, emb);
    __syncthreads();

    // forward through the hidden layers, keeping s_l
    for (int l = 0; l < D; ++l) {
      const tc::Layer L = tc::layer_of(m, l);
      if (L.skip) tc::skip_input<TL>(m, L, emb, buf, pt);
      tc::Acc<TL> acc;
      tc::product<TL, S::KC, S::NBUF, S::PRESPLIT>(L.wT + pt.lo(), m.plane, L.K,
                                                   pt.cols(L.N), L.N,
                                                   l == 0 ? pt.local(emb) : pt.src(buf),
                                                   stage, acc);
      pt.meet();
      tc::activation_out<TL, ACT>(L, acc, buf, deriv + (size_t)l * m.rows * P, pt);
      pt.sync();
    }

    // the final layer: outputs [0, n0) from the product, straight out (a
    // pair: block 0 rows [0, 512), block 1 the rest)
    {
      tc::Acc<TL> acc;
      const int f0 = pt.final_lo();
      tc::product<TL, S::KC, S::NBUF, S::PRESPLIT>(LD.wT + f0, m.plane, LD.K,
                                                   pt.final_cols(n0), LD.N, pt.src(buf),
                                                   stage, acc);
      tc::each_output<TL>(acc, pt.final_cols(n0), [&](int of, int p, float a) {
        const int o = f0 + of;
        if (o < LD.out_dim && p0 + p < M) {
          const float z = a + __ldg(LD.b + o);
          if (o == 0) sdf[p0 + p] = z;
          else hgeo[(p0 + p) * geo_dim + (o - 1)] = z;
        }
      });
    }
    // outputs [n0, out_dim) in fp32 on the CUDA cores
    for (int idx = threadIdx.x; idx < (LD.out_dim - n0) * P; idx += NF_THREADS) {
      const int o = n0 + idx / P, p = idx % P;
      const float z = tc::final_row<TL>(LD, o, pt.src(buf), p);
      if (p0 + p < M) hgeo[(p0 + p) * geo_dim + (o - 1)] = z;
    }
    for (int idx = threadIdx.x; idx < m.c_pad * P; idx += NF_THREADS)
      ge[(idx / P) * LDV + idx % P] = 0.f;  // the encoding is not needed any more
    __syncthreads();
    pt.meet();  // the peer has read this block's rows in the final layer

    // the nablas sweep: g = W_D[0, :], then g <- (g s_l) W_l
    for (int idx = threadIdx.x; idx < pt.cols(LD.K) * P; idx += NF_THREADS)
      buf[(idx / P) * LDV + idx % P] = __ldg(LD.w + pt.lo() + idx / P);
    __syncthreads();
    for (int l = D - 1; l >= 0; --l) {
      const tc::Layer L = tc::layer_of(m, l);
      const float* sl = deriv + (size_t)l * m.rows * P + (size_t)pt.lo() * P;
      for (int idx = threadIdx.x; idx < pt.cols(L.N) * P; idx += NF_THREADS)
        buf[(idx / P) * LDV + idx % P] *= sl[idx];  // padded rows: slope 0
      pt.sync();
      tc::reverse_product<TL, S::KC, S::NBUF, S::PRESPLIT>(m, L, buf, stage, pt);
      tc::pull_input<TL>(m, L, l, buf, ge, pt);
    }
    pt.meet();  // both halves of g_e are summed

    // encoding pullback: d e / d x_c = 1, f cos(f x_c), -f sin(f x_c)
    for (int idx = threadIdx.x; idx < 3 * P; idx += NF_THREADS) {
      const int c = idx / P, p = idx % P;
      if (p0 + p >= M || !pt.lead()) continue;
      const float xc = xs[c * P + p];
      float n = pt.merged(ge, c * LDV + p);
      for (int f = 0; f < multires; ++f) {
        const float fr = ldexpf(1.f, f);
        const float ph = xc * fr;
        const float gs = pt.merged(ge, (3 + 6 * f + c) * LDV + p);
        const float gc = pt.merged(ge, (3 + 6 * f + 3 + c) * LDV + p);
        n += fr * (gs * cosf(ph) - gc * sinf(ph));
      }
      nablas[(p0 + p) * 3 + c] = n;
    }
    pt.sync();  // the next tile overwrites shared memory (a pair's g_e once read)
  }
}

}  // namespace ntt

namespace {

template <class TL>
size_t smem_bytes(int c_pad, int rows) {
  return ((size_t)4 * TL::P + (size_t)(c_pad + ntt::tc::held_rows<TL>(rows)) * TL::LDV +
          ntt::Nf<TL>::STAGE) *
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
  for (auto kernel : {ntt::nablas_forward_kernel<TL, ntt::ACT_SOFTPLUS>,
                      ntt::nablas_forward_kernel<TL, ntt::ACT_SINE>}) {
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (err == cudaSuccess) err = ntt::tc::resident<TL>(kernel, smem, optin, sms, &n);
    blocks = first || n < blocks ? n : blocks;
    first = false;
  }
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

template <class TL>
int launch(const ntt::tc::Mlp& m, int act, const void* x, int M, void* sdf, void* nablas,
           void* hgeo, int geo_dim, int blocks, void* slopes, cudaStream_t stream) {
  const size_t smem = smem_bytes<TL>(m.c_pad, m.rows);
  auto kernel = act == ntt::ACT_SINE ? ntt::nablas_forward_kernel<TL, ntt::ACT_SINE>
                                     : ntt::nablas_forward_kernel<TL, ntt::ACT_SOFTPLUS>;
  return (int)ntt::tc::launch<TL>(
      kernel, blocks, smem, stream, m, static_cast<const float*>(x), M,
      static_cast<float*>(sdf), static_cast<float*>(nablas), static_cast<float*>(hgeo),
      geo_dim, static_cast<float*>(slopes));
}

}  // namespace

// Shared memory of a block, in bytes; `tile` picks the tile (0 tc::Narrow,
// 128 points; 1 tc::Wide, 64; 2 tc::Cluster, 64 a pair), as
// ops/surface_pack.py records it.
extern "C" size_t ntt_nablas_forward_smem_bytes(int c_pad, int rows, int tile) {
  return ntt::tc::by_tile(tile, [&](auto t) { return smem_bytes<decltype(t)>(c_pad, rows); });
}

// Blocks of the kernel resident on the current card at once (the persistent
// grid's size before it is capped at one block, or one pair, per tile; the
// caller sizes the slope scratch, one slot of (n_layers - 1) x rows x the
// tile's points a block or a pair, by it). Sets the kernel's dynamic
// shared-memory cap to the card's opt-in maximum (so it never needs raising
// for a larger shape) and asks the occupancy of this shape's use. The
// wrapper calls it once per (card, c_pad, rows, tile) and keeps the answer.
// Returns a negative cudaError_t on failure, and 0 when a block (or a pair)
// does not fit.
extern "C" int ntt_nablas_forward_resident(int c_pad, int rows, int tile) {
  return ntt::tc::by_tile(tile, [&](auto t) { return resident<decltype(t)>(c_pad, rows); });
}

// x [M,3] -> sdf [M], nablas [M,3], hgeo [M,geo_dim]; all fp32, contiguous,
// on the device; `params` (three planes of `plane` floats) and `meta` the
// pack of ops/surface_pack.py; `act` the hidden layers' activation
// (ACT_SOFTPLUS or ACT_SINE); `tile` the tile; `slopes` scratch of one slot
// of (n_layers - 1) x rows x the tile's points (128, or 64 wide and
// cluster) floats a block (a pair of the cluster tile), `blocks` at most
// ntt_nablas_forward_resident's count (even for the cluster tile). Returns
// the cudaError_t of the launch.
extern "C" int ntt_nablas_forward(const void* x, int M, const void* params, long long plane,
                                  const void* meta, int n_layers, int in_ch, int c_pad,
                                  int rows, int act, int tile, void* sdf, void* nablas,
                                  void* hgeo, int geo_dim, int blocks, void* slopes,
                                  void* stream) {
  if (M <= 0) return 0;
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  if (tile < 0 || tile > 2 || (tile == 2 && blocks % 2)) return (int)cudaErrorInvalidValue;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ntt::tc::by_tile(tile, [&](auto t) {
    return launch<decltype(t)>(m, act, x, M, sdf, nablas, hgeo, geo_dim, blocks, slopes, st);
  });
}
