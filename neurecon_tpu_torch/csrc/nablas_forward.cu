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
// slope scratch of D x 512 x 64 floats a block.
#include "surface_mma.cuh"

namespace ntt {

// The tile (tc::Narrow or tc::Wide) and its weight stage: both TF32 parts on
// the narrow tile, the fp32 plane on the wide one, where shared memory is short.
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
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [4][P]
  float* emb = xs + 4 * P;                      // [c_pad][LDV] encoding, then g_e
  float* buf = emb + m.c_pad * LDV;             // [rows][LDV]
  float* stage = buf + m.rows * LDV;            // S::STAGE
  float* ge = emb;
  const int D = m.n_layers - 1, C = m.in_ch, multires = (C - 3) / 6;
  float* deriv = slopes + (size_t)blockIdx.x * D * m.rows * P;  // [D][rows][P]
  const tc::Layer LD = tc::layer_of(m, D);
  const int n0 = min(LD.N, TL::NMAX);  // final-layer outputs the product takes
  const int tiles = (M + P - 1) / P;
  for (int T = blockIdx.x; T < tiles; T += gridDim.x) {
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
      if (L.skip) tc::skip_input<TL>(m, L, emb, buf);
      tc::Acc<TL> acc;
      tc::product<TL, S::KC, S::NBUF, S::PRESPLIT>(L.wT, m.plane, L.K, L.N, L.N,
                                                   l == 0 ? emb : buf, stage, acc);
      tc::activation_out<TL, ACT>(L, acc, buf, deriv + (size_t)l * m.rows * P);
      __syncthreads();
    }

    // the final layer: outputs [0, n0) from the product, straight out
    {
      tc::Acc<TL> acc;
      tc::product<TL, S::KC, S::NBUF, S::PRESPLIT>(LD.wT, m.plane, LD.K, n0, LD.N, buf, stage,
                                                   acc);
      tc::each_output<TL>(acc, n0, [&](int o, int p, float a) {
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
      const float z = tc::final_row<TL>(LD, o, buf, p);
      if (p0 + p < M) hgeo[(p0 + p) * geo_dim + (o - 1)] = z;
    }
    for (int idx = threadIdx.x; idx < m.c_pad * P; idx += NF_THREADS)
      ge[(idx / P) * LDV + idx % P] = 0.f;  // the encoding is not needed any more
    __syncthreads();

    // the nablas sweep: g = W_D[0, :], then g <- (g s_l) W_l
    for (int idx = threadIdx.x; idx < LD.K * P; idx += NF_THREADS)
      buf[(idx / P) * LDV + idx % P] = __ldg(LD.w + idx / P);
    __syncthreads();
    for (int l = D - 1; l >= 0; --l) {
      const tc::Layer L = tc::layer_of(m, l);
      const float* sl = deriv + (size_t)l * m.rows * P;
      for (int idx = threadIdx.x; idx < L.N * P; idx += NF_THREADS)
        buf[(idx / P) * LDV + idx % P] *= sl[idx];  // padded rows: slope 0
      __syncthreads();
      tc::reverse_product<TL, S::KC, S::NBUF, S::PRESPLIT>(m, L, buf, stage);
      tc::pull_input<TL>(m, L, l, buf, ge);
    }

    // encoding pullback: d e / d x_c = 1, f cos(f x_c), -f sin(f x_c)
    for (int idx = threadIdx.x; idx < 3 * P; idx += NF_THREADS) {
      const int c = idx / P, p = idx % P;
      if (p0 + p >= M) continue;
      const float xc = xs[c * P + p];
      float n = ge[c * LDV + p];
      for (int f = 0; f < multires; ++f) {
        const float fr = ldexpf(1.f, f);
        const float ph = xc * fr;
        const float gs = ge[(3 + 6 * f + c) * LDV + p];
        const float gc = ge[(3 + 6 * f + 3 + c) * LDV + p];
        n += fr * (gs * cosf(ph) - gc * sinf(ph));
      }
      nablas[(p0 + p) * 3 + c] = n;
    }
    __syncthreads();  // the next tile overwrites shared memory
  }
}

}  // namespace ntt

namespace {

template <class TL>
size_t smem_bytes(int c_pad, int rows) {
  return ((size_t)4 * TL::P + (size_t)(c_pad + rows) * TL::LDV + ntt::Nf<TL>::STAGE) *
         sizeof(float);
}

template <class TL>
int resident(int c_pad, int rows) {
  const size_t smem = smem_bytes<TL>(c_pad, rows);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > (size_t)optin) return 0;
  bool first = true;
  for (auto kernel : {ntt::nablas_forward_kernel<TL, ntt::ACT_SOFTPLUS>,
                      ntt::nablas_forward_kernel<TL, ntt::ACT_SINE>}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TL::THREADS, smem);
    per_sm = first || n < per_sm ? n : per_sm;
    first = false;
  }
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

template <class TL>
int launch(const ntt::tc::Mlp& m, int act, const void* x, int M, void* sdf, void* nablas,
           void* hgeo, int geo_dim, int blocks, void* slopes, cudaStream_t stream) {
  const size_t smem = smem_bytes<TL>(m.c_pad, m.rows);
  auto kernel = act == ntt::ACT_SINE ? ntt::nablas_forward_kernel<TL, ntt::ACT_SINE>
                                     : ntt::nablas_forward_kernel<TL, ntt::ACT_SOFTPLUS>;
  kernel<<<blocks, TL::THREADS, smem, stream>>>(
      m, static_cast<const float*>(x), M, static_cast<float*>(sdf),
      static_cast<float*>(nablas), static_cast<float*>(hgeo), geo_dim,
      static_cast<float*>(slopes));
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of a block, in bytes; `wide` picks the tile (tc::Wide, 64
// points, else tc::Narrow, 128), as ops/surface_pack.py records it.
extern "C" size_t ntt_nablas_forward_smem_bytes(int c_pad, int rows, int wide) {
  return wide ? smem_bytes<ntt::tc::Wide>(c_pad, rows)
              : smem_bytes<ntt::tc::Narrow>(c_pad, rows);
}

// Blocks of the kernel resident on the current card at once (the persistent
// grid's size before it is capped at one block per tile; the caller sizes
// the slope scratch, blocks x (n_layers - 1) x rows x the tile's points, by
// it). Sets the kernel's dynamic shared-memory cap to the card's opt-in
// maximum (so it never needs raising for a larger shape) and asks the
// occupancy of this shape's use. The wrapper calls it once per (card, c_pad,
// rows, wide) and keeps the answer. Returns a negative cudaError_t on
// failure, and 0 when a block does not fit.
extern "C" int ntt_nablas_forward_resident(int c_pad, int rows, int wide) {
  return wide ? resident<ntt::tc::Wide>(c_pad, rows) : resident<ntt::tc::Narrow>(c_pad, rows);
}

// x [M,3] -> sdf [M], nablas [M,3], hgeo [M,geo_dim]; all fp32, contiguous,
// on the device; `params` (three planes of `plane` floats) and `meta` the
// pack of ops/surface_pack.py; `act` the hidden layers' activation
// (ACT_SOFTPLUS or ACT_SINE); `wide` the tile; `slopes` scratch of `blocks`
// x (n_layers - 1) x rows x the tile's points (128, or 64 wide) floats,
// `blocks` at most ntt_nablas_forward_resident's count. Returns the
// cudaError_t of the launch.
extern "C" int ntt_nablas_forward(const void* x, int M, const void* params, long long plane,
                                  const void* meta, int n_layers, int in_ch, int c_pad,
                                  int rows, int act, int wide, void* sdf, void* nablas,
                                  void* hgeo, int geo_dim, int blocks, void* slopes,
                                  void* stream) {
  if (M <= 0) return 0;
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? launch<ntt::tc::Wide>(m, act, x, M, sdf, nablas, hgeo, geo_dim, blocks,
                                      slopes, st)
              : launch<ntt::tc::Narrow>(m, act, x, M, sdf, nablas, hgeo, geo_dim, blocks,
                                        slopes, st);
}
