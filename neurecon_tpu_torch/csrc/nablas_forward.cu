// Surface-MLP forward + input gradient (nablas) — CUDA kernels for sm_90a.
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
// a split-fp32 tensor-core product (three TF32 products a multiply-add), so
// the bound is the tensor cores' operations, 12.4 ms per 1,044,480 points at
// the card's 495 TFLOP/s; the outputs (1.09 GB there) take 0.3 ms of HBM
// time.
//
// The narrow tile (padded hidden widths up to 256, final-layer rows up to
// 264): the warp-specialised TMA + wgmma pipeline of narrow_tile.cuh (its
// note has the design: one 384-thread block an SM on 64-point tiles, a
// producer warpgroup streaming each product's K-major weights by TMA through
// a ring of two 64 KB stages, two consumer warpgroups of 128 columns each,
// the split-fp32 wgmma products promoted into fp32 sums every 4 k-steps). The
// forward is kernel 4's (narrow_hidden), with each layer's slope s_l =
// phi'(a_l) computed in the epilogue from Softplus's own e^(100 a) (sigmoid =
// e / (1 + e)). The final layer's first 256 rows go through the product, rows
// 1..255 straight to h; the sdf row (row 0) and any row past 256 (the
// flagship's 257th, h's last column) run on the CUDA cores in fp32 from h_D,
// two lanes a point (narrow_row), as kernel 4's sdf row. The sdf row stays
// off the tensor cores: there the accumulator's truncation inside a promotion
// group adds to the sdf's bias against the plain version (a mean error of
// -4.5e-7 with the row in the product, -3.6e-7 with it here, at the flagship
// widths; the rest comes with h_D), and a NeuS step amplifies sdf errors
// through its alpha clamp (PERF.md, kernel 1's redesign). The sweep starts
// from W_D's sdf row times s_{D-1} and runs each reverse product g W_l as a
// wgmma product too: TF32 wgmma takes no transpose and wants its B K-major,
// and the K-major form of W_l as the B of g W_l is the pack's W^T [K][N]
// block, so the producer streams every hidden layer's W^T through the same
// ring after the forward's W (two tensor maps a hidden layer, one for the
// final layer). A reverse product's 64 outputs in a thread are the gradient
// at layer l's input in the forward's own columns of layer l - 1, so the
// thread multiplies them by the slopes it computed for those elements itself
// and writes g s_{l-1} in place as the next product's input; a skip layer's
// rows past h (over sqrt(2)) and layer 0's go to g_e, which reuses the
// encoding's buffer. The pullback through d e / d x runs on the CUDA cores, a
// warp on its 16 points. The slopes (D x 256 x 64 floats, 512 KB a tile) do
// not fit beside the ring and the activations: each consumer thread writes
// its 64 a layer to a device-memory scratch of the block's own, in its own
// order (float4s, a warp's 512 contiguous bytes), and reads them back once in
// the sweep, newest layer first, so the last-written are still in L2 (68 MB
// for 132 blocks, ~17 GB of traffic per 1,044,480 points less what L2 keeps);
// recomputing them would cost a second forward pass (the hidden layers'
// products, about half the kernel's). Shared memory (flagship widths): the
// ring 2 x 64 KB, the activations (then g) [256][72], the encoding (then g_e)
// [40][72], xs [3][64]: 218,144 bytes with the alignment slack, as kernel 4.
// The last tile may be ragged; its missing points are encoded as zeros and
// not written.
//
// A surface wider than 256 (up to 512 hidden columns and final-layer rows)
// runs the wide tile (surface_mma.cuh's mma.sync products): 64 points, 8
// column groups, every final-layer row in the product, the fp32 weight stage
// [2][16][520] split in registers: 226,560 bytes at W = 512, and a slope
// scratch of D x 512 x 64 floats a block. The tile is encoded, pushed
// through the hidden layers in place in one activation buffer (the slope
// s_l of every layer kept), and then through the final layer, whose
// accumulators go straight to sdf and h; the sweep starts from W_D's sdf
// row, multiplies by s_l and runs the reverse product through W_l (the
// pack's [N][K] block), splitting off the encoding's rows at the skip and
// at layer 0 into g_e, which reuses the encoding's buffer. A surface wider
// than 512 (up to 1024) runs the cluster tile (surface_mma.cuh): a pair of
// those blocks on one 64-point tile, each holding half of every layer's
// rows (W = 1024: [512][72] a block, 226,560 bytes), with one slope scratch
// of D x rows x 64 floats a pair, each block writing and reading its own
// rows. The final layer's product takes rows [0, 512) in block 0 and the
// rest (up to 1024) in block 1; at W_geo 256 its 257 rows sit whole in block
// 0, and block 1 waits at the next barrier. The encoding's gradient g_e is
// the two blocks' sum: block 0 reads block 1's through distributed shared
// memory in the pullback and writes the tile's sdf, nablas and h rows from
// the rows each block computes.
#include "narrow_tile.cuh"
#include "surface_mma.cuh"

namespace ntt {

// ---- the narrow tile: the wgmma pipeline

// The narrow tile's tensor maps (wg::weight_map), passed by value: every
// layer's W [N][K] (the forward's B, the final layer's included) and every
// hidden layer's W^T [K][N] (the sweep's).
struct NablasMaps {
  CUtensorMap w[narrow::MAXD + 1];
  CUtensorMap wT[narrow::MAXD];
};

// The sweep's step after the reverse product of layer l, `v` the thread's
// columns of g W_l (the gradient at layer l's input, its K rows): rows of h
// times layer l - 1's slopes `s` (the thread's own, from the forward) into
// `act` as the next product's input; the encoding's rows (past h_dim: a
// skip layer's, after the skip's 1/sqrt(2), and every row of layer 0, h_dim
// 0) added to g_e and written as zeros in `act`.
__device__ __forceinline__ void narrow_pull(const float (&v)[64], const float4 (&s)[16],
                                            float* act, float* ge, int K, int h_dim, bool skip,
                                            int in_ch, int half, int p, int t) {
  using narrow::LDV;
  const int n0 = 128 * half + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float sj[4] = {s[j].x, s[j].y, s[j].z, s[j].w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + 8 * j + (r & 1), q = p + 8 * ((r >> 1) & 1);
      float g = v[4 * j + r];
      if (skip) g *= 0.707106781187f;
      if (n < K && n < h_dim) {
        act[n * LDV + q] = g * sj[r];
      } else if (n < K) {
        act[n * LDV + q] = 0.f;
        if (n - h_dim < in_ch) ge[(n - h_dim) * LDV + q] += g;
      }
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(narrow::THREADS, 1)
nablas_forward_kernel_narrow(const __grid_constant__ NablasMaps maps, tc::Mlp m,
                             const float* __restrict__ x, int M, float* __restrict__ sdf,
                             float* __restrict__ nablas, float* __restrict__ hgeo, int geo_dim,
                             float4* slopes, int stages) {
  using namespace narrow;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  float* act = ring + stages * STAGE;  // [rows][LDV]: the activations, then g
  float* emb = act + m.rows * LDV;     // [c_pad][LDV]: the encoding, then g_e
  float* xs = emb + m.c_pad * LDV;     // [3][P]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + 3 * P);  // full[stages], empty[stages]
  float* ge = emb;
  const int D = m.n_layers - 1, multires = (m.in_ch - 3) / 6;
  const int n_tiles = (M + P - 1) / P;
  Ring rg = ring_start(ring, bars, stages);

  if (threadIdx.x < 128) {  // the producer warpgroup
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    for (int T = blockIdx.x; T < n_tiles; T += gridDim.x) {
      for (int l = 0; l <= D; ++l) {  // the forward's W, the final layer's first 256 rows
        const int* r = m.meta + l * tc::META;
        produce(rg, &maps.w[l], __ldg(r + 0) / 8, min(__ldg(r + 1), NMAX) > NC ? 2 : 1);
      }
      for (int l = D - 1; l >= 0; --l) {  // the sweep's W^T: depth N, K outputs
        const int* r = m.meta + l * tc::META;
        produce(rg, &maps.wT[l], __ldg(r + 1) / 8, __ldg(r + 0) > NC ? 2 : 1);
      }
    }
    return;
  }

  // a consumer warpgroup: columns [128 half, + 128) of every product for the
  // tile's 64 points, 16 a warp (a warp of each warpgroup on the same points)
  wg::regs_inc<CONSUMER_REGS>();
  const int half = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pw = (threadIdx.x / 32 % 4) * 16;  // the warp's first point in the tile
  const int p = pw + g;                        // the thread's points p and p + 8
  const int n0 = 128 * half + 2 * t;           // its first column (narrow_tile.cuh's note)
  float4* slope = slopes + (size_t)blockIdx.x * D * SLOPE_LAYER + (threadIdx.x - 128);
  const tc::Layer LD = tc::layer_of(m, D);
  const int nf = min(LD.N, NMAX);  // final-layer rows the product takes
  float sum[64];
  for (int T = blockIdx.x; T < n_tiles; T += gridDim.x) {
    const long p0 = (long)T * P;
    if (half == 0) narrow_embed(m, x, p0, M, pw, lane, xs, emb);
    consumers_sync();  // the encoding is written
    narrow_hidden<ACT, true>(m, rg, act, emb, sum, half, pw, p, t, lane, slope);

    // the final layer: rows [1, nf) from the product straight to h; the sdf
    // row (half 0) and rows [nf, out_dim) (half 1) in fp32 on the CUDA cores
    narrow_pass(act, LD.K / 8, rg, sum, 128 * half < nf, half, p, t, lane);
    if (128 * half < nf) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int o = n0 + 8 * (i >> 2) + (i & 1);
        const long q = p0 + p + 8 * ((i >> 1) & 1);
        if (o > 0 && o < LD.out_dim && o < nf && q < M)
          hgeo[q * geo_dim + (o - 1)] = sum[i] + __ldg(LD.b + o);
      }
    }
    const int q = pw + (lane & 15);
    if (half == 0) {
      const float s = narrow_row(act, LD.w, LD.K, q, lane);
      if (lane < 16 && p0 + q < M) sdf[p0 + q] = s + __ldg(LD.b);
      // g_e starts at zero: the encoding is read no more
      for (int idx = lane; idx < m.c_pad * 16; idx += 32)
        ge[(idx / 16) * LDV + pw + idx % 16] = 0.f;
    } else {
      for (int o = nf; o < LD.out_dim; ++o) {
        const float s = narrow_row(act, LD.w + (size_t)o * LD.K, LD.K, q, lane);
        if (lane < 16 && p0 + q < M) hgeo[(p0 + q) * geo_dim + (o - 1)] = s + __ldg(LD.b + o);
      }
    }
    consumers_sync();  // h_D is read

    // the nablas sweep: g = W_D[0, :] s_{D-1}, then g <- (g W_l) s_{l-1}
    const int N1 = __ldg(m.meta + (D - 1) * tc::META + 1);
    if (128 * half < N1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 s4 = slope[SLOPE_LAYER * (D - 1) + 256 * j];
        const float sj[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + 8 * j + (r & 1);
          if (n < N1) act[n * LDV + p + 8 * ((r >> 1) & 1)] = __ldg(LD.w + n) * sj[r];
        }
      }
    }
    consumers_sync();  // g is written
    for (int l = D - 1; l >= 0; --l) {
      const tc::Layer L = tc::layer_of(m, l);
      const bool mine = 128 * half < L.K;
      narrow_pass(act, L.N / 8, rg, sum, mine, half, p, t, lane);
      // layer l - 1's slopes, where this thread wrote them (it held columns
      // of that layer); the loads meet the other warpgroup's product
      float4 s[16];
      const bool held = l > 0 && 128 * half < __ldg(m.meta + (l - 1) * tc::META + 1);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s[j] = held ? slope[SLOPE_LAYER * (l - 1) + 256 * j] : make_float4(0.f, 0.f, 0.f, 0.f);
      consumers_sync();  // both warpgroups have read g
      const int h_dim = l == 0 ? 0 : L.skip ? L.in_dim - m.in_ch : 1 << 30;
      if (mine) narrow_pull(sum, s, act, ge, L.K, h_dim, L.skip, m.in_ch, half, p, t);
      consumers_sync();  // g (and g_e) written
    }

    // the encoding pullback, a warp of warpgroup 0 on its 16 points: d e /
    // d x_c = 1, f cos(f x_c), -f sin(f x_c)
    if (half == 0) {
      for (int idx = lane; idx < 3 * 16; idx += 32) {
        const int c = idx / 16, q = pw + idx % 16;
        if (p0 + q >= M) continue;
        const float xc = xs[c * P + q];
        float n = ge[c * LDV + q];
        for (int f = 0; f < multires; ++f) {
          const float fr = ldexpf(1.f, f);
          float sn, cs;
          sincosf(xc * fr, &sn, &cs);
          n += fr * (ge[(3 + 6 * f + c) * LDV + q] * cs - ge[(6 + 6 * f + c) * LDV + q] * sn);
        }
        nablas[(p0 + q) * 3 + c] = n;
      }
      __syncwarp();  // the next tile's encoding overwrites these points' xs and g_e
    }
  }
}

// ---- the wide and cluster tiles: surface_mma.cuh's products

// The tile (tc::Wide or tc::Cluster) and its weight stage: the fp32 plane,
// split in registers (shared memory is short beside the wide buffers).
template <class TL>
struct Nf {
  static constexpr int KC = 16;    // weight rows per staged chunk
  static constexpr int NBUF = 2;   // staged chunks: one computed, one in flight
  static constexpr bool PRESPLIT = false;
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

int narrow_launch(const ntt::tc::Mlp& m, const int* host_meta, int act, const void* x, int M,
                  void* sdf, void* nablas, void* hgeo, int geo_dim, int blocks, void* slopes,
                  cudaStream_t stream) {
  using namespace ntt::narrow;
  ntt::NablasMaps maps;
  int stages = 0;
  // a layer's maps from its record (K, N, out, in, offset of W^T, of W, ..):
  // W [N][K] (K inner), and a hidden layer's W^T [K][N] (N inner)
  auto make = [&](ntt::NablasMaps* mp, int D) {
    const float* big = m.params + m.plane;
    for (int l = 0; l <= D; ++l) {
      const int* r = host_meta + l * ntt::tc::META;
      if (!ntt::wg::weight_map<SW>(&mp->w[l], big + r[5], m.plane, r[0], r[1])) return false;
      if (l < D && !ntt::wg::weight_map<SW>(&mp->wT[l], big + r[4], m.plane, r[1], r[0]))
        return false;
    }
    return true;
  };
  if (const int err = plan(m, host_meta, &maps, &stages, make)) return err;
  auto kernel = act == ntt::ACT_SINE ? ntt::nablas_forward_kernel_narrow<ntt::ACT_SINE>
                                     : ntt::nablas_forward_kernel_narrow<ntt::ACT_SOFTPLUS>;
  kernel<<<blocks, THREADS, bytes(m.c_pad, m.rows, stages), stream>>>(
      maps, m, static_cast<const float*>(x), M, static_cast<float*>(sdf),
      static_cast<float*>(nablas), static_cast<float*>(hgeo), geo_dim,
      static_cast<float4*>(slopes), stages);
  return (int)cudaGetLastError();
}

// f(T{}) for the wide (1) or cluster (2) tile.
template <class F>
auto by_wide_tile(int tile, F&& f) {
  return tile == 2 ? f(ntt::tc::Cluster{}) : f(ntt::tc::Wide{});
}

// The grid of a launch of M points: `blocks` (at most the resident count)
// capped at one block, or one pair of the cluster tile, per 64-point tile.
int launch_blocks(int M, int blocks, int tile) {
  static_assert(ntt::narrow::P == ntt::tc::Wide::P, "one tile of points for every kernel 1");
  const long tiles = (M + (long)ntt::narrow::P - 1) / ntt::narrow::P;
  return (int)std::min<long>(blocks, tiles * (tile == 2 ? ntt::tc::Cluster::CL : 1));
}

}  // namespace

// Shared memory of a block, in bytes; `tile` picks the tile (0 the narrow
// wgmma pipeline, 1 tc::Wide, 2 tc::Cluster), as ops/surface_pack.py records
// it. The narrow tile's is at the ring stages the current card fits.
extern "C" size_t ntt_nablas_forward_smem_bytes(int c_pad, int rows, int tile) {
  if (tile == 0) {
    int optin = 0, sms = 0;
    if (ntt::narrow::optin_bytes(&optin, &sms)) return 0;
    return ntt::narrow::bytes(c_pad, rows, ntt::narrow::stages_for(c_pad, rows, optin));
  }
  return by_wide_tile(tile, [&](auto t) { return smem_bytes<decltype(t)>(c_pad, rows); });
}

// Blocks of the kernel resident on the current card at once (the persistent
// grid's size before ntt_nablas_forward caps it at one block, or one pair,
// per 64-point tile). Sets the kernel's dynamic
// shared-memory cap to the card's opt-in maximum (so it never needs raising
// for a larger shape) and asks the occupancy of this shape's use. The
// wrapper calls it once per (card, c_pad, rows, tile) and keeps the answer.
// Returns a negative cudaError_t on failure, and 0 when a block (or a pair)
// does not fit.
extern "C" int ntt_nablas_forward_resident(int c_pad, int rows, int tile) {
  if (tile == 0)
    return ntt::narrow::resident(c_pad, rows, ntt::nablas_forward_kernel_narrow<ntt::ACT_SOFTPLUS>,
                                 ntt::nablas_forward_kernel_narrow<ntt::ACT_SINE>);
  return by_wide_tile(tile, [&](auto t) { return resident<decltype(t)>(c_pad, rows); });
}

// Floats of the slope scratch that ntt_nablas_forward needs for M points on
// at most `blocks` blocks: a slot a block of the capped grid (a pair of the
// cluster tile), (n_layers - 1) x 256 x 64 floats on the narrow tile (each
// consumer thread's 64 slopes a layer in its own order), (n_layers - 1) x
// rows x 64 on the others.
extern "C" long long ntt_nablas_forward_scratch_floats(int M, int n_layers, int rows, int tile,
                                                      int blocks) {
  if (M <= 0) return 0;
  const long long slots = launch_blocks(M, blocks, tile) / (tile == 2 ? ntt::tc::Cluster::CL : 1);
  const long long layer =
      tile == 0 ? 4LL * ntt::narrow::SLOPE_LAYER : (long long)rows * ntt::tc::Wide::P;
  return slots * (n_layers - 1) * layer;
}

// x [M,3] -> sdf [M], nablas [M,3], hgeo [M,geo_dim]; all fp32, contiguous,
// on the device; `params` (three planes of `plane` floats) and `meta` the
// pack of ops/surface_pack.py, and `host_meta` its records in host memory
// (the narrow tile's tensor maps are made from them, once a pack); `act` the
// hidden layers' activation (ACT_SOFTPLUS or ACT_SINE); `tile` the tile;
// `blocks` at most ntt_nablas_forward_resident's count (even for the cluster
// tile), capped here at one block (or one pair) per 64-point tile; `slopes`
// scratch of ntt_nablas_forward_scratch_floats(M, n_layers, rows, tile,
// blocks) floats (16-byte aligned). Returns the cudaError_t of the launch:
// cudaErrorInvalidValue for a narrow surface of more than narrow::MAXD hidden
// layers.
extern "C" int ntt_nablas_forward(const void* x, int M, const void* params, long long plane,
                                  const void* meta, const void* host_meta, int n_layers,
                                  int in_ch, int c_pad, int rows, int act, int tile, void* sdf,
                                  void* nablas, void* hgeo, int geo_dim, int blocks,
                                  void* slopes, void* stream) {
  if (M <= 0) return 0;
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  if (tile < 0 || tile > 2 || (tile == 2 && blocks % 2)) return (int)cudaErrorInvalidValue;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  blocks = launch_blocks(M, blocks, tile);
  if (tile == 0)
    return narrow_launch(m, static_cast<const int*>(host_meta), act, x, M, sdf, nablas, hgeo,
                         geo_dim, blocks, slopes, st);
  return by_wide_tile(tile, [&](auto t) {
    return launch<decltype(t)>(m, act, x, M, sdf, nablas, hgeo, geo_dim, blocks, slopes, st);
  });
}
