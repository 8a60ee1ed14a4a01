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
// 264): a warp-specialised wgmma pipeline (wgmma_tf32.cuh), one 384-thread
// block an SM walking tiles of 64 points. Warpgroup 0 is the producer: one
// thread streams every layer's W [N][K], both TF32 planes, by TMA through a
// ring of stages in shared memory (a stage: G = 4 k-steps of all 256 output
// columns, two 32 KB boxes, 128-byte swizzle; full / empty mbarriers a
// stage), and gives its registers up (setmaxnreg) to the two consumer
// warpgroups. Consumer warpgroup h computes output columns [128 h, 128 h +
// 128) of every layer for the tile's 64 points (a warp 16 of them): it loads
// each k-step's A fragment from the activation buffer, splits it into TF32
// big and small parts in registers, and issues small x big, big x small,
// big x big as `wgmma.mma_async` m64n128k8 with B from the ring. The tensor
// cores add into their fp32 accumulator with truncation, so one accumulator
// over a whole layer drifts (the promotion mutant of tools/mutants.py);
// each group of G k-steps goes into a fresh accumulator, added to the
// running fp32 sum on the CUDA cores (round to nearest) once the group is
// done: the promotion interval is 32 of K. Registers: the running sum and
// the fresh accumulator, 64 each. After a layer's products the two
// warpgroups meet (a named barrier: both have read the input), write their
// columns' activations in place, and meet again. Why 64 points and not 128:
// 128 points x 256 columns of running sums and fresh accumulators would
// need the whole register file; and why this ring: the weights stream from
// L2 once per 64 points (60 GB per 2^20 points), and a ring of two 64 KB
// stages (all the shared memory beside the activations) delivers them in
// ~9 ms per 2^20 points on its own, which with the products and the
// epilogue is most of the kernel's time. A two-block cluster multicasting
// each box, and streaming the fp32 plane alone with the small part
// computed in shared memory, each halve the bytes from L2 and were both
// slower on the card: the ring is bound by its round trip, not by L2's
// bandwidth. The epilogue is straight-line code (softplus100), so that a
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
#include <mutex>

#include "surface_mma.cuh"
#include "wgmma_tf32.cuh"

namespace ntt {

// ---- the narrow tile: the wgmma pipeline

namespace narrow {
constexpr int P = 64;                   // points a tile (a wgmma's 64 rows)
constexpr int LDV = P + 8;              // activation row stride in floats (conflict-free A loads)
constexpr int NC = 128;                 // output columns a consumer warpgroup
constexpr int SW = 128;                 // bytes of a TMA box's rows and of their swizzle
constexpr int KB = SW / 32;             // k-steps a box
constexpr int G = 4;                    // k-steps a ring stage and a promotion group
static_assert(G % KB == 0, "whole boxes a stage");
constexpr int BOX = NC * (SW / 4) * 2;  // floats of one TMA box: 128 columns, both planes
constexpr int STAGE = G / KB * 2 * BOX; // floats of a stage: G k-steps of 256 columns
constexpr int THREADS = 384;            // the producer warpgroup and two consumers
constexpr int MAXD = 24;                // hidden layers the maps take
constexpr int MAX_STAGES = 6;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 40 + 2 x 232 per lane of 128
// the block's shape as tc::resident counts it
struct Block {
  static constexpr int THREADS = narrow::THREADS;
  static constexpr int CL = 1;
};
}  // namespace narrow

// One tensor map per hidden layer (wg::weight_map), passed by value.
struct SdfMaps {
  CUtensorMap w[narrow::MAXD];
};

// The two consumer warpgroups' barrier (id 1; 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Softplus(beta = 100) of z as log(1 + e^(100 z)) / 100 (z itself past 100 z
// = 20, as torch's threshold) on the special-function unit, straight-line:
// both sides computed and one selected, so that a thread's 64 activations
// interleave (a branch per activation runs them one after another, each at
// the full latency of its two MUFU operations). ex2 and lg2 put an
// activation ~1e-9 off the exact log1pf(expf(.)) / 100, where the sdf's check
// is 1e-5 of max|sdf|.
__device__ __forceinline__ float softplus100(float z) {
  const float y = 100.f * z;
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(y * 1.44269504089f));
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(l) : "f"(1.f + e));
  return (y > 20.f ? y : l * 0.693147180560f) * 0.01f;
}

// The hidden activation of a pre-activation sum `a` plus bias `b` (0 on a
// padded column, `real` false), over sqrt(2) when it is the next (SKIP)
// layer's input, as the plain forward scales the skip's input (a multiply
// by 1 / sqrt(2): the division's slow-path check would again split the
// activations). The sine as sinf: 30 a reaches tens of radians, where
// __sinf's error grows.
template <int ACT, bool SKIP>
__device__ __forceinline__ float narrow_act(float a, float b, bool real) {
  float v;
  if constexpr (ACT == ACT_SINE)
    v = sinf(SIREN_W0 * (a + b));
  else
    v = softplus100(a + b);
  v = real ? v : 0.f;
  if constexpr (SKIP) v *= 0.707106781187f;
  return v;
}

// The ring's cursor: the stage a consumer (or the producer) takes next and
// the parity of its current round.
struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int n, stage;
  uint32_t phase;
  __device__ void advance() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A consumer warpgroup's pass over the K rows of V: sum = V^T B for its 128
// columns (`mine`: the layer has any of them; else it only keeps pace with
// the ring), B from the ring, group by group: each group's three products a
// k-step into a fresh accumulator, then added to the fp32 sum.
__device__ __forceinline__ void narrow_pass(const float* V, int nks, Ring& ring, float (&sum)[64],
                                            bool mine, int half, int p, int t, int lane) {
  using namespace narrow;
  float fresh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = fresh[i] = 0.f;
  for (int q = 0; q < nks; q += G) {
    const int n = min(G, nks - q);
    uint32_t ab[G][4], as[G][4];
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (s < n) {
        const float* v = V + (8 * (q + s) + t) * LDV + p;
        tc::split_tf32(v[0], ab[s][0], as[s][0]);
        tc::split_tf32(v[8], ab[s][1], as[s][1]);
        tc::split_tf32(v[4 * LDV], ab[s][2], as[s][2]);
        tc::split_tf32(v[4 * LDV + 8], ab[s][3], as[s][3]);
      } else {  // past K: zeros against the slot's stale (finite) weights
#pragma unroll
        for (int r = 0; r < 4; ++r) ab[s][r] = as[s][r] = 0u;
      }
    }
    wg::mbar_wait(ring.full + ring.stage, ring.phase);
    if (mine) {
      const float* st = ring.buf + ring.stage * STAGE + half * BOX;
      wg::fence_operands(fresh);
      wg::wgmma_fence();
      uint64_t big[G];  // each k-step's big plane; its small plane NC x SW bytes on
#pragma unroll
      for (int s = 0; s < G; ++s)
        big[s] = wg::desc_k_major<SW>(st + s / KB * 2 * BOX) + 2 * (s % KB);
      // the group's small terms first, while the fresh accumulator is small
      // (its truncating adds then lose bits of small sums), the big x big
      // products last
#pragma unroll
      for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, as[s], big[s], s > 0);
#pragma unroll
      for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, ab[s], big[s] + ((NC * SW) >> 4), 1);
#pragma unroll
      for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, ab[s], big[s], 1);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operands(fresh);
    }
    if (lane == 0) wg::mbar_arrive(ring.empty + ring.stage);
    if (mine) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += fresh[i];
    }
    ring.advance();
  }
}

// A consumer warpgroup's columns [128 half, + 128) of the layer's output,
// activated (in place in v, the biases loaded first), into the activation
// buffer at the thread's points p and p + 8, up to the layer's N; rows from
// `skip_from` on are left to the skip's fill.
template <int ACT, bool SKIP>
__device__ __forceinline__ void narrow_write(float (&v)[64], float* act, const tc::Layer& L,
                                             int half, int skip_from, int p, int t) {
  using narrow::LDV;
  const int n0 = 128 * half + 2 * t;
  float b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = n0 + 8 * (i >> 1) + (i & 1);
    b[i] = n < L.out_dim ? __ldg(L.b + n) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int n = n0 + 8 * (i >> 2) + (i & 1);
    v[i] = narrow_act<ACT, SKIP>(v[i], b[2 * (i >> 2) + (i & 1)], n < L.out_dim);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int n = n0 + 8 * (i >> 2) + (i & 1);
    if (n < L.N && n < skip_from) act[n * LDV + p + 8 * ((i >> 1) & 1)] = v[i];
  }
}

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

  // a k-step past K still feeds its slot to a wgmma (against zero A): the
  // ring starts as zeros, and holds finite weights from then on
  for (int i = threadIdx.x; i < stages * STAGE; i += THREADS) ring[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(bars + s, 1);           // the producer's arrival, and the bytes
      wg::mbar_init(bars + stages + s, 8);  // one arrival per consumer warp
    }
    wg::fence_barrier_init();
  }
  wg::fence_proxy_async();
  __syncthreads();
  Ring rg{ring, bars, bars + stages, stages, 0, 0u};

  if (threadIdx.x < 128) {  // the producer warpgroup
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    for (int T = blockIdx.x; T < n_tiles; T += gridDim.x)
      for (int l = 0; l < D; ++l) {
        const int* r = m.meta + l * tc::META;
        const int nks = __ldg(r + 0) / 8, halves = __ldg(r + 1) > NC ? 2 : 1;
        for (int q = 0; q < nks; q += G) {
          const int boxes = (min(G, nks - q) + KB - 1) / KB;  // past K a box reads zeros
          wg::mbar_wait(rg.empty + rg.stage, rg.phase ^ 1);
          wg::mbar_expect_tx(rg.full + rg.stage, boxes * halves * BOX * sizeof(float));
          for (int b = 0; b < boxes; ++b)
            for (int h = 0; h < halves; ++h)
              wg::tma_load_3d(rg.buf + rg.stage * STAGE + (2 * b + h) * BOX, &maps.w[l],
                              rg.full + rg.stage, 8 * (q + KB * b), NC * h, 0);
          rg.advance();
        }
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
    if (half == 0) {
      for (int idx = lane; idx < 3 * 16; idx += 32) {
        const int c = idx / 16, q = pw + idx % 16;
        xs[c * P + q] = (p0 + q < M) ? x[(p0 + q) * 3 + c] : 0.f;
      }
      __syncwarp();
      // the positional encoding, as surface_mma.cuh's embed_tile
      for (int idx = lane; idx < m.c_pad * 16; idx += 32) {
        const int c = idx / 16, q = pw + idx % 16;
        float v = 0.f;
        if (c < 3) {
          v = xs[c * P + q];
        } else if (c < m.in_ch) {
          const int j = c - 3, f = j / 6, r = j % 6;
          const float ph = xs[(r % 3) * P + q] * ldexpf(1.f, f);
          v = (r < 3) ? sinf(ph) : cosf(ph);
        }
        emb[c * LDV + q] = v;
      }
    }
    consumers_sync();  // the encoding is written; the last tile's sdf row is read
    for (int l = 0; l < D; ++l) {
      const tc::Layer L = tc::layer_of(m, l);
      const bool mine = 128 * half < L.N;
      narrow_pass(l == 0 ? emb : act, L.K / 8, rg, sum, mine, half, p, t, lane);
      consumers_sync();  // both warpgroups have read the layer's input
      const bool skip_next = l + 1 < D && __ldg(m.meta + (l + 1) * tc::META + 7);
      const tc::Layer S = tc::layer_of(m, skip_next ? l + 1 : l);
      const int h_dim = skip_next ? S.in_dim - m.in_ch : 1 << 30;
      if (mine && skip_next) narrow_write<ACT, true>(sum, act, L, half, h_dim, p, t);
      if (mine && !skip_next) narrow_write<ACT, false>(sum, act, L, half, h_dim, p, t);
      if (skip_next) {  // the skip layer's input rows past h: the encoding, then zeros
        for (int idx = lane; idx < (S.K - h_dim) * 16; idx += 32) {
          const int c = idx / 16, q = pw + idx % 16;
          if ((h_dim + c) / 128 == half)
            act[(h_dim + c) * LDV + q] = c < m.in_ch ? emb[c * LDV + q] / 1.41421356237f : 0.f;
        }
      }
      consumers_sync();  // the layer's output is written
    }
    if (half == 0) {
      // the sdf row, in fp32 on the CUDA cores: two lanes a point, each on
      // alternate 4-row blocks of K
      const tc::Layer LD = tc::layer_of(m, D);
      const int q = pw + (lane & 15);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int k = 4 * (lane >> 4); k < LD.K; k += 8) {
        s0 += act[k * LDV + q] * __ldg(LD.w + k);
        s1 += act[(k + 1) * LDV + q] * __ldg(LD.w + k + 1);
        s2 += act[(k + 2) * LDV + q] * __ldg(LD.w + k + 2);
        s3 += act[(k + 3) * LDV + q] * __ldg(LD.w + k + 3);
      }
      float s = (s0 + s1) + (s2 + s3);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
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

int optin_bytes(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// The narrow tile's shared memory: the ring's `stages`, the activations, the
// encoding, xs, two mbarriers a stage, and 1 KB to align the ring.
size_t narrow_bytes(int c_pad, int rows, int stages) {
  using namespace ntt::narrow;
  return 1024 + ((size_t)stages * STAGE + (size_t)(rows + c_pad) * LDV + 3 * P) * sizeof(float) +
         (size_t)stages * 2 * sizeof(uint64_t);
}

// Ring stages that fit beside the rest in `optin` bytes, at most MAX_STAGES;
// 0 when fewer than two do.
int narrow_stages(int c_pad, int rows, int optin) {
  using namespace ntt::narrow;
  int n = 0;
  while (n < MAX_STAGES && narrow_bytes(c_pad, rows, n + 1) <= (size_t)optin) ++n;
  return n >= 2 ? n : 0;
}

int narrow_resident(int c_pad, int rows) {
  int optin = 0, sms = 0;
  int err = optin_bytes(&optin, &sms);
  if (err) return -err;
  const int stages = narrow_stages(c_pad, rows, optin);
  if (!stages) return 0;
  int blocks = 0;
  bool first = true;
  for (auto kernel : {ntt::sdf_forward_kernel_narrow<ntt::ACT_SOFTPLUS>,
                      ntt::sdf_forward_kernel_narrow<ntt::ACT_SINE>}) {
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (!err)
      err = (int)ntt::tc::resident<ntt::narrow::Block>(kernel, narrow_bytes(c_pad, rows, stages),
                                                     optin, sms, &n);
    blocks = first || n < blocks ? n : blocks;
    first = false;
  }
  return err ? -err : blocks;
}

// A narrow launch's plan for one pack: the ring's stages on the card and a
// tensor map a hidden layer. A map holds only the weights' address and
// shape, so a plan is exact for every launch with its key (the card, the
// params pointer, the plane, the widths and each layer's K, N and offset);
// the last PLANS plans are kept, so that a repeated launch encodes no map
// and asks the card nothing.
struct NarrowPlan {
  int dev = -1, D = 0, c_pad = 0, rows = 0, stages = 0;
  const float* params = nullptr;
  size_t plane = 0;
  int rec[ntt::narrow::MAXD][3];  // K, N, off W
  ntt::SdfMaps maps;
};
constexpr int PLANS = 8;

// Copies the plan of (m, host_meta) on the current card into maps and
// stages, made first when no kept plan has its key. Returns a cudaError_t.
int narrow_plan(const ntt::tc::Mlp& m, const int* host_meta, ntt::SdfMaps* maps, int* stages) {
  using namespace ntt::narrow;
  const int D = m.n_layers - 1;
  if (D < 1 || D > MAXD || !host_meta) return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  static std::mutex mu;
  static NarrowPlan plans[PLANS];
  static int next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  auto rec = [&](int l) { return host_meta + l * ntt::tc::META; };  // K, N, out, in, off W^T, off W, ..
  for (const NarrowPlan& pl : plans) {
    bool same = pl.dev == dev && pl.params == m.params && pl.plane == m.plane && pl.D == D &&
                pl.c_pad == m.c_pad && pl.rows == m.rows;
    for (int l = 0; same && l < D; ++l)
      same = pl.rec[l][0] == rec(l)[0] && pl.rec[l][1] == rec(l)[1] && pl.rec[l][2] == rec(l)[5];
    if (same) {
      *maps = pl.maps;
      *stages = pl.stages;
      return 0;
    }
  }
  NarrowPlan& pl = plans[next];
  pl.dev = -1;
  int optin = 0, sms = 0;
  if (const int err = optin_bytes(&optin, &sms)) return err;
  pl.stages = narrow_stages(m.c_pad, m.rows, optin);
  if (!pl.stages) return (int)cudaErrorInvalidConfiguration;
  for (int l = 0; l < D; ++l) {
    const int* r = rec(l);
    if (!ntt::wg::weight_map<SW>(&pl.maps.w[l], m.params + m.plane + r[5], m.plane, r[0], r[1]))
      return (int)cudaErrorInvalidValue;
    pl.rec[l][0] = r[0];
    pl.rec[l][1] = r[1];
    pl.rec[l][2] = r[5];
  }
  pl.dev = dev;
  pl.params = m.params;
  pl.plane = m.plane;
  pl.D = D;
  pl.c_pad = m.c_pad;
  pl.rows = m.rows;
  next = (next + 1) % PLANS;
  *maps = pl.maps;
  *stages = pl.stages;
  return 0;
}

int narrow_launch(const ntt::tc::Mlp& m, const int* host_meta, int act, const float* x, int M,
                  float* sdf, int blocks, cudaStream_t stream) {
  using namespace ntt::narrow;
  ntt::SdfMaps maps;
  int stages = 0;
  if (const int err = narrow_plan(m, host_meta, &maps, &stages)) return err;
  auto kernel = act == ntt::ACT_SINE ? ntt::sdf_forward_kernel_narrow<ntt::ACT_SINE>
                                     : ntt::sdf_forward_kernel_narrow<ntt::ACT_SOFTPLUS>;
  kernel<<<blocks, THREADS, narrow_bytes(m.c_pad, m.rows, stages), stream>>>(maps, m, x, M, sdf,
                                                                            stages);
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
    return narrow_bytes(c_pad, rows, narrow_stages(c_pad, rows, optin));
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
  if (tile == 0) return narrow_resident(c_pad, rows);
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
