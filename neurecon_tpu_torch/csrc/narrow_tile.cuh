// The narrow tile's warp-specialised TMA + wgmma split-fp32 pipeline
// (wgmma_tf32.cuh), shared by the sdf-only forward (sdf_forward.cu, kernel
// 4) and the forward + nablas (nablas_forward.cu, kernel 1) on every surface
// whose padded hidden widths are at most 256 (final-layer rows up to 264).
//
// One 384-thread block an SM walks tiles of 64 points. Warpgroup 0 is the
// producer: one thread streams each product's K-major weight block (both
// TF32 planes) by TMA through a ring of stages in shared memory (a stage: G
// = 4 k-steps of all 256 output columns, two 32 KB boxes, 128-byte swizzle;
// full / empty mbarriers a stage), in the order the consumers take them, and
// gives its registers up (setmaxnreg) to the two consumer warpgroups.
// Consumer warpgroup h computes output columns [128 h, 128 h + 128) of every
// product for the tile's 64 points (a warp 16 of them, the same 16 in both
// warpgroups): it loads each k-step's A fragment from an activation buffer
// [rows][LDV] in shared memory, splits it into TF32 big and small parts in
// registers, and issues small x big, big x small, big x big as
// `wgmma.mma_async` m64n128k8 with B from the ring. The tensor cores add
// into their fp32 accumulator with truncation, so one accumulator over a
// whole layer drifts (the promotion mutants of tools/mutants.py); each
// group of G k-steps goes into a fresh accumulator, added to the running
// fp32 sum on the CUDA cores (round to nearest) once the group is done: the
// promotion interval is 32 of K. Registers: the running sum and the fresh
// accumulator, 64 each. After a product the two warpgroups meet (a named
// barrier: both have read the input) before either writes its columns in
// place. A thread's 64 outputs of a product are its accumulator elements:
// element i at column 128 h + 8 (i >> 2) + 2 t + (i & 1) and point p + 8 ((i
// >> 1) & 1), (g, t) = (lane / 4, lane % 4), p = 16 (warp % 4) + g.
//
// Why 64 points and not 128: 128 points x 256 columns of running sums and
// fresh accumulators would need the whole register file. Why this ring: the
// weights stream from L2 once per 64 points, and a ring of two 64 KB stages
// (all the shared memory beside the activations) is bound by its round
// trip (~9 ms per 2^20 points of kernel 4's 8 layers on its own); a
// two-block cluster multicasting each box, and streaming the fp32 plane
// alone with the small part computed in shared memory, each halve the bytes
// from L2 and were both slower on the card (PERF.md, kernel 4's redesign).
#pragma once

#include <algorithm>
#include <mutex>

#include "surface_mma.cuh"
#include "wgmma_tf32.cuh"

namespace ntt {
namespace narrow {
constexpr int P = 64;                   // points a tile (a wgmma's 64 rows)
constexpr int LDV = P + 8;              // activation row stride in floats (conflict-free A loads)
constexpr int NC = 128;                 // output columns a consumer warpgroup
constexpr int NMAX = 2 * NC;            // output columns a product takes
constexpr int SW = 128;                 // bytes of a TMA box's rows and of their swizzle
constexpr int KB = SW / 32;             // k-steps a box
constexpr int G = 4;                    // k-steps a ring stage and a promotion group
static_assert(G % KB == 0, "whole boxes a stage");
constexpr int BOX = NC * (SW / 4) * 2;  // floats of one TMA box: 128 columns, both planes
constexpr int STAGE = G / KB * 2 * BOX; // floats of a stage: G k-steps of 256 columns
constexpr int THREADS = 384;            // the producer warpgroup and two consumers
constexpr int MAXD = 24;                // hidden layers the tensor maps take
constexpr int MAX_STAGES = 6;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 40 + 2 x 232 per lane of 128
constexpr int SLOPE_LAYER = 16 * 256;  // float4s of a block's slopes a layer (16 a consumer thread)
// the block's shape as tc::resident counts it
struct Block {
  static constexpr int THREADS = narrow::THREADS;
  static constexpr int CL = 1;
};
}  // namespace narrow

// The two consumer warpgroups' barrier (id 1; 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// e^(100 z) on the special-function unit (ex2.approx.ftz), the shared term
// of Softplus(beta = 100) and of its slope sigmoid(100 z).
__device__ __forceinline__ float exp100(float z) {
  const float y = 100.f * z;
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(y * 1.44269504089f));
  return e;
}

// Softplus(beta = 100) of z as log(1 + e^(100 z)) / 100 (z itself past 100 z
// = 20, as torch's threshold) on the special-function unit, straight-line:
// both sides computed and one selected, so that a thread's 64 activations
// interleave (a branch per activation runs them one after another, each at
// the full latency of its two MUFU operations). ex2 and lg2 put an
// activation ~1e-9 off the exact log1pf(expf(.)) / 100, where the sdf's check
// is 1e-5 of max|sdf|. `e` is exp100(z).
__device__ __forceinline__ float softplus100(float z, float e) {
  float l;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(l) : "f"(1.f + e));
  const float y = 100.f * z;
  return (y > 20.f ? y : l * 0.693147180560f) * 0.01f;
}
__device__ __forceinline__ float softplus100(float z) { return softplus100(z, exp100(z)); }

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

// The producer's stream of one product: the K-major block of `map` (depth
// `nks` k-steps; `halves` boxes of 128 output columns a k-step group), group
// by group into the ring.
__device__ __forceinline__ void produce(Ring& rg, const CUtensorMap* map, int nks, int halves) {
  using namespace narrow;
  for (int q = 0; q < nks; q += G) {
    const int boxes = (min(G, nks - q) + KB - 1) / KB;  // past K a box reads zeros
    wg::mbar_wait(rg.empty + rg.stage, rg.phase ^ 1);
    wg::mbar_expect_tx(rg.full + rg.stage, boxes * halves * BOX * sizeof(float));
    for (int b = 0; b < boxes; ++b)
      for (int h = 0; h < halves; ++h)
        wg::tma_load_3d(rg.buf + rg.stage * STAGE + (2 * b + h) * BOX, map, rg.full + rg.stage,
                        8 * (q + KB * b), NC * h, 0);
    rg.advance();
  }
}

// A consumer warpgroup's pass over the K rows of V: sum = V^T B for its 128
// columns (`mine`: the product has any of them; else it only keeps pace with
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

// The block's start: the ring zeroed (a k-step past K still feeds its slot
// to a wgmma, against zero A: the ring starts as zeros, and holds finite
// weights from then on) and its mbarriers made; every thread returns the
// ring's cursor at stage 0.
__device__ __forceinline__ Ring ring_start(float* ring, uint64_t* bars, int stages) {
  using namespace narrow;
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
  return Ring{ring, bars, bars + stages, stages, 0, 0u};
}

// The positional encoding of the warp's 16 points from q0 on (x [M, 3] from
// point p0 on; points past M as zeros) into xs [3][P] and emb [c_pad][LDV],
// as surface_mma.cuh's embed_tile.
__device__ __forceinline__ void narrow_embed(const tc::Mlp& m, const float* __restrict__ x,
                                             long p0, int M, int q0, int lane, float* xs,
                                             float* emb) {
  using narrow::LDV;
  using narrow::P;
  for (int idx = lane; idx < 3 * 16; idx += 32) {
    const int c = idx / 16, q = q0 + idx % 16;
    xs[c * P + q] = (p0 + q < M) ? x[(p0 + q) * 3 + c] : 0.f;
  }
  __syncwarp();
  for (int idx = lane; idx < m.c_pad * 16; idx += 32) {
    const int c = idx / 16, q = q0 + idx % 16;
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

// Row `w` [K] of the final layer against h_D in `act` for the warp's point
// q, in fp32 on the CUDA cores: two lanes a point (lane and lane ^ 16), each
// on alternate 4-row blocks of K; both return the sum (no bias).
__device__ __forceinline__ float narrow_row(const float* act, const float* __restrict__ w, int K,
                                            int q, int lane) {
  using narrow::LDV;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int k = 4 * (lane >> 4); k < K; k += 8) {
    s0 += act[k * LDV + q] * __ldg(w + k);
    s1 += act[(k + 1) * LDV + q] * __ldg(w + k + 1);
    s2 += act[(k + 2) * LDV + q] * __ldg(w + k + 2);
    s3 += act[(k + 3) * LDV + q] * __ldg(w + k + 3);
  }
  const float s = (s0 + s1) + (s2 + s3);
  return s + __shfl_xor_sync(0xffffffffu, s, 16);
}

// The hidden activation of a pre-activation sum `a` plus bias `b` (0 on a
// padded column, `real` false), over sqrt(2) when it is the next (SKIP)
// layer's input, as the plain forward scales the skip's input (a multiply
// by 1 / sqrt(2): the division's slow-path check would again split the
// activations); with SLOPE also its slope phi'(a + b) into `s` (0 on a
// padded column): sigmoid(100 z) = e / (1 + e) from Softplus's own e =
// e^(100 z) (1 past 100 z = 20, where it is 1 in fp32), or 30 cos(30 z).
// The sine as sinf / sincosf: 30 a reaches tens of radians, where __sinf's
// error grows.
template <int ACT, bool SKIP, bool SLOPE>
__device__ __forceinline__ float narrow_act(float a, float b, bool real, float& s) {
  float v;
  if constexpr (ACT == ACT_SINE) {
    if constexpr (SLOPE) {
      float c;
      sincosf(SIREN_W0 * (a + b), &v, &c);
      s = SIREN_W0 * c;
    } else {
      v = sinf(SIREN_W0 * (a + b));
    }
  } else {
    const float e = exp100(a + b);
    v = softplus100(a + b, e);
    if constexpr (SLOPE) s = 100.f * (a + b) > 20.f ? 1.f : __fdividef(e, 1.f + e);
  }
  v = real ? v : 0.f;
  if constexpr (SLOPE) s = real ? s : 0.f;
  if constexpr (SKIP) v *= 0.707106781187f;
  return v;
}

// A consumer warpgroup's columns [128 half, + 128) of the layer's output,
// activated (in place in v, the biases loaded first), into the activation
// buffer at the thread's points p and p + 8, up to the layer's N; rows from
// `skip_from` on are left to the skip's fill. With SLOPE the thread's 64
// slopes go to `slope` in its own order (slope[256 j] the float4 of
// elements 4 j .. 4 j + 3), whole: the sweep reads them back in the same
// thread.
template <int ACT, bool SKIP, bool SLOPE>
__device__ __forceinline__ void narrow_write(float (&v)[64], float* act, const tc::Layer& L,
                                             int half, int skip_from, int p, int t,
                                             float4* slope) {
  using narrow::LDV;
  const int n0 = 128 * half + 2 * t;
  float b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = n0 + 8 * (i >> 1) + (i & 1);
    b[i] = n < L.out_dim ? __ldg(L.b + n) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + 8 * j + (r & 1);
      v[4 * j + r] =
          narrow_act<ACT, SKIP, SLOPE>(v[4 * j + r], b[2 * j + (r & 1)], n < L.out_dim, s[r]);
    }
    if constexpr (SLOPE) slope[256 * j] = make_float4(s[0], s[1], s[2], s[3]);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int n = n0 + 8 * (i >> 2) + (i & 1);
    if (n < L.N && n < skip_from) act[n * LDV + p + 8 * ((i >> 1) & 1)] = v[i];
  }
}

// The consumers' forward of one tile through the hidden layers: the
// encoding `emb` in, h_D in `act` out (each layer written in place over its
// input once both warpgroups have read it; the skip layer's input rows past
// h filled from the encoding, over sqrt(2)); with SLOPE every layer's slopes
// to `slope` (the thread's slot: layer l's at slope + SLOPE_LAYER l). Ends
// after the consumers' barrier that follows the last layer's write.
template <int ACT, bool SLOPE>
__device__ __forceinline__ void narrow_hidden(const tc::Mlp& m, Ring& rg, float* act,
                                              const float* emb, float (&sum)[64], int half,
                                              int pw, int p, int t, int lane, float4* slope) {
  using narrow::LDV;
  const int D = m.n_layers - 1;
  for (int l = 0; l < D; ++l) {
    const tc::Layer L = tc::layer_of(m, l);
    const bool mine = 128 * half < L.N;
    narrow_pass(l == 0 ? emb : act, L.K / 8, rg, sum, mine, half, p, t, lane);
    consumers_sync();  // both warpgroups have read the layer's input
    const bool skip_next = l + 1 < D && __ldg(m.meta + (l + 1) * tc::META + 7);
    const tc::Layer S = tc::layer_of(m, skip_next ? l + 1 : l);
    const int h_dim = skip_next ? S.in_dim - m.in_ch : 1 << 30;
    float4* sl = SLOPE ? slope + narrow::SLOPE_LAYER * l : nullptr;
    if (mine && skip_next) narrow_write<ACT, true, SLOPE>(sum, act, L, half, h_dim, p, t, sl);
    if (mine && !skip_next) narrow_write<ACT, false, SLOPE>(sum, act, L, half, h_dim, p, t, sl);
    if (skip_next) {  // the skip layer's input rows past h: the encoding, then zeros
      for (int idx = lane; idx < (S.K - h_dim) * 16; idx += 32) {
        const int c = idx / 16, q = pw + idx % 16;
        if ((h_dim + c) / 128 == half)
          act[(h_dim + c) * LDV + q] = c < m.in_ch ? emb[c * LDV + q] / 1.41421356237f : 0.f;
      }
    }
    consumers_sync();  // the layer's output is written
  }
}

}  // namespace ntt

namespace ntt {
namespace narrow {

// ---- host side

inline int optin_bytes(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// The block's shared memory: the ring's `stages`, the activations, the
// encoding, xs, two mbarriers a stage, and 1 KB to align the ring.
inline size_t bytes(int c_pad, int rows, int stages) {
  return 1024 + ((size_t)stages * STAGE + (size_t)(rows + c_pad) * LDV + 3 * P) * sizeof(float) +
         (size_t)stages * 2 * sizeof(uint64_t);
}

// Ring stages that fit beside the rest in `optin` bytes, at most MAX_STAGES;
// 0 when fewer than two do.
inline int stages_for(int c_pad, int rows, int optin) {
  int n = 0;
  while (n < MAX_STAGES && bytes(c_pad, rows, n + 1) <= (size_t)optin) ++n;
  return n >= 2 ? n : 0;
}

// Blocks of the narrow kernel's two instantiations (the fewer) resident on
// the current card at once; 0 when a block does not fit; a negative
// cudaError_t on failure.
template <class Kernel>
int resident(int c_pad, int rows, Kernel k_softplus, Kernel k_sine) {
  int optin = 0, sms = 0;
  int err = optin_bytes(&optin, &sms);
  if (err) return -err;
  const int stages = stages_for(c_pad, rows, optin);
  if (!stages) return 0;
  int blocks = 0;
  bool first = true;
  for (auto kernel : {k_softplus, k_sine}) {
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (!err)
      err = (int)tc::resident<Block>(kernel, bytes(c_pad, rows, stages), optin, sms, &n);
    blocks = first || n < blocks ? n : blocks;
    first = false;
  }
  return err ? -err : blocks;
}

// A narrow launch's plan for one pack: the ring's stages on the card and the
// kernel's tensor maps (`Maps`). A map holds only the weights' address and
// shape, so a plan is exact for every launch with its key (the card, the
// params pointer, the plane, the widths and every layer's record); the last
// PLANS plans are kept, so that a repeated launch encodes no map and asks
// the card nothing.
template <class Maps>
struct Plan {
  int dev = -1, D = 0, c_pad = 0, rows = 0, stages = 0;
  const float* params = nullptr;
  size_t plane = 0;
  int rec[(MAXD + 1) * tc::META];
  Maps maps;
};
constexpr int PLANS = 8;

// Copies the plan of (m, host_meta) on the current card into maps and
// stages, made first when no kept plan has its key: `make(maps, D)` encodes
// the maps (false on failure). Returns a cudaError_t: cudaErrorInvalidValue
// for more than MAXD hidden layers.
template <class Maps, class Make>
int plan(const tc::Mlp& m, const int* host_meta, Maps* maps, int* stages, Make&& make) {
  const int D = m.n_layers - 1;
  if (D < 1 || D > MAXD || !host_meta) return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  static std::mutex mu;
  static Plan<Maps> plans[PLANS];
  static int next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  const int n_rec = (D + 1) * tc::META;
  for (const Plan<Maps>& pl : plans) {
    if (pl.dev == dev && pl.params == m.params && pl.plane == m.plane && pl.D == D &&
        pl.c_pad == m.c_pad && pl.rows == m.rows &&
        std::equal(host_meta, host_meta + n_rec, pl.rec)) {
      *maps = pl.maps;
      *stages = pl.stages;
      return 0;
    }
  }
  Plan<Maps>& pl = plans[next];
  pl.dev = -1;
  int optin = 0, sms = 0;
  if (const int err = optin_bytes(&optin, &sms)) return err;
  pl.stages = stages_for(m.c_pad, m.rows, optin);
  if (!pl.stages) return (int)cudaErrorInvalidConfiguration;
  if (!make(&pl.maps, D)) return (int)cudaErrorInvalidValue;
  std::copy(host_meta, host_meta + n_rec, pl.rec);
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

}  // namespace narrow
}  // namespace ntt
