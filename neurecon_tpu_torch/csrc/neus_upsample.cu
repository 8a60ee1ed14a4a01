// NeuS hierarchical upsampler (`official_solution`) — one CUDA kernel for
// sm_90a.
//
// Replaces the Pallas megakernel `_make_upsample_kernel` of
// neurecon_tpu/ops/fused_upsample.py (entry `fused_neus_upsample`), with the
// semantics of the plain loop in neurecon_tpu/models/frameworks/neus.py
// (`neus_upsample`): coarse sdf query, then per round i the section slope
// estimate (min with the previous slope, clipped to [-10, 0]), sigmoid cdf at
// s = 64 * 2^i, alpha = (pc - nc + 1e-5) / (pc + 1e-5), visibility weights by
// a cumprod of max(1 - alpha, 0) + 1e-10, the +1e-5 pdf/cdf, inverse CDF at
// the caller's sorted uniforms, sdf re-query, and a stable merge (old samples
// before new ones at equal depth). Unlike the Pallas kernel, the sdf query
// includes the optional sphere_residual prior |x| - r, as the plain
// upsampler does.
//
// What bounds it: the MLP queries, 128 points a ray at 459,008 multiply-adds
// each (the hidden layers and the sdf row, at the flagship widths); the
// per-ray scalar stages are O(128) work. The queries run as split-fp32
// tensor-core products (surface_mma.cuh), so the bound is the tensor cores'
// operations: 2.9 ms per 4,096 rays at 495 TFLOP/s (three TF32 MMAs a
// multiply-add), 0.36 ms per 512.
//
// Design. A block of R rays (one warp each for the scalar stages) keeps each
// ray's sorted depths and sdf (up to n_coarse + n_iters * n_per entries) in
// shared memory, and queries the MLP on tiles of P points: the R x n_coarse
// coarse points, then each round's R x n_per new ones, through the hidden
// layers as kernel 4 runs them (products in place in one activation
// buffer), the sdf row in fp32 on the CUDA cores, plus the prior. With R =
// P / 16 a round's new points are one tile. The block's size is picked per
// call (the wrapper): P = 128, R = 8 (512 threads) when that gives every SM
// a block, else P = 64, R = 4 (256 threads): at a training step's 512 rays,
// 128 blocks, where 8 rays a block would leave 68 of the card's 132 SMs
// idle. One block an SM either way (P = 64 stages both TF32 parts of the
// weights, 164,736 bytes of shared memory at the flagship widths; P = 128
// has room only for the fp32 stage and splits it in registers, 218,624
// bytes). A surface wider than 256 (up to 512) runs the wide tile
// (surface_mma.cuh): 4 rays on 64-point tiles, 512 threads in 8 column
// groups, the fp32 stage in chunks of 8 rows (at W = 512: 204,160 bytes; 16
// rows would take 237,440). A surface wider than 512 (up to 1024) runs the
// cluster tile (surface_mma.cuh): a pair of those blocks on the same 4 rays,
// each holding half of every layer's rows (W = 1024: 204,160 bytes a
// block), both summing the sdf row over the two halves and running the
// rays' scalar stages alike on their own copies (the same instructions on
// the same values), block 0 writing d_all; 512 rays make 128 pairs. The
// scalar stages: elementwise over lanes, the cumprod and the
// pdf/cdf prefix sums sequentially on lane 0 (their order decides which det
// u = 1.0 entries tie), a binary search per uniform, and the merge as a rank
// count (own index + number of foreign elements before it). None of the TPU
// kernel's lane padding, counting searches, one-hot gathers or
// triangular-matmul prefix sums is needed.
#include "surface_mma.cuh"

namespace ntt {

// The weight stage of a tile: both TF32 parts on the narrow 64-point tile,
// the fp32 plane (split in registers) on the narrow 128-point one, where
// shared memory is short, and on the wide ones in chunks of 8 rows.
template <class TL>
struct Up {
  static constexpr bool PRESPLIT = TL::P == 64 && TL::CG == 4;
  static constexpr int KC = TL::CG == 4 ? 16 : 8;  // weight rows per staged chunk
  static constexpr int NBUF = 2;  // staged chunks: one computed, one in flight
  static constexpr int STAGE = tc::stage_floats<TL>(KC, NBUF, PRESPLIT);
  static constexpr int THREADS = TL::THREADS;
};

struct Bufs {
  float* ray;   // [R][8]: o xyz, d xyz
  float* d;     // [R][S] sorted depths
  float* s;     // [R][S] sdf at those depths
  float* d2;    // [R][S] scratch (pdf, merge output)
  float* s2;    // [R][S]
  float* cdf;   // [R][S]
  float* nd;    // [R][n_per] new depths
  float* ns;    // [R][n_per] sdf at the new depths
};

// sdf at depth dep[r * stride + j] of ray r, for j < n and the block's R
// rays, written to sd[r * stride + j]: P points a tile through the hidden
// layers (tensor cores), the sdf row and the sphere prior (sphere_r >= 0).
template <class TL, int ACT>
__device__ void query(const tc::Mlp& m, const Bufs& B, int R, const float* dep, float* sd,
                      int stride, int n, float sphere_r, float* xs, float* emb, float* buf,
                      float* stage) {
  constexpr int P = TL::P;
  using U = Up<TL>;
  const tc::Part<TL> pt(m.rows);
  const int total = R * n, D = m.n_layers - 1;
  const tc::Layer LD = tc::layer_of(m, D);
  for (int t0 = 0; t0 < total; t0 += P) {
    for (int idx = threadIdx.x; idx < 3 * P; idx += U::THREADS) {
      const int c = idx / P, p = idx % P, q = t0 + p;
      float v = 0.f;
      if (q < total) {
        const int r = q / n, j = q % n;
        v = __fadd_rn(B.ray[r * 8 + c], __fmul_rn(B.ray[r * 8 + 3 + c], dep[r * stride + j]));
      }
      xs[idx] = v;
    }
    __syncthreads();
    tc::embed_tile<TL>(m, xs, emb);
    __syncthreads();
    for (int l = 0; l < D; ++l) {
      const tc::Layer L = tc::layer_of(m, l);
      if (L.skip) tc::skip_input<TL>(m, L, emb, buf, pt);
      tc::Acc<TL> acc;
      tc::product<TL, U::KC, U::NBUF, U::PRESPLIT>(L.wT + pt.lo(), m.plane, L.K,
                                                   pt.cols(L.N), L.N,
                                                   l == 0 ? pt.local(emb) : pt.src(buf),
                                                   stage, acc);
      pt.meet();
      tc::activation_out<TL, ACT>(L, acc, buf, nullptr, pt);
      pt.sync();
    }
    for (int p = threadIdx.x; p < P; p += U::THREADS) {
      const int q = t0 + p;
      if (q >= total) continue;
      float v = tc::final_row<TL>(LD, 0, pt.src(buf), p);
      if (sphere_r >= 0.f) {
        const float x0 = xs[p], x1 = xs[P + p], x2 = xs[2 * P + p];
        v += sqrtf(x0 * x0 + x1 * x1 + x2 * x2 + 1e-12f) - sphere_r;
      }
      sd[(q / n) * stride + q % n] = v;
    }
    pt.sync();  // (a pair: both have read the other's rows)
  }
}

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

// One warp: weights over the B-1 sections of ray buffers (d, s) at
// sharpness sc, then cdf [B] with a leading 0. pdf goes through `tmp`.
__device__ void section_cdf(const float* d, const float* s, float* cdf,
                            float* tmp, int B, float sc) {
  const int lane = threadIdx.x % 32;
  for (int j = lane; j < B - 1; j += 32) {
    const float dot = (s[j + 1] - s[j]) / (d[j + 1] - d[j] + 1e-5f);
    const float prev = (j == 0) ? 0.f : (s[j] - s[j - 1]) / (d[j] - d[j - 1] + 1e-5f);
    const float dv = fminf(fmaxf(fminf(prev, dot), -10.f), 0.f);
    const float mid = 0.5f * (s[j] + s[j + 1]);
    const float dist = d[j + 1] - d[j];
    const float half = __fmul_rn(__fmul_rn(dv, dist), 0.5f);
    const float pc = sigmoidf(__fsub_rn(mid, half) * sc);
    const float nc = sigmoidf(__fadd_rn(mid, half) * sc);
    cdf[j] = (pc - nc + 1e-5f) / (pc + 1e-5f);  // alpha
  }
  __syncwarp();
  if (lane == 0) {
    float T = 1.f, sum = 0.f;
    for (int j = 0; j < B - 1; ++j) {
      const float a = cdf[j];
      const float w5 = __fmul_rn(a, T) + 1e-5f;
      T = __fmul_rn(T, fmaxf(1.f - a, 0.f) + 1e-10f);
      tmp[j] = w5;
      sum += w5;
    }
    float c = 0.f;
    cdf[0] = 0.f;
    for (int j = 0; j < B - 1; ++j) {
      c += tmp[j] / sum;
      cdf[j + 1] = c;
    }
  }
  __syncwarp();
}

template <class TL, int ACT>
__global__ void __launch_bounds__(Up<TL>::THREADS, 1)
neus_upsample_kernel(tc::Mlp m, const float* __restrict__ rays_o,
                     const float* __restrict__ rays_d,
                     const float* __restrict__ d_coarse,
                     const float* __restrict__ u, int N, int R, int n_coarse,
                     int n_iters, int n_per, float sphere_r,
                     float* __restrict__ d_out) {
  constexpr int P = TL::P, LDV = TL::LDV, THREADS = Up<TL>::THREADS;
  const tc::Part<TL> pt(m.rows);
  extern __shared__ float4 smem4[];
  const int S = n_coarse + n_iters * n_per;
  float* xs = reinterpret_cast<float*>(smem4);  // [4][P]
  float* emb = xs + 4 * P;                      // [c_pad][LDV]
  float* buf = emb + m.c_pad * LDV;             // [rows][LDV] (a pair: its half)
  float* stage = buf + tc::held_rows<TL>(m.rows) * LDV;  // Up<TL>::STAGE
  Bufs B;
  B.ray = stage + Up<TL>::STAGE;
  B.d = B.ray + R * 8;
  B.s = B.d + R * S;
  B.d2 = B.s + R * S;
  B.s2 = B.d2 + R * S;
  B.cdf = B.s2 + R * S;
  B.nd = B.cdf + R * S;
  B.ns = B.nd + R * n_per;

  const long ray0 = (long)pt.slot() * R;
  for (int idx = threadIdx.x; idx < R * 6; idx += THREADS) {
    const int r = idx / 6, c = idx % 6;
    float v = 0.f;
    if (ray0 + r < N) v = (c < 3) ? rays_o[(ray0 + r) * 3 + c] : rays_d[(ray0 + r) * 3 + c - 3];
    B.ray[r * 8 + c] = v;
  }
  for (int idx = threadIdx.x; idx < R * n_coarse; idx += THREADS) {
    const int r = idx / n_coarse, j = idx % n_coarse;
    B.d[r * S + j] = (ray0 + r < N) ? d_coarse[(ray0 + r) * n_coarse + j] : 0.f;
  }
  __syncthreads();
  query<TL, ACT>(m, B, R, B.d, B.s, S, n_coarse, sphere_r, xs, emb, buf, stage);

  // warp r < R does ray r's scalar stages; the other warps only query
  const int lane = threadIdx.x % 32, r = threadIdx.x / 32;
  const bool mine = r < R, valid = ray0 + r < N;
  float* d = B.d + r * S;
  float* s = B.s + r * S;
  float* d2 = B.d2 + r * S;
  float* s2 = B.s2 + r * S;
  float* cdf = B.cdf + r * S;
  float* nd = B.nd + r * n_per;
  float* ns = B.ns + r * n_per;
  int nb = n_coarse;
  for (int it = 0; it < n_iters; ++it) {
    if (mine) {
      section_cdf(d, s, cdf, d2, nb, 64.f * (float)(1 << it));
      for (int j = lane; j < n_per; j += 32) {
        const float uu = valid ? u[(ray0 + r) * (long)(n_iters * n_per) + it * n_per + j] : 0.f;
        int lo = 0, hi = nb;  // first index with cdf >= u == count(cdf < u)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cdf[mid] < uu) lo = mid + 1; else hi = mid;
        }
        const int below = max(lo - 1, 0), above = min(lo, nb - 1);
        const float cb = cdf[below], ca = cdf[above];
        const float bb = d[below], ba = d[above];
        float den = ca - cb;
        if (den < 1e-5f) den = 1.f;
        const float t = (uu - cb) / den;
        nd[j] = __fadd_rn(bb, __fmul_rn(t, ba - bb));
      }
    }
    __syncthreads();
    query<TL, ACT>(m, B, R, B.nd, B.ns, n_per, n_per, sphere_r, xs, emb, buf, stage);
    if (mine) {
      // stable merge == stable sort of concat([old, new]) by depth
      for (int i = lane; i < nb; i += 32) {
        const float v = d[i];
        int cnt = 0;
        for (int k = 0; k < n_per; ++k) cnt += nd[k] < v;
        d2[i + cnt] = v;
        s2[i + cnt] = s[i];
      }
      for (int j = lane; j < n_per; j += 32) {
        const float v = nd[j];
        int pos = 0;
        for (int k = 0; k < n_per; ++k) pos += (nd[k] < v) || (nd[k] == v && k < j);
        for (int i = 0; i < nb; ++i) pos += d[i] <= v;
        d2[pos] = v;
        s2[pos] = ns[j];
      }
      __syncwarp();
      for (int i = lane; i < nb + n_per; i += 32) {
        d[i] = d2[i];
        s[i] = s2[i];
      }
      __syncwarp();
    }
    nb += n_per;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * S; idx += THREADS) {
    const int rr = idx / S, j = idx % S;
    if (ray0 + rr < N && pt.lead()) d_out[(ray0 + rr) * S + j] = B.d[rr * S + j];
  }
}

template <class TL>
size_t smem_bytes(int c_pad, int rows, int R, int S, int n_per) {
  constexpr int P = TL::P, LDV = TL::LDV;
  return ((size_t)4 * P + (size_t)(c_pad + tc::held_rows<TL>(rows)) * LDV + Up<TL>::STAGE +
          (size_t)R * 8 + (size_t)R * (5 * S + 2 * n_per)) * sizeof(float);
}

}  // namespace ntt

// Sets every instantiation's dynamic shared-memory cap to the card's opt-in
// maximum, once per card (a cap set per shape would have to grow with it),
// and returns the card's SM count, which the wrapper picks the block size
// by. A negative cudaError_t on failure.
extern "C" int ntt_neus_upsample_setup() {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  using Small = ntt::tc::Tile<64, 4>;
  for (auto kernel : {ntt::neus_upsample_kernel<Small, ntt::ACT_SOFTPLUS>,
                      ntt::neus_upsample_kernel<Small, ntt::ACT_SINE>,
                      ntt::neus_upsample_kernel<ntt::tc::Narrow, ntt::ACT_SOFTPLUS>,
                      ntt::neus_upsample_kernel<ntt::tc::Narrow, ntt::ACT_SINE>,
                      ntt::neus_upsample_kernel<ntt::tc::Wide, ntt::ACT_SOFTPLUS>,
                      ntt::neus_upsample_kernel<ntt::tc::Wide, ntt::ACT_SINE>,
                      ntt::neus_upsample_kernel<ntt::tc::Cluster, ntt::ACT_SOFTPLUS>,
                      ntt::neus_upsample_kernel<ntt::tc::Cluster, ntt::ACT_SINE>}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return -(int)err;
  return sms;
}

namespace {

template <class TL>
int launch(const ntt::tc::Mlp& m, int act, const void* rays_o, const void* rays_d,
           const void* d_coarse, const void* u, int N, int R, int n_coarse, int n_iters,
           int n_per, float sphere_r, void* d_out, cudaStream_t stream) {
  const int S = n_coarse + n_iters * n_per;
  const size_t smem = ntt::smem_bytes<TL>(m.c_pad, m.rows, R, S, n_per);
  const int blocks = TL::CL * ((N + R - 1) / R);  // a block (a pair) per R rays
  auto kernel = act == ntt::ACT_SINE ? ntt::neus_upsample_kernel<TL, ntt::ACT_SINE>
                                     : ntt::neus_upsample_kernel<TL, ntt::ACT_SOFTPLUS>;
  return (int)ntt::tc::launch<TL>(
      kernel, blocks, smem, stream, m, static_cast<const float*>(rays_o),
      static_cast<const float*>(rays_d), static_cast<const float*>(d_coarse),
      static_cast<const float*>(u), N, R, n_coarse, n_iters, n_per, sphere_r,
      static_cast<float*>(d_out));
}

}  // namespace

// rays_o, rays_d [N,3] (d unit), d_coarse [N,n_coarse] sorted, u
// [N, n_iters*n_per] sorted within each round -> d_out [N, n_coarse +
// n_iters*n_per] sorted. Blocks of R rays on P-point tiles: the narrow tiles
// (`tile` 0) at P 64 with R <= 8, or 128 with R <= 16; the wide tile
// (`tile` 1, a surface wider than 256) at P 64 with R <= 16, and the cluster
// tile (`tile` 2, wider than 512) the same a pair; after
// ntt_neus_upsample_setup. `params` (three planes of `plane` floats) and
// `meta` the pack of ops/surface_pack.py; sphere_r < 0: no sphere_residual
// prior; `act` the hidden layers' activation (ACT_SOFTPLUS or ACT_SINE).
// Returns the cudaError_t of the launch.
extern "C" int ntt_neus_upsample(const void* rays_o, const void* rays_d, const void* d_coarse,
                                 const void* u, int N, int n_coarse, int n_iters, int n_per,
                                 const void* params, long long plane, const void* meta,
                                 int n_layers, int in_ch, int c_pad, int rows, int act,
                                 int tile, float sphere_r, int P, int R, void* d_out,
                                 void* stream) {
  if (N <= 0) return 0;
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  const bool small = tile == 0 && P == 64 && R >= 1 && R <= 8;
  const bool narrow = tile == 0 && P == 128 && R >= 1 && R <= 16;
  const bool wide64 = tile == 1 && P == 64 && R >= 1 && R <= 16;
  const bool pair64 = tile == 2 && P == 64 && R >= 1 && R <= 16;
  if (!(small || narrow || wide64 || pair64)) return (int)cudaErrorInvalidValue;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair64)
    return launch<ntt::tc::Cluster>(m, act, rays_o, rays_d, d_coarse, u, N, R, n_coarse,
                                    n_iters, n_per, sphere_r, d_out, st);
  if (wide64)
    return launch<ntt::tc::Wide>(m, act, rays_o, rays_d, d_coarse, u, N, R, n_coarse, n_iters,
                                 n_per, sphere_r, d_out, st);
  if (narrow)
    return launch<ntt::tc::Narrow>(m, act, rays_o, rays_d, d_coarse, u, N, R, n_coarse,
                                   n_iters, n_per, sphere_r, d_out, st);
  return launch<ntt::tc::Tile<64, 4>>(m, act, rays_o, rays_d, d_coarse, u, N, R, n_coarse,
                                      n_iters, n_per, sphere_r, d_out, st);
}
