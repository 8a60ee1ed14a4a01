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
// What bounds it: the MLP queries (about 0.92 MFLOP per point, 128 points per
// ray at the flagship widths); the per-ray scalar stages are O(128) work.
//
// Design. A block of 256 threads owns 8 rays. Each ray's sorted depth and sdf
// buffers (up to n_coarse + n_iters * n_per_iter entries) live in shared
// memory. The MLP runs through the shared tile routine (surface_mlp.cuh), 16
// points at a time, the sdf row only, weights streamed through its
// shared-memory stage. Warp w does ray w's scalar stages: the
// elementwise stages over lanes, the cumprod and the pdf/cdf prefix sums
// sequentially on lane 0, a binary search per uniform, and the merge as a
// parallel rank count (own index + number of foreign elements before it).
// None of the TPU kernel's lane padding, counting searches, one-hot gathers
// or triangular-matmul prefix sums is needed.
#include "surface_mlp.cuh"

namespace ntt {

constexpr int RAYS = THREADS / 32;  // rays per block, one warp each

struct Bufs {
  float* ray;   // [RAYS][8]: o xyz, d xyz
  float* d;     // [RAYS][S] sorted depths
  float* s;     // [RAYS][S] sdf at those depths
  float* d2;    // [RAYS][S] scratch (pdf, merge output)
  float* s2;    // [RAYS][S]
  float* cdf;   // [RAYS][S]
  float* nd;    // [RAYS][n_per] new depths
  float* ns;    // [RAYS][n_per] sdf at the new depths
};

// sdf at depth dep[r * stride + j] of ray r, for j < n, written to
// sd[r * stride + j]; all RAYS rays, TILE points per MLP pass.
__device__ void query(const Mlp& m, const Bufs& B, const float* dep, float* sd,
                      int stride, int n, float sphere_r, float* xs, float* emb,
                      float* bufA, float* bufB, float* stage, float* tile_sdf) {
  const int total = RAYS * n;
  for (int t0 = 0; t0 < total; t0 += TILE) {
    for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
      const int c = idx / TILE, p = idx % TILE, q = t0 + p;
      float v = 0.f;
      if (q < total) {
        const int r = q / n, j = q % n;
        v = __fadd_rn(B.ray[r * 8 + c],
                      __fmul_rn(B.ray[r * 8 + 3 + c], dep[r * stride + j]));
      }
      xs[idx] = v;
    }
    __syncthreads();
    embed_tile(m, xs, emb);
    __syncthreads();
    const float* h = hidden_forward(m, emb, bufA, bufB, nullptr, stage);
    sdf_row_tile(m, h, tile_sdf);
    __syncthreads();
    for (int p = threadIdx.x; p < TILE; p += blockDim.x) {
      const int q = t0 + p;
      if (q >= total) continue;
      float v = tile_sdf[p];
      if (sphere_r >= 0.f) {
        const float x0 = xs[p], x1 = xs[TILE + p], x2 = xs[2 * TILE + p];
        v += sqrtf(x0 * x0 + x1 * x1 + x2 * x2 + 1e-12f) - sphere_r;
      }
      sd[(q / n) * stride + q % n] = v;
    }
    __syncthreads();
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

__global__ void __launch_bounds__(THREADS)
neus_upsample_kernel(Mlp m, const float* __restrict__ rays_o,
                     const float* __restrict__ rays_d,
                     const float* __restrict__ d_coarse,
                     const float* __restrict__ u, int N, int n_coarse,
                     int n_iters, int n_per, float sphere_r,
                     float* __restrict__ d_out) {
  extern __shared__ float4 smem4[];
  const int S = n_coarse + n_iters * n_per;
  float* xs = reinterpret_cast<float*>(smem4);
  float* emb = xs + 4 * TILE;
  float* bufA = emb + m.in_ch * TILE;
  float* bufB = bufA + m.wmax * TILE;
  float* stage = bufB + m.wmax * TILE;
  float* tile_sdf = stage + STAGE_FLOATS;
  Bufs B;
  B.ray = tile_sdf + TILE;
  B.d = B.ray + RAYS * 8;
  B.s = B.d + RAYS * S;
  B.d2 = B.s + RAYS * S;
  B.s2 = B.d2 + RAYS * S;
  B.cdf = B.s2 + RAYS * S;
  B.nd = B.cdf + RAYS * S;
  B.ns = B.nd + RAYS * n_per;

  const long ray0 = (long)blockIdx.x * RAYS;
  for (int idx = threadIdx.x; idx < RAYS * 6; idx += blockDim.x) {
    const int r = idx / 6, c = idx % 6;
    float v = 0.f;
    if (ray0 + r < N) v = (c < 3) ? rays_o[(ray0 + r) * 3 + c] : rays_d[(ray0 + r) * 3 + c - 3];
    B.ray[r * 8 + c] = v;
  }
  for (int idx = threadIdx.x; idx < RAYS * n_coarse; idx += blockDim.x) {
    const int r = idx / n_coarse, j = idx % n_coarse;
    B.d[r * S + j] = (ray0 + r < N) ? d_coarse[(ray0 + r) * n_coarse + j] : 0.f;
  }
  __syncthreads();
  query(m, B, B.d, B.s, S, n_coarse, sphere_r, xs, emb, bufA, bufB, stage, tile_sdf);

  const int lane = threadIdx.x % 32, r = threadIdx.x / 32;
  const bool valid = ray0 + r < N;
  float* d = B.d + r * S;
  float* s = B.s + r * S;
  float* d2 = B.d2 + r * S;
  float* s2 = B.s2 + r * S;
  float* cdf = B.cdf + r * S;
  float* nd = B.nd + r * n_per;
  float* ns = B.ns + r * n_per;
  int nb = n_coarse;
  for (int it = 0; it < n_iters; ++it) {
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
    __syncthreads();
    query(m, B, B.nd, B.ns, n_per, n_per, sphere_r, xs, emb, bufA, bufB, stage,
          tile_sdf);
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
    nb += n_per;
    for (int i = lane; i < nb; i += 32) {
      d[i] = d2[i];
      s[i] = s2[i];
    }
    __syncwarp();
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RAYS * S; idx += blockDim.x) {
    const int rr = idx / S, j = idx % S;
    if (ray0 + rr < N) d_out[(ray0 + rr) * S + j] = B.d[rr * S + j];
  }
}

}  // namespace ntt

extern "C" size_t ntt_neus_upsample_smem_bytes(int in_ch, int wmax, int S,
                                               int n_per) {
  return (ntt::mlp_smem_floats(in_ch, wmax) + ntt::TILE + ntt::RAYS * 8 +
          (size_t)ntt::RAYS * (5 * S + 2 * n_per)) * sizeof(float);
}

// rays_o, rays_d [N,3] (d unit), d_coarse [N,n_coarse] sorted, u
// [N, n_iters*n_per] sorted within each round -> d_out [N, n_coarse +
// n_iters*n_per] sorted. sphere_r < 0: no sphere_residual prior. Returns the
// cudaError_t of the launch.
extern "C" int ntt_neus_upsample(const void* rays_o, const void* rays_d,
                                 const void* d_coarse, const void* u, int N,
                                 int n_coarse, int n_iters, int n_per,
                                 const void* params, const void* meta,
                                 int n_layers, int in_ch, int multires,
                                 int wmax, float sphere_r, void* d_out,
                                 void* stream) {
  if (N <= 0) return 0;
  const int S = n_coarse + n_iters * n_per;
  const size_t smem = ntt_neus_upsample_smem_bytes(in_ch, wmax, S, n_per);
  cudaError_t err = cudaFuncSetAttribute(
      ntt::neus_upsample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt::Mlp m{static_cast<const float*>(params), static_cast<const int*>(meta),
             n_layers, in_ch, multires, wmax};
  const int blocks = (N + ntt::RAYS - 1) / ntt::RAYS;
  ntt::neus_upsample_kernel<<<blocks, ntt::THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(d_coarse), static_cast<const float*>(u), N,
      n_coarse, n_iters, n_per, sphere_r, static_cast<float*>(d_out));
  return (int)cudaGetLastError();
}
