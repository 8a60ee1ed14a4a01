// VolSDF §3.4 error-bounded fine sampler — three weight-free CUDA kernels for
// sm_90a.
//
// Replace the per-ray stages of the Pallas kernel family of
// neurecon_tpu/ops/fused_fine_sample.py (entry `fused_fine_sample`), with the
// semantics of the plain loop `fine_sample` in
// neurecon_tpu/models/frameworks/volsdf.py. The MLP queries go through the
// sdf-only kernel (sdf_forward.cu), batched over all rays in one launch per
// stage; these kernels take its raw output. The map:
//
//   _make_init_kernel           -> sdf_forward + init_kernel (a): the
//     sphere_residual prior and the sphere-background min on the coarse sdf,
//     beta+ of paper eq. 10, the convergence mask under the net's beta, the
//     checkpoint-0 opacity draw, the first bounds clipped to [0, 1e5];
//   _make_upsample_query_kernel -> draw_kernel (b) + sdf_forward: pdf
//     proportional to bounds + 1e-5, the det inverse CDF at linspace(0, 1,
//     n_up + 2) with both ends dropped, the new depths and their points;
//   _make_checkpoint_kernel     -> checkpoint_kernel (c): prior and
//     background min on the new sdf, the stable merge of the old buffer with
//     the new depths, the max error bound under the net's beta, the opacity
//     draw of newly converged rays, the beta bisection of the rest, the new
//     bounds; on the last round the fallback draw and beta_out.
//
// The merge is a rank count (old before new at equal depth). It equals the
// reference's stable sort of the concatenation because the det draw of (b)
// gives ascending depths (monotone cdf, ascending u).
//
// What bounds them: neither bytes nor FLOPs but latency. A round of (c) runs
// ~12 error-bound sweeps over the ray's buffer (up to 3,584 entries at the
// flagship), each two dependent prefix sums and four expf per interval; the
// buffers are a few tens of KB per ray.
//
// Design. One 256-thread block per ray, the ray's buffers in shared memory
// (d, sdf and two scratch rows, 4 x 3,584 floats = 57 KB at the flagship, so
// three blocks an SM); the workspace between launches is [N, S] rows in device
// memory. A sweep gives each thread a contiguous chunk of intervals, sums it
// sequentially, and a warp-shuffle scan of the chunk totals makes the block's
// prefix; the order differs from the reference's cumsum, so a bound that sits
// at eps can flip (see PERF.md for the measured agreement). Draws are one
// binary search per uniform (count of cdf < u), with the reference's
// denominator < 1e-5 -> 1. Products that feed sums are rounded apart
// (__fmul_rn) so the compiler does not fuse them; no fast math: 0 * inf in a
// bound must give NaN (then +inf) as in the reference. Rays that have
// converged skip the bisection (their beta does not change); everything else
// runs on every ray, as in the reference. None of the TPU kernels' lane
// padding, counting searches, one-hot gathers or triangular-matmul prefix
// sums is needed.
#include <cuda_runtime.h>
#include <math.h>

namespace ntt {
namespace vfs {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float2* sh;  // [WARPS] block-reduction scratch
  float* d;    // [P] sorted depths
  float* s;    // [P] sdf at those depths
  float* a;    // [P] scratch
  float* b;    // [P] scratch (per-interval errors, then the opacity cdf)
};

__device__ Smem layout(float4* smem4, int P) {
  Smem B;
  B.sh = reinterpret_cast<float2*>(smem4);
  B.d = reinterpret_cast<float*>(B.sh + WARPS);
  B.s = B.d + P;
  B.a = B.s + P;
  B.b = B.a + P;
  return B;
}

__device__ __forceinline__ void point(const float* o, const float* dir, float t, float* x) {
  for (int c = 0; c < 3; ++c) x[c] = __fadd_rn(o[c], __fmul_rn(dir[c], t));
}

// The query's sdf from the MLP's raw value at the point o + t d: plus the
// sphere_residual prior |x| - prior_r (prior_r >= 0), then min with
// bg_r - |x| (bg_r >= 0), on the fp32 point the MLP saw.
__device__ float finish_sdf(float raw, const float* o, const float* dir, float t,
                            float prior_r, float bg_r) {
  float x[3];
  point(o, dir, t, x);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                             __fmul_rn(x[2], x[2]));
  float v = raw;
  if (prior_r >= 0.f) v = __fadd_rn(v, sqrtf(sq + 1e-12f) - prior_r);
  if (bg_r >= 0.f) v = fminf(v, bg_r - sqrtf(sq));
  return v;
}

// [k0, k1): this thread's contiguous chunk of n items.
__device__ __forceinline__ void chunk(int n, int& k0, int& k1) {
  const int C = (n + THREADS - 1) / THREADS;
  k0 = min((int)threadIdx.x * C, n);
  k1 = min(k0 + C, n);
}

// Exclusive scan over the block of one float2 per thread (components summed
// apart). Every thread of the block calls it.
__device__ float2 block_exclusive_scan(float2 v, float2* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const float ax = __shfl_up_sync(FULL, inc.x, o), ay = __shfl_up_sync(FULL, inc.y, o);
    if (lane >= o) { inc.x += ax; inc.y += ay; }
  }
  float2 ex = make_float2(__shfl_up_sync(FULL, inc.x, 1), __shfl_up_sync(FULL, inc.y, 1));
  if (lane == 0) ex = make_float2(0.f, 0.f);
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float2 w = lane < WARPS ? sh[lane] : make_float2(0.f, 0.f);
    for (int o = 1; o < WARPS; o <<= 1) {
      const float ax = __shfl_up_sync(FULL, w.x, o), ay = __shfl_up_sync(FULL, w.y, o);
      if (lane >= o) { w.x += ax; w.y += ay; }
    }
    if (lane < WARPS) sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) ex = make_float2(sh[warp - 1].x + ex.x, sh[warp - 1].y + ex.y);
  __syncthreads();  // sh is reused by the next call
  return ex;
}

__device__ float block_max(float v, float2* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) sh[warp].x = v;
  __syncthreads();
  float r = sh[0].x;
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, sh[w].x);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float2* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) sh[warp].x = v;
  __syncthreads();
  float r = sh[0].x;
  for (int w = 1; w < WARPS; ++w) r += sh[w].x;
  __syncthreads();
  return r;
}

// alpha times the Laplace CDF of -sdf (volsdf.py sdf_to_sigma).
__device__ __forceinline__ float sigma_of(float sdf, float alpha, float beta) {
  const float e = 0.5f * expf(-fabsf(sdf) / beta);
  return alpha * (sdf >= 0.f ? e : 1.f - e);
}

enum { MAX_BOUND = 0, CLIP_BOUNDS = 1 };

// The error bounds of the P-entry buffer (B.d, B.s) at (alpha, beta), paper
// §3.3: bound_k = exp(-R_k) (exp(E_k) - 1), R the exclusive prefix of
// sigma * delta, E the inclusive prefix of alpha / (4 beta) delta^2
// exp(-d*_k / beta); NaN -> +inf. MAX_BOUND returns the block's max;
// CLIP_BOUNDS writes clip(bound, 0, 1e5) to out[k], k < P - 1.
template <int MODE>
__device__ float sweep(const Smem& B, int P, float alpha, float beta, float* out) {
  int k0, k1;
  chunk(P - 1, k0, k1);
  const float coef = alpha / (4.f * beta);
  float2 tot = make_float2(0.f, 0.f);
  for (int k = k0; k < k1; ++k) {
    const float delta = B.d[k + 1] - B.d[k];
    const float sd = __fmul_rn(sigma_of(B.s[k], alpha, beta), delta);
    const float dstar = fmaxf(0.5f * (fabsf(B.s[k]) + fabsf(B.s[k + 1]) - delta), 0.f);
    const float err = __fmul_rn(__fmul_rn(coef, __fmul_rn(delta, delta)), expf(-dstar / beta));
    B.a[k] = sd;
    B.b[k] = err;
    tot.x += sd;
    tot.y += err;
  }
  const float2 base = block_exclusive_scan(tot, B.sh);
  float R = base.x, E = base.y, m = -INFINITY;
  for (int k = k0; k < k1; ++k) {
    E += B.b[k];
    float bound = expf(-R) * (expf(E) - 1.f);
    if (isnan(bound)) bound = INFINITY;
    R += B.a[k];
    if (MODE == MAX_BOUND) m = fmaxf(m, bound);
    else out[k] = fminf(fmaxf(bound, 0.f), 1e5f);
  }
  if (MODE == MAX_BOUND) return block_max(m, B.sh);
  return 0.f;
}

// The opacity cdf of the final draws into B.b [P]: 0, then 1 - exp(-R_k) for
// k < P - 1 (sample_cdf's leading 0 prepended to 1 - exp(-R_t)).
__device__ void opacity_cdf(const Smem& B, int P, float alpha, float beta) {
  int k0, k1;
  chunk(P - 1, k0, k1);
  float tot = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float sd = __fmul_rn(sigma_of(B.s[k], alpha, beta), B.d[k + 1] - B.d[k]);
    B.a[k] = sd;
    tot += sd;
  }
  float R = block_exclusive_scan(make_float2(tot, 0.f), B.sh).x;
  for (int k = k0; k < k1; ++k) {
    B.b[k + 1] = 1.f - expf(-R);
    R += B.a[k];
  }
  if (threadIdx.x == 0) B.b[0] = 0.f;
  __syncthreads();
}

// Inverse CDF at u: the first index with cdf >= u (the count of cdf < u on a
// monotone cdf), the bracketing entries, and the lerp with denominators below
// 1e-5 taken as 1 (sampling.py _invert_cdf).
__device__ float invert(const float* cdf, const float* bins, int P, float u) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] < u) lo = mid + 1; else hi = mid;
  }
  const int below = max(lo - 1, 0), above = min(lo, P - 1);
  const float cb = cdf[below], ca = cdf[above];
  const float bb = bins[below], ba = bins[above];
  float den = ca - cb;
  if (den < 1e-5f) den = 1.f;
  const float t = (u - cb) / den;
  return __fadd_rn(bb, __fmul_rn(t, ba - bb));
}

// n_final opacity draws of ray r at the uniforms u[0..n_final) into fine.
__device__ void draw_final(const Smem& B, int P, float alpha, float beta, const float* u,
                           int n_final, float* fine) {
  opacity_cdf(B, P, alpha, beta);
  for (int j = threadIdx.x; j < n_final; j += blockDim.x) fine[j] = invert(B.b, B.d, P, u[j]);
  __syncthreads();  // the next sweep overwrites the cdf
}

__device__ __forceinline__ void load_ray(const float* rays_o, const float* rays_d, long r,
                                         float* o, float* dir) {
  for (int c = 0; c < 3; ++c) {
    o[c] = rays_o[r * 3 + c];
    dir[c] = rays_d[r * 3 + c];
  }
}

__global__ void __launch_bounds__(THREADS)
init_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
            const float* __restrict__ d_init, const float* __restrict__ raw,
            const float* __restrict__ far, const float* __restrict__ ab,
            const float* __restrict__ u, int n0, int S, int n_final, int u_stride,
            float eps, float beta_c, float prior_r, float bg_r, float* __restrict__ d_buf,
            float* __restrict__ s_buf, float* __restrict__ bounds, float* __restrict__ beta_arr,
            int* __restrict__ converged, int* __restrict__ iter_usage,
            float* __restrict__ fine) {
  extern __shared__ float4 smem4[];
  const Smem B = layout(smem4, n0);
  const long r = blockIdx.x;
  float o[3], dir[3];
  load_ray(rays_o, rays_d, r, o, dir);
  for (int j = threadIdx.x; j < n0; j += blockDim.x) {
    const float t = d_init[r * n0 + j];
    const float v = finish_sdf(raw[r * n0 + j], o, dir, t, prior_r, bg_r);
    B.d[j] = t;
    B.s[j] = v;
    d_buf[r * S + j] = t;
    s_buf[r * S + j] = v;
  }
  __syncthreads();
  const float alpha_net = ab[0], beta_net = ab[1];
  const float f = far[r];
  const float beta = sqrtf(__fmul_rn(f, f) / beta_c);
  const bool bad = sweep<MAX_BOUND>(B, n0, alpha_net, beta_net, nullptr) > eps;
  sweep<CLIP_BOUNDS>(B, n0, 1.f / beta, beta, bounds + r * S);
  draw_final(B, n0, alpha_net, beta_net, u + r * u_stride, n_final, fine + r * n_final);
  if (threadIdx.x == 0) {
    beta_arr[r] = beta;
    converged[r] = !bad;
    iter_usage[r] = bad ? -1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
draw_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
            const float* __restrict__ d_buf, const float* __restrict__ bounds, int s_in,
            int S, int n_up, float step, float* __restrict__ nd, float* __restrict__ pts) {
  extern __shared__ float4 smem4[];
  const Smem B = layout(smem4, s_in);  // d, and the cdf in s
  const long r = blockIdx.x;
  float* cdf = B.s;
  for (int j = threadIdx.x; j < s_in; j += blockDim.x) B.d[j] = d_buf[r * S + j];
  int k0, k1;
  chunk(s_in - 1, k0, k1);
  float tot = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float w = bounds[r * S + k] + 1e-5f;
    cdf[k + 1] = w;
    tot += w;
  }
  const float total = block_sum(tot, B.sh);
  float loc = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float p = cdf[k + 1] / total;
    cdf[k + 1] = p;
    loc += p;
  }
  float c = block_exclusive_scan(make_float2(loc, 0.f), B.sh).x;
  for (int k = k0; k < k1; ++k) {
    c += cdf[k + 1];
    cdf[k + 1] = c;
  }
  if (threadIdx.x == 0) cdf[0] = 0.f;
  __syncthreads();
  float o[3], dir[3];
  load_ray(rays_o, rays_d, r, o, dir);
  for (int j = threadIdx.x; j < n_up; j += blockDim.x) {
    const float v = invert(cdf, B.d, s_in, __fmul_rn((float)(j + 1), step));
    nd[r * n_up + j] = v;
    float x[3];
    point(o, dir, v, x);
    for (int q = 0; q < 3; ++q) pts[(r * n_up + j) * 3 + q] = x[q];
  }
}

// Count of sorted a[0..n) below v (strictly, or at most v with `le`).
__device__ __forceinline__ int rank(const float* a, int n, float v, bool le) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v || (le && a[mid] == v)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
checkpoint_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                  const float* __restrict__ d_in, const float* __restrict__ s_in_buf,
                  const float* __restrict__ nd, const float* __restrict__ raw,
                  const float* __restrict__ ab, const float* __restrict__ u_it,
                  const float* __restrict__ u_last, int s_in, int S, int n_up,
                  int n_final, int u_stride, int it, int last, int max_bisection, float eps,
                  float prior_r, float bg_r, float* __restrict__ d_out,
                  float* __restrict__ s_out, float* __restrict__ bounds,
                  float* __restrict__ beta_arr, int* __restrict__ converged,
                  int* __restrict__ iter_usage, float* __restrict__ fine,
                  float* __restrict__ beta_out) {
  extern __shared__ float4 smem4[];
  const int P = s_in + n_up;
  const Smem B = layout(smem4, P);
  const long r = blockIdx.x;
  float o[3], dir[3];
  load_ray(rays_o, rays_d, r, o, dir);
  // stable merge: old sorted in a, new sorted in b
  for (int i = threadIdx.x; i < s_in; i += blockDim.x) B.a[i] = d_in[r * S + i];
  for (int j = threadIdx.x; j < n_up; j += blockDim.x) B.b[j] = nd[r * n_up + j];
  __syncthreads();
  for (int i = threadIdx.x; i < s_in; i += blockDim.x) {
    const float v = B.a[i];
    const int pos = i + rank(B.b, n_up, v, false);
    B.d[pos] = v;
    B.s[pos] = s_in_buf[r * S + i];
  }
  for (int j = threadIdx.x; j < n_up; j += blockDim.x) {
    const float v = B.b[j];
    const int pos = j + rank(B.a, s_in, v, true);
    B.d[pos] = v;
    B.s[pos] = finish_sdf(raw[r * n_up + j], o, dir, v, prior_r, bg_r);
  }
  __syncthreads();
  if (!last) {
    for (int k = threadIdx.x; k < P; k += blockDim.x) {
      d_out[r * S + k] = B.d[k];
      s_out[r * S + k] = B.s[k];
    }
  }

  const float alpha_net = ab[0], beta_net = ab[1];
  bool conv = converged[r] != 0;
  int iu = iter_usage[r];
  float beta = beta_arr[r];
  // still above eps under the net's beta (only rays not yet converged matter)
  const bool still_bad = sweep<MAX_BOUND>(B, P, alpha_net, beta_net, nullptr) > eps;
  if (!conv && !still_bad) {
    draw_final(B, P, alpha_net, beta_net, u_it + r * u_stride, n_final, fine + r * n_final);
    iu = it;
    conv = true;
  }
  if (!conv) {  // bisect beta+ in [beta_net, beta] so that the max bound meets eps
    float left = beta_net, right = beta;
    for (int i = 0; i < max_bisection; ++i) {
      const float tmp = 0.5f * (left + right);
      if (sweep<MAX_BOUND>(B, P, 1.f / tmp, tmp, nullptr) <= eps) right = tmp;
      else left = tmp;
    }
    beta = right;
  }
  if (!last) {
    sweep<CLIP_BOUNDS>(B, P, 1.f / beta, beta, bounds + r * S);
  } else if (!conv) {
    draw_final(B, P, 1.f / beta, beta, u_last + r * u_stride, n_final, fine + r * n_final);
  }
  if (threadIdx.x == 0) {
    beta_arr[r] = beta;
    converged[r] = conv;
    iter_usage[r] = iu;
    if (last) beta_out[r] = conv ? beta_net : beta;
  }
}

inline size_t smem_bytes(int P) { return WARPS * sizeof(float2) + 4 * (size_t)P * sizeof(float); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace vfs
}  // namespace ntt

using namespace ntt::vfs;

// Kernel (a). rays [N,3] (d unit), d_init [N,n0] sorted, raw [N*n0] the MLP's
// sdf at o + d_init d, far [N], ab = (alpha_net, beta_net) on the device, u
// [N, u_stride] (the first n_final entries used). Writes the first n0 entries
// of the rows (stride S) of d_buf, s_buf and bounds, and beta, converged,
// iter_usage [N], fine [N,n_final]. prior_r / bg_r < 0: no prior / no
// background. Returns the cudaError_t of the launch.
extern "C" int ntt_volsdf_init(const void* rays_o, const void* rays_d, const void* d_init,
                               const void* raw, const void* far, const void* ab,
                               const void* u, int N, int n0, int S, int n_final,
                               int u_stride, float eps, float beta_c, float prior_r,
                               float bg_r, void* d_buf, void* s_buf, void* bounds,
                               void* beta, void* converged, void* iter_usage, void* fine,
                               void* stream) {
  if (N <= 0) return 0;
  const size_t smem = smem_bytes(n0);
  cudaError_t err = allow_smem(init_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  init_kernel<<<N, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(d_init), static_cast<const float*>(raw),
      static_cast<const float*>(far), static_cast<const float*>(ab),
      static_cast<const float*>(u), n0, S, n_final, u_stride, eps, beta_c, prior_r, bg_r,
      static_cast<float*>(d_buf), static_cast<float*>(s_buf), static_cast<float*>(bounds),
      static_cast<float*>(beta), static_cast<int*>(converged),
      static_cast<int*>(iter_usage), static_cast<float*>(fine));
  return (int)cudaGetLastError();
}

// Kernel (b). d_buf rows (stride S) hold s_in sorted depths, bounds rows
// their s_in - 1 bounds; step = float32(1 / (n_up + 1)). Writes nd [N,n_up]
// (ascending) and pts [N*n_up,3].
extern "C" int ntt_volsdf_draw(const void* rays_o, const void* rays_d, const void* d_buf,
                               const void* bounds, int N, int s_in, int S, int n_up,
                               float step, void* nd, void* pts, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = smem_bytes(s_in);
  cudaError_t err = allow_smem(draw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  draw_kernel<<<N, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(d_buf), static_cast<const float*>(bounds), s_in, S, n_up,
      step, static_cast<float*>(nd), static_cast<float*>(pts));
  return (int)cudaGetLastError();
}

// Kernel (c) of round `it` (1-based; `last` on round max_iter). d_in / s_in_buf
// rows hold s_in entries, nd [N,n_up] the new depths (ascending), raw
// [N*n_up] the MLP's sdf there; u_it / u_last point at round it's and the
// fallback's uniforms (row stride u_stride). Writes the merged rows into d_out
// / s_out (not on the last round), the new bounds (not on the last round),
// the state, the draws, and beta_out on the last round.
extern "C" int ntt_volsdf_checkpoint(
    const void* rays_o, const void* rays_d, const void* d_in, const void* s_in_buf,
    const void* nd, const void* raw, const void* ab, const void* u_it, const void* u_last,
    int N, int s_in, int S, int n_up, int n_final, int u_stride, int it, int last,
    int max_bisection, float eps, float prior_r, float bg_r, void* d_out, void* s_out,
    void* bounds, void* beta, void* converged, void* iter_usage, void* fine, void* beta_out,
    void* stream) {
  if (N <= 0) return 0;
  const size_t smem = smem_bytes(s_in + n_up);
  cudaError_t err = allow_smem(checkpoint_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  checkpoint_kernel<<<N, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(d_in), static_cast<const float*>(s_in_buf),
      static_cast<const float*>(nd), static_cast<const float*>(raw),
      static_cast<const float*>(ab), static_cast<const float*>(u_it),
      static_cast<const float*>(u_last), s_in, S, n_up, n_final, u_stride, it, last,
      max_bisection, eps, prior_r, bg_r, static_cast<float*>(d_out),
      static_cast<float*>(s_out), static_cast<float*>(bounds), static_cast<float*>(beta),
      static_cast<int*>(converged), static_cast<int*>(iter_usage), static_cast<float*>(fine),
      static_cast<float*>(beta_out));
  return (int)cudaGetLastError();
}
