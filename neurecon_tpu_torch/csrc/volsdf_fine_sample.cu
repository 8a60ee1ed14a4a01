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
//   _make_upsample_query_kernel -> draw_kernel (b) (round 1) or the tail of
//     checkpoint_kernel (c) (rounds 2..max_iter), then sdf_forward: pdf
//     proportional to bounds + 1e-5, the det inverse CDF at linspace(0, 1,
//     n_up + 2) with both ends dropped, the new depths and their points;
//   _make_checkpoint_kernel     -> checkpoint_kernel (c): prior and
//     background min on the new sdf, the stable merge of the old buffer with
//     the new depths, the max error bound under the net's beta, the opacity
//     draw of newly converged rays, the beta bisection of the rest, the new
//     bounds and from them the next round's det draw; on the last round the
//     fallback draw and beta_out.
//
// A call makes 1 (a) + 1 (b) + max_iter (c) launches: the bounds of rounds
// 1..max_iter-1 never leave the block that computed them.
//
// The merge equals the reference's stable sort of the concatenation (old
// before new at equal depth) because the det draw gives ascending depths
// (monotone cdf, ascending u).
//
// What bounds (c): arithmetic. A round runs up to 12 error-bound sweeps over
// the ray's buffer (up to 3,584 entries at the flagship), each four expf and
// two IEEE divisions per interval: about six special-function operations (ex2,
// rcp; 16 a clock per SM on Hopper) among the instructions of those IEEE
// sequences. Bytes are a few tens of KB per ray and round.
//
// One design for (a), (b) and (c). One block per ray: 256 threads (512 or
// 1,024 for buffers above 4,097 entries; `by_shape`). Each thread holds a
// contiguous chunk of C intervals (`chunk_of`; C a template parameter, the
// smallest even one that holds the buffer, so that no chunk is padded much)
// with their depths and sdf in registers (`Chunk<C>`), and a sweep's
// per-interval sigma * delta and error terms (`terms`) beside them. A sweep
// runs all C intervals without a branch (zero-width intervals past a short
// chunk add nothing), then one barrier for the block scan (`scan_block`: warp
// shuffles; every warp scans the warp totals itself, so every kernel sums in
// one order), then the bounds, and one __syncthreads_or of "above eps" for the
// block's max.
//
// Kernel (a) runs its two sweeps, at the net's (alpha, beta) and at (1 / beta+,
// beta+), in one pass over the chunk with one scan of the four sums, and
// takes the opacity cdf 1 - exp(-R) from the net sweep's own exp(-R): the
// same terms, partition and scan that a separate opacity sweep would run
// (`draw_opacity`), so the same bits. Three barriers a block: after the
// loads, in the scan, and the decision's __syncthreads_or, which also
// completes the cdf row for the draws' searches. Kernel (c) runs every sweep
// of a round (the net's beta, the bisection, the new bounds) through one loop
// (`sweep_chunk`), so that its code is inlined once and stays in the
// instruction cache.
//
// Shared memory holds what random access needs: for (a) the depths and a row
// that holds the finished sdf, then the cdf (2 x n0 words); for (b) and (c)
// the merge's inputs (depths and sdf, old then new, loaded coalesced, the new
// sdf finished there), the merged rows (written out to the next round's
// buffers coalesced), a cdf and the det draw's index map (3 x 3,584 + 512
// words at the flagship). The merge takes each thread's entries by a co-rank
// search on the merge path. The det draw is a merge too: its uniforms ascend,
// so each thread counts, for each cdf entry of its chunk, the uniforms at or
// below it and writes the index of every draw that falls in its chunk (the
// count of cdf entries below u, which is the binary search's index on a
// monotone cdf); if the chunks' sums left the cdf falling at a chunk boundary
// (they round apart from the scan), the ray's draws are binary searches. So
// are the opacity draws, whose uniforms come unsorted. Products that feed sums
// are rounded apart (__fmul_rn) so the compiler does not fuse them; no fast
// math: 0 * inf in a bound must give NaN (then +inf) as in the reference. Rays
// that have converged skip the bisection (their beta does not change);
// everything else runs on every ray, as in the reference. The prefix sums run
// in another order than the reference's cumsum, so a bound that sits at eps
// can flip (PERF.md). None of the TPU kernels' lane padding, counting
// searches, one-hot gathers or triangular-matmul prefix sums is needed.
#include <cuda_runtime.h>
#include <math.h>

namespace ntt {
namespace vfs {

constexpr unsigned FULL = 0xffffffffu;

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

// alpha times the Laplace CDF of -sdf (volsdf.py sdf_to_sigma).
__device__ __forceinline__ float sigma_of(float sdf, float alpha, float beta) {
  const float e = 0.5f * expf(-fabsf(sdf) / beta);
  return alpha * (sdf >= 0.f ? e : 1.f - e);
}

// The inverse-CDF lerp at u for the count lo of cdf entries below u: the
// bracketing entries, with denominators below 1e-5 taken as 1
// (sampling.py _invert_cdf).
__device__ __forceinline__ float lerp_at(const float* cdf, const float* bins, int P, int lo,
                                         float u) {
  const int below = max(lo - 1, 0), above = min(lo, P - 1);
  const float cb = cdf[below], ca = cdf[above];
  const float bb = bins[below], ba = bins[above];
  float den = ca - cb;
  if (den < 1e-5f) den = 1.f;
  const float t = (u - cb) / den;
  return __fadd_rn(bb, __fmul_rn(t, ba - bb));
}

// Inverse CDF at u: the first index with cdf >= u (the count of cdf < u on a
// monotone cdf) by binary search, then the lerp.
__device__ float invert(const float* cdf, const float* bins, int P, float u) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] < u) lo = mid + 1; else hi = mid;
  }
  return lerp_at(cdf, bins, P, lo, u);
}

__device__ __forceinline__ void load_ray(const float* rays_o, const float* rays_d, long r,
                                         float* o, float* dir) {
  for (int c = 0; c < 3; ++c) {
    o[c] = rays_o[r * 3 + c];
    dir[c] = rays_d[r * 3 + c];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// The kernels' routines: T threads a ray, each with a chunk of at most C
// intervals in registers.

// Two sets of K x T/32 float2 slots (K the widest exchange of the kernel),
// taken in turn by the block's exchanges, so that an exchange needs one
// barrier: a warp that writes a set again has passed the barrier of the
// exchange in between, which every warp reaches only after reading the set.
struct Xchg {
  float2* sh;
  int turn;
};

template <int T, int K = 1>
__device__ __forceinline__ float2* take_slots(Xchg& x) {
  x.turn ^= 1;
  return x.sh + x.turn * K * (T / 32);
}

// Exclusive block scan of K float2 a thread (each component summed apart) in
// one exchange: the warps' Hillis-Steele scans, then the same scan of the warp
// totals, which every warp finishes itself after one barrier.
template <int T, int K>
__device__ __forceinline__ void scan_block(float2 (&v)[K], Xchg& x) {
  constexpr int W = T / 32;
  float2* sh = take_slots<T, K>(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float2 inc = v[j];
    for (int o = 1; o < 32; o <<= 1) {
      const float ax = __shfl_up_sync(FULL, inc.x, o), ay = __shfl_up_sync(FULL, inc.y, o);
      if (lane >= o) { inc.x += ax; inc.y += ay; }
    }
    v[j] = make_float2(__shfl_up_sync(FULL, inc.x, 1), __shfl_up_sync(FULL, inc.y, 1));
    if (lane == 0) v[j] = make_float2(0.f, 0.f);
    if (lane == 31) sh[j * W + warp] = inc;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float2 w = lane < W ? sh[j * W + lane] : make_float2(0.f, 0.f);
    for (int o = 1; o < W; o <<= 1) {
      const float ax = __shfl_up_sync(FULL, w.x, o), ay = __shfl_up_sync(FULL, w.y, o);
      if (lane >= o) { w.x += ax; w.y += ay; }
    }
    const float px = __shfl_sync(FULL, w.x, max(warp - 1, 0));
    const float py = __shfl_sync(FULL, w.y, max(warp - 1, 0));
    if (warp > 0) v[j] = make_float2(px + v[j].x, py + v[j].y);
  }
}

template <int T>
__device__ __forceinline__ float2 scan_block(float2 v, Xchg& x) {
  float2 a[1] = {v};
  scan_block<T, 1>(a, x);
  return a[0];
}

// The block's sum in the first draw kernel's order (warp butterflies, then
// the warp sums in warp order). One barrier.
template <int T>
__device__ __forceinline__ float sum_block(float v, Xchg& x) {
  float2* sh = take_slots<T>(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) sh[warp].x = v;
  __syncthreads();
  float r = sh[0].x;
  for (int w = 1; w < T / 32; ++w) r += sh[w].x;
  return r;
}

// This thread's chunk of a ray's buffer: entries k0 .. k0 + cnt (the cnt
// intervals it owns and the next thread's first entry) in registers, in
// chunk_of's partition of the intervals.
template <int C>
struct Chunk {
  float d[C + 1], s[C + 1];
  int k0, cnt;
};

// [k0, k0 + cnt): this thread's contiguous share of n intervals, ceil(n / T)
// each (the last threads' shares are shorter or empty).
template <int T>
__device__ __forceinline__ void chunk_of(int n, int& k0, int& cnt) {
  const int c = (n + T - 1) / T;
  k0 = min((int)threadIdx.x * c, n);
  cnt = min(k0 + c, n) - k0;
}

// The merge's order: an old depth goes before a new one it equals.
__device__ __forceinline__ bool old_first(float old_d, float new_d) { return old_d <= new_d; }

// Entries k0 .. k0 + cnt of the stable merge of the old row a [s_in] with the
// new row b [n_up] (both sorted, their sdf in sa and sb): the co-rank of k0
// on the merge path by binary search, then a sequential merge. Entries past
// k0 + cnt repeat the last one (zero-width intervals, see sweep_chunk).
template <int C>
__device__ __forceinline__ void merge_chunk(Chunk<C>& ch, const float* a, const float* sa,
                                            int s_in, const float* b, const float* sb,
                                            int n_up) {
  const int k = ch.k0;
  int lo = max(0, k - n_up), hi = min(k, s_in);
  while (lo < hi) {  // the number of old entries among the first k
    const int mid = (lo + hi) >> 1;
    if (old_first(a[mid], b[k - mid - 1])) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = k - lo;
#pragma unroll
  for (int e = 0; e <= C; ++e) {
    if (e <= ch.cnt) {
      if (j >= n_up || (i < s_in && old_first(a[i], b[j]))) {
        ch.d[e] = a[i];
        ch.s[e] = sa[i];
        ++i;
      } else {
        ch.d[e] = b[j];
        ch.s[e] = sb[j];
        ++j;
      }
    } else if (e > 0) {
      ch.d[e] = ch.d[e - 1];
      ch.s[e] = ch.s[e - 1];
    }
  }
}

// Interval i of the chunk at (alpha, beta), coef = alpha / (4 beta), paper
// §3.3: (sigma * delta, the error term alpha / (4 beta) delta^2
// exp(-d*_i / beta)); the sums of each over the buffer are R and E.
template <int C>
__device__ __forceinline__ float2 terms(const Chunk<C>& ch, int i, float alpha, float beta,
                                        float coef) {
  const float delta = ch.d[i + 1] - ch.d[i];
  const float dstar = fmaxf(0.5f * (fabsf(ch.s[i]) + fabsf(ch.s[i + 1]) - delta), 0.f);
  return make_float2(__fmul_rn(sigma_of(ch.s[i], alpha, beta), delta),
                     __fmul_rn(__fmul_rn(coef, __fmul_rn(delta, delta)), expf(-dstar / beta)));
}

// An interval's error bound exp(-R) (exp(E) - 1) from decay = exp(-R) (R
// exclusive, E inclusive of the interval); NaN (0 * inf) -> +inf.
__device__ __forceinline__ float bound_at(float decay, float E) {
  const float b = decay * (expf(E) - 1.f);
  return isnan(b) ? INFINITY : b;
}

// The bound clipped to [0, 1e5], as the det draw takes it.
__device__ __forceinline__ float clip_bound(float b) { return fminf(fmaxf(b, 0.f), 1e5f); }

// A sweep of the error bounds over the chunk: the thread's bounds clipped
// into out (the first cnt are the chunk's), and whether the block's largest
// bound is above eps (one __syncthreads_or). It runs all C intervals without
// a branch, so that their chains interleave: past cnt they have zero width,
// add exactly 0 to both sums, and their bounds, with the same E and an R no
// smaller, are no larger than the chunk's last.
template <int T, int C>
__device__ __forceinline__ bool sweep_chunk(const Chunk<C>& ch, float alpha, float beta,
                                            float eps, float (&out)[C], Xchg& x) {
  const float coef = alpha / (4.f * beta);
  float2 t[C];
  float2 tot = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    t[i] = terms(ch, i, alpha, beta, coef);
    tot.x += t[i].x;
    tot.y += t[i].y;
  }
  const float2 base = scan_block<T>(tot, x);
  float R = base.x, E = base.y, m = -INFINITY;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    E += t[i].y;
    const float bound = bound_at(expf(-R), E);
    R += t[i].x;
    m = fmaxf(m, bound);
    out[i] = clip_bound(bound);
  }
  return __syncthreads_or(m > eps) != 0;
}

// n_final opacity draws at the uniforms u (unsorted) into fine: the cdf
// 0, 1 - exp(-R_k) (the sum of the sweeps' sigma * delta) into crow, then a
// search each.
template <int T, int C>
__device__ __forceinline__ void draw_opacity(const Chunk<C>& ch, int P, const float* drow,
                                             float* crow,
                             float alpha, float beta, const float* u, int n_final, float* fine,
                             Xchg& x) {
  float sd[C];
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < ch.cnt) {
      sd[i] = __fmul_rn(sigma_of(ch.s[i], alpha, beta), ch.d[i + 1] - ch.d[i]);
      tot += sd[i];
    }
  }
  float R = scan_block<T>(make_float2(tot, 0.f), x).x;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < ch.cnt) {
      crow[ch.k0 + i + 1] = 1.f - expf(-R);
      R += sd[i];
    }
  }
  if (threadIdx.x == 0) crow[0] = 0.f;
  __syncthreads();
  for (int j = threadIdx.x; j < n_final; j += T) fine[j] = invert(crow, drow, P, u[j]);
  __syncthreads();  // the cdf row is written again next
}

// The det uniform u_j = (j + 1) step, and the number of them at most c.
__device__ __forceinline__ float det_u(int j, float step) {
  return __fmul_rn((float)(j + 1), step);
}

__device__ int det_count(float c, int n_up, float step) {
  int g = (int)fminf(fmaxf(c * (float)(n_up + 1), 0.f), (float)n_up);
  while (g > 0 && det_u(g - 1, step) > c) --g;
  while (g < n_up && det_u(g, step) <= c) ++g;
  return g;
}

// The det draw: from the clipped bounds w of the thread's cnt intervals
// (from k0) of the P-entry buffer drow, pdf = (w + 1e-5) / sum, its cdf (the
// first draw kernel's sum and scan order) into crow, and the n_up depths at
// u_j into nd with their points into pts. idx [n_up] is the index map.
template <int T, int C>
__device__ __forceinline__ void det_draw(float (&w)[C], int k0, int cnt, int P, const float* drow,
                                         float* crow,
                         int* idx, int n_up, float step, const float* o, const float* dir,
                         float* nd, float* pts, Xchg& x) {
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < cnt) {
      w[i] = w[i] + 1e-5f;
      tot += w[i];
    }
  }
  const float total = sum_block<T>(tot, x);
  float loc = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < cnt) {
      w[i] = w[i] / total;
      loc += w[i];
    }
  }
  float c = scan_block<T>(make_float2(loc, 0.f), x).x;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < cnt) {
      c += w[i];
      w[i] = c;
      crow[k0 + i + 1] = c;
    }
  }
  if (threadIdx.x == 0) crow[0] = 0.f;
  __syncthreads();
  // within a chunk the cdf cannot fall (sums of pdf >= 0); across a chunk
  // boundary it can by an ulp, and then the count is not the search's index
  const bool falls = cnt > 0 && crow[k0] > w[0];
  if (__syncthreads_or(falls)) {
    for (int j = threadIdx.x; j < n_up; j += T) {
      const float u = det_u(j, step);
      const float v = invert(crow, drow, P, u);
      nd[j] = v;
      point(o, dir, v, pts + 3 * j);
    }
    return;
  }
  // draws j with cdf[i-1] < u_j <= cdf[i] take index i: this thread writes
  // those of its entries i = k0+1 .. k0+cnt, the last one also those above
  // every entry (index P)
  if (cnt > 0) {
    int m = det_count(crow[k0], n_up, step);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i < cnt) {
        const int m1 = det_count(w[i], n_up, step);
        for (int j = m; j < m1; ++j) idx[j] = k0 + i + 1;
        m = m1;
      }
    }
    if (k0 + cnt == P - 1)
      for (int j = m; j < n_up; ++j) idx[j] = P;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_up; j += T) {
    const float v = lerp_at(crow, drow, P, idx[j], det_u(j, step));
    nd[j] = v;
    point(o, dir, v, pts + 3 * j);
  }
}

// Shared memory of (b) and (c): the exchange slots, the depth row [P], the
// merge / cdf row [P], the det draw's index map [n_up], and for (c) the
// merge's sdf row [P].
template <int T>
inline size_t smem_bytes_bc(int P, int n_up, int rows) {
  return 2 * (T / 32) * sizeof(float2) + (rows * (size_t)P + n_up) * sizeof(float);
}

template <int T>
struct Rows {
  Xchg x;
  float* drow;
  float* crow;
  int* idx;
  float* srow;
  __device__ Rows(float4* smem4, int P, int n_up) {
    x.sh = reinterpret_cast<float2*>(smem4);
    x.turn = 0;
    drow = reinterpret_cast<float*>(x.sh + 2 * (T / 32));
    crow = drow + P;
    idx = reinterpret_cast<int*>(crow + P);
    srow = reinterpret_cast<float*>(idx + n_up);
  }
};

template <int T, int C>
__global__ void __launch_bounds__(T)
draw_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
            const float* __restrict__ d_buf, const float* __restrict__ bounds, int s_in,
            int S, int n_up, float step, float* __restrict__ nd, float* __restrict__ pts) {
  extern __shared__ float4 smem4[];
  Rows<T> L(smem4, s_in, n_up);
  const long r = blockIdx.x;
  for (int k = threadIdx.x; k < s_in; k += T) L.drow[k] = d_buf[r * S + k];
  for (int k = threadIdx.x; k < s_in - 1; k += T) L.crow[k] = bounds[r * S + k];
  __syncthreads();
  int k0, cnt;
  chunk_of<T>(s_in - 1, k0, cnt);
  float w[C];
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (i < cnt) w[i] = L.crow[k0 + i];
  __syncthreads();  // the row becomes the cdf
  float o[3], dir[3];
  load_ray(rays_o, rays_d, r, o, dir);
  det_draw<T, C>(w, k0, cnt, s_in, L.drow, L.crow, L.idx, n_up, step, o, dir, nd + r * n_up,
                 pts + r * n_up * 3, L.x);
}

template <int T, int C>
__global__ void __launch_bounds__(T, T == 256 ? 3 : 1)
checkpoint_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                  const float* __restrict__ d_in, const float* __restrict__ s_in_buf,
                  const float* __restrict__ nd, const float* __restrict__ raw,
                  const float* __restrict__ ab, const float* __restrict__ u_it,
                  const float* __restrict__ u_last, int s_in, int S, int n_up,
                  int n_final, int u_stride, int it, int last, int max_bisection, float eps,
                  float prior_r, float bg_r, float step, float* __restrict__ d_out,
                  float* __restrict__ s_out, float* __restrict__ beta_arr,
                  int* __restrict__ converged, int* __restrict__ iter_usage,
                  float* __restrict__ fine, float* __restrict__ beta_out,
                  float* __restrict__ nd_next, float* __restrict__ pts_next) {
  extern __shared__ float4 smem4[];
  const int P = s_in + n_up, n = P - 1;
  Rows<T> L(smem4, P, n_up);
  const long r = blockIdx.x;
  float o[3], dir[3];
  load_ray(rays_o, rays_d, r, o, dir);  // again for the det draw: not held across the sweeps
  // the stable merge: old depths and sdf in crow / srow [0, s_in), new ones
  // in [s_in, P)
  for (int i = threadIdx.x; i < s_in; i += T) {
    L.crow[i] = d_in[r * S + i];
    L.srow[i] = s_in_buf[r * S + i];
  }
  for (int j = threadIdx.x; j < n_up; j += T) {
    const float v = nd[r * n_up + j];
    L.crow[s_in + j] = v;
    L.srow[s_in + j] = finish_sdf(raw[r * n_up + j], o, dir, v, prior_r, bg_r);
  }
  __syncthreads();
  Chunk<C> ch;
  chunk_of<T>(n, ch.k0, ch.cnt);
  if (ch.cnt > 0) {
    merge_chunk<C>(ch, L.crow, L.srow, s_in, L.crow + s_in, L.srow + s_in, n_up);
  } else {  // no intervals: zero-width ones that add nothing
#pragma unroll
    for (int e = 0; e <= C; ++e) ch.d[e] = ch.s[e] = 0.f;
  }
  // the merged rows: each thread's entries (the last one's entry n too) into
  // drow and crow, then out to the next round's buffers, coalesced
  const int own = ch.cnt + (ch.cnt > 0 && ch.k0 + ch.cnt == n ? 1 : 0);
  __syncthreads();  // the merge's inputs are read
#pragma unroll
  for (int e = 0; e <= C; ++e) {
    if (e < own) {
      L.drow[ch.k0 + e] = ch.d[e];
      L.crow[ch.k0 + e] = ch.s[e];
    }
  }
  __syncthreads();
  if (!last) {
    for (int k = threadIdx.x; k < P; k += T) {
      d_out[r * S + k] = L.drow[k];
      s_out[r * S + k] = L.crow[k];
    }
  }

  // The round's sweeps, through one copy of the sweep's code: i = -1 under
  // the net's beta (still above eps?), then the bisection of beta+ in
  // [beta_net, beta] for a ray not yet converged, then the new bounds (not
  // on the last round).
  const float alpha_net = ab[0], beta_net = ab[1];
  bool conv = converged[r] != 0, newly = false;
  float beta = beta_arr[r], left = beta_net, right = beta;
  int steps = 0;
  float w[C];
  for (int i = -1;; ++i) {
    float sb;
    if (i < 0) sb = beta_net;
    else if (i < steps) sb = 0.5f * (left + right);
    else if (last) break;
    else sb = beta;
    const bool bad = sweep_chunk<T, C>(ch, i < 0 ? alpha_net : 1.f / sb, sb, eps, w, L.x);
    if (i < 0) {
      newly = !conv && !bad;
      conv = conv || newly;
      steps = conv ? 0 : max_bisection;
    } else if (i < steps) {
      if (!bad) right = sb; else left = sb;
      beta = right;
    } else {
      break;
    }
  }
  // the opacity draw: of a ray converged this round at the net's beta, or
  // on the last round the fallback at beta+
  if (newly || (last && !conv)) {
    draw_opacity<T, C>(ch, P, L.drow, L.crow, newly ? alpha_net : 1.f / beta,
                       newly ? beta_net : beta, (newly ? u_it : u_last) + r * u_stride,
                       n_final, fine + r * n_final, L.x);
  }
  if (!last) {  // the next round's det draw from the new bounds
    load_ray(rays_o, rays_d, r, o, dir);
    det_draw<T, C>(w, ch.k0, ch.cnt, P, L.drow, L.crow, L.idx, n_up, step, o, dir,
                   nd_next + r * n_up, pts_next + r * n_up * 3, L.x);
  }
  if (threadIdx.x == 0) {
    beta_arr[r] = beta;
    converged[r] = conv;
    if (newly) iter_usage[r] = it;
    if (last) beta_out[r] = conv ? beta_net : beta;
  }
}

// Kernel (a) on n0 depths a ray: the coarse sdf finished (loaded coalesced
// into the rows, both round-0 buffers written out), then one pass over the
// chunk for the sweeps at the net's (alpha, beta) and at (1 / beta+, beta+),
// one scan of their four sums, and per interval the net's bound (the max
// decision), the clipped beta+ bound (into bounds, for kernel (b)) and the
// opacity cdf 1 - exp(-R) of the net's R (into the sdf's row, whose chunks
// are in registers by then); then the checkpoint-0 draws.
template <int T, int C>
__global__ void __launch_bounds__(T, T == 256 && C <= 8 ? 4 : 1)
init_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
            const float* __restrict__ d_init, const float* __restrict__ raw,
            const float* __restrict__ far, const float* __restrict__ ab,
            const float* __restrict__ u, int n0, int S, int n_final, int u_stride,
            float eps, float beta_c, float prior_r, float bg_r, float* __restrict__ d_buf,
            float* __restrict__ s_buf, float* __restrict__ bounds, float* __restrict__ beta_arr,
            int* __restrict__ converged, int* __restrict__ iter_usage,
            float* __restrict__ fine) {
  // beyond 8 intervals a thread the beta+ terms are computed again in the
  // bound pass, not held: four terms an interval would spill (up to 8, at
  // most 64 registers, four blocks an SM, no spills)
  constexpr bool keep = C <= 8;
  extern __shared__ float4 smem4[];
  Xchg x{reinterpret_cast<float2*>(smem4), 0};
  float* drow = reinterpret_cast<float*>(x.sh + 2 * 2 * (T / 32));
  float* crow = drow + n0;  // the finished sdf, then the opacity cdf
  const long r = blockIdx.x;
  float o[3], dir[3];
  load_ray(rays_o, rays_d, r, o, dir);
  for (int j = threadIdx.x; j < n0; j += T) {
    const float t = d_init[r * n0 + j];
    const float v = finish_sdf(raw[r * n0 + j], o, dir, t, prior_r, bg_r);
    drow[j] = t;
    crow[j] = v;
    d_buf[r * S + j] = t;
    s_buf[r * S + j] = v;
  }
  __syncthreads();
  Chunk<C> ch;
  chunk_of<T>(n0 - 1, ch.k0, ch.cnt);
#pragma unroll
  for (int e = 0; e <= C; ++e) {  // past cnt: zero-width intervals
    const int k = ch.k0 + min(e, ch.cnt);
    ch.d[e] = drow[k];
    ch.s[e] = crow[k];
  }
  const float alpha_net = ab[0], beta_net = ab[1];
  const float f = far[r];
  const float beta = sqrtf(__fmul_rn(f, f) / beta_c);
  const float alpha = 1.f / beta;
  const float coef_net = alpha_net / (4.f * beta_net), coef = alpha / (4.f * beta);
  float2 tn[C], tp[keep ? C : 1];
  float2 tot[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};  // net, beta+
#pragma unroll
  for (int i = 0; i < C; ++i) {
    tn[i] = terms(ch, i, alpha_net, beta_net, coef_net);
    const float2 p = terms(ch, i, alpha, beta, coef);
    if constexpr (keep) tp[i] = p;
    tot[0].x += tn[i].x;
    tot[0].y += tn[i].y;
    tot[1].x += p.x;
    tot[1].y += p.y;
  }
  scan_block<T, 2>(tot, x);
  float Rn = tot[0].x, En = tot[0].y, Rp = tot[1].x, Ep = tot[1].y, m = -INFINITY;
  float* bout = bounds + r * S + ch.k0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float2 p;
    if constexpr (keep) p = tp[i]; else p = terms(ch, i, alpha, beta, coef);
    En += tn[i].y;
    Ep += p.y;
    const float decay = expf(-Rn);
    const float bn = bound_at(decay, En), bp = bound_at(expf(-Rp), Ep);
    m = fmaxf(m, bn);
    if (i < ch.cnt) {
      crow[ch.k0 + i + 1] = 1.f - decay;
      bout[i] = clip_bound(bp);
    }
    Rn += tn[i].x;
    Rp += p.x;
  }
  if (threadIdx.x == 0) crow[0] = 0.f;
  const bool bad = __syncthreads_or(m > eps) != 0;  // and the cdf row is whole
  for (int j = threadIdx.x; j < n_final; j += T)
    fine[r * n_final + j] = invert(crow, drow, n0, u[r * u_stride + j]);
  if (threadIdx.x == 0) {
    beta_arr[r] = beta;
    converged[r] = !bad;
    iter_usage[r] = bad ? -1 : 0;
  }
}

// Kernel (a)'s shared memory: two sets of 2 x T/32 exchange slots, the depth
// row and the sdf / cdf row.
template <int T>
inline size_t smem_bytes_a(int n0) {
  return 2 * 2 * (T / 32) * sizeof(float2) + 2 * (size_t)n0 * sizeof(float);
}

// The block shape for n intervals: 256 threads with the smallest even chunk
// that holds them (chunk_of's share at 256 threads, up to 4,096 intervals),
// then 512 and 1,024 threads; f.run<T, C>() launches.
template <typename F>
cudaError_t by_shape(int n, const F& f) {
  if (n <= 256 * 2) return f.template run<256, 2>();
  if (n <= 256 * 4) return f.template run<256, 4>();
  if (n <= 256 * 6) return f.template run<256, 6>();
  if (n <= 256 * 8) return f.template run<256, 8>();
  if (n <= 256 * 10) return f.template run<256, 10>();
  if (n <= 256 * 12) return f.template run<256, 12>();
  if (n <= 256 * 14) return f.template run<256, 14>();
  if (n <= 256 * 16) return f.template run<256, 16>();
  if (n <= 512 * 16) return f.template run<512, 16>();
  if (n <= 1024 * 14) return f.template run<1024, 14>();
  return cudaErrorInvalidValue;
}

struct InitLaunch {
  const float *rays_o, *rays_d, *d_init, *raw, *far, *ab, *u;
  int N, n0, S, n_final, u_stride;
  float eps, beta_c, prior_r, bg_r;
  float *d_buf, *s_buf, *bounds, *beta;
  int *converged, *iter_usage;
  float* fine;
  cudaStream_t stream;

  template <int T, int C>
  cudaError_t run() const {
    const size_t smem = smem_bytes_a<T>(n0);
    cudaError_t err = allow_smem(init_kernel<T, C>, smem);
    if (err != cudaSuccess) return err;
    init_kernel<T, C><<<N, T, smem, stream>>>(rays_o, rays_d, d_init, raw, far, ab, u, n0, S,
                                              n_final, u_stride, eps, beta_c, prior_r, bg_r,
                                              d_buf, s_buf, bounds, beta, converged,
                                              iter_usage, fine);
    return cudaGetLastError();
  }
};

struct DrawLaunch {
  const float *rays_o, *rays_d, *d_buf, *bounds;
  int N, s_in, S, n_up;
  float step;
  float *nd, *pts;
  cudaStream_t stream;

  template <int T, int C>
  cudaError_t run() const {
    const size_t smem = smem_bytes_bc<T>(s_in, n_up, 2);
    cudaError_t err = allow_smem(draw_kernel<T, C>, smem);
    if (err != cudaSuccess) return err;
    draw_kernel<T, C><<<N, T, smem, stream>>>(rays_o, rays_d, d_buf, bounds, s_in, S, n_up,
                                              step, nd, pts);
    return cudaGetLastError();
  }
};

struct CheckpointLaunch {
  const float *rays_o, *rays_d, *d_in, *s_in_buf, *nd, *raw, *ab, *u_it, *u_last;
  int N, s_in, S, n_up, n_final, u_stride, it, last, max_bisection;
  float eps, prior_r, bg_r, step;
  float *d_out, *s_out, *beta;
  int *converged, *iter_usage;
  float *fine, *beta_out, *nd_next, *pts_next;
  cudaStream_t stream;

  template <int T, int C>
  cudaError_t run() const {
    const size_t smem = smem_bytes_bc<T>(s_in + n_up, n_up, 3);
    cudaError_t err = allow_smem(checkpoint_kernel<T, C>, smem);
    if (err != cudaSuccess) return err;
    checkpoint_kernel<T, C><<<N, T, smem, stream>>>(
        rays_o, rays_d, d_in, s_in_buf, nd, raw, ab, u_it, u_last, s_in, S, n_up, n_final,
        u_stride, it, last, max_bisection, eps, prior_r, bg_r, step, d_out, s_out, beta,
        converged, iter_usage, fine, beta_out, nd_next, pts_next);
    return cudaGetLastError();
  }
};

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
  const InitLaunch f{
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(d_init), static_cast<const float*>(raw),
      static_cast<const float*>(far), static_cast<const float*>(ab),
      static_cast<const float*>(u), N, n0, S, n_final, u_stride, eps, beta_c, prior_r, bg_r,
      static_cast<float*>(d_buf), static_cast<float*>(s_buf), static_cast<float*>(bounds),
      static_cast<float*>(beta), static_cast<int*>(converged), static_cast<int*>(iter_usage),
      static_cast<float*>(fine), static_cast<cudaStream_t>(stream)};
  return (int)by_shape(n0 - 1, f);
}

// Kernel (b). d_buf rows (stride S) hold s_in sorted depths, bounds rows
// their s_in - 1 bounds; step = float32(1 / (n_up + 1)). Writes nd [N,n_up]
// (ascending) and pts [N*n_up,3].
extern "C" int ntt_volsdf_draw(const void* rays_o, const void* rays_d, const void* d_buf,
                               const void* bounds, int N, int s_in, int S, int n_up,
                               float step, void* nd, void* pts, void* stream) {
  if (N <= 0) return 0;
  const DrawLaunch f{static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
                     static_cast<const float*>(d_buf), static_cast<const float*>(bounds),
                     N, s_in, S, n_up, step, static_cast<float*>(nd), static_cast<float*>(pts),
                     static_cast<cudaStream_t>(stream)};
  return (int)by_shape(s_in - 1, f);
}

// Kernel (c) of round `it` (1-based; `last` on round max_iter). d_in / s_in_buf
// rows hold s_in entries, nd [N,n_up] the new depths (ascending), raw
// [N*n_up] the MLP's sdf there; u_it / u_last point at round it's and the
// fallback's uniforms (row stride u_stride). Writes the merged rows into d_out
// / s_out and the next round's det depths nd_next [N,n_up] and their points
// pts_next [N*n_up,3] (not on the last round; step as for kernel (b)), the
// state, the draws, and beta_out on the last round.
extern "C" int ntt_volsdf_checkpoint(
    const void* rays_o, const void* rays_d, const void* d_in, const void* s_in_buf,
    const void* nd, const void* raw, const void* ab, const void* u_it, const void* u_last,
    int N, int s_in, int S, int n_up, int n_final, int u_stride, int it, int last,
    int max_bisection, float eps, float prior_r, float bg_r, float step, void* d_out,
    void* s_out, void* beta, void* converged, void* iter_usage, void* fine, void* beta_out,
    void* nd_next, void* pts_next, void* stream) {
  if (N <= 0) return 0;
  const CheckpointLaunch f{
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(d_in), static_cast<const float*>(s_in_buf),
      static_cast<const float*>(nd), static_cast<const float*>(raw),
      static_cast<const float*>(ab), static_cast<const float*>(u_it),
      static_cast<const float*>(u_last), N, s_in, S, n_up, n_final, u_stride, it, last,
      max_bisection, eps, prior_r, bg_r, step, static_cast<float*>(d_out),
      static_cast<float*>(s_out), static_cast<float*>(beta), static_cast<int*>(converged),
      static_cast<int*>(iter_usage), static_cast<float*>(fine), static_cast<float*>(beta_out),
      static_cast<float*>(nd_next), static_cast<float*>(pts_next),
      static_cast<cudaStream_t>(stream)};
  return (int)by_shape(s_in + n_up - 1, f);
}
