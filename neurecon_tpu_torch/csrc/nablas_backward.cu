// Backward of the surface-MLP forward + nablas (the eikonal grad-of-grad):
// CUDA kernels for sm_90a.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of
// neurecon_tpu/ops/fused_nablas_vjp.py (the backward of the custom-VJP op
// `fused_forward_with_nablas_vjp`). Given the cotangents of sdf, nablas and
// the geometry features of M points, it gives the grads of every effective
// weight W_l [out, in], every bias b_l, and x, with the second-order
// (phi'') terms that the eikonal loss reaches through nablas.
//
// The math, per point, in the port's layout (in_l = the input of layer l:
// the encoding e, [h, e]/sqrt(2) at a skip, else h_l; a_l = W_l in_l + b_l;
// s_l = sigmoid(100 a_l) = phi'(a_l), phi'' = 100 s_l (1 - s_l)):
//   phase 1  forward, keeping s_l and in_l
//   phase 2  nablas sweep u_D = W_D[0, :], q_l = u_{l+1} s_l,
//            g_in = W_l^T q_l (u_l and g_e split off at the skip / layer 0)
//   phase 3  the nablas cotangent pushed forward through phase 2:
//            gin_0 = n_bar (d e / d x), qbar_l = W_l gin_l,
//            abarB_l = qbar_l u_{l+1} phi''(a_l) = 100 qbar_l q_l (1 - s_l),
//            ubar_{l+1} = qbar_l s_l, W_bar_l += q_l (x) gin_l; at the end
//            W_bar_D[0, :] += sum_m ubar_D (the seed's pullback, gsdfbar)
//   phase 4  one first-order down-sweep from y_bar = [sdf_bar, h_bar]:
//            W_bar_D += y_bar (x) h_D, abar_l = g_l s_l + abarB_l,
//            W_bar_l += abar_l (x) in_l, b_bar_l += abar_l, g = W^T abar,
//            ending in x_bar through the encoding (plus phase 3's
//            n_bar * g_e * d^2 e / d x^2 term).
//
// What bounds it: arithmetic. Per point at the flagship widths, 4 passes
// through the hidden chain plus the weight-gradient products, ~5.9 MFLOP,
// against ~1 KB of cotangents in and 12 B out; the weight grads are summed
// over all M points.
//
// Design. The TPU kernel keeps ~43 KB of per-point state (a_l, h_l, u_l,
// q_l, abar_l) in 100 MB of VMEM and sums the weight grads in VMEM from
// grid step to grid step. A Hopper block has 227 KB and its blocks run in
// no order. So the work is split in two hand-written passes:
//   1. `backward_tile_kernel`: one block of 256 threads per tile of 16
//      points runs phases 1-4 with the surface_mlp.cuh staged products for
//      every chain product. The activation slopes s_l (128 KB per tile at
//      D=8, W=256) go to a device-memory scratch of the block's own
//      (written once, read three times; 50 MB for the whole persistent
//      grid, so mostly L2), so a block needs ~71 KB of shared memory and
//      three blocks share an SM to hide the weight stream's L2 latency
//      (1.5x faster than one block per SM with the slopes in shared
//      memory). It
//      writes x_bar, and, per layer, the operands of the weight gradient to
//      a device-memory workspace: A = [q_l ; abar_l] and B = [gin_l ; in_l],
//      so that W_bar_l = sum over 2M rows of A (x) B; and per tile the
//      column sums of abar_l, y_bar and ubar_D (the bias grads, gsdfbar).
//      The workspace is tile-blocked ([tile][column][16 points]), the
//      shared-memory layout of the activations, so each block writes
//      contiguous 16-float rows.
//   2. `outer_sum_kernel`: a shared-memory-tiled fp32 sum of outer
//      products over the workspace rows, split along the rows into
//      `n_split` partial sums per 64 x 64 output tile; `colsum_kernel` sums
//      the per-tile bias rows the same way, and `split_sum_kernel` adds the
//      partials in a fixed order. No atomics: the result does not change
//      from run to run.
// fp32 FMA throughout; no tensor cores yet.
#include "surface_mlp.cuh"

namespace ntt {

constexpr int JOB = 12;  // int64 fields per layer record of the backward
// Layer record (built by ops/fused_nablas_vjp.py::_layout): offsets in
// floats into the workspace of A and of B, their column counts (multiples
// of 64), out and in, the reduction depth in 16-row tiles, the offset of
// W_bar_l in the flat gradient, the column of b_bar_l in a bias row, the
// first output tile of the layer in the reduction grid, the number of row
// pairs (2 for hidden layers: [q ; abar] and [gin ; in]; 1 for the final
// layer: y_bar and h_D), and (final layer) the column of gsdfbar.
struct Job {
  long long a_off, b_off, ldA, ldB, n_out, n_in, k_tiles, c_off, bias_off,
      tile_start, n_pairs, extra_off;
};

__device__ __forceinline__ Job job_of(const long long* jobs, int l) {
  const long long* r = jobs + (size_t)l * JOB;
  Job J;
  J.a_off = __ldg(r + 0);
  J.b_off = __ldg(r + 1);
  J.ldA = __ldg(r + 2);
  J.ldB = __ldg(r + 3);
  J.n_out = __ldg(r + 4);
  J.n_in = __ldg(r + 5);
  J.k_tiles = __ldg(r + 6);
  J.c_off = __ldg(r + 7);
  J.bias_off = __ldg(r + 8);
  J.tile_start = __ldg(r + 9);
  J.n_pairs = __ldg(r + 10);
  J.extra_off = __ldg(r + 11);
  return J;
}

// Copy `rows` rows of a [rows][TILE] block between shared memory and the
// workspace (both 16-byte aligned).
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < rows * TILE / 4; i += blockDim.x) d[i] = s[i];
}

// Sum over the tile's points of each of `rows` rows -> dst[row].
__device__ __forceinline__ void row_sums(float* dst, const float* src, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float4* s = reinterpret_cast<const float4*>(src + r * TILE);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < TILE / 4; ++i) {
      const float4 v = s[i];
      acc += (v.x + v.y) + (v.z + v.w);
    }
    dst[r] = acc;
  }
}

// Channel c of the encoding at the tile's point p: the coordinate it reads
// (r), d e_c / d x_r (J) and d^2 e_c / d x_r^2 (J2).
__device__ __forceinline__ void enc_deriv(const float* xs, int c, int p, int& r,
                                          float& J, float& J2) {
  if (c < 3) {
    r = c;
    J = 1.f;
    J2 = 0.f;
    return;
  }
  const int j = c - 3, f = j / 6, r6 = j % 6;
  r = r6 % 3;
  const float fr = ldexpf(1.f, f);
  const float ph = xs[r * TILE + p] * fr;
  const float sn = sinf(ph), cs = cosf(ph);
  if (r6 < 3) {  // sin(fr x)
    J = fr * cs;
    J2 = -fr * fr * sn;
  } else {       // cos(fr x)
    J = -fr * sn;
    J2 = -fr * fr * cs;
  }
}

// Phases 1-4 on point tile T, with the block's shared memory at `xs` and
// its slope scratch at `deriv`.
__device__ __forceinline__ void
backward_tile(const Mlp& m, const float* __restrict__ x, int M, int Mtiles,
              const float* __restrict__ cot_sdf, const float* __restrict__ cot_nab,
              const float* __restrict__ cot_h, int geo_dim,
              const long long* __restrict__ jobs, float* work, float* bias_part,
              int nb, int rows, int c4, float* __restrict__ xbar, int T,
              float* deriv, float* xs) {  // xs: [4][TILE] points
  float* nbar = xs + 4 * TILE;                   // [4][TILE] nablas cotangent
  float* xb = nbar + 4 * TILE;                   // [4][TILE] x_bar, phase 3 term
  float* emb = xb + 4 * TILE;                    // [c4][TILE] encoding (phase 1)
  float* gebar = emb;                            // n_bar (d e / d x), phase 3 on
  float* ge = emb + c4 * TILE;                   // [c4][TILE] g_e, then e_bar
  float* bufA = ge + c4 * TILE;                  // [rows][TILE]
  float* bufB = bufA + rows * TILE;              // [rows][TILE]
  float* stage = bufB + rows * TILE;             // STAGE_FLOATS
  const int D = m.n_layers - 1;
  const long p0 = (long)T * TILE;
  const int C = m.in_ch;
  const float inv_sqrt2 = 1.f / 1.41421356237f;
  float* bias_row = bias_part + (size_t)T * nb;
  // the workspace slot of (layer record J, operand base, its ld, pair k)
  auto slot = [&](long long base, long long ld, int k) {
    return work + base + ((size_t)k * Mtiles + T) * ld * TILE;
  };

  // rows past M get zero cotangents, so they add nothing to any gradient
  for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
    const int c = idx / TILE, p = idx % TILE;
    const bool in = p0 + p < M;
    xs[idx] = in ? x[(p0 + p) * 3 + c] : 0.f;
    nbar[idx] = in ? cot_nab[(p0 + p) * 3 + c] : 0.f;
    xb[idx] = 0.f;
  }
  for (int idx = threadIdx.x; idx < C * TILE; idx += blockDim.x) ge[idx] = 0.f;
  __syncthreads();
  embed_tile(m, xs, emb);
  __syncthreads();

  // ---- phase 1: forward; keep s_l (shared) and in_l (workspace, B pair 1)
  float* in = emb;
  float* out = bufA;
  for (int l = 0; l < D; ++l) {
    const Layer L = layer_of(m, l);
    const Job J = job_of(jobs, l);
    if (L.skip) {
      const int h_dim = L.in_dim - C;
      for (int idx = threadIdx.x; idx < C * TILE; idx += blockDim.x)
        in[h_dim * TILE + idx] = emb[idx];
      __syncthreads();
      for (int idx = threadIdx.x; idx < L.in_dim * TILE; idx += blockDim.x)
        in[idx] = in[idx] * inv_sqrt2;
      __syncthreads();
    }
    copy_rows(slot(J.b_off, J.ldB, 1), in, L.in_dim);
    hidden_tile(L, in, out, deriv + (size_t)l * m.wmax * TILE, stage);
    __syncthreads();
    in = out;
    out = (out == bufA) ? bufB : bufA;
  }
  const Layer LD = layer_of(m, D);
  const Job JD = job_of(jobs, D);
  copy_rows(slot(JD.b_off, JD.ldB, 0), in, LD.in_dim);  // h_D
  __syncthreads();

  // ---- phase 2: the nablas sweep; q_l to the workspace (A pair 0), g_e kept
  float* g = (in == bufA) ? bufB : bufA;
  float* other = in;
  for (int idx = threadIdx.x; idx < LD.in_dim * TILE; idx += blockDim.x)
    g[idx] = __ldg(LD.w + idx / TILE);
  __syncthreads();
  for (int l = D - 1; l >= 0; --l) {
    const Layer L = layer_of(m, l);
    const Job J = job_of(jobs, l);
    const float* dl = deriv + (size_t)l * m.wmax * TILE;
    for (int idx = threadIdx.x; idx < L.out_dim * TILE; idx += blockDim.x)
      g[idx] *= dl[idx];
    __syncthreads();
    copy_rows(slot(J.a_off, J.ldA, 0), g, L.out_dim);
    {
      float acc[1][4][4];
      staged_product<1>(L.w, L.out_dim, L.ld_w, g, stage, acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * col_group() + c;
        if (i < L.in_dim)
          *reinterpret_cast<float4*>(other + i * TILE + 4 * point_group()) =
              make_float4(acc[0][c][0], acc[0][c][1], acc[0][c][2], acc[0][c][3]);
      }
    }
    __syncthreads();
    if (l == 0) {
      for (int idx = threadIdx.x; idx < C * TILE; idx += blockDim.x)
        ge[idx] += other[idx];
    } else if (L.skip) {
      const int h_dim = L.in_dim - C;
      for (int idx = threadIdx.x; idx < L.in_dim * TILE; idx += blockDim.x) {
        const float v = other[idx] * inv_sqrt2;
        if (idx < h_dim * TILE) other[idx] = v;
        else ge[idx - h_dim * TILE] += v;
      }
    }
    __syncthreads();
    float* t = g;
    g = other;
    other = t;
  }

  // ---- phase 3: n_bar pushed forward through phase 2's chain
  for (int idx = threadIdx.x; idx < C * TILE; idx += blockDim.x) {
    const int c = idx / TILE, p = idx % TILE;
    int r;
    float J, J2;
    enc_deriv(xs, c, p, r, J, J2);
    gebar[idx] = nbar[r * TILE + p] * J;
  }
  for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
    const int k = idx / TILE, p = idx % TILE;
    float s = 0.f;
    for (int c = 3; c < C; ++c) {
      int r;
      float J, J2;
      enc_deriv(xs, c, p, r, J, J2);
      if (r == k) s += ge[c * TILE + p] * J2;
    }
    xb[idx] = nbar[idx] * s;
  }
  __syncthreads();
  float* ub = bufA;  // ubar_l (unused at l = 0)
  for (int l = 0; l < D; ++l) {
    const Layer L = layer_of(m, l);
    const Job J = job_of(jobs, l);
    const float* dl = deriv + (size_t)l * m.wmax * TILE;
    const float* gin;
    if (l == 0) {
      gin = gebar;
    } else if (L.skip) {
      const int h_dim = L.in_dim - C;
      for (int idx = threadIdx.x; idx < L.in_dim * TILE; idx += blockDim.x) {
        const float v = idx < h_dim * TILE ? ub[idx] : gebar[idx - h_dim * TILE];
        ub[idx] = v * inv_sqrt2;
      }
      __syncthreads();
      gin = ub;
    } else {
      gin = ub;
    }
    copy_rows(slot(J.b_off, J.ldB, 0), gin, L.in_dim);
    float* nxt = (gin == bufA) ? bufB : bufA;
    float acc[1][4][4];
    staged_product<1>(L.wT, L.in_dim, L.ld_wT, gin, stage, acc);  // qbar_l
    const float* qs = slot(J.a_off, J.ldA, 0);
    float* ab = slot(J.a_off, J.ldA, 1);
    const int q0 = 4 * point_group();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = 4 * col_group() + c;
      if (o >= L.out_dim) break;
      const int at = o * TILE + q0;
      const float4 s = *reinterpret_cast<const float4*>(dl + at);
      const float4 q = *reinterpret_cast<const float4*>(qs + at);
      const float a0 = acc[0][c][0], a1 = acc[0][c][1], a2 = acc[0][c][2],
                  a3 = acc[0][c][3];
      *reinterpret_cast<float4*>(ab + at) = make_float4(
          100.f * a0 * q.x * (1.f - s.x), 100.f * a1 * q.y * (1.f - s.y),
          100.f * a2 * q.z * (1.f - s.z), 100.f * a3 * q.w * (1.f - s.w));
      *reinterpret_cast<float4*>(nxt + at) =
          make_float4(a0 * s.x, a1 * s.y, a2 * s.z, a3 * s.w);
    }
    __syncthreads();
    ub = nxt;
  }
  row_sums(bias_row + JD.extra_off, ub, LD.in_dim);  // gsdfbar
  // e_bar reuses ge: phase 3's x_bar term has read it
  for (int idx = threadIdx.x; idx < C * TILE; idx += blockDim.x) ge[idx] = 0.f;
  __syncthreads();

  // ---- phase 4: the first-order down-sweep from y_bar = [sdf_bar, h_bar]
  float* y = (ub == bufA) ? bufB : bufA;
  for (int idx = threadIdx.x; idx < LD.out_dim * TILE; idx += blockDim.x) {
    const int o = idx / TILE, p = idx % TILE;
    const long pt = p0 + p;
    float v = 0.f;
    if (pt < M) v = (o == 0) ? cot_sdf[pt] : cot_h[pt * geo_dim + (o - 1)];
    y[idx] = v;
  }
  __syncthreads();
  copy_rows(slot(JD.a_off, JD.ldA, 0), y, LD.out_dim);
  row_sums(bias_row + JD.bias_off, y, LD.out_dim);
  float* gh = ub;
  {
    float acc[1][4][4];
    staged_product<1>(LD.w, LD.out_dim, LD.ld_w, y, stage, acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * col_group() + c;
      if (i < LD.in_dim)
        *reinterpret_cast<float4*>(gh + i * TILE + 4 * point_group()) =
            make_float4(acc[0][c][0], acc[0][c][1], acc[0][c][2], acc[0][c][3]);
    }
  }
  __syncthreads();
  float* ab_s = y;
  for (int l = D - 1; l >= 0; --l) {
    const Layer L = layer_of(m, l);
    const Job J = job_of(jobs, l);
    const float* dl = deriv + (size_t)l * m.wmax * TILE;
    float* ab = slot(J.a_off, J.ldA, 1);
    for (int idx = threadIdx.x; idx < L.out_dim * TILE; idx += blockDim.x) {
      const float a = gh[idx] * dl[idx] + ab[idx];
      ab[idx] = a;
      ab_s[idx] = a;
    }
    __syncthreads();
    row_sums(bias_row + J.bias_off, ab_s, L.out_dim);
    {
      float acc[1][4][4];
      staged_product<1>(L.w, L.out_dim, L.ld_w, ab_s, stage, acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * col_group() + c;
        if (i < L.in_dim)
          *reinterpret_cast<float4*>(gh + i * TILE + 4 * point_group()) =
              make_float4(acc[0][c][0], acc[0][c][1], acc[0][c][2], acc[0][c][3]);
      }
    }
    __syncthreads();
    if (l == 0) {
      for (int idx = threadIdx.x; idx < C * TILE; idx += blockDim.x)
        ge[idx] += gh[idx];
    } else if (L.skip) {
      const int h_dim = L.in_dim - C;
      for (int idx = threadIdx.x; idx < L.in_dim * TILE; idx += blockDim.x) {
        const float v = gh[idx] * inv_sqrt2;
        if (idx < h_dim * TILE) gh[idx] = v;
        else ge[idx - h_dim * TILE] += v;
      }
    }
    __syncthreads();
  }

  // x_bar = e_bar through d e / d x, plus phase 3's term
  for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
    const int k = idx / TILE, p = idx % TILE;
    if (p0 + p >= M) continue;
    float s = ge[k * TILE + p];
    for (int c = 3; c < C; ++c) {
      int r;
      float J, J2;
      enc_deriv(xs, c, p, r, J, J2);
      if (r == k) s += ge[c * TILE + p] * J;
    }
    xbar[(p0 + p) * 3 + k] = xb[idx] + s;
  }
}

// A persistent grid (as many blocks as fit on the card at once) walks the
// point tiles; each block keeps its tile's slopes s_l ([D][wmax][TILE]) in
// its own slice of `slopes`, reused from tile to tile so that it stays in L2.
__global__ void __launch_bounds__(THREADS, 3)
backward_tile_kernel(Mlp m, const float* __restrict__ x, int M, int Mtiles,
                     const float* __restrict__ cot_sdf,
                     const float* __restrict__ cot_nab,
                     const float* __restrict__ cot_h, int geo_dim,
                     const long long* __restrict__ jobs, float* work,
                     float* bias_part, int nb, int rows, int c4,
                     float* slopes, float* __restrict__ xbar) {
  extern __shared__ float4 smem4[];
  float* deriv = slopes + (size_t)blockIdx.x * (m.n_layers - 1) * m.wmax * TILE;
  for (int T = blockIdx.x; T < Mtiles; T += gridDim.x) {
    backward_tile(m, x, M, Mtiles, cot_sdf, cot_nab, cot_h, geo_dim, jobs, work,
                  bias_part, nb, rows, c4, xbar, T, deriv,
                  reinterpret_cast<float*>(smem4));
    __syncthreads();  // the next tile overwrites shared memory
  }
}

constexpr int RT = 64;  // output tile edge of the reduction
constexpr int RS = 20;  // staged column stride: 16 rows + 4 floats of pad

// part[split][c_off + o * n_in + i] = sum over this split's rows k of
// A[k][o] * B[k][i], for one 64 x 64 output tile of one layer. A and B are
// tile-blocked: row k, column c at ((k / 16) * ld + c) * 16 + k % 16.
// Thread (ty, tx) owns columns o0 + ty + 16 a and i0 + tx + 16 b, so that
// the float4 reads of B by neighbouring threads fall in distinct banks.
__global__ void __launch_bounds__(256)
outer_sum_kernel(const long long* __restrict__ jobs, int n_jobs,
                 const float* __restrict__ work, float* __restrict__ part,
                 long long total, int n_split) {
  __shared__ __align__(16) float As[2][RT * RS];
  __shared__ __align__(16) float Bs[2][RT * RS];
  const int t = blockIdx.x;
  int j = 0;
  while (j + 1 < n_jobs && __ldg(jobs + (size_t)(j + 1) * JOB + 9) <= t) ++j;
  const Job J = job_of(jobs, j);
  const int tiles_i = (int)((J.n_in + RT - 1) / RT);
  const int local = t - (int)J.tile_start;
  const int o0 = (local / tiles_i) * RT, i0 = (local % tiles_i) * RT;
  const long long kt0 = J.k_tiles * blockIdx.y / n_split;
  const long long kt1 = J.k_tiles * (blockIdx.y + 1) / n_split;
  const float* A = work + J.a_off + (size_t)o0 * TILE;
  const float* B = work + J.b_off + (size_t)i0 * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int col = threadIdx.x / 4, k4 = threadIdx.x % 4;  // 64 columns x 4 float4
  auto issue = [&](long long kt, int buf) {
    cp_async16(&As[buf][col * RS + 4 * k4], A + (size_t)kt * J.ldA * TILE + col * TILE + 4 * k4);
    cp_async16(&Bs[buf][col * RS + 4 * k4], B + (size_t)kt * J.ldB * TILE + col * TILE + 4 * k4);
    cp_async_commit();
  };
  if (kt0 < kt1) issue(kt0, 0);
  for (long long kt = kt0; kt < kt1; ++kt) {
    const int buf = (int)((kt - kt0) & 1);
    if (kt + 1 < kt1) {
      issue(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        av[a] = *reinterpret_cast<const float4*>(&As[buf][(ty + 16 * a) * RS + 4 * q]);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bv[b] = *reinterpret_cast<const float4*>(&Bs[buf][(tx + 16 * b) * RS + 4 * q]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float s = acc[a][b];
          s += av[a].x * bv[b].x;
          s += av[a].y * bv[b].y;
          s += av[a].z * bv[b].z;
          s += av[a].w * bv[b].w;
          acc[a][b] = s;
        }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  float* P = part + (size_t)blockIdx.y * total + J.c_off;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty + 16 * a;
    if (o >= J.n_out) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + tx + 16 * b;
      if (i < J.n_in) P[(size_t)o * J.n_in + i] = acc[a][b];
    }
  }
}

// part[split][off + c] = sum of bias_part[r][c] over this split's rows.
__global__ void colsum_kernel(const float* __restrict__ bias_part, int n_rows,
                              int nb, float* __restrict__ part, long long total,
                              long long off, int n_split) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nb) return;
  const int r0 = (int)((long long)n_rows * blockIdx.y / n_split);
  const int r1 = (int)((long long)n_rows * (blockIdx.y + 1) / n_split);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += bias_part[(size_t)r * nb + c];
  part[(size_t)blockIdx.y * total + off + c] = s;
}

// out[j] = sum over the splits of part[split][j], in split order.
__global__ void split_sum_kernel(const float* __restrict__ part, long long total,
                                 int n_split, float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += part[(size_t)k * total + j];
  out[j] = s;
}

__host__ __device__ inline size_t backward_smem_floats(int c4, int rows) {
  return (size_t)(12 + 2 * c4 + 2 * rows) * TILE + STAGE_FLOATS;
}

}  // namespace ntt

extern "C" size_t ntt_nablas_backward_smem_bytes(int c4, int rows) {
  return ntt::backward_smem_floats(c4, rows) * sizeof(float);
}

// Blocks of the persistent tile pass for `m_tiles` tiles: as many as are
// resident on the card at once, at most one per tile (the caller sizes the
// slope scratch by it). Returns a negative cudaError_t on failure.
extern "C" int ntt_nablas_backward_blocks(int c4, int rows, int m_tiles) {
  const size_t smem = ntt_nablas_backward_smem_bytes(c4, rows);
  cudaError_t err = cudaFuncSetAttribute(
      ntt::backward_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ntt::backward_tile_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ntt::backward_tile_kernel, ntt::THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  const int blocks = per_sm * sms;
  return blocks < m_tiles ? blocks : m_tiles;
}

// x [M,3], cot_sdf [M], cot_nab [M,3], cot_h [M,geo_dim] -> xbar [M,3] and
// the flat gradient `flat` [total] (layout in ops/fused_nablas_vjp.py);
// `work`, `bias_part` [Mtiles, nb], `part` [n_split, total] and `slopes`
// [blocks, n_layers - 1, wmax, 16] are scratch; `blocks` comes from
// ntt_nablas_backward_blocks, which also sets the kernel's attributes.
// All fp32, contiguous, on the device; M > 0. Returns the first
// cudaError_t of the four launches.
extern "C" int ntt_nablas_backward(
    const void* x, int M, const void* params, const void* meta, int n_layers,
    int in_ch, int multires, int wmax, int rows, int c4, const void* cot_sdf,
    const void* cot_nab, const void* cot_h, int geo_dim, const void* jobs,
    void* work, void* bias_part, int nb, void* part, int n_split,
    long long total, long long bias_flat_off, int n_out_tiles, int blocks,
    void* slopes, void* flat, void* xbar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = ntt_nablas_backward_smem_bytes(c4, rows);
  cudaError_t err;
  ntt::Mlp m{static_cast<const float*>(params), static_cast<const int*>(meta),
             n_layers, in_ch, multires, wmax};
  const int Mtiles = (M + ntt::TILE - 1) / ntt::TILE;
  const long long* J = static_cast<const long long*>(jobs);
  float* W = static_cast<float*>(work);
  float* BP = static_cast<float*>(bias_part);
  float* P = static_cast<float*>(part);
  ntt::backward_tile_kernel<<<blocks, ntt::THREADS, smem, st>>>(
      m, static_cast<const float*>(x), M, Mtiles,
      static_cast<const float*>(cot_sdf), static_cast<const float*>(cot_nab),
      static_cast<const float*>(cot_h), geo_dim, J, W, BP, nb, rows, c4,
      static_cast<float*>(slopes), static_cast<float*>(xbar));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ntt::outer_sum_kernel<<<dim3(n_out_tiles, n_split), 256, 0, st>>>(
      J, n_layers, W, P, total, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ntt::colsum_kernel<<<dim3((nb + 255) / 256, n_split), 256, 0, st>>>(
      BP, Mtiles, nb, P, total, bias_flat_off, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long sum_blocks = (total + 255) / 256;
  ntt::split_sum_kernel<<<(unsigned)sum_blocks, 256, 0, st>>>(
      P, total, n_split, static_cast<float*>(flat));
  return (int)cudaGetLastError();
}
