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
// s_l = phi'(a_l): sigmoid(100 a_l) for Softplus(beta = 100), where
// phi'' = 100 s_l (1 - s_l); 30 cos(30 a_l) for the SIREN sine, where
// phi'' = -900 sin(30 a_l) = -900 h_{l+1}):
//   phase 1  forward, keeping s_l and in_l
//   phase 2  nablas sweep u_D = W_D[0, :], q_l = u_{l+1} s_l,
//            g_in = W_l^T q_l (u_l and g_e split off at the skip / layer 0);
//            for the sine, also u_{l+1} phi''(a_l) = -900 u_{l+1} h_{l+1}
//            (h_{l+1} is the next layer's input, kept in the workspace by
//            phase 1: a sine net has no skips), parked in abar_l's slot
//   phase 3  the nablas cotangent pushed forward through phase 2:
//            gin_0 = n_bar (d e / d x), qbar_l = W_l gin_l,
//            abarB_l = qbar_l u_{l+1} phi''(a_l) (Softplus: 100 qbar_l q_l
//            (1 - s_l) from the kept slope; sine: qbar_l times the parked
//            product; cos(30 a) alone has lost the sine's sign),
//            ubar_{l+1} = qbar_l s_l, W_bar_l += q_l (x) gin_l; at the end
//            W_bar_D[0, :] += sum_m ubar_D (the seed's pullback, gsdfbar)
//   phase 4  one first-order down-sweep from y_bar = [sdf_bar, h_bar]:
//            W_bar_D += y_bar (x) h_D, abar_l = g_l s_l + abarB_l,
//            W_bar_l += abar_l (x) in_l, b_bar_l += abar_l, g = W^T abar,
//            ending in x_bar through the encoding (plus phase 3's
//            n_bar * g_e * d^2 e / d x^2 term).
//
// What bounds it. Per point at the flagship widths, 4 passes through the
// hidden chain in the tile pass plus the two weight-gradient products in the
// reduction, ~5.8 MFLOP, against ~1 KB of cotangents in and 12 B out: 753
// GFLOP at a training step's 130,560 points, 11.2 ms at the card's fp32
// rate outside the tensor cores and 4.6 ms as split-fp32 (three TF32 MMAs a
// multiply-add at 495 TFLOP/s). Both passes run their products on the
// tensor cores (surface_mma.cuh), so the kernel is held to the 3xTF32
// bound; its device-memory traffic (the workspace, 4.6 GB written once and
// read once by the reduction, and the slope scratch below) is under 3 ms at
// 3.35 TB/s.
//
// Design. The TPU kernel keeps ~43 KB of per-point state (a_l, h_l, u_l,
// q_l, abar_l) in 100 MB of VMEM and sums the weight grads in VMEM from
// grid step to grid step. A Hopper block has 227 KB and its blocks run in
// no order. So the work is split in two hand-written passes:
//   1. `backward_tile_kernel`: a persistent grid of 512-thread blocks, one
//      per SM, walks tiles of 128 points; each runs phases 1-4 with every
//      chain product (the forward, the nablas sweep, the pushed-forward
//      nablas cotangent, the down-sweep) on the split-fp32 tensor-core
//      product, each weight fetched from L2 once per 128 points. Every
//      product reads its input from one activation buffer and its epilogue
//      overwrites it in place. Shared memory (floats, flagship widths):
//      xs, n_bar, the phase-3 x_bar term [4][128] each; the encoding (then
//      n_bar d e / d x) and g_e [40][136] each; the activations [264][136];
//      the weight stage [2][16][264]: 227,072 bytes, one block an SM. The
//      activation slopes s_l (D x 264 x 128 floats, 1.08 MB a tile) do not
//      fit beside them; they go to a device-memory scratch of the block's
//      own (143 MB for the grid, past the 50 MB L2), written once and read
//      three times: ~4.4 GB of traffic at 130,560 points, ~1.3 ms at HBM's
//      rate, which is less than recomputing them (a fifth forward pass,
//      0.9 ms of 3xTF32 work at the bound, several at the kernel's rate).
//      The pass writes x_bar, and, per layer, the operands of the weight
//      gradient to a device-memory workspace: A = [q_l ; abar_l] and
//      B = [gin_l ; in_l], so that W_bar_l = sum over 2M rows of A (x) B;
//      and per tile the column sums of abar_l, y_bar and ubar_D (the bias
//      grads, gsdfbar). The workspace is tile-blocked ([tile][column][128
//      points]), so each block writes contiguous 128-float rows.
//   2. `outer_sum_kernel`: the sum of outer products over the workspace
//      rows, per layer a GEMM of depth 2M (261,120 at a step's 130,560
//      points), on the tensor cores with the same split-fp32 scheme, split
//      along the rows into `n_split` partial sums per 64 x 64 output tile;
//      `colsum_kernel` sums the per-tile bias rows the same way, and
//      `split_sum_kernel` adds the partials in a fixed order. No atomics:
//      the result does not change from run to run.
#include "surface_mma.cuh"

namespace ntt {

constexpr int BWD_TILE = 128;  // points per tile of the tile pass
constexpr int BWD_KC = 16;     // weight rows per staged chunk
constexpr int BWD_NBUF = 2;    // staged chunks: one computed, one in flight
constexpr int BWD_STAGE = tc::stage_floats(BWD_KC, BWD_NBUF, false);
constexpr int THREADS = tc::Tile<BWD_TILE>::THREADS;

constexpr int JOB = 12;  // int64 fields per layer record of the backward
// Layer record (built by ops/fused_nablas_vjp.py::_layout): offsets in
// floats into the workspace of A and of B, their column counts (multiples
// of 64), out and in, the reduction depth in 16-row k-tiles, the offset of
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

// Copy `rows` rows of an activation block ([rows][LDV] in shared memory) to
// the workspace ([rows][P], contiguous).
template <int P>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int rows) {
  constexpr int LDV = tc::Tile<P>::LDV, Q = P / 4;
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < rows * Q; i += THREADS)
    d[i] = *reinterpret_cast<const float4*>(src + (i / Q) * LDV + 4 * (i % Q));
}

// Sum over the tile's points of each of `rows` rows -> dst[row].
template <int P>
__device__ __forceinline__ void row_sums(float* dst, const float* src, int rows) {
  constexpr int LDV = tc::Tile<P>::LDV;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const float4* s = reinterpret_cast<const float4*>(src + r * LDV);
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < P / 4; ++i) {
      const float4 v = s[i];
      acc += (v.x + v.y) + (v.z + v.w);
    }
    dst[r] = acc;
  }
}

// Channel c of the encoding at the tile's point p: the coordinate it reads
// (r), d e_c / d x_r (J) and d^2 e_c / d x_r^2 (J2).
template <int P>
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
  const float ph = xs[r * P + p] * fr;
  const float sn = sinf(ph), cs = cosf(ph);
  if (r6 < 3) {  // sin(fr x)
    J = fr * cs;
    J2 = -fr * fr * sn;
  } else {       // cos(fr x)
    J = -fr * sn;
    J2 = -fr * fr * cs;
  }
}

// Phases 1-4 on point tile T, with the block's shared memory at `base` and
// its slope scratch at `deriv` ([D][rows][P]); ACT the hidden activation.
template <int P, int ACT>
__device__ __forceinline__ void
backward_tile(const tc::Mlp& m, const float* __restrict__ x, int M, int Mtiles,
              const float* __restrict__ cot_sdf, const float* __restrict__ cot_nab,
              const float* __restrict__ cot_h, int geo_dim,
              const long long* __restrict__ jobs, float* work, float* bias_part,
              int nb, float* __restrict__ xbar, int T, float* deriv, float* base) {
  constexpr int LDV = tc::Tile<P>::LDV;
  float* xs = base;                    // [4][P] points
  float* nbar = xs + 4 * P;            // [4][P] nablas cotangent
  float* xb = nbar + 4 * P;            // [4][P] x_bar, phase 3 term
  float* emb = xb + 4 * P;             // [c_pad][LDV] encoding (phase 1)
  float* gebar = emb;                  // n_bar (d e / d x), phase 3 on
  float* ge = emb + m.c_pad * LDV;     // [c_pad][LDV] g_e, then e_bar
  float* buf = ge + m.c_pad * LDV;     // [rows][LDV] activations
  float* stage = buf + m.rows * LDV;   // BWD_STAGE
  const int D = m.n_layers - 1;
  const long p0 = (long)T * P;
  const int C = m.in_ch;
  const float inv_sqrt2 = 1.f / 1.41421356237f;
  float* bias_row = bias_part + (size_t)T * nb;
  // the workspace slot of (operand base, its ld, pair k) for this tile
  auto slot = [&](long long off, long long ld, int k) {
    return work + off + ((size_t)k * Mtiles + T) * ld * P;
  };
  auto slope = [&](int l) { return deriv + (size_t)l * m.rows * P; };

  // rows past M get zero cotangents, so they add nothing to any gradient
  for (int idx = threadIdx.x; idx < 3 * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    const bool in = p0 + p < M;
    xs[idx] = in ? x[(p0 + p) * 3 + c] : 0.f;
    nbar[idx] = in ? cot_nab[(p0 + p) * 3 + c] : 0.f;
    xb[idx] = 0.f;
  }
  for (int idx = threadIdx.x; idx < m.c_pad * P; idx += THREADS)
    ge[(idx / P) * LDV + idx % P] = 0.f;
  __syncthreads();
  tc::embed_tile<P>(m, xs, emb);
  __syncthreads();

  // ---- phase 1: forward; keep s_l (scratch) and in_l (workspace, B pair 1)
  for (int l = 0; l < D; ++l) {
    const tc::Layer L = tc::layer_of(m, l);
    const Job J = job_of(jobs, l);
    if (L.skip) {  // [h, e] * (1 / sqrt(2)), the encoding right after h
      const int h_dim = L.in_dim - C;
      for (int idx = threadIdx.x; idx < (L.K - h_dim) * P; idx += THREADS) {
        const int c = idx / P, p = idx % P;
        buf[(h_dim + c) * LDV + p] = c < C ? emb[c * LDV + p] : 0.f;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < L.K * P; idx += THREADS)
        buf[(idx / P) * LDV + idx % P] *= inv_sqrt2;
      __syncthreads();
    }
    const float* in = l == 0 ? emb : buf;
    copy_rows<P>(slot(J.b_off, J.ldB, 1), in, L.in_dim);
    float acc[tc::Tile<P>::MT][8][4];
    tc::product<P, BWD_KC, BWD_NBUF, false>(L.wT, m.plane, L.K, L.N, L.N, in, stage, acc);
    tc::activation_out<P, ACT>(L, acc, buf, slope(l));
    __syncthreads();
  }
  const tc::Layer LD = tc::layer_of(m, D);
  const Job JD = job_of(jobs, D);
  copy_rows<P>(slot(JD.b_off, JD.ldB, 0), buf, LD.in_dim);  // h_D
  __syncthreads();

  // ---- phase 2: the nablas sweep; q_l to the workspace (A pair 0), g_e kept
  for (int idx = threadIdx.x; idx < LD.K * P; idx += THREADS)
    buf[(idx / P) * LDV + idx % P] = __ldg(LD.w + idx / P);  // W_D[0, :]
  __syncthreads();
  for (int l = D - 1; l >= 0; --l) {
    const tc::Layer L = tc::layer_of(m, l);
    const Job J = job_of(jobs, l);
    const float* sl = slope(l);
    if constexpr (ACT == ACT_SINE) {  // u_{l+1} phi''(a_l), parked in abar_l's slot
      const Job Jn = job_of(jobs, l + 1);
      const float* hn = l + 1 == D ? slot(Jn.b_off, Jn.ldB, 0) : slot(Jn.b_off, Jn.ldB, 1);
      float* ab = slot(J.a_off, J.ldA, 1);
      for (int idx = threadIdx.x; idx < L.out_dim * P; idx += THREADS)
        ab[idx] = -SIREN_W0 * SIREN_W0 * buf[(idx / P) * LDV + idx % P] * hn[idx];
    }
    for (int idx = threadIdx.x; idx < L.N * P; idx += THREADS)
      buf[(idx / P) * LDV + idx % P] *= sl[idx];  // padded rows: slope 0
    __syncthreads();
    copy_rows<P>(slot(J.a_off, J.ldA, 0), buf, L.out_dim);
    tc::reverse_product<P, BWD_KC, BWD_NBUF, false>(m, L, buf, stage);
    tc::pull_input<P>(m, L, l, buf, ge);
  }

  // ---- phase 3: n_bar pushed forward through phase 2's chain
  for (int idx = threadIdx.x; idx < m.c_pad * P; idx += THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (c < C) {
      int r;
      float J, J2;
      enc_deriv<P>(xs, c, p, r, J, J2);
      v = nbar[r * P + p] * J;
    }
    gebar[c * LDV + p] = v;
  }
  for (int idx = threadIdx.x; idx < 3 * P; idx += THREADS) {
    const int k = idx / P, p = idx % P;
    float s = 0.f;
    for (int c = 3; c < C; ++c) {
      int r;
      float J, J2;
      enc_deriv<P>(xs, c, p, r, J, J2);
      if (r == k) s += ge[c * LDV + p] * J2;
    }
    xb[idx] = nbar[idx] * s;
  }
  __syncthreads();
  for (int l = 0; l < D; ++l) {
    const tc::Layer L = tc::layer_of(m, l);
    const Job J = job_of(jobs, l);
    const float* sl = slope(l);
    if (L.skip) {  // [ubar, gebar] * (1 / sqrt(2))
      const int h_dim = L.in_dim - C;
      for (int idx = threadIdx.x; idx < L.K * P; idx += THREADS) {
        const int r = idx / P, p = idx % P;
        const float v = r < h_dim ? buf[r * LDV + p]
                                  : (r - h_dim < C ? gebar[(r - h_dim) * LDV + p] : 0.f);
        buf[r * LDV + p] = v * inv_sqrt2;
      }
      __syncthreads();
    }
    const float* gin = l == 0 ? gebar : buf;
    copy_rows<P>(slot(J.b_off, J.ldB, 0), gin, L.in_dim);
    float acc[tc::Tile<P>::MT][8][4];
    tc::product<P, BWD_KC, BWD_NBUF, false>(L.wT, m.plane, L.K, L.N, L.N, gin, stage,
                                            acc);  // qbar_l
    const float* qs = slot(J.a_off, J.ldA, 0);
    float* ab = slot(J.a_off, J.ldA, 1);
    tc::each_output<P>(acc, L.N, [&](int o, int p, float a) {
      float u = 0.f;
      if (o < L.out_dim) {
        const float s = sl[o * P + p];
        if constexpr (ACT == ACT_SINE) ab[o * P + p] *= a;
        else ab[o * P + p] = 100.f * a * qs[o * P + p] * (1.f - s);
        u = a * s;
      }
      buf[o * LDV + p] = u;
    });
    __syncthreads();
  }
  row_sums<P>(bias_row + JD.extra_off, buf, LD.in_dim);  // gsdfbar
  // e_bar reuses ge: phase 3's x_bar term has read it
  for (int idx = threadIdx.x; idx < m.c_pad * P; idx += THREADS)
    ge[(idx / P) * LDV + idx % P] = 0.f;
  __syncthreads();

  // ---- phase 4: the first-order down-sweep from y_bar = [sdf_bar, h_bar]
  for (int idx = threadIdx.x; idx < LD.N * P; idx += THREADS) {
    const int o = idx / P, p = idx % P;
    const long pt = p0 + p;
    float v = 0.f;
    if (pt < M && o < LD.out_dim) v = (o == 0) ? cot_sdf[pt] : cot_h[pt * geo_dim + (o - 1)];
    buf[o * LDV + p] = v;
  }
  __syncthreads();
  copy_rows<P>(slot(JD.a_off, JD.ldA, 0), buf, LD.out_dim);
  row_sums<P>(bias_row + JD.bias_off, buf, LD.out_dim);
  tc::reverse_product<P, BWD_KC, BWD_NBUF, false>(m, LD, buf, stage);  // g_h = y_bar W_D
  for (int l = D - 1; l >= 0; --l) {
    const tc::Layer L = tc::layer_of(m, l);
    const Job J = job_of(jobs, l);
    const float* sl = slope(l);
    float* ab = slot(J.a_off, J.ldA, 1);
    for (int idx = threadIdx.x; idx < L.N * P; idx += THREADS) {
      const int o = idx / P, p = idx % P;
      float a = 0.f;
      if (o < L.out_dim) {
        a = buf[o * LDV + p] * sl[idx] + ab[idx];
        ab[idx] = a;
      }
      buf[o * LDV + p] = a;
    }
    __syncthreads();
    row_sums<P>(bias_row + J.bias_off, buf, L.out_dim);
    tc::reverse_product<P, BWD_KC, BWD_NBUF, false>(m, L, buf, stage);
    tc::pull_input<P>(m, L, l, buf, ge);
  }

  // x_bar = e_bar through d e / d x, plus phase 3's term
  for (int idx = threadIdx.x; idx < 3 * P; idx += THREADS) {
    const int k = idx / P, p = idx % P;
    if (p0 + p >= M) continue;
    float s = ge[k * LDV + p];
    for (int c = 3; c < C; ++c) {
      int r;
      float J, J2;
      enc_deriv<P>(xs, c, p, r, J, J2);
      if (r == k) s += ge[c * LDV + p] * J;
    }
    xbar[(p0 + p) * 3 + k] = xb[idx] + s;
  }
}

// A persistent grid (one block per SM) walks the point tiles; each block
// keeps its tile's slopes s_l ([D][rows][P]) in its own slice of `slopes`,
// reused from tile to tile.
template <int ACT>
__global__ void __launch_bounds__(THREADS, 1)
backward_tile_kernel(tc::Mlp m, const float* __restrict__ x, int M, int Mtiles,
                     const float* __restrict__ cot_sdf,
                     const float* __restrict__ cot_nab,
                     const float* __restrict__ cot_h, int geo_dim,
                     const long long* __restrict__ jobs, float* work,
                     float* bias_part, int nb, float* slopes,
                     float* __restrict__ xbar) {
  constexpr int P = BWD_TILE;
  extern __shared__ float4 smem4[];
  float* deriv = slopes + (size_t)blockIdx.x * (m.n_layers - 1) * m.rows * P;
  for (int T = blockIdx.x; T < Mtiles; T += gridDim.x) {
    backward_tile<P, ACT>(m, x, M, Mtiles, cot_sdf, cot_nab, cot_h, geo_dim, jobs, work,
                     bias_part, nb, xbar, T, deriv, reinterpret_cast<float*>(smem4));
    __syncthreads();  // the next tile overwrites shared memory
  }
}

constexpr int RT = 64;   // output tile edge of the reduction
constexpr int RK = 16;   // workspace rows per staged k-tile
constexpr int RS = RK + 4;  // staged column stride: conflict-free fragments
constexpr int RED_THREADS = 128;

// part[split][c_off + o * n_in + i] = sum over this split's rows k of
// A[k][o] * B[k][i], for one 64 x 64 output tile of one layer, on the
// tensor cores with the split-fp32 product of surface_mma.cuh. A and B are
// tile-blocked: row k, column c at ((k / P) * ld + c) * P + k % P, P =
// BWD_TILE; a k-tile is 16 consecutive rows of one point tile, staged
// column by column ([64][RS]: each column's 16 rows contiguous, as the MMA
// fragments read them). Warp w owns output rows o0 + 32 (w % 2) + [0, 32)
// and columns i0 + 32 (w / 2) + [0, 32): 2 x 4 MMA tiles. A k-tile's six
// MMAs a tile go into a fresh fragment, added to the fp32 sum on the CUDA
// cores (the tensor cores' accumulation truncates; over 2M rows it would
// drift).
__global__ void __launch_bounds__(RED_THREADS)
outer_sum_kernel(const long long* __restrict__ jobs, int n_jobs,
                 const float* __restrict__ work, float* __restrict__ part,
                 long long total, int n_split) {
  constexpr int P = BWD_TILE;
  __shared__ __align__(16) float As[2][RT * RS];
  __shared__ __align__(16) float Bs[2][RT * RS];
  const int t_out = blockIdx.x;
  int j = 0;
  while (j + 1 < n_jobs && __ldg(jobs + (size_t)(j + 1) * JOB + 9) <= t_out) ++j;
  const Job J = job_of(jobs, j);
  const int tiles_i = (int)((J.n_in + RT - 1) / RT);
  const int local = t_out - (int)J.tile_start;
  const int o0 = (local / tiles_i) * RT, i0 = (local % tiles_i) * RT;
  const long long kt0 = J.k_tiles * blockIdx.y / n_split;
  const long long kt1 = J.k_tiles * (blockIdx.y + 1) / n_split;
  const float* A = work + J.a_off + (size_t)o0 * P;
  const float* B = work + J.b_off + (size_t)i0 * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wo = (warp & 1) * 32, wi = (warp >> 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  auto fetch = [&](long long kt, int buf) {  // 64 columns x 4 float4, each operand
    const long long r0 = kt * RK, T = r0 / P;
    const int w = (int)(r0 % P);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = threadIdx.x + RED_THREADS * q, col = idx / 4, k4 = idx % 4;
      tc::cp_async16(&As[buf][col * RS + 4 * k4],
                     A + ((size_t)T * J.ldA + col) * P + w + 4 * k4);
      tc::cp_async16(&Bs[buf][col * RS + 4 * k4],
                     B + ((size_t)T * J.ldB + col) * P + w + 4 * k4);
    }
    tc::cp_async_commit();
  };
  if (kt0 < kt1) fetch(kt0, 0);
  for (long long kt = kt0; kt < kt1; ++kt) {
    const int buf = (int)((kt - kt0) & 1);
    if (kt + 1 < kt1) {
      fetch(kt + 1, buf ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    float d[2][4][4];
#pragma unroll
    for (int s = 0; s < RK / 8; ++s) {  // k-steps of 8 rows
      uint32_t a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float* v = &As[buf][(wo + 16 * a + g) * RS + 8 * s + t];
        tc::split_tf32(v[0], a_big[a][0], a_small[a][0]);
        tc::split_tf32(v[8 * RS], a_big[a][1], a_small[a][1]);
        tc::split_tf32(v[4], a_big[a][2], a_small[a][2]);
        tc::split_tf32(v[8 * RS + 4], a_big[a][3], a_small[a][3]);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float* v = &Bs[buf][(wi + 8 * b + g) * RS + 8 * s + t];
        tc::split_tf32(v[0], b_big[b][0], b_small[b][0]);
        tc::split_tf32(v[4], b_big[b][1], b_small[b][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (s == 0) tc::mma_tf32_first(d[a][b], a_small[a], b_big[b]);
          else tc::mma_tf32(d[a][b], a_small[a], b_big[b]);
        }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) tc::mma_tf32(d[a][b], a_big[a], b_small[b]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) tc::mma_tf32(d[a][b], a_big[a], b_big[b]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] += d[a][b][e];
    __syncthreads();  // the buffer is refilled two tiles on
  }
  float* Pp = part + (size_t)blockIdx.y * total + J.c_off;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wo + 16 * a + g + 8 * (e >> 1);
        const int i = i0 + wi + 8 * b + 2 * t + (e & 1);
        if (o < J.n_out && i < J.n_in) Pp[(size_t)o * J.n_in + i] = acc[a][b][e];
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

}  // namespace ntt

extern "C" size_t ntt_nablas_backward_smem_bytes(int c_pad, int rows) {
  constexpr int P = ntt::BWD_TILE, LDV = ntt::tc::Tile<P>::LDV;
  return ((size_t)12 * P + (size_t)(2 * c_pad + rows) * LDV + ntt::BWD_STAGE) *
         sizeof(float);
}

// Blocks of the persistent tile pass for `m_tiles` tiles: as many as are
// resident on the card at once, at most one per tile (the caller sizes the
// slope scratch by it). Sets the kernel's dynamic shared-memory cap to the
// card's opt-in maximum. Returns a negative cudaError_t on failure, 0 when a
// block does not fit.
extern "C" int ntt_nablas_backward_blocks(int c_pad, int rows, int m_tiles) {
  const size_t smem = ntt_nablas_backward_smem_bytes(c_pad, rows);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > (size_t)optin) return 0;
  bool first = true;
  for (auto kernel : {ntt::backward_tile_kernel<ntt::ACT_SOFTPLUS>,
                      ntt::backward_tile_kernel<ntt::ACT_SINE>}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, ntt::THREADS, smem);
    per_sm = first || n < per_sm ? n : per_sm;
    first = false;
  }
  if (err != cudaSuccess) return -(int)err;
  const int blocks = per_sm * sms;
  return blocks < m_tiles ? blocks : m_tiles;
}

// x [M,3], cot_sdf [M], cot_nab [M,3], cot_h [M,geo_dim] -> xbar [M,3] and
// the flat gradient `flat` [total] (layout in ops/fused_nablas_vjp.py);
// `params` (three planes of `plane` floats) and `meta` the pack of
// ops/surface_pack.py; `act` the hidden layers' activation
// (ACT_SOFTPLUS or ACT_SINE); `work`, `bias_part`
// [Mtiles, nb], `part` [n_split, total] and `slopes` [blocks, n_layers - 1,
// rows, BWD_TILE] are scratch; `blocks` comes from ntt_nablas_backward_blocks,
// which also sets the kernel's attributes. All fp32, contiguous, on the
// device; M > 0. Returns the first cudaError_t of the four launches.
extern "C" int ntt_nablas_backward(
    const void* x, int M, const void* params, long long plane, const void* meta, int n_layers,
    int in_ch, int c_pad, int rows, int act, const void* cot_sdf, const void* cot_nab,
    const void* cot_h, int geo_dim, const void* jobs, void* work,
    void* bias_part, int nb, void* part, int n_split, long long total,
    long long bias_flat_off, int n_out_tiles, int blocks, void* slopes,
    void* flat, void* xbar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = ntt_nablas_backward_smem_bytes(c_pad, rows);
  cudaError_t err;
  ntt::tc::Mlp m{static_cast<const float*>(params), (size_t)plane,
                 static_cast<const int*>(meta), n_layers, in_ch, c_pad, rows};
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  const int Mtiles = (M + ntt::BWD_TILE - 1) / ntt::BWD_TILE;
  const long long* J = static_cast<const long long*>(jobs);
  float* W = static_cast<float*>(work);
  float* BP = static_cast<float*>(bias_part);
  float* P = static_cast<float*>(part);
  auto tile_kernel = act == ntt::ACT_SINE ? ntt::backward_tile_kernel<ntt::ACT_SINE>
                                              : ntt::backward_tile_kernel<ntt::ACT_SOFTPLUS>;
  tile_kernel<<<blocks, ntt::THREADS, smem, st>>>(
      m, static_cast<const float*>(x), M, Mtiles,
      static_cast<const float*>(cot_sdf), static_cast<const float*>(cot_nab),
      static_cast<const float*>(cot_h), geo_dim, J, W, BP, nb,
      static_cast<float*>(slopes), static_cast<float*>(xbar));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ntt::outer_sum_kernel<<<dim3(n_out_tiles, n_split), ntt::RED_THREADS, 0, st>>>(
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
