// Split-fp32 ("3xTF32") tensor-core layer products of the surface MLP over a
// tile of P points held in shared memory, and the device routines around
// them, shared by every surface-MLP kernel: the sdf-only forward
// (sdf_forward.cu), the forward + nablas (nablas_forward.cu), the NeuS
// upsampler (neus_upsample.cu) and the eikonal backward's tile pass
// (nablas_backward.cu).
//
// The product. out[p][n] = sum_k V[p][k] * M[k][n] for the tile's P points,
// with V an activation block in shared memory and M a weight block in device
// memory, [K][ld] row-major, its first N columns: W^T (the forward, through
// a layer) or W (the reverse sweeps). Both orientations are in the pack (ops/surface_pack.py),
// so the product never transposes. The product runs on
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`, rows = points,
// columns = outputs, depth = inputs.
//
// Precision. A TF32 operand keeps 10 of fp32's 23 mantissa bits. Each
// operand x is split into big = rna(x) and small = rna(x - big) (rna:
// cvt.rna.tf32.f32's rounding, done in integer arithmetic; x - big is exact
// in fp32), and each product
// accumulates small_a big_b + big_a small_b + big_a big_b, the small terms
// first; small_a small_b (~2^-22 of the product) is dropped. The tensor
// cores add into their fp32 accumulator with truncation, so a layer's 96
// MMAs chained into one accumulator drift toward zero: the chained mutant
// of tools/mutants.py puts kernel 4 at 1.6e-5 of max|sdf| on the card,
// past its 1e-5 check. So each k-step's
// three MMAs go into a fresh fragment, and that is added to the running
// fp32 sum on the CUDA cores (round to nearest): one FADD per accumulator
// and k-step. The sums then keep fp32 accuracy (a single TF32 product misses
// kernel 4's check, see tools/mutants.py). The activations are split in
// registers as each A fragment is loaded. The weights are split once, in
// the pack (a big and a small plane beside the fp32 one): a product that
// stages both parts (PRESPLIT) saves the B fragments' splits, which 4
// warps repeat for every fragment they share, at twice the stage's shared
// memory; the sdf-only kernel has that room, the backward has not and
// splits the fp32 stage in registers.
//
// Layout. Activations are feature-major, [rows][LDV] with LDV = P + 8
// floats, so the A fragments' loads (lanes over 8 points x 4 inputs) fall
// in 32 distinct banks. A layer's rows are padded to multiples of 8 (the
// MMA's k and n) by the pack: the encoding's 39 channels are 40 rows, layer
// 3's 217 outputs 224 (rows 217-223 written as zeros), and a skip layer's
// input [h, encoding] is 217 + 39 = 256 rows, the encoding right after h;
// padded rows hold zeros and meet zero weights.
// Weights stream from L2 through a shared-memory stage of NBUF chunks of KC
// rows (row stride SLD, again conflict-free for the B fragments) with
// cp.async, one barrier a chunk, so every weight is fetched once per tile
// of P points.
//
// Work split. P / 32 point groups x CG column groups of warps: warp w takes
// 32 points from 32 (w % (P / 32)) and 64 columns from 64 (w / (P / 32)),
// i.e. 2 m-tiles x 8 n-tiles; its accumulators (2 x 8 x 4 floats) stay in
// registers, so a layer's output may overwrite its input buffer once every
// warp has passed the product's closing barrier. Not 8 warps of 4 m-tiles:
// two warps a scheduler do not hide the latencies of the fragment loads,
// splits and MMAs, and 4 m-tiles need more than the 128 registers a thread
// of 512 may have.
//
// Two tile shapes (`Tile`), picked per surface at launch (ops/surface_pack.py
// records which): the narrow tiles, CG = 4 (products of up to 256 outputs)
// on 128 points (or 64, kernel 2's small blocks), for every surface whose
// padded hidden widths are at most 256; and the wide tile, CG = 8 on 64
// points (512 threads, the same 32-point x 64-column accumulators per warp),
// for hidden widths and final-layer rows up to 512. At 128 points a
// 512-wide activation buffer alone would take 278 KB; at 64 points it takes
// 147 KB, and every column of a layer is still in registers when the
// product's closing barrier passes, so layers stay in place. The wide
// kernels stage the fp32 plane and split it in registers (a stage of both
// parts at SLD = 520 does not fit beside the buffer). The narrow
// instantiations are the kernels of the W <= 256 surfaces unchanged.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "activation.cuh"

namespace ntt {
namespace tc {

constexpr int META = 8;       // ints per layer record of the pack

// A tile of P_ points: P_ / 32 point groups x CG_ column groups of warps.
template <int P_, int CG_>
struct Tile {
  static_assert(P_ == 64 || P_ == 128, "tiles of 64 or 128 points");
  static_assert(CG_ == 4 || CG_ == 8, "4 or 8 column groups");
  static constexpr int P = P_;
  static constexpr int CG = CG_;
  static constexpr int MT = 2;                  // m-tiles of 16 points per warp
  static constexpr int PG = P / 32;             // point groups of warps
  static constexpr int THREADS = 32 * CG * PG;  // threads per block
  static_assert(THREADS <= 512, "at most 512 threads a block");
  static constexpr int LDV = P + 8;             // activation row stride in floats
  static constexpr int NMAX = 64 * CG;          // widest product output
  static constexpr int SLD = NMAX + 8;          // stage row stride in floats (== 8 mod 32)
};
using Narrow = Tile<128, 4>;  // padded hidden widths <= 256
using Wide = Tile<64, 8>;     // padded hidden widths and final-layer rows <= 512

// Floats of a weight stage of NBUF chunks of KC rows: the big and small
// planes (PRESPLIT), or the fp32 plane.
template <class T>
constexpr int stage_floats(int KC, int NBUF, bool PRESPLIT) {
  return (PRESPLIT ? 2 : 1) * NBUF * KC * T::SLD;
}

// The pack (ops/surface_pack.py): per layer W^T [K][N], W [N][K] and b [N],
// K and N the input and output counts padded to 8, in three planes (fp32,
// its TF32 big parts, their small remainders) at the same offsets; and one
// record of META int32: K, N, out_dim, in_dim, offset of W^T, of W, of b,
// skip flag (the input is [h, encoding] / sqrt(2), h in rows
// [0, in_dim - in_ch)).
struct Mlp {
  const float* params;  // the fp32 plane; the big and small planes follow
  size_t plane;         // floats of one plane
  const int* meta;
  int n_layers;  // D + 1
  int in_ch;     // encoding channels (3 + 6 multires)
  int c_pad;     // encoding rows (in_ch padded to 8)
  int rows;      // rows of the activation buffer (widest padded K or N)
};

struct Layer {
  int K, N, out_dim, in_dim, skip;
  const float* wT;  // [K][N]
  const float* w;   // [N][K]
  const float* b;   // [N]
};

__device__ __forceinline__ Layer layer_of(const Mlp& m, int l) {
  const int* r = m.meta + l * META;
  Layer L;
  L.K = __ldg(r + 0);
  L.N = __ldg(r + 1);
  L.out_dim = __ldg(r + 2);
  L.in_dim = __ldg(r + 3);
  L.wT = m.params + __ldg(r + 4);
  L.w = m.params + __ldg(r + 5);
  L.b = m.params + __ldg(r + 6);
  L.skip = __ldg(r + 7);
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 on a finite x: keep 10 of the 23 mantissa bits, round to
// nearest, ties away from zero. Adding half of the 13 dropped bits to the
// bit pattern rounds the magnitude (the sign bit is apart); the mask drops
// them. (ptxas expands the cvt instruction itself into more instructions,
// with checks for inf and NaN that finite data never needs.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small + O(2^-22 |x|), both TF32 values in fp32 registers.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d = a b on one 16x8x8 TF32 tile (fragment layouts of the PTX ISA).
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += a b on one 16x8x8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class T>
using Acc = float[T::MT][8][4];

// acc[i][j][e] = sum_{k < K} V[k][p] M[k][n] for the warp's (p, n) of
// fragment element (i, j, e) (see each_output), with M a weight block of
// the pack's fp32 plane, [K][ld] of which the first N columns are read
// (K % 8 == 0, N % 8 == 0, N <= T::NMAX, ld % 4 == 0, rows 16-byte aligned), whose TF32 big and small parts lie `plane` and 2 `plane`
// floats on, and V in shared memory as [K][LDV]; `stage` holds NBUF chunks
// of KC weight rows, both parts. Each k-step's three MMAs go into a fresh
// fragment that is then added to the accumulator on the CUDA cores (see the
// note on precision). Every thread of the block must call it: it
// synchronises, and it returns after a barrier that every warp reaches once
// done with V and the stage (so the caller may overwrite V).
template <class T, int KC, int NBUF, bool PRESPLIT>
__device__ __forceinline__ void product(const float* __restrict__ M, size_t plane, int K,
                                        int N, int ld, const float* V, float* stage,
                                        Acc<T>& acc) {
  static_assert(KC % 8 == 0 && NBUF >= 2, "chunks of whole k-steps, two buffers or more");
  constexpr int MT = T::MT, LDV = T::LDV, SLD = T::SLD, CH = KC * SLD;
  constexpr int PARTS = PRESPLIT ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pw = (warp % T::PG) * 32, nw = (warp / T::PG) * 64;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nch = (K + KC - 1) / KC, n4 = N / 4;
  auto fetch = [&](int ch) {  // always commits, so the group count is uniform
    if (ch < nch) {
      const int n = min(KC, K - ch * KC) * n4;
      float* dst = stage + (ch % NBUF) * PARTS * CH;  // big plane, then small
      const float* src = M + (PRESPLIT ? plane : 0) + (size_t)ch * KC * ld;
      for (int idx = threadIdx.x; idx < n; idx += T::THREADS) {
        const int r = idx / n4, c = idx - r * n4;
        cp_async16(dst + r * SLD + 4 * c, src + (size_t)r * ld + 4 * c);
        if (PRESPLIT)
          cp_async16(dst + CH + r * SLD + 4 * c, src + plane + (size_t)r * ld + 4 * c);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < NBUF - 1; ++ch) fetch(ch);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<NBUF - 2>();  // this thread's copies of chunk ch have landed
    __syncthreads();  // everyone's have, and chunk ch - 1's buffer is free
    fetch(ch + NBUF - 1);
    if (nw >= N) continue;
    const int steps = min(KC, K - ch * KC) / 8;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {  // k-steps of 8 rows
      const float* S = stage + (ch % NBUF) * PARTS * CH + 8 * s * SLD + nw + g;
      const float* Vk = V + (size_t)(ch * KC + 8 * s) * LDV + pw + g;
      uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* v = Vk + 16 * i;
        split_tf32(v[t * LDV], a_big[i][0], a_small[i][0]);
        split_tf32(v[t * LDV + 8], a_big[i][1], a_small[i][1]);
        split_tf32(v[(t + 4) * LDV], a_big[i][2], a_small[i][2]);
        split_tf32(v[(t + 4) * LDV + 8], a_big[i][3], a_small[i][3]);
      }
      // All 8 n-tiles, also those at or past N (their stage columns hold
      // stale values, and each_output never reads their sums): one basic
      // block, which lets ptxas interleave the independent MMA chains.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_big[2], b_small[2];
        if (PRESPLIT) {
          b_big[0] = __float_as_uint(S[t * SLD + 8 * j]);
          b_big[1] = __float_as_uint(S[(t + 4) * SLD + 8 * j]);
          b_small[0] = __float_as_uint(S[CH + t * SLD + 8 * j]);
          b_small[1] = __float_as_uint(S[CH + (t + 4) * SLD + 8 * j]);
        } else {
          split_tf32(S[t * SLD + 8 * j], b_big[0], b_small[0]);
          split_tf32(S[(t + 4) * SLD + 8 * j], b_big[1], b_small[1]);
        }
        // small terms first, the m-tiles interleaved so that an MMA does
        // not wait on the one before it
        float d[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_small[i], b_big);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_small);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_big);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][e];
      }
    }
  }
  __syncthreads();
}

// f(n, p, value) for every output element the thread holds, n < N.
template <class T, class F>
__device__ __forceinline__ void each_output(const Acc<T>& acc, int N, F&& f) {
  constexpr int MT = T::MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pw = (warp % T::PG) * 32, nw = (warp / T::PG) * 64;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (nw + 8 * j < N) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(nw + 8 * j + 2 * t + (e & 1), pw + 16 * i + g + 8 * (e >> 1), acc[i][j][e]);
    }
  }
}

// Positional encoding of xs [3][P] into emb [c_pad][LDV]: rows [x, sin(f0
// x), cos(f0 x), sin(f1 x), ...], f_i = 2^i, then zero rows to c_pad.
template <class T>
__device__ __forceinline__ void embed_tile(const Mlp& m, const float* xs, float* emb) {
  constexpr int P = T::P, LDV = T::LDV;
  for (int idx = threadIdx.x; idx < m.c_pad * P; idx += T::THREADS) {
    const int c = idx / P, p = idx % P;
    float v = 0.f;
    if (c < 3) {
      v = xs[c * P + p];
    } else if (c < m.in_ch) {
      const int j = c - 3, f = j / 6, r = j % 6;
      const float ph = xs[(r % 3) * P + p] * ldexpf(1.f, f);
      v = (r < 3) ? sinf(ph) : cosf(ph);
    }
    emb[c * LDV + p] = v;
  }
}

// The activation of the product plus bias, written over `out` ([N][LDV];
// rows out_dim..N-1 get 0); with `slope` ([N][P], device memory) also its
// derivative (0 on the padded rows): Softplus(beta = 100) and sigmoid(100 z),
// or (ACT_SINE) sin(30 z) and 30 cos(30 z). Softplus is the plain version's
// formula (torch's softplus of y = 100 z, threshold 20, over 100), so that
// a pre-activation equal to the plain one gives its output to the bit: the
// NeuS step's gradient turns on the sign of sdf differences between
// sections a few 1e-7 apart (PERF.md). sincosf/sinf, not the fast
// intrinsics: 30 z reaches tens of radians, where __sinf's error grows with
// |x| (the kernels build without --use_fast_math).
template <class T, int ACT>
__device__ __forceinline__ void activation_out(const Layer& L, const Acc<T>& acc, float* out,
                                               float* slope) {
  constexpr int P = T::P, LDV = T::LDV;
  each_output<T>(acc, L.N, [&](int o, int p, float a) {
    float v = 0.f, s = 0.f;
    if (o < L.out_dim) {
      if constexpr (ACT == ACT_SINE) {
        const float y = SIREN_W0 * (a + __ldg(L.b + o));
        if (slope) {
          float cs;
          sincosf(y, &v, &cs);
          s = SIREN_W0 * cs;
        } else {
          v = sinf(y);
        }
      } else {
        const float y = 100.f * (a + __ldg(L.b + o));
        v = (y > 20.f ? y : log1pf(expf(y))) / 100.f;
        s = 1.f / (1.f + expf(-y));
      }
    }
    out[o * LDV + p] = v;
    if (slope) slope[o * P + p] = s;
  });
}

// The skip layer's input in `buf`: h is in rows [0, h_dim), h_dim = in_dim
// - in_ch; the encoding `emb` goes to rows [h_dim, h_dim + in_ch), zeros to
// the padded rows up to K, then all K rows are divided by sqrt(2), as the
// plain forward does.
template <class T>
__device__ __forceinline__ void skip_input(const Mlp& m, const Layer& L, const float* emb,
                                           float* buf) {
  constexpr int P = T::P, LDV = T::LDV;
  const int h_dim = L.in_dim - m.in_ch;
  for (int idx = threadIdx.x; idx < (L.K - h_dim) * P; idx += T::THREADS) {
    const int c = idx / P, p = idx % P;
    buf[(h_dim + c) * LDV + p] = c < m.in_ch ? emb[c * LDV + p] : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L.K * P; idx += T::THREADS) {
    float* cat = buf + (idx / P) * LDV + idx % P;
    *cat = *cat / 1.41421356237f;
  }
  __syncthreads();
}

// Row `row` of the final layer at the tile's point p, on the CUDA cores in
// fp32: sum_k V[k][p] W_D[row][k] + b_D[row], with V the layer's input
// ([K][LDV]; W_D's row is K floats of its [N][K] block, padded entries zero
// on both sides). The sdf row, and the final layer's outputs past the
// product's T::NMAX columns.
template <class T>
__device__ __forceinline__ float final_row(const Layer& L, int row, const float* V, int p) {
  constexpr int LDV = T::LDV;
  const float* w = L.w + (size_t)row * L.K;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int k = 0; k < L.K; k += 4) {
    s0 += V[k * LDV + p] * __ldg(w + k);
    s1 += V[(k + 1) * LDV + p] * __ldg(w + k + 1);
    s2 += V[(k + 2) * LDV + p] * __ldg(w + k + 2);
    s3 += V[(k + 3) * LDV + p] * __ldg(w + k + 3);
  }
  return ((s0 + s1) + (s2 + s3)) + __ldg(L.b + row);
}

// The reverse product of layer L in a sweep: g_in = g W over `buf` (depth K
// = the layer's padded outputs, N = its padded inputs), written back over
// it. Ends synchronised.
template <class T, int KC, int NBUF, bool PRESPLIT>
__device__ __forceinline__ void reverse_product(const Mlp& m, const Layer& L, float* buf,
                                                float* stage) {
  constexpr int LDV = T::LDV;
  Acc<T> acc;
  product<T, KC, NBUF, PRESPLIT>(L.w, m.plane, L.N, L.K, L.K, buf, stage, acc);
  each_output<T>(acc, L.K, [&](int i, int p, float v) { buf[i * LDV + p] = v; });
  __syncthreads();
}

// After the reverse product of layer l (`buf` holds the gradient at its
// input): layer 0's input is the encoding, whose rows are added to g_e
// (`ge`, [c_pad][LDV]); a skip layer's input [h, e] / sqrt(2) splits, its h
// rows staying in `buf` and its encoding rows added to g_e, both divided by
// sqrt(2). Ends synchronised.
template <class T>
__device__ __forceinline__ void pull_input(const Mlp& m, const Layer& L, int l, float* buf,
                                           float* ge) {
  constexpr int P = T::P, LDV = T::LDV;
  const float inv_sqrt2 = 1.f / 1.41421356237f;
  const int C = m.in_ch;
  if (l == 0) {
    for (int idx = threadIdx.x; idx < C * P; idx += T::THREADS) {
      const int at = (idx / P) * LDV + idx % P;
      ge[at] += buf[at];
    }
  } else if (L.skip) {
    const int h_dim = L.in_dim - C;
    for (int idx = threadIdx.x; idx < L.in_dim * P; idx += T::THREADS) {
      const int r = idx / P, p = idx % P;
      const float v = buf[r * LDV + p] * inv_sqrt2;
      if (r < h_dim) buf[r * LDV + p] = v;
      else ge[(r - h_dim) * LDV + p] += v;
    }
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace ntt
