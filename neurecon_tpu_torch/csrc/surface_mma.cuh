// Split-fp32 ("3xTF32") tensor-core layer products of the surface MLP over a
// tile of P points held in shared memory, and the device routines around
// them, shared by the surface-MLP kernels: the forward + nablas
// (nablas_forward.cu), the NeuS upsampler (neus_upsample.cu), the eikonal
// backward's tile pass (nablas_backward.cu) and the sdf-only forward's wide
// and cluster tiles (sdf_forward.cu; its narrow tile runs wgmma,
// wgmma_tf32.cuh).
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
// MMAs chained into one accumulator drift toward zero: chained so, kernel
// 4's narrow tile read 1.6e-5 of max|sdf| on the card when it ran this
// product, past its 1e-5 check. So each k-step's
// three MMAs go into a fresh fragment, and that is added to the running
// fp32 sum on the CUDA cores (round to nearest): one FADD per accumulator
// and k-step. The sums then keep fp32 accuracy (a single TF32 product misses
// kernel 4's check, see tools/mutants.py). The activations are split in
// registers as each A fragment is loaded. The weights are split once, in
// the pack (a big and a small plane beside the fp32 one): a product that
// stages both parts (PRESPLIT) saves the B fragments' splits, which 4
// warps repeat for every fragment they share, at twice the stage's shared
// memory; the narrow forward kernels have that room, the backward has not and
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
//
// The cluster tile (`Cluster`), for padded hidden widths and final-layer
// rows up to 1024: a 1024-wide activation buffer at 64 points takes 295 KB,
// past one block's 227 KB, so two blocks of the wide tile's shape, a
// thread-block cluster on two SMs (launched with cluster dims (2, 1, 1)),
// take the same 64 points. Each holds half of every activation block's
// rows, [r H, r H + H) in block r, H = pair_rows(rows) <= 512, and computes
// the same half of every layer's output columns, so a layer's output lands
// where the next layer's input rows are read. The product streams this
// block's weight columns and reads each k-step's A fragments through a
// generic pointer to the block that holds its rows: its own shared memory,
// or the peer's through distributed shared memory (`mapa`); a k-step lies
// in one block, H being a multiple of 8. The output still overwrites the
// input in place: the pair meets at a cluster barrier before a block writes
// its half (the peer may still be reading it) and again before the next
// product reads it. A
// final-layer product takes rows [0, 512) in block 0 and the rest in block
// 1, as its outputs go straight to device memory. Per-point sums over the
// rows (kernels 1 and 3's encoding gradient) add the two blocks' halves;
// block 0 writes the tile's per-point outputs. Every member of `Part` for a
// lone block (Narrow, Wide) is the constant that leaves its code as it was.
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
  static constexpr int CL = 1;                  // blocks a tile
};
using Narrow = Tile<128, 4>;  // padded hidden widths <= 256
using Wide = Tile<64, 8>;     // padded hidden widths and final-layer rows <= 512
// padded hidden widths and final-layer rows <= 1024: a pair of Wide blocks
struct Cluster : Wide {
  static constexpr int CL = 2;
};

// Rows of every activation block that each block of a Cluster pair holds,
// for `rows` rows in all: half, rounded up to a whole k-step of 8.
__host__ __device__ constexpr int pair_rows(int rows) { return (rows + 15) / 16 * 8; }

// Rows of the activation buffer in one block's shared memory.
template <class T>
__host__ __device__ constexpr int held_rows(int rows) {
  return T::CL == 2 ? pair_rows(rows) : rows;
}

// The input rows of a Cluster pair's product, V [K][LDV]: rows [lo, lo + n)
// in this block's shared memory at `own`, the others from row `plo` on in
// the other block's at `peer` (a generic address of distributed shared
// memory).
struct Halves {
  const float* own;
  const float* peer;
  int lo, n, plo;
  __device__ bool mine(int k) const { return (unsigned)(k - lo) < (unsigned)n; }
};

template <int LDV>
__device__ __forceinline__ const float* row_at(const float* V, int k) {
  return V + (size_t)k * LDV;
}
template <int LDV>
__device__ __forceinline__ const float* row_at(const Halves& V, int k) {
  return V.mine(k) ? V.own + (size_t)(k - V.lo) * LDV : V.peer + (size_t)(k - V.plo) * LDV;
}

// The generic address of `p` (this block's shared memory) in the shared
// memory of block `rank` of the cluster.
__device__ __forceinline__ const float* cluster_map(const float* p, unsigned rank) {
  unsigned long long q;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(q) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(q);
}

// Every thread of both blocks of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are seen by the peer after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;\n" :::
               "memory");
}

// This block's part of its tile: the rows it holds of every activation
// block, the output columns its products compute, the tiles it walks, and
// how it meets the other block of a Cluster pair. A lone block holds every
// row and meets no one.
template <class T, bool PAIR = (T::CL == 2)>
struct Part {
  __device__ explicit Part(int) {}
  __device__ int lo() const { return 0; }            // first row held (and column computed)
  __device__ int cols(int n) const { return n; }     // rows held of rows [0, n)
  __device__ bool holds(int) const { return true; }
  __device__ bool lead() const { return true; }      // writes the tile's per-point outputs
  __device__ unsigned slot() const { return blockIdx.x; }  // first tile; the block's scratch slot
  __device__ unsigned slots() const { return gridDim.x; }  // tiles walked at once
  __device__ int final_lo() const { return 0; }      // first final-layer row of its product
  __device__ int final_cols(int n) const { return n; }
  __device__ void meet() const {}                    // the pair's barrier
  __device__ void sync() const { __syncthreads(); }  // the block's, or the pair's
  template <class Q>
  __device__ Q* src(Q* buf) const { return buf; }
  template <class Q>
  __device__ Q* local(Q* v) const { return v; }
  __device__ float merged(const float* a, int at) const { return a[at]; }
};

template <class T>
struct Part<T, true> {
  int rank, H;
  __device__ explicit Part(int rows) : H(pair_rows(rows)) {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    rank = (int)r;
  }
  __device__ int lo() const { return rank * H; }
  __device__ int cols(int n) const { return min(max(n - rank * H, 0), H); }
  __device__ bool holds(int r) const { return r >= rank * H && r < rank * H + H; }
  __device__ bool lead() const { return rank == 0; }
  __device__ unsigned slot() const { return blockIdx.x >> 1; }
  __device__ unsigned slots() const { return gridDim.x >> 1; }
  __device__ int final_lo() const { return rank * T::NMAX; }
  __device__ int final_cols(int n) const { return min(max(n - rank * T::NMAX, 0), T::NMAX); }
  __device__ void meet() const { cluster_sync(); }
  __device__ void sync() const { cluster_sync(); }
  __device__ Halves src(const float* buf) const {
    return {buf, cluster_map(buf, rank ^ 1), rank * H, H, (rank ^ 1) * H};
  }
  __device__ Halves local(const float* v) const { return {v, v, 0, 1 << 30, 0}; }
  __device__ float merged(const float* a, int at) const {
    return a[at] + cluster_map(a, rank ^ 1)[at];
  }
};

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
// done with V and the stage (so the caller may overwrite V; a Cluster pair
// meets first, `Part::meet`, as the peer reads V too). V is a pointer, or
// for a Cluster pair its Halves: each k-step's rows from this block's
// shared memory or the peer's (`row_at`).
template <class T, int KC, int NBUF, bool PRESPLIT, class Src>
__device__ __forceinline__ void product(const float* __restrict__ M, size_t plane, int K,
                                        int N, int ld, Src V, float* stage, Acc<T>& acc) {
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
      const float* Vk = row_at<LDV>(V, ch * KC + 8 * s) + pw + g;
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
// rows out_dim..N-1 get 0; a Cluster block its rows, `pt`); with `slope`
// ([N][P], device memory, every row) also its
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
                                               float* slope, const Part<T>& pt) {
  constexpr int P = T::P, LDV = T::LDV;
  each_output<T>(acc, pt.cols(L.N), [&](int o, int p, float a) {
    float v = 0.f, s = 0.f;
    const int og = pt.lo() + o;  // the layer's output row
    if (og < L.out_dim) {
      if constexpr (ACT == ACT_SINE) {
        const float y = SIREN_W0 * (a + __ldg(L.b + og));
        if (slope) {
          float cs;
          sincosf(y, &v, &cs);
          s = SIREN_W0 * cs;
        } else {
          v = sinf(y);
        }
      } else {
        const float y = 100.f * (a + __ldg(L.b + og));
        v = (y > 20.f ? y : log1pf(expf(y))) / 100.f;
        s = 1.f / (1.f + expf(-y));
      }
    }
    out[o * LDV + p] = v;
    if (slope) slope[og * P + p] = s;
  });
}

// The skip layer's input in `buf`: h is in rows [0, h_dim), h_dim = in_dim
// - in_ch; the encoding `emb` goes to rows [h_dim, h_dim + in_ch), zeros to
// the padded rows up to K, then all K rows are divided by sqrt(2), as the
// plain forward does (a Cluster block its own rows; the pair meets after).
template <class T>
__device__ __forceinline__ void skip_input(const Mlp& m, const Layer& L, const float* emb,
                                           float* buf, const Part<T>& pt) {
  constexpr int P = T::P, LDV = T::LDV;
  const int h_dim = L.in_dim - m.in_ch;
  for (int idx = threadIdx.x; idx < (L.K - h_dim) * P; idx += T::THREADS) {
    const int c = idx / P, p = idx % P;
    if (pt.holds(h_dim + c))
      buf[(h_dim + c - pt.lo()) * LDV + p] = c < m.in_ch ? emb[c * LDV + p] : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < pt.cols(L.K) * P; idx += T::THREADS) {
    float* cat = buf + (idx / P) * LDV + idx % P;
    *cat = *cat / 1.41421356237f;
  }
  pt.sync();
}

// Row `row` of the final layer at the tile's point p, on the CUDA cores in
// fp32: sum_k V[k][p] W_D[row][k] + b_D[row], with V the layer's input
// ([K][LDV], or a Cluster pair's Halves, whose 4-row groups each lie in one
// block; W_D's row is K floats of its [N][K] block, padded entries zero
// on both sides). The sdf row, and the final layer's outputs past the
// product's T::NMAX columns.
template <class T, class Src>
__device__ __forceinline__ float final_row(const Layer& L, int row, Src V, int p) {
  constexpr int LDV = T::LDV;
  const float* w = L.w + (size_t)row * L.K;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int k = 0; k < L.K; k += 4) {
    if constexpr (T::CL == 1) {
      s0 += V[k * LDV + p] * __ldg(w + k);
      s1 += V[(k + 1) * LDV + p] * __ldg(w + k + 1);
      s2 += V[(k + 2) * LDV + p] * __ldg(w + k + 2);
      s3 += V[(k + 3) * LDV + p] * __ldg(w + k + 3);
    } else {
      const float* v = row_at<LDV>(V, k) + p;
      s0 += v[0] * __ldg(w + k);
      s1 += v[LDV] * __ldg(w + k + 1);
      s2 += v[2 * LDV] * __ldg(w + k + 2);
      s3 += v[3 * LDV] * __ldg(w + k + 3);
    }
  }
  return ((s0 + s1) + (s2 + s3)) + __ldg(L.b + row);
}

// The reverse product of layer L in a sweep: g_in = g W over `buf` (depth K
// = the layer's padded outputs, N = its padded inputs), written back over
// it. Ends synchronised (a Cluster pair: both blocks' halves written).
template <class T, int KC, int NBUF, bool PRESPLIT>
__device__ __forceinline__ void reverse_product(const Mlp& m, const Layer& L, float* buf,
                                                float* stage, const Part<T>& pt) {
  constexpr int LDV = T::LDV;
  Acc<T> acc;
  product<T, KC, NBUF, PRESPLIT>(L.w + pt.lo(), m.plane, L.N, pt.cols(L.K), L.K, pt.src(buf),
                                 stage, acc);
  pt.meet();
  each_output<T>(acc, pt.cols(L.K), [&](int i, int p, float v) { buf[i * LDV + p] = v; });
  pt.sync();
}

// After the reverse product of layer l (`buf` holds the gradient at its
// input): layer 0's input is the encoding, whose rows are added to g_e
// (`ge`, [c_pad][LDV]); a skip layer's input [h, e] / sqrt(2) splits, its h
// rows staying in `buf` and its encoding rows added to g_e, both divided by
// sqrt(2). A Cluster block adds its own rows to its own g_e (the tile's is
// the two blocks' sum, `Part::merged`). Ends synchronised (the block).
template <class T>
__device__ __forceinline__ void pull_input(const Mlp& m, const Layer& L, int l, float* buf,
                                           float* ge, const Part<T>& pt) {
  constexpr int P = T::P, LDV = T::LDV;
  const float inv_sqrt2 = 1.f / 1.41421356237f;
  const int C = m.in_ch;
  if (l == 0) {
    for (int idx = threadIdx.x; idx < pt.cols(C) * P; idx += T::THREADS) {
      const int at = (idx / P) * LDV + idx % P;
      ge[at + pt.lo() * LDV] += buf[at];
    }
  } else if (L.skip) {
    const int h_dim = L.in_dim - C;
    for (int idx = threadIdx.x; idx < pt.cols(L.in_dim) * P; idx += T::THREADS) {
      const int r = idx / P, p = idx % P, rg = pt.lo() + r;  // local and layer rows
      const float v = buf[r * LDV + p] * inv_sqrt2;
      if (rg < h_dim) buf[r * LDV + p] = v;
      else ge[(rg - h_dim) * LDV + p] += v;
    }
  }
  __syncthreads();
}

// ---- host side: the shared-memory attributes, occupancy and launch of a
// tile's kernel

// Sets `kernel`'s dynamic shared-memory cap to the card's opt-in maximum
// (`optin` bytes; so it never needs raising for a larger shape) and its
// carveout to the most shared memory, then counts the blocks resident on
// the card at once at `smem` bytes a block into `blocks`: blocks an SM x
// `sms` for a lone block's tile; for a Cluster pair twice the pairs the card
// can place at once (cudaOccupancyMaxActiveClusters: a pair takes two SMs
// of one GPC).
template <class T, class Kernel>
inline cudaError_t resident(Kernel kernel, size_t smem, int optin, int sms, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int n = 0;
  if constexpr (T::CL == 1) {
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::THREADS, smem);
    *blocks = n * sms;
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = T::CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(T::CL);
    cfg.blockDim = dim3(T::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
    *blocks = T::CL * n;
  }
  return err;
}

// f(T{}) for the tile of code `tile` as the launches take it
// (ops/surface_pack.py: 0 Narrow, 1 Wide, 2 Cluster).
template <class F>
inline auto by_tile(int tile, F&& f) {
  if (tile == 2) return f(Cluster{});
  if (tile == 1) return f(Wide{});
  return f(Narrow{});
}

// Launches `kernel` on `blocks` blocks of T::THREADS (a Cluster's in pairs:
// `blocks` even, cluster dims (2, 1, 1)); returns the launch's cudaError_t.
template <class T, class... Params, class... Args>
inline cudaError_t launch(void (*kernel)(Params...), int blocks, size_t smem,
                          cudaStream_t stream, Args... args) {
  if constexpr (T::CL == 1) {
    kernel<<<blocks, T::THREADS, smem, stream>>>(args...);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = T::CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(T::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

}  // namespace tc
}  // namespace ntt
