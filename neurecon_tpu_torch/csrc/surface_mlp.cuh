// The surface MLP on a tile of points held in shared memory — the device
// routine shared by the forward+nablas kernel (nablas_forward.cu) and the
// NeuS upsampler kernel (neus_upsample.cu).
//
// Layout. Activations live in shared memory feature-major, [rows][TILE]: one
// row of TILE floats per channel, so the TILE values one weight multiplies are
// read as TILE/4 float4 broadcasts. Weights come from the packed buffer the
// Python wrapper builds: per layer, W^T [in][ld_wT] (the forward's operand)
// and W [out][ld_w] (the reverse sweep's), rows padded to a multiple of 4
// floats, and b [out]. `meta` holds one record of eight int32 per layer:
// in_dim, out_dim, offset of W^T, offset of W, offset of b, skip flag (input
// is concat[h, emb] / sqrt(2)), ld of W^T, ld of W.
//
// Every product out[c][p] = sum_r M[r][c] * V[r][p] streams M through shared
// memory in chunks of KC rows with cp.async, double-buffered, so the block's
// threads read each weight once from L2 per tile and overlap the next
// chunk's copy with this chunk's FMAs. A thread owns a 4-column x 4-point
// block of the output (two such column blocks when a layer is wider than
// 256).
//
// fp32 FMA throughout; no tensor cores yet.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ntt {

constexpr int TILE = 16;       // points per MLP tile
constexpr int THREADS = 256;   // threads per block
constexpr int META = 8;        // ints per layer record
constexpr int KC = 16;         // weight rows per staged chunk
constexpr int STAGE_LD = 264;  // widest padded weight row the stage holds
constexpr int STAGE_FLOATS = 2 * KC * STAGE_LD;

struct Mlp {
  const float* params;  // packed weights
  const int* meta;      // [n_layers][META]
  int n_layers;         // D + 1
  int in_ch;            // embedding width (3 + 6 * multires)
  int multires;         // number of frequency bands
  int wmax;             // rows of an activation buffer (widest hidden layer)
};

struct Layer {
  int in_dim, out_dim;
  const float* wT;  // [in][ld_wT]
  const float* w;   // [out][ld_w]
  const float* b;   // [out]
  int skip, ld_wT, ld_w;
};

__device__ __forceinline__ Layer layer_of(const Mlp& m, int l) {
  const int* r = m.meta + l * META;
  Layer L;
  L.in_dim = __ldg(r + 0);
  L.out_dim = __ldg(r + 1);
  L.wT = m.params + __ldg(r + 2);
  L.w = m.params + __ldg(r + 3);
  L.b = m.params + __ldg(r + 4);
  L.skip = __ldg(r + 5);
  L.ld_wT = __ldg(r + 6);
  L.ld_w = __ldg(r + 7);
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

// Register blocking: thread t owns columns 4*cg .. 4*cg+3 (cg = t % 64, plus
// 64 groups further on for each extra NC) and points 4*pg .. 4*pg+3
// (pg = t / 64). Per weight row it reads one float4 of weights (the warp's
// 32 column groups are one contiguous 512-byte row segment) and one float4
// of activations (a broadcast), for 16 FMAs.
static_assert(TILE == 16 && THREADS == 256, "the blocking assumes 16 x 256");
__device__ __forceinline__ int col_group() { return threadIdx.x % 64; }
__device__ __forceinline__ int point_group() { return threadIdx.x / 64; }

// acc[j][c][p] = sum_{r < rows} M[r][4 (cg + 64 j) + c] * V[r][4 pg + p],
// with M in device memory as [rows][ld] (ld % 4 == 0, ld <= STAGE_LD,
// 16-byte aligned) and V in shared memory as [rows][TILE]. Column groups at
// or past ld are left at 0. Every thread of the block must call it: it
// synchronises.
template <int NC>
__device__ __forceinline__ void staged_product(const float* __restrict__ M,
                                               int rows, int ld,
                                               const float* V, float* stage,
                                               float (&acc)[NC][4][4]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[j][c][p] = 0.f;
  const int nch = (rows + KC - 1) / KC;
  auto issue = [&](int ch) {
    const int n4 = min(KC, rows - ch * KC) * ld / 4;
    const float4* src = reinterpret_cast<const float4*>(M + (size_t)ch * KC * ld);
    float* dst = stage + (ch & 1) * KC * STAGE_LD;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + i);
    cp_async_commit();
  };
  const float* Vp = V + 4 * point_group();
  issue(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      issue(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* S = stage + (ch & 1) * KC * STAGE_LD;
    const int r0 = ch * KC, nr = min(KC, rows - r0);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c0 = 4 * (col_group() + 64 * j);
      if (c0 >= ld) continue;
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(S + r * ld + c0);
        const float4 v = *reinterpret_cast<const float4*>(Vp + (r0 + r) * TILE);
        const float wc[4] = {w.x, w.y, w.z, w.w};
        const float vp[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[j][c][p] += wc[c] * vp[p];
      }
    }
    __syncthreads();  // the stage is refilled two chunks on
  }
}

// Positional encoding of xs [3][TILE] into emb [in_ch][TILE]:
// rows [x, sin(f0 x), cos(f0 x), sin(f1 x), ...], f_i = 2^i.
__device__ __forceinline__ void embed_tile(const Mlp& m, const float* xs,
                                           float* emb) {
  for (int idx = threadIdx.x; idx < m.in_ch * TILE; idx += blockDim.x) {
    const int c = idx / TILE, p = idx % TILE;
    float v;
    if (c < 3) {
      v = xs[c * TILE + p];
    } else {
      const int j = c - 3, f = j / 6, r = j % 6;
      const float ph = xs[(r % 3) * TILE + p] * ldexpf(1.f, f);
      v = (r < 3) ? sinf(ph) : cosf(ph);
    }
    emb[idx] = v;
  }
}

// One hidden layer: out[o][p] = softplus100(sum_k in[k][p] W[o][k] + b[o]);
// with `deriv`, its slope sigmoid(100 z) is kept there for the reverse sweep.
// Hidden layers are at most 256 wide (the wrapper checks).
__device__ __forceinline__ void hidden_tile(const Layer& L, const float* in,
                                            float* out, float* deriv,
                                            float* stage) {
  float acc[1][4][4];
  staged_product<1>(L.wT, L.in_dim, L.ld_wT, in, stage, acc);
  const int c0 = 4 * col_group(), q0 = 4 * point_group();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int o = c0 + c;
    if (o >= L.out_dim) break;
    const float bias = __ldg(L.b + o);
    float y[4], sp[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      y[p] = 100.f * (acc[0][c][p] + bias);
      sp[p] = (fmaxf(y[p], 0.f) + log1pf(expf(-fabsf(y[p])))) / 100.f;
    }
    *reinterpret_cast<float4*>(out + o * TILE + q0) = make_float4(sp[0], sp[1], sp[2], sp[3]);
    if (deriv)
      *reinterpret_cast<float4*>(deriv + o * TILE + q0) =
          make_float4(1.f / (1.f + expf(-y[0])), 1.f / (1.f + expf(-y[1])),
                      1.f / (1.f + expf(-y[2])), 1.f / (1.f + expf(-y[3])));
  }
}

// Hidden layers 0..D-1 on the tile whose encoding is in `emb`. Ping-pongs
// between bufA and bufB; returns the buffer holding h_D (the final layer's
// input). With `deriv` ([D][wmax][TILE]) every layer's activation slope is
// kept. Ends with the block synchronised.
__device__ __forceinline__ float* hidden_forward(const Mlp& m, const float* emb,
                                                 float* bufA, float* bufB,
                                                 float* deriv, float* stage) {
  const float* in = emb;
  float* out = bufA;
  for (int l = 0; l < m.n_layers - 1; ++l) {
    const Layer L = layer_of(m, l);
    if (L.skip) {
      // in holds h (h_dim rows); append the encoding, then scale by 1/sqrt(2)
      float* cat = const_cast<float*>(in);
      const int h_dim = L.in_dim - m.in_ch;
      for (int idx = threadIdx.x; idx < m.in_ch * TILE; idx += blockDim.x)
        cat[h_dim * TILE + idx] = emb[idx];
      __syncthreads();
      for (int idx = threadIdx.x; idx < L.in_dim * TILE; idx += blockDim.x)
        cat[idx] = cat[idx] / 1.41421356237f;
      __syncthreads();
    }
    hidden_tile(L, in, out, deriv ? deriv + (size_t)l * m.wmax * TILE : nullptr,
                stage);
    __syncthreads();
    in = out;
    out = (out == bufA) ? bufB : bufA;
  }
  return const_cast<float*>(in);
}

// The final layer's sdf row alone: sdf[p] = sum_k h[k][p] * W_D[0][k] + b_D[0],
// one warp per point, lanes over k.
__device__ __forceinline__ void sdf_row_tile(const Mlp& m, const float* h,
                                             float* sdf) {
  const Layer L = layer_of(m, m.n_layers - 1);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int p = warp; p < TILE; p += blockDim.x / 32) {
    float s = 0.f;
    for (int k = lane; k < L.in_dim; k += 32) s += h[k * TILE + p] * __ldg(L.w + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sdf[p] = s + __ldg(L.b);
  }
}

// Shared-memory floats of the MLP part of a block: xs [4][TILE] (3 used),
// emb [in_ch][TILE], bufA and bufB [wmax][TILE], the weight stage.
__host__ __device__ inline size_t mlp_smem_floats(int in_ch, int wmax) {
  return (size_t)(4 + in_ch + 2 * wmax) * TILE + STAGE_FLOATS;
}

}  // namespace ntt
