// Surface-MLP forward + input gradient (nablas) — one CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel `_make_nablas_kernel` of
// neurecon_tpu/ops/fused_nablas.py (entry `fused_forward_with_nablas`).
// For each point: sdf, the geometry features (final-layer rows 1..), and
// d sdf / dx by a hand-written reverse sweep g <- (g * phi'(a_l)) W_l (skip
// split by 1/sqrt(2)) ending in the positional-encoding pullback. phi is
// Softplus(beta = 100), phi' = sigmoid(100 a), or the SIREN sine sin(30 a),
// phi' = 30 cos(30 a) (a launch argument; a SIREN point costs 328,704
// multiply-adds and 1,280 sincosf at D=5, W=256).
//
// What bounds it: arithmetic. At the flagship widths a point costs about
// 2 MFLOP (forward plus reverse sweep) against 16 bytes of input and 1 KB of
// output, far above the card's fp32 ridge point.
//
// Design. One block of 256 threads works on a tile of 16 points at a time.
// The reverse sweep needs every hidden layer's activation slope; the TPU
// kernel kept them in VMEM. Here they are stored, not recomputed: D x wmax x
// 16 floats (128 KB at D=8, W=256) in a device-memory scratch of the block's
// own, reused from tile to tile by a persistent grid (as many blocks as are
// resident at once; ~50 MB in all, so it stays mostly in L2). Shared memory
// then holds two activation buffers and the weight stage, ~69 KB, and three
// blocks share an SM to hide the latency of the weight stream: weights (W^T
// for the forward, W for the reverse sweep, ~2.1 MB fp32 each) stream from
// L2 through the double-buffered shared-memory stage of surface_mlp.cuh,
// each weight used for 16 FMAs. (Until the port's second slice the slopes
// sat in shared memory, one block per SM.) A faster kernel (tensor cores,
// more points per weight load) is later work.
#include "surface_mlp.cuh"

namespace ntt {

// Point tile T, with the block's shared memory at `xs` and its slope
// scratch at `deriv` ([D][wmax][TILE]); ACT the hidden activation.
template <int ACT>
__device__ __forceinline__ void
nablas_forward_tile(const Mlp& m, const float* __restrict__ x, int M,
                    float* __restrict__ sdf, float* __restrict__ nablas,
                    float* __restrict__ hgeo, int geo_dim, int T, float* deriv,
                    float* xs) {                 // xs: [4][TILE]
  float* emb = xs + 4 * TILE;                    // [in_ch][TILE]
  float* bufA = emb + m.in_ch * TILE;            // [wmax][TILE]
  float* bufB = bufA + m.wmax * TILE;            // [wmax][TILE]
  float* stage = bufB + m.wmax * TILE;           // STAGE_FLOATS
  const int D = m.n_layers - 1;
  const long p0 = (long)T * TILE;

  for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
    const int c = idx / TILE, p = idx % TILE;
    xs[idx] = (p0 + p < M) ? x[(p0 + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  embed_tile(m, xs, emb);
  __syncthreads();
  float* h = hidden_forward<ACT>(m, emb, bufA, bufB, deriv, stage);

  // final layer: sdf (row 0) and geometry features (rows 1..), straight out
  const Layer LD = layer_of(m, D);
  {
    float acc[2][4][4];
    staged_product<2>(LD.wT, LD.in_dim, LD.ld_wT, h, stage, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = 4 * (col_group() + 64 * j) + c;
        if (o >= LD.out_dim) continue;
        const float bias = __ldg(LD.b + o);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const long pt = p0 + 4 * point_group() + p;
          if (pt >= M) continue;
          const float z = acc[j][c][p] + bias;
          if (o == 0) sdf[pt] = z;
          else hgeo[pt * geo_dim + (o - 1)] = z;
        }
      }
  }

  // reverse sweep: g starts as d sdf / d h_D = W_D[0, :]
  float* g = (h == bufA) ? bufB : bufA;
  float* other = h;
  for (int idx = threadIdx.x; idx < LD.in_dim * TILE; idx += blockDim.x)
    g[idx] = __ldg(LD.w + idx / TILE);
  float* gemb = emb;  // the encoding is not needed any more
  for (int idx = threadIdx.x; idx < m.in_ch * TILE; idx += blockDim.x)
    gemb[idx] = 0.f;
  __syncthreads();

  for (int l = D - 1; l >= 0; --l) {
    const Layer L = layer_of(m, l);
    const float* dl = deriv + (size_t)l * m.wmax * TILE;
    for (int idx = threadIdx.x; idx < L.out_dim * TILE; idx += blockDim.x)
      g[idx] *= dl[idx];
    __syncthreads();
    {
      // g_in[i][p] = sum_o g[o][p] * W[o][i]: the reverse of layer l
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
      for (int idx = threadIdx.x; idx < m.in_ch * TILE; idx += blockDim.x)
        gemb[idx] += other[idx];
    } else if (L.skip) {
      const int h_dim = L.in_dim - m.in_ch;
      for (int idx = threadIdx.x; idx < L.in_dim * TILE; idx += blockDim.x) {
        const float v = other[idx] / 1.41421356237f;
        if (idx < h_dim * TILE) other[idx] = v;
        else gemb[idx - h_dim * TILE] += v;
      }
    }
    __syncthreads();
    float* t = g;
    g = other;
    other = t;
  }

  // encoding pullback: d emb / d x_c = 1, f cos(f x_c), -f sin(f x_c)
  for (int idx = threadIdx.x; idx < 3 * TILE; idx += blockDim.x) {
    const int p = idx / 3, c = idx % 3;
    if (p0 + p >= M) continue;
    const float xc = xs[c * TILE + p];
    float n = gemb[c * TILE + p];
    for (int f = 0; f < m.multires; ++f) {
      const float fr = ldexpf(1.f, f);
      const float ph = xc * fr;
      const float gs = gemb[(3 + 6 * f + c) * TILE + p];
      const float gc = gemb[(3 + 6 * f + 3 + c) * TILE + p];
      n += fr * (gs * cosf(ph) - gc * sinf(ph));
    }
    nablas[(p0 + p) * 3 + c] = n;
  }
}

template <int ACT>
__global__ void __launch_bounds__(THREADS, 3)
nablas_forward_kernel(Mlp m, const float* __restrict__ x, int M,
                      float* __restrict__ sdf, float* __restrict__ nablas,
                      float* __restrict__ hgeo, int geo_dim, float* slopes) {
  extern __shared__ float4 smem4[];
  float* deriv = slopes + (size_t)blockIdx.x * (m.n_layers - 1) * m.wmax * TILE;
  const int tiles = (M + TILE - 1) / TILE;
  for (int T = blockIdx.x; T < tiles; T += gridDim.x) {
    nablas_forward_tile<ACT>(m, x, M, sdf, nablas, hgeo, geo_dim, T, deriv,
                        reinterpret_cast<float*>(smem4));
    __syncthreads();  // the next tile overwrites shared memory
  }
}

}  // namespace ntt

extern "C" size_t ntt_nablas_forward_smem_bytes(int in_ch, int wmax) {
  return ntt::mlp_smem_floats(in_ch, wmax) * sizeof(float);
}

// Blocks of the persistent grid for M points: as many as are resident on the
// card at once, at most one per tile (the caller sizes the slope scratch,
// blocks x (n_layers - 1) x wmax x 16 floats, by it). Returns a negative
// cudaError_t on failure.
extern "C" int ntt_nablas_forward_blocks(int in_ch, int wmax, int M) {
  const size_t smem = ntt_nablas_forward_smem_bytes(in_ch, wmax);
  cudaError_t err = cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  bool first = true;
  for (auto kernel : {ntt::nablas_forward_kernel<ntt::ACT_SOFTPLUS>,
                      ntt::nablas_forward_kernel<ntt::ACT_SINE>}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int n = 0;  // the fewer of the two instantiations' resident blocks
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, ntt::THREADS, smem);
    per_sm = first || n < per_sm ? n : per_sm;
    first = false;
  }
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (M + ntt::TILE - 1) / ntt::TILE;
  return per_sm * sms < tiles ? per_sm * sms : tiles;
}

// x [M,3] -> sdf [M], nablas [M,3], hgeo [M,geo_dim]; all fp32, contiguous,
// on the device; `slopes` is scratch for `blocks` blocks (from
// ntt_nablas_forward_blocks, which also sets the kernel's attributes); `act`
// the hidden layers' activation (ACT_SOFTPLUS or ACT_SINE). Returns the
// cudaError_t of the launch.
extern "C" int ntt_nablas_forward(const void* x, int M, const void* params,
                                  const void* meta, int n_layers, int in_ch,
                                  int multires, int wmax, int act, void* sdf,
                                  void* nablas, void* hgeo, int geo_dim,
                                  int blocks, void* slopes, void* stream) {
  if (M <= 0) return 0;
  const size_t smem = ntt_nablas_forward_smem_bytes(in_ch, wmax);
  ntt::Mlp m{static_cast<const float*>(params), static_cast<const int*>(meta),
             n_layers, in_ch, multires, wmax};
  if (act != ntt::ACT_SOFTPLUS && act != ntt::ACT_SINE) return (int)cudaErrorInvalidValue;
  auto kernel = act == ntt::ACT_SINE ? ntt::nablas_forward_kernel<ntt::ACT_SINE>
                                     : ntt::nablas_forward_kernel<ntt::ACT_SOFTPLUS>;
  kernel<<<blocks, ntt::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const float*>(x), M, static_cast<float*>(sdf),
      static_cast<float*>(nablas), static_cast<float*>(hgeo), geo_dim,
      static_cast<float*>(slopes));
  return (int)cudaGetLastError();
}
