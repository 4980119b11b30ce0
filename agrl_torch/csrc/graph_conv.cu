// Fused eval-mode graph convolution for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels agrl_tpu/ops/graph_conv.py:graph_propagate_pallas
// and agrl_tpu/ops/graph_conv_v2.py:graph_propagate_pallas_v2 (two Pallas
// schedules of one function). Per clip b, with f_b (V, C), adj_b (V, V),
// W (C, C):
//
//   h    = f_b @ W
//   A    = row_l1(adj_b)
//   S    = row_l1(2 * sigmoid(-sqrt(max(d2, 1e-12)))),  d2_ij = |f_i - f_j|^2
//   G    = (A + S) / 2
//   out  = (1 - gamma) f_b + gamma * lrelu_0.1(bn_eval(G @ h))
//
// W arrives as Wt = W^T, i.e. a torch Linear weight (out, in), row-major:
// both operands of f_b @ W are then contiguous along the reduction axis.
//
// Three launches on the caller's stream:
//   gram_partial    grid (B, KS): block (b, s) accumulates the V x V Gram
//                   of f_b over the s-th of KS slices of the channels, in
//                   fp32 registers, into a scratch buffer. Splitting the
//                   channels puts B * KS blocks (128 at B=16) on the card
//                   instead of B.
//   graph_blend     grid (B): one warp per row sums the KS partials in a
//                   fixed order (so d2_ii is exactly 0), forms the l2
//                   affinity, row-normalizes it and the pose adjacency, and
//                   writes G (B, V, V) to scratch.
//   graph_propagate grid (C / CT, B): block (t, b) computes the (V, CT)
//                   tile t of h = f_b @ W with fp32 FMA, keeps it in
//                   shared memory, multiplies by G_b, and applies BN
//                   (running stats), LeakyReLU(0.1) and the convex
//                   residual on the same tile. h never goes to device
//                   memory.
//
// Bound on an H100 SXM (B=16, V=56, C=2048, one call): f@W is
// 2*896*2048^2 = 7.52 GFLOP, the Gram and G@h add 0.21 GFLOP each, ~7.9
// GFLOP in all; the bytes the function must move are W 16.8 MB + f 7.3 MB +
// out 7.3 MB + adj 0.2 MB, ~31.6 MB. At 67 TFLOP/s fp32 (no tensor cores)
// that is ~0.12 ms against ~9.4 us of memory time: the call is bound by
// fp32 operations. The design therefore spends its effort on keeping the
// FMA pipes fed in graph_propagate: f and Wt K-chunks stream into shared
// memory through a 3-stage cp.async pipeline (the next chunks load while
// the current one is multiplied); each thread keeps an R x 8 register tile
// (R = ceil(V/16) rows) and per 4-deep K step reads R + 8 float4 from
// shared memory (row stride KC + 4 makes those reads conflict-free) for
// 32R FMAs. The 256 blocks of the serving shape fit the 132 SMs in one
// wave at two blocks per SM. W is re-read once per clip from L2 (16.8 MB
// fits the 50 MB L2), not from device memory. Reaching the tensor-core
// bound (TF32 or bf16 wgmma, TMA, reading W once per clip group) is later
// work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int KC = 32;         // depth of one staged K chunk
constexpr int RS = KC + 4;     // row stride of K-contiguous tiles: 16-byte rows, no bank conflicts
constexpr int CT = 128;        // output columns per propagate block
constexpr int CPT = CT / 16;   // columns per thread: tx, tx + 16, ..., tx + 112
constexpr int HS = CT + 4;     // row stride of the h tile
constexpr int STAGES = 3;      // cp.async pipeline depth
constexpr int KS_MAX = 8;      // channel slices of the Gram
constexpr float kBnEps = 1e-5f;
constexpr float kNormEps = 1e-12f;

__host__ __device__ constexpr int gram_slices(int C) {
  return (C / KC) % KS_MAX == 0 ? KS_MAX : 4;  // C % 128 == 0: C / KC is a multiple of 4
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- 1. Gram partials ----------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ f, float* __restrict__ partial, int V, int C) {
  constexpr int VP = 16 * R;
  constexpr int FS = VP + 1;  // odd stride: the transposed stores hit distinct banks
  __shared__ float fs[KC * FS];

  const int b = blockIdx.x, slice = blockIdx.y;
  const int kchunk = C / gridDim.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* fb = f + (size_t)b * V * C;

  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;

  for (int k0 = slice * kchunk; k0 < (slice + 1) * kchunk; k0 += KC) {
    for (int idx = threadIdx.x; idx < VP * KC; idx += kThreads) {
      const int v = idx / KC, k = idx % KC;
      fs[k * FS + v] = (v < V) ? fb[(size_t)v * C + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[R], bv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = fs[k * FS + ty + 16 * r];
        bv[r] = fs[k * FS + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)b * gridDim.y + slice) * VP * VP;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) out[(ty + 16 * r) * VP + tx + 16 * c] = acc[r][c];
}

// ---- 2. Affinity + blend ---------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
graph_blend_kernel(const float* __restrict__ partial, int slices, const float* __restrict__ adj,
                   float* __restrict__ graph, int V) {
  constexpr int VP = 16 * R;
  constexpr int JPL = (VP + 31) / 32;  // columns per lane
  const int b = blockIdx.x;
  const float* pb = partial + (size_t)b * slices * VP * VP;
  // the same slices summed in the same order for every entry
  auto gram = [&](int i, int j) {
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += pb[(size_t)q * VP * VP + i * VP + j];
    return s;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < V; i += kThreads / 32) {
    const float gii = gram(i, i);
    const float* adj_row = adj + ((size_t)b * V + i) * V;
    float s[JPL], a[JPL];
    float s_sum = 0.f, a_sum = 0.f;
#pragma unroll
    for (int q = 0; q < JPL; ++q) {
      const int j = lane + 32 * q;
      s[q] = 0.f;
      a[q] = 0.f;
      if (j < V) {
        const float d2 = gii + gram(j, j) - 2.f * gram(i, j);  // exactly 0 when i == j
        const float d = sqrtf(fmaxf(d2, kNormEps));
        s[q] = 2.f / (1.f + expf(d));  // 2 * sigmoid(-d); exp overflow gives 0
        a[q] = adj_row[j];
      }
      s_sum += fabsf(s[q]);
      a_sum += fabsf(a[q]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s_sum += __shfl_xor_sync(0xffffffffu, s_sum, off);
      a_sum += __shfl_xor_sync(0xffffffffu, a_sum, off);
    }
    const float s_den = fmaxf(s_sum, kNormEps);
    const float a_den = fmaxf(a_sum, kNormEps);
    float* g_row = graph + ((size_t)b * V + i) * V;
#pragma unroll
    for (int q = 0; q < JPL; ++q) {
      const int j = lane + 32 * q;
      if (j < V) g_row[j] = 0.5f * (a[q] / a_den + s[q] / s_den);
    }
  }
}

// ---- 3. h tile, G @ h, epilogue --------------------------------------------

template <int R>
struct PropagateSmem {
  static constexpr int VP = 16 * R;
  static constexpr int GS = VP + 1;
  static constexpr int STAGE = (VP + CT) * RS;  // f chunk rows, then Wt chunk rows
  static constexpr int PIPE = STAGES * STAGE;
  static constexpr int TILES = VP * HS + VP * GS;  // h tile + G_b, after the K loop
  static constexpr size_t BYTES = sizeof(float) * (PIPE > TILES ? PIPE : TILES);
};

template <int R>
__global__ void __launch_bounds__(kThreads)
graph_propagate_kernel(const float* __restrict__ f, const float* __restrict__ graph,
                       const float* __restrict__ wt, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ var, float gamma, float* __restrict__ out,
                       int V, int C) {
  using L = PropagateSmem<R>;
  constexpr int VP = L::VP;
  extern __shared__ __align__(16) float prop_smem[];

  const int col0 = blockIdx.x * CT;
  const int b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* fb = f + (size_t)b * V * C;
  const float* wb = wt + (size_t)col0 * C;

  // rows V..VP-1 of every stage's f chunk stay zero (the copies skip them)
  for (int idx = threadIdx.x; idx < STAGES * (VP - V) * RS; idx += kThreads) {
    const int s = idx / ((VP - V) * RS), rem = idx % ((VP - V) * RS);
    prop_smem[s * L::STAGE + V * RS + rem] = 0.f;
  }
  auto load_chunk = [&](int stage, int kt) {
    float* fsd = prop_smem + stage * L::STAGE;
    float* wsd = fsd + VP * RS;
    const int k0 = kt * KC;
    for (int idx = threadIdx.x; idx < V * (KC / 4); idx += kThreads) {
      const int v = idx / (KC / 4), q = idx % (KC / 4);
      cp_async16(fsd + v * RS + 4 * q, fb + (size_t)v * C + k0 + 4 * q);
    }
    for (int idx = threadIdx.x; idx < CT * (KC / 4); idx += kThreads) {
      const int c = idx / (KC / 4), q = idx % (KC / 4);
      cp_async16(wsd + c * RS + 4 * q, wb + (size_t)c * C + k0 + 4 * q);
    }
  };

  const int nk = C / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_chunk(s, s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }

  float acc[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed
    __syncthreads();              // ...for every thread; chunk kt-1's stage is free
    if (kt + STAGES - 1 < nk) load_chunk((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* fsd = prop_smem + (kt % STAGES) * L::STAGE;
    const float* wsd = fsd + VP * RS;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[R], w[CPT];
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = *reinterpret_cast<const float4*>(fsd + (ty + 16 * r) * RS + k);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        w[c] = *reinterpret_cast<const float4*>(wsd + (tx + 16 * c) * RS + k);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float t = fmaf(a[r].x, w[c].x, acc[r][c]);
          t = fmaf(a[r].y, w[c].y, t);
          t = fmaf(a[r].z, w[c].z, t);
          acc[r][c] = fmaf(a[r].w, w[c].w, t);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers now hold the h tile and G_b

  float* hs = prop_smem;            // [VP][HS]
  float* gs = prop_smem + VP * HS;  // [VP][GS]
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) hs[(ty + 16 * r) * HS + tx + 16 * c] = acc[r][c];
  const float* gb = graph + (size_t)b * V * V;
  for (int idx = threadIdx.x; idx < VP * V; idx += kThreads) {
    const int i = idx / V, j = idx % V;
    gs[i * L::GS + j] = (i < V) ? gb[(size_t)i * V + j] : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  for (int j = 0; j < V; ++j) {
    float g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) g[r] = gs[(ty + 16 * r) * L::GS + j];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float h = hs[j * HS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][c] = fmaf(g[r], h, acc[r][c]);
    }
  }

  // epilogue: BN (running stats), LeakyReLU(0.1), convex residual
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = col0 + tx + 16 * c;
    const float mul = rsqrtf(var[col] + kBnEps) * scale[col];
    const float sub = mean[col], add = bias[col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + 16 * r;
      if (i >= V) continue;
      const size_t at = ((size_t)b * V + i) * C + col;
      float y = (acc[r][c] - sub) * mul + add;
      y = y >= 0.f ? y : 0.1f * y;
      out[at] = (1.f - gamma) * f[at] + gamma * y;
    }
  }
}

template <int R>
int launch(const float* f, const float* adj, const float* wt, const float* scale,
           const float* bias, const float* mean, const float* var, float gamma,
           float* scratch, float* out, int B, int V, int C, cudaStream_t stream) {
  constexpr int VP = 16 * R;
  const int slices = gram_slices(C);
  float* partial = scratch;                            // (B, slices, VP, VP)
  float* graph = scratch + (size_t)B * slices * VP * VP;  // (B, V, V)

  gram_partial_kernel<R><<<dim3(B, slices), kThreads, 0, stream>>>(f, partial, V, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  graph_blend_kernel<R><<<B, kThreads, 0, stream>>>(partial, slices, adj, graph, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = PropagateSmem<R>::BYTES;
  err = cudaFuncSetAttribute(graph_propagate_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  graph_propagate_kernel<R><<<dim3(C / CT, B), kThreads, smem, stream>>>(
      f, graph, wt, scale, bias, mean, var, gamma, out, V, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C must be a multiple of this.
int graph_conv_column_tile() { return CT; }

// Largest vertex count the kernels take.
int graph_conv_max_vertices() { return 128; }

// Floats of scratch graph_conv_forward needs: Gram partials, then G.
long long graph_conv_scratch_floats(int B, int V, int C) {
  const long long vp = V <= 64 ? 64 : 128;
  return (long long)B * gram_slices(C) * vp * vp + (long long)B * V * V;
}

// f, out (B, V, C); adj (B, V, V); wt (C, C) = W^T (a torch Linear weight);
// scale/bias/mean/var (C,); scratch of graph_conv_scratch_floats(B, V, C).
// All fp32, contiguous, on the current device; f and wt 16-byte aligned.
// Returns 0 or the cudaError_t of the first failing call.
int graph_conv_forward(const float* f, const float* adj, const float* wt, const float* scale,
                       const float* bias, const float* mean, const float* var, float gamma,
                       float* scratch, float* out, int B, int V, int C, void* stream) {
  if (B <= 0 || V <= 0 || V > 128 || C <= 0 || C % CT != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V <= 64)
    return launch<4>(f, adj, wt, scale, bias, mean, var, gamma, scratch, out, B, V, C, s);
  return launch<8>(f, adj, wt, scale, bias, mean, var, gamma, scratch, out, B, V, C, s);
}

const char* graph_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
