// Fused eval-mode graph convolution for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels agrl_tpu/ops/graph_conv.py:graph_propagate_pallas
// and agrl_tpu/ops/graph_conv_v2.py:graph_propagate_pallas_v2 (two Pallas
// schedules of one function). Per clip b, with f_b (V, C), adj_b (V, V),
// W (C, C) and an optional 0/1 vertex mask m_b (V,):
//
//   h    = f_b @ W
//   P    = m_b m_b^T (all ones without a mask)
//   A    = row_l1(adj_b * P)
//   S    = row_l1(2 * sigmoid(-sqrt(max(d2, 1e-12))) * P),  d2_ij = |f_i - f_j|^2
//   G    = (A + S) / 2, A or S      (mode 0 both, 1 pose, 2 learned)
//   out  = (1 - gamma) f_b + gamma * lrelu_0.1(bn_eval(G @ h))
//
// The modes are agrl_tpu's GraphConvLayer graphs (use_pose and learn_graph,
// agrl_tpu/models/layers.py:219-238). Mode 1 needs no Gram: its launch is
// skipped, and the blend reads only the adjacency.
//
// The mask is agrl_tpu's GraphConvLayer vertex_mask (padding frames of the
// bucketed `--test-sample all` eval): pairs with a padded end drop out of
// both row sums, and a padded row sums to 0 and, through the 1e-12 floor,
// gives a zero row of G.
//
// W arrives as Wt = W^T, i.e. a torch Linear weight (out, in), row-major:
// both operands of f_b @ W are then contiguous along the reduction axis.
//
// Two schedules, chosen by graph_conv_forward from V.
//
// V <= 128, three launches on the caller's stream:
//   gram_partial    grid (B, KS): block (b, s) accumulates the V x V Gram
//                   of f_b over the s-th of KS slices of the channels, in
//                   fp32 registers, into a scratch buffer. Splitting the
//                   channels puts B * KS blocks (512 at B=16) on the card
//                   instead of B.
//   graph_blend     grid (B, ceil(V / 8)): the diagonal of the Gram first,
//                   then one warp per row sums the KS partials in a fixed
//                   order (so d2_ii is exactly 0), forms the l2 affinity,
//                   masks it and the pose adjacency, row-normalizes both
//                   and writes G (B, V, V).
//   graph_propagate grid (C / BN, ceil(B / clips)): block (t, p) computes
//                   the (BM, BN) tile t of h = f @ W for the clips of
//                   group p on the tensor cores, keeps it in shared
//                   memory, multiplies each clip's rows by its G_b, and
//                   applies BN (running stats), LeakyReLU(0.1) and the
//                   convex residual on the same tile. h never goes to
//                   device memory.
//
// V > 128 (long clips, up to 8288 vertices for a 1184-frame bucket): a
// block cannot hold a clip's rows of G, and a k-split Gram scratch would
// take B * 32 * V^2 floats, so four launches with G and h in scratch:
//   gram_tile       grid (ceil(V / 64), ceil(V / 64), B): one 64 x 64 tile
//                   of the Gram over all C channels (no k-split), fp32 on
//                   the FMA pipe; diagonal tiles also write the diagonal
//                   (B, V), the same fp32 values, so d2_ii is exactly 0.
//   graph_blend_long grid (V, B): one block per row, masked row sums over
//                   the full row in a fixed order (no atomics), then G
//                   written over the row's Gram entries in place.
//   graph_propagate the short schedule's tensor-core mainloop over the
//                   flattened (B * V, C) rows, 128 rows a block (clip
//                   boundaries fall inside a block; the product does not
//                   care), stored into an h scratch (B, V, C).
//   graph_apply_long grid (C / 128, ceil(V / 128), B): a (128 x 128) tile of
//                   G_b @ h_b with K running over V, fp32 FMA, each 32-deep
//                   chunk summed apart and added into the total; BN,
//                   LeakyReLU and the residual on the tile.
// At V = 8288, C = 2048 the Gram and G @ h are 281 GFLOP each against 69.5
// for f @ W: on the FP32 pipe they take ~8.4 ms per layer, where the three
// products in 3xTF32, with only the Gram's upper half (it is symmetric),
// would take ~3.0; tensor cores for them are later work.
//
// Bound on an H100 SXM (B=16, V=56, C=2048, one call): f@W is
// 2*896*2048^2 = 7.52 GFLOP, the Gram and G@h add 0.21 GFLOP each; the
// bytes the function must move are W 16.8 MB + f 7.3 MB + out 7.3 MB + adj
// 0.2 MB, ~31.6 MB (9.4 us at 3.35 TB/s). At the fp32 FMA peak (67
// TFLOP/s) f@W alone takes 0.112 ms, the first design's ceiling. The
// tensor cores reach fp32 accuracy with 3xTF32: each operand splits as
// x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and the fp32 accumulators
// take lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of the product, is dropped).
// A single TF32 pass keeps only ~11 bits of each operand (~3e-4 of the
// output's scale at the serving shape), far outside the kernel's fp32
// bars. Three tf32 passes at 495 TFLOP/s over f@W, the Gram's upper half
// and G@h bound the call at ~0.047 ms (~0.052 with the Gram and G@h on the
// FMA pipe, where this design runs them).
//
// graph_propagate's design:
//   * a block holds BM = 128 rows: two clips of up to 64 vertices (V=56
//     pads to 64) or one clip of up to 128, and BN = 128 output columns.
//     Both clips share the block's W^T tile, so W is read once per clip
//     pair, not once per clip;
//   * two warpgroups, one per 64 rows, each issue wgmma.m64n128k8 tf32
//     with fp32 accumulators (64 a thread), both operands read from
//     shared memory through descriptors, 3 products per k8 step; each
//     K chunk's products are promoted into a second set of 64 fp32
//     registers (the tensor cores' own accumulation truncates);
//   * one thread feeds a 3-stage ring with TMA: per 32-deep K chunk, each
//     clip's (64 x 32) box of a 3-D (B, V, C) tensor map, whose rows V..63
//     and missing clips land as zeros, and the (128 x 32) box of W^T (a
//     torch Linear weight: both operands are contiguous along the
//     reduction axis, the K-major layout tf32 wgmma requires); a stage's
//     mbarrier completes when its bytes have landed. All 256 threads then
//     split the chunk once into hi and lo planes (double-buffered, so the
//     split of chunk k + 1 overlaps the products of chunk k). Raw chunks
//     and planes share TMA's and wgmma's 128-byte swizzle, which keeps
//     the split's reads and writes conflict-free;
//   * the epilogue: the h tile and each clip's G_b in shared memory, G @ h
//     in fp32 FMA, BN, LeakyReLU, residual.
// The Gram stays fp32 on the FMA pipe (3% of the work): its cancellation
// near zero distance is where the affinity is sharpest.
//
// What it moves (PERF.md has its times on an H100): 251 MB of operands
// from L2 per call at B=16 (f once per column tile, W once per clip
// pair), and each chunk passes through shared memory three times
// (written by TMA, read and written by the split, read by 24 wgmma).
// Sharing W^T tiles between blocks (TMA multicast in a cluster) and
// warp-specialized producers are the next levers (a cluster barrier per
// chunk, tried in their place, cost more than it saved).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid; 8 warps
constexpr int KC = 32;         // depth of one staged K chunk
constexpr int BM = 128;        // propagate block rows: 2 clips of <= 64 vertices or 1 of <= 128
constexpr int BN = 128;        // output columns per propagate block
constexpr int HS = BN + 4;     // row stride of the h tile
constexpr int STAGES = 3;      // TMA ring depth
constexpr int KS_MAX = 32;     // channel slices of the Gram
constexpr float kBnEps = 1e-5f;
constexpr float kNormEps = 1e-12f;

__host__ __device__ constexpr int gram_slices(int C) {
  // C % 128 == 0: C / KC is a multiple of 4
  return (C / KC) % 32 == 0 ? 32 : (C / KC) % 16 == 0 ? 16 : (C / KC) % 8 == 0 ? 8 : 4;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// mbarrier of one ring stage: one arrival (the issuing thread's, with the
// stage's byte count) plus the TMA transfers' bytes complete a phase.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of the given parity to complete. A transfer that
// never lands traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}
// TMA tile loads into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// fp32 -> tf32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero), with integer operations: the low 13 mantissa bits become 0.
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving an accumulator while a wgmma may write it.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
// Orders this thread's shared-memory stores before later wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128, fp32) = a (64 x 8) * b (8 x 128) + (add ? d : 0): one
// warpgroup, tf32 operands from shared memory (descriptors),
// asynchronous until wgmma_wait. The 64 accumulators of a thread:
// d[4 i + e] is row 16 warp + g (+ 8 for e >= 2), column 8 i + 2 t (+ 1
// for odd e).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], unsigned long long a,
                                                     unsigned long long b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(add));
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

// G's entry from the row's affinity s and pose a and their row sums' floors
// s_den and a_den.
__device__ __forceinline__ float graph_entry(int mode, float s, float s_den, float a, float a_den) {
  switch (mode) {
    case 1: return a / a_den;
    case 2: return s / s_den;
    default: return 0.5f * (a / a_den + s / s_den);
  }
}
__host__ __device__ __forceinline__ bool needs_gram(int mode) { return mode == 0 || mode == 2; }

template <int R>
__global__ void __launch_bounds__(kThreads)
graph_blend_kernel(const float* __restrict__ partial, int slices, const float* __restrict__ adj,
                   const float* __restrict__ mask, float* __restrict__ graph, int V, int mode) {
  constexpr int VP = 16 * R;
  constexpr int JPL = (VP + 31) / 32;  // columns per lane
  __shared__ float diag[VP];
  const int b = blockIdx.x;
  const float* pb = partial + (size_t)b * slices * VP * VP;
  // the same slices summed in the same order for every entry; the loads
  // are independent, so they fly together
  auto gram = [&](int i, int j) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < KS_MAX; ++q)
      if (q < slices) s += pb[(size_t)q * VP * VP + i * VP + j];
    return s;
  };
  const bool learned = needs_gram(mode);
  if (learned)
    for (int i = threadIdx.x; i < V; i += kThreads) diag[i] = gram(i, i);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int i = blockIdx.y * (kThreads / 32) + threadIdx.x / 32;  // this warp's row
  if (i < V) {
    const float gii = learned ? diag[i] : 0.f;
    const float* adj_row = adj + ((size_t)b * V + i) * V;
    const float* mb = mask == nullptr ? nullptr : mask + (size_t)b * V;
    float s[JPL], a[JPL];
    float s_sum = 0.f, a_sum = 0.f;
#pragma unroll
    for (int q = 0; q < JPL; ++q) {
      const int j = lane + 32 * q;
      s[q] = 0.f;
      a[q] = 0.f;
      if (j < V) {
        const float pm = mb == nullptr ? 1.f : mb[i] * mb[j];  // the pair's mask
        if (learned) {
          const float d2 = gii + diag[j] - 2.f * gram(i, j);  // exactly 0 when i == j
          const float d = sqrtf(fmaxf(d2, kNormEps));
          s[q] = 2.f / (1.f + expf(d)) * pm;  // 2 * sigmoid(-d); exp overflow gives 0
        }
        a[q] = adj_row[j] * pm;
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
      if (j < V) g_row[j] = graph_entry(mode, s[q], s_den, a[q], a_den);
    }
  }
}

// ---- 3. h tile, G @ h, epilogue --------------------------------------------

// Raw chunks and operand planes share one layout: BM rows x KC floats
// (K-contiguous), rows of 128 bytes, the 16-byte slot q of row r stored at
// slot q ^ (r % 8). That is how TMA's 128-byte swizzle writes a box and
// what wgmma reads as a 128-byte-swizzled K-major operand (8-row atoms of
// 1024 bytes, which must start at 1024-byte boundaries).
constexpr int PLANE = BM * KC;  // floats
static_assert(BM == BN && KC * sizeof(float) == 128, "f and W^T chunks share the layout");
__device__ __forceinline__ int slot(int r, int q) { return r * KC + 4 * (q ^ (r & 7)); }
// Shared-memory matrix descriptor of a k8 step of a plane (p: the step's
// first row, advanced by 32 bytes per k8 within the 128-byte rows): start
// address, leading byte offset 1 (unused for swizzled K-major operands),
// stride byte offset 1024 (between 8-row atoms), all in 16-byte units;
// layout type 1 (128-byte swizzle).
__device__ __forceinline__ unsigned long long plane_desc(const float* p) {
  return (unsigned long long)((smem_u32(p) & 0x3ffff) >> 4) | (1ull << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

template <int VP>
struct PropagateSmem {
  static constexpr int CLIPS = BM / VP;  // clips per block
  static constexpr int GS = VP + 1;
  // K loop: two buffers of the four planes (f hi, f lo, W^T hi, W^T lo),
  // then the raw ring: STAGES chunks of BM f rows and BN W^T rows, then
  // one mbarrier per stage
  static constexpr int PLANES = 2 * 4 * PLANE;
  static constexpr int RAW = (BM + BN) * KC;
  static constexpr int PIPE = PLANES + STAGES * RAW;
  static constexpr int TILES = BM * HS + BM * GS;  // h tile + each clip's G_b, after the K loop
  static constexpr size_t BYTES =
      sizeof(float) * (PIPE > TILES ? PIPE : TILES) + 8 * STAGES + 1024;  // + alignment slack
};

// STORE_H: the long schedule's h = f @ W alone. f is then one (1, V, C)
// matrix of the flattened rows, block y takes rows 128 y .. 128 y + 127,
// and the tile is stored into out (the h scratch) as it comes from the
// accumulators.
template <int VP, bool STORE_H>
__global__ void __launch_bounds__(kThreads, 1)
graph_propagate_kernel(const __grid_constant__ CUtensorMap f_map,
                       const __grid_constant__ CUtensorMap wt_map,
                       const float* __restrict__ f, const float* __restrict__ graph,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ var, float gamma, float* __restrict__ out,
                       int B, int V, int C) {
  using L = PropagateSmem<VP>;
  constexpr int RPC = VP / 16;  // epilogue rows per thread and clip
  extern __shared__ unsigned char prop_raw_smem[];
  float* const prop_smem = reinterpret_cast<float*>(
      (reinterpret_cast<size_t>(prop_raw_smem) + 1023) & ~(size_t)1023);
  float* raw = prop_smem + L::PLANES;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(prop_smem + L::PIPE);

  const int col0 = blockIdx.x * BN;
  const int v0 = STORE_H ? blockIdx.y * BM : 0;            // first row of the block
  const int b0 = STORE_H ? 0 : blockIdx.y * L::CLIPS;  // first clip of the block
  const int clips = min(L::CLIPS, B - b0);
  // block row r is vertex r % VP of clip b0 + r / VP
  auto row_valid = [&](int r) { return r % VP < V && b0 + r / VP < B; };

  // the rows of a clip past B stay zero in every stage (no load covers
  // them); rows V..VP-1 of a clip are the TMA box's zero fill
  for (int idx = threadIdx.x; idx < STAGES * BM * KC; idx += kThreads) {
    const int s = idx / (BM * KC), r = idx % (BM * KC) / KC;
    if (r / VP >= clips) raw[s * L::RAW + idx % (BM * KC)] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread loads chunk kt into a stage: each clip's (VP x KC) box of
  // the (B, V, C) f map and the (BN x KC) box of the W^T map
  auto load_chunk = [&](int stage, int kt) {
    float* rs = raw + stage * L::RAW;
    mbar_expect_tx(full + stage, (unsigned)(sizeof(float) * (clips * VP + BN) * KC));
    for (int p = 0; p < clips; ++p)
      tma_load_3d(rs + p * VP * KC, &f_map, kt * KC, v0, b0 + p, full + stage);
    tma_load_2d(rs + BM * KC, &wt_map, kt * KC, col0, full + stage);
  };
  // raw chunk -> hi/lo planes of buffer buf: x = hi + lo, hi = tf32(x),
  // lo = tf32(x - hi) (x - hi is exact); consecutive threads take
  // consecutive rows, so the reads (swizzled) and the writes are
  // conflict-free
  auto split_chunk = [&](int stage, int buf) {
    const float* rs = raw + stage * L::RAW;
    float* pl = prop_smem + buf * 4 * PLANE;
#pragma unroll
    for (int i = 0; i < 2 * BM * (KC / 4) / kThreads; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const int op = idx / (BM * (KC / 4));  // 0: f, 1: W^T
      const int r = idx % BM, q = idx / BM % (KC / 4);
      const float4 x = *reinterpret_cast<const float4*>(rs + slot(op * BM + r, q));
      float4 hi, lo;
      hi.x = round_tf32(x.x); lo.x = round_tf32(x.x - hi.x);
      hi.y = round_tf32(x.y); lo.y = round_tf32(x.y - hi.y);
      hi.z = round_tf32(x.z); lo.z = round_tf32(x.z - hi.z);
      hi.w = round_tf32(x.w); lo.w = round_tf32(x.w - hi.w);
      float* dst = pl + op * 2 * PLANE + slot(r, q);
      *reinterpret_cast<float4*>(dst) = hi;
      *reinterpret_cast<float4*>(dst + PLANE) = lo;
    }
  };

  const int nk = C / KC;
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES - 1 && s < nk; ++s) load_chunk(s, s);

  // warpgroup wg computes block rows 64 wg .. 64 wg + 63 (one clip at
  // VP = 64, half of one at VP = 128) x all BN columns. The tensor cores
  // add into acc with truncation, so a chain of 3 C / 8 wgmma on one
  // accumulator drifts (at C = 2048, 3e-6 of max|output| from float64,
  // ~20x an fp32 product's error); acc holds one chunk's 12 products
  // (the chunk's first wgmma does not add acc) and is promoted into tot,
  // in fp32 adds that round to nearest.
  const int wg = threadIdx.x / 128;
  float acc[64], tot[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = tot[e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    // every thread has split chunk kt-1 (its stage is free) and every
    // warpgroup has waited for chunk kt-2's products (plane buffer kt % 2
    // is free)
    __syncthreads();
    if (threadIdx.x == 0 && kt + STAGES - 1 < nk)
      load_chunk((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    mbar_wait(full + kt % STAGES, (kt / STAGES) & 1);  // chunk kt has landed
    split_chunk(kt % STAGES, kt % 2);  // overlaps chunk kt-1's products
    fence_proxy_async();
    __syncthreads();

    const float* pl = prop_smem + (kt % 2) * 4 * PLANE;
    const float* f_hi = pl + wg * 64 * KC;  // rows 64 wg ..
    const float* w_hi = pl + 2 * PLANE;
    wgmma_wait<0>();  // chunk kt-1's products are done: promote them
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      pin(acc[e]);
      tot[e] += acc[e];
      pin(acc[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < KC / 8; ++k8) {
      const int at = k8 * 8;  // slots 2 k8, 2 k8 + 1 of every row
      const unsigned long long fh = plane_desc(f_hi + at);
      const unsigned long long fl = plane_desc(f_hi + PLANE + at);
      const unsigned long long wh = plane_desc(w_hi + at);
      const unsigned long long wl = plane_desc(w_hi + PLANE + at);
      wgmma_m64n128k8_tf32(acc, fl, wh, k8 > 0);  // small terms first; the chunk starts at 0
      wgmma_m64n128k8_tf32(acc, fh, wl, 1);
      wgmma_m64n128k8_tf32(acc, fh, wh, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    pin(acc[e]);
    tot[e] += acc[e];
  }
  if constexpr (STORE_H) {
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int r = v0 + wg * 64 + warp * 16 + lane / 4, c = col0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if (r < V)
        *reinterpret_cast<float2*>(out + (size_t)r * C + c + 8 * i) =
            make_float2(tot[4 * i], tot[4 * i + 1]);
      if (r + 8 < V)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * C + c + 8 * i) =
            make_float2(tot[4 * i + 2], tot[4 * i + 3]);
    }
    return;
  }
  __syncthreads();  // the buffers now hold the h tile and each clip's G_b

  float* hs = prop_smem;            // [BM][HS]
  float* gs = prop_smem + BM * HS;  // [BM][GS]: row clip * VP + i holds G_b[i, :]
  {
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int r = wg * 64 + warp * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      hs[r * HS + 8 * i + c] = tot[4 * i];
      hs[r * HS + 8 * i + c + 1] = tot[4 * i + 1];
      hs[(r + 8) * HS + 8 * i + c] = tot[4 * i + 2];
      hs[(r + 8) * HS + 8 * i + c + 1] = tot[4 * i + 3];
    }
  }
  for (int idx = threadIdx.x; idx < BM * V; idx += kThreads) {
    const int r = idx / V, j = idx % V;
    gs[r * L::GS + j] =
        row_valid(r) ? graph[((size_t)(b0 + r / VP) * V + r % VP) * V + j] : 0.f;
  }
  __syncthreads();

  // G @ h: thread (tx, ty) owns rows ty + 16 i (clip i / RPC) and columns
  // tx + 16 c of the tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float o[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) o[i][c] = 0.f;
  for (int j = 0; j < V; ++j) {
    float gv[BM / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) gv[i] = gs[(ty + 16 * i) * L::GS + j];
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      float h[L::CLIPS];
#pragma unroll
      for (int p = 0; p < L::CLIPS; ++p) h[p] = hs[(p * VP + j) * HS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) o[i][c] = fmaf(gv[i], h[i / RPC], o[i][c]);
    }
  }

  // epilogue: BN (running stats), LeakyReLU(0.1), convex residual
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) {
    const int col = col0 + tx + 16 * c;
    const float mul = rsqrtf(var[col] + kBnEps) * scale[col];
    const float sub = mean[col], add = bias[col];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int r = ty + 16 * i;
      if (!row_valid(r)) continue;
      const size_t at = ((size_t)(b0 + r / VP) * V + r % VP) * C + col;
      float y = (o[i][c] - sub) * mul + add;
      y = y >= 0.f ? y : 0.1f * y;
      out[at] = (1.f - gamma) * f[at] + gamma * y;
    }
  }
}

// ---- long clips (V > 128) -------------------------------------------------

constexpr int GT = 64;        // Gram tile: 64 x 64 entries, 4 x 4 a thread
constexpr int GTS = GT + 1;   // odd stride: the transposed stores hit distinct banks
constexpr int AT = 128;       // G @ h tile: 128 rows x 128 columns, 8 x 8 a thread
constexpr int ATS = AT + 1;

// Gram tile (i0.., j0..) of clip b over all C channels, in 32-deep chunks
// whose sums are added into the total (a chain of C fmaf on one register
// would drift further from the plain product). Symmetric entries see the
// same products in the same order, so G2_ij == G2_ji and, on the diagonal,
// the values written to diag are the Gram's own.
__global__ void __launch_bounds__(kThreads)
gram_tile_kernel(const float* __restrict__ f, float* __restrict__ gram,
                 float* __restrict__ diag, int V, int C) {
  __shared__ float fa[KC * GTS], fb[KC * GTS];
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* fc = f + (size_t)b * V * C;

  float part[4][4], tot[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[r][c] = 0.f;

  for (int k0 = 0; k0 < C; k0 += KC) {
    for (int idx = threadIdx.x; idx < GT * KC; idx += kThreads) {
      const int v = idx / KC, k = idx % KC;
      fa[k * GTS + v] = i0 + v < V ? fc[(size_t)(i0 + v) * C + k0 + k] : 0.f;
      fb[k * GTS + v] = j0 + v < V ? fc[(size_t)(j0 + v) * C + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = fa[k * GTS + ty + 16 * r];
        bv[r] = fb[k * GTS + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = fmaf(a[r], bv[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) tot[r][c] += part[r][c];
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= V) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= V) continue;
      gram[((size_t)b * V + i) * V + j] = tot[r][c];
      if (i == j) diag[(size_t)b * V + i] = tot[r][c];
    }
  }
}

// Sum of v over the block's 256 threads, in a fixed order; every thread
// gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free (an earlier call's reads are done)
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// Row i of clip b: the masked affinity and pose rows, their L1 sums over
// the whole row, then G's row written over the Gram's. A thread writes
// only the entries it read, so the row is rewritten in place.
__global__ void __launch_bounds__(kThreads)
graph_blend_long_kernel(float* __restrict__ graph, const float* __restrict__ diag,
                        const float* __restrict__ adj, const float* __restrict__ mask, int V,
                        int mode) {
  __shared__ float red[kThreads / 32];
  const int i = blockIdx.x, b = blockIdx.y;
  float* row = graph + ((size_t)b * V + i) * V;
  const float* adj_row = adj + ((size_t)b * V + i) * V;
  const float* db = diag + (size_t)b * V;
  const float* mb = mask == nullptr ? nullptr : mask + (size_t)b * V;
  const bool learned = needs_gram(mode);
  const float gii = learned ? db[i] : 0.f, mi = mb == nullptr ? 1.f : mb[i];
  // without the Gram (mode 1) the row holds nothing yet and is only written
  auto entries = [&](int j, float& s, float& a) {
    const float pm = mb == nullptr ? 1.f : mi * mb[j];
    s = 0.f;
    if (learned) {
      const float d2 = gii + db[j] - 2.f * row[j];  // exactly 0 when i == j
      s = 2.f / (1.f + expf(sqrtf(fmaxf(d2, kNormEps)))) * pm;
    }
    a = adj_row[j] * pm;
  };
  float s_sum = 0.f, a_sum = 0.f;
  for (int j = threadIdx.x; j < V; j += kThreads) {
    float s, a;
    entries(j, s, a);
    s_sum += fabsf(s);
    a_sum += fabsf(a);
  }
  const float s_den = fmaxf(block_sum(s_sum, red), kNormEps);
  const float a_den = fmaxf(block_sum(a_sum, red), kNormEps);
  for (int j = threadIdx.x; j < V; j += kThreads) {
    float s, a;
    entries(j, s, a);
    row[j] = graph_entry(mode, s, s_den, a, a_den);
  }
}

// Tile (rows i0.., columns col0..) of G_b @ h_b, K over V in 32-deep
// chunks (each chunk's 32 products summed apart, then added into the
// total), then BN (running stats), LeakyReLU(0.1) and the convex residual.
// Thread (tx, ty) owns rows ty + 16 i and columns tx + 16 c.
__global__ void __launch_bounds__(kThreads)
graph_apply_long_kernel(const float* __restrict__ graph, const float* __restrict__ h,
                        const float* __restrict__ f, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ mean,
                        const float* __restrict__ var, float gamma, float* __restrict__ out,
                        int V, int C) {
  __shared__ float gs[KC * ATS];  // gs[k][r] = G_b[i0 + r, k0 + k]
  __shared__ float hs[KC * AT];   // hs[k][c] = h_b[k0 + k, col0 + c]
  const int col0 = blockIdx.x * AT, i0 = blockIdx.y * AT, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* gb = graph + (size_t)b * V * V;
  const float* hb = h + (size_t)b * V * C;

  float part[AT / 16][AT / 16], tot[AT / 16][AT / 16];
#pragma unroll
  for (int i = 0; i < AT / 16; ++i)
#pragma unroll
    for (int c = 0; c < AT / 16; ++c) tot[i][c] = 0.f;

  for (int k0 = 0; k0 < V; k0 += KC) {
    for (int idx = threadIdx.x; idx < AT * KC; idx += kThreads) {
      const int r = idx / KC, k = idx % KC;  // consecutive threads: consecutive k of a row
      gs[k * ATS + r] = i0 + r < V && k0 + k < V ? gb[(size_t)(i0 + r) * V + k0 + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < KC * AT; idx += kThreads) {
      const int k = idx / AT, c = idx % AT;
      hs[k * AT + c] = k0 + k < V ? hb[(size_t)(k0 + k) * C + col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < AT / 16; ++i)
#pragma unroll
      for (int c = 0; c < AT / 16; ++c) part[i][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float gv[AT / 16], hv[AT / 16];
#pragma unroll
      for (int i = 0; i < AT / 16; ++i) gv[i] = gs[k * ATS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < AT / 16; ++c) hv[c] = hs[k * AT + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < AT / 16; ++i)
#pragma unroll
        for (int c = 0; c < AT / 16; ++c) part[i][c] = fmaf(gv[i], hv[c], part[i][c]);
    }
#pragma unroll
    for (int i = 0; i < AT / 16; ++i)
#pragma unroll
      for (int c = 0; c < AT / 16; ++c) tot[i][c] += part[i][c];
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < AT / 16; ++c) {
    const int col = col0 + tx + 16 * c;
    const float mul = rsqrtf(var[col] + kBnEps) * scale[col];
    const float sub = mean[col], add = bias[col];
#pragma unroll
    for (int i = 0; i < AT / 16; ++i) {
      const int r = i0 + ty + 16 * i;
      if (r >= V) continue;
      const size_t at = ((size_t)b * V + r) * C + col;
      float y = (tot[i][c] - sub) * mul + add;
      y = y >= 0.f ? y : 0.1f * y;
      out[at] = (1.f - gamma) * f[at] + gamma * y;
    }
  }
}

// cuTensorMapEncodeTiled, a CUDA driver API entry point, fetched through
// the runtime (no link to libcuda needed).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)p
                                                                         : (EncodeTiled) nullptr;
  }();
  return fn;
}

// A row-major fp32 tensor of `rank` dims (innermost first) read in boxes of
// `box`, 128-byte swizzled in shared memory; rows past the end of a dim
// load as zeros.
bool tensor_map(CUtensorMap* map, const float* base, cuuint32_t rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[2];  // bytes, of dims 1 .. rank-1
  cuuint64_t stride = sizeof(float);
  for (cuuint32_t d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R>
int launch(const float* f, const float* adj, const float* mask, const float* wt,
           const float* scale, const float* bias, const float* mean, const float* var,
           float gamma, int mode, float* scratch, float* out, int B, int V, int C,
           cudaStream_t stream) {
  constexpr int VP = 16 * R;
  const int slices = gram_slices(C);
  float* partial = scratch;                            // (B, slices, VP, VP)
  float* graph = scratch + (size_t)B * slices * VP * VP;  // (B, V, V)

  cudaError_t err;
  if (needs_gram(mode)) {
    gram_partial_kernel<R><<<dim3(B, slices), kThreads, 0, stream>>>(f, partial, V, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  graph_blend_kernel<R><<<dim3(B, (V + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                           stream>>>(partial, slices, adj, mask, graph, V, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using L = PropagateSmem<VP>;
  CUtensorMap f_map, wt_map;
  const cuuint64_t f_dims[3] = {(cuuint64_t)C, (cuuint64_t)V, (cuuint64_t)B};
  const cuuint32_t f_box[3] = {KC, VP, 1};
  const cuuint64_t wt_dims[2] = {(cuuint64_t)C, (cuuint64_t)C};
  const cuuint32_t wt_box[2] = {KC, BN};
  if (!tensor_map(&f_map, f, 3, f_dims, f_box) || !tensor_map(&wt_map, wt, 2, wt_dims, wt_box))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(graph_propagate_kernel<VP, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C / BN, (B + L::CLIPS - 1) / L::CLIPS);
  graph_propagate_kernel<VP, false><<<grid, kThreads, L::BYTES, stream>>>(
      f_map, wt_map, f, graph, scale, bias, mean, var, gamma, out, B, V, C);
  return (int)cudaGetLastError();
}

// V > 128: scratch holds h (B, V, C), then the Gram, overwritten by G
// (B, V, V), then the Gram's diagonal (B, V).
int launch_long(const float* f, const float* adj, const float* mask, const float* wt,
                const float* scale, const float* bias, const float* mean, const float* var,
                float gamma, int mode, float* scratch, float* out, int B, int V, int C,
                cudaStream_t stream) {
  const size_t rows = (size_t)B * V;
  float* h = scratch;
  float* graph = h + rows * C;
  float* diag = graph + rows * V;

  cudaError_t err;
  if (needs_gram(mode)) {
    const int gt = (V + GT - 1) / GT;
    gram_tile_kernel<<<dim3(gt, gt, B), kThreads, 0, stream>>>(f, graph, diag, V, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  graph_blend_long_kernel<<<dim3(V, B), kThreads, 0, stream>>>(graph, diag, adj, mask, V, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // h = f @ W over the flattened rows: f as one (1, B * V, C) matrix
  using L = PropagateSmem<BM>;
  CUtensorMap f_map, wt_map;
  const cuuint64_t f_dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, 1};
  const cuuint32_t f_box[3] = {KC, BM, 1};
  const cuuint64_t wt_dims[2] = {(cuuint64_t)C, (cuuint64_t)C};
  const cuuint32_t wt_box[2] = {KC, BN};
  if (!tensor_map(&f_map, f, 3, f_dims, f_box) || !tensor_map(&wt_map, wt, 2, wt_dims, wt_box))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(graph_propagate_kernel<BM, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  graph_propagate_kernel<BM, true><<<dim3(C / BN, (unsigned)((rows + BM - 1) / BM)), kThreads,
                                      L::BYTES, stream>>>(
      f_map, wt_map, f, nullptr, scale, bias, mean, var, gamma, h, 1, (int)rows, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  graph_apply_long_kernel<<<dim3(C / AT, (V + AT - 1) / AT, B), kThreads, 0, stream>>>(
      graph, h, f, scale, bias, mean, var, gamma, out, V, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C must be a multiple of this.
int graph_conv_column_tile() { return BN; }

// Floats of scratch graph_conv_forward needs. V <= 128: Gram partials,
// then G. V > 128: h, G, the Gram's diagonal.
long long graph_conv_scratch_floats(int B, int V, int C) {
  if (V > 128) return (long long)B * V * C + (long long)B * V * V + (long long)B * V;
  const long long vp = V <= 64 ? 64 : 128;
  return (long long)B * gram_slices(C) * vp * vp + (long long)B * V * V;
}

// f, out (B, V, C); adj (B, V, V); mask (B, V) of 0/1 or null; wt (C, C) =
// W^T (a torch Linear weight); scale/bias/mean/var (C,); mode 0 both, 1
// pose, 2 learned; scratch of graph_conv_scratch_floats(B, V, C).
// All fp32, contiguous, on the current device; f and wt 16-byte aligned.
// Any V >= 1; B and B * V / 128 within a grid dimension (65535). Returns 0
// or the cudaError_t of the first failing call.
int graph_conv_forward(const float* f, const float* adj, const float* mask, const float* wt,
                       const float* scale, const float* bias, const float* mean,
                       const float* var, float gamma, int mode, float* scratch, float* out,
                       int B, int V, int C, void* stream) {
  if (B <= 0 || B > 65535 || V <= 0 || C <= 0 || C % BN != 0 || mode < 0 || mode > 2 ||
      ((long long)B * V + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V <= 64)
    return launch<4>(f, adj, mask, wt, scale, bias, mean, var, gamma, mode, scratch, out, B, V,
                     C, s);
  if (V <= 128)
    return launch<8>(f, adj, mask, wt, scale, bias, mean, var, gamma, mode, scratch, out, B, V,
                     C, s);
  return launch_long(f, adj, mask, wt, scale, bias, mean, var, gamma, mode, scratch, out, B, V,
                     C, s);
}

const char* graph_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
