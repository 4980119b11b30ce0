// Batch-hard triplet mining for Hopper (sm_90a), fp32: the H heads of a
// train step in one launch (one cluster launch for B <= 256, two kernels
// of a tiled schedule above), and their gradient in one launch.
//
// Replaces the TPU kernel agrl_tpu/ops/triplet.py:hard_mine_pallas. For
// each head h (features f_h (B, D)) and the labels (B,) the heads share,
// per anchor i:
//
//   d2_ij = sq_i + sq_j - 2 <f_i, f_j>        (sq_i = <f_i, f_i>)
//   dist  = sqrt(max(d2_ij, 1e-12))
//   d_ap[h, i], i_ap[h, i] = max, argmax over j with labels[j] == labels[i] (self included)
//   d_an[h, i], i_an[h, i] = min, argmin over j with labels[j] != labels[i]
//
// The same quadratic form as the JAX package (agrl_tpu/losses/__init__.py
// pairwise_euclidean), so near-zero distances and the picks agree with it.
// sq_i is the Gram's own diagonal (the same fp32 value), so d2_ii is
// exactly 0. Masked entries take -FLT_MAX (max) and
// FLT_MAX (min), as the plain version's torch.where does, and a tie goes
// to the lowest index, as torch.argmax / argmin do: an anchor with no
// negative gets d_an = FLT_MAX. Unlike the Pallas kernel, B needs no
// padding to a multiple of 8.
//
// Ties: the kernel returns one index per anchor. JAX's max/min VJP (and
// torch's amax/amin) split the gradient evenly among tied entries instead.
// Ties happen when a batch holds identical clips (RandomIdentitySamplerV1
// samples with replacement when a pid has fewer than K tracklets, and
// `restricted` sampling of a tracklet of <= seq_len frames is
// deterministic). Identical rows come from identical inputs through the
// same network, so their Jacobians are equal and the parameter gradient is
// the same whichever of them takes the gradient; only the split among the
// tied feature rows differs.
//
// Bound on an H100 SXM at the train step's shape (H=5 heads, B=16 = 4x4,
// D=2048): the forward must read 5 x 131 KB of features and does ~5 MFLOP
// (the Grams): ~0.2 us of HBM time. The backward reads the features again
// and writes as many gradient bytes: ~0.4 us. Both are far under the few
// microseconds of one launch, so what the design spends is latency: one
// launch for all heads, each head's work spread over a cluster, no pass
// through device memory between the Gram and the mining.
//
// Short forward (B <= 256): one cluster of 8 blocks per (head, band of
// 16 anchors); grid (8 x bands, H). Block rank r of a cluster owns 1/8 of the columns.
// All its threads bring that slice of all B rows into shared memory with
// cp.async, 16 bytes each, the labels with the first chunk, in chunks of
// kc4 float4 columns through a two-stage ring when the slice does not fit
// at once (at the train shape it does: 16 x 256 floats, 16 KB). One
// cp.async.bulk per row on an mbarrier measured within a few percent on
// the card and needs more code. The band's rows against every row form a
// 16 x B partial Gram in 4 x 4 tiles of fp32 FMA (a tile's 8 float4 loads
// feed 64 FMAs; a thread per output loads 2 per 4 FMAs, and shared memory
// bound that design), each tile's columns split over kg threads and their
// partials summed in a fixed order; one thread per row outside the band
// sums that row's norm. Each block then pushes its partials into the
// shared memory of the block that finishes the anchor (band row a to rank
// a % 8), and its norms to every block, and the cluster meets at one
// barrier. Block r then finishes anchors r and r + 8, one warp each, from
// its own shared memory: the 8 partials summed in rank order 0..7
// (deterministic, no atomics, nothing through device memory), the
// distances, the masked max and min with their indices. No block reads a
// peer's memory after the barrier, so each may exit; a relaxed cluster
// arrive at the start, waited on before the pushes, makes sure every peer
// runs before it is written to (a second full barrier in its place
// measured slower).
//
// S-matrix backward (the TPU kernel has none), B <= 96: per head, with
// M[i, i_ap[i]] = g_ap[i] / d_ap[i] and M[i, i_an[i]] = g_an[i] / d_an[i] (zero where the
// pick sits at the clamp's floor, is FLT_MAX, or is the anchor itself:
// those distances carry no gradient) and S = M + M^T,
//
//   grad_h = rowsum(S) * f_h - S @ f_h.
//
// Grid (column tiles of 128, bands of 16 anchors, H). Each block builds its
// band's 16 rows of S, stored transposed, in shared memory from the 2B
// picks (M's own entries, then the transposed ones, in two
// barrier-separated passes that never write one entry twice), after one
// round trip that loads the picks and the features together (a first
// form that loaded a pick's d, i and g one after another, with one thread
// per column, took about twice as long); then each thread walks j = 0..B-1
// in order for one column of 8 of the band's gradient rows and their row
// sums of S, reading S's column j as float4 broadcasts: deterministic, no
// atomics.
//
// The head table: up to 64 heads, a __grid_constant__ kernel parameter
// (64 pointers, 512 bytes) indexed by blockIdx directly (sm_70 and later
// read a dynamic index of such a parameter in place, without the copy to
// local memory that a plain by-value struct takes); more heads, a device
// array of pointers that the wrapper copies up before the launch. Both
// are one template of each kernel (ParamTable, DeviceTable).
//
// Long schedule (B > 256). The cluster design cannot stretch past 256:
// each cluster pushes a 16 x B partial Gram through distributed shared
// memory, and the backward keeps a 16 x B band of S in shared memory.
// Bound at (H, B, D) = (5, 2048, 2048): the Grams' 2 H B^2 D = 86 GFLOP
// over the FP32 pipe's 67 TFLOP/s, 1.28 ms; the features are 84 MB (25
// us of HBM time). The forward is operations-bound, the backward bytes-
// bound (it reads the features and writes as many gradient bytes).
//
// Long forward: two kernels. hard_mine_long_tile_kernel, grid (column
// tiles, anchor tiles, H), makes one BM x BM tile of a head's fp32 Gram
// on the FP32 pipe (BM = 128, 8 x 8 per thread; BM = 64, 4 x 4, where
// 128-row tiles would fill less than one wave of the card): k tiles of 8
// through double-buffered shared memory, each output an fmaf chain in k
// order. Plain TF32 is not used: the quadratic form cancels near zero
// distance, where the hardest positive lies. The block's threads also
// chain the norms of its rows and columns in that same k order, so sq_i
// is the Gram's own diagonal value and d2_ii is exactly 0 in whichever
// tile holds it. Each tile mines its rows over its columns (masks, clamp,
// +-FLT_MAX, lowest index on ties) into (H, tiles, B) partials;
// hard_mine_long_merge_kernel merges them in tile order. The max and min
// with the lowest-index rule give the same answer in any order, so the
// result does not depend on which tile ran first.
//
// Pick-based backward, B > 96: grad_r = sum over the picks that touch row
// r of w (f_r - f_other), w = g / d: anchor r's own two picks, then every
// anchor whose pick is r, in anchor order. O(B D) FMAs a head, where S @ f
// costs B^2 D. It takes any B, but its list walk is a chain of dependent
// loads, ~14 us at B = 16 against the S-matrix kernel's 3.0; the S-matrix
// kernel grows as B^2 and loses from B = 128 (H = 5, D = 2048: 0.0163 vs
// 0.0181 ms at B = 96, 0.0263 vs 0.0177 at 128; NVIDIA H100 80GB HBM3,
// 700 W, agrl_torch/kernels/triplet_forks.py), hence kShortBackwardBatch.
// hard_mine_long_backward_kernel, grid (columns / 1024, bands of 16 rows,
// H): each block scans every anchor's two picks (in segments of 2048
// anchors) and appends, in anchor order, the live ones that land in its
// band to a list in shared memory (a block-wide ordered compaction:
// ballots and warp counts, no atomics); then each thread, for its four
// columns, walks the list in order and adds w * f_source into the band
// row's accumulator in shared memory; thread 0 sums each row's weights in
// the same order. The gradient is rowsum * f_r - acc, the S-matrix
// backward's form. Fixed order, no atomics: two runs give the same bits.
//
// Limits: H <= 65535 heads and B <= 65535 x 16 (grid dimensions), of one
// shape; any D (the wrapper pads D to a multiple of 4 with zero columns,
// which change no distance, and slices the gradient back). The long
// forward's partials take 16 H B ceil(B / 64) bytes of device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;            // blocks per (head, band): the portable cluster size
constexpr int kBand = 16;              // anchors per cluster
constexpr int kShortBatch = 256;       // the largest B of the cluster schedule
// the largest B of the S-matrix backward; the pick-based one takes larger B
// (where it is the faster on the card: see the header)
constexpr int kShortBackwardBatch = 96;
static_assert(kShortBackwardBatch <= kShortBatch, "S (ST below) holds kShortBatch columns");
constexpr int kParamHeads = 64;        // heads the parameter table holds
constexpr int kMaxGrid = 65535;        // gridDim.y and gridDim.z
constexpr int kRingBytes = 64 * 1024;  // the staging ring, both stages
constexpr int kHalfBand = kBand / 2;   // band rows per backward thread
constexpr int kBwColumns = kThreads / 2;  // columns per backward block, two threads each
// the k-split partials: kg x (16 x tiles + 1) floats, with kg x tiles <= kThreads
constexpr int kRed = 17 * kThreads;
// the long schedule
constexpr int kTileK = 8;                       // Gram k tile
constexpr int kMinTile = 64;                    // the smaller Gram tile (BM)
constexpr int kLongBand = 16;                   // backward rows a block
constexpr int kLongSeg = 2048;                  // anchors scanned per list fill
constexpr int kLongList = 2 * kLongSeg + 2 * kLongBand;  // list entries: picks of a segment, own picks
constexpr int kMaxBatch = kMaxGrid * kLongBand;

// The heads' pointers, indexed by head: in the launch's parameters (up to
// kParamHeads) or in a device array.
template <class P>
struct ParamTable {
  P p[kParamHeads];
  __device__ __forceinline__ P operator[](int h) const { return p[h]; }
};
template <class P>
struct DeviceTable {
  const P* p;
  __device__ __forceinline__ P operator[](int h) const { return p[h]; }
};

// float4 columns per staged chunk, and the ring's stages (1 when one chunk
// holds a block's whole slice)
__host__ __device__ inline int chunk4(int B, int n4) {
  const int slice = (n4 + kCluster - 1) / kCluster;
  const int cap = kRingBytes / (2 * B * 16) - 1;  // one float4 of padding per row
  return slice < cap ? (slice > 0 ? slice : 1) : cap;
}
__host__ __device__ inline int ring_stages(int B, int n4) {
  const int slice = (n4 + kCluster - 1) / kCluster;
  return slice > chunk4(B, n4) ? 2 : 1;
}
// bytes of the forward's dynamic shared memory: labels, ring, k-split
// partials, then the partials its peers push (Gram rows, norms)
__host__ __device__ inline int labels_bytes(int B) { return (8 * B + 15) / 16 * 16; }
__host__ inline size_t forward_smem(int B, int n4) {
  const size_t ring = (size_t)ring_stages(B, n4) * B * (chunk4(B, n4) + 1) * 16;
  return labels_bytes(B) + ring + (size_t)(kRed + 3 * kCluster * B) * 4;
}
// the most any call takes: the largest B with a two-stage ring (any D)
__host__ inline size_t forward_smem_max() { return forward_smem(kShortBatch, kCluster << 20); }
// the long backward's: the band's accumulators, then the list
constexpr size_t kLongBackwardSmem =
    (size_t)kLongBand * kThreads * 16 + (size_t)kLongList * 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 or 8 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// <a, b> over n float4s in a fixed order: four FMA chains, then (x + y) + (z + w)
__device__ __forceinline__ float dot4(const float4* a, const float4* b, int n) {
  float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
  for (int c = 0; c < n; ++c) {
    const float4 p = a[c];
    const float4 q = b[c];
    x = fmaf(p.x, q.x, x);
    y = fmaf(p.y, q.y, y);
    z = fmaf(p.z, q.z, z);
    w = fmaf(p.w, q.w, w);
  }
  return (x + y) + (z + w);
}

// (value, index) pair reductions with the lowest index winning ties.
__device__ __forceinline__ void keep_max(float& v, int& k, float v2, int k2) {
  if (v2 > v || (v2 == v && k2 < k)) { v = v2; k = k2; }
}

__device__ __forceinline__ void keep_min(float& v, int& k, float v2, int k2) {
  if (v2 < v || (v2 == v && k2 < k)) { v = v2; k = k2; }
}

template <class Heads>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
hard_mine_heads_kernel(const __grid_constant__ Heads heads, const long long* __restrict__ labels,
                       int B, int D,
                       float* __restrict__ d_ap, float* __restrict__ d_an,
                       long long* __restrict__ i_ap, long long* __restrict__ i_an) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int i0 = (blockIdx.x / kCluster) * kBand;
  const int rows = min(kBand, B - i0);  // anchors of this band
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this block's float4 columns [c_lo, c_hi), in chunks of kc4
  const int n4 = D / 4;
  const int c_lo = rank * n4 / kCluster;
  const int c_hi = (rank + 1) * n4 / kCluster;
  const int kc4 = chunk4(B, n4);
  const int stages = ring_stages(B, n4);
  const int nch = (c_hi - c_lo + kc4 - 1) / kc4;
  const int stride = kc4 + 1;  // float4s per staged row: one of padding spreads the banks

  extern __shared__ __align__(16) unsigned char smem[];
  long long* lab = reinterpret_cast<long long*>(smem);                // (B,)
  float4* ring = reinterpret_cast<float4*>(smem + labels_bytes(B));   // (stages, B, stride)
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * B * stride);  // (kg, 16 tiles + 1)
  float* recv_g = red + kRed;                   // (kCluster, 2, B): from rank r, Gram row of slot
  float* recv_sq = recv_g + 2 * kCluster * B;   // (kCluster, B): from rank r, the norms
  const float4* f4 = reinterpret_cast<const float4*>(heads[h]);

  auto issue = [&](int k) {  // every thread: its float4s of chunk k into stage k % stages
    const int s = k % stages;
    const int c0 = c_lo + k * kc4;
    const int w = min(kc4, c_hi - c0);
    for (int e = threadIdx.x; e < B * w; e += kThreads) {
      const int r = e / w, c = e - r * w;
      cp_async16(ring + ((size_t)s * B + r) * stride + c, f4 + (size_t)r * n4 + c0 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the labels land with the first chunk (B <= kThreads)
  if (threadIdx.x < B) cp_async8(lab + threadIdx.x, labels + threadIdx.x);
  if (nch == 0) asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; k < stages && k < nch; ++k) issue(k);
  // this block runs: from the matching wait on, peers may write its shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();

  // The band's Gram rows against every row in 4 x 4 tiles, each tile's
  // columns split over kg threads (kg x tiles <= kThreads); the norms of
  // the rows outside the band, one thread each (B - rows < kThreads).
  const int tcols = (B + 3) / 4;
  const int ntiles = ((rows + 3) / 4) * tcols;
  int kg = 1;
  while (2 * kg * ntiles <= kThreads) kg *= 2;
  const int tile = threadIdx.x / kg, q = threadIdx.x % kg;
  const bool active = tile < ntiles;
  int ra[4], rb[4];  // staged rows of the tile, clamped (the clamped outputs are dropped)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ra[e] = i0 + min(4 * (tile / tcols) + e, rows - 1);
    rb[e] = min(4 * (tile % tcols) + e, B - 1);
  }
  float acc[4][4] = {};
  const int jn = threadIdx.x < i0 ? threadIdx.x : threadIdx.x + rows;  // this thread's norm row
  const bool norm = threadIdx.x < B - rows;
  float nrm = 0.f;
  for (int k = 0; k < nch; ++k) {
    const int s = k % stages;
    if (k + 1 < nch && stages == 2)  // chunk k + 1 may stay in flight
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk k from every thread's copies
    const float4* buf = ring + (size_t)s * B * stride;
    const int w = min(kc4, c_hi - (c_lo + k * kc4));
    if (active) {
      for (int c = q; c < w; c += kg) {  // fixed column order: the same sums in every run
        float4 a[4], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = buf[(size_t)ra[e] * stride + c];
          b[e] = buf[(size_t)rb[e] * stride + c];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            acc[x][y] = fmaf(a[x].x, b[y].x, acc[x][y]);
            acc[x][y] = fmaf(a[x].y, b[y].y, acc[x][y]);
            acc[x][y] = fmaf(a[x].z, b[y].z, acc[x][y]);
            acc[x][y] = fmaf(a[x].w, b[y].w, acc[x][y]);
          }
      }
    }
    if (norm) nrm += dot4(buf + (size_t)jn * stride, buf + (size_t)jn * stride, w);
    __syncthreads();  // every thread is done with stage s
    if (k + stages < nch) issue(k + stages);
  }
  if (nch == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the labels
  const int n_out = 16 * ntiles;
  if (active)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) red[q * (n_out + 1) + tile * 16 + x * 4 + y] = acc[x][y];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer runs
  __syncthreads();

  // Push this block's partials to the blocks that finish each anchor (band
  // row a goes to rank a % 8, slot a / 8); every block takes all norms.
  // The band's norms are its Gram diagonal, the same value, so d2_ii is 0.
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    float v = 0.f;
#pragma unroll 4
    for (int g = 0; g < kg; ++g) v += red[g * (n_out + 1) + o];
    const int tl = o / 16;
    const int a = 4 * (tl / tcols) + (o % 16) / 4, b = 4 * (tl % tcols) + o % 4;
    if (a < rows && b < B) {
      cluster.map_shared_rank(recv_g, a % kCluster)[(rank * 2 + a / kCluster) * B + b] = v;
      if (b == i0 + a)
        for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(recv_sq, r)[rank * B + b] = v;
    }
  }
  if (norm)
    for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(recv_sq, r)[rank * B + jn] = nrm;
  cluster.sync();  // every partial has landed in the block that sums it

  // anchors rank and rank + 8 of the band, one warp each, from local
  // shared memory alone; no peer reads this block's memory, so it may exit
  for (int t = rank + kCluster * warp; t < rows; t += kCluster * kWarps) {
    const int i = i0 + t;
    const float* gs = recv_g + (t / kCluster) * B;
    const long long li = lab[i];
    float sq_i = 0.f;
    for (int r = 0; r < kCluster; ++r) sq_i += recv_sq[r * B + i];
    // sentinels lose to every real entry, masked ones included
    float v_ap = -INFINITY, v_an = INFINITY;
    int k_ap = B, k_an = B;
    for (int j = lane; j < B; j += 32) {
      float g = 0.f, sq_j = 0.f;
      for (int r = 0; r < kCluster; ++r) {  // rank order: the same sums in every run
        g += gs[r * 2 * B + j];
        sq_j += recv_sq[r * B + j];
      }
      const float dist = sqrtf(fmaxf(sq_i + sq_j - 2.0f * g, 1e-12f));
      const bool pos = lab[j] == li;
      keep_max(v_ap, k_ap, pos ? dist : -FLT_MAX, j);
      keep_min(v_an, k_an, pos ? FLT_MAX : dist, j);
    }
    for (int o = 16; o > 0; o >>= 1) {
      keep_max(v_ap, k_ap, __shfl_xor_sync(0xffffffffu, v_ap, o),
               __shfl_xor_sync(0xffffffffu, k_ap, o));
      keep_min(v_an, k_an, __shfl_xor_sync(0xffffffffu, v_an, o),
               __shfl_xor_sync(0xffffffffu, k_an, o));
    }
    if (lane == 0) {
      const size_t out = (size_t)h * B + i;
      d_ap[out] = v_ap;
      i_ap[out] = k_ap;
      d_an[out] = v_an;
      i_an[out] = k_an;
    }
  }
}

// Row `row`'s two picks as M's entries: w[p] = g / d at column k[p], or 0
// where the distance carries no gradient. Its six loads do not wait on
// each other.
__device__ __forceinline__ void row_picks(size_t at, int row, const float* d_ap,
                                          const float* d_an, const long long* i_ap,
                                          const long long* i_an, const float* g_ap,
                                          const float* g_an, float dist_min, float (&w)[2],
                                          int (&k)[2]) {
  const float d[2] = {d_ap[at], d_an[at]};
  const long long kk[2] = {i_ap[at], i_an[at]};
  const float g[2] = {g_ap ? g_ap[at] : 0.f, g_an ? g_an[at] : 0.f};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    k[p] = (int)kk[p];
    w[p] = d[p] > dist_min && d[p] < FLT_MAX && k[p] != row ? g[p] / d[p] : 0.f;
  }
}

template <class Heads, class Grads>
__global__ void __launch_bounds__(kThreads)
hard_mine_heads_backward_kernel(const __grid_constant__ Heads heads,
                                const __grid_constant__ Grads grads, int B, int D,
                                const float* __restrict__ d_ap, const float* __restrict__ d_an,
                                const long long* __restrict__ i_ap,
                                const long long* __restrict__ i_an,
                                const float* __restrict__ g_ap, const float* __restrict__ g_an,
                                float dist_min) {
  // S^T for the band: ST[j * kBand + t] = S[i0 + t, j], S = M + M^T
  __shared__ __align__(16) float ST[kShortBatch * kBand];
  const int tid = threadIdx.x;
  const int h = blockIdx.z;
  const int i0 = blockIdx.y * kBand;
  const int rows = min(kBand, B - i0);
  const size_t base = (size_t)h * B;
  // two threads per column, each for half of the band's rows
  const int c = blockIdx.x * kBwColumns + tid % kBwColumns;
  const int t0 = (tid / kBwColumns) * kHalfBand;
  const bool col = c < D;
  const float* f = heads[h];

  // this column of the first 16 rows and of this thread's band rows, and
  // this thread's picks (row tid's, for M^T, and band row i0 + tid's, for
  // M; B <= kThreads), all loaded before anything waits on them
  float x0[kBand], xb[kHalfBand];
#pragma unroll
  for (int t = 0; t < kBand; ++t) x0[t] = col && t < B ? f[(size_t)t * D + c] : 0.f;
#pragma unroll
  for (int t = 0; t < kHalfBand; ++t)
    xb[t] = col && t0 + t < rows ? f[(size_t)(i0 + t0 + t) * D + c] : 0.f;
  float wj[2] = {0.f, 0.f}, wi[2] = {0.f, 0.f};
  int kj[2] = {0, 0}, ki[2] = {0, 0};
  if (tid < B) row_picks(base + tid, tid, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min, wj, kj);
  if (tid < rows)
    row_picks(base + i0 + tid, i0 + tid, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min, wi, ki);
  for (int e = tid; e < kBand * B; e += kThreads) ST[e] = 0.f;
  __syncthreads();
  // M's own entries of the band's rows (a row's two picks are distinct columns)
  for (int p = 0; p < 2; ++p)
    if (wi[p] != 0.f) ST[ki[p] * kBand + tid] = wi[p];
  __syncthreads();
  // M^T: row tid's picks that land in the band (row tid of ST is this thread's alone)
  for (int p = 0; p < 2; ++p)
    if (wj[p] != 0.f && kj[p] >= i0 && kj[p] < i0 + rows) ST[tid * kBand + kj[p] - i0] += wj[p];
  __syncthreads();
  if (!col) return;

  // acc[t] += S[i0 + t0 + t, j] * f[j, c] and rs[t] += S[i0 + t0 + t, j], j in order
  float acc[kHalfBand], rs[kHalfBand];
#pragma unroll
  for (int t = 0; t < kHalfBand; ++t) acc[t] = rs[t] = 0.f;
  auto add_row = [&](int j, float x) {
    const float4* s4 = reinterpret_cast<const float4*>(ST + j * kBand + t0);
#pragma unroll
    for (int u = 0; u < kHalfBand / 4; ++u) {
      const float4 sv = s4[u];
      const float sj[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[4 * u + e] = fmaf(sj[e], x, acc[4 * u + e]);
        rs[4 * u + e] += sj[e];
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kBand; ++j)
    if (j < B) add_row(j, x0[j]);
  for (int j = kBand; j < B; ++j) add_row(j, f[(size_t)j * D + c]);
  float* g = grads[h];
#pragma unroll
  for (int t = 0; t < kHalfBand; ++t)
    if (t0 + t < rows) g[(size_t)(i0 + t0 + t) * D + c] = rs[t] * xb[t] - acc[t];
}

// ---- the long schedule (B > kShortBatch) ------------------------------------

// One BM x BM tile of head h's Gram (anchor rows i0.., columns j0..), BM =
// 16 TM, each thread TM x TM outputs: rows and columns g * 64 + (ty or tx)
// * 4 + e. Then each anchor row's masked max and min over the tile's
// columns into the partials (H, tiles, B): part_v (d_ap, d_an), part_k
// (i_ap, i_an). D % 4 == 0.
template <int TM, class Heads>
__global__ void __launch_bounds__(kThreads)
hard_mine_long_tile_kernel(const __grid_constant__ Heads heads, const long long* __restrict__ labels,
                           int B, int D, float2* __restrict__ part_v, int2* __restrict__ part_k) {
  constexpr int BM = 16 * TM;
  constexpr int kG = TM / 4;           // float4 groups of a thread's rows (and columns)
  constexpr int kLoads = BM / 64;      // float4s a thread stages per k tile
  constexpr int LD = BM + 4;           // staged row length: float4-aligned
  __shared__ __align__(16) float As[2][kTileK][LD];  // anchor rows, k-major
  __shared__ __align__(16) float Bs[2][kTileK][LD];  // column rows, k-major
  __shared__ float sq[2][BM];                        // their norms
  __shared__ long long lab[2][BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BM;
  const int n4 = D / 4;
  const int nk = (n4 + 1) / 2;  // k tiles: two float4 columns each
  const float4* f4 = reinterpret_cast<const float4*>(heads[h]);

  // staging: float4 e = tid + s * kThreads of the 4 BM a k tile holds
  // (operand, row, half); rows past B and columns past D stage zeros
  const float4* src[kLoads];
  float* dst[kLoads];
  bool live[kLoads];
  int half[kLoads];
#pragma unroll
  for (int s = 0; s < kLoads; ++s) {
    const int e = tid + s * kThreads;
    const int op = e / (2 * BM), idx = e % (2 * BM);
    const int r = idx >> 1;
    half[s] = idx & 1;
    const int row = (op ? j0 : i0) + r;
    live[s] = row < B;
    src[s] = f4 + (size_t)min(row, B - 1) * n4 + half[s];
    dst[s] = (op ? &Bs[0][0][0] : &As[0][0][0]) + 4 * half[s] * LD + r;
  }
  float4 v[kLoads];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s)
      v[s] = live[s] && 2 * kt + half[s] < n4 ? src[s][2 * kt] : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      float* d = dst[s] + buf * kTileK * LD;
      d[0] = v[s].x;
      d[LD] = v[s].y;
      d[2 * LD] = v[s].z;
      d[3 * LD] = v[s].w;
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TM; ++y) acc[x][y] = 0.f;
  float nrm = 0.f;  // thread t < 2 BM: the norm of staged row t % BM of operand t / BM
  const float* nsrc = tid < BM ? &As[0][0][tid] : &Bs[0][0][(tid - BM) % BM];
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float a[TM], b[TM];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(&As[buf][k][g * 64 + ty * 4]);
        const float4 y = *reinterpret_cast<const float4*>(&Bs[buf][k][g * 64 + tx * 4]);
        a[4 * g] = x.x, a[4 * g + 1] = x.y, a[4 * g + 2] = x.z, a[4 * g + 3] = x.w;
        b[4 * g] = y.x, b[4 * g + 1] = y.y, b[4 * g + 2] = y.z, b[4 * g + 3] = y.w;
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TM; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
    // the norms in the products' k order: the diagonal's own value
    if (tid < 2 * BM) {
      const float* col = nsrc + buf * kTileK * LD;
#pragma unroll
      for (int k = 0; k < kTileK; ++k) nrm = fmaf(col[k * LD], col[k * LD], nrm);
    }
    if (kt + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }
  if (tid < 2 * BM) {
    const int op = tid / BM, r = tid % BM;
    const int row = (op ? j0 : i0) + r;
    sq[op][r] = nrm;
    lab[op][r] = row < B ? labels[row] : 0;
  }
  __syncthreads();

#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int r = (x / 4) * 64 + ty * 4 + x % 4;
    const float sq_i = sq[0][r];
    const long long li = lab[0][r];
    // sentinels lose to every real entry, masked ones included
    float v_ap = -INFINITY, v_an = INFINITY;
    int k_ap = B, k_an = B;
#pragma unroll
    for (int y = 0; y < TM; ++y) {
      const int c = (y / 4) * 64 + tx * 4 + y % 4;
      const int j = j0 + c;
      if (j < B) {
        const float dist = sqrtf(fmaxf(sq_i + sq[1][c] - 2.0f * acc[x][y], 1e-12f));
        const bool pos = lab[1][c] == li;
        keep_max(v_ap, k_ap, pos ? dist : -FLT_MAX, j);
        keep_min(v_an, k_an, pos ? FLT_MAX : dist, j);
      }
    }
    for (int o = 8; o > 0; o >>= 1) {  // over the 16 threads of the row (one half warp)
      keep_max(v_ap, k_ap, __shfl_xor_sync(0xffffffffu, v_ap, o),
               __shfl_xor_sync(0xffffffffu, k_ap, o));
      keep_min(v_an, k_an, __shfl_xor_sync(0xffffffffu, v_an, o),
               __shfl_xor_sync(0xffffffffu, k_an, o));
    }
    if (tx == 0 && i0 + r < B) {
      const size_t out = ((size_t)h * gridDim.x + blockIdx.x) * B + i0 + r;
      part_v[out] = make_float2(v_ap, v_an);
      part_k[out] = make_int2(k_ap, k_an);
    }
  }
}

// The tiles' partials of each (h, i), merged in tile order.
__global__ void __launch_bounds__(kThreads)
hard_mine_long_merge_kernel(const float2* __restrict__ part_v, const int2* __restrict__ part_k,
                            int H, int B, int tiles, float* __restrict__ d_ap,
                            float* __restrict__ d_an, long long* __restrict__ i_ap,
                            long long* __restrict__ i_an) {
  const size_t at = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (at >= (size_t)H * B) return;
  const size_t h = at / B, i = at % B;
  float v_ap = -INFINITY, v_an = INFINITY;
  int k_ap = B, k_an = B;
  for (int t = 0; t < tiles; ++t) {
    const size_t in = (h * tiles + t) * B + i;
    const float2 v = part_v[in];
    const int2 k = part_k[in];
    keep_max(v_ap, k_ap, v.x, k.x);
    keep_min(v_an, k_an, v.y, k.y);
  }
  d_ap[at] = v_ap;
  i_ap[at] = k_ap;
  d_an[at] = v_an;
  i_an[at] = k_an;
}

// Appends each thread's entries (e0 before e1, thread order) to list[n..]
// and returns the new length: a block-wide ordered compaction. Every
// thread of the block calls it.
__device__ __forceinline__ int append(int2* list, int n, int* warp_n, bool e0, int2 v0, bool e1,
                                      int2 v1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b0 = __ballot_sync(0xffffffffu, e0), b1 = __ballot_sync(0xffffffffu, e1);
  const unsigned lt = (1u << lane) - 1u;
  if (lane == 0) warp_n[warp] = __popc(b0) + __popc(b1);
  __syncthreads();
  int at = n, total = n;
  for (int w = 0; w < kWarps; ++w) {
    at += w < warp ? warp_n[w] : 0;
    total += warp_n[w];
  }
  at += __popc(b0 & lt) + __popc(b1 & lt);
  if (e0) list[at++] = v0;
  if (e1) list[at] = v1;
  __syncthreads();  // every thread has read warp_n
  return total;
}

// The gradient of the picked distances for bands of kLongBand rows (any B).
// A list entry is (source row * kLongBand + band row, the weight's bits).
template <class Heads, class Grads>
__global__ void __launch_bounds__(kThreads)
hard_mine_long_backward_kernel(const __grid_constant__ Heads heads,
                               const __grid_constant__ Grads grads, int B, int D,
                               const float* __restrict__ d_ap, const float* __restrict__ d_an,
                               const long long* __restrict__ i_ap,
                               const long long* __restrict__ i_an,
                               const float* __restrict__ g_ap, const float* __restrict__ g_an,
                               float dist_min) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* acc = reinterpret_cast<float4*>(smem);                  // (kLongBand, kThreads)
  int2* list = reinterpret_cast<int2*>(acc + kLongBand * kThreads);  // (kLongList,)
  __shared__ float rs[kLongBand];
  __shared__ int warp_n[kWarps];
  const int tid = threadIdx.x;
  const int h = blockIdx.z;
  const int i0 = blockIdx.y * kLongBand;
  const int rows = min(kLongBand, B - i0);
  const int n4 = D / 4;
  const int c4 = blockIdx.x * kThreads + tid;  // this thread's float4 column
  const bool col = c4 < n4;
  const size_t base = (size_t)h * B;
  const float4* f4 = reinterpret_cast<const float4*>(heads[h]);
#pragma unroll
  for (int t = 0; t < kLongBand; ++t) acc[t * kThreads + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < kLongBand) rs[tid] = 0.f;

  // the band rows' own picks first
  int2 v[2] = {make_int2(0, 0), make_int2(0, 0)};
  bool e[2] = {false, false};
  if (tid < rows) {
    float w[2];
    int k[2];
    row_picks(base + i0 + tid, i0 + tid, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min, w, k);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      e[p] = w[p] != 0.f;
      v[p] = make_int2(k[p] * kLongBand + tid, __float_as_int(w[p]));
    }
  }
  int n = append(list, 0, warp_n, e[0], v[0], e[1], v[1]);
  for (int s0 = 0; s0 < B; s0 += kLongSeg) {
    // every anchor of the segment whose pick lands in the band, in anchor order
    const int s1 = min(B, s0 + kLongSeg);
    for (int a0 = s0; a0 < s1; a0 += kThreads) {
      const int a = a0 + tid;
      e[0] = e[1] = false;
      if (a < s1) {
        const long long kk[2] = {i_ap[base + a], i_an[base + a]};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int k = (int)kk[p];
          if (k >= i0 && k < i0 + rows && k != a) {
            const float d = (p ? d_an : d_ap)[base + a];
            const float* gp = p ? g_an : g_ap;
            const float g = gp ? gp[base + a] : 0.f;
            const float w = d > dist_min && d < FLT_MAX ? g / d : 0.f;
            e[p] = w != 0.f;
            v[p] = make_int2(a * kLongBand + k - i0, __float_as_int(w));
          }
        }
      }
      n = append(list, n, warp_n, e[0], v[0], e[1], v[1]);
    }
    // the list in order: acc[t] += w * f_source, rs[t] += w (thread 0)
    for (int q = 0; q < n; q += 4) {
      int2 en[4];
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) en[u] = q + u < n ? list[q + u] : make_int2(0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = col ? f4[(size_t)(en[u].x / kLongBand) * n4 + c4] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q + u < n) {
          const int t = en[u].x % kLongBand;
          const float w = __int_as_float(en[u].y);
          float4& s = acc[t * kThreads + tid];
          s.x = fmaf(w, x[u].x, s.x);
          s.y = fmaf(w, x[u].y, s.y);
          s.z = fmaf(w, x[u].z, s.z);
          s.w = fmaf(w, x[u].w, s.w);
          if (tid == 0) rs[t] += w;
        }
      }
    }
    n = 0;
    __syncthreads();  // the list is read through; rs is whole after the last segment
  }
  if (!col) return;
  float4* g4 = reinterpret_cast<float4*>(grads[h]);
  for (int t = 0; t < rows; ++t) {
    const size_t at = (size_t)(i0 + t) * n4 + c4;
    const float4 x = f4[at];
    const float4 s = acc[t * kThreads + tid];
    const float r = rs[t];
    g4[at] = make_float4(r * x.x - s.x, r * x.y - s.y, r * x.z - s.z, r * x.w - s.w);
  }
}

__global__ void empty_kernel() {}

bool check_heads(int H, int B, int D) {
  return H > 0 && H <= kMaxGrid && B > 0 && B <= kMaxBatch && D > 0 && D % 4 == 0;
}

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return count;
}

size_t long_tiles(int B) { return (B + kMinTile - 1) / kMinTile; }

template <class Heads>
cudaError_t forward_launch(const Heads& hs, int H, const long long* labels, int B, int D,
                           float* d_ap, float* d_an, long long* i_ap, long long* i_an,
                           void* scratch, cudaStream_t stream) {
  if (B <= kShortBatch) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        hard_mine_heads_kernel<Heads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)forward_smem_max());
    if (attr != cudaSuccess) return attr;
    const dim3 grid(kCluster * ((B + kBand - 1) / kBand), H);
    hard_mine_heads_kernel<Heads><<<grid, kThreads, forward_smem(B, D / 4), stream>>>(
        hs, labels, B, D, d_ap, d_an, i_ap, i_an);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  // 128-row tiles where they fill a wave of the card, else 64-row ones
  const long long t128 = (B + 127) / 128;
  const bool wide = (long long)H * t128 * t128 >= sm_count();
  const int tiles = wide ? (int)t128 : (int)long_tiles(B);
  float2* part_v = static_cast<float2*>(scratch);
  int2* part_k = reinterpret_cast<int2*>(part_v + (size_t)H * long_tiles(B) * B);
  const dim3 grid(tiles, tiles, H);
  if (wide)
    hard_mine_long_tile_kernel<8, Heads><<<grid, kThreads, 0, stream>>>(hs, labels, B, D,
                                                                        part_v, part_k);
  else
    hard_mine_long_tile_kernel<4, Heads><<<grid, kThreads, 0, stream>>>(hs, labels, B, D,
                                                                        part_v, part_k);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const size_t n = (size_t)H * B;
  hard_mine_long_merge_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part_v, part_k, H, B, tiles, d_ap, d_an, i_ap, i_an);
  return cudaGetLastError();
}

template <class Heads, class Grads>
cudaError_t backward_launch(const Heads& hs, const Grads& gs, int H, int B, int D,
                            const float* d_ap, const float* d_an, const long long* i_ap,
                            const long long* i_an, const float* g_ap, const float* g_an,
                            float dist_min, cudaStream_t stream) {
  if (B <= kShortBackwardBatch) {
    const dim3 grid((D + kBwColumns - 1) / kBwColumns, (B + kBand - 1) / kBand, H);
    hard_mine_heads_backward_kernel<Heads, Grads><<<grid, kThreads, 0, stream>>>(
        hs, gs, B, D, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min);
    return cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      hard_mine_long_backward_kernel<Heads, Grads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kLongBackwardSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((D / 4 + kThreads - 1) / kThreads, (B + kLongBand - 1) / kLongBand, H);
  hard_mine_long_backward_kernel<Heads, Grads><<<grid, kThreads, kLongBackwardSmem, stream>>>(
      hs, gs, B, D, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest head count and batch the kernels take (grid dimensions), the
// largest batch of the cluster schedule, and how many heads the launch's
// parameter table holds (more take a device table). Any D % 4 == 0.
int hard_mine_max_heads() { return kMaxGrid; }
int hard_mine_max_batch() { return kMaxBatch; }
int hard_mine_short_max_batch() { return kShortBatch; }
int hard_mine_param_heads() { return kParamHeads; }

// Bytes of device scratch the forward takes at (H, B): the long
// schedule's partials, 0 for the cluster schedule.
long long hard_mine_scratch_bytes(int H, int B) {
  return B <= kShortBatch ? 0 : (long long)H * long_tiles(B) * B * 16;
}

// heads: H pointers (a host array) to (B, D) fp32 features, 16-byte
// aligned; table: null (H <= hard_mine_param_heads()), or a device array
// of the same H pointers; labels (B,) int64; d_ap, d_an (H, B) fp32; i_ap,
// i_an (H, B) int64; scratch: hard_mine_scratch_bytes(H, B) bytes, 16-byte
// aligned (unused at B <= 256). All contiguous, on the current device.
// Returns 0 or the cudaError_t of a launch.
int hard_mine_heads_forward(const void* const* heads, const void* table, int H,
                            const long long* labels, int B, int D, float* d_ap, float* d_an,
                            long long* i_ap, long long* i_an, void* scratch, void* stream) {
  if (!check_heads(H, B, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table != nullptr)
    return (int)forward_launch(DeviceTable<const float*>{static_cast<const float* const*>(table)},
                               H, labels, B, D, d_ap, d_an, i_ap, i_an, scratch, st);
  if (H > kParamHeads) return (int)cudaErrorInvalidValue;
  ParamTable<const float*> hs{};
  for (int h = 0; h < H; ++h) hs.p[h] = static_cast<const float*>(heads[h]);
  return (int)forward_launch(hs, H, labels, B, D, d_ap, d_an, i_ap, i_an, scratch, st);
}

// The gradient of the picked distances: grads[h] (B, D) fp32 from the
// forward's d_ap, d_an, i_ap, i_an (H, B) and the incoming g_ap, g_an
// (H, B) fp32, either of which may be null (no gradient). table: null
// (H <= hard_mine_param_heads()), or a device array of the H head
// pointers followed by the H gradient pointers. dist_min is the clamp's
// floor sqrt(1e-12) in fp32. Returns 0 or the cudaError_t.
int hard_mine_heads_backward(const void* const* heads, void* const* grads, const void* table,
                             int H, int B, int D, const float* d_ap, const float* d_an,
                             const long long* i_ap, const long long* i_an, const float* g_ap,
                             const float* g_an, float dist_min, void* stream) {
  if (!check_heads(H, B, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    void* const* t = static_cast<void* const*>(const_cast<void*>(table));
    return (int)backward_launch(
        DeviceTable<const float*>{reinterpret_cast<const float* const*>(t)},
        DeviceTable<float*>{reinterpret_cast<float* const*>(t + H)}, H, B, D, d_ap, d_an, i_ap,
        i_an, g_ap, g_an, dist_min, st);
  }
  if (H > kParamHeads) return (int)cudaErrorInvalidValue;
  ParamTable<const float*> hs{};
  ParamTable<float*> gs{};
  for (int h = 0; h < H; ++h) {
    hs.p[h] = static_cast<const float*>(heads[h]);
    gs.p[h] = static_cast<float*>(grads[h]);
  }
  return (int)backward_launch(hs, gs, H, B, D, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min, st);
}

// An empty kernel: the time of one launch on the stream, as a yardstick.
int hard_mine_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* hard_mine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
