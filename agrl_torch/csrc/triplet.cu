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
// are one template of each kernel (ParamTable, DeviceTable). The long
// forward keeps it: it brings its operand rows with cp.async from these
// pointers, 16 bytes a thread (rows are 16-byte aligned: the wrapper pads
// D to a multiple of 4), and needs no TMA tensor map. A map is 128 bytes,
// so 64 of them do not fit in a launch's parameters, and maps in a device
// array would take a fence and a host-side encode per head per call; the
// threads split every chunk into hi and lo planes anyway, so a copy engine
// would spare them little.
//
// Long schedule (B > 256). The cluster design cannot stretch past 256:
// each cluster pushes a 16 x B partial Gram through distributed shared
// memory, and the backward keeps a 16 x B band of S in shared memory.
// Bound at (H, B, D) = (5, 2048, 2048): the Grams' upper halves, H B (B +
// 1) D = 43 GFLOP, in three tf32 passes at 495 TFLOP/s, 0.26 ms (on the
// FP32 pipe the whole Grams, 86 GFLOP at 67 TFLOP/s, take 1.28 ms); the
// features are 84 MB (25 us of HBM time). The forward is operations-bound,
// the backward bytes-bound (it reads the features and writes as many
// gradient bytes).
//
// Long forward: three kernels. hard_mine_gram_kernel<T, DIAG> makes a T x
// T tile of a head's Gram (T = 128 rows, two warpgroups; T = 64, one,
// where 128-row upper tiles would fill less than one wave of the card) in
// 3xTF32 on the tensor cores, as K1's long Gram (graph_conv.cu): each
// operand splits as x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and
// wgmma m64nTk8 adds lo*hi + hi*lo + hi*hi into fp32 registers; each K
// chunk of 32 is promoted into a second set of registers in fp32 adds,
// because the tensor cores' own accumulation truncates. A single TF32 pass
// is not enough: the quadratic form cancels near zero distance, where the
// hardest positive lies. Operand rows come through a three-stage cp.async
// ring (rows past B and columns past D land as zeros), are split by every
// thread into double-buffered hi/lo planes in the 128-byte swizzle wgmma
// reads, and the products of chunk k run while chunk k + 1 is split. The
// first launch (DIAG) takes the diagonal tiles, grid (B / T, H): one
// operand serves as both, and the tile's diagonal g_ii is written to
// diag (H, B) as the norms sq_i, so d2_ii = g_ii + g_ii - 2 g_ii is
// exactly 0. The second takes the tiles above it, grid (nt (nt - 1) / 2,
// H), launched programmatically dependent on the first (its products run
// while the diagonal tiles finish; it waits on them before it reads diag).
// The Gram is symmetric, and d2_ij = sq_i + sq_j - 2 g_ij is the same
// fp32 value either way round, so each upper tile mines its rows over its
// columns and, mirrored, its columns over its rows; a diagonal tile uses
// its upper triangle for both halves. Mining is the tile's epilogue: the
// tile is staged in shared memory, turned into distances in place, and
// reduced by rows and by columns (two threads a line, then combined); the
// (B, B) distances never reach device memory. Each (row, tile) gets one
// partial (masks, clamp, +-FLT_MAX, lowest index on ties) in (H, tiles,
// B); hard_mine_long_merge_kernel merges them in tile order. The max and
// min with the lowest-index rule give the same answer in any order, so
// the result does not depend on which tile ran first. Where even 64-row
// tiles fill under a wave (B of a few hundred over a few heads), a cluster
// of 2 or 4 blocks splits each tile's K chunks and its rank 0 sums the
// partial tiles in rank order from its peers' shared memory (no atomics,
// nothing through device memory) before it mines. The Gram's values do
// not depend on T (every entry is the same wgmma products over the same K
// chunks, promoted in the same order) but do on the split, which (H, B,
// D) decide: two calls give the same bits.
//
// Pick-based backward, B > 96: grad_r = sum over the picks that touch row
// r of w (f_r - f_other), w = g / d: anchor r's own two picks, then every
// anchor whose pick is r, in anchor order. O(B D) FMAs a head, where S @ f
// costs B^2 D. It takes any B, but costs more than the S-matrix kernel at
// small B; the S-matrix kernel grows as B^2. The fork, kShortBackwardBatch,
// was set where an earlier form of this backward (each band scanning every
// pick) crossed it: 0.0163 vs 0.0181 ms at B = 96, 0.0263 vs 0.0177 at 128
// (H = 5, D = 2048; NVIDIA H100 80GB HBM3, 700 W;
// agrl_torch/kernels/triplet_forks.py times both). Two launches read the
// picks once.
// hard_mine_pick_lists_kernel writes each row's terms (source row,
// weight) in order by a stable counting sort on the target row, a cluster
// of up to 8 blocks a head (enough walker warps for ~2 steps each): each
// block counts its anchors' live picks per (walker, row) and per anchor
// with shared-memory integer atomics and folds its walkers' counts into
// offsets and a total per row; the blocks share the rows for an exclusive
// scan over (row, own, block), reading the blocks' totals and setting each
// block's base into the row through distributed shared memory (a few
// remote accesses a row: reading every walker's count remotely was slower
// than one block a head) and chaining their row ranges' totals in rank
// order; then each walker warp fills its
// contiguous run of anchors in order, 32 picks a step, each pick also into
// its anchor's own slots at the head of the row. A step's equal targets
// are ranked by a bitonic sort of (target, lane) over the warp's shuffles:
// __match_any_sync iterates over the distinct targets, which a step's
// picks mostly are. One block a head left its latency in plain sight (one
// walker's steps in a row, every phase a chain of shared-memory rounds),
// hence the cluster. No atomics touch a sum, and the order is fixed.
// hard_mine_long_backward_kernel, grid (32-float4 column slices, bands of
// 16 rows, H), launched dependent on it, stages its band's rows (sources
// inside the band, the positive picks of a P x K batch, are read there)
// and its band's entries in shared memory, and sums each row's terms with
// float4 rows of f: rowsum * f_r - acc, the S-matrix backward's form. What
// bounds it is latency: three dependent rounds of loads a block after the
// staging. Fixed order, no atomics: two runs give the same bits.
//
// Limits: H <= 65535 heads and B <= 65535 x 16 (grid dimensions), of one
// shape; any D (the wrapper pads D to a multiple of 4 with zero columns,
// which change no distance, and slices the gradient back). The long
// forward's partials and norms take H B (16 ceil(B / 64) + 4) bytes of
// device memory, the long backward's lists H (48 B + 4).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
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
constexpr int kMinTile = 64;                    // the smaller Gram tile (T)
constexpr int kKC = 32;                         // Gram K chunk: one 128-byte row a staged row
constexpr int kStages = 3;                      // the cp.async ring's chunks
constexpr int kLongBand = 16;                   // backward rows a block
constexpr int kMaxBatch = kMaxGrid * kLongBand;
constexpr int kListThreads = 1024;              // the pick lists' block
constexpr int kListWarps = kListThreads / 32;
constexpr int kListSmem = 192 * 1024;           // the walkers' cursors, where they fit

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

// 16 bytes from global to shared memory, asynchronously: n of them read
// (16 or 0), the rest zero-filled
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving an accumulator while a wgmma may write it.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
// Orders this thread's shared-memory stores before later wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, fp32) = a (64 x 8) * b (8 x N) + (add ? d : 0), N = 2 x the
// accumulators: one warpgroup, tf32 operands from shared memory
// (descriptors), asynchronous until wgmma_wait_all. Accumulator e of a
// thread: row 16 warp + lane / 4 (+ 8 for e % 4 >= 2), column 8 (e / 4) +
// 2 (lane % 4) (+ 1 for odd e).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], unsigned long long a,
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
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], unsigned long long a,
                                           unsigned long long b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(add));
}

// A staged chunk and an operand plane share one layout: rows of kKC floats
// (128 bytes), the 16-byte slot q of row r stored at slot q ^ (r % 8), the
// 128-byte swizzle that wgmma reads as a K-major operand (8-row atoms of
// 1024 bytes, which must start at 1024-byte boundaries).
__device__ __forceinline__ int swz(int r, int q) { return r * kKC + 4 * (q ^ (r & 7)); }
// Shared-memory matrix descriptor of a k8 step of a plane (p: the step's
// first row, 32 bytes further per k8): start address, leading byte offset
// 1 (unused for swizzled K-major operands), stride byte offset 1024
// (between 8-row atoms), in 16-byte units; layout type 1 (128-byte
// swizzle).
__device__ __forceinline__ unsigned long long plane_desc(const float* p) {
  return (unsigned long long)((smem_u32(p) & 0x3ffff) >> 4) | (1ull << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// A T x T Gram tile's shared memory, in floats from a 1024-byte boundary:
// two buffers of four planes (A hi, A lo, B hi, B lo; T rows each), then
// the ring of kStages raw chunks (T A rows, then T B rows). After the K
// loop it holds the epilogue's staged tile, norms, labels and half-line
// results.
template <int T>
struct GramSmem {
  static constexpr int NT = 2 * T;  // threads: T / 64 warpgroups
  static constexpr int PLANE = T * kKC;
  static constexpr int PLANES = 2 * 4 * PLANE;
  static constexpr int RAW = 2 * T * kKC;
  static constexpr int FLOATS = PLANES + kStages * RAW;
  static constexpr int TS = T + 1;  // staged row stride: a line's 32 threads hit distinct banks
  static_assert(T * TS + 2 * T + 4 * T + 4 * T <= FLOATS, "the epilogue fits in the ring");
  static constexpr size_t BYTES = sizeof(float) * FLOATS + 1024;  // + alignment slack
};

// Tile (ti, tj) of head h's Gram in 3xTF32 on the tensor cores, mined in
// its epilogue into the partials (H, tiles, B): part_v (d_ap, d_an),
// part_k (i_ap, i_an). DIAG: tile (t, t), one operand for both; its
// diagonal goes to diag (H, B), and it mines its rows from its upper
// triangle. Otherwise upper tile t (tj > ti, numbered row by row), mining
// its rows over its columns and its columns over its rows, with the norms
// the DIAG launch wrote. S > 1: a cluster of S blocks (blockIdx.x = S t +
// rank) splits the K chunks, rank s the s-th run of them, and rank 0 sums
// the partial tiles in rank order from its peers' shared memory and mines
// alone. D % 4 == 0.
template <int T, bool DIAG, class Heads>
__global__ void __launch_bounds__(2 * T, 1)
hard_mine_gram_kernel(const __grid_constant__ Heads heads, const long long* __restrict__ labels,
                      int B, int D, int S, float* __restrict__ diag, float2* __restrict__ part_v,
                      int2* __restrict__ part_k) {
  using L = GramSmem<T>;
  constexpr int NA = T / 2;                // accumulators a thread
  constexpr int kRows = DIAG ? T : 2 * T;  // rows a chunk stages: A's, then B's
  constexpr int kPer = kRows * 8 / L::NT;  // 16-byte slots a thread stages and splits a chunk
  extern __shared__ unsigned char gram_raw_smem[];
  float* const smem = reinterpret_cast<float*>(
      (reinterpret_cast<size_t>(gram_raw_smem) + 1023) & ~(size_t)1023);
  float* const raw = smem + L::PLANES;
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int nt = (B + T - 1) / T;
  const int rank = blockIdx.x % S;
  int ti = blockIdx.x / S, tj = ti;
  if (DIAG) {
    // the tiles above the diagonal may launch and run their products now
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  } else {
    int t = blockIdx.x / S;  // row ti holds tiles ti + 1 .. nt - 1
    ti = 0;
    while (t >= nt - 1 - ti) t -= nt - 1 - ti++;
    tj = ti + 1 + t;
  }
  const int i0 = ti * T, j0 = tj * T;
  const float* const rows = heads[h];

  // chunk kt's rows into raw stage s: 8 threads a row, 16 bytes each, so
  // a warp reads 4 whole 128-byte rows; rows past B and columns past D
  // land as zeros
  auto load = [&](int s, int kt) {
    float* rs = raw + s * L::RAW;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = i * L::NT + tid;
      const int r = idx / 8, q = idx % 8;
      const int row = r < T ? i0 + r : j0 + r - T;
      const int col = kt * kKC + 4 * q;
      const bool in = row < B && col < D;
      cp_async16_fill(rs + swz(r, q), in ? rows + (size_t)row * D + col : rows, in ? 16 : 0);
    }
  };
  // raw chunk -> hi/lo planes of buffer buf: x = hi + lo, hi = tf32(x),
  // lo = tf32(x - hi) (x - hi is exact); consecutive threads take
  // consecutive rows, so the swizzled reads and the writes are
  // conflict-free
  auto split = [&](int s, int buf) {
    const float* rs = raw + s * L::RAW;
    float* pl = smem + buf * 4 * L::PLANE;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = i * L::NT + tid;
      const int op = idx / (T * 8);  // 0: A, 1: B
      const int r = idx % T, q = idx / T % 8;
      const float4 x = *reinterpret_cast<const float4*>(rs + swz(op * T + r, q));
      float4 hi, lo;
      hi.x = round_tf32(x.x); lo.x = round_tf32(x.x - hi.x);
      hi.y = round_tf32(x.y); lo.y = round_tf32(x.y - hi.y);
      hi.z = round_tf32(x.z); lo.z = round_tf32(x.z - hi.z);
      hi.w = round_tf32(x.w); lo.w = round_tf32(x.w - hi.w);
      float* dst = pl + op * 2 * L::PLANE + swz(r, q);
      *reinterpret_cast<float4*>(dst) = hi;
      *reinterpret_cast<float4*>(dst + L::PLANE) = lo;
    }
  };

  // this rank's K chunks: [k0, k0 + nk)
  const int nk_all = (D + kKC - 1) / kKC;
  const int k0 = rank * nk_all / S, nk = (rank + 1) * nk_all / S - k0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, k0 + s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // one group a chunk, empty or not
  }
  // warpgroup wg computes tile rows 64 wg .. 64 wg + 63 x all T columns.
  // The tensor cores add into acc with truncation, so acc holds one
  // chunk's 12 products (the chunk's first wgmma does not add acc) and is
  // promoted into tot, in fp32 adds that round to nearest.
  const int wg = tid / 128;
  float acc[NA], tot[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = tot[e] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");  // mine of chunk kt
    // every thread's copies of chunk kt have landed, every thread has split
    // chunk kt - 1 (its stage is free), and every warpgroup has waited for
    // chunk kt - 2's products (plane buffer kt % 2 is free)
    __syncthreads();
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, k0 + kt + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    split(kt % kStages, kt % 2);  // overlaps chunk kt - 1's products
    fence_proxy_async();
    __syncthreads();

    const float* pl = smem + (kt % 2) * 4 * L::PLANE;
    const float* a_hi = pl + wg * 64 * kKC;             // A rows 64 wg ..
    const float* b_hi = DIAG ? pl : pl + 2 * L::PLANE;  // B rows: the A rows on the diagonal
    wgmma_wait_all();  // chunk kt - 1's products are done: promote them
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      pin(acc[e]);
      tot[e] += acc[e];
      pin(acc[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < kKC / 8; ++k8) {
      const int at = k8 * 8;  // slots 2 k8, 2 k8 + 1 of every row
      const unsigned long long ah = plane_desc(a_hi + at);
      const unsigned long long al = plane_desc(a_hi + L::PLANE + at);
      const unsigned long long bh = plane_desc(b_hi + at);
      const unsigned long long bl = plane_desc(b_hi + L::PLANE + at);
      wgmma_tf32(acc, al, bh, k8 > 0);  // small terms first; the chunk starts at 0
      wgmma_tf32(acc, ah, bl, 1);
      wgmma_tf32(acc, ah, bh, 1);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    pin(acc[e]);
    tot[e] += acc[e];
  }

  // the epilogue: the tile staged (a split's partial tiles summed in rank
  // order), turned into distances, mined
  __syncthreads();  // the ring is free
  float* ts = smem;             // ts[r TS + c]: G[i0 + r, j0 + c], then its distance
  float* sq = ts + T * L::TS;   // the rows' norms, then the columns'
  long long* lab = reinterpret_cast<long long*>(sq + 2 * T);  // their labels
  float* hv = reinterpret_cast<float*>(lab + 2 * T);  // a line's second half: d_ap, d_an
  int* hk = reinterpret_cast<int*>(hv + 2 * T);       // i_ap, i_an
  {
    const int lane = tid % 32, w = tid / 32 % 4;
#pragma unroll
    for (int e = 0; e < NA; ++e)
      ts[(wg * 64 + w * 16 + lane / 4 + (e & 2) * 4) * L::TS + e / 4 * 8 + lane % 4 * 2 + (e & 1)] =
          tot[e];
  }
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partial tile is staged
    if (rank == 0)
      for (int s = 1; s < S; ++s) {
        const float* peer = cluster.map_shared_rank(ts, s);
        for (int idx = tid; idx < T * T; idx += L::NT) {
          const int at = idx / T * L::TS + idx % T;
          ts[at] += peer[at];
        }
      }
    cluster.sync();  // no peer exits while rank 0 reads it
    if (rank != 0) return;
  }
  if (!DIAG) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the norms are written
  for (int t = tid; t < 2 * T; t += L::NT) {
    const int row = (t < T ? i0 : j0 - T) + t;
    lab[t] = row < B ? labels[row] : 0;
    if (!DIAG) sq[t] = row < B ? diag[(size_t)h * B + row] : 0.f;
  }
  __syncthreads();
  if (DIAG) {
    for (int t = tid; t < T; t += L::NT) {
      const float g = ts[t * L::TS + t];  // the Gram's own diagonal: d2_ii is exactly 0
      sq[t] = sq[T + t] = g;
      if (i0 + t < B) diag[(size_t)h * B + i0 + t] = g;
    }
    __syncthreads();
  }
  // distances in place; a diagonal tile's upper triangle serves both halves
  for (int idx = tid; idx < T * T; idx += L::NT) {
    const int r = idx / T, c = idx % T;
    if (DIAG && c < r) continue;
    float& x = ts[r * L::TS + c];
    x = sqrtf(fmaxf(sq[r] + sq[T + c] - 2.0f * x, 1e-12f));
  }
  __syncthreads();

  // Mines each line (a row over the tile's columns; by_col, a column over
  // its rows) into its partial: two threads a line, each over every second
  // entry, combined through shared memory. Sentinels lose to every real
  // entry, masked ones included; ties go to the lowest index.
  const int line = tid % T, half = tid / T;
  auto mine = [&](bool by_col) {
    const long long own = lab[(by_col ? T : 0) + line];
    const int first = by_col ? i0 : j0;  // the index of the line's first entry
    float v_ap = -INFINITY, v_an = INFINITY;
    int k_ap = B, k_an = B;
    for (int m = half; m < T && first + m < B; m += 2) {
      const int r = by_col ? m : line, c = by_col ? line : m;
      const float dist = DIAG && c < r ? ts[c * L::TS + r] : ts[r * L::TS + c];
      const bool pos = lab[(by_col ? 0 : T) + m] == own;
      keep_max(v_ap, k_ap, pos ? dist : -FLT_MAX, first + m);
      keep_min(v_an, k_an, pos ? FLT_MAX : dist, first + m);
    }
    if (half) {
      hv[line] = v_ap;
      hv[T + line] = v_an;
      hk[line] = k_ap;
      hk[T + line] = k_an;
    }
    __syncthreads();
    const int at = (by_col ? j0 : i0) + line;
    if (!half && at < B) {
      keep_max(v_ap, k_ap, hv[line], hk[line]);
      keep_min(v_an, k_an, hv[T + line], hk[T + line]);
      const size_t out = ((size_t)h * nt + (by_col ? ti : tj)) * B + at;
      part_v[out] = make_float2(v_ap, v_an);
      part_k[out] = make_int2(k_ap, k_an);
    }
    __syncthreads();  // hv, hk are read through
  };
  mine(false);
  if (!DIAG) mine(true);
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

// Pick p (0: i_ap, 1: i_an) of anchor `row` as M's entry: its column k and
// its weight g / d, or 0 where the distance carries no gradient (row_picks'
// rule, for one pick).
__device__ __forceinline__ float pick_weight(size_t at, int row, int p, const float* d_ap,
                                             const float* d_an, const long long* i_ap,
                                             const long long* i_an, const float* g_ap,
                                             const float* g_an, float dist_min, int& k) {
  const float d = (p ? d_an : d_ap)[at];
  k = (int)(p ? i_an : i_ap)[at];
  const float* gp = p ? g_an : g_ap;
  const float g = gp ? gp[at] : 0.f;
  return d > dist_min && d < FLT_MAX && k != row ? g / d : 0.f;
}

// Whether the pick lists' arrays (B ints a walker, and two more rows: the
// block's anchors' own picks, its rows' bases) fit in shared memory for at
// least one walker; past that, one block of one walker with its arrays in
// the scratch.
inline bool lists_in_smem(int B) { return 12 * B <= kListSmem; }
// Blocks a head's lists take (a cluster, up to the portable 8), and walker
// warps a block: about two steps of 16 anchors a walker, within shared
// memory. A block zeroes and folds W B counts whatever its share of the
// anchors, so many blocks of a few walkers beat a few of many.
inline int list_blocks(int B) {
  return lists_in_smem(B) ? (B < 256 ? 1 : B / 256 < kCluster ? B / 256 : kCluster) : 1;
}
inline int list_walkers(int B, int C) {
  if (!lists_in_smem(B)) return 1;
  const int cap = kListSmem / (4 * B) - 2, want = (B + 32 * C - 1) / (32 * C);
  const int w = want < cap ? want : cap;
  return w < 1 ? 1 : w > kListWarps ? kListWarps : w;
}

// A warp's ranks among equal keys: rank, the lanes below this one with its
// key; last, none above it has it. A bitonic sort of (key, lane) over the
// warp (15 compare-exchange stages through shuffles), the runs of equal
// keys found in sorted order, and each result sent back to its lane
// through the warp's 32 ints of shared memory. Every lane calls it.
__device__ __forceinline__ void step_ranks(int key, int lane, int* scratch, int& rank,
                                           bool& last) {
  unsigned long long v = (unsigned long long)(unsigned)(key ^ INT_MIN) << 32 | (unsigned)lane;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = lower == ascending ? (o < v ? o : v) : (o > v ? o : v);
    }
  // sorted position `lane` holds (key, its lane): the run of its key starts
  // at the last position at or below it whose left neighbour differs
  const unsigned kv = (unsigned)(v >> 32);
  const unsigned left = __shfl_up_sync(0xffffffffu, kv, 1);
  const unsigned right = __shfl_down_sync(0xffffffffu, kv, 1);
  int first = lane == 0 || left != kv ? lane : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, first, o);
    if (lane >= o) first = max(first, y);
  }
  scratch[v & 31] = (lane - first) << 1 | (lane == 31 || right != kv ? 1 : 0);
  __syncwarp();
  const int r = scratch[lane];
  __syncwarp();  // the slot may be written again
  rank = r >> 1;
  last = r & 1;
}

// Head blockIdx.x / C's pick lists: every term of each row's gradient, in
// order: start (H, B + 1), the row's first entry, and list (H, 4 B),
// entries (source row, weight bits): the row's own live picks (i_ap's,
// then i_an's), then every live pick of another anchor that lands on it,
// in (anchor, pick) order. A stable counting sort on the target row over
// a cluster of C blocks, W walker warps each: walker g = W rank + w takes
// the g-th run of anchors. Each block counts its anchors' live picks per
// (walker, target row) and per anchor in its own shared memory, and folds
// its walkers' counts into per-walker offsets and a total per row; the
// blocks share the rows for an exclusive scan over (row, own, block),
// reading the blocks' totals and setting each block's base into the row
// through distributed shared memory, their row ranges' totals chained in
// rank order; then each walker fills its run in order, 32 picks a step,
// and every pick's own entry into its anchor's row. counts (H, 3 B): the
// arrays of the one-block form where shared memory cannot hold them.
template <bool kSharedCursors>
__global__ void __launch_bounds__(kListThreads)
hard_mine_pick_lists_kernel(int B, int C, int W, const float* __restrict__ d_ap,
                            const float* __restrict__ d_an, const long long* __restrict__ i_ap,
                            const long long* __restrict__ i_an, const float* __restrict__ g_ap,
                            const float* __restrict__ g_an, float dist_min,
                            int* __restrict__ counts, int* __restrict__ start,
                            int2* __restrict__ list) {
  extern __shared__ int cursor_smem[];
  __shared__ int warp_sum[kListWarps];
  __shared__ int ranks[kListWarps][32];  // each walker's step_ranks slots
  __shared__ int range_total[kCluster];  // rank 0's: each block's row range's entries
  // the gradient kernel may launch and stage its rows now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int rank = blockIdx.x % C, h = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int run = (B + C * W - 1) / (C * W);  // walker g: anchors [g run, (g + 1) run)
  const int a_lo = min(B, rank * W * run), a_hi = min(B, (rank + 1) * W * run);
  int* cur;  // (W, B): each walker's count into each row, then its offset among the block's
  if constexpr (kSharedCursors)
    cur = cursor_smem;
  else
    cur = counts + (size_t)h * 3 * B;
  int* own = cur + W * B;    // (B,): its anchors' own live picks, then their rows' starts
  int* base = own + B;       // (B,): its total into each row, then its first entry there
  auto peer = [&](int* p, int b) {  // block b's copy of this block's array p
    return C == 1 ? p : cg::this_cluster().map_shared_rank(p, b);
  };
  const size_t hb = (size_t)h * B;
  int* st = start + (size_t)h * (B + 1);
  int2* out = list + 4 * hb;
  for (int e = tid; e < (W + 2) * B; e += kListThreads) cur[e] = 0;
  __syncthreads();
  // this block's anchors' live picks, per walker and target row and per
  // anchor (integer counts: any order of the atomics gives the same);
  // kAhead picks a thread loaded together
  constexpr int kAhead = 8;
  for (int e0 = 2 * a_lo; e0 < 2 * a_hi; e0 += kAhead * kListThreads) {
    float wt[kAhead];
    int k[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int e = e0 + u * kListThreads + tid, a = e / 2;
      k[u] = 0;
      wt[u] = e < 2 * a_hi ? pick_weight(hb + a, a, e % 2, d_ap, d_an, i_ap, i_an, g_ap, g_an,
                                         dist_min, k[u])
                           : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (wt[u] != 0.f) {
        const int a = (e0 + u * kListThreads + tid) / 2;
        atomicAdd(cur + (a / run - rank * W) * B + k[u], 1);
        atomicAdd(own + a, 1);
      }
  }
  __syncthreads();
  // each walker's offset among the block's entries into each row, and the
  // block's total there
  for (int r = tid; r < B; r += kListThreads) {
    int t = 0;
#pragma unroll 4
    for (int w = 0; w < W; ++w) {
      const int c = cur[w * B + r];
      cur[w * B + r] = t;
      t += c;
    }
    base[r] = t;
  }
  if (C > 1)
    cg::this_cluster().sync();  // every block's totals are in
  else
    __syncthreads();
  // this block's rows [r_lo, r_hi): each row's entries (its anchor's own
  // live picks, then every block's)
  const int r_lo = rank * B / C, r_hi = (rank + 1) * B / C;
  const int span = W * run;  // anchors a block
  auto row_entries = [&](int r) {
    int n = peer(own, r / span)[r];
    for (int b = 0; b < C; ++b) n += peer(base, b)[r];
    return n;
  };
  // an exclusive scan of n over the block, in chunks of kListThreads rows;
  // returns this row's prefix (and the chunk's total in `chunk`)
  auto block_scan = [&](int n, int& chunk) {
    int x = n;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int before = 0;
    chunk = 0;
    for (int w = 0; w < kListWarps; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      chunk += warp_sum[w];
    }
    __syncthreads();  // warp_sum is read through
    return before + x - n;
  };
  int carry = 0;  // the entries of the rows before this block's
  if (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    int total = 0;
    for (int r0 = r_lo; r0 < r_hi; r0 += kListThreads) {
      int chunk;
      block_scan(r0 + tid < r_hi ? row_entries(r0 + tid) : 0, chunk);
      total += chunk;
    }
    if (tid == 0) cluster.map_shared_rank(&range_total[0], 0)[rank] = total;
    cluster.sync();
    const int* totals = cluster.map_shared_rank(&range_total[0], 0);
    for (int b = 0; b < rank; ++b) carry += totals[b];
  }
  for (int r0 = r_lo; r0 < r_hi; r0 += kListThreads) {
    const int r = r0 + tid;
    const int n = r < r_hi ? row_entries(r) : 0;
    int chunk;
    const int first = carry + block_scan(n, chunk);
    if (r < r_hi) {
      st[r] = first;
      int* owner = peer(own, r / span);
      int at = first + owner[r];
      owner[r] = first;
      for (int b = 0; b < C; ++b) {
        int* bb = peer(base, b);
        const int t = bb[r];
        bb[r] = at;
        at += t;
      }
    }
    carry += chunk;
  }
  if (r_hi == B && tid == 0) st[B] = carry;
  if (C > 1)
    cg::this_cluster().sync();  // every start and base is set; no block reads a peer after
  else
    __syncthreads();
  if (warp >= W) return;
  // walker `warp`: lane 2 m + p takes pick p of anchor a0 + m, so lane
  // order is (anchor, pick) order; a step's picks of one row take
  // consecutive entries in lane order; kAhead steps' picks are loaded
  // together
  int* c = cur + warp * B;
  const int a_end = min(B, (rank * W + warp + 1) * run);
  for (int a0 = (rank * W + warp) * run; a0 < a_end; a0 += 16 * kAhead) {
    float wt[kAhead];
    int k[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int a = a0 + 16 * u + lane / 2;
      k[u] = 0;
      wt[u] = a < a_end ? pick_weight(hb + a, a, lane % 2, d_ap, d_an, i_ap, i_an, g_ap, g_an,
                                      dist_min, k[u])
                        : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (a0 + 16 * u >= a_end) break;  // the walker's run is done (warp-uniform)
      const bool live = wt[u] != 0.f;
      int rank_u;
      bool last;
      step_ranks(live ? k[u] : INT_MAX, lane, ranks[warp], rank_u, last);
      const bool live0 = __shfl_sync(0xffffffffu, live, lane & ~1);  // the anchor's pick 0
      const int at = live ? base[k[u]] + c[k[u]] + rank_u : 0;
      __syncwarp();  // every lane has read its cursor
      if (live) {
        const int a = a0 + 16 * u + lane / 2;
        out[at] = make_int2(a, __float_as_int(wt[u]));
        out[own[a] + (lane % 2 && live0)] = make_int2(k[u], __float_as_int(wt[u]));
        if (last) c[k[u]] += rank_u + 1;  // the group's size
      }
      __syncwarp();
    }
  }
}

// s += w x (float4), rs += w
__device__ __forceinline__ void add_scaled(float4& s, float& rs, float w, float4 x) {
  s.x = fmaf(w, x.x, s.x);
  s.y = fmaf(w, x.y, s.y);
  s.z = fmaf(w, x.z, s.z);
  s.w = fmaf(w, x.w, s.w);
  rs += w;
}

// The gradient of the picked distances for a band of kLongBand rows x 32
// float4 columns (blockIdx = (columns, band, h)), any B: warp w takes band
// rows w and w + 8, one float4 column a lane, and sums each row's entries
// of the pick lists in order. The band's rows are staged in shared memory:
// a source row inside the band is read there (a P x K batch keeps each
// identity's rows together, so the positive picks' sources mostly are),
// any other through L2. Launched dependent on the pick lists (the staging
// runs before it waits for them); then the band's entries are staged too
// (kBackEntries at a time), so a row's loads of f do not wait on loads of
// its list, and up to four terms' loads fly together: three dependent
// rounds of loads a block after the staging (starts, entries, rows).
constexpr int kBackEntries = 512;  // list entries staged at once
template <class Heads, class Grads>
__global__ void __launch_bounds__(kThreads)
hard_mine_long_backward_kernel(const __grid_constant__ Heads heads,
                               const __grid_constant__ Grads grads, int B, int D,
                               const int* __restrict__ start, const int2* __restrict__ list) {
  constexpr int kRowsPerWarp = kLongBand / kWarps;
  __shared__ float4 band[kLongBand][32];  // the band's rows, this block's columns
  __shared__ int2 terms[kBackEntries];    // a chunk of the band's entries
  __shared__ int row_start[kLongBand + 1];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.z, n4 = D / 4, c4 = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * kLongBand, rows = min(kLongBand, B - r0);
  const float4* f4 = reinterpret_cast<const float4*>(heads[h]);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < kLongBand * 32; e += kThreads) {
    const int i = e / 32, c = blockIdx.x * 32 + e % 32;
    band[i][e % 32] = i < rows && c < n4 ? f4[(size_t)(r0 + i) * n4 + c] : zero;
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the pick lists are written
  if (tid <= rows) row_start[tid] = start[(size_t)h * (B + 1) + r0 + tid];
  __syncthreads();

  float4 acc[kRowsPerWarp];
  float rs[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    acc[j] = zero;
    rs[j] = 0.f;
  }
  const int e_lo = row_start[0], e_hi = row_start[rows];
  const int2* ent = list + 4 * (size_t)h * B;
  for (int q0 = e_lo; q0 < e_hi; q0 += kBackEntries) {
    const int q1 = min(e_hi, q0 + kBackEntries);
    if (q0 > e_lo) __syncthreads();  // the last chunk is read through
    for (int e = q0 + tid; e < q1; e += kThreads) terms[e - q0] = ent[e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int t = warp + kWarps * j;
      const int lo = t < rows ? max(row_start[t], q0) : 0;
      const int hi = t < rows ? min(row_start[t + 1], q1) : 0;
      for (int q = lo; q < hi; q += 4) {  // f[src]'s column, from the band or L2
        float4 x[4];
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int2 e = q + u < hi ? terms[q + u - q0] : make_int2(r0, 0);
          w[u] = __int_as_float(e.y);
          x[u] = (unsigned)(e.x - r0) < (unsigned)kLongBand ? band[e.x - r0][lane]
                 : c4 < n4                                   ? f4[(size_t)e.x * n4 + c4]
                                                             : zero;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q + u < hi) add_scaled(acc[j], rs[j], w[u], x[u]);
      }
    }
  }
  if (c4 >= n4) return;
  float4* g4 = reinterpret_cast<float4*>(grads[h]);
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int t = warp + kWarps * j;
    if (t >= rows) continue;
    const float4 x = band[t][lane];
    const float4 a = acc[j];
    const float r = rs[j];
    // evict-first: the gradient is not read again, the heads' rows are
    __stcs(g4 + (size_t)(r0 + t) * n4 + c4,
           make_float4(r * x.x - a.x, r * x.y - a.y, r * x.z - a.z, r * x.w - a.w));
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

// The long forward's Gram launches at tile size T: the diagonal tiles,
// then the tiles above them, programmatically dependent on the first
// launch (their blocks start as SMs free up and wait for it only before
// they read the norms).
template <int T, class Heads>
cudaError_t gram_launch(const Heads& hs, int H, const long long* labels, int B, int D,
                        float* diag, float2* part_v, int2* part_k, cudaStream_t stream) {
  using L = GramSmem<T>;
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(hard_mine_gram_kernel<T, true, Heads>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)L::BYTES);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(hard_mine_gram_kernel<T, false, Heads>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)L::BYTES);
  }();
  if (attr != cudaSuccess) return attr;
  const unsigned nt = (B + T - 1) / T;
  // 64-row tiles fill under a wave: a K split, as many ranks (up to 4) as
  // keep the blocks within two an SM and sixteen chunks a rank. The Gram's
  // bits depend on the split, which depends on (H, B, D) alone.
  const long long blocks = (long long)H * nt * (nt + 1) / 2;
  int S = 1;
  while (T == kMinTile && S < 4 && blocks * S * 2 <= 2ll * sm_count() &&
         (D + kKC - 1) / kKC >= 16 * S * 2)
    S *= 2;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = S;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  const int cluster = S > 1 ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt * S, H);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = attrs + 1;  // the diagonal tiles: the split's clusters, if any
  cfg.numAttrs = cluster;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, hard_mine_gram_kernel<T, true, Heads>, hs,
                                            labels, B, D, S, diag, part_v, part_k);
  if (rc != cudaSuccess) return rc;
  // the tiles above them, programmatically dependent on that launch
  cfg.gridDim = dim3(nt * (nt - 1) / 2 * S, H);
  cfg.attrs = attrs;
  cfg.numAttrs = 1 + cluster;
  return cudaLaunchKernelEx(&cfg, hard_mine_gram_kernel<T, false, Heads>, hs, labels, B, D, S,
                            diag, part_v, part_k);
}

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
  // 128-row tiles where their upper half fills a wave of the card, else
  // 64-row ones (the Gram's values are the same either way)
  const long long t128 = (B + 127) / 128;
  const bool wide = (long long)H * t128 * (t128 + 1) / 2 >= sm_count();
  const int tiles = wide ? (int)t128 : (int)long_tiles(B);
  const size_t n = (size_t)H * B;
  float2* part_v = static_cast<float2*>(scratch);
  int2* part_k = reinterpret_cast<int2*>(part_v + n * long_tiles(B));
  float* diag = reinterpret_cast<float*>(part_k + n * long_tiles(B));
  const cudaError_t rc =
      wide ? gram_launch<128>(hs, H, labels, B, D, diag, part_v, part_k, stream)
           : gram_launch<kMinTile>(hs, H, labels, B, D, diag, part_v, part_k, stream);
  if (rc != cudaSuccess) return rc;
  hard_mine_long_merge_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part_v, part_k, H, B, tiles, d_ap, d_an, i_ap, i_an);
  return cudaGetLastError();
}

template <class Heads, class Grads>
cudaError_t backward_launch(const Heads& hs, const Grads& gs, int H, int B, int D,
                            const float* d_ap, const float* d_an, const long long* i_ap,
                            const long long* i_an, const float* g_ap, const float* g_an,
                            float dist_min, void* scratch, cudaStream_t stream) {
  if (B <= kShortBackwardBatch) {
    const dim3 grid((D + kBwColumns - 1) / kBwColumns, (B + kBand - 1) / kBand, H);
    hard_mine_heads_backward_kernel<Heads, Grads><<<grid, kThreads, 0, stream>>>(
        hs, gs, B, D, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  int2* list = static_cast<int2*>(scratch);                      // (H, 4 B)
  int* start = reinterpret_cast<int*>(list + 4 * (size_t)H * B);  // (H, B + 1)
  int* counts = start + (size_t)H * (B + 1);                     // (H, 3 B)
  static const cudaError_t attr = cudaFuncSetAttribute(
      hard_mine_pick_lists_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kListSmem);
  if (attr != cudaSuccess) return attr;
  const int C = list_blocks(B), W = list_walkers(B, C);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t lists = {};
  lists.gridDim = dim3(C * H);
  lists.blockDim = dim3(kListThreads);
  lists.dynamicSmemBytes = lists_in_smem(B) ? 4 * (W + 2) * B : 0;
  lists.stream = stream;
  lists.attrs = cluster;
  lists.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t launched =
      lists_in_smem(B)
          ? cudaLaunchKernelEx(&lists, hard_mine_pick_lists_kernel<true>, B, C, W, d_ap, d_an,
                               i_ap, i_an, g_ap, g_an, dist_min, counts, start, list)
          : cudaLaunchKernelEx(&lists, hard_mine_pick_lists_kernel<false>, B, C, W, d_ap, d_an,
                               i_ap, i_an, g_ap, g_an, dist_min, counts, start, list);
  if (launched != cudaSuccess) return launched;
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  // the gradient kernel, programmatically dependent on the lists' launch
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D / 4 + 31) / 32, (B + kLongBand - 1) / kLongBand, H);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hard_mine_long_backward_kernel<Heads, Grads>, hs, gs, B, D,
                            start, list);
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
// schedule's partials (a float2 and an int2 per head, 64-row tile and
// anchor) and norms, 0 for the cluster schedule.
long long hard_mine_scratch_bytes(int H, int B) {
  return B <= kShortBatch ? 0 : (long long)H * B * (16 * (long long)long_tiles(B) + 4);
}

// Bytes of device scratch the backward takes at (H, B): the pick lists
// (4 B entries, B + 1 row starts, 3 B counts), 0 for the S-matrix
// backward. Less than the forward's at every B > 256.
long long hard_mine_backward_scratch_bytes(int H, int B) {
  return B <= kShortBackwardBatch ? 0 : (long long)H * (48ll * B + 4);
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
// floor sqrt(1e-12) in fp32. scratch: hard_mine_backward_scratch_bytes(H,
// B) bytes, 8-byte aligned (unused at B <= 96). Returns 0 or the
// cudaError_t.
int hard_mine_heads_backward(const void* const* heads, void* const* grads, const void* table,
                             int H, int B, int D, const float* d_ap, const float* d_an,
                             const long long* i_ap, const long long* i_an, const float* g_ap,
                             const float* g_an, float dist_min, void* scratch, void* stream) {
  if (!check_heads(H, B, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    void* const* t = static_cast<void* const*>(const_cast<void*>(table));
    return (int)backward_launch(
        DeviceTable<const float*>{reinterpret_cast<const float* const*>(t)},
        DeviceTable<float*>{reinterpret_cast<float* const*>(t + H)}, H, B, D, d_ap, d_an, i_ap,
        i_an, g_ap, g_an, dist_min, scratch, st);
  }
  if (H > kParamHeads) return (int)cudaErrorInvalidValue;
  ParamTable<const float*> hs{};
  ParamTable<float*> gs{};
  for (int h = 0; h < H; ++h) {
    hs.p[h] = static_cast<const float*>(heads[h]);
    gs.p[h] = static_cast<float*>(grads[h]);
  }
  return (int)backward_launch(hs, gs, H, B, D, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min,
                              scratch, st);
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
