// Batch-hard triplet mining for Hopper (sm_90a), fp32: the H heads of a
// train step in one cluster launch, and their gradient in one launch.
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
// Forward design: one cluster of 8 blocks per (head, band of 16 anchors);
// grid (8 x bands, H). Block rank r of a cluster owns 1/8 of the columns.
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
// Backward design (the TPU kernel has none): per head, with M[i, i_ap[i]]
// = g_ap[i] / d_ap[i] and M[i, i_an[i]] = g_an[i] / d_an[i] (zero where the
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
// The head table is a __grid_constant__ kernel parameter (64 pointers, 512
// bytes), indexed by blockIdx directly: sm_70 and later read a dynamic
// index of such a parameter in place, without the copy to local memory
// that a plain by-value struct takes.
//
// Limits: B <= 256, D % 4 == 0 and D <= 8192, H <= 64 heads of one shape.

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
constexpr int kMaxBatch = 256;
constexpr int kMaxDim = 8192;
constexpr int kMaxHeads = 64;        // 3 x 15 + 1 = 46 heads of msppn/msppgn at --num-split 8
constexpr int kRingBytes = 64 * 1024;  // the staging ring, both stages
constexpr int kHalfBand = kBand / 2;   // band rows per backward thread
constexpr int kBwColumns = kThreads / 2;  // columns per backward block, two threads each
// the k-split partials: kg x (16 x tiles + 1) floats, with kg x tiles <= kThreads
constexpr int kRed = 17 * kThreads;

struct Heads {
  const float* f[kMaxHeads];
};
struct Grads {
  float* g[kMaxHeads];
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
  const float4* f4 = reinterpret_cast<const float4*>(heads.f[h]);

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

__global__ void __launch_bounds__(kThreads)
hard_mine_heads_backward_kernel(const __grid_constant__ Heads heads,
                                const __grid_constant__ Grads grads, int B, int D,
                                const float* __restrict__ d_ap, const float* __restrict__ d_an,
                                const long long* __restrict__ i_ap,
                                const long long* __restrict__ i_an,
                                const float* __restrict__ g_ap, const float* __restrict__ g_an,
                                float dist_min) {
  // S^T for the band: ST[j * kBand + t] = S[i0 + t, j], S = M + M^T
  __shared__ __align__(16) float ST[kMaxBatch * kBand];
  const int tid = threadIdx.x;
  const int h = blockIdx.z;
  const int i0 = blockIdx.y * kBand;
  const int rows = min(kBand, B - i0);
  const size_t base = (size_t)h * B;
  // two threads per column, each for half of the band's rows
  const int c = blockIdx.x * kBwColumns + tid % kBwColumns;
  const int t0 = (tid / kBwColumns) * kHalfBand;
  const bool col = c < D;
  const float* f = heads.f[h];

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
  float* g = grads.g[h];
#pragma unroll
  for (int t = 0; t < kHalfBand; ++t)
    if (t0 + t < rows) g[(size_t)(i0 + t0 + t) * D + c] = rs[t] * xb[t] - acc[t];
}

__global__ void empty_kernel() {}

bool check_heads(int H, int B, int D) {
  return H > 0 && H <= kMaxHeads && B > 0 && B <= kMaxBatch && D > 0 && D % 4 == 0 &&
         D <= kMaxDim;
}

}  // namespace

extern "C" {

// Largest batch, feature width and head count the kernels take; D % 4 == 0.
int hard_mine_max_batch() { return kMaxBatch; }
int hard_mine_max_dim() { return kMaxDim; }
int hard_mine_max_heads() { return kMaxHeads; }

// heads: H pointers (a host array) to (B, D) fp32 features, 16-byte
// aligned; labels (B,) int64; d_ap, d_an (H, B) fp32; i_ap, i_an (H, B)
// int64. All contiguous, on the current device. Returns 0 or the
// cudaError_t of the launch.
int hard_mine_heads_forward(const void* const* heads, int H, const long long* labels, int B,
                            int D, float* d_ap, float* d_an, long long* i_ap, long long* i_an,
                            void* stream) {
  if (!check_heads(H, B, D)) return (int)cudaErrorInvalidValue;
  Heads hs{};
  for (int h = 0; h < H; ++h) hs.f[h] = static_cast<const float*>(heads[h]);
  const size_t smem = forward_smem(B, D / 4);
  static const cudaError_t attr = cudaFuncSetAttribute(
      hard_mine_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)forward_smem(kMaxBatch, kMaxDim / 4));  // the largest any call needs
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(kCluster * ((B + kBand - 1) / kBand), H);
  hard_mine_heads_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      hs, labels, B, D, d_ap, d_an, i_ap, i_an);
  return (int)cudaGetLastError();
}

// The gradient of the picked distances: grads[h] (B, D) fp32 from the
// forward's d_ap, d_an, i_ap, i_an (H, B) and the incoming g_ap, g_an
// (H, B) fp32, either of which may be null (no gradient). dist_min is the
// clamp's floor sqrt(1e-12) in fp32. Returns 0 or the cudaError_t.
int hard_mine_heads_backward(const void* const* heads, void* const* grads, int H, int B, int D,
                             const float* d_ap, const float* d_an, const long long* i_ap,
                             const long long* i_an, const float* g_ap, const float* g_an,
                             float dist_min, void* stream) {
  if (!check_heads(H, B, D)) return (int)cudaErrorInvalidValue;
  Heads hs{};
  Grads gs{};
  for (int h = 0; h < H; ++h) {
    hs.f[h] = static_cast<const float*>(heads[h]);
    gs.g[h] = static_cast<float*>(grads[h]);
  }
  const dim3 grid((D + kBwColumns - 1) / kBwColumns, (B + kBand - 1) / kBand, H);
  hard_mine_heads_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hs, gs, B, D, d_ap, d_an, i_ap, i_an, g_ap, g_an, dist_min);
  return (int)cudaGetLastError();
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
