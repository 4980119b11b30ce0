// Batch-hard triplet mining for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel agrl_tpu/ops/triplet.py:hard_mine_pallas. For
// features f (B, D) and labels (B,), per anchor i:
//
//   d2_ij = sq_i + sq_j - 2 <f_i, f_j>        (sq_i = <f_i, f_i>)
//   dist  = sqrt(max(d2_ij, 1e-12))
//   d_ap[i], i_ap[i] = max, argmax over j with labels[j] == labels[i] (self included)
//   d_an[i], i_an[i] = min, argmin over j with labels[j] != labels[i]
//
// The same quadratic form as the JAX package (agrl_tpu/losses/__init__.py
// pairwise_euclidean), so near-zero distances and the picks agree with it.
// Masked entries take -FLT_MAX (max) and FLT_MAX (min), as the plain
// version's torch.where does, and a tie goes to the lowest index, as
// torch.argmax / argmin do: an anchor with no negative gets d_an = FLT_MAX.
// Unlike the Pallas kernel, B needs no padding to a multiple of 8.
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
// Design: one block per anchor (grid B, 256 threads). The block stages
// f_i in shared memory; each of its 8 warps takes every 8th j and reduces
// <f_i, f_j> and <f_j, f_j> over D with float4 loads and fp32 FMA, then a
// butterfly shuffle; lane 0 writes dist_ij to shared memory. sq_i comes
// from the same function in the same order, so d2_ii is exactly 0. Warp 0
// then scans the row for the masked max and min with their indices.
//
// Bound on an H100 SXM at the train step's shape (B=16 = 4x4, D=2048, one
// call per head, 5 per step): the function must read 131 KB of features
// and does ~1 MFLOP (the Gram), i.e. ~0.04 us of HBM time and ~0.02 us of
// fp32 FMA time. Both are far under one kernel launch (a few us), so the
// call is bound by launch latency, and the design keeps it to one launch
// with nothing staged through device memory. The 16 blocks re-read f_j
// through L2 (B * B * D * 4 = 2 MB at this shape). Folding the 5 heads of
// a step into one launch is later work.
//
// Limits: B <= 1024 (the shared distance row), D % 4 == 0 and D <= 8192
// (f_i in shared memory: D * 4 + B * 4 bytes <= 36 KB, under the 48 KB
// that needs no opt-in).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 1024;
constexpr int kMaxDim = 8192;

struct Dots {
  float ab;  // <a, b>
  float bb;  // <b, b>
};

// Both dot products over n4 float4s, reduced across the warp; every lane
// gets the same sums (the butterfly adds the same pairs in every lane).
__device__ __forceinline__ Dots warp_dots(const float4* a, const float4* b, int n4, int lane) {
  float ab = 0.f, bb = 0.f;
  for (int c = lane; c < n4; c += 32) {
    const float4 x = a[c];
    const float4 y = b[c];
    ab = fmaf(x.x, y.x, ab);
    ab = fmaf(x.y, y.y, ab);
    ab = fmaf(x.z, y.z, ab);
    ab = fmaf(x.w, y.w, ab);
    bb = fmaf(y.x, y.x, bb);
    bb = fmaf(y.y, y.y, bb);
    bb = fmaf(y.z, y.z, bb);
    bb = fmaf(y.w, y.w, bb);
  }
  for (int o = 16; o > 0; o >>= 1) {
    ab += __shfl_xor_sync(0xffffffffu, ab, o);
    bb += __shfl_xor_sync(0xffffffffu, bb, o);
  }
  return {ab, bb};
}

// (value, index) pair reductions with the lowest index winning ties.
__device__ __forceinline__ void keep_max(float& v, int& k, float v2, int k2) {
  if (v2 > v || (v2 == v && k2 < k)) { v = v2; k = k2; }
}

__device__ __forceinline__ void keep_min(float& v, int& k, float v2, int k2) {
  if (v2 < v || (v2 == v && k2 < k)) { v = v2; k = k2; }
}

__global__ void __launch_bounds__(kThreads)
hard_mine_kernel(const float* __restrict__ f, const long long* __restrict__ labels, int B, int D,
                 float* __restrict__ d_ap, float* __restrict__ d_an,
                 long long* __restrict__ i_ap, long long* __restrict__ i_an) {
  extern __shared__ float4 smem[];
  const int n4 = D / 4;
  float4* fi = smem;                                   // (n4,) the anchor's row
  float* dist = reinterpret_cast<float*>(smem + n4);   // (B,) its distance row
  __shared__ float sq_i_shared;

  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* f4 = reinterpret_cast<const float4*>(f);

  for (int c = threadIdx.x; c < n4; c += kThreads) fi[c] = f4[(size_t)i * n4 + c];
  __syncthreads();
  if (warp == 0) {
    const Dots s = warp_dots(fi, fi, n4, lane);
    if (lane == 0) sq_i_shared = s.bb;
  }
  __syncthreads();
  const float sq_i = sq_i_shared;

  for (int j = warp; j < B; j += kWarps) {
    const Dots g = warp_dots(fi, f4 + (size_t)j * n4, n4, lane);
    if (lane == 0) dist[j] = sqrtf(fmaxf(sq_i + g.bb - 2.0f * g.ab, 1e-12f));
  }
  __syncthreads();

  if (warp == 0) {
    const long long li = labels[i];
    // sentinels lose to every real entry, masked ones included
    float v_ap = -INFINITY, v_an = INFINITY;
    int k_ap = B, k_an = B;
    for (int j = lane; j < B; j += 32) {
      const bool pos = labels[j] == li;
      keep_max(v_ap, k_ap, pos ? dist[j] : -FLT_MAX, j);
      keep_min(v_an, k_an, pos ? FLT_MAX : dist[j], j);
    }
    for (int o = 16; o > 0; o >>= 1) {
      keep_max(v_ap, k_ap, __shfl_xor_sync(0xffffffffu, v_ap, o),
               __shfl_xor_sync(0xffffffffu, k_ap, o));
      keep_min(v_an, k_an, __shfl_xor_sync(0xffffffffu, v_an, o),
               __shfl_xor_sync(0xffffffffu, k_an, o));
    }
    if (lane == 0) {
      d_ap[i] = v_ap;
      i_ap[i] = k_ap;
      d_an[i] = v_an;
      i_an[i] = k_an;
    }
  }
}

}  // namespace

extern "C" {

// Largest batch and feature width hard_mine_forward takes; D % 4 == 0.
int hard_mine_max_batch() { return kMaxBatch; }
int hard_mine_max_dim() { return kMaxDim; }

// f (B, D) fp32, 16-byte aligned; labels (B,) int64; d_ap, d_an (B,) fp32;
// i_ap, i_an (B,) int64. All contiguous, on the current device. Returns 0
// or the cudaError_t of the launch.
int hard_mine_forward(const float* f, const long long* labels, int B, int D, float* d_ap,
                      float* d_an, long long* i_ap, long long* i_an, void* stream) {
  if (B <= 0 || B > kMaxBatch || D <= 0 || D % 4 != 0 || D > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * sizeof(float) + (size_t)B * sizeof(float);
  hard_mine_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      f, labels, B, D, d_ap, d_an, i_ap, i_an);
  return (int)cudaGetLastError();
}

const char* hard_mine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
