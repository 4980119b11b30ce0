// Sparse min-plus product for Hopper (sm_90a), fp32.
//
// Replaces, on the re-ranking path, the TPU kernel
// agrl_tpu/ops/minsum.py:59 min_sum_pallas. For non-negative a (Q, C) and
// b (J, C), row-major:
//
//   out[q, j] = sum_c min(a[q, c], b[j, c])          out is (Q, J)
//
// A term with a zero operand adds exactly 0, so only the pairs where both
// a[q, c] and b[j, c] are non-zero need work. Re-ranking's membership
// matrix v (agrl_torch/ops/rerank.py, expanded_membership) is ~99% zeros
// by construction: at MARS's test size (Q = 1,980, J = C = 11,310) 1.93e7
// of the 2.53e11 dense terms have two non-zero operands, ~97 non-zeros per
// row. This is the public algorithm's own sparse form
// (agrl_torch/metrics/rerank.py: an inverted index of the rows that are
// non-zero in each column; each query walks its non-zero columns and adds
// min(v[q, c], v[rows, c]) into those rows), on the card:
//
//   nnz_count_kernel   one warp per row of a or b: counts of the non-zeros
//                      of the row (a warp reduction), atomic counts of b's
//                      non-zeros per column, and a count of the entries
//                      that are < 0 or NaN (the wrapper raises on them).
//                      The wrapper scans the counts (torch.cumsum) into
//                      row and column pointers and reads the totals back
//                      once, to size the buffers. When a is b's first Q
//                      rows (re-ranking's v[:Q] and v), a's counts and CSR
//                      are b's first rows, and a's passes are skipped.
//   csr_fill_kernel    one warp per row again: ballot + popc compaction of
//                      the non-zeros into CSR (columns ascending, values;
//                      for b also each entry's row). A stable sort of b's
//                      entries by column (torch.sort(stable=True), glue on
//                      the ~1e6-entry list) turns b's CSR into the inverted
//                      index: per column, its rows ascending, with values.
//                      Filling column slots with atomics would order each
//                      column differently from run to run.
//   min_sum_accumulate_kernel
//                      one block per (query q, range of kRange output
//                      columns), an fp32 accumulator for the range in
//                      shared memory. The block walks q's non-zero columns
//                      c in ascending order; its threads take the entries
//                      of column c's row list that fall in the range (a
//                      binary search bounds them when the range is not all
//                      of J) and add min(a[q, c], b[j, c]) into acc[j - j0].
//                      Within one column every j is distinct, so no two
//                      threads touch one slot, and a barrier between
//                      columns keeps the order: no atomics, each output's
//                      sum runs over ascending c as the host algorithm's
//                      does, and the result is the same bit for bit on
//                      every run. The first entries of the next kDepth
//                      columns are loaded into registers together, so
//                      their latencies overlap. Then the range is written
//                      out, coalesced, zeros included.
//
// Bound on an H100 SXM at the MARS shape on v, where a = v[:Q] is b's
// first rows and is read as part of b: b read once and the output
// written once, 4 (JC + QJ) = 601 MB at 3.35 TB/s = 0.180 ms (0.206 ms
// for inputs that do not alias); the 1.93e7 needed terms are ~1.2 us of
// fp32 issue. The count and fill passes each read b once (2 x 512 MB)
// and the output is 90 MB: the design is bound by those bytes, ~1.85x
// the bound, plus the sort, the read-back and the latency of the short
// per-column lists.
// On dense inputs the dense kernel (csrc/minsum.cu) is far faster: the
// caller, which knows its data, picks the entry.
//
// Limits: Q, J, C > 0, Q < 2^31 (grid x), ceil(J / kRange) <= 65535.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kUnroll = 8;      // 32-float loads in flight per warp in the row passes
constexpr int kBatch = kThreads;  // query columns staged per round of the accumulation
constexpr int kDepth = 8;       // columns whose first entries load together
constexpr int kRange = 16384;   // output columns per accumulation block: 64 KB of fp32
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

// ---- 1. counts ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
nnz_count_kernel(const float* __restrict__ x, int rows, int C, int* __restrict__ row_nnz,
                 int* __restrict__ col_nnz, unsigned long long* __restrict__ bad) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const float* xr = x + (size_t)row * C;
  int nnz = 0, neg = 0;
  for (int c0 = 0; c0 < C; c0 += 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u + lane;
      v[u] = c < C ? __ldg(xr + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool nz = v[u] != 0.f;
      nnz += nz;
      neg += !(v[u] >= 0.f);  // < 0 or NaN
      if (col_nnz != nullptr && nz) atomicAdd(col_nnz + c0 + 32 * u + lane, 1);
    }
  }
  nnz = (int)__reduce_add_sync(kFull, (unsigned)nnz);
  neg = (int)__reduce_add_sync(kFull, (unsigned)neg);
  if (lane == 0) {
    row_nnz[row] = nnz;
    if (neg) atomicAdd(bad, (unsigned long long)neg);
  }
}

// ---- 2. CSR fill ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
csr_fill_kernel(const float* __restrict__ x, int rows, int C, const long long* __restrict__ ptr,
                int* __restrict__ col_out, float* __restrict__ val_out, int* __restrict__ row_out) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  const unsigned below = (1u << lane) - 1u;
  long long at = ptr[row];
  for (int c0 = 0; c0 < C; c0 += 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u + lane;
      v[u] = c < C ? __ldg(xr + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool nz = v[u] != 0.f;
      const unsigned mask = __ballot_sync(kFull, nz);
      if (nz) {
        const long long p = at + __popc(mask & below);
        col_out[p] = c0 + 32 * u + lane;
        val_out[p] = v[u];
        if (row_out != nullptr) row_out[p] = row;
      }
      at += __popc(mask);
    }
  }
}

// ---- 3. accumulation -----------------------------------------------------------

// First index in [lo, hi) whose row is >= j (rows ascending), else hi.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ rows, long long lo,
                                                 long long hi, int j) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (rows[mid] < j) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
min_sum_accumulate_kernel(const long long* __restrict__ a_ptr, const int* __restrict__ a_col,
                          const float* __restrict__ a_val, const long long* __restrict__ col_ptr,
                          const int* __restrict__ inv_row, const float* __restrict__ inv_val,
                          int J, float* __restrict__ out) {
  extern __shared__ float acc[];  // the range's outputs
  __shared__ long long s_beg[kBatch], s_end[kBatch];
  __shared__ float s_av[kBatch];

  const int q = blockIdx.x;
  const int j0 = blockIdx.y * kRange;
  const int width = min(kRange, J - j0);
  const int j1 = j0 + width;
  const int tid = threadIdx.x;
  for (int t = tid; t < width; t += kThreads) acc[t] = 0.f;

  const long long lo = a_ptr[q], hi = a_ptr[q + 1];
  for (long long base = lo; base < hi; base += kBatch) {
    const int n = (int)min((long long)kBatch, hi - base);
    __syncthreads();  // acc zeroed; the previous round's staging consumed
    if (tid < n) {
      const int c = a_col[base + tid];
      s_av[tid] = a_val[base + tid];
      long long s = col_ptr[c], e = col_ptr[c + 1];
      if (j0 > 0) s = lower_bound(inv_row, s, e, j0);
      if (j1 < J) e = lower_bound(inv_row, s, e, j1);
      s_beg[tid] = s;
      s_end[tid] = e;
    }
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kDepth) {
      int pj[kDepth];
      float pv[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int i = i0 + d;
        pj[d] = -1;
        pv[d] = 0.f;
        if (i < n) {
          const long long e = s_beg[i] + tid;
          if (e < s_end[i]) {
            pj[d] = inv_row[e];
            pv[d] = inv_val[e];
          }
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int i = i0 + d;
        if (i >= n) break;  // uniform across the block
        const float av = s_av[i];
        if (pj[d] >= 0) acc[pj[d] - j0] += fminf(av, pv[d]);
        for (long long e = s_beg[i] + tid + kThreads; e < s_end[i]; e += kThreads)
          acc[inv_row[e] - j0] += fminf(av, inv_val[e]);
        __syncthreads();  // column c's adds land before column c + 1's
      }
    }
  }
  __syncthreads();
  float* row_out = out + (size_t)q * J + j0;
  for (int t = tid; t < width; t += kThreads) row_out[t] = acc[t];
}

}  // namespace

extern "C" {

// Output columns per accumulation block; J may be at most 65535 times this.
long long min_sum_sparse_range() { return kRange; }

// Counts of x (rows, C): row_nnz[r] = non-zeros of row r; col_nnz[c] +=
// non-zeros of column c (skipped when col_nnz is null); *bad += entries
// that are < 0 or NaN. col_nnz and bad must be zeroed by the caller.
int sparse_count(const float* x, int rows, int C, int* row_nnz, int* col_nnz, void* bad,
                 void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  nnz_count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, rows, C, row_nnz, col_nnz, static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}

// CSR of x from its row pointers ptr (rows + 1, exclusive scan of
// row_nnz): col/val (and row, when not null) of every non-zero, rows in
// order, columns ascending within a row.
int sparse_fill(const float* x, int rows, int C, const long long* ptr, int* col, float* val,
                int* row, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  csr_fill_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, rows, C, ptr, col, val, row);
  return (int)cudaGetLastError();
}

// out (Q, J) from a's CSR (a_ptr (Q + 1), a_col, a_val) and b's inverted
// index (col_ptr (C + 1), inv_row, inv_val: per column, rows ascending).
int sparse_accumulate(const long long* a_ptr, const int* a_col, const float* a_val,
                      const long long* col_ptr, const int* inv_row, const float* inv_val, int Q,
                      int J, float* out, void* stream) {
  const int ranges = (J + kRange - 1) / kRange;
  if (Q <= 0 || J <= 0 || ranges > kMaxGridY) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(J < kRange ? J : kRange);
  cudaError_t err = cudaFuncSetAttribute(min_sum_accumulate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(sizeof(float) * kRange));
  if (err != cudaSuccess) return (int)err;
  min_sum_accumulate_kernel<<<dim3(Q, ranges), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      a_ptr, a_col, a_val, col_ptr, inv_row, inv_val, J, out);
  return (int)cudaGetLastError();
}

const char* min_sum_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
