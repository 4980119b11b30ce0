// Min-plus product for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel agrl_tpu/ops/minsum.py:59 min_sum_pallas. For
// a (Q, C) and b (J, C), row-major:
//
//   out[q, j] = sum_c min(a[q, c], b[j, c])          out is (Q, J)
//
// the Jaccard term of k-reciprocal re-ranking (agrl_torch/ops/rerank.py),
// where a holds the query rows of the membership matrix v and b all of
// it. It is a matrix product over the (min, +) semiring, which has no
// tensor-core form, so the design is an fp32 register-blocked "SGEMM"
// with fminf + add in place of the FMA:
//
//   * a 2-D grid of 128 x 128 output tiles, q tiles on x (blocks that run
//     together share one b tile, which is read from device memory about
//     once; a, 90 MB at the MARS shape, is re-read through L2);
//   * 256 threads, each holding an 8 x 8 micro-tile of accumulators in
//     registers: rows ty + 16 i, columns tx + 16 k (tx, ty < 16);
//   * the whole C loop runs inside the block, in chunks of 16 columns of
//     a and b staged in shared memory as rows of 20 floats. Each thread
//     loads its 2 x 8 floats of the next chunk into registers while the
//     block computes on the current one, and stores them after the next
//     barrier. Staging reads 64 coalesced bytes of each of two rows per
//     warp; the compute reads float4s along C, and the 8 threads of a
//     quarter-warp read 8 consecutive rows of b whose 16-byte slots
//     5 r mod 8 are all distinct (conflict-free), while all of them read
//     one row of a (a broadcast);
//   * sum order, fixed (deterministic, no atomics): each float4 step adds
//     (min + min) + (min + min) into a partial sum over 32 columns (two
//     chunks), and each partial goes into the accumulator. The
//     accumulator takes C / 32 adds instead of C / 4, which keeps the
//     fp32 error at a few ulps of the result for 1 add per 32 terms more
//     (adding each float4 step straight into the accumulator reached
//     1.37e-4, ~9 ulps, at C = 515 on an H100: beyond the JAX package's
//     1e-4 bar).
//
// Ragged edges: both a and b are zero-filled past C, and min(0, 0) = 0 is
// exact whatever the sign of the real entries; rows past Q or J are
// staged as zeros and their outputs are not stored. Unlike the Pallas
// kernel, which writes a transposed (J, Q) slab, this one writes (Q, J).
//
// Bound on an H100 SXM at the MARS shape (Q = 1,980, J = C = 11,310):
// 2.53e11 terms, each one FMNMX and one FADD (no fusion into an FMA).
// FADD runs on the FP32 pipe at 128 lanes per SM per clock; FMNMX runs on
// the ALU pipe at half that rate, 64 lanes per SM per clock, and the four
// schedulers of an SM issue one warp instruction each per clock, so both
// limits give the same 64 terms per SM per clock: 2.53e11 / (132 SMs x 64
// x 1.98 GHz) = ~15 ms, i.e. 2 instructions per term at ~33.5 T fp32
// instructions/s. Bytes: 4 (QC + JC + QJ) = 690 MB at 3.35 TB/s, ~0.21 ms.
// So on dense inputs operations bound it, by ~70x; the 16 LDS.128 per 512
// ALU/FP32 instructions and the staging are a few percent of the issue
// slots. The 64 accumulators, 64 partials, 8 float4 of a and the 16
// prefetched floats need ~180 registers, so one block runs per SM (8
// warps): the prefetch, not a second block, hides the loads. On the
// re-ranking's own v (>98% zeros) the terms with both operands non-zero
// are a small share of Q J C and the bound falls to the bytes; skipping
// chunks where a or b is all zero, and cp.async/TMA staging, are later
// work.
//
// Limits: Q, J, C > 0 and ceil(J / 128) <= 65535 (grid y).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 128;           // output rows (q) and columns (j) per block
constexpr int kChunk = 16;           // C columns staged per step
constexpr int kStride = kChunk + 4;  // shared row stride: 20 floats = 5 float4 slots
constexpr int kSpan = 32;            // C columns per partial sum
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kMicro = 8;            // each an 8 x 8 micro-tile
constexpr int kMaxGridY = 65535;
constexpr int kPerThread = kTile * kChunk / kThreads;  // staged floats per thread and operand

// Rows row0..row0+127, columns c0..c0+15 of src (rows x C) into registers;
// zero outside. One warp covers two rows: two 64-byte coalesced reads.
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, int rows, int C,
                                           int row0, int c0, float (&reg)[kPerThread]) {
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int gr = row0 + idx / kChunk;
    const int gc = c0 + idx % kChunk;
    reg[it] = (gr < rows && gc < C) ? src[(size_t)gr * C + gc] : 0.f;
  }
}

// The same slots into shared memory.
__device__ __forceinline__ void store_chunk(const float (&reg)[kPerThread],
                                            float (*dst)[kStride]) {
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    dst[idx / kChunk][idx % kChunk] = reg[it];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
min_sum_kernel(const float* __restrict__ a, const float* __restrict__ b, int Q, int J, int C,
               float* __restrict__ out) {
  __shared__ __align__(16) float as[kTile][kStride];
  __shared__ __align__(16) float bs[kTile][kStride];

  const int q0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // acc[i][k]: out[q0 + ty + 16 i, j0 + tx + 16 k]; part: its share from
  // the current kSpan columns
  float acc[kMicro][kMicro];
  float part[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int k = 0; k < kMicro; ++k) acc[i][k] = part[i][k] = 0.f;

  float ra[kPerThread], rb[kPerThread];
  load_chunk(a, Q, C, q0, 0, ra);
  load_chunk(b, J, C, j0, 0, rb);

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    store_chunk(ra, as);
    store_chunk(rb, bs);
    __syncthreads();
    if (c0 + kChunk < C) {  // the next chunk's loads fly during this chunk's arithmetic
      load_chunk(a, Q, C, q0, c0 + kChunk, ra);
      load_chunk(b, J, C, j0, c0 + kChunk, rb);
    }

#pragma unroll 1
    for (int c = 0; c < kChunk; c += 4) {
      float4 av[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        av[i] = *reinterpret_cast<const float4*>(&as[ty + 16 * i][c]);
#pragma unroll
      for (int k = 0; k < kMicro; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(&bs[tx + 16 * k][c]);
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          part[i][k] += (fminf(av[i].x, bv.x) + fminf(av[i].y, bv.y)) +
                        (fminf(av[i].z, bv.z) + fminf(av[i].w, bv.w));
        }
      }
    }
    if ((c0 + kChunk) % kSpan == 0 || c0 + kChunk >= C) {
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int k = 0; k < kMicro; ++k) {
          acc[i][k] += part[i][k];
          part[i][k] = 0.f;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) break;
#pragma unroll
    for (int k = 0; k < kMicro; ++k) {
      const int j = j0 + tx + 16 * k;
      if (j < J) out[(size_t)q * J + j] = acc[i][k];
    }
  }
}

}  // namespace

extern "C" {

// Largest J min_sum_forward takes (the j tiles run on grid y).
long long min_sum_max_rows() { return (long long)kMaxGridY * kTile; }

// a (Q, C), b (J, C), out (Q, J): fp32, contiguous, on the current
// device. Returns 0 or the cudaError_t of the launch.
int min_sum_forward(const float* a, const float* b, int Q, int J, int C, float* out,
                    void* stream) {
  if (Q <= 0 || J <= 0 || C <= 0 || (J + kTile - 1) / kTile > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + kTile - 1) / kTile, (J + kTile - 1) / kTile);
  min_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, Q, J, C, out);
  return (int)cudaGetLastError();
}

const char* min_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
