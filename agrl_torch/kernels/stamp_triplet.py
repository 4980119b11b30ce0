"""Where the time goes inside csrc/triplet.cu's two kernels, on the card.

    python -m agrl_torch.kernels.stamp_triplet [--source FILE]

Copies the kernel source (default: agrl_torch/csrc/triplet.cu) with a
%globaltimer stamp written by each block's thread 0 at the end of every
phase, builds the copy with nvcc into agrl_torch/_build/, runs the
forward and the backward at the train step's shape (H=5 heads of
(16, 2048): the cluster schedule, the launch's parameter table) 30 times
each, and prints for each phase the median over the
last 20 runs of each block's time since the first block started (the
fastest, median and slowest block), then the device time per call of the
stamped kernels and of an empty kernel (torch.profiler). The stamps cost
time of their own: compare stamped copies with each other, not with the
times chip_smoke.py prints. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np

from agrl_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc

H, B, D = 5, 16, 2048
FORWARD_PHASES = ("start", "staged and met", "first chunk landed", "Gram done", "pushed",
                  "cluster barrier", "mined")
BACKWARD_PHASES = ("start", "loaded, S zeroed", "M written", "M^T written", "computed",
                   "stored")

_PRELUDE = """
__device__ unsigned long long g_stamps_fw[4096][8];
__device__ unsigned long long g_stamps_bw[4096][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_F(k) if (threadIdx.x == 0) \\
  g_stamps_fw[blockIdx.y * gridDim.x + blockIdx.x][k] = gtime();
#define STAMP_B(k) if (threadIdx.x == 0) \\
  g_stamps_bw[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x][k] = gtime();
"""

_READERS = """
extern "C" int read_stamps(int backward, unsigned long long* out, int n) {
  return (int)(backward ? cudaMemcpyFromSymbol(out, g_stamps_bw, 64 * n)
                        : cudaMemcpyFromSymbol(out, g_stamps_fw, 64 * n));
}
"""

# (text the stamp follows, stamp) in source order; each text must occur once
_ANCHORS = (
    ("namespace cg = cooperative_groups;\n", _PRELUDE),
    ("  const int rank = static_cast<int>(cluster.block_rank());\n", "  STAMP_F(0)\n"),
    ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n'
     "  __syncthreads();\n", "  STAMP_F(1)\n"),
    ("    __syncthreads();  // chunk k from every thread's copies\n",
     "    if (k == 0) { STAMP_F(2) }\n"),
    ('  if (nch == 0) asm volatile("cp.async.wait_group 0;\\n" ::: "memory");  // the labels\n',
     "  STAMP_F(3)\n"),
    ("  cluster.sync();  // every partial has landed in the block that sums it\n",
     "  STAMP_F(5)\n"),
    ("      i_an[out] = k_an;\n    }\n  }\n", "  STAMP_F(6)\n"),
    ("  const float* f = heads[h];\n\n", "  STAMP_B(0)\n"),
    ("  for (int e = tid; e < kBand * B; e += kThreads) ST[e] = 0.f;\n  __syncthreads();\n",
     "  STAMP_B(1)\n"),
    ("    if (wi[p] != 0.f) ST[ki[p] * kBand + tid] = wi[p];\n  __syncthreads();\n",
     "  STAMP_B(2)\n"),
    ("ST[tid * kBand + kj[p] - i0] += wj[p];\n  __syncthreads();\n", "  STAMP_B(3)\n"),
    ("    if (j < B) add_row(j, x0[j]);\n  for (int j = kBand; j < B; ++j) "
     "add_row(j, f[(size_t)j * D + c]);\n", "  STAMP_B(4)\n"),
    ("rs[t] * xb[t] - acc[t];\n}\n", None),
)


def stamped_source(src: str) -> str:
    """`src` with the stamps inserted; raises if a phase's text is missing."""
    for anchor, stamp in _ANCHORS:
        if src.count(anchor) != 1:
            raise ValueError(f"phase anchor not found once in the source: {anchor!r}")
        if stamp is None:  # the backward's end: the stamp goes before the closing brace
            src = src.replace(anchor, anchor[:-2] + "  STAMP_B(5)\n}\n")
        else:
            src = src.replace(anchor, anchor + stamp)
    # the forward's pushes end where the cluster barrier starts
    src = src.replace("  cluster.sync();  // every partial has landed",
                      "  STAMP_F(4)\n  cluster.sync();  // every partial has landed")
    return src + _READERS


def build(source) -> ctypes.CDLL:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / "triplet_stamped.cu"
    cu.write_text(stamped_source(source.read_text()))
    lib = BUILD_DIR / "libtriplet_stamped.so"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.hard_mine_heads_forward.argtypes = [p, p, i, p, i, i, p, p, p, p, p, p]
    dll.hard_mine_heads_backward.argtypes = [p, p, p, i, i, i, p, p, p, p, p, p, f, p]
    dll.hard_mine_empty_launch.argtypes = [p]
    dll.read_stamps.argtypes = [i, p, i]
    return dll


def phase_table(run, read, blocks, names, iters=30, keep=20):
    """Per phase: (fastest, median, slowest block) of the median over the
    last `keep` runs of each block's ns since the first block started."""
    runs = []
    for _ in range(iters):
        run()
        stamps = np.zeros((blocks, 8), np.uint64)
        read(stamps, blocks)
        t = stamps[:, :len(names)].astype(np.int64)
        runs.append(t - t[:, 0].min())
    per_block = np.median(np.stack(runs[-keep:]), axis=0)
    return [(n, *np.percentile(per_block[:, k], [0, 50, 100])) for k, n in enumerate(names)]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default=str(CSRC_DIR / "triplet.cu"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from pathlib import Path

    from agrl_torch.ops.triplet import _DIST_MIN

    dll = build(Path(args.source))
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    labels = torch.from_numpy(np.repeat(np.arange(B // 4), 4)).to(dev)
    heads = [torch.from_numpy(rng.randn(B, D).astype(np.float32)).to(dev) for _ in range(H)]
    grads = [torch.empty_like(x) for x in heads]
    ptrs = (ctypes.c_void_p * H)(*(x.data_ptr() for x in heads))
    gptrs = (ctypes.c_void_p * H)(*(g.data_ptr() for g in grads))
    outs = [torch.empty(H, B, device=dev), torch.empty(H, B, device=dev),
            torch.empty(H, B, dtype=torch.int64, device=dev),
            torch.empty(H, B, dtype=torch.int64, device=dev)]
    g_ap, g_an = (torch.rand(H, B, device=dev) / B for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    def forward():
        check(dll.hard_mine_heads_forward(ptrs, None, H, labels.data_ptr(), B, D,
                                          *(o.data_ptr() for o in outs), None, stream))
        torch.cuda.synchronize()

    def backward():
        check(dll.hard_mine_heads_backward(ptrs, gptrs, None, H, B, D,
                                           *(o.data_ptr() for o in outs),
                                           g_ap.data_ptr(), g_an.data_ptr(), _DIST_MIN, stream))
        torch.cuda.synchronize()

    def reader(backward_side):
        return lambda a, n: check(dll.read_stamps(backward_side, a.ctypes.data, n))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"stamped {args.source} at H={H} B={B} D={D}; {smi}")
    for name, run, read, blocks, phases in (
        ("forward", forward, reader(0), 8 * H, FORWARD_PHASES),
        ("backward", backward, reader(1), ((D + 127) // 128) * H, BACKWARD_PHASES),
    ):
        print(f"{name}: ns since the first block started (fastest, median, slowest block)")
        for phase, lo, med, hi in phase_table(run, read, blocks, phases):
            print(f"  {phase:20s} {lo:7.0f} {med:7.0f} {hi:7.0f}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            forward()
            backward()
            check(dll.hard_mine_empty_launch(stream))
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            print(f"device time per call {us / e.count:7.2f} us x{e.count} {e.key[:70]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
