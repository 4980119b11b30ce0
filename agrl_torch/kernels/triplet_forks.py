"""The two forks of csrc/triplet.cu that K3's wrapper settles by shape,
each timed against the road it does not take, on the card.

    python -m agrl_torch.kernels.triplet_forks

1. The head table. The wrapper hands the kernels up to 64 head pointers
   in the launch's parameters and more in a device array, which it copies
   up before each launch; the C interface takes a device array at any H.
   At the train steps' (H, B, D) = (5, 16, 2048), (22, 16, 1536) and
   (64, 16, 1536): both kernels with each table, the device one with its
   copy, as the wrapper makes it; their outputs bit-equal.
2. The backward schedule. B <= kShortBackwardBatch takes the S-matrix
   backward (hard_mine_heads_backward_kernel), a larger B the pick-based
   one (hard_mine_long_backward_kernel), which takes any B. Two copies of
   the source are built into agrl_torch/_build/, one whose S-matrix
   backward takes every B up to the cluster schedule's 256, one whose
   pick-based backward takes every B, and both backwards run at the same
   three shapes and at H=5 D=2048 with B = 32 to 256, where the threshold
   is chosen; their gradients within 1e-5 of max of each other (they sum
   in other orders).

Device time per call (torch.profiler, every device operation of the call)
over 20 calls, in the order a, b, b, a. Prints the card's name and power
limit, a line per shape and one JSON line. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from agrl_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, _compile, _hashed_path, find_nvcc

TABLE_SHAPES = ((5, 16, 2048), (22, 16, 1536), (64, 16, 1536))
BACKWARD_SHAPES = TABLE_SHAPES + tuple((5, B, 2048) for B in (32, 64, 96, 128, 192, 256))
# the threshold of the backward's fork
_THRESHOLD = re.compile(r"^constexpr int kShortBackwardBatch = (\d+);$", re.M)


def backward_source(src: str, threshold: int) -> str:
    """`src` with the S-matrix backward taking B <= `threshold` (0: none)."""
    if len(_THRESHOLD.findall(src)) != 1:
        raise ValueError("kShortBackwardBatch is not defined once in the source")
    return _THRESHOLD.sub(f"constexpr int kShortBackwardBatch = {threshold};", src)


def build_backward(threshold: int) -> ctypes.CDLL:
    """The copy whose S-matrix backward takes B <= `threshold`."""
    from agrl_torch.kernels.build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    name = f"triplet_backward_{threshold}"
    cu = BUILD_DIR / f"{name}.cu"
    cu.write_text(backward_source((CSRC_DIR / "triplet.cu").read_text(), threshold))
    lib = ctypes.CDLL(str(_compile([find_nvcc(), *NVCC_FLAGS], cu,
                                   _hashed_path(name, cu, NVCC_FLAGS))))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hard_mine_heads_backward.argtypes = [p, p, p, i, i, i, p, p, p, p, p, p, f, p]
    return lib


def device_ms(torch, fn, n=20) -> float:
    """Device time per call of fn(): every device operation it launched,
    summed over n calls (torch.profiler), over n."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages())
    return us / n / 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from agrl_torch.ops import triplet as tri

    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(2) as pool:  # one nvcc for each copy, started together
        short_lib, long_lib = pool.map(build_backward, (tri.SHORT_MAX_BATCH, 0))
    lib = tri._lib()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: {lib.hard_mine_error_string(rc).decode()}")

    def case(H, B, D):
        rng = np.random.RandomState(H * B + D)
        labels = torch.from_numpy(np.repeat(np.arange(B // 4), 4)).to(dev)
        heads = [torch.from_numpy(rng.randn(B, D).astype(np.float32)).to(dev)
                 for _ in range(H)]
        g_ap, g_an = (torch.from_numpy(rng.rand(H, B).astype(np.float32) / B).to(dev)
                      for _ in range(2))
        return heads, labels, tri.hard_mine_heads_kernel(heads, labels), g_ap, g_an

    def forward(heads, labels, table):
        H, (B, D) = len(heads), heads[0].shape
        out = [torch.empty(H, B, device=dev), torch.empty(H, B, device=dev),
               torch.empty(H, B, dtype=torch.int64, device=dev),
               torch.empty(H, B, dtype=torch.int64, device=dev)]

        def run():
            dtab = tri._device_table(heads, dev) if table == "device" else None
            check(lib.hard_mine_heads_forward(
                tri._pointers(heads), None if dtab is None else dtab.data_ptr(), H,
                labels.data_ptr(), B, D, *(o.data_ptr() for o in out), None, stream))
        return run, out

    def backward(which, heads, mined, g_ap, g_an, table="param"):
        H, (B, D) = len(heads), heads[0].shape
        grads = [torch.empty_like(f) for f in heads]

        def run():
            dtab = tri._device_table(heads + grads, dev) if table == "device" else None
            check(which.hard_mine_heads_backward(
                tri._pointers(heads), tri._pointers(grads),
                None if dtab is None else dtab.data_ptr(), H, B, D,
                *(x.data_ptr() for x in mined), g_ap.data_ptr(), g_an.data_ptr(),
                tri._DIST_MIN, stream))
        return run, grads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    record = {"card": smi, "tables": [], "backwards": []}
    ok = True
    for H, B, D in TABLE_SHAPES:
        heads, labels, mined, g_ap, g_an = case(H, B, D)
        runs = {t: (forward(heads, labels, t), backward(lib, heads, mined, g_ap, g_an, t))
                for t in ("param", "device")}
        for (fw, out), (bw, grads) in runs.values():
            fw()
            bw()
        torch.cuda.synchronize()
        (_, out_p), (_, grads_p) = runs["param"]
        (_, out_d), (_, grads_d) = runs["device"]
        same = (all(torch.equal(a, b) for a, b in zip(out_p, out_d))
                and all(torch.equal(a, b) for a, b in zip(grads_p, grads_d)))
        rec = dict(H=H, B=B, D=D, bit_equal=same)
        for t in ("param", "device", "device", "param"):
            (fw, _), (bw, _) = runs[t]
            rec.setdefault(f"{t}_ms", []).append(device_ms(torch, fw))
            rec.setdefault(f"{t}_backward_ms", []).append(device_ms(torch, bw))
        print(f"head table H={H} B={B} D={D}: forward param {rec['param_ms']} ms, device "
              f"{rec['device_ms']} ms; backward param {rec['param_backward_ms']} ms, device "
              f"{rec['device_backward_ms']} ms; bit-equal {same}")
        record["tables"].append(rec)
        ok &= same
    for H, B, D in BACKWARD_SHAPES:
        heads, labels, mined, g_ap, g_an = case(H, B, D)
        runs = {"short": backward(short_lib, heads, mined, g_ap, g_an),
                "long": backward(long_lib, heads, mined, g_ap, g_an)}
        for bw, _ in runs.values():
            bw()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(runs["long"][1], runs["short"][1]))
        rec = dict(H=H, B=B, D=D, long_vs_short_rel_err=err)
        for which in ("short", "long", "long", "short"):
            rec.setdefault(f"{which}_backward_ms", []).append(device_ms(torch, runs[which][0]))
        print(f"backward H={H} B={B} D={D}: S-matrix {rec['short_backward_ms']} ms, "
              f"pick-based {rec['long_backward_ms']} ms; gradients {err:.3e} of max apart "
              "(tol 1e-5)")
        record["backwards"].append(rec)
        ok &= err <= 1e-5
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
