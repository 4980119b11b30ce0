#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (agrl_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the graph-conv kernel library from agrl_torch/csrc (nvcc);
  3. kernel vs its plain PyTorch version on the card, TF32 off: the
     serving shape B=16 V=56 C=2048 (atol 2e-4), a ragged B=3 V=40
     (atol 2e-4), and the bf16-held v2 entry on rounded inputs (atol
     2e-3); times with CUDA events, L2 flushed before every call;
  4. the serving path at the paper config (VMGN, ResNet-50, 256x128,
     seq_len 8, 4-way pyramid parts -> V=56, two graph layers, random
     weights from a seed): FeatureExtractor(batch_size=16) answers 1-,
     16- and 21-clip requests; the kernel's launch count must rise by
     2 per 16-clip chunk;
  5. the whole model, kernel path vs plain path, on one 16-clip batch;
  6. the same 2 clips on the CPU and on the card;
  7. the `evenly` Evaluator (cosine, MARS CMC/mAP on the card) on the
     synthetic dataset at 256x128;
then one {"serving": ...} line, one {"kernels": [...]} line, the card's
name and power limit, and {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SEQ_LEN, HEIGHT, WIDTH, BATCH = 8, 256, 128, 16
# device kernels of agrl_torch/csrc/graph_conv.cu, as the profiler names them
GRAPH_KERNELS = ("gram_partial_kernel", "graph_blend_kernel", "graph_propagate_kernel")
NUM_CLASSES = 625  # MARS training identities


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class L2Flusher:
    """Writes a buffer larger than the 50 MB L2 so the next call finds its
    inputs in device memory, as it would between the model's layers."""

    def __init__(self, torch, device):
        self.buf = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.zero_()


def time_cuda(torch, fn, flush, iters=20, warmup=3) -> float:
    """Mean ms of fn() over `iters` calls, each after an L2 flush, timed
    by CUDA events around the call alone."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def graph_inputs(torch, B, V, C, seed, device):
    rng = np.random.RandomState(seed)
    arrs = (
        rng.rand(B, V, C) * 2.0,                 # ReLU-like vertex features
        (rng.rand(B, V, V) > 0.5) * 1.0,          # pose-like 0/1 graph
        rng.randn(C, C) * 0.01,                  # graph Linear ~ N(0, 0.01)
        rng.rand(C) + 0.5, rng.randn(C) * 0.1,   # BN scale, bias
        rng.randn(C) * 0.1, rng.rand(C) + 0.5,   # BN running mean, var
    )
    t = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]
    t[2] = t[2].t().contiguous().t()  # W as the transpose view of a Linear weight
    return t


def graph_bound_ms(B, V, C):
    """Least time for one fused call: fp32 FLOPs of f@W, the Gram and G@h
    over the fp32 peak vs bytes of f, adj, W, BN vectors in and out over
    the HBM rate; the larger one bounds."""
    flops = 2.0 * B * V * C * C + 2 * (2.0 * B * V * V * C)
    nbytes = 4.0 * (2 * B * V * C + B * V * V + C * C + 4 * C)
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def phase_kernels(torch, gc, device, flush):
    """Kernel vs plain on the card; returns the serving-shape record."""
    cases = [("serving B=16 V=56", 16, 56, 2048, 0), ("ragged B=3 V=40", 3, 40, 2048, 1)]
    rec = {}
    for label, B, V, C, seed in cases:
        args = graph_inputs(torch, B, V, C, seed, device)
        got = gc.graph_propagate(*args)
        want = gc.graph_propagate_reference(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f"[kernel] {label} C={C}: max|kernel - plain| = {err:.3e} (atol 2e-4)")
        if not (err <= 2e-4):
            raise AssertionError(f"kernel disagrees with plain at {label}: {err}")
        if B == 16:
            f, W = args[0], args[2]
            f2 = f.reshape(B * V, C)
            rec = dict(
                max_abs_err=err,
                ms=time_cuda(torch, lambda: gc.graph_propagate(*args), flush),
                plain_ms=time_cuda(torch, lambda: gc.graph_propagate_reference(*args), flush),
                library_ms=time_cuda(torch, lambda: torch.matmul(f2, W), flush),
            )
            rec["bound_ms"], rec["bound_by"] = graph_bound_ms(B, V, C)
            v2_args = args
    # the v2 entry: f and adj held in bf16, same kernel, fp32 math
    got = gc.graph_propagate_v2(*v2_args)
    want = gc.graph_propagate_reference(
        gc.round_bf16(v2_args[0]), gc.round_bf16(v2_args[1]), *v2_args[2:]
    )
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"[kernel] v2 (bf16-held f, adj) B=16 V=56: max|kernel - plain| = {err:.3e} (atol 2e-3)")
    if not (err <= 2e-3):
        raise AssertionError(f"v2 entry disagrees with plain: {err}")
    rec["v2_max_abs_err"] = err
    rec["v2_ms"] = time_cuda(torch, lambda: gc.graph_propagate_v2(*v2_args), flush)
    log(
        f"[kernel] serving shape: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"torch.matmul(f, W) alone {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), v2 {rec['v2_ms']:.4f} ms"
    )
    return rec


def random_clips(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, SEQ_LEN, HEIGHT, WIDTH, 3)).astype(np.uint8)


def pose_adjacency(n, seed):
    """Pose graphs from plausible random standing poses (the synthetic
    dataset's pose model), built by the port's GraphBuilder."""
    from agrl_torch.data.datasets.synthetic import _make_pose
    from agrl_torch.data.graph import GraphBuilder

    rng = np.random.RandomState(seed)
    gb = GraphBuilder(num_split=4, pyramid_part=True)
    heights = np.full(SEQ_LEN, HEIGHT, np.float64)
    return np.stack([
        gb(np.stack([_make_pose(rng, WIDTH, HEIGHT) for _ in range(SEQ_LEN)]), heights)
        for _ in range(n)
    ]).astype(np.float32)


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_serving(torch, gc, fx):
    """Main path: FeatureExtractor requests of 1, 16 and 21 clips."""
    requests = {
        1: (random_clips(1, 10), None),
        16: (random_clips(16, 11), None),
        21: (random_clips(21, 12), pose_adjacency(21, 12)),
    }
    outs = {}
    gc.launches = 0  # main path starts here
    expected = 0
    for n, (imgs, adjs) in requests.items():
        before = gc.launches
        t0 = time.perf_counter()
        out = fx(imgs, adjs)
        dt = time.perf_counter() - t0
        chunks = math.ceil(n / BATCH)
        expected += 2 * chunks
        log(f"[serve] {n:2d} clips -> {out.shape}, {dt * 1e3:.1f} ms, "
            f"graph kernel launches +{gc.launches - before} (want {2 * chunks})")
        if out.shape != (n, 4096) or not np.isfinite(out).all():
            raise AssertionError(f"bad features for a {n}-clip request")
        if gc.launches - before != 2 * chunks:
            raise AssertionError("graph kernel launch count != 2 per 16-clip chunk")
        outs[n] = out
    launches = gc.launches  # main path ends here
    if launches != expected:
        raise AssertionError(f"{launches} launches on the main path, want {expected}")

    imgs21, adjs21 = requests[21]
    worst = 0.0
    for i in (0, 7, 16, 20):  # both chunks, several batch positions
        alone = fx(imgs21[i:i + 1], adjs21[i:i + 1])[0]
        worst = max(worst, rel_err(alone, outs[21][i]))
    log(f"[serve] row alone vs inside the 21-clip request: "
        f"max|diff|/max|row| = {worst:.3e} (tol 1e-5)")
    if not (worst <= 1e-5):
        raise AssertionError("a clip's features depend on its request")

    # serving speed: the 16-clip request end to end (H2D, forward, D2H)
    imgs16 = requests[16][0]
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fx(imgs16)
        times.append((time.perf_counter() - t0) * 1e3)
    q1, ms, q3 = (float(v) for v in np.percentile(times, [25, 50, 75]))
    log(f"[serve] 16-clip request: median {ms:.2f} ms (quartiles {q1:.2f}-{q3:.2f}) over 10, "
        f"{BATCH / ms * 1e3:.1f} clips/s")
    return launches, dict(
        request16_ms=ms, request16_q1_ms=q1, request16_q3_ms=q3,
        clips_per_s=BATCH / ms * 1e3, request16_all_ms=times,
    )


def phase_model_paths(torch, layers_mod, gc, model, device):
    """Whole model on one 16-clip batch: kernel path vs plain path (only the
    graph layers differ)."""
    from agrl_torch.data.transforms import preprocess_clips

    x = preprocess_clips(torch.from_numpy(random_clips(BATCH, 20)).to(device))
    adj = torch.from_numpy(pose_adjacency(BATCH, 20)).to(device)
    with torch.inference_mode():
        kern = model(x, adj)
        layers_mod.graph_propagate = gc.graph_propagate_reference
        try:
            plain = model(x, adj)
        finally:
            layers_mod.graph_propagate = gc.graph_propagate
    # device forward time of one 16-clip batch (events, no H2D/D2H)
    with torch.inference_mode():
        fwd_ms = time_cuda(torch, lambda: model(x, adj), lambda: None, iters=5, warmup=1)
    kern, plain = kern.cpu().numpy(), plain.cpu().numpy()
    err = rel_err(kern, plain)
    log(f"[model] kernel path vs plain path, 16 clips: max|diff|/max|plain| = {err:.3e} "
        f"(tol 1e-5); forward {fwd_ms:.2f} ms per 16-clip batch")
    if not (np.isfinite(kern).all() and err <= 1e-5):
        raise AssertionError("kernel path and plain path disagree")
    return fwd_ms, err, profile_forward(torch, model, x, adj)


def profile_forward(torch, model, x, adj, n=3):
    """Device time by kernel over `n` forwards of one 16-clip batch
    (torch.profiler), the graph kernels' share of it, and the card's busy
    share of the window (kernel time / event-timed wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x, adj)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                model(x, adj)
            end.record()
            end.synchronize()
    window_ms = start.elapsed_time(end)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((e.key, us / 1e3 / n, e.count // n))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    ours = [r for r in rows if any(k in r[0] for k in GRAPH_KERNELS)]
    graph_ms = sum(r[1] for r in ours)
    log(f"[profile] {n} forwards: device busy {busy_ms:.2f} ms per forward, "
        f"{busy_ms * n / window_ms:.1%} of the {window_ms / n:.2f} ms window; "
        f"graph kernels {graph_ms:.3f} ms ({graph_ms / max(busy_ms, 1e-9):.2%})")
    for name, ms, count in rows[:12]:
        log(f"[profile]   {ms:8.3f} ms x{count:<3d} {name[:90]}")
    return dict(
        device_busy_ms=busy_ms, busy_share=busy_ms * n / window_ms,
        graph_kernels_ms=graph_ms,
        graph_kernels=ours,
        top=rows[:12],
    )


def phase_card_vs_cpu(torch, build_model_fn, fx):
    from agrl_torch.engine.export import FeatureExtractor

    cpu_model = build_model_fn("cpu")
    fx_cpu = FeatureExtractor(cpu_model, batch_size=2, seq_len=SEQ_LEN, device="cpu")
    imgs, adjs = random_clips(2, 30), pose_adjacency(2, 30)
    t0 = time.perf_counter()
    ref = fx_cpu(imgs, adjs)
    cpu_s = time.perf_counter() - t0
    got = fx(imgs, adjs)
    err = rel_err(got, ref)
    log(f"[cpu] card vs CPU, 2 clips: max|diff|/max|cpu| = {err:.3e} (tol 1e-3); "
        f"CPU took {cpu_s:.1f} s")
    if not (err <= 1e-3):
        raise AssertionError("card and CPU features disagree")
    return err


def phase_evaluator(torch, gc, model, device):
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.engine.evaluator import Evaluator

    build_dir = REPO / "agrl_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        t0 = time.perf_counter()
        ds = init_vidreid_dataset(
            "synthetic", root=root, num_pids=6, tracklets_per_pid=4,
            frames_per_tracklet=(10, 16), height=HEIGHT, width=WIDTH, verbose=False,
        )
        log(f"[eval] synthetic dataset written in {time.perf_counter() - t0:.1f} s")

        def loader(split):
            dset = VideoClipDataset(
                getattr(ds, split), seq_len=SEQ_LEN, sample="evenly", height=HEIGHT,
                width=WIDTH, pose_info=ds.process_poses,
            )
            return ClipLoader(dset, batch_size=BATCH, num_workers=4)

        gc.launches = 0
        r1, mAP = Evaluator(model, test_sample="evenly", device=device).evaluate(
            loader("query"), loader("gallery"), dist_metric="cosine"
        )
    if not (0.0 <= r1 <= 1.0 and 0.0 <= mAP <= 1.0) or gc.launches == 0:
        raise AssertionError(f"evaluator: rank-1 {r1}, mAP {mAP}, launches {gc.launches}")
    log(f"[eval] evenly evaluator: rank-1 {r1:.4f}, mAP {mAP:.4f}, "
        f"graph kernel launches {gc.launches}")
    return r1, mAP


def main() -> int:
    if not (REPO / "agrl_torch" / "csrc" / "graph_conv.cu").exists():
        print("chip_smoke.py: the agrl_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    from agrl_torch.models import default_num_vertices, init_model
    from agrl_torch.models import layers as layers_mod
    from agrl_torch.ops import graph_conv as gc
    from agrl_torch.engine.export import FeatureExtractor
    from agrl_torch.kernels.build import library_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = nvidia_smi_line()
    log(f"[card] nvidia-smi: {smi}; torch: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    gc._lib()
    log(f"[build] graph_conv library ready in {time.perf_counter() - t0:.1f} s "
        f"({library_path('graph_conv').name})")
    for line in library_path("graph_conv").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # 3. kernel vs plain
    flush = L2Flusher(torch, device)
    krec = phase_kernels(torch, gc, device, flush)
    del flush

    # 4. serving at the paper config
    def build(dev):
        return init_model(
            "vmgn", num_classes=NUM_CLASSES, device=dev, seed=0, num_split=4,
            pyramid_part=True, num_gb=2, use_pose=True, learn_graph=True,
        )

    model = build(device)
    V = default_num_vertices(model, SEQ_LEN)
    log(f"[serve] VMGN paper config: ResNet-50 (3,4,6,3), {HEIGHT}x{WIDTH}, seq_len {SEQ_LEN}, "
        f"V={V}, num_gb 2, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")
    fx = FeatureExtractor(model, batch_size=BATCH, seq_len=SEQ_LEN, device=device)
    torch.cuda.reset_peak_memory_stats()
    launches, serving = phase_serving(torch, gc, fx)
    serving["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # 5. kernel path vs plain path, whole model
    fwd_ms, model_err, serving["profile"] = phase_model_paths(
        torch, layers_mod, gc, model, device
    )
    serving["forward16_device_ms"] = fwd_ms
    serving["model_kernel_vs_plain_rel_err"] = model_err

    # 6. card vs CPU
    serving["card_vs_cpu_rel_err"] = phase_card_vs_cpu(torch, build, fx)

    # 7. evaluator
    r1, mAP = phase_evaluator(torch, gc, model, device)
    serving.update(eval_rank1=r1, eval_mAP=mAP)

    serving["smoke_seconds"] = time.perf_counter() - t_start
    print(json.dumps({"serving": serving}))
    kernel = {
        "name": "graph_propagate",
        "route": "cuda",
        "source": "agrl_torch/csrc/graph_conv.cu",
        "replaces": "agrl_tpu/ops/graph_conv.py:127",
        "also_replaces": "agrl_tpu/ops/graph_conv_v2.py:102",
        "launches": launches,
        "max_abs_err": krec["max_abs_err"],
        "ms": krec["ms"],
        "kernel_ms": krec["ms"],
        "plain_ms": krec["plain_ms"],
        "bound_ms": krec["bound_ms"],
        "bound_by": krec["bound_by"],
        "library_ms": krec["library_ms"],
        "library_call": "torch.matmul(f, W): the f@W product alone",
        "v2_max_abs_err": krec["v2_max_abs_err"],
        "v2_ms": krec["v2_ms"],
        "shape": "B=16 V=56 C=2048 fp32",
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
