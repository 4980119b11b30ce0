#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (agrl_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the four kernel libraries from agrl_torch/csrc (graph_conv,
     triplet, minsum, minsum_sparse; one nvcc each, in parallel) and
     print each kernel's registers and spills from the -Xptxas -v logs;
  3. K1 (3xTF32 on the tensor cores) vs its plain PyTorch version on the
     card, TF32 off: the serving shape B=16 V=56 C=2048 (atol 2e-4; and
     within 1e-6 of max|output| of a float64 run), a ragged B=3 V=40
     (atol 2e-4), and the bf16-held v2 entry on rounded inputs (atol
     2e-3); times with CUDA events, L2 flushed before every call; the
     bound on the tensor cores and the old fp32-FMA bound;
  4. the serving path at the paper config (VMGN, ResNet-50, 256x128,
     seq_len 8, 4-way pyramid parts -> V=56, two graph layers, random
     weights from a seed): FeatureExtractor(batch_size=16, bf16=False)
     answers 1-, 16- and 21-clip requests in fp32; the kernel's launch
     count must rise by 2 per 16-clip chunk;
  5. the whole model, kernel path vs plain path, on one 16-clip batch;
  6. the same 2 clips on the CPU and on the card;
  7. the `evenly` Evaluator (cosine, MARS CMC/mAP on the card) on the
     synthetic dataset at 256x128, then with re_rank=True: mars,
     market1501 and dukev re-ranked on the card (one sparse K4 call
     each; dukev scores on the host), the re-ranked distmat export
     (return_distmat, one sparse K4 call) and mars on the host path
     (device_rank=False), whose mAP must equal the device path's within
     1e-6;
  8. the batch-hard mining kernels (K3: one forward launch for H heads,
     one backward launch) vs their plain versions, TF32 off: H=5 B=16
     D=2048 (the train step), H=1 B=15, H=5 B=64, H=3 B=256; values atol
     1e-4, picks equal, the multi-head loss's gradients vs the plain
     path's autograd atol 1e-5, two calls bit-equal; at the train shape,
     device time per call (profiler) and CUDA-event call times (L2
     flushed) of both kernels, their plain versions and batched
     torch.cdist, an empty kernel's call, the bounds, and the whole
     triplet term (forward and backward: the kernels, the per-head path,
     the earlier design's structure) with its device operations;
  9. the train step at the paper config (VMGN, 625 classes, consistent
     loss: 5 heads), 4x4 batches from ClipLoader + RandomIdentitySamplerV1
     over synthetic 256x128 data (restricted, seq_len 8), flips, Adam lr
     1e-4 wd 5e-4, soft-margin triplet, no label smoothing: 20 steps with
     finite losses, one K3 forward and one backward launch per step and
     falling xent; step time, clips/s, peak memory, a profiler table of
     one step, how long a step holds the host (until step() returns vs
     until the card is done; host waits inside CUDA calls); then the
     evenly Evaluator on the trained model;
 10. one train step's loss and gradients, kernel path vs plain path (only
     the multi-head triplet loss differs);
 11. one train step at full width, B=4 (2x2), card vs CPU;
 12. the dense min-plus kernel (K4, min_sum) vs its plain version at the
     JAX package's test shapes (37,53,100), (130,260,515), (8,8,8): atol
     1e-4;
 13. k-reciprocal re-ranking at MARS scale (1,980 query and 9,330
     gallery seeded 4096-d features with identity structure; cosine,
     k1 20, k2 6, lambda 0.3): re_ranking_from_features 3 times, one
     sparse K4 call (min_sum_sparse) each and no dense one, wall time,
     peak memory, a profiler table with K4's share; the kernel path vs
     the plain path (plain min-sum): the re-ranked matrix within 1e-5,
     MARS CMC/mAP within 1e-6;
 14. K4 at the MARS shape (Q=1,980, J=C=11,310) on the re-ranking's
     membership matrix v: min_sum_sparse vs plain (atol 1e-5), vs the
     host algorithm's fp32 accumulation replayed in NumPy (atol 1e-6),
     bit-equal across two calls; the dense kernel vs plain on v (atol
     1e-5) and on uniform inputs (1e-5 of the max); times of the whole
     sparse call, the dense kernel, the plain version and
     torch.cdist(p=1) + row sums with the L2 flushed; the bounds on these
     inputs (the sparse entry reads a = v[:Q] as part of b, the dense
     kernel reads both) and on dense ones;
 15. re-ranking at Q=200 G=800: the card vs the CPU vs the host
     algorithm (agrl_torch.metrics.rerank), atol 2e-4, on integer
     features whose distances are exact on every device; then card vs
     CPU on continuous cosine features, reported only;
 16. the training CLI as a user runs it (python -m
     agrl_torch.cli.train_vidreid_xent_htri): a synthetic MARS layout at
     256x128 (16 train and 8 test ids, 2 cameras, 16-24 frames a
     tracklet), `-d mars` with VMGN_ARGS read from scripts/_vmgn_common.sh,
     3 epochs at --stepsize 2 with an eval and a checkpoint after each, in
     a subprocess: a finite meter line per step, a CMC block per eval, the
     checkpoints; the Time and Data meters. Then in this process through
     main(argv), the wrappers counted: --evaluate --resume best_model
     prints the best Rank-1 again (2 K1 launches per eval batch),
     --evaluate --re-rank makes one min_sum_sparse call, --resume
     checkpoint_ep2 trains epoch 3 at the schedule's lr (one K3 forward
     and one backward launch per step); the train loader alone (PIL
     decode and pose graphs on 8 threads and on one); epochs 2-3 again at
     the scripts' --print-freq 200 (one sync per epoch); --evaluate with
     --test-sample unset (dense, agrl_tpu's default) and with all (buckets
     of 16 and 24 frames: 112 and 168 graph vertices), 2 K1 launches per
     device batch;
 17. (run after phase 3) K1 masked and long vs its plain version at the
     shapes the `all` Evaluator packs at clip_batch 64: (B, V) = (64, 56),
     (32, 112), (21, 168), (9, 392), (3, 1064), (1, 2128), (1, 8288), each
     with trailing pad frames masked, and (16, 56) unmasked (bit-equal to
     phase 3's output): max|kernel - plain| / max|plain| (tol 1e-5, pad rows
     included), CUDA-event times (L2 flushed) of the kernel, the plain
     version and torch.bmm(G, h) alone, the bound (all three products in
     3xTF32, the symmetric Gram's upper half only) and the kernel's share
     of it, and the device kernels by name (torch.profiler);
 18. (run after phase 7) dense, skipdense and all evaluation at the paper
     config (the serving model): 24 query tracklets of 16-300 frames and
     one of 1,000 (the top bucket, V = 8288), 40 gallery tracklets of
     16-300 frames, seeded in memory (a VideoClipDataset whose decode
     reads them; pose graphs from seeded poses): extraction frames/s and
     tracklets/s (host clock, synced), frames pushed, device batches and
     how many of them fill the frame budget, K1 launches (one
     per graph layer and batch), peak memory, CMC/mAP through evaluate;
     the query features of the kernel path vs the plain path (tol 1e-5);
     for all, the 1,000-frame tracklet's masked, padded feature vs its
     unpadded forward (atol 2e-4);
 19. (run after phase 18) bf16 serving: FeatureExtractor at its bf16
     default on the `vmgn` factory's float32 model answers phase 4's
     requests (K1 twice per 16-clip chunk, K2 never), features vs phase 4's
     fp32 ones (reported), 16-clip request ms beside fp32's; then the bf16
     eval forward of the float32, bfloat16 and None models (same seeded
     weights): K1 and K2 launches per chunk, kernel path vs plain path (tol
     1e-4 of max), bf16 vs fp32 (reported), device ms, a request's clips/s
     and a profiler table each;
 20. the serving artifact: the bf16 eval forward exported at batch 16
     (size, weights left out), served by a fresh process that imports no
     model code from the artifact and load_variables of a checkpoint: 1-,
     16- and 21-clip requests, K1 launches counted there (2 per chunk),
     features within 1e-5 of max of phase 19's live bf16 ones, request ms;
 21. (run after phase 11) the --bf16-train step: a dtype-bfloat16 VMGN
     from phase 9's seed on phase 9's batches and draws, 20 steps with
     finite losses, falling xent and one K3 forward and one backward launch
     each; steps 1-4 loss within rtol = atol = 0.05 of phase 9's fp32
     steps; float32 parameters and Adam state; step ms, clips/s, peak
     memory, a profiler table;
 16, bf16 (run after phase 16): one CLI epoch of the preset with
     --bf16-train --bf16-eval (a subprocess; console in
     agrl_torch/_build/cli_train_bf16.log), python -m
     agrl_torch.cli.export_model on its best_model.pth.tar, and that
     artifact served here: K1 twice per chunk, features within 1e-5 of max
     of the live bf16 path;
 22. (run after phase 16) the CLI's host side on phase 16's MARS layout
     at the paper preset: [build] lines for the host libraries of native/
     (libjpeg_decode, librank_eval: built with g++, or the reason not); the
     train loader alone at -j 1 and -j 8 under PIL and native (ms a batch,
     ms a frame); native vs PIL pixels on the layout's 256x128 JPEGs
     (bit-equal) and on JPEGs written at 512x256 (per-frame mean |diff| < 6);
     the CLI for 2 epochs at --print-freq 1 (in process, wrappers counted,
     train batches hashed): --decode pil with the batches built when the
     step asks (no prefetch thread, as before), --decode pil, --decode
     auto, --cache-frames,
     --frame-cache-dir twice (the second warm), each with its Time and Data
     meters (median of steps 2-8 and of epoch 2), K3 1 + 1 launches a step
     and K1 2 per eval batch, the uint8 batches of pil and --cache-frames
     hash-equal; a save's blocked ms, sync vs --async-ckpt (the async file
     loads equal to the state at the save) and --profile-dir's files (the
     trace names K3's kernels), one epoch each; the FLOPs line; the host
     scorers, native vs NumPy, on a MARS-scale cosine distance matrix
     (phase 13's features): ms and CMC/mAP within 1e-6;
 23. (run after phase 22) the rest of VMGN's training surface at the paper
     config (VMGN ResNet-50, 4x4 batches of 8-frame 256x128 colour clips,
     consistent loss, soft-margin), from one seeded state: (a) 12 steps
     under each optimizer name (adam, amsgrad, sgd, nesterov, rmsprop,
     adabound, radam; flips; a warmup epoch of 6 steps, then lr 1e-4):
     step ms (median of steps 4-12), finite losses, one K3 forward and one
     backward launch a step, and update 13, across the milestone's lr
     change, card vs CPU from the same state and gradients (1e-6 of max
     per parameter); (b) misalign, random crop (--rand-crop), random
     erasing, flips and all together with injected draws, card vs CPU
     (atol 1e-5) and their device ms, then 10 steps with all of them; (c)
     --remat none, dots and full: one step under
     torch.use_deterministic_algorithms against none's (1e-5 of max per
     entry; none repeated beside it), the running statistics updated once,
     step ms and peak memory of 7 steps; (d) the 16-clip eval forward of
     VMGN built with each graph its flags reach (both, --use-pose alone,
     --learn-graph alone): K1 twice a forward, kernel vs plain path (1e-5
     of max); K1 in each of its three modes (both, pose, learned) at
     B=16 V=56 vs its plain twin, with times and bounds; (e) agrl_tpu's
     optax state (adam, sgd, radam) built as seeded optax-layout trees,
     migrated, and one resumed step card vs CPU (1e-6 of max); (f) the CLI
     on phase 16's MARS layout (in process, wrappers counted): one epoch of
     the preset with --optim radam --rand-erase --rand-crop --misalign-aug
     --remat dots, and one of -a vmgn --use-pose without --learn-graph,
     each evaluated at evenly (K3 1 + 1 a step, K1 2 per eval batch);
then one {"serving": ...} line (with "bf16" and "artifact"), one {"training": ...} line (with "bf16"),
one {"reranking": ...} line, one {"cli": ...} line (with "bf16"), one {"evaluation": ...}
line, one {"input": ...} line, one {"train_surface": ...} line, one {"kernels": [...]} line (each kernel's `slower_than_plain`
lists the shapes where this run timed it above its plain version), the
card's name and power limit, and
{"ok": true, "device": {...}} as the last line.

    python3 chip_smoke.py --term-only ROOT

measures only the triplet term of a train step (5 heads, forward and
backward) as the agrl_torch package in ROOT computes it, e.g. an
unpacked earlier commit, and prints one JSON line.
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import shlex
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
# tensor cores (an FMA counts 2), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
PEAK_HBM_BYTES = 3.35e12
# fp32 instructions per second, for work with no FMA in it: 132 SMs x 128
# lanes x 1.98 GHz. The min-plus kernel's FMNMX runs on the ALU pipe at
# half that (64 lanes per SM per clock), its FADD on the FP32 pipe at full
# rate, and the schedulers issue one warp instruction per clock each, so
# a (FMNMX, FADD) term costs 2 / 128 SM-clocks either way.
PEAK_FP32_ISSUE = 132 * 128 * 1.98e9
MINSUM_KERNEL = "min_sum_kernel"  # agrl_torch/csrc/minsum.cu
# agrl_torch/csrc/minsum_sparse.cu, as the profiler names them
SPARSE_KERNELS = ("nnz_count_kernel", "csr_fill_kernel", "min_sum_accumulate_kernel")
MARS_Q, MARS_G, MARS_IDS = 1980, 9330, 636  # MARS test split: query, gallery tracklets

SEQ_LEN, HEIGHT, WIDTH, BATCH = 8, 256, 128, 16
# device kernels of agrl_torch/csrc/graph_conv.cu, as the profiler names them
GRAPH_KERNELS = ("gram_partial_kernel", "graph_blend_kernel", "graph_propagate_kernel")
# agrl_torch/csrc/triplet.cu, as the profiler names them: forward, backward
TRIPLET_KERNELS = ("hard_mine_heads_kernel", "hard_mine_heads_backward_kernel")
NUM_CLASSES = 625  # MARS training identities
FEATURE_DIM = 2048  # the triplet heads' width
TRAIN_STEPS, TRAIN_HEADS = 20, 5  # global, attention, 3 consistent-loss subclips
LIBS = ("graph_conv", "triplet", "minsum", "minsum_sparse")  # agrl_torch/csrc/<name>.cu


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(log_text: str) -> list:
    """One line per kernel of an nvcc -Xptxas -v log: its name (and
    template argument), registers, spills and static shared memory."""
    lines, name, spill = [], "?", ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '.*?\d([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return lines


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


def device_ms_per_call(torch, fn, n=20):
    """Device time of one fn() call: its kernels' device time summed over
    n back-to-back calls (torch.profiler), over n. For a call whose host
    dispatch outlasts its kernels, where CUDA events around the call
    measure the dispatch; the inputs stay in L2 between calls, as a
    caller's freshly computed inputs are."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(r[1] for r in device_rows(prof, n))


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


def graph_bound_ms(B, V, C, masked=False):
    """Least time for one fused call: its three products as three tf32
    products each (3xTF32, the least that keeps fp32 accuracy on the tensor
    cores) over the tf32 peak — f@W, the Gram f f^T on and above its
    diagonal (it is symmetric), and G@h — vs bytes of f, adj, W, BN vectors
    (and the vertex mask) in and out over the HBM rate; the larger one
    bounds. Also the first design's figure, every FLOP of the three whole
    products at the fp32 FMA peak. Returns (bound ms, bound_by, fp32 FMA
    bound ms)."""
    mm, gram, gh = 2.0 * B * V * C * C, 1.0 * B * V * (V + 1) * C, 2.0 * B * V * V * C
    nbytes = 4.0 * (2 * B * V * C + B * V * V + C * C + 4 * C + (B * V if masked else 0))
    t_ops = 3 * (mm + gram + gh) / PEAK_TF32_FLOPS
    t_mem = nbytes / PEAK_HBM_BYTES
    t_fma = max((mm + 2 * gh) / PEAK_FP32_FLOPS, t_mem)
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), t_fma * 1e3


def slower_than_plain(*cases) -> list:
    """The labels of the (label, kernel ms, plain ms) cases where the
    kernel took longer than its plain version in this run."""
    return [label for label, ms, plain_ms in cases if ms > plain_ms]


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
            # fp32 accuracy of the 3xTF32 product: one TF32 pass is ~2e-4
            # away, the wgmma accumulators without per-chunk promotion ~3e-6
            exact = gc.graph_propagate_reference(*(x.double() for x in args))
            f64_err = float((got.double() - exact).abs().max() / exact.abs().max())
            plain_f64_err = float((want.double() - exact).abs().max() / exact.abs().max())
            log(f"[kernel] {label}: max|kernel - float64| / max|float64| = {f64_err:.3e} "
                f"(tol 1e-6; the plain fp32 version: {plain_f64_err:.3e})")
            if not (f64_err <= 1e-6):
                raise AssertionError(f"kernel is not fp32-accurate at {label}: {f64_err}")
            del exact
            f, W = args[0], args[2]
            f2 = f.reshape(B * V, C)
            rec = dict(
                max_abs_err=err, float64_rel_err=f64_err, plain_float64_rel_err=plain_f64_err,
                ms=time_cuda(torch, lambda: gc.graph_propagate(*args), flush),
                plain_ms=time_cuda(torch, lambda: gc.graph_propagate_reference(*args), flush),
                library_ms=time_cuda(torch, lambda: torch.matmul(f2, W), flush),
            )
            rec["bound_ms"], rec["bound_by"], rec["fp32_fma_bound_ms"] = graph_bound_ms(B, V, C)
            v2_args, serving_out = args, got
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
        f"({rec['bound_by']}: 3xTF32 on the tensor cores; fp32-FMA bound "
        f"{rec['fp32_fma_bound_ms']:.4f} ms), v2 {rec['v2_ms']:.4f} ms"
    )
    return rec, serving_out


# (B, V, masked): the `all` Evaluator's packings at clip_batch 64 (buckets of
# 8, 16, 24, 56, 152, 304 and 1184 frames), then the serving shape unmasked
K1_LONG_SHAPES = ((64, 56, True), (32, 112, True), (21, 168, True), (9, 392, True),
                  (3, 1064, True), (1, 2128, True), (1, 8288, True), (16, 56, False))


def bucket_ladder(top):
    """The `all` Evaluator's bucket ladder up to `top` frames."""
    from agrl_torch.engine.evaluator import Evaluator

    out = [Evaluator._bucket_len(1)]
    while out[-1] < top:
        out.append(Evaluator._bucket_len(out[-1] + 1))
    return out


def masked_graph_inputs(torch, gc, B, V, C, seed, device):
    """graph_inputs with the `all` eval's padding: clip b has a seeded count
    of real frames above the next smaller bucket; its pose rows and columns
    past them are 0 (the Evaluator pads the adjacency with a zero block)."""
    args = graph_inputs(torch, B, V, C, seed, device)
    frames = V // 7
    ladder = bucket_ladder(frames)
    lo = ladder[-2] if len(ladder) > 1 else 0
    real = np.random.RandomState(seed).randint(lo + 1, frames + 1, size=B)
    mask = (np.arange(V)[None, :] < real[:, None] * 7).astype(np.float32)
    mask = torch.from_numpy(mask).to(device)
    args[1] = args[1] * gc.pair_mask(mask)
    return args, mask, real


def phase_k1_long(torch, gc, device, flush, serving_out):
    """K1 masked and long vs its plain twin at the `all` Evaluator's shapes
    (phase 17); the unmasked serving shape must repeat phase 3's output."""
    from torch.profiler import ProfilerActivity, profile

    C, recs = 2048, []
    for B, V, masked in K1_LONG_SHAPES:
        if masked:
            args, mask, real = masked_graph_inputs(torch, gc, B, V, C, V, device)
        else:
            args, mask, real = graph_inputs(torch, B, V, C, 0, device), None, None
        kernel = lambda: gc.graph_propagate(*args, vertex_mask=mask)  # noqa: E731
        plain = lambda: gc.graph_propagate_reference(*args, vertex_mask=mask)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        same = None if masked else bool(torch.equal(got, serving_out))
        G = gc.blended_graph(args[0], args[1], mask)
        h = torch.matmul(args[0], args[2])
        iters = 20 if V <= 392 else 5
        rec = dict(B=B, V=V, masked=masked, max_rel_err=err,
                   max_abs_err=float((got - want).abs().max()),
                   ms=time_cuda(torch, kernel, flush, iters=iters),
                   plain_ms=time_cuda(torch, plain, flush, iters=max(2, iters // 4), warmup=1),
                   library_ms=time_cuda(torch, lambda: torch.bmm(G, h), flush, iters=iters))
        rec["bound_ms"], rec["bound_by"], rec["fp32_fma_bound_ms"] = graph_bound_ms(
            B, V, C, masked)
        del G, h, got, want
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kernel()
            torch.cuda.synchronize()
        rec["kernels"] = [(name[:60], ms) for name, ms, _ in device_rows(prof, 3)]
        pads = "" if real is None else f", real frames {real.min()}-{real.max()} of {V // 7}"
        log(f"[k1long] B={B} V={V} {'masked' if masked else 'unmasked'}{pads}: "
            f"max|kernel - plain|/max|plain| = {err:.3e} (tol 1e-5); kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, torch.bmm(G, h) {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it; fp32-FMA figure "
            f"{rec['fp32_fma_bound_ms']:.4f} ms)"
            + ("" if same is None else f"; bit-equal to phase 3: {same}"))
        log("[k1long]   device: " + ", ".join(f"{n} {m:.4f} ms" for n, m in rec["kernels"]))
        if not (err <= 1e-5) or same is False:
            raise AssertionError(f"K1 at B={B} V={V} masked={masked}: rel err {err}, "
                                 f"bit-equal to phase 3: {same}")
        recs.append(rec)
        del args, mask
        torch.cuda.empty_cache()
    return recs


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
    return fwd_ms, err, profile_forward(torch, lambda: model(x, adj))


def device_rows(prof, n):
    """(kernel name, device ms per iteration, launches per iteration) of a
    profiled window of n iterations, largest first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((e.key, us / 1e3 / n, e.count // n))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_forward(torch, fn, n=3):
    """Device time by kernel over `n` calls of fn(), one 16-clip forward
    (torch.profiler), the graph kernels' share of it, and the card's busy
    share of the window (kernel time / event-timed wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
    window_ms = start.elapsed_time(end)
    rows = device_rows(prof, n)
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
    fx_cpu = FeatureExtractor(cpu_model, batch_size=2, seq_len=SEQ_LEN, bf16=False, device="cpu")
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


def phase_evaluator(torch, gc, ms, model, device):
    """The evenly Evaluator, then its re-ranking stage: device re-ranking
    under the mars, market1501 and dukev protocols and for the distmat
    export (one sparse K4 call each; dukev and the export score on the host)
    and the host path (device_rank=False: host re-ranking, NumPy scorer)."""
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

        evaluator = Evaluator(model, test_sample="evenly", device=device)
        gc.launches = 0
        r1, mAP = evaluator.evaluate(loader("query"), loader("gallery"), dist_metric="cosine")
        if not (0.0 <= r1 <= 1.0 and 0.0 <= mAP <= 1.0) or gc.launches == 0:
            raise AssertionError(f"evaluator: rank-1 {r1}, mAP {mAP}, launches {gc.launches}")
        log(f"[eval] evenly evaluator: rank-1 {r1:.4f}, mAP {mAP:.4f}, "
            f"graph kernel launches {gc.launches}")

        reranked = {}
        # dukev after re-ranking scores on the host, still re-ranked on the card
        for protocol, device_rank in (("mars", True), ("market1501", True), ("dukev", True),
                                      ("mars", False)):
            before = ms.sparse_launches
            rr1, rmap = evaluator.evaluate(
                loader("query"), loader("gallery"), dist_metric="cosine", re_rank=True,
                metric_protocol=protocol, device_rank=device_rank,
            )
            k4 = ms.sparse_launches - before
            path = "device" if device_rank else "host"
            log(f"[eval] re-ranked, {protocol} on the {path} path: rank-1 {rr1:.4f}, "
                f"mAP {rmap:.4f}, min_sum_sparse launches +{k4}")
            if not (math.isfinite(rr1) and math.isfinite(rmap) and 0.0 <= rr1 <= 1.0
                    and 0.0 <= rmap <= 1.0 and k4 == int(device_rank)):
                raise AssertionError(f"re-ranking evaluator ({protocol}, {path}): rank-1 {rr1}, "
                                     f"mAP {rmap}, min_sum_sparse launches {k4}")
            reranked[f"{protocol}_{path}"] = (rr1, rmap)

        # the re-ranked matrix for export: re-ranked on the card, one sparse K4 call
        before = ms.sparse_launches
        dm = evaluator.evaluate(loader("query"), loader("gallery"), dist_metric="cosine",
                                re_rank=True, return_distmat=True)
        k4 = ms.sparse_launches - before
        log(f"[eval] re-ranked distmat export: shape {dm.shape}, min_sum_sparse launches +{k4}")
        if not (isinstance(dm, np.ndarray) and dm.shape == (len(ds.query), len(ds.gallery))
                and np.isfinite(dm).all() and k4 == 1):
            raise AssertionError(f"re-ranked distmat export: shape {getattr(dm, 'shape', None)}, "
                                 f"min_sum_sparse launches {k4}")
    host_diff = abs(reranked["mars_host"][1] - reranked["mars_device"][1])
    log(f"[eval] re-ranked mars mAP, host path vs device path: |diff| {host_diff:.3e} (tol 1e-6)")
    if not host_diff <= 1e-6:
        raise AssertionError("re-ranking evaluator: host and device paths disagree")
    return r1, mAP, reranked


EVAL_IDS = 20
EVAL_LONG = 1000  # MARS's max_len: the `all` bucket of 1,184 frames, V = 8288


def memory_eval_data(seed=7, frame_range=(16, 301)):
    """Seeded tracklets held in memory, MARS-like lengths: 24 query of
    16-300 frames plus one of 1,000, 40 gallery of 16-300, over 20
    identities (query camera 1, gallery camera 2). Each tracklet is one
    rendered 256x128 person (synthetic_mars's palette, camera tint and
    noise) shifted by a few pixels from frame to frame; each frame has a
    seeded standing pose. Returns (splits, pose_info, frame -> (image,
    shift), images)."""
    from agrl_torch.data.datasets.synthetic import _make_pose
    from agrl_torch.data.datasets.synthetic_mars import _appearance, _cam_nuisance, _render_frame

    rng = np.random.RandomState(seed)
    looks = [_appearance(pid, rng) for pid in range(EVAL_IDS)]
    lengths = {"query": [*rng.randint(*frame_range, size=24), EVAL_LONG],
               "gallery": list(rng.randint(*frame_range, size=40))}
    splits, pose_info, frames, images = {}, {}, {}, []
    for cam, split in enumerate(("query", "gallery"), start=1):
        splits[split] = []
        for t, num in enumerate(lengths[split]):
            pid = t % EVAL_IDS
            colors, freq = looks[pid]
            gain, bright = _cam_nuisance(cam, rng)
            images.append(_render_frame(colors, freq, gain, bright, rng, HEIGHT, WIDTH))
            paths = []
            for i in range(int(num)):
                name = f"{pid:04d}C{cam}T{t:04d}F{i:04d}.jpg"
                frames[name] = (len(images) - 1, i % 9 - 4)
                pose_info[name] = _make_pose(rng, WIDTH, HEIGHT)
                paths.append(f"mars/bbox_test/{pid:04d}/{name}")
            splits[split].append((tuple(paths), pid, cam))
    return splits, pose_info, frames, images


def memory_loader(data, split, sample):
    """ClipLoader (batches of one tracklet) over a VideoClipDataset whose
    decode reads the in-memory frames; everything else is the port's."""
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset

    splits, pose_info, frames, images = data

    class MemoryClipDataset(VideoClipDataset):
        def decode(self, paths):
            picks = [frames[p.rsplit("/", 1)[1]] for p in paths]
            imgs = np.stack([np.roll(images[k], shift, axis=1) for k, shift in picks])
            return imgs, [(WIDTH, HEIGHT)] * len(paths)

    dset = MemoryClipDataset(splits[split], seq_len=SEQ_LEN, sample=sample, height=HEIGHT,
                             width=WIDTH, pose_info=pose_info)
    return ClipLoader(dset, batch_size=1, num_workers=4)


def count_device_batches(ev):
    """Wraps the Evaluator's forward: device batches, frames pushed, and the
    batches that fill the frame budget (clip_batch clips of 8 frames, or
    clip_batch * 8 // Sp tracklets of a bucket of Sp frames)."""
    n = {"batches": 0, "frames": 0, "full_batches": 0}
    inner = ev._fwd

    def counted(imgs, *rest):
        n["batches"] += 1
        n["frames"] += int(imgs.shape[0] * imgs.shape[1])
        n["full_batches"] += int(imgs.shape[0] == max(1, ev.clip_batch * 8 // imgs.shape[1]))
        return inner(imgs, *rest)

    ev._fwd = counted
    return n


def phase_eval_strategies(torch, layers_mod, gc, model, device):
    """dense, skipdense and all evaluation at the paper config (phase 18)."""
    from agrl_torch.engine.evaluator import Evaluator

    t0 = time.perf_counter()
    data = memory_eval_data()
    real = {s: sum(min(len(t[0]), 1000) for t in data[0][s]) for s in ("query", "gallery")}
    log(f"[evals] {len(data[0]['query'])} query / {len(data[0]['gallery'])} gallery tracklets, "
        f"{real['query']} / {real['gallery']} frames, made in {time.perf_counter() - t0:.1f} s")
    out = {}
    for sample in ("dense", "skipdense", "all"):
        ev = Evaluator(model, test_sample=sample, device=device)
        n = count_device_batches(ev)
        extract, feats = ev.extract, {}
        torch.cuda.reset_peak_memory_stats()
        gc.launches = 0  # main path starts here
        t_extract = {}
        for split in ("query", "gallery"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats[split] = extract(memory_loader(data, split, sample), split)
            torch.cuda.synchronize()
            t_extract[split] = time.perf_counter() - t0
        ev.extract = lambda loader, name: feats[name]  # evaluate ranks these features
        r1, mAP = ev.evaluate("query", "gallery", dist_metric="cosine")
        launches = gc.launches  # main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        secs = sum(t_extract.values())
        frames = real["query"] + real["gallery"]
        tracklets = len(feats["query"][1]) + len(feats["gallery"][1])
        rec = dict(extract_s=secs, frames_per_s=frames / secs, tracklets_per_s=tracklets / secs,
                   real_frames=frames, pushed_frames=n["frames"], device_batches=n["batches"],
                   full_batches=n["full_batches"],
                   k1_launches=launches, k1_per_layer_per_batch=launches / 2 / n["batches"],
                   peak_mem_gb=peak, rank1=r1, mAP=mAP,
                   query_s=t_extract["query"], gallery_s=t_extract["gallery"])
        log(f"[evals] {sample}: extraction {secs:.2f} s, {rec['frames_per_s']:.1f} frames/s, "
            f"{rec['tracklets_per_s']:.2f} tracklets/s ({frames} frames, {n['frames']} pushed in "
            f"{n['batches']} device batches, {n['full_batches']} of them full); K1 launches {launches} "
            f"({rec['k1_per_layer_per_batch']:.2f} per graph layer and batch); peak "
            f"{peak:.2f} GB; rank-1 {r1:.4f}, mAP {mAP:.4f}")
        if not (launches == 2 * n["batches"] > 0 and math.isfinite(r1) and math.isfinite(mAP)
                and 0.0 <= r1 <= 1.0 and 0.0 <= mAP <= 1.0):
            raise AssertionError(f"{sample} evaluation: K1 launches {launches} for "
                                 f"{n['batches']} batches, rank-1 {r1}, mAP {mAP}")

        # the kernel path vs the plain path on the query split
        layers_mod.graph_propagate = gc.graph_propagate_reference
        try:
            plain = extract(memory_loader(data, "query", sample), "query")[0]
        finally:
            layers_mod.graph_propagate = gc.graph_propagate
        qf = feats["query"][0]
        rec["kernel_vs_plain_rel_err"] = err = float((qf - plain).abs().max() / plain.abs().max())
        log(f"[evals] {sample}: query features, kernel path vs plain path: max|diff|/max|plain| "
            f"= {err:.3e} (tol 1e-5)")
        if not (torch.isfinite(qf).all() and err <= 1e-5):
            raise AssertionError(f"{sample} evaluation: kernel path and plain path disagree")

        if sample == "all":  # the 1,000-frame tracklet: padded to 1,184 with a mask vs unpadded
            imgs, _, _, adj = memory_loader(data, "query", sample).dataset.get_item(24)
            alone = ev._fwd(imgs[None], adj[None])[0]
            diff = float((qf[24] - alone).abs().max())
            rec["padded_vs_unpadded_max_abs"] = diff
            rec["padded_vs_unpadded_rel"] = float(diff / alone.abs().max())
            log(f"[evals] all: the {EVAL_LONG}-frame tracklet padded to "
                f"{Evaluator._bucket_len(EVAL_LONG)} frames with its mask vs unpadded: "
                f"max|diff| {diff:.3e} (atol 2e-4), relative {rec['padded_vs_unpadded_rel']:.3e}")
            if not diff <= 2e-4:
                raise AssertionError("all evaluation: padded feature != unpadded feature")
        out[sample] = rec
        del ev, feats, plain, qf
        torch.cuda.empty_cache()
    return out


def triplet_heads(torch, H, B, D, device, seed):
    """H heads of (B, D) features over one P x K batch (the labels are
    shared): identity centres plus noise, no tied distances in a row."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // 4)), 4)[:B]
    heads = [(rng.randn(B, D) + rng.randn(labels[-1] + 1, D)[labels] * 0.3) * 0.5
             for _ in range(H)]
    return ([torch.from_numpy(h.astype(np.float32)).to(device) for h in heads],
            torch.from_numpy(labels.astype(np.int64)).to(device))


def triplet_term(torch, loss_fn, heads, labels):
    """One triplet term of a train step: loss_fn(heads, labels) forward and
    its gradient onto every head (autograd.grad: nothing accumulates)."""
    leaves = [h.clone().requires_grad_(True) for h in heads]
    return lambda: torch.autograd.grad(loss_fn(leaves, labels), leaves)


def measure_term(torch, run, flush, n=20):
    """(device ms per call, device operations per call, event-timed ms with
    the L2 flushed, profiler rows) of run(): the device time and the
    kernels, memsets and copies it launched, summed over n back-to-back
    calls (torch.profiler) over n; then CUDA events around one call, host
    dispatch included."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    rows = device_rows(prof, n)
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), time_cuda(torch, run, flush), rows)


def plain_triplet_heads(tri, losses_mod):
    """The multi-head loss's plain path: deep_supervision over the plain
    mining (pairwise_euclidean + hard_mine) of each head."""
    def one(f, y, margin, soft):
        return losses_mod.triplet_from_distances(
            *tri.hard_mine(tri.pairwise_euclidean(f), y), margin, soft).mean()

    return lambda xs, y, margin=0.3, soft=True: losses_mod.deep_supervision(
        one, xs, y, margin=margin, soft=soft)


def triplet_bound_ms(H, B, D, s_nnz=None):
    """Least time for one forward call over H heads: the fp32 Grams' 2 B^2
    D FLOPs (and 2 B D for the norms) per head over the fp32 peak vs every
    head and the labels in, two distances and two int64 picks per anchor
    out, over the HBM rate. With s_nnz (the non-zeros of the H S matrices
    of this run's picks), the backward's: (s_nnz + H B) D FMAs (S @ f and
    rowsum(S) * f, the work the picks need) vs the heads and the forward's
    outputs and two incoming gradients in, the gradients out. Returns (ms,
    bound_by)."""
    if s_nnz is None:
        flops = H * (2.0 * B * B * D + 2.0 * B * D)
        nbytes = H * 4.0 * B * D + 8.0 * B + H * (4 + 4 + 8 + 8) * B
    else:
        flops = 2.0 * (s_nnz + H * B) * D
        nbytes = H * 8.0 * B * D + H * (4 + 4 + 8 + 8 + 4 + 4) * B
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def s_nonzeros(torch, tri, d_ap, d_an, i_ap, i_an):
    """Non-zeros of S = M + M^T over the heads, for the picks that carry a
    gradient."""
    H, B = d_ap.shape
    M = torch.zeros(H, B, B, dtype=torch.bool, device=d_ap.device)
    rows = torch.arange(B, device=d_ap.device).expand(H, B)
    heads = torch.arange(H, device=d_ap.device)[:, None].expand(H, B)
    for d, j in ((d_ap, i_ap), (d_an, i_an)):
        live = (d > tri._DIST_MIN) & (d < tri._BIG) & (j != rows)
        M[heads[live], rows[live], j[live]] = True
    return int((M | M.transpose(1, 2)).sum())


def phase_triplet(torch, tri, losses_mod, device, flush):
    """K3 vs its plain versions on the card; returns the train-shape record."""
    plain_loss = plain_triplet_heads(tri, losses_mod)
    rec = {}
    for H, B in ((TRAIN_HEADS, BATCH), (1, 15), (TRAIN_HEADS, 64), (3, 256)):
        heads, labels = triplet_heads(torch, H, B, FEATURE_DIM, device, seed=B)
        got = tri.hard_mine_heads_kernel(heads, labels)
        again = tri.hard_mine_heads_kernel(heads, labels)
        want = tri.hard_mine_heads_reference(heads, labels)
        kernel_term = triplet_term(torch, losses_mod.batch_hard_triplet_heads, heads, labels)
        grads, grads_again = kernel_term(), kernel_term()
        plain_grads = triplet_term(torch, plain_loss, heads, labels)()
        torch.cuda.synchronize()
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        picks = bool(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]))
        gerr = max(float((a - b).abs().max()) for a, b in zip(grads, plain_grads))
        same = (all(torch.equal(a, b) for a, b in zip(got, again))
                and all(torch.equal(a, b) for a, b in zip(grads, grads_again)))
        log(f"[triplet] H={H} B={B} D={FEATURE_DIM}: max|kernel - plain| = {err:.3e} (atol "
            f"1e-4), picks equal: {picks}; gradients of the multi-head loss (backward "
            f"kernel) vs the plain path's autograd max|diff| = {gerr:.3e} (atol 1e-5); two "
            f"calls bit-equal (forward, backward): {same}")
        if not (err <= 1e-4 and picks and gerr <= 1e-5 and same):
            raise AssertionError(f"hard_mine kernels disagree with plain at H={H} B={B}")
        if (H, B) != (TRAIN_HEADS, BATCH):
            continue
        gen = torch.Generator(device=device).manual_seed(0)
        g_ap, g_an = (torch.rand(H, B, generator=gen, device=device) / B for _ in range(2))
        stacked = torch.stack(heads)
        calls = dict(
            kernel=lambda: tri.hard_mine_heads_kernel(heads, labels),
            backward=lambda: tri.hard_mine_heads_backward_kernel(heads, *got, g_ap, g_an),
            plain=lambda: tri.hard_mine_heads_reference(heads, labels),
            plain_backward=lambda: tri.hard_mine_backward_reference(heads, *got, g_ap, g_an),
            library=lambda: torch.cdist(stacked, stacked),
        )
        rec = dict(max_abs_err=err, grad_max_abs_err=gerr, two_calls_bit_equal=same)
        for name, fn in calls.items():
            prefix = "" if name == "kernel" else f"{name}_"
            rec[f"{prefix}ms"] = device_ms_per_call(torch, fn)
            rec[f"{prefix}call_ms"] = time_cuda(torch, fn, flush)
        rec["launch_floor_ms"] = time_cuda(torch, lambda: tri.empty_launch(device), flush)
        rec["bound_ms"], rec["bound_by"] = triplet_bound_ms(H, B, FEATURE_DIM)
        nnz = s_nonzeros(torch, tri, *got)
        rec["backward_bound_ms"], rec["backward_bound_by"] = triplet_bound_ms(
            H, B, FEATURE_DIM, s_nnz=nnz)
        # the whole triplet term of a step, forward and backward: the
        # kernels, the per-head path through them (H = 1 each) and the
        # earlier design's structure (a forward launch per head, the plain
        # backward)
        def earlier_design(xs, y):
            total = 0.0
            for x in xs:
                d_ap, d_an = tri._HardMineHeads.apply(y, tri.hard_mine_heads_kernel,
                                                      tri.hard_mine_backward_reference, x)
                total = total + losses_mod.triplet_from_distances(d_ap[0], d_an[0]).mean()
            return total / len(xs)

        for name, fn in (("term", losses_mod.batch_hard_triplet_heads),
                         ("per_head_term", lambda xs, y: losses_mod.deep_supervision(
                             losses_mod.batch_hard_triplet, xs, y)),
                         ("parent_term", earlier_design)):
            run = triplet_term(torch, fn, heads, labels)
            rec[f"{name}_ms"], rec[f"{name}_kernels"], rec[f"{name}_call_ms"], rows = \
                measure_term(torch, run, flush)
            if name == "term":
                rec["term_rows"] = rows
        rec["s_nonzeros"] = nnz
    log(f"[triplet] train shape H={TRAIN_HEADS} B={BATCH} D={FEATURE_DIM}, device time per "
        f"call: forward kernel {rec['ms']:.4f} ms (bound {rec['bound_ms']:.6f} ms, "
        f"{rec['bound_by']}), backward kernel {rec['backward_ms']:.4f} ms (bound "
        f"{rec['backward_bound_ms']:.6f} ms, {rec['backward_bound_by']}; S has "
        f"{rec['s_nonzeros']} non-zeros), plain {rec['plain_ms']:.4f} + "
        f"{rec['plain_backward_ms']:.4f} ms, batched torch.cdist {rec['library_ms']:.4f} ms; "
        f"event-timed calls with the L2 flushed (host dispatch included): forward "
        f"{rec['call_ms']:.4f} ms, backward {rec['backward_call_ms']:.4f} ms, plain "
        f"{rec['plain_call_ms']:.4f} + {rec['plain_backward_call_ms']:.4f} ms, cdist "
        f"{rec['library_call_ms']:.4f} ms, an empty kernel {rec['launch_floor_ms']:.4f} ms")
    for name, what in (("term", "batch_hard_triplet_heads (the kernels)"),
                       ("per_head_term", "deep_supervision(batch_hard_triplet) (the kernels "
                                         "at H = 1, per head)"),
                       ("parent_term", "the earlier design's structure (a forward launch "
                                       "per head, the plain backward)")):
        log(f"[triplet] triplet term, forward and backward over {TRAIN_HEADS} heads, {what}: "
            f"device {rec[name + '_ms']:.4f} ms in {rec[name + '_kernels']} device operations; "
            f"event-timed {rec[name + '_call_ms']:.4f} ms")
    for name, ms, count in rec.pop("term_rows")[:12]:
        log(f"[triplet]   {ms:8.4f} ms x{count:<3d} {name[:90]}")
    return rec


def main_term_only(root: Path) -> int:
    """`chip_smoke.py --term-only ROOT`: the triplet term of one train step,
    forward and backward over 5 heads of (16, 2048), as the agrl_torch
    package found in ROOT (e.g. an unpacked earlier commit) computes it:
    batch_hard_triplet_heads where the package has it, else
    deep_supervision(batch_hard_triplet, ...); prints one JSON line."""
    if not (root / "agrl_torch" / "csrc" / "triplet.cu").exists():
        print(f"chip_smoke.py: no agrl_torch package in {root}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, str(root))
    from agrl_torch import losses

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    heads, labels = triplet_heads(torch, TRAIN_HEADS, BATCH, FEATURE_DIM, device, 0)
    def per_head(xs, y):
        return losses.deep_supervision(losses.batch_hard_triplet, xs, y)

    if hasattr(losses, "batch_hard_triplet_heads"):
        name, loss = "batch_hard_triplet_heads", losses.batch_hard_triplet_heads
    else:
        name, loss = "deep_supervision(batch_hard_triplet)", per_head
    dev_ms, ops, call_ms, rows = measure_term(
        torch, triplet_term(torch, loss, heads, labels), L2Flusher(torch, device))
    smi = nvidia_smi_line()
    log(f"[term] {root}: {name} over {TRAIN_HEADS} heads of ({BATCH}, {FEATURE_DIM}), forward "
        f"and backward: device {dev_ms:.4f} ms in {ops} device operations; event-timed "
        f"{call_ms:.4f} ms (L2 flushed); {smi}")
    for name, ms, count in rows[:25]:
        log(f"[term]   {ms:8.4f} ms x{count:<3d} {name[:90]}")
    print(json.dumps({"triplet_term": dict(
        root=str(root), loss=name, device_ms=dev_ms, device_ops=ops, call_ms=call_ms, rows=rows,
        card=smi, kind=torch.cuda.get_device_name(0))}))
    return 0


def colour_clips(n, seed):
    """Clips of a colour each under noise, so the clips of a batch differ
    as real identities do (train-mode BN normalizes over the batch)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (n, 1, 1, 1, 3))
    noise = rng.randint(-40, 41, (n, SEQ_LEN, HEIGHT, WIDTH, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def subclips(seed):
    """Consistent-loss subclips: sorted subsets of S-3, S-2, S-1 frames."""
    rng = np.random.RandomState(seed)
    return [np.sort(rng.permutation(SEQ_LEN)[:n]) for n in (SEQ_LEN - 3, SEQ_LEN - 2, SEQ_LEN - 1)]


def build_train_model(init_model, device, seed=0):
    return init_model(
        "vmgn", num_classes=NUM_CLASSES, device=device, seed=seed, num_split=4,
        pyramid_part=True, num_gb=2, use_pose=True, learn_graph=True, consistent_loss=True,
    )


def frozen_step(torch, model):
    """A train step whose optimizer does not move the weights (lr 0): its
    gradients stay in p.grad for a comparison."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.optim import init_optim

    opt = init_optim("adam", model.parameters(), 0.0)
    return make_train_step(model, opt, lambda step: 0.0, label_smooth=False,
                           aug={"flip_aug": True})


def grads_of(model):
    return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def profile_train_step(torch, step, batch, generator):
    """Device time by kernel over one train step (torch.profiler), the
    busy share of its event-timed window, and K3's share (its forward and
    backward kernels)."""
    from torch.profiler import ProfilerActivity, profile

    imgs, pids, _, adjs = batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(imgs, pids, adjs, generator=generator)
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    rows = device_rows(prof, 1)
    busy_ms = sum(r[1] for r in rows)
    k3 = {k: [r for r in rows if f"{k}(" in r[0]] for k in TRIPLET_KERNELS}
    k3_ms = {k: sum(r[1] for r in v) for k, v in k3.items()}
    k3_n = {k: sum(r[2] for r in v) for k, v in k3.items()}
    fwd, bwd = TRIPLET_KERNELS
    total = k3_ms[fwd] + k3_ms[bwd]
    log(f"[profile] one train step: device busy {busy_ms:.2f} ms, "
        f"{busy_ms / window_ms:.1%} of the {window_ms:.2f} ms window; hard_mine forward "
        f"{k3_ms[fwd]:.4f} ms x{k3_n[fwd]}, backward {k3_ms[bwd]:.4f} ms x{k3_n[bwd]} "
        f"({total / max(busy_ms, 1e-9):.3%})")
    for name, ms, count in rows[:15]:
        log(f"[profile]   {ms:8.3f} ms x{count:<4d} {name[:90]}")
    return dict(device_busy_ms=busy_ms, window_ms=window_ms, busy_share=busy_ms / window_ms,
                hard_mine_ms=k3_ms[fwd], hard_mine_launches=k3_n[fwd],
                hard_mine_backward_ms=k3_ms[bwd], hard_mine_backward_launches=k3_n[bwd],
                hard_mine_share=total / max(busy_ms, 1e-9), top=rows[:15])


def host_side_of_step(torch, step, batches, generator):
    """How long the host is held by one train step: host time until
    step() returns (no sync before the return) vs until the card is done,
    unprofiled, median over the batches; then, in one profiled step, the
    host's time inside CUDA calls that wait for the card (stream syncs and
    the blocking copies)."""
    from torch.profiler import ProfilerActivity, profile

    ret, done = [], []
    for imgs, pids, _, adjs in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(imgs, pids, adjs, generator=generator)
        ret.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        done.append((time.perf_counter() - t0) * 1e3)
    imgs, pids, _, adjs = batches[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(imgs, pids, adjs, generator=generator)
        torch.cuda.synchronize()
    waits = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("cuda") and ("Synchronize" in e.key or "Memcpy" in e.key)}
    out = dict(return_ms=float(np.median(ret)), done_ms=float(np.median(done)),
               profiled_waits_ms=waits, torch_ops=sum(e.count for e in prof.key_averages()
                                                      if e.key.startswith("aten::")))
    log(f"[profile] host side of a train step: step() returns after {out['return_ms']:.2f} ms "
        f"of {out['done_ms']:.2f} ms until the card is done (median of {len(ret)}); profiled "
        f"host waits in CUDA calls {', '.join(f'{k} {v:.2f} ms' for k, v in waits.items())}; "
        f"{out['torch_ops']} aten op calls, nested calls included")
    return out


def phase_train(torch, tri, gc, device):
    """Main path: TRAIN_STEPS steps of the paper recipe's train step on
    synthetic 256x128 data, then the evenly Evaluator on the result."""
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.data.samplers import RandomIdentitySamplerV1
    from agrl_torch.engine.evaluator import Evaluator
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models import init_model
    from agrl_torch.optim import init_optim, multistep_lr, per_step

    build_dir = REPO / "agrl_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        t0 = time.perf_counter()
        ds = init_vidreid_dataset(
            "synthetic", root=root, num_pids=8, tracklets_per_pid=4,
            frames_per_tracklet=(6, 16), height=HEIGHT, width=WIDTH, verbose=False,
        )
        log(f"[train] synthetic dataset ({ds.num_train_pids} train pids, {len(ds.train)} "
            f"tracklets) written in {time.perf_counter() - t0:.1f} s")

        def clip_set(split, sample):
            return VideoClipDataset(getattr(ds, split), seq_len=SEQ_LEN, sample=sample,
                                    height=HEIGHT, width=WIDTH, pose_info=ds.process_poses)

        loader = ClipLoader(
            clip_set("train", "restricted"), batch_size=BATCH, drop_last=True, num_workers=4,
            seed=0, sampler=RandomIdentitySamplerV1(ds.train, num_instances=4, seed=0),
        )
        model = build_train_model(init_model, device)
        opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
        lr_fn = per_step(multistep_lr(1e-4, [50, 100, 150]), len(loader))
        step = make_train_step(model, opt, lr_fn, lambda_xent=1.0, lambda_htri=1.0,
                               label_smooth=False, margin=0.3, soft_margin=True,
                               aug={"flip_aug": True})
        gen = torch.Generator().manual_seed(0)
        batches = []
        while len(batches) < TRAIN_STEPS:
            batches.extend(loader)
        batches = batches[:TRAIN_STEPS]

        torch.cuda.reset_peak_memory_stats()
        history, times = [], []
        tri.launches = tri.backward_launches = 0  # main path starts here
        for i, (imgs, pids, _, adjs) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(imgs, pids, adjs, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            row = {k: float(v) for k, v in metrics.items()}
            history.append(row)
            log(f"[train] step {i + 1:2d}: loss {row['loss']:.4f} xent {row['xent_loss']:.4f} "
                f"htri {row['htri_loss']:.4f} top1 {row['top1']:.3f} ({times[-1]:.1f} ms)")
        launches, backward_launches = tri.launches, tri.backward_launches  # main path ends here
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        if not launches == backward_launches == TRAIN_STEPS:
            raise AssertionError(f"{launches} hard_mine forward and {backward_launches} backward "
                                 f"launches, want one each per step x {TRAIN_STEPS}")
        if not all(math.isfinite(v) for row in history for v in row.values()):
            raise AssertionError("a train metric is not finite")
        first = float(np.mean([r["xent_loss"] for r in history[:5]]))
        last = float(np.mean([r["xent_loss"] for r in history[-5:]]))
        log(f"[train] mean xent of steps 1-5 {first:.4f} -> steps {TRAIN_STEPS - 4}-"
            f"{TRAIN_STEPS} {last:.4f}")
        if not last < first:
            raise AssertionError("xent did not fall")
        steady = times[3:]
        q1, med, q3 = (float(v) for v in np.percentile(steady, [25, 50, 75]))
        log(f"[train] step (device synced): median {med:.2f} ms (quartiles {q1:.2f}-{q3:.2f}) "
            f"over steps 4-{TRAIN_STEPS}, {BATCH / med * 1e3:.1f} clips/s; peak device memory "
            f"{peak_gb:.2f} GB; hard_mine launches {launches} forward, {backward_launches} "
            f"backward ({TRAIN_HEADS} heads each)")
        prof = profile_train_step(torch, step, batches[0], gen)
        prof["host_side"] = host_side_of_step(torch, step, batches[-5:], gen)

        gc.launches = 0
        r1, mAP = Evaluator(model, test_sample="evenly", device=device).evaluate(
            ClipLoader(clip_set("query", "evenly"), batch_size=BATCH, num_workers=4),
            ClipLoader(clip_set("gallery", "evenly"), batch_size=BATCH, num_workers=4),
            dist_metric="cosine",
        )
        if not (0.0 <= r1 <= 1.0 and 0.0 <= mAP <= 1.0) or gc.launches == 0:
            raise AssertionError(f"evaluator after training: rank-1 {r1}, mAP {mAP}")
        log(f"[train] evenly evaluator on the trained model: rank-1 {r1:.4f}, mAP {mAP:.4f}")
    return model, (launches, backward_launches), batches, dict(
        steps=TRAIN_STEPS, history=history, step_ms=med, step_q1_ms=q1, step_q3_ms=q3,
        step_all_ms=times, clips_per_s=BATCH / med * 1e3, peak_mem_gb=peak_gb,
        xent_first5=first, xent_last5=last, profile=prof, eval_rank1=r1, eval_mAP=mAP,
    )


def phase_train_paths(torch, tri, losses_mod, model):
    """One train step, kernel path vs plain path on the same batch, flips
    and subclips (only the multi-head triplet loss differs: its plain path
    mines each head with pairwise_euclidean + hard_mine), with
    deterministic cuDNN so that nothing else changes between the two."""
    from agrl_torch.engine import trainer as trainer_mod

    step = frozen_step(torch, model)
    imgs = colour_clips(BATCH, 40)
    pids = np.repeat(np.arange(BATCH // 4), 4)
    adjs = pose_adjacency(BATCH, 40)
    flip = np.arange(BATCH) % 2 == 0
    subs = subclips(40)
    torch.backends.cudnn.deterministic = True
    try:
        kern = step(imgs, pids, adjs, flip=flip, subclip_indices=subs)
        g_kern = grads_of(model)
        trainer_mod.batch_hard_triplet_heads = plain_triplet_heads(tri, losses_mod)
        try:
            plain = step(imgs, pids, adjs, flip=flip, subclip_indices=subs)
        finally:
            trainer_mod.batch_hard_triplet_heads = losses_mod.batch_hard_triplet_heads
        g_plain = grads_of(model)
    finally:
        torch.backends.cudnn.deterministic = False
    loss_err = abs(float(kern["loss"]) - float(plain["loss"])) / abs(float(plain["loss"]))
    worst = max((float((g_kern[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)), n)
                for n, g in g_plain.items())
    log(f"[paths] train step, kernel vs plain triplet: loss rel {loss_err:.3e} (tol 1e-5); "
        f"worst gradient leaf {worst[1]}: max|diff|/max|g| = {worst[0]:.3e} (tol 1e-4)")
    if not (loss_err <= 1e-5 and worst[0] <= 1e-4):
        raise AssertionError("train step: kernel path and plain path disagree")
    return loss_err, worst[0]


def phase_train_card_vs_cpu(torch, device):
    """One train step at full width, B=4 (2x2), on the card and on the CPU
    from the same seed, batch, flips and subclips."""
    from agrl_torch.models import init_model

    imgs = colour_clips(4, 50)
    pids = np.array([0, 0, 1, 1])
    adjs = pose_adjacency(4, 50)
    flip = np.array([True, False, False, True])
    subs = subclips(50)
    out = {}
    for dev in ("cpu", device):
        model = build_train_model(init_model, dev, seed=3)
        t0 = time.perf_counter()
        metrics = frozen_step(torch, model)(imgs, pids, adjs, flip=flip, subclip_indices=subs)
        out[str(dev)] = (float(metrics["loss"]), grads_of(model), time.perf_counter() - t0)
    (l_cpu, g_cpu, cpu_s), (l_gpu, g_gpu, _) = out["cpu"], out[str(device)]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    fro = max((float((g_gpu[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in g_cpu.items())
    worst = max(float((g_gpu[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                for n, g in g_cpu.items())
    # cuDNN and the CPU sum in other orders. The conv kernels ahead of a
    # train-mode BN get gradients whose terms cancel (the loss is invariant
    # to their scale), which magnifies those rounding differences: at
    # vmgn_tiny size fp32 alone is 0.3% (Frobenius) from a float64 run
    # (tests/test_torch_train.py). Bar: 5e-2 of the leaf's norm, far under
    # the O(1) of a wrong term.
    log(f"[cpu] train step, card vs CPU (B=4, S={SEQ_LEN}, full width): loss rel "
        f"{loss_err:.3e} (tol 1e-3); worst gradient leaf {fro[1]}: |diff|/|g| = "
        f"{fro[0]:.3e} (tol 5e-2), largest entry diff / max|g| over leaves {worst:.3e}; "
        f"CPU step {cpu_s:.1f} s")
    if not (loss_err <= 1e-3 and fro[0] <= 5e-2):
        raise AssertionError("train step: card and CPU disagree")
    return loss_err, fro[0], worst


def minsum_bound_ms(a, b, a_in_b=False):
    """Least time for one min-plus call on these inputs: 2 instructions
    (FMNMX, FADD) per term that the data needs, over the fp32 issue rate,
    vs each input read once and the output written once, over the HBM
    rate; the larger one bounds. A term with a zero operand adds min = 0
    (the inputs are non-negative), so the terms needed are sum_c nnz(a[:,
    c]) nnz(b[:, c]); on dense inputs that is Q J C. a_in_b: a is the
    first Q rows of b (re-ranking's v[:Q] and v), which min_sum_sparse
    reads once, as part of b, so a's bytes are not counted. Returns
    (bound ms, bound_by, terms, bound ms if every term were needed)."""
    Q, C = a.shape
    J = b.shape[0]
    terms = int(((a > 0).sum(0).double() * (b > 0).sum(0).double()).sum())
    t_bytes = 4.0 * ((0 if a_in_b else Q * C) + J * C + Q * J) / PEAK_HBM_BYTES
    t_ops = 2.0 * terms / PEAK_FP32_ISSUE
    t_dense = 2.0 * Q * J * C / PEAK_FP32_ISSUE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", terms,
            max(t_dense, t_bytes) * 1e3)


def check_min_sum(torch, ms, a, b, label, atol, relative=False):
    """K4 vs its plain version on the same inputs; raises past the bar."""
    got = ms.min_sum_kernel(a, b)
    want = ms.min_sum_reference(a, b)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max()) if relative else 1.0
    kind = "max|kernel - plain| / max|plain|" if relative else "max|kernel - plain|"
    log(f"[minsum] {label}: {kind} = {err / scale:.3e} (tol {atol:g})")
    if not (err / scale <= atol):
        raise AssertionError(f"min_sum kernel disagrees with plain at {label}: {err / scale}")
    return err / scale


def phase_minsum_shapes(torch, ms, device):
    """K4 vs plain at the JAX package's test shapes (atol 1e-4)."""
    rng = np.random.RandomState(0)
    for Q, J, C in ((37, 53, 100), (130, 260, 515), (8, 8, 8)):
        a = torch.from_numpy(rng.rand(Q, C).astype(np.float32)).to(device)
        b = torch.from_numpy(rng.rand(J, C).astype(np.float32)).to(device)
        check_min_sum(torch, ms, a, b, f"Q={Q} J={J} C={C} uniform", 1e-4)


def mars_features(torch, device, seed=0):
    """Seeded 4096-d features at MARS's test size (1,980 query, 9,330
    gallery tracklets): 636 identity centres plus noise (sigma 5 gives
    cosine rank-1 ~0.67 before re-ranking), cameras 0-5."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(MARS_IDS, 4096).astype(np.float32)
    q_pids = np.arange(MARS_Q) % MARS_IDS
    g_pids = rng.randint(0, MARS_IDS, MARS_G)
    qf = centres[q_pids] + rng.randn(MARS_Q, 4096).astype(np.float32) * 5.0
    gf = centres[g_pids] + rng.randn(MARS_G, 4096).astype(np.float32) * 5.0
    ids = (q_pids, g_pids, rng.randint(0, 6, MARS_Q), rng.randint(0, 6, MARS_G))
    return torch.from_numpy(qf).to(device), torch.from_numpy(gf).to(device), ids


def phase_rerank_mars(torch, ms, rr, rank, qf, gf, ids):
    """Main path: k-reciprocal re-ranking at MARS scale on the card
    (cosine, k1 20, k2 6, lambda 0.3); one sparse K4 call per re-rank and
    no dense one. Returns the main path's (sparse, dense) launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from agrl_torch.ops.distmat import compute_distmat

    runs = 3
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    ms.sparse_launches = ms.launches = 0  # main path starts here
    for i in range(runs):
        before = ms.sparse_launches
        t0 = time.perf_counter()
        final = rr.re_ranking_from_features(qf, gf, "cosine")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if ms.sparse_launches - before != 1:
            raise AssertionError(f"re-rank {i}: {ms.sparse_launches - before} min_sum_sparse "
                                 f"launches, want 1")
    launches, dense_launches = ms.sparse_launches, ms.launches  # main path ends here
    if dense_launches:
        raise AssertionError(f"{dense_launches} dense min_sum launches in re-ranking, want 0")
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    if final.shape != (MARS_Q, MARS_G) or not bool(torch.isfinite(final).all()):
        raise AssertionError("re-ranked matrix has the wrong shape or non-finite entries")
    med = float(np.median(times))
    log(f"[rerank] MARS scale Q={MARS_Q} G={MARS_G} D=4096 cosine: wall {med:.2f} ms median of "
        f"{runs} ({', '.join(f'{t:.2f}' for t in times)}); peak device memory above the "
        f"features {peak_gb:.2f} GB; min_sum_sparse launches {launches} (1 per re-rank), "
        f"dense min_sum launches {dense_launches}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rr.re_ranking_from_features(qf, gf, "cosine")
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    rows = device_rows(prof, 1)
    busy_ms = sum(r[1] for r in rows)
    k4_ms = sum(r[1] for r in rows if any(k in r[0] for k in SPARSE_KERNELS))
    log(f"[rerank] profiled re-rank: device busy {busy_ms:.2f} ms, {busy_ms / window_ms:.1%} of "
        f"the {window_ms:.2f} ms window; the sparse min-sum kernels {k4_ms:.3f} ms "
        f"({k4_ms / max(busy_ms, 1e-9):.2%} of device time; its sort, scans and gathers are "
        f"rows of their own)")
    for name, t, count in rows[:14]:
        log(f"[rerank]   {t:8.3f} ms x{count:<3d} {name[:90]}")

    # kernel path vs plain path: only the Jaccard min-sum differs
    rr.min_sum_sparse = ms.min_sum_reference
    try:
        t0 = time.perf_counter()
        plain = rr.re_ranking_from_features(qf, gf, "cosine")
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3
    finally:
        rr.min_sum_sparse = ms.min_sum_sparse
    err = float((final - plain).abs().max())
    scores = {}
    original = compute_distmat(qf, gf, "cosine")
    for label, dm in (("kernel", final), ("plain", plain), ("original", original)):
        cmc, mAP = rank.mars_cmc_map_from_distmat(dm, *ids)
        scores[label] = (cmc.cpu().numpy(), float(mAP))
    cmc_diff = float(np.abs(scores["kernel"][0] - scores["plain"][0]).max())
    map_diff = abs(scores["kernel"][1] - scores["plain"][1])
    log(f"[rerank] kernel path vs plain path (plain min-sum, {plain_wall:.0f} ms): "
        f"max|diff| = {err:.3e} (tol 1e-5); MARS CMC max|diff| {cmc_diff:.3e}, mAP |diff| "
        f"{map_diff:.3e} (tol 1e-6)")
    log(f"[rerank] MARS rank-1 / mAP: original {scores['original'][0][0]:.4f} / "
        f"{scores['original'][1]:.4f}, re-ranked {scores['kernel'][0][0]:.4f} / "
        f"{scores['kernel'][1]:.4f}")
    if not (err <= 1e-5 and cmc_diff <= 1e-6 and map_diff <= 1e-6):
        raise AssertionError("re-ranking: kernel path and plain path disagree")
    return launches, dense_launches, dict(
        Q=MARS_Q, G=MARS_G, D=4096, metric="cosine", k1=20, k2=6, lambda_value=0.3,
        wall_ms=med, wall_all_ms=times, peak_mem_gb_above_features=peak_gb,
        profile_window_ms=window_ms, device_busy_ms=busy_ms, min_sum_sparse_kernels_ms=k4_ms,
        min_sum_sparse_kernels_share=k4_ms / max(busy_ms, 1e-9), top=rows[:14],
        kernel_vs_plain_max_abs_err=err, plain_path_wall_ms=plain_wall,
        cmc_max_abs_diff=cmc_diff, map_abs_diff=map_diff,
        rank1_original=float(scores["original"][0][0]), map_original=scores["original"][1],
        rank1=float(scores["kernel"][0][0]), mAP=scores["kernel"][1],
    )


def profile_min_sum_sparse(torch, ms, a, b, n=3):
    """Device time by kernel of n back-to-back min_sum_sparse calls (their
    602 MB of inputs do not fit the 50 MB L2): the count, fill and
    accumulation kernels and the glue (zeroed counts, scans, sort,
    gathers)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ms.min_sum_sparse(a, b)
        torch.cuda.synchronize()
    rows = device_rows(prof, n)
    log(f"[minsum] one min_sum_sparse call by kernel (device ms, mean of {n}; device total "
        f"{sum(r[1] for r in rows):.4f} ms):")
    for name, t, count in rows[:10]:
        log(f"[minsum]   {t:8.4f} ms x{count:<2d} {name[:90]}")
    return rows[:10]


def phase_minsum_mars(torch, ms, rr, qf, gf, device, flush):
    """K4 at the MARS shape (Q=1,980, J=C=11,310) on the re-ranking's own
    membership matrix v (rows sum to 1): min_sum_sparse vs plain (atol
    1e-5), vs the host algorithm's fp32 accumulation replayed in NumPy
    (atol 1e-6; agrl_torch.metrics.rerank.sparse_min_sum), bit-equal across
    two calls; the dense kernel vs plain on
    v (atol 1e-5) and on uniform inputs (1e-5 of the max); times of the
    whole sparse call (counts, scans, read-back, fill, sort, accumulation),
    the dense kernel, the plain version and torch.cdist(p=1) + row sums,
    L2 flushed; the bound. Returns (sparse record, dense record)."""
    from agrl_torch.metrics.rerank import sparse_min_sum
    from agrl_torch.ops.distmat import compute_distmat

    dists = [compute_distmat(x, y, "cosine") for x, y in ((qf, gf), (qf, qf), (gf, gf))]
    v = rr.expanded_membership(rr.original_dist(*dists))
    del dists
    a, b = v[:MARS_Q], v

    got = ms.min_sum_sparse(a, b)
    again = ms.min_sum_sparse(a, b)
    want = ms.min_sum_reference(a, b)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bit_equal = bool(torch.equal(got, again))
    t0 = time.perf_counter()
    host = sparse_min_sum(a.cpu().numpy(), b.cpu().numpy())
    host_s = time.perf_counter() - t0
    got_np = got.cpu().numpy()
    host_err = float(np.abs(got_np - host).max())
    host_same = bool(np.array_equal(got_np, host))
    log(f"[minsum] MARS shape, re-ranking v, min_sum_sparse: max|kernel - plain| = {err:.3e} "
        f"(tol 1e-5); max|kernel - host order| = {host_err:.3e} (tol 1e-6; bit-equal: "
        f"{host_same}; NumPy replay {host_s:.1f} s); two calls bit-equal: {bit_equal}")
    if not (err <= 1e-5 and host_err <= 1e-6 and bit_equal):
        raise AssertionError("min_sum_sparse disagrees with plain or the host order, or is "
                             "not deterministic")
    del got, again, want, host, got_np
    srec = dict(max_abs_err=err, host_order_max_abs_err=host_err, host_order_bit_equal=host_same,
                two_calls_bit_equal=bit_equal)

    drec = dict(max_abs_err=check_min_sum(torch, ms, a, b, "MARS shape, re-ranking v", 1e-5))
    gen = torch.Generator(device=device).manual_seed(0)
    ua = torch.rand(MARS_Q, a.shape[1], generator=gen, device=device)
    ub = torch.rand(*b.shape, generator=gen, device=device)
    drec["uniform_rel_err"] = check_min_sum(torch, ms, ua, ub, "MARS shape, uniform", 1e-5,
                                            relative=True)
    del ua, ub

    def library():
        return (a.sum(1)[:, None] + b.sum(1)[None, :] - torch.cdist(a, b, p=1)) / 2

    lib_err = float((library() - ms.min_sum_kernel(a, b)).abs().max())
    srec["ms"] = time_cuda(torch, lambda: ms.min_sum_sparse(a, b), flush, iters=5, warmup=1)
    srec["profile"] = profile_min_sum_sparse(torch, ms, a, b)
    drec["ms"] = time_cuda(torch, lambda: ms.min_sum_kernel(a, b), flush, iters=5, warmup=1)
    plain_ms = time_cuda(torch, lambda: ms.min_sum_reference(a, b), flush, iters=2, warmup=1)
    library_ms = time_cuda(torch, library, flush, iters=3, warmup=1)
    # the dense kernel reads a and b; the sparse entry sees that a is b's
    # first rows (the wrapper's own test) and reads b alone
    bound_ms, bound_by, terms, dense_bound_ms = minsum_bound_ms(a, b)
    a_in_b = a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
    s_bound_ms, s_bound_by, _, _ = minsum_bound_ms(a, b, a_in_b=a_in_b)
    Q, C = a.shape
    dense = Q * b.shape[0] * C
    common = dict(plain_ms=plain_ms, library_ms=library_ms, dense_bound_ms=dense_bound_ms,
                  terms_needed=terms, terms_dense=dense, library_max_abs_err=lib_err,
                  v_nonzero_share=float((v > 0).float().mean()))
    srec.update(common, bound_ms=s_bound_ms, bound_by=s_bound_by, a_read_as_part_of_b=a_in_b)
    drec.update(common, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[minsum] MARS shape Q={Q} J={b.shape[0]} C={C} (v {common['v_nonzero_share']:.3%} "
        f"non-zero): min_sum_sparse call {srec['ms']:.4f} ms (mean of 5; bound "
        f"{s_bound_ms:.4f} ms, {s_bound_by}, b read once{' and a as its first rows' if a_in_b else ''}"
        f"; {s_bound_ms / srec['ms']:.1%} of it), dense kernel {drec['ms']:.3f} ms (mean "
        f"of 5; bound on this v {bound_ms:.4f} ms, {bound_by}, a and b read), plain "
        f"{plain_ms:.1f} ms (mean of 2), cdist(p=1) + row sums {library_ms:.3f} ms (mean of 3; "
        f"max|lib - kernel| {lib_err:.2e}); {terms:.3e} of {dense:.3e} terms have both "
        f"operands non-zero; on dense inputs the bound is {dense_bound_ms:.2f} ms (operations: "
        f"2 instructions per term at {PEAK_FP32_ISSUE / 1e12:.1f} T/s); L2 flushed before each "
        f"call")
    return srec, drec


def exact_features(seed=1):
    """Q=200, G=800 integer features (D=128, 40 identity centres in
    [-150, 150] plus noise in [-100, 100]): every squared euclidean
    distance and every partial sum of it is an integer below 2^24, so the
    distances are bit-identical on the card, on the CPU and in the host
    algorithm's float64, and this seed leaves no tie at the neighbour-set
    boundaries (ranks 6, 11, 21). With continuous features, fp32 rounding
    (~1e-7) flips near-tied neighbours between devices, and one flipped
    set moves its row's Jaccard terms by up to ~1e-1."""
    rng = np.random.RandomState(seed)
    centres = rng.randint(-150, 151, (40, 128))
    pids = rng.randint(0, 40, 1000)
    feats = (centres[pids] + rng.randint(-100, 101, (1000, 128))).astype(np.float32)
    return feats[:200], feats[200:]


def boundary_gap(torch, rr, qf, gf, metric):
    """Smallest distance gap at a neighbour-set boundary of re-ranking
    (between ranks k - 1 and k of each sorted row of its normalized
    distance, k = k2 = 6, half_k + 1 = 11, k1 + 1 = 21): 0 means a tie
    that decides a set."""
    from agrl_torch.ops.distmat import compute_distmat

    d = rr.original_dist(*(compute_distmat(x, y, metric) for x, y in ((qf, gf), (qf, qf), (gf, gf))))
    s = torch.sort(d, dim=1).values
    return min(float((s[:, k] - s[:, k - 1]).min()) for k in (6, 11, 21))


def phase_rerank_cpu(torch, rr, device):
    """The port's re-ranking from features on the card vs its own CPU run
    vs the copied host algorithm (metrics.rerank.re_ranking on float64
    host distances), Q=200 G=800, squared euclidean, atol 2e-4. Then the
    card vs the CPU on continuous 4096-d cosine features of the same size,
    reported and not held: there fp32 rounding decides near ties."""
    from agrl_torch.metrics import compute_distance_matrix, re_ranking

    qf, gf = exact_features()
    q_card, g_card = torch.from_numpy(qf).to(device), torch.from_numpy(gf).to(device)
    gap = boundary_gap(torch, rr, q_card, g_card, "euclidean")
    card = rr.re_ranking_from_features(q_card, g_card, "euclidean").cpu().numpy()
    t0 = time.perf_counter()
    cpu = rr.re_ranking_from_features(torch.from_numpy(qf), torch.from_numpy(gf),
                                      "euclidean").numpy()
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = re_ranking(*(compute_distance_matrix(x, y, "euclidean")
                        for x, y in ((qf, gf), (qf, qf), (gf, gf))))
    host_s = time.perf_counter() - t0
    e_cpu, e_host = float(np.abs(card - cpu).max()), float(np.abs(card - host).max())
    log(f"[rerank] Q=200 G=800 exact integer distances (smallest boundary gap {gap:.2e}): card "
        f"vs CPU max|diff| {e_cpu:.3e}, card vs host algorithm {e_host:.3e} (tol 2e-4); CPU "
        f"{cpu_s:.1f} s, host algorithm {host_s:.1f} s")
    if not (gap > 0 and e_cpu <= 2e-4 and e_host <= 2e-4):
        raise AssertionError("re-ranking: card, CPU and host algorithm disagree")

    rng = np.random.RandomState(1)
    centres = rng.randn(100, 4096)
    qf, gf = (torch.from_numpy((centres[rng.randint(0, 100, n)] + rng.randn(n, 4096) * 5.0)
                               .astype(np.float32)) for n in (200, 800))
    cont_gap = boundary_gap(torch, rr, qf.to(device), gf.to(device), "cosine")
    diff = np.abs(rr.re_ranking_from_features(qf.to(device), gf.to(device), "cosine").cpu().numpy()
                  - rr.re_ranking_from_features(qf, gf, "cosine").numpy())
    rows = int((diff.max(axis=1) > 2e-4).sum())
    log(f"[rerank] the same size on continuous 4096-d cosine features (smallest boundary gap "
        f"{cont_gap:.2e}): card vs CPU max|diff| {float(diff.max()):.3e}, {rows} of 200 rows "
        f"beyond 2e-4 (reported, not held: fp32 distance rounding flips near-tied neighbours)")
    return e_cpu, e_host, float(diff.max()), rows


CLI_MODULE = "agrl_torch.cli.train_vidreid_xent_htri"
CLI_EPOCHS = 3
# the [cli] fixture: MARS's layout at 256x128, 16 train and 8 test ids on 2
# cameras, one tracklet per camera, 16-24 frames each (~1,000 JPEGs)
CLI_DATA = dict(num_train_pids=16, num_test_pids=8, num_cams=2, tracklets_per_cam=1,
                frames_range=(16, 24), height=HEIGHT, width=WIDTH, seed=0)
METER = re.compile(r"Epoch: \[(\d+)\]\[(\d+)/(\d+)\]\tTime (\S+) \(\S+\)\tSpeed \S+ samples/s\t"
                   r"Data (\S+) \(\S+\)\tXent (\S+) \(\S+\)\tHtri (\S+) \(\S+\)")


def vmgn_args() -> list:
    """VMGN_ARGS of scripts/_vmgn_common.sh (the paper preset), read as text."""
    text = (REPO / "scripts" / "_vmgn_common.sh").read_text()
    return shlex.split(re.search(r"VMGN_ARGS=\((.*?)\)", text, re.S).group(1), comments=True)


def cmc_blocks(out: str) -> list:
    """(rank-1, mAP) of each printed result block, as fractions."""
    return [(float(r1) / 100, float(m) / 100) for m, r1 in re.findall(
        r"Results -+\nmAP: (\S+)%\nCMC curve\nRank-1\s*: (\S+)%", out)]


def without_flag(argv, flag):
    """argv with `flag` and its value taken out."""
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


def expected_eval_batches(ds, sample, clip_batch=64):
    """Device batches of a dense or all evaluation of ds's query and
    gallery splits: dense packs clips into batches of clip_batch; all
    batches each bucket's tracklets under clip_batch * 8 frames."""
    from collections import Counter

    from agrl_torch.data.sampling import num_clips
    from agrl_torch.engine.evaluator import Evaluator

    total = 0
    for split in (ds.query, ds.gallery):
        lengths = [min(len(t[0]), 1000) for t in split]
        if sample == "all":
            buckets = Counter(Evaluator._bucket_len(n) for n in lengths)
            total += sum(-(-c // max(1, clip_batch * 8 // sp)) for sp, c in buckets.items())
        else:
            total += -(-sum(num_clips(n, SEQ_LEN, sample) for n in lengths) // clip_batch)
    return total


def run_cli_in_process(cli, argv):
    """cli.main(argv) in this process; returns (result, its console output)."""
    buf, stdout = io.StringIO(), sys.stdout
    sys.stdout = buf
    try:
        result = cli.main(argv)
    finally:
        sys.stdout = stdout
    return result, buf.getvalue()


def host_input_breakdown(root: str, args) -> dict:
    """Where the CLI's Data meter goes: the train loader as the CLI builds
    it (MARS catalog, restricted clips, pose graphs), 3 batches (after a
    first) on args.workers threads and on one; on one thread, the time
    inside the PIL decode (host_decode_resize) and inside the pose graphs
    (_clip_adj)."""
    from agrl_torch.data import loader as loader_mod
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.samplers import init_sampler

    ds = init_vidreid_dataset("mars", root=root, verbose=False, use_pose=True)
    dset = loader_mod.VideoClipDataset(
        ds.train, seq_len=args.seq_len, sample=args.train_sample, height=args.height,
        width=args.width, pose_info=ds.process_poses, num_split=args.num_split,
        num_parts=args.num_parts, pyramid_part=args.pyramid_part, enable_pose=args.use_pose)
    spent = {"decode": 0.0, "graph": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    def batches_ms(workers, n=3):
        loader = loader_mod.ClipLoader(dset, batch_size=args.train_batch, drop_last=True,
                                       num_workers=workers, seed=0, sampler=init_sampler(
                                           args.train_sampler, ds.train, args.train_batch,
                                           args.num_instances, seed=0))
        it = iter(loader)
        next(it)  # warm: first reads of the files
        spent.update(decode=0.0, graph=0.0)
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        return (time.perf_counter() - t0) / n * 1e3

    threaded = batches_ms(args.workers)
    real_decode, real_adj = loader_mod.host_decode_resize, dset._clip_adj
    loader_mod.host_decode_resize = timed("decode", real_decode)
    dset._clip_adj = timed("graph", real_adj)
    try:
        single = batches_ms(1)
    finally:
        loader_mod.host_decode_resize = real_decode
    return dict(batch_ms_threads=threaded, threads=args.workers, batch_ms_one_thread=single,
                decode_ms_one_thread=spent["decode"] / 3 * 1e3,
                graph_ms_one_thread=spent["graph"] / 3 * 1e3, os_cpu_count=os.cpu_count())


def phase_cli(torch, tri, gc, ms):
    """The training CLI as a user runs it: the paper preset through the
    MARS catalog on a synthetic MARS layout, 3 epochs with an eval and a
    checkpoint after each (a subprocess), then in this process with the
    kernel wrappers counted: --evaluate --resume best_model (the best
    Rank-1 again; K1 launches per eval batch), --evaluate --re-rank (one
    min_sum_sparse call), --resume checkpoint_ep2 (epoch 3 at the
    schedule's lr; K3 launches per step) and --resume checkpoint_ep1 at
    the scripts' --print-freq 200; and the train loader alone."""
    from agrl_torch.cli import train_vidreid_xent_htri as cli
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.datasets.synthetic_mars import materialize_mars_layout
    from agrl_torch.engine import trainer
    from agrl_torch.optim import multistep_lr

    t_phase = time.perf_counter()
    build_dir = REPO / "agrl_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    preset = vmgn_args()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root, save_dir = f"{tmp}/data", f"{tmp}/log"
        t0 = time.perf_counter()
        materialize_mars_layout(root, **CLI_DATA)
        ds = init_vidreid_dataset("mars", root=root, verbose=False)
        test_batch = int(preset[preset.index("--test-batch") + 1])
        eval_batches = -(-len(ds.query) // test_batch) + -(-len(ds.gallery) // test_batch)
        log(f"[cli] MARS layout at {HEIGHT}x{WIDTH} written in {time.perf_counter() - t0:.1f} s: "
            f"{ds.num_train_pids} train ids, {len(ds.train)} train / {len(ds.query)} query / "
            f"{len(ds.gallery)} gallery tracklets; preset: {' '.join(preset)}")

        base = ["-d", "mars", *preset, "--root", root]
        argv = base + ["--max-epoch", str(CLI_EPOCHS), "--stepsize", "2", "--eval-step", "1",
                       "--print-freq", "1", "--save-dir", save_dir]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", CLI_MODULE, *argv], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
        train_s = time.perf_counter() - t0
        out = proc.stdout
        (build_dir / "cli_train.log").write_text(out + proc.stderr)
        if proc.returncode != 0:
            raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        meters = [m.groups() for m in METER.finditer(out)]
        steps_per_epoch = int(meters[0][2]) if meters else 0
        step_ms = [float(m[3]) * 1e3 for m in meters]
        data_ms = [float(m[4]) * 1e3 for m in meters]
        losses = [(float(m[5]), float(m[6])) for m in meters]
        evals = cmc_blocks(out)
        ckpts = [f"checkpoint_ep{e}.pth.tar" for e in range(1, CLI_EPOCHS + 1)]
        missing = [c for c in ckpts + ["best_model.pth.tar"]
                   if not (Path(save_dir) / c).exists()]
        best = re.search(r"==> Best Rank-1 (\S+)%", out)
        log(f"[cli] train: {len(meters)} steps in {train_s:.1f} s (process start, catalog, model, "
            f"{CLI_EPOCHS} evals and checkpoints included); evals (rank-1, mAP) {evals}")
        if not (len(meters) == CLI_EPOCHS * steps_per_epoch > 0
                and all(math.isfinite(v) for pair in losses for v in pair)
                and len(evals) == CLI_EPOCHS and not missing and best):
            raise AssertionError(f"CLI run: {len(meters)} meter lines, {len(evals)} evals, "
                                 f"losses {losses}, missing {missing}")
        steady = step_ms[1:]
        med, data_med = float(np.median(steady)), float(np.median(data_ms[1:]))
        log(f"[cli] Time meter: median {med:.2f} ms over steps 2-{len(step_ms)} (first "
            f"{step_ms[0]:.2f}), {BATCH / med * 1e3:.1f} clips/s; Data meter: median "
            f"{data_med:.2f} ms, max {max(data_ms[1:]):.2f} ms (first {data_ms[0]:.2f})")
        host = host_input_breakdown(root, cli.build_parser().parse_args(argv))
        log(f"[cli] host input, the train loader alone: {host['batch_ms_threads']:.1f} ms a "
            f"batch on {host['threads']} threads, {host['batch_ms_one_thread']:.1f} ms on one, of "
            f"which PIL decode {host['decode_ms_one_thread']:.1f} ms and pose graphs "
            f"{host['graph_ms_one_thread']:.1f} ms ({host['os_cpu_count']} CPUs)")

        # in process, with the wrappers counted
        best_ckpt = f"{save_dir}/best_model.pth.tar"
        eval_argv = base + ["--save-dir", f"{tmp}/eval", "--resume", best_ckpt, "--evaluate"]
        gc.launches = 0
        (r1, mAP), _ = run_cli_in_process(cli, eval_argv)
        k1_eval = gc.launches
        log(f"[cli] --evaluate --resume best_model: rank-1 {r1:.2%} (training's best "
            f"{best.group(1)}%), mAP {mAP:.2%}; graph kernel launches {k1_eval} for "
            f"{eval_batches} eval batches")
        if f"{r1 * 100:.2f}" != best.group(1) or k1_eval != 2 * eval_batches:
            raise AssertionError("--evaluate --resume best_model: another rank-1 or K1 count")

        # --evaluate with --test-sample unset (dense, agrl_tpu's default) and with all
        strategies = {}
        unset = without_flag(base, "--test-sample")
        for sample, extra in (("dense", []), ("all", ["--test-sample", "all"])):
            gc.launches = 0
            t0 = time.perf_counter()
            (sr1, smap), sout = run_cli_in_process(cli, unset + extra + [
                "--save-dir", f"{tmp}/eval_{sample}", "--resume", best_ckpt, "--evaluate"])
            secs, k1 = time.perf_counter() - t0, gc.launches
            batches = expected_eval_batches(ds, sample)
            blocks = cmc_blocks(sout)
            log(f"[cli] --evaluate, test_sample {sample}{' (unset)' if not extra else ''}: "
                f"CMC blocks (rank-1, mAP) {blocks}; graph kernel launches {k1} for {batches} "
                f"device batches; {secs:.1f} s")
            if not (len(blocks) == 1 and f"test_sample='{sample}'" in sout and k1 == 2 * batches
                    and 0.0 <= sr1 <= 1.0 and 0.0 <= smap <= 1.0):
                raise AssertionError(f"--evaluate --test-sample {sample}: blocks {blocks}, K1 "
                                     f"launches {k1} for {batches} batches")
            strategies[sample] = dict(rank1=sr1, mAP=smap, k1_launches=k1,
                                      device_batches=batches, seconds=secs)
        ms.sparse_launches = 0
        (rr1, rmap), _ = run_cli_in_process(cli, eval_argv + ["--re-rank"])
        k4 = ms.sparse_launches
        log(f"[cli] --evaluate --re-rank: rank-1 {rr1:.2%}, mAP {rmap:.2%}; min_sum_sparse "
            f"calls {k4}")
        if k4 != 1 or not (0.0 <= rr1 <= 1.0 and 0.0 <= rmap <= 1.0):
            raise AssertionError(f"--re-rank: {k4} min_sum_sparse calls, rank-1 {rr1}")

        seen, real = {"lr": []}, trainer.make_train_step

        def recording(model, optimizer, lr_fn, **kw):
            step = real(model, optimizer, lr_fn, **kw)
            seen["start_step"] = kw["start_step"]

            def counted(*args, **kwargs):
                out = step(*args, **kwargs)
                seen["lr"].append(optimizer.param_groups[0]["lr"])
                return out
            return counted

        trainer.make_train_step = recording
        tri.launches = tri.backward_launches = gc.launches = 0  # main path starts here
        try:
            run_cli_in_process(cli, base + [
                "--max-epoch", str(CLI_EPOCHS), "--stepsize", "2", "--print-freq", "1",
                "--save-dir", f"{tmp}/resumed", "--resume", f"{save_dir}/checkpoint_ep2.pth.tar"])
        finally:
            trainer.make_train_step = real
        fwd, bwd, k1 = tri.launches, tri.backward_launches, gc.launches  # and ends here
        n = len(seen["lr"])
        want_lr = multistep_lr(float(preset[preset.index("--lr") + 1]), [2])(2)
        log(f"[cli] --resume checkpoint_ep2: {n} steps of epoch 3 from step "
            f"{seen.get('start_step')}, lr {sorted(set(seen['lr']))} (schedule: {want_lr:g}); "
            f"hard_mine launches {fwd} forward, {bwd} backward; graph kernel launches {k1} "
            f"in its eval")
        if not (n == steps_per_epoch and seen["start_step"] == 2 * steps_per_epoch
                and all(lr == want_lr for lr in seen["lr"]) and fwd == bwd == n
                and k1 == 2 * eval_batches):
            raise AssertionError("--resume checkpoint_ep2: wrong step count, lr or launches")

        # the scripts' --print-freq 200 (and --print-last): one meter line, one
        # sync, per epoch; epoch 3's line averages its steps over one window
        _, out = run_cli_in_process(cli, base + [
            "--max-epoch", str(CLI_EPOCHS), "--stepsize", "2", "--save-dir", f"{tmp}/freq200",
            "--resume", f"{save_dir}/checkpoint_ep1.pth.tar"])
        lines = [m.groups() for m in METER.finditer(out)]
        if [m[0] for m in lines] != ["2", "3"]:
            raise AssertionError(f"--print-freq 200: meter lines {lines}")
        freq200_ms = float(lines[-1][3]) * 1e3
        log(f"[cli] --print-freq 200: epoch 3's Time meter {freq200_ms:.2f} ms a step over its "
            f"{steps_per_epoch} steps in one window (--print-freq 1: median {med:.2f} ms)")
    torch.cuda.empty_cache()
    return dict(
        steps=len(meters), steps_per_epoch=steps_per_epoch, step_ms_median=med,
        step_ms_all=step_ms, clips_per_s=BATCH / med * 1e3, data_ms_median=data_med,
        data_ms_max=max(data_ms[1:]), data_ms_all=data_ms,
        workers=cli.build_parser().parse_args(argv).workers,
        evals=[{"epoch": e + 1, "rank1": a, "mAP": b} for e, (a, b) in enumerate(evals)],
        best_rank1=float(best.group(1)) / 100, resumed_eval_rank1=r1, resumed_eval_mAP=mAP,
        rerank_rank1=rr1, rerank_mAP=rmap, k3_per_step=[fwd / n, bwd / n],
        k1_per_eval_batch=k1 / eval_batches, k4_per_rerank_eval=k4, eval_batches=eval_batches,
        train_subprocess_s=train_s, resumed_lr=seen["lr"][0], host_input=host,
        step_ms_print_freq_200=freq200_ms, eval_strategies=strategies,
        phase_seconds=time.perf_counter() - t_phase,
    )


SERVE_REQUESTS = ((1, 10, False), (16, 11, False), (21, 12, True))  # (clips, seed, pose adjacency)


def serve_requests():
    """Phase 4's requests: 1, 16 and 21 clips (the last with pose graphs)."""
    return {n: (random_clips(n, seed), pose_adjacency(n, seed) if pose else None)
            for n, seed, pose in SERVE_REQUESTS}


def request_ms(torch, fx, imgs, reps=10):
    """Median and quartiles of a request's host time (H2D, forward, D2H)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fx(imgs)
        times.append((time.perf_counter() - t0) * 1e3)
    return [float(v) for v in np.percentile(times, [25, 50, 75])]


def phase_bf16_serving(torch, gc, layers_mod, model, fx32, device):
    """bf16 serving (phase 19): FeatureExtractor at its bf16 default on the
    `vmgn` factory's float32 model answers phase 4's requests (K1 twice per
    16-clip chunk), features against phase 4's fp32 ones; then the bf16
    eval forward of the float32, bfloat16 and None models (the same seeded
    weights): K1 and K2 launches per chunk, device ms, a 16-clip request's
    clips/s, a profiler table, kernel path vs plain path, bf16 vs fp32."""
    from agrl_torch.engine.evaluator import make_eval_forward
    from agrl_torch.engine.export import FeatureExtractor
    from agrl_torch.models import init_model

    requests = serve_requests()
    fx16 = FeatureExtractor(model, batch_size=BATCH, seq_len=SEQ_LEN, device=device)
    outs, vs_fp32 = {}, {}
    gc.launches = gc.v2_launches = 0  # main path starts here
    expected = 0
    for n, (imgs, adjs) in requests.items():
        before = gc.launches
        outs[n] = fx16(imgs, adjs)
        expected += 2 * math.ceil(n / BATCH)
        if outs[n].shape != (n, 4096) or not np.isfinite(outs[n]).all():
            raise AssertionError(f"bf16 serving: bad features for a {n}-clip request")
        log(f"[bf16] {n:2d}-clip request: graph kernel launches +{gc.launches - before} "
            f"(want {2 * math.ceil(n / BATCH)})")
    launches, v2_launches = gc.launches, gc.v2_launches  # main path ends here
    if launches != expected or v2_launches != 0:
        raise AssertionError(f"bf16 serving: {launches} K1 and {v2_launches} K2 launches, "
                             f"want {expected} and 0")
    for n, (imgs, adjs) in requests.items():
        vs_fp32[n] = rel_err(outs[n], fx32(imgs, adjs))
    q1, med, q3 = request_ms(torch, fx16, requests[16][0])
    q1_32, med32, q3_32 = request_ms(torch, fx32, requests[16][0])
    log(f"[bf16] features vs fp32 serving, max|diff|/max|fp32| by request: "
        f"{', '.join(f'{n}: {e:.3e}' for n, e in vs_fp32.items())} (reported)")
    log(f"[bf16] 16-clip request: bf16 median {med:.2f} ms ({q1:.2f}-{q3:.2f}), "
        f"{BATCH / med * 1e3:.1f} clips/s; fp32 in this phase {med32:.2f} ms "
        f"({q1_32:.2f}-{q3_32:.2f}), {BATCH / med32 * 1e3:.1f} clips/s")
    rec = dict(launches=launches, v2_launches=v2_launches, vs_fp32_rel_err=vs_fp32,
               request16_ms=med, request16_q1_ms=q1, request16_q3_ms=q3,
               clips_per_s=BATCH / med * 1e3, fp32_request16_ms=med32,
               fp32_clips_per_s=BATCH / med32 * 1e3, models={})

    x = torch.from_numpy(random_clips(BATCH, 20)).to(device)
    adj = torch.from_numpy(pose_adjacency(BATCH, 20)).to(device)
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16), ("none", None)):
        m = model if name == "float32" else init_model(
            "vmgn", num_classes=NUM_CLASSES, device=device, seed=0, num_split=4,
            pyramid_part=True, num_gb=2, use_pose=True, learn_graph=True, dtype=dtype)
        fwd = make_eval_forward(m, device, bf16=True)
        before = (gc.launches, gc.v2_launches)
        kern = fwd(x, adj)
        torch.cuda.synchronize()
        k1, k2 = gc.launches - before[0], gc.v2_launches - before[1]
        layers_mod.graph_propagate = gc.graph_propagate_reference
        try:
            plain = fwd(x, adj)
        finally:
            layers_mod.graph_propagate = gc.graph_propagate
        fp32 = make_eval_forward(m, device, bf16=False)(x, adj)
        kern, plain, fp32 = (t.cpu().numpy() for t in (kern, plain, fp32))
        err, vs32 = rel_err(kern, plain), rel_err(kern, fp32)
        dev_ms = time_cuda(torch, lambda: fwd(x, adj), lambda: None, iters=5, warmup=1)
        mq1, mmed, mq3 = request_ms(torch, FeatureExtractor(
            m, batch_size=BATCH, seq_len=SEQ_LEN, device=device), requests[16][0], reps=5)
        log(f"[bf16] model dtype {name}: K1 +{k1}, K2 +{k2} per 16-clip forward; kernel path vs "
            f"plain path {err:.3e} of max (tol 1e-4); bf16 vs fp32 eval {vs32:.3e} (reported); "
            f"device {dev_ms:.2f} ms per 16-clip forward; 16-clip request median {mmed:.2f} ms, "
            f"{BATCH / mmed * 1e3:.1f} clips/s")
        if not (np.isfinite(kern).all() and err <= 1e-4 and k1 == 2 and k2 == 0):
            raise AssertionError(f"bf16 eval of the {name} model: K1 {k1}, K2 {k2}, "
                                 f"kernel vs plain {err}")
        rec["models"][name] = dict(
            k1_per_chunk=k1, k2_per_chunk=k2, kernel_vs_plain_rel_err=err,
            bf16_vs_fp32_rel_err=vs32, forward16_device_ms=dev_ms, request16_ms=mmed,
            request16_q1_ms=mq1, request16_q3_ms=mq3, clips_per_s=BATCH / mmed * 1e3,
            profile=profile_forward(torch, lambda: fwd(x, adj)))
        if m is not model:
            del m
            torch.cuda.empty_cache()
    return rec, outs


ARTIFACT_SERVER = """
import json, sys, time
import numpy as np
import torch
from agrl_torch.core.checkpoint import load_variables
from agrl_torch.engine.export import FeatureExtractor
from agrl_torch.ops import graph_conv as gc

t0 = time.perf_counter()
fx = FeatureExtractor.from_exported(sys.argv[1], load_variables(sys.argv[2]))
load_s = time.perf_counter() - t0
launches = {}
for n in (1, 16, 21):
    imgs = np.load(f"imgs{n}.npy")
    adjs = np.load("adjs21.npy") if n == 21 else None
    before = gc.launches
    np.save(f"feats{n}.npy", fx(imgs, adjs))
    launches[n] = gc.launches - before
imgs = np.load("imgs16.npy")
times = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fx(imgs)
    times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps(dict(
    load_s=load_s, launches=launches, request16_ms=times, device=str(fx.device),
    model_code=[m for m in sys.modules if m.startswith(("agrl_torch.models",
                                                        "agrl_torch.engine.evaluator"))])))
"""


def phase_artifact(torch, model, live_outs, live_ms, device):
    """The serving artifact on the card (phase 20): the bf16 eval forward of
    the serving model exported at batch 16, saved, then loaded and served
    in a fresh process that imports no model code, with the weights read
    by load_variables: 1-, 16- and 21-clip requests, K1 launches counted
    there, features against the live bf16 path (phase 19), request ms."""
    from agrl_torch.engine.export import export_eval_forward, save_exported

    build_dir = REPO / "agrl_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        exported = export_eval_forward(model, model.state_dict(), BATCH, SEQ_LEN, HEIGHT,
                                       WIDTH, device=device)
        export_s = time.perf_counter() - t0
        path, ckpt = f"{tmp}/vmgn_eval.pt2", f"{tmp}/best_model.pth.tar"
        save_exported(path, exported)
        size = os.path.getsize(path)
        consts = sum(t.numel() for t in exported.constants.values())
        weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        torch.save({"state_dict": model.state_dict(), "epoch": 0}, ckpt)
        for n, (imgs, adjs) in serve_requests().items():
            np.save(f"{tmp}/imgs{n}.npy", imgs)
            if adjs is not None:
                np.save(f"{tmp}/adjs{n}.npy", adjs)
        log(f"[artifact] exported in {export_s:.1f} s: {size / 1e6:.3f} MB "
            f"({len(exported.state_dict)} weight tensors, {consts} constant numbers; the "
            f"weights it is served with: {weights / 1e6:.1f} MB)")
        if exported.state_dict or consts > 1000 or size > weights / 10:
            raise AssertionError("the artifact holds weights")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", ARTIFACT_SERVER, path, ckpt], cwd=tmp,
                              env=env, capture_output=True, text=True, timeout=600)
        process_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"artifact server exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        errs = {n: rel_err(np.load(f"{tmp}/feats{n}.npy"), live_outs[n]) for n in live_outs}
    q1, med, q3 = (float(v) for v in np.percentile(res["request16_ms"], [25, 50, 75]))
    want = {str(n): 2 * math.ceil(n / BATCH) for n in live_outs}
    log(f"[artifact] served by a fresh process ({process_s:.1f} s, load {res['load_s']:.1f} s, "
        f"on {res['device']}): K1 launches {res['launches']} (want {want}); features vs the live "
        f"bf16 path {', '.join(f'{n}: {e:.3e}' for n, e in errs.items())} (tol 1e-5); model "
        f"modules imported {res['model_code']}; 16-clip request median {med:.2f} ms "
        f"({q1:.2f}-{q3:.2f}), {BATCH / med * 1e3:.1f} clips/s (live bf16 {live_ms:.2f} ms)")
    if not (res["launches"] == want and all(e <= 1e-5 for e in errs.values())
            and res["model_code"] == [] and res["device"].startswith("cuda")):
        raise AssertionError("the artifact's serving disagrees with the live path")
    return dict(size_bytes=size, export_s=export_s, load_s=res["load_s"],
                process_s=process_s, launches=res["launches"], vs_live_rel_err=errs,
                request16_ms=med, request16_q1_ms=q1, request16_q3_ms=q3,
                clips_per_s=BATCH / med * 1e3, live_bf16_request16_ms=live_ms)


def phase_train_bf16(torch, tri, device, batches, fp32_history):
    """The --bf16-train step (phase 21): the paper recipe's step on a model
    built with dtype bfloat16 from phase 9's seed, on phase 9's batches with
    the same flip and subclip draws; steps 1-4 held against phase 9's fp32
    losses within 0.05."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models import init_model
    from agrl_torch.optim import init_optim

    model = init_model(
        "vmgn", num_classes=NUM_CLASSES, device=device, seed=0, num_split=4,
        pyramid_part=True, num_gb=2, use_pose=True, learn_graph=True, consistent_loss=True,
        dtype=torch.bfloat16,
    )
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    # phase 9's schedule: lr 1e-4 until its first milestone, 50 epochs on
    step = make_train_step(model, opt, lambda step: 1e-4, label_smooth=False, margin=0.3,
                           soft_margin=True, aug={"flip_aug": True})
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    history, times = [], []
    tri.launches = tri.backward_launches = 0  # main path starts here
    for i, (imgs, pids, _, adjs) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(imgs, pids, adjs, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
        log(f"[bf16 train] step {i + 1:2d}: loss {history[-1]['loss']:.4f} xent "
            f"{history[-1]['xent_loss']:.4f} htri {history[-1]['htri_loss']:.4f} "
            f"(fp32 {fp32_history[i]['loss']:.4f}; {times[-1]:.1f} ms)")
    launches, backward = tri.launches, tri.backward_launches  # main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = float(np.mean([r["xent_loss"] for r in history[:5]]))
    last = float(np.mean([r["xent_loss"] for r in history[-5:]]))
    bf16_4 = [r["loss"] for r in history[:4]]
    fp32_4 = [r["loss"] for r in fp32_history[:4]]
    close = bool(np.allclose(bf16_4, fp32_4, rtol=0.05, atol=0.05))
    q1, med, q3 = (float(v) for v in np.percentile(times[3:], [25, 50, 75]))
    dtypes = sorted({str(p.dtype) for p in model.parameters()}
                    | {str(s["exp_avg"].dtype) for s in opt.state.values()})
    log(f"[bf16 train] step (device synced): median {med:.2f} ms (quartiles {q1:.2f}-{q3:.2f}) "
        f"over steps 4-{len(batches)}, {BATCH / med * 1e3:.1f} clips/s; peak {peak_gb:.2f} GB; "
        f"hard_mine launches {launches} forward, {backward} backward; xent {first:.4f} -> "
        f"{last:.4f}; steps 1-4 loss {bf16_4} vs fp32 {fp32_4} (rtol = atol = 0.05: {close}); "
        f"parameter and Adam state dtypes {dtypes}")
    if not (launches == backward == len(batches)
            and all(math.isfinite(v) for r in history for v in r.values())
            and last < first and close and dtypes == ["torch.float32"]):
        raise AssertionError("bf16 train step: launches, finiteness, falling xent, fp32 "
                             "trajectory or fp32 state failed")
    prof = profile_train_step(torch, step, batches[0], gen)
    del model, opt, step
    torch.cuda.empty_cache()
    return (launches, backward), dict(
        steps=len(batches), history=history, step_ms=med, step_q1_ms=q1, step_q3_ms=q3,
        step_all_ms=times, clips_per_s=BATCH / med * 1e3, peak_mem_gb=peak_gb,
        xent_first5=first, xent_last5=last, loss_1_4=bf16_4, fp32_loss_1_4=fp32_4,
        profile=prof)


def phase_cli_bf16(torch, gc):
    """Phase 16, bf16: one CLI epoch of the paper preset with --bf16-train
    --bf16-eval (a subprocess), `python -m agrl_torch.cli.export_model` on
    its best_model.pth.tar (a subprocess), then the artifact served here
    against the live bf16 path of the same weights."""
    from agrl_torch.cli import train_vidreid_xent_htri as cli
    from agrl_torch.core.checkpoint import load_variables
    from agrl_torch.data.datasets.synthetic_mars import materialize_mars_layout
    from agrl_torch.engine.export import FeatureExtractor
    from agrl_torch.models import init_model

    build_dir = REPO / "agrl_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    preset = vmgn_args()
    args = cli.build_parser().parse_args(preset)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root, save_dir = f"{tmp}/data", f"{tmp}/log"
        materialize_mars_layout(root, **CLI_DATA)
        argv = ["-d", "mars", *preset, "--root", root, "--bf16-train", "--bf16-eval",
                "--max-epoch", "1", "--eval-step", "1", "--print-freq", "1",
                "--save-dir", save_dir]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", CLI_MODULE, *argv], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
        train_s = time.perf_counter() - t0
        (build_dir / "cli_train_bf16.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise AssertionError(f"the bf16 CLI run exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        meters = [m.groups() for m in METER.finditer(proc.stdout)]
        losses = [float(v) for m in meters for v in m[5:7]]
        evals = cmc_blocks(proc.stdout)
        best = f"{save_dir}/best_model.pth.tar"
        log(f"[cli bf16] --bf16-train --bf16-eval: {len(meters)} steps in {train_s:.1f} s, "
            f"Time meter median {np.median([float(m[3]) for m in meters[1:]]) * 1e3:.1f} ms; "
            f"evals (rank-1, mAP) {evals}")
        if not (meters and all(math.isfinite(v) for v in losses) and len(evals) == 1
                and Path(best).exists()):
            raise AssertionError(f"bf16 CLI run: {len(meters)} steps, losses {losses}, "
                                 f"evals {evals}")
        num_classes = int(torch.load(best, map_location="cpu", weights_only=True)[
            "state_dict"]["global_classifier.weight"].shape[0])
        arch_flags = ["-a", args.arch, "--num-classes", str(num_classes),
                      "--last-stride", str(args.last_stride), "--num-parts", str(args.num_parts),
                      "--num-split", str(args.num_split), "--num-gb", str(args.num_gb)]
        arch_flags += [f"--{k.replace('_', '-')}" for k in ("pyramid_part", "use_pose",
                                                            "learn_graph", "bnneck")
                       if getattr(args, k)]
        path = f"{tmp}/vmgn_eval.pt2"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "agrl_torch.cli.export_model", *arch_flags,
             "--load-weights", best, "--batch", str(BATCH), "--seq-len", str(args.seq_len),
             "--height", str(args.height), "--width", str(args.width), "--out", path],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        export_s = time.perf_counter() - t0
        exported_line = next((ln for ln in proc.stdout.splitlines()
                              if ln.startswith("Exported")), None)
        log(f"[cli bf16] export_model ({export_s:.1f} s): {exported_line}")
        if proc.returncode != 0 or exported_line is None:
            raise AssertionError(f"export_model exited {proc.returncode}: {proc.stderr[-3000:]}")
        state = load_variables(best)
        fx = FeatureExtractor.from_exported(path, state)
        imgs, adjs = random_clips(21, 40), pose_adjacency(21, 40)
        gc.launches = 0
        got = fx(imgs, adjs)
        k1 = gc.launches
        model = init_model(args.arch, num_classes=num_classes, device="cuda",
                           num_split=args.num_split, pyramid_part=args.pyramid_part,
                           num_gb=args.num_gb, use_pose=args.use_pose,
                           learn_graph=args.learn_graph)
        model.load_state_dict(state)
        want = FeatureExtractor(model, batch_size=BATCH, seq_len=args.seq_len)(imgs, adjs)
        err = rel_err(got, want)
        log(f"[cli bf16] the artifact serves 21 clips: K1 launches {k1} (want 4), features vs "
            f"the live bf16 path {err:.3e} (tol 1e-5)")
        if not (k1 == 4 and err <= 1e-5 and np.isfinite(got).all()):
            raise AssertionError("the CLI's artifact disagrees with the live path")
        del model
    torch.cuda.empty_cache()
    return dict(steps=len(meters), train_subprocess_s=train_s, evals=evals,
                export_s=export_s, exported=exported_line, artifact_k1_launches=k1,
                artifact_vs_live_rel_err=err)


INPUT_EPOCHS = 2
INPUT_PIXEL_SET = 64  # frames written at 512x256 for the downscale comparison
COMPLEXITY = re.compile(r"Model complexity: params (\S+)M flops (\S+)G")


def build_host_libraries():
    """[build] lines for the host libraries of native/ (g++, in parallel):
    the library or the reason it cannot be had."""
    from agrl_torch.data import jpeg_native
    from agrl_torch.metrics import rank_native

    t0 = time.perf_counter()
    mods = {"jpeg_decode": jpeg_native, "rank_eval": rank_native}
    with ThreadPoolExecutor(len(mods)) as pool:
        built = dict(zip(mods, pool.map(lambda m: m.available(), mods.values())))
    secs = time.perf_counter() - t0
    out = {"build_s": secs}
    for name, mod in mods.items():
        if built[name]:
            lib = mod.LIBRARY
            log(f"[build] lib{name}: built, {lib.path.name}" + (f"; {lib.note}" if lib.note else "")
                + f" ({secs:.1f} s for both)")
            out[name] = {"built": True, "library": lib.path.name, "note": lib.note}
        else:
            log(f"[build] lib{name}: {mod.why_unavailable()}")
            out[name] = {"built": False, "reason": mod.why_unavailable()}
    return out


def loader_ms(ds_train, args, decode, workers, n=5):
    """The CLI's train loader alone (MARS catalog, restricted clips, pose
    graphs): ms a batch (mean of n after a first) and ms a frame."""
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.data.samplers import init_sampler

    ds, process_poses = ds_train
    dset = VideoClipDataset(
        ds.train, seq_len=args.seq_len, sample=args.train_sample, height=args.height,
        width=args.width, pose_info=process_poses, num_split=args.num_split,
        num_parts=args.num_parts, pyramid_part=args.pyramid_part, enable_pose=args.use_pose,
        decode=decode)
    loader = ClipLoader(dset, batch_size=args.train_batch, drop_last=True, num_workers=workers,
                        seed=0, malloc_tuning=True, sampler=init_sampler(
                            args.train_sampler, ds.train, args.train_batch, args.num_instances,
                            seed=0))
    got, t0 = 0, None
    while got <= n:
        for _ in loader:
            if t0 is None:
                t0 = time.perf_counter()  # after the first batch: files read once
            else:
                got += 1
                if got == n:
                    break
        if got == n:
            break
    ms = (time.perf_counter() - t0) / n * 1e3
    return ms, ms / (args.train_batch * args.seq_len)


def _downscale_diff(paths, tmp, tag, content):
    """Writes JPEGs at 2 x (HEIGHT, WIDTH) from `content(i, path)` and
    decodes them to (HEIGHT, WIDTH) natively and with PIL: the max |diff|
    and the largest per-frame mean |diff|."""
    from PIL import Image

    from agrl_torch.data.transforms import host_decode_resize

    big = []
    for i, p in enumerate(paths[:INPUT_PIXEL_SET]):
        q = f"{tmp}/{tag}_{i}.jpg"
        Image.fromarray(content(i, p)).save(q, quality=92)
        big.append(q)
    nat, _ = host_decode_resize(big, HEIGHT, WIDTH, decode="native")
    pil, _ = host_decode_resize(big, HEIGHT, WIDTH, decode="pil")
    diff = np.abs(nat.astype(int) - pil.astype(int))
    return int(diff.max()), float(diff.reshape(len(big), -1).mean(axis=1).max())


def pixel_checks(root, tmp, native_built):
    """Native vs PIL pixels: the layout's 256x128 JPEGs (bit-equal); JPEGs
    written at 512x256 with tests/test_torch_host_decode.py's smooth content
    (that test's bound: per-frame mean |native - PIL| < 6); and the layout's
    frames upscaled to 512x256 (reported: the two downscales differ most on
    sharp edges and noise)."""
    from PIL import Image

    from agrl_torch.data.transforms import host_decode_resize

    paths = [str(p) for p in sorted(Path(root).rglob("*.jpg"))[:256]]
    if not native_built:
        log("[input] native vs PIL pixels: not compared (the native decoder is not built)")
        return None
    nat, _ = host_decode_resize(paths, HEIGHT, WIDTH, decode="native")
    pil, _ = host_decode_resize(paths, HEIGHT, WIDTH, decode="pil")
    at_size = int(np.abs(nat.astype(int) - pil.astype(int)).max())
    rng = np.random.RandomState(0)

    def smooth(i, p):
        small = (rng.rand(HEIGHT // 4, WIDTH // 4, 3) * 255).astype(np.uint8)
        return np.asarray(Image.fromarray(small).resize((2 * WIDTH, 2 * HEIGHT),
                                                        Image.BILINEAR))

    def upscaled(i, p):
        return np.asarray(Image.open(p).convert("RGB").resize((2 * WIDTH, 2 * HEIGHT),
                                                               Image.BILINEAR))

    smooth_max, smooth_mean = _downscale_diff(paths, tmp, "smooth", smooth)
    layout_max, layout_mean = _downscale_diff(paths, tmp, "layout", upscaled)
    log(f"[input] native vs PIL pixels: {len(paths)} layout JPEGs at {HEIGHT}x{WIDTH}: max "
        f"|diff| {at_size} (must be 0); {INPUT_PIXEL_SET} JPEGs at {2 * HEIGHT}x{2 * WIDTH} "
        f"decoded to {HEIGHT}x{WIDTH}: smooth content max |diff| {smooth_max}, per-frame mean "
        f"up to {smooth_mean:.3f} (bar 6); the layout's frames upscaled: max |diff| "
        f"{layout_max}, per-frame mean up to {layout_mean:.3f} (reported)")
    if at_size != 0 or smooth_mean >= 6.0:
        raise AssertionError("native decode disagrees with PIL beyond its bars")
    return dict(at_size_frames=len(paths), at_size_max_abs_diff=at_size,
                downscale_frames=INPUT_PIXEL_SET, smooth_max_abs_diff=smooth_max,
                smooth_mean_abs_diff_max=smooth_mean, layout_max_abs_diff=layout_max,
                layout_mean_abs_diff_max=layout_mean)


def phase_input(torch, tri, gc):
    """Phase 22: the CLI's host side on phase 16's MARS layout at the paper
    preset: the host libraries, the train loader alone, native vs PIL
    pixels, the CLI's meters under four input configurations (launches
    counted), blocked time of a save sync vs async, the profile, the FLOPs
    line, and the host scorers at MARS scale."""
    import hashlib

    from agrl_torch.cli import train_vidreid_xent_htri as cli
    from agrl_torch.core import checkpoint as ckpt_mod
    from agrl_torch.data import loader as loader_mod
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.datasets.synthetic_mars import materialize_mars_layout
    from agrl_torch.metrics import rank as host_rank
    from agrl_torch.metrics import rank_native
    from agrl_torch.ops.distmat import compute_distmat

    t_phase = time.perf_counter()
    result = {"build": build_host_libraries()}
    native_built = result["build"]["jpeg_decode"]["built"]
    build_dir = REPO / "agrl_torch" / "_build"
    preset = vmgn_args()
    args = cli.build_parser().parse_args(preset)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root = f"{tmp}/data"
        materialize_mars_layout(root, **CLI_DATA)
        ds = init_vidreid_dataset("mars", root=root, verbose=False, use_pose=True)
        test_batch = args.test_batch
        eval_batches = -(-len(ds.query) // test_batch) + -(-len(ds.gallery) // test_batch)

        # the train loader alone
        loaders = {}
        for decode in ("pil", "native") if native_built else ("pil",):
            for workers in (1, 8):
                ms, per_frame = loader_ms((ds, ds.process_poses), args, decode, workers)
                loaders[f"{decode}_j{workers}"] = {"batch_ms": ms, "frame_ms": per_frame}
                log(f"[input] train loader, {decode}, -j {workers}: {ms:.1f} ms a batch of "
                    f"{args.train_batch * args.seq_len} frames, {per_frame:.3f} ms a frame "
                    f"(decode, pose graphs, stacking; {os.cpu_count()} CPUs)")
        result["loader"] = loaders
        result["pixels"] = pixel_checks(root, tmp, native_built)

        # the CLI, in process with the wrappers counted and the batches hashed
        base = ["-d", "mars", *preset, "--root", root, "--max-epoch", str(INPUT_EPOCHS),
                "--print-freq", "1", "--eval-step", "-1"]
        hashes = []
        real_prefetch = loader_mod.prefetch_to_device
        real_sync, real_async = ckpt_mod.save_checkpoint, ckpt_mod.AsyncCheckpointer.save

        serial = []  # non-empty: the batches bypass the prefetch thread

        def hashing_prefetch(iterator, size=2, device="cuda"):
            def hashed():
                for batch in iterator:
                    hashes.append(hashlib.sha256(batch[0].tobytes()).hexdigest())
                    yield batch
            return hashed() if serial else real_prefetch(hashed(), size, device)

        def cli_run(name, extra):
            hashes.clear()
            tri.launches = tri.backward_launches = gc.launches = 0  # main path starts here
            t0 = time.perf_counter()
            _, out = run_cli_in_process(cli, base + extra + ["--save-dir", f"{tmp}/{name}"])
            secs = time.perf_counter() - t0
            fwd, bwd, k1 = tri.launches, tri.backward_launches, gc.launches  # and ends here
            meters = [m.groups() for m in METER.finditer(out)]
            steps = len(meters)
            spe = int(meters[0][2])
            step_ms = [float(m[3]) * 1e3 for m in meters]
            data_ms = [float(m[4]) * 1e3 for m in meters]
            rec = dict(steps=steps, seconds=secs, k3_per_step=[fwd / steps, bwd / steps],
                       k1_per_eval_batch=k1 / eval_batches,
                       time_ms_median=float(np.median(step_ms[1:])),
                       data_ms_median=float(np.median(data_ms[1:])),
                       epoch2_time_ms_median=float(np.median(step_ms[spe:])),
                       epoch2_data_ms_median=float(np.median(data_ms[spe:])),
                       data_ms_all=data_ms, time_ms_all=step_ms,
                       batch_hashes=list(hashes), evals=cmc_blocks(out))
            for line in out.splitlines():
                if line.startswith(("Frame decoder", "Frame cache", "Eval batch cache",
                                    "Persistent frame cache", "Model complexity")):
                    log(f"[input] {name}: {line}")
            log(f"[input] {name}: {steps} steps, Time meter median {rec['time_ms_median']:.1f} "
                f"ms, Data meter median {rec['data_ms_median']:.2f} ms (steps 2-{steps}); "
                f"epoch 2: Time {rec['epoch2_time_ms_median']:.1f}, Data "
                f"{rec['epoch2_data_ms_median']:.2f} ms; K3 {fwd} + {bwd} launches, K1 {k1} for "
                f"{eval_batches} eval batches; {secs:.1f} s")
            if not (steps == INPUT_EPOCHS * spe and fwd == bwd == steps and k1 == 2 * eval_batches
                    and len(rec["evals"]) == 1 and len(hashes) == steps):
                raise AssertionError(f"CLI run {name}: {steps} steps, K3 {fwd}+{bwd}, K1 {k1}, "
                                     f"evals {rec['evals']}, {len(hashes)} batches hashed")
            return rec, out

        loader_mod.prefetch_to_device = hashing_prefetch
        try:
            runs = {}
            # the batches built when the step asks, as before prefetch_to_device
            serial.append(True)
            runs["a0_pil_serial"], _ = cli_run("a0_pil_serial", ["--decode", "pil"])
            serial.clear()
            runs["a_pil"], out_a = cli_run("a_pil", ["--decode", "pil"])
            runs["b_auto"], _ = cli_run("b_auto", ["--decode", "auto"])
            runs["c_cache_frames"], _ = cli_run("c_cache_frames", ["--cache-frames"])
            store = f"{tmp}/store"
            runs["d_store_cold"], _ = cli_run("d_store_cold", ["--frame-cache-dir", store])
            runs["d_store_warm"], out_d = cli_run("d_store_warm", ["--frame-cache-dir", store])
        finally:
            loader_mod.prefetch_to_device = real_prefetch
        if not (runs["a_pil"]["batch_hashes"] == runs["c_cache_frames"]["batch_hashes"]
                == runs["a0_pil_serial"]["batch_hashes"]):
            raise AssertionError("the uint8 train batches of --decode pil and --cache-frames "
                                 "differ")
        present = re.search(r"Persistent frame cache: '.*' \((\d+) frames present\)", out_d)
        if not present or int(present.group(1)) == 0:
            raise AssertionError("the second --frame-cache-dir run found no frames")
        log(f"[input] batches of a0_pil_serial, a_pil and c_cache_frames: "
            f"{len(runs['a_pil']['batch_hashes'])} sha256 equal; the warm store held "
            f"{present.group(1)} frames")
        result["cli"] = runs
        flops = COMPLEXITY.search(out_a)
        result["flops_line"] = flops.group(0)
        result["gflops"], result["params_m"] = float(flops.group(2)), float(flops.group(1))

        # --async-ckpt and --profile-dir: one epoch, the saves timed
        prof = f"{tmp}/prof"
        synced = []

        def sync_timed(model, optimizer, fpath, epoch, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_sync(model, optimizer, fpath, epoch, **kw)
            synced.append((time.perf_counter() - t0) * 1e3)

        async_blocked, async_states = [], []

        def async_timed(self, model, optimizer, fpath, epoch, **kw):
            async_states.append({k: v.detach().to("cpu", copy=True)
                                 for k, v in model.state_dict().items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_async(self, model, optimizer, fpath, epoch, **kw)
            async_blocked.append((time.perf_counter() - t0) * 1e3)

        import agrl_torch.core as core_pkg

        one = base[:base.index("--max-epoch")] + ["--max-epoch", "1", "--print-freq", "1"]
        core_pkg.save_checkpoint = sync_timed
        try:
            run_cli_in_process(cli, one + ["--save-dir", f"{tmp}/sync"])
        finally:
            core_pkg.save_checkpoint = real_sync
        written = []
        real_write = ckpt_mod.AsyncCheckpointer._write

        def write_timed(*a):
            t0 = time.perf_counter()
            real_write(*a)
            written.append((time.perf_counter() - t0) * 1e3)

        ckpt_mod.AsyncCheckpointer.save = async_timed
        ckpt_mod.AsyncCheckpointer._write = staticmethod(write_timed)
        try:
            run_cli_in_process(cli, one + ["--save-dir", f"{tmp}/async", "--async-ckpt",
                                           "--profile-dir", prof])
        finally:
            ckpt_mod.AsyncCheckpointer.save = real_async
            ckpt_mod.AsyncCheckpointer._write = staticmethod(real_write)
        saved = torch.load(f"{tmp}/async/checkpoint_ep1.pth.tar", map_location="cpu",
                           weights_only=True)["state_dict"]
        equal = saved.keys() == async_states[0].keys() and all(
            torch.equal(saved[k], v) for k, v in async_states[0].items())
        traces = sorted(Path(prof).glob("trace_*.json"))
        trace_text = traces[0].read_text() if traces else ""
        names_k3 = [k for k in TRIPLET_KERNELS if k in trace_text]
        result["checkpoint"] = dict(sync_blocked_ms=synced[0], async_blocked_ms=async_blocked[0],
                                    async_write_ms=written[0], async_file_loads_equal=equal,
                                    file_mb=os.path.getsize(
                                        f"{tmp}/async/checkpoint_ep1.pth.tar") / 1e6)
        result["profile"] = dict(files=[p.name for p in Path(prof).iterdir()],
                                 trace_mb=sum(p.stat().st_size for p in traces) / 1e6,
                                 names_k3=names_k3)
        log(f"[input] a save blocks the loop {synced[0]:.1f} ms sync, {async_blocked[0]:.1f} ms "
            f"with --async-ckpt, whose thread writes it in {written[0]:.1f} ms "
            f"({result['checkpoint']['file_mb']:.1f} MB file); the async file loads equal: "
            f"{equal}")
        log(f"[input] --profile-dir: {result['profile']['files']}, "
            f"{result['profile']['trace_mb']:.1f} MB of trace; K3 kernels named: {names_k3}")
        if not (equal and names_k3 == list(TRIPLET_KERNELS)):
            raise AssertionError("--async-ckpt file or --profile-dir trace wrong")

    # the host scorers at MARS scale, native vs NumPy
    qf, gf, ids = mars_features(torch, torch.device("cuda"))
    dm = compute_distmat(qf, gf, "cosine").cpu().numpy()
    del qf, gf
    torch.cuda.empty_cache()
    scorers = {}
    for proto, numpy_fn, native_fn in (
            ("mars", host_rank.evaluate_mars, rank_native.evaluate_mars_native),
            ("market1501", host_rank.eval_market1501, rank_native.evaluate_market1501_native)):
        t0 = time.perf_counter()
        cmc_n, map_n = numpy_fn(dm, *ids, 50)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        rec = {"numpy_ms": numpy_ms, "mAP": map_n, "rank1": float(cmc_n[0])}
        if result["build"]["rank_eval"]["built"]:
            t0 = time.perf_counter()
            cmc_c, map_c = native_fn(dm, *ids, 50)
            rec["native_ms"] = (time.perf_counter() - t0) * 1e3
            rec["cmc_max_abs_diff"] = float(np.abs(np.asarray(cmc_c) - cmc_n).max())
            rec["map_abs_diff"] = abs(map_c - map_n)
            if rec["cmc_max_abs_diff"] > 1e-6 or rec["map_abs_diff"] > 1e-6:
                raise AssertionError(f"native {proto} scorer disagrees with NumPy: {rec}")
        scorers[proto] = rec
        log(f"[input] host scorer {proto} on the {MARS_Q} x {MARS_G} distance matrix: NumPy "
            f"{numpy_ms:.1f} ms" + (f", native {rec['native_ms']:.1f} ms; CMC max |diff| "
                                    f"{rec['cmc_max_abs_diff']:.1e}, mAP |diff| "
                                    f"{rec['map_abs_diff']:.1e}" if "native_ms" in rec else
                                    " (native not built)"))
    result["scorers"] = scorers
    result["phase_seconds"] = time.perf_counter() - t_phase
    return result


# ---- phase 23: the rest of VMGN's training surface ------------------------

SURFACE_STEPS = 12  # per optimizer; the step-13 update lies across an lr change
SURFACE_SPE = 6  # steps an "epoch" of phase 23's schedule
SURFACE_MODES = (("both", True, True), ("pose", True, False), ("learned", False, True))


def surface_batches(n, seed):
    """n paper-config batches (16 colour clips of 4 ids, pose graphs)."""
    pids = np.repeat(np.arange(BATCH // 4), 4)
    return [(colour_clips(BATCH, seed + i), pids, pose_adjacency(BATCH, seed + i))
            for i in range(n)]


def surface_lr_fn():
    """A warmup epoch at 1% of 1e-4 (steps 0-5), 1e-4 (steps 6-11), then
    the milestone at epoch 2: step 12 takes 1e-5."""
    from agrl_torch.optim import per_step, warmup_multistep_lr

    return per_step(warmup_multistep_lr(1e-4, [2], warmup_factor=0.01, warmup_iters=1),
                    SURFACE_SPE)


def leaf_rel_errs(torch, got: dict, want: dict) -> dict:
    """Per entry: max|got - want| / max|want| (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        g = got[k].detach().double().cpu()
        w = w.detach().double().cpu()
        scale = float(w.abs().max())
        out[k] = float((g - w).abs().max()) / scale if scale else float((g - w).abs().max())
    return out


def held_update(torch, name, opt, lr_fn, step_index):
    """One update of `opt` (after its steps) on the card and the same update
    on the CPU from the same state and the card's last gradients, at
    lr_fn(step_index); and the CPU update at the previous step's lr, to show
    the comparison sees the lr change. Returns (max rel err over leaves, rel
    distance at the old lr)."""
    import copy

    from agrl_torch.optim import init_optim

    held = list(opt.param_groups[0]["params"])
    state = copy.deepcopy(opt.state_dict())  # the card's step below updates it in place
    p0 = [p.detach().cpu().clone() for p in held]
    grads = [p.grad.detach().cpu().clone() for p in held]

    def cpu_step(lr):
        ps = [torch.nn.Parameter(p.clone()) for p in p0]
        cpu_opt = init_optim(name, ps, 1e-4, weight_decay=5e-4)
        cpu_opt.load_state_dict(state)
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        for group in cpu_opt.param_groups:
            group["lr"] = lr
        cpu_opt.step()
        return ps

    lr = lr_fn(step_index)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    cpu_new, cpu_old = cpu_step(lr), cpu_step(lr_fn(step_index - 1))
    names = [str(i) for i in range(len(held))]
    err = max(leaf_rel_errs(torch, dict(zip(names, held)), dict(zip(names, cpu_new))).values())
    old = max(leaf_rel_errs(torch, dict(zip(names, held)), dict(zip(names, cpu_old))).values())
    return err, old


def phase_optimizers(torch, tri, model, init, batches, device):
    """(a) SURFACE_STEPS steps of the paper recipe under each optimizer name
    from one seeded state; K3 launches per step, step ms (median of steps
    4-12), finite losses; then the held update across the lr change, card
    vs CPU."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.optim import OPTIMIZER_NAMES, init_optim

    lr_fn = surface_lr_fn()
    out = {}
    for name in OPTIMIZER_NAMES:
        model.load_state_dict(init)
        opt = init_optim(name, model.parameters(), 1e-4, weight_decay=5e-4)
        step = make_train_step(model, opt, lr_fn, label_smooth=False, soft_margin=True,
                               aug={"flip_aug": True})
        gen = torch.Generator().manual_seed(0)
        times, losses = [], []
        tri.launches = tri.backward_launches = 0  # this optimizer's path starts here
        for imgs, pids, adjs in batches[:SURFACE_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(imgs, pids, adjs, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        fwd, bwd = tri.launches, tri.backward_launches  # and ends here
        err, old = held_update(torch, name, opt, lr_fn, SURFACE_STEPS)
        med = float(np.median(times[3:]))
        rec = dict(step_ms=med, step_all_ms=times, losses=losses,
                   k3_per_step=[fwd / SURFACE_STEPS, bwd / SURFACE_STEPS],
                   held_update_card_vs_cpu=err, held_update_vs_old_lr=old,
                   lr_change=[lr_fn(SURFACE_STEPS - 1), lr_fn(SURFACE_STEPS)])
        log(f"[surface] optim {name:8s}: step {med:.2f} ms (median of steps 4-{SURFACE_STEPS}), "
            f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, hard_mine {fwd}+{bwd} launches in "
            f"{SURFACE_STEPS} steps; update {SURFACE_STEPS + 1} (lr {rec['lr_change'][0]:g} -> "
            f"{rec['lr_change'][1]:g}) card vs CPU {err:.3e} of max per leaf (tol 1e-6; at the "
            f"old lr {old:.3e})")
        if not (fwd == bwd == SURFACE_STEPS and all(math.isfinite(v) for v in losses)
                and err <= 1e-6 and old > 10 * max(err, 1e-9)):
            raise AssertionError(f"optimizer {name}: launches {fwd}+{bwd}, losses {losses}, "
                                 f"card vs CPU {err}, old-lr distance {old}")
        out[name] = rec
        del opt, step
        torch.cuda.empty_cache()
    return out


def phase_augment(torch, tri, model, init, batches, device):
    """(b) Each augmentation with injected draws, card against CPU, and its
    device ms; then 10 steps with all three and the flips."""
    from agrl_torch.data import transforms as tt
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.optim import init_optim

    imgs = torch.from_numpy(colour_clips(BATCH, 70))
    g = torch.Generator().manual_seed(5)
    draws = dict(misalign_draws=tt.draw_misalign(BATCH, g),
                 translate_draws=tt.draw_translate(BATCH, HEIGHT, WIDTH, g),
                 flip=torch.rand(BATCH, generator=g) < 0.5,
                 erase_draws=tt.draw_erase(BATCH, SEQ_LEN, HEIGHT, WIDTH, g))
    off = dict(flip_aug=False, rand_erase=False, misalign_aug=False, rand_translate=False)
    cases = {"flip": dict(off, flip_aug=True), "misalign": dict(off, misalign_aug=True),
             "rand_crop": dict(off, rand_translate=True), "rand_erase": dict(off, rand_erase=True),
             "all": dict(flip_aug=True, rand_erase=True, misalign_aug=True, rand_translate=True)}
    on_card = imgs.to(device)
    out = {}
    for label, flags in cases.items():
        card = tt.preprocess_clips(on_card, train=True, **draws, **flags)
        cpu = tt.preprocess_clips(imgs, train=True, **draws, **flags)
        err = float((card.cpu() - cpu).abs().max())
        ms = time_cuda(torch, lambda: tt.preprocess_clips(on_card, train=True, **draws, **flags),
                       lambda: None, iters=10, warmup=2)
        out[label] = dict(card_vs_cpu_max_abs_err=err, preprocess_ms=ms)
        log(f"[surface] augment {label:10s}: card vs CPU max|diff| {err:.3e} (tol 1e-5), "
            f"preprocess of 16 clips {ms:.3f} ms")
        if not err <= 1e-5:
            raise AssertionError(f"augmentation {label}: card and CPU disagree by {err}")

    model.load_state_dict(init)
    opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-4, label_smooth=False, soft_margin=True,
                           aug=cases["all"])
    gen = torch.Generator().manual_seed(1)
    times, losses = [], []
    tri.launches = tri.backward_launches = 0  # the augmented path starts here
    for imgs_, pids, adjs in batches[:10]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(imgs_, pids, adjs, generator=gen)["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd, bwd = tri.launches, tri.backward_launches  # and ends here
    med = float(np.median(times[3:]))
    log(f"[surface] 10 steps with flips, misalign, crop and erase: {med:.2f} ms (median of "
        f"steps 4-10), hard_mine {fwd}+{bwd}, losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (fwd == bwd == 10 and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"augmented steps: launches {fwd}+{bwd}, losses {losses}")
    out["steps"] = dict(step_ms=med, step_all_ms=times, losses=losses,
                        k3_per_step=[fwd / 10, bwd / 10])
    return out


def phase_remat(torch, tri, model, init, batches, device):
    """(c) none/dots/full: one step from one seeded state with the same
    flips and subclips under torch.use_deterministic_algorithms (warnings
    only where an op has no deterministic kernel), held against none's;
    the running statistics updated once; then 6 more steps for the step ms
    (median of the last 5) and the peak memory of the 7."""
    import warnings

    from agrl_torch.engine.trainer import REMAT_POLICIES, make_train_step
    from agrl_torch.optim import init_optim

    imgs, pids, adjs = batches[0]
    flip = np.arange(BATCH) % 3 == 0
    subs = subclips(23)
    out, first = {}, {}
    for policy in REMAT_POLICIES + ("none",):  # none twice: its own repeatability
        model.load_state_dict(init)
        opt = init_optim("adam", model.parameters(), 1e-4, weight_decay=5e-4)
        step = make_train_step(model, opt, lambda s: 1e-4, label_smooth=False, soft_margin=True,
                               aug={"flip_aug": True}, remat=policy)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                tri.launches = tri.backward_launches = 0  # this policy's path starts here
                step(imgs, pids, adjs, flip=flip, subclip_indices=subs)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        tracked = int(model.bn1.num_batches_tracked)
        if policy in first:  # the second none
            rep = leaf_rel_errs(torch, state, first[policy])
            out["none"]["repeat_max_rel_err"] = max(rep.values())
            out["none"]["repeat_bit_equal"] = all(v == 0 for v in rep.values())
            continue
        first[policy] = state
        gen = torch.Generator().manual_seed(2)
        times = []
        for b_imgs, b_pids, b_adjs in batches[1:7]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(b_imgs, b_pids, b_adjs, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd, bwd = tri.launches, tri.backward_launches  # and ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        rec = dict(step_ms=float(np.median(times[1:])), step_all_ms=times, peak_mem_gb=peak,
                   k3_per_step=[fwd / 7, bwd / 7], bn_updates_after_one_step=tracked)
        if policy != "none":
            errs = leaf_rel_errs(torch, state, first["none"])
            rec["vs_none_max_rel_err"] = max(errs.values())
            rec["vs_none_bit_equal_entries"] = sum(v == 0 for v in errs.values())
            rec["entries"] = len(errs)
        out[policy] = rec
        log(f"[surface] remat {policy:4s}: step {rec['step_ms']:.2f} ms (median of 5), peak "
            f"{peak:.2f} GB, hard_mine {fwd}+{bwd} in 7 steps, bn1 updated {tracked}x by step 1"
            + ("" if policy == "none" else
               f"; step 1 vs none: {rec['vs_none_max_rel_err']:.3e} of max per entry (tol "
               f"1e-5), {rec['vs_none_bit_equal_entries']}/{rec['entries']} bit-equal"))
        if not (fwd == bwd == 7 and tracked == 1
                and (policy == "none" or rec["vs_none_max_rel_err"] <= 1e-5)):
            raise AssertionError(f"remat {policy}: {rec}")
        del opt, step
    log(f"[surface] remat none repeated: {out['none']['repeat_max_rel_err']:.3e} "
        f"(bit-equal: {out['none']['repeat_bit_equal']})")
    return out


def graph_mode_bound_ms(B, V, C, mode):
    """graph_bound_ms for one mode: the Gram only where the mode uses it."""
    mm, gh = 2.0 * B * V * C * C, 2.0 * B * V * V * C
    gram = 1.0 * B * V * (V + 1) * C if mode in ("both", "learned") else 0.0
    nbytes = 4.0 * (2 * B * V * C + B * V * V + C * C + 4 * C)
    t_ops, t_mem = 3 * (mm + gram + gh) / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def phase_graph_modes(torch, gc, layers_mod, device, flush):
    """(d) The 16-clip eval forward of VMGN in each graph mode its flags
    reach, kernel path vs plain path, K1 launches per forward; then K1 in
    each of its three modes at the serving shape vs its plain twin, timed,
    with its bound."""
    from agrl_torch.data.transforms import preprocess_clips
    from agrl_torch.models import init_model

    x = preprocess_clips(torch.from_numpy(random_clips(BATCH, 80)).to(device))
    adj = torch.from_numpy(pose_adjacency(BATCH, 80)).to(device)
    out = {}
    for mode, use_pose, learn_graph in SURFACE_MODES:
        model = init_model("vmgn", num_classes=NUM_CLASSES, device=device, seed=0, num_split=4,
                           pyramid_part=True, num_gb=2, use_pose=use_pose,
                           learn_graph=learn_graph)
        with torch.no_grad():
            gc.launches = 0  # this mode's eval forward starts here
            kern = model(x, adj)
            torch.cuda.synchronize()
            launches = gc.launches  # and ends here
            layers_mod.graph_propagate = gc.graph_propagate_reference
            try:
                plain = model(x, adj)
            finally:
                layers_mod.graph_propagate = gc.graph_propagate
        err = rel_err(kern.cpu().numpy(), plain.cpu().numpy())
        modes = {layer.mode for layer in model.graph_layers}
        out[mode] = dict(model_launches=launches, model_rel_err=err)
        log(f"[surface] VMGN eval, graph {mode:7s} (--use-pose {use_pose}, --learn-graph "
            f"{learn_graph}): K1 launches {launches} for 16 clips, kernel vs plain path "
            f"{err:.3e} of max (tol 1e-5)")
        if not (launches == 2 and modes == {mode} and err <= 1e-5):
            raise AssertionError(f"graph mode {mode}: {launches} launches, layers {modes}, "
                                 f"err {err}")
        del model
        torch.cuda.empty_cache()
    B, V, C = BATCH, SEQ_LEN * 7, FEATURE_DIM
    args = graph_inputs(torch, B, V, C, 90, device)
    for mode in gc.GRAPH_MODES:
        gc.launches = 0  # the op-level check of this mode
        got = gc.graph_propagate(*args, mode=mode)
        torch.cuda.synchronize()
        launched = gc.launches
        want = gc.graph_propagate_reference(*args, mode=mode)
        err = rel_err(got.cpu().numpy(), want.cpu().numpy())
        ms = time_cuda(torch, lambda: gc.graph_propagate(*args, mode=mode), flush)
        plain_ms = time_cuda(torch, lambda: gc.graph_propagate_reference(*args, mode=mode),
                             flush, iters=5)
        bound, by = graph_mode_bound_ms(B, V, C, mode)
        out.setdefault(mode, {}).update(op_launches=launched, max_rel_err=err,
                                        max_abs_err=float((got - want).abs().max()), ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        log(f"[surface] K1 mode {mode:7s} B={B} V={V} C={C}: {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"bound {bound:.4f} by {by}), max|diff|/max|plain| {err:.3e} (tol 1e-5)")
        if not (launched == 1 and err <= 1e-5):
            raise AssertionError(f"K1 mode {mode}: {launched} launches, err {err}")
    return out


def flax_layout(arr, kind):
    """The inverse of weight_convert's layout change: OIHW -> HWIO, a torch
    Linear (out, in) -> flax Dense (in, out)."""
    if kind == "conv":
        return arr.transpose(2, 3, 1, 0)
    return arr.T if kind == "linear" else arr


def optax_state_tree(model, optim, count, seed):
    """An optax-layout opt_state of agrl_tpu's init_optim(optim) for
    `model`'s parameters, from seeded numpy arrays: the moment trees have
    the params' flax paths and layouts (core/optax_state.py's table)."""
    from agrl_torch.models.weight_convert import torch_name_map

    rng = np.random.RandomState(seed)

    def tree(positive=False):
        out = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            path, _, kind = torch_name_map(name)
            arr = rng.randn(*p.shape).astype(np.float32) * 1e-3
            arr = arr * arr if positive else arr
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = flax_layout(arr, kind)
        return out

    c = np.int32(count)
    if optim == "adam":
        return {"0": {"count": c}, "1": {"0": {"count": c, "mu": tree(), "nu": tree(True)},
                                         "1": {"count": c}}}
    if optim == "sgd":
        return {"0": {"count": c}, "1": {"0": {"trace": tree()}, "1": {"count": c}}}
    if optim == "radam":
        return {"count": c, "exp_avg": tree(), "exp_avg_sq": tree(True)}
    raise KeyError(optim)


def phase_migration(torch, device):
    """(e) agrl_tpu's optax state migrated into the port's optimizer (adam,
    sgd, radam), from seeded optax-layout trees (no JAX here): one resumed
    step on the card and on the CPU from the same parameters, state and
    gradients, within 1e-6 of max per entry."""
    import copy

    from agrl_torch.core.optax_state import load_optax_state
    from agrl_torch.models import init_model
    from agrl_torch.optim import init_optim

    model = init_model("vmgn", num_classes=NUM_CLASSES, device=device, seed=3, num_split=4,
                       pyramid_part=True, num_gb=2, use_pose=True, learn_graph=True,
                       consistent_loss=True)
    cpu_model = copy.deepcopy(model).cpu()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(9)
    grads = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 1e-1)
             for n, p in model.named_parameters() if p.requires_grad}
    out = {}
    for k, optim in enumerate(("adam", "sgd", "radam")):
        tree = optax_state_tree(cpu_model, optim, count=7, seed=20 + k)
        model.load_state_dict(init)
        cpu_model.load_state_dict({n: v.cpu() for n, v in init.items()})
        steps = []
        for m in (model, cpu_model):
            opt = init_optim(optim, m.parameters(), 1e-4, weight_decay=5e-4)
            steps.append(load_optax_state(opt, m, tree, optim))
            for n, p in m.named_parameters():
                if p.requires_grad:
                    p.grad = grads[n].to(p.device)
            opt.step()
        card = {n: p for n, p in model.named_parameters() if p.requires_grad}
        cpu = {n: p for n, p in cpu_model.named_parameters() if p.requires_grad}
        err = max(leaf_rel_errs(torch, card, cpu).values())
        moved = max(leaf_rel_errs(torch, cpu, {n: init[n] for n in cpu}).values())
        out[optim] = dict(count=steps[0], card_vs_cpu_max_rel_err=err, step_moved=moved)
        log(f"[surface] migration {optim:5s}: optax count {steps[0]} -> the port's step; the "
            f"resumed step card vs CPU {err:.3e} of max per entry (tol 1e-6; the step moved "
            f"the weights by {moved:.3e})")
        if not (steps == [7, 7] and err <= 1e-6 and moved > 100 * max(err, 1e-12)):
            raise AssertionError(f"migration {optim}: counts {steps}, err {err}, moved {moved}")
    del model, cpu_model
    torch.cuda.empty_cache()
    return out


def phase_cli_surface(torch, tri, gc):
    """(f) The CLI on phase 16's MARS layout: one epoch of the preset with
    --optim radam --rand-erase --rand-crop --misalign-aug --remat dots, and
    one epoch of -a vmgn --use-pose without --learn-graph, each evaluated
    at evenly; the wrappers counted."""
    from agrl_torch.cli import train_vidreid_xent_htri as cli
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.datasets.synthetic_mars import materialize_mars_layout
    from agrl_torch.engine import trainer

    build_dir = REPO / "agrl_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    preset = vmgn_args()
    runs = {
        "radam_augment_remat": ["--optim", "radam", "--rand-erase", "--rand-crop",
                                "--misalign-aug", "--remat", "dots"],
        "pose_graph": None,  # the preset without --learn-graph
    }
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root = f"{tmp}/data"
        materialize_mars_layout(root, **CLI_DATA)
        ds = init_vidreid_dataset("mars", root=root, verbose=False)
        test_batch = int(preset[preset.index("--test-batch") + 1])
        eval_batches = -(-len(ds.query) // test_batch) + -(-len(ds.gallery) // test_batch)
        for label, extra in runs.items():
            args = (without_flag(preset, "--optim") + extra if extra is not None
                    else [a for a in preset if a != "--learn-graph"])
            argv = ["-d", "mars", *args, "--root", root, "--max-epoch", "1", "--print-freq",
                    "1", "--save-dir", f"{tmp}/{label}"]
            seen, real = {}, trainer.make_train_step

            def recording(model, optimizer, lr_fn, **kw):
                seen.update(kw, model=model, optimizer=type(optimizer).__name__)
                return real(model, optimizer, lr_fn, **kw)

            trainer.make_train_step = recording
            tri.launches = tri.backward_launches = gc.launches = 0  # this run starts here
            t0 = time.perf_counter()
            try:
                _, text = run_cli_in_process(cli, argv)
            finally:
                trainer.make_train_step = real
            secs = time.perf_counter() - t0
            fwd, bwd, k1 = tri.launches, tri.backward_launches, gc.launches  # and ends here
            meters = [m.groups() for m in METER.finditer(text)]
            step_ms = [float(m[3]) * 1e3 for m in meters]
            data_ms = [float(m[4]) * 1e3 for m in meters]
            losses = [float(v) for m in meters for v in m[5:7]]
            blocks = cmc_blocks(text)
            n = len(meters)
            modes = sorted({layer.mode for layer in seen["model"].graph_layers})
            rec = dict(argv_extra=extra if extra is not None else ["(no --learn-graph)"],
                       steps=n, step_ms_median=float(np.median(step_ms[1:])) if n > 1 else None,
                       step_ms_all=step_ms, data_ms_median=float(np.median(data_ms[1:]))
                       if n > 1 else None, k3_per_step=[fwd / max(n, 1), bwd / max(n, 1)],
                       k1_per_eval_batch=k1 / eval_batches, graph_modes=modes,
                       optimizer=seen["optimizer"], remat=seen["remat"], aug=seen["aug"],
                       evals=blocks, seconds=secs)
            out[label] = rec
            log(f"[surface] cli {label}: {n} steps, Time meter median {rec['step_ms_median']} ms, "
                f"Data {rec['data_ms_median']} ms; {seen['optimizer']}, remat {seen['remat']}, "
                f"aug {seen['aug']}, graph {modes}; hard_mine {fwd}+{bwd}, K1 {k1} for "
                f"{eval_batches} eval batches; CMC (rank-1, mAP) {blocks}; {secs:.1f} s")
            ok = (n > 0 and fwd == bwd == n and k1 == 2 * eval_batches and len(blocks) == 1
                  and all(math.isfinite(v) for v in losses))
            if label == "pose_graph":
                ok = ok and modes == ["pose"]
            else:
                ok = ok and seen["optimizer"] == "RAdam" and seen["remat"] == "dots" and all(
                    seen["aug"][k] for k in ("rand_erase", "misalign_aug", "rand_translate"))
            if not ok:
                raise AssertionError(f"CLI {label}: {rec}")
    return out


def phase_train_surface(torch, tri, gc, layers_mod, device, flush):
    """Phase 23: (a) optimizers, (b) augmentations, (c) remat, (d) graph
    modes, (e) migration, (f) the CLI."""
    from agrl_torch.models import init_model

    t_phase = time.perf_counter()
    batches = surface_batches(SURFACE_STEPS, 100)
    model = build_train_model(init_model, device, seed=4)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    t0 = time.perf_counter()
    out["optimizers"] = phase_optimizers(torch, tri, model, init, batches, device)
    out["optimizers_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["augment"] = phase_augment(torch, tri, model, init, batches, device)
    out["augment_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["remat"] = phase_remat(torch, tri, model, init, batches, device)
    out["remat_seconds"] = time.perf_counter() - t0
    del model, init, batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["graph_modes"] = phase_graph_modes(torch, gc, layers_mod, device, flush)
    out["graph_modes_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["migration"] = phase_migration(torch, device)
    out["migration_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cli"] = phase_cli_surface(torch, tri, gc)
    out["cli_seconds"] = time.perf_counter() - t0
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    if not all((REPO / "agrl_torch" / "csrc" / f"{n}.cu").exists() for n in LIBS):
        print("chip_smoke.py: the agrl_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 3
    # cuBLAS's deterministic workspace, for phase 23's deterministic remat step
    # (set before the first cuBLAS call; 32 MiB, the size it has on Hopper anyway)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(REPO))
    from agrl_torch import losses as losses_mod
    from agrl_torch.models import default_num_vertices, init_model
    from agrl_torch.models import layers as layers_mod
    from agrl_torch.ops import graph_conv as gc
    from agrl_torch.ops import minsum as ms
    from agrl_torch.ops import rank
    from agrl_torch.ops import rerank as rr
    from agrl_torch.ops import triplet as tri
    from agrl_torch.engine.export import FeatureExtractor
    from agrl_torch.kernels.build import build as build_library
    from agrl_torch.kernels.build import library_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = nvidia_smi_line()
    log(f"[card] nvidia-smi: {smi}; torch: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:
        list(pool.map(build_library, LIBS))
    gc._lib()
    tri._lib()
    ms._lib()
    ms._sparse_lib()
    log(f"[build] {', '.join(library_path(n).name for n in LIBS)} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in LIBS:
        for line in ptxas_summary(library_path(name).with_suffix(".log").read_text()):
            log(f"[build]   {name}: {line}")

    # 3. kernel vs plain
    flush = L2Flusher(torch, device)
    krec, serving_out = phase_kernels(torch, gc, device, flush)
    # 17. K1 masked and long, at the `all` Evaluator's shapes
    k1_long = phase_k1_long(torch, gc, device, flush, serving_out)
    del serving_out
    # 8. K3 vs plain (run here, beside the other kernel checks)
    trec = phase_triplet(torch, tri, losses_mod, device, flush)
    # 12. K4 vs plain at the JAX package's test shapes
    phase_minsum_shapes(torch, ms, device)

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
    fx = FeatureExtractor(model, batch_size=BATCH, seq_len=SEQ_LEN, bf16=False, device=device)
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
    r1, mAP, reranked_eval = phase_evaluator(torch, gc, ms, model, device)
    serving.update(eval_rank1=r1, eval_mAP=mAP)

    # 18. dense, skipdense and all evaluation
    t0 = time.perf_counter()
    evaluation = phase_eval_strategies(torch, layers_mod, gc, model, device)
    evaluation["phase_seconds"] = time.perf_counter() - t0

    # 19. bf16 serving: the default FeatureExtractor and three model dtypes
    t0 = time.perf_counter()
    serving["bf16"], bf16_outs = phase_bf16_serving(torch, gc, layers_mod, model, fx, device)
    serving["bf16"]["phase_seconds"] = time.perf_counter() - t0
    # 20. the artifact, served by a process with no model code
    t0 = time.perf_counter()
    serving["artifact"] = phase_artifact(torch, model, bf16_outs,
                                         serving["bf16"]["request16_ms"], device)
    serving["artifact"]["phase_seconds"] = time.perf_counter() - t0

    # 9. the train step at the paper config, then the evaluator
    del fx, model
    torch.cuda.empty_cache()
    trained, (tri_launches, tri_backward_launches), train_batches, training = phase_train(
        torch, tri, gc, device)

    # 10. kernel path vs plain path, one train step
    training["step_kernel_vs_plain_loss_rel_err"], training[
        "step_kernel_vs_plain_grad_rel_err"] = phase_train_paths(torch, tri, losses_mod, trained)
    del trained
    torch.cuda.empty_cache()

    # 11. card vs CPU, one train step
    (training["card_vs_cpu_loss_rel_err"], training["card_vs_cpu_grad_fro_rel_err"],
     training["card_vs_cpu_grad_max_rel_err"]) = phase_train_card_vs_cpu(torch, device)
    torch.cuda.empty_cache()

    # 21. the bf16 train step on phase 9's batches and draws
    t0 = time.perf_counter()
    (bf16_tri, bf16_tri_backward), training["bf16"] = phase_train_bf16(
        torch, tri, device, train_batches, training["history"])
    training["bf16"]["phase_seconds"] = time.perf_counter() - t0
    del train_batches

    # 13. re-ranking at MARS scale (K4's main path), kernel path vs plain path
    qf, gf, ids = mars_features(torch, device)
    k4_launches, dense_launches, reranking = phase_rerank_mars(torch, ms, rr, rank, qf, gf, ids)
    # 14. K4 vs plain at the MARS shape, times and bound
    srec, mrec = phase_minsum_mars(torch, ms, rr, qf, gf, device, flush)
    del qf, gf, flush
    torch.cuda.empty_cache()
    # 15. card vs CPU vs the host algorithm
    (reranking["card_vs_cpu_max_abs_err"], reranking["card_vs_host_max_abs_err"],
     reranking["continuous_card_vs_cpu_max_abs_diff"],
     reranking["continuous_rows_beyond_2e-4"]) = phase_rerank_cpu(torch, rr, device)
    reranking["evaluator_synthetic"] = reranked_eval

    serving["smoke_seconds"] = training["smoke_seconds"] = time.perf_counter() - t_start
    reranking["smoke_seconds"] = time.perf_counter() - t_start
    # 16. the training CLI: the paper preset through the MARS catalog, then
    # --bf16-train --bf16-eval, export_model and its artifact
    cli = phase_cli(torch, tri, gc, ms)
    t0 = time.perf_counter()
    cli["bf16"] = phase_cli_bf16(torch, gc)
    cli["bf16"]["phase_seconds"] = time.perf_counter() - t0
    # 22. the CLI's host side: decoders, caches, prefetch, async checkpoints,
    # the profile, the FLOPs line, the host scorers
    host_input = phase_input(torch, tri, gc)
    # 23. the rest of the training surface: optimizers, augmentations, remat,
    # graph modes, optax-state migration, the CLI with the new flags
    surface = phase_train_surface(torch, tri, gc, layers_mod, device, L2Flusher(torch, device))

    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"reranking": reranking}))
    cli["smoke_seconds"] = time.perf_counter() - t_start
    print(json.dumps({"cli": cli}))
    evaluation["cli_k1_launches"] = cli["eval_strategies"]
    print(json.dumps({"evaluation": evaluation}))
    print(json.dumps({"input": host_input}))
    print(json.dumps({"train_surface": surface}))
    kernel = {
        "name": "graph_propagate",
        "route": "cuda",
        "source": "agrl_torch/csrc/graph_conv.cu",
        "replaces": "agrl_tpu/ops/graph_conv.py:127",
        "also_replaces": "agrl_tpu/ops/graph_conv_v2.py:102",
        "launches": launches,
        "cli_launches_per_eval_batch": cli["k1_per_eval_batch"],
        "input_cli_launches_per_eval_batch": {k: v["k1_per_eval_batch"]
                                              for k, v in host_input["cli"].items()},
        "max_abs_err": krec["max_abs_err"],
        "ms": krec["ms"],
        "kernel_ms": krec["ms"],
        "plain_ms": krec["plain_ms"],
        "bound_ms": krec["bound_ms"],
        "bound_by": krec["bound_by"],
        "fp32_fma_bound_ms": krec["fp32_fma_bound_ms"],
        "float64_rel_err": krec["float64_rel_err"],
        "plain_float64_rel_err": krec["plain_float64_rel_err"],
        "precision": "f@W in 3xTF32 (wgmma.m64n128k8 tf32, TMA ring, fp32 accumulators); "
                     "Gram, G@h fp32",
        "library_ms": krec["library_ms"],
        "library_call": "torch.matmul(f, W): the f@W product alone",
        "v2_max_abs_err": krec["v2_max_abs_err"],
        "v2_ms": krec["v2_ms"],
        "shape": "B=16 V=56 C=2048 fp32",
        "masked_and_long": [{k: v for k, v in r.items() if k != "kernels"} for r in k1_long],
        "masked_and_long_timing": "CUDA events around one call, L2 flushed: kernel mean of 20 "
                                  "(5 at V >= 1064), plain of 5 (2), library torch.bmm(G, h) "
                                  "alone; max_rel_err = max|kernel - plain| / max|plain|",
        "eval_launches": {s: evaluation[s]["k1_launches"] for s in ("dense", "skipdense", "all")},
        "bf16_serving_launches": serving["bf16"]["launches"],
        "bf16_eval_launches_per_chunk": {k: v["k1_per_chunk"]
                                         for k, v in serving["bf16"]["models"].items()},
        "artifact_launches": serving["artifact"]["launches"],
        "graph_modes": {m: {k: v for k, v in r.items()} for m, r in
                        surface["graph_modes"].items()},
        "graph_modes_note": "phase 23: model_launches per 16-clip eval forward of VMGN built "
                            "with the mode's flags; ms, plain_ms: "
                            "CUDA events, L2 flushed, at B=16 V=56 C=2048; bound without the "
                            "Gram where the mode has none",
        "surface_cli_launches_per_eval_batch": {k: v["k1_per_eval_batch"]
                                                for k, v in surface["cli"].items()},
        "cli_bf16_artifact_launches": cli["bf16"]["artifact_k1_launches"],
        "v2_launches_on_paths": serving["bf16"]["v2_launches"] + sum(
            v["k2_per_chunk"] for v in serving["bf16"]["models"].values()),
        "v2_note": "K2's entry (graph_propagate_v2) takes bf16 vertex features; no VMGN path "
                   "gives the graph layers bf16 features (the pyramid pooling matrix is "
                   "float32, as agrl_tpu's numpy constant, and promotes them), so the bf16 "
                   "eval's bf16-rounded weights and adjacency go to K1, widened",
        "slower_than_plain": slower_than_plain(
            ("B=16 V=56", krec["ms"], krec["plain_ms"]),
            *((f"B={r['B']} V={r['V']}{' masked' if r['masked'] else ''}", r["ms"], r["plain_ms"])
              for r in k1_long)),
    }
    triplet = {
        "name": "hard_mine",
        "kernels": list(TRIPLET_KERNELS),
        "route": "cuda",
        "source": "agrl_torch/csrc/triplet.cu",
        "replaces": "agrl_tpu/ops/triplet.py:48",
        "heads": TRAIN_HEADS,
        "launches": tri_launches,
        "backward_launches": tri_backward_launches,
        "cli_launches_per_step": cli["k3_per_step"],
        "input_cli_launches_per_step": {k: v["k3_per_step"]
                                        for k, v in host_input["cli"].items()},
        "bf16_train_launches": bf16_tri,
        "optimizer_launches_per_step": {k: v["k3_per_step"]
                                        for k, v in surface["optimizers"].items()},
        "augment_launches_per_step": surface["augment"]["steps"]["k3_per_step"],
        "remat_launches_per_step": {k: v["k3_per_step"] for k, v in surface["remat"].items()},
        "surface_cli_launches_per_step": {k: v["k3_per_step"]
                                          for k, v in surface["cli"].items()},
        "bf16_train_backward_launches": bf16_tri_backward,
        "max_abs_err": trec["max_abs_err"],
        "grad_max_abs_err": trec["grad_max_abs_err"],
        "two_calls_bit_equal": trec["two_calls_bit_equal"],
        "ms": trec["ms"],
        "plain_ms": trec["plain_ms"],
        "bound_ms": trec["bound_ms"],
        "bound_by": trec["bound_by"],
        "backward_ms": trec["backward_ms"],
        "plain_backward_ms": trec["plain_backward_ms"],
        "backward_bound_ms": trec["backward_bound_ms"],
        "backward_bound_by": trec["backward_bound_by"],
        "library_ms": trec["library_ms"],
        "library_call": "torch.cdist(F, F) on the stacked (5, 16, 2048) heads: the distances "
                        "alone",
        "term_ms": trec["term_ms"],
        "term_kernels": trec["term_kernels"],
        "term_call_ms": trec["term_call_ms"],
        "per_head_term_ms": trec["per_head_term_ms"],
        "per_head_term_kernels": trec["per_head_term_kernels"],
        "per_head_term_call_ms": trec["per_head_term_call_ms"],
        "parent_term_ms": trec["parent_term_ms"],
        "parent_term_kernels": trec["parent_term_kernels"],
        "parent_term_call_ms": trec["parent_term_call_ms"],
        "parent_term_note": "the earlier design's structure rebuilt in this run: one forward "
                            "launch per head (this tree's kernel at H = 1) and the plain "
                            "backward",
        "launch_floor_ms": trec["launch_floor_ms"],
        "timing": "ms, backward_ms, plain_*, library_ms, *term_ms: device time per call "
                  "(torch.profiler, L2 warm); *_call_ms, launch_floor_ms: CUDA events around "
                  "one call with the L2 flushed, host dispatch included; *term*: loss forward "
                  "and backward over the 5 heads; *_kernels: device operations per term",
        "call_ms": trec["call_ms"],
        "backward_call_ms": trec["backward_call_ms"],
        "plain_call_ms": trec["plain_call_ms"],
        "plain_backward_call_ms": trec["plain_backward_call_ms"],
        "library_call_ms": trec["library_call_ms"],
        "shape": f"H={TRAIN_HEADS} B={BATCH} D={FEATURE_DIM} fp32",
        "slower_than_plain": slower_than_plain(
            ("forward", trec["ms"], trec["plain_ms"]),
            ("backward", trec["backward_ms"], trec["plain_backward_ms"])),
    }
    min_sum = {
        "name": "min_sum",
        "route": "cuda",
        "source": "agrl_torch/csrc/minsum.cu",
        "replaces": "agrl_tpu/ops/minsum.py:59",
        "launches": dense_launches,
        "max_abs_err": mrec["max_abs_err"],
        "ms": mrec["ms"],
        "plain_ms": mrec["plain_ms"],
        "bound_ms": mrec["bound_ms"],
        "bound_by": mrec["bound_by"],
        "library_ms": mrec["library_ms"],
        "library_call": "(a.sum(1)[:, None] + b.sum(1)[None, :] - torch.cdist(a, b, p=1)) / 2",
        "timing": "CUDA events around one call, L2 flushed; kernel mean of 5, plain of 2, "
                  "library of 3",
        "dense_bound_ms": mrec["dense_bound_ms"],
        "terms_needed": mrec["terms_needed"],
        "terms_dense": mrec["terms_dense"],
        "uniform_rel_err": mrec["uniform_rel_err"],
        "library_max_abs_err": mrec["library_max_abs_err"],
        "shape": f"Q={MARS_Q} J=C={MARS_Q + MARS_G} fp32, the re-ranking's membership v "
                 f"({mrec['v_nonzero_share']:.3%} non-zero)",
        "note": "the dense entry; re-ranking calls min_sum_sparse",
        "slower_than_plain": slower_than_plain(("MARS v", mrec["ms"], mrec["plain_ms"])),
    }
    min_sum_sparse = {
        "name": "min_sum_sparse",
        "route": "cuda",
        "source": "agrl_torch/csrc/minsum_sparse.cu",
        "replaces": "agrl_tpu/ops/minsum.py:59",
        "launches": k4_launches,
        "cli_launches_per_rerank_eval": cli["k4_per_rerank_eval"],
        "max_abs_err": srec["max_abs_err"],
        "ms": srec["ms"],
        "plain_ms": srec["plain_ms"],
        "bound_ms": srec["bound_ms"],
        "bound_by": srec["bound_by"],
        "library_ms": srec["library_ms"],
        "library_call": "(a.sum(1)[:, None] + b.sum(1)[None, :] - torch.cdist(a, b, p=1)) / 2",
        "timing": "CUDA events around the whole call (counts, scans, one read-back, CSR fill, "
                  "sort, accumulation), L2 flushed, mean of 5",
        "host_order_max_abs_err": srec["host_order_max_abs_err"],
        "host_order_bit_equal": srec["host_order_bit_equal"],
        "two_calls_bit_equal": srec["two_calls_bit_equal"],
        "terms_needed": srec["terms_needed"],
        "shape": min_sum["shape"],
        "slower_than_plain": slower_than_plain(("MARS v", srec["ms"], srec["plain_ms"])),
    }
    print(json.dumps({"kernels": [kernel, triplet, min_sum, min_sum_sparse]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--term-only"] and len(sys.argv) == 3:
        sys.exit(main_term_only(Path(sys.argv[2]).resolve()))
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--term-only ROOT]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
