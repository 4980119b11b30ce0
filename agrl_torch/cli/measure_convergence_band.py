"""Measure the discriminative MARS-layout recipe's converged retrieval band
(the counterpart of agrl_tpu's tools/measure_convergence_band.py).

Trains agrl_tpu's convergence recipe (tests/test_convergence.py's
`trained_on_discriminative`) across seeds and scores each run with the
evenly, dense and all evaluators:

  * fixture: `materialize_mars_layout` with 6 train and 16 test ids, 2
    cameras, 2 tracklets a camera, 6-12 frames of 128x64, seed 3;
  * model: vmgn_tiny, --num-split 4 --pyramid-part, num_gb 1, pose and
    learned graph;
  * clips: seq_len 4 at 64x32, restricted sampling; batches of 8 (2
    instances) from RandomIdentitySamplerV1 and a one-worker ClipLoader,
    both seeded with the run's seed;
  * Adam lr 1e-3, weight decay 5e-4; label smoothing, soft-margin
    triplet, flips; 10 epochs (one step each on this fixture);
  * scoring: evenly (loader batch 8), dense and all (loader batch 1),
    clip_batch 8, cosine distance, the mars protocol.

The model's init comes from `init_model(seed=)` and the flips from a
torch.Generator(seed + 1). Then one INJECTED loss mis-wiring at the first
seed, `no_htri` (lambda_htri = 0: the triplet term dropped, the reference's
loss wiring train_vidreid_xent_htri.py:400-408), which a regression floor
anchored on the first seed's score must catch. The first seed is trained
twice and both scores are kept (`reproduced`).

    python -m agrl_torch.cli.measure_convergence_band [seeds ...] [--device cpu] [--out PATH]

Seeds default to 0 1 2 4. The run is on the card unless --device cpu is
given, and raises without one. It writes agrl_tpu's JSON layout
(`seeds`, `injected`, `summary`) plus `device` (the device, and on a card
its name and power limit as nvidia-smi prints them) and `reproduced`, by
default to agrl_torch/cli/convergence_band.json, which
tests/test_torch_convergence.py and chip_smoke.py's convergence phase
read. Runs on the card take deterministic cuDNN and cuBLAS algorithms
(`deterministic`), so that a run repeats its losses bit for bit: without
them two runs of one seed on one card differ in their losses (PERF.md
records by how much).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from agrl_torch import resolve_device

S, H, W = 4, 64, 32
EPOCHS = 10
SAMPLES = ("evenly", "dense", "all")
DEFAULT_SEEDS = (0, 1, 2, 4)
BAND_PATH = osp.join(osp.dirname(osp.abspath(__file__)), "convergence_band.json")
# the regression tripwire's margin around the first seed's score
# (agrl_tpu tests/test_convergence.py SUBSTRATE_MARGIN)
SUBSTRATE_MARGIN = 0.05


def build_fixture(root):
    """The MARS-layout fixture under `root`, loaded by the mars catalog."""
    from agrl_torch.data.datasets import init_vidreid_dataset
    from agrl_torch.data.datasets.synthetic_mars import materialize_mars_layout

    materialize_mars_layout(
        root, num_train_pids=6, num_test_pids=16, num_cams=2,
        tracklets_per_cam=2, frames_range=(6, 12),
        height=128, width=64, seed=3,
    )
    return init_vidreid_dataset("mars", root=root, use_pose=True, verbose=False)


def _clip_kw(ds) -> dict:
    return dict(height=H, width=W, pose_info=ds.process_poses, num_split=4,
                pyramid_part=True, enable_pose=True)


def train_loader(ds, seed):
    """The recipe's P x K train loader: batches of 8, 2 instances."""
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.data.samplers import init_sampler

    train_ds = VideoClipDataset(ds.train, seq_len=S, sample="restricted", **_clip_kw(ds))
    sampler = init_sampler("RandomIdentitySamplerV1", ds.train, 8, 2, seed=seed)
    return ClipLoader(train_ds, batch_size=8, sampler=sampler, drop_last=True,
                      num_workers=1, seed=seed)


def build_model(ds, seed, device):
    from agrl_torch.models import init_model

    return init_model(
        "vmgn_tiny", num_classes=ds.num_train_pids, loss={"xent", "htri"},
        num_split=4, pyramid_part=True, num_gb=1, use_pose=True,
        learn_graph=True, device=device, seed=seed,
    )


@contextmanager
def deterministic(on: bool):
    """Deterministic cuDNN and cuBLAS algorithms (and any other op that has
    one) while inside; the process's settings are restored after. cuBLAS
    needs CUBLAS_WORKSPACE_CONFIG set before its first call in the
    process: a caller that set none gets ":4096:8" here."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[2:]


def train_once(ds, seed, lambda_htri=1.0, *, device="cuda", variables=None, flips=None):
    """Trains the recipe once; returns (model, history), history one
    {loss, xent_loss, htri_loss, top1} dict of floats a step.

    `variables` (numpy, agrl_tpu's layout) replace the seeded init through
    `from_jax_variables`; `flips` (one (8,) bool array a step) replace the
    draws of torch.Generator(seed + 1). On the card the run takes
    deterministic algorithms (`deterministic`), so it repeats its bits."""
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.weight_convert import from_jax_variables
    from agrl_torch.optim import init_optim

    dev = resolve_device(device)
    loader = train_loader(ds, seed)
    model = build_model(ds, seed, dev)
    if variables is not None:
        from_jax_variables(variables, model)
    opt = init_optim("adam", model.parameters(), 1e-3, weight_decay=5e-4)
    step = make_train_step(model, opt, lambda s: 1e-3, label_smooth=True, soft_margin=True,
                           lambda_htri=lambda_htri, aug={"flip_aug": True})
    gen = torch.Generator().manual_seed(seed + 1)
    history = []
    with deterministic(dev.type == "cuda"):
        for _ in range(EPOCHS):
            for imgs, pids, _, adjs in loader:
                flip = None if flips is None else flips[len(history)]
                metrics = step(imgs, pids, adjs, generator=gen, flip=flip)
                history.append({k: float(v) for k, v in metrics.items()})
    if not all(np.isfinite(list(h.values())).all() for h in history):
        raise FloatingPointError(f"non-finite losses: {history}")
    return model, history


def eval_loaders(ds, sample):
    """(query, gallery) loaders of the recipe's scoring: batches of 8
    tracklets under evenly, one under dense, skipdense and all."""
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset

    bs = 1 if sample in ("dense", "skipdense", "all") else 8
    return tuple(
        ClipLoader(VideoClipDataset(split, seq_len=S, sample=sample, **_clip_kw(ds)),
                   batch_size=bs, num_workers=1)
        for split in (ds.query, ds.gallery))


def score(model, ds, sample, *, device="cuda"):
    """(rank-1, mAP) of `model` under `sample`: cosine, mars protocol,
    clip_batch 8."""
    from agrl_torch.engine.evaluator import Evaluator

    q, g = eval_loaders(ds, sample)
    ev = Evaluator(model, test_sample=sample, clip_batch=8, device=device)
    rank1, mAP = ev.evaluate(q, g, dist_metric="cosine", metric_protocol="mars")
    return float(rank1), float(mAP)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def summarize(out: dict) -> dict:
    """agrl_tpu's summary of the seeds: evenly mAP mean, sigma (ddof 1),
    min, max, and the largest |dense - evenly| and |all - evenly| mAP."""
    recs = list(out["seeds"].values())
    maps = np.array([r["evenly"]["mAP"] for r in recs])
    return {
        "evenly_mAP_mean": round(float(maps.mean()), 4),
        "evenly_mAP_sigma": round(float(maps.std(ddof=1)), 4) if len(maps) > 1 else 0.0,
        "evenly_mAP_min": round(float(maps.min()), 4),
        "evenly_mAP_max": round(float(maps.max()), 4),
        **{f"{s}_vs_evenly_max_delta": round(float(max(
            abs(r[s]["mAP"] - r["evenly"]["mAP"]) for r in recs)), 4) for s in ("dense", "all")},
    }


def band_limits(band: dict) -> tuple:
    """(golden, floor, ceiling) of a band: seed 0's evenly mAP, it minus
    SUBSTRATE_MARGIN, and min(0.995, it plus the margin), as agrl_tpu's
    golden_band derives them."""
    golden = band["seeds"]["0"]["evenly"]["mAP"]
    return golden, golden - SUBSTRATE_MARGIN, min(0.995, golden + SUBSTRATE_MARGIN)


def measure(ds, seeds, device) -> dict:
    dev = resolve_device(device)
    out = {"seeds": {}, "injected": {}, "reproduced": {}}
    for i, seed in enumerate(seeds):
        t0 = time.monotonic()
        model, _ = train_once(ds, seed, device=dev)
        rec = {}
        for sample in SAMPLES:
            r1, mAP = score(model, ds, sample, device=dev)
            rec[sample] = {"rank1": round(r1, 4), "mAP": round(mAP, 4)}
        rec["train_s"] = round(time.monotonic() - t0, 1)
        out["seeds"][str(seed)] = rec
        print(f"[band] seed {seed}: {rec}", flush=True)
        if i == 0:  # the golden seed again: does this device reproduce it?
            model, _ = train_once(ds, seed, device=dev)
            r1, mAP = score(model, ds, "evenly", device=dev)
            out["reproduced"] = {"seed": seed, "runs": [rec["evenly"], {
                "rank1": round(r1, 4), "mAP": round(mAP, 4)}]}
            print(f"[band] seed {seed} again: evenly rank1 {r1:.4f} mAP {mAP:.4f}", flush=True)

    # the injected loss mis-wiring: the triplet term dropped, first seed
    t0 = time.monotonic()
    model, _ = train_once(ds, seeds[0], lambda_htri=0.0, device=dev)
    r1, mAP = score(model, ds, "evenly", device=dev)
    out["injected"]["no_htri"] = {"rank1": round(r1, 4), "mAP": round(mAP, 4),
                                  "train_s": round(time.monotonic() - t0, 1)}
    print(f"[band] injected no_htri: {out['injected']['no_htri']}", flush=True)
    out["summary"] = summarize(out)
    out["device"] = {"type": dev.type, "deterministic": dev.type == "cuda"}
    if dev.type == "cuda":
        out["device"].update(name=torch.cuda.get_device_name(dev), nvidia_smi=card_line())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("seeds", nargs="*", type=int, default=list(DEFAULT_SEEDS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=BAND_PATH, help="where the band's JSON goes")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card: raise before any data is written
    with tempfile.TemporaryDirectory(prefix="band_") as root:
        ds = build_fixture(osp.join(root, "d"))
        out = measure(ds, args.seeds, args.device)
    print(json.dumps(out, indent=1))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
