"""The training/eval CLI — the counterpart of agrl_tpu's
cli/train_vidreid_xent_htri.py (and of the reference's
train_vidreid_xent_htri.py), on the card:

    python -m agrl_torch.cli.train_vidreid_xent_htri -d mars "${VMGN_ARGS[@]}" ...

The parser is agrl_tpu's, flag for flag (names, defaults, types, choices),
so the scripts in scripts/ invoke it unchanged. What the port does not
take yet is refused up front by `preflight`, before any data is read,
with the ROADMAP item that will port it; flags with no meaning here
(`--compile-cache-dir`, `--gpu-devices`, `--use-avai-gpus`) parse and do
nothing. The run goes to the card unless `--use-cpu`; without a card it
raises, it never carries on on the CPU.

Call order (agrl_tpu's `run`): seeds -> log tee -> catalog -> frame
caches and decoder -> loaders -> model (params and FLOPs line) ->
(pretrained | load-weights | resume: a port checkpoint, or an agrl_tpu
.msgpack with its optax state) -> schedules -> epoch loop with
periodic eval and checkpoints (`--async-ckpt`: written behind the next
epoch), the first epoch under `--profile-dir`'s profiler. Train batches
are built and copied to the card behind the step (`prefetch_to_device`).
Every train step goes through the batch-hard mining kernels (K3), every
eval batch through the graph kernel (K1), and `--re-rank` through
`min_sum_sparse` (K4).

Data and tensor parallelism (agrl_tpu's --mesh-dp, --mesh-mp and --dist-*
flags, its CLI :209-245, :486-524): W processes, one card each, started
by torchrun

    torchrun --nproc-per-node W -m agrl_torch.cli.train_vidreid_xent_htri \
        [--mesh-mp MP] ...

or each with --dist-coordinator HOST:PORT --dist-num-processes W
--dist-process-id I (gloo under --use-cpu; NCCL on cards, one card a
process, never gloo). They form one process group
(parallel.initialize_distributed) whose mesh is dp x mp, dp = W / MP
(parallel.make_mesh; MP must divide W): each dp index loads its slice of
every train batch (ClipLoader's process_shard), the mp ranks of one dp
index the same slice; the step is agrl_tpu's on the global batch
(engine/trainer.py); at MP > 1 the wide Linears and their optimizer
state are sharded over mp (parallel.place_state, agrl_tpu's placement)
once the run's state is whole (fresh, or resumed). Every rank evaluates
the whole query and gallery with the weights gathered whole and the
batches split over dp, so every rank prints the same results; before
each checkpoint every rank joins the gather of the shards
(core.fetch_global_state), and rank 0 writes the file a run without mp
writes. Each process logs to its own file (`-proc{r}` for r > 0);
args.json, the scalars and the checkpoints come from rank 0 alone. With
no --dist-* flag and no torchrun variables no process group is made.
"""

from __future__ import annotations

import argparse
import datetime
from contextlib import closing
import inspect
import os.path as osp
import shutil
import sys
import time
import zipfile

import numpy as np
import torch

# agrl_tpu's model registry (agrl_tpu/models/__init__.py), the choices of
# -a; the port builds all of it (models/__init__.py). An arch of the
# registry not yet ported would be refused by its ROADMAP item through
# UNPORTED_ARCHS and _refuse
ARCH_NAMES = (
    "vmgn", "gsta", "ganet", "msppn", "msppgn", "sta", "simple_sta", "res50tp",
    "resnet50_s1", "vmgn_tiny", "res50tp_legacy", "res50ta", "res50rnn", "resnet3d50",
    "resnet3dt",
)
UNPORTED_ARCHS: dict[str, str] = {}
PROTOCOL = "mars"  # the reference's train script always scores with evaluate_mars (:531)


def build_parser() -> argparse.ArgumentParser:
    from agrl_torch.data import datasets as data_manager

    p = argparse.ArgumentParser(
        description="Train video re-id model with xent + htri losses (PyTorch, CUDA)"
    )
    # Datasets
    p.add_argument("--root", type=str, default="data")
    p.add_argument("-d", "--dataset", type=str, default="mars", choices=data_manager.get_names())
    p.add_argument("-j", "--workers", default=8, type=int,
                   help="threads decoding the frames of a batch")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--seq-len", type=int, default=15)
    p.add_argument("--split-id", type=int, default=0)
    p.add_argument("--download", action="store_true",
                   help="auto-download the dataset when missing (iLIDS-VID "
                        "only, reference ilidsvid.py:119-133); requires "
                        "network access")
    p.add_argument("--train-batch", default=32, type=int)
    p.add_argument("--test-batch", default=5, type=int)
    p.add_argument("--clip-batch", default=64, type=int,
                   help="device batch of clips for dense/skipdense eval (clips pack "
                        "across tracklets); --test-sample all batches up to "
                        "clip_batch * 8 frames; evenly eval batches by --test-batch")
    p.add_argument("--num-instances", type=int, default=4)
    p.add_argument("--train-sample", default="restricted",
                   choices=["evenly", "random", "consecutive", "restricted"])
    p.add_argument("--test-sample", default="dense",
                   choices=["evenly", "all", "dense", "skipdense"],
                   help="eval clips: evenly (one clip a tracklet, batches of --test-batch), "
                        "dense/skipdense (every frame in clips, pooled by --pool) or all "
                        "(whole tracklets, length-bucketed with a frame mask)")
    p.add_argument("--train-sampler", default="RandomIdentitySampler")
    # Optimization
    p.add_argument("--optim", type=str, default="adam",
                   help="adam, amsgrad, sgd, nesterov, rmsprop, adabound or radam")
    # Loss
    p.add_argument("--margin", type=float, default=0.3)
    p.add_argument("--soft-margin", action="store_true")
    p.add_argument("--lambda-xent", type=float, default=1)
    p.add_argument("--lambda-htri", type=float, default=1)
    p.add_argument("--label-smooth", action="store_true")
    # LR schedule
    p.add_argument("--max-epoch", default=600, type=int)
    p.add_argument("--lr", "--learning-rate", default=0.0003, type=float)
    p.add_argument("--stepsize", default=[200, 400], nargs="+", type=int)
    p.add_argument("--gamma", default=0.1, type=float)
    p.add_argument("--weight-decay", default=5e-04, type=float)
    p.add_argument("--zero-wd", type=int, default=-1,
                   help="weight decay 0 from this epoch on (> 0)")
    p.add_argument("--warmup", action="store_true")
    # Architecture
    p.add_argument("-a", "--arch", type=str, default="vmgn", choices=list(ARCH_NAMES),
                   help="agrl_tpu's video registry, all ported")
    p.add_argument("--pool", type=str, default="avg", choices=["avg", "max"])
    p.add_argument("--last-stride", type=int, default=1, choices=[1, 2])
    p.add_argument("--num-split", type=int, default=4)
    p.add_argument("--num-parts", type=int, default=3)
    p.add_argument("--num-gb", type=int, default=2)
    p.add_argument("--num-scale", type=int, default=1)
    p.add_argument("--pyramid-part", action="store_true")
    p.add_argument("--use-pose", action="store_true")
    p.add_argument("--learn-graph", action="store_true")
    p.add_argument("--knn", default=16, type=int)
    p.add_argument("--consistent-loss", action="store_true")
    p.add_argument("--bnneck", action="store_true", help="accepted; VMGN always has BNNecks")
    # Augmentation
    p.add_argument("--flip-aug", action="store_true")
    p.add_argument("--rand-erase", action="store_true",
                   help="random erasing, per frame, after the normalization")
    p.add_argument("--rand-crop", action="store_true",
                   help="a random 240x120-of-256x128 window per clip, stretched back")
    p.add_argument("--misalign-aug", action="store_true",
                   help="crop or edge-pad 5%% of the height at the top or bottom per clip")
    # Visualization
    p.add_argument("--visualize-ranks", action="store_true")
    # Post process
    p.add_argument("--dist-metric", type=str, default="euclidean")
    p.add_argument("--re-rank", action="store_true")
    # Checkpoint
    p.add_argument("--resume", type=str, default="", metavar="PATH",
                   help="an agrl_torch checkpoint (.pth.tar) or an agrl_tpu one "
                        "(.msgpack + .json): weights, optimizer state, epoch")
    p.add_argument("--load-weights", type=str, default="",
                   help="shape-filtered weight load: a torch state dict (.pth/.pth.tar/"
                        ".npz/.npy, reference names) or an agrl_tpu .msgpack checkpoint")
    p.add_argument("--pretrained-weights", type=str, default="", metavar="PATH",
                   help="torchvision-style ImageNet ResNet weights (.pth/.pth.tar/"
                        ".npz) loaded into the backbone at startup — the reference's "
                        "init_pretrained_weights (vmgn.py:360-370), incl. the vmgn "
                        "layer4 -> layer4_1/layer4_2 duplication")
    # Evaluation
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--eval-step", type=int, default=-1)
    p.add_argument("--start-eval", type=int, default=0)
    # Devices: one card a process; the dp axis is the process group
    p.add_argument("--mesh-dp", type=int, default=0,
                   help="data-parallel devices: one process per card, so 0 (the world "
                        "size) or the world size")
    p.add_argument("--mesh-mp", type=int, default=1,
                   help="model-parallel devices: processes sharing a dp index, over "
                        "which the wide Linears shard; must divide the process count")
    p.add_argument("--dist-coordinator", type=str, default="",
                   help="HOST:PORT of process 0 of a multi-process run")
    p.add_argument("--dist-num-processes", type=int, default=0,
                   help="processes of a multi-process run (one card each)")
    p.add_argument("--dist-process-id", type=int, default=-1,
                   help="this process's index in a multi-process run")
    p.add_argument("--bf16-eval", action="store_true",
                   help="evaluate with bf16-rounded weights, pixels and adjacency "
                        "(agrl_tpu's bf16 eval; the model computes at its own dtype)")
    p.add_argument("--bf16-train", action="store_true",
                   help="mixed precision: the trunk and layer4 compute in bf16 from "
                        "float32 parameters; graph layers, heads and losses in float32")
    p.add_argument("--profile-dir", type=str, default="",
                   help="profile the first training epoch with torch.profiler (CPU and "
                        "CUDA activities) and write its Chrome trace and op table here")
    p.add_argument("--remat", type=str, default="none", choices=["none", "dots", "full"],
                   help="gradient rematerialization of the model forward: none, dots "
                        "(products saved, the rest recomputed) or full (nothing saved)")
    p.add_argument("--cache-frames", action="store_true",
                   help="keep decoded frames, deterministic eval items and collated eval "
                        "batches in one byte-capped RAM LRU shared by the three loaders")
    p.add_argument("--cache-gb", type=float, default=None,
                   help="budget of --cache-frames in GB (default: 8, raised to hold the "
                        "evenly eval batches when host RAM allows; <= 0: unbounded)")
    p.add_argument("--frame-cache-dir", type=str, default="",
                   help="persistent decoded-frame store (agrl_tpu's layout): decode is "
                        "paid once per machine")
    p.add_argument("--decode", type=str, default="auto", choices=["auto", "native", "pil"],
                   help="frame decoder: auto = the native libjpeg decoder when it builds, "
                        "PIL otherwise; pil = the reference's pixels; native = the native "
                        "decoder or an error")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints on a background thread from a device snapshot")
    p.add_argument("--use-cpu", action="store_true")
    p.add_argument("--compile-cache-dir", type=str, default="auto",
                   help="XLA compilation cache of agrl_tpu: no effect in PyTorch")
    p.add_argument("--gpu-devices", default="0", type=str,
                   help="(compat, no effect: the run takes the current CUDA device)")
    p.add_argument("--use-avai-gpus", action="store_true", help="(compat, no effect)")
    # Misc
    p.add_argument("--print-freq", type=int, default=200)
    p.add_argument("--print-last", action="store_true")
    p.add_argument("--seed", type=int, default=0xFF)
    p.add_argument("--save-dir", type=str, default="log")
    return p


def _refuse(flag: str, value, item: str, hint: str = "") -> None:
    raise SystemExit(
        f"{flag} {value!r} is not ported to agrl_torch yet (ROADMAP {item})"
        + (f"; {hint}" if hint else "")
    )


def process_count(args) -> int:
    """The processes of this run: --dist-num-processes, torchrun's
    WORLD_SIZE, or 1 (no process group)."""
    import os

    from agrl_torch.parallel import torchrun_environment

    if args.dist_num_processes:
        return args.dist_num_processes
    if torchrun_environment():
        return int(os.environ["WORLD_SIZE"])
    return 1


def distributed_run(args) -> bool:
    """Whether this run makes a process group: a --dist-* flag or torchrun."""
    from agrl_torch.parallel import torchrun_environment

    return args.dist_num_processes > 0 or torchrun_environment()


def preflight(args) -> None:
    """Refuses, before any data is read or weight made, what the port does
    not take: each SystemExit names the flag, its value and the ROADMAP
    item that will port it, or an unknown optimizer, which agrl_tpu
    refuses only after reading the data. A multi-process run needs the
    three --dist-* flags together (or torchrun's environment), a --mesh-mp
    that divides the process count W, a --mesh-dp of 0 or W / mp and a
    --train-batch that divides over the dp ranks (agrl_tpu's multi-host
    branch, its CLI :499-505). Then
    agrl_tpu's graph layout check (its CLI :367-394), on the model built
    on the meta device: a
    model that reads a multi-scale adjacency (`expected_adj_scales`, msppgn
    with --use-pose or without --learn-graph) needs that --num-scale and
    the data side's parts per frame. Without --use-cpu it also refuses what
    the card's kernels would refuse later (ROADMAP C, limits): K3 mines any
    batch, head count and width up to its grid dimensions (65535 heads,
    65535 x 16 clips) and its long schedule's partials in the card's memory
    (about B^2 / 4 bytes a head for a --train-batch B above 256)."""
    from agrl_torch.models import build_model, get_names
    from agrl_torch.optim import OPTIMIZER_NAMES
    from agrl_torch.ops.triplet import MAX_BATCH, MAX_HEADS, hard_mine_scratch_bytes
    from agrl_torch.utils.reidtools import calc_splits

    if args.arch not in get_names():
        _refuse("-a/--arch", args.arch, UNPORTED_ARCHS[args.arch], f"ported: {get_names()}")
    if args.optim not in OPTIMIZER_NAMES:
        raise SystemExit(f"--optim {args.optim!r}: unsupported optimizer; choices "
                         f"{OPTIMIZER_NAMES}")
    dist_flags = (("--dist-coordinator", args.dist_coordinator, ""),
                  ("--dist-num-processes", args.dist_num_processes, 0),
                  ("--dist-process-id", args.dist_process_id, -1))
    given = [(flag, value) for flag, value, unset in dist_flags if value != unset]
    if given and len(given) < len(dist_flags):
        missing = [flag for flag, value, unset in dist_flags if value == unset]
        raise SystemExit(f"{given[0][0]} {given[0][1]!r}: a multi-process run takes "
                         "--dist-coordinator HOST:PORT, --dist-num-processes N and "
                         f"--dist-process-id I together (missing {', '.join(missing)}), "
                         "or torchrun's environment and none of them")
    if given and not 0 <= args.dist_process_id < args.dist_num_processes:
        raise SystemExit(f"--dist-process-id {args.dist_process_id!r} is not in "
                         f"[0, {args.dist_num_processes})")
    world, mp = process_count(args), args.mesh_mp
    if mp < 1 or world % mp:
        raise SystemExit(
            f"--mesh-mp {mp!r}: the mesh is dp x mp processes, one card each, and mp={mp} does "
            f"not divide this run's {world} process(es); launch a multiple of {mp} (torchrun "
            "--nproc-per-node, or the --dist-* flags)")
    dp = world // mp
    if args.mesh_dp and args.mesh_dp != dp:
        raise SystemExit(
            f"--mesh-dp {args.mesh_dp!r}: the data-parallel axis is one process per card and "
            f"this run has {world} process(es) (ROADMAP A8a) over --mesh-mp {mp}, dp={dp}; "
            f"launch {args.mesh_dp * mp} (torchrun --nproc-per-node {args.mesh_dp * mp}, or the "
            "--dist-* flags) or pass --mesh-dp 0")
    if args.train_batch % dp:
        raise SystemExit(f"--train-batch {args.train_batch!r} does not divide over the {dp} "
                         f"data-parallel ranks of this run ({world} processes over --mesh-mp "
                         f"{mp}): each takes an equal slice of every batch")
    if not args.use_cpu and args.train_batch > MAX_BATCH:
        raise SystemExit(
            f"--train-batch {args.train_batch}: the card's batch-hard mining kernel (K3) "
            f"takes at most {MAX_BATCH} clips, its grid's limit (ROADMAP C, limits); the CPU "
            "path (--use-cpu) takes it"
        )
    try:
        with torch.device("meta"):  # the structure alone: no weights are made
            model = build_model(args.arch, num_classes=1, **model_kwargs(args))
    except ValueError:
        return  # a model its flags cannot build raises where the run builds it
    model_scales = getattr(model, "expected_adj_scales", None)
    if model_scales is not None:
        if args.num_scale != model_scales:
            raise SystemExit(
                f"arch '{args.arch}' consumes a {model_scales}-scale "
                f"adjacency (vertices span layer2/3/4) but --num-scale is "
                f"{args.num_scale}; pass --num-scale {model_scales} so the "
                "pose adjacency matches the model's vertex count"
            )
        data_split = sum(calc_splits(args.num_split)) if args.pyramid_part else args.num_split
        if data_split != model.total_split:
            raise SystemExit(
                f"arch '{args.arch}' pools {model.total_split} pyramid "
                f"parts per frame (calc_splits({args.num_split})) but the "
                f"pose graph is built with {data_split}; pass "
                "--pyramid-part (and a matching --num-split) so the "
                "adjacency layout matches the model's vertices"
            )
    heads = getattr(model, "num_heads", 1)
    if not args.use_cpu and heads > MAX_HEADS:
        raise SystemExit(
            f"-a {args.arch} --num-split {args.num_split}: {heads} heads; the card's "
            f"batch-hard mining kernel (K3) mines at most {MAX_HEADS}, its grid's limit "
            "(ROADMAP C, limits); the CPU path (--use-cpu) takes them"
        )
    scratch = hard_mine_scratch_bytes(heads, args.train_batch)
    card = card_memory() if not args.use_cpu and scratch else None
    if card is not None and scratch > card:
        raise SystemExit(
            f"--train-batch {args.train_batch}: the card's batch-hard mining kernel (K3) takes "
            f"{scratch / 2**30:.1f} GiB of partials at {heads} heads, more than the card's "
            f"{card / 2**30:.1f} GiB (ROADMAP C, limits); the CPU path (--use-cpu) takes it"
        )


def card_memory():
    """Bytes of memory of the card this process runs on, or None without
    one (the run then stops where it asks for the card)."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory


def model_kwargs(args, dtype=torch.float32) -> dict:
    """The registry keywords of the run's flags, as agrl_tpu's CLI passes
    them to init_model, and the frame size, which sizes res50ta's attention
    conv at build (agrl_tpu sizes it at create_train_state from
    --height/--width)."""
    return dict(
        loss={"xent", "htri"},
        last_stride=args.last_stride,
        num_parts=args.num_parts,
        num_scale=args.num_scale,
        num_split=args.num_split,
        pyramid_part=args.pyramid_part,
        num_gb=args.num_gb,
        use_pose=args.use_pose,
        learn_graph=args.learn_graph,
        consistent_loss=args.consistent_loss,
        bnneck=args.bnneck,
        height=args.height,
        width=args.width,
        dtype=dtype,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args)


def run(args):
    """The CLI's run: (rank-1, mAP) under --evaluate, the distance matrix
    under --evaluate --visualize-ranks, None after training."""
    from agrl_torch import resolve_device
    from agrl_torch.utils.logger import Logger, ScalarWriter

    preflight(args)
    mesh = None
    if distributed_run(args):
        import torch.distributed as dist

        from agrl_torch.parallel import initialize_distributed, make_mesh

        kind = "cpu" if args.use_cpu else "cuda"
        if args.dist_num_processes:
            initialize_distributed(args.dist_coordinator, args.dist_num_processes,
                                   args.dist_process_id, device=kind)
        else:
            initialize_distributed(device=kind)
        try:
            mesh = make_mesh(dp=args.mesh_dp or None, mp=args.mesh_mp)
        except BaseException:
            dist.destroy_process_group()
            raise
    device = mesh.device if mesh is not None else resolve_device(
        "cpu" if args.use_cpu else "cuda")
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    mode = "test" if args.evaluate else "train"
    stamp = time.strftime("-%Y-%m-%d-%H-%M-%S")
    # each process its own log; the scalars from process 0 alone
    proc_tag = "" if mesh is None or mesh.rank == 0 else f"-proc{mesh.rank}"
    stdout = sys.stdout
    logger = Logger(osp.join(args.save_dir, f"log_{mode}{stamp}{proc_tag}.txt"))
    sys.stdout = logger
    writer = ScalarWriter(args.save_dir) if not proc_tag else None
    stores = []  # the run's FrameDiskCache, closed here (it holds the store's lock)
    try:
        result = _run(args, device, writer, stores, mesh)
        if mesh is not None:
            torch.distributed.barrier()  # every rank done before the group goes
        return result
    finally:
        for store in stores:
            store.close()
        sys.stdout = stdout
        logger.close()
        if writer is not None:
            writer.close()
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _run(args, device, writer, stores, mesh):
    from agrl_torch import models
    from agrl_torch.core import (
        AsyncCheckpointer,
        fetch_global_state,
        load_any_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from agrl_torch.data import datasets as data_manager
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.data.samplers import init_sampler
    from agrl_torch.engine.evaluator import Evaluator
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models.weight_convert import init_pretrained_weights
    from agrl_torch.optim import (
        init_optim,
        multistep_lr,
        per_step,
        warmup_multistep_lr,
        zero_wd_schedule,
    )
    from agrl_torch.utils.iotools import check_isfile, write_json
    from agrl_torch.utils.model_complexity import compute_model_complexity, count_num_param
    from agrl_torch.utils.profiling import trace
    from agrl_torch.utils.reidtools import visualize_ranked_results

    is_main = mesh is None or mesh.rank == 0
    print(f"==========\nArgs:{args}\n==========")
    if is_main:
        write_json(vars(args), osp.join(args.save_dir, "args.json"))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"Torch device: {device} ({name}), torch {torch.__version__}")
    if mesh is not None:
        print(f"Mesh: dp={mesh.dp} mp={mesh.mp} (process {mesh.rank} of {mesh.world}, "
              f"{torch.distributed.get_backend()})")
    # the flips and the consistent-loss subclips (agrl_tpu: PRNGKey(seed + 1))
    generator = torch.Generator().manual_seed(args.seed + 1)

    print(f"Initializing dataset {args.dataset}")
    dataset = data_manager.init_vidreid_dataset(
        root=args.root, name=args.dataset, split_id=args.split_id,
        use_pose=args.use_pose, download=args.download,
    )
    shared_cache, disk_cache = _host_input(args, dataset)
    if disk_cache is not None:
        stores.append(disk_cache)
    ds_kwargs = dict(
        height=args.height, width=args.width, pose_info=dataset.process_poses,
        num_split=args.num_split, num_parts=args.num_parts, num_scale=args.num_scale,
        pyramid_part=args.pyramid_part, enable_pose=args.use_pose,
        cache_frames=args.cache_frames, cache=shared_cache, disk_cache=disk_cache,
        decode=args.decode,
    )
    train_ds = VideoClipDataset(dataset.train, seq_len=args.seq_len, sample=args.train_sample,
                                **ds_kwargs)
    query_ds = VideoClipDataset(dataset.query, seq_len=args.seq_len, sample=args.test_sample,
                                **ds_kwargs)
    gallery_ds = VideoClipDataset(dataset.gallery, seq_len=args.seq_len,
                                  sample=args.test_sample, **ds_kwargs)
    sampler = init_sampler(
        args.train_sampler, dataset.train, args.train_batch, args.num_instances, seed=args.seed
    )
    # every rank runs the identically seeded sampler and loads its dp slice
    trainloader = ClipLoader(train_ds, batch_size=args.train_batch, sampler=sampler,
                             drop_last=True, num_workers=args.workers, seed=args.seed,
                             malloc_tuning=True,
                             process_shard=None if mesh is None else (mesh.dp_index, mesh.dp))
    # dense/skipdense/all items vary in length: one tracklet a loader batch
    test_batch = 1 if args.test_sample in ("dense", "skipdense", "all") else args.test_batch
    queryloader = ClipLoader(query_ds, batch_size=test_batch, num_workers=args.workers,
                             malloc_tuning=True)
    galleryloader = ClipLoader(gallery_ds, batch_size=test_batch, num_workers=args.workers,
                               malloc_tuning=True)

    print(f"Initializing model: {args.arch}")
    model = models.init_model(
        args.arch,
        num_classes=dataset.num_train_pids,
        device=device,
        seed=args.seed,
        **model_kwargs(args, torch.bfloat16 if args.bf16_train else torch.float32),
    )
    if is_main:
        _copy_model_source(model, args.save_dir)
    # the startup params/FLOPs line (reference train_vidreid_xent_htri.py:256-263
    # runs the same single-clip probe)
    n_params, gflops = compute_model_complexity(
        model, seq_len=args.seq_len, height=args.height, width=args.width, verbose=False)
    print(f"Model complexity: params {n_params:.5f}M flops {gflops:.3f}G")
    size_exclude = getattr(model, "size_line_exclude", ("classifier",))
    print(f"Model size: {count_num_param(model, size_exclude):.5f}M")

    if args.pretrained_weights and check_isfile(args.pretrained_weights):
        matched, skipped = init_pretrained_weights(model, args.pretrained_weights)
        print(f"Initialized backbone with ImageNet weights from "
              f"'{args.pretrained_weights}' ({len(matched)} matched, {len(skipped)} skipped)")
    if args.load_weights and check_isfile(args.load_weights):
        matched, skipped = load_any_checkpoint(model, args.load_weights)
        print(f"Loaded pretrained weights from '{args.load_weights}' "
              f"({len(matched)} matched, {len(skipped)} skipped)")

    # schedules: epoch-indexed like the reference scheduler.step(epoch);
    # RandomIdentitySamplerV1's epoch has exactly num_ids * K clips
    steps_per_epoch = max(1, len(trainloader))
    optimizer = init_optim(args.optim, model.parameters(), args.lr,
                           weight_decay=args.weight_decay)
    start_epoch, start_step = 0, 0
    best_rank1, best_mAP = -np.inf, 0.0
    if args.resume and check_isfile(args.resume):
        if zipfile.is_zipfile(args.resume):
            meta = load_checkpoint(args.resume, model, optimizer)
            start_step = (meta["epoch"] + 1) * steps_per_epoch
        else:
            meta, start_step = resume_agrl_tpu(args.resume, model, optimizer, args.optim)
        start_epoch = meta["epoch"] + 1
        best_rank1, best_mAP = meta["rank1"], meta["mAP"]
        print(f"Loaded checkpoint from '{args.resume}'")
        print(f"- start_epoch: {start_epoch}")
        print(f"- rank1: {best_rank1}")
        print(f"- mAP: {best_mAP}")
    if mesh is not None:
        from agrl_torch.parallel import replicated

        replicated(mesh, model, optimizer)  # every rank from rank 0's values

    evaluator = Evaluator(model, test_sample=args.test_sample, pool=args.pool,
                          bf16=args.bf16_eval, clip_batch=args.clip_batch, device=device)
    if args.evaluate:
        print("Evaluate only")
        result = evaluator.evaluate(
            queryloader, galleryloader, dist_metric=args.dist_metric, re_rank=args.re_rank,
            metric_protocol=PROTOCOL, return_distmat=args.visualize_ranks, mesh=mesh,
        )
        if args.visualize_ranks and is_main:
            visualize_ranked_results(
                result, dataset.query, dataset.gallery,
                save_dir=osp.join(args.save_dir, "ranked_results"), topk=20,
            )
        return result

    if args.warmup:
        lr_epoch = warmup_multistep_lr(args.lr, args.stepsize, gamma=args.gamma,
                                       warmup_factor=0.01, warmup_iters=10)
    else:
        lr_epoch = multistep_lr(args.lr, args.stepsize, gamma=args.gamma)
    if mesh is not None and mesh.mp > 1:
        from agrl_torch.parallel import place_state

        # the whole state (fresh, or resumed) to this rank's blocks
        plan = place_state(mesh, model, optimizer)
        print(f"Sharded over mp={mesh.mp}: {len(plan)} weight(s) "
              f"({', '.join(list(plan)[:4])}{', ...' if len(plan) > 4 else ''})")
    wd_epoch = zero_wd_schedule(args.weight_decay, args.zero_wd)
    # agrl_tpu's aug dict (its CLI :551-556): --rand-crop is rand_translate
    aug = dict(flip_aug=args.flip_aug, rand_erase=args.rand_erase,
               misalign_aug=args.misalign_aug, rand_translate=args.rand_crop)
    train_step = make_train_step(
        model, optimizer, per_step(lr_epoch, steps_per_epoch),
        lambda_xent=args.lambda_xent, lambda_htri=args.lambda_htri,
        label_smooth=args.label_smooth, margin=args.margin, soft_margin=args.soft_margin,
        aug=aug, start_step=start_step, remat=args.remat, mesh=mesh,
    )

    print("==> Start training")
    start_time = time.time()
    train_time = 0
    best_epoch = start_epoch
    async_ckpt = AsyncCheckpointer() if args.async_ckpt and is_main else None
    save = save_checkpoint if async_ckpt is None else async_ckpt.save
    try:
        for epoch in range(start_epoch, args.max_epoch):
            for group in optimizer.param_groups:
                group["weight_decay"] = wd_epoch(epoch)
            t0 = time.time()
            if args.profile_dir and epoch == start_epoch:
                with trace(args.profile_dir):
                    train_one_epoch(args, epoch, train_step, trainloader, generator, writer,
                                    device, mesh)
                print(f"Profile of epoch {epoch + 1} written to '{args.profile_dir}'")
            else:
                train_one_epoch(args, epoch, train_step, trainloader, generator, writer,
                                device, mesh)
            train_time += round(time.time() - t0)

            do_eval = (
                (epoch + 1) > args.start_eval
                and args.eval_step > 0
                and (epoch + 1) % args.eval_step == 0
            ) or (epoch + 1) == args.max_epoch
            if do_eval:
                print("==> Test")
                rank1, mAP = evaluator.evaluate(
                    queryloader, galleryloader, dist_metric=args.dist_metric,
                    re_rank=args.re_rank, metric_protocol=PROTOCOL, mesh=mesh,
                )
                is_best = rank1 > best_rank1
                if is_best:
                    best_rank1, best_mAP, best_epoch = rank1, mAP, epoch + 1
                state = None
                if mesh is not None and mesh.mp > 1:
                    # COLLECTIVE: every rank joins the gather of the mp shards
                    # before the rank-0 gate (agrl_tpu's CLI :610-617)
                    state = fetch_global_state(model, optimizer, fetch_local=is_main)
                if is_main:  # one checkpoint and scalar writer a job
                    save(model, optimizer,
                         osp.join(args.save_dir, f"checkpoint_ep{epoch + 1}.pth.tar"),
                         epoch, rank1=rank1, mAP=mAP, is_best=is_best, state=state)
                    writer.add_scalar("acc/rank1", rank1, epoch + 1)
                    writer.add_scalar("acc/mAP", mAP, epoch + 1)
    finally:
        if async_ckpt is not None:
            async_ckpt.close()  # the last save lands before the run reports done

    print(f"==> Best Rank-1 {best_rank1:.2%}, mAP: {best_mAP:.2%}, achieved at epoch {best_epoch}")
    elapsed = str(datetime.timedelta(seconds=round(time.time() - start_time)))
    print(f"Finished. Total elapsed time (h:m:s): {elapsed}. "
          f"Training time (h:m:s): {datetime.timedelta(seconds=train_time)}.")
    return None


def resume_agrl_tpu(fpath: str, model, optimizer, optim: str) -> tuple[dict, int]:
    """--resume of an agrl_tpu checkpoint (its CLI :467-480): the .msgpack's
    params and batch_stats into the model (every leaf, strictly), its
    optax opt_state into the optimizer, the .json sidecar's epoch and
    scores. Returns (meta, step): the step is optax's count, the updates
    the run took, where the resumed schedule goes on."""
    from agrl_torch.core.flax_msgpack import read_checkpoint
    from agrl_torch.core.optax_state import load_optax_state
    from agrl_torch.models.weight_convert import from_jax_variables

    tree, meta = read_checkpoint(fpath)
    missing = [k for k in ("params", "batch_stats", "opt_state") if k not in tree]
    if missing:
        raise SystemExit(f"--resume {fpath!r} holds no {', '.join(missing)}: not a checkpoint "
                         "of agrl_tpu's train CLI (weights alone load with --load-weights)")
    from_jax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}, model)
    step = load_optax_state(optimizer, model, tree["opt_state"], optim)
    print(f"Resumed agrl_tpu's {optim} state at step {step}")
    return meta, step


def _host_input(args, dataset):
    """The run's decoder line, the shared RAM LRU of --cache-frames and the
    --frame-cache-dir store, with agrl_tpu's startup lines (agrl_tpu's CLI
    :256-305). Returns (BoundedCache or None, FrameDiskCache or None)."""
    from agrl_torch.data import jpeg_native
    from agrl_torch.data.cache import (
        BoundedCache,
        FrameDiskCache,
        estimate_cache_gb,
        resolve_cache_budget,
    )
    from agrl_torch.data.transforms import effective_decoder

    # raises here for --decode native without the decoder, before a store opens
    decoder = effective_decoder(args.decode)
    if decoder == "native":
        print(f"Frame decoder: native (libjpeg, batched; --decode {args.decode})")
    elif args.decode == "pil":
        print("Frame decoder: PIL (--decode pil)")
    else:
        print(f"Frame decoder: PIL (--decode auto: {jpeg_native.why_unavailable()})")

    shared_cache = None
    if args.cache_frames:
        full_gb = estimate_cache_gb(
            [dataset.train, dataset.query, dataset.gallery], args.height, args.width)
        # deterministic eval loaders cache whole collated batches; repeat evals
        # are host-free only if that working set fits the budget
        eval_gb = (
            (len(dataset.query) + len(dataset.gallery))
            * args.seq_len * args.height * args.width * 3 / 1e9
            if args.test_sample == "evenly" else 0.0
        )
        cap_bytes, cap_txt = resolve_cache_budget(args.cache_gb, eval_gb)
        print(f"Frame cache: ~{full_gb:.1f} GB to hold every decoded frame "
              f"({args.height}x{args.width}); LRU budget = {cap_txt}")
        hint = (" — raise --cache-gb to keep repeat evals host-free"
                if cap_bytes and eval_gb * 1e9 > cap_bytes else "")
        if eval_gb:
            print(f"Eval batch cache: ~{eval_gb:.1f} GB holds every collated "
                  f"eval batch (evenly){hint}")
        shared_cache = BoundedCache(cap_bytes)
    disk_cache = None
    if args.frame_cache_dir:
        # tagged by this run's decoder: a store of the other decoder's pixels is
        # never served (FrameDiskCache)
        disk_cache = FrameDiskCache(args.frame_cache_dir, args.height, args.width,
                                    decoder=decoder)
        print(f"Persistent frame cache: '{args.frame_cache_dir}' "
              f"({len(disk_cache)} frames present)")
    return shared_cache, disk_cache


def _copy_model_source(model, save_dir: str) -> None:
    """Copy the architecture's source file into save_dir for provenance
    (reference models/__init__.py:37-40)."""
    from agrl_torch.utils.iotools import mkdir_if_missing

    try:
        mkdir_if_missing(save_dir)
        shutil.copy(inspect.getfile(type(model)), save_dir)
    except OSError as e:  # provenance is best-effort
        print(f"(model source copy skipped: {e})")


def train_one_epoch(args, epoch, train_step, trainloader, generator, writer, device,
                    mesh=None):
    """One epoch of train steps with agrl_tpu's meter block. The batches
    come through prefetch_to_device: built (and on the card, copied) up to
    two ahead on a thread while the step runs, so the Data meter is the
    wait for a batch the thread has not finished. The meters hold each
    step's 0-d device tensors and sync with the card only when a line
    prints; the step's time is the window's wall clock over its steps,
    measured after that sync. Under a mesh each rank holds its slice of
    the batch, the metrics are the global batch's and Speed counts the
    global batch; `writer` is None on the ranks that write no scalars."""
    from agrl_torch.data.loader import prefetch_to_device
    from agrl_torch.utils.avgmeter import AverageMeter
    from agrl_torch.utils.logger import cur_time

    xent_losses = AverageMeter()
    htri_losses = AverageMeter()
    precisions = AverageMeter()
    batch_time = AverageMeter()
    data_time = AverageMeter()

    num_batches = len(trainloader)
    end = time.time()
    window_start = time.time()
    window_batches = 0
    # closing: a step that raises stops and joins the prefetch thread
    with closing(prefetch_to_device(trainloader, size=2, device=device)) as batches:
        for batch_idx, (imgs, pids, _, adjs) in enumerate(batches):
            data_time.update(time.time() - end)
            metrics = train_step(imgs, pids, adjs, generator=generator)
            window_batches += 1

            bsz = imgs.shape[0] * (1 if mesh is None else mesh.dp)  # the global batch
            xent_losses.update(metrics["xent_loss"], bsz)
            htri_losses.update(metrics["htri_loss"], bsz)
            precisions.update(metrics["top1"])

            if ((batch_idx + 1) % args.print_freq == 0) or (
                args.print_last and batch_idx == num_batches - 1
            ):
                float(metrics["xent_loss"])  # sync: the window's steps have run
                batch_time.update((time.time() - window_start) / window_batches, window_batches)
                window_start = time.time()
                window_batches = 0
                eta_seconds = batch_time.avg * (
                    num_batches - (batch_idx + 1) + (args.max_epoch - (epoch + 1)) * num_batches
                )
                eta_str = str(datetime.timedelta(seconds=int(eta_seconds)))
                print(
                    f"CurTime: {cur_time()}\t"
                    f"Epoch: [{epoch + 1}][{batch_idx + 1}/{num_batches}]\t"
                    f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                    f"Speed {bsz / batch_time.avg:.3f} samples/s\t"
                    f"Data {data_time.val:.4f} ({data_time.avg:.4f})\t"
                    f"Xent {xent_losses.val:.4f} ({xent_losses.avg:.4f})\t"
                    f"Htri {htri_losses.val:.4f} ({htri_losses.avg:.4f})\t"
                    f"Top1 {precisions.val:.4f} ({precisions.avg:.4f})\t"
                    f"Eta {eta_str}"
                )
            end = time.time()

    if writer is not None:
        writer.add_scalar("loss/xent_loss", float(xent_losses.avg), epoch + 1)
        writer.add_scalar("loss/htri_loss", float(htri_losses.avg), epoch + 1)


if __name__ == "__main__":
    main()
