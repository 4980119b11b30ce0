"""The port's training CLI held against agrl_tpu's: the parser flag for
flag, the pre-flight refusals and the host-side flags it now takes, a CPU
run end to end at vmgn_tiny on the synthetic set (64x32, seq_len 4), and
--resume's step count and Adam state."""

import copy
import glob
import io
import os.path as osp
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from agrl_torch.cli import train_vidreid_xent_htri as tcli
from agrl_torch.optim import zero_wd_schedule
from agrl_tpu.cli import train_vidreid_xent_htri as jcli
from agrl_tpu.optim import multistep_lr as jax_multistep_lr
from agrl_tpu.optim import per_step as jax_per_step

torch.set_num_threads(2)

JAX_ACTIONS = {a.dest: a for a in jcli.build_parser()._actions}
PORT_ACTIONS = {a.dest: a for a in tcli.build_parser()._actions}


def test_parser_has_every_flag_of_agrl_tpu():
    assert len(JAX_ACTIONS) == 77  # 76 add_argument calls and -h
    assert PORT_ACTIONS.keys() == JAX_ACTIONS.keys()


@pytest.mark.parametrize("dest", sorted(JAX_ACTIONS))
def test_parser_flag_matches_agrl_tpu(dest):
    want, got = JAX_ACTIONS[dest], PORT_ACTIONS[dest]
    assert type(got) is type(want)
    assert got.option_strings == want.option_strings
    assert got.dest == want.dest
    assert got.default == want.default
    assert got.type is want.type
    assert got.nargs == want.nargs
    assert got.const == want.const
    assert (None if got.choices is None else list(got.choices)) == (
        None if want.choices is None else list(want.choices))


# the refusals: extra argv -> (flag the message names, value it names, what
# else it names)
REFUSALS = {
    # every arch of agrl_tpu's registry is ported: the legacy and 3D video
    # archs pass the arch check and are refused by the multi-process flags'
    # pre-flight, as every arch
    "arch": (["-a", "res50tp_legacy", "--mesh-dp", "2"], "--mesh-dp", "2", "ROADMAP A8a"),
    "arch_res50ta": (["-a", "res50ta", "--dist-num-processes", "2"], "--dist-num-processes",
                     "2", "together"),
    # --mesh-mp shards over the processes of one dp index: a world that mp
    # does not divide is refused, naming both
    "arch_legacy": (["-a", "res50rnn", "--mesh-mp", "2"], "--mesh-mp", "2", "1 process(es)"),
    "arch_3d": (["-a", "resnet3d50", "--dist-process-id", "1"], "--dist-process-id", "1",
                "together"),
    # one process per card: --mesh-dp is the process count (1 here)
    "mesh_dp": (["--mesh-dp", "2"], "--mesh-dp", "2", "1 process(es)"),
    "mesh_mp": (["--mesh-mp", "2", "--dist-coordinator", "127.0.0.1:1", "--dist-num-processes",
                 "3", "--dist-process-id", "0"], "--mesh-mp", "2", "3 process(es)"),
    # a multi-process run takes the three --dist-* flags together
    "dist_coordinator": (["--dist-coordinator", "localhost:1234"], "--dist-coordinator",
                         "localhost:1234", "missing --dist-num-processes, --dist-process-id"),
    "dist_num_processes": (["--dist-num-processes", "2"], "--dist-num-processes", "2",
                           "missing --dist-coordinator, --dist-process-id"),
    "dist_process_id": (["--dist-process-id", "0"], "--dist-process-id", "0",
                        "missing --dist-coordinator, --dist-num-processes"),
    # the card's kernel limits, checked without --use-cpu before the device:
    # K3's grid takes 65535 x 16 clips, and its long schedule's partials
    # (~B^2 / 4 bytes a head) must fit in the card's memory (80 GB here)
    "card_batch_grid": (["--train-batch", "1048561"], "--train-batch", "1048561",
                        "ROADMAP C"),
    "card_batch_memory": (["--learn-graph", "--train-batch", "600000"], "--train-batch",
                          "600000", "GiB of partials"),
}

# the card's memory where a test stands the card in: an H100's 80 GB
CARD_MEMORY = 80 * 10**9


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_preflight_refuses_before_reading_data(case, tmp_path, monkeypatch):
    extra, flag, value, named = REFUSALS[case]

    def no_data(*args, **kwargs):
        raise AssertionError("the catalog was read before the refusal")

    monkeypatch.setattr("agrl_torch.data.datasets.init_vidreid_dataset", no_data)
    monkeypatch.setattr(tcli, "card_memory", lambda: CARD_MEMORY)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):  # not under torchrun
        monkeypatch.delenv(var, raising=False)
    base = ["--root", str(tmp_path / "absent"), "--save-dir", str(tmp_path / "log"),
            "-a", "vmgn_tiny"]
    if not case.startswith("card_"):
        base.append("--use-cpu")
    stdout = sys.stdout
    with pytest.raises(SystemExit) as exc:
        tcli.main(base + extra)
    assert sys.stdout is stdout
    msg = str(exc.value)
    assert flag in msg and value in msg and named in msg, msg
    assert not (tmp_path / "log").exists()


# runs that K3 took only on the CPU until its long schedule, device head table
# and any width: without --use-cpu the pre-flight passes them to the catalog
CARD_RUNS = {
    "card_train_batch": ["--learn-graph", "--train-batch", "257"],
    # 3 x 31 + 1 = 94 heads, more than the launch's parameter table holds
    "card_heads": ["-a", "msppgn", "--num-split", "16", "--learn-graph"],
    # (4 + 1) x 2048 = 10240-wide triplet features
    "card_dim": ["-a", "ganet", "--num-gb", "4"],
}


class _CatalogReached(Exception):
    pass


@pytest.mark.parametrize("case", sorted(CARD_RUNS))
def test_preflight_reaches_the_catalog_on_the_card(case, tmp_path, monkeypatch):
    """--train-batch 257, msppgn at --num-split 16 (94 heads) and ganet at
    --num-gb 4 (D = 10240) pass the pre-flight without --use-cpu and reach
    the dataset catalog (the card itself stood in by the CPU device and an
    80 GB memory here)."""
    def catalog(*args, **kwargs):
        raise _CatalogReached

    monkeypatch.setattr("agrl_torch.data.datasets.init_vidreid_dataset", catalog)
    monkeypatch.setattr("agrl_torch.resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(tcli, "card_memory", lambda: CARD_MEMORY)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):  # not under torchrun
        monkeypatch.delenv(var, raising=False)
    argv = ["--root", str(tmp_path / "absent"), "--save-dir", str(tmp_path / "log"),
            "-a", "vmgn_tiny", *CARD_RUNS[case]]
    args = tcli.build_parser().parse_args(argv)
    assert not args.use_cpu
    stdout = sys.stdout
    with pytest.raises(_CatalogReached):
        tcli.main(argv)
    assert sys.stdout is stdout


def test_every_arch_choice_is_ported_or_refused_by_item():
    """-a's choices (agrl_tpu's registry) split into the port's registry and
    the refused names; every one is ported now (the legacy and 3D video
    families last), so none is refused."""
    from agrl_torch.models import get_names

    ported, refused = set(get_names()), set(tcli.UNPORTED_ARCHS)
    assert ported | refused == set(tcli.ARCH_NAMES) and not ported & refused
    assert {"msppn", "msppgn", "res50tp_legacy", "res50ta", "res50rnn", "resnet3d50",
            "resnet3dt"} <= ported
    assert not refused


def test_an_unported_arch_is_refused_by_its_item(tmp_path, monkeypatch):
    """The mechanism stays for an arch agrl_tpu's registry may gain: a name
    of -a's choices outside the port's registry is refused before any data
    is read, naming its ROADMAP item."""
    import agrl_torch.models as models

    names = [n for n in models.get_names() if n != "res50rnn"]
    monkeypatch.setattr(models, "get_names", lambda: names)
    monkeypatch.setattr(tcli, "UNPORTED_ARCHS", {"res50rnn": "A9"})
    with pytest.raises(SystemExit, match=r"-a/--arch 'res50rnn' is not ported .*ROADMAP A9"):
        tcli.main(["--use-cpu", "--root", str(tmp_path / "absent"), "--save-dir",
                   str(tmp_path / "log"), "-a", "res50rnn"])


# graph layout flags -> the pre-flight's refusal, agrl_tpu's message
# (agrl_tpu/cli/train_vidreid_xent_htri.py:367-394), or None: accepted
LAYOUTS = {
    "msppgn_pose_one_scale": (["-a", "msppgn", "--use-pose", "--num-scale", "1",
                               "--pyramid-part"],
                              "arch 'msppgn' consumes a 3-scale adjacency (vertices span "
                              "layer2/3/4) but --num-scale is 1; pass --num-scale 3"),
    "msppgn_no_pyramid": (["-a", "msppgn", "--use-pose", "--num-scale", "3"],
                          "arch 'msppgn' pools 7 pyramid parts per frame (calc_splits(4)) but "
                          "the pose graph is built with 4; pass --pyramid-part"),
    "msppgn_neither_one_scale": (["-a", "msppgn", "--pyramid-part"],
                                 "arch 'msppgn' consumes a 3-scale adjacency"),
    "msppgn_learned_no_pyramid": (["-a", "msppgn", "--learn-graph", "--num-scale", "3"], None),
    "msppgn_pose": (["-a", "msppgn", "--use-pose", "--num-scale", "3", "--pyramid-part"], None),
    "msppgn_learned_any_scale": (["-a", "msppgn", "--learn-graph", "--num-scale", "1"], None),
    "msppn_default_scale": (["-a", "msppn"], None),
    "msppn_any_scale": (["-a", "msppn", "--num-scale", "3", "--num-split", "8"], None),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_preflight_checks_the_graph_layout_as_agrl_tpu(case):
    """When a model reads a multi-scale adjacency (msppgn with --use-pose,
    or without --learn-graph) --num-scale must be 3 and the data side's
    parts per frame the model's; msppn, and msppgn with --learn-graph
    alone, never read it and take any layout. Refused with agrl_tpu's
    message, on the CPU and for the card, before any data is read."""
    extra, refusal = LAYOUTS[case]
    for card in (False, True):
        args = tcli.build_parser().parse_args(extra + ([] if card else ["--use-cpu"]))
        if refusal is None:
            tcli.preflight(args)
            continue
        with pytest.raises(SystemExit) as exc:
            tcli.preflight(args)
        assert refusal in str(exc.value), str(exc.value)


def test_preflight_lets_the_cpu_take_the_card_limits():
    args = tcli.build_parser().parse_args([
        "--use-cpu", "-a", "vmgn_tiny", "--test-sample", "evenly", "--train-batch", "257",
        "--seq-len", "19", "--pyramid-part",
    ])
    tcli.preflight(args)


@pytest.mark.parametrize("extra", [[], ["--test-sample", "all"]])
def test_preflight_takes_any_seq_len_on_the_card(extra):
    """The card's graph kernel takes any number of vertices: 19 frames x 7
    parts = 133, and agrl_tpu's default --test-sample dense (or all, whose
    buckets reach 8288 vertices), pass without --use-cpu."""
    args = tcli.build_parser().parse_args(
        ["-a", "vmgn_tiny", "--seq-len", "19", "--num-split", "4", "--pyramid-part", *extra])
    tcli.preflight(args)


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("flag", ["--bf16-train", "--bf16-eval"])
def test_preflight_takes_the_bf16_flags(flag, card):
    """--bf16-train and --bf16-eval are ported: the pre-flight passes them,
    with --use-cpu and for the card."""
    argv = ["-a", "vmgn", "--test-sample", "evenly", flag] + ([] if card else ["--use-cpu"])
    tcli.preflight(tcli.build_parser().parse_args(argv))


def test_zero_wd_schedule_matches_agrl_tpu_rule():
    """agrl_tpu's wd_fn (cli :409-413): 0 from step zero_wd * steps_per_epoch
    on when zero_wd > 0; the port sets it per epoch."""
    spe = 3
    for zero_wd in (-1, 0, 2):
        sched = zero_wd_schedule(5e-4, zero_wd)
        for step in range(12):
            want = 0.0 if zero_wd > 0 and step >= zero_wd * spe else 5e-4
            assert sched(step // spe) == want


METER = re.compile(
    r"^CurTime: \S+ \S+\tEpoch: \[\d+\]\[\d+/\d+\]\tTime \d+\.\d{3} \(\d+\.\d{3}\)\t"
    r"Speed \d+\.\d{3} samples/s\tData \d+\.\d{4} \(\d+\.\d{4}\)\tXent (\S+) \(\S+\)\t"
    r"Htri (\S+) \(\S+\)\tTop1 \d\.\d{4} \(\d\.\d{4}\)\tEta \d+:\d\d:\d\d$"
)


def _run_cli(argv):
    """main(argv) with stdout captured; returns (result, output)."""
    buf, stdout = io.StringIO(), sys.stdout
    sys.stdout = buf
    try:
        result = tcli.main(argv)
        assert sys.stdout is buf  # run restored the stream it was given
    finally:
        sys.stdout = stdout
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 epochs, --stepsize 1, an eval and a checkpoint after each; the
    optimizer's state is recorded at each save."""
    root = tmp_path_factory.mktemp("cli")
    save_dir = str(root / "log")
    base = [
        "--use-cpu", "--root", str(root / "data"), "-d", "synthetic", "-a", "vmgn_tiny",
        "--height", "64", "--width", "32", "--seq-len", "4", "--train-batch", "4",
        "--num-instances", "2", "--train-sample", "restricted",
        "--train-sampler", "RandomIdentitySamplerV1", "--test-sample", "evenly",
        "--test-batch", "8", "--num-split", "4", "--pyramid-part", "--use-pose",
        "--learn-graph", "--num-gb", "1", "--flip-aug", "--soft-margin",
        "--dist-metric", "cosine", "--lr", "1e-3", "--stepsize", "1", "--gamma", "0.1",
        "--save-dir", save_dir, "-j", "2", "--seed", "1",
    ]
    import agrl_torch.core as core

    saved, real_save = {}, core.save_checkpoint

    def recording_save(model, optimizer, fpath, epoch, **kw):
        saved[epoch] = copy.deepcopy(optimizer.state_dict())
        return real_save(model, optimizer, fpath, epoch, **kw)

    core.save_checkpoint = recording_save
    try:
        result, out = _run_cli(base + ["--max-epoch", "2", "--eval-step", "1", "--print-freq", "1"])
    finally:
        core.save_checkpoint = real_save
    return dict(base=base, save_dir=save_dir, out=out, result=result, saved=saved)


def test_cli_trains_evaluates_and_checkpoints(trained):
    out, save_dir = trained["out"], trained["save_dir"]
    assert trained["result"] is None
    meters = [line for line in out.splitlines() if line.startswith("CurTime: ")]
    assert meters and all(METER.match(line) for line in meters), meters[:2]
    for line in meters:
        xent, htri = (float(v) for v in METER.match(line).groups())
        assert np.isfinite(xent) and np.isfinite(htri)
    # synthetic: 8 ids x K=2 clips = 16 per epoch, 4 steps of 4
    assert [re.search(r"Epoch: \[(\d+)\]\[(\d+)/", m).groups() for m in meters] == [
        (str(e), str(b)) for e in (1, 2) for b in (1, 2, 3, 4)]
    assert out.count("Computing CMC and mAP on device") == 2
    for name in ("checkpoint_ep1.pth.tar", "checkpoint_ep2.pth.tar", "best_model.pth.tar",
                 "args.json", "scalars.jsonl", "vmgn.py"):
        assert osp.exists(osp.join(save_dir, name)), name
    assert glob.glob(osp.join(save_dir, "log_train-*.txt"))
    from agrl_torch.utils.tbevents import decode_scalar_event, read_records

    (events,) = glob.glob(osp.join(save_dir, "events.out.tfevents.*"))
    scalars = [decode_scalar_event(r) for r in read_records(events)]
    assert scalars[0]["version"] == "brain.Event:2"
    tags = [(tag, e["step"]) for e in scalars[1:] for tag, _ in e["scalars"]]
    assert tags == [(t, ep) for ep in (1, 2) for t in ("loss/xent_loss", "loss/htri_loss",
                                                       "acc/rank1", "acc/mAP")]


def test_meter_line_is_agrl_tpu_letter_for_letter():
    import inspect

    def meter_block(module):
        src = inspect.getsource(module.train_one_epoch)
        block = src[src.index('f"CurTime: '):src.index('f"Eta {eta_str}"')]
        return re.sub(r"\s+", " ", block)

    assert meter_block(tcli) == meter_block(jcli)


def test_evaluate_resume_best_prints_best_rank1(trained, tmp_path):
    out = trained["out"]
    best = re.search(r"==> Best Rank-1 (\S+), mAP: (\S+), achieved", out).groups()
    (r1, mAP), eval_out = _run_cli(trained["base"] + [
        "--evaluate", "--save-dir", str(tmp_path),
        "--resume", osp.join(trained["save_dir"], "best_model.pth.tar")])
    assert (f"{r1:.2%}", f"{mAP:.2%}") == best
    assert "Evaluate only" in eval_out and "Loaded checkpoint from" in eval_out
    assert glob.glob(str(tmp_path / "log_test-*.txt"))


def test_evaluate_visualize_ranks_returns_the_distmat(trained, tmp_path):
    distmat, _ = _run_cli(trained["base"] + [
        "--evaluate", "--visualize-ranks", "--save-dir", str(tmp_path),
        "--resume", osp.join(trained["save_dir"], "best_model.pth.tar")])
    assert isinstance(distmat, np.ndarray) and distmat.shape == (24, 24)
    assert np.isfinite(distmat).all()
    strips = glob.glob(str(tmp_path / "ranked_results" / "*" / "gallery_top001"))
    assert len(strips) == 24


def test_resume_restores_adam_and_the_step_count(trained, monkeypatch, tmp_path):
    """--resume checkpoint_ep1 (epoch index 0 saved): the first update of
    the resumed epoch uses lr_fn(steps_per_epoch), the decayed lr, as
    agrl_tpu's resumed state (step = (epoch + 1) * steps_per_epoch)
    gives, from Adam state bit-equal to the state at the save."""
    from agrl_torch.engine import trainer

    seen, real = {}, trainer.make_train_step

    def recording_make(model, optimizer, lr_fn, **kw):
        step = real(model, optimizer, lr_fn, **kw)
        seen["start_step"] = kw["start_step"]

        def first(*args, **kwargs):
            if "state" not in seen:
                seen["state"] = copy.deepcopy(optimizer.state_dict())
                out = step(*args, **kwargs)
                seen["lr"] = optimizer.param_groups[0]["lr"]
                return out
            return step(*args, **kwargs)

        return first

    monkeypatch.setattr(trainer, "make_train_step", recording_make)
    _, out = _run_cli(trained["base"] + [
        "--max-epoch", "2", "--eval-step", "1", "--print-freq", "1", "--save-dir", str(tmp_path),
        "--resume", osp.join(trained["save_dir"], "checkpoint_ep1.pth.tar")])
    spe = 4
    assert "- start_epoch: 1" in out and seen["start_step"] == spe
    want_lr = float(jax_per_step(jax_multistep_lr(1e-3, [1], gamma=0.1), spe)(spe))
    assert seen["lr"] == pytest.approx(want_lr, rel=1e-12) and want_lr < 1e-3 / 2
    before, resumed = trained["saved"][0], seen["state"]
    assert before["state"].keys() == resumed["state"].keys() and before["state"]
    for k, want in before["state"].items():
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(resumed["state"][k][field], want[field]), (k, field)
    assert [m for m in out.splitlines() if m.startswith("CurTime: ")][0].split("\t")[1] == \
        "Epoch: [2][1/4]"


@pytest.mark.parametrize("test_sample", ["dense", "all"])
def test_evaluate_dense_and_all(trained, tmp_path, test_sample):
    """--evaluate of the best checkpoint with --test-sample unset (dense,
    agrl_tpu's default) and with all: loader batches of one tracklet, a CMC
    block, and ranks in [0, 1]."""
    base = list(trained["base"])
    i = base.index("--test-sample")
    del base[i:i + 2]
    if test_sample != "dense":
        base += ["--test-sample", test_sample]
    (r1, mAP), out = _run_cli(base + [
        "--evaluate", "--save-dir", str(tmp_path), "--clip-batch", "8",
        "--resume", osp.join(trained["save_dir"], "best_model.pth.tar")])
    assert f"test_sample='{test_sample}'" in out
    assert "Extracted features for query set, obtained 24-by-4096 matrix" in out
    assert "Computing CMC and mAP on device" in out and "Results ----------" in out
    assert 0.0 <= r1 <= 1.0 and 0.0 <= mAP <= 1.0


def _spy_train_step(monkeypatch):
    """Records make_train_step's optimizer and keywords as the CLI calls it."""
    from agrl_torch.engine import trainer

    seen, real = {}, trainer.make_train_step

    def recording_make(model, optimizer, lr_fn, **kw):
        seen.update(kw, model=model, optimizer=optimizer)
        return real(model, optimizer, lr_fn, **kw)

    monkeypatch.setattr(trainer, "make_train_step", recording_make)
    return seen


# the train flags ported in ROADMAP A2, and VMGN's pose-only and
# learned-only graphs: extra argv, flags dropped from the base, and what
# the run must have been built with
TRAIN_FLAGS = {
    "optim": (["--optim", "radam"], [], lambda seen: type(seen["optimizer"]).__name__ == "RAdam"),
    "rand_erase": (["--rand-erase"], [], lambda seen: seen["aug"]["rand_erase"]),
    "rand_crop": (["--rand-crop"], [], lambda seen: seen["aug"]["rand_translate"]),
    "misalign_aug": (["--misalign-aug"], [], lambda seen: seen["aug"]["misalign_aug"]),
    "remat": (["--remat", "dots"], [], lambda seen: seen["remat"] == "dots"),
    "pose_graph": ([], ["--learn-graph"],
                   lambda seen: {g.mode for g in seen["model"].graph_layers} == {"pose"}),
    "learned_graph": ([], ["--use-pose"],
                      lambda seen: {g.mode for g in seen["model"].graph_layers} == {"learned"}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_FLAGS))
def test_preflight_takes_the_train_flags_and_a_cpu_epoch_runs_with_them(
        case, trained, tmp_path, monkeypatch):
    """The pre-flight passes each (with --use-cpu and for the card), and
    one CPU epoch with an evaluation runs with it: finite meter lines, a
    CMC block, a checkpoint. tests/test_torch_optim.py,
    test_torch_augment.py, test_torch_remat.py and test_torch_graph_modes.py
    hold what each computes against agrl_tpu."""
    extra, dropped, built_with = TRAIN_FLAGS[case]
    save_dir = str(tmp_path / "log")
    base = [a if a != trained["save_dir"] else save_dir for a in trained["base"]
            if a not in dropped]
    tcli.preflight(tcli.build_parser().parse_args(base + extra))
    tcli.preflight(tcli.build_parser().parse_args([a for a in base + extra if a != "--use-cpu"]))
    seen = _spy_train_step(monkeypatch)
    try:
        result, out = _run_cli(base + extra + ["--max-epoch", "1", "--eval-step", "1",
                                               "--print-freq", "1"])
        assert osp.exists(osp.join(save_dir, "checkpoint_ep1.pth.tar"))
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)  # two ~220 MB checkpoints
    assert result is None and built_with(seen), case
    meters = [METER.match(line) for line in out.splitlines() if line.startswith("CurTime: ")]
    assert len(meters) == 4 and all(m is not None for m in meters)
    assert all(np.isfinite(float(v)) for m in meters for v in m.groups())
    assert out.count("Computing CMC and mAP on device") == 1


# the single-scale and multi-scale archs: the CLI's -a, the eval feature's
# width (ganet's (num_gb + 1) * 2048 and msppgn's (num_gb + 1) * 512 at the
# base's --num-gb 1)
CLI_ARCHS = {"gsta": 2048, "ganet": 4096, "sta": 1024, "msppn": 512, "msppgn": 1024}
CLI_CLASSES = {"gsta": "GSTA", "ganet": "GANet", "sta": "STA", "msppn": "MSPyraPartNet",
               "msppgn": "MSPyraPartGraphNet"}


@pytest.mark.parametrize("arch", sorted(CLI_ARCHS))
def test_cli_trains_and_evaluates_each_arch(arch, trained, tmp_path, monkeypatch):
    """-a gsta, ganet, sta, msppn and msppgn at full ResNet-50 depth on the
    CPU (64x32, seq_len 4): the pre-flight passes them (also for the card),
    one epoch of 4 steps (gsta and ganet with --consistent-loss: 2 heads;
    msppn and msppgn 22) with finite meter lines, an evenly evaluation and
    a checkpoint; then --evaluate --resume best_model under --test-sample
    all (frame-masked buckets; msppgn's adjacency padded split-major by its
    pad_eval_adjacency), whose features have the arch's width. msppn runs
    at the default --num-scale 1, msppgn (--use-pose) at 3."""
    import agrl_torch.engine.evaluator as ev

    save_dir = str(tmp_path / "log")
    base = [a if a != trained["save_dir"] else save_dir for a in trained["base"]]
    base[base.index("vmgn_tiny")] = arch
    if arch in ("gsta", "ganet"):
        base.append("--consistent-loss")
    if arch == "msppgn":
        base += ["--num-scale", "3"]
    tcli.preflight(tcli.build_parser().parse_args([a for a in base if a != "--use-cpu"]))
    seen = _spy_train_step(monkeypatch)
    widths, real_extract = [], ev.Evaluator.extract

    def recording_extract(self, *a, **kw):
        feats = real_extract(self, *a, **kw)
        widths.append(feats[0].shape[1])
        return feats

    monkeypatch.setattr(ev.Evaluator, "extract", recording_extract)
    try:
        result, out = _run_cli(base + ["--max-epoch", "1", "--eval-step", "1",
                                       "--print-freq", "1"])
        assert result is None and type(seen["model"]).__name__ == CLI_CLASSES[arch]
        assert getattr(seen["model"], "consistent_loss", False) == (arch in ("gsta", "ganet"))
        meters = [METER.match(line) for line in out.splitlines() if line.startswith("CurTime: ")]
        assert len(meters) == 4 and all(m is not None for m in meters)
        assert all(np.isfinite(float(v)) for m in meters for v in m.groups())
        assert out.count("Computing CMC and mAP on device") == 1
        best = osp.join(save_dir, "best_model.pth.tar")
        test_sample = base.index("--test-sample") + 1
        argv = base[:test_sample] + ["all"] + base[test_sample + 1:]
        rank1, mAP = _run_cli(argv + ["--evaluate", "--resume", best])[0]
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)  # full-size checkpoints
    assert 0.0 <= rank1 <= 1.0 and 0.0 <= mAP <= 1.0
    assert widths and set(widths) == {CLI_ARCHS[arch]}


def test_graph_layers_without_a_graph_raise_as_agrl_tpu(trained, tmp_path):
    """-a with graph layers and neither --use-pose nor --learn-graph: the
    model build raises, as agrl_tpu's GraphConvLayer asserts one of them;
    an unknown optimizer is refused before any data is read."""
    base = [a if a != trained["save_dir"] else str(tmp_path / "log") for a in trained["base"]
            if a not in ("--use-pose", "--learn-graph")]
    with pytest.raises(ValueError, match="use_pose or learn_graph"):
        _run_cli(base + ["--max-epoch", "1"])
    with pytest.raises(SystemExit, match="unsupported optimizer"):
        tcli.preflight(tcli.build_parser().parse_args(base + ["--optim", "lamb"]))


def test_cli_trains_and_evaluates_in_bf16(trained, tmp_path, monkeypatch):
    """--bf16-train --bf16-eval end to end on the CPU: the model is built
    with dtype bfloat16 (agrl_tpu's CLI :366; vmgn_tiny drops it, as
    agrl_tpu's does), the Evaluator runs the bf16 eval (:527), the losses
    stay finite and the run checkpoints."""
    import agrl_torch.engine.evaluator as ev
    import agrl_torch.models as models

    seen = {}
    real_init, real_evaluator = models.init_model, ev.Evaluator

    def init_model(*args, **kwargs):
        seen["dtype"] = kwargs.get("dtype")
        return real_init(*args, **kwargs)

    class Evaluator(real_evaluator):
        def __init__(self, *args, **kwargs):
            seen["bf16"] = kwargs.get("bf16")
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(models, "init_model", init_model)
    monkeypatch.setattr(ev, "Evaluator", Evaluator)
    save_dir = str(tmp_path / "log")
    argv = [a if a != trained["save_dir"] else save_dir for a in trained["base"]]
    result, out = _run_cli(argv + ["--bf16-train", "--bf16-eval", "--max-epoch", "1",
                                   "--eval-step", "1", "--print-freq", "1"])
    assert result is None and seen == {"dtype": torch.bfloat16, "bf16": True}
    meters = [METER.match(line) for line in out.splitlines() if line.startswith("CurTime: ")]
    assert len(meters) == 4 and all(m is not None for m in meters)
    assert all(np.isfinite(float(v)) for m in meters for v in m.groups())
    assert out.count("Computing CMC and mAP on device") == 1
    assert osp.exists(osp.join(save_dir, "best_model.pth.tar"))


def _accept_cache_frames(trained, tmp_path, out, result):
    """--cache-frames: agrl_tpu's cache lines, and the cached evaluation
    scores as the uncached best did."""
    best = re.search(r"==> Best Rank-1 (\S+), mAP: (\S+), achieved", trained["out"]).groups()
    assert re.search(r"^Frame cache: ~\d+\.\d GB to hold every decoded frame \(64x32\); "
                     r"LRU budget = 8 GB cap \(default\)$", out, re.M), out
    assert "Eval batch cache: ~0.0 GB holds every collated eval batch (evenly)" in out
    assert (f"{result[0]:.2%}", f"{result[1]:.2%}") == best


def _accept_frame_cache_dir(trained, tmp_path, out, result):
    """--frame-cache-dir: the store's line and its files, one record for
    each distinct frame the evaluation read."""
    store = tmp_path / "store"
    assert f"Persistent frame cache: '{store}' (0 frames present)" in out
    for name in ("VERSION", "frames_64x32.bin", "frames_64x32.idx", "frames_64x32.dec"):
        assert (store / name).exists(), name
    records = (store / "frames_64x32.bin").stat().st_size // (64 * 32 * 3)
    lines = (store / "frames_64x32.idx").read_text().splitlines()
    assert records == len(lines) > 0


def _accept_decode_native(trained, tmp_path, out, result):
    """--decode native: decodes with the native decoder where it builds;
    elsewhere the run raises with the reason before it reads a frame."""
    from agrl_torch.data import jpeg_native

    if isinstance(result, BaseException):
        assert not jpeg_native.available()
        assert jpeg_native.why_unavailable() in str(result)
    else:
        assert jpeg_native.available()
        assert "Frame decoder: native (libjpeg, batched; --decode native)" in out
        assert 0.0 <= result[0] <= 1.0


def _accept_async_ckpt(trained, tmp_path, out, result, saved=None):
    """--async-ckpt: the checkpoint written behind the run loads to the
    state the model and optimizer had when it was saved."""
    from agrl_torch.core import load_checkpoint

    assert result is None and saved
    model_sd, optim_sd = saved[0]
    ckpt = torch.load(str(tmp_path / "log" / "checkpoint_ep1.pth.tar"), weights_only=True)
    assert ckpt["state_dict"].keys() == model_sd.keys()
    for k, v in model_sd.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    for k, v in optim_sd["state"].items():
        for field, t in v.items():
            assert torch.equal(ckpt["optimizer"]["state"][k][field], t), (k, field)
    assert ckpt["optimizer"]["param_groups"] == optim_sd["param_groups"]
    meta = load_checkpoint(str(tmp_path / "log" / "best_model.pth.tar"))
    assert meta["epoch"] == 0


def _accept_profile_dir(trained, tmp_path, out, result):
    """--profile-dir: the first epoch's trace and op table are written."""
    prof = tmp_path / "prof"
    assert f"Profile of epoch 1 written to '{prof}'" in out
    (trace_file,) = glob.glob(str(prof / "trace_*.json"))
    (ops_file,) = glob.glob(str(prof / "ops_*.txt"))
    assert osp.getsize(trace_file) > 1000 and "aten::" in open(ops_file).read()


# the flags ported with the host side (ROADMAP A5, A9): extra argv, whether
# the run trains one epoch (else --evaluate of the trained best model),
# and the check of what the flag asks for
ACCEPTED = {
    "cache_frames": (["--cache-frames"], False, _accept_cache_frames),
    "frame_cache_dir": (["--frame-cache-dir", "{tmp}/store"], False, _accept_frame_cache_dir),
    "decode_native": (["--decode", "native"], False, _accept_decode_native),
    "async_ckpt": (["--async-ckpt"], True, _accept_async_ckpt),
    "profile_dir": (["--profile-dir", "{tmp}/prof"], True, _accept_profile_dir),
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_preflight_takes_the_host_flags_and_the_run_does_what_they_ask(
        case, trained, tmp_path, monkeypatch):
    extra, train, check = ACCEPTED[case]
    extra = [a.format(tmp=tmp_path) for a in extra]
    base = [a if a != trained["save_dir"] else str(tmp_path / "log") for a in trained["base"]]
    tcli.preflight(tcli.build_parser().parse_args(base + extra))
    tcli.preflight(tcli.build_parser().parse_args(
        [a for a in base + extra if a != "--use-cpu"]))
    saved = []
    if case == "async_ckpt":
        from agrl_torch.core import checkpoint as ckpt_mod

        real_save = ckpt_mod.AsyncCheckpointer.save

        def recording_save(self, model, optimizer, *args, **kwargs):
            saved.append((copy.deepcopy(model.state_dict()),
                          copy.deepcopy(optimizer.state_dict())))
            return real_save(self, model, optimizer, *args, **kwargs)

        monkeypatch.setattr(ckpt_mod.AsyncCheckpointer, "save", recording_save)
    if train:
        argv = base + extra + ["--max-epoch", "1", "--eval-step", "1", "--print-freq", "1"]
    else:
        argv = base + extra + ["--evaluate", "--resume",
                               osp.join(trained["save_dir"], "best_model.pth.tar")]
    try:
        result, out = _run_cli(argv)
    except RuntimeError as e:  # --decode native without the decoder
        if case != "decode_native":
            raise
        result, out = e, ""
    kw = {"saved": saved} if case == "async_ckpt" else {}
    check(trained, tmp_path, out, result, **kw)
