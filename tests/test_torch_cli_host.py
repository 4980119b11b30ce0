"""The port's CLI with the host-side flags on (a CPU run at vmgn_tiny on
the synthetic set): --cache-frames --frame-cache-dir --async-ckpt
--profile-dir --decode pil trains and evaluates to the same losses and
Rank-1/mAP as the run without them, and a second process on the same
frame store evaluates from it without decoding a frame."""

import glob
import os
import re
import subprocess
import sys

import torch

from tests.test_torch_cli import METER, _run_cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _base(root, save_dir):
    return [
        "--use-cpu", "--root", str(root / "data"), "-d", "synthetic", "-a", "vmgn_tiny",
        "--height", "64", "--width", "32", "--seq-len", "4", "--train-batch", "4",
        "--num-instances", "2", "--train-sampler", "RandomIdentitySamplerV1",
        "--test-sample", "evenly", "--test-batch", "8", "--num-split", "4", "--pyramid-part",
        "--use-pose", "--learn-graph", "--num-gb", "1", "--flip-aug", "--soft-margin",
        "--dist-metric", "cosine", "--lr", "1e-3", "--save-dir", str(save_dir), "-j", "2",
        "--seed", "3", "--decode", "pil", "--max-epoch", "2", "--eval-step", "1",
        "--print-freq", "1",
    ]


def _results(out):
    losses = [METER.match(line).groups() for line in out.splitlines()
              if line.startswith("CurTime: ")]
    blocks = re.findall(r"Results -+\nmAP: (\S+)\nCMC curve\nRank-1\s*: (\S+)", out)
    return losses, blocks


# the eval's decode would raise in the second process: the store serves it
_NO_DECODE = (
    "import sys\n"
    "import agrl_torch.data.transforms as t\n"
    "def no_decode(*a, **k):\n"
    "    raise AssertionError('a frame was decoded')\n"
    "t._decode_batch = no_decode\n"
    "from agrl_torch.cli.train_vidreid_xent_htri import main\n"
    "r1, mAP = main(sys.argv[1:])\n"
    "print(f'RESULT {r1:.6f} {mAP:.6f}')\n"
)


def test_host_flags_keep_the_run_and_a_second_process_reads_the_store(tmp_path):
    plain_out = _run_cli(_base(tmp_path, tmp_path / "plain"))[1]
    store, prof = tmp_path / "store", tmp_path / "prof"
    flagged_out = _run_cli(_base(tmp_path, tmp_path / "flagged") + [
        "--cache-frames", "--frame-cache-dir", str(store), "--async-ckpt",
        "--profile-dir", str(prof)])[1]
    plain, flagged = _results(plain_out), _results(flagged_out)
    assert len(plain[0]) == 8 and len(plain[1]) == 2
    assert flagged == plain  # the same losses and the same CMC blocks
    assert "Frame decoder: PIL (--decode pil)" in flagged_out
    assert f"Persistent frame cache: '{store}' (0 frames present)" in flagged_out
    assert glob.glob(str(prof / "trace_*.json"))
    for name in ("checkpoint_ep1.pth.tar", "checkpoint_ep2.pth.tar", "best_model.pth.tar"):
        a = torch.load(str(tmp_path / "plain" / name), weights_only=True)
        b = torch.load(str(tmp_path / "flagged" / name), weights_only=True)
        for k, v in a["state_dict"].items():
            assert torch.equal(v, b["state_dict"][k]), (name, k)
    n_frames = (store / "frames_64x32.bin").stat().st_size // (64 * 32 * 3)
    assert n_frames > 0

    best = str(tmp_path / "flagged" / "best_model.pth.tar")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_DECODE, *_base(tmp_path, tmp_path / "second"),
         "--evaluate", "--resume", best, "--frame-cache-dir", str(store)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"Persistent frame cache: '{store}' ({n_frames} frames present)" in proc.stdout
    r1, mAP = (float(v) for v in re.search(r"RESULT (\S+) (\S+)", proc.stdout).groups())
    best_block = re.search(r"==> Best Rank-1 (\S+)%, mAP: (\S+)%", flagged_out).groups()
    assert (f"{r1:.2%}", f"{mAP:.2%}") == (f"{best_block[0]}%", f"{best_block[1]}%")
