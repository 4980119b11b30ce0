"""agrl_tpu's convergence check in the port: the discriminative MARS-layout
recipe (agrl_torch/cli/measure_convergence_band.py, the counterpart of
tools/measure_convergence_band.py) trained to its converged mAP band.

agrl_tpu trains its recipe once per variant (the full loss, and the
injected mis-wiring `no_htri`: lambda_htri = 0) in a module-scoped
fixture, jitted, and hands the port its seed-0 initial variables, its
batches and its flip draws. The port, started from them, must follow
agrl_tpu's losses step by step and land on its converged evenly score;
its no_htri run must land below agrl_tpu's floor. Then the band that the
tool measured on the card (agrl_torch/cli/convergence_band.json) is held
to the invariants of agrl_tpu's test_band_floor_trips_on_injected_bug, and
the port's own seed 0, trained here on the CPU, must reproduce the card's
golden score.

Also the port's ImageDataset and ClipLoader's collate of items that carry
no adjacency, against agrl_tpu's (tests/test_transforms_legacy.py:95-121).
"""

import json
import os.path as osp
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from agrl_torch.cli import measure_convergence_band as band_tool
from agrl_torch.data.loader import ClipLoader as TorchClipLoader
from agrl_torch.data.loader import ImageDataset as TorchImageDataset
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.datasets.synthetic_mars import materialize_mars_layout as jax_materialize
from agrl_tpu.data.loader import ClipLoader as JaxClipLoader
from agrl_tpu.data.loader import ImageDataset as JaxImageDataset
from agrl_tpu.data.loader import VideoClipDataset as JaxClipDataset
from agrl_tpu.data.samplers import init_sampler as jax_sampler
from agrl_tpu.engine import create_train_state, make_train_step
from agrl_tpu.engine.evaluator import Evaluator as JaxEvaluator
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.optim import init_optim as jax_optim

S, H, W = band_tool.S, band_tool.H, band_tool.W
MARGIN = band_tool.SUBSTRATE_MARGIN  # agrl_tpu tests/test_convergence.py:52
SEED = 0
# step 1 starts from the same variables, batch and flips: only the
# arithmetic differs
FIRST_STEP_RTOL = 1e-4
# each step's losses against agrl_tpu's, per variant: (steps held, xent
# relative, htri absolute; htri falls to ~1e-5, where a relative bar reads
# rounding). Measured with the port on 1, 2, 4 and 8 CPU threads
# (`sweep_threads`, below): the full loss over all 10 steps at most 0.0094
# and 0.0017. no_htri, whose triplet term nothing holds down, spreads from
# step 5 on (by step 10 xent 0.087 and htri 0.118 apart, htri at 0.0003-1.0
# relative where it is above 1e-2), so only its first 4 steps are held: at
# most 0.0069 and 0.0315; its converged floor is its main hold. The bars
# are about twice those.
STEP_BARS = {"full": (10, 0.02, 0.004), "no_htri": (4, 0.015, 0.06)}
# the port's CPU runs take this many threads (set in the fixtures, then
# restored): a run's rounding, and so its trajectory, depends on it
THREADS = 4


@contextmanager
def _threads(n):
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    return _datasets(tmp_path_factory.mktemp("band"))


def _datasets(root):
    """(the port's dataset, agrl_tpu's dataset): the port's build_fixture
    and agrl_tpu's materializer, each in a directory of its own."""
    tds = band_tool.build_fixture(osp.join(root, "torch"))
    jax_materialize(osp.join(root, "jax"), num_train_pids=6, num_test_pids=16, num_cams=2,
                    tracklets_per_cam=2, frames_range=(6, 12), height=128, width=64, seed=3)
    jds = jax_dataset("mars", root=osp.join(root, "jax"), use_pose=True, verbose=False)
    return tds, jds


def _jax_clip_kw(jds):
    return dict(height=H, width=W, pose_info=jds.process_poses, num_split=4,
                pyramid_part=True, enable_pose=True, decode="pil")


def _flip_decisions(aug_key, n):
    """The per-clip flips agrl_tpu's preprocess_clips draws from its key
    (agrl_tpu/data/transforms.py:298-307, one key per clip)."""
    return np.array([bool(jax.random.uniform(jax.random.split(k, 4)[0]) < 0.5)
                     for k in jax.random.split(aug_key, n)])


def _jax_run(jds, lambda_htri):
    """agrl_tpu's recipe (tools/measure_convergence_band.py train_once and
    score) at seed 0: its initial variables, batches, flips, per-step
    losses and converged evenly (rank-1, mAP)."""
    kw = _jax_clip_kw(jds)
    train_ds = JaxClipDataset(jds.train, seq_len=S, sample="restricted", **kw)
    sampler = jax_sampler("RandomIdentitySamplerV1", jds.train, 8, 2, seed=SEED)
    loader = JaxClipLoader(train_ds, batch_size=8, sampler=sampler, drop_last=True,
                           num_workers=1, seed=SEED)
    model = jax_init_model(
        "vmgn_tiny", num_classes=jds.num_train_pids, loss={"xent", "htri"},
        num_split=4, pyramid_part=True, num_gb=1, use_pose=True, learn_graph=True,
    )
    tx = jax_optim("adam", lambda step: 1e-3, weight_decay=5e-4)
    state = create_train_state(model, tx, jax.random.PRNGKey(SEED), seq_len=S, height=H,
                               width=W, batch_size=2)
    init = jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    step = make_train_step(model, tx, label_smooth=True, soft_margin=True,
                           lambda_htri=lambda_htri, aug=dict(flip_aug=True), donate=False)
    key = jax.random.PRNGKey(SEED + 1)
    batches, flips, history = [], [], []
    for _ in range(band_tool.EPOCHS):
        for imgs, pids, camids, adjs in loader:
            key, sk = jax.random.split(key)
            _, aug = jax.random.split(sk)  # agrl_tpu/engine/trainer.py:104-109
            flips.append(_flip_decisions(aug, len(imgs)))
            state, metrics = step(state, imgs, pids.astype(np.int32), adjs, sk)
            batches.append((imgs, pids, camids, adjs))
            history.append({k: float(v) for k, v in metrics.items()})
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    q, g = (JaxClipLoader(JaxClipDataset(split, seq_len=S, sample="evenly", **kw),
                          batch_size=8, num_workers=1) for split in (jds.query, jds.gallery))
    rank1, mAP = JaxEvaluator(model, test_sample="evenly", clip_batch=8).evaluate(
        variables, q, g, dist_metric="cosine", metric_protocol="mars")
    return dict(init=init, batches=batches, flips=flips, history=history,
                evenly=(float(rank1), float(mAP)))


def _port_run(tds, jax_run, lambda_htri):
    """The port's recipe from agrl_tpu's initial variables and flips: its
    per-step losses and converged evenly (rank-1, mAP)."""
    model, history = band_tool.train_once(tds, SEED, lambda_htri, device="cpu",
                                          variables=jax_run["init"], flips=jax_run["flips"])
    return dict(history=history, evenly=band_tool.score(model, tds, "evenly", device="cpu"))


@pytest.fixture(scope="module")
def runs(fixtures):
    """{variant: (agrl_tpu's run, the port's run)} for the full loss and
    no_htri."""
    tds, jds = fixtures
    out = {}
    for variant, lambda_htri in (("full", 1.0), ("no_htri", 0.0)):
        jrun = _jax_run(jds, lambda_htri)
        with _threads(THREADS):
            out[variant] = (jrun, _port_run(tds, jrun, lambda_htri))
    return out


@pytest.fixture(scope="module")
def card_band():
    with open(band_tool.BAND_PATH) as f:
        return json.load(f)


def test_fixture_batches_match_agrl_tpu(fixtures, runs):
    """(a) The port's fixture and train loader yield agrl_tpu's 10 batches
    bit for bit: clips, pids, camids and adjacency."""
    tds, _ = fixtures
    want = runs["full"][0]["batches"]
    loader = band_tool.train_loader(tds, SEED)
    got = [b for _ in range(band_tool.EPOCHS) for b in loader]
    assert len(got) == len(want) == band_tool.EPOCHS  # one step an epoch
    for t, j in zip(got, want):
        for x, y in zip(t, j):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("variant", ["full", "no_htri"])
def test_first_step_losses_match_agrl_tpu(runs, variant):
    """(b) Step 1 from agrl_tpu's variables, batch and flips: xent and htri
    within FIRST_STEP_RTOL of agrl_tpu's."""
    jrun, prun = runs[variant]
    for k in ("xent_loss", "htri_loss", "loss"):
        np.testing.assert_allclose(prun["history"][0][k], jrun["history"][0][k],
                                   rtol=FIRST_STEP_RTOL, err_msg=k)


@pytest.mark.parametrize("variant", ["full", "no_htri"])
def test_trajectory_follows_agrl_tpu(runs, variant):
    """(b) The xent and htri of the variant's held steps within its
    STEP_BARS of agrl_tpu's; under the full loss also the same top-1 every
    step (a fraction of 8 clips: a flipped argmax shows)."""
    jrun, prun = runs[variant]
    assert len(prun["history"]) == len(jrun["history"]) == band_tool.EPOCHS
    steps, xent_bar, htri_bar = STEP_BARS[variant]
    xent, htri = _worst_steps(prun, jrun, steps)
    print(f"[convergence] {variant}: worst of steps 1-{steps}: xent rel {xent:.4f}, htri abs "
          f"{htri:.4f}")
    assert xent <= xent_bar and htri <= htri_bar, (xent, htri)
    if variant == "full":
        assert [p["top1"] for p in prun["history"]] == [j["top1"] for j in jrun["history"]]


def _worst_steps(prun, jrun, n=band_tool.EPOCHS):
    """The largest per-step xent relative and htri absolute differences
    over the first n steps."""
    steps = list(zip(prun["history"], jrun["history"]))[:n]
    return (max(abs(p["xent_loss"] - j["xent_loss"]) / j["xent_loss"] for p, j in steps),
            max(abs(p["htri_loss"] - j["htri_loss"]) for p, j in steps))


def test_converged_score_matches_agrl_tpu(runs):
    """(b) The converged evenly mAP within MARGIN of agrl_tpu's run, rank-1
    within one of the 16 queries."""
    (jr1, jmap), (pr1, pmap) = runs["full"][0]["evenly"], runs["full"][1]["evenly"]
    print(f"[convergence] evenly: agrl_tpu rank-1 {jr1:.4f} mAP {jmap:.4f}; "
          f"port rank-1 {pr1:.4f} mAP {pmap:.4f}")
    assert abs(pmap - jmap) < MARGIN, (pmap, jmap)
    assert abs(pr1 - jr1) <= 1 / 16 + 1e-9, (pr1, jr1)


def test_injected_bug_trips_agrl_tpu_floor(runs):
    """(c) The port's no_htri run from agrl_tpu's init lands below agrl_tpu's
    floor (its seed-0 evenly mAP minus MARGIN), as agrl_tpu's own no_htri
    run does."""
    floor = runs["full"][0]["evenly"][1] - MARGIN
    port_bug, jax_bug = runs["no_htri"][1]["evenly"][1], runs["no_htri"][0]["evenly"][1]
    print(f"[convergence] no_htri: agrl_tpu mAP {jax_bug:.4f}, port mAP {port_bug:.4f}, "
          f"floor {floor:.4f}")
    assert port_bug < floor, (port_bug, floor)
    assert jax_bug < floor, (jax_bug, floor)


def test_card_band_trips_on_injected_bug(card_band):
    """(d) The band measured on the card holds agrl_tpu's
    test_band_floor_trips_on_injected_bug invariants: the injected bug
    below the floor, the floor above 0.5, the golden inside (floor,
    ceiling); it names the card, its seeds and a reproduced golden."""
    golden, floor, ceil = band_tool.band_limits(card_band)
    injected = card_band["injected"]["no_htri"]["mAP"]
    assert injected < floor, (injected, floor)
    assert floor < golden < ceil
    assert floor > 0.5
    # agrl_tpu's design rationale holds on the card's seeds too: the bug
    # sits above a mean - 2 sigma seed floor and a seed converges below
    # mean - sigma, so only the pinned seed's anchor catches the bug
    s = card_band["summary"]
    assert injected > s["evenly_mAP_mean"] - 2.0 * s["evenly_mAP_sigma"]
    assert s["evenly_mAP_min"] < s["evenly_mAP_mean"] - s["evenly_mAP_sigma"]
    assert sorted(card_band["seeds"], key=int) == [str(s) for s in band_tool.DEFAULT_SEEDS]
    assert card_band["summary"] == band_tool.summarize(card_band)
    dev = card_band["device"]
    assert dev["type"] == "cuda" and dev["nvidia_smi"].startswith(dev["name"])
    runs = card_band["reproduced"]["runs"]
    assert len(runs) >= 2 and all(r["mAP"] == golden for r in runs), runs


def test_summary_is_agrl_tpus():
    """The tool's summary of agrl_tpu's committed seeds is agrl_tpu's own
    (tools/convergence_band.json), and so are its golden and floor."""
    with open(osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools",
                       "convergence_band.json")) as f:
        theirs = json.load(f)
    assert band_tool.summarize(theirs) == theirs["summary"]
    golden, floor, ceil = band_tool.band_limits(theirs)
    assert (golden, floor, ceil) == (0.7844, 0.7844 - 0.05, 0.7844 + 0.05)


def test_cpu_seed_reproduces_card_golden(fixtures, card_band):
    """(d) The port's own seed 0 (its seeded init and generator), trained
    here on the CPU, reproduces the card's committed seed-0 evenly mAP
    within MARGIN and its rank-1 within one query."""
    tds, _ = fixtures
    with _threads(THREADS):
        model, _ = band_tool.train_once(tds, SEED, device="cpu")
        r1, mAP = band_tool.score(model, tds, "evenly", device="cpu")
    card = card_band["seeds"][str(SEED)]["evenly"]
    print(f"[convergence] seed {SEED} on the CPU: rank-1 {r1:.4f} mAP {mAP:.4f}; "
          f"card {card}")
    assert abs(mAP - card["mAP"]) < MARGIN, (mAP, card)
    assert abs(r1 - card["rank1"]) <= 1 / 16 + 1e-9, (r1, card)


def test_tool_needs_a_card_unless_asked(monkeypatch, tmp_path):
    """Without a card the tool raises before it writes anything; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "band.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        band_tool.main(["0", "--out", str(out)])
    with pytest.raises(RuntimeError):
        band_tool.train_once(None, 0, device="cuda")
    assert not out.exists()


# ---- ImageDataset ----------------------------------------------------------


def _image(path, h=80, w=40, seed=0):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path)
    return str(path)


def test_image_dataset_item_matches_agrl_tpu(tmp_path):
    p = _image(tmp_path / "img.png")
    ours = TorchImageDataset([(p, 3, 1)], height=64, width=32)
    theirs = JaxImageDataset([(p, 3, 1)], height=64, width=32)
    assert len(ours) == len(theirs) == 1
    img, pid, camid = ours.get_item(0)
    want = theirs.get_item(0)
    assert img.shape == (64, 32, 3) and img.dtype == np.uint8 and (pid, camid) == (3, 1)
    np.testing.assert_array_equal(img, want[0])
    assert (pid, camid) == want[1:]


def test_image_dataset_through_cliploader_matches_agrl_tpu(tmp_path):
    """Items without an adjacency collate with an all-ones (B, 1, 1) one,
    two batches bit-equal to agrl_tpu's ClipLoader's."""
    items = [(_image(tmp_path / f"img{i}.png", seed=i), i % 2, 0) for i in range(4)]
    ours = list(TorchClipLoader(TorchImageDataset(items, height=64, width=32), batch_size=2))
    theirs = list(JaxClipLoader(JaxImageDataset(items, height=64, width=32), batch_size=2,
                                num_workers=1))
    assert len(ours) == len(theirs) == 2
    for t, j in zip(ours, theirs):
        imgs, pids, camids, adjs = t
        assert imgs.shape == (2, 64, 32, 3)
        assert adjs.shape == (2, 1, 1) and adjs.dtype == np.float32 and (adjs == 1).all()
        for x, y in zip(t, j):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def sweep_threads(counts=(1, 2, 4, 8)):
    """Measures STEP_BARS' spread: agrl_tpu's two runs once, then the port's
    from them at each CPU thread count; prints each variant's worst step
    differences over its held steps and over all steps, and its converged
    evenly scores.

        JAX_PLATFORMS=cpu python -m tests.test_torch_convergence
    """
    import contextlib
    import io
    import tempfile

    with tempfile.TemporaryDirectory(prefix="band_sweep_") as root:
        tds, jds = _datasets(root)
        jax_runs = {v: _jax_run(jds, lam) for v, lam in (("full", 1.0), ("no_htri", 0.0))}
        for n in counts:
            for variant, lam in (("full", 1.0), ("no_htri", 0.0)):
                with _threads(n), contextlib.redirect_stdout(io.StringIO()):
                    prun = _port_run(tds, jax_runs[variant], lam)
                held = STEP_BARS[variant][0]
                xent, htri = _worst_steps(prun, jax_runs[variant], held)
                xent_all, htri_all = _worst_steps(prun, jax_runs[variant])
                print(f"threads {n} {variant}: steps 1-{held} xent rel {xent:.4f}, htri abs "
                      f"{htri:.4f}; all steps {xent_all:.4f}, {htri_all:.4f}; evenly (rank-1, "
                      f"mAP) agrl_tpu {jax_runs[variant]['evenly']}, port {prun['evenly']}",
                      flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sweep_threads()
