"""The port's data parallelism (agrl_torch.parallel) held against
agrl_tpu's single-device functions on the global batch.

Two gloo ranks on the CPU (tests/torch_parallel_worker.py, mode ops) run
the global-batch BatchNorm of each kind and the gathered batch-hard
mining on their slices of one seeded global batch; the one-device
oracles run here on the whole batch: the port's own BatchNorm and
agrl_tpu's flax BatchNorm, and agrl_tpu's deep_supervision of
batch_hard_triplet under jax.value_and_grad. In this process, with no
group: ClipLoader's process_shard against agrl_tpu's, serving over a
two-device CPU mesh, the mesh's refusals and the CLI's pre-flight of a
multi-process run.
"""

import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch.losses import batch_hard_triplet_heads
from agrl_torch.models import backbone
from agrl_torch.parallel import Mesh, make_mesh, shard_batch
from agrl_tpu import losses as jl
from tests.torch_parallel_worker import BN_KINDS, spawn

torch.set_num_threads(2)

WORLD = 2
H, B, D, ROWS = 3, 8, 16, 12  # mining: heads, global batch, width, projection input
LONG_B = 320  # a long global batch: 80 ids x 4 (K3's long schedule on the card)


def _bn_state(rng):
    return {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
            "bias": torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32)),
            "running_mean": torch.from_numpy(rng.normal(0, 0.5, 6).astype(np.float32)),
            "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
            "num_batches_tracked": torch.tensor(3)}


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    rng = np.random.RandomState(0)
    inputs = {"bn_state": _bn_state(rng)}
    for kind, shape in BN_KINDS.items():
        # a channel offset well above the spread: the variance must not
        # come from a cancelling E[x^2] - E[x]^2
        x = rng.normal(0, 1, shape) * rng.uniform(0.5, 2, (1, 6) + (1,) * (len(shape) - 2)) + 3.0
        inputs[f"x_{kind}"] = torch.from_numpy(x.astype(np.float32))
        inputs[f"g_{kind}"] = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    inputs["feats"] = torch.from_numpy(rng.normal(0, 1, (H, B, D)).astype(np.float32))
    inputs["labels"] = torch.from_numpy(np.repeat(np.arange(B // 2), 2))
    inputs["rows"] = torch.from_numpy(rng.normal(0, 1, (B, ROWS)).astype(np.float32))
    inputs["proj"] = torch.from_numpy(rng.normal(0, 0.3, (D, ROWS)).astype(np.float32))
    centres = rng.normal(0, 0.3, (LONG_B // 4, D))
    inputs["labels_long"] = torch.from_numpy(np.repeat(np.arange(LONG_B // 4), 4))
    inputs["feats_long"] = torch.from_numpy(
        (rng.normal(0, 1, (2, LONG_B, D)) + centres[inputs["labels_long"].numpy()])
        .astype(np.float32))
    return inputs, spawn("ops", inputs, tmp_path_factory.mktemp("ops"), world=WORLD)


def _full_bn(inputs, kind, frozen):
    """One BN of the port over the whole batch, the same upstream gradient."""
    bn = getattr(backbone, kind.split("_")[0])(6, eps=1e-5)
    bn.load_state_dict(inputs["bn_state"])
    bn.train()
    x = inputs[f"x_{kind}"].clone().requires_grad_(True)
    with backbone.frozen_running_stats() if frozen else torch.enable_grad():
        y = bn(x)
    (y * inputs[f"g_{kind}"]).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad, db=bn.bias.grad,
                running_mean=bn.running_mean, running_var=bn.running_var,
                tracked=int(bn.num_batches_tracked))


@pytest.mark.parametrize("frozen", [False, True], ids=["update", "frozen"])
@pytest.mark.parametrize("kind", sorted(BN_KINDS))
def test_global_batchnorm_matches_one_bn_over_the_global_batch(ops, kind, frozen):
    """Each rank's output and input gradient equal its slice of one BN's
    over the concatenated batch; the ranks' weight and bias gradients sum
    to its (the train step averages them with the rest: the objective here
    is the sum of the ranks' terms); the running statistics (flax's rule
    with the biased global variance, or untouched under
    frozen_running_stats) equal its on both ranks. Tolerance: 2e-6 of each
    tensor's largest entry (fp32, sums over 8 to 120 rows)."""
    inputs, ranks = ops
    want = _full_bn(inputs, kind, frozen)
    got = [r[f"{kind}/{frozen}"] for r in ranks]

    def close(a, b, name):
        assert torch.allclose(a, b, rtol=0, atol=2e-6 * float(b.abs().max())), name

    for key in ("y", "dx"):
        close(torch.cat([g[key] for g in got]), want[key], key)
    for key in ("dw", "db"):
        close(sum(g[key] for g in got), want[key], key)
    for g in got:
        for key in ("running_mean", "running_var"):
            close(g[key], want[key], key)
        assert g["tracked"] == want["tracked"] == (3 if frozen else 4)
    if frozen:
        assert torch.equal(got[0]["running_var"], inputs["bn_state"]["running_var"])


def test_global_batchnorm2d_matches_flax_on_the_global_batch(ops):
    """agrl_tpu's flax BatchNorm (momentum 0.9, eps 1e-5, in its two-pass
    variance configuration: the shipped one-pass E[x^2] - E[x]^2 loses
    ~1e-6 relative here, where the channels sit at 3 with unit spread) on
    the whole NHWC batch: the ranks' outputs (2e-6 of max) and the running
    statistics after the update, whose variance is the biased one (1e-6 of
    max)."""
    inputs, ranks = ops
    st = inputs["bn_state"]
    x = inputs["x_BatchNorm2d"].permute(0, 2, 3, 1).numpy()
    variables = {"params": {"scale": st["weight"].numpy(), "bias": st["bias"].numpy()},
                 "batch_stats": {"mean": st["running_mean"].numpy(),
                                 "var": st["running_var"].numpy()}}
    y, mutated = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                                     use_fast_variance=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    got = torch.cat([r["BatchNorm2d/False"]["y"] for r in ranks]).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=0, atol=2e-6 * np.abs(y).max())
    for r in ranks:
        for key, flax_key in (("running_mean", "mean"), ("running_var", "var")):
            want = np.asarray(mutated["batch_stats"][flax_key])
            np.testing.assert_allclose(r["BatchNorm2d/False"][key].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


def _jax_mining(feats, labels):
    """agrl_tpu's deep_supervision(batch_hard_triplet) over the heads of the
    whole batch: the loss and its gradient in the features."""
    def loss(f):
        return jl.deep_supervision(lambda x, y: jl.batch_hard_triplet(x, y, 0.3, soft=True),
                                   list(f), jnp.asarray(labels))

    value, grad = jax.value_and_grad(loss)(jnp.asarray(feats))
    return float(value), np.asarray(grad)


def test_gathered_mining_matches_the_global_batch(ops):
    """The loss on every rank is the global batch's (rtol 1e-6 against
    agrl_tpu's and the port's plain twin on the whole batch). Each rank's
    feature gradient, as the step's average over the ranks takes it (the
    gather's backward sums the ranks' gradients of the one loss: divided by
    the world size), equals its slice of the whole batch's gradient (atol
    1e-6 of max); a factor of the world size either way fails it."""
    inputs, ranks = ops
    feats, labels = inputs["feats"], inputs["labels"]
    value, grad = _jax_mining(feats.numpy(), labels.numpy())
    plain = [f.clone().requires_grad_(True) for f in feats]
    plain_loss = batch_hard_triplet_heads(plain, labels)
    plain_loss.backward()
    plain_grad = torch.stack([f.grad for f in plain])
    np.testing.assert_allclose(plain_grad.numpy(), grad, rtol=0, atol=1e-6 * np.abs(grad).max())
    k = B // WORLD
    for r, rank in enumerate(ranks):
        got = rank["mining"]
        np.testing.assert_allclose(float(got["loss"]), value, rtol=1e-6)
        np.testing.assert_allclose(float(got["loss"]), float(plain_loss.detach()), rtol=1e-6)
        want = grad[:, r * k:(r + 1) * k]
        np.testing.assert_allclose(got["grads"].numpy() / WORLD, want, rtol=0,
                                   atol=1e-6 * np.abs(grad).max())


def test_gathered_mining_of_a_long_batch_matches_the_global_batch(ops):
    """The same at a global batch of 320 (two heads, 160 rows a rank; on the
    card the gathered batch takes K3's long schedule): the loss on both
    ranks within rtol 1e-6 of agrl_tpu's on the whole batch, each rank's
    feature gradient over the world size its slice of agrl_tpu's (atol
    1e-6 of max)."""
    inputs, ranks = ops
    feats, labels = inputs["feats_long"], inputs["labels_long"]
    value, grad = _jax_mining(feats.numpy(), labels.numpy())
    k = LONG_B // WORLD
    for r, rank in enumerate(ranks):
        got = rank["mining_long"]
        np.testing.assert_allclose(float(got["loss"]), value, rtol=1e-6)
        np.testing.assert_allclose(got["grads"].numpy() / WORLD, grad[:, r * k:(r + 1) * k],
                                   rtol=0, atol=1e-6 * np.abs(grad).max())


def test_gathered_mining_parameter_gradient_has_no_world_factor(ops):
    """A parameter ahead of the heads (a shared projection P): its gradient
    averaged over the ranks equals its gradient on the whole batch (rtol
    1e-5 of max): the world-size factor of the gather's backward and the
    average cancel."""
    inputs, ranks = ops
    proj = torch.nn.Linear(ROWS, D, bias=False)
    proj.weight.data.copy_(inputs["proj"])
    feats = proj(inputs["rows"])
    batch_hard_triplet_heads([feats * (h + 1) for h in range(H)], inputs["labels"]).backward()
    want = proj.weight.grad
    for rank in ranks:
        got = rank["mining"]["proj_grad"]
        assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(ranks[0]["mining"]["proj_grad"], ranks[1]["mining"]["proj_grad"])


def test_no_group_means_no_collective(monkeypatch):
    """Without global_batch_stats a train-mode BN takes today's path: no
    collective is called (torch.distributed raises if one were)."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a collective ran without a mesh")

    for name in ("all_gather", "all_reduce", "broadcast"):
        monkeypatch.setattr(dist, name, refuse)
    bn = backbone.BatchNorm2d(4).train()
    bn(torch.randn(3, 4, 2, 2)).sum().backward()
    feats = [torch.randn(4, 8, requires_grad=True) for _ in range(2)]
    batch_hard_triplet_heads(feats, torch.tensor([0, 0, 1, 1])).backward()


# --- process_shard: ClipLoader against agrl_tpu's --------------------------

@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from agrl_tpu.data.datasets import init_vidreid_dataset

    return init_vidreid_dataset("synthetic", root=str(tmp_path_factory.mktemp("data")),
                                num_pids=5, tracklets_per_pid=3, frames_per_tracklet=(6, 12),
                                height=32, width=16, verbose=False)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampler", "in_order"])
def test_process_shard_matches_agrl_tpu(synthetic, sampled):
    """Both ranks of a 2-process run over two epochs: the items (pids,
    camids, frames), their per-item seeds and the loader lengths equal
    agrl_tpu's ClipLoader(process_shard=...) on the same dataset; batch 6
    over 2 processes, and in order over the 15 gallery-less train tracklets
    the ragged tail (15 = 2 x 6 + 3) keeps 1 item a rank."""
    from agrl_torch.data.loader import ClipLoader, VideoClipDataset
    from agrl_torch.data.samplers import RandomIdentitySamplerV1
    from agrl_tpu.data.loader import ClipLoader as JaxLoader
    from agrl_tpu.data.loader import VideoClipDataset as JaxDataset
    from agrl_tpu.data.samplers import RandomIdentitySamplerV1 as JaxSampler

    train = synthetic.train
    for rank in range(WORLD):
        kw = dict(batch_size=6, drop_last=False, seed=3, process_shard=(rank, WORLD))
        port = ClipLoader(VideoClipDataset(train, seq_len=4, sample="random", height=32,
                                           width=16),
                          sampler=RandomIdentitySamplerV1(train, 2, seed=1) if sampled else None,
                          num_workers=1, **kw)
        jaxl = JaxLoader(JaxDataset(train, seq_len=4, sample="random", height=32, width=16),
                         sampler=JaxSampler(train, 2, seed=1) if sampled else None,
                         num_workers=1, **kw)
        assert len(port) == len(jaxl)
        for _ in range(2):
            got, want = list(port), list(jaxl)
            assert len(got) == len(want) == len(port)
            for g, w in zip(got, want):
                assert g[0].shape[0] == 6 // WORLD or g is got[-1]
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
    # in order, the tail of 3 leaves 1 item a rank; a tail shorter than the
    # world yields nothing
    tail = ClipLoader(VideoClipDataset(train[:13], seq_len=4, sample="evenly", height=32,
                                       width=16), batch_size=6, process_shard=(1, WORLD))
    assert len(tail) == 2 and [b[0].shape[0] for b in tail] == [3, 3]


def test_process_shard_refuses_an_indivisible_batch():
    from agrl_torch.data.loader import ClipLoader

    with pytest.raises(ValueError, match="does not divide over 3"):
        ClipLoader([], batch_size=4, process_shard=(0, 3))
    with pytest.raises(ValueError, match="not in"):
        ClipLoader([], batch_size=4, process_shard=(2, 2))


# --- the mesh itself ---------------------------------------------------------

def test_make_mesh_forms_and_refusals():
    """Without a group: the local-devices form over given devices, which is
    data-parallel serving (agrl_tpu's FeatureExtractor replicates over mp):
    mp > 1 there raises; in a process group of one process, mp = 2 does
    not divide the world and raises naming both; shard_batch takes the
    rank's contiguous dp slice."""
    import torch.distributed as dist

    from tests.torch_parallel_worker import free_port

    mesh = make_mesh(devices=["cpu", "cpu"])
    assert (mesh.dp, mesh.rank, mesh.distributed) == (2, 0, False)
    assert make_mesh(dp=1, devices=["cpu", "cpu"]).dp == 1
    with pytest.raises(ValueError, match="local-devices form is data-parallel"):
        make_mesh(mp=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs that many devices"):
        make_mesh(dp=3, devices=["cpu", "cpu"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        with pytest.raises(ValueError, match="mp=2 does not divide the world of 1"):
            make_mesh(mp=2)
        one = make_mesh(mp=1)
        assert (one.dp, one.mp, one.rank, one.world, one.distributed) == (1, 1, 0, 1, True)
    finally:
        dist.destroy_process_group()
    rank1 = Mesh(dp=2, dp_index=1, devices=(torch.device("cpu"),), dp_group=object())
    a, b = shard_batch(rank1, np.arange(6), np.arange(12).reshape(6, 2))
    np.testing.assert_array_equal(a, [3, 4, 5])
    np.testing.assert_array_equal(b, [[6, 7], [8, 9], [10, 11]])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(rank1, np.arange(5))


def test_initialize_distributed_refusals(monkeypatch):
    """No arguments and no torchrun variables, a partial set of arguments,
    or a card asked for where there is none: each raises before any group."""
    from agrl_torch.parallel import initialize_distributed

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("127.0.0.1:1", 2, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            initialize_distributed("127.0.0.1:1", 1, 0)


# --- mesh serving -------------------------------------------------------------

def test_mesh_serving_matches_one_device(tmp_path):
    """FeatureExtractor over a two-entry CPU device list (weights copied to
    each, every 4-clip chunk split 2 + 2) gives one device's features
    bit for bit, for 1-, 4- and 7-clip requests; batch_size must divide
    over the mesh; a process-group mesh and from_exported with a mesh of
    two devices are refused."""
    from agrl_torch.engine.export import FeatureExtractor, export_eval_forward
    from agrl_torch.models import init_model

    model = init_model("vmgn_tiny", num_classes=4, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    mesh = make_mesh(devices=["cpu", "cpu"])
    one = FeatureExtractor(copy.deepcopy(model), batch_size=4, seq_len=4, bf16=False,
                           device="cpu")
    two = FeatureExtractor(model, batch_size=4, seq_len=4, bf16=False, mesh=mesh)
    for n in (1, 4, 7):
        imgs = rng.randint(0, 256, (n, 4, 32, 16, 3)).astype(np.uint8)
        np.testing.assert_array_equal(two(imgs), one(imgs))
    with pytest.raises(ValueError, match="divide over"):
        FeatureExtractor(model, batch_size=3, seq_len=4, mesh=mesh)
    grouped = Mesh(dp=2, dp_index=0, devices=(torch.device("cpu"),), dp_group=object())
    with pytest.raises(ValueError, match="local-devices form"):
        FeatureExtractor(model, batch_size=4, seq_len=4, mesh=grouped)
    exp = export_eval_forward(model, model.state_dict(), 4, 4, 32, 16, device="cpu")
    with pytest.raises(ValueError, match="one-device program"):
        FeatureExtractor.from_exported(exp, model.state_dict(), mesh=mesh)


# --- the CLI's pre-flight of a multi-process run ------------------------------

PREFLIGHT = {
    # extra argv -> what the refusal names
    "mesh_mp": (["--mesh-mp", "2", "--dist-coordinator", "127.0.0.1:1", "--dist-num-processes",
                 "3", "--dist-process-id", "0"], ("--mesh-mp 2", "mp=2", "3 process(es)")),
    "mesh_dp_not_world": (["--mesh-dp", "3", "--dist-coordinator", "127.0.0.1:1",
                           "--dist-num-processes", "2", "--dist-process-id", "0"],
                          ("--mesh-dp 3", "2 process(es)")),
    "indivisible_batch": (["--train-batch", "5", "--dist-coordinator", "127.0.0.1:1",
                           "--dist-num-processes", "2", "--dist-process-id", "1"],
                          ("--train-batch 5", "2 processes")),
    "partial_dist_flags": (["--dist-coordinator", "127.0.0.1:1", "--dist-num-processes", "2"],
                           ("--dist-coordinator", "missing --dist-process-id")),
    "process_id_out_of_range": (["--dist-coordinator", "127.0.0.1:1", "--dist-num-processes",
                                 "2", "--dist-process-id", "2"], ("--dist-process-id 2",)),
    "torchrun_world": (["--train-batch", "6"], ("--train-batch 6", "4 processes")),
}


@pytest.mark.parametrize("case", sorted(PREFLIGHT))
def test_preflight_of_a_multi_process_run(case, tmp_path, monkeypatch):
    """Each refusal comes before any data is read or group made."""
    import torch.distributed as dist

    from agrl_torch.cli import train_vidreid_xent_htri as tcli

    extra, named = PREFLIGHT[case]

    def no_data(*args, **kwargs):
        raise AssertionError("the catalog was read before the refusal")

    monkeypatch.setattr("agrl_torch.data.datasets.init_vidreid_dataset", no_data)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    if case == "torchrun_world":
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("RANK", "0")
    base = ["--use-cpu", "--root", str(tmp_path / "absent"), "--save-dir",
            str(tmp_path / "log"), "-a", "vmgn_tiny"]
    with pytest.raises(SystemExit) as exc:
        tcli.main(base + extra)
    msg = str(exc.value)
    assert all(n in msg for n in named), msg
    assert not dist.is_initialized()
    assert not (tmp_path / "log").exists()


def test_a_run_without_dist_flags_makes_no_group(monkeypatch):
    from agrl_torch.cli import train_vidreid_xent_htri as tcli

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    args = tcli.build_parser().parse_args([])
    assert not tcli.distributed_run(args) and tcli.process_count(args) == 1
    args = tcli.build_parser().parse_args(["--dist-coordinator", "h:1", "--dist-num-processes",
                                           "3", "--dist-process-id", "0"])
    assert tcli.distributed_run(args) and tcli.process_count(args) == 3
