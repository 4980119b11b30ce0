"""The port's multi-head batch-hard mining (K3 over the H heads of a train
step: the plain twins of the forward and backward kernels, the
autograd.Function the card runs them in, and the multi-head loss) held
against agrl_tpu's Pallas kernel (interpret mode), its jnp twin and
jax.value_and_grad of deep_supervision(batch_hard_triplet, ...), on the
same numpy inputs."""

import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agrl_torch import losses as tl
from agrl_torch.ops import triplet
from agrl_tpu import losses as jl
from agrl_tpu.ops.triplet import hard_mine_pallas

D = 2048
SHAPES = [(1, 16), (3, 15), (5, 16)]  # (H, B): one head, a ragged batch, a train step
# and the 22 heads of an msppn/msppgn step at --num-split 4
LOSS_SHAPES = SHAPES + [(22, 16)]


def _heads(H, B, seed=0, K=4, D=D, scale=0.5):
    """H heads over one P x K batch (a ragged B cuts the last identity
    short), spread enough that no two distances of a row tie."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(-(-B // K)), K)[:B].astype(np.int32)
    heads = [((rng.randn(B, D) + labels[:, None] * 0.1) * scale).astype(np.float32)
             for _ in range(H)]
    return heads, labels


def _twins(heads, labels):
    """_HardMineHeads with the plain twins injected for the two kernels."""
    return triplet._HardMineHeads.apply(
        labels, triplet.hard_mine_heads_reference, triplet.hard_mine_backward_reference, *heads)


def _jax_loss_and_grads(heads, labels, margin=0.3, soft=True):
    crit = partial(jl.batch_hard_triplet, margin=margin, soft=soft)
    loss, grads = jax.value_and_grad(
        lambda xs: jl.deep_supervision(crit, xs, jnp.asarray(labels))
    )([jnp.asarray(h) for h in heads])
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("H,B", SHAPES)
def test_heads_reference_matches_pallas_and_jnp(H, B):
    heads, labels = _heads(H, B, seed=H)
    d_ap, d_an, i_ap, i_an = triplet.hard_mine_heads_reference(
        [torch.from_numpy(h) for h in heads], torch.from_numpy(labels))
    assert d_ap.shape == d_an.shape == i_ap.shape == i_an.shape == (H, B)
    pos = labels[:, None] == labels[None, :]
    for h, f in enumerate(heads):
        pal_ap, pal_an = hard_mine_pallas(jnp.asarray(f), jnp.asarray(labels), interpret=True)
        dist = np.asarray(jl.pairwise_euclidean(jnp.asarray(f)))
        want_ap, want_an = jl.hard_mine(jnp.asarray(dist), jnp.asarray(labels))
        # fp32 both ways: only the Gram's summation order differs
        for got, want in ((d_ap[h], pal_ap), (d_an[h], pal_an), (d_ap[h], want_ap),
                          (d_an[h], want_an)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(i_ap[h].numpy(), np.where(pos, dist, -np.inf).argmax(1))
        np.testing.assert_array_equal(i_an[h].numpy(), np.where(pos, np.inf, dist).argmin(1))


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("H,B", LOSS_SHAPES)
def test_heads_loss_and_gradients_match_jax(H, B, soft):
    """The kernel path's structure (one mining call for all heads, the
    hand-written backward) with the plain twins: loss rtol 1e-6, every
    head's gradient atol 1e-5 against jax.value_and_grad. Entries of ~0.05
    (distances ~3, the scale of tests/test_torch_losses.py): the hinge's
    d_ap - d_an cancels, so larger distances would magnify the Gram's fp32
    rounding past the loss's rtol."""
    heads, labels = _heads(H, B, seed=10 + H, scale=0.05)
    xs = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    loss = tl.mean_over_heads(tl.triplet_from_distances(
        *_twins(xs, torch.from_numpy(labels)), soft=soft))
    loss.backward()
    want_loss, want_grads = _jax_loss_and_grads(heads, labels, soft=soft)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-6, atol=0)
    for x, want in zip(xs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("H,B", LOSS_SHAPES)
def test_heads_loss_on_cpu_is_deep_supervision(H, B, soft):
    """On CPU tensors the multi-head loss is deep_supervision(batch_hard_
    triplet, ...): bit-equal loss and gradients; and within 1e-6 of the
    JAX package's."""
    heads, labels = _heads(H, B, seed=20 + H)
    results = []
    for fn in (tl.batch_hard_triplet_heads,
               partial(tl.deep_supervision, tl.batch_hard_triplet)):
        xs = [torch.from_numpy(h).requires_grad_(True) for h in heads]
        loss = fn(xs, torch.from_numpy(labels), margin=0.3, soft=soft)
        loss.backward()
        results.append((loss.detach(), [x.grad for x in xs]))
    (got, got_g), (want, want_g) = results
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    np.testing.assert_allclose(float(got), _jax_loss_and_grads(heads, labels, soft=soft)[0],
                               rtol=1e-6, atol=0)


def test_heads_loss_takes_a_single_head():
    heads, labels = _heads(1, 16, seed=30)
    f, y = torch.from_numpy(heads[0]), torch.from_numpy(labels)
    assert torch.equal(tl.batch_hard_triplet_heads(f, y), tl.batch_hard_triplet(f, y))


@pytest.mark.parametrize("grads", ["both", "ap_only", "an_only"])
def test_backward_reference_matches_plain_autograd(grads):
    """The S-matrix backward against autograd through the plain version,
    for random incoming gradients on every head (None where a pick is
    unused)."""
    H, B = 3, 16
    heads, labels = _heads(H, B, seed=40)
    rng = np.random.RandomState(41)
    g_ap = None if grads == "an_only" else torch.from_numpy(rng.randn(H, B).astype(np.float32))
    g_an = None if grads == "ap_only" else torch.from_numpy(rng.randn(H, B).astype(np.float32))
    xs = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    d_ap, d_an = (torch.stack(d) for d in zip(*(
        triplet.hard_mine(triplet.pairwise_euclidean(x), torch.from_numpy(labels)) for x in xs)))
    outs = [(d, g) for d, g in ((d_ap, g_ap), (d_an, g_an)) if g is not None]
    want = torch.autograd.grad([d for d, _ in outs], xs, [g for _, g in outs])
    fs = [torch.from_numpy(h) for h in heads]
    got = triplet.hard_mine_backward_reference(
        fs, *triplet.hard_mine_heads_reference(fs, torch.from_numpy(labels)), g_ap, g_an)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_tied_duplicates_give_the_same_parameter_gradient():
    """In head 1, rows 1 and 2 are the same clip, so anchor 0's hardest
    positive ties. JAX (and the plain path's amax) split the gradient
    between the twins; the kernel path gives it all to the lower index. The
    gradient of a parameter that maps inputs to the heads is the same."""
    rng = np.random.RandomState(3)
    xs = [rng.randn(8, 64).astype(np.float32) for _ in range(3)]
    xs[1][2] = xs[1][1]
    xs[1][3] = xs[1][0] + 0.01 * xs[1][3]  # anchor 0's farthest positive is a twin
    labels = np.repeat(np.arange(2), 4).astype(np.int32)
    w = (rng.randn(64, 256) * 0.1).astype(np.float32)

    def torch_grad(loss_of):
        wt = torch.from_numpy(w).requires_grad_(True)
        loss_of([torch.from_numpy(x) @ wt for x in xs], torch.from_numpy(labels)).backward()
        return wt.grad.numpy()

    def jax_loss(wj):
        return jl.deep_supervision(jl.batch_hard_triplet, [jnp.asarray(x) @ wj for x in xs],
                                   jnp.asarray(labels))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(w)))
    _, _, i_ap, _ = triplet.hard_mine_reference(
        torch.from_numpy(xs[1] @ w), torch.from_numpy(labels))
    assert int(i_ap[0]) in (1, 2)  # a tie the picks resolve to one twin
    for loss_of in (tl.batch_hard_triplet_heads,
                    lambda fs, y: tl.mean_over_heads(tl.triplet_from_distances(*_twins(fs, y)))):
        np.testing.assert_allclose(torch_grad(loss_of), want, atol=1e-5, rtol=0)


def test_anchors_without_negative_carry_no_gradient():
    """One label in every head: d_an is FLT_MAX and nothing flows back."""
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(rng.randn(4, 8).astype(np.float32)).requires_grad_(True)
          for _ in range(3)]
    d_ap, d_an = _twins(xs, torch.zeros(4, dtype=torch.int64))
    assert torch.all(d_an == torch.finfo(torch.float32).max)
    d_an.sum().backward()
    assert all(torch.all(x.grad == 0) for x in xs)


def test_heads_refuse_other_devices():
    heads = [torch.zeros(4, 8, device="meta") for _ in range(2)]
    labels = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        tl.batch_hard_triplet_heads(heads, labels)
    with pytest.raises(ValueError, match="device"):
        triplet.hard_mine_heads(heads, labels)


@pytest.mark.parametrize("case,match", [
    ("too_many_heads", "heads"),
    ("no_heads", "heads"),
    # a long batch, a width that is no multiple of 4 and one past 8192 are
    # taken (the long schedule; zero columns padded): they stop at the
    # device check on CPU tensors
    ("batch_257", "CUDA tensors"),
    ("dim_not_4", "CUDA tensors"),
    ("dim_8196", "CUDA tensors"),
    ("batch_above_grid", "B <= 1048560"),
    ("no_columns", "D > 0"),
    ("shapes_differ", "share one"),
    ("dtypes_differ", "share one"),
    ("labels_length", "labels"),
    ("cpu_tensors", "CUDA tensors"),
])
def test_kernel_wrappers_refuse_before_launching(case, match):
    """The wrappers check every limit before they build or launch
    anything (the grid's: 65535 heads, 65535 x 16 rows); on CPU tensors
    the kernels themselves refuse."""
    f = torch.zeros(16, 64)
    y = torch.zeros(16, dtype=torch.int64)
    big = triplet.MAX_BATCH + 1
    heads = {
        "too_many_heads": [f] * (triplet.MAX_HEADS + 1),
        "no_heads": [],
        "batch_257": [torch.zeros(257, 64)],
        "dim_not_4": [torch.zeros(16, 66)],
        "dim_8196": [torch.zeros(16, 8196)],
        "batch_above_grid": [torch.zeros(big, 4)],
        "no_columns": [torch.zeros(16, 0)],
        "shapes_differ": [f, torch.zeros(16, 128)],
        "dtypes_differ": [f, f.double()],
        "labels_length": [f],
        "cpu_tensors": [f, f],
    }[case]
    labels = {"batch_257": torch.zeros(257, dtype=torch.int64),
              "batch_above_grid": torch.zeros(big, dtype=torch.int64),
              "labels_length": y[:8]}.get(case, y)
    with pytest.raises(ValueError, match=match):
        triplet.hard_mine_heads_kernel(heads, labels)
    if heads:
        with pytest.raises(ValueError, match=match):
            ids = torch.zeros(len(heads), labels.shape[0], dtype=torch.int64)
            dist = torch.ones(len(heads), labels.shape[0])
            triplet.hard_mine_heads_backward_kernel(heads, dist, dist, ids, ids, dist, None)


@pytest.mark.parametrize("H", [64, 65, 94, 190])
def test_head_limit_is_64(H):
    """64 heads is what the launch's own parameter table holds; more go
    through a device table of pointers, so 65, msppgn's 94 at --num-split
    16 and its 190 at 32 pass the head check and stop at the device check
    on CPU tensors, one call each way. The kernel source states the
    table's size and the grid's head limit, which the wrapper compares
    with the built library's at first use; the wrapper picks the table by
    H alone (no caller chooses it)."""
    f = torch.zeros(16, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triplet.hard_mine_heads_kernel([f] * H, torch.zeros(16, dtype=torch.int64))
    from agrl_torch.kernels.build import CSRC_DIR

    src = (CSRC_DIR / "triplet.cu").read_text()
    assert "constexpr int kParamHeads = 64;" in src and "constexpr int kMaxGrid = 65535;" in src
    assert triplet.PARAM_HEADS == 64 and triplet.MAX_HEADS == 65535
    sig = inspect.signature(triplet.hard_mine_heads_kernel).parameters
    assert list(sig) == ["features", "labels"]


def test_stamp_tool_finds_every_phase_of_the_kernels():
    """agrl_torch.kernels.stamp_triplet instruments csrc/triplet.cu by
    text: every phase it stamps is still where it looks for it."""
    from agrl_torch.kernels import stamp_triplet

    src = (stamp_triplet.CSRC_DIR / "triplet.cu").read_text()
    out = stamp_triplet.stamped_source(src)
    for k in range(len(stamp_triplet.FORWARD_PHASES)):
        assert out.count(f"STAMP_F({k})") == 1
    for k in range(len(stamp_triplet.BACKWARD_PHASES)):
        assert out.count(f"STAMP_B({k})") == 1


def test_forks_tool_finds_the_backward_fork():
    """agrl_torch.kernels.triplet_forks builds copies of csrc/triplet.cu
    with the backward's threshold (the largest B of the S-matrix kernel)
    set to 0 and to 256: the one constant it edits is still where it looks
    for it, and nothing else changes."""
    from agrl_torch.kernels import triplet_forks

    src = (triplet_forks.CSRC_DIR / "triplet.cu").read_text()
    for t in (0, 256):
        out = triplet_forks.backward_source(src, t)
        assert out.count(f"constexpr int kShortBackwardBatch = {t};\n") == 1
        assert triplet_forks.backward_source(out, int(triplet_forks._THRESHOLD.search(
            src).group(1))) == src
    assert "if (B <= kShortBackwardBatch) {" in src
