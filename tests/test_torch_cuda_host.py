"""The host side's card paths: prefetch_to_device's pinned copies on a side
stream, and AsyncCheckpointer's device snapshot. Every test needs an
NVIDIA GPU (marker `cuda`) and skips without one; the file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_host.py
"""

import numpy as np
import pytest
import torch

from agrl_torch.core import AsyncCheckpointer, save_checkpoint
from agrl_torch.data.loader import prefetch_to_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (4, 8, 64, 32, 3)).astype(np.uint8),
             rng.randint(0, 9, 4).astype(np.int32), rng.rand(4, 56, 56).astype(np.float32))
            for _ in range(n)]


def test_prefetch_copies_each_batch_to_the_card(cuda):
    batches = _batches(6)
    out = []
    for dev_batch in prefetch_to_device(iter(batches), size=2, device=cuda):
        assert all(t.is_cuda for t in dev_batch)
        # used on the consumer's stream right away, as the train step does
        out.append(tuple((t.float() * 1).cpu() for t in dev_batch))
    assert len(out) == 6
    for got, want in zip(out, batches):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.float32))


def test_prefetch_never_hands_out_the_source_array(cuda):
    """The pinned staging buffer is a copy: writing to the iterator's array
    after it was handed over does not change the device batch."""
    src = _batches(1)[0]
    it = prefetch_to_device(iter([src]), size=1, device=cuda)
    dev = next(it)
    torch.cuda.synchronize()
    src[0][...] = 0
    assert dev[0].cpu().numpy().any()
    assert list(it) == []


def test_async_checkpoint_of_a_card_model_equals_the_sync_one(cuda, tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.BatchNorm1d(64),
                              torch.nn.Linear(64, 8)).to(cuda)
    opt = torch.optim.Adam(net.parameters(), 1e-2)

    def step():
        loss = net(torch.randn(32, 64, device=cuda)).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

    step()
    save_checkpoint(net, opt, str(tmp_path / "sync.pth.tar"), epoch=0)
    ck = AsyncCheckpointer()
    ck.save(net, opt, str(tmp_path / "async.pth.tar"), epoch=0)
    for _ in range(5):  # in place, on the card, while the copy is in flight
        step()
    ck.close()
    a = torch.load(str(tmp_path / "sync.pth.tar"), map_location="cpu", weights_only=True)
    b = torch.load(str(tmp_path / "async.pth.tar"), map_location="cpu", weights_only=True)
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for k, v in a["optimizer"]["state"].items():
        for f, t in v.items():
            assert torch.equal(t, b["optimizer"]["state"][k][f]), (k, f)
