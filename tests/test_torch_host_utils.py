"""The port's host utilities held against agrl_tpu's where it has them:
AsyncCheckpointer (agrl_torch/core/checkpoint.py), the profiler and memory
report (utils/profiling.py), the startup FLOPs count
(utils/model_complexity.py) and the allocator tuning (utils/hostmem.py)."""

import glob
import os.path as osp
import threading
import time

import jax
import optax
import pytest
import torch
from torch import nn

from agrl_torch.core import checkpoint as ckpt_mod
from agrl_torch.core import AsyncCheckpointer, load_checkpoint, save_checkpoint
from agrl_torch.utils import model_complexity as tmc
from agrl_torch.utils import profiling as tprof

torch.set_num_threads(2)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(6, 5)
        self.bn = nn.BatchNorm1d(5)
        self.head = nn.Linear(5, 3)

    def forward(self, x):
        return self.head(torch.relu(self.bn(self.fc(x))))


def _trained(seed=0, steps=2):
    torch.manual_seed(seed)
    net = _Net()
    opt = torch.optim.Adam(net.parameters(), 1e-2)
    _steps(net, opt, steps, seed)
    return net, opt


def _steps(net, opt, n, seed):
    g = torch.Generator().manual_seed(seed + 100)
    for _ in range(n):
        loss = net(torch.randn(8, 6, generator=g)).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()


def _assert_ckpt_equal(a, b):
    ca, cb = (torch.load(p, weights_only=True) for p in (a, b))
    assert ca.keys() == cb.keys()
    assert list(ca["state_dict"]) == list(cb["state_dict"])
    for k in ca["state_dict"]:
        assert torch.equal(ca["state_dict"][k].cpu(), cb["state_dict"][k].cpu()), k
    assert ca["optimizer"]["param_groups"] == cb["optimizer"]["param_groups"]
    for k, v in ca["optimizer"]["state"].items():
        for f, t in v.items():
            assert torch.equal(t.cpu(), cb["optimizer"]["state"][k][f].cpu()), (k, f)
    assert [ca[k] for k in ("epoch", "rank1", "mAP")] == [cb[k] for k in ("epoch", "rank1", "mAP")]
    assert getattr(ca["state_dict"], "_metadata", None) == getattr(cb["state_dict"], "_metadata",
                                                                   None)


def test_async_save_equals_sync_save_though_training_goes_on(tmp_path, monkeypatch):
    """The model and optimizer step (in place) while the write is held
    back: the file still holds the state at save(), as the sync save does,
    and loads into a model and optimizer the same way."""
    net, opt = _trained()
    sync_path, async_path = str(tmp_path / "sync.pth.tar"), str(tmp_path / "async.pth.tar")
    save_checkpoint(net, opt, sync_path, epoch=3, rank1=0.5, mAP=0.25, is_best=False)
    gate = threading.Event()
    real_write = ckpt_mod._write_checkpoint

    def held_write(*args):
        gate.wait(10)
        return real_write(*args)

    monkeypatch.setattr(ckpt_mod, "_write_checkpoint", held_write)
    ck = AsyncCheckpointer()
    ck.save(net, opt, async_path, epoch=3, rank1=0.5, mAP=0.25, is_best=True)
    _steps(net, opt, 3, seed=7)  # overwrite params, BN stats and Adam moments
    gate.set()
    ck.wait()
    _assert_ckpt_equal(sync_path, async_path)
    _assert_ckpt_equal(async_path, str(tmp_path / "best_model.pth.tar"))
    fresh, fresh_opt = _trained(seed=1, steps=1)
    assert load_checkpoint(async_path, fresh, fresh_opt) == {"epoch": 3, "rank1": 0.5,
                                                             "mAP": 0.25}
    ck.close()


def test_async_saves_are_ordered_one_in_flight(tmp_path, monkeypatch):
    windows, submitted = [], []
    real_write = ckpt_mod._write_checkpoint

    def slow_write(*args):
        t0 = time.monotonic()
        time.sleep(0.05)
        real_write(*args)
        windows.append((t0, time.monotonic()))

    monkeypatch.setattr(ckpt_mod, "_write_checkpoint", slow_write)
    net, opt = _trained()
    ck = AsyncCheckpointer()
    for i in range(3):
        save_checkpoint(net, opt, str(tmp_path / f"sync{i}.pth.tar"), epoch=i)
        ck.save(net, opt, str(tmp_path / f"ep{i}.pth.tar"), epoch=i)
        submitted.append(time.monotonic())
        _steps(net, opt, 1, seed=i)
    ck.wait()
    ck.wait()  # idempotent
    assert len(windows) == 6  # 3 sync + 3 async writes
    async_windows = windows[1::2]
    for k in range(2):
        assert submitted[k + 1] >= async_windows[k][1]
    for i in range(3):
        _assert_ckpt_equal(str(tmp_path / f"sync{i}.pth.tar"), str(tmp_path / f"ep{i}.pth.tar"))
    ck.close()


def test_async_error_surfaces_on_the_next_wait(tmp_path):
    net, opt = _trained()
    target = tmp_path / "a_directory.pth.tar"
    target.mkdir()
    ck = AsyncCheckpointer()
    ck.save(net, opt, str(target), epoch=0)
    with pytest.raises(RuntimeError, match="Is a directory"):  # torch.save's error
        ck.wait()
    ok = str(tmp_path / "ok.pth.tar")
    ck.save(net, opt, ok, epoch=1)  # still usable
    ck.close()
    assert load_checkpoint(ok)["epoch"] == 1


def test_trace_writes_a_chrome_trace_and_an_op_table(tmp_path):
    with tprof.trace(str(tmp_path / "prof")) as prof:
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64)).sum()
    assert prof is not None
    (trace_file,) = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    (ops_file,) = glob.glob(str(tmp_path / "prof" / "ops_*.txt"))
    assert osp.getsize(trace_file) > 500 and "traceEvents" in open(trace_file).read()
    assert "aten::matmul" in open(ops_file).read()


def test_device_memory_report_has_agrl_tpu_records():
    from agrl_tpu.utils import profiling as jprof

    lines = []
    got = tprof.device_memory_report(print_fn=lines.append)
    want = jprof.device_memory_report(print_fn=None)
    assert [sorted(r) for r in got] == [sorted(r) for r in want][:len(got)]
    assert lines and all(line.startswith("[mem] ") and "in_use=" in line and "limit=" in line
                         for line in lines)


def _jax_gflops(S, Hh, Ww):
    from agrl_tpu.engine import create_train_state
    from agrl_tpu.models import init_model
    from agrl_tpu.utils.model_complexity import compute_model_complexity

    m = init_model("vmgn_tiny", num_classes=8)
    st = create_train_state(m, optax.adam(1e-3), jax.random.PRNGKey(0), seq_len=S, height=Hh,
                            width=Ww, batch_size=2)
    return compute_model_complexity(m, {"params": st.params, "batch_stats": st.batch_stats},
                                    seq_len=S, height=Hh, width=Ww, verbose=False)


@pytest.mark.parametrize("shape", [(2, 64, 32), (8, 256, 128)])
def test_flops_within_ten_percent_of_agrl_tpu(shape):
    """agrl_tpu's XLA cost analysis vs the port's FlopCounterMode count of
    the same 1-clip eval forward, vmgn_tiny: within 10% (the port counts
    convolutions over their in-bounds taps, as XLA does; XLA also counts
    elementwise work)."""
    from agrl_torch.models import init_model

    model = init_model("vmgn_tiny", num_classes=8, device="cpu", seed=0)
    params, gflops = tmc.compute_model_complexity(model, *shape, verbose=False)
    j_params, j_gflops = _jax_gflops(*shape)
    assert params == pytest.approx(j_params, abs=1e-9)
    assert abs(gflops / j_gflops - 1) < 0.10, (gflops, j_gflops)


def test_flops_equal_with_the_registered_op_and_the_plain_layer(monkeypatch):
    """K1's registered op carries a formula for its three products: the
    count is the same as with the plain layer in its place, whose products
    FlopCounterMode counts one by one; and the model is left as it was."""
    import agrl_torch.models.layers as layers
    from agrl_torch.models import init_model
    from agrl_torch.ops.graph_conv import graph_propagate_reference

    model = init_model("vmgn_tiny", num_classes=8, device="cpu", seed=0)
    model.train()
    x = torch.rand(1, 2, 64, 32, 3)
    adj = torch.ones(1, 14, 14)
    with_op = tmc.count_eval_flops(model, 2, 64, 32)
    assert model.training
    seen = []

    def plain(*args, **kwargs):
        seen.append(1)
        return graph_propagate_reference(*args, **kwargs)

    monkeypatch.setattr(layers, "graph_propagate", plain)
    assert tmc.count_eval_flops(model, 2, 64, 32) == with_op and seen
    B, V, C = 1, 14, 2048
    per_layer = 2 * B * V * C * C + 2 * 2 * B * V * V * C
    assert with_op > 2 * per_layer
    monkeypatch.undo()
    model.eval()
    with torch.no_grad():  # the probe left no fake tensor behind
        assert torch.isfinite(model(x, adj)).all()


def test_malloc_tuning_is_idempotent():
    from agrl_torch.utils.hostmem import tune_malloc_for_streaming

    first = tune_malloc_for_streaming()
    assert tune_malloc_for_streaming() == first
