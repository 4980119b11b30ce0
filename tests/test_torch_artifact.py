"""The port's serving artifact: torch.export of the eval forward with the
weights as call-time inputs (agrl_tpu's jax.export path,
agrl_tpu/engine/export.py), its round trip through a .pt2 file, serving
from it with no model code, and the export CLI held against agrl_tpu's
tools/export_model.py. CPU artifacts of vmgn_tiny at 64x32, S=4, batch 2.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from agrl_torch.cli import export_model as port_cli
from agrl_torch.core.checkpoint import load_variables, save_checkpoint
from agrl_torch.engine.export import (
    FeatureExtractor,
    export_eval_forward,
    load_exported,
    save_exported,
)
from agrl_torch.models import init_model
from agrl_torch.optim import init_optim
from agrl_tpu.core import save_checkpoint as jax_save_checkpoint
from agrl_tpu.engine.evaluator import make_eval_forward as jax_make_eval_forward
from agrl_tpu.engine.export import load_exported as jax_load_exported
from agrl_tpu.models import init_model as jax_init_model
from agrl_tpu.models import init_params
from tests.test_torch_vmgn import _randomize

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
S, H, W, BATCH, V = 4, 64, 32, 2, 28
ARTIFACT_MAX_BYTES = 4 * 2**20  # the graph alone (measured ~0.7-0.9 MB); weights are ~90 MB


def _clips(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, S, H, W, 3)).astype(np.uint8),
            ((rng.rand(n, V, V) > 0.5) + np.eye(V)).astype(np.float32))


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def model():
    return init_model("vmgn_tiny", num_classes=5, device="cpu", seed=3)


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """{bf16: (path, exported program)}: a bf16 and a float32 artifact."""
    out = {}
    for bf16 in (True, False):
        path = str(tmp_path_factory.mktemp("artifact") / "vmgn_tiny_eval.pt2")
        exported = export_eval_forward(model, model.state_dict(), BATCH, S, H, W,
                                       bf16=bf16, device="cpu")
        save_exported(path, exported)
        out[bf16] = path, exported
    return out


BF16 = pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])


@BF16
def test_round_trip_matches_the_live_forward(model, artifacts, bf16):
    """A loaded artifact serves a ragged 3-clip request and an empty one
    within 1e-5 of the live FeatureExtractor (agrl_tpu's tests/
    test_export.py bar), bf16 and fp32."""
    path = artifacts[bf16][0]
    fx = FeatureExtractor.from_exported(path, model.state_dict())
    live = FeatureExtractor(model, batch_size=BATCH, seq_len=S, bf16=bf16, device="cpu")
    imgs, adjs = _clips(3, 0)
    got, want = fx(imgs, adjs), live(imgs, adjs)
    assert got.shape == (3, 4096) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fx(imgs), live(imgs), atol=1e-5, rtol=1e-5)
    assert fx(imgs[:0]).shape == (0, 4096)


@BF16
def test_from_exported_infers_shapes_and_refuses_a_batch_mismatch(model, artifacts, bf16):
    exported = artifacts[bf16][1]
    fx = FeatureExtractor.from_exported(exported, model.state_dict(), batch_size=BATCH)
    assert (fx.batch_size, fx.seq_len, fx._num_vertices, tuple(fx._hw)) == (BATCH, S, V, (H, W))
    assert fx.device == torch.device("cpu")
    with pytest.raises(ValueError, match=f"artifact was exported at batch {BATCH}, not 3"):
        FeatureExtractor.from_exported(exported, model.state_dict(), batch_size=3)
    with pytest.raises(ValueError):  # the frame size is the artifact's
        fx(np.zeros((1, S, H + 8, W, 3), np.uint8))
    partial = {k: v for k, v in model.state_dict().items() if "graph_layers" not in k}
    with pytest.raises(KeyError, match="lacks"):
        FeatureExtractor.from_exported(exported, partial)


@BF16
def test_artifact_holds_no_weights(model, artifacts, bf16):
    """Weights are call-time inputs: the program's parameters, buffers and
    example inputs are empty, its constants are the normalization and
    pooling tables (a few dozen numbers), and the file is the graph
    alone."""
    path, exported = artifacts[bf16]
    assert not exported.state_dict and exported.example_inputs is None
    assert sum(t.numel() for t in exported.constants.values()) < 100
    size = os.path.getsize(path)
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    assert size < ARTIFACT_MAX_BYTES < weights, (size, weights)
    loaded = load_exported(path)
    assert not loaded.state_dict
    ops = {str(n.target) for n in loaded.graph.nodes if n.op == "call_function"}
    assert "agrl_torch.graph_propagate.default" in ops


def test_a_process_with_no_model_code_serves_the_artifact(model, artifacts, tmp_path):
    """Serving host: torch, agrl_torch.ops (through engine.export), the
    artifacts and a checkpoint read by load_variables; agrl_torch.models,
    the Evaluator and JAX are never imported."""
    ckpt = str(tmp_path / "best_model.pth.tar")
    save_checkpoint(model, init_optim("adam", model.parameters(), 1e-4), ckpt, epoch=0)
    imgs, adjs = _clips(3, 1)
    np.save(tmp_path / "imgs.npy", imgs)
    np.save(tmp_path / "adjs.npy", adjs)
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "from agrl_torch.core.checkpoint import load_variables\n"
        "from agrl_torch.engine.export import FeatureExtractor\n"
        f"state = load_variables({ckpt!r})\n"
        "imgs, adjs = np.load('imgs.npy'), np.load('adjs.npy')\n"
        f"for name, path in (('bf16', {artifacts[True][0]!r}), ('fp32', {artifacts[False][0]!r})):\n"
        "    np.save(name + '.npy', FeatureExtractor.from_exported(path, state)(imgs, adjs))\n"
        "print(json.dumps([m for m in sys.modules if m.startswith(("
        "'agrl_torch.models', 'agrl_torch.engine.evaluator', 'jax', 'agrl_tpu'))]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for name, bf16 in (("bf16", True), ("fp32", False)):
        live = FeatureExtractor(model, batch_size=BATCH, seq_len=S, bf16=bf16, device="cpu")
        np.testing.assert_allclose(np.load(tmp_path / f"{name}.npy"), live(imgs, adjs),
                                   atol=1e-5, rtol=1e-5)


def test_load_variables_is_the_checkpoints_state_dict(model, tmp_path):
    ckpt = str(tmp_path / "checkpoint_ep1.pth.tar")
    save_checkpoint(model, init_optim("adam", model.parameters(), 1e-4), ckpt, epoch=0)
    got = load_variables(ckpt)
    want = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="export_model"):
        load_variables(str(tmp_path / "best_model.msgpack"))


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_export_model",
                                                  REPO / "tools" / "export_model.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def msgpack_ckpt(tmp_path_factory):
    """agrl_tpu vmgn_tiny variables (randomized BN statistics) in its
    msgpack checkpoint format."""
    jmodel = jax_init_model("vmgn_tiny", num_classes=5)
    variables = init_params(jmodel, jax.random.PRNGKey(1), seq_len=S, height=H, width=W)
    variables = _randomize(jax.tree.map(np.asarray, dict(variables)), seed=2)
    path = str(tmp_path_factory.mktemp("msgpack") / "best_model.msgpack")
    jax_save_checkpoint(variables, path, epoch=0)
    return jmodel, variables, path


def test_export_cli_matches_agrl_tpus_tool_on_a_msgpack(msgpack_ckpt, tmp_path, capsys):
    """`python -m agrl_torch.cli.export_model` and agrl_tpu's
    tools/export_model.py on the same agrl_tpu checkpoint, both at their
    bf16 default with vmgn_tiny (dtype None: a bf16 trunk): features within
    1e-2 of max, and the port no further from float32 than twice agrl_tpu's
    bf16-vs-fp32 distance. The port's artifact serves the converted weights
    its CLI wrote beside it."""
    jmodel, variables, ckpt = msgpack_ckpt
    flags = ["-a", "vmgn_tiny", "--num-classes", "5", "--load-weights", ckpt,
             "--pyramid-part", "--use-pose", "--learn-graph", "--batch", str(BATCH),
             "--seq-len", str(S), "--height", str(H), "--width", str(W)]
    port_out, jax_out = str(tmp_path / "port.pt2"), str(tmp_path / "jax.jaxexp")
    port_cli.main(flags + ["--device", "cpu", "--out", port_out])
    printed = capsys.readouterr().out
    assert "Exported vmgn_tiny eval forward (batch 2, seq 4, 64x32, bf16, device cpu)" in printed
    weights = str(tmp_path / "port.weights.pth")
    assert f"-> {weights}" in printed
    _jax_tool().main(flags + ["--out", jax_out])

    imgs, adjs = _clips(BATCH, 2)
    port16 = FeatureExtractor.from_exported(port_out, load_variables(weights))(imgs, adjs)
    jax16 = np.asarray(jax_load_exported(jax_out).call(variables, imgs, adjs))
    assert _rel(port16, jax16) <= 1e-2, _rel(port16, jax16)

    port_cli.main(flags + ["--device", "cpu", "--no-bf16", "--out", str(tmp_path / "f.pt2")])
    port32 = FeatureExtractor.from_exported(str(tmp_path / "f.pt2"),
                                            load_variables(weights))(imgs, adjs)
    jax32 = np.asarray(jax_make_eval_forward(jmodel, False)[0](variables, imgs, adjs))
    np.testing.assert_allclose(port32, jax32, atol=5e-4, rtol=1e-4)
    assert _rel(port16, port32) <= 2 * _rel(jax16, jax32)


def test_export_cli_refuses_a_partial_load(msgpack_ckpt, tmp_path):
    ckpt = msgpack_ckpt[2]
    with pytest.raises(SystemExit, match="--allow-partial"):
        port_cli.main(["-a", "vmgn_tiny", "--num-classes", "7", "--load-weights", ckpt,
                       "--pyramid-part", "--use-pose", "--learn-graph", "--device", "cpu",
                       "--out", str(tmp_path / "x.pt2")])
    assert not (tmp_path / "x.pt2").exists()
