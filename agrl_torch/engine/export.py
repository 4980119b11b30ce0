"""AOT export and in-process serving of the eval forward (counterpart of
agrl_tpu/engine/export.py).

The eval forward, the exact program the Evaluator runs
(engine/evaluator.py `eval_program`: on-device normalize, the optional
bf16 rounding, the model at its own dtype), is served two ways:

  * `FeatureExtractor(model, ...)`: in-process serving from a live model
    behind one fixed batch shape. A request of any size runs in
    ceil(N / batch_size) forwards of `batch_size` clips; ragged chunks are
    padded with zero frames and an all-ones adjacency, and the padding rows
    are sliced off the output.
  * `export_eval_forward` / `save_exported` / `load_exported`: the same
    program captured by `torch.export` into a `.pt2` file. The weights are
    call-time inputs (a {name: tensor} dict, through
    torch.func.functional_call), so the artifact holds no weights and one
    artifact serves every checkpoint of an arch; preprocessing and the
    bf16 rounding are inside it, which takes uint8 clips and a float32
    adjacency. The graph layers are the registered op
    `agrl_torch::graph_propagate` (ops/graph_conv.py): the kernel on the
    card, the plain version on the CPU. A serving host needs torch, this
    package's `ops.graph_conv` (imported by `load_exported`, it registers
    the op), the artifact and a state dict, and no model code:

    model = init_model("vmgn", num_classes=625, ...)
    exp = export_eval_forward(model, model.state_dict(), batch_size=64,
                              seq_len=8, height=256, width=128)
    save_exported("vmgn_eval.pt2", exp)
    # serving host:
    from agrl_torch.core.checkpoint import load_variables
    fx = FeatureExtractor.from_exported(
        "vmgn_eval.pt2", load_variables("best_model.pth.tar"))
    feats = fx(clips_uint8)  # (N, D) float32, any N (D = 4096 for vmgn)

Archs that read no adjacency (res50tp, resnet50_s1, sta, simple_sta,
msppn and the legacy video archs) are served the same way: `fx(imgs)` with adjs=None passes an
all-ones one, which they ignore. The all-ones adjacency has
`default_num_vertices` vertices: S * total_split * 3 for msppn and msppgn
(168 at --num-split 4 and S = 8), whose vertices span three scales.

`bf16=True` is the default of both, as in agrl_tpu (export.py:57, :132).
The program an artifact holds runs on the device it was exported on.

Serving over several devices of one process (agrl_tpu's `mesh=`,
export.py:116-165): `FeatureExtractor(model, mesh=make_mesh(devices=...))`,
the local-devices form of parallel.make_mesh. The weights are copied once
to each of the mesh's devices, `batch_size` must divide by their count,
and each request chunk (padded as above) splits into equal contiguous
parts, one a device, whose features come back concatenated in order.
`from_exported` refuses a mesh of more than one device, as agrl_tpu's
does: scale artifact serving by process. The local-devices form has no mp
axis. A model placed by `parallel.place_state` (a `--mesh-mp` run's, its
wide Linears held as mp blocks) is served whole: at construction the
FeatureExtractor gathers every block over the model's mp group, once,
with `parallel.whole_weights`'s gather, and serves from its own copy of
the whole weights (K1 on the whole W), as agrl_tpu's FeatureExtractor
replicates whatever variables it is given (export.py:161): a snapshot of
the weights at construction, where a model without blocks is served live.
The trained model keeps its blocks. The gather is a collective: every
rank of the mp group builds its FeatureExtractor, in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from agrl_torch import resolve_device
from agrl_torch.ops import graph_conv  # noqa: F401  (registers the ops an artifact calls)

# NOTE: the evaluator and model imports are lazy (inside the live-model
# branches): serving from an artifact loads no model code.


class _Program(torch.nn.Module):
    """The module torch.export traces: forward(state, imgs, adjs). It holds
    the eval function, not the model, so no weight of the model becomes
    part of the artifact."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, state, imgs, adjs):
        return self.fn(state, imgs, adjs)


def export_eval_forward(
    model,
    state_dict,
    batch_size: int,
    seq_len: int,
    height: int,
    width: int,
    *,
    bf16: bool = True,
    num_vertices: int | None = None,
    device="cuda",
):
    """torch.export the eval forward at a fixed batch shape on `device`.

    Returns a torch.export.ExportedProgram whose module is called as
    `(state, imgs, adjs)`: state the {name: tensor} dict of the model's
    floating-point parameters and buffers (taken from `state_dict`, which
    gives their shapes and dtypes), imgs (batch, seq_len, H, W, 3) uint8,
    adjs (batch, V, V) float32; it returns (batch, D) float32."""
    from agrl_torch.engine.evaluator import eval_program, serving_state
    from agrl_torch.models import default_num_vertices

    dev = resolve_device(device)
    model = model.to(dev).eval()
    if num_vertices is None:
        num_vertices = default_num_vertices(model, seq_len)
    names = serving_state(model).keys()
    missing = sorted(names - state_dict.keys())
    if missing:
        raise KeyError(f"state_dict lacks {len(missing)} tensors of the model, e.g. {missing[:3]}")
    state = {k: torch.as_tensor(state_dict[k]).to(dev) for k in names}
    imgs = torch.zeros((batch_size, seq_len, height, width, 3), dtype=torch.uint8, device=dev)
    adjs = torch.ones((batch_size, num_vertices, num_vertices), dtype=torch.float32, device=dev)
    exported = torch.export.export(
        _Program(eval_program(model, bf16)), (state, imgs, adjs), strict=False
    )
    exported.example_inputs = None  # they hold the weights: keep them out of the artifact
    return exported


def save_exported(path: str, exported) -> None:
    torch.export.save(exported, path)


def load_exported(path: str):
    return torch.export.load(path)


def _signature(exported):
    """(state names in the program's order, imgs shape, adjs shape, device)
    from the program's input signature: the state dict's tensors come
    first, then imgs and adjs."""
    def children(spec):  # TreeSpec.children() replaced .children_specs in torch 2.12
        return spec.children() if hasattr(spec, "child") else spec.children_specs

    args_spec = children(exported.call_spec.in_spec)[0]  # ((state, imgs, adjs), {})
    names = list(children(args_spec)[0].context)
    user = [n for n in exported.graph.nodes if n.op == "placeholder"][-2:]
    img, adj = (n.meta["val"] for n in user)
    return names, tuple(img.shape), tuple(adj.shape), img.device


class FeatureExtractor:
    """Serving-facing feature extraction: `fx(clips_u8, adjs)` -> (N, D)
    float32 numpy features, behind one batch shape. Build it from a live
    model (`FeatureExtractor(model, ...)`, on the card unless device="cpu")
    or from an exported artifact (`FeatureExtractor.from_exported`), which
    needs no model code. `bf16` (default True, as agrl_tpu's) rounds the
    weights, pixels and adjacency to bf16 (engine/evaluator.py
    `eval_program`); bf16=False serves float32.

    Which weights it serves: a model without mp blocks is served live (the
    extractor holds the module itself, moved to `device`), so a request
    sees the weights the model holds at that moment. A model holding mp
    blocks (parallel.place_state) is served from a snapshot: copied whole
    at construction, each block gathered over its mp group, so weights the
    model takes later do not reach the extractor; build a new one to serve
    them. Every rank of that group builds its FeatureExtractor, in the same
    order, as every rank enters parallel.whole_weights; the model keeps its
    blocks. The copy holds the weights and buffers, not the model's
    gradients (a Parameter's deep copy clones its data alone)."""

    def __init__(
        self,
        model=None,
        *,
        batch_size: int = 64,
        seq_len: int = 8,
        bf16: bool = True,
        num_vertices: int | None = None,
        device="cuda",
        mesh=None,
        _call=None,
        _hw=None,
    ):
        if mesh is not None and mesh.distributed:
            raise ValueError("serving takes the local-devices form of the mesh "
                             "(parallel.make_mesh(devices=...)); scale serving by process")
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._hw = _hw  # frame H/W: fixed by an artifact, or locked in by the first request
        if _call is not None:
            self._fwd = _call
            self._num_vertices = num_vertices
            return
        if model is None:
            raise ValueError("pass a model (or use from_exported)")
        from agrl_torch.engine.evaluator import make_eval_forward
        from agrl_torch.models import default_num_vertices
        from agrl_torch.parallel import sharded_weights, whole_weights

        if sharded_weights(model):
            import copy

            with whole_weights(model):  # one gather a block, over its mp group
                model = copy.deepcopy(model)  # the weights, not the gradients
        self.model = model.to(self.device)
        self._num_vertices = (
            num_vertices if num_vertices is not None else default_num_vertices(model, seq_len)
        )
        self._fwd = make_eval_forward(self.model, self.device, bf16)
        if mesh is not None and mesh.dp > 1:
            if batch_size % mesh.dp:
                raise ValueError(f"batch_size {batch_size} must divide over the mesh's "
                                 f"{mesh.dp} devices")
            import copy

            # the weights, copied once to each further device
            replicas = [self._fwd] + [
                make_eval_forward(copy.deepcopy(self.model).to(resolve_device(d)),
                                  resolve_device(d), bf16)
                for d in mesh.devices[1:]]
            self._fwd = _split_over(replicas, batch_size // mesh.dp)

    @classmethod
    def from_exported(cls, path_or_program, state_dict, *, batch_size=None, mesh=None):
        """Serve an artifact of `export_eval_forward` (a path or a loaded
        program) with the weights `state_dict` (e.g. core.checkpoint.
        load_variables): the batch, seq_len, frame size and vertex count
        come from the artifact's input signature, the device from where it
        was exported. Entries of `state_dict` the program does not take
        (num_batches_tracked) are left out; a missing one raises. Sets both
        TF32 switches off, process-wide, as make_eval_forward does. A mesh
        of more than one device is refused: an artifact is a one-device
        program (agrl_tpu/engine/export.py:147-152)."""
        if mesh is not None and mesh.dp > 1:
            raise ValueError("mesh serving needs a live model: an exported artifact is a "
                             "one-device program (scale artifact serving by process)")
        exported = (load_exported(path_or_program) if isinstance(path_or_program, str)
                    else path_or_program)
        names, img_shape, adj_shape, dev = _signature(exported)
        b, s = img_shape[0], img_shape[1]
        if batch_size is not None and batch_size != b:
            raise ValueError(f"artifact was exported at batch {b}, not {batch_size}")
        state_dict = {k[len("module."):] if k.startswith("module.") else k: v
                      for k, v in state_dict.items()}
        missing = [k for k in names if k not in state_dict]
        if missing:
            raise KeyError(f"the artifact takes {len(names)} weight tensors; state_dict lacks "
                           f"{len(missing)}, e.g. {missing[:3]}")
        state = {k: torch.as_tensor(state_dict[k]).to(dev) for k in names}
        module = exported.module()
        # the switches make_eval_forward sets: fp32 products and convolutions
        # in full fp32 (a program does not carry them)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        def call(imgs, adjs):
            with torch.no_grad():
                return module(state, torch.as_tensor(imgs).to(dev),
                              torch.as_tensor(adjs, dtype=torch.float32).to(dev))

        return cls(batch_size=b, seq_len=s, num_vertices=adj_shape[1], device=dev,
                   _call=call, _hw=img_shape[2:4])

    def __call__(self, imgs, adjs=None) -> np.ndarray:
        """imgs: (N, S, H, W, 3) uint8; adjs: (N, V, V) or None (all-ones).
        Returns (N, D) float32 features. N = 0 is served (one padded
        forward, empty result)."""
        imgs = np.asarray(imgs)
        n = imgs.shape[0]
        # reject shape drift up front: one batch shape serves every request
        if imgs.ndim != 5 or imgs.shape[1] != self.seq_len or imgs.shape[4] != 3:
            raise ValueError(
                f"expected clips of shape (N, {self.seq_len}, H, W, 3), got {imgs.shape}"
            )
        if self._hw is None:
            self._hw = (imgs.shape[2], imgs.shape[3])
        elif tuple(imgs.shape[2:4]) != tuple(self._hw):
            raise ValueError(
                f"this extractor serves {self._hw[0]}x{self._hw[1]} frames, "
                f"got {imgs.shape[2]}x{imgs.shape[3]}"
            )
        v = self._num_vertices
        if adjs is not None:
            adjs = np.asarray(adjs, np.float32)
            if adjs.shape != (n, v, v):
                raise ValueError(f"expected adjacency of shape ({n}, {v}, {v}), got {adjs.shape}")
        bs = self.batch_size
        ones = np.ones((bs, v, v), np.float32)  # dummy/padding adjacency
        out = []
        for start in range(0, max(n, 1), bs):  # n == 0 -> one padded run
            im = imgs[start:start + bs]
            ad = ones if adjs is None else adjs[start:start + bs]
            take = im.shape[0]
            if take < bs:
                im = np.concatenate([im, np.zeros((bs - take, *imgs.shape[1:]), imgs.dtype)])
                if adjs is not None:
                    ad = np.concatenate([ad, ones[: bs - take]])
            out.append(self._fwd(im, ad)[:take])  # async on the card
        return torch.cat(out).cpu().numpy()


def _split_over(forwards, part: int):
    """One forward of a batch over several devices: rows [i * part,
    (i + 1) * part) go to forwards[i] (each launched before any result is
    read), and the features come back concatenated in order on the first
    one's device."""

    def fwd(imgs, adjs):
        outs = [f(imgs[i * part:(i + 1) * part], adjs[i * part:(i + 1) * part])
                for i, f in enumerate(forwards)]
        return torch.cat([o.to(outs[0].device) for o in outs])

    return fwd
