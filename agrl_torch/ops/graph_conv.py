"""Fused eval-mode graph convolution: the CUDA kernel and its plain twin.

Counterpart of agrl_tpu/ops/graph_conv.py (graph_propagate_pallas) and
agrl_tpu/ops/graph_conv_v2.py (graph_propagate_pallas_v2), two Pallas
schedules of one function — the eval-mode VMGN GraphConvLayer, per clip,
with an optional 0/1 vertex mask m (agrl_tpu's `vertex_mask`; P = m m^T,
all ones without it):

    h   = f @ W
    A   = row_l1(adj * P)
    S   = row_l1(2 * sigmoid(-pdist(f)) * P)
    G   = (A + S) / 2     mode "both" (--use-pose --learn-graph)
          A               mode "pose" (--use-pose alone)
          S               mode "learned" (--learn-graph alone)
    out = (1 - gamma) * f + gamma * lrelu_0.1(bn_eval(G @ h))   (convex)
          f + gamma * lrelu_0.1(bn_eval(G @ h))                 (additive)

The modes are agrl_tpu's GraphConvLayer graphs
(agrl_tpu/models/layers.py:219-238); its Pallas kernel builds "both"
only. "pose" needs no Gram, and the kernel skips it. Two flags give
ganet's layer (agrl_tpu/models/layers.py:186-187, 252): `mask_diag`
multiplies P by (1 - I) before both row normalizations, and `additive`
takes the residual x + gamma * h'.

On the card this op IS the hand-written kernel (csrc/graph_conv.cu: f @ W
on the tensor cores in 3xTF32, each K chunk promoted into fp32 registers,
which keeps fp32 accuracy; the Gram and G @ h on the FP32 pipe for clips
of up to 128 vertices), for any number of vertices: clips of more than
128 take the kernel's long schedule, where the Gram (its upper tiles,
mirrored) and G @ h run in 3xTF32 too; `graph_propagate_reference` is
its plain PyTorch version, used for CPU tensors and to check the kernel.

Both entries are registered torch ops, `agrl_torch::graph_propagate` (K1,
with an optional vertex mask) and `agrl_torch::graph_propagate_v2` (K2's
entry: f and adj held in bf16), so `torch.export` captures them in a
serving artifact and a loaded artifact calls them: the CPU implementation
is the plain version, the CUDA one the kernel or an exception, never a
fallback, and a fake implementation gives the output's shape and dtype
(float32) while tracing, and a FLOP formula (their three products) lets
FlopCounterMode count them. Importing this module registers them. A bf16
input (f, adj, W or a BN vector, as the bf16 eval passes them) is widened
to float32 before the kernel, which is exact; the output is float32.

Layouts follow the JAX package: f (B, V, C), adj (B, V, V), W (C, C) as
(in, out). The kernel reads W^T, so the transpose view of a torch Linear
weight (`linear.weight.t()`, what GraphConvLayer passes) costs no copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

BN_EPS = 1e-5

GRAPH_MODES = ("both", "pose", "learned")  # index = the kernel's mode code

# Launches of the CUDA kernel, plain integers that callers reset to 0 and
# read back: `launches` counts graph_propagate (K1) calls on CUDA tensors,
# `v2_launches` graph_propagate_v2 (K2's entry) calls. They count in the
# ops' CUDA implementations, so calls made by a loaded artifact count too.
launches = 0
v2_launches = 0


def l1_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=1): x / max(sum|x|, eps)."""
    return x / torch.clamp(x.abs().sum(dim=dim, keepdim=True), min=eps)


def l2_affinity(v: torch.Tensor) -> torch.Tensor:
    """(B, V, C) -> (B, V, V) similarity 2 / (exp(pairwise_dist) + 1),
    computed as 2 * sigmoid(-dist): the same function, overflow-safe
    (agrl_tpu/models/layers.py:55-76). The Gram is fp32; TF32 would
    reinject the cancellation error of the quadratic form near zero
    distance, where the affinity is sharpest, so callers keep it off.
    float64 input stays float64."""
    v = v.to(torch.promote_types(v.dtype, torch.float32))
    sq = (v * v).sum(dim=2)
    d2 = sq[:, None, :] + sq[:, :, None] - 2.0 * torch.matmul(v, v.transpose(1, 2))
    return 2.0 * torch.sigmoid(-torch.sqrt(torch.clamp(d2, min=1e-12)))


def pair_mask(vertex_mask: torch.Tensor) -> torch.Tensor:
    """(B, V) 0/1 vertex mask -> (B, V, V): entry (i, j) is 1 iff both ends
    are real vertices (agrl_tpu/models/layers.py:_pair_mask)."""
    return vertex_mask[:, :, None] * vertex_mask[:, None, :]


def graph_mode(use_pose: bool, learn_graph: bool) -> str:
    """The mode of a GraphConvLayer's flags; agrl_tpu's layer asserts one of
    them (agrl_tpu/models/layers.py:210), so neither raises here too."""
    if not (use_pose or learn_graph):
        raise ValueError("a graph layer needs use_pose or learn_graph (agrl_tpu's "
                         "GraphConvLayer asserts one of them)")
    return "both" if use_pose and learn_graph else "pose" if use_pose else "learned"


def _check_mode(mode: str) -> int:
    if mode not in GRAPH_MODES:
        raise ValueError(f"graph mode must be one of {GRAPH_MODES}, got {mode!r}")
    return GRAPH_MODES.index(mode)


def blended_graph(f: torch.Tensor, adj: torch.Tensor, vertex_mask=None,
                  mode: str = "both", mask_diag: bool = False) -> torch.Tensor:
    """The layer's graph G (B, V, V) in `mode` (module docstring),
    P = pair_mask(vertex_mask) (no mask: P = 1), times (1 - I) under
    `mask_diag`."""
    _check_mode(mode)
    pair = None if vertex_mask is None else pair_mask(vertex_mask)
    if mask_diag:
        off = 1.0 - torch.eye(f.shape[1], dtype=adj.dtype, device=adj.device)
        pair = off if pair is None else off * pair
    if mode != "pose":
        sim = l2_affinity(f)
        sim = l1_normalize(sim if pair is None else sim * pair, dim=2)
        if mode == "learned":
            return sim
    adj = l1_normalize(adj if pair is None else adj * pair, dim=2)
    return adj if mode == "pose" else (adj + sim) / 2.0


def _widen(t):
    """bf16 -> float32 (exact); any other dtype as it is."""
    return None if t is None else (t.float() if t.dtype == torch.bfloat16 else t)


def graph_propagate_reference(f, adj, W, scale, bias, mean, var, gamma=0.1, vertex_mask=None,
                              mode="both", mask_diag=False, additive=False):
    """Plain PyTorch version: (B, V, C) -> (B, V, C), eval-mode BN;
    `vertex_mask` (B, V) of 0/1 or None; `mode` one of GRAPH_MODES;
    `mask_diag` and `additive` as the module docstring says. bf16 inputs
    are widened to float32 first, as the kernel's wrapper widens them."""
    f, adj, W, scale, bias, mean, var, vertex_mask = map(
        _widen, (f, adj, W, scale, bias, mean, var, vertex_mask))
    h = torch.matmul(f, W)
    hp = torch.matmul(blended_graph(f, adj, vertex_mask, mode, mask_diag), h)
    hp = (hp - mean) / torch.sqrt(var + BN_EPS) * scale + bias
    hp = torch.where(hp >= 0, hp, 0.1 * hp)
    return (f if additive else (1.0 - gamma) * f) + gamma * hp


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/graph_conv.cu, built at first use, with its C signatures."""
    from agrl_torch.kernels.build import load_library

    lib = load_library("graph_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_conv_forward.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_float, i, i, i, p, p,
                                       i, i, i, p]
    lib.graph_conv_forward.restype = i
    lib.graph_conv_scratch_floats.argtypes = [i, i, i]
    lib.graph_conv_scratch_floats.restype = ctypes.c_longlong
    lib.graph_conv_error_string.argtypes = [i]
    lib.graph_conv_error_string.restype = ctypes.c_char_p
    lib.graph_conv_column_tile.restype = i
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device, aligned: bool = False) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be float32 {shape} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(f, adj, W, scale, bias, mean, var, gamma, vertex_mask, mode, mask_diag, additive):
    """Run csrc/graph_conv.cu on CUDA tensors; raises on anything it does
    not take (never falls back)."""
    code = _check_mode(mode)
    lib = _lib()
    f, adj, W, scale, bias, mean, var, vertex_mask = map(
        _widen, (f, adj, W, scale, bias, mean, var, vertex_mask))
    if f.dim() != 3 or W.dim() != 2:
        raise ValueError(f"f must be (B, V, C) and W (C, C), got {tuple(f.shape)}, "
                         f"{tuple(W.shape)}")
    B, V, C = f.shape
    dev = f.device
    tile = lib.graph_conv_column_tile()
    # grid limits: B clips in one grid dimension, B * V rows in 128-row blocks in another
    if not (0 < B <= 65535 and V > 0 and -(-B * V // 128) <= 65535) or C % tile:
        raise ValueError(f"kernel takes 0 < B <= 65535, V > 0, B * V <= {65535 * 128}, "
                         f"C % {tile} == 0; got B={B} V={V} C={C}")
    # the kernel reads W^T (a torch Linear weight): free for the layer's
    # `linear.weight.t()`, one copy for a row-major (in, out) W
    wt = W.t().contiguous()
    _check("f", f, (B, V, C), dev, aligned=True)
    _check("adj", adj, (B, V, V), dev)
    _check("W", wt, (C, C), dev, aligned=True)
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        _check(name, t, (C,), dev)
    if vertex_mask is not None:
        _check("vertex_mask", vertex_mask, (B, V), dev)

    out = torch.empty_like(f)
    scratch = torch.empty(lib.graph_conv_scratch_floats(B, V, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.graph_conv_forward(
            f.data_ptr(), adj.data_ptr(), None if vertex_mask is None else vertex_mask.data_ptr(),
            wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), float(gamma), code, int(mask_diag), int(additive),
            scratch.data_ptr(), out.data_ptr(), B, V, C, stream,
        )
    if rc != 0:
        msg = lib.graph_conv_error_string(rc).decode()
        raise RuntimeError(f"graph_conv kernel launch failed: {msg} ({rc})")
    return out


def _fake(f, adj, W, scale, bias, mean, var, gamma, vertex_mask=None, mode="both",
          mask_diag=False, additive=False):
    return f.new_empty(f.shape, dtype=torch.promote_types(f.dtype, torch.float32))


@torch.library.custom_op("agrl_torch::graph_propagate", mutates_args=(), device_types="cpu")
def _graph_propagate_op(
    f: torch.Tensor, adj: torch.Tensor, W: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, gamma: float,
    vertex_mask: torch.Tensor | None = None, mode: str = "both", mask_diag: bool = False,
    additive: bool = False,
) -> torch.Tensor:
    _check_mode(mode)
    return graph_propagate_reference(f, adj, W, scale, bias, mean, var, gamma, vertex_mask, mode,
                                     mask_diag, additive)


@_graph_propagate_op.register_kernel("cuda")
def _(f, adj, W, scale, bias, mean, var, gamma, vertex_mask=None, mode="both", mask_diag=False,
      additive=False):
    global launches
    out = _launch(f, adj, W, scale, bias, mean, var, gamma, vertex_mask, mode, mask_diag,
                  additive)
    launches += 1
    return out


_graph_propagate_op.register_fake(_fake)


def graph_propagate(f, adj, W, scale, bias, mean, var, gamma=0.1, vertex_mask=None,
                    mode="both", mask_diag=False, additive=False):
    """Fused eval graph conv, any V; `vertex_mask` (B, V) of 0/1 or None;
    `mode` one of GRAPH_MODES; `mask_diag` and `additive` give ganet's
    layer. CPU tensors: the plain version. CUDA tensors: the kernel
    (csrc/graph_conv.cu), or an exception."""
    return torch.ops.agrl_torch.graph_propagate(
        f, adj, W, scale, bias, mean, var, float(gamma), vertex_mask, mode, bool(mask_diag),
        bool(additive))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 -> fp32 (round to nearest even), as jnp.astype does."""
    return x.to(torch.bfloat16).to(torch.float32)


@torch.library.custom_op("agrl_torch::graph_propagate_v2", mutates_args=(), device_types="cpu")
def _graph_propagate_v2_op(
    f: torch.Tensor, adj: torch.Tensor, W: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, gamma: float,
    vertex_mask: torch.Tensor | None = None, mode: str = "both", mask_diag: bool = False,
    additive: bool = False,
) -> torch.Tensor:
    _check_mode(mode)
    return graph_propagate_reference(round_bf16(f), round_bf16(adj), W, scale, bias, mean, var,
                                     gamma, vertex_mask, mode, mask_diag, additive)


@_graph_propagate_v2_op.register_kernel("cuda")
def _(f, adj, W, scale, bias, mean, var, gamma, vertex_mask=None, mode="both", mask_diag=False,
      additive=False):
    global v2_launches
    out = _launch(round_bf16(f), round_bf16(adj), W, scale, bias, mean, var, gamma,
                  vertex_mask, mode, mask_diag, additive)
    v2_launches += 1
    return out


_graph_propagate_v2_op.register_fake(_fake)


def graph_propagate_v2(f, adj, W, scale, bias, mean, var, gamma=0.1, vertex_mask=None,
                       mode="both", mask_diag=False, additive=False):
    """The graph_conv_v2 entry: f and adj are held in bf16 (rounded here,
    as graph_conv_v2.py:159-160 does), the math stays fp32 — the same
    kernel on bf16-rounded inputs. CPU tensors: the plain version."""
    return torch.ops.agrl_torch.graph_propagate_v2(
        f, adj, W, scale, bias, mean, var, float(gamma), vertex_mask, mode, bool(mask_diag),
        bool(additive))


def _propagate_flops(f_shape, adj_shape, W_shape, scale=None, bias=None, mean=None, var=None,
                     gamma=None, vertex_mask=None, mode="both", mask_diag=False,
                     additive=False, *, out_shape=None,
                     **kwargs) -> int:
    """The op's products as FlopCounterMode counts the plain version's
    (2 per multiply-add): f @ W, the Gram f f^T of the l2 affinity (modes
    "both" and "learned"), G @ h. The elementwise work is not counted, as
    for any op there."""
    B, V, C = f_shape
    C_out = W_shape[1]
    gram = 2 * B * V * V * C if mode in ("both", "learned") else 0
    return 2 * B * V * C * C_out + gram + 2 * B * V * V * C_out


# FlopCounterMode (utils/model_complexity.py) counts an op without a
# formula as 0; with this one the count is the plain path's
register_flop_formula(
    [torch.ops.agrl_torch.graph_propagate, torch.ops.agrl_torch.graph_propagate_v2]
)(_propagate_flops)

