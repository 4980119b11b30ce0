"""Fused eval-mode graph convolution: the CUDA kernel and its plain twin.

Counterpart of agrl_tpu/ops/graph_conv.py (graph_propagate_pallas) and
agrl_tpu/ops/graph_conv_v2.py (graph_propagate_pallas_v2), two Pallas
schedules of one function — the eval-mode VMGN GraphConvLayer, per clip:

    h   = f @ W
    A   = row_l1(adj)
    S   = row_l1(2 * sigmoid(-pdist(f)))
    G   = (A + S) / 2
    out = (1 - gamma) * f + gamma * lrelu_0.1(bn_eval(G @ h))

On the card this op IS the hand-written kernel (csrc/graph_conv.cu: f @ W
on the tensor cores in 3xTF32, each K chunk promoted into fp32 registers,
which keeps fp32 accuracy; the Gram and G @ h in fp32);
`graph_propagate_reference` is its plain PyTorch
version, used for CPU tensors and to check the kernel.
`graph_propagate` dispatches on the tensor's device: CPU -> plain
version, CUDA -> the kernel or an exception, never a fallback.

Layouts follow the JAX package: f (B, V, C), adj (B, V, V), W (C, C) as
(in, out). The kernel reads W^T, so the transpose view of a torch Linear
weight (`linear.weight.t()`, what GraphConvLayer passes) costs no copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

BN_EPS = 1e-5
# the most vertices a clip may have on the card: csrc/graph_conv.cu holds a
# clip's V rows in one 128-row block (graph_conv_max_vertices() returns it)
MAX_VERTICES = 128

# Launches of the CUDA kernel (one per graph_propagate/_v2 call on CUDA
# tensors). A plain integer: callers reset it to 0 and read it back.
launches = 0


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


def blended_graph(f: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """G = (row_l1(adj) + row_l1(l2_affinity(f))) / 2, (B, V, V)."""
    return (l1_normalize(adj, dim=2) + l1_normalize(l2_affinity(f), dim=2)) / 2.0


def graph_propagate_reference(f, adj, W, scale, bias, mean, var, gamma=0.1):
    """Plain PyTorch version: (B, V, C) -> (B, V, C), eval-mode BN."""
    h = torch.matmul(f, W)
    hp = torch.matmul(blended_graph(f, adj), h)
    hp = (hp - mean) / torch.sqrt(var + BN_EPS) * scale + bias
    hp = torch.where(hp >= 0, hp, 0.1 * hp)
    return (1.0 - gamma) * f + gamma * hp


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/graph_conv.cu, built at first use, with its C signatures."""
    from agrl_torch.kernels.build import load_library

    lib = load_library("graph_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_conv_forward.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, p, p, i, i, i, p]
    lib.graph_conv_forward.restype = i
    lib.graph_conv_scratch_floats.argtypes = [i, i, i]
    lib.graph_conv_scratch_floats.restype = ctypes.c_longlong
    lib.graph_conv_error_string.argtypes = [i]
    lib.graph_conv_error_string.restype = ctypes.c_char_p
    lib.graph_conv_column_tile.restype = i
    lib.graph_conv_max_vertices.restype = i
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device, aligned: bool = False) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be float32 {shape} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(f, adj, W, scale, bias, mean, var, gamma):
    """Run csrc/graph_conv.cu on CUDA tensors; raises on anything it does
    not take (never falls back)."""
    global launches
    lib = _lib()
    if f.dim() != 3 or W.dim() != 2:
        raise ValueError(f"f must be (B, V, C) and W (C, C), got {tuple(f.shape)}, "
                         f"{tuple(W.shape)}")
    B, V, C = f.shape
    dev = f.device
    tile, v_max = lib.graph_conv_column_tile(), lib.graph_conv_max_vertices()
    if B == 0 or V == 0 or V > v_max or C % tile:
        raise ValueError(f"kernel takes B > 0, 0 < V <= {v_max}, C % {tile} == 0; "
                         f"got B={B} V={V} C={C}")
    # the kernel reads W^T (a torch Linear weight): free for the layer's
    # `linear.weight.t()`, one copy for a row-major (in, out) W
    wt = W.t().contiguous()
    _check("f", f, (B, V, C), dev, aligned=True)
    _check("adj", adj, (B, V, V), dev)
    _check("W", wt, (C, C), dev, aligned=True)
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        _check(name, t, (C,), dev)

    out = torch.empty_like(f)
    scratch = torch.empty(lib.graph_conv_scratch_floats(B, V, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.graph_conv_forward(
            f.data_ptr(), adj.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), float(gamma), scratch.data_ptr(),
            out.data_ptr(), B, V, C, stream,
        )
    if rc != 0:
        msg = lib.graph_conv_error_string(rc).decode()
        raise RuntimeError(f"graph_conv kernel launch failed: {msg} ({rc})")
    launches += 1
    return out


def graph_propagate(f, adj, W, scale, bias, mean, var, gamma=0.1):
    """Fused eval graph conv. CPU tensors: the plain version. CUDA
    tensors: the kernel (csrc/graph_conv.cu), or an exception."""
    if f.device.type == "cpu":
        return graph_propagate_reference(f, adj, W, scale, bias, mean, var, gamma)
    if f.device.type != "cuda":
        raise ValueError(f"no graph_propagate for device {f.device}")
    return _launch(f, adj, W, scale, bias, mean, var, gamma)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 -> fp32 (round to nearest even), as jnp.astype does."""
    return x.to(torch.bfloat16).to(torch.float32)


def graph_propagate_v2(f, adj, W, scale, bias, mean, var, gamma=0.1):
    """The graph_conv_v2 entry: f and adj are held in bf16 (rounded here,
    as graph_conv_v2.py:159-160 does), the math stays fp32 — the same
    kernel on bf16-rounded inputs."""
    return graph_propagate(round_bf16(f), round_bf16(adj), W, scale, bias, mean, var, gamma)
