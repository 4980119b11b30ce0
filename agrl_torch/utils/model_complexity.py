"""Model size and FLOPs for the startup line (counterpart of
agrl_tpu/utils/model_complexity.py).

agrl_tpu asks XLA's cost analysis of the compiled eval forward for its
FLOPs; the port counts the same 1-clip eval forward with
`torch.utils.flop_counter.FlopCounterMode` (2 per multiply-add). XLA
counts a convolution's multiply-adds over the taps that fall inside the
input only, not over its zero padding; FlopCounterMode's stock formula
counts every tap, which at small frames (ResNet's 3x3 convolutions over a
few rows) overcounts by ~14% of the convolutions. The port counts XLA's
way (`_conv_flops_unpadded`, 1-, 2- and 3-D: resnet3d's Conv3d too), so
the two lines differ only by the elementwise work XLA also counts
(tests/test_torch_host_utils.py states the bar). res50rnn's LSTM is torch
products (models/resnet_temporal.py), counted as such. The graph layer's
registered op (`agrl_torch::graph_propagate`, K1) carries a formula for
its products (ops/graph_conv.py; the Gram only in the graph modes that
build it), so the count is the same whether the kernel or the plain layer
ran.
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def count_num_param(model: nn.Module, exclude_heads=("classifier",)) -> float:
    """Parameters in millions. The reference (torchtools.py:62-67) excludes
    ONLY a head attribute literally named `classifier`: vmgn (whose heads
    are global_/att_classifier) excludes nothing.

    `exclude_heads`: exact top-level module names, or prefixes ending in
    '_'. Counts what agrl_tpu counts over its params tree: every
    nn.Parameter (the BNNecks' frozen zero biases have no flax leaf, so
    they are left out), no buffers."""
    total = 0
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        if any(top.startswith(h) if h.endswith("_") else top == h for h in exclude_heads):
            continue
        if not p.requires_grad:
            continue
        total += p.numel()
    return total / 1e6


def _valid_taps(size_in: int, size_out: int, k: int, stride: int, pad: int, dil: int) -> int:
    """Sum over output positions of the kernel taps that land inside the
    input along one axis."""
    return sum(
        sum(1 for j in range(k) if 0 <= o * stride - pad + j * dil < size_in)
        for o in range(size_out)
    )


def _conv_flops_unpadded(x_shape, w_shape, _bias, stride, padding, dilation, transposed,
                         *args, out_shape=None, **kwargs) -> int:
    """2 x the multiply-adds of a 1-, 2- or 3-D convolution over its
    in-bounds taps (XLA's HloCostAnalysis convention); a transposed one as
    the stock formula counts it."""
    from torch.utils.flop_counter import conv_flop_count

    if transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=transposed)
    n = x_shape[0]
    c_out, c_per_group = w_shape[:2]
    taps = 1
    for d in range(len(x_shape) - 2):
        taps *= _valid_taps(x_shape[2 + d], out_shape[2 + d], w_shape[2 + d], stride[d],
                            padding[d], dilation[d])
    return 2 * n * c_out * c_per_group * taps


def count_eval_flops(model: nn.Module, seq_len: int = 8, height: int = 256,
                     width: int = 128, num_vertices: int | None = None) -> int:
    """FLOPs of the eval forward of one (1, seq_len, height, width, 3) clip
    with an all-ones adjacency (agrl_tpu's probe), counted by
    FlopCounterMode on fake tensors: shapes only, so nothing runs on the
    device and no kernel launches. The model itself is not touched."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from agrl_torch.models import default_num_vertices

    if num_vertices is None:
        num_vertices = default_num_vertices(model, seq_len)
    device = next(model.parameters()).device
    # a copy: the forward may cache tensors on its module (VMGN's pooling
    # matrix), and those made here would be fake
    probe = copy.deepcopy(model).eval()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros((1, seq_len, height, width, 3), device=device)
        adj = torch.ones((1, num_vertices, num_vertices), device=device)
        counter = FlopCounterMode(
            display=False, custom_mapping={torch.ops.aten.convolution: _conv_flops_unpadded})
        with torch.no_grad(), counter:
            probe(x, adj)
    return counter.get_total_flops()


def compute_model_complexity(model: nn.Module, seq_len: int = 8, height: int = 256,
                             width: int = 128, num_vertices: int | None = None,
                             verbose: bool = True) -> tuple[float, float]:
    """(parameters in millions, GFLOPs of a 1-clip eval forward), as
    agrl_tpu's compute_model_complexity returns them."""
    num_params = count_num_param(model, getattr(model, "count_exclude_heads", ("classifier",)))
    gflops = count_eval_flops(model, seq_len, height, width, num_vertices) / 1e9
    if verbose:
        print(f"Model complexity: params {num_params:.5f}M, eval forward {gflops:.2f} GFLOPs/clip")
    return num_params, gflops
