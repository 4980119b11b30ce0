"""ResNet backbone with a configurable last stride (PyTorch, NCHW inside).

Counterpart of agrl_tpu/models/backbone.py. Semantics match the reference
backbone (torchreid/models/vmgn.py:29-65, 175-211): Bottleneck v1 blocks
(stride on the 3x3 conv), BN after every conv, projection downsample when
the shape changes, `last_stride` for layer4.

Module names are the reference's (conv1, bn1, layer1.0.conv1, ...,
downsample.0/.1), so reference-named state dicts load directly and
agrl_tpu's name map (weight_convert._split_torch_name) applies as is.
The stem (conv1, bn1, maxpool) lives in `ResNetTrunk` under those names.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torch BatchNorm defaults: eps 1e-5 (agrl_tpu/models/backbone.py:56-59),
# momentum 0.1 (flax momentum 0.9)
BN_EPS = 1e-5

_stats = threading.local()


@contextmanager
def frozen_running_stats():
    """Train-mode BatchNorms in this thread normalize as usual but leave
    their running statistics alone: the recompute of a checkpointed
    forward (`--remat`) must not update them a second time."""
    before = getattr(_stats, "frozen", False)
    _stats.frozen = True
    try:
        yield
    finally:
        _stats.frozen = before


@contextmanager
def global_batch_stats(mesh):
    """Train-mode BatchNorms in this thread normalize with the mean and the
    biased variance of the GLOBAL batch of `mesh`'s dp group, and
    update their running statistics with them (agrl_tpu gets this from
    GSPMD: under jit the batch axis is global, agrl_tpu/models/backbone.py:
    11-13). The train step enters it around the forward of a data-parallel
    step (and its `--remat` recompute); outside it nothing changes."""
    before = getattr(_stats, "mesh", None)
    _stats.mesh = mesh
    try:
        yield
    finally:
        _stats.mesh = before


def _bn_layout(t: torch.Tensor) -> torch.Tensor:
    """t as it is where torch's native BatchNorm kernels take its layout
    (contiguous, or channels-last, which cuDNN's convolutions hand over on
    the card), else a contiguous copy; SyncBatchNorm's rule."""
    if (t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))
            or (t.dim() == 5 and t.is_contiguous(memory_format=torch.channels_last_3d))):
        return t
    return t.contiguous()


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a dp group.

    Forward: each rank's (count, mean, biased variance) per channel, in
    float32 (Welford's on the card, a two-pass one on the CPU), go to every
    rank in one all_gather
    and combine by Chan's rule, mean = sum n_r m_r / N and
    N var = sum (n_r var_r + n_r (m_r - mean)^2), whose terms are all
    non-negative; the input normalizes with them in float32. Returns the
    output and the global (mean, var), which update the running statistics.

    Backward: the global sums of dy and dy * (x - mean) per channel, one
    all_reduce, give the input gradient of the global normalization
    (SyncBatchNorm's rule); the weight and bias gradients are this rank's
    sums, which the train step averages over the ranks with the rest. On
    the card the sums and the input gradient are torch's fused
    batch_norm_backward_reduce / batch_norm_backward_elemt passes (those
    SyncBatchNorm runs), as are the forward's statistics and normalization;
    on the CPU the same arithmetic in torch ops."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        import torch.distributed as dist

        C = x.shape[1]
        xf = x.float()
        n = xf.numel() // C
        if xf.is_cuda:  # one fused pass (SyncBatchNorm's); eps 0: invstd = var^-1/2, or 0
            xf = _bn_layout(xf)
            mean_r, invstd_r = torch.batch_norm_stats(xf, 0.0)
            var_r = torch.where(invstd_r > 0, invstd_r.pow(-2), 0.0)
        else:
            var_r, mean_r = torch.var_mean(xf, dim=[0, *range(2, x.dim())], correction=0)
        row = torch.cat([xf.new_full((1,), float(n)), mean_r, var_r])
        rows = [torch.empty_like(row) for _ in range(mesh.dp)]
        dist.all_gather(rows, row, group=mesh.dp_group)
        rows = torch.stack(rows)
        counts, means, variances = rows[:, :1], rows[:, 1:C + 1], rows[:, C + 1:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (counts * (variances + (means - mean) ** 2)).sum(0) / total
        invstd = torch.rsqrt(var + eps)
        if xf.is_cuda:  # keeps the input's layout (cuDNN's inference BN goes through NHWC)
            out = torch.batch_norm_elemt(xf, weight, bias, mean, invstd, eps)
        else:
            out = F.batch_norm(xf, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(xf, weight, mean, invstd)
        ctx.mesh, ctx.in_dtype = mesh, x.dtype
        ctx.total, ctx.counts = total, counts[:, 0].to(torch.int32)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        import torch.distributed as dist

        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        dy = dout.float()
        if x.is_cuda:
            dy = _bn_layout(dy)
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            both = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(both, group=ctx.mesh.dp_group)
            g_dy, g_dy_xmu = both.split(C)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, g_dy, g_dy_xmu,
                                                 ctx.counts)
            return dx.to(ctx.in_dtype), dw, db, None, None
        dims = [0, *range(2, x.dim())]
        shape = (1, C) + (1,) * (x.dim() - 2)
        xmu = x - mean.reshape(shape)
        local = torch.cat([dy.sum(dims), (dy * xmu).sum(dims)])
        both = local.clone()
        dist.all_reduce(both, group=ctx.mesh.dp_group)
        sum_dy, sum_dy_xmu = (both / ctx.total).split(C)
        dx = (dy - sum_dy.reshape(shape) - xmu * (invstd * invstd * sum_dy_xmu).reshape(shape)) \
            * (invstd * weight).reshape(shape)
        local_dy, local_dy_xmu = local.split(C)
        return dx.to(ctx.in_dtype), local_dy_xmu * invstd, local_dy, None, None


class _FlaxRunningStats:
    """Train mode normalizes with the batch mean and the biased batch
    variance, as both frameworks do, but updates `running_var` with the
    BIASED variance, as agrl_tpu's flax BatchNorm does
    (agrl_tpu/models/backbone.py:56-59). torch's own BatchNorm, and the
    original torch AGRL, use the unbiased one: a factor n / (n - 1) in the
    update, 16/15 at the BNNecks of a 16-clip batch. agrl_tpu is the
    oracle, so the port keeps flax's rule. Under `global_batch_stats` the
    batch is the process group's global one (_GlobalBatchNorm), with the
    same rule: torch.nn.SyncBatchNorm would take the unbiased variance.

    `compute_dtype` is flax's BatchNorm `dtype`: the output's dtype (None:
    the promotion of the input's and the scale's). Training: batch
    statistics, the normalization and the running-stat update are float32
    whatever the input (flax's `_compute_stats` promotes to float32).
    Eval: `_eval`. Parameters and running stats stay float32; the
    bf16 eval hands a bf16-rounded copy of them."""

    compute_dtype = None

    def inv_std(self) -> torch.Tensor:
        """rsqrt(running_var + eps) in the running variance's dtype, as
        flax's `_normalize` takes it: bf16, rounded, under the bf16 eval."""
        return torch.rsqrt(self.running_var + self.eps)

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        """flax's eval `_normalize`, (x - mean) * (inv_std * scale) + bias,
        in the promotion `ct` of the input's and the statistics' dtypes,
        rounded where agrl_tpu's CPU backend rounds: with float32 anywhere
        (the float32 model under the bf16 eval, or a bf16 input with float32
        statistics) everything after inv_std is float32, in one pass; with
        bf16 input and bf16 statistics every operation rounds to bf16."""
        shape = (-1,) + (1,) * (x.dim() - 2)  # broadcast over dim 1, the channels
        ct = torch.promote_types(x.dtype, self.running_var.dtype)
        mul = (self.inv_std().to(ct) * self.weight.to(ct)).reshape(shape)
        mean = self.running_mean.to(ct).reshape(shape)
        bias = self.bias.to(ct).reshape(shape)
        if ct == torch.float32:
            return torch.addcmul(bias - mean * mul, x.float(), mul)
        return (x.to(ct) - mean) * mul + bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if not self.training:
            return self._eval(x).to(dt)
        mesh = getattr(_stats, "mesh", None)
        if mesh is not None:
            return self._forward_global(x, dt, mesh)
        # a bf16 input normalizes to bf16 in one mixed-type call (fp32 math);
        # any other mix normalizes in fp32 and casts
        xin = x if x.dtype == dt else x.float()
        out = F.batch_norm(xin, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if getattr(_stats, "frozen", False):
            return out.to(dt)
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out.to(dt)

    def _forward_global(self, x: torch.Tensor, dt, mesh) -> torch.Tensor:
        """Train mode under `global_batch_stats`: _GlobalBatchNorm, then
        flax's running-stat rule with the global mean and biased variance."""
        out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, mesh)
        if not getattr(_stats, "frozen", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        return out.to(dt)


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    pass


class _ComputeDtypeConv:
    """A convolution computing at `compute_dtype` (flax's Conv `dtype`:
    input and kernel cast to it; None: their promotion), from float32
    weights under training, so autograd's gradients land in float32.

    torch's CPU bf16 convolution (oneDNN) reads past its input when the
    kernel spans more than one column, the column stride is above 1 and
    the output is one column wide: msppn's layer4 at 64x32 frames (a 4x2
    map to 2x1) comes out wrong by more than its size, or not finite, and
    so does the 3-D convolution of resnet3d's layer4 at 64x32 (a 1x4x2
    map to 1x2x1). Such a convolution computes in float64 on the bf16
    values and rounds its output to bf16 (float64, not float32: a float32
    sum's last bits follow the thread count, and the rounding turns them
    into whole bf16 steps). Every other CPU bf16 convolution is oneDNN's;
    CUDA tensors take cuDNN's. tests/test_torch_graphnet.py and
    tests/test_torch_legacy.py show the fault and the repair."""

    compute_dtype = None

    def onednn_bf16_faults(self, x: torch.Tensor) -> bool:
        """Whether oneDNN's bf16 kernel gets this convolution of CPU `x` wrong."""
        kw, sw = self.kernel_size[-1], self.stride[-1]
        pw, dw = self.padding[-1], self.dilation[-1]
        out_w = (x.shape[-1] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        return x.device.type == "cpu" and kw > 1 and sw > 1 and out_w == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        if dt == torch.bfloat16 and self.onednn_bf16_faults(x):
            return self._conv_forward(x.to(dt).double(), self.weight.to(dt).double(),
                                      None if bias is None else bias.double()).to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv2d(_ComputeDtypeConv, nn.Conv2d):
    pass


class Conv1d(_ComputeDtypeConv, nn.Conv1d):
    """res50ta's temporal attention convolution (N, C, T)."""


class Conv3d(_ComputeDtypeConv, nn.Conv3d):
    """The 3-D convolution of the resnet3d family (NCDHW)."""


def linear(module: nn.Module, name: str, x: torch.Tensor, weight: torch.Tensor, bias=None):
    """F.linear(x, weight, bias), or its tensor-parallel form when
    `module`'s parameter `name` is a block of rows sharded over an mp group
    (parallel.place_state: `weight` is the block, the output whole)."""
    shard = getattr(module, "mp_shards", {}).get(name)
    return F.linear(x, weight, bias) if shard is None else shard.linear(x, weight, bias)


class Linear(nn.Linear):
    """nn.Linear computing at the promotion of its input's and weight's
    dtypes, as flax's Dense with dtype None: the bf16 eval's rounded
    weights on float32 features compute in float32. Under `--mesh-mp` its
    weight may be a block of its output rows (parallel.place_state), the
    product then tensor-parallel at that dtype (`linear`)."""

    MP_BLOCKS = {"weight": 1}  # the rows parallel.place_state may shard

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return linear(self, "weight", x.to(dt), self.weight.to(dt), bias)


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Sets the compute dtype of every convolution and BatchNorm in `module`."""
    for m in module.modules():
        if isinstance(m, (_ComputeDtypeConv, _FlaxRunningStats)):
            m.compute_dtype = dtype


def init_linear_default_(lin: nn.Linear, generator: torch.Generator) -> None:
    """nn.Linear's own init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
    weight and the bias, from `generator` (agrl_tpu's
    torch_linear_kernel_init and torch_linear_bias_init)."""
    bound = 1.0 / math.sqrt(lin.in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if lin.bias is not None:
            lin.bias.uniform_(-bound, bound, generator=generator)


def init_lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init, lecun_normal: a normal of variance
    1 / fan_in truncated at two standard deviations (of the untruncated
    normal, rescaled so the truncated one keeps the variance)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def batch_norm2d(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


def init_conv_(conv: nn.Module, generator: torch.Generator) -> None:
    """Kaiming normal, fan_out, ReLU gain (agrl_tpu's `conv_kaiming`), for a
    2-D or 3-D convolution."""
    out_ch, _, *kernel = conv.weight.shape
    std = math.sqrt(2.0 / (out_ch * math.prod(kernel)))
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)


class Bottleneck(nn.Module):
    """ResNet-v1 bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = batch_norm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm2d(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(
                Conv2d(inplanes, out, 1, stride=stride, bias=False), batch_norm2d(out)
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


class ResLayer(nn.Sequential):
    """A stage of `blocks` bottlenecks; the stride applies to the first."""

    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1):
        out = planes * Bottleneck.expansion
        needs_down = stride != 1 or inplanes != out
        super().__init__(
            Bottleneck(inplanes, planes, stride=stride, downsample=needs_down),
            *[Bottleneck(out, planes) for _ in range(1, blocks)],
        )


class PartPooling:
    """The pyramid part pooling of the video archs, with its pooling matrix
    cached on the module, in a `_pool_cache` dict that the module's
    __init__ sets."""

    def part_pool(self, fmap: torch.Tensor, splits) -> torch.Tensor:
        """(N, c, h, w) -> (N, sum(splits), c): the width mean, then each
        split's adaptive average over the rows, as one product with
        agrl_tpu's float32 pooling matrix, which promotes a bf16 fmap
        (agrl_tpu's einsum with a numpy constant)."""
        fw = fmap.mean(dim=3)
        fw = fw.to(torch.promote_types(fw.dtype, torch.float32))
        return torch.matmul(self._pool_matrix(fw.shape[2], fw, tuple(splits)), fw.transpose(1, 2))

    def _pool_matrix(self, h: int, ref: torch.Tensor, splits: tuple) -> torch.Tensor:
        """(sum(splits), h) pooling matrix on ref's device and in its dtype,
        cached per height, splits, device and dtype, and made outside
        inference mode (a model served first and trained after takes it in
        autograd). While torch.export traces, it is made anew (a constant of
        the program): the cache must not keep a tensor of the trace."""
        key = (h, splits, ref.device, ref.dtype)
        tracing = torch.compiler.is_compiling()
        if key in self._pool_cache and not tracing:
            return self._pool_cache[key]
        rows = [adaptive_avg_pool_matrix(h, n) for n in splits]
        # a normal tensor even under inference_mode: a later train forward
        # reuses it in autograd
        with torch.inference_mode(False):
            m = torch.cat([torch.from_numpy(r) for r in rows]).to(ref.device, ref.dtype)
        if not tracing:
            self._pool_cache[key] = m
        return m


class ResNetTrunk(PartPooling, nn.Module):
    """Stem (conv7x7/2 + BN + relu + maxpool3x3/2) + layer1..layer3 — the
    trunk every video arch shares; each adds its own layer4. Subclasses
    keep these names at their top level, as the reference's models do."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self._pool_cache: dict = {}
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = ResLayer(64, 64, layers[0])
        self.layer2 = ResLayer(256, 128, layers[1], stride=2)
        self.layer3 = ResLayer(512, 256, layers[2], stride=2)

    def forward_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) -> layer3 activation (N, 1024, H/16, W/16)."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer3(self.layer2(self.layer1(x)))

    def init_backbone(self, generator: torch.Generator) -> None:
        init_backbone_(self, generator)


def init_backbone_(module: nn.Module, generator: torch.Generator) -> None:
    """Reference _init_params for convolutions and BatchNorms: every 2-D and
    3-D conv in `module` kaiming (fan_out) with a zero bias, every BN scale
    1 / shift 0."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            init_conv_(m, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class MultiScaleTrunk(ResNetTrunk):
    """The trunk with a layer4 at stride 2, whose layer2, layer3 and layer4
    maps msppn and msppgn read (agrl_tpu/models/graphnet.py:52-64). Its
    children, in order, are the reference's `base` Sequential (conv1, bn1,
    relu, maxpool, layer1..4): msppn keeps them at its top level, msppgn
    as `base.{0..7}`; `levels` runs either."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__(layers)
        self.layer4 = ResLayer(1024, 512, layers[3], stride=2)


def resnet_base(layers=(3, 4, 6, 3), last_stride: int = 2) -> nn.Sequential:
    """The reference's `base` of the legacy video and image archs,
    nn.Sequential(conv1, bn1, relu, maxpool, layer1..4) of a torchvision
    ResNet (its children but the pool and the fc), with layer4 at
    `last_stride`: state-dict names `base.{0,1,4..7}`
    (agrl_tpu/models/weight_convert.py:convert_temporal_state_dict)."""
    return nn.Sequential(*ResNetTrunk(layers).children(),
                         ResLayer(1024, 512, layers[3], stride=last_stride))


#: where an ImageNet ResNet's stages go in a model holding `resnet_base`
#: as `base` (weight_convert.init_pretrained_weights)
BASE_IMAGENET_STAGES = {"conv1": "base.0", "bn1": "base.1", "layer1": "base.4",
                        "layer2": "base.5", "layer3": "base.6", "layer4": "base.7"}


def levels(stages, x: torch.Tensor):
    """(N, 3, H, W) through the 8 stages of a MultiScaleTrunk -> the
    layer2, layer3 and layer4 maps, (N, c, h, w) each."""
    for stage in stages[:5]:
        x = stage(x)
    f1 = stages[5](x)
    f2 = stages[6](f1)
    return f1, f2, stages[7](f2)


def adaptive_max_pool_rows(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch's AdaptiveMaxPool2d((n, 1)) as agrl_tpu computes it
    (agrl_tpu/models/backbone.py:243-257): the max over W, then the max
    over row bins [floor(i*h/n), ceil((i+1)*h/n)), which overlap where n
    does not divide h. x: (N, C, H, W) -> (N, n, C)."""
    xw = x.amax(dim=3)  # (N, C, H)
    h = xw.shape[2]
    bins = [xw[:, :, (i * h) // out_size:-(-((i + 1) * h) // out_size)].amax(dim=2)
            for i in range(out_size)]
    return torch.stack(bins, dim=1)


def adaptive_avg_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix replicating torch's
    AdaptiveAvgPool semantics: bin i averages rows
    [floor(i*in/out), ceil((i+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m
