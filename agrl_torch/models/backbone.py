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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torch BatchNorm defaults: eps 1e-5 (agrl_tpu/models/backbone.py:56-59),
# momentum 0.1 (flax momentum 0.9)
BN_EPS = 1e-5


class _FlaxRunningStats:
    """Train mode normalizes with the batch mean and the biased batch
    variance, as both frameworks do, but updates `running_var` with the
    BIASED variance, as agrl_tpu's flax BatchNorm does
    (agrl_tpu/models/backbone.py:56-59). torch's own BatchNorm, and the
    original torch AGRL, use the unbiased one: a factor n / (n - 1) in the
    update, 16/15 at the BNNecks of a 16-clip batch. agrl_tpu is the
    oracle, so the port keeps flax's rule. Eval mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


def batch_norm2d(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Kaiming normal, fan_out, ReLU gain (agrl_tpu's `conv_kaiming`)."""
    out_ch, _, kh, kw = conv.weight.shape
    std = math.sqrt(2.0 / (out_ch * kh * kw))
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)


class Bottleneck(nn.Module):
    """ResNet-v1 bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batch_norm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = batch_norm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm2d(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False), batch_norm2d(out)
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


class ResNetTrunk(nn.Module):
    """Stem (conv7x7/2 + BN + relu + maxpool3x3/2) + layer1..layer3 — the
    trunk shared by two-branch models. Subclasses keep these names at
    their top level, as the reference's GSTA does."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
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
