"""3-D ResNets, the spatio-temporal convolution baselines of the legacy
video family (counterpart of agrl_tpu/models/resnet3d.py; reference
torchreid/models/resnet3d.py, the Kinetics 3-D ResNet-10..200 of Hara et
al., and resnet3dt.py, its video re-id wrapper):

  * a 7x7x7 stem convolution at stride (1, 2, 2), padding 3, BN, ReLU;
  * a 3x3x3 max pool at stride 2, padding 1 (padding never wins the max,
    as flax's -inf padding);
  * four stages of 3-D basic or bottleneck blocks (`DEPTH_CONFIGS`) with
    projection shortcuts where the shape changes (type B);
  * the mean over time and space; the classifier, named `fc` as the
    reference's (torch's default Linear init), in training only.

Convolutions are Conv3d over NCDHW; clips arrive as (B, T, H, W, 3) and
are permuted inside. State-dict names are the reference's (conv1, bn1,
layer{i}.{j}.{convK,bnK,downsample.0/.1}, fc), the ones agrl_tpu's
convert_resnet3d_state_dict reads. Eval: the (B, 512 * expansion)
feature (2048 at depth 50); train: the logits, or (logits, feature) under
{"xent", "htri"}. BatchNorm3d keeps flax's running-statistic rule. No
adjacency is read and no frame mask is taken; the factories drop `dtype`
as agrl_tpu's do.
"""

from __future__ import annotations

import torch
from torch import nn

from agrl_torch.models.backbone import (
    BN_EPS,
    BatchNorm3d,
    Conv3d,
    Linear,
    init_backbone_,
    init_linear_default_,
)
from agrl_torch.models.gsta import check_loss


def _bn(channels: int) -> BatchNorm3d:
    return BatchNorm3d(channels, eps=BN_EPS)


def _downsample(inplanes: int, out: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv3d(inplanes, out, 1, stride=stride, bias=False), _bn(out))


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv3d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + residual)


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv3d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv3d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv3d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(inplanes, out, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + residual)


DEPTH_CONFIGS = {
    10: (BasicBlock3D, (1, 1, 1, 1)),
    18: (BasicBlock3D, (2, 2, 2, 2)),
    34: (BasicBlock3D, (3, 4, 6, 3)),
    50: (Bottleneck3D, (3, 4, 6, 3)),
    101: (Bottleneck3D, (3, 4, 23, 3)),
    152: (Bottleneck3D, (3, 8, 36, 3)),
    200: (Bottleneck3D, (3, 24, 36, 3)),
}


class ResNet3D(nn.Module):
    """(B, T, H, W, 3) clips -> logits / the pooled feature."""

    name_scheme = "resnet3d"
    # no stage of a 2-D ImageNet ResNet fits: --pretrained-weights loads
    # nothing, as agrl_tpu's init_pretrained_weights matches nothing here
    imagenet_stages = {}
    # the reference's count_num_param leaves out `classifier`, which is
    # agrl_tpu's name for this head
    count_exclude_heads = size_line_exclude = ("fc",)

    def __init__(self, num_classes: int, loss=frozenset({"xent", "htri"}), depth: int = 50):
        super().__init__()
        if depth not in DEPTH_CONFIGS:
            raise ValueError(f"depth must be one of {sorted(DEPTH_CONFIGS)}")
        self.loss = check_loss(loss)
        self.depth = depth
        block, layers = DEPTH_CONFIGS[depth]
        self.conv1 = Conv3d(3, 64, 7, stride=(1, 2, 2), padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)
        inplanes = 64
        for i, (planes, blocks, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                         (1, 2, 2, 2))):
            stage = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                stage.append(block(inplanes, planes, stride=s,
                                   downsample=s != 1 or inplanes != planes * block.expansion))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
        self.fc = Linear(inplanes, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """agrl_tpu's: convs kaiming (fan_out), BN 1 / 0, the head torch's
        default Linear init."""
        init_backbone_(self, generator)
        init_linear_default_(self.fc, generator)

    def forward(self, x: torch.Tensor, adj=None):
        x = x.permute(0, 4, 1, 2, 3)  # (B, 3, T, H, W)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        f = x.mean(dim=(2, 3, 4))
        if not self.training:
            return f
        y = self.fc(f)
        return y if self.loss == frozenset({"xent"}) else (y, f)


def resnet3d(num_classes, loss=frozenset({"xent", "htri"}), depth=50, **kwargs):
    """agrl_tpu's factory (agrl_tpu/models/resnet3d.py:134), the registry's
    `resnet3d50`: other keywords, `dtype` among them, are dropped."""
    return ResNet3D(num_classes=num_classes, loss=loss, depth=depth)


def resnet3dt(num_classes, loss=frozenset({"xent", "htri"}), depth=50, **kwargs):
    """The video re-id wrapper's name (reference resnet3dt.py): the same
    module, as agrl_tpu's (:139)."""
    return resnet3d(num_classes, loss, depth, **kwargs)
