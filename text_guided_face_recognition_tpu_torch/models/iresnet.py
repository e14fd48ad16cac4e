"""ArcFace iResNet face backbone, NCHW.

Counterpart of text_guided_face_recognition_tpu/models/iresnet.py:
BN-conv-BN-PReLU-conv-BN residual blocks with a stride-2 first block per
stage, a 3x3 stride-1 stem, and the dual output the pipeline relies on,
(global 512-d feature, local 256-channel map taken after layer 3; 14x14 for
112x112 input). As a frozen backbone, BatchNorm runs from its running
statistics (flax momentum 0.9 is torch momentum 0.1; eps 1e-5). Convs run
in `dtype`; fc and the scale-free `features` BN stay in f32. Depths 18,
34, 50, 100 and 200 (`IRESNET_LAYERS`); BatchNorm takes the batch's
statistics in train mode (MagFace's trainable SoftmaxBuilder).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from text_guided_face_recognition_tpu_torch.models.layers import (
    BatchNorm, Dense, PReLU)

__all__ = ["IResNet", "IRESNET_LAYERS", "iresnet18", "iresnet34",
           "iresnet50", "iresnet100", "iresnet200"]

# blocks per stage of each depth (the JAX package's and the reference's)
IRESNET_LAYERS = {"iresnet18": (2, 2, 2, 2), "iresnet34": (3, 4, 6, 3),
                  "iresnet50": (3, 4, 14, 3), "iresnet100": (3, 13, 30, 3),
                  "iresnet200": (6, 26, 60, 6)}


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype` with its weight rounded at each use;
    `groups` = cin gives a depthwise convolution."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.padding, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)
        return y


class IBasicBlock(nn.Module):
    """BN -> conv3x3 -> BN -> PReLU -> conv3x3(stride) -> BN (+ shortcut)."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.bn1 = BatchNorm(cin, dtype=dtype)
        self.conv1 = Conv2d(cin, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.prelu = PReLU(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, dtype=dtype)
        self.bn3 = BatchNorm(planes, dtype=dtype)
        if downsample:
            self.downsample_conv = Conv2d(cin, planes, 1, stride, 0,
                                          dtype=dtype)
            self.downsample_bn = BatchNorm(planes, dtype=dtype)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return out + x


class IResNet(nn.Module):
    """Four-stage iResNet for `img_size` x `img_size` input; forward returns
    (embedding (B, 512) f32, local map (B, 256, img/8, img/8) in `dtype`)."""

    def __init__(self, layers: Sequence[int], num_features: int = 512,
                 dtype: torch.dtype = torch.float32, img_size: int = 112):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 3, 1, 1, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        self.prelu = PReLU(64)
        self.stages = []
        cin = 64
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers), start=1):
            names = []
            for i in range(n_blocks):
                name = f"layer{stage}_{i}"
                self.add_module(name, IBasicBlock(
                    cin, planes, 2 if i == 0 else 1, i == 0, dtype))
                names.append(name)
                cin = planes
            self.stages.append(names)
        self.bn2 = BatchNorm(512, dtype=dtype)
        spatial = img_size // 16
        self.fc = Dense(512 * spatial * spatial, num_features, torch.float32)
        self.features = BatchNorm(num_features, use_scale=False,
                                  dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.prelu(self.bn1(self.conv1(x.to(self.dtype))))
        local_map = None
        for stage, names in enumerate(self.stages, start=1):
            for name in names:
                x = getattr(self, name)(x)
            if stage == 3:
                local_map = x
        x = self.bn2(x)
        # the JAX package flattens NHWC: keep its (H, W, C) feature order so
        # fc's weight carries over unchanged
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.features(self.fc(x.float()))
        return x, local_map


def iresnet18(**kw) -> IResNet:
    return IResNet(layers=IRESNET_LAYERS["iresnet18"], **kw)


def iresnet34(**kw) -> IResNet:
    return IResNet(layers=IRESNET_LAYERS["iresnet34"], **kw)


def iresnet50(**kw) -> IResNet:
    return IResNet(layers=IRESNET_LAYERS["iresnet50"], **kw)


def iresnet100(**kw) -> IResNet:
    return IResNet(layers=IRESNET_LAYERS["iresnet100"], **kw)


def iresnet200(**kw) -> IResNet:
    return IResNet(layers=IRESNET_LAYERS["iresnet200"], **kw)
