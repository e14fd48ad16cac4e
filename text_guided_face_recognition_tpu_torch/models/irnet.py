"""AdaFace IR / IR-SE face backbones, NCHW.

Counterpart of text_guided_face_recognition_tpu/models/irnet.py:
BasicBlockIR (BN-conv-BN-PReLU-conv(stride)-BN with a MaxPool(1, stride)
identity shortcut), BottleneckIR past 100 layers, optional SE modules, and
the three outputs (l2-normalised global feature, local map at body index 5,
feature norm), and the GNAP and GDC pooling heads, which no backbone of the
reference uses. For ir_18 at 112x112 the local map is the end of the
256-channel stage, (B, 256, 14, 14). The backbone is frozen: BatchNorm runs
from its running statistics and the output dropout is the identity. Convs
run in `dtype`; output_fc and the affine-free output BN stay in f32.
Submodule names follow the JAX package's flax tree (engine/from_jax.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.models.iresnet import Conv2d
from text_guided_face_recognition_tpu_torch.models.layers import (
    BatchNorm, Dense, PReLU)

__all__ = ["IRBackbone", "build_model", "SEModule", "GNAP", "GDC"]

_BLOCK_SPECS = {
    18: [(64, 2), (128, 2), (256, 2), (512, 2)],
    34: [(64, 3), (128, 4), (256, 6), (512, 3)],
    50: [(64, 3), (128, 4), (256, 14), (512, 3)],
    100: [(64, 3), (128, 13), (256, 30), (512, 3)],
    152: [(256, 3), (512, 8), (1024, 36), (2048, 3)],
    200: [(256, 3), (512, 24), (1024, 36), (2048, 3)],
}


class SEModule(nn.Module):
    """Squeeze-excite: mean over space -> 1x1 conv -> ReLU -> 1x1 conv ->
    sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, dtype=dtype)
        self.fc2 = Conv2d(channels // reduction, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class GNAP(nn.Module):
    """Global norm-aware pooling head over an NCHW map of `channels`: an
    affine-free BN, each position weighted by the mean feature norm over
    its own norm, the spatial mean, an affine-free f32 BN."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = BatchNorm(channels, use_scale=False, use_bias=False,
                             dtype=dtype)
        self.bn2 = BatchNorm(channels, use_scale=False, use_bias=False,
                             dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(x)
        x_norm = torch.linalg.vector_norm(x.float(), dim=1, keepdim=True)
        weight = x_norm.mean() / x_norm.clamp_min(1e-12)
        x = (x * weight.to(x.dtype)).mean(dim=(2, 3))
        return self.bn2(x.float())


class GDC(nn.Module):
    """Global depthwise convolution head over a 7 x 7 NCHW map of
    `channels`: a depthwise 7 x 7 conv and BN, the flatten, a bias-free f32
    Dense to `embedding_size` and an affine-free f32 BN."""

    def __init__(self, channels: int, embedding_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_dw = Conv2d(channels, channels, 7, dtype=dtype,
                              groups=channels)
        self.bn_dw = BatchNorm(channels, dtype=dtype)
        self.linear = Dense(channels, embedding_size, torch.float32,
                            bias=False)
        self.bn = BatchNorm(embedding_size, use_scale=False, use_bias=False,
                            dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn_dw(self.conv_dw(x)).flatten(1)
        return self.bn(self.linear(x.float()))


def _max_pool_stride(x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch MaxPool2d(kernel=1, stride=s): spatial subsampling."""
    return x if stride == 1 else x[:, :, ::stride, ::stride]


class _IRBlock(nn.Module):
    """The shortcut both block kinds share: the subsampled input when the
    width is kept, else a strided 1x1 conv and BN."""

    def _shortcut_init(self, cin: int, depth: int, stride: int,
                       dtype: torch.dtype) -> None:
        self.stride = stride
        if cin == depth:
            self.shortcut_conv = self.shortcut_bn = None
        else:
            self.shortcut_conv = Conv2d(cin, depth, 1, stride, dtype=dtype)
            self.shortcut_bn = BatchNorm(depth, dtype=dtype)

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_conv is None:
            return _max_pool_stride(x, self.stride)
        return self.shortcut_bn(self.shortcut_conv(x))


class BasicBlockIR(_IRBlock):
    """BN -> conv3x3 -> BN -> PReLU -> conv3x3(stride) -> BN (-> SE)."""

    def __init__(self, cin: int, depth: int, stride: int,
                 use_se: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self._shortcut_init(cin, depth, stride, dtype)
        self.res_bn1 = BatchNorm(cin, dtype=dtype)
        self.res_conv1 = Conv2d(cin, depth, 3, 1, 1, dtype=dtype)
        self.res_bn2 = BatchNorm(depth, dtype=dtype)
        self.res_prelu = PReLU(depth)
        self.res_conv2 = Conv2d(depth, depth, 3, stride, 1, dtype=dtype)
        self.res_bn3 = BatchNorm(depth, dtype=dtype)
        self.se = SEModule(depth, dtype=dtype) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.res_prelu(self.res_bn2(self.res_conv1(self.res_bn1(x))))
        res = self.res_bn3(self.res_conv2(res))
        if self.se is not None:
            res = self.se(res)
        return res + self._shortcut(x)


class BottleneckIR(_IRBlock):
    """BN -> 1x1 -> BN -> PReLU -> 3x3 -> BN -> PReLU -> 1x1(stride) -> BN
    (-> SE), a quarter of the width inside."""

    def __init__(self, cin: int, depth: int, stride: int,
                 use_se: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        red = depth // 4
        self._shortcut_init(cin, depth, stride, dtype)
        self.res_bn1 = BatchNorm(cin, dtype=dtype)
        self.res_conv1 = Conv2d(cin, red, 1, dtype=dtype)
        self.res_bn2 = BatchNorm(red, dtype=dtype)
        self.res_prelu1 = PReLU(red)
        self.res_conv2 = Conv2d(red, red, 3, 1, 1, dtype=dtype)
        self.res_bn3 = BatchNorm(red, dtype=dtype)
        self.res_prelu2 = PReLU(red)
        self.res_conv3 = Conv2d(red, depth, 1, stride, dtype=dtype)
        self.res_bn4 = BatchNorm(depth, dtype=dtype)
        self.se = SEModule(depth, dtype=dtype) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.res_prelu1(self.res_bn2(self.res_conv1(self.res_bn1(x))))
        res = self.res_prelu2(self.res_bn3(self.res_conv2(res)))
        res = self.res_bn4(self.res_conv3(res))
        if self.se is not None:
            res = self.se(res)
        return res + self._shortcut(x)


class IRBackbone(nn.Module):
    """AdaFace backbone for 112x112 input; forward returns (global (B, 512)
    f32 l2-normalised, local map in `dtype` at body index `local_index`,
    norm (B, 1) f32)."""

    def __init__(self, num_layers: int = 18, mode: str = "ir",
                 dtype: torch.dtype = torch.float32, local_index: int = 5):
        super().__init__()
        if num_layers not in _BLOCK_SPECS:
            raise ValueError(f"num_layers={num_layers} is not one of "
                             f"{sorted(_BLOCK_SPECS)}")
        block = BottleneckIR if num_layers > 100 else BasicBlockIR
        self.dtype, self.local_index = dtype, local_index
        self.input_conv = Conv2d(3, 64, 3, 1, 1, dtype=dtype)
        self.input_bn = BatchNorm(64, dtype=dtype)
        self.input_prelu = PReLU(64)
        self.n_body = 0
        cin = 64
        for depth, units in _BLOCK_SPECS[num_layers]:
            for u in range(units):
                self.add_module(f"body_{self.n_body}", block(
                    cin, depth, 2 if u == 0 else 1, mode == "ir_se", dtype))
                cin = depth
                self.n_body += 1
        self.output_bn = BatchNorm(cin, dtype=dtype)
        self.output_fc = Dense(cin * 7 * 7, 512, torch.float32)
        self.output_features = BatchNorm(512, use_scale=False, use_bias=False,
                                         dtype=torch.float32)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.input_prelu(self.input_bn(self.input_conv(x.to(self.dtype))))
        local = None
        for i in range(self.n_body):
            x = getattr(self, f"body_{i}")(x)
            if i == self.local_index:
                local = x
        x = self.output_bn(x)
        # the (H, W, C) flatten of the JAX package (engine/convert.py)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.output_features(self.output_fc(x.float()))
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / norm.clamp_min(1e-12), local, norm


_MODELS = {
    "ir_18": (18, "ir"), "ir_34": (34, "ir"), "ir_50": (50, "ir"),
    "ir_101": (100, "ir"), "ir_152": (152, "ir"), "ir_200": (200, "ir"),
    "ir_se_50": (50, "ir_se"), "ir_se_101": (100, "ir_se"),
    "ir_se_152": (152, "ir_se"), "ir_se_200": (200, "ir_se"),
}


def build_model(model_name: str = "ir_50",
                dtype: torch.dtype = torch.float32) -> IRBackbone:
    """The AdaFace backbone by the reference's name."""
    if model_name not in _MODELS:
        raise ValueError(f"not a correct model name: {model_name}")
    num_layers, mode = _MODELS[model_name]
    return IRBackbone(num_layers=num_layers, mode=mode, dtype=dtype)
