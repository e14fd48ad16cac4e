"""FCAM image-side heads, NCHW.

Counterpart of text_guided_face_recognition_tpu/models/image_heads.py.
`ImageHeading` projects the frozen backbone's global 512-d feature to the
shared 256-d space and refines the local map through IMIM (BN ->
self-attention -> LayerNorm -> bottleneck 1x1 convs -> projection).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.models.iresnet import Conv2d
from text_guided_face_recognition_tpu_torch.models.layers import (
    BatchNorm,
    LayerNormCHW,
    ProjectionHead,
    SelfAttention2D,
    l2_normalize,
)

__all__ = ["IMIM", "ImageHeading"]


class IMIM(nn.Module):
    """Intra-modal image modulation on the local map: (B, C, S, S) ->
    (B, feat_dim, S, S), l2-normalised over channels."""

    def __init__(self, channel_dim: int = 256, feat_dim: int = 256,
                 spatial: int = 14, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn_img = BatchNorm(channel_dim, dtype=dtype)
        self.sa = SelfAttention2D(channel_dim, scale=1, dtype=dtype)
        self.ln = LayerNormCHW(channel_dim, spatial, spatial)
        self.conv1x1_1 = Conv2d(channel_dim, channel_dim // 2, 1, bias=True,
                                dtype=dtype)
        self.conv1x1_2 = Conv2d(channel_dim // 2, channel_dim, 1, bias=True,
                                dtype=dtype)
        self.project_local = ProjectionHead(channel_dim, feat_dim, dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        img = self.bn_img(img.to(self.dtype))
        img = self.ln(self.sa(img, img))
        img = torch.relu(self.conv1x1_1(img))
        img = torch.relu(self.conv1x1_2(img))
        # ProjectionHead normalises already; the reference normalises once
        # more (idempotent, kept for exactness)
        return l2_normalize(self.project_local(img), dim=1)


class ImageHeading(nn.Module):
    """Global + local FCAM image head: (global (B, 512), local (B, C, S, S))
    -> (global (B, feat_dim), local (B, feat_dim, S, S))."""

    def __init__(self, feat_dim: int = 256, global_dim: int = 512,
                 local_channels: int = 256, spatial: int = 14,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.imim = IMIM(local_channels, feat_dim, spatial, dtype)
        self.project_global = ProjectionHead(global_dim, feat_dim, dtype)

    def forward(self, global_image: torch.Tensor, local_image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        local_image = self.imim(local_image)
        global_image = self.project_global(global_image.to(self.dtype))
        return global_image, local_image
