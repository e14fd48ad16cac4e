"""AttnGAN's generator-side attention, which no entry point uses.

Counterpart of text_guided_face_recognition_tpu/models/legacy_attention.py
(`SpatialAttention`, `ChannelAttention`). Image features are NCHW here,
NHWC there; the context stays (B, sourceL, cdf), the JAX package's layout.
The reference's 1x1-conv context projections are bias-free Dense layers
over the context's channels, sized at construction (the JAX package sizes
them from the call).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.models.layers import Dense

__all__ = ["SpatialAttention", "ChannelAttention"]


class SpatialAttention(nn.Module):
    """Word-context attention over the positions of an (B, idf, H, W) map:
    the context (B, L, cdf) projected to idf (`conv_context`), each
    position's softmax over the L words (f32; `mask` (B, L) True drops a
    word). Returns (weighted context (B, idf, H W), attn (B, L, H, W))."""

    def __init__(self, idf: int, cdf: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_context = Dense(cdf, idf, dtype, bias=False)

    def forward(self, inputs: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, _, h, w = inputs.shape
        source = self.conv_context(context)                  # (B, L, idf)
        target = inputs.flatten(2).transpose(1, 2)           # (B, HW, idf)
        attn = torch.matmul(target, source.transpose(1, 2))  # (B, HW, L)
        if mask is not None:
            attn = attn.masked_fill(mask[:, None, :], -float("inf"))
        attn = torch.softmax(attn.float(), dim=-1)
        weighted = torch.matmul(source.transpose(1, 2),
                                attn.to(source.dtype).transpose(1, 2))
        return weighted, attn.transpose(1, 2).reshape(b, -1, h, w)


class ChannelAttention(nn.Module):
    """Channel-wise attention: the context (B, L, cdf) projected to ih iw
    positions (`conv_context{ih}`), each channel of the weighted context
    (B, idf, ih iw) attending over the L words (f32). Returns (weighted
    (B, idf, ih, iw), attn (B, idf, L))."""

    def __init__(self, idf: int, cdf: int, ih: int, iw: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ih, self.iw = ih, iw
        self.add_module(f"conv_context{ih}",
                        Dense(cdf, ih * iw, dtype, bias=False))

    def forward(self, weighted_context: torch.Tensor, context: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = context.shape[0]
        proj = getattr(self, f"conv_context{self.ih}")
        source_c = proj(context).transpose(1, 2)             # (B, HW, L)
        attn_c = torch.softmax(
            torch.matmul(weighted_context, source_c).float(), dim=-1)
        weighted_c = torch.matmul(source_c,
                                  attn_c.to(source_c.dtype).transpose(1, 2))
        return (weighted_c.transpose(1, 2).reshape(b, -1, self.ih, self.iw),
                attn_c)
