"""Margin classifier heads as modules.

Counterpart of the ArcFace head of text_guided_face_recognition_tpu/models/
margins.py: a parameter-owning wrapper over the f32 math of ops/margins.py.
The JAX package's other heads (AddMarginProduct, SphereProduct, AdaFaceHead,
MagLinear) are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.ops.margins import (
    arc_margin_logits)

__all__ = ["ArcMarginProduct", "xavier_uniform_"]


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator
                    ) -> torch.Tensor:
    """U(-a, a), a = sqrt(6 / (fan_in + fan_out)), drawn from `generator`
    on the CPU whatever the weight's device (one seed, the same weights
    everywhere)."""
    bound = math.sqrt(6.0 / (weight.shape[0] + weight.shape[1]))
    weight.copy_((torch.rand(weight.shape, generator=generator) * 2.0 - 1.0)
                 * bound)
    return weight


class ArcMarginProduct(nn.Module):
    """ArcFace head: cos(theta + m) logits scaled by s over an
    (out_features, in_features) f32 class-weight matrix (s = 30, m = 0.5 on
    the image and fusion heads, s = 35 on the stage-1 text head)."""

    def __init__(self, in_features: int, out_features: int, s: float = 30.0,
                 m: float = 0.50, easy_margin: bool = False):
        super().__init__()
        self.s, self.m, self.easy_margin = s, m, easy_margin
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        xavier_uniform_(self.weight, torch.Generator().manual_seed(0))

    def forward(self, inputs: torch.Tensor, label: torch.Tensor
                ) -> torch.Tensor:
        return arc_margin_logits(inputs, self.weight, label, self.s, self.m,
                                 self.easy_margin)
