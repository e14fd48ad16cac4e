"""Margin classifier heads as modules.

Counterpart of text_guided_face_recognition_tpu/models/margins.py:
parameter-owning wrappers over the f32 math of ops/margins.py (ArcFace,
CosFace, SphereFace, AdaFace, MagFace). SphereProduct's step counter and
AdaFaceHead's EMA batch statistics, the JAX package's `margin_stats`
collection, are buffers of the same names here, updated by each forward
as the reference updates its module attributes. Weights are drawn on the
CPU from a `torch.Generator` (seed 0 unless one is given) and moved to
`device`. AdaFaceHead keeps the reference's (embedding_size, classnum)
kernel as `weight` (classnum, embedding_size), the layout every
`kernel` leaf takes in the port (engine/from_jax.py); MagLinear's weight
stays (in_features, out_features), as in the reference and the JAX
package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.ops.margins import (
    adaface_logits, add_margin_logits, arc_margin_logits, linear_margin_fn,
    mag_margin_logits, sphere_margin_logits)

__all__ = ["ArcMarginProduct", "AddMarginProduct", "SphereProduct",
           "AdaFaceHead", "MagLinear", "xavier_uniform_"]


def _gen(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def _uniform_pm1(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U(-1, 1) drawn on the CPU (flax's uniform(scale=2) - 1)."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0).to(device)


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


class AddMarginProduct(nn.Module):
    """CosFace head: (cos(theta) - m) at the label, scaled by s, over an
    (out_features, in_features) f32 class-weight matrix."""

    def __init__(self, in_features: int, out_features: int, s: float = 30.0,
                 m: float = 0.40, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.s, self.m = s, m
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        xavier_uniform_(self.weight, _gen(generator))
        self.to(device)

    def forward(self, inputs: torch.Tensor, label: torch.Tensor
                ) -> torch.Tensor:
        return add_margin_logits(inputs, self.weight, label, self.s, self.m)


class SphereProduct(nn.Module):
    """SphereFace head with the annealed lambda; its step counter is the
    f32 buffer `iter`, advanced by each forward."""

    def __init__(self, in_features: int, out_features: int, m: int = 4,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.m = m
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        xavier_uniform_(self.weight, _gen(generator))
        self.register_buffer("iter", torch.zeros(()))
        self.to(device)

    def forward(self, inputs: torch.Tensor, label: torch.Tensor
                ) -> torch.Tensor:
        logits, it = sphere_margin_logits(inputs, self.weight, label,
                                          self.iter, self.m)
        with torch.no_grad():
            self.iter.copy_(it)
        return logits


class AdaFaceHead(nn.Module):
    """AdaFace's norm-adaptive margin head; the EMA buffers `batch_mean`
    (20) and `batch_std` (100) are updated by each forward."""

    def __init__(self, embedding_size: int, classnum: int, m: float = 0.4,
                 h: float = 0.333, s: float = 64.0, t_alpha: float = 1.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.m, self.h, self.s, self.t_alpha = m, h, s, t_alpha
        # the reference's (embedding_size, classnum) kernel, held transposed
        self.weight = nn.Parameter(
            _uniform_pm1((embedding_size, classnum), _gen(generator),
                         None).t().contiguous())
        self.register_buffer("batch_mean", torch.tensor(20.0))
        self.register_buffer("batch_std", torch.tensor(100.0))
        self.to(device)

    def forward(self, embeddings: torch.Tensor, norms: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
        logits, mean, std = adaface_logits(
            embeddings, self.weight.t(), norms, label, self.batch_mean,
            self.batch_std, self.m, self.h, self.s, self.t_alpha)
        with torch.no_grad():
            self.batch_mean.copy_(mean)
            self.batch_std.copy_(std)
        return logits


class MagLinear(nn.Module):
    """MagFace's magnitude-aware margin head over an (in_features,
    out_features) weight: ((scaled cos, scaled cos(theta + m(|x|))),
    |x|), the margin linear in |x| from l_margin at l_a to u_margin at
    u_a."""

    def __init__(self, in_features: int, out_features: int,
                 scale: float = 64.0, easy_margin: bool = True,
                 l_margin: float = 0.45, u_margin: float = 0.8,
                 l_a: float = 10.0, u_a: float = 110.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale, self.easy_margin = scale, easy_margin
        self.l_a, self.u_a = l_a, u_a
        self.margin_fn = linear_margin_fn(l_margin, u_margin, l_a, u_a)
        self.weight = nn.Parameter(_uniform_pm1(
            (in_features, out_features), _gen(generator), None))
        self.to(device)

    def forward(self, inputs: torch.Tensor):
        return mag_margin_logits(inputs, self.weight, self.margin_fn,
                                 self.l_a, self.u_a, self.scale,
                                 self.easy_margin)
