"""Shared building blocks.

Counterpart of text_guided_face_recognition_tpu/models/layers.py. Spatial
modules are NCHW, PyTorch's habit; the JAX package is NHWC, and the tests
permute when they compare. Parameters are f32; each module computes in its
`dtype`, rounding parameters at each use as flax does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from text_guided_face_recognition_tpu_torch.parallel import mesh
from text_guided_face_recognition_tpu_torch.parallel.contrastive import (
    sync_sum)

__all__ = ["l2_normalize", "Dense", "PReLU", "BatchNorm", "ProjectionHead",
           "LayerNormCHW", "SelfAttention2D"]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along `dim`."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


class Dense(nn.Linear):
    """nn.Linear with flax nn.Dense(dtype=...) rounding: the input and the
    weight are rounded to `dtype`, the product is rounded, and then the
    rounded bias is added. Weight (out, in), as nn.Linear."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (NCHW); alpha is rounded to x's dtype."""

    def __init__(self, features: int, init_alpha: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), init_alpha))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.to(x.dtype).reshape(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, a * x)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with flax nn.BatchNorm semantics, computed in
    f32 and cast to `dtype`. `use_scale=False` gives the scale-free BN of
    the iResNet `features` layer; `use_bias=False` as well, the affine-free
    output BN of the AdaFace backbone.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch's: mean and the biased variance E[x^2] - E[x]^2 (floored
    at 0) over every axis but dim 1, in f32, differentiable; and it updates
    the running statistics in place, running = (1 - momentum) running +
    momentum batch with the biased variance, as flax's
    `mutable=["batch_stats"]` returns them (flax's momentum 0.9 is this
    momentum 0.1).

    With `sync` (parallel/mesh.py `sync_batchnorm`, set by the trainers
    under a process group) train mode takes the global batch's statistics:
    the per-channel sums of x and x^2, in f32, summed over the ranks
    (`sync_sum`, whose backward sums the cotangents over the ranks), over
    the global count; so every rank normalises with, and keeps, the same
    statistics, forward and backward, as the JAX package's BatchNorm over a
    sharded batch."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 use_scale: bool = True, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = (nn.Parameter(torch.ones(features)) if use_scale
                       else None)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.sync = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.sync:
            count = xf.numel() // xf.shape[1] * mesh.world_size()
            sums = sync_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims)]))
            mean, sq = (sums / count).chunk(2)
        else:
            mean = xf.mean(dims)
            sq = (xf * xf).mean(dims)
        var = torch.clamp_min(sq - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(self.dtype)


def _channels_last_dense(dense: Dense, x: torch.Tensor) -> torch.Tensor:
    """Apply a Dense over the channel axis of an NCHW map."""
    return dense(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ProjectionHead(nn.Module):
    """Dense + l2 normalisation over the feature axis (dim 1 for NCHW
    maps, the last axis for vectors)."""

    def __init__(self, in_features: int, projection_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.projection = Dense(in_features, projection_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            return l2_normalize(_channels_last_dense(self.projection, x), dim=1)
        return l2_normalize(self.projection(x), dim=-1)


class LayerNormCHW(nn.Module):
    """LayerNorm over the whole (C, H, W) block of an NCHW map with an
    elementwise (C, H, W) affine, statistics in f32, output in x's dtype
    (torch nn.LayerNorm([C, H, W]); the JAX package keeps the affine as
    (H, W, C))."""

    def __init__(self, c: int, h: int, w: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c, h, w))
        self.bias = nn.Parameter(torch.zeros(c, h, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = xf.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)


class SelfAttention2D(nn.Module):
    """Projected 2-D cross-attention on NCHW maps: q from `y`, k and v from
    `x`; attention[b, i, j] = <k_i, q_j> / sqrt(C / scale), softmax over j
    (the query axis), response_i = sum_j attention[i, j] v_j. Scores and the
    softmax in f32; probabilities rounded to v's dtype before the product."""

    def __init__(self, channel_dim: int, scale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channel_dim, self.scale = channel_dim, scale
        c_proj = channel_dim // scale
        self.query_proj = Dense(channel_dim, c_proj, dtype)
        self.key_proj = Dense(channel_dim, c_proj, dtype)
        self.value_proj = Dense(channel_dim, channel_dim, dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape

        def rows(t):  # (B, C, H, W) -> (B, HW, C)
            return t.flatten(2).transpose(1, 2)

        q = self.query_proj(rows(y))
        k = self.key_proj(rows(x))
        v = self.value_proj(rows(x))
        attn = torch.matmul(k.float(), q.float().transpose(1, 2))
        attn = attn / math.sqrt(self.channel_dim / self.scale)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)   # (B, HW, C)
        return out.transpose(1, 2).reshape(b, self.channel_dim, h, w)
