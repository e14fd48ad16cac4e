"""Angular-margin classifier logits (ArcFace) in f32.

Counterpart of the ArcFace part of text_guided_face_recognition_tpu/ops/
margins.py: one-hot by F.one_hot on the labels' device, all trig and
margin math in f32 whatever the network's compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["normalized_cosine", "arc_margin_logits"]


def normalized_cosine(embeddings: torch.Tensor, weight: torch.Tensor
                      ) -> torch.Tensor:
    """cos(theta) between l2-normalised embeddings and class weights;
    weight (out_features, in_features), the F.linear layout."""
    e = embeddings.float()
    w = weight.float()
    e = e / torch.clamp_min(torch.linalg.vector_norm(e, dim=1, keepdim=True),
                            1e-12)
    w = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                            1e-12)
    return e @ w.t()


def arc_margin_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                      label: torch.Tensor, s: float = 30.0, m: float = 0.50,
                      easy_margin: bool = False) -> torch.Tensor:
    """ArcFace cos(theta + m) logits, scaled by s."""
    cosine = normalized_cosine(embeddings, weight)
    # 1 - cos^2 is floored at 1e-12, not 0: sqrt'(0) is inf, and a target
    # cosine that reaches +-1 would turn the backward into 0 * inf = NaN in
    # every parameter group at once (the JAX package's DEVIATIONS #22).
    sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 1e-12, 1.0))
    cos_m, sin_m = math.cos(m), math.sin(m)
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        phi = torch.where(cosine > th, phi, cosine - mm)
    one_hot = F.one_hot(label.long(), cosine.shape[1]).to(cosine.dtype)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * s
