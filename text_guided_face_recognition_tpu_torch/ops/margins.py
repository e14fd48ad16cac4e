"""Angular-margin classifier math (ArcFace, CosFace, SphereFace, AdaFace,
MagFace) in f32.

Counterpart of text_guided_face_recognition_tpu/ops/margins.py: one-hot by
F.one_hot on the labels' device, all trig and margin math in f32 whatever
the network's compute dtype. State the reference mutates on its modules is
explicit here, as in the JAX package: SphereFace's step counter and
AdaFace's EMA batch statistics go in and come out.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["normalized_cosine", "arc_margin_logits", "add_margin_logits",
           "sphere_margin_logits", "adaface_logits", "mag_margin_logits",
           "mag_loss_g", "linear_margin_fn"]


def _one_hot(label: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(label.long(), n).float()


def _unit(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-12)


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


def add_margin_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                      label: torch.Tensor, s: float = 30.0, m: float = 0.40
                      ) -> torch.Tensor:
    """CosFace cos(theta) - m logits, scaled by s."""
    cosine = normalized_cosine(embeddings, weight)
    one_hot = _one_hot(label, cosine.shape[1])
    return (one_hot * (cosine - m) + (1.0 - one_hot) * cosine) * s


_SPHERE_MLAMBDA = [
    lambda x: x * 0 + 1.0,
    lambda x: x,
    lambda x: 2 * x ** 2 - 1,
    lambda x: 4 * x ** 3 - 3 * x,
    lambda x: 8 * x ** 4 - 8 * x ** 2 + 1,
    lambda x: 16 * x ** 5 - 20 * x ** 3 + 5 * x,
]


def sphere_margin_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                         label: torch.Tensor,
                         iteration: Union[torch.Tensor, int], m: int = 4,
                         base: float = 1000.0, gamma: float = 0.12,
                         power: float = 1.0, lambda_min: float = 5.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SphereFace cos(m theta) with the annealed lambda; the step counter
    is explicit: (logits, iteration + 1)."""
    it = torch.as_tensor(iteration, dtype=torch.float32,
                         device=embeddings.device) + 1.0
    lamb = torch.clamp_min(base * (1 + gamma * it) ** (-power), lambda_min)
    cos_theta = torch.clamp(normalized_cosine(embeddings, weight), -1.0, 1.0)
    cos_m_theta = _SPHERE_MLAMBDA[m](cos_theta)
    # arccos'(+-1) is infinite: the argument stays strictly inside (-1, 1)
    # (the shift at the clamp leaves k = floor(m theta / pi) unchanged)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7))
    k = torch.floor(m * theta / math.pi)
    phi_theta = torch.pow(-1.0, k) * cos_m_theta - 2 * k
    norm = torch.linalg.vector_norm(embeddings.float(), dim=1)
    one_hot = _one_hot(label, cos_theta.shape[1])
    logits = one_hot * (phi_theta - cos_theta) / (1 + lamb) + cos_theta
    return logits * norm[:, None], it


def adaface_logits(embeddings: torch.Tensor, kernel: torch.Tensor,
                   norms: torch.Tensor, label: torch.Tensor,
                   batch_mean: torch.Tensor, batch_std: torch.Tensor,
                   m: float = 0.4, h: float = 0.333, s: float = 64.0,
                   t_alpha: float = 1.0, eps: float = 1e-3
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AdaFace's norm-adaptive margin over an (embedding_size, classnum)
    kernel (the reference's orientation); the EMA batch statistics are
    explicit: (logits, new batch_mean, new batch_std)."""
    e = embeddings.float()
    cosine = torch.clamp(e @ _unit(kernel.float(), 0), -1 + eps, 1 - eps)
    safe = torch.clamp(norms.float(), 0.001, 100).detach()
    mean, std = safe.mean(), safe.std(unbiased=True)
    new_mean = mean * t_alpha + (1 - t_alpha) * batch_mean
    new_std = std * t_alpha + (1 - t_alpha) * batch_std
    scaler = torch.clamp((safe - new_mean) / (new_std + eps) * h, -1.0, 1.0)
    scaler = scaler.reshape(-1, 1)
    one_hot = _one_hot(label, cosine.shape[1])
    theta = torch.arccos(cosine)
    theta_m = torch.clamp(theta + one_hot * (m * scaler * -1.0), eps,
                          math.pi - eps)
    cosine3 = torch.cos(theta_m) - one_hot * (m + m * scaler)
    return cosine3 * s, new_mean, new_std


def mag_margin_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                      margin_fn: Callable[[torch.Tensor], torch.Tensor],
                      l_a: float = 10.0, u_a: float = 110.0,
                      scale: float = 64.0, easy_margin: bool = True
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                 torch.Tensor]:
    """MagFace's magnitude-aware margin over an (in_features,
    out_features) weight: ((scaled cos theta, scaled cos(theta + m(|x|))),
    |x| clamped to [l_a, u_a])."""
    x = embeddings.float()
    x_norm = torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                         l_a, u_a)
    ada = margin_fn(x_norm)
    cos_m, sin_m = torch.cos(ada), torch.sin(ada)
    cos_theta = torch.clamp(_unit(x, 1) @ _unit(weight.float(), 0), -1.0, 1.0)
    # floored at 1e-12 as in arc_margin_logits
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta,
                                           1e-12))
    cos_theta_m = cos_theta * cos_m - sin_theta * sin_m
    if easy_margin:
        cos_theta_m = torch.where(cos_theta > 0, cos_theta_m, cos_theta)
    else:
        mm = torch.sin(math.pi - ada) * ada
        threshold = torch.cos(math.pi - ada)
        cos_theta_m = torch.where(cos_theta > threshold, cos_theta_m,
                                  cos_theta - mm)
    return (scale * cos_theta, scale * cos_theta_m), x_norm


def mag_loss_g(x_norm: torch.Tensor, u_a: float = 110.0) -> torch.Tensor:
    """MagFace's magnitude regulariser g, averaged."""
    return ((1.0 / u_a ** 2) * x_norm + 1.0 / x_norm).mean()


def linear_margin_fn(l_margin: float, u_margin: float, l_a: float,
                     u_a: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The margin linear in the feature norm, l_margin at l_a and u_margin
    at u_a."""
    def fn(x):
        return (u_margin - l_margin) / (u_a - l_a) * (x - l_a) + l_margin
    return fn
