"""MagFace model surface.

Counterpart of text_guided_face_recognition_tpu/models/magface.py: the
reference's NetworkBuilder wraps an iresnet unchanged, so the frozen
MagFace backbone is the ArcFace iResNet (models/iresnet.py), returning
(global, local); its checkpoint differs only in its key prefix
(engine/convert.convert_magface, which takes the depth's `layers`). The
trainable surface: `SoftmaxBuilder` (an iResNet's features and the
MagLinear head of models/margins.py) and `mag_loss`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from text_guided_face_recognition_tpu_torch.models import iresnet
from text_guided_face_recognition_tpu_torch.models.margins import MagLinear
from text_guided_face_recognition_tpu_torch.ops.losses import (
    cross_entropy_rows)
from text_guided_face_recognition_tpu_torch.ops.margins import mag_loss_g

__all__ = ["network_builder", "SoftmaxBuilder", "mag_loss"]


def network_builder(arch: str = "iresnet18", **kw) -> iresnet.IResNet:
    """The MagFace backbone: the iresnet `arch` (iresnet18, 34, 50, 100 or
    200), (global, local) out."""
    if arch not in iresnet.IRESNET_LAYERS:
        raise ValueError(f"MagFace arch {arch!r} is not one of "
                         f"{tuple(iresnet.IRESNET_LAYERS)}")
    return getattr(iresnet, arch)(**kw)


class SoftmaxBuilder(nn.Module):
    """The trainable MagFace model: the iResNet `arch`'s features
    (`features`) and a MagLinear head (`fc`) whose margin is linear in the
    feature norm. forward(x NCHW) -> ((scaled cos, scaled cos(theta +
    m)), x_norm), for `mag_loss`; BatchNorm takes the batch's statistics
    in train mode."""

    def __init__(self, arch: str = "iresnet18", embedding_size: int = 512,
                 last_fc_size: int = 1000, arc_scale: float = 64.0,
                 l_margin: float = 0.45, u_margin: float = 0.8,
                 l_a: float = 10.0, u_a: float = 110.0,
                 dtype: torch.dtype = torch.float32, img_size: int = 112,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = network_builder(arch, num_features=embedding_size,
                                        dtype=dtype, img_size=img_size)
        self.fc = MagLinear(embedding_size, last_fc_size, scale=arc_scale,
                            l_margin=l_margin, u_margin=u_margin, l_a=l_a,
                            u_a=u_a, generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor):
        feats, _local = self.features(x)
        return self.fc(feats)


def mag_loss(logits_pair: Tuple[torch.Tensor, torch.Tensor],
             target: torch.Tensor, x_norm: torch.Tensor, u_a: float = 110.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MagFace's loss: (cross entropy of the margin logits at the target
    and the plain ones elsewhere, the magnitude regulariser g)."""
    cos_theta, cos_theta_m = logits_pair
    one_hot = F.one_hot(target.long(), cos_theta.shape[1]).to(
        cos_theta.dtype)
    output = one_hot * cos_theta_m + (1.0 - one_hot) * cos_theta
    return cross_entropy_rows(output, target), mag_loss_g(x_norm, u_a)
