"""Device-side image normalisation (uint8-on-the-wire mode).

Counterpart of text_guided_face_recognition_tpu/ops/images.py: with
`uint8_images` the host ships uint8 RGB and the device computes
x / 255 * 2 - 1 in float32 (plus the RGB->BGR flip for adaface), the same
ops in the same order as the host transform (data/transforms.py).
"""

from __future__ import annotations

import torch

__all__ = ["device_normalize"]


def device_normalize(img: torch.Tensor, model_type: str = "arcface"
                     ) -> torch.Tensor:
    """uint8 NHWC RGB -> float32 [-1, 1] (BGR for adaface); float input
    passes through untouched (host-normalised path)."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0 * 2.0 - 1.0
        if model_type == "adaface":
            img = img.flip(-1)
    return img
