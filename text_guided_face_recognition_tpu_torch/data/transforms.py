"""Image transforms, numpy host-side.

Behavioral port of the reference's torchvision pipeline (reference:
utils/dataset_utils.py:57-79): train = RandomGrayscale(p=0.2) +
RandomHorizontalFlip(p=0.5); both splits ToTensor + Normalize(0.5, 0.5);
adaface models get an RGB->BGR channel permute.

Outputs are NHWC float32 in [-1, 1], the wire format the JAX package's
loader produces; the port's models permute to NCHW on the device.
Randomness is driven by an explicit numpy Generator.

Copy of text_guided_face_recognition_tpu/data/transforms.py: the port keeps
its own, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["train_transform", "train_aug_u8", "eval_transform",
           "decode_image"]

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)  # ITU-R 601-2 (PIL L)


def _normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [-1, 1] (ToTensor + Normalize(0.5, 0.5))."""
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def _to_bgr(img: np.ndarray) -> np.ndarray:
    return img[..., ::-1]


def train_aug_u8(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The augmentation half of train_transform: uint8 RGB -> uint8 RGB.
    uint8_images mode ships this to the device (4x less h2d than float32)
    and normalizes on-chip (ops/images.device_normalize — same math)."""
    if rng.random() < 0.2:  # RandomGrayscale(p=0.2)
        gray = (img.astype(np.float32) @ _LUMA)
        img = np.repeat(np.round(gray)[..., None], 3, axis=-1).astype(np.uint8)
    if rng.random() < 0.5:  # RandomHorizontalFlip(p=0.5)
        img = img[:, ::-1, :]
    return np.ascontiguousarray(img)


def train_transform(img: np.ndarray, rng: np.random.Generator,
                    model_type: str = "arcface") -> np.ndarray:
    """img: uint8 (H, W, 3) RGB -> float32 (H, W, 3) in [-1, 1]."""
    out = _normalize(train_aug_u8(img, rng))
    if model_type == "adaface":
        out = _to_bgr(out)
    return np.ascontiguousarray(out)


def eval_transform(img: np.ndarray, model_type: str = "arcface") -> np.ndarray:
    out = _normalize(img)
    if model_type == "adaface":
        out = _to_bgr(out)
    return np.ascontiguousarray(out)


def decode_image(path: str, img_size: Optional[int] = None) -> np.ndarray:
    """Decode to uint8 RGB HWC (reference: PIL open + convert('RGB'))."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if img_size is not None and img.size != (img_size, img_size):
        img = img.resize((img_size, img_size), Image.BILINEAR)
    return np.asarray(img, np.uint8)
