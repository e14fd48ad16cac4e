"""DAMSM word-region similarity: a hand-written CUDA kernel (K9) for the
forward, with a gradient that recomputes through the plain function.

Counterpart of text_guided_face_recognition_tpu/ops/damsm_pallas.py:
`damsm_similarity_pallas` (the kernel, csrc/damsm.cu) and the custom VJP
`damsm_similarity_fused`, whose backward is the VJP of the plain
`damsm_similarity` (ops/attention.py) at the saved inputs: here a
torch.autograd.Function whose backward re-runs the plain function under
`torch.enable_grad` and takes `torch.autograd.grad`.

The kernel follows the TPU kernel's numerics: invalid words masked with
-1e30 rather than -inf, and the two softmax sums and the cosine's norm
product clamped at eps; the plain version masks with -inf and clamps only
the norms. Inputs and output are f32 on both.

`damsm_similarity_cuda` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; it never falls back from one to the other. Each
kernel call adds one to `damsm_similarity_cuda.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda
from text_guided_face_recognition_tpu_torch.ops.attention import (
    damsm_similarity)

__all__ = ["damsm_similarity_cuda", "damsm_similarity_fused"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P)
MAX_PAIRS = 20 * 256   # csrc/damsm.cu: regions x words logits per block


def damsm_similarity_cuda(words: torch.Tensor, regions: torch.Tensor,
                          gamma1: float, gamma2: float,
                          word_mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-8) -> torch.Tensor:
    """K9: sim (B, B), sim[j, i] for image j and caption i.

    words (B, D, T), regions (B, D, R), f32 and contiguous; word_mask
    optional (B, T) bool. The kernel takes R * T <= 5120.
    """
    if words.device.type == "cpu":
        return damsm_similarity(words, regions, gamma1, gamma2, word_mask,
                                eps)
    name = "damsm_similarity_cuda"
    if words.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {words.device}")
    if words.dim() != 3 or regions.dim() != 3:
        raise ValueError(f"{name}: words (B, D, T) and regions (B, D, R)")
    b, d, t = words.shape
    r = regions.shape[2]
    for what, a, shape in (("words", words, (b, d, t)),
                           ("regions", regions, (b, d, r))):
        if tuple(a.shape) != shape or a.dtype != torch.float32 or \
                a.device != words.device or not a.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"{shape} tensor on {words.device}")
    if r * t > MAX_PAIRS:
        raise ValueError(f"{name}: the kernel takes R * T <= {MAX_PAIRS}, "
                         f"got {r} * {t}")
    mask = None
    if word_mask is not None:
        if tuple(word_mask.shape) != (b, t) or \
                word_mask.device != words.device:
            raise ValueError(f"{name}: word_mask must be ({b}, {t}) on "
                             f"{words.device}")
        mask = word_mask.to(torch.float32).contiguous()
    sim = torch.empty((b, b), dtype=torch.float32, device=words.device)
    fn = _cuda.function("damsm", "tgfr_damsm_similarity", _ARGTYPES)
    _cuda.launch(fn, words.data_ptr(), regions.data_ptr(),
                 None if mask is None else mask.data_ptr(), sim.data_ptr(),
                 b, d, t, r, float(gamma1), float(gamma2), float(eps))
    damsm_similarity_cuda.launches += 1
    return sim


class _DamsmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, words, regions, gamma1, gamma2, word_mask):
        ctx.gammas = (gamma1, gamma2)
        ctx.word_mask = word_mask
        ctx.save_for_backward(words, regions)
        return damsm_similarity_cuda(words, regions, gamma1, gamma2,
                                     word_mask)

    @staticmethod
    def backward(ctx, g):
        words, regions = ctx.saved_tensors
        with torch.enable_grad():
            w = words.detach().requires_grad_(True)
            r = regions.detach().requires_grad_(True)
            sim = damsm_similarity(w, r, *ctx.gammas, ctx.word_mask)
            dw, dr = torch.autograd.grad(sim, (w, r), g)
        return dw, dr, None, None, None


def damsm_similarity_fused(words: torch.Tensor, regions: torch.Tensor,
                           gamma1: float, gamma2: float,
                           word_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """DAMSM similarity with its gradient: K9 forward, the plain function's
    VJP (recomputed) backward."""
    return _DamsmFn.apply(words, regions, gamma1, gamma2, word_mask)


damsm_similarity_cuda.launches = 0
