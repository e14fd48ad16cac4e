"""LayerNorm forward for the text tower: a hand-written CUDA kernel (K1) and
its plain PyTorch version.

Counterpart of text_guided_face_recognition_tpu/ops/layernorm_pallas.py
(`layernorm_fused`, forward only: the backward waits for the training
slice). Semantics: y = (x - mean) / sqrt(var + eps) * gamma + beta over the
last axis, statistics in f32, y in x's dtype; gamma/beta are f32 masters
used as they are (not rounded to x's dtype), as `FusedLayerNorm` passes them.

`layernorm_fused` runs the plain version for a CPU tensor and the kernel
(csrc/layernorm.cu) for a CUDA tensor; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda

__all__ = ["layernorm_fused", "layernorm_ref", "ln_f32", "LN_MAX_WIDTH"]

LN_MAX_WIDTH = 1024  # csrc/common.cuh kLnMaxWidth: a row held in registers

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _F, _I, _P)


def ln_f32(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float) -> torch.Tensor:
    """LayerNorm of f32 `r` over its last axis with f32 statistics (mean,
    then the centred variance), the order of the Pallas kernels."""
    mean = r.mean(dim=-1, keepdim=True)
    rc = r - mean
    var = (rc * rc).mean(dim=-1, keepdim=True)
    return (rc * torch.rsqrt(var + eps)) * gamma + beta


def layernorm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return ln_f32(x.float(), gamma.float(), beta.float(), eps).to(x.dtype)


def layernorm_fused(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis of `x` (any leading shape).

    x: float32 or bfloat16, contiguous, H <= 1024 on a card. gamma, beta:
    (H,) float32.
    Returns y with x's shape and dtype. Each kernel launch adds one to
    `layernorm_fused.launches`.
    """
    if x.device.type == "cpu":
        return layernorm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_fused: unsupported device {x.device}")
    h = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layernorm_fused: x dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("layernorm_fused: x must be contiguous")
    if h > LN_MAX_WIDTH:
        raise ValueError(f"layernorm_fused: the kernel takes H <= "
                         f"{LN_MAX_WIDTH}, got {h}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (h,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(f"layernorm_fused: {name} must be a contiguous "
                             f"float32 ({h},) tensor on {x.device}")
    y = torch.empty_like(x)
    rows = x.numel() // h
    if rows:
        fn = _cuda.function("layernorm", "tgfr_layernorm_fwd", _ARGTYPES)
        _cuda.launch(fn, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     y.data_ptr(), rows, h, float(eps),
                     _cuda.dtype_code(x.dtype))
        layernorm_fused.launches += 1
    return y


layernorm_fused.launches = 0
