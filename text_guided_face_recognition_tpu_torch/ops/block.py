"""Post-LN transformer half-layers, forward: hand-written CUDA kernels (K3,
K5) and their plain PyTorch versions.

Counterpart of text_guided_face_recognition_tpu/ops/block_pallas.py:

  attn_block: y = LN(x + (Wo . MHSA(x) + bo))         csrc/attn_block.cu
  ffn_block:  z = LN(x + (W2 . gelu(W1 . x + c1) + c2))  csrc/ffn_block.cu

Same argument order and layouts as the JAX functions, minus the dropout
bits and seed (dropout comes with the training slice: `rate > 0` raises).
Weights, biases and LayerNorm parameters are f32 masters, rounded to the
activation dtype inside the kernel, as flax rounds them at each use.
A weight has the JAX (in, out) shape; the kernel takes it as the
transposed view `linear.weight.t()` of a contiguous (out, in) nn.Linear
weight, the layout the port's modules store (the plain version takes any
layout).

Rounding points (block_pallas.py `_attn_heads_fwd`, `_ffn_fwd_kernel`):
every GEMM accumulates in f32, is rounded to the activation dtype, and then
gets its rounded bias; attention probabilities are rounded before P.V; the
key mask is an additive finfo(float32).min; LayerNorm statistics are f32.
GELU is the exact erf GELU.

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other. Each kernel call
adds one to the wrapper's `launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda
from text_guided_face_recognition_tpu_torch.ops.layernorm import (
    LN_MAX_WIDTH, ln_f32)

__all__ = ["attn_block", "attn_block_ref", "ffn_block", "ffn_block_ref",
           "dense_ref", "gelu"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FFN_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _F, _I, _P)
_ATTN_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _F, _I, _P)
D_HEAD = 64


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def dense_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    """x . w + bias with flax nn.Dense(dtype=x.dtype) rounding: the product
    of the rounded operands accumulated in f32, rounded, then the rounded
    bias added. w: (in, out) f32 master."""
    dt = x.dtype
    y = torch.matmul(x.float(), w.to(dt).float()).to(dt)
    return y + bias.to(dt)


def _ln_rounded_affine(r, gamma, beta, eps):
    dt = r.dtype
    return ln_f32(r.float(), gamma.to(dt).float(), beta.to(dt).float(),
                  eps).to(dt)


def ffn_block_ref(x, w1, c1, w2, c2, gamma, beta, rate: float = 0.0,
                  eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of `ffn_block`."""
    _no_dropout(rate, "ffn_block_ref")
    dt = x.dtype
    a = gelu(dense_ref(x, w1, c1).float()).to(dt)
    r = x + dense_ref(a, w2, c2)
    return _ln_rounded_affine(r, gamma, beta, eps)


def attn_block_ref(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b: int, t: int,
                   heads: int = 12, rate: float = 0.0,
                   eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of `attn_block`."""
    _no_dropout(rate, "attn_block_ref")
    dt = x.dtype
    h = x.shape[1]
    d = h // heads
    qkv = dense_ref(x, wqkv, bqkv).float()            # (R, 3H), values in dt

    def split(i):                                      # (B, heads, T, d)
        return qkv[:, i * h:(i + 1) * h].reshape(b, t, heads, d
                                                 ).permute(0, 2, 1, 3)

    q, k, v = split(0), split(1), split(2)
    neg = torch.finfo(torch.float32).min
    mbias = torch.where(mask.reshape(b, 1, 1, t) > 0,
                        torch.zeros((), device=x.device),
                        torch.full((), neg, device=x.device))
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d)) + mbias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    o = torch.matmul(p.float(), v).to(dt)              # (B, heads, T, d)
    o = o.permute(0, 2, 1, 3).reshape(b * t, h)
    r = x + dense_ref(o, wo, bo)
    return _ln_rounded_affine(r, gamma, beta, eps)


def _no_dropout(rate: float, name: str) -> None:
    if rate > 0.0:
        raise NotImplementedError(
            f"{name}: dropout (rate > 0) comes with the training slice "
            "(ROADMAP.md, Queue 1)")


def _check_act(name: str, x: torch.Tensor, widths) -> None:
    """x: a contiguous, 16-byte aligned (R, H) CUDA tensor; the GEMM tiles
    need every width in `widths` to be a multiple of 64, and the LayerNorm
    pass H <= 1024."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x dtype {x.dtype} not supported")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned "
                         "(R, H) tensor")
    if any(w % 64 for w in widths) or x.shape[1] > LN_MAX_WIDTH:
        raise ValueError(f"{name}: the kernel takes widths {widths} that are "
                         f"multiples of 64, and H <= {LN_MAX_WIDTH}")


def _check_master(name: str, what: str, p: torch.Tensor, shape, device
                  ) -> None:
    if tuple(p.shape) != tuple(shape) or p.dtype != torch.float32 or \
            p.device != device or not p.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}")


def _check_weight(name: str, what: str, w: torch.Tensor, shape, device
                  ) -> None:
    """w: a float32 (in, out) weight that is the .t() view of a contiguous,
    16-byte aligned (out, in) tensor."""
    if tuple(w.shape) != tuple(shape) or w.dtype != torch.float32 or \
            w.device != device:
        raise ValueError(f"{name}: {what} must be a float32 {tuple(shape)} "
                         f"tensor on {device}")
    if not w.t().is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be the .t() view of a "
                         "contiguous, 16-byte aligned (out, in) tensor, as "
                         "nn.Linear.weight.t() is")


def ffn_block(x, w1, c1, w2, c2, gamma, beta, rate: float = 0.0,
              eps: float = 1e-12) -> torch.Tensor:
    """Fused post-LN FFN half-layer, forward.

    x: (R, H) float32 or bfloat16. w1: (H, I), c1: (I,), w2: (I, H),
    c2: (H,), gamma/beta: (H,), all float32 masters. The kernel takes H and
    I multiples of 64, H <= 1024, and w1, w2 as .t() views of contiguous
    (out, in) tensors. Returns z: (R, H).
    """
    _no_dropout(rate, "ffn_block")
    if x.device.type == "cpu":
        return ffn_block_ref(x, w1, c1, w2, c2, gamma, beta, rate, eps)
    name = "ffn_block"
    inter = w1.shape[1] if w1.dim() == 2 else -1
    _check_act(name, x, (x.shape[-1], inter))
    rows, h = x.shape
    dev = x.device
    _check_weight(name, "w1", w1, (h, inter), dev)
    _check_weight(name, "w2", w2, (inter, h), dev)
    _check_master(name, "c1", c1, (inter,), dev)
    for what, p in (("c2", c2), ("gamma", gamma), ("beta", beta)):
        _check_master(name, what, p, (h,), dev)
    act = torch.empty((rows, inter), dtype=x.dtype, device=dev)
    resid = torch.empty_like(x)
    z = torch.empty_like(x)
    fn = _cuda.function("ffn_block", "tgfr_ffn_block_fwd", _FFN_ARGTYPES)
    _cuda.launch(fn, x.data_ptr(), w1.data_ptr(), c1.data_ptr(),
                 w2.data_ptr(), c2.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), act.data_ptr(), resid.data_ptr(),
                 z.data_ptr(), rows, h, inter, float(eps),
                 _cuda.dtype_code(x.dtype))
    ffn_block.launches += 1
    return z


def attn_block(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b: int, t: int,
               heads: int = 12, rate: float = 0.0,
               eps: float = 1e-12) -> torch.Tensor:
    """Fused post-LN self-attention half-layer, forward.

    x: (R, H) = (b*t, H) float32 or bfloat16; mask: (b, t) int32, nonzero
    = valid key; wqkv: (H, 3H) with [q|k|v] packed on the output axis,
    head-major within each; bqkv: (3H,); wo: (H, H); bo, gamma, beta: (H,);
    all float32 masters. The kernel takes heads of width 64 (H = 64 * heads),
    H <= 1024, t <= 128, and wqkv, wo as .t() views of contiguous (out, in)
    tensors. Returns y: (R, H).
    """
    _no_dropout(rate, "attn_block")
    if x.device.type == "cpu":
        return attn_block_ref(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b, t,
                              heads, rate, eps)
    name = "attn_block"
    _check_act(name, x, (x.shape[-1],))
    rows, h = x.shape
    dev = x.device
    if rows != b * t:
        raise ValueError(f"{name}: x has {rows} rows, expected b*t = {b * t}")
    if h != heads * D_HEAD:
        raise ValueError(f"{name}: the kernel takes heads of width {D_HEAD}; "
                         f"got H={h}, heads={heads}")
    if not 0 < t <= 128:
        raise ValueError(f"{name}: the kernel takes 1 <= t <= 128, got {t}")
    if tuple(mask.shape) != (b, t) or mask.dtype != torch.int32 or \
            mask.device != dev or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous int32 ({b}, {t})"
                         f" tensor on {dev}")
    _check_weight(name, "wqkv", wqkv, (h, 3 * h), dev)
    _check_weight(name, "wo", wo, (h, h), dev)
    _check_master(name, "bqkv", bqkv, (3 * h,), dev)
    for what, p in (("bo", bo), ("gamma", gamma), ("beta", beta)):
        _check_master(name, what, p, (h,), dev)
    qkv = torch.empty((rows, 3 * h), dtype=x.dtype, device=dev)
    ctx = torch.empty_like(x)
    resid = torch.empty_like(x)
    y = torch.empty_like(x)
    fn = _cuda.function("attn_block", "tgfr_attn_block_fwd", _ATTN_ARGTYPES)
    _cuda.launch(fn, x.data_ptr(), mask.data_ptr(), wqkv.data_ptr(),
                 bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), qkv.data_ptr(),
                 ctx.data_ptr(), resid.data_ptr(), y.data_ptr(), b, t, h,
                 heads, float(eps), _cuda.dtype_code(x.dtype))
    attn_block.launches += 1
    return y


ffn_block.launches = 0
attn_block.launches = 0
