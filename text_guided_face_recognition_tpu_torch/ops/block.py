"""Post-LN transformer half-layers and the whole tower: hand-written CUDA
kernels for the forwards (K3, K5, K7) and the backwards (K4, K6, K8), and
their plain PyTorch versions.

Counterpart of text_guided_face_recognition_tpu/ops/block_pallas.py:

  attn_block:  y = LN(x + drop(Wo . MHSA(x) + bo))           csrc/attn_block.cu
  ffn_block:   z = LN(x + drop(W2 . gelu(W1 . x + c1) + c2))  csrc/ffn_block.cu
  tower_block: L layers of attn_block then ffn_block, one kernel launch
               each way                                      csrc/tower_block.cu

Same argument order and layouts as the JAX functions. Dropout (rate > 0)
takes its bits from exactly one of two sources, with the keep rule of
ops/dropout.py:
- host bits (the JAX kernels' `use_prng=False`): int32 tensors holding
  uint32 patterns, bits_p (heads*B, T, T) on the attention probabilities,
  bits_h / bits (R, H) on the half-layer's output;
- `seed=` (the JAX kernels' `use_prng=True`): an int32 (1,) tensor on the
  input's device, from which the kernels draw the stream of ops/philox.py
  in-kernel, the forward and the backward alike; `ffn_block` takes the
  layer seed and draws its stream seed ^ 0x5BD1E995, `tower_block` the one
  seed s and draws stream s + j in layer j. The plain versions call
  ops/philox.py's plain dumps, so the plain and kernel forms of prng mode
  see the same masks, and prng mode equals host mode fed the dump of the
  same seed (K10-K12). Weights, biases
and LayerNorm parameters are f32 masters, rounded to the activation dtype
inside the kernel, as flax rounds them at each use. A weight has the JAX
(in, out) shape; the kernel takes it as the transposed view
`linear.weight.t()` of a contiguous (out, in) nn.Linear weight, the layout
the port's modules store. The plain version takes any layout and brings a
weight to that one before each product (`kernel_layout`): on the CPU a
product's summation order follows its operands' memory layout, so the
plain result is then the same bits whatever layout the caller holds.

Rounding points (block_pallas.py `_attn_heads_fwd`, `_attn_heads_bwd`,
`_ffn_fwd_kernel`, `_ffn_bwd_kernel`): every GEMM accumulates in f32, is
rounded to the activation dtype, and then gets its rounded bias;
attention probabilities are rounded before dropout and P.V; the key mask
is an additive finfo(float32).min; LayerNorm statistics are f32. GELU is
the exact erf GELU, and the backward uses its analytic derivative. In the
backwards every activation gradient (dr, the dropped dr, da, df, do, the
per-head ds/dq/dk/dv) is rounded to the activation dtype, dx is
r(dr + r(acc)), and weight and bias gradients stay f32.

`ffn_block` and `attn_block` are torch.autograd.Functions. Their forward
saves the residuals the backward reads (ffn: x, f, act, r; attn: x, qkv,
p, o, r), and the bits or the seed, only when a gradient is needed: grad
mode on where the wrapper is called (forward itself runs with it off) and
an input that requires one; the serving path (inference mode) saves
nothing, whatever its parameters' requires_grad.
Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; it never falls back from one to the other. Each kernel call
adds one to its wrapper's `launches`: `ffn_block.launches` (K3),
`ffn_block_bwd.launches` (K4), `attn_block.launches` (K5),
`attn_block_bwd.launches` (K6), `tower_block.launches` (K7),
`tower_block_bwd.launches` (K8).

The tower (`tower_block`) takes its 12 per-layer leaves stacked (L, ...) and
ALREADY rounded to the activation dtype (the model stacks and casts once
per step; autograd's stack/cast backward hands each f32 parameter its
gradient), weights as the transposed view of a contiguous (L, out, in)
stack, biases and LayerNorm parameters (L, 1, n). Its arithmetic is the
half-layers' at every rounding point, with two differences in the
backward, both the TPU kernel's: gelu(f) and y = LN(r1) are recomputed, not
saved, and every gradient is rounded to the stacked leaves' dtype (K4 and K6
return f32 weight gradients), so in bf16 `tower` and `both` differ by that
rounding. Host dropout bits are stacked (L, ...) views of the step's one
flat draw; a layer's slice must be contiguous, the layer stride is free.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda
from text_guided_face_recognition_tpu_torch.ops.dropout import (
    dropout, threshold)
from text_guided_face_recognition_tpu_torch.ops.layernorm import (
    LN_MAX_WIDTH, ln_bwd_counter, ln_bwd_f32, ln_bwd_parts, ln_f32)
from text_guided_face_recognition_tpu_torch.ops.philox import (
    attn_stream_bits_ref, check_seed, ffn_seed, ffn_stream_bits_ref,
    tower_stream_bits_ref)

__all__ = ["attn_block", "attn_block_ref", "attn_block_fwd",
           "attn_block_fwd_ref", "attn_block_bwd", "attn_block_bwd_ref",
           "ffn_block", "ffn_block_ref", "ffn_block_fwd", "ffn_block_fwd_ref",
           "ffn_block_bwd", "ffn_block_bwd_ref", "tower_block",
           "tower_block_ref", "tower_block_fwd", "tower_block_fwd_ref",
           "tower_block_bwd", "tower_block_bwd_ref", "TOWER_LEAVES",
           "dense_ref", "gelu", "dgelu"]

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_FFN_FWD_ARGTYPES = (_P,) * 9 + (_U, _F) + (_P,) * 4 + (_I, _I, _I, _F, _I,
                                                         _P)
_FFN_BWD_ARGTYPES = (_P,) * 10 + (_U, _F) + (_P,) * 10 + (_I, _I, _I, _F, _I,
                                                          _P)
_ATTN_FWD_ARGTYPES = (_P,) * 11 + (_U, _F) + (_P,) * 5 + (_I, _I, _I, _I, _F,
                                                          _I, _P)
_ATTN_BWD_ARGTYPES = (_P,) * 12 + (_U, _F) + (_P,) * 11 + (_I, _I, _I, _I,
                                                           _F, _I, _P)
_TOWER_ARGTYPES = (_P,) * 4 + (_U, _F, _F, _I, _P)
D_HEAD = 64
# the tower's stacked leaves, in the JAX package's `_BlockP` order
TOWER_LEAVES = ("wqkv", "bqkv", "wo", "bo", "g1", "b1", "w1", "c1", "w2",
                "c2", "g2", "b2")
# The longest caption (t) the attention kernels take, forward and
# backward, bf16 and f32, the half-layers and the tower: bert-base's
# position table (csrc/common.cuh kAttnMaxT). The tensor-core tiles (bf16)
# hold two or four (T, 64) bf16 rows of a pair and walk the keys in blocks
# of 64; the f32 strip tiles walk queries and keys in strips of 64; the
# bf16 scalar tile (K5 with residuals and K7, up to t = 128) holds
# 3 (T, 64) + (T, T) f32.
MAX_T = 512
# The library the tower wrappers launch from: `tower_block`, or its
# measurement build `tower_block_phases` (ops/_cuda.py VARIANTS), which
# chip_smoke.py's phase table switches to around its own calls.
_TOWER_LIB = "tower_block"


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def dgelu(x: torch.Tensor) -> torch.Tensor:
    """Analytic derivative of the exact GELU: Phi(x) + x phi(x)."""
    return 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0)))) + \
        x * torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """An (in, out) weight as the .t() view of a contiguous (out, in)
    tensor, the layout the kernels take (a copy when it is held in
    another)."""
    return w if w.t().is_contiguous() else w.t().contiguous().t()


def dense_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
              ) -> torch.Tensor:
    """x . w + bias with flax nn.Dense(dtype=x.dtype) rounding: the product
    of the rounded operands accumulated in f32, rounded, then the rounded
    bias added. w: (in, out) f32 master, in any layout."""
    dt = x.dtype
    y = torch.matmul(x.float(), kernel_layout(w.to(dt).float())).to(dt)
    return y + bias.to(dt)


def _mm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """a . b of dt-valued operands, accumulated in f32, rounded to dt."""
    return torch.matmul(a.float(), b.float()).to(dt)


def _ln_rounded_affine(r, gamma, beta, eps):
    dt = r.dtype
    return ln_f32(r.float(), gamma.to(dt).float(), beta.to(dt).float(),
                  eps).to(dt)


def _ln_bwd_rounded(dy, r, gamma, eps):
    """(dr rounded to the activation dtype, dgamma, dbeta)."""
    dt = dy.dtype
    dr, dg, db = ln_bwd_f32(dy.float(), r.float(), gamma.to(dt).float(), eps)
    return dr.to(dt), dg, db


def _maybe_drop(x, bits, rate):
    return dropout(x, bits, rate) if rate > 0.0 else x


# ------------------------------------------------------------- plain FFN --

def ffn_block_fwd_ref(x, w1, c1, w2, c2, gamma, beta, bits=None,
                      rate: float = 0.0, eps: float = 1e-12, seed=None):
    """Plain forward with the backward's residuals: (z, f, act, r)."""
    if rate > 0.0 and seed is not None:
        bits = ffn_stream_bits_ref(seed, *x.shape)
    dt = x.dtype
    f = dense_ref(x, w1, c1)
    a = gelu(f.float()).to(dt)
    r = x + _maybe_drop(dense_ref(a, w2, c2), bits, rate)
    return _ln_rounded_affine(r, gamma, beta, eps), f, a, r


def ffn_block_ref(x, w1, c1, w2, c2, gamma, beta, rate: float = 0.0,
                  eps: float = 1e-12, bits=None, seed=None) -> torch.Tensor:
    """Plain PyTorch version of `ffn_block`."""
    return ffn_block_fwd_ref(x, w1, c1, w2, c2, gamma, beta, bits, rate,
                             eps, seed)[0]


def ffn_block_bwd_ref(dz, x, f, r, w1, w2, gamma, bits=None,
                      rate: float = 0.0, eps: float = 1e-12, seed=None):
    """Plain backward (block_pallas.py `_ffn_bwd_kernel`): (dx, dw1, dc1,
    dw2, dc2, dgamma, dbeta), weight gradients (in, out) f32."""
    if rate > 0.0 and seed is not None:
        bits = ffn_stream_bits_ref(seed, *x.shape)
    dt = dz.dtype
    dr, dg, db = _ln_bwd_rounded(dz, r, gamma, eps)
    dgg = _maybe_drop(dr, bits, rate)
    a = gelu(f.float()).to(dt)
    dw2 = a.float().t() @ dgg.float()
    da = _mm(dgg, kernel_layout(w2.to(dt)).t(), dt)
    df = (da.float() * dgelu(f.float())).to(dt)
    dw1 = x.float().t() @ df.float()
    dx = dr + _mm(df, kernel_layout(w1.to(dt)).t(), dt)
    return (dx, dw1, df.float().sum(0), dw2, dgg.float().sum(0), dg, db)


# ------------------------------------------------------- plain attention --

def _heads(m: torch.Tensor, b: int, t: int, heads: int) -> torch.Tensor:
    """(R, H) -> (B, heads, T, d) f32."""
    return m.float().reshape(b, t, heads, -1).permute(0, 2, 1, 3)


def _unheads(m: torch.Tensor) -> torch.Tensor:
    """(B, heads, T, d) -> (R, H)."""
    b, heads, t, d = m.shape
    return m.permute(0, 2, 1, 3).reshape(b * t, heads * d)


def _bhtt(p: torch.Tensor, b: int, heads: int) -> torch.Tensor:
    """(heads*B, T, T), the kernels' layout -> (B, heads, T, T)."""
    return p.reshape(heads, b, *p.shape[1:]).transpose(0, 1)


def attn_block_fwd_ref(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b: int,
                       t: int, heads: int = 12, bits_p=None, bits_h=None,
                       rate: float = 0.0, eps: float = 1e-12, seed=None):
    """Plain forward with the backward's residuals: (y, qkv, p, o, r), p
    (heads*B, T, T) rounded, before dropout."""
    dt = x.dtype
    h = x.shape[1]
    if rate > 0.0 and seed is not None:
        bits_p, bits_h = attn_stream_bits_ref(seed, b, t, h, heads)
    qkv = dense_ref(x, wqkv, bqkv)                     # (R, 3H)
    q, k, v = (_heads(qkv[:, i * h:(i + 1) * h], b, t, heads)
               for i in range(3))
    neg = torch.finfo(torch.float32).min
    mbias = torch.where(mask.reshape(b, 1, 1, t) > 0,
                        torch.zeros((), device=x.device),
                        torch.full((), neg, device=x.device))
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(h // heads))
    s = s + mbias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)     # (B, heads, T, T)
    pd = p if rate <= 0.0 else dropout(p, _bhtt(bits_p, b, heads), rate)
    o = _unheads(_mm(pd, v, dt))
    r = x + _maybe_drop(dense_ref(o, wo, bo), bits_h, rate)
    p_all = p.transpose(0, 1).reshape(heads * b, t, t)
    return _ln_rounded_affine(r, gamma, beta, eps), qkv, p_all, o, r


def attn_block_ref(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b: int, t: int,
                   heads: int = 12, rate: float = 0.0, eps: float = 1e-12,
                   bits_p=None, bits_h=None, seed=None) -> torch.Tensor:
    """Plain PyTorch version of `attn_block`."""
    return attn_block_fwd_ref(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b, t,
                              heads, bits_p, bits_h, rate, eps, seed)[0]


def attn_block_bwd_ref(dy, x, qkv, p, o, r, wqkv, wo, gamma, b: int, t: int,
                       heads: int = 12, bits_p=None, bits_h=None,
                       rate: float = 0.0, eps: float = 1e-12, seed=None):
    """Plain backward (block_pallas.py `_attn_bwd_kernel`): (dx, dwqkv,
    dbqkv, dwo, dbo, dgamma, dbeta), weight gradients (in, out) f32."""
    dt = dy.dtype
    h = x.shape[1]
    if rate > 0.0 and seed is not None:
        bits_p, bits_h = attn_stream_bits_ref(seed, b, t, h, heads)
    inv = 1.0 / math.sqrt(h // heads)
    dr, dg, db = _ln_bwd_rounded(dy, r, gamma, eps)
    dh = _maybe_drop(dr, bits_h, rate)
    dwo = o.float().t() @ dh.float()
    do = _heads(_mm(dh, kernel_layout(wo.to(dt)).t(), dt), b, t, heads)
    q, k, v = (_heads(qkv[:, i * h:(i + 1) * h], b, t, heads)
               for i in range(3))
    pb = _bhtt(p, b, heads)                            # (B, heads, T, T)
    pd = pb if rate <= 0.0 else dropout(pb, _bhtt(bits_p, b, heads), rate)
    dv = _mm(pd.transpose(-1, -2), do, dt)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if rate > 0.0:
        dp = dropout(dp, _bhtt(bits_p, b, heads), rate)
    p32 = pb.float()
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    ds = (ds * inv).to(dt)
    dq = _mm(ds, k, dt)
    dk = _mm(ds.transpose(-1, -2), q, dt)
    dqkv = torch.cat([_unheads(dq), _unheads(dk), _unheads(dv)], dim=-1)
    dwqkv = x.float().t() @ dqkv.float()
    dx = dr + _mm(dqkv, kernel_layout(wqkv.to(dt)).t(), dt)
    return (dx, dwqkv, dqkv.float().sum(0), dwo, dh.float().sum(0), dg, db)


# ------------------------------------------------------------ plain tower --

def _layer_bits(bits, j):
    return None if bits is None else bits[j]


def _tower_bits(seed, bits, rate, n_layers, b, t, h, heads):
    """The tower's (bits_p, bits_h, bits_f): the host bits, or the plain
    dump of stream seed + j for layer j."""
    if rate > 0.0 and seed is not None:
        return tower_stream_bits_ref(seed, n_layers, b, t, h, heads)
    return bits


def tower_block_fwd_ref(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2,
                        g2, b2, b: int, t: int, heads: int = 12, bits_p=None,
                        bits_h=None, bits_f=None, rate: float = 0.0,
                        eps: float = 1e-12, seed=None):
    """Plain forward of the tower with the backward's residuals: (z, xin,
    qkv, p, o, r1, f, r2), each residual stacked (L, ...). The half-layers'
    plain forwards compose it: their rounding points are the tower's
    (block_pallas.py `_tower_fwd_kernel`)."""
    bits_p, bits_h, bits_f = _tower_bits(seed, (bits_p, bits_h, bits_f),
                                         rate, wqkv.shape[0], b, t,
                                         x.shape[1], heads)
    res = [[] for _ in range(7)]
    for j in range(wqkv.shape[0]):
        y, qkv, p, o, r1 = attn_block_fwd_ref(
            x, mask, wqkv[j], bqkv[j, 0], wo[j], bo[j, 0], g1[j, 0], b1[j, 0],
            b, t, heads, _layer_bits(bits_p, j), _layer_bits(bits_h, j), rate,
            eps)
        z, f, _, r2 = ffn_block_fwd_ref(y, w1[j], c1[j, 0], w2[j], c2[j, 0],
                                        g2[j, 0], b2[j, 0],
                                        _layer_bits(bits_f, j), rate, eps)
        for acc, v in zip(res, (x, qkv, p, o, r1, f, r2)):
            acc.append(v)
        x = z
    return (x, *(torch.stack(v) for v in res))


def tower_block_ref(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2,
                    b2, b: int, t: int, heads: int = 12, rate: float = 0.0,
                    eps: float = 1e-12, bits_p=None, bits_h=None,
                    bits_f=None, seed=None) -> torch.Tensor:
    """Plain PyTorch version of `tower_block`."""
    return tower_block_fwd_ref(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1,
                               w2, c2, g2, b2, b, t, heads, bits_p, bits_h,
                               bits_f, rate, eps, seed)[0]


def tower_block_bwd_ref(dz, mask, xin, qkv, p, o, r1, f, r2, wqkv, wo, g1,
                        b1, w1, w2, g2, b: int, t: int, heads: int = 12,
                        bits_p=None, bits_h=None, bits_f=None,
                        rate: float = 0.0, eps: float = 1e-12, seed=None):
    """Plain backward of the tower (block_pallas.py `_tower_bwd_kernel`):
    (dx, dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, dc1, dw2, dc2, dg2, db2),
    the 12 gradients stacked like their leaves and rounded to the leaves'
    dtype. Layers run in reverse; y = LN(r1), the FFN half's input, is
    recomputed (gelu(f) too, inside the half-layer's plain backward)."""
    bits_p, bits_h, bits_f = _tower_bits(seed, (bits_p, bits_h, bits_f),
                                         rate, wqkv.shape[0], b, t,
                                         dz.shape[1], heads)
    lt = wqkv.dtype
    grads = [[] for _ in range(12)]
    for j in reversed(range(wqkv.shape[0])):
        y = _ln_rounded_affine(r1[j], g1[j, 0], b1[j, 0], eps)
        dy, dw1, dc1, dw2, dc2, dg2, db2 = ffn_block_bwd_ref(
            dz, y, f[j], r2[j], w1[j], w2[j], g2[j, 0],
            _layer_bits(bits_f, j), rate, eps)
        dz, dwqkv, dbqkv, dwo, dbo, dg1, db1 = attn_block_bwd_ref(
            dy, xin[j], qkv[j], p[j], o[j], r1[j], wqkv[j], wo[j], g1[j, 0],
            b, t, heads, _layer_bits(bits_p, j), _layer_bits(bits_h, j), rate,
            eps)
        for acc, v in zip(grads, (dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, dc1,
                                  dw2, dc2, dg2, db2)):
            acc.append(v.to(lt) if v.dim() == 2 else v.to(lt)[None])
    return (dz, *(torch.stack(v[::-1]) for v in grads))


# ---------------------------------------------------------------- checks --

def _check_rate(name: str, rate: float, bits, seed=None) -> None:
    """rate in [0, 1); with rate > 0 exactly one dropout source: every one
    of the site's host bits, or the seed."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: rate must be in [0, 1), got {rate}")
    if rate <= 0.0:
        return
    given = [bt is not None for bt in bits]
    if seed is not None and any(given):
        raise ValueError(f"{name}: dropout takes host bits or a seed, not "
                         "both")
    if seed is None and not all(given):
        raise ValueError(f"{name}: rate > 0 needs its dropout bits (host "
                         "bits) or a seed (in-kernel bits)")


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


def _check_like(name: str, what: str, a: torch.Tensor, shape, x) -> None:
    """a: a contiguous, 16-byte aligned tensor of x's dtype and device."""
    if tuple(a.shape) != tuple(shape) or a.dtype != x.dtype or \
            a.device != x.device or not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be a contiguous, 16-byte "
                         f"aligned {x.dtype} {tuple(shape)} tensor on "
                         f"{x.device}")


def _check_bits(name: str, what: str, bits, shape, device) -> None:
    if bits is None:
        return
    if tuple(bits.shape) != tuple(shape) or bits.dtype != torch.int32 or \
            bits.device != device or not bits.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous int32 "
                         f"{tuple(shape)} tensor on {device}")


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


def _ptr(a: Optional[torch.Tensor]) -> Optional[int]:
    return None if a is None else a.data_ptr()


def _sources(name: str, rate: float, bits, seed, device):
    """The kernel's dropout sources: (bits..., seed), all None at rate 0;
    the seed checked for the kernel."""
    if rate <= 0.0:
        return (None,) * len(bits) + (None,)
    if seed is not None:
        check_seed(name, seed, device)
    return (*bits, seed)


def _drop_args(rate: float) -> Tuple[int, float]:
    return ((threshold(rate), float(1.0 / (1.0 - rate))) if rate > 0.0
            else (0, 1.0))


def _ln_part(rows: int, dev) -> Tuple[int, int]:
    """The LN backward's scratch (its partial column sums) and the current
    stream's arrival counters, as pointers (ops/layernorm.py)."""
    part = torch.empty((ln_bwd_parts(rows), 3 * LN_MAX_WIDTH),
                       dtype=torch.float32, device=dev)
    return part.data_ptr(), ln_bwd_counter(dev).data_ptr()


# ---------------------------------------------------------- FFN kernels --

def ffn_block_fwd(x, w1, c1, w2, c2, gamma, beta, bits=None,
                  rate: float = 0.0, eps: float = 1e-12, save: bool = True,
                  seed=None):
    """K3: the forward of `ffn_block` with the backward's residuals:
    (z, f = W1 x + c1, act = gelu(f), r = the pre-LN sum); on a card f is
    written only when `save`, else None. seed: the layer seed (prng mode);
    the kernel draws stream seed ^ 0x5BD1E995."""
    _check_rate("ffn_block", rate, (bits,), seed)
    if x.device.type == "cpu":
        return ffn_block_fwd_ref(x, w1, c1, w2, c2, gamma, beta, bits, rate,
                                 eps, seed)
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
    bits, seed = _sources(name, rate, (bits,), seed, dev)
    _check_bits(name, "bits", bits, (rows, h), dev)
    stream = None if seed is None else ffn_seed(seed)
    act = torch.empty((rows, inter), dtype=x.dtype, device=dev)
    f = torch.empty_like(act) if save else None
    resid = torch.empty_like(x)
    z = torch.empty_like(x)
    thr, scale = _drop_args(rate)
    fn = _cuda.function("ffn_block", "tgfr_ffn_block_fwd", _FFN_FWD_ARGTYPES)
    _cuda.launch(fn, x.data_ptr(), w1.data_ptr(), c1.data_ptr(),
                 w2.data_ptr(), c2.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), _ptr(bits), _ptr(stream), thr, scale,
                 act.data_ptr(), _ptr(f), resid.data_ptr(), z.data_ptr(),
                 rows, h, inter,
                 float(eps), _cuda.dtype_code(x.dtype))
    ffn_block.launches += 1
    return z, f, act, resid


def ffn_block_bwd(dz, x, f, act, r, w1, w2, gamma, bits=None,
                  rate: float = 0.0, eps: float = 1e-12, seed=None):
    """K4: the gradients of `ffn_block` at its saved residuals (x, f =
    W1 x + c1, act = gelu(f), r = the pre-LN sum) for the cotangent dz,
    with the forward's dropout source (bits, or the layer seed whose stream
    the kernel regenerates). Returns (dx, dw1, dc1, dw2, dc2, dgamma,
    dbeta); weight gradients in the (in, out) shape of w1, w2, f32. On the
    CPU, act is not read."""
    _check_rate("ffn_block_bwd", rate, (bits,), seed)
    if dz.device.type == "cpu":
        return ffn_block_bwd_ref(dz, x, f, r, w1, w2, gamma, bits, rate, eps,
                                 seed)
    name = "ffn_block_bwd"
    inter = w1.shape[1] if w1.dim() == 2 else -1
    _check_act(name, x, (x.shape[-1], inter))
    rows, h = x.shape
    dev = x.device
    for what, a, shape in (("dz", dz, (rows, h)), ("r", r, (rows, h)),
                           ("f", f, (rows, inter)),
                           ("act", act, (rows, inter))):
        _check_like(name, what, a, shape, x)
    _check_weight(name, "w1", w1, (h, inter), dev)
    _check_weight(name, "w2", w2, (inter, h), dev)
    _check_master(name, "gamma", gamma, (h,), dev)
    bits, seed = _sources(name, rate, (bits,), seed, dev)
    _check_bits(name, "bits", bits, (rows, h), dev)
    stream = None if seed is None else ffn_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dw1 = torch.empty((inter, h), **f32)       # nn.Linear (out, in)
    dw2 = torch.empty((h, inter), **f32)
    dc1 = torch.empty(inter, **f32)
    dln = torch.empty(3 * h, **f32)
    dr = torch.empty_like(x)
    dgg = torch.empty_like(x) if rate > 0.0 else None
    df = torch.empty_like(act)
    thr, scale = _drop_args(rate)
    fn = _cuda.function("ffn_block", "tgfr_ffn_block_bwd", _FFN_BWD_ARGTYPES)
    _cuda.launch(fn, dz.data_ptr(), x.data_ptr(), f.data_ptr(),
                 act.data_ptr(), r.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 gamma.data_ptr(), _ptr(bits), _ptr(stream), thr, scale,
                 dx.data_ptr(), dw1.data_ptr(), dc1.data_ptr(), dw2.data_ptr(),
                 dln.data_ptr(), dr.data_ptr(), _ptr(dgg), df.data_ptr(),
                 *_ln_part(rows, dev), rows, h, inter,
                 float(eps), _cuda.dtype_code(x.dtype))
    ffn_block_bwd.launches += 1
    return (dx, dw1.t(), dc1, dw2.t(), dln[2 * h:], dln[:h], dln[h:2 * h])


class _FfnBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, c1, w2, c2, gamma, beta, bits, seed, rate, eps,
                grad):
        save = grad and any(ctx.needs_input_grad[:7])
        z, f, act, r = ffn_block_fwd(x, w1, c1, w2, c2, gamma, beta, bits,
                                     rate, eps, save, seed=seed)
        ctx.rate, ctx.eps = rate, eps
        if save:
            ctx.save_for_backward(x, f, act, r, w1, w2, gamma, bits, seed)
        return z

    @staticmethod
    def backward(ctx, dz):
        x, f, act, r, w1, w2, gamma, bits, seed = ctx.saved_tensors
        grads = ffn_block_bwd(dz.contiguous(), x, f, act, r, w1, w2, gamma,
                              bits, ctx.rate, ctx.eps, seed=seed)
        return (*grads, None, None, None, None, None)


def ffn_block(x, w1, c1, w2, c2, gamma, beta, rate: float = 0.0,
              eps: float = 1e-12, bits=None, seed=None) -> torch.Tensor:
    """Fused post-LN FFN half-layer with its gradient: K3 forward, K4
    backward.

    x: (R, H) float32 or bfloat16. w1: (H, I), c1: (I,), w2: (I, H),
    c2: (H,), gamma/beta: (H,), all float32 masters. When rate > 0, one
    dropout source: bits (R, H) int32, or seed (1,) int32, the layer seed
    (ops/philox.py). The kernels take H and I multiples of 64, H <= 1024,
    and w1, w2 as .t() views of contiguous (out, in) tensors. Returns
    z: (R, H).
    """
    _check_rate("ffn_block", rate, (bits,), seed)
    if rate <= 0.0:
        bits = seed = None
    return _FfnBlockFn.apply(x, w1, c1, w2, c2, gamma, beta, bits, seed,
                             rate, eps, torch.is_grad_enabled())


# ---------------------------------------------------- attention kernels --

def attn_block_fwd(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b: int, t: int,
                   heads: int = 12, bits_p=None, bits_h=None,
                   rate: float = 0.0, eps: float = 1e-12, save: bool = True,
                   seed=None):
    """K5: the forward of `attn_block` with the backward's residuals:
    (y, qkv, p = the rounded probabilities before dropout (heads*B, T, T),
    o = the context rows, r = the pre-LN sum); on a card p is written only
    when `save`, else None. seed: the layer seed (prng mode)."""
    _check_rate("attn_block", rate, (bits_p, bits_h), seed)
    if x.device.type == "cpu":
        return attn_block_fwd_ref(x, mask, wqkv, bqkv, wo, bo, gamma, beta,
                                  b, t, heads, bits_p, bits_h, rate, eps,
                                  seed)
    name = "attn_block"
    _check_act(name, x, (x.shape[-1],))
    rows, h = x.shape
    dev = x.device
    if rows != b * t:
        raise ValueError(f"{name}: x has {rows} rows, expected b*t = {b * t}")
    if h != heads * D_HEAD:
        raise ValueError(f"{name}: the kernel takes heads of width {D_HEAD}; "
                         f"got H={h}, heads={heads}")
    if not 0 < t <= MAX_T:
        raise ValueError(f"{name}: the kernel takes 1 <= t <= {MAX_T}, got "
                         f"{t}")
    if tuple(mask.shape) != (b, t) or mask.dtype != torch.int32 or \
            mask.device != dev or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous int32 ({b}, {t})"
                         f" tensor on {dev}")
    _check_weight(name, "wqkv", wqkv, (h, 3 * h), dev)
    _check_weight(name, "wo", wo, (h, h), dev)
    _check_master(name, "bqkv", bqkv, (3 * h,), dev)
    for what, p in (("bo", bo), ("gamma", gamma), ("beta", beta)):
        _check_master(name, what, p, (h,), dev)
    bits_p, bits_h, seed = _sources(name, rate, (bits_p, bits_h), seed, dev)
    _check_bits(name, "bits_p", bits_p, (heads * b, t, t), dev)
    _check_bits(name, "bits_h", bits_h, (rows, h), dev)
    qkv = torch.empty((rows, 3 * h), dtype=x.dtype, device=dev)
    p = (torch.empty((heads * b, t, t), dtype=x.dtype, device=dev) if save
         else None)
    ctx = torch.empty_like(x)
    resid = torch.empty_like(x)
    y = torch.empty_like(x)
    thr, scale = _drop_args(rate)
    fn = _cuda.function("attn_block", "tgfr_attn_block_fwd",
                        _ATTN_FWD_ARGTYPES)
    _cuda.launch(fn, x.data_ptr(), mask.data_ptr(), wqkv.data_ptr(),
                 bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), _ptr(bits_p),
                 _ptr(bits_h), _ptr(seed), thr, scale, qkv.data_ptr(), _ptr(p),
                 ctx.data_ptr(), resid.data_ptr(), y.data_ptr(), b, t, h,
                 heads, float(eps), _cuda.dtype_code(x.dtype))
    attn_block.launches += 1
    return y, qkv, p, ctx, resid


def attn_block_bwd(dy, x, qkv, p, o, r, wqkv, wo, gamma, b: int, t: int,
                   heads: int = 12, bits_p=None, bits_h=None,
                   rate: float = 0.0, eps: float = 1e-12, seed=None):
    """K6: the gradients of `attn_block` at its saved residuals (x, qkv,
    p = the rounded probabilities before dropout (heads*B, T, T), o = the
    context rows, r = the pre-LN sum) for the cotangent dy, with the
    forward's dropout source (bits, or the seed whose stream the kernel
    regenerates). Returns (dx, dwqkv, dbqkv, dwo, dbo, dgamma, dbeta);
    weight gradients in the (in, out) shape of wqkv, wo, f32."""
    _check_rate("attn_block_bwd", rate, (bits_p, bits_h), seed)
    if dy.device.type == "cpu":
        return attn_block_bwd_ref(dy, x, qkv, p, o, r, wqkv, wo, gamma, b, t,
                                  heads, bits_p, bits_h, rate, eps, seed)
    name = "attn_block_bwd"
    _check_act(name, x, (x.shape[-1],))
    rows, h = x.shape
    dev = x.device
    if rows != b * t or h != heads * D_HEAD or not 0 < t <= MAX_T:
        raise ValueError(f"{name}: the kernel takes x (b*t, heads*{D_HEAD}) "
                         f"with 1 <= t <= {MAX_T}; got {tuple(x.shape)}, "
                         f"b={b}, t={t}, heads={heads}")
    for what, a, shape in (("dy", dy, (rows, h)), ("o", o, (rows, h)),
                           ("r", r, (rows, h)), ("qkv", qkv, (rows, 3 * h))):
        _check_like(name, what, a, shape, x)
    if tuple(p.shape) != (heads * b, t, t) or p.dtype != x.dtype or \
            p.device != dev or not p.is_contiguous():
        raise ValueError(f"{name}: p must be a contiguous {x.dtype} "
                         f"({heads * b}, {t}, {t}) tensor on {dev}")
    _check_weight(name, "wqkv", wqkv, (h, 3 * h), dev)
    _check_weight(name, "wo", wo, (h, h), dev)
    _check_master(name, "gamma", gamma, (h,), dev)
    bits_p, bits_h, seed = _sources(name, rate, (bits_p, bits_h), seed, dev)
    _check_bits(name, "bits_p", bits_p, (heads * b, t, t), dev)
    _check_bits(name, "bits_h", bits_h, (rows, h), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((3 * h, h), **f32)     # nn.Linear (out, in)
    dbqkv = torch.empty(3 * h, **f32)
    dwo = torch.empty((h, h), **f32)
    dln = torch.empty(3 * h, **f32)
    dr = torch.empty_like(x)
    dh = torch.empty_like(x) if rate > 0.0 else None
    dout = torch.empty_like(x)
    dqkv = torch.empty_like(qkv)
    thr, scale = _drop_args(rate)
    fn = _cuda.function("attn_block", "tgfr_attn_block_bwd",
                        _ATTN_BWD_ARGTYPES)
    _cuda.launch(fn, dy.data_ptr(), x.data_ptr(), qkv.data_ptr(),
                 p.data_ptr(), o.data_ptr(), r.data_ptr(), wqkv.data_ptr(),
                 wo.data_ptr(), gamma.data_ptr(), _ptr(bits_p), _ptr(bits_h),
                 _ptr(seed), thr, scale, dx.data_ptr(), dwqkv.data_ptr(),
                 dbqkv.data_ptr(), dwo.data_ptr(), dln.data_ptr(),
                 dr.data_ptr(), _ptr(dh), dout.data_ptr(), dqkv.data_ptr(),
                 *_ln_part(rows, dev), b, t, h, heads,
                 float(eps), _cuda.dtype_code(x.dtype))
    attn_block_bwd.launches += 1
    return (dx, dwqkv.t(), dbqkv, dwo.t(), dln[2 * h:], dln[:h],
            dln[h:2 * h])


class _AttnBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, wqkv, bqkv, wo, bo, gamma, beta, bits_p,
                bits_h, seed, b, t, heads, rate, eps, grad):
        save = grad and any(ctx.needs_input_grad[:8])
        y, qkv, p, o, r = attn_block_fwd(x, mask, wqkv, bqkv, wo, bo, gamma,
                                         beta, b, t, heads, bits_p, bits_h,
                                         rate, eps, save, seed=seed)
        ctx.shape, ctx.rate, ctx.eps = (b, t, heads), rate, eps
        if save:
            ctx.save_for_backward(x, qkv, p, o, r, wqkv, wo, gamma, bits_p,
                                  bits_h, seed)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x, qkv, p, o, r, wqkv, wo, gamma, bits_p, bits_h,
         seed) = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwo, dbo, dg, db = attn_block_bwd(
            dy.contiguous(), x, qkv, p, o, r, wqkv, wo, gamma, *ctx.shape,
            bits_p, bits_h, ctx.rate, ctx.eps, seed=seed)
        return (dx, None, dwqkv, dbqkv, dwo, dbo, dg, db) + (None,) * 9


def attn_block(x, mask, wqkv, bqkv, wo, bo, gamma, beta, b: int, t: int,
               heads: int = 12, rate: float = 0.0, eps: float = 1e-12,
               bits_p=None, bits_h=None, seed=None) -> torch.Tensor:
    """Fused post-LN self-attention half-layer with its gradient: K5
    forward, K6 backward.

    x: (R, H) = (b*t, H) float32 or bfloat16; mask: (b, t) int32, nonzero
    = valid key; wqkv: (H, 3H) with [q|k|v] packed on the output axis,
    head-major within each; bqkv: (3H,); wo: (H, H); bo, gamma, beta: (H,);
    all float32 masters. When rate > 0, one dropout source: bits_p
    (heads*b, t, t) and bits_h (R, H) int32, or seed (1,) int32, the layer
    seed (ops/philox.py). The kernels take heads of width 64
    (H = 64 * heads), H <= 1024, t <= MAX_T (512), and wqkv, wo as .t()
    views of contiguous (out, in) tensors.
    Returns y: (R, H).
    """
    _check_rate("attn_block", rate, (bits_p, bits_h), seed)
    if rate <= 0.0:
        bits_p = bits_h = seed = None
    return _AttnBlockFn.apply(x, mask, wqkv, bqkv, wo, bo, gamma, beta,
                              bits_p, bits_h, seed, b, t, heads, rate, eps,
                              torch.is_grad_enabled())


# -------------------------------------------------------- tower kernels --

def _check_tower(name, x, mask, leaves, b, t, heads, bits, seed, rate):
    """The tower kernels' contract; returns (L, rows, h, inter)."""
    _check_rate(name, rate, bits, seed)
    wqkv, w1 = leaves["wqkv"], leaves["w1"]
    inter = w1.shape[2] if w1.dim() == 3 else -1
    _check_act(name, x, (x.shape[-1], inter))
    rows, h = x.shape
    dev = x.device
    n_layers = wqkv.shape[0]
    if rows != b * t or h != heads * D_HEAD or not 0 < t <= MAX_T:
        raise ValueError(f"{name}: the kernel takes x (b*t, heads*{D_HEAD}) "
                         f"with 1 <= t <= {MAX_T}; got {tuple(x.shape)}, "
                         f"b={b}, t={t}, heads={heads}")
    if tuple(mask.shape) != (b, t) or mask.dtype != torch.int32 or \
            mask.device != dev or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous int32 ({b}, {t})"
                         f" tensor on {dev}")
    shapes = {"wqkv": (h, 3 * h), "bqkv": (1, 3 * h), "wo": (h, h),
              "bo": (1, h), "g1": (1, h), "b1": (1, h), "w1": (h, inter),
              "c1": (1, inter), "w2": (inter, h), "c2": (1, h), "g2": (1, h),
              "b2": (1, h)}
    for what, a in leaves.items():
        shape = (n_layers,) + shapes[what]
        if tuple(a.shape) != shape or a.dtype != x.dtype or a.device != dev:
            raise ValueError(f"{name}: {what} must be a {x.dtype} {shape} "
                             f"tensor on {dev} (stacked, already rounded to "
                             "the activation dtype)")
        stored = a.transpose(1, 2) if what.startswith("w") else a
        if not stored.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(
                f"{name}: {what} must be "
                + ("the .transpose(1, 2) view of a contiguous, 16-byte "
                   "aligned (L, out, in) stack" if what.startswith("w")
                   else "contiguous and 16-byte aligned"))
    for what, bt, shape in (("bits_p", bits[0], (heads * b, t, t)),
                            ("bits_h", bits[1], (rows, h)),
                            ("bits_f", bits[2], (rows, h))):
        if bt is None:
            continue
        if tuple(bt.shape) != (n_layers,) + shape or \
                bt.dtype != torch.int32 or bt.device != dev or \
                not bt[0].is_contiguous():
            raise ValueError(f"{name}: {what} must be an int32 "
                             f"{(n_layers,) + shape} tensor on {dev} whose "
                             "per-layer slices are contiguous")
    return n_layers, rows, h, inter


def _tower_launch(fn_name, ptrs, bits, dims, rate, eps, dtype):
    """Call a tower launcher. ptrs: the C interface's pointer slots in order
    (None where absent); bits: the three host-bit stacks or Nones, for
    their layer strides. Returns (grid, blocks per SM, shared bytes)."""
    arr = (ctypes.c_void_p * len(ptrs))(*[_ptr(a) for a in ptrs])
    strides = (ctypes.c_longlong * 3)(*[0 if bt is None else bt.stride(0)
                                        for bt in bits])
    cdims = (ctypes.c_int * len(dims))(*dims)
    info = (ctypes.c_int * 3)()
    thr, scale = _drop_args(rate)
    fn = _cuda.function(_TOWER_LIB, fn_name, _TOWER_ARGTYPES)
    _cuda.launch(fn, arr, strides, cdims, info, thr, scale, float(eps),
                 _cuda.dtype_code(dtype))
    return tuple(info)


def tower_block_fwd(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2,
                    b2, b: int, t: int, heads: int = 12, bits_p=None,
                    bits_h=None, bits_f=None, rate: float = 0.0,
                    eps: float = 1e-12, save: bool = True, seed=None):
    """K7: the forward of `tower_block` in ONE kernel launch, with the
    backward's residuals: (z, xin, qkv, p, o, r1, f, r2), each residual
    stacked (L, ...); on a card they are allocated and written only when
    `save`, else None. seed: the tower's one seed (prng mode); layer j
    draws stream seed + j."""
    bits = (bits_p, bits_h, bits_f)
    _check_rate("tower_block", rate, bits, seed)
    leaves = dict(zip(TOWER_LEAVES, (wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2,
                                     c2, g2, b2)))
    if x.device.type == "cpu":
        return tower_block_fwd_ref(x, mask, *leaves.values(), b, t, heads,
                                   *bits, rate, eps, seed)
    *bits, seed = _sources("tower_block", rate, bits, seed, x.device)
    n, rows, h, inter = _check_tower("tower_block", x, mask, leaves, b, t,
                                     heads, bits, seed, rate)

    def buf(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    z = torch.empty_like(x)
    k = n if save else 1                   # residual slots
    xin = buf(n if save else 2, rows, h)   # saved inputs, or the ping-pong
    qkv, o, r1, r2 = (buf(k, rows, 3 * h), buf(k, rows, h), buf(k, rows, h),
                      buf(k, rows, h))
    p = buf(n, heads * b, t, t) if save else None
    f = buf(n, rows, inter) if save else None
    y, act = buf(rows, h), buf(rows, inter)
    tower_block_fwd.info = _tower_launch(
        "tgfr_tower_fwd",
        (x, mask, *leaves.values(), *bits, seed, z, xin, qkv, p, o, r1, f,
         r2, y, act), bits, (n, b, t, h, heads, inter, int(save)), rate, eps,
        x.dtype)
    tower_block.launches += 1
    if not save:
        return z, None, None, None, None, None, None, None
    return z, xin, qkv, p, o, r1, f, r2


def tower_block_bwd(dz, mask, xin, qkv, p, o, r1, f, r2, wqkv, wo, g1, b1,
                    w1, w2, g2, b: int, t: int, heads: int = 12, bits_p=None,
                    bits_h=None, bits_f=None, rate: float = 0.0,
                    eps: float = 1e-12, seed=None):
    """K8: the gradients of `tower_block` in ONE kernel launch, at its saved
    residuals for the cotangent dz, with the forward's dropout source.
    Returns (dx, dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, dc1, dw2, dc2, dg2,
    db2), the 12 gradients stacked like their leaves, in the leaves' dtype
    and layout."""
    bits = (bits_p, bits_h, bits_f)
    _check_rate("tower_block_bwd", rate, bits, seed)
    if dz.device.type == "cpu":
        return tower_block_bwd_ref(dz, mask, xin, qkv, p, o, r1, f, r2, wqkv,
                                   wo, g1, b1, w1, w2, g2, b, t, heads, *bits,
                                   rate, eps, seed)
    name = "tower_block_bwd"
    *bits, seed = _sources(name, rate, bits, seed, dz.device)
    leaves = dict(wqkv=wqkv, wo=wo, g1=g1, b1=b1, w1=w1, w2=w2, g2=g2)
    n, rows, h, inter = _check_tower(name, dz, mask, leaves, b, t, heads,
                                     bits, seed, rate)
    for what, a, shape in (("xin", xin, (rows, h)), ("qkv", qkv,
                                                     (rows, 3 * h)),
                           ("p", p, (heads * b, t, t)), ("o", o, (rows, h)),
                           ("r1", r1, (rows, h)), ("f", f, (rows, inter)),
                           ("r2", r2, (rows, h))):
        _check_like(name, what, a, (n,) + shape, dz)

    def buf(*shape, dtype=dz.dtype):
        return torch.empty(shape, dtype=dtype, device=dz.device)

    dx = torch.empty_like(dz)
    # gradients in nn.Linear's (L, out, in) layout, biases (L, 1, n)
    dwqkv, dwo = buf(n, 3 * h, h), buf(n, h, h)
    dw1, dw2 = buf(n, inter, h), buf(n, h, inter)
    dbqkv, dc1 = buf(n, 1, 3 * h), buf(n, 1, inter)
    dbo, dg1, db1, dc2, dg2, db2 = (buf(n, 1, h) for _ in range(6))
    dd = buf(rows, h) if rate > 0.0 else None
    scratch = (buf(rows, h), dd, buf(rows, inter), buf(rows, h),
               buf(rows, inter), buf(rows, h), buf(rows, h),
               buf(rows, 3 * h),
               buf(-(-rows // 4), 3 * h, dtype=torch.float32))
    tower_block_bwd.info = _tower_launch(
        "tgfr_tower_bwd",
        (dz, mask, xin, qkv, p, o, r1, f, r2, wqkv, wo, g1, b1, w1, w2, g2,
         *bits, seed, dx, dwqkv, dbqkv, dwo, dbo, dg1, db1, dw1, dc1, dw2,
         dc2, dg2, db2, *scratch), bits, (n, b, t, h, heads, inter, 1), rate,
        eps, dz.dtype)
    tower_block_bwd.launches += 1
    return (dx, dwqkv.transpose(1, 2), dbqkv, dwo.transpose(1, 2), dbo, dg1,
            db1, dw1.transpose(1, 2), dc1, dw2.transpose(1, 2), dc2, dg2, db2)


class _TowerBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2,
                b2, bits_p, bits_h, bits_f, seed, b, t, heads, rate, eps,
                grad):
        needs = ctx.needs_input_grad
        save = grad and (needs[0] or any(needs[2:14]))
        z, *res = tower_block_fwd(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1,
                                  w2, c2, g2, b2, b, t, heads, bits_p, bits_h,
                                  bits_f, rate, eps, save, seed=seed)
        ctx.shape, ctx.rate, ctx.eps = (b, t, heads), rate, eps
        if save:
            ctx.save_for_backward(mask, *res, wqkv, wo, g1, b1, w1, w2, g2,
                                  bits_p, bits_h, bits_f, seed)
        return z

    @staticmethod
    def backward(ctx, dz):
        *saved, bits_p, bits_h, bits_f, seed = ctx.saved_tensors
        grads = tower_block_bwd(dz.contiguous(), *saved, *ctx.shape, bits_p,
                                bits_h, bits_f, ctx.rate, ctx.eps, seed=seed)
        return (grads[0], None, *grads[1:]) + (None,) * 10


def tower_block(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2, b2,
                b: int, t: int, heads: int = 12, rate: float = 0.0,
                eps: float = 1e-12, bits_p=None, bits_h=None, bits_f=None,
                seed=None) -> torch.Tensor:
    """The whole post-LN tower with its gradient, one kernel launch each
    way: K7 forward, K8 backward.

    x: (R, H) = (b*t, H) float32 or bfloat16; mask: (b, t) int32. The 12
    leaves stacked over L layers and already in x's dtype: wqkv (L, H, 3H),
    wo (L, H, H), w1 (L, H, I), w2 (L, I, H), each the .transpose(1, 2)
    view of a contiguous (L, out, in) stack; bqkv (L, 1, 3H), c1 (L, 1, I),
    bo, c2, g1, b1, g2, b2 (L, 1, H). When rate > 0, one dropout source:
    bits_p (L, heads*b, t, t), bits_h and bits_f (L, R, H) int32, or seed
    (1,) int32, the tower's seed (ops/philox.py). The kernels take heads of
    width 64, H <= 1024, H and I multiples of 64, t <= MAX_T (512). Returns
    z: (R, H); gradients arrive in the leaves' dtype.
    """
    _check_rate("tower_block", rate, (bits_p, bits_h, bits_f), seed)
    if rate <= 0.0:
        bits_p = bits_h = bits_f = seed = None
    return _TowerBlockFn.apply(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1,
                               w2, c2, g2, b2, bits_p, bits_h, bits_f, seed, b,
                               t, heads, rate, eps, torch.is_grad_enabled())


ffn_block.launches = 0
ffn_block_bwd.launches = 0
attn_block.launches = 0
attn_block_bwd.launches = 0
tower_block.launches = 0
tower_block_bwd.launches = 0
tower_block_fwd.info = tower_block_bwd.info = None
