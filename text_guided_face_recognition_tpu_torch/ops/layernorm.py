"""LayerNorm for the text tower: hand-written CUDA kernels for the forward
(K1) and the backward (K2), and their plain PyTorch versions.

Counterpart of text_guided_face_recognition_tpu/ops/layernorm_pallas.py
(`layernorm_fused`, a custom VJP). Semantics: y = (x - mean) /
sqrt(var + eps) * gamma + beta over the last axis, statistics in f32, y in
x's dtype; gamma/beta are f32 masters used as they are (not rounded to x's
dtype), as `FusedLayerNorm` passes them. The backward saves only x and
recomputes the row statistics: dx in x's dtype, dgamma and dbeta in f32.

`layernorm_fused` is a torch.autograd.Function: K1 forward, K2 backward.
Each wrapper runs the plain version for a CPU tensor and the kernel
(csrc/layernorm.cu) for a CUDA tensor; it never falls back from one to the
other. Each K1 launch adds one to `layernorm_fused.launches`, each K2
launch one to `layernorm_bwd.launches`. K2 (and the LN phase of the
half-layer backwards, ops/block.py) adds its column sums in the same
launch, through a `part` scratch of `ln_bwd_parts(rows)` rows of
`LN_MAX_WIDTH` floats a sum and the arrival counters of the stream it
launches on (`ln_bwd_counter`): LN backward calls on two streams of one
device may run at once, each counting its own tickets.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda

__all__ = ["layernorm_fused", "layernorm_bwd",
           "layernorm_ref", "layernorm_bwd_ref", "ln_f32", "ln_bwd_parts",
           "ln_bwd_counter", "LN_MAX_WIDTH"]

LN_MAX_WIDTH = 1024  # csrc/common.cuh kLnMaxWidth: a row held in registers

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGTYPES = (_P, _P, _P, _P, _I, _I, _F, _I, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P)
# (device index, stream handle) -> that stream's arrival counters
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def ln_bwd_parts(rows: int) -> int:
    """Rows of the LN backward's `part` scratch for `rows` token rows: one
    a block of 8 rows, then one a group of blocks (8 groups; csrc/common.cuh
    `ln_bwd_parts`)."""
    return -(-rows // 8) + 8


def ln_bwd_counter(device: torch.device) -> torch.Tensor:
    """The LN backward's arrival counters for the current stream of
    `device`: int32 words, 0 between launches (the blocks that take the
    last tickets reset them). Launches on one stream run in order, so they
    never meet in the counters; each stream has its own. Made with
    torch.zeros at the first LN backward on the stream, which therefore
    must not run inside a CUDA graph capture."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    stream = torch.cuda.current_stream(idx).cuda_stream
    counter = _COUNTERS.get((idx, stream))
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "LayerNorm backward: its arrival counters are made at the "
                "first call on a stream; run one LN backward on this stream "
                f"of cuda:{idx} before capturing a CUDA graph on it")
        counter = torch.zeros(16, dtype=torch.int32, device=f"cuda:{idx}")
        _COUNTERS[(idx, stream)] = counter
    return counter


def ln_f32(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float) -> torch.Tensor:
    """LayerNorm of f32 `r` over its last axis with f32 statistics (mean,
    then the centred variance), the order of the Pallas kernels."""
    mean = r.mean(dim=-1, keepdim=True)
    rc = r - mean
    var = (rc * rc).mean(dim=-1, keepdim=True)
    return (rc * torch.rsqrt(var + eps)) * gamma + beta


def ln_bwd_f32(dy: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor,
               eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dr, dgamma, dbeta) of `ln_f32` over 2-D f32 rows, statistics
    recomputed from r (block_pallas.py `_ln_bwd_f32`)."""
    h = r.shape[-1]
    mean = r.sum(dim=-1, keepdim=True) / h
    rc = r - mean
    var = (rc * rc).sum(dim=-1, keepdim=True) / h
    rs = torch.rsqrt(var + eps)
    xhat = rc * rs
    dxhat = dy * gamma
    m1 = dxhat.sum(dim=-1, keepdim=True) / h
    m2 = (dxhat * xhat).sum(dim=-1, keepdim=True) / h
    dr = rs * (dxhat - m1 - xhat * m2)
    return dr, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def layernorm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel."""
    return ln_f32(x.float(), gamma.float(), beta.float(), eps).to(x.dtype)


def layernorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                      eps: float = 1e-12
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dx in x's dtype,
    dgamma f32, dbeta f32)."""
    h = x.shape[-1]
    dr, dg, db = ln_bwd_f32(dy.reshape(-1, h).float(), x.reshape(-1, h).float(),
                            gamma.float(), eps)
    return dr.to(x.dtype).reshape(x.shape), dg, db


def _check(name: str, x: torch.Tensor, params) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    h = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if h > LN_MAX_WIDTH:
        raise ValueError(f"{name}: the kernel takes H <= {LN_MAX_WIDTH}, "
                         f"got {h}")
    for what, p in params:
        if p.shape != (h,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"({h},) tensor on {x.device}")


def _layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """K1, the forward of `layernorm_fused`."""
    if x.device.type == "cpu":
        return layernorm_ref(x, gamma, beta, eps)
    _check("layernorm_fused", x, (("gamma", gamma), ("beta", beta)))
    y = torch.empty_like(x)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows:
        fn = _cuda.function("layernorm", "tgfr_layernorm_fwd", _FWD_ARGTYPES)
        _cuda.launch(fn, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     y.data_ptr(), rows, h, float(eps),
                     _cuda.dtype_code(x.dtype))
        layernorm_fused.launches += 1
    return y


def layernorm_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-12
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (dx, dgamma, dbeta) of the LayerNorm at x for the cotangent
    dy (x's shape and dtype). dx in x's dtype; dgamma, dbeta (H,) f32."""
    if x.device.type == "cpu":
        return layernorm_bwd_ref(dy, x, gamma, eps)
    _check("layernorm_bwd", x, (("gamma", gamma),))
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            dy.device != x.device or not dy.is_contiguous():
        raise ValueError("layernorm_bwd: dy must be a contiguous tensor of "
                         "x's shape, dtype and device")
    h = x.shape[-1]
    rows = x.numel() // h
    dx = torch.empty_like(x)
    if not rows:
        dgb = torch.zeros(2 * h, dtype=torch.float32, device=x.device)
        return dx, dgb[:h], dgb[h:]
    dgb = torch.empty(2 * h, dtype=torch.float32, device=x.device)
    part = torch.empty((ln_bwd_parts(rows), 2 * LN_MAX_WIDTH),
                       dtype=torch.float32, device=x.device)
    fn = _cuda.function("layernorm", "tgfr_layernorm_bwd", _BWD_ARGTYPES)
    _cuda.launch(fn, dy.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                 dx.data_ptr(), dgb.data_ptr(), part.data_ptr(),
                 ln_bwd_counter(x.device).data_ptr(), rows, h, float(eps),
                 _cuda.dtype_code(x.dtype))
    layernorm_bwd.launches += 1
    return dx, dgb[:h], dgb[h:]


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        return _layernorm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg, db = layernorm_bwd(dy.contiguous(), x, gamma, ctx.eps)
        return dx, dg, db, None


def layernorm_fused(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis of `x` (any leading shape), with its
    gradient: K1 forward, K2 backward (x saved, statistics recomputed).

    x: float32 or bfloat16, contiguous, H <= 1024 on a card. gamma, beta:
    (H,) float32. Returns y with x's shape and dtype.
    """
    return _LayerNormFn.apply(x, gamma, beta, eps)


layernorm_fused.launches = 0
layernorm_bwd.launches = 0
