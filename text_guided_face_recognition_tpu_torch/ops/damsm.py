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

The kernel takes any B, D, T, R and gamma1. Its launch plan is
`damsm_plan`, computed here so that the CPU tests can check every plan: a
block takes one image and a group of captions whose words fit in its N
word columns (the short path), or one caption in chunks of N words (the
long path: a first pass for each region's softmax statistics over words
and the logits, kept in (B, B, R, 2) and (B, B, R, T rounded up to 8) f32
scratch, 410 MB at B 32, R 196, T 510, which the second pass reads back).
Past D = 512 (the wide path) D is split into slices of at most 512 rows:
a first kernel writes the long path's scratch over the whole of D, the
long path's second pass runs on each slice (a launch a slice) and writes
its three cosine sums per word to (slices, B, B, T rounded up to 8, 3)
f32 scratch, and a last kernel adds them (csrc/damsm.cu). The gamma1 softmax
over regions subtracts the fixed bound max(gamma1, 0) while
|gamma1| <= 60, and each word's running maximum past it, so no term
underflows at any gamma1.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda
from text_guided_face_recognition_tpu_torch.ops.attention import (
    damsm_similarity)

__all__ = ["damsm_similarity_cuda", "damsm_similarity_fused", "damsm_plan",
           "damsm_smem", "SLICE_D", "SMEM_LIMIT"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 7 + (_I,) * 8 + (ctypes.c_longlong, _F, _F, _F, _P)
SLICE_D = 512        # csrc/damsm.cu kMaxSliceD: the features a block holds
SMEM_LIMIT = 232448  # shared memory a block can have on the H100
_WARPS = 16          # csrc/damsm.cu kThreads / 32
_RC = 32             # csrc/damsm.cu kRC: regions a block of the ring


def damsm_smem(dp: int, n: int) -> int:
    """Shared memory of a block, in bytes, as the kernel lays it out: 1024
    to align the gamma1 weights for wgmma, which take two (n, 32) tiles (hi
    and lo); the (dp, n) word tile; two (dp, 32) region slots, which the
    warps' three cosine partials per word column reuse at the end; two
    (32, n + 4) logit tiles (the feature sum's two halves); and per word
    column its sum, mask, cosine, running gamma1 maximum and rescale
    factor. A copy, for the CPU tests, of csrc/damsm.cu `tgfr_damsm_smem`;
    a card test holds the two equal."""
    ring = max(2 * dp * _RC, 3 * _WARPS * n)
    return 1024 + 4 * (2 * n * _RC + dp * n + ring + 2 * _RC * (n + 4)
                       + 5 * n)


def damsm_plan(b: int, d: int, t: int, r: int) -> dict:
    """K9's launch plan for words (b, d, t) and regions (b, d, r).

    slices: the slices of D a block takes one of (1 up to SLICE_D
    features, else ceil(d / SLICE_D): the wide path); dp: the rows of a
    slice (all of d where slices is 1) rounded up to 16; n: the word
    columns of a block, 96 for dp up to 256 and 32 past it (a thread holds
    48, or 32, context sums); long: a caption's t words do not fit in n
    columns, or the wide path; g: captions a block (1 on the long path);
    word_chunks: n-word chunks a caption takes; grid: (caption groups,
    images) a launch, and the slices' launches."""
    if min(b, d, t, r) < 1:
        raise ValueError(f"damsm_plan: empty shape b {b}, d {d}, t {t}, "
                         f"r {r}")
    slices = -(-d // SLICE_D)
    dp = -(-(-(-d // slices)) // 16) * 16
    n = 96 if dp <= 256 else 32
    long = t > n or slices > 1
    g = 1 if long else min(b, n // t)
    return {"dp": dp, "n": n, "long": long, "g": g, "slices": slices,
            "smem": damsm_smem(dp, n),
            "word_chunks": -(-t // n) if long else 1,
            "grid": (b if long else -(-b // g), b, slices)}


def damsm_similarity_cuda(words: torch.Tensor, regions: torch.Tensor,
                          gamma1: float, gamma2: float,
                          word_mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-8) -> torch.Tensor:
    """K9: sim (B, B), sim[j, i] for image j and caption i.

    words (B, D, T), regions (B, D, R), f32 and contiguous; word_mask
    optional (B, T) bool. Any B, D, T, R and gamma1.
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
    plan = damsm_plan(b, d, t, r)
    mask = None
    if word_mask is not None:
        if tuple(word_mask.shape) != (b, t) or \
                word_mask.device != words.device:
            raise ValueError(f"{name}: word_mask must be ({b}, {t}) on "
                             f"{words.device}")
        mask = word_mask.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=words.device)
    sim = torch.empty((b, b), **f32)
    stats = kept = wpart = None
    tp = -(-t // 8) * 8
    if plan["long"]:
        stats = torch.empty((b, b, r, 2), **f32)
        kept = torch.empty((b, b, r, tp), **f32)
    if plan["slices"] > 1:
        wpart = torch.empty((plan["slices"], b, b, tp, 3), **f32)
    fn = _cuda.function("damsm", "tgfr_damsm_similarity", _ARGTYPES)
    _cuda.launch(fn, words.data_ptr(), regions.data_ptr(),
                 None if mask is None else mask.data_ptr(), sim.data_ptr(),
                 *(None if a is None else a.data_ptr()
                   for a in (stats, kept, wpart)), b, d, t, r,
                 plan["n"], plan["g"], int(plan["long"]), plan["slices"],
                 plan["smem"], float(gamma1), float(gamma2), float(eps))
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
