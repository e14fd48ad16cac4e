"""Class-sharded margin classifier over the ranks (partial FC without
sampling).

Counterpart of `sharded_margin_ce` in
text_guided_face_recognition_tpu/parallel/partial_fc.py. The stage-2 margin
head's weight W (num_classes, feat) is split by classes over the ranks:
each rank holds C/N rows and their optimizer state. The fused embeddings
and labels are gathered (B x feat floats a step), each rank forms its
(B, C/N) block of cosine / margin logits, and the softmax statistics (the
row maximum, the sum of exponentials and the target logit) are combined
over the ranks, so every rank evaluates the same full-class cross-entropy,
exact in value and gradient against the dense head:

  * the row maximum shifts the log-sum-exp and takes no gradient (the
    log-sum-exp is shift-invariant), gathered from every rank's stopped
    block maximum;
  * the sums of exponentials and the target logit are `psum`s: every
    rank's loss consumes them whole, so their backward hands the cotangent
    through;
  * the gathered embeddings feed a different block on each rank, so their
    gather sums the cotangents over the ranks (`gather_rows_summed`), and
    the towers below then need one sum over the ranks, as in the
    data-parallel step; the W shard's gradient is local and complete.

Classes past `num_classes` (padding to a multiple of N) are masked out of
the softmax; their rows take a zero gradient. A library function, as in
the JAX package: no entry point calls it; the class-sharded stage-2 step
around it is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from text_guided_face_recognition_tpu_torch.parallel import mesh
from text_guided_face_recognition_tpu_torch.parallel.contrastive import (
    gather_rows_summed, psum)

__all__ = ["sharded_margin_ce"]

_NEG_INF = -1.0e30   # exp(x - row max) underflows to exactly 0.0 in f32


def sharded_margin_ce(emb_local: torch.Tensor, w_local: torch.Tensor,
                      label_local: torch.Tensor, *, head: str = "arcface",
                      s: float = 30.0, m: float = 0.5,
                      easy_margin: bool = False, loss_kind: str = "ce",
                      gamma: float = 2.0,
                      num_classes: Optional[int] = None) -> torch.Tensor:
    """The margin-softmax cross-entropy of the global batch with W
    class-sharded over the ranks, the same scalar on every rank.

      emb_local   (B/N, D)  this rank's batch rows
      w_local     (C/N, D)  this rank's class rows (F.linear layout)
      label_local (B/N,)    global class ids of the local rows
      num_classes           the true class count; columns at or past it
                            are masked out of the softmax

    head "arcface" (cos(theta + m)) or "cosface" (cos(theta) - m), scaled
    by s; loss_kind "ce" (nn.CrossEntropyLoss) or "focal" (the reference's
    (1 - p)^gamma on the batch-mean cross-entropy, ops/losses.py
    focal_loss). Without a process group: the dense head over w_local."""
    if head not in ("arcface", "cosface"):
        raise ValueError(f"unsupported sharded margin head {head!r}")
    if loss_kind not in ("ce", "focal"):
        raise ValueError(f"unsupported loss_kind {loss_kind!r}")
    if num_classes is not None and num_classes < 0:
        raise ValueError("num_classes must be >= 0")
    emb = gather_rows_summed(emb_local)
    label = mesh.all_gather_rows(label_local).long()

    e = emb.float()
    w = w_local.float()
    e = e / torch.clamp_min(torch.linalg.vector_norm(e, dim=1, keepdim=True),
                            1e-12)
    w = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                            1e-12)
    cosine = e @ w.t()                                   # (B, C/N)

    c_loc = w_local.shape[0]
    offset = mesh.rank() * c_loc
    loc = label - offset
    in_range = (loc >= 0) & (loc < c_loc)
    # a row whose class another rank holds gets the all-zero one-hot: no
    # margin here and no target logit from this block
    one_hot = F.one_hot(torch.where(in_range, loc, 0), c_loc).to(
        cosine.dtype) * in_range[:, None].to(cosine.dtype)

    if head == "arcface":
        # 1e-12 floor, not 0: sqrt'(0) = inf (ops/margins.py)
        sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 1e-12, 1.0))
        phi = cosine * math.cos(m) - sine * math.sin(m)
        if easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            th = math.cos(math.pi - m)
            mm = math.sin(math.pi - m) * m
            phi = torch.where(cosine > th, phi, cosine - mm)
    else:
        phi = cosine - m
    logits = (one_hot * phi + (1.0 - one_hot) * cosine) * s
    if num_classes is not None:
        col = offset + torch.arange(c_loc, device=logits.device)
        logits = torch.where(col[None, :] < num_classes, logits,
                             torch.full_like(logits, _NEG_INF))

    with torch.no_grad():
        row_max = mesh.all_gather_rows(
            logits.amax(dim=1)[None]).amax(dim=0)          # (B,)
    z = torch.exp(logits - row_max[:, None])
    denom = psum(z.sum(dim=1))
    target = psum((one_hot * logits).sum(dim=1))
    nll = torch.log(denom) + row_max - target             # (B,)
    ce = nll.mean()
    if loss_kind == "focal":
        p = torch.exp(-ce)
        return (1.0 - p) ** gamma * ce
    return ce
