"""Differentiable collectives of the data-parallel step.

Counterpart of text_guided_face_recognition_tpu/parallel/contrastive.py
(`gather_global_negatives`, `local_diag_labels`, `psum_mean`) over
`torch.distributed`. Each rank runs the towers on its own rows, gathers the
embeddings, and evaluates the whole global loss, identically on every rank,
as the JAX package's jit over a data mesh evaluates it once on the global
batch (and as the reference's nn.DataParallel does on its first GPU).

A collective's backward depends on who consumes its output, and getting it
wrong scales gradients silently:

  * `gather_global_negatives`: every rank evaluates the same loss on all
    the gathered rows, so every rank's cotangent of the gathered tensor is
    already the full one. Its backward takes this rank's rows of it, with
    no communication. (torch.distributed.nn's all_gather sums the
    cotangents over the ranks instead, which here gives N times the
    gradient; Adam's near scale-invariance would hide that after an
    update.) The towers below the gather then hold the gradient of their
    own rows only, and the trainer sums them over the ranks once
    (engine/trainer.py); the parameters applied after the gather hold the
    full gradient on every rank already.
  * `gather_rows_summed`: the gathered rows feed blocks that differ per
    rank (the class-sharded classifier's logit blocks, parallel/
    partial_fc.py), so each rank's cotangent is a part: the backward sums
    them over the ranks, then takes this rank's rows (JAX's all_gather
    transpose, a reduce-scatter).
  * `psum`: a sum over ranks that feeds the loss every rank evaluates:
    the backward hands the cotangent through unchanged. `psum_mean` is
    its mean (backward: 1/N of the cotangent).
  * `sync_sum`: a sum over ranks whose result feeds each rank's own rows
    (the global-batch BatchNorm statistics, models/layers.py): each rank's
    cotangent is a part, and the backward sums them over the ranks.

Without a process group each is the identity (`local_diag_labels`: the
local labels). Integer and bool tensors gather without a gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from text_guided_face_recognition_tpu_torch.parallel import mesh

__all__ = ["gather_global_negatives", "gather_rows_summed",
           "local_diag_labels", "psum", "psum_mean", "sync_sum"]


def _gather(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, summed: bool) -> torch.Tensor:
        ctx.lo = dist.get_rank() * x.shape[0]
        ctx.rows = x.shape[0]
        ctx.summed = summed
        return _gather(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.summed:
            g = _all_reduce(g)
        return g[ctx.lo:ctx.lo + ctx.rows], None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: float,
                grad_summed: bool) -> torch.Tensor:
        ctx.scale, ctx.grad_summed = scale, grad_summed
        out = _all_reduce(x)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.grad_summed:
            g = _all_reduce(g)
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


def _gather_rows(x: torch.Tensor, summed: bool) -> torch.Tensor:
    if not mesh.active():
        return x
    if not (x.is_floating_point() and torch.is_grad_enabled()
            and x.requires_grad):
        return mesh.all_gather_rows(x)
    return _GatherRows.apply(x, summed)


def gather_global_negatives(x: torch.Tensor) -> torch.Tensor:
    """All ranks' rows of x, (b_local, ...) -> (b_local * N, ...) in rank
    order, for a loss every rank evaluates whole; backward: this rank's
    rows of the cotangent (module docstring)."""
    return _gather_rows(x, summed=False)


def gather_rows_summed(x: torch.Tensor) -> torch.Tensor:
    """All ranks' rows of x in rank order, for consumers split across the
    ranks; backward: the cotangents summed over the ranks, this rank's
    rows of the sum (module docstring)."""
    return _gather_rows(x, summed=True)


def local_diag_labels(local_batch: int, device=None) -> torch.Tensor:
    """The matching-pair labels of this rank's rows against the gathered
    global columns: rank * local_batch + arange(local_batch)."""
    return mesh.rank() * local_batch + torch.arange(local_batch,
                                                    device=device)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, for the loss every rank evaluates:
    backward hands the cotangent through."""
    return _Psum.apply(x, 1.0, False) if mesh.active() else x


def psum_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the ranks (per-rank means -> the global mean),
    for the loss every rank evaluates: backward 1/N of the cotangent."""
    if not mesh.active():
        return x
    return _Psum.apply(x, 1.0 / dist.get_world_size(), False)


def sync_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, for consumers of each rank's own rows
    (sync BatchNorm): backward sums the cotangents over the ranks."""
    return _Psum.apply(x, 1.0, True) if mesh.active() else x
