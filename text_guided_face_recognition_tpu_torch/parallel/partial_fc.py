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
the softmax; their rows take a zero gradient.

The class-sharded stage-2 step around it (`make_partial_fc_fusion_step`,
the JAX package's, whose entry point is a library call as there): each
rank holds its C/N rows of `metric_fc.weight` and of their SGD state, the
rows [rank C/N, (rank + 1) C/N) of the W that `manual_seed` initialises
whole (so the starting state is the replicated layout's); the W shard's
gradient stays local, every other gradient is summed over the ranks and
the BatchNorm statistics are averaged (engine/trainer.py, mode
partial_fc). A train state leaves and enters the trainer whole
(`gather_state_for_partial_fc`, `shard_state_for_partial_fc`), so its
checkpoint is the replicated layout's file, as the JAX package's global
arrays make its checkpoint the same tree; `classifier_specs_for_state`
names the leaves that are split.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from text_guided_face_recognition_tpu_torch.parallel import mesh
from text_guided_face_recognition_tpu_torch.parallel.contrastive import (
    gather_rows_summed, psum)

__all__ = ["sharded_margin_ce", "classifier_specs_for_state",
           "shard_state_for_partial_fc", "gather_state_for_partial_fc",
           "make_partial_fc_fusion_step"]

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


_CLS_PATH_KEYS = ("metric_fc", "cls")


def _map(tree: Any, fn: Callable, path: tuple = ()) -> Any:
    """fn(path, leaf) over a nested tree of mappings and lists; a mapping's
    key joins the path split at its dots (a state dict's "metric_fc.weight"
    is the path (metric_fc, weight), as a JAX tree's nested keys)."""
    if isinstance(tree, Mapping):
        return type(tree)((k, _map(v, fn, path + tuple(str(k).split("."))))
                          for k, v in tree.items())
    if isinstance(tree, list):
        return [_map(v, fn, path) for v in tree]
    return fn(path, tree)


def _on_classifier(path, leaf, shape: tuple) -> bool:
    """A 2-D tensor or array of `shape` under a `metric_fc` or `cls` key
    (the classifier's weight, or its optimizer group's state); shape alone
    could match another leaf."""
    return (isinstance(leaf, (torch.Tensor, np.ndarray)) and leaf.ndim == 2
            and tuple(leaf.shape) == shape
            and any(k in _CLS_PATH_KEYS for k in path))


def classifier_specs_for_state(state: Any,
                               classifier_shape: Sequence[int]) -> Any:
    """The tree of `state` with 0 (rows split over the ranks) at each leaf
    of the class-sharded layout (every 2-D leaf of `classifier_shape`,
    (num_classes, feat), under a `metric_fc` or `cls` key) and None
    (replicated) elsewhere; the JAX package's P(axis, None) and P()."""
    shape = tuple(classifier_shape)
    return _map(state, lambda path, leaf: 0 if _on_classifier(
        path, leaf, shape) else None)


def shard_state_for_partial_fc(state: Any, classifier_shape: Sequence[int],
                               rank: Optional[int] = None,
                               world: Optional[int] = None) -> Any:
    """A whole train state (torch tensors or numpy arrays: the port's
    checkpoint tree or an exported JAX one) with each classifier leaf cut
    to rank `rank`'s rows of `world` (this process's by default); the
    other leaves are the given objects."""
    shape = tuple(classifier_shape)
    rank = mesh.rank() if rank is None else rank
    world = mesh.world_size() if world is None else world
    rows = shape[0] // world

    def cut(path, leaf):
        if not _on_classifier(path, leaf, shape):
            return leaf
        part = leaf[rank * rows:(rank + 1) * rows]
        return part.clone() if torch.is_tensor(part) else part.copy()

    return _map(state, cut)


def gather_state_for_partial_fc(state: Any,
                                classifier_shape: Sequence[int]) -> Any:
    """The whole train state of a class-sharded rank: each classifier leaf
    (this rank's (C/N, feat) rows) gathered over the ranks in rank order.
    A collective: every rank calls it."""
    c, d = tuple(classifier_shape)
    local = (c // mesh.world_size(), d)
    return _map(state, lambda path, leaf: mesh.all_gather_rows(leaf)
                if _on_classifier(path, leaf, local) else leaf)


def make_partial_fc_fusion_step(trainer):
    """The stage-2 train step with metric_fc class-sharded over the
    ranks: puts `trainer` (an engine/stage2.FusionTrainer built under the
    process group, before its first step) into the partial_fc mode, cuts
    its classifier and the classifier's optimizer state to this rank's
    rows, and returns its train_step. The loss is `sharded_margin_ce`
    (ArcFace, s 30, m 0.5, the focal loss for model_type arcface with loss
    focal_loss, else cross-entropy); the W shard's gradient stays local,
    every other gradient is summed over the ranks and the BatchNorm
    statistics are averaged. num_classes must divide by the world size."""
    args = trainer.args
    n = mesh.world_size()
    c = int(args.num_classes)
    if c % n:
        raise ValueError(
            f"partial-FC requires num_classes ({c}) divisible by the mesh "
            f"axis size ({n}); pad num_classes in the config — "
            f"sharded_margin_ce(num_classes=...) masks the padded columns")
    trainer.classifier_shape = (c, int(args.fusion_final_dim))
    trainer.set_mode("partial_fc", post_gather=("metric_fc",))
    own = shard_state_for_partial_fc(
        {"model": trainer.model.state_dict(),
         "optimizer": trainer.opt.state_dict()}, trainer.classifier_shape)
    with torch.no_grad():
        w = trainer.model.metric_fc.weight
        w.data = own["model"]["metric_fc.weight"].to(w.device)
    trainer.opt.resize_state(own["optimizer"])
    return trainer.train_step
