"""FCAM multi-granularity contrastive losses and the identity loss of the
stage-1 recipe.

Counterpart of text_guided_face_recognition_tpu/ops/losses.py (the terms
the stage-1 trainers run: `global_loss` for BERT, `clip_loss` for LSTM and
GRU). Batch-global semantics: every B x B matrix
is over the whole batch. All losses return f32 scalars; upstream
activations may be bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from text_guided_face_recognition_tpu_torch.ops.attention import (
    damsm_similarity)
from text_guided_face_recognition_tpu_torch.ops.damsm import (
    damsm_similarity_fused)

__all__ = ["cosine_similarity", "cross_entropy_rows", "sent_loss",
           "words_loss", "global_loss", "clip_loss", "focal_loss"]


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, dim: int = 1,
                      eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine, the product of the norms clamped at eps."""
    w12 = (x1 * x2).sum(dim=dim)
    w1 = torch.linalg.vector_norm(x1, dim=dim)
    w2 = torch.linalg.vector_norm(x2, dim=dim)
    return w12 / torch.clamp_min(w1 * w2, eps)


def cross_entropy_rows(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean softmax cross-entropy over rows (nn.CrossEntropyLoss)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def _class_mask(class_ids: torch.Tensor) -> torch.Tensor:
    """mask[i, j] True where i and j share a class but i != j."""
    same = class_ids[:, None] == class_ids[None, :]
    return same & ~torch.eye(class_ids.shape[0], dtype=torch.bool,
                             device=class_ids.device)


def sent_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
              labels: torch.Tensor, class_ids: Optional[torch.Tensor],
              gamma3: float = 10.0, eps: float = 1e-8
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DAMSM sentence loss: the B x B cosine matrix scaled by gamma3,
    same-class off-diagonal pairs at -inf, symmetric cross-entropy against
    the diagonal."""
    cnn, rnn = cnn_code.float(), rnn_code.float()
    scores = cnn @ rnn.t()
    norms = torch.linalg.vector_norm(cnn, dim=1, keepdim=True) * \
        torch.linalg.vector_norm(rnn, dim=1, keepdim=True).t()
    scores = scores / torch.clamp_min(norms, eps) * gamma3
    if class_ids is not None:
        scores = scores.masked_fill(_class_mask(class_ids), float("-inf"))
    return (cross_entropy_rows(scores, labels),
            cross_entropy_rows(scores.t(), labels))


def words_loss(img_features: torch.Tensor, words_emb: torch.Tensor,
               labels: torch.Tensor, gamma1: float = 4.0,
               gamma2: float = 5.0, gamma3: float = 10.0,
               word_mask: Optional[torch.Tensor] = None,
               use_pallas: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DAMSM word loss: img_features (B, D, H, W) local region map,
    words_emb (B, D, T), labels (B,) diagonal. Cross-entropy over images
    per caption and captions per image on the gamma3-scaled similarity.
    `use_pallas` (the JAX package's name for its fused kernel) routes the
    similarity through the K9 kernel (ops/damsm.py)."""
    b, d, h, w = img_features.shape
    regions = img_features.reshape(b, d, h * w).float()
    words = words_emb.float()
    if use_pallas:
        sim = damsm_similarity_fused(words.contiguous(),
                                     regions.contiguous(), gamma1, gamma2,
                                     word_mask)
    else:
        sim = damsm_similarity(words, regions, gamma1, gamma2, word_mask)
    sim = sim * gamma3                                   # [img j, cap i]
    return cross_entropy_rows(sim, labels), cross_entropy_rows(sim.t(), labels)


def global_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
                eps: float = 1e-8, temp3: float = 10.0) -> torch.Tensor:
    """CLIP-style symmetric cross-entropy on the B x B cosine matrix."""
    labels = torch.arange(cnn_code.shape[0], device=cnn_code.device)
    loss0, loss1 = sent_loss(cnn_code, rnn_code, labels, None, gamma3=temp3,
                             eps=eps)
    return loss0 + loss1


def clip_loss(text_features: torch.Tensor, image_features: torch.Tensor,
              logit_scale: float = 1.0) -> torch.Tensor:
    """The InfoNCE CLIP loss of the LSTM trainer (the reference's
    `ClipLoss`): the mean of the cross-entropies over images and over
    texts of the logit_scale-scaled B x B product, in f32."""
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    logits = logit_scale * (image_features.float() @ text_features.float().t())
    return (cross_entropy_rows(logits, labels)
            + cross_entropy_rows(logits.t(), labels)) / 2.0


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal loss as the reference defines it: (1 - p)^gamma applied to the
    batch-mean cross-entropy, not per sample."""
    logp = cross_entropy_rows(logits, labels)
    p = torch.exp(-logp)
    return (1.0 - p) ** gamma * logp
