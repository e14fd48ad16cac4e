"""Word <-> region attention (DAMSM / AttnGAN style), plain PyTorch.

Counterpart of text_guided_face_recognition_tpu/ops/attention.py: the whole
B_caption x B_image similarity tensor from two batched contractions, with
the double softmax (over words, then gamma1-scaled over regions) and the
gamma2-smoothed log-sum-exp in between. Masked words get -inf logits and
leave the final log-sum-exp. `damsm_similarity` is also the plain version
of the K9 kernel (ops/damsm.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["func_attention", "damsm_similarity"]


def func_attention(query: torch.Tensor, context: torch.Tensor, gamma1: float,
                   query_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched AttnGAN attention.

    query (B, D, T) word features; context (B, D, H, W) region features;
    query_mask optional (B, T) bool, True for valid words. Returns
    (weighted context (B, D, T), attention (B, T, H, W)).
    """
    b, d, t = query.shape
    h, w = context.shape[2], context.shape[3]
    ctx = context.reshape(b, d, h * w)                       # (B, D, R)
    attn = torch.einsum("bdr,bdt->brt", ctx, query)
    if query_mask is not None:
        attn = attn.masked_fill(~query_mask[:, None, :], float("-inf"))
    attn = torch.softmax(attn, dim=-1).transpose(1, 2)       # (B, T, R)
    attn = torch.softmax(attn * gamma1, dim=-1)
    weighted = torch.einsum("bdr,btr->bdt", ctx, attn)
    return weighted, attn.reshape(b, t, h, w)


def damsm_similarity(words: torch.Tensor, regions: torch.Tensor,
                     gamma1: float, gamma2: float,
                     word_mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-8) -> torch.Tensor:
    """Caption-image DAMSM similarity, sim[j, i] for image j, caption i.

    words (B, D, T) f32, regions (B, D, R) f32, word_mask optional (B, T)
    bool (True = valid). For every (caption, image) pair: attend the
    caption's words over the image's regions, take each word's cosine with
    its attended region summary, gamma2-smooth-LSE over valid words.
    """
    b, d, t = words.shape
    r = regions.shape[2]
    wq = words.transpose(1, 2).reshape(b * t, d)              # (i*t, d)
    logits = torch.einsum("qd,jdr->qjr", wq, regions).reshape(b, t, b, r)
    lw = logits.transpose(1, 3)                               # [i, r, j, t]
    if word_mask is not None:
        lw = lw.masked_fill(~word_mask[:, None, None, :], float("-inf"))
    aw = torch.softmax(lw, dim=-1)
    ar = torch.softmax(aw.transpose(1, 3) * gamma1, dim=-1)   # [i, t, j, r]
    arj = ar.permute(2, 0, 1, 3).reshape(b, b * t, r)         # (j, i*t, r)
    wctx = torch.matmul(arj, regions.transpose(1, 2)).reshape(b, b, t, d)
    wv = words.transpose(1, 2)                                # [i, t, d]
    dots = torch.einsum("itd,jitd->jit", wv, wctx)
    wn = torch.linalg.vector_norm(wv, dim=-1)                 # [i, t]
    cn = torch.linalg.vector_norm(wctx, dim=-1)               # [j, i, t]
    cos = dots / torch.clamp_min(wn[None] * cn, eps)
    z = cos * gamma2
    if word_mask is not None:
        z = z.masked_fill(~word_mask[None, :, :], float("-inf"))
    return torch.logsumexp(z, dim=-1)                         # [j, i]
