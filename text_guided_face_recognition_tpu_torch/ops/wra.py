"""Word-region alignment (WRA) loss: an attention-weighted word InfoNCE.

Counterpart of text_guided_face_recognition_tpu/ops/wra.py (the stage-1
`is_WRA` term). Each word attends over its own image's regions; the word
and its attended region summary form an InfoNCE pair against the other
words of the caption, both ways, each word weighted by an external
saliency clipped to its row's 10th and 90th percentiles over the valid
words and normalised. The saliency takes no gradient.

The percentile is the JAX package's formula, not `torch.quantile`: sort
with the dtype's largest value in the masked entries (the valid ones come
first), interpolate linearly at q (n_valid - 1), and take the lower value
where the upper index passes the last valid entry. It reads nothing on
the host, so the loss captures in a CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["word_region_alignment_loss"]


def _masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float
                       ) -> torch.Tensor:
    """Each row's q-th percentile over its masked-in entries, linearly
    interpolated. x, mask (B, N); returns (B, 1)."""
    big = torch.finfo(x.dtype).max
    n = x.shape[-1]
    n_valid = mask.sum(-1)                                    # (B,)
    xs = torch.sort(torch.where(mask > 0, x, big), dim=-1).values
    pos = (q / 100.0) * (n_valid - 1.0)
    lo = torch.clamp(torch.floor(pos), 0, n - 1).long()
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = (pos - lo.to(pos.dtype))[:, None]
    vlo = xs.gather(-1, lo[:, None])
    vhi = xs.gather(-1, hi[:, None])
    vhi = torch.where(hi[:, None] > (n_valid[:, None] - 1).long(), vlo, vhi)
    return vlo + frac * (vhi - vlo)


def word_region_alignment_loss(word_emb: torch.Tensor,
                               region_emb: torch.Tensor,
                               word_attn: torch.Tensor,
                               word_mask: Optional[torch.Tensor] = None,
                               local_temperature: float = 0.1
                               ) -> torch.Tensor:
    """word_emb (B, N_w, D), region_emb (B, N_r, D), word_attn (B, N_w)
    the words' saliency, word_mask (B, N_w) optional, True for valid
    words. Returns the mean of the two directions' weighted
    cross-entropies, an f32 scalar."""
    b, n_w, _ = word_emb.shape
    we, re = word_emb.float(), region_emb.float()
    scores = torch.softmax(torch.einsum("bwd,brd->bwr", we, re)
                           / local_temperature, dim=-1)
    attended = torch.einsum("bwr,brd->bwd", scores, re)
    attended = attended / torch.clamp_min(
        torch.linalg.vector_norm(attended, dim=-1, keepdim=True), 1e-12)

    aw = word_attn.detach().float()
    mask = (torch.ones_like(aw) if word_mask is None
            else word_mask.to(torch.float32))
    lo = _masked_percentile(aw, mask, 10.0)
    hi = _masked_percentile(aw, mask, 90.0)
    aw = torch.where(mask > 0, torch.minimum(torch.maximum(aw, lo), hi),
                     torch.zeros_like(aw))
    aw = aw / torch.clamp_min(aw.sum(1, keepdim=True), 1e-12)

    sim = torch.einsum("bwd,bvd->bwv", we, attended) / local_temperature
    targets = torch.arange(n_w, device=we.device).repeat(b)
    w_flat = aw.reshape(-1)

    def weighted_ce(sim2d):
        nll = -F.log_softmax(sim2d, dim=-1).gather(-1, targets[:, None])[:, 0]
        return (nll * w_flat).sum() / b

    return (weighted_ce(sim.reshape(b * n_w, n_w))
            + weighted_ce(sim.transpose(1, 2).reshape(b * n_w, n_w))) / 2.0
