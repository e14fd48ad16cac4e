"""Face-caption fusion networks, NCHW.

Counterpart of text_guided_face_recognition_tpu/models/fusion.py: `FCFM`
(the BERT-path fusion net), `WordLevelCFA_LSTM` (the LSTM path's) and
`LinearFusion`, and two modules no entry point uses, `ParagraphLevelCFA`
and `ConcatAttention`. Word features arrive as (B, F, T), the text head's
and the RNN encoder's layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from text_guided_face_recognition_tpu_torch.models.iresnet import Conv2d
from text_guided_face_recognition_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    LayerNormCHW,
    SelfAttention2D,
    TorchMultiheadAttention,
)

__all__ = ["LinearFusion", "FCFM", "WordLevelCFA_LSTM", "ParagraphLevelCFA",
           "ConcatAttention"]


class LinearFusion(nn.Module):
    """concat(img, sent) -> Dense(fusion_final_dim)."""

    def __init__(self, in_features: int = 512, fusion_final_dim: int = 640,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, fusion_final_dim, dtype)

    def forward(self, img_features: torch.Tensor,
                sent_emb: torch.Tensor) -> torch.Tensor:
        return self.fc1(torch.cat([img_features, sent_emb], dim=1))


class FCFM(nn.Module):
    """BERT-path fusion net.

    local: img (B, 256, 14, 14) -> conv3x3 valid -> 36 x 12 x 12 -> ReLU ->
    maxpool 2 -> BN; words (B, 256, T) -> Dense 256 -> 36 -> Gram (36 x 36)
    / sqrt(36) -> 36 channels of 6 x 6 -> BN; SelfAttention2D(img, words) ->
    LayerNorm -> maxpool 2 -> flatten (C, H, W) 324 -> Dense 128.
    Output: concat[128, LN(global img), LN(sent)] = 640.
    """

    def __init__(self, channel_dim: int = 36, local_channels: int = 256,
                 feat_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channel_dim
        s = math.isqrt(c)
        if s * s != c:
            raise ValueError("channel_dim must be a perfect square (36)")
        self.c, self.s, self.dtype = c, s, dtype
        self.conv = Conv2d(local_channels, c, 3, bias=True, dtype=dtype)
        self.bn_img = BatchNorm(c, dtype=dtype)
        self.projection = Dense(feat_dim, c, dtype)
        self.bn_word = BatchNorm(c, dtype=dtype)
        self.sa = SelfAttention2D(c, scale=1, dtype=dtype)
        self.ln = LayerNormCHW(c, s, s)
        self.linear = Dense(c * (s // 2) ** 2, 128, dtype)
        self.ln_gl_image = nn.LayerNorm(feat_dim, eps=1e-5)
        self.ln_sent = nn.LayerNorm(feat_dim, eps=1e-5)

    def _ln(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.dtype).float(), ln.normalized_shape,
                            ln.weight, ln.bias, ln.eps).to(self.dtype)

    def forward(self, img: torch.Tensor, word: torch.Tensor,
                gl_img: torch.Tensor, sent: torch.Tensor) -> torch.Tensor:
        c, s, dt = self.c, self.s, self.dtype
        img = self.conv(img.to(dt))                               # (B,36,12,12)
        img = self.bn_img(F.max_pool2d(torch.relu(img), 2))       # (B,36,6,6)

        w = self.projection(word.transpose(1, 2).to(dt))          # (B, T, 36)
        wf = w.float()
        gram = torch.matmul(wf.transpose(1, 2), wf)               # (B, 36, 36)
        gram = (gram / math.sqrt(c)).to(dt)
        # channels = the first Gram axis, the second folded into s x s
        wmap = self.bn_word(gram.reshape(gram.shape[0], c, s, s))

        iw = self.ln(self.sa(img, wmap))
        iw = F.max_pool2d(iw, 2).flatten(1)                       # (B, 324)
        iw = self.linear(iw)
        return torch.cat([iw, self._ln(self.ln_gl_image, gl_img),
                          self._ln(self.ln_sent, sent)], dim=1)   # (B, 640)


class WordLevelCFA_LSTM(nn.Module):
    """LSTM-path fusion net (the reference's models/fusion_nets.py:260-291).

    The local map (B, C, 14, 14) sits in a zero 16 x 16 canvas; the words
    (B, C, T) give a C x C Gram / sqrt(C), computed in f32 and rounded, its
    second axis folded into 16 x 16 (C = 256); one SelfAttention2D (shared
    weights) runs twice: canvas on canvas, then that on the word map. `ln1`
    holds weights only: the reference normalises the first pass with it and
    drops the result (:283), so it is not called; `ln2` normalises the
    second; avg-pool 8 -> flatten (C, 2, 2) -> Dense 1024 -> 768."""

    def __init__(self, channel_dim: int = 256, scale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channel_dim
        if c != 256:
            raise ValueError("WordLevelCFA_LSTM folds its C x C word Gram "
                             "into a 16 x 16 map: channel_dim must be 256")
        self.c, self.dtype = c, dtype
        self.sa = SelfAttention2D(c, scale=scale, dtype=dtype)
        self.ln1 = LayerNormCHW(c, 16, 16)
        self.ln2 = LayerNormCHW(c, 16, 16)
        self.linear = Dense(4 * c, 768, dtype)

    def forward(self, local_img: torch.Tensor, word: torch.Tensor
                ) -> torch.Tensor:
        b, c, dt = local_img.shape[0], self.c, self.dtype
        img = F.pad(local_img.to(dt), (1, 1, 1, 1))             # (B,C,16,16)
        wf = word.float()
        gram = torch.matmul(wf, wf.transpose(1, 2))              # (B, C, C)
        wmap = (gram / math.sqrt(c)).to(dt).reshape(b, c, 16, 16)
        img2 = self.sa(img, img)
        iw = self.ln2(self.sa(img2, wmap))
        iw = F.avg_pool2d(iw, 8).flatten(1)                      # (B, 1024)
        return self.linear(iw)


class ParagraphLevelCFA(nn.Module):
    """Sentence-to-patch attention pooling: the (B, 512) image feature as
    eight 64-d patches, the sentence's first 64-d slice as the query of a
    one-head TorchMultiheadAttention (`mha`, embed_dim 64, the width of its
    inputs, as in the JAX package; the reference declares 128 and could not
    run). (img (B, 512), sent (B, 256)) -> (B, 64)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mha = TorchMultiheadAttention(64, 1, dtype)

    def forward(self, img: torch.Tensor, sent_emb: torch.Tensor
                ) -> torch.Tensor:
        b = img.shape[0]
        img_p = img.reshape(b, 8, 64)
        sent_p = sent_emb.reshape(b, -1, 64)[:, :1]
        return self.mha(sent_p, img_p, img_p).reshape(b, -1)


class ConcatAttention(nn.Module):
    """One-head TorchMultiheadAttention (`mha`, 256) over [img (512), sent
    (256)] as three 256-d patches, then Dense 768 -> 512 (`linear`)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mha = TorchMultiheadAttention(256, 1, dtype)
        self.linear = Dense(768, 512, dtype)

    def forward(self, img: torch.Tensor, sent_emb: torch.Tensor
                ) -> torch.Tensor:
        b = img.shape[0]
        patch = torch.cat([img, sent_emb], dim=1).reshape(b, 3, 256)
        return self.linear(self.mha(patch, patch, patch).reshape(b, -1))
