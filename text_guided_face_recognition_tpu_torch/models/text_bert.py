"""Text encoders of every bert_type and the FCAM text head.

Counterpart of text_guided_face_recognition_tpu/models/text_bert.py: the
whole `TextArch` table. bert and align are BERT-base; blip is the BERT
layout with 8 heads of 96 and no token-type embeddings; falva (sic, the
reference's key) puts BERT's embeddings under pre-LN blocks with a trailing
LayerNorm; clip and groupvit are pre-LN, causal, quick-GELU towers with no
embedding LayerNorm and a trailing one (eps 1e-5). Submodule and parameter
names follow the JAX package's flax tree (engine/from_jax.py maps one onto
the other); q|k|v are packed on the output axis of one `qkv` projection,
head-major within each. Token-type ids are all zero. The sentence feature
is hidden[:, 0] under the causal mask too, where token 0 sees only itself:
the JAX package's contract, kept.

`fused_block` routes the tower's half-layers through the hand-written CUDA
kernels of ops/block.py ("attn", "ffn" or "both"), or all of its layers
through the whole-tower kernels, one launch each way ("tower"); `fused_ln`
routes every LayerNorm the kernels do not hold through ops/layernorm.py.
With both off the tower runs ordinary PyTorch modules, as the JAX package
runs flax modules. The module tree and the state_dict keys are the same
under every `fused_block`. The block kernels, as the JAX package's, take
post-LN erf-GELU layers with heads 64 wide: for any other arch (blip's
96-wide heads, the pre-LN archs) a `fused_block` other than none runs the
unfused tower with the JAX package's UserWarning, a choice made from the
arch before any module is built (`fused_block_in_effect`), never a fallback
on a failed kernel. `fused_block_effective` holds the mode in effect, which
every count of dropout bits and seeds reads.

Dropout in train mode follows the JAX package's two modes. With
`fused_dropout` (host mode) every site takes bits from the step's one flat
host draw, in the plan's site order. Without it (prng mode, the JAX
package's default and its `use_prng` on the chip) the fused half-layers'
kernels draw their bits in-kernel from int32 seeds, one per layer for
attn / ffn / both and one for tower (ops/philox.py), and the host draw holds
only the other sites: the embeddings and the unfused halves.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from text_guided_face_recognition_tpu_torch.models.layers import (
    Dense, l2_normalize)
from text_guided_face_recognition_tpu_torch.ops.block import (
    D_HEAD, attn_block, ffn_block, gelu, tower_block)
from text_guided_face_recognition_tpu_torch.ops.dropout import (
    DropBits, dropout, layer_sites, prng_sites, total_elems)
from text_guided_face_recognition_tpu_torch.ops.layernorm import (
    layernorm_fused)

__all__ = ["TextArch", "TEXT_ARCHS", "TransformerEncoder", "TextEncoder",
           "BertWordMapping", "TextHeading", "LayerNorm", "drop_elems",
           "fused_block_in_effect", "quick_gelu"]

FUSED_BLOCK_MODES = ("none", "ffn", "attn", "both", "tower")


@dataclasses.dataclass(frozen=True)
class TextArch:
    vocab_size: int
    hidden: int
    layers: int
    heads: int
    intermediate: int
    max_positions: int
    style: str = "postln"      # "postln" (BERT) | "preln" (CLIP/ViT)
    causal: bool = False
    act: str = "gelu"          # "gelu" (erf) | "quick_gelu"
    type_vocab: int = 2        # 0 disables token-type embeddings
    dropout: float = 0.1       # train mode only
    emb_ln: bool = True
    final_ln: bool = False
    ln_eps: float = 1e-12


# The JAX package's architecture table, entry for entry.
TEXT_ARCHS = {
    "bert": TextArch(30522, 768, 12, 12, 3072, 512),
    "align": TextArch(30522, 768, 12, 12, 3072, 512),
    "blip": TextArch(30524, 768, 12, 8, 3072, 512, type_vocab=0, dropout=0.0),
    "falva": TextArch(30522, 768, 12, 12, 3072, 512, style="preln",
                      dropout=0.0, final_ln=True),
    "clip": TextArch(49408, 512, 12, 8, 2048, 77, style="preln", causal=True,
                     act="quick_gelu", type_vocab=0, dropout=0.0,
                     emb_ln=False, final_ln=True, ln_eps=1e-5),
    "groupvit": TextArch(49408, 256, 12, 4, 1024, 77, style="preln",
                         causal=True, act="quick_gelu", type_vocab=0,
                         dropout=0.0, emb_ln=False, final_ln=True,
                         ln_eps=1e-5),
}


def fused_block_in_effect(arch: TextArch, fused_block: str) -> str:
    """The `fused_block` mode a tower of `arch` runs: the mode asked for,
    or "none" where the block kernels do not take the arch (a pre-LN or
    quick-GELU layer, heads other than 64 wide), as the JAX package's
    TransformerEncoder decides it."""
    if fused_block not in FUSED_BLOCK_MODES:
        raise ValueError(f"fused_block={fused_block!r} is not one of "
                         f"{FUSED_BLOCK_MODES}")
    if fused_block != "none" and (arch.style != "postln"
                                  or arch.act != "gelu"
                                  or arch.hidden // arch.heads != D_HEAD):
        return "none"
    return fused_block


def drop_elems(arch: TextArch, b: int, t: int, fused_block: str = "none",
               fused_dropout: bool = True) -> int:
    """Host dropout bits one training forward of the tower takes."""
    fb = fused_block_in_effect(arch, fused_block)
    return total_elems(arch.hidden, arch.layers, arch.heads, b, t,
                       prng_sites(fb, fused_dropout))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The FFN activation `name` of an f32 tensor, in f32 (the caller
    rounds once to the compute dtype)."""
    return quick_gelu(x) if name == "quick_gelu" else gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 parameters, output in `dtype`.
    `fused` runs ops/layernorm.layernorm_fused (the CUDA kernel on a card);
    otherwise F.layer_norm on f32 (flax nn.LayerNorm reduces in f32)."""

    def __init__(self, h: int, eps: float, dtype: torch.dtype,
                 fused: bool = False):
        super().__init__()
        self.eps, self.dtype, self.fused = eps, dtype, fused
        self.weight = nn.Parameter(torch.ones(h))
        self.bias = nn.Parameter(torch.zeros(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.fused:
            return layernorm_fused(x.contiguous(), self.weight, self.bias,
                                   self.eps)
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.eps).to(self.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with one packed q|k|v projection; f32
    scores, the causal mask (causal archs) and then the key mask, each
    setting a score to finfo(float32).min, probabilities rounded to
    `dtype`, then dropped with bits_p (heads*B, T, T) when rate > 0, before
    P.V."""

    def __init__(self, arch: TextArch, dtype: torch.dtype):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        self.qkv = Dense(arch.hidden, 3 * arch.hidden, dtype)
        self.out = Dense(arch.hidden, arch.hidden, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                bits_p: Optional[torch.Tensor] = None,
                rate: float = 0.0) -> torch.Tensor:
        a = self.arch
        b, t, _ = x.shape
        d = a.hidden // a.heads
        qkv = self.qkv(x).reshape(b, t, 3, a.heads, d).float()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        score = torch.matmul(q, k.transpose(-1, -2)) / (d ** 0.5)
        neg = torch.finfo(torch.float32).min
        if a.causal:
            causal = torch.ones(t, t, dtype=torch.bool,
                                device=x.device).tril()
            score = score.masked_fill(~causal, neg)
        score = score.masked_fill(~mask[:, None, None, :], neg)
        probs = torch.softmax(score, dim=-1).to(self.dtype)
        if rate > 0.0:   # bits in the kernels' (heads*B, T, T) layout
            bits = bits_p.view(a.heads, b, t, t).transpose(0, 1)
            probs = dropout(probs, bits, rate)
        out = torch.matmul(probs.float(), v).to(self.dtype)  # (B, heads, T, d)
        return self.out(out.transpose(1, 2).reshape(b, t, a.hidden))


class Block(nn.Module):
    """One layer. Post-LN: y = LN(x + drop(attn(x))), then
    LN(y + drop(W2 act(W1 y))); pre-LN: y = x + drop(attn(LN(x))), then
    y + drop(W2 act(W1 LN(y))). `fused_block` is the mode in effect; the
    kernels take post-LN layers only."""

    def __init__(self, arch: TextArch, dtype: torch.dtype, fused_ln: bool,
                 fused_block: str):
        super().__init__()
        h = arch.hidden
        self.arch, self.dtype, self.fused_block = arch, dtype, fused_block
        self.attn = SelfAttention(arch, dtype)
        self.attn_ln = LayerNorm(h, arch.ln_eps, dtype, fused_ln)
        self.ffn_in = Dense(h, arch.intermediate, dtype)
        self.ffn_out = Dense(arch.intermediate, h, dtype)
        self.ffn_ln = LayerNorm(h, arch.ln_eps, dtype, fused_ln)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                mask_i32: torch.Tensor, plan: Optional[DropBits] = None,
                rate: float = 0.0,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: (B, T) bool; mask_i32: the same as contiguous int32, the
        kernel's form. plan: this step's host dropout bits when rate > 0;
        seed: the layer's (1,) int32 seed in prng mode, which the fused
        halves draw from (the FFN half from stream seed ^ 0x5BD1E995) while
        the unfused ones take host bits."""
        a = self.arch
        b, t, h = x.shape
        eps = a.ln_eps
        fused_attn = self.fused_block in ("attn", "both")
        fused_ffn = self.fused_block in ("ffn", "both")
        seed_attn = seed if fused_attn else None
        seed_ffn = seed if fused_ffn else None
        bits_p = bits_h = bits_f = None
        if rate > 0.0:
            drawn = {"attn": seed_attn, "ffn": seed_ffn}
            bits_p, bits_h, bits_f = (
                None if drawn[half] is not None else plan.take(shape)
                for half, shape in layer_sites(h, a.heads, b, t))
        if a.style == "preln":
            return self._preln(x, mask, rate, bits_p, bits_h, bits_f)
        if fused_attn:
            y = attn_block(
                x.reshape(b * t, h).contiguous(), mask_i32,
                self.attn.qkv.weight.t(), self.attn.qkv.bias,
                self.attn.out.weight.t(), self.attn.out.bias,
                self.attn_ln.weight, self.attn_ln.bias, b, t, a.heads, rate,
                eps, bits_p, bits_h, seed_attn).reshape(b, t, h)
        else:
            att = self.attn(x, mask, bits_p, rate)
            if rate > 0.0:
                att = dropout(att, bits_h.view(b, t, h), rate)
            y = self.attn_ln(x + att)
        if fused_ffn:
            return ffn_block(
                y.reshape(b * t, h).contiguous(), self.ffn_in.weight.t(),
                self.ffn_in.bias, self.ffn_out.weight.t(), self.ffn_out.bias,
                self.ffn_ln.weight, self.ffn_ln.bias, rate, eps,
                bits_f, seed_ffn).reshape(b, t, h)
        f = self.ffn_out(_act(a.act, self.ffn_in(y).float()).to(self.dtype))
        if rate > 0.0:
            f = dropout(f, bits_f.view(b, t, h), rate)
        return self.ffn_ln(y + f)

    def _preln(self, x, mask, rate, bits_p, bits_h, bits_f) -> torch.Tensor:
        """The pre-LN layer, unfused; the residual stream stays in
        `dtype`."""
        a = self.arch
        b, t, h = x.shape
        att = self.attn(self.attn_ln(x), mask, bits_p, rate)
        if rate > 0.0:
            att = dropout(att, bits_h.view(b, t, h), rate)
        x = x + att
        f = self.ffn_out(_act(a.act, self.ffn_in(self.ffn_ln(x)).float()
                              ).to(self.dtype))
        if rate > 0.0:
            f = dropout(f, bits_f.view(b, t, h), rate)
        return x + f


class TransformerEncoder(nn.Module):
    """The text tower of `arch`; returns the last hidden states (B, T, H)."""

    def __init__(self, arch: TextArch, dtype: torch.dtype = torch.float32,
                 fused_ln: bool = False, fused_block: str = "none",
                 fused_dropout: bool = False):
        super().__init__()
        fb = fused_block_in_effect(arch, fused_block)
        if fb != fused_block:
            warnings.warn(
                f"fused_block={fused_block!r} supports post-LN gelu archs "
                f"with d_head == {D_HEAD} only (bert/align); falling back to "
                f"the unfused path for style={arch.style!r} "
                f"act={arch.act!r} d_head={arch.hidden // arch.heads}")
        self.arch, self.dtype, self.fused_block = arch, dtype, fused_block
        self.fused_block_effective = fb
        self.fused_dropout = fused_dropout
        h = arch.hidden
        self.tok_emb = nn.Embedding(arch.vocab_size, h)
        self.pos_emb = nn.Embedding(arch.max_positions, h)
        self.type_emb = (nn.Embedding(arch.type_vocab, h) if arch.type_vocab
                         else None)
        self.emb_ln = (LayerNorm(h, arch.ln_eps, dtype, fused_ln)
                       if arch.emb_ln else None)
        for i in range(arch.layers):
            self.add_module(f"layer_{i}", Block(arch, dtype, fused_ln, fb))
        self.final_ln = (LayerNorm(h, arch.ln_eps, dtype, fused_ln)
                         if arch.final_ln else None)

    def drop_counts(self, b: int, t: int) -> Tuple[int, int]:
        """(host bits, kernel seeds) one training forward at (b, t) takes:
        prng mode draws one seed per layer (attn / ffn / both) or one
        (tower) and the host bits of the other sites only."""
        if not self.arch.dropout:
            return 0, 0
        fb = self.fused_block_effective
        sites = prng_sites(fb, self.fused_dropout)
        seeds = 0 if not sites else 1 if fb == "tower" else self.arch.layers
        return drop_elems(self.arch, b, t, fb,
                          self.fused_dropout), seeds

    def local_bits(self, bits: torch.Tensor, b: int, t: int, rank: int,
                   world: int, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """A rank's share of the host bits of a forward at the global batch
        (b, t): each site's bits of the rank's rows [rank b / world, (rank
        + 1) b / world), in the plan's site order, as many as a forward at
        (b / world, t) takes; into `out` when given. Every site is
        batch-major but the attention probabilities, (heads, B, T, T)."""
        a = self.arch
        h, bl = a.hidden, b // world
        rows = slice(rank * bl, (rank + 1) * bl)
        in_kernel = prng_sites(self.fused_block_effective, self.fused_dropout)
        plan = DropBits(bits)
        parts = [plan.take((b, t * h))[rows]]
        for _ in range(a.layers):
            for i, (half, shape) in enumerate(layer_sites(h, a.heads, b, t)):
                if half in in_kernel:
                    continue
                if i == 0:                  # probabilities (heads*B, T, T)
                    parts.append(plan.take((a.heads, b, t * t))[:, rows])
                else:
                    parts.append(plan.take((b, t * h))[rows])
        return torch.cat([p.reshape(-1) for p in parts], out=out)

    def _tower(self, x: torch.Tensor, mask_i32: torch.Tensor,
               plan: Optional[DropBits], rate: float,
               seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """All layers through ops/block.tower_block (fused_block="tower"):
        the 12 leaves of every layer stacked and cast once to the compute
        dtype; autograd's stack/cast backward hands each f32 parameter its
        gradient, the kernel's bf16 value widened. In prng mode the kernels
        draw layer j's bits from stream seed + j; in host mode the step's
        flat bit draw already has the tower's order (per layer:
        probabilities, attention output, FFN output), so the kernel gets
        strided views of it."""
        a, dt = self.arch, self.dtype
        b, t, h = x.shape
        layers = [getattr(self, f"layer_{i}") for i in range(a.layers)]

        def stack(get, weight=False):
            s = torch.stack([get(lyr) for lyr in layers]).to(dt)
            return s.transpose(1, 2) if weight else s.unsqueeze(1)

        leaves = (
            stack(lambda m: m.attn.qkv.weight, True),
            stack(lambda m: m.attn.qkv.bias),
            stack(lambda m: m.attn.out.weight, True),
            stack(lambda m: m.attn.out.bias),
            stack(lambda m: m.attn_ln.weight), stack(lambda m: m.attn_ln.bias),
            stack(lambda m: m.ffn_in.weight, True),
            stack(lambda m: m.ffn_in.bias),
            stack(lambda m: m.ffn_out.weight, True),
            stack(lambda m: m.ffn_out.bias),
            stack(lambda m: m.ffn_ln.weight), stack(lambda m: m.ffn_ln.bias))
        bits_p = bits_h = bits_f = None
        if rate > 0.0 and seed is None:
            sites = layer_sites(h, a.heads, b, t)
            sizes = [math.prod(shape) for _, shape in sites]
            per = plan.take((a.layers, sum(sizes)))
            bits_p, bits_h, bits_f = (
                c.unflatten(1, shape) for c, (_, shape)
                in zip(per.split(sizes, dim=1), sites))
        z = tower_block(x.reshape(b * t, h).contiguous(), mask_i32, *leaves,
                        b, t, a.heads, rate, a.ln_eps, bits_p, bits_h, bits_f,
                        seed)
        return z.reshape(b, t, h)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                drop_bits: Optional[torch.Tensor] = None,
                drop_seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """In train mode: drop_bits, a flat int32 tensor of random bit
        patterns on the input's device for the host-drawn sites, and in
        prng mode drop_seeds, the kernels' int32 seeds, as many as
        `drop_counts(B, T)` says (both ignored in eval mode)."""
        a, dt = self.arch, self.dtype
        b, t = input_ids.shape
        if t > a.max_positions:
            raise ValueError(
                f"captions of {t} tokens: this text arch has "
                f"{a.max_positions} positions (config.check_caption_length)")
        rate = float(a.dropout) if self.training else 0.0
        plan = seeds = None
        if rate > 0.0:
            n, k = self.drop_counts(b, t)
            if drop_bits is None or drop_bits.numel() != n:
                raise ValueError(
                    f"TransformerEncoder in train mode takes drop_bits: {n} "
                    "int32 bit patterns (ops/dropout.draw)")
            got = 0 if drop_seeds is None else drop_seeds.numel()
            if got != k or (k and (drop_seeds.dim() != 1 or
                                   drop_seeds.dtype != torch.int32)):
                raise ValueError(
                    "TransformerEncoder(fused_block="
                    f"{self.fused_block_effective!r}, "
                    f"fused_dropout={self.fused_dropout}) in train mode "
                    f"takes {k} int32 drop_seeds (ops/dropout.draw_seeds)")
            plan = DropBits(drop_bits)
            seeds = drop_seeds if k else None
        ids = input_ids.long()
        pos = torch.arange(t, device=ids.device)[None, :]
        x = self.tok_emb(ids).to(dt) + self.pos_emb(pos).to(dt)
        if self.type_emb is not None:
            x = x + self.type_emb(torch.zeros_like(ids)).to(dt)
        if self.emb_ln is not None:
            x = self.emb_ln(x)
        if rate > 0.0:
            x = dropout(x, plan.take(x.shape), rate)
        mask = attention_mask.bool()
        mask_i32 = attention_mask.to(torch.int32).contiguous()
        if self.fused_block_effective == "tower":
            x = self._tower(x, mask_i32, plan, rate,
                            None if seeds is None else seeds[:1])
        else:
            for i in range(a.layers):
                x = getattr(self, f"layer_{i}")(
                    x, mask, mask_i32, plan, rate,
                    None if seeds is None else seeds[i:i + 1])
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x


class TextEncoder(nn.Module):
    """bert_type-selected encoder with the reference's output contract:
    (words_emb = hidden[:, 1:], sent_emb = hidden[:, 0])."""

    def __init__(self, bert_type: str = "bert",
                 dtype: torch.dtype = torch.float32, fused_ln: bool = False,
                 fused_block: str = "none", fused_dropout: bool = False):
        super().__init__()
        self.model = TransformerEncoder(TEXT_ARCHS[bert_type], dtype,
                                        fused_ln, fused_block, fused_dropout)

    @property
    def fused_block_effective(self) -> str:
        return self.model.fused_block_effective

    def drop_counts(self, b: int, t: int) -> Tuple[int, int]:
        return self.model.drop_counts(b, t)

    def local_bits(self, bits, b, t, rank, world, out=None) -> torch.Tensor:
        return self.model.local_bits(bits, b, t, rank, world, out)

    def forward(self, captions: torch.Tensor, mask: torch.Tensor,
                drop_bits: Optional[torch.Tensor] = None,
                drop_seeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = self.model(captions, mask, drop_bits, drop_seeds)
        return hidden[:, 1:], hidden[:, 0]


class BertWordMapping(nn.Module):
    """Three token-window projections K in {2, 3, 4} with ReLU: the
    reference's Conv2d(1, F, (K, E)) written as a Dense over K stacked
    tokens. (B, T, E) -> [(B, T-K+1, F)] * 3."""

    def __init__(self, hidden: int, feat_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for k in (2, 3, 4):
            self.add_module(f"conv_k{k}", Dense(k * hidden, feat_dim, dtype))

    def forward(self, words_emb: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for k in (2, 3, 4):
            t = words_emb.shape[1] - k + 1
            win = torch.cat([words_emb[:, i:i + t] for i in range(k)], dim=-1)
            outs.append(torch.relu(getattr(self, f"conv_k{k}")(win)))
        return outs


class TextHeading(nn.Module):
    """FCAM text head: (words_emb (B, T-1, E)) -> (words (B, F, T-2) f32,
    sent (B, F) f32). Per-word features are the max over the three window
    scales, a scale padded with finfo(float32).min where its window does not
    fit; the sentence feature is the mean over scales of the max over time;
    both l2-normalised."""

    def __init__(self, hidden: int = 768, feat_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bwm = BertWordMapping(hidden, feat_dim, dtype)

    def forward(self, words_emb: torch.Tensor,
                sent_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a, b, c = self.bwm(words_emb)
        t_out = a.shape[1]
        neg = torch.finfo(torch.float32).min

        def pad_to(x):
            return F.pad(x.float(), (0, 0, 0, t_out - x.shape[1]), value=neg)

        words = torch.maximum(torch.maximum(pad_to(a), pad_to(b)), pad_to(c))
        words = l2_normalize(words, dim=-1).transpose(1, 2)   # (B, F, T_out)
        sent = (a.amax(dim=1) + b.amax(dim=1) + c.amax(dim=1)) / 3.0
        sent = l2_normalize(sent.float(), dim=-1)
        return words, sent
