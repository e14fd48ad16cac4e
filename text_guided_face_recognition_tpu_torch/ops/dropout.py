"""Dropout from random bits: the keep rule, the host draw and its sites.

The semantics of the JAX package's `_DropPlan` (models/text_bert.py) and
of block_pallas.py `_drop`: keep iff the uint32 bit >= round(rate * 2^32)
(capped at 2^32 - 1), so P(keep) = 1 - rate exactly; a kept value v of
dtype dt becomes v * dt(1 / (1 - rate)), rounded to dt; a dropped one is 0.
Mask values carry no parity constraint with torch or JAX; the keep rule
does.

Bits are int32 tensors holding the uint32 bit patterns (PyTorch's uint32
dtype has few kernels); the CUDA kernels read the same memory as uint32.
A training step draws all of its host bits at once (`draw`) and `DropBits`
hands out consecutive slices in the JAX plan's site order: the embeddings
(B*T, H), then per layer the sites of `layer_sites`. In prng mode (the JAX
package's `use_prng`, its default on the chip) the fused half-layers'
kernels draw their own bits from a seed (ops/philox.py); the host draw
then holds only the other sites, in the same order, and the step draws the
kernels' int32 seeds beside it (`draw_seeds`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["threshold", "keep_mask", "dropout", "layer_sites", "prng_sites",
           "total_elems", "draw", "draw_seeds", "DropBits"]


def threshold(rate: float) -> int:
    """Keep iff the uint32 bit >= this."""
    return min(int(round(rate * (1 << 32))), (1 << 32) - 1)


def keep_mask(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep mask of int32-held uint32 bits."""
    return (bits.to(torch.int64) & 0xFFFFFFFF) >= threshold(rate)


def dropout(x: torch.Tensor, bits: torch.Tensor, rate: float
            ) -> torch.Tensor:
    """x with the dropout of `bits` (same shape) applied, in x's dtype."""
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep_mask(bits, rate), x * scale, torch.zeros_like(x))


def layer_sites(hidden: int, heads: int, b: int, t: int
                ) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """One layer's dropout sites in the plan's order, as (half-layer, bit
    shape): the attention half's probabilities (heads*B, T, T) and output
    (B*T, H), then the FFN half's output (B*T, H)."""
    out = (b * t, hidden)
    return (("attn", (heads * b, t, t)), ("attn", out), ("ffn", out))


def prng_sites(fused_block: str, fused_dropout: bool) -> Sequence[str]:
    """The half-layers whose kernels draw their own dropout bits: every
    fused half, unless fused_dropout (the JAX package's use_prng)."""
    if fused_dropout or fused_block == "none":
        return ()
    return {"attn": ("attn",), "ffn": ("ffn",)}.get(fused_block,
                                                     ("attn", "ffn"))


def total_elems(hidden: int, layers: int, heads: int, b: int, t: int,
                in_kernel: Sequence[str] = ()) -> int:
    """Host bits one training step of a post-LN tower takes (`_DropPlan`):
    the embeddings and every layer's `layer_sites`, less those of the
    halves named in `in_kernel` ("attn", "ffn"), whose kernels draw their
    own bits."""
    per = sum(math.prod(shape) for half, shape
              in layer_sites(hidden, heads, b, t) if half not in in_kernel)
    return b * t * hidden + layers * per


def draw(n: int, generator: torch.Generator, device,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n uniform 32-bit patterns as int32, made on `device` from
    `generator` (which must live on that device); into `out` when given
    (the same stream)."""
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         generator=generator, device=device, out=out)


def draw_seeds(n: int, generator: torch.Generator, device,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n int32 stream seeds in [0, 2^31 - 1), as the JAX package draws them
    (jax.random.randint(key, (1, 1), 0, int32 max)), made on `device`;
    into `out` when given."""
    return torch.randint(0, (1 << 31) - 1, (n,), dtype=torch.int32,
                         generator=generator, device=device, out=out)


class DropBits:
    """Consecutive slices of one flat draw, one per dropout site."""

    def __init__(self, bits: torch.Tensor):
        if bits.dtype != torch.int32 or bits.dim() != 1:
            raise ValueError("DropBits: bits must be a flat int32 tensor")
        self.bits = bits
        self.ofs = 0

    def take(self, shape: Sequence[int]) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= int(s)
        if self.ofs + n > self.bits.numel():
            raise ValueError(f"DropBits: {self.bits.numel()} bits, a site at "
                             f"offset {self.ofs} needs {n}")
        out = self.bits[self.ofs:self.ofs + n].view(*shape)
        self.ofs += n
        return out
