"""Dropout from host-made random bits.

The semantics of the JAX package's `_DropPlan` (models/text_bert.py) and
of block_pallas.py `_drop`: keep iff the uint32 bit >= round(rate * 2^32)
(capped at 2^32 - 1), so P(keep) = 1 - rate exactly; a kept value v of
dtype dt becomes v * dt(1 / (1 - rate)), rounded to dt; a dropped one is 0.
Mask values carry no parity constraint with torch or JAX; the keep rule
does.

Bits are int32 tensors holding the uint32 bit patterns (PyTorch's uint32
dtype has few kernels); the CUDA kernels read the same memory as uint32.
A training step draws all of its bits at once (`draw`) and `DropBits` hands
out consecutive slices in the JAX plan's site order: the embeddings
(B*T, H), then per layer the attention probabilities (heads*B, T, T), the
attention output (B*T, H) and the FFN output (B*T, H).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["threshold", "keep_mask", "dropout", "total_elems", "draw",
           "DropBits"]


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


def total_elems(hidden: int, layers: int, heads: int, b: int, t: int) -> int:
    """Bits one training step of a post-LN tower takes (`_DropPlan`)."""
    return b * t * hidden + layers * (b * heads * t * t + 2 * b * t * hidden)


def draw(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """n uniform 32-bit patterns as int32, made on `device` from
    `generator` (which must live on that device)."""
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         generator=generator, device=device)


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
