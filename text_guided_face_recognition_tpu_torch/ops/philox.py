"""The in-kernel dropout streams: counter-based Philox4x32-10 bits, their
plain PyTorch version, and the bit-dump kernels K10-K12 (csrc/philox.cu).

Counterpart of the Mosaic PRNG that the JAX package's fused kernels draw
from on the TPU (ops/block_pallas.py `_ffn_bits`, `_attn_bits`, the tower
kernels' `prng_seed(seed + j)`) and of the dump kernels of
tools/verify_block_prng.py (`dump_bits`, `dump1_kernel`, `dumpL`). The
TPU's values cannot be had on a GPU; the port keeps the contract, not the
values (mask values carry no parity constraint; the keep rule does).

The stream contract, followed by the CUDA kernels (csrc/common.cuh
`philox_word`, `DropSrc`) and by the plain version here:

- Generator. A stream is named by a uint32 seed s. Its word i (i >= 0,
  64-bit) is word i & 3 of Philox4x32-10 with the counter (lo32(i >> 2),
  hi32(i >> 2), 0, 0) and the key (s, 0): multipliers 0xD2511F53 and
  0xCD9E8D57, Weyl constants 0x9E3779B9 and 0xBB67AE85 (Random123's
  philox4x32, 10 rounds).
- Streams per site (models/text_bert.py of the JAX package, `_fused_postln`
  and `_tower`):
    attention half-layer (K5/K6) of layer j: stream seeds[j]; the
      probabilities take words [0, heads B T^2) in the (heads*B, T, T)
      layout, the attention output the next R H words ((R, H), R = B T);
    FFN half-layer (K3/K4) of layer j: stream seeds[j] ^ 0x5BD1E995 (int32
      xor), words [0, R H);
    tower (K7/K8) with the one seed s: layer j uses stream s + j (int32
      wrap), its probabilities, attention output and FFN output consecutive
      in that stream.
- Seeds are int32 in [0, 2^31 - 1), drawn per step on the device (one per
  layer for attn / ffn / both, one for tower), and reach a kernel through a
  device pointer: an int32 tensor, the JAX kernels' (1, 1) SMEM seed.
  Nothing syncs the host.
- Keep rule: unchanged (ops/dropout.py): keep iff word >= round(rate 2^32).

The same seed gives the same masks; a backward regenerates its forward's
masks from the seed it saved; and prng mode equals host-bits mode fed the
dump of the same seed (K10-K12 below), bit for bit.

K10 `attn_stream_bits`, K11 `ffn_stream_bits`, K12 `tower_stream_bits`
return exactly the tensors the host-bits mode of `attn_block`,
`ffn_block` and `tower_block` (ops/block.py) takes, as int32-held uint32
patterns. Each runs its plain version for a CPU seed and the dump kernel
for a CUDA seed (never falling back), one launch a call (K11's xor of the
seed is the kernel's), counting its launches in `<wrapper>.launches`.
`compose_drop_bits` lays the dumps of a prng-mode step out with its host
bits as one host-mode draw.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from text_guided_face_recognition_tpu_torch.ops import _cuda
from text_guided_face_recognition_tpu_torch.ops.dropout import (
    layer_sites, prng_sites)

__all__ = ["FFN_XOR", "philox4x32_10", "stream_bits", "ffn_seed",
           "attn_stream_bits", "attn_stream_bits_ref", "ffn_stream_bits",
           "ffn_stream_bits_ref", "tower_stream_bits",
           "tower_stream_bits_ref", "check_seed", "compose_drop_bits"]

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
FFN_XOR = 0x5BD1E995      # the FFN site's stream: seed ^ this (int32 xor)
_MASK = 0xFFFFFFFF

Seed = Union[int, torch.Tensor]


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the product of the constant a < 2^32 and
    b (int64 values in [0, 2^32)), with no intermediate above 2^49."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b * ah, b * al                       # each < 2^48
    hi = (bh + (bl >> 16)) >> 16
    lo = (((bh & 0xFFFF) << 16) + bl) & _MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1=0):
    """Philox4x32-10 on int64 tensors holding uint32 values (the key words
    may be ints or tensors that broadcast). Returns the 4 output words."""
    for r in range(10):
        if r:
            k0 = (k0 + W0) & _MASK
            k1 = (k1 + W1) & _MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key(seed: Seed):
    """The stream's key word: a uint32 int, or a (1,) int64 tensor."""
    if torch.is_tensor(seed):
        return seed.reshape(-1)[:1].long() & _MASK
    return int(seed) & _MASK


def _as_int32(w: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bit patterns as int32."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def stream_bits(seed: Seed, n: int, offset: int = 0) -> torch.Tensor:
    """Words [offset, offset + n) of stream `seed` as int32-held uint32, on
    the seed tensor's device (the CPU for an int seed)."""
    device = seed.device if torch.is_tensor(seed) else "cpu"
    b0, b1 = offset >> 2, (offset + n + 3) >> 2
    blk = torch.arange(b0, b1, dtype=torch.int64, device=device)
    zero = torch.zeros_like(blk)
    words = torch.stack(philox4x32_10(blk & _MASK, blk >> 32, zero, zero,
                                      _key(seed)), dim=1).reshape(-1)
    start = offset - 4 * b0
    return _as_int32(words[start:start + n])


def ffn_seed(seed: Seed) -> Seed:
    """The FFN site's stream of a layer seed: seed ^ 0x5BD1E995 (int32)."""
    if torch.is_tensor(seed):
        return seed ^ FFN_XOR
    return (int(seed) & _MASK) ^ FFN_XOR


def _layer_seed(seed: Seed, j: int) -> Seed:
    """The tower's stream of layer j: seed + j (int32 wrap)."""
    if torch.is_tensor(seed):
        return (seed.long() + j) & _MASK
    return (int(seed) + j) & _MASK


def _sizes(b: int, t: int, h: int, heads: int) -> Tuple[int, int]:
    return heads * b * t * t, b * t * h


# ------------------------------------------------------- plain versions --

def attn_stream_bits_ref(seed: Seed, b: int, t: int, h: int, heads: int):
    """Plain K10: (bits_p (heads*b, t, t), bits_h (b*t, h)) of stream
    seed, words [0, n_p) and [n_p, n_p + b t h)."""
    n_p, n_h = _sizes(b, t, h, heads)
    w = stream_bits(seed, n_p + n_h)
    return w[:n_p].view(heads * b, t, t), w[n_p:].view(b * t, h)


def ffn_stream_bits_ref(seed: Seed, rows: int, h: int) -> torch.Tensor:
    """Plain K11: (rows, h) words [0, rows h) of stream seed ^ 0x5BD1E995;
    `seed` is the layer seed."""
    return stream_bits(ffn_seed(seed), rows * h).view(rows, h)


def tower_stream_bits_ref(seed: Seed, layers: int, b: int, t: int, h: int,
                          heads: int):
    """Plain K12: (bits_p (L, heads*b, t, t), bits_h (L, b*t, h), bits_f
    (L, b*t, h)); layer j from stream seed + j, its three sites
    consecutive."""
    n_p, n_h = _sizes(b, t, h, heads)
    w = torch.stack([stream_bits(_layer_seed(seed, j), n_p + 2 * n_h)
                     for j in range(layers)])
    return _split_tower(w, b, t, h, heads)


def _split_tower(w, b, t, h, heads):
    n_p, n_h = _sizes(b, t, h, heads)
    return (w[:, :n_p].unflatten(1, (heads * b, t, t)),
            w[:, n_p:n_p + n_h].unflatten(1, (b * t, h)),
            w[:, n_p + n_h:].unflatten(1, (b * t, h)))


# --------------------------------------------------------------- kernels --

def check_seed(name: str, seed: torch.Tensor, device) -> None:
    """seed: a contiguous int32 (1,) tensor on `device`."""
    if not torch.is_tensor(seed) or tuple(seed.shape) != (1,) or \
            seed.dtype != torch.int32 or seed.device != device or \
            not seed.is_contiguous():
        raise ValueError(f"{name}: seed must be a contiguous int32 (1,) "
                         f"tensor on {device}")


def _dump(name: str, seed: torch.Tensor, layers: int, per: int,
          key_xor: int = 0) -> torch.Tensor:
    """(layers, per) int32: row j is words [0, per) of stream (seed ^
    key_xor) + j, in one launch of csrc/philox.cu."""
    check_seed(name, seed, seed.device)
    if not 1 <= layers <= 65535 or not 1 <= per <= 4 * _MASK:
        raise ValueError(f"{name}: {layers} rows of {per} words; the kernel "
                         f"takes 1 to 65535 rows of at most 2^32 - 1 Philox "
                         f"blocks (4 words each)")
    out = torch.empty((layers, per), dtype=torch.int32, device=seed.device)
    fn = _cuda.function("philox", "tgfr_philox_dump",
                        (ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_void_p))
    _cuda.launch(fn, seed.data_ptr(), key_xor, layers, per, out.data_ptr())
    return out


def attn_stream_bits(seed: torch.Tensor, b: int, t: int, h: int, heads: int):
    """K10: the attention half-layer's bits of stream seed, (bits_p
    (heads*b, t, t), bits_h (b*t, h)), for `attn_block`'s host mode."""
    if seed.device.type == "cpu":
        return attn_stream_bits_ref(seed, b, t, h, heads)
    n_p, n_h = _sizes(b, t, h, heads)
    w = _dump("attn_stream_bits", seed, 1, n_p + n_h)[0]
    attn_stream_bits.launches += 1
    return w[:n_p].view(heads * b, t, t), w[n_p:].view(b * t, h)


def ffn_stream_bits(seed: torch.Tensor, rows: int, h: int) -> torch.Tensor:
    """K11: the FFN half-layer's bits (rows, h) of layer seed `seed` (its
    stream seed ^ 0x5BD1E995, applied to the key in the kernel), for
    `ffn_block`'s host mode."""
    if seed.device.type == "cpu":
        return ffn_stream_bits_ref(seed, rows, h)
    w = _dump("ffn_stream_bits", seed, 1, rows * h, FFN_XOR)[0]
    ffn_stream_bits.launches += 1
    return w.view(rows, h)


def tower_stream_bits(seed: torch.Tensor, layers: int, b: int, t: int,
                      h: int, heads: int):
    """K12: the tower's bits of seed, (bits_p (L, heads*b, t, t), bits_h,
    bits_f (L, b*t, h)), layer j from stream seed + j, for `tower_block`'s
    host mode (per-layer slices contiguous, one flat buffer)."""
    if seed.device.type == "cpu":
        return tower_stream_bits_ref(seed, layers, b, t, h, heads)
    n_p, n_h = _sizes(b, t, h, heads)
    w = _dump("tower_stream_bits", seed, layers, n_p + 2 * n_h)
    tower_stream_bits.launches += 1
    return _split_tower(w, b, t, h, heads)


attn_stream_bits.launches = 0
ffn_stream_bits.launches = 0
tower_stream_bits.launches = 0


def compose_drop_bits(arch, b: int, t: int, fused_block: str,
                      bits: torch.Tensor,
                      seeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The full host draw (every site, ops/dropout.py's order) that
    reproduces a prng-mode step of `fused_block` with host bits `bits` and
    kernel seeds `seeds`: the host sites' bits where the step took them,
    the dumps of the seeds' streams (K10-K12) where its kernels drew them.
    Fed to the same step in host mode, or to fused_block "none", it gives
    the prng-mode step's masks. arch: the text arch (hidden, layers,
    heads)."""
    in_kernel = prng_sites(fused_block, False) if seeds is not None else ()
    h, heads, layers = arch.hidden, arch.heads, arch.layers
    sites = layer_sites(h, heads, b, t)
    if in_kernel and fused_block == "tower":
        stacks = tower_stream_bits(seeds[:1], layers, b, t, h, heads)

    def dump(j, half):
        """Layer j's dumped bits of `half`, in its sites' order."""
        if fused_block == "tower":
            return [s[j] for s, (hf, _) in zip(stacks, sites) if hf == half]
        seed = seeds[j:j + 1]
        return (attn_stream_bits(seed, b, t, h, heads) if half == "attn"
                else (ffn_stream_bits(seed, b * t, h),))

    out, ofs = [bits[:b * t * h]], b * t * h
    for j in range(layers):
        dumped = {half: iter(dump(j, half)) for half in in_kernel}
        for half, shape in sites:
            if half in dumped:
                out.append(next(dumped[half]).reshape(-1))
            else:
                n = math.prod(shape)
                out.append(bits[ofs:ofs + n])
                ofs += n
    if ofs != bits.numel():
        raise ValueError(f"compose_drop_bits: {bits.numel()} host bits, the "
                         f"{fused_block!r} step takes {ofs}")
    return torch.cat(out)
