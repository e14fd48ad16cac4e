"""Bidirectional LSTM/GRU caption encoder.

Counterpart of text_guided_face_recognition_tpu/models/text_rnn.py
(`RNNEncoder`, the reference's models/models.py:236-324): Embedding(vocab,
300) -> dropout 0.5 -> one bidirectional LSTM or GRU layer, nhidden / 2
units per direction, giving

  * words_emb (B, nhidden, T) f32: each step's outputs, zero past each
    caption's length;
  * sent_emb (B, nhidden) f32: the forward output at len - 1 beside the
    backward output at position 0, l2-normalised.

No packing and no sorting. The reference packs length-sorted captions,
which needs the lengths on the host; the JAX package runs flax's
length-aware scan instead (`nn.RNN(seq_lengths=...)`, the backward
direction with `reverse=True, keep_order=True`), and so does this module,
with static shapes: the backward direction reads each caption reversed
within its length by a gather (flax's `flip_sequences`: position t takes
(T - 1 - t + len) mod T, padding reversed after it), runs the same
forward-only recurrence, and the same gather puts its outputs back in
caption order. Both directions run in one loop over T, as batched
products over a leading direction axis, so a step is the same few device
operations whatever the lengths and a CUDA graph captures it.

The cells are written as per-step products and elementwise operations
(not cuDNN's nn.LSTM / nn.GRU), so that they round where flax's cells
round in a reduced compute dtype: flax's `OptimizedLSTMCell` rounds the
input, kernel and bias to `dtype`, rounds each product to it and adds the
bias in it, takes the gates in it, and keeps its carry (c, h) in f32
(param_dtype): c' = f c + r(i g), h' = o tanh(c'), both f32. `GRUCell`
likewise: r, z, n in `dtype`, h' = r((1 - z) n) + z h in f32. In f32 every
step is f32. Each gate keeps its own parameters under flax's names (LSTM:
`ii`, `if`, `ig`, `io` input kernels, `hi`, `hf`, `hg`, `ho` hidden kernels
with the biases; GRU: `ir`, `iz`, `in` with biases, `hr`, `hz`, and `hn`
with its bias), so engine/from_jax.py bridges them as Dense layers; a step
concatenates them into one (in, 4h) or (in, 3h) product.

Dropout takes its bits from the caller (ops/dropout.py's keep rule; one
int32 pattern per embedding element, `drop_counts`); rate 0.5 doubles a
kept value, exact in every dtype, as flax's `inputs / keep_prob`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.models.layers import l2_normalize
from text_guided_face_recognition_tpu_torch.ops.dropout import dropout

__all__ = ["RNNEncoder", "RNN_GATES", "flip_index", "init_rnn_"]

# each cell's gates in flax's (and torch's chunk) order
RNN_GATES = {"LSTM": ("i", "f", "g", "o"), "GRU": ("r", "z", "n")}


class _Gate(nn.Module):
    """One gate's (out, in) kernel, with or without its bias: flax's
    `DenseParams` / `Dense` under the gate's name."""

    def __init__(self, n_in: int, n_out: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None


class _Cell(nn.Module):
    """One direction's gates under flax's names (see the module
    docstring); `kernels` stacks them per side."""

    def __init__(self, en_type: str, n_in: int, h: int):
        super().__init__()
        lstm = en_type == "LSTM"
        for g in RNN_GATES[en_type]:
            # LSTM: the bias sits on the hidden side; GRU: on the input
            # side, and on the hidden side of n
            self.add_module(f"i{g}", _Gate(n_in, h, bias=not lstm))
            self.add_module(f"h{g}", _Gate(h, h, bias=lstm or g == "n"))

    def kernels(self, side: str, gates) -> torch.Tensor:
        return torch.cat([getattr(self, f"{side}{g}").weight for g in gates])


def flip_index(lens: torch.Tensor, t: int) -> torch.Tensor:
    """(B, T) positions that reverse each row within its length, padding
    reversed after it (flax `flip_sequences`); the map is its own
    inverse."""
    ar = torch.arange(t - 1, -1, -1, device=lens.device)
    return (ar[None, :] + lens[:, None]) % t


class RNNEncoder(nn.Module):
    """forward(captions (B, T) int, cap_lens (B,) int, drop_bits) ->
    (words_emb (B, nhidden, T) f32, sent_emb (B, nhidden) f32)."""

    def __init__(self, vocab_size: int, en_type: str = "LSTM",
                 ninput: int = 300, nhidden: int = 256,
                 drop_prob: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        if en_type not in RNN_GATES:
            raise NotImplementedError(f"en_type={en_type!r}: the RNN encoder "
                                      "is an LSTM or a GRU")
        self.en_type, self.ninput, self.dtype = en_type, ninput, dtype
        self.drop_prob = float(drop_prob)
        self.h = nhidden // 2
        self.encoder = nn.Embedding(vocab_size, ninput)
        self.fwd = _Cell(en_type, ninput, self.h)
        self.bwd = _Cell(en_type, ninput, self.h)

    def drop_counts(self, b: int, t: int) -> Tuple[int, int]:
        """(host bits, kernel seeds) one training forward at (b, t) takes:
        one bit pattern per embedding element, no seed."""
        return (b * t * self.ninput if self.drop_prob > 0.0 else 0), 0

    def _stacked(self):
        """The two directions' kernels (2, in, G h), (2, h, G h) and biases
        rounded to the compute dtype, gates in flax's order."""
        dt = self.dtype
        gates = RNN_GATES[self.en_type]
        cells = (self.fwd, self.bwd)
        wi = torch.stack([c.kernels("i", gates) for c in cells]).to(dt)
        wh = torch.stack([c.kernels("h", gates) for c in cells]).to(dt)
        if self.en_type == "LSTM":
            bi = None
            bh = torch.stack([torch.cat([getattr(c, f"h{g}").bias
                                         for g in gates]) for c in cells])
        else:
            bi = torch.stack([torch.cat([getattr(c, f"i{g}").bias
                                         for g in gates]) for c in cells])
            bh = torch.stack([c.hn.bias for c in cells])
        rounded = [None if b is None else b.to(dt)[:, None, :]
                   for b in (bi, bh)]
        return wi.transpose(1, 2), wh.transpose(1, 2), rounded[0], rounded[1]

    def _lstm(self, xs, wh, bh):
        """The recurrence of both directions: xs (2, B, T, 4h) input
        products, rounded; returns (2, B, T, h) f32 outputs."""
        dt = self.dtype
        _, b, t, _ = xs.shape
        h = torch.zeros(2, b, self.h, dtype=torch.float32, device=xs.device)
        c = torch.zeros_like(h)
        outs = []
        for s in range(t):
            gates = (torch.bmm(h.to(dt), wh) + bh) + xs[:, :, s]
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f.float() * c + (i * g).float()
            h = o.float() * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=2)

    def _gru(self, xs, wh, bhn):
        """The GRU recurrence of both directions: xs (2, B, T, 3h) input
        products with their biases, rounded."""
        dt = self.dtype
        _, b, t, _ = xs.shape
        h = torch.zeros(2, b, self.h, dtype=torch.float32, device=xs.device)
        outs = []
        for s in range(t):
            hr, hz, hn = torch.bmm(h.to(dt), wh).chunk(3, dim=-1)
            xr, xz, xn = xs[:, :, s].chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + bhn))
            h = ((1.0 - z) * n).float() + z.float() * h
            outs.append(h)
        return torch.stack(outs, dim=2)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                drop_bits: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        b, t = captions.shape
        emb = self.encoder(captions.long()).to(dt)              # (B, T, in)
        if self.training and self.drop_prob > 0.0:
            n, _ = self.drop_counts(b, t)
            if drop_bits is None or drop_bits.numel() != n:
                raise ValueError(f"RNNEncoder in train mode takes drop_bits: "
                                 f"{n} int32 bit patterns (ops/dropout.draw)")
            emb = dropout(emb, drop_bits.view(b, t, self.ninput),
                          self.drop_prob)
        lens = cap_lens.long()
        flip = flip_index(lens, t)                              # (B, T)
        rev = torch.gather(emb, 1, flip[:, :, None].expand(b, t, self.ninput))
        wi, wh, bi, bh = self._stacked()
        x2 = torch.stack([emb, rev]).reshape(2, b * t, self.ninput)
        xs = torch.bmm(x2, wi)                                  # rounded
        if bi is not None:
            xs = xs + bi
        xs = xs.reshape(2, b, t, -1)
        out = (self._lstm(xs, wh, bh) if self.en_type == "LSTM"
               else self._gru(xs, wh, bh))                      # (2,B,T,h)
        fwd = out[0]
        bwd = torch.gather(out[1], 1, flip[:, :, None].expand(b, t, self.h))
        idx = torch.clamp_min(lens - 1, 0)[:, None, None].expand(b, 1, self.h)
        sent = torch.cat([torch.gather(fwd, 1, idx)[:, 0], bwd[:, 0]], dim=-1)
        valid = (torch.arange(t, device=lens.device)[None, :]
                 < lens[:, None])[..., None]
        output = torch.where(valid, torch.cat([fwd, bwd], dim=-1),
                             torch.zeros((), device=fwd.device))
        words_emb = output.transpose(1, 2)                      # (B, 2h, T)
        return words_emb, l2_normalize(sent, dim=-1)


def init_rnn_(module: RNNEncoder, gen: torch.Generator) -> RNNEncoder:
    """flax's initialisers from `gen`: the embedding U[0, 0.1), input
    kernels lecun normal, hidden kernels orthogonal, biases 0."""
    with torch.no_grad():
        module.encoder.weight.copy_(
            torch.rand(module.encoder.weight.shape, generator=gen) * 0.1)
        for cell in (module.fwd, module.bwd):
            for name, gate in cell.named_children():
                w = gate.weight
                if name.startswith("i"):
                    w.copy_(torch.randn(w.shape, generator=gen)
                            / math.sqrt(w.shape[1]))
                else:
                    q, r = torch.linalg.qr(torch.randn(w.shape, generator=gen))
                    w.copy_(q * torch.sign(torch.diagonal(r))[None, :])
                if gate.bias is not None:
                    gate.bias.zero_()
    return module
