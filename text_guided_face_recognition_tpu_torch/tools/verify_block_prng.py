"""Verification of the fused-block kernels' in-kernel dropout (prng mode).

  python -m text_guided_face_recognition_tpu_torch.tools.verify_block_prng \
      [--cpu] [--batch 32] [--words 24] [--layers 12] [--hidden 768] \
      [--heads 12] [--intermediate 3072] [--rate 0.1]

Counterpart of tools/verify_block_prng.py, which checks the Mosaic PRNG
mode of the JAX package's kernels on a TPU. Here, on the CUDA card (or on
the CPU with --cpu, where the kernels' plain versions run), for the FFN
half-layer (K3/K4), the attention half-layer (K5/K6) and the whole tower
(K7/K8), in float32 and bfloat16, at full width by default (the tower at
12 layers of H 768, which the card has the memory for):

  1. determinism: the same seed twice gives identical values and gradients;
  2. different seeds give different outputs;
  3. the attention and FFN streams of one seed differ (and the tower's
     layers draw different streams);
  4. prng mode equals host mode fed the dump of the same seed (K10, K11,
     K12), values and every gradient, bit for bit;
  5. a wrong-seed control: the backward run under another seed gives other
     gradients than the true ones, so check 4 can see a mask mismatch;
  6. the kept share of each site is within 5 sigma of 1 - rate;
and K10-K12 equal their plain versions bit for bit. Prints one line per
check and a JSON report; exits 1 on the first failure.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List

import torch

from text_guided_face_recognition_tpu_torch.ops import block, philox
from text_guided_face_recognition_tpu_torch.ops.dropout import keep_mask

EPS = 1e-12
SIGMAS = 5.0


def _kept_share(name: str, bits: torch.Tensor, rate: float) -> dict:
    """The share of kept elements against 1 - rate, in standard errors."""
    n = bits.numel()
    share = keep_mask(bits, rate).float().mean().item()
    sigma = math.sqrt(rate * (1.0 - rate) / n)
    z = abs(share - (1.0 - rate)) / sigma
    if z > SIGMAS:
        raise AssertionError(f"{name}: kept share {share} is {z:.2f} sigma "
                             f"from {1.0 - rate} over {n} elements")
    return {"kept": share, "sigma_from_expected": z, "elements": n}


def _equal(name: str, a, b) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: output {i} differs")


def _differs(name: str, a, b) -> None:
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: identical, the check cannot see a "
                             "change of seed")


class _Case:
    """One kernel pair's runs: `run(seed=..., bits=...)` gives (output,
    *gradients) for the cotangent dz; `bwd(fwd_seed, seed)` the gradients
    from the residuals of a forward under fwd_seed, the backward under
    seed (the wrong-seed control); `dump(seed)` the host bits of the
    seed's stream (K10-K12) and `dump_ref(seed)` their plain version."""

    def __init__(self, name, run, bwd, dump, dump_ref, sites):
        self.name, self.run, self.bwd = name, run, bwd
        self.dump, self.dump_ref, self.sites = dump, dump_ref, sites


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def _cases(dev, dt, b, t, h, heads, inter, layers, rate, gen):
    """The FFN, attention and tower cases at one activation dtype."""
    r = b * t

    def rn(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen)).to(dev)

    x = rn(r, h).to(dt)
    dz = rn(r, h).to(dt)
    lens = torch.randint(2, t + 1, (b,), generator=gen)
    lens[0] = t
    mask = (torch.arange(t)[None, :] < lens[:, None]).to(
        dev, torch.int32).contiguous()
    # f32 masters in nn.Linear's (out, in) layout; the kernels take .t()
    wqkv, bqkv = rn(3 * h, h, std=h ** -0.5), rn(3 * h, std=0.1)
    wo, bo = rn(h, h, std=h ** -0.5), rn(h, std=0.1)
    w1, c1 = rn(inter, h, std=h ** -0.5), rn(inter, std=0.1)
    w2, c2 = rn(h, inter, std=inter ** -0.5), rn(h, std=0.1)
    g, be = rn(h, std=0.1, mean=1.0), rn(h, std=0.1)

    def ffn_run(seed=None, bits=None):
        ins = [_leaf(a) for a in (x, w1, c1, w2, c2, g, be)]
        z = block.ffn_block(ins[0], ins[1].t(), ins[2], ins[3].t(), *ins[4:],
                            rate, EPS, bits=bits, seed=seed)
        return (z, *torch.autograd.grad(z, ins, dz))

    def ffn_bwd(fwd_seed, seed):
        _, f, act, res = block.ffn_block_fwd(x, w1.t(), c1, w2.t(), c2, g, be,
                                             None, rate, EPS, seed=fwd_seed)
        return block.ffn_block_bwd(dz, x, f, act, res, w1.t(), w2.t(), g,
                                   None, rate, EPS, seed=seed)

    def attn_run(seed=None, bits=None):
        bp, bh = bits if bits is not None else (None, None)
        ins = [_leaf(a) for a in (x, wqkv, bqkv, wo, bo, g, be)]
        y = block.attn_block(ins[0], mask, ins[1].t(), ins[2], ins[3].t(),
                             *ins[4:], b, t, heads, rate, EPS, bp, bh, seed)
        return (y, *torch.autograd.grad(y, ins, dz))

    def attn_bwd(fwd_seed, seed):
        _, qkv, p, o, res = block.attn_block_fwd(
            x, mask, wqkv.t(), bqkv, wo.t(), bo, g, be, b, t, heads, None,
            None, rate, EPS, seed=fwd_seed)
        return block.attn_block_bwd(dz, x, qkv, p, o, res, wqkv.t(), wo.t(),
                                    g, b, t, heads, None, None, rate, EPS,
                                    seed=seed)

    # the tower's leaves stacked and cast, weights (L, out, in) viewed
    # (L, in, out), as the model hands them over
    st = dict(
        wqkv=rn(layers, 3 * h, h, std=h ** -0.5),
        bqkv=rn(layers, 1, 3 * h, std=0.1), wo=rn(layers, h, h, std=h ** -0.5),
        bo=rn(layers, 1, h, std=0.1), g1=rn(layers, 1, h, std=0.1, mean=1.0),
        b1=rn(layers, 1, h, std=0.1), w1=rn(layers, inter, h, std=h ** -0.5),
        c1=rn(layers, 1, inter, std=0.1),
        w2=rn(layers, h, inter, std=inter ** -0.5),
        c2=rn(layers, 1, h, std=0.1), g2=rn(layers, 1, h, std=0.1, mean=1.0),
        b2=rn(layers, 1, h, std=0.1))
    st = {k: v.to(dt) for k, v in st.items()}

    def view(k, a):
        return a.transpose(1, 2) if k.startswith("w") else a

    def tower_run(seed=None, bits=None):
        bp, bh, bf = bits if bits is not None else (None, None, None)
        ins = [_leaf(x)] + [_leaf(st[k]) for k in block.TOWER_LEAVES]
        lv = [view(k, a) for k, a in zip(block.TOWER_LEAVES, ins[1:])]
        z = block.tower_block(ins[0], mask, *lv, b, t, heads, rate, EPS, bp,
                              bh, bf, seed)
        return (z, *torch.autograd.grad(z, ins, dz))

    def tower_bwd(fwd_seed, seed):
        lv = {k: view(k, st[k]) for k in block.TOWER_LEAVES}
        _, *res = block.tower_block_fwd(x, mask, *lv.values(), b, t, heads,
                                        rate=rate, eps=EPS, seed=fwd_seed)
        return block.tower_block_bwd(
            dz, mask, *res, *(lv[k] for k in ("wqkv", "wo", "g1", "b1", "w1",
                                              "w2", "g2")),
            b, t, heads, rate=rate, eps=EPS, seed=seed)

    return [
        _Case("ffn", ffn_run, ffn_bwd,
              lambda s: philox.ffn_stream_bits(s, r, h),
              lambda s: philox.ffn_stream_bits_ref(s, r, h), ("f",)),
        _Case("attn", attn_run, attn_bwd,
              lambda s: philox.attn_stream_bits(s, b, t, h, heads),
              lambda s: philox.attn_stream_bits_ref(s, b, t, h, heads),
              ("p", "h")),
        _Case("tower", tower_run, tower_bwd,
              lambda s: philox.tower_stream_bits(s, layers, b, t, h, heads),
              lambda s: philox.tower_stream_bits_ref(s, layers, b, t, h,
                                                     heads),
              ("p", "h", "f")),
    ]


def verify(device, b: int = 32, t: int = 24, h: int = 768, heads: int = 12,
           inter: int = 3072, layers: int = 12, rate: float = 0.1,
           dtypes=(torch.float32, torch.bfloat16), seeds=(1234, 777),
           log=print) -> Dict[str, dict]:
    """Run every check; raise AssertionError on the first failure. Returns
    the report {case: {dtype: {check: value}}, "dumps": {...}}."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    sa, sb = (torch.tensor([s], dtype=torch.int32, device=dev)
              for s in seeds)
    report: Dict[str, dict] = {"shape": dict(
        b=b, t=t, h=h, heads=heads, inter=inter, layers=layers, rate=rate,
        device=str(dev))}
    for dt in dtypes:
        tag = str(dt).replace("torch.", "")
        for case in _cases(dev, dt, b, t, h, heads, inter, layers, rate,
                           gen):
            out: Dict[str, object] = {}
            got = case.run(seed=sa)
            _equal(f"{case.name} {tag} determinism", got, case.run(seed=sa))
            _differs(f"{case.name} {tag} seeds {seeds}", got,
                     case.run(seed=sb))
            bits = case.dump(sa)
            bits = bits if isinstance(bits, tuple) else (bits,)
            _equal(f"{case.name} {tag} prng mode vs host mode fed the dump",
                   got, case.run(bits=bits if len(bits) > 1 else bits[0]))
            _differs(f"{case.name} {tag} wrong-seed backward",
                     case.bwd(sa, sa), case.bwd(sa, sb))
            if dt == dtypes[0]:
                ref = case.dump_ref(sa)
                ref = ref if isinstance(ref, tuple) else (ref,)
                _equal(f"{case.name} dump vs its plain version", bits, ref)
                out["kept"] = {s: _kept_share(f"{case.name} site {s}", a,
                                              rate)
                               for s, a in zip(case.sites, bits)}
            out.update(determinism=True, seeds_differ=True,
                       prng_equals_host=True, wrong_seed_differs=True,
                       outputs=len(got))
            report.setdefault(case.name, {})[tag] = out
            log(f"verify_block_prng: {case.name} {tag}: determinism, seeds "
                f"differ, prng == host fed the dump ({len(got)} outputs, bit "
                "for bit), wrong-seed backward differs: PASS")
    # the attention and FFN streams of one seed, and the tower's layers
    attn_h = philox.attn_stream_bits(sa, b, t, h, heads)[1]
    if torch.equal(attn_h, philox.ffn_stream_bits(sa, b * t, h)):
        raise AssertionError("the attention and FFN streams of one seed are "
                             "the same")
    tower_h = philox.tower_stream_bits(sa, 2, b, t, h, heads)[1]
    if torch.equal(tower_h[0], tower_h[1]):
        raise AssertionError("the tower's layers 0 and 1 draw one stream")
    report["streams_differ"] = True
    log("verify_block_prng: attention / FFN streams and tower layers "
        "differ; dumps equal their plain versions: PASS")
    return report


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--words", type=int, default=24)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--intermediate", type=int, default=3072)
    ap.add_argument("--rate", type=float, default=0.1)
    a = ap.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        print("verify_block_prng: CUDA is not available; pass --cpu to run "
              "the plain versions", file=sys.stderr)
        return 1
    if not a.cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        report = verify("cpu" if a.cpu else "cuda", a.batch, a.words,
                        a.hidden, a.heads, a.intermediate, a.layers, a.rate)
    except AssertionError as e:
        print(f"verify_block_prng: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report))
    print("verify_block_prng: ALL PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
