#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

  python3 chip_smoke.py [--only kernels|serving|train]

Phases, in order; any failure raises and the script exits non-zero:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes (R = 768 token rows of B = 32 captions x
     T = 24, H = 768, 12 heads, I = 3072; ragged key masks from the
     synthetic captions; weights passed as the model passes them, the .t()
     view of an (out, in) nn.Linear weight; dropout 0.1 from int32 bits
     drawn on the card; DAMSM words (32, 256, 22) and regions
     (32, 256, 196), l2-normalised over features as the heads make them),
     in bf16 and f32 (K9: f32), then timed beside its plain version, a
     one-call library equivalent where PyTorch has one, and its bound on
     the card. A time is the device time per call of a CUDA graph of
     back-to-back calls (no host work in the timed span), with a warm L2
     (`ms`) and with the L2 flushed before each call (`ms_cold_l2`: a
     graph of flush + call less a graph of the flushes). K3 and K5 are
     held and timed twice: serving (rate 0, no residuals) and train mode
     (rate 0.1, the residuals the backward reads, `*_train` keys);
  4. serving at full width in bf16 (bert-base 12 layers, iresnet18 at
     112x112, ImageHeading, FCFM 640; random weights from manual_seed;
     synthetic test split; batch 32; fused_block=both, fused_ln=true):
     run_test in pair mode, then extract_embeddings, with every kernel's
     launch count zeroed before and read after; then one pair batch with
     the kernels off (plain PyTorch modules on the card) against the same
     batch with them on, and the time of a pair batch either way;
  5. stage-1 training at full width in bf16 (bert-base, iresnet18 at
     112x112, batch 32, num_classes 4500, fused_block=both, fused_ln,
     use_pallas, dropout 0.1, Adam moments bf16, synthetic train split):
     the CLI (cli/train_encoders_bert.py: one epoch of 2 steps, its
     checkpoints written and removed again) with every count zeroed before
     and read after; then 20 steps on one fixed batch (counts per step,
     a finite loss that falls); one step's loss and gradients with the
     kernels on against off, from the same weights and the same dropout
     bits, and once more with a planted K6 fault that the comparison must
     catch; the step time either way and the step's device-time split.
The last two lines are the `kernels` JSON line and the result line.

Tolerances. Kernel against plain version, forward outputs:
|k - p| <= atol + rtol |p| with rtol = atol = 2e-2 in bf16 (1 bf16 ulp at
|x| < 8 is <= 2^-5; the two sum in different orders and may round the
other way) and 1e-4 in f32, with TF32 off for matmuls and convolutions so
the plain f32 version is full f32. Backward outputs (K2, K4, K6):
max |k - p| <= tol max(1, max |p|), tol 2e-2 in bf16 and 1e-4 in f32, per
output: the weight and bias gradients are f32 sums over 768 rows whose
rounded bf16 terms may each differ by one ulp between the two, so the
error scales with the gradient's magnitude, not element by element. K9
(f32): |k - p| <= 1e-4 + 1e-4 |p|. Kernels on against off: serving pair
scores 2e-2 (bf16 rounding differences carried through 12 layers and a
640-d cosine). One training step, from the same weights and dropout bits,
in the trainer's bf16 and again in f32: the loss within 1e-2 (bf16) /
1e-5 (f32) relative; and per top-level module (image_head, text_encoder,
text_head, image_cls, text_cls) its gradients as one vector within
||g_on - g_off|| <= 0.25 (bf16) / 1e-4 (f32) ||g_off||, and each of its
parameters within max |g_on - g_off| <= 0.5 (bf16) / 1e-3 (f32)
(max |g_off| + k G), G the largest gradient element of the model, k 1e-3
(bf16) / 1e-6 (f32). The k G term holds gradients that are zero in exact
arithmetic, like the query bias of IMIM's softmax over queries, to their
rounding noise. The bf16 limits leave room for the text head, whose
gradients differ most (its elementwise max over three window
convolutions and its max over positions route each element's gradient
to one winner, and a bf16 rounding in the tower below can change the
winner), and they fail a planted fault: the same bf16 step with K6 handed
all-keep bits for the attention probabilities, which the script runs
after the real comparison and which must fail it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SCORE_TOL = 2e-2
# kernels on against off, one training step (see the docstring)
ON_OFF_TOL = {"bfloat16": {"loss": 1e-2, "l2": 0.25, "max": 0.5,
                           "floor": 1e-3},
              "float32": {"loss": 1e-5, "l2": 1e-4, "max": 1e-3,
                          "floor": 1e-6}}
RATE = 0.1
TRAIN_STEPS = 20


def _graph_ms(fn, calls: int = 20, reps: int = 9) -> float:
    """Device ms per call: one CUDA graph of `calls` back-to-back calls of
    fn, replayed `reps` times between two CUDA events; the median replay
    over `calls`. The graph leaves the host's launch work out of the span."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _times(fn, flush, flush_ms: float) -> tuple:
    """(warm-L2 ms, cold-L2 ms) per call of fn; the cold time is a graph
    of flush + call less `flush_ms`, the graph of the flushes alone."""
    def cold():
        flush()
        fn()
    return _graph_ms(fn), _graph_ms(cold) - flush_ms


def _close(a, b, tol: float):
    """(max |a - b|, whether |a - b| <= tol + tol |b| everywhere)."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return err.max().item(), bool((err <= tol + tol * b.abs()).all())


def _close_scaled(a, b, tol: float):
    """(max |a - b|, whether max |a - b| <= tol max(1, max |b|))."""
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    return err, err <= tol * max(1.0, b.abs().max().item())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take for the call: the larger of its
    bytes (each input read once, each output written once) over HBM rate
    and its operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _bounds(b, t, h, heads, inter, es, d_words, t_words, r_regions):
    """Bounds per kernel, from the shapes and the element size es of the
    activations; dropout bits count 4 bytes an element where the call
    reads them (train mode)."""
    r = b * t
    act = r * h * es                      # one (R, H) activation
    p_el = heads * b * t * t
    d = h // heads
    attn_core = 4.0 * b * heads * t * t * d
    attn_w = 4 * (4 * h * h + 3 * h + 3 * h)      # wqkv, wo, biases, LN
    ffn_w = 4 * (2 * h * inter + inter + 3 * h)
    out = {
        "layernorm_fused": _bound(2 * act + 2 * h * 4, 8.0 * r * h, "f32"),
        "layernorm_bwd": _bound(3 * act + 3 * h * 4, 12.0 * r * h, "f32"),
        "ffn_block": _bound(2 * act + ffn_w, 4.0 * r * h * inter,
                            "bf16_tensor"),
        "attn_block": _bound(2 * act + 4 * b * t + attn_w,
                             2.0 * r * h * 4 * h + attn_core,
                             "bf16_tensor"),
        # in: dz, x, r, f, w1, w2, gamma, bits; out: dx, dw1, dw2, biases
        "ffn_block_bwd": _bound(
            4 * act + r * inter * es + 4 * (4 * h * inter + inter + 4 * h)
            + 4 * r * h, 8.0 * r * h * inter, "bf16_tensor"),
        # in: dy, x, o, r, qkv, p, wqkv, wo, gamma, bits; out: dx, dW, db
        "attn_block_bwd": _bound(
            8 * act + p_el * es + 4 * (8 * h * h + 6 * h) + 4 * (p_el + r * h),
            2.0 * r * h * 8 * h + 2 * attn_core, "bf16_tensor"),
        "damsm_similarity": _bound(
            4 * (b * d_words * (t_words + r_regions) + b * b),
            4.0 * b * b * r_regions * t_words * d_words, "f32"),
    }
    # train-mode forwards: + bits in, + residuals out (f, r / qkv, p, o, r)
    out["ffn_block_train"] = _bound(
        3 * act + r * inter * es + ffn_w + 4 * r * h, 4.0 * r * h * inter,
        "bf16_tensor")
    out["attn_block_train"] = _bound(
        6 * act + p_el * es + 4 * b * t + attn_w + 4 * (p_el + r * h),
        2.0 * r * h * 4 * h + attn_core, "bf16_tensor")
    return out


SRC = "text_guided_face_recognition_tpu_torch/csrc/"
JAX = "text_guided_face_recognition_tpu/ops/"


def kernel_phase(args):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.engine.prepare import (
        _synthetic_bert)
    from text_guided_face_recognition_tpu_torch.ops import (
        attention, block, damsm, layernorm)
    from text_guided_face_recognition_tpu_torch.ops.dropout import draw

    dev = torch.device("cuda")
    B, T, H, heads, I = 32, args.bert_words_num, 768, 12, 3072
    R = B * T
    D, TW, RG = args.aux_feat_dim_per_granularity, T - 2, (
        args.img_size // 8) ** 2
    eps = 1e-12
    _, _, masks = _synthetic_bert(args, B)
    mask = torch.from_numpy(np.stack(masks[::args.captions_per_image][:B]))
    mask = mask.to(dev, torch.int32).contiguous()
    gen = torch.Generator().manual_seed(args.manual_seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x32, dy32 = rn(R, H), rn(R, H)
    ln_g, ln_b = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    # weights (in, out) as the .t() view of (out, in), as the model has them
    wqkv, bqkv = rn(3 * H, H, std=H ** -0.5).t(), rn(3 * H, std=0.1)
    wo, bo = rn(H, H, std=H ** -0.5).t(), rn(H, std=0.1)
    w1, c1 = rn(I, H, std=H ** -0.5).t(), rn(I, std=0.1)
    w2, c2 = rn(H, I, std=I ** -0.5).t(), rn(H, std=0.1)
    dgen = torch.Generator(device=dev).manual_seed(args.manual_seed + 1)
    bits_p = draw(heads * B * T * T, dgen, dev).view(heads * B, T, T)
    bits_h = draw(R * H, dgen, dev).view(R, H)
    bits_f = draw(R * H, dgen, dev).view(R, H)
    words = F.normalize(rn(B, D, TW), dim=1).contiguous()
    regions = F.normalize(rn(B, D, RG), dim=1).contiguous()
    # the library calls take their affine in the input dtype
    ln_g_bf16, ln_b_bf16 = ln_g.bfloat16(), ln_b.bfloat16()
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    flush_ms = _graph_ms(flush)
    attn_w = (wqkv, bqkv, wo, bo, ln_g, ln_b)
    ffn_w = (w1, c1, w2, c2, ln_g, ln_b)

    def ln_library(x, dy):
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            x, [H], ln_g_bf16, ln_b_bf16, eps)
        return lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [H], mean, rstd, ln_g_bf16, ln_b_bf16, [True, True, True])

    # per kernel: run(x) and ref(x) give tuples compared output by output
    specs = [
        dict(name="layernorm_fused", fn=layernorm.layernorm_fused,
             source=SRC + "layernorm.cu",
             replaces=JAX + "layernorm_pallas.py:103",
             run=lambda x: (layernorm.layernorm_fused(x, ln_g, ln_b, eps),),
             ref=lambda x: (layernorm.layernorm_ref(x, ln_g, ln_b, eps),),
             library=lambda x: lambda: F.layer_norm(x, (H,), ln_g_bf16,
                                                    ln_b_bf16, eps)),
        dict(name="layernorm_bwd", fn=layernorm.layernorm_bwd, bwd=True,
             source=SRC + "layernorm.cu",
             replaces=JAX + "layernorm_pallas.py:120",
             run=lambda x: layernorm.layernorm_bwd(dy32.to(x.dtype), x, ln_g,
                                                   eps),
             ref=lambda x: layernorm.layernorm_bwd_ref(dy32.to(x.dtype), x,
                                                       ln_g, eps),
             library=lambda x: ln_library(x, dy32.to(x.dtype))),
        dict(name="attn_block", fn=block.attn_block,
             source=SRC + "attn_block.cu",
             replaces=JAX + "block_pallas.py:626",
             run=lambda x: (block.attn_block(x, mask, *attn_w, B, T, heads,
                                             0.0, eps),),
             ref=lambda x: (block.attn_block_ref(x, mask, *attn_w, B, T,
                                                 heads, 0.0, eps),),
             train_run=lambda x: block.attn_block_fwd(
                 x, mask, *attn_w, B, T, heads, bits_p, bits_h, RATE, eps),
             train_ref=lambda x: block.attn_block_fwd_ref(
                 x, mask, *attn_w, B, T, heads, bits_p, bits_h, RATE, eps)),
        dict(name="attn_block_bwd", fn=block.attn_block_bwd, bwd=True,
             source=SRC + "attn_block.cu",
             replaces=JAX + "block_pallas.py:650",
             res=lambda x: block.attn_block_fwd_ref(
                 x, mask, *attn_w, B, T, heads, bits_p, bits_h, RATE, eps),
             run=lambda x, res: block.attn_block_bwd(
                 dy32.to(x.dtype), x, *res[1:], wqkv, wo, ln_g, B, T, heads,
                 bits_p, bits_h, RATE, eps),
             ref=lambda x, res: block.attn_block_bwd_ref(
                 dy32.to(x.dtype), x, *res[1:], wqkv, wo, ln_g, B, T, heads,
                 bits_p, bits_h, RATE, eps)),
        dict(name="ffn_block", fn=block.ffn_block,
             source=SRC + "ffn_block.cu",
             replaces=JAX + "block_pallas.py:331",
             run=lambda x: (block.ffn_block(x, *ffn_w, 0.0, eps),),
             ref=lambda x: (block.ffn_block_ref(x, *ffn_w, 0.0, eps),),
             train_run=lambda x: block.ffn_block_fwd(x, *ffn_w, bits_f,
                                                     RATE, eps),
             train_ref=lambda x: block.ffn_block_fwd_ref(x, *ffn_w, bits_f,
                                                         RATE, eps)),
        dict(name="ffn_block_bwd", fn=block.ffn_block_bwd, bwd=True,
             source=SRC + "ffn_block.cu",
             replaces=JAX + "block_pallas.py:375",
             res=lambda x: block.ffn_block_fwd_ref(x, *ffn_w, bits_f, RATE,
                                                   eps),
             run=lambda x, res: block.ffn_block_bwd(
                 dy32.to(x.dtype), x, res[1], res[2], res[3], w1, w2, ln_g,
                 bits_f, RATE, eps),
             ref=lambda x, res: block.ffn_block_bwd_ref(
                 dy32.to(x.dtype), x, res[1], res[3], w1, w2, ln_g, bits_f,
                 RATE, eps)),
        dict(name="damsm_similarity", fn=damsm.damsm_similarity_cuda,
             source=SRC + "damsm.cu",
             replaces=JAX + "damsm_pallas.py:115", dtypes=(torch.float32,),
             run=lambda x: (damsm.damsm_similarity_cuda(words, regions, 4.0,
                                                        5.0),),
             ref=lambda x: (attention.damsm_similarity(words, regions, 4.0,
                                                       5.0),)),
    ]
    bounds = _bounds(B, T, H, heads, I, 2, D, TW, RG)
    rows = []
    for s in specs:
        row = {"name": s["name"], "route": "cuda", "source": s["source"],
               "replaces": s["replaces"]}
        check = _close_scaled if s.get("bwd") else _close
        dtypes = s.get("dtypes", (torch.bfloat16, torch.float32))
        for dt in dtypes:
            x = x32.to(dt)
            tol = TOL[str(dt)[6:]]
            tag = "" if dt == dtypes[0] else "_f32"
            if "res" in s:
                res = s["res"](x)
                run, ref = (lambda f=s["run"], r=res: lambda x: f(x, r))(), \
                    (lambda f=s["ref"], r=res: lambda x: f(x, r))()
            else:
                run, ref = s["run"], s["ref"]
            errs = []
            for k, (o, p) in enumerate(zip(run(x), ref(x))):
                torch.cuda.synchronize()
                err, ok = check(o, p, tol)
                errs.append(err)
                if not ok:
                    raise AssertionError(
                        f"{s['name']} {dt} output {k}: kernel disagrees with "
                        f"its plain version (max |err| {err})")
            row[f"max_abs_err{tag}"] = max(errs)
            row[f"tolerance{tag}"] = {"rtol": tol, "atol": tol,
                                      "scaled": bool(s.get("bwd"))}
            if "train_run" in s:
                errs = []
                for k, (o, p) in enumerate(zip(s["train_run"](x),
                                               s["train_ref"](x))):
                    torch.cuda.synchronize()
                    err, ok = _close(o, p, tol)
                    errs.append(err)
                    if not ok:
                        raise AssertionError(
                            f"{s['name']} train {dt} output {k}: kernel "
                            f"disagrees with its plain version ({err})")
                row[f"max_abs_err_train{tag}"] = max(errs)
        x = x32.to(dtypes[0])
        if "res" in s:
            res = s["res"](x)
            run = (lambda f=s["run"], r=res: lambda: f(x, r))()
            ref = (lambda f=s["ref"], r=res: lambda: f(x, r))()
        else:
            run = (lambda f=s["run"]: lambda: f(x))()
            ref = (lambda f=s["ref"]: lambda: f(x))()
        row["ms"], row["ms_cold_l2"] = _times(run, flush, flush_ms)
        row["kernel_ms"] = row["ms"]
        row["plain_ms"], row["plain_ms_cold_l2"] = _times(ref, flush,
                                                          flush_ms)
        lib = s.get("library")
        row["library_ms"], row["library_ms_cold_l2"] = (
            (None, None) if lib is None else _times(lib(x), flush, flush_ms))
        row.update(bounds[s["name"]])
        if "train_run" in s:
            tr = (lambda f=s["train_run"]: lambda: f(x))()
            tp = (lambda f=s["train_ref"]: lambda: f(x))()
            row["ms_train"], row["ms_train_cold_l2"] = _times(tr, flush,
                                                              flush_ms)
            row["plain_ms_train"], _ = _times(tp, flush, flush_ms)
            b = bounds[s["name"] + "_train"]
            row["bound_ms_train"], row["bound_by_train"] = (b["bound_ms"],
                                                            b["bound_by"])
        rows.append(row)
        print(f"kernel {row['name']}: max|err| {row['max_abs_err']:.3g}"
              f"{'' if 'max_abs_err_f32' not in row else ', f32 %.3g' % row['max_abs_err_f32']}"
              f"; {row['ms']:.4f} ms, cold L2 {row['ms_cold_l2']:.4f} "
              f"(plain {row['plain_ms']:.4f}, library {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} by {row['bound_by']})"
              + ("" if "ms_train" not in row else
                 f"; train {row['ms_train']:.4f} ms (plain "
                 f"{row['plain_ms_train']:.4f}, bound "
                 f"{row['bound_ms_train']:.4f})"), flush=True)
    return rows


def _profile(step, reps: int = 3, what: str = "pair batch") -> dict:
    """Device time and the kernels that take it over `reps` calls of step,
    from torch.profiler. The busy share is device time over the wall time
    under the profiler, which slows the host: it is not the share of an
    unprofiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a user annotation (torch.optim's `Optimizer.step#...` range) spans the
    # kernels it encloses and the gaps between them: it is not device time
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev)
    if not busy_us:
        return {"device_busy_share_profiled": "not measured"}

    def group(name):
        for key in ("gemm_kernel", "attention_core_bwd", "attention_core",
                    "layernorm_bwd_rows", "layernorm_rows", "colsum",
                    "damsm_kernel"):
            if key in name:
                return "port kernels: " + key
        return "other: " + name[:60]

    by_group = {}
    for e in dev:
        g = group(e.key)
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total
    top = sorted(by_group.items(), key=lambda kv: -kv[1])[:12]
    return {what + "es" if what.endswith("batch") else what + "s": reps,
            "wall_ms_per_call": wall_us / reps / 1e3,
            "device_ms_per_call": busy_us / reps / 1e3,
            "device_busy_share_profiled": busy_us / wall_us,
            "top_ms_per_call": {k: v / reps / 1e3 for k, v in top}}


def _counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _zero(kernels):
    for fn in kernels.values():
        fn.launches = 0


def slice_phase(args, kernels):
    """The serving path at full width; returns the per-kernel launch counts
    of the path and prints its metrics."""
    import numpy as np
    import torch

    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        pair_scores, run_test)
    from text_guided_face_recognition_tpu_torch.engine.extract import (
        extract_embeddings)

    dev = prep.resolve_device(False)
    test_dl, test_ds = prep.prepare_dataloader(args, "test")
    text_encoder, text_head = prep.prepare_text_encoder(args, dev)
    backbone = prep.prepare_backbone(args, dev)
    image_head = prep.prepare_image_head(args, dev)
    fusion_net = prep.prepare_fusion_net(args, dev)
    n_batches = len(test_dl)

    _zero(kernels)
    t0 = time.perf_counter()
    metrics = run_test(args, test_dl, backbone, image_head, fusion_net,
                       text_encoder, text_head)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    after_test = _counts(kernels)
    t0 = time.perf_counter()
    emb = extract_embeddings(args, "test", device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    total = _counts(kernels)
    layers = text_encoder.model.arch.layers

    expected_test = {k: 0 for k in kernels}
    expected_test.update({"layernorm_fused": 2 * n_batches,
                          "attn_block": 2 * layers * n_batches,
                          "ffn_block": 2 * layers * n_batches})
    n_emb = math.ceil(len(emb["keys"]) / args.batch_size)
    expected_extract = {k: 0 for k in kernels}
    expected_extract.update({"layernorm_fused": n_emb,
                             "attn_block": layers * n_emb,
                             "ffn_block": layers * n_emb})
    got_extract = {k: total[k] - after_test[k] for k in total}
    print(f"serving: run_test {n_batches} pair batches in {t_test:.3f} s, "
          f"launches {after_test}; extract {len(emb['keys'])} samples in "
          f"{t_extract:.3f} s, launches {got_extract}")
    if after_test != expected_test or got_extract != expected_extract:
        raise AssertionError(
            f"launch counts {after_test} / {got_extract} != expected "
            f"{expected_test} / {expected_extract}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    e = emb["embeddings"]
    if e.shape != (len(test_ds.filenames), args.fusion_final_dim) or \
            not np.isfinite(e).all():
        raise AssertionError(f"embeddings: shape {e.shape} or non-finite")

    # the same pair batch with the kernels off: plain modules on the card
    off = args.replace(fused_block="none", fused_ln=False)
    te_off, th_off = prep.prepare_text_encoder(off, dev)
    te_off.load_state_dict(text_encoder.state_dict())
    th_off.load_state_dict(text_head.state_dict())
    batch = next(iter(test_dl))
    cols = [batch[k] for k in ("img1", "img2", "cap1", "cap2", "mask1",
                               "mask2")]

    def run(te, th):
        return pair_scores(args, backbone, image_head, fusion_net, te, th,
                           *cols)

    s_on, s_off = run(text_encoder, text_head), run(te_off, th_off)
    diff = (s_on.float() - s_off.float()).abs().max().item()
    print(f"serving: kernels on vs off, one pair batch: max |score diff| "
          f"{diff:.6g} (tolerance {SCORE_TOL})")
    if not diff <= SCORE_TOL:
        raise AssertionError(f"kernels on/off scores differ by {diff}")
    ms_on, ms_off = [], []
    for _ in range(5):  # in turns: on, off, off, on
        for te, th, acc in ((text_encoder, text_head, ms_on),
                            (te_off, th_off, ms_off),
                            (te_off, th_off, ms_off),
                            (text_encoder, text_head, ms_on)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(te, th)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
    profile = _profile(lambda: run(text_encoder, text_head))
    print("serving profile: " + json.dumps(profile))
    print("serving: " + json.dumps({
        "metrics": metrics, "ms_per_pair_batch_kernels_on":
        statistics.median(ms_on), "ms_per_pair_batch_kernels_off":
        statistics.median(ms_off), "score_diff_on_off": diff,
        "pair_batches": n_batches, "batch_size": args.batch_size}))
    return total


def _twin(trainer, state, **changes):
    """Another trainer of `trainer`'s configuration with `changes`, holding
    the weights (and BN statistics) `state`."""
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    tw = Stage1Trainer(trainer.args.replace(**changes), trainer.device)
    tw.model.load_state_dict(state)
    return tw


def _grads(on, off, batch, bits) -> tuple:
    """One step's loss and gradients (no update) from two trainers holding
    the same weights, on the same batch and dropout bits: (loss_on,
    loss_off, per parameter (name, max |d|, max |g_off|, ||d||^2,
    ||g_off||^2)) with d = g_on - g_off."""
    loss_on, _ = on.compute_grads(batch, bits)
    loss_off, _ = off.compute_grads(batch, bits)
    offp = dict(off.model.named_parameters())
    stats = []
    for name, p in on.model.named_parameters():
        q = offp[name]
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"{name}: a gradient on one side only")
        if p.grad is not None:
            a, c = p.grad.float(), q.grad.float()
            d = a - c
            stats.append((name, d.abs().max().item(), c.abs().max().item(),
                          d.square().sum().item(), c.square().sum().item()))
    return float(loss_on), float(loss_off), stats


def _on_off(on, off, batch, bits, floor: float) -> dict:
    """Kernels on against off for one step (`_grads`), summed per
    top-level module (image_head, text_encoder, text_head, image_cls,
    text_cls): l2 = ||g_on - g_off|| / ||g_off|| over the module, and max,
    the largest over its parameters of max |g_on - g_off| / (max |g_off| +
    floor G), G the largest gradient element of the model."""
    loss_on, loss_off, stats = _grads(on, off, batch, bits)
    big = max(s[2] for s in stats)
    groups = {}
    for name, dmax, cmax, d2, c2 in stats:
        g = groups.setdefault(name.split(".")[0],
                              {"d2": 0.0, "c2": 0.0, "max": 0.0, "max_at": ""})
        g["d2"] += d2
        g["c2"] += c2
        rel = dmax / (cmax + floor * big)
        if rel > g["max"]:
            g["max"], g["max_at"] = rel, name
    for g in groups.values():
        d2, c2 = g.pop("d2"), g.pop("c2")
        g["l2"] = math.sqrt(d2 / c2) if c2 else math.inf
    return {"loss_on": loss_on, "loss_off": loss_off,
            "loss_rel": abs(loss_on - loss_off) / abs(loss_off),
            "groups": groups, "gradients": len(stats)}


def _on_off_ok(r, tol) -> bool:
    return r["loss_rel"] <= tol["loss"] and all(
        g["l2"] <= tol["l2"] and g["max"] <= tol["max"]
        for g in r["groups"].values())


def _planted_fault(on, off, batch, bits, floor: float) -> dict:
    """`_on_off` with a fault planted in K6's inputs: the attention
    backward is handed all-keep bits for the probabilities that the
    forward dropped, so K6 runs without its dp dropout mask. Only the text
    tower's gradients move; the forward and the loss do not."""
    import torch

    from text_guided_face_recognition_tpu_torch.ops import block
    real = block.attn_block_bwd

    def faulty(*a):
        a = list(a)     # _AttnBlockFn.backward passes bits_p 13th
        a[12] = torch.full_like(a[12], -1)
        return real(*a)

    # attn_block_bwd counts into the function its name is bound to, so the
    # control's launches land here and not in the main path's count
    faulty.launches = 0
    block.attn_block_bwd = faulty
    try:
        return _on_off(on, off, batch, bits, floor)
    finally:
        block.attn_block_bwd = real


def train_phase(kernels):
    """Stage-1 training at full width; returns the per-kernel launch counts
    of the CLI's run and prints the phase's metrics."""
    import torch

    from text_guided_face_recognition_tpu_torch.cli import (
        train_encoders_bert)
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)

    ckpt = os.path.join(ROOT, "checkpoints", "chip_smoke")
    argv = ["--cfg", os.path.join(ROOT, "cfg", "train_bert.yml"),
            "--synthetic", "--fused_block", "both", "--fused_ln",
            "--use_pallas", "--compute_dtype", "bfloat16", "--batch_size",
            "32", "--max_steps", "2", "--max_epoch", "1",
            "--checkpoints_path", ckpt]
    _zero(kernels)
    t0 = time.perf_counter()
    try:
        trainer = train_encoders_bert.main(argv)
        torch.cuda.synchronize()
        saved = sorted(os.listdir(trainer.save_dir()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    t_cli = time.perf_counter() - t0
    cli_counts = _counts(kernels)
    args = trainer.args
    layers = trainer.arch.layers
    per_step = {"layernorm_fused": 1, "layernorm_bwd": 1,
                "attn_block": layers, "attn_block_bwd": layers,
                "ffn_block": layers, "ffn_block_bwd": layers,
                "damsm_similarity": 1}
    steps = trainer.steps
    print(f"train: CLI {steps} steps + checkpoints {saved} in {t_cli:.1f} s "
          f"(set-up included), launches {cli_counts}", flush=True)
    if cli_counts != {k: steps * v for k, v in per_step.items()}:
        raise AssertionError(f"CLI launch counts {cli_counts} != {steps} x "
                             f"{per_step}")
    expect = {f"{args.model_type}_image_encoder_1",
              f"{args.bert_type}_text_encoder_1", "train_state_1"}
    if set(saved) != expect:
        raise AssertionError(f"checkpoints {saved} != {sorted(expect)}")

    # 20 steps on one fixed batch
    batch = trainer.to_device(next(iter(trainer.train_dl)))
    b, t = batch["caps"].shape
    _zero(kernels)
    losses = [trainer.train_step(batch)["total_loss"]
              for _ in range(TRAIN_STEPS)]
    losses = [float(v) for v in losses]
    fixed_counts = _counts(kernels)
    print(f"train: {TRAIN_STEPS} steps on one batch, total loss "
          f"{[round(v, 4) for v in losses]}, launches {fixed_counts}",
          flush=True)
    if fixed_counts != {k: TRAIN_STEPS * v for k, v in per_step.items()}:
        raise AssertionError(f"launch counts {fixed_counts} != "
                             f"{TRAIN_STEPS} x {per_step}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"loss does not fall: first five {first}, "
                             f"last five {last}")

    # one step, kernels on against off: same weights, same bits; in bf16
    # (the trainer's own) and in f32; then bf16 again with a planted K6
    # fault, which the same check must catch
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bits = trainer.draw_bits(b, t)
    off = _twin(trainer, state, fused_block="none", fused_ln=False,
                use_pallas=False)
    floor = ON_OFF_TOL["bfloat16"]["floor"]
    on_off = {"bfloat16": _on_off(trainer, off, batch, bits, floor)}
    planted = _planted_fault(trainer, off, batch, bits, floor)
    trainer.model.load_state_dict(state)
    f32 = [_twin(trainer, state, compute_dtype="float32"),
           _twin(trainer, state, compute_dtype="float32", fused_block="none",
                 fused_ln=False, use_pallas=False)]
    on_off["float32"] = _on_off(*f32, batch, bits,
                                ON_OFF_TOL["float32"]["floor"])
    del f32
    for dt, r in (*on_off.items(), ("bfloat16, planted K6 fault", planted)):
        tol = ON_OFF_TOL[dt.split(",")[0]]
        print(f"train: kernels on vs off, one step, {dt}: loss "
              f"{r['loss_on']:.6f} vs {r['loss_off']:.6f} (rel "
              f"{r['loss_rel']:.3g}, tolerance {tol['loss']}); per module "
              f"l2 / largest per parameter (tolerance {tol['l2']} / "
              f"{tol['max']}, floor {tol['floor']} G): " + "; ".join(
                  f"{m} {g['l2']:.4g} / {g['max']:.4g} at {g['max_at']}"
                  for m, g in r["groups"].items()), flush=True)
    for dt, r in on_off.items():
        if not _on_off_ok(r, ON_OFF_TOL[dt]):
            raise AssertionError(f"kernels on/off training step disagrees "
                                 f"in {dt}")
    if _on_off_ok(planted, ON_OFF_TOL["bfloat16"]):
        raise AssertionError("the on/off check passed a planted K6 fault")
    on_off["bfloat16_planted_k6_fault"] = planted
    torch.cuda.empty_cache()

    ms_on, ms_off = [], []
    for _ in range(5):  # in turns: on, off, off, on
        for tr, acc in ((trainer, ms_on), (off, ms_off), (off, ms_off),
                        (trainer, ms_on)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
    # the step's two halves on the host clock, kernels on
    ms_grads, ms_opt = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.compute_grads(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.opt.step()
        torch.cuda.synchronize()
        ms_grads.append((t1 - t0) * 1e3)
        ms_opt.append((time.perf_counter() - t1) * 1e3)
    profile = _profile(lambda: trainer.train_step(batch), what="step")
    print("train profile: " + json.dumps(profile))
    print("train: " + json.dumps({
        "ms_per_step_kernels_on": statistics.median(ms_on),
        "ms_per_step_kernels_off": statistics.median(ms_off),
        "ms_forward_backward": statistics.median(ms_grads),
        "ms_optimizer": statistics.median(ms_opt),
        "ms_per_step_on_all": ms_on, "ms_per_step_off_all": ms_off,
        "loss_first": losses[0], "loss_last": losses[-1],
        "on_off": on_off,
        "batch_size": b, "steps_cli": steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return cli_counts, {k: v // TRAIN_STEPS for k, v in fixed_counts.items()}


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "serving", "train"))
    only = ap.parse_args(argv).only
    sys.path.insert(0, ROOT)
    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.ops import (
        _cuda, block, damsm, layernorm)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    per_source = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})",
          flush=True)

    args = load_yaml(os.path.join(ROOT, "cfg", "test.yml")).replace(
        synthetic=True, fused_block="both", fused_ln=True,
        compute_dtype="bfloat16", batch_size=32, is_roc=False,
        checkpoints_path="", eval_table_mode=False)
    kernels = {"layernorm_fused": layernorm.layernorm_fused,
               "layernorm_bwd": layernorm.layernorm_bwd,
               "attn_block": block.attn_block,
               "attn_block_bwd": block.attn_block_bwd,
               "ffn_block": block.ffn_block,
               "ffn_block_bwd": block.ffn_block_bwd,
               "damsm_similarity": damsm.damsm_similarity_cuda}

    rows = kernel_phase(args) if only in (None, "kernels") else []
    serving = (slice_phase(args, kernels) if only in (None, "serving")
               else None)
    train = train_phase(kernels) if only in (None, "train") else None
    for r in rows:
        if serving is not None:
            r["launches_serving"] = serving[r["name"]]
        if train is not None:
            r["launches"] = train[0][r["name"]]
            r["launches_per_train_step"] = train[1][r["name"]]
            if r["launches"] < 1:
                raise AssertionError(f"{r['name']} never launched on the "
                                     "training path")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
