#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes (R = 768 token rows of B = 32 captions x
     T = 24, H = 768, 12 heads, I = 3072; ragged key masks from the
     synthetic captions; weights passed as the model passes them, the .t()
     view of an (out, in) nn.Linear weight), in bf16 and f32, then timed
     beside its plain version, a one-call library equivalent where PyTorch
     has one, and its bound on the card. A time is the device time per
     call of a CUDA graph of back-to-back calls (no host work in the timed
     span), with a warm L2 (`ms`) and with the L2 flushed before each call
     (`ms_cold_l2`: a graph of flush + call less a graph of the flushes);
  4. the slice at full width in bf16 (bert-base 12 layers, iresnet18 at
     112x112, ImageHeading, FCFM 640; random weights from manual_seed;
     synthetic test split; batch 32; fused_block=both, fused_ln=true):
     run_test in pair mode, then extract_embeddings, with every kernel's
     launch count zeroed before and read after; then one pair batch with
     the kernels off (plain PyTorch modules on the card) against the same
     batch with them on, and the time of a pair batch either way.
The last two lines are the `kernels` JSON line and the result line.

Tolerances. Kernel against plain version: |k - p| <= atol + rtol |p| with
rtol = atol = 2e-2 in bf16 (1 bf16 ulp at |x| < 8 is <= 2^-5; the two sum in
different orders and may round the other way) and 1e-4 in f32, with TF32
off for matmuls and convolutions so the plain f32 version is full f32.
Kernels on against off, per pair score: 2e-2 (bf16 rounding differences
carried through 12 layers and a 640-d cosine).
"""

from __future__ import annotations

import json
import math
import os
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
    import torch
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return err.max().item(), bool((err <= tol + tol * b.abs()).all())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def kernel_phase(args):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from text_guided_face_recognition_tpu_torch.engine.prepare import (
        _synthetic_bert)
    from text_guided_face_recognition_tpu_torch.ops import block, layernorm

    dev = torch.device("cuda")
    B, T, H, heads, I = 32, args.bert_words_num, 768, 12, 3072
    R = B * T
    eps = 1e-12
    _, _, masks = _synthetic_bert(args, B)
    mask = torch.from_numpy(np.stack(masks[::args.captions_per_image][:B]))
    mask = mask.to(dev, torch.int32).contiguous()
    gen = torch.Generator().manual_seed(args.manual_seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x32 = rn(R, H)
    ln_g, ln_b = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    # weights (in, out) as the .t() view of (out, in), as the model has them
    wqkv, bqkv = rn(3 * H, H, std=H ** -0.5).t(), rn(3 * H, std=0.1)
    wo, bo = rn(H, H, std=H ** -0.5).t(), rn(H, std=0.1)
    w1, c1 = rn(I, H, std=H ** -0.5).t(), rn(I, std=0.1)
    w2, c2 = rn(H, I, std=I ** -0.5).t(), rn(H, std=0.1)
    # the library call takes its affine in the input dtype
    ln_g_bf16, ln_b_bf16 = ln_g.bfloat16(), ln_b.bfloat16()
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    flush_ms = _graph_ms(flush)

    specs = [
        dict(name="layernorm_fused", fn=layernorm.layernorm_fused,
             source="text_guided_face_recognition_tpu_torch/csrc/layernorm.cu",
             replaces="text_guided_face_recognition_tpu/ops/layernorm_pallas.py:103",
             run=lambda f, x: f(x, ln_g, ln_b, eps),
             ref=lambda x: layernorm.layernorm_ref(x, ln_g, ln_b, eps),
             library=lambda x: F.layer_norm(x, (H,), ln_g_bf16, ln_b_bf16,
                                            eps)),
        dict(name="attn_block", fn=block.attn_block,
             source="text_guided_face_recognition_tpu_torch/csrc/attn_block.cu",
             replaces="text_guided_face_recognition_tpu/ops/block_pallas.py:626",
             run=lambda f, x: f(x, mask, wqkv, bqkv, wo, bo, ln_g, ln_b, B, T,
                                heads, 0.0, eps),
             ref=lambda x: block.attn_block_ref(x, mask, wqkv, bqkv, wo, bo,
                                                ln_g, ln_b, B, T, heads, 0.0,
                                                eps),
             library=None),
        dict(name="ffn_block", fn=block.ffn_block,
             source="text_guided_face_recognition_tpu_torch/csrc/ffn_block.cu",
             replaces="text_guided_face_recognition_tpu/ops/block_pallas.py:331",
             run=lambda f, x: f(x, w1, c1, w2, c2, ln_g, ln_b, 0.0, eps),
             ref=lambda x: block.ffn_block_ref(x, w1, c1, w2, c2, ln_g, ln_b,
                                               0.0, eps),
             library=None),
    ]
    rows = []
    for s in specs:
        row = {"name": s["name"], "route": "cuda", "source": s["source"],
               "replaces": s["replaces"]}
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            out = s["run"](s["fn"], x)
            torch.cuda.synchronize()
            err, ok = _close(out, s["ref"](x), TOL[str(dt)[6:]])
            tag = "" if dt == torch.bfloat16 else "_f32"
            row[f"max_abs_err{tag}"] = err
            row[f"tolerance{tag}"] = {"rtol": TOL[str(dt)[6:]],
                                      "atol": TOL[str(dt)[6:]]}
            if not ok:
                raise AssertionError(f"{s['name']} {dt}: kernel disagrees with "
                                     f"its plain version (max |err| {err})")
        x = x32.to(torch.bfloat16)
        row["ms"], row["ms_cold_l2"] = _times(
            lambda: s["run"](s["fn"], x), flush, flush_ms)
        row["kernel_ms"] = row["ms"]
        row["plain_ms"], row["plain_ms_cold_l2"] = _times(
            lambda: s["ref"](x), flush, flush_ms)
        row["library_ms"], row["library_ms_cold_l2"] = (
            (None, None) if s["library"] is None else
            _times(lambda: s["library"](x), flush, flush_ms))
        row.update(_bound(s["name"], x, B, T, H, heads, I))
        rows.append(row)
    return rows


def _bound(name, x, b, t, h, heads, inter):
    """The least time the card could take for the call: the larger of its
    bytes (each input read once, each output written once) over HBM rate
    and its operations over the peak rate for their type."""
    r, es = b * t, x.element_size()
    act = r * h * es                      # one (R, H) activation
    if name == "layernorm_fused":
        nbytes = 2 * act + 2 * h * 4
        flops, kind = 8.0 * r * h, "f32"
    elif name == "ffn_block":
        nbytes = 2 * act + 4 * (2 * h * inter + inter + 3 * h)
        flops, kind = 4.0 * r * h * inter, "bf16_tensor"
    else:
        d = h // heads
        nbytes = 2 * act + 4 * b * t + 4 * (4 * h * h + 3 * h + 3 * h)
        flops = (2.0 * r * h * 3 * h + 4.0 * b * heads * t * t * d
                 + 2.0 * r * h * h)
        kind = "bf16_tensor"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _profile(step, reps: int = 3) -> dict:
    """Device time and the kernels that take it over `reps` pair batches
    (kernels on), from torch.profiler. The busy share is device time over
    the wall time under the profiler, which slows the host: it is not the
    share of an unprofiled batch."""
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
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(e.self_device_time_total for e in dev)
    if not busy_us:
        return {"device_busy_share_profiled": "not measured"}

    def group(name):
        for key in ("gemm_kernel", "attention_core", "layernorm_rows"):
            if key in name:
                return "port kernels: " + key
        return "other: " + name[:60]

    by_group = {}
    for e in dev:
        g = group(e.key)
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total
    top = sorted(by_group.items(), key=lambda kv: -kv[1])[:10]
    return {"pair_batches": reps, "wall_ms_per_batch": wall_us / reps / 1e3,
            "device_ms_per_batch": busy_us / reps / 1e3,
            "device_busy_share_profiled": busy_us / wall_us,
            "top_ms_per_batch": {k: v / reps / 1e3 for k, v in top}}


def slice_phase(args, kernels):
    """The serving path at full width; returns the per-kernel launch counts
    of the main path and prints its metrics."""
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

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = run_test(args, test_dl, backbone, image_head, fusion_net,
                       text_encoder, text_head)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    after_test = counts()
    t0 = time.perf_counter()
    emb = extract_embeddings(args, "test", device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    total = counts()
    layers = text_encoder.model.arch.layers

    expected_test = {"layernorm_fused": 2 * n_batches,
                     "attn_block": 2 * layers * n_batches,
                     "ffn_block": 2 * layers * n_batches}
    n_emb = math.ceil(len(emb["keys"]) / args.batch_size)
    expected_extract = {"layernorm_fused": n_emb, "attn_block": layers * n_emb,
                        "ffn_block": layers * n_emb}
    got_extract = {k: total[k] - after_test[k] for k in total}
    print(f"slice: run_test {n_batches} pair batches in {t_test:.3f} s, "
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
    print(f"slice: kernels on vs off, one pair batch: max |score diff| "
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
    print("profile: " + json.dumps(profile))
    print("slice: " + json.dumps({
        "metrics": metrics, "ms_per_pair_batch_kernels_on":
        statistics.median(ms_on), "ms_per_pair_batch_kernels_off":
        statistics.median(ms_off), "score_diff_on_off": diff,
        "pair_batches": n_batches, "batch_size": args.batch_size}))
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from text_guided_face_recognition_tpu_torch.config import load_yaml
    from text_guided_face_recognition_tpu_torch.ops import _cuda, block
    from text_guided_face_recognition_tpu_torch.ops.layernorm import (
        layernorm_fused)

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
    kernels = {"layernorm_fused": layernorm_fused,
               "attn_block": block.attn_block, "ffn_block": block.ffn_block}

    rows = kernel_phase(args)
    for r in rows:
        print(f"kernel {r['name']}: bf16 max|err| {r['max_abs_err']:.3g}, "
              f"f32 {r['max_abs_err_f32']:.3g}; {r['ms']:.4f} ms, cold L2 "
              f"{r['ms_cold_l2']:.4f} (plain {r['plain_ms']:.4f} / "
              f"{r['plain_ms_cold_l2']:.4f}, library {r['library_ms']} / "
              f"{r['library_ms_cold_l2']}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})", flush=True)
    launches = slice_phase(args, kernels)
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} never launched on the path")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
