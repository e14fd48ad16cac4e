"""Op breakdown of one train step (where do the ms go?).

  python -m text_guided_face_recognition_tpu_torch.tools.profile_step \
      [--stage 1|2|lstm] [--batch 32] [--k 8] [--top 25] [--cpu] \
      [--fused_block none|ffn|attn|both|tower] [--bert_type bert] \
      [--adam_moments_dtype bfloat16] \
      [--lazy_embedding_adam] [--feature-cache] [--trace-dir DIR]

Counterpart of tools/profile_step.py, with torch.profiler in place of
jax.profiler. Builds the stage's trainer at the defaults of the config
(stage 1 BERT; stage 2 BERT with fcfm; lstm the stage-1 LSTM recipe),
synthetic data, a batch of `--batch` samples of the synthetic train split
(sample i is image i mod the split's size), and on the card warms the
trainer's captured step up (its three eager steps and the capture), then
traces `--k` replays and sums each CUDA kernel's device time. Prints one
JSON line a group of kernels (the port's kernels, GEMMs, convolutions,
collectives, the optimizer's multi-tensor kernels, copies, the rest) and a
total line, `device_total_ms_per_step` = total / k, then the top kernels.
With --cpu the trainer is eager on the CPU and the lines sum the CPU ops'
own time (`cpu_total_ms_per_step`): a host measurement, not a device one.
`--feature-cache` profiles the frozen_feature_cache step (the batch carries
the backbone's features, no convolution tower in the step). The Chrome
trace is written to --trace-dir (a new temporary directory by default).

N/A here (XLA-only flags of the JAX tool): --rnn_unroll (the port's RNN is
a loop of per-step ops, no scan), --stack_max_elems (the JAX optimizer's
stacking; the port's runs one multi-tensor update a group and dtype),
--xla_opts (XLA compiler presets), and --trace-dir as an existing trace to
parse (a jax.profiler xplane).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile

import numpy as np
import torch

GROUPS = (
    (("tower_", "hl_gemm", "hl_bwd_gemm", "attention_mma", "attention_core",
      "attention_strip", "layernorm_", "colsum", "damsm_", "philox"),
     "port kernels"),
    (("nccl",), "collective"),
    (("multi_tensor", "foreach"), "optimizer"),
    (("gemm", "xmma", "cutlass", "gemv", "sm90_", "sm80_", "matmul", "mm",
      "linear"), "matmul"),
    (("conv", "implicit", "winograd", "fprop", "dgrad", "wgrad"),
     "convolution"),
    (("memcpy", "memset", "copy", "fill"), "copy"),
    (("reduce", "sum", "norm", "max"), "reduce"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for keys, g in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def _batch(tr, n: int):
    ds = tr.train_ds
    samples = [ds[i % len(ds)] for i in range(n)]
    return tr.to_device({k: np.stack([np.asarray(x[k]) for x in samples])
                         for k in samples[0] if k != "key"})


def build(ns):
    """(trainer, device batch) of the command line's stage."""
    from text_guided_face_recognition_tpu_torch.config import TGFRConfig
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)

    over = {}
    if ns.fused_block is not None:
        over["fused_block"] = ns.fused_block
    if ns.adam_moments_dtype is not None:
        over["adam_moments_dtype"] = ns.adam_moments_dtype
    if ns.lazy_embedding_adam:
        over["lazy_embedding_adam"] = True
    base = TGFRConfig().replace(
        synthetic=True, batch_size=ns.batch, num_workers=2, max_epoch=1,
        cpu=bool(ns.cpu), checkpoints_path="", **over)
    stage = str(ns.stage)
    dev = torch.device("cpu") if ns.cpu else None
    if stage == "lstm":
        tr = Stage1Trainer(base.replace(en_type="LSTM", lambda_clip=1.0),
                           dev)
    elif stage == "2":
        tr = FusionTrainer(base.replace(en_type="BERT",
                                        bert_type=ns.bert_type,
                                        fusion_type="fcfm",
                                        CONFIG_NAME="Fusion"), dev)
    else:
        tr = Stage1Trainer(base.replace(en_type="BERT",
                                        bert_type=ns.bert_type), dev)
    batch = _batch(tr, ns.batch)
    if ns.feature_cache:
        batch["img_gl"], batch["img_lc"] = tr.image_features(
            batch.pop("img"))
    return tr, batch


def profile(tr, batch, k: int, trace_dir: str):
    """{op or kernel name: ms over the k traced steps}, after warming the
    step up (on the card until its graph is captured, and once more)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    cuda = tr.device.type == "cuda"
    for _ in range(tr.WARMUP_STEPS + 2 if cuda else 1):
        tr.train_step(batch)
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with tprofile(activities=acts) as prof:
        for _ in range(k):
            tr.train_step(batch)
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    agg = collections.defaultdict(float)
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue
        if cuda:
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                agg[e.key] += e.self_device_time_total / 1e3
        elif e.self_cpu_time_total:
            agg[e.key] += e.self_cpu_time_total / 1e3
    return dict(agg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--stage", default="1",
                    help="1 | 2 | lstm (stage-1 LSTM)")
    ap.add_argument("--fused_block", default=None,
                    choices=("none", "ffn", "attn", "both", "tower"))
    ap.add_argument("--bert_type", default="bert")
    ap.add_argument("--adam_moments_dtype", default=None)
    ap.add_argument("--lazy_embedding_adam", action="store_true")
    ap.add_argument("--feature-cache", dest="feature_cache",
                    action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace-dir", dest="trace_dir", default=None)
    ns = ap.parse_args(argv)

    tr, batch = build(ns)
    trace_dir = ns.trace_dir or tempfile.mkdtemp(prefix="tgfr_trace_")
    agg = profile(tr, batch, ns.k, trace_dir)
    if not agg:
        print(json.dumps({"error": "no device events"}))
        return 1
    total = sum(agg.values())
    k = ns.k
    by_group = collections.defaultdict(float)
    for name, ms in agg.items():
        by_group[group_of(name)] += ms
    metric = ("cpu_total_ms_per_step" if tr.device.type == "cpu"
              else "device_total_ms_per_step")
    print(json.dumps({"metric": metric, "value": total / k, "k": k,
                      "stage": str(ns.stage), "batch": ns.batch,
                      "trace_dir": trace_dir}))
    for g, ms in sorted(by_group.items(), key=lambda x: -x[1]):
        print(json.dumps({"group": g, "ms_per_step": ms / k,
                          "pct": 100 * ms / total}))
    for name, ms in sorted(agg.items(), key=lambda x: -x[1])[:ns.top]:
        print(json.dumps({"op": name[:120], "ms_per_step": ms / k,
                          "pct": 100 * ms / total}))
    if tr.device.type == "cuda":
        tr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
