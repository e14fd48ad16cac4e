"""Entry points of the port, run as modules:

  python -m text_guided_face_recognition_tpu_torch.cli.test [--cfg ...]
  python -m text_guided_face_recognition_tpu_torch.cli.org_face_test ...
  python -m text_guided_face_recognition_tpu_torch.cli.extract_embeddings ...
  python -m text_guided_face_recognition_tpu_torch.cli.train_encoders_bert ...
  python -m text_guided_face_recognition_tpu_torch.cli.fusion_bert ...
  python -m text_guided_face_recognition_tpu_torch.cli.train_encoders_lstm ...
  python -m text_guided_face_recognition_tpu_torch.cli.fusion_lstm ...

`test` and `extract_embeddings` take any config, an LSTM one
(cfg/fusion_lstm.yml) too.

All run on the CUDA card unless `--cpu` is given, and fail when no card is
present and the CPU was not asked for.

Each also runs on N ranks under torchrun, one process a rank:

  torchrun --nproc_per_node 2 -m \
      text_guided_face_recognition_tpu_torch.cli.train_encoders_bert \
      --cpu --synthetic                    # two CPU ranks over gloo
  torchrun --nproc_per_node 8 -m \
      text_guided_face_recognition_tpu_torch.cli.fusion_bert   # 8 cards, NCCL

(parallel/mesh.py: gloo on the CPU and where ranks share a card, NCCL with
one rank a card; the captured train step needs NCCL, so the training CLIs
take `--eager` for ranks that share a card). Training splits every global
batch of `batch_size` over the ranks, which must divide it; evaluation and
extraction shard each batch. Rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import gc
import os
import random

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parser(default_cfg: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", type=str,
                   default=os.path.join(_ROOT, "cfg", default_cfg),
                   help="config file")
    p.add_argument("--synthetic", action="store_true", default=None,
                   help="run on synthetic images/captions")
    p.add_argument("--cpu", action="store_true", default=None,
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--bert_type", type=str, default=None,
                   choices=("bert", "align", "blip", "falva", "clip",
                            "groupvit"),
                   help="text arch of the BERT recipe (models/text_bert.py "
                        "TEXT_ARCHS)")
    p.add_argument("--fused_block", type=str, default=None,
                   choices=("none", "ffn", "attn", "both", "tower"),
                   help="text tower through the CUDA kernels: half-layers "
                        "(ffn, attn, both) or all layers in one launch "
                        "each way (tower)")
    p.add_argument("--fused_ln", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="text-tower LayerNorms through the CUDA kernel")
    p.add_argument("--fused_dropout", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="training: every dropout site from the step's host "
                        "bits (default: the fused kernels draw their own "
                        "from seeds)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=("float32", "bfloat16"))
    p.add_argument("--eval_table_mode", action="store_true", default=None,
                   help="score pairs through the per-sample embedding table")
    return p


def run(main) -> None:
    """An entry point's `__main__`: main(); then the trainer it returns
    closed (its captured step and the NCCL collectives in it freed:
    engine/trainer.py `close`) and collected, and the process group
    left."""
    from text_guided_face_recognition_tpu_torch.parallel import mesh
    try:
        out = main()
        if hasattr(out, "close"):
            out.close()
        del out
        gc.collect()
    finally:
        mesh.shutdown()


def setup(ns: argparse.Namespace):
    """Merge the YAML under the flags and seed the host RNGs."""
    import numpy as np
    import torch

    from text_guided_face_recognition_tpu_torch.config import merge_args_yaml
    args = merge_args_yaml(ns)
    random.seed(args.manual_seed)
    np.random.seed(args.manual_seed)
    torch.manual_seed(args.manual_seed)
    return args
