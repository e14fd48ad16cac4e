"""Entry points of the port, run as modules:

  python -m text_guided_face_recognition_tpu_torch.cli.test [--cfg ...]
  python -m text_guided_face_recognition_tpu_torch.cli.extract_embeddings ...
  python -m text_guided_face_recognition_tpu_torch.cli.train_encoders_bert ...
  python -m text_guided_face_recognition_tpu_torch.cli.fusion_bert ...

All run on the CUDA card unless `--cpu` is given, and fail when no card is
present and the CPU was not asked for.
"""

from __future__ import annotations

import argparse
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
