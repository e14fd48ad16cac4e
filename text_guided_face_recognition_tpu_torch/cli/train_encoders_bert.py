"""Stage-1 FCAM pretraining with a BERT text encoder.

  python -m text_guided_face_recognition_tpu_torch.cli.train_encoders_bert \
      [--cfg cfg/train_bert.yml] [--synthetic] [--cpu] [--max_steps N] \
      [--max_epoch N] [--fused_block both] [--fused_ln] [--use_pallas]

Counterpart of src/train_encoders_bert.py. Runs on the CUDA card unless
`--cpu` is given.
"""

from __future__ import annotations

import argparse

from text_guided_face_recognition_tpu_torch.cli import parser, setup


def main(argv=None, default_cfg: str = "train_bert.yml",
         title: str = "Train BERT Encoder"):
    """Stage 1 under `default_cfg`; the config's en_type picks the text
    encoder (BERT, LSTM or GRU)."""
    p = parser(default_cfg, title)
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--checkpoints_path", type=str, default=None)
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="DAMSM similarity through the CUDA kernel")
    args = setup(p.parse_args(argv))
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)

    device = prep.resolve_device(bool(args.cpu))
    print(f"\nLet's train the encoders on {device}")
    trainer = Stage1Trainer(args, device)
    trainer.main()
    return trainer


if __name__ == "__main__":
    main()
