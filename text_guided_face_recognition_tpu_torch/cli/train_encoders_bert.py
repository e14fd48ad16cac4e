"""Stage-1 FCAM pretraining with a BERT text encoder.

  python -m text_guided_face_recognition_tpu_torch.cli.train_encoders_bert \
      [--cfg cfg/train_bert.yml] [--synthetic] [--cpu] [--max_steps N] \
      [--max_epoch N] [--fused_block both] [--fused_ln] [--use_pallas] \
      [--resume_model_path P --resume_epoch N] [--eager]

Counterpart of src/train_encoders_bert.py. Runs on the CUDA card unless
`--cpu` is given, or on N ranks under torchrun (cli/__init__.py; `--eager`
where ranks share a card). `--resume_model_path` (with `--resume_epoch`
above 1) takes the port's train state or the JAX package's, exported with
tools/export_jax_checkpoint.py.
"""

from __future__ import annotations

import argparse

from text_guided_face_recognition_tpu_torch.cli import parser, run, setup


def main(argv=None, default_cfg: str = "train_bert.yml",
         title: str = "Train BERT Encoder"):
    """Stage 1 under `default_cfg`; the config's en_type picks the text
    encoder (BERT, LSTM or GRU)."""
    p = parser(default_cfg, title)
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--checkpoints_path", type=str, default=None)
    p.add_argument("--resume_model_path", type=str, default=None)
    p.add_argument("--resume_epoch", type=int, default=None)
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="DAMSM similarity through the CUDA kernel")
    p.add_argument("--eager", action="store_true",
                   help="eager steps, no CUDA graph (ranks sharing a card)")
    ns = p.parse_args(argv)
    eager = ns.eager
    del ns.eager
    args = setup(ns)
    from text_guided_face_recognition_tpu_torch.engine.stage1 import (
        Stage1Trainer)
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    device = mesh.init_from_env(bool(args.cpu))
    if mesh.is_main():
        print(f"\nLet's train the encoders on {device} "
              f"({mesh.world_size()} rank(s))")
    trainer = Stage1Trainer(args, device, eager=eager)
    trainer.main()
    return trainer


if __name__ == "__main__":
    run(main)
