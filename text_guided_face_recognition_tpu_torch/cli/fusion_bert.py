"""Stage-2 fusion training on top of stage-1 BERT encoders.

  python -m text_guided_face_recognition_tpu_torch.cli.fusion_bert \
      [--cfg cfg/fusion_bert.yml] [--synthetic] [--cpu] [--max_steps N] \
      [--max_epoch N] [--fused_block tower] [--fused_ln] [--eager]

Counterpart of src/fusion_bert.py. Runs on the CUDA card unless `--cpu` is
given, or on N ranks under torchrun (cli/__init__.py; `--eager` where
ranks share a card).
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import parser, run, setup


def main(argv=None, default_cfg: str = "fusion_bert.yml"):
    """Stage 2 under `default_cfg`; the config's en_type picks the text
    encoder (BERT, LSTM or GRU)."""
    p = parser(default_cfg, "Fusion")
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap steps per epoch (smoke runs)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--checkpoints_path", type=str, default=None)
    p.add_argument("--text_encoder_path", type=str, default=None)
    p.add_argument("--image_encoder_path", type=str, default=None)
    p.add_argument("--resume_model_path", type=str, default=None)
    p.add_argument("--resume_epoch", type=int, default=None)
    p.add_argument("--eager", action="store_true",
                   help="eager steps, no CUDA graph (ranks sharing a card)")
    ns = p.parse_args(argv)
    eager = ns.eager
    del ns.eager
    args = setup(ns)
    from text_guided_face_recognition_tpu_torch.engine.stage2 import (
        FusionTrainer)
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    device = mesh.init_from_env(bool(args.cpu))
    if mesh.is_main():
        print(f"\nLet's train the fusion net on {device} "
              f"({mesh.world_size()} rank(s))")
    trainer = FusionTrainer(args, device, eager=eager)
    trainer.main()
    return trainer


if __name__ == "__main__":
    run(main)
