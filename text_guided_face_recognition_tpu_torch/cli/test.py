"""Final TGFR evaluation: 1:1 verification (+ 1:N identification).

  python -m text_guided_face_recognition_tpu_torch.cli.test \
      [--cfg cfg/test.yml] [--synthetic] [--cpu] [--fused_block both] \
      [--fused_ln] [--batch_size 32] [--eval_table_mode] \
      [--text_encoder_path P] [--image_encoder_path P] [--fusion_net_path P]

Counterpart of src/test.py. The three paths take the port's artifacts,
the reference's files or the JAX package's exported with
tools/export_jax_checkpoint.py (engine/prepare.py). On N ranks under
torchrun each pair batch is sharded over them (cli/__init__.py); rank 0
prints the metrics.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import parser, run, setup


def main(argv=None):
    p = parser("test.yml", "Testing TGFR model")
    for name in ("text_encoder_path", "image_encoder_path",
                 "fusion_net_path"):
        p.add_argument(f"--{name}", type=str, default=None)
    args = setup(p.parse_args(argv))
    from text_guided_face_recognition_tpu_torch.config import check_serving
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import run_test
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    device = mesh.init_from_env(bool(args.cpu))
    check_serving(args)
    test_dl, _ = prep.prepare_dataloader(args, "test")
    text_encoder, text_head = prep.prepare_text_encoder(args, device)
    backbone = prep.prepare_backbone(args, device)
    image_head = prep.prepare_image_head(args, device)
    fusion_net = prep.prepare_fusion_net(args, device)  # None for concat

    if mesh.is_main():
        print(f"\nLet's test the model on {device} "
              f"({mesh.world_size()} rank(s))")
    return run_test(args, test_dl, backbone, image_head, fusion_net,
                    text_encoder, text_head)


if __name__ == "__main__":
    run(main)
