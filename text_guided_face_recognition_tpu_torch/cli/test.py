"""Final TGFR evaluation: 1:1 verification (+ 1:N identification).

  python -m text_guided_face_recognition_tpu_torch.cli.test \
      [--cfg cfg/test.yml] [--synthetic] [--cpu] [--fused_block both] \
      [--fused_ln] [--batch_size 32] [--eval_table_mode]

Counterpart of src/test.py.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import parser, setup


def main(argv=None):
    args = setup(parser("test.yml", "Testing TGFR model").parse_args(argv))
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import run_test

    device = prep.resolve_device(bool(args.cpu))
    test_dl, _ = prep.prepare_dataloader(args, "test")
    text_encoder, text_head = prep.prepare_text_encoder(args, device)
    backbone = prep.prepare_backbone(args, device)
    image_head = prep.prepare_image_head(args, device)
    fusion_net = prep.prepare_fusion_net(args, device)  # None for concat

    print(f"\nLet's test the model on {device}")
    return run_test(args, test_dl, backbone, image_head, fusion_net,
                    text_encoder, text_head)


if __name__ == "__main__":
    main()
