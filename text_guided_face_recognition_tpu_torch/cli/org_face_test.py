"""The COTS face-model baseline: cosine on the raw backbone's features,
no text.

  python -m text_guided_face_recognition_tpu_torch.cli.org_face_test \
      [--cfg cfg/test.yml] [--synthetic] [--cpu] [--batch_size 32] \
      [--eval_table_mode]

Counterpart of src/org_face_test.py. The config's `model_type` (arcface |
adaface | magface) picks the backbone, its `weights_<model_type>` file the
weights.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import parser, setup


def main(argv=None):
    args = setup(parser("test.yml", "Testing COTS face model").parse_args(
        argv))
    from text_guided_face_recognition_tpu_torch.config import check_backbone
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        org_face_test)

    check_backbone(args)
    device = prep.resolve_device(bool(args.cpu))
    test_dl, _ = prep.prepare_dataloader(args, "test")
    print("loading models ...")
    backbone = prep.prepare_backbone(args, device)
    print(f"start testing on {device} ...")
    return org_face_test(args.replace(is_roc=True), test_dl, backbone)


if __name__ == "__main__":
    main()
