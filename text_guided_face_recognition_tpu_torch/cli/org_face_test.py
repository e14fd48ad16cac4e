"""The COTS face-model baseline: cosine on the raw backbone's features,
no text.

  python -m text_guided_face_recognition_tpu_torch.cli.org_face_test \
      [--cfg cfg/test.yml] [--synthetic] [--cpu] [--batch_size 32] \
      [--eval_table_mode]

Counterpart of src/org_face_test.py. The config's `model_type` (arcface |
adaface | magface) picks the backbone, its `weights_<model_type>` file the
weights. On N ranks under torchrun each pair batch is sharded over them
(cli/__init__.py); rank 0 prints the metrics.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import parser, run, setup


def main(argv=None):
    args = setup(parser("test.yml", "Testing COTS face model").parse_args(
        argv))
    from text_guided_face_recognition_tpu_torch.config import check_backbone
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        org_face_test)
    from text_guided_face_recognition_tpu_torch.parallel import mesh

    check_backbone(args)
    device = mesh.init_from_env(bool(args.cpu))
    test_dl, _ = prep.prepare_dataloader(args, "test")
    if mesh.is_main():
        print("loading models ...")
    backbone = prep.prepare_backbone(args, device)
    if mesh.is_main():
        print(f"start testing on {device} ({mesh.world_size()} rank(s)) ...")
    return org_face_test(args.replace(is_roc=True), test_dl, backbone)


if __name__ == "__main__":
    run(main)
