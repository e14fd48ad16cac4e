"""Batch embedding extraction (serving utility).

  python -m text_guided_face_recognition_tpu_torch.cli.extract_embeddings \
      [--cfg cfg/test.yml] [--split test] [--out embeddings.npz] \
      [--synthetic] [--cpu] [--fused_block both] [--fused_ln]

Writes an .npz with `keys`, `embeddings` (N, fusion_dim) and `class_ids`.
Counterpart of src/extract_embeddings.py.
"""

from __future__ import annotations

from text_guided_face_recognition_tpu_torch.cli import parser, setup


def main(argv=None):
    p = parser("test.yml", "Extract fused TGFR embeddings")
    p.add_argument("--split", default="test",
                   choices=("train", "valid", "test"))
    p.add_argument("--out", default="embeddings.npz")
    ns = p.parse_args(argv)
    split, out = ns.split, ns.out
    del ns.split, ns.out
    args = setup(ns)

    from text_guided_face_recognition_tpu_torch.engine.extract import (
        extract_embeddings)
    result = extract_embeddings(args, split=split, out=out)
    print(f"wrote {result['embeddings'].shape[0]} embeddings of dim "
          f"{result['embeddings'].shape[1]} to {out}")
    return result


if __name__ == "__main__":
    main()
