"""TGFR on PyTorch and CUDA: the port of `text_guided_face_recognition_tpu`
to an NVIDIA H100.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name. This package imports torch, numpy and pyyaml, and
nothing of JAX or of the JAX package.

Layout:
  config  typed configuration (the cfg/*.yml surface the port runs)
  data    synthetic and on-disk datasets, transforms, host loader (numpy)
  ops     image normalisation; the hand-written CUDA kernels (csrc/) for the
          text tower's LayerNorm and post-LN half-layers, each beside its
          plain PyTorch version
  models  BERT text encoder and head, the iResNet (ArcFace, MagFace) and
          IR (AdaFace) backbones, image head, FCFM
  engine  model factories, the reference's weight files and the weight
          bridge from JAX variables, pair evaluation, the COTS baseline and
          embedding extraction, the two trainers
  cli     entry points: `python -m text_guided_face_recognition_tpu_torch.cli.test`,
          `... .cli.extract_embeddings`, `... .cli.org_face_test` and the
          trainers
  utils   verification and identification metrics (numpy)

What is ported so far, and what waits, is in ROADMAP.md.
"""

__version__ = "0.1.0"
