"""Pair evaluation: fused embeddings, pair cosine, verification metrics.

Counterpart of text_guided_face_recognition_tpu/engine/evaluate.py for one
device: encode both sides of each caption pair, run the frozen backbone and
the image head, fuse (concat | linear | fcfm), score the pair by cosine, and
report AUC/EER/TPR@FPR (+ rank-1 identification). Pair mode runs every pair
batch; table mode (`eval_table_mode`) embeds each distinct sample once and
scores pairs from the table. `validate_concat` is stage 1's validation:
concat fusion on the valid split, modules put in eval mode for its length.
The mesh-sharded eval of the JAX package waits for the parallel slice
(ROADMAP.md).

Batches arrive as numpy from the data layer, images NHWC (the wire format);
`backbone_features` normalises uint8 on the device and permutes to NCHW.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.ops.images import device_normalize
from text_guided_face_recognition_tpu_torch.utils.metrics import (
    calculate_identification_acc,
    calculate_scores,
)

__all__ = ["cosine_pairs", "run_test", "embed_batch", "pair_scores",
           "backbone_features", "validate_concat"]


def cosine_pairs(out1: torch.Tensor, out2: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """torch nn.CosineSimilarity(dim=1, eps=1e-6) semantics of the JAX
    package: each norm is clamped to eps separately."""
    n1 = torch.linalg.vector_norm(out1, dim=1)
    n2 = torch.linalg.vector_norm(out2, dim=1)
    return (out1 * out2).sum(dim=1) / (n1.clamp_min(eps) * n2.clamp_min(eps))


def backbone_features(backbone: nn.Module, model_type: str,
                      img: torch.Tensor):
    """(global (B, 512) f32, local (B, C, S, S)) of NHWC images."""
    img = device_normalize(img, model_type)            # NHWC
    return backbone(img.permute(0, 3, 1, 2))           # NCHW inside


def _fused_embed(backbone, image_head, text_encoder, text_head, fusion_net,
                 en_type: str, model_type: str, fusion_type: str,
                 img: torch.Tensor, caps: torch.Tensor,
                 extra: torch.Tensor) -> torch.Tensor:
    """One side's fused embedding, the deployable vector: the cosine of two
    of these is the pair score. extra = the attention mask."""
    if en_type != "BERT":
        raise NotImplementedError(
            f"en_type={en_type!r}: the LSTM path is not ported yet "
            "(ROADMAP.md, Queue 1)")
    words_raw, _ = text_encoder(caps, extra)
    w, s = text_head(words_raw)
    g, l = backbone_features(backbone, model_type, img)
    p, q = image_head(g, l)
    if fusion_type == "concat":
        return torch.cat([p, s], dim=1)
    if fusion_type == "linear":
        return fusion_net(p, s)
    if fusion_type == "fcfm":
        return fusion_net(q, w, p, s)
    raise ValueError(fusion_type)


class _Models:
    """The five serving modules and the config strings that pick the graph."""

    def __init__(self, args, backbone, image_head, fusion_net, text_encoder,
                 text_head):
        self.mods = (backbone, image_head, text_encoder, text_head, fusion_net)
        self.kinds = (args.en_type, args.model_type, args.fusion_type)
        self.device = next(backbone.parameters()).device

    def to_device(self, *arrays) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(a)).to(self.device,
                                                  non_blocking=True)
                for a in arrays]

    @torch.inference_mode()
    def embed(self, img, caps, extra) -> torch.Tensor:
        return _fused_embed(*self.mods, *self.kinds, img, caps, extra)

    @torch.inference_mode()
    def pair_scores(self, img1, img2, cap1, cap2, x1, x2) -> torch.Tensor:
        return cosine_pairs(self.embed(img1, cap1, x1),
                            self.embed(img2, cap2, x2))


def embed_batch(args, backbone, image_head, fusion_net, text_encoder,
                text_head, img, caps, extra) -> torch.Tensor:
    """One batch of fused embeddings from numpy (or tensor) inputs."""
    m = _Models(args, backbone, image_head, fusion_net, text_encoder,
                text_head)
    return m.embed(*m.to_device(img, caps, extra))


def pair_scores(args, backbone, image_head, fusion_net, text_encoder,
                text_head, img1, img2, cap1, cap2, x1, x2) -> torch.Tensor:
    """One pair batch's cosine scores from numpy (or tensor) inputs."""
    m = _Models(args, backbone, image_head, fusion_net, text_encoder,
                text_head)
    return m.pair_scores(*m.to_device(img1, img2, cap1, cap2, x1, x2))


def _score_loop(dl, models: _Models):
    preds, labels = [], []
    for batch in dl:
        pred = models.pair_scores(*models.to_device(
            batch["img1"], batch["img2"], batch["cap1"], batch["cap2"],
            batch["mask1"], batch["mask2"]))
        preds += pred.float().cpu().tolist()
        labels += np.asarray(batch["pair_label"]).tolist()
    return preds, labels


def _table_score_loop(args, ds, models: _Models):
    """Pair scores through a deduplicated per-sample embedding table: each
    distinct image side of the pair list is embedded once (first-appearance
    order, keyed on the full image name), then every pair is the cosine of
    two table rows. Batches are padded to one shape."""
    sides = [ds.pair_sides(i) for i in range(len(ds))]
    order, seen = [], {}
    for pair in sides:
        for name, key in pair:
            if name not in seen:
                seen[name] = len(order)
                order.append((name, key))

    bs = max(int(args.batch_size), 1)
    embs = []
    for i in range(0, len(order), bs):
        chunk = [ds.get_sample(n, k) for n, k in order[i:i + bs]]
        cols = [np.stack([c[f] for c in chunk])
                for f in ("img", "cap", "mask")]
        pad = bs - len(chunk)
        if pad:
            cols = [np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                    for a in cols]
        out = models.embed(*models.to_device(*cols))
        embs.append(out.float().cpu().numpy()[:len(chunk)])
    table = np.concatenate(embs)

    i1 = np.asarray([seen[pair[0][0]] for pair in sides])
    i2 = np.asarray([seen[pair[1][0]] for pair in sides])
    norms = np.maximum(np.linalg.norm(table, axis=1), 1e-6)
    preds = np.sum(table[i1] * table[i2], axis=1) / (norms[i1] * norms[i2])
    return preds.tolist(), list(ds.pair_label)


def run_test(args, test_dl, backbone, image_head, fusion_net, text_encoder,
             text_head) -> Dict[str, float]:
    """Full eval with fusion dispatch on the modules' device; prints and
    returns the verification metrics (+ identification with is_ident)."""
    models = _Models(args, backbone, image_head, fusion_net, text_encoder,
                     text_head)
    if getattr(args, "eval_table_mode", False):
        preds, labels = _table_score_loop(args, test_dl.dataset, models)
    else:
        preds, labels = _score_loop(test_dl, models)
    if args.is_ident:
        calculate_identification_acc(preds, args)
    return calculate_scores(preds, labels, args)


def validate_concat(args, valid_dl, backbone, image_head, text_encoder,
                    text_head) -> Dict[str, float]:
    """Stage-1 validation: concat(global image projection, sentence)
    cosine verification on the valid split (reference: Train.test,
    src/train_encoders_bert.py:348-395), the modules in eval mode."""
    mods = (image_head, text_encoder, text_head)
    modes = [m.training for m in mods]
    for m in mods:
        m.eval()
    try:
        models = _Models(args.replace(fusion_type="concat"), backbone,
                         image_head, None, text_encoder, text_head)
        if args.eval_table_mode:
            preds, labels = _table_score_loop(args, valid_dl.dataset, models)
        else:
            preds, labels = _score_loop(valid_dl, models)
    finally:
        for m, mode in zip(mods, modes):
            m.train(mode)
    return calculate_scores(preds, labels, args)
