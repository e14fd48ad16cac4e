"""Pair evaluation: fused embeddings, pair cosine, verification metrics.

Counterpart of text_guided_face_recognition_tpu/engine/evaluate.py: encode
both sides of each caption pair, run the frozen backbone and the image
head, fuse (concat | linear | fcfm), score the pair by cosine, and
report AUC/EER/TPR@FPR (+ rank-1 identification). Pair mode runs every pair
batch; table mode (`eval_table_mode`) embeds each distinct sample once and
scores pairs from the table. `validate_concat` is stage 1's validation:
concat fusion on the valid split, modules put in eval mode for its length.
`org_face_test` is the COTS baseline, the cosine of the raw backbone's
global features with no text, and `get_img_features_dict` its per-image
feature table.

Under a process group (parallel/mesh.py) every loop is sharded over the
ranks (the JAX package's `_shard_eval`): each batch is padded to a
multiple of the world size by repeating row 0, each rank loads and scores
only its share of it (`shard_rows`; the pair loaders' `row_shard`,
data/loader.py), and the outputs are gathered in rank order with the
padded ones dropped (`gather_rows`); rank 0 computes, prints and returns
the metrics, the other ranks return {}.

Batches arrive as numpy from the data layer, images NHWC (the wire format);
`backbone_features` normalises uint8 on the device and permutes to NCHW.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.ops.images import device_normalize
from text_guided_face_recognition_tpu_torch.parallel import mesh
from text_guided_face_recognition_tpu_torch.utils.metrics import (
    calculate_identification_acc,
    calculate_scores,
)

__all__ = ["cosine_pairs", "extra_key", "run_test", "embed_batch",
           "pair_scores", "predict_pairs", "shard_rows", "gather_rows",
           "backbone_features", "validate_concat", "global_features",
           "raw_pair_scores", "org_face_test", "get_img_features_dict"]


def cosine_pairs(out1: torch.Tensor, out2: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """torch nn.CosineSimilarity(dim=1, eps=1e-6) semantics of the JAX
    package: each norm is clamped to eps separately."""
    n1 = torch.linalg.vector_norm(out1, dim=1)
    n2 = torch.linalg.vector_norm(out2, dim=1)
    return (out1 * out2).sum(dim=1) / (n1.clamp_min(eps) * n2.clamp_min(eps))


def backbone_features(backbone: nn.Module, model_type: str,
                      img: torch.Tensor):
    """(global (B, 512) f32, local (B, C, S, S)) of NHWC images; AdaFace's
    third output, the feature norm, is dropped."""
    img = device_normalize(img, model_type)            # NHWC
    out = backbone(img.permute(0, 3, 1, 2))            # NCHW inside
    return out[:2] if model_type == "adaface" else out


def extra_key(en_type: str) -> str:
    """The caption field beside the token ids: BERT's attention `mask`, an
    RNN's `cap_len`."""
    return "mask" if en_type == "BERT" else "cap_len"


def _fused_embed(backbone, image_head, text_encoder, text_head, fusion_net,
                 en_type: str, model_type: str, fusion_type: str,
                 img: torch.Tensor, caps: torch.Tensor,
                 extra: torch.Tensor) -> torch.Tensor:
    """One side's fused embedding, the deployable vector: the cosine of two
    of these is the pair score. extra = the attention mask (BERT) or the
    caption lengths (LSTM/GRU, whose encoder has no head)."""
    if en_type == "BERT":
        words_raw, _ = text_encoder(caps, extra)
        w, s = text_head(words_raw)
    else:
        w, s = text_encoder(caps, extra)
    g, l = backbone_features(backbone, model_type, img)
    p, q = image_head(g, l)
    if fusion_type == "concat":
        return torch.cat([p, s], dim=1)
    if fusion_type == "linear":
        return fusion_net(p, s)
    if fusion_type == "fcfm" and en_type == "LSTM":
        return fusion_net(q, w)
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


def shard_rows(n: int) -> np.ndarray:
    """The positions, in a batch of n rows, of the rows this rank loads
    and runs (parallel/mesh.py `shard_positions`); all n without a process
    group."""
    return mesh.shard_positions(n, mesh.rank(), mesh.world_size())


def gather_rows(out, n: int):
    """The outputs of a whole batch of n rows from every rank's `out`, the
    outputs of its rows (`shard_rows`): gathered in rank order, the padded
    rows dropped; `out` itself without a process group."""
    return mesh.all_gather_rows(out)[:n] if mesh.active() else out


def _whole_batch(batch, pair_label: np.ndarray, pred):
    """(scores, labels) of a whole pair batch from this rank's scores of
    it: a row-sharded loader's batch (`global_rows`) has its scores
    gathered and its labels read from the dataset's `pair_label`."""
    rows = batch.get("global_rows")
    if rows is None:
        return pred, np.asarray(batch["pair_label"])
    return gather_rows(pred, len(rows)), pair_label[rows]


def _score_loop(dl, models: _Models):
    """Scores and labels of every pair batch of `dl`; a row-sharded loader
    (under a process group) yields this rank's rows of each batch, whose
    scores are gathered."""
    preds, labels = [], []
    xk = extra_key(models.kinds[0])
    pair_label = np.asarray(dl.dataset.pair_label)
    for batch in dl:
        pred, label = _whole_batch(batch, pair_label, models.pair_scores(
            *models.to_device(batch["img1"], batch["img2"], batch["cap1"],
                              batch["cap2"], batch[xk + "1"],
                              batch[xk + "2"])))
        preds += pred.float().cpu().tolist()
        labels += label.tolist()
    return preds, labels


def _table_score_loop(args, ds, embed, need_caption: bool = True):
    """Pair scores through a deduplicated per-sample embedding table: each
    distinct image side of the pair list is embedded once (first-appearance
    order, keyed on the full image name), then every pair is the cosine of
    two table rows. `embed` maps numpy columns (img, and cap and mask with
    `need_caption`: cap and mask, or cap and cap_len) to (B, D)
    embeddings. Batches are padded to one shape; under a process group
    each rank loads and embeds its share of a batch (`shard_rows`)."""
    sides = [ds.pair_sides(i) for i in range(len(ds))]
    order, seen = [], {}
    for pair in sides:
        for name, key in pair:
            if name not in seen:
                seen[name] = len(order)
                order.append((name, key))

    bs = max(int(args.batch_size), 1)
    fields = (("img", "cap", extra_key(args.en_type)) if need_caption
              else ("img",))
    embs = []
    for i in range(0, len(order), bs):
        chunk = order[i:i + bs]
        padded = chunk + chunk[:1] * (bs - len(chunk))
        samples = [ds.get_sample(*padded[p], need_caption=need_caption)
                   for p in shard_rows(bs)]
        cols = [np.stack([c[f] for c in samples]) for f in fields]
        out = gather_rows(embed(*cols), bs)
        embs.append(out.float().cpu().numpy()[:len(chunk)])
    table = np.concatenate(embs)

    i1 = np.asarray([seen[pair[0][0]] for pair in sides])
    i2 = np.asarray([seen[pair[1][0]] for pair in sides])
    norms = np.maximum(np.linalg.norm(table, axis=1), 1e-6)
    preds = np.sum(table[i1] * table[i2], axis=1) / (norms[i1] * norms[i2])
    return preds.tolist(), list(ds.pair_label)


def _table_embed(models: _Models):
    return lambda *cols: models.embed(*models.to_device(*cols))


def predict_pairs(args, test_dl, backbone, image_head, fusion_net,
                  text_encoder, text_head):
    """(scores, labels) of every pair of the loader's split, in pair
    order, on every rank: pair batches, or the embedding table with
    `eval_table_mode`."""
    models = _Models(args, backbone, image_head, fusion_net, text_encoder,
                     text_head)
    if getattr(args, "eval_table_mode", False):
        return _table_score_loop(args, test_dl.dataset, _table_embed(models))
    return _score_loop(test_dl, models)


def run_test(args, test_dl, backbone, image_head, fusion_net, text_encoder,
             text_head) -> Dict[str, float]:
    """Full eval with fusion dispatch on the modules' device; prints and
    returns the verification metrics (+ identification with is_ident) on
    rank 0 ({} on the other ranks)."""
    preds, labels = predict_pairs(args, test_dl, backbone, image_head,
                                  fusion_net, text_encoder, text_head)
    if not mesh.is_main():
        return {}
    if args.is_ident:
        calculate_identification_acc(preds, args)
    return calculate_scores(preds, labels, args)


def validate_concat(args, valid_dl, backbone, image_head, text_encoder,
                    text_head) -> Dict[str, float]:
    """Stage-1 validation: concat(global image projection, sentence)
    cosine verification on the valid split (reference: Train.test,
    src/train_encoders_bert.py:348-395), the modules in eval mode
    (text_head None with an RNN encoder); the metrics on rank 0 ({} on
    the other ranks)."""
    mods = [m for m in (image_head, text_encoder, text_head)
            if m is not None]
    modes = [m.training for m in mods]
    for m in mods:
        m.eval()
    try:
        models = _Models(args.replace(fusion_type="concat"), backbone,
                         image_head, None, text_encoder, text_head)
        if args.eval_table_mode:
            preds, labels = _table_score_loop(args, valid_dl.dataset,
                                              _table_embed(models))
        else:
            preds, labels = _score_loop(valid_dl, models)
    finally:
        for m, mode in zip(mods, modes):
            m.train(mode)
    return calculate_scores(preds, labels, args) if mesh.is_main() else {}


# ------------------------------------------------------ the COTS baseline --

@torch.inference_mode()
def global_features(backbone: nn.Module, model_type: str, img
                    ) -> torch.Tensor:
    """The backbone's global features (B, 512) of NHWC images given as
    numpy or tensors."""
    device = next(backbone.parameters()).device
    img = torch.as_tensor(np.asarray(img)).to(device, non_blocking=True)
    return backbone_features(backbone, model_type, img)[0]


def raw_pair_scores(backbone: nn.Module, model_type: str, img1, img2
                    ) -> torch.Tensor:
    """One pair batch's cosine scores on the raw global features."""
    return cosine_pairs(global_features(backbone, model_type, img1),
                        global_features(backbone, model_type, img2))


def get_img_features_dict(args, backbone: nn.Module
                          ) -> Dict[str, np.ndarray]:
    """The global backbone features of every distinct image of the test
    pair list ({name: (512,) f32}), read from
    data_dir/dataset_name/test_images in sorted name order, batched and
    padded to one shape by repeating a batch's first image (whose features
    are dropped); under a process group each rank decodes and runs its
    share of a batch (`shard_rows`)."""
    from text_guided_face_recognition_tpu_torch.data.transforms import (
        decode_image, eval_transform)

    with open(args.test_pair_list) as fd:
        pairs = fd.readlines()
    names = sorted({p.split(" ")[0] for p in pairs} |
                   {p.split(" ")[1].strip() for p in pairs})
    feats: Dict[str, np.ndarray] = {}
    bs = max(int(args.batch_size), 1)
    for i in range(0, len(names), bs):
        chunk = names[i:i + bs]
        padded = chunk + chunk[:1] * (bs - len(chunk))
        imgs = np.stack([
            eval_transform(decode_image(
                os.path.join(args.data_dir, args.dataset_name, "test_images",
                             padded[p]), args.img_size), args.model_type)
            for p in shard_rows(bs)])
        out = gather_rows(global_features(backbone, args.model_type, imgs),
                          bs)
        for n, f in zip(chunk, out.float().cpu().numpy()):
            feats[n] = f
    return feats


def org_face_test(args, test_dl, backbone: nn.Module) -> Dict[str, float]:
    """The COTS baseline: cosine on the raw backbone's global features, no
    text; every pair batch, or with `eval_table_mode` a per-image feature
    table (no captions loaded). Prints and returns the verification
    metrics (+ identification with is_ident) on rank 0 ({} on the other
    ranks)."""
    if getattr(args, "eval_table_mode", False):
        preds, labels = _table_score_loop(
            args, test_dl.dataset,
            lambda img: global_features(backbone, args.model_type, img),
            need_caption=False)
    else:
        preds, labels = [], []
        pair_label = np.asarray(test_dl.dataset.pair_label)
        for batch in test_dl:
            pred, label = _whole_batch(batch, pair_label, raw_pair_scores(
                backbone, args.model_type, batch["img1"], batch["img2"]))
            preds += pred.float().cpu().tolist()
            labels += label.tolist()
    if not mesh.is_main():
        return {}
    if args.is_ident:
        calculate_identification_acc(preds, args)
    return calculate_scores(preds, labels, args)
