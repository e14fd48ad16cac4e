"""Batch embedding extraction, the serving layer.

Counterpart of text_guided_face_recognition_tpu/engine/extract.py, on one
device: the fused embedding of every (image, caption) sample of a split,
deterministic (eval transform, the first caption of each image). The cosine
of two of these vectors is the pair score of engine/evaluate.py.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["extract_embeddings"]


def extract_embeddings(args, split: str = "test", out: Optional[str] = None,
                       device: Optional[torch.device] = None
                       ) -> Dict[str, np.ndarray]:
    """Extract the fused embedding of every sample in `split` on `device`
    (default: the CUDA card, or the CPU when `args.cpu`).

    Returns {"keys": (N,) str, "embeddings": (N, fusion_dim) float32,
    "class_ids": (N,)} and writes them as an .npz when `out` is given.
    """
    from text_guided_face_recognition_tpu_torch.config import check_serving
    from text_guided_face_recognition_tpu_torch.data import (
        DataLoader, TrainDataset)
    from text_guided_face_recognition_tpu_torch.engine import prepare as prep
    from text_guided_face_recognition_tpu_torch.engine.evaluate import (
        _Models, extra_key)

    check_serving(args)

    if device is None:
        device = prep.resolve_device(bool(args.cpu))
    _, ds = prep.prepare_dataloader(args, split)
    if split != "train":
        # one flat sample per image instead of the pair list
        ds = TrainDataset(ds.filenames, ds.captions, ds.att_masks, args=args,
                          split=split, synthetic=ds.synthetic, seed=0,
                          vocab=ds.vocab)
    ds.augment = False
    ds.fixed_sent_ix = 0
    dl = DataLoader(ds, batch_size=args.batch_size, shuffle=False,
                    drop_last=False, num_workers=args.num_workers)

    text_encoder, text_head = prep.prepare_text_encoder(args, device)
    models = _Models(args, prep.prepare_backbone(args, device),
                     prep.prepare_image_head(args, device),
                     prep.prepare_fusion_net(args, device), text_encoder,
                     text_head)
    keys, embs, cls = [], [], []
    xk = extra_key(args.en_type)       # the attention mask or cap_len
    for batch in dl:
        emb = models.embed(*models.to_device(batch["img"], batch["caps"],
                                             batch[xk]))
        embs.append(emb.float().cpu().numpy())
        keys += batch["key"].tolist()
        cls.append(np.asarray(batch["cls_id"]))

    result = {"keys": np.asarray(keys), "embeddings": np.concatenate(embs),
              "class_ids": np.concatenate(cls)}
    if out:
        np.savez(out, **result)
    return result
