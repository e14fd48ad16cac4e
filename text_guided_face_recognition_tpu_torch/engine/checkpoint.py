"""Checkpoint artifacts of the trainers, written with torch.save.

Counterpart of text_guided_face_recognition_tpu/engine/checkpoint.py, in
the JAX package's naming. Under one save directory, stage 1 writes
`{model_type}_image_encoder_{epoch}` ({"image_head"}),
`{bert_type}_text_encoder_{epoch}` ({"model", "head"}) and
`train_state_{epoch}`; stage 2 writes
`fusion_{fusion_type}_{model_type}_{epoch}` ({"net", "image_head"}),
`encoder_{en_type}_{fusion_type}_{epoch}` ({"model", "head"}) and
`train_state_{epoch}`. Each is one file holding a nested dict of tensors
(state_dicts, optimizer state, metadata); engine/prepare.py loads the
encoder and fusion artifacts back by these keys. `prune_checkpoints` keeps
the newest epochs of each artifact family.
"""

from __future__ import annotations

import os
import re
import shutil
from collections import defaultdict
from typing import Any

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "prune_checkpoints"]


def save_checkpoint(path: str, tree: Any) -> None:
    """torch.save `tree` to `path` (written beside, then renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def prune_checkpoints(save_dir: str, keep_last: int) -> None:
    """Retain only the newest `keep_last` epochs of each artifact family in
    `save_dir` (names end in `_<epoch>`). keep_last <= 0 keeps everything,
    the reference behaviour."""
    if keep_last <= 0 or not os.path.isdir(save_dir):
        return
    families = defaultdict(list)
    for name in os.listdir(save_dir):
        m = re.match(r"^(.*)_(\d+)$", name)
        if m:
            families[m.group(1)].append((int(m.group(2)), name))
    for entries in families.values():
        entries.sort()
        for _epoch, name in entries[:-keep_last]:
            path = os.path.join(save_dir, name)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
