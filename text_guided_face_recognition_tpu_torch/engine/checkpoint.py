"""Checkpoint artifacts of the trainers, written with torch.save.

Counterpart of text_guided_face_recognition_tpu/engine/checkpoint.py, in
the JAX package's naming. Under one save directory, stage 1 writes
`{model_type}_image_encoder_{epoch}` ({"image_head"}),
`{bert_type}_text_encoder_{epoch}` ({"model", "head"}; with an LSTM or
GRU encoder `{en_type}_text_encoder_{epoch}`, {"model"}, in a save
directory without the bert_type level) and `train_state_{epoch}`; stage 2
writes `fusion_{fusion_type}_{model_type}_{epoch}` ({"net",
"image_head"}), `encoder_{en_type}_{fusion_type}_{epoch}` ({"model",
"head"}, or {"model"} for an RNN encoder) and `train_state_{epoch}`. Each is one file holding a nested dict of tensors
(state_dicts, optimizer state, metadata); engine/prepare.py loads the
encoder and fusion artifacts back by these keys. `prune_checkpoints` keeps
the newest epochs of each artifact family.

The JAX package's checkpoints are Orbax directories, which the port does
not read: tools/export_jax_checkpoint.py (run where JAX is) writes one as
a `.npz` of `/`-joined tree paths, and `load_jax_export` reads that back
into a nested dict of numpy arrays in the JAX package's layout: a weights
artifact's tree ({"model", "head"}, {"image_head"}, {"net",
"image_head"}), or a train state's {"params", "batch_stats", "meta":
{"epoch", "lr": {group}}, "opt": {group: {"count", "mu" / "nu" /
"trace"}}}. `migrate_legacy_qkv` fuses the text tower's separate
query / key / value leaves of checkpoints older than the JAX package's
fused projection, as its loader does.
"""

from __future__ import annotations

import os
import re
import shutil
import zipfile
from collections import defaultdict
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "prune_checkpoints",
           "is_jax_export", "load_jax_export", "migrate_legacy_qkv"]


def save_checkpoint(path: str, tree: Any) -> None:
    """torch.save `tree` to `path` (written beside, then renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def is_jax_export(path: str) -> bool:
    """`path` is an exporter's `.npz`: a zip of `.npy` members only (a
    torch file is a zip too, of other members)."""
    if not os.path.isfile(path) or not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    return bool(names) and all(n.endswith(".npy") for n in names)


def load_jax_export(path: str) -> Dict[str, Any]:
    """The exporter's `.npz` at `path` as a nested dict of numpy arrays,
    split at each key's `/`."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def migrate_legacy_qkv(tree: Any) -> Any:
    """The JAX package's `migrate_legacy_qkv` on numpy trees: a node with
    separate `query`, `key` and `value` Dense leaves (and no `qkv`) gets
    one `qkv` whose kernel (and bias) is their concatenation along the
    output axis, [q | k | v]."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: migrate_legacy_qkv(v) for k, v in tree.items()}
    if ({"query", "key", "value"} <= tree.keys() and "qkv" not in tree
            and isinstance(tree["query"], dict)
            and "kernel" in tree["query"]):
        parts = [tree.pop(n) for n in ("query", "key", "value")]
        fused = {"kernel": np.concatenate(
            [np.asarray(p["kernel"]) for p in parts], axis=-1)}
        if "bias" in parts[0]:
            fused["bias"] = np.concatenate(
                [np.asarray(p["bias"]) for p in parts], axis=-1)
        tree["qkv"] = fused
    return tree


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
