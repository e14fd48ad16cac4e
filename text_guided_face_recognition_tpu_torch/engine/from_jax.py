"""The weight bridge: JAX package variables -> a port module's state_dict.

The port names its submodules after the JAX package's flax modules, so a
flax path `a/b/kernel` lands on the port key `a.b.weight`. The leaf
transforms:

  Dense `kernel` (in, out)      -> `weight` (out, in)
  Conv  `kernel` HWIO           -> `weight` OIHW
  Embed `embedding`             -> `weight`
  LayerNorm / BatchNorm `scale` -> `weight`   (`bias` keeps its name)
  LayerNormCHW (H, W, C)        -> (C, H, W), scale and bias alike
  batch_stats `mean` / `var`    -> `running_mean` / `running_var`
  PReLU `alpha`                 -> `alpha`
  a bare `weight` (the trainers'
  image_cls / text_cls /
  metric_fc class weights)      -> `weight`, unchanged

The scale-free `features` BN has no scale on either side. A whole trainer
bridges at once: the stage-1 params tree {image_head, text_encoder,
text_head, image_cls, text_cls} with batch_stats {image_head} onto
engine/stage1.Stage1Model, and the stage-2 tree {text_encoder, text_head,
image_head, fusion_net, metric_fc} with batch_stats {image_head,
fusion_net} onto engine/stage2.FusionModel. The text tower's tree is the
same under every `fused_block`, `tower` included. Inputs are nested
dicts of numpy arrays (the tests get them with `jax.device_get`); this module
imports nothing of JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from text_guided_face_recognition_tpu_torch.models.layers import LayerNormCHW

__all__ = ["state_dict_from_jax"]

_PARAM_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "weight": "weight", "bias": "bias", "alpha": "alpha"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _convert(owner: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if isinstance(owner, LayerNormCHW):
        return value.transpose(2, 0, 1)          # (H, W, C) -> (C, H, W)
    if leaf == "kernel" and value.ndim == 2:
        return value.T                           # (in, out) -> (out, in)
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    return value


def state_dict_from_jax(params: Mapping,
                        batch_stats: Optional[Mapping] = None,
                        module: Optional[nn.Module] = None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """The `state_dict` of `module` holding the JAX variables.

    params / batch_stats: the flax `params` and `batch_stats` collections as
    nested dicts of numpy arrays. Raises KeyError when a JAX leaf has no
    port key or a port parameter or buffer gets no JAX leaf, and ValueError
    on a shape mismatch, so a bridge that loads is complete.
    """
    if module is None:
        raise ValueError("state_dict_from_jax needs the port module")
    owners = dict(module.named_modules())
    target = module.state_dict()
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sources = [(params, _PARAM_LEAF), (batch_stats or {}, _STATS_LEAF)]
    for tree, names in sources:
        for path, value in _flatten(tree).items():
            owner_path, _, leaf = path.rpartition(".")
            if leaf not in names:
                raise KeyError(f"JAX leaf {path!r}: unknown leaf name")
            key = f"{owner_path}.{names[leaf]}" if owner_path else names[leaf]
            if key not in target or owner_path not in owners:
                raise KeyError(f"JAX leaf {path!r} has no port key {key!r}")
            arr = _convert(owners[owner_path], leaf, value)
            if tuple(arr.shape) != tuple(target[key].shape):
                raise ValueError(f"{path!r} -> {key!r}: shape {arr.shape} "
                                 f"!= {tuple(target[key].shape)}")
            out[key] = torch.from_numpy(np.array(arr, np.float32)).to(
                target[key].dtype)
    missing = [k for k in target if k not in out]
    if missing:
        raise KeyError(f"port keys with no JAX leaf: {missing}")
    return OrderedDict((k, out[k]) for k in target)
